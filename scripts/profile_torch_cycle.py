"""Where the time of one cycle of the PyTorch port goes, on one NVIDIA
GPU.

    python3 scripts/profile_torch_cycle.py [--shape headline|contended|
        sharing|topology|topology_subgroups|saturated|
        saturated_sequential|preempt_many_queues|fragmented|affinity|
        affinity_reclaim|affinity_reclaim_sequential|affinity_sharing]

Runs the cycle of ``chip_smoke.py``'s shape once to warm up, then once
under ``torch.profiler`` (CPU and CUDA activities), and prints:

- the cycle's wall time (the warm-up run's too: the profiler's own
  per-op cost inflates the profiled one) and its phases
  (``CycleResult.phase_seconds``); for the victim cells (``saturated``,
  ``saturated_sequential``, ``preempt_many_queues``, ``fragmented``, as
  ``chip_smoke.py`` configures them) the per-action seconds, steps
  (wavefront chunks for a chunked action), scenario attempts (lanes) and
  syncs;
- the device's busy time — the union of every kernel (ours and
  PyTorch's), copy and memset interval in the trace — and its idle share
  of the cycle, 1 - busy / wall;
- the 20 device activities with the most summed time, with call counts.

The numbers go to ``chiprun_out/profile_<shape>_summary.json``; the trace
(Chrome trace format) to ``chiprun_out/profile_<shape>.json`` for the
headline and contended cells and to ``build/profile_<shape>.json`` for the
sharing cell (the per-task path, ``chip_smoke.py``'s GPU-sharing fleet),
the two topology cells, the victim cells and the four affinity cells,
whose traces hold hundreds of thousands of events.
Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the cycle shapes and runner)


#: ``chip_smoke.py``'s topology cells (allocate only)
TOPOLOGY_CELLS = ("topology", "topology_subgroups")
#: trace event categories that are device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_activity(trace_path: str, top_n: int = 20):
    """(busy seconds, top entries) from an exported Chrome trace: the
    union of every kernel, copy and memset interval on the device (so
    nothing is counted twice), and the ``top_n`` names by summed device
    time as (name, calls, ms)."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((t0, t0 + dur))
        calls, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (calls + 1, us + dur)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(((n, c, us / 1e3) for n, (c, us) in by_name.items()),
                 key=lambda x: -x[2])[:top_n]
    return busy_us / 1e6, top


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="headline", choices=(
        "headline", "contended", "sharing", *TOPOLOGY_CELLS,
        *chip_smoke.VICTIM_CELLS, *chip_smoke.AFFINITY_CELLS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_cycle: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    victim = args.shape in chip_smoke.VICTIM_CELLS
    card = chip_smoke.card_line()
    from kai_scheduler_tpu_torch.framework.scheduler import (Scheduler,
                                                             SchedulerConfig)
    if args.shape == "sharing":
        shape = chip_smoke.SHARING
        _, _, warm = chip_smoke.run_sharing_cycle("cuda")  # build + warm
        cluster = chip_smoke.sharing_cluster()
        sched = Scheduler(SchedulerConfig(actions=("allocate",)),
                          device="cuda")
    elif args.shape in TOPOLOGY_CELLS:
        shape = (chip_smoke.TOPOLOGY if args.shape == "topology"
                 else chip_smoke.TOPO_SUB)
        _, _, warm = chip_smoke.run_topology_cycle(args.shape, "cuda")
        cluster = chip_smoke.topology_cluster(args.shape)
        sched = Scheduler(SchedulerConfig(actions=("allocate",)),
                          device="cuda")
    elif args.shape in chip_smoke.AFFINITY_CELLS:
        shape = {"affinity": chip_smoke.AFFINITY,
                 "affinity_reclaim": chip_smoke.AFFINITY_RECLAIM,
                 "affinity_reclaim_sequential": chip_smoke.AFFINITY_RECLAIM,
                 "affinity_sharing": chip_smoke.AFFINITY_SHARING}[args.shape]
        _, _, warm = chip_smoke.run_affinity_cycle(args.shape, "cuda")
        cluster = chip_smoke.affinity_cluster(args.shape)
        sched = Scheduler(chip_smoke.affinity_config(args.shape),
                          device="cuda")
    elif victim:
        shape = {"saturated": chip_smoke.SATURATED,
                 "preempt_many_queues": chip_smoke.PREEMPT_MANY,
                 "fragmented": chip_smoke.FRAGMENTED}[
                     chip_smoke.VICTIM_CELLS[args.shape][0]]
        _, _, warm = chip_smoke.run_victim_cycle(args.shape, "cuda")
        cluster = chip_smoke.victim_cluster(args.shape)
        sched = Scheduler(chip_smoke.victim_config(args.shape),
                          device="cuda")
    else:
        shape = (chip_smoke.HEADLINE if args.shape == "headline"
                 else chip_smoke.CONTENDED)
        _, _, warm = chip_smoke.run_cycle(shape, "cuda")   # build + warm
        cluster = chip_smoke.fresh_cluster(shape)
        sched = Scheduler(SchedulerConfig(actions=("allocate",)),
                          device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = sched.run_once(cluster)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    trace_dir = (os.path.join(ROOT, "build")
                 if victim or args.shape in ("sharing", *TOPOLOGY_CELLS,
                                             *chip_smoke.AFFINITY_CELLS)
                 else out_dir)
    os.makedirs(trace_dir, exist_ok=True)
    trace_path = os.path.join(trace_dir, f"profile_{args.shape}.json")
    prof.export_chrome_trace(trace_path)
    busy, top = device_activity(trace_path)
    summary = dict(
        card=card, shape=shape, wall_seconds=wall,
        warm_up_wall_seconds=warm, phase_seconds=res.phase_seconds,
        action_seconds=res.action_seconds,
        victim_stats={k: vars(v) for k, v in res.victim_stats.items()},
        evictions=len(res.evictions), chunks=res.chunks,
        retries=res.retries,
        binds=len(res.bind_requests), device_seconds=busy,
        device_idle_share=1.0 - busy / wall,
        top_device=[dict(name=n, calls=c, device_ms=ms)
                    for n, c, ms in top])
    with open(os.path.join(out_dir, f"profile_{args.shape}_summary.json"),
              "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print(f"card: {card}")
    print(f"{args.shape}: wall {wall:.4f} s (warm-up run, unprofiled: "
          f"{warm:.4f} s), {res.chunks} chunks, {res.retries} retries, "
          f"{len(res.bind_requests)} "
          f"binds, {len(res.evictions)} evictions; device busy {busy:.4f} "
          f"s, idle share {summary['device_idle_share']:.4f} of the "
          f"profiled wall, {1.0 - busy / warm:.4f} of the warm-up wall")
    print("phases: " + ", ".join(f"{k} {v:.4f}"
                                 for k, v in res.phase_seconds.items()))
    print("actions: " + ", ".join(
        f"{k} {v:.4f} s" + (f" ({vars(res.victim_stats[k])})"
                            if k in res.victim_stats else "")
        for k, v in res.action_seconds.items()))
    for name, calls, ms in top:
        print(f"  {ms:10.3f} ms  {calls:6d}x  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
