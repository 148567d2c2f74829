"""Where the time of one allocate cycle of the PyTorch port goes, on one
NVIDIA GPU.

    python3 scripts/profile_torch_cycle.py [--shape headline|contended]

Runs the cycle of ``chip_smoke.py``'s shape once to warm up, then once
under ``torch.profiler`` (CPU and CUDA activities), and prints:

- the cycle's wall time and its phases (``CycleResult.phase_seconds``);
- the device's busy time — the union of every kernel (ours and
  PyTorch's), copy and memset interval in the trace — and its idle share
  of the cycle, 1 - busy / wall;
- the 20 device activities with the most summed time, with call counts.

The trace goes to ``chiprun_out/profile_<shape>.json`` (Chrome trace
format) and the numbers to ``chiprun_out/profile_<shape>_summary.json``.
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
    ap.add_argument("--shape", choices=("headline", "contended"),
                    default="headline")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_cycle: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    shape = chip_smoke.HEADLINE if args.shape == "headline" \
        else chip_smoke.CONTENDED
    card = chip_smoke.card_line()
    chip_smoke.run_cycle(shape, "cuda")                 # build + warm up
    from kai_scheduler_tpu_torch.framework.scheduler import Scheduler
    cluster = chip_smoke.fresh_cluster(shape)
    sched = Scheduler(device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = sched.run_once(cluster)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, f"profile_{args.shape}.json")
    prof.export_chrome_trace(trace_path)
    busy, top = device_activity(trace_path)
    summary = dict(
        card=card, shape=shape, wall_seconds=wall,
        phase_seconds=res.phase_seconds, chunks=res.chunks,
        binds=len(res.bind_requests), device_seconds=busy,
        device_idle_share=1.0 - busy / wall,
        top_device=[dict(name=n, calls=c, device_ms=ms)
                    for n, c, ms in top])
    with open(os.path.join(out_dir, f"profile_{args.shape}_summary.json"),
              "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print(f"card: {card}")
    print(f"{args.shape}: wall {wall:.4f} s, {res.chunks} chunks, "
          f"{len(res.bind_requests)} binds; device busy {busy:.4f} s, "
          f"idle share {summary['device_idle_share']:.4f}")
    print("phases: " + ", ".join(f"{k} {v:.4f}"
                                 for k, v in res.phase_seconds.items()))
    for name, calls, ms in top:
        print(f"  {ms:10.3f} ms  {calls:6d}x  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
