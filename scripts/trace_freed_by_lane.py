"""Where K8 (``freed_by_lane``) and K7 (``replace_victims``) spend their
time on the victim cells, on one NVIDIA GPU.

    python3 scripts/trace_freed_by_lane.py [--cells saturated,...]
    PYTHONPATH=<checkout> python3 scripts/trace_freed_by_lane.py

Runs one cycle of each of ``chip_smoke.py``'s victim cells named in
``--cells`` (default: saturated, sharing_reclaim, mig_reclaim, fragmented)
on the card, captures a few K8 and K7 calls (``chip_smoke.Capture``) and
counts, for every K7 call of the cycle, the victims it re-places.  For
each captured K8 call it prints what the kernel walks — lanes, nodes,
pods, live pods (``0 <= lane < B``), the longest node list (node 0's
holds the snapshotter's padding rows) and each leaf queue's pods and live
pods — and the device time a launch of every function the call runs
(``torch.profiler``, mean of 20 calls): the kernels, the memsets.  K8's
node part and its queue part run in one grid (one thread a node and one
block a leaf queue in the first design; node tiles and leaf-queue blocks
in the tiled one): the script also builds two scratch copies of the
source, one whose queue blocks return at once and one whose node blocks
do, and times them the same way, so that each part's time can be read
alone.  Each scratch copy's outputs are not held (``chip_smoke.py`` holds
the whole kernel's).  For each captured K7 call it prints the victims,
N, D, E and the device time a launch.

The package is whichever ``kai_scheduler_tpu_torch`` comes first on
``sys.path``, so ``PYTHONPATH=<checkout>`` traces another checkout's
kernels (with that checkout's ``chip_smoke.py`` where it has one).  The
record goes to ``chiprun_out/trace_freed_by_lane.json`` beside the
``chip_smoke.py`` used.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# after PYTHONPATH: a checkout named there supplies the package
sys.path.append(ROOT)

import chip_smoke  # noqa: E402  (the victim cells and the capture)

REPS = 20
CELLS = ("saturated", "sharing_reclaim", "mig_reclaim", "fragmented")
KEEP = {"freed_by_lane": (0, 1, 2, 10, 20, 30),
        "replace_victims": (0, 5, 20, 40)}
#: the node part and the queue part of the grid, each switched off by a
#: line put in front of an anchor of the source: (variant, [(anchor, line)
#: of the first design, of the tiled one])
SPLITS = (
    ("nodes_only", [
        ("  // ---- one block per leaf queue ---",
         "  if (blockIdx.x >= 0) return;  // queue blocks off\n"),
        ("    // ---- one block per leaf queue: its live pods",
         "    return;  // queue blocks off\n")]),
    ("queues_only", [
        ("    if (n >= N) return;\n",
         "    return;  // node blocks off\n"),
        ("  const int work = *ndense * nslab;\n",
         "  return;  // node blocks off\n")]),
)


def build_variant(name: str, source: str, edits):
    """``source`` with the first of ``edits`` (anchor, line) whose anchor
    it holds once applied — ``line`` put in front of ``anchor`` — built
    with the package's flags into a library of its own (None when the
    source holds none of the anchors)."""
    from kai_scheduler_tpu_torch import kernels
    with open(source) as f:
        text = f.read()
    edit = next(((a, ln) for a, ln in edits if text.count(a) == 1), None)
    if edit is None:
        return None
    anchor, line = edit
    out_dir = os.path.join(ROOT, "build", "trace_freed_by_lane")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"freed_by_lane_{name}.cu")
    with open(src, "w") as f:
        f.write(text.replace(anchor, line + anchor))
    lib_path = os.path.join(out_dir, f"lib_{name}.so")
    subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-shared",
                    "-I", str(kernels.CSRC), src,
                    str(kernels.CSRC / "kai_common.cu"), "-o", lib_path],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    lib.kai_freed_by_lane.argtypes = kernels._SIGNATURES["kai_freed_by_lane"]
    lib.kai_freed_by_lane.restype = ctypes.c_int
    lib.kai_error_string.argtypes = [ctypes.c_int]
    lib.kai_error_string.restype = ctypes.c_char_p
    return lib


def device_ms(call) -> dict:
    """Mean device milliseconds a call of every device function ``call``
    runs, over ``REPS`` calls under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0:
            out[e.key.split("(")[0][:60]] = us / 1e3 / REPS
    out["total"] = sum(out.values())
    return out


def lane_stats(state, lane, B, pods) -> dict:
    r = state.running
    live = (lane >= 0) & (lane < B)
    qlen = (pods.queue_off[1:] - pods.queue_off[:-1]).long()
    qseg = torch.repeat_interleave(torch.arange(qlen.numel(),
                                                device=lane.device), qlen)
    qlive = torch.zeros_like(qlen).index_add_(
        0, qseg, live[pods.queue_pods.long()].long())
    nlen = (pods.node_off[1:] - pods.node_off[:-1]).long()
    return dict(B=B, N=state.nodes.n, Q=state.queues.q, M=r.m,
                D=state.nodes.d, E=r.extended.shape[1],
                live=int(live.sum()), node0_pods=int(nlen[0]),
                longest_node_list=int(nlen.max()),
                queue_pods=qlen.tolist(), queue_live=qlive.tolist())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_freed_by_lane: no CUDA device")
    import kai_scheduler_tpu_torch
    from kai_scheduler_tpu_torch import kernels
    from kai_scheduler_tpu_torch.ops import victims as V
    lib = kernels.library()
    source = str(kernels.CSRC / "freed_by_lane.cu")
    variants = {"whole": lib}
    for name, edits in SPLITS:
        v = build_variant(name, source, edits)
        if v is not None:
            variants[name] = v
    out = dict(card=chip_smoke.card_line(),
               package=kai_scheduler_tpu_torch.__file__,
               variants=list(variants), cells={})
    for cell in a.cells.split(","):
        k7_victims = []
        with chip_smoke.Capture(KEEP) as cap:
            # the capture wraps the module's wrapper; count under it
            wrapped = V.replace_victims
            V.replace_victims = lambda *x, _w=wrapped, **k: (
                k7_victims.append(int(x[1].sum())), _w(*x, **k))[1]
            try:
                _, _, secs = chip_smoke.run_victim_cycle(cell, "cuda")
            finally:
                V.replace_victims = wrapped
        rec = dict(cycle_seconds=secs, k7_calls=len(k7_victims),
                   k7_victims=k7_victims, k8=[], k7=[])
        for args, kw in cap.calls.get("freed_by_lane", []):
            state, lane, B, chain = args
            kw = {k: v for k, v in kw.items()
                  if k in ("compose", "devices", "extended")}
            pods = V.PodIndex.of(state)
            st = lane_stats(state, lane, B, pods)
            st.update(kw)
            times = {}
            for name, vlib in variants.items():
                kernels._LIB, saved = vlib, kernels._LIB
                try:
                    times[name] = device_ms(
                        lambda: V.freed_by_lane(state, lane, B, chain,
                                                pods=pods, **kw))
                finally:
                    kernels._LIB = saved
            st["device_ms"] = times
            rec["k8"].append(st)
            print(cell, json.dumps(st), flush=True)
        for args, kw in cap.calls.get("replace_victims", []):
            state, mask = args[0], args[1]
            K = max(1, min(state.running.m, args[-1]))
            st = dict(victims=min(int(mask.sum()), K), N=state.nodes.n,
                      D=state.nodes.d, E=state.running.extended.shape[1],
                      device_ms=device_ms(
                          lambda: V.replace_victims(*args, **kw)))
            rec["k7"].append(st)
            print(cell, "K7", json.dumps(st), flush=True)
        out["cells"][cell] = rec
        print(cell, f"{secs:.3f} s cycle; K7 victims a call "
              f"{k7_victims[:40]}{'...' if len(k7_victims) > 40 else ''}",
              flush=True)
        del cap
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "trace_freed_by_lane.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(out["card"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
