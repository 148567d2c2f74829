"""Where K6 (``freed_by_mask``) spends its time on resident_churn, on one
NVIDIA GPU.

    python3 scripts/trace_freed_by_mask.py

Drives ``chip_smoke.py``'s resident_churn stream (the headline fleet half
running, ``SchedulerConfig(resident=True)``, 1 % churn a cycle) until the
snapshot is resident, then captures every K6 call of one more cycle
(reclaim's ``freeable`` bound, the stale pass, any scenario attempt).
For each captured call it prints what the kernel walks — the pod axis
``M``, the masked pods, the rows whose node or queue is -1 (the
snapshotter's padding, which ``PodIndex`` files under node 0 and queue
0), the longest node and queue lists and how many of their pods are
masked, whether every masked summand is a whole number and the largest
per-queue sum of magnitudes — and times the wrapper (median of 50 calls,
CUDA events around each) on three index variants that give the same
bits, since an unmasked pod adds nothing:

- ``as_captured``: the action's own ``PodIndex``;
- ``node_lists_masked``: the node lists hold only the masked pods;
- ``queue_lists_masked``: the queue lists hold only the masked pods.

Every variant's outputs are held equal to the captured call's.  The
record goes to ``chiprun_out/trace_freed_by_mask.json``.  Imports nothing
of JAX.
"""
from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the resident_churn stream and capture)


def masked_index(pods, mask: torch.Tensor, which: str):
    """``pods`` with the node (``which="node"``) or queue lists cut to
    the masked pods, in the same order."""
    from kai_scheduler_tpu_torch.ops.victims import PodIndex
    off, lst = ((pods.node_off, pods.node_pods) if which == "node"
                else (pods.queue_off, pods.queue_pods))
    keep = mask[lst.long()]
    seg = torch.repeat_interleave(
        torch.arange(off.numel() - 1, device=off.device),
        (off[1:] - off[:-1]).long())
    new_off = torch.zeros_like(off)
    new_off[1:] = torch.cumsum(
        torch.zeros(off.numel() - 1, dtype=torch.int32, device=off.device)
        .index_add_(0, seg[keep], torch.ones_like(seg[keep],
                                                  dtype=torch.int32)), 0)
    new = (new_off.to(torch.int32), lst[keep].contiguous())
    if which == "node":
        return PodIndex(*new, pods.queue_off, pods.queue_pods)
    return PodIndex(pods.node_off, pods.node_pods, *new)


def segment_stats(off: torch.Tensor, lst: torch.Tensor, mask: torch.Tensor):
    lens = (off[1:] - off[:-1]).long()
    on = mask[lst.long()].to(torch.int64)
    seg = torch.repeat_interleave(torch.arange(lens.numel(),
                                               device=lens.device), lens)
    masked = torch.zeros_like(lens).index_add_(0, seg, on)
    top = int(torch.argmax(lens))
    return dict(segments=lens.numel(), longest=top,
                longest_len=int(lens[top]), longest_masked=int(masked[top]),
                segment0_len=int(lens[0]), segment0_masked=int(masked[0]),
                mean_len=float(lens.float().mean()))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("trace_freed_by_mask: no CUDA device")
    from kai_scheduler_tpu_torch import kernels
    from kai_scheduler_tpu_torch.ops import victims as V
    kernels.library()
    run = chip_smoke.ResidentRun("resident", "cuda")
    run.step()
    for _ in range(chip_smoke.RESIDENT_WARM):
        run.step()
        if run.last["mode"] == "resident":
            break
    if run.last["mode"] != "resident":
        raise AssertionError(f"resident_churn: mode {run.last}")
    with chip_smoke.Capture({"freed_by_mask": range(1000)}) as cap:
        run.step()
    calls = cap.calls.get("freed_by_mask", [])
    if not calls:
        raise AssertionError("resident_churn: no K6 call captured")
    fn = cap._orig["freed_by_mask"]
    out = dict(card=chip_smoke.card_line(), calls=[])
    for args, kw in calls:
        state, mask, chain = args[:3]
        pods = args[3] if len(args) > 3 else kw.get("pods")
        pods = pods if pods is not None else V.PodIndex.of(state)
        r = state.running
        want = fn(state, mask, chain, pods)
        rec = dict(M=r.m, masked=int(mask.sum()), N=state.nodes.n,
                   Q=state.queues.q, R=r.req.shape[1], D=state.nodes.d,
                   E=r.extended.shape[1],
                   node_negative=int((r.node < 0).sum()),
                   node_negative_masked=int((mask & (r.node < 0)).sum()),
                   queue_negative=int((r.queue < 0).sum()),
                   node_lists=segment_stats(pods.node_off, pods.node_pods,
                                            mask),
                   queue_lists=segment_stats(pods.queue_off,
                                             pods.queue_pods, mask))
        vals = torch.cat([r.req, r.extended,
                          torch.where(r.device >= 0, r.accel_held,
                                      0.0)[:, None]], 1)[mask]
        rec["masked_whole"] = bool((vals == torch.trunc(vals)).all())
        qsum = torch.zeros((state.queues.q, r.req.shape[1]),
                           device=mask.device).index_add_(
            0, r.queue.clamp(min=0)[mask].long(), r.req[mask].abs())
        rec["max_queue_abs_sum"] = float(qsum.max()) if qsum.numel() else 0.0
        times = {}
        for name, idx in (("as_captured", pods),
                          ("node_lists_masked",
                           masked_index(pods, mask, "node")),
                          ("queue_lists_masked",
                           masked_index(pods, mask, "queue"))):
            got = fn(state, mask, chain, idx)
            for a, b in zip(got, want):
                if a is not None and not torch.equal(a, b):
                    raise AssertionError(f"K6 {name}: outputs differ")
            times[name] = chip_smoke._time_ms(
                lambda idx=idx: fn(state, mask, chain, idx))
        rec["ms"] = times
        out["calls"].append(rec)
        print(json.dumps(rec), flush=True)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "trace_freed_by_mask.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(out["card"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
