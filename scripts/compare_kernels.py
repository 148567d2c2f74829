"""Time K3 (``uniform_fill``), K5 (``cumsum_ds``), K6 (``freed_by_mask``),
K7 (``replace_victims``), K8 (``freed_by_lane``), K9 (``pertask_fill``),
K10 (``dense_accept``) and K12 (``affinity_mask``) of one checkout on the
inputs another run captured, on one NVIDIA GPU.

    python3 chip_smoke.py                  # writes build/kernel_inputs.pt
    PYTHONPATH=<checkout> python3 scripts/compare_kernels.py \\
        --inputs build/kernel_inputs.pt --label <name>

``chip_smoke.py`` saves the first captured call of every K3, K6, K9 and
K10 mode, and of K8's three modes (K9's and K10's extended
modes too: ``pertask_fill:extended``, ``:lanes_extended``,
``:legacy_extended``, ``dense_accept:extended``), and K7's call with the
most victims on fragmented and on sharing_reclaim
(``replace_victims:fragmented``, ``:sharing_reclaim``), K5's largest call
of each victim cell that launches it (``cumsum_ds:saturated``,
``:saturated_sequential``, ``:preempt_many_queues``, ``:fragmented``,
``:sharing_reclaim``, ``:mig_reclaim``) and K12's largest call and
one-lane call (``affinity_mask``, ``affinity_mask:one_lane``), on its
main path to ``build/kernel_inputs.pt``.  This script loads them into
whichever ``kai_scheduler_tpu_torch`` comes first on ``sys.path`` (so it times an
older checkout's kernels on the same inputs), holds each kernel against
that checkout's plain version (tolerance 0; K6's, K7's and K8's on CPU
copies, K6's and K8's ``index_add_`` adding in order there), and prints
one JSON line: each mode's median of 50 calls (CUDA events around each
call, as ``chip_smoke.py`` times them, the host's launch included), its
device time a call (``device_ms``: the profiler's device time of every
kernel the 50 calls launched, over 50; null when the profiler recorded
some kernel of a call fewer or more than 50 times), the card's name and
power limit,
and the checkout's path.  A checkout whose K6 has no queue-only mode runs
the whole kernel for that call (what its reclaim ran) and is held on the
queue tables; a mode whose arguments the checkout's wrapper does not take
(K8's device table, K9's lanes and legacy modes before they existed, the
extended modes before they existed) is listed under ``missing``.
``scripts/chip_proof.sh run`` alternates it between the parent commit and
the change (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess

import torch

REPEATS = 50


def _time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _kernel_totals(fn, calls: int) -> dict[str, tuple[int, float]]:
    """``{kernel: (launches, device us)}`` the profiler recorded over
    ``calls`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = us if us is not None else getattr(e, "cuda_time_total", 0.0)
        if us > 0:
            out[e.key] = (e.count, us)
    return out


def _device_ms(fn) -> float | None:
    """Device milliseconds a call: every kernel ``REPEATS`` calls launch,
    from the profiler's device activity; None when the profiler did not
    record each kernel of one call ``REPEATS`` times (a call whose kernels
    went unrecorded would count as no time)."""
    fn()
    torch.cuda.synchronize()
    one = _kernel_totals(fn, 1)
    many = _kernel_totals(fn, REPEATS)
    if {k: c for k, (c, _) in many.items()} != {
            k: c * REPEATS for k, (c, _) in one.items()}:
        return None
    return sum(us for _, us in many.values()) / REPEATS / 1e3


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if hasattr(out, "fields"):
        return list(out.fields())
    return [t for t in out if t is not None]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--label", required=True)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: no CUDA device")
    import kai_scheduler_tpu_torch
    from kai_scheduler_tpu_torch.ops import allocate as A
    from kai_scheduler_tpu_torch.ops import victims as V
    from kai_scheduler_tpu_torch.state import (state_from_numpy,
                                               state_to_numpy)
    from kai_scheduler_tpu_torch.utils import numerics as NU
    saved = torch.load(a.inputs, map_location="cuda", weights_only=False)
    has_queues_only = "queues_only" in inspect.signature(
        V.freed_by_mask).parameters

    def freed(args, kw):
        """K6's call, its outputs and its plain version's, on CPU copies
        of the inputs."""
        state, mask, chain = args[:3]
        only = kw.get("queues_only", False)
        if has_queues_only or not only:
            def call():
                return V.freed_by_mask(*args, **kw)
        else:   # an older K6: the whole kernel, held on its queue tables
            def call():
                return V.freed_by_mask(*args)[2:4]
        plain = V.freed_by_mask_plain(
            state_from_numpy(state_to_numpy(state), "cpu"), mask.cpu(),
            chain.cpu())
        return (call, [t.cpu() for t in _flat(call())],
                list(plain[2:4] if only else plain))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    def lane_freed(args, kw):
        """K8's call, its outputs and its plain version's, on CPU copies."""
        state, lane, B, chain = args

        def call():
            return V.freed_by_lane(*args, **kw)
        plain = V.freed_by_lane_plain(
            state_from_numpy(state_to_numpy(state), "cpu"), lane.cpu(), B,
            chain.cpu(), **kw)
        return call, [t.cpu() for t in _flat(call())], _flat(plain)

    def replaced(args, kw):
        """K7's call, its outputs and its plain version's, on CPU copies."""
        def call():
            return V.replace_victims(*args, **kw)
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a
               for a in args[1:]]
        plain = V.replace_victims_plain(
            state_from_numpy(state_to_numpy(args[0]), "cpu"), *cpu, **kw)
        return call, [t.cpu() for t in _flat(call())], _flat(plain)

    out = dict(label=a.label, package=kai_scheduler_tpu_torch.__file__,
               card=card.strip(), modes={}, device_ms={}, missing=[])
    for mode, (args, kw) in saved.items():
        # a keyword left at None is the wrapper's default: an older
        # checkout whose wrapper lacks it runs the same call
        kw = {k: v for k, v in kw.items() if k != "agg" and v is not None}
        wrapper = {"freed_by_mask": V.freed_by_mask,
                   "freed_by_lane": V.freed_by_lane,
                   "replace_victims": V.replace_victims,
                   "pertask_fill": A.pertask_fill,
                   "dense_accept": A.dense_accept,
                   "uniform_fill": A.uniform_fill,
                   "cumsum_ds": NU.cumsum_ds,
                   "affinity_mask": A.affinity_mask}[mode.split(":")[0]]
        if not set(kw) <= set(inspect.signature(wrapper).parameters):
            out["missing"].append(mode)
            continue
        if mode.startswith("freed_by_mask"):
            call, got, want = freed(args, kw)
        elif mode.startswith("freed_by_lane"):
            call, got, want = lane_freed(args, kw)
        elif mode.startswith("replace_victims"):
            call, got, want = replaced(args, kw)
        elif mode.startswith("cumsum_ds"):
            def call(args=args, kw=kw):
                return NU.cumsum_ds(*args, **kw)
            # its plain version on a CPU copy (the wrapper takes it there)
            got = [call().cpu().view(torch.int32)]
            want = [NU.cumsum_ds(args[0].cpu(), **kw).view(torch.int32)]
        else:
            fn, plain = {"pertask_fill": (A.pertask_fill,
                                          A.pertask_fill_plain),
                         "dense_accept": (A.dense_accept,
                                          A.dense_accept_plain),
                         "uniform_fill": (A.uniform_fill,
                                          A.uniform_fill_plain),
                         "affinity_mask": (A.affinity_mask,
                                           A.affinity_mask_plain)}[
                mode.split(":")[0]]

            def call(fn=fn, args=args, kw=kw):
                return fn(*args, **kw)
            got, want = _flat(call()), _flat(plain(*args, **kw))
        if len(got) != len(want) or not all(
                torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{a.label} {mode}: kernel and plain "
                                 f"version differ")
        out["modes"][mode] = _time_ms(call)
        out["device_ms"][mode] = _device_ms(call)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
