"""Time K9 (``pertask_fill``) and K10 (``dense_accept``) of one checkout on
the inputs another run captured, on one NVIDIA GPU.

    python3 chip_smoke.py                  # writes build/kernel_inputs.pt
    PYTHONPATH=<checkout> python3 scripts/compare_kernels.py \\
        --inputs build/kernel_inputs.pt --label <name>

``chip_smoke.py`` saves the first captured call of every K9 and K10 mode
on its main path (sharing, topology, topology_subgroups, affinity_sharing)
to ``build/kernel_inputs.pt``.  This script loads them into whichever
``kai_scheduler_tpu_torch`` comes first on ``sys.path`` (so it times an
older checkout's kernels on the same inputs), holds each kernel against
that checkout's plain version (tolerance 0), and prints one JSON line:
each mode's median of 50 calls (CUDA events around each call, as
``chip_smoke.py`` times them), the card's name and power limit, and the
checkout's path.  ``scripts/chip_proof.sh run`` alternates it between
the parent commit and the change (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
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


def _flat(out):
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
    saved = torch.load(a.inputs, map_location="cuda", weights_only=False)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = dict(label=a.label, package=kai_scheduler_tpu_torch.__file__,
               card=card.strip(), modes={})
    for mode, (args, kw) in saved.items():
        kw = {k: v for k, v in kw.items() if k != "agg"}
        if mode.startswith("pertask_fill"):
            fn, plain = A.pertask_fill, A.pertask_fill_plain
        else:
            fn, plain = A.dense_accept, A.dense_accept_plain
        for x, y in zip(_flat(fn(*args, **kw)), _flat(plain(*args, **kw))):
            if not torch.equal(x, y):
                raise AssertionError(f"{a.label} {mode}: kernel and plain "
                                     f"version differ")
        out["modes"][mode] = _time_ms(lambda: fn(*args, **kw))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
