"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kai_scheduler_tpu_torch`` end to end on the card and fails
(non-zero exit, no result line) on any build error, launch error or
mismatch:

1. builds the four hand-written CUDA kernels from ``csrc/`` and prints
   the card's name and power limit;
2. runs one warm-up allocate cycle of the headline cluster (10,000 nodes
   x 6,250 gangs x 8 replicas = 50,000 pending pods) through
   ``Scheduler(device="cuda").run_once``, capturing the inputs each kernel
   wrapper receives on the main path; then holds every kernel against its
   plain PyTorch version on those inputs (bit-exact: tolerance 0) and
   times both with CUDA events;
3. runs the headline cycle again five times, timed, each on a fresh
   cluster with the launch counts reset just before and read just after;
   every kernel must have launched in every run; every packed i16 commit
   must equal, byte for byte, the CPU oracle's (the same cycle with
   ``device="cpu"``, i.e. the kernels' plain versions);
4. does the same (three runs) on a contended cluster: the same backlog
   on 4,000 nodes, four departments of four queues, three priorities;
5. prints one JSON line of per-kernel numbers, the card line, and last
   ``{"ok": true, "device": {...}}``.

Longer output (the compiler's register/spill report, per-phase numbers)
goes to ``chiprun_out/chip_smoke.json``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

#: peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and f32
#: operations/s outside the tensor cores — the kernels' work is f32/int
#: compare-and-add, no matrix products
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPEATS = 50
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# capture: record what each kernel wrapper receives on the main path
# ---------------------------------------------------------------------------

class Capture:
    """Wraps the four kernel wrappers where the main path calls them and
    keeps the arguments of a few calls (cloned, so later in-place work
    cannot change them)."""

    #: which calls to keep per wrapper: both DRF levels, the first and the
    #: tenth wavefront chunk (an empty cluster, then a partly filled one)
    KEEP = {"drf_water_fill": (0, 1), "type_tables": (0, 9),
            "uniform_fill": (0, 9), "sparse_accept": (0, 9)}

    def __init__(self):
        from kai_scheduler_tpu_torch.ops import allocate, drf
        self.calls: dict[str, list] = {}
        self._mods = ((drf, "drf_water_fill"), (allocate, "type_tables"),
                      (allocate, "uniform_fill"), (allocate, "sparse_accept"))
        self._orig = {name: getattr(mod, name) for mod, name in self._mods}

    @staticmethod
    def _clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(Capture._clone(v) for v in x)
        return x

    def __enter__(self):
        for mod, name in self._mods:
            orig = self._orig[name]
            seen = self.calls.setdefault(name, [])
            counter = {"n": 0}

            def wrapped(*args, _orig=orig, _seen=seen, _c=counter,
                        _keep=self.KEEP[name], **kw):
                if _c["n"] in _keep:
                    _seen.append((self._clone(args), self._clone(kw)))
                _c["n"] += 1
                return _orig(*args, **kw)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name in self._mods:
            setattr(mod, name, self._orig[name])


# ---------------------------------------------------------------------------
# kernels vs their plain versions
# ---------------------------------------------------------------------------

def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _flatten(out):
    if isinstance(out, torch.Tensor):
        return [out]
    res = []
    for o in out:
        res.extend(_flatten(o))
    return res


def _max_abs_err(a, b) -> float:
    """Max |a - b| over every output; raises on a shape/dtype mismatch or
    any bit difference (the kernels are held bit-exact: tolerance 0)."""
    worst = 0.0
    for x, y in zip(_flatten(a), _flatten(b), strict=True):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"output {tuple(x.shape)}/{x.dtype} vs "
                                 f"{tuple(y.shape)}/{y.dtype}")
        xf, yf = x.double(), y.double()
        worst = max(worst, float((xf - yf).abs().max()) if x.numel() else 0.0)
        if not torch.equal(x, y):
            raise AssertionError(f"kernel and plain version differ "
                                 f"(max |diff| {worst})")
    return worst


def _time_ms(fn, repeats=REPEATS) -> float:
    """Median milliseconds of one call, CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def launch_floor_ms() -> float:
    """The floor under any launch: one PyTorch call on a one-element
    tensor, timed like the kernels."""
    one = torch.zeros(1, device="cuda")
    return _time_ms(lambda: one.add_(1.0), 200)


def kernel_checks(cap: Capture) -> dict:
    """Every kernel on the captured main-path inputs vs its plain version:
    equality, timings, and the least time the card could take."""
    from kai_scheduler_tpu_torch.ops import allocate as A
    from kai_scheduler_tpu_torch.ops import drf as D
    out = {}

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    # K1 — one hierarchy level (the last one captured): per resource the
    # deserved pass and the pairwise remainder rank (Q^2), plus ~40
    # operations per queue in each water-fill round this level's data
    # needs (the plain version counts its rounds)
    errs, rec = [], None
    for args, kw in cap.calls["drf_water_fill"]:
        fs_k, _ = cap._orig["drf_water_fill"](*args, **kw)
        rounds: list = []
        fs_p = D.divide_level_plain(*args, **kw, rounds=rounds)
        errs.append(_max_abs_err(fs_k, fs_p))
        rec = (args, kw, rounds)
    args, kw, rounds = rec
    Q, R_ = args[1].shape
    ms = _time_ms(lambda: cap._orig["drf_water_fill"](*args, **kw))
    plain_ms = _time_ms(lambda: D.divide_level_plain(*args, **kw), 5)
    b, by = bound(_nbytes(*args) + Q * R_ * 4,
                  R_ * (Q * 20 + Q * Q * 6 + Q * 40 * sum(rounds)))
    out["drf_water_fill"] = dict(max_abs_err=max(errs), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                 shape=f"Q={Q} R={R_}")

    # K2 — per (type, node): ~45 f32 operations; reads the node pools,
    # labels and filter rows once, writes 14 bytes per (type, node)
    errs = []
    for args, kw in cap.calls["type_tables"]:
        k_out = cap._orig["type_tables"](*args, **kw)
        p_out = A.type_tables_plain(*args, **kw)
        errs.append(_max_abs_err(k_out, p_out))
    nodes, free, extra, type_req, type_sel, type_cls, placement = args
    Y, N = type_req.shape[0], free.shape[0]
    ms = _time_ms(lambda: cap._orig["type_tables"](*args, **kw))
    plain_ms = _time_ms(lambda: A.type_tables_plain(*args, **kw))
    nb = _nbytes(free, extra, nodes.releasing, nodes.allocatable,
                 nodes.valid, nodes.labels, nodes.filter_masks, type_req,
                 type_sel, type_cls) + Y * N * 14
    b, by = bound(nb, Y * N * 45)
    out["type_tables"] = dict(max_abs_err=max(errs), ms=ms,
                              plain_ms=plain_ms, bound_ms=b, bound_by=by,
                              shape=f"Y={Y} N={N}")

    # K3 — per lane: its type's fit/band/soft rows (shared by lanes of one
    # type: each table read once), ~10 operations per node for jitter,
    # score and the top-k compare; writes the lane outputs
    errs = []
    for args, kw in cap.calls["uniform_fill"]:
        k_out = cap._orig["uniform_fill"](*args, **kw)
        p_out = A.uniform_fill_plain(*args, **kw)
        errs.append(_max_abs_err(k_out, p_out))
    (cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain, lt, tables,
     soft, valid) = args
    B, T = prior.shape
    Q = qa.shape[0]
    ms = _time_ms(lambda: cap._orig["uniform_fill"](*args, **kw))
    plain_ms = _time_ms(lambda: A.uniform_fill_plain(*args, **kw))
    nb = (_nbytes(cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain,
                  soft, valid, *tables)
          + B * (12 + T + 3 * 4 + 1 + 4 * 3)   # the lanes' gang rows
          + B * (2 * Q * 3 * 4 + T * 5 + 1))   # outputs
    b, by = bound(nb, B * N * 10)
    out["uniform_fill"] = dict(max_abs_err=max(errs), ms=ms,
                               plain_ms=plain_ms, bound_ms=b, bound_by=by,
                               shape=f"B={B} T={T} N={N} Q={Q}")

    # K4 — the K = B*T entries and the pools at the <= K touched nodes;
    # the sort's compares (K log2(K)^2 / 2) dominate the operations
    errs = []
    for args, kw in cap.calls["sparse_accept"]:
        k_out = cap._orig["sparse_accept"](*args, **kw)
        p_out = A.sparse_accept_plain(*args, **kw)
        errs.append(_max_abs_err(k_out, p_out))
    nodes_b, ent_ok, pipe_b, req_b, free, pipe_pool, N = args
    K = nodes_b.numel()
    ms = _time_ms(lambda: cap._orig["sparse_accept"](*args, **kw))
    plain_ms = _time_ms(lambda: A.sparse_accept_plain(*args, **kw))
    lg = max(1, (K - 1).bit_length())
    nb = _nbytes(nodes_b, ent_ok, pipe_b, req_b) + K * 2 * 12 + 4 + K * 8
    b, by = bound(nb, K * lg * lg // 2 + K * 18)
    out["sparse_accept"] = dict(max_abs_err=max(errs), ms=ms,
                                plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                shape=f"K={K} N={N}")
    return out


# ---------------------------------------------------------------------------
# cycles
# ---------------------------------------------------------------------------

HEADLINE = dict(num_nodes=10_000, node_accel=8.0, num_gangs=6250,
                tasks_per_gang=8)
CONTENDED = dict(num_nodes=4_000, node_accel=8.0, num_gangs=6250,
                 tasks_per_gang=8, num_departments=4,
                 queues_per_department=4, priority_spread=3)
#: timed cycles per shape (each on a fresh cluster from the same seed)
HEADLINE_RUNS = 5
CONTENDED_RUNS = 3


def fresh_cluster(shape: dict):
    from kai_scheduler_tpu_torch.runtime.cluster import Cluster
    from kai_scheduler_tpu_torch.state import make_cluster
    return Cluster.from_objects(*make_cluster(**shape))


def run_cycle(shape: dict, device: str):
    from kai_scheduler_tpu_torch.framework.scheduler import Scheduler
    cluster = fresh_cluster(shape)
    t0 = time.perf_counter()
    res = Scheduler(device=device).run_once(cluster)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, cluster, time.perf_counter() - t0


def check_cycle(name: str, shape: dict, gpu, cpu, cluster) -> dict:
    """The GPU cycle's outputs are right: the packed commit equals the CPU
    oracle's byte for byte, every bound gang is whole, queue tables are
    finite."""
    res, secs = gpu
    if res.packed.tobytes() != cpu.packed.tobytes():
        diff = int((res.packed != cpu.packed).sum())
        raise AssertionError(f"{name}: packed commit differs from the CPU "
                             f"oracle in {diff} of {res.packed.size} i16")
    if [(b.pod_name, b.selected_node) for b in res.bind_requests] != \
            [(b.pod_name, b.selected_node) for b in cpu.bind_requests]:
        raise AssertionError(f"{name}: BindRequests differ from the oracle")
    per_gang: dict[str, int] = {}
    for br in res.bind_requests:
        g = cluster.pods[br.pod_name].group
        per_gang[g] = per_gang.get(g, 0) + 1
    for g, n in per_gang.items():
        if n != cluster.pod_groups[g].min_member:
            raise AssertionError(f"{name}: gang {g} bound {n} of "
                                 f"{cluster.pod_groups[g].min_member} pods")
    t = res.tensors
    if not bool(torch.isfinite(t.queue_allocated).all()):
        raise AssertionError(f"{name}: non-finite queue allocation")
    return dict(
        cycle_seconds=secs, binds=len(res.bind_requests),
        pods_bound_per_s=len(res.bind_requests) / secs,
        gangs_allocated=int(t.allocated.sum()),
        gangs_attempted=int(t.attempted.sum()),
        fit_reason_counts={int(k): int(v) for k, v in zip(
            *torch.unique(t.fit_reason.cpu(), return_counts=True))},
        chunks=res.chunks, phase_seconds=res.phase_seconds,
        action_seconds=res.action_seconds, shape=shape,
        nodes=shape["num_nodes"],
        pending_pods=shape["num_gangs"] * shape["tasks_per_gang"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from kai_scheduler_tpu_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {}

    # -- 1. build -----------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s -> {os.path.relpath(path)}")
    report["build_seconds"] = build_s
    report["build_log"] = list(kernels.BUILD_LOG)
    for entry in kernels.BUILD_LOG:
        for line in entry.splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log("  " + line.strip())

    # -- 2. warm-up headline cycle with input capture, kernels vs plain -------
    with Capture() as cap:
        warm, _, warm_s = run_cycle(HEADLINE, "cuda")
    log(f"warm-up headline cycle: {warm_s:.3f} s, "
        f"{len(warm.bind_requests)} binds")
    checks = kernel_checks(cap)
    report["launch_floor_ms"] = launch_floor_ms()

    # -- 3./4. timed cycles vs the CPU oracle --------------------------------
    # every run: counts reset just before, read just after, all > 0; every
    # run's commit equals the oracle's (the cycle is deterministic)
    launches = {}
    for name, shape, reps in (("headline", HEADLINE, HEADLINE_RUNS),
                              ("contended", CONTENDED, CONTENDED_RUNS)):
        runs = []
        for _ in range(reps):
            kernels.reset_launch_counts()
            res, cluster, secs = run_cycle(shape, "cuda")
            counts = kernels.launch_counts()
            missing = [k for k, v in counts.items() if v <= 0]
            if missing:
                raise AssertionError(
                    f"{name}: kernels never launched: {missing}")
            runs.append((res, cluster, secs, counts))
        cpu, _, cpu_s = run_cycle(shape, "cpu")
        recs = [check_cycle(name, shape, (res, secs), cpu, cluster)
                for res, cluster, secs, _ in runs]
        secs_all = sorted(r["cycle_seconds"] for r in recs)
        rec = dict(recs[-1])
        rec.update(runs=len(recs), cycle_seconds_all=secs_all,
                   cycle_seconds_median=statistics.median(secs_all),
                   pods_bound_per_s_median=rec["binds"]
                   / statistics.median(secs_all),
                   launches=runs[-1][3], cpu_oracle_seconds=cpu_s)
        report[name] = rec
        if name == "headline":
            launches = runs[-1][3]
        log(f"{name}: {len(recs)} cycles, median "
            f"{rec['cycle_seconds_median']:.4f} s (min {secs_all[0]:.4f}, "
            f"max {secs_all[-1]:.4f}), {rec['binds']} binds "
            f"({rec['pods_bound_per_s_median']:.0f} pods/s), "
            f"{rec['gangs_allocated']} gangs allocated of "
            f"{rec['gangs_attempted']} attempted, {rec['chunks']} chunks, "
            f"fit reasons {rec['fit_reason_counts']}, launches "
            f"{rec['launches']}; every commit == CPU oracle "
            f"({cpu_s:.1f} s)")
        log("  phases (last run): " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec["phase_seconds"].items()))

    for name, c in checks.items():
        log(f"kernel {name}: equal to its plain version (max_abs_err "
            f"{c['max_abs_err']}), {c['ms']:.4f} ms kernel, "
            f"{c['plain_ms']:.4f} ms plain, {launches[name]} launches per "
            f"headline cycle, bound {c['bound_ms']:.6f} ms by "
            f"{c['bound_by']} [{c['shape']}]")
    log(f"launch floor (one PyTorch call on one element): "
        f"{report['launch_floor_ms']:.4f} ms")
    report["kernel_checks"] = checks
    rows = []
    for name, info in kernels.KERNELS.items():
        c = checks[name]
        rows.append(dict(name=name, route="cuda", source=info.source,
                         replaces=info.replaces, launches=launches[name],
                         max_abs_err=c["max_abs_err"], ms=c["ms"],
                         plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                         bound_by=c["bound_by"], library_ms=None))
    report["kernels"] = rows
    report["card"] = card
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
