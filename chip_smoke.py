"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kai_scheduler_tpu_torch`` end to end on the card and fails
(non-zero exit, no result line) on any build error, launch error or
mismatch:

1. builds the seven hand-written CUDA kernels from ``csrc/`` (one
   ``nvcc`` per source, all started together) and prints the card's name
   and power limit;
2. runs one warm-up allocate cycle of the headline cluster (10,000 nodes
   x 6,250 gangs x 8 replicas = 50,000 pending pods) through
   ``Scheduler(device="cuda").run_once``, capturing the inputs each
   allocate kernel's wrapper receives on the main path; then holds K1-K4
   against their plain PyTorch versions on those inputs (bit-exact:
   tolerance 0) and times both with CUDA events;
3. runs the headline cycle again five times, timed, each on a fresh
   cluster with the launch counts reset just before and read just after;
   every allocate kernel must have launched in every run; every packed
   i16 commit must equal, byte for byte, the CPU oracle's (the same cycle
   with ``device="cpu"``, i.e. the kernels' plain versions);
4. does the same (three runs) on a contended cluster: the same backlog
   on 4,000 nodes, four departments of four queues, three priorities;
5. runs the five default actions (allocate, consolidation, reclaim,
   preempt, stalegangeviction) with the sequential victim engine
   (``VictimConfig(batch_size=1)``) on each of two clusters: first a
   run under the profiler's CUDA activity with K5-K7's inputs captured
   (each kernel's in-cycle device time), then the timed run on a fresh
   cluster with the launch counts reset just before and read just after:
   - *saturated* (the repo's worst-case production shape): 10,000 nodes x
     4 accelerators filled by 40,000 running pods, 10,000 pending pods in
     the other queues — reclaim must evict;
   - *fragmented*: 10,000 nodes x 8 accelerators, each running two
     one-pod gangs of 2; 256 pending one-pod gangs of 6 fit no node idle
     — consolidation must move victims; 16 running gangs below their
     quorum past the grace period — stalegangeviction must evict;
   the packed commit, BindRequests, evictions (pod, move target) and
   move rebinds must equal the CPU oracle's; then K5-K7 are held against
   their plain versions on the captured inputs and timed;
6. prints one JSON line of per-kernel numbers, the card line, and last
   ``{"ok": true, "device": {...}}``.

Longer output (the compiler's register/spill report, per-phase numbers)
goes to ``chiprun_out/chip_smoke.json``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
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
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")


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
    """Wraps kernel wrappers where the main path calls them and keeps the
    arguments of a few calls (cloned, so later in-place work cannot change
    them)."""

    #: which calls to keep per wrapper in the headline warm-up: both DRF
    #: levels, the first and the tenth wavefront chunk (an empty cluster,
    #: then a partly filled one)
    ALLOCATE_KEEP = {"drf_water_fill": (0, 1), "type_tables": (0, 9),
                     "uniform_fill": (0, 9), "sparse_accept": (0, 9)}

    def __init__(self, keep: dict):
        from kai_scheduler_tpu_torch.ops import allocate, drf, stale, victims
        self.keep = keep
        self.calls: dict[str, list] = {}
        # (module, attribute, kernel): every place the main path looks the
        # wrapper up
        self._sites = ((drf, "drf_water_fill", "drf_water_fill"),
                       (allocate, "type_tables", "type_tables"),
                       (allocate, "uniform_fill", "uniform_fill"),
                       (allocate, "sparse_accept", "sparse_accept"),
                       (victims, "cumsum_ds", "cumsum_ds"),
                       (victims, "freed_by_mask", "freed_by_mask"),
                       (stale, "freed_by_mask", "freed_by_mask"),
                       (victims, "replace_victims", "replace_victims"))
        self._orig = {k: getattr(mod, a) for mod, a, k in self._sites}
        self._saved = [(mod, a, getattr(mod, a)) for mod, a, _ in self._sites]

    @staticmethod
    def _clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(Capture._clone(v) for v in x)
        return x

    def __enter__(self):
        counters: dict[str, dict] = {}
        for mod, attr, name in self._sites:
            orig = self._orig[name]
            seen = self.calls.setdefault(name, [])
            counter = counters.setdefault(name, {"n": 0})

            def wrapped(*args, _orig=orig, _seen=seen, _c=counter,
                        _keep=self.keep.get(name, ()), **kw):
                if _c["n"] in _keep:
                    _seen.append((self._clone(args), self._clone(kw)))
                _c["n"] += 1
                return _orig(*args, **kw)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def _global_names(source: str) -> list[str]:
    """The ``__global__`` functions a kernel's CUDA source defines."""
    import re
    with open(os.path.join(ROOT, source)) as f:
        text = f.read()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)", text)


def in_cycle_device_ms(prof) -> dict[str, dict]:
    """Each kernel's device time and launches inside a profiled run, from
    the profiler's per-name totals (its ``__global__`` functions summed;
    K6's entry runs two)."""
    from kai_scheduler_tpu_torch import kernels
    totals: dict[str, tuple[int, float]] = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        name = e.key.split("(")[0].split()[-1] if e.key else ""
        c, t = totals.get(name, (0, 0.0))
        totals[name] = (c + e.count, t + us)
    out = {}
    for k, info in kernels.KERNELS.items():
        fns = _global_names(info.source)
        calls = [totals[f] for f in fns if f in totals]
        out[k] = dict(ms=sum(t for _, t in calls) / 1e3,
                      launches=max((c for c, _ in calls), default=0),
                      functions=fns)
    return out


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


def bound(nbytes: float, ops: float):
    """(ms, what bounds it): the larger of the bytes over the card's
    memory rate and the operations over its f32 rate."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel_checks(cap: Capture) -> dict:
    """Every kernel on the captured main-path inputs vs its plain version:
    equality, timings, and the least time the card could take."""
    from kai_scheduler_tpu_torch.ops import allocate as A
    from kai_scheduler_tpu_torch.ops import drf as D
    out = {}

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
#: the kernels an allocate-only cycle launches
ALLOCATE_KERNELS = ("drf_water_fill", "type_tables", "uniform_fill",
                    "sparse_accept")
#: the repo's worst-case production shape (bench.py's saturated cycle):
#: 40,000 running pods fill 10,000 nodes x 4 accelerators, 10,000 pending
#: pods wait in the other queues
SATURATED = dict(num_nodes=10_000, node_accel=4.0, num_gangs=6250,
                 tasks_per_gang=8, running_fraction=0.8,
                 queue_accel_quota=1000.0, partition_queues_by_running=True)
#: see fragmented_objects
FRAGMENTED = dict(num_nodes=10_000, pending=256, stale=16)
#: K5-K7 calls kept per victim cell (the first solve's tables, an early
#: and a later scenario mask, the first consolidation re-placements)
VICTIM_KEEP = {
    "saturated": {"cumsum_ds": (0, 1), "freed_by_mask": (0, 3)},
    "fragmented": {"cumsum_ds": (0,), "freed_by_mask": (1, 40),
                   "replace_victims": (0, 20)},
}


def fragmented_objects(apis, *, num_nodes: int, pending: int, stale: int,
                       node_accel: float = 8.0, victim_accel: float = 2.0,
                       pending_accel: float = 6.0, now: float = 1000.0):
    """A fragmented full cluster, built with the object API: every node
    runs two preemptible one-pod gangs of ``victim_accel``, created node
    by node (so newest-first victim ranks free one node at a time);
    ``pending`` one-pod gangs of ``pending_accel`` fit no node idle but fit
    the cluster's spare capacity; the first gang on each of the first
    ``stale`` nodes declares a quorum of 2 with one pod left, stale since
    ``now - 120`` s (past the 60 s grace).  One department and one leaf
    queue, every quota unlimited.  Returns ``(nodes, queues, groups, pods,
    now)``."""
    unl = apis.QueueResource(quota=-1.0)
    queues = [apis.Queue("dept", accel=unl),
              apis.Queue("q0", parent="dept", accel=unl)]
    nodes, groups, pods = [], [], []
    for i in range(num_nodes):
        node = f"node-{i}"
        nodes.append(apis.Node(node, apis.ResourceVec(node_accel, 64.0,
                                                      256.0),
                               labels={"kubernetes.io/hostname": node}))
        for j in range(2):
            name = f"run-{i}-{j}"
            is_stale = j == 0 and i < stale
            groups.append(apis.PodGroup(
                name, queue="q0", min_member=2 if is_stale else 1,
                creation_timestamp=float(2 * i + j),
                last_start_timestamp=float(2 * i + j),
                stale_since=now - 120.0 if is_stale else None))
            pods.append(apis.Pod(
                f"{name}-0", name,
                resources=apis.ResourceVec(victim_accel, 1.0, 4.0),
                status=apis.PodStatus.RUNNING, node=node,
                creation_timestamp=float(2 * i + j)))
    for k in range(pending):
        name = f"want-{k}"
        groups.append(apis.PodGroup(name, queue="q0", min_member=1,
                                    creation_timestamp=now + k))
        pods.append(apis.Pod(f"{name}-0", name,
                             resources=apis.ResourceVec(pending_accel, 1.0,
                                                        4.0),
                             creation_timestamp=now + k))
    return nodes, queues, groups, pods, now


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

# ---------------------------------------------------------------------------
# the victim cells
# ---------------------------------------------------------------------------

def victim_config():
    from kai_scheduler_tpu_torch.framework.scheduler import (DEFAULT_ACTIONS,
                                                             SchedulerConfig)
    from kai_scheduler_tpu_torch.framework.session import SessionConfig
    from kai_scheduler_tpu_torch.ops.victims import VictimConfig
    return SchedulerConfig(actions=DEFAULT_ACTIONS, session=SessionConfig(
        victims=VictimConfig(batch_size=1)))


def victim_cluster(cell: str):
    from kai_scheduler_tpu_torch.apis import types as apis
    from kai_scheduler_tpu_torch.runtime.cluster import Cluster
    from kai_scheduler_tpu_torch.state import make_cluster
    if cell == "saturated":
        return Cluster.from_objects(*make_cluster(**SATURATED))
    nodes, queues, groups, pods, now = fragmented_objects(apis,
                                                          **FRAGMENTED)
    cluster = Cluster.from_objects(nodes, queues, groups, pods)
    cluster.now = now
    return cluster


def run_victim_cycle(cell: str, device: str):
    from kai_scheduler_tpu_torch.framework.scheduler import Scheduler
    cluster = victim_cluster(cell)
    sched = Scheduler(victim_config(), device=device)
    t0 = time.perf_counter()
    res = sched.run_once(cluster)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, cluster, time.perf_counter() - t0


def _evictions(res):
    return [(e.pod_name, e.group, e.move_to) for e in res.evictions]


def _binds(brs):
    return [dataclasses.astuple(b) for b in brs]


def check_victim_cycle(cell: str, gpu, cpu, cluster, counts: dict) -> dict:
    """The GPU victim cycle equals the CPU oracle (packed commit, binds,
    evictions with move targets, move rebinds) and did the cell's work."""
    res, secs = gpu
    if res.packed.tobytes() != cpu.packed.tobytes():
        diff = int((res.packed != cpu.packed).sum())
        raise AssertionError(f"{cell}: packed commit differs from the CPU "
                             f"oracle in {diff} of {res.packed.size} i16")
    for what, a, b in (
            ("BindRequests", _binds(res.bind_requests),
             _binds(cpu.bind_requests)),
            ("evictions", _evictions(res), _evictions(cpu)),
            ("move rebinds", _binds(res.move_bind_requests),
             _binds(cpu.move_bind_requests))):
        if a != b:
            raise AssertionError(f"{cell}: {what} differ from the oracle")
    t = res.tensors
    if not bool(torch.isfinite(t.queue_allocated).all()):
        raise AssertionError(f"{cell}: non-finite queue allocation")
    moved = [e for e in res.evictions if e.move_to is not None]
    pipelined = int(t.pipelined.sum())
    stale_names = {f"run-{i}-0" for i in range(FRAGMENTED["stale"])}
    stale_ev = [e for e in res.evictions if e.group in stale_names]
    if cell == "saturated":
        need = ("cumsum_ds", "freed_by_mask", "type_tables", "uniform_fill")
        if not res.evictions or pipelined <= 0:
            raise AssertionError(f"{cell}: {len(res.evictions)} evictions, "
                                 f"{pipelined} pipelined placements")
    else:
        need = ("cumsum_ds", "freed_by_mask", "replace_victims",
                "type_tables", "uniform_fill")
        if not moved or not stale_ev:
            raise AssertionError(f"{cell}: {len(moved)} consolidation "
                                 f"moves, {len(stale_ev)} stale evictions")
        for e in moved:
            br = cluster.bind_requests.get(e.pod_name)
            if br is None or br.selected_node != e.move_to:
                raise AssertionError(f"{cell}: moved victim {e.pod_name} "
                                     f"not rebound on {e.move_to}")
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{cell}: kernels never launched: {missing}")
    return dict(
        cycle_seconds=secs, evictions=len(res.evictions),
        consolidation_moves=len(moved), stale_evictions=len(stale_ev),
        pipelined_tasks=pipelined, binds=len(res.bind_requests),
        move_rebinds=len(res.move_bind_requests),
        gangs_allocated=int(t.allocated.sum()),
        victim_stats={k: dataclasses.asdict(v)
                      for k, v in res.victim_stats.items()},
        action_seconds=res.action_seconds, phase_seconds=res.phase_seconds,
        launches=counts)


def _cpu_state(state):
    from kai_scheduler_tpu_torch.state import state_from_numpy, state_to_numpy
    return state_from_numpy(state_to_numpy(state), "cpu")


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def victim_kernel_checks(caps: dict) -> dict:
    """K5-K7 on the inputs captured from the victim cells vs their plain
    versions (run on CPU copies: the oracle), kernel and plain times on
    the card, the bound, and the nearest library call's time (NOT the same
    function: ``torch.cumsum`` is not compensated, ``index_add_`` adds in
    no fixed order)."""
    from kai_scheduler_tpu_torch.ops import victims as V
    from kai_scheduler_tpu_torch.utils import numerics as NU
    out = {}

    # K5 — read each element once, write once; ~20 f32 operations each
    # (a combine per up-sweep pair, one per even prefix, the final add)
    errs, big = [], None
    for cell in ("saturated", "fragmented"):
        for args, kw in caps[cell].calls.get("cumsum_ds", []):
            x = args[0]
            got = caps[cell]._orig["cumsum_ds"](x, **kw)
            errs.append(_max_abs_err(got.cpu(), NU.cumsum_ds_plain(x.cpu())))
            if big is None or x.numel() > big.numel():
                big = x
    k_ms = _time_ms(lambda: NU.cumsum_ds(big))
    p_ms = _time_ms(lambda: NU.cumsum_ds_plain(big), 5)
    lib_ms = _time_ms(lambda: torch.cumsum(big, 0))
    b, by = bound(2 * big.numel() * 4, 20 * big.numel())
    out["cumsum_ds"] = dict(
        max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b,
        bound_by=by, nearest_library_ms=lib_ms,
        nearest_library="torch.cumsum (plain f32, not compensated)",
        shape=f"U={big.shape[0]} C={big[0].numel()}")

    # K6 — the mask, the masked pods' rows and the five outputs once each;
    # a few adds per masked pod plus the chain roll-up
    errs, rec = [], None
    for cell in ("saturated", "fragmented"):
        for args, kw in caps[cell].calls.get("freed_by_mask", []):
            state, mask, chain = args[:3]
            got = caps[cell]._orig["freed_by_mask"](*args, **kw)
            cst = _cpu_state(state)
            errs.append(_max_abs_err(_to_cpu(got), V.freed_by_mask_plain(
                cst, mask.cpu(), chain.cpu())))
            if rec is None or int(mask.sum()) > int(rec[0][1].sum()):
                rec = (args, kw, cell)
    (state, mask, chain, *rest), kw, cell = rec
    pods = V.PodIndex.of(state)
    k_ms = _time_ms(lambda: V.freed_by_mask(state, mask, chain, pods))
    p_ms = _time_ms(lambda: V.freed_by_mask_plain(state, mask, chain), 5)
    r, n, q = state.running, state.nodes, state.queues
    N, D, Q, E, R_ = n.n, n.d, q.q, r.extended.shape[1], r.req.shape[1]
    seg = torch.where(mask, torch.clamp(r.node, min=0), N).long()
    req_m = torch.where(mask[:, None], r.req, 0.0)

    def library():
        torch.zeros((N + 1, R_), device=mask.device).index_add_(0, seg, req_m)
    lib_ms = _time_ms(library)
    nm = int(mask.sum())
    row = 12 + 4 + 4 + 4 + 1 + 4 + 4 + 4 * E
    nbytes = r.m + nm * row + (N * R_ + N * D + 2 * Q * R_ + N * E) * 4
    b, by = bound(nbytes, nm * (3 * R_ + D + E) + 4 * Q * Q * R_)
    out["freed_by_mask"] = dict(
        max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b,
        bound_by=by, nearest_library_ms=lib_ms,
        nearest_library="index_add_ of the [N, R] node table only "
                        "(atomic order)",
        shape=f"M={r.m} masked={nm} N={N} Q={Q} ({cell})")

    # K7 — the node pools once, the victims' rows, the outputs once; per
    # victim and node ~(3R + 3D + 2E + 12) operations for the fit test
    errs, rec = [], None
    for args, kw in caps["fragmented"].calls.get("replace_victims", []):
        got = caps["fragmented"]._orig["replace_victims"](*args, **kw)
        cst = _cpu_state(args[0])
        errs.append(_max_abs_err(_to_cpu(got), V.replace_victims_plain(
            cst, *_to_cpu(args[1:]), **kw)))
        if rec is None or int(args[1].sum()) > int(rec[0][1].sum()):
            rec = (args, kw)
    args, kw = rec
    state, mask = args[0], args[1]
    k_ms = _time_ms(lambda: V.replace_victims(*args, **kw))
    p_ms = _time_ms(lambda: V.replace_victims_plain(*args, **kw), 5)
    r, n = state.running, state.nodes
    N, D, E, R_ = n.n, n.d, r.extended.shape[1], r.req.shape[1]
    nv = min(int(mask.sum()), max(1, min(r.m, args[-1])))
    pools = N * (2 * R_ + 2 * D + 2 * E + 1) * 4 + N * 2
    nbytes = pools + r.m + nv * (28 + 4 * E) + N * (R_ + D + E) * 4 + r.m * 4
    b, by = bound(nbytes, nv * N * (3 * R_ + 3 * D + 2 * E + 12))
    out["replace_victims"] = dict(
        max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b,
        bound_by=by, nearest_library_ms=None, nearest_library=None,
        shape=f"victims={nv} N={N} D={D}")
    return out



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
    with Capture(Capture.ALLOCATE_KEEP) as cap:
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
            missing = [k for k in ALLOCATE_KERNELS if counts[k] <= 0]
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

    # -- 5. the victim cells: one GPU run each (counts reset just before,
    # read just after), one CPU oracle run --------------------------------
    # (a first GPU run, not timed, under the profiler's CUDA activity
    # with K5-K7's inputs captured, gives each kernel's in-cycle device
    # time)
    from torch.profiler import ProfilerActivity, profile
    caps = {}
    for cell in ("saturated", "fragmented"):
        with Capture(VICTIM_KEEP[cell]) as cap, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_victim_cycle(cell, "cuda")
        in_cycle = in_cycle_device_ms(prof)
        del prof
        kernels.reset_launch_counts()
        res, cluster, secs = run_victim_cycle(cell, "cuda")
        counts = kernels.launch_counts()
        cpu, _, cpu_s = run_victim_cycle(cell, "cpu")
        rec = check_victim_cycle(cell, (res, secs), cpu, cluster, counts)
        rec.update(cpu_oracle_seconds=cpu_s, in_cycle_ms=in_cycle)
        report[cell] = rec
        caps[cell] = cap
        log(f"{cell}: {secs:.3f} s cycle, {rec['evictions']} evictions "
            f"({rec['consolidation_moves']} consolidation moves, "
            f"{rec['stale_evictions']} stale), {rec['pipelined_tasks']} "
            f"pipelined tasks, {rec['binds']} binds, {rec['move_rebinds']} "
            f"move rebinds, {rec['gangs_allocated']} gangs allocated; "
            f"launches {counts}; commit, binds and evictions == CPU oracle "
            f"({cpu_s:.1f} s)")
        for act, sec in res.action_seconds.items():
            st = rec["victim_stats"].get(act)
            extra = (f"{st['steps']} steps, {st['attempts']} scenario "
                     f"attempts, {st['syncs']} host syncs, " if st else "")
            log(f"  {cell} action {act}: {extra}{sec:.4f} s")
        log("  phases: " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec["phase_seconds"].items()))
        log("  in-cycle kernel device ms / launches (profiled run): "
            + ", ".join(f"{k} {v['ms']:.3f} / {v['launches']}"
                        for k, v in in_cycle.items() if v["launches"]))
    checks.update(victim_kernel_checks(caps))
    #: the main path each kernel's launches are read from
    path_of = {k: ("headline", launches) for k in ALLOCATE_KERNELS}
    path_of.update(cumsum_ds=("saturated", report["saturated"]["launches"]),
                   freed_by_mask=("saturated",
                                  report["saturated"]["launches"]),
                   replace_victims=("fragmented",
                                    report["fragmented"]["launches"]))

    for name, c in checks.items():
        cell, counts = path_of[name]
        lib = ("" if c.get("nearest_library_ms") is None else
               f", nearest library call {c['nearest_library']}: "
               f"{c['nearest_library_ms']:.4f} ms")
        in_cyc = ", ".join(
            f"{v} {report[v]['in_cycle_ms'][name]['ms']:.3f} ms / "
            f"{report[v]['in_cycle_ms'][name]['launches']} launches"
            for v in ("saturated", "fragmented"))
        log(f"kernel {name}: equal to its plain version (max_abs_err "
            f"{c['max_abs_err']}), {c['ms']:.4f} ms kernel, "
            f"{c['plain_ms']:.4f} ms plain, {counts[name]} launches per "
            f"{cell} cycle, bound {c['bound_ms']:.6f} ms by "
            f"{c['bound_by']} [{c['shape']}]{lib}; in-cycle device time "
            f"in the profiled victim runs: {in_cyc}")
    log(f"launch floor (one PyTorch call on one element): "
        f"{report['launch_floor_ms']:.4f} ms")
    report["kernel_checks"] = checks
    rows = []
    for name, info in kernels.KERNELS.items():
        c = checks[name]
        cell, counts = path_of[name]
        rows.append(dict(name=name, route="cuda", source=info.source,
                         replaces=info.replaces, launches=counts[name],
                         max_abs_err=c["max_abs_err"], ms=c["ms"],
                         plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                         bound_by=c["bound_by"], library_ms=None,
                         launches_path=cell,
                         nearest_library_ms=c.get("nearest_library_ms"),
                         in_cycle_ms={v: report[v]["in_cycle_ms"][name]["ms"]
                                      for v in ("saturated",
                                                "fragmented")}))
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
