"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kai_scheduler_tpu_torch`` end to end on the card and fails
(non-zero exit, no result line) on any build error, launch error or
mismatch:

1. builds the hand-written CUDA kernels K1-K13 from ``csrc/`` (one
   ``nvcc`` per source, all started together; fourteen entry points: K11
   is a build and an update) and prints the card's name and power limit;
2. runs one warm-up allocate cycle of the headline cluster (10,000 nodes
   x 6,250 gangs x 8 replicas = 50,000 pending pods) through
   ``Scheduler(device="cuda").run_once``, capturing the inputs each
   allocate kernel's wrapper receives on the main path (allocate only:
   ``SchedulerConfig(actions=("allocate",))``); then holds K1-K4
   against their plain PyTorch versions on those inputs (bit-exact:
   tolerance 0) and times both with CUDA events;
3. runs the headline cycle again five times, timed, each on a fresh
   cluster with the launch counts reset just before and read just after;
   every allocate kernel must have launched in every run; every packed
   i16 commit must equal, byte for byte, the CPU oracle's (the same cycle
   with ``device="cpu"``, i.e. the kernels' plain versions);
4. does the same (three runs) on a contended cluster: the same backlog
   on 4,000 nodes, four departments of four queues, three priorities;
5. runs the *sharing* cell, allocate only, on the per-task path: a
   GPU-sharing fleet of 10,000 nodes x 8 devices (80 GiB each), a
   half-used device 0 on the first 5,000; pending training gangs of 8
   whole-device pods, one-pod fractions (0.5), one-pod memory-based shares
   (24 GiB) and launcher-plus-workers gangs in the proportions 2,500 :
   16,000 : 8,000 : 1,000, cut by ``SHARING_CUT`` — a warm-up run under
   the profiler's CUDA activity with K9's (``pertask_fill``) and K10's
   (``dense_accept``) inputs captured, then three timed runs on fresh
   clusters with the launch counts reset just before and read just
   after; K9 and K10 must launch in every run, and the packed commit, the
   BindRequests and their device indices must equal the CPU oracle's;
   then K9 and K10 are held against their plain versions on the captured
   inputs (tolerance 0) and timed;
6. runs the two topology cells, allocate only, the same way (a profiled
   warm-up with the inputs captured, three timed runs on fresh clusters
   with the counts reset just before and read just after, one CPU oracle
   run; every commit, BindRequest and retry count equal to the oracle's,
   every bound gang — every subgroup — in one rack; each mode below
   launched in every timed run, by the counts its wrapper takes per mode
   at the launch):
   - *topology*: BASELINE config 4, uncut — 5,000 nodes in 8 blocks x 16
     racks, 2,500 rack-required gangs of 8 replicas — the uniform path
     with the domain tables (K11), K3's topology mode and K10 without the
     device table;
   - *topology_subgroups*: the per-task path on the same tree, racks of
     different fill, mixed gangs and two-subgroup gangs each required at
     the rack level (the gang preferring its block), 600 gangs —
     K9's subgroup-topology mode (64 lanes) with the in-cycle retry,
     K10;
   then K11, K3's topology and preferred modes, K9's topology and banned
   modes (the retry on its first launch's scratch and on its own) and
   K10's mode without the device table are held against their plain
   versions on the captured inputs (tolerance 0) and timed;
7. runs the five default actions (allocate, consolidation, reclaim,
   preempt, stalegangeviction) on four victim cells: first a run under
   the profiler's CUDA activity with K5-K8's (and the victim wavefront's
   K2-K4) inputs captured (each kernel's in-cycle device time), then the
   timed run on a fresh cluster with the launch counts reset just before
   and read just after:
   - *saturated* (the repo's worst-case production shape) at the default
     ``SchedulerConfig()``: 10,000 nodes x 4 accelerators filled by
     40,000 running pods, 10,000 pending pods in the other queues —
     reclaim must evict, through the chunked wavefront (64 lanes);
   - *saturated_sequential*: the same cell at ``VictimConfig(
     batch_size=1)``, the sequential engine, its depth cut to 128
     preemptors per queue (``queue_depth``);
   - *preempt_many_queues* (``bench.py``'s many-tenant preempt shape,
     the preempt action alone as there) at the default VictimConfig:
     80,000 running pods fill 10,000 nodes x 8 accelerators, 512 leaf
     queues each hold one boosted 8-pod preemptor — preempt must evict,
     through the sparse wavefront (256 lanes);
   - *fragmented* at the default config: 10,000 nodes x 8 accelerators,
     each running two one-pod gangs of 2; 256 pending one-pod gangs of 6
     fit no node idle — consolidation (sequential) must move victims; 16
     running gangs below their quorum past the grace period —
     stalegangeviction must evict;
   the packed commit, BindRequests, evictions (pod, move target) and
   move rebinds must equal the CPU oracle's; then K5-K8 and the victim
   modes of K2-K4 (per-lane pools, per-lane queue tables and score bias,
   the freed credit) are held against their plain versions on the
   captured inputs and timed;
8. runs the four affinity cells (in-cycle affinity terms: cross-gang
   required anti-affinity, anchors with dependers, shared host ports) the
   same way — a profiled warm-up with the inputs captured, timed runs on
   fresh clusters with the counts reset just before and read just after,
   one CPU oracle run; every commit, BindRequest, eviction, chunk count and
   the claimed-domain table ``anti_used`` equal to the oracle's, no host
   holding two placed pods of one anti term, every placed depender beside
   its anchor; each cell's kernels and modes launched in every timed run:
   - *affinity* (allocate only, the uniform path, uncut, five timed runs):
     the headline backlog as 64 services (one replica per host across a
     service's gangs), 256 anchors, 256 four-pod dependers, 512 gangs on
     host port 8443 — K12, K13, K3's mask mode, K1, K2, K4;
   - *affinity_reclaim* (the saturated shape at the default config, one
     timed run): the pending gangs in 64 services — reclaim's wavefront
     with K3's lane and mask modes, K8, K12, K13;
   - *affinity_reclaim_sequential* (the same on the sequential victim
     engine, cut as saturated_sequential is, one timed run): reclaim's
     scenario search confined to each preemptor's one-lane mask — K12 at
     one lane, K3's mask mode, K5, K6, K13 after every step;
   - *affinity_sharing* (allocate only, the per-task path, three timed
     runs): the sharing fleet with 128 one-pod 0.5 fractions in 16
     services and 32 whole-device gangs on one host port (both cut by
     two) — K9's mask mode, K10, K12, K13;
   then K12, K13 and the mask modes of K3 and K9 are held against their
   plain versions on the captured inputs (tolerance 0) and timed;
9. prints one JSON line of per-kernel numbers (a row per kernel and per
   topology and mask mode), the card line, and last ``{"ok": true,
   "device": {...}}``.

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
        # (module, attribute, key): every place the main path looks the
        # wrapper up; the victim wavefront's calls of K2-K4 get keys of
        # their own (their per-lane modes)
        self._sites = ((drf, "drf_water_fill", "drf_water_fill"),
                       (allocate, "type_tables", "type_tables"),
                       (allocate, "uniform_fill", "uniform_fill"),
                       (allocate, "sparse_accept", "sparse_accept"),
                       (victims, "cumsum_ds", "cumsum_ds"),
                       (victims, "freed_by_mask", "freed_by_mask"),
                       (stale, "freed_by_mask", "freed_by_mask"),
                       (victims, "replace_victims", "replace_victims"),
                       (victims, "freed_by_lane", "freed_by_lane"),
                       (victims, "type_tables", "type_tables:lanes"),
                       (victims, "uniform_fill", "uniform_fill:lanes"),
                       (victims, "sparse_accept", "sparse_accept:credit"),
                       (allocate, "pertask_fill", "pertask_fill"),
                       (allocate, "dense_accept", "dense_accept"),
                       (allocate, "topo_tables_build", "topo_tables_build"),
                       (allocate, "topo_tables_update",
                        "topo_tables_update"),
                       (allocate, "affinity_mask", "affinity_mask"),
                       (allocate, "anti_mark", "anti_mark"),
                       (victims, "affinity_mask", "affinity_mask:victims"),
                       (victims, "anti_mark", "anti_mark:victims"))
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


#: entry points that share a source with another one: their functions
SOURCE_FUNCTIONS = {
    "topo_tables_build": ("tt_counts_kernel", "tt_domains_kernel"),
    "topo_tables_update": ("tt_update_kernel",),
    "affinity_mask": ("affinity_mask_kernel",),
    "anti_mark": ("anti_mark_kernel",)}


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
        fns = SOURCE_FUNCTIONS.get(k) or _global_names(info.source)
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
#: the repo's many-tenant preempt shape (bench.py's preempt_many_queues):
#: 80,000 running pods fill 10,000 nodes x 8 accelerators; 512 leaf
#: queues each hold one boosted 8-pod preemptor
PREEMPT_MANY = dict(num_nodes=10_000, node_accel=8.0, num_gangs=10_512,
                    tasks_per_gang=8, running_fraction=10_000 / 10_512,
                    num_departments=2, queues_per_department=256,
                    pending_priority_boost=100)
#: see ``state.fleets.fragmented_objects``
FRAGMENTED = dict(num_nodes=10_000, pending=256, stale=16)
#: the victim cells, in the order they run: (cluster, victim wavefront
#: width — None for the default VictimConfig, 1 for the sequential engine)
VICTIM_CELLS = {"saturated": ("saturated", None),
                "saturated_sequential": ("saturated", 1),
                "preempt_many_queues": ("preempt_many_queues", None),
                "fragmented": ("fragmented", None)}
#: the sequential cell's depth cut: reclaim attempts at most this many
#: preemptors per queue (the cell's 1,250 pending gangs wait in two
#: queues), about a fifth of the full run's steps, so that the script
#: stays within half its time limit
SEQUENTIAL_QUEUE_DEPTH = 128
#: the preempt cell runs the preempt action alone, as the repo's own
#: benchmark of this shape does (bench.py bench_preempt_many_queues); in
#: the five-action cycle reclaim first spends 512 one-lane chunks on it
CELL_ACTIONS = {"preempt_many_queues": ("preempt",)}
#: kernel calls kept per victim cell (the first solve's tables, an early
#: and a later scenario mask, the first consolidation re-placements; the
#: wavefront's first chunks)
_LANES = {"freed_by_lane": (0, 1, 2), "type_tables:lanes": (0, 1, 2),
          "uniform_fill:lanes": (0, 1, 2), "sparse_accept:credit": (0, 1)}
VICTIM_KEEP = {
    "saturated": dict(_LANES),
    "saturated_sequential": {"cumsum_ds": (0, 1), "freed_by_mask": (0, 3)},
    "preempt_many_queues": dict(_LANES),
    "fragmented": {"cumsum_ds": (0,), "freed_by_mask": (1, 40),
                   "replace_victims": (0, 20)},
}
#: the kernels each victim cell must launch
VICTIM_NEED = {
    "saturated": ("cumsum_ds", "freed_by_mask", "freed_by_lane",
                  "type_tables", "uniform_fill"),
    "saturated_sequential": ("cumsum_ds", "freed_by_mask", "type_tables",
                             "uniform_fill"),
    "preempt_many_queues": ("cumsum_ds", "freed_by_lane", "type_tables",
                            "uniform_fill", "sparse_accept"),
    "fragmented": ("cumsum_ds", "freed_by_mask", "replace_victims",
                   "type_tables", "uniform_fill"),
}


#: the GPU-sharing cell at full size: 10,000 nodes x 8 devices of 80 GiB,
#: a half-used device 0 on the first 5,000; pending 2,500 training gangs
#: of 8 whole-device pods, 16,000 one-pod fractions (0.5), 8,000 one-pod
#: memory-based shares (24 GiB = 0.3 of a device) and 1,000 launchers
#: with 5 one-device workers — 50,000 pods, 35,400 devices of demand
SHARING_FULL = dict(training=2_500, fractions=16_000, memory=8_000,
                    launchers=1_000)
#: the common factor the four gang counts are cut by: the per-task
#: wavefront accepts about two lanes a chunk on this fleet (binpack sends
#: every lane of a type to the same fullest node), so the full backlog is
#: thousands of chunks, and the CPU oracle's plain versions take a large
#: fraction of a second a chunk at 10,000 nodes x 256 lanes
SHARING_CUT = 25
SHARING = dict(num_nodes=10_000, shared_nodes=5_000,
               **{k: v // SHARING_CUT for k, v in SHARING_FULL.items()})
SHARING_RUNS = 3
#: K9 and K10 calls kept in the sharing warm-up: the first chunk (every
#: lane on the fresh fleet) and a later one
SHARING_KEEP = {"pertask_fill": (0, 20), "dense_accept": (0, 20)}
#: the kernels a sharing (per-task) allocate cycle launches
SHARING_KERNELS = ("drf_water_fill", "pertask_fill", "dense_accept")
#: the topology cell: BASELINE config 4 (bench.py:240), uncut — 5,000
#: nodes of 8 accelerators in 8 blocks x 16 racks, 2,500 rack-required
#: gangs of 8 replicas (20,000 pods); the uniform path with the domain
#: tables (K11), K3's topology mode and the dense accept (K10)
TOPOLOGY = dict(num_nodes=5_000, node_accel=8.0, num_gangs=2_500,
                tasks_per_gang=8, topology_levels=(8, 16),
                required_level="topo/level1")
TOPOLOGY_RUNS = 3
#: kernel calls kept in its warm-up: the build, the first and the fifth
#: chunk
TOPOLOGY_KEEP = {"topo_tables_build": (0,), "topo_tables_update": (0, 4),
                 "uniform_fill": (0, 4), "dense_accept": (0, 4)}
TOPOLOGY_KERNELS = ("drf_water_fill", "type_tables", "uniform_fill",
                    "uniform_fill:topology", "dense_accept",
                    "dense_accept:no_devices", "topo_tables_build",
                    "topo_tables_update")
#: the topology_subgroups cell (the per-task path) on the same tree:
#: ``state.fleets.topology_subgroup_objects`` with 600 gangs, uncut — a
#: cycle is one chunk per one to two gangs (every lane's domain-binpack
#: band picks the same fullest fitting rack), and the CPU oracle's plain
#: K9 takes about 0.12 s a chunk at 5,000 nodes x 64 lanes on the card's
#: host (20.7 s for 300 gangs), within the 120 s the oracle may take
TOPO_SUB = dict(num_nodes=5_000, levels=(8, 16), gangs=600)
TOPO_SUB_RUNS = 3
#: K9's calls alternate between a chunk's first attempt and its retry
#: launch: keep the first chunk's pair and the twentieth's
TOPO_SUB_KEEP = {"pertask_fill": (0, 1, 40, 41), "dense_accept": (0, 20)}
TOPO_SUB_KERNELS = ("drf_water_fill", "pertask_fill",
                    "pertask_fill:topology", "pertask_fill:banned",
                    "dense_accept")
#: the affinity cell (allocate only, the uniform path, uncut): the headline
#: backlog (10,000 nodes, 6,250 gangs of 8) as 64 services whose replicas
#: keep one per host across gangs (a required hostname anti term against
#: their own ``app``), 256 anchors, 256 four-pod dependers each needing its
#: anchor's host, 512 one-pod gangs sharing host port 8443 — 51,792 pods,
#: 321 term rows (padded to 512); K3's mask mode, K12, K13, K1, K2, K4
AFFINITY = dict(num_nodes=10_000, node_accel=8.0, num_gangs=6250,
                tasks_per_gang=8, services=64, anchors=256, dependers=256,
                port_gangs=512)
AFFINITY_RUNS = 5
#: the affinity_reclaim cell: the saturated shape at the default config,
#: its 1,250 pending gangs in 64 services with a required hostname anti
#: term against their own ``app`` (the running pods carry none); reclaim's
#: wavefront with K3's lane and mask modes, K8, K12, K13
AFFINITY_RECLAIM = dict(SATURATED, services=64)
#: the affinity_sharing cell (allocate only, the per-task path):
#: ``sharing_objects``' fleet with 256 one-pod 0.5-fraction gangs in 16
#: services (hostname anti term against their own ``app``) and 64 one-pod
#: whole-device gangs sharing host port 8443; K9's mask mode, K10, K12,
#: K13.  Both counts are cut by ``AFFINITY_SHARING_CUT``: the script ran
#: 927 s with them uncut, over its 900 s aim, and this cell cuts first
AFFINITY_SHARING_FULL = dict(fractions=256, port_gangs=64)
AFFINITY_SHARING_CUT = 2
AFFINITY_SHARING = dict(num_nodes=10_000, shared_nodes=5_000, services=16,
                        **{k: v // AFFINITY_SHARING_CUT
                           for k, v in AFFINITY_SHARING_FULL.items()})
AFFINITY_SHARING_RUNS = 3
#: per cell: (timed runs, kernel calls kept in its warm-up, the kernels
#: and modes every timed run must launch)
AFFINITY_CELLS = {
    "affinity": (AFFINITY_RUNS, {"affinity_mask": (0, 60),
                                 "anti_mark": (0, 60),
                                 "uniform_fill": (0, 60)},
                 ("drf_water_fill", "type_tables", "uniform_fill",
                  "uniform_fill:mask", "sparse_accept", "affinity_mask",
                  "anti_mark")),
    "affinity_reclaim": (1, {"affinity_mask:victims": (0, 1, 2),
                             "anti_mark:victims": (0, 1, 2),
                             "uniform_fill:lanes": (0, 1, 2)},
                         ("cumsum_ds", "freed_by_lane", "type_tables",
                          "type_tables:lanes", "uniform_fill",
                          "uniform_fill:lanes", "uniform_fill:mask",
                          "affinity_mask", "anti_mark")),
    # the affinity_reclaim fleet on the sequential victim engine, cut as
    # saturated_sequential is (``SEQUENTIAL_QUEUE_DEPTH``): reclaim's
    # scenario search confined to each preemptor's one-lane mask (K12 at
    # one lane, K3's mask mode through ``attempt_gang_dense``), every step
    # marked by K13
    "affinity_reclaim_sequential": (
        1, {"affinity_mask:victims": (0, 1, 2),
            "anti_mark:victims": (0, 1, 2), "uniform_fill": (0, 1, 2)},
        ("cumsum_ds", "freed_by_mask", "type_tables", "uniform_fill",
         "uniform_fill:mask", "affinity_mask", "anti_mark")),
    "affinity_sharing": (AFFINITY_SHARING_RUNS,
                         {"affinity_mask": (0, 30), "anti_mark": (0, 30),
                          "pertask_fill": (0, 30)},
                         ("drf_water_fill", "pertask_fill",
                          "pertask_fill:mask", "dense_accept",
                          "affinity_mask", "anti_mark")),
}
#: the cells with a profiled run (each kernel's in-cycle device time)
PROFILED_CELLS = ("sharing", "topology", "topology_subgroups", "saturated",
                  "saturated_sequential", "preempt_many_queues",
                  "fragmented", *AFFINITY_CELLS)


def fresh_cluster(shape: dict):
    from kai_scheduler_tpu_torch.runtime.cluster import Cluster
    from kai_scheduler_tpu_torch.state import make_cluster
    return Cluster.from_objects(*make_cluster(**shape))


def run_cycle(shape: dict, device: str):
    from kai_scheduler_tpu_torch.framework.scheduler import (Scheduler,
                                                             SchedulerConfig)
    cluster = fresh_cluster(shape)
    t0 = time.perf_counter()
    res = Scheduler(SchedulerConfig(actions=("allocate",)),
                    device=device).run_once(cluster)
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
# the GPU-sharing cell (the per-task path)
# ---------------------------------------------------------------------------

def sharing_cluster():
    from kai_scheduler_tpu_torch.apis import types as apis
    from kai_scheduler_tpu_torch.runtime.cluster import Cluster
    from kai_scheduler_tpu_torch.state.fleets import sharing_objects
    return Cluster.from_objects(*sharing_objects(apis, **SHARING))


def run_sharing_cycle(device: str):
    from kai_scheduler_tpu_torch.framework.scheduler import (Scheduler,
                                                             SchedulerConfig)
    cluster = sharing_cluster()
    t0 = time.perf_counter()
    res = Scheduler(SchedulerConfig(actions=("allocate",)),
                    device=device).run_once(cluster)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, cluster, time.perf_counter() - t0


def check_sharing_cycle(gpu, cpu, cluster, counts: dict) -> dict:
    """The GPU sharing cycle equals the CPU oracle (packed commit,
    BindRequests with their device indices), every bound gang is whole,
    fractions bind to a device, and K9 and K10 launched."""
    res, secs = gpu
    if res.packed.tobytes() != cpu.packed.tobytes():
        diff = int((res.packed != cpu.packed).sum())
        raise AssertionError(f"sharing: packed commit differs from the CPU "
                             f"oracle in {diff} of {res.packed.size} i16")
    if _binds(res.bind_requests) != _binds(cpu.bind_requests):
        raise AssertionError("sharing: BindRequests (or their device "
                             "indices) differ from the oracle")
    per_gang: dict[str, int] = {}
    frac = 0
    for br in res.bind_requests:
        pod = cluster.pods[br.pod_name]
        per_gang[pod.group] = per_gang.get(pod.group, 0) + 1
        if pod.accel_portion > 0 or pod.accel_memory_gib > 0:
            frac += 1
            if len(br.selected_accel_groups) != 1:
                raise AssertionError(f"sharing: fraction {br.pod_name} "
                                     f"bound without one device")
    for g, n in per_gang.items():
        if n != cluster.pod_groups[g].min_member:
            raise AssertionError(f"sharing: gang {g} bound {n} of "
                                 f"{cluster.pod_groups[g].min_member} pods")
    missing = [k for k in SHARING_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"sharing: kernels never launched: {missing}")
    if frac == 0:
        raise AssertionError("sharing: no fractional binds")
    t = res.tensors
    if not bool(torch.isfinite(t.queue_allocated).all()):
        raise AssertionError("sharing: non-finite queue allocation")
    return dict(
        cycle_seconds=secs, binds=len(res.bind_requests),
        fractional_binds=frac, pods_bound_per_s=len(res.bind_requests) / secs,
        gangs_allocated=int(t.allocated.sum()),
        gangs_attempted=int(t.attempted.sum()),
        fit_reason_counts={int(k): int(v) for k, v in zip(
            *torch.unique(t.fit_reason.cpu(), return_counts=True))},
        chunks=res.chunks, phase_seconds=res.phase_seconds,
        action_seconds=res.action_seconds, shape=SHARING, launches=counts)


def sharing_kernel_checks(cap: Capture) -> dict:
    """K9 and K10 on the inputs captured from the sharing warm-up vs their
    plain versions, both on the card (tolerance 0), kernel and plain
    times, and the least time the card could take for these inputs."""
    from kai_scheduler_tpu_torch.ops import allocate as A
    out = {}

    # K9 — reads the node tables and the lanes' gang rows once, writes the
    # lane outputs; per task step that placed, ~60 f32 operations a node
    # (the fit on both pools with the device table, the bands, the score)
    errs = []
    for args, kw in cap.calls["pertask_fill"]:
        k_out = cap._orig["pertask_fill"](*args, **kw).fields()
        p_out = A.pertask_fill_plain(*args, **kw).fields()
        errs.append(_max_abs_err(k_out, p_out))
    args, kw = cap.calls["pertask_fill"][0]
    nodes, tt, cand, prior, free, dev, qa = args[:7]
    B, T = prior.shape
    N, D = dev.shape
    Q = qa.shape[0]
    steps = int((A.pertask_fill_plain(*args, **kw).nodes_t
                 >= 0).sum())
    ms = _time_ms(lambda: cap._orig["pertask_fill"](*args, **kw))
    plain_ms = _time_ms(
        lambda: A.pertask_fill_plain(*args, **kw), 5)
    K = nodes.labels.shape[1]
    X = nodes.filter_masks.shape[0]
    L = nodes.topology.shape[1]
    node_bytes = N * (5 * 12 + 3 * 4 * D + 1 + 4 * K + 5 * X + 4 + 4 * L)
    lane_bytes = B * (8 + T * (12 + 1 + 4 * K + 4 * 5))
    out_bytes = B * (2 * Q * 12 + T * 9 + 1 + T * (24 + 8 * D))
    b, by = bound(node_bytes + lane_bytes + out_bytes, steps * N * 60)
    out["pertask_fill"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b,
        bound_by=by, checked=len(errs),
        shape=f"B={B} T={T} N={N} D={D} Q={Q} placed steps={steps}")

    # K10 — the touched entries' rows and the pools at their nodes once,
    # the lane deltas of the queue tables once; per touching (lane, node)
    # ~2 (6 + 2 D) operations for the cumulative tests and the commit
    errs = []
    for args, kw in cap.calls["dense_accept"]:
        k_out = cap._orig["dense_accept"](*args, **kw)
        p_out = A.dense_accept_plain(*args, **kw)
        errs.append(_max_abs_err(k_out, p_out))
    args, kw = cap.calls["dense_accept"][0]
    nodes_b, ok = args[0], args[1]
    B, T = nodes_b.shape
    D = args[8].shape[1]
    Q = args[13].shape[0]
    ent = ok[:, None] & (nodes_b >= 0)
    E = int(ent.sum())
    U = int(torch.unique(nodes_b[ent]).numel())
    ms = _time_ms(lambda: cap._orig["dense_accept"](*args, **kw))
    plain_ms = _time_ms(lambda: A.dense_accept_plain(*args, **kw), 5)
    nb = (B * T * (4 + 2 * 12 + 2 * 4 * D) + U * 2 * (2 * 12 + 2 * 4 * D)
          + B * (2 + 2 * Q * 12) + 4 * Q * 12)
    b, by = bound(nb, E * 2 * (6 + 2 * D))
    out["dense_accept"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b,
        bound_by=by, checked=len(errs),
        shape=f"B={B} T={T} D={D} Q={Q} entries={E} nodes={U}")
    return out


# ---------------------------------------------------------------------------
# the topology cells (required, subgroup and preferred levels)
# ---------------------------------------------------------------------------

def topology_cluster(cell: str):
    from kai_scheduler_tpu_torch.apis import types as apis
    from kai_scheduler_tpu_torch.runtime.cluster import Cluster
    from kai_scheduler_tpu_torch.state import make_cluster
    from kai_scheduler_tpu_torch.state import fleets
    if cell == "topology":
        return Cluster.from_objects(*make_cluster(**TOPOLOGY))
    return Cluster.from_objects(*fleets.topology_subgroup_objects(
        apis, make_cluster, **TOPO_SUB))


def run_topology_cycle(cell: str, device: str):
    from kai_scheduler_tpu_torch.framework.scheduler import (Scheduler,
                                                             SchedulerConfig)
    cluster = topology_cluster(cell)
    t0 = time.perf_counter()
    res = Scheduler(SchedulerConfig(actions=("allocate",)),
                    device=device).run_once(cluster)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, cluster, time.perf_counter() - t0


def check_topology_cycle(cell: str, gpu, cpu, cluster, counts: dict) -> dict:
    """The GPU topology cycle equals the CPU oracle (packed commit,
    BindRequests, retries), every bound gang is whole and every bound
    gang — every subgroup, where the gang declares them — sits in one rack
    (``topo/level1`` under its ``topo/level0`` block), and the cell's
    kernels launched."""
    res, secs = gpu
    if res.packed.tobytes() != cpu.packed.tobytes():
        diff = int((res.packed != cpu.packed).sum())
        raise AssertionError(f"{cell}: packed commit differs from the CPU "
                             f"oracle in {diff} of {res.packed.size} i16")
    if _binds(res.bind_requests) != _binds(cpu.bind_requests):
        raise AssertionError(f"{cell}: BindRequests differ from the oracle")
    if (res.retries, res.retry_chunks) != (cpu.retries, cpu.retry_chunks):
        raise AssertionError(
            f"{cell}: {res.retries} retries in {res.retry_chunks} chunks, "
            f"the oracle {cpu.retries} in {cpu.retry_chunks}")
    per_gang: dict[str, int] = {}
    racks: dict[tuple, set] = {}
    for br in res.bind_requests:
        pod = cluster.pods[br.pod_name]
        per_gang[pod.group] = per_gang.get(pod.group, 0) + 1
        labels = cluster.nodes[br.selected_node].labels
        rack = (labels["topo/level0"], labels["topo/level1"])
        racks.setdefault((pod.group, pod.subgroup), set()).add(rack)
    for g, n in per_gang.items():
        if n != cluster.pod_groups[g].min_member:
            raise AssertionError(f"{cell}: gang {g} bound {n} of "
                                 f"{cluster.pod_groups[g].min_member} pods")
    spread = [k for k, v in racks.items() if len(v) != 1]
    if spread:
        raise AssertionError(f"{cell}: {len(spread)} rack-required gangs "
                             f"or subgroups span racks, e.g. {spread[0]}")
    need = TOPOLOGY_KERNELS if cell == "topology" else TOPO_SUB_KERNELS
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{cell}: kernels never launched: {missing}")
    if not per_gang:
        raise AssertionError(f"{cell}: nothing bound")
    t = res.tensors
    if not bool(torch.isfinite(t.queue_allocated).all()):
        raise AssertionError(f"{cell}: non-finite queue allocation")
    return dict(
        cycle_seconds=secs, binds=len(res.bind_requests),
        pods_bound_per_s=len(res.bind_requests) / secs,
        gangs_allocated=int(t.allocated.sum()),
        gangs_attempted=int(t.attempted.sum()),
        racks_used=len({r for v in racks.values() for r in v}),
        fit_reason_counts={int(k): int(v) for k, v in zip(
            *torch.unique(t.fit_reason.cpu(), return_counts=True))},
        chunks=res.chunks, retries=res.retries,
        retry_chunks=res.retry_chunks, phase_seconds=res.phase_seconds,
        action_seconds=res.action_seconds,
        shape=TOPOLOGY if cell == "topology" else TOPO_SUB, launches=counts)


def topology_kernel_checks(tcap: Capture, scap: Capture) -> dict:
    """K11 and the topology modes of K3, K9 and K10 on the inputs captured
    from the two topology warm-ups vs their plain versions, both on the
    card (tolerance 0), kernel and plain times, and the least time the
    card could take for these inputs."""
    from kai_scheduler_tpu_torch.ops import allocate as A
    out = {}

    def held(key, plain, calls):
        k_fn = tcap._orig[key]
        errs = [_max_abs_err(k_fn(*a, **kw), plain(*a, **kw))
                for a, kw in calls]
        return max(errs), len(errs)

    # K11 build — reads the pools, the fit table and the CSR once, writes
    # the three tables; ~12 operations per (type, node) for the counts,
    # one add per CSR entry for the aggregate and per (type, entry) for
    # the caps
    calls = tcap.calls["topo_tables_build"]
    err, n = held("topo_tables_build", A.topo_tables_build_plain, calls)
    args, kw = calls[0]
    st, fp_build, avail, valid, type_req = args
    Y, N = fp_build.shape
    L = st.dom_of.shape[0]
    ND, M = N * L, st.dom_nodes.numel()
    k_fn = tcap._orig["topo_tables_build"]
    ms = _time_ms(lambda: k_fn(*args, **kw))
    plain_ms = _time_ms(lambda: A.topo_tables_build_plain(*args, **kw))
    ids = st.dom_of[0].long()
    acc = avail[:, 0].contiguous()
    lib_ms = _time_ms(lambda: torch.zeros(
        (ND + 1,), device=acc.device).index_add_(0, ids, acc))
    nb = (_nbytes(fp_build, avail, type_req, st.dom_ptr, st.dom_nodes)
          + Y * ND * 4 + ND * 4 + Y * (N + 1) * 4)
    b, by = bound(nb, Y * N * 12 + M * (1 + Y))
    out["topo_tables_build"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        nearest_library_ms=lib_ms,
        nearest_library="index_add_ of one level's aggregate (atomic order)",
        checked=n, shape=f"Y={Y} N={N} L={L} ND={ND}")

    # K11 update — the three tables in and out, the taken entries and the
    # touched nodes' rows once; per touched (type, node) ~12 operations
    # for the count, per level one add per entry and per changed count
    calls = tcap.calls["topo_tables_update"]
    err, n = held("topo_tables_update", A.topo_tables_update_plain, calls)
    args, kw = calls[-1]
    (st, fp_build, caps, agg, c_y, avail, take, nodes_b, req0_b,
     type_req) = args
    B, T = nodes_b.shape
    placed = take[:, None] & (nodes_b >= 0)
    K = int(placed.sum())
    U = int(torch.unique(nodes_b[placed]).numel())
    k_fn = tcap._orig["topo_tables_update"]
    ms = _time_ms(lambda: k_fn(*args, **kw))
    plain_ms = _time_ms(lambda: A.topo_tables_update_plain(*args, **kw))
    nb = (2 * _nbytes(caps, agg, c_y) + _nbytes(nodes_b, take, req0_b)
          + U * (12 + Y + 4 * L))
    b, by = bound(nb, Y * U * (12 + L) + K * L)
    out["topo_tables_update"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        checked=n, shape=f"B={B} T={T} entries={K} nodes={U} Y={Y} ND={ND}")

    # K3 topology mode — as kernel_checks' K3 plus, per lane, the pick's
    # walk over the ND domains (order, caps, level: each table read once)
    # and the rows out
    calls = tcap.calls["uniform_fill"]
    err, n = held("uniform_fill", A.uniform_fill_plain, calls)
    args, kw = calls[0]
    (cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain, lt, tables,
     soft, valid) = args
    topo = kw["topo"]
    B, T = prior.shape
    Q = qa.shape[0]
    N = valid.shape[0]
    ND = topo.level_of_dom.shape[0]
    k_fn = tcap._orig["uniform_fill"]
    ms = _time_ms(lambda: k_fn(*args, **kw))
    plain_ms = _time_ms(lambda: A.uniform_fill_plain(*args, **kw))
    lane_bytes = (B * (12 + T + 3 * 4 + 1 + 4 * 3)
                  + B * (2 * Q * 3 * 4 + T * 5 + 1 + T * 24))
    nb = (_nbytes(cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain,
                  soft, valid, *tables, topo.dom_caps_y, topo.level_of_dom,
                  topo.order, topo.topology, kw["free"]) + lane_bytes)
    b, by = bound(nb, B * N * 10 + B * ND * 3)
    out["uniform_fill:topology"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        checked=n, shape=f"B={B} T={T} N={N} ND={ND} Q={Q}")

    # K3 preferred mode — the same inputs with every other lane's gang
    # preferring its block (topo/level0): a second pass over the nodes
    pref = torch.full_like(lt.queue, -1)
    pref[cand[::2].long()] = 0
    pkw = dict(kw, topo=dataclasses.replace(topo, pref_level=pref))
    err = _max_abs_err(k_fn(*args, **pkw), A.uniform_fill_plain(*args, **pkw))
    ms = _time_ms(lambda: k_fn(*args, **pkw))
    plain_ms = _time_ms(lambda: A.uniform_fill_plain(*args, **pkw))
    b, by = bound(nb + _nbytes(pref), B * N * 22 + B * ND * 3)
    out["uniform_fill:preferred"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        checked=1, shape=f"B={B} N={N}, {B // 2 + B % 2} lanes preferring")

    # K10 without the device table (the uniform lanes' rows here; the
    # per-task path without GPU sharing runs the same mode) — the
    # entries' rows, the pools at their nodes and the queue deltas once
    calls = tcap.calls["dense_accept"]
    err, n = held("dense_accept", A.dense_accept_plain, calls)
    args, kw = calls[-1]
    nodes_b, ok = args[0], args[1]
    B, T = nodes_b.shape
    Q = args[13].shape[0]
    ent = ok[:, None] & (nodes_b >= 0)
    E = int(ent.sum())
    U = int(torch.unique(nodes_b[ent]).numel())
    k_fn = tcap._orig["dense_accept"]
    ms = _time_ms(lambda: k_fn(*args, **kw))
    plain_ms = _time_ms(lambda: A.dense_accept_plain(*args, **kw), 5)
    nb = B * T * (4 + 2 * 12) + U * 2 * 24 + B * (2 + 2 * Q * 12) + 4 * Q * 12
    b, by = bound(nb, E * 2 * 6)
    out["dense_accept:no_devices"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        checked=n, shape=f"B={B} T={T} Q={Q} entries={E} nodes={U}")

    # K9 subgroup-topology mode — sharing_kernel_checks' K9 bytes plus the
    # chunk-start [ND, R] aggregate once and each placed step's debit at
    # every level (the copies into the lanes' rows are the kernel's own
    # cost, not the function's); per placed task step ~70 operations a
    # node (the domain gate and band)
    calls = [c for c in scap.calls["pertask_fill"]
             if c[1].get("active") is None]
    retry_calls = [c for c in scap.calls["pertask_fill"]
                   if c[1].get("active") is not None]

    def fields(o):
        return o.fields()
    k_fn = scap._orig["pertask_fill"]
    errs = [_max_abs_err(fields(k_fn(*a, **kw)),
                         fields(A.pertask_fill_plain(*a, **kw)))
            for a, kw in calls]
    args, kw = calls[0]
    nodes, tt, cand, prior, free, dev, qa = args[:7]
    B, T = prior.shape
    N = free.shape[0]
    L = nodes.topology.shape[1]
    Q = qa.shape[0]
    first = k_fn(*args, **kw)
    steps = int((first.nodes_t >= 0).sum())
    ms = _time_ms(lambda: k_fn(*args, **kw))
    plain_ms = _time_ms(lambda: A.pertask_fill_plain(*args, **kw), 5)
    K_ = nodes.labels.shape[1]
    X = nodes.filter_masks.shape[0]
    node_bytes = N * (5 * 12 + 1 + 4 * K_ + 5 * X + 4 + 4 * L)
    lane_bytes = B * (8 + T * (12 + 1 + 4 * K_ + 4 * 5))
    out_bytes = B * (2 * Q * 12 + T * 9 + 1 + T * 24)
    agg_bytes = (N * L + 1) * 12 + steps * L * 12
    b, by = bound(node_bytes + lane_bytes + out_bytes + agg_bytes,
                  steps * N * 70)
    out["pertask_fill:topology"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b,
        bound_by=by, checked=len(errs),
        shape=f"B={B} T={T} N={N} L={L} Q={Q} placed steps={steps}")

    # K9 banned mode — on the first chunk's inputs with the first
    # attempt's locked domains banned: every lane; the retry's active
    # lanes (the failed ones) over the first output, on the first
    # launch's scratch (its chunk-start row copied, not summed) and on a
    # scratch of its own; and the retry launches the warm-up captured
    banned = first.sub_dom
    bkw = dict(kw, banned=banned)
    rkw = dict(bkw, active=~first.success, base=first)
    errs = [_max_abs_err(fields(k_fn(*args, **bkw)),
                         fields(A.pertask_fill_plain(*args, **bkw)))]
    for agg in (A.pertask_agg_scratch(B, kw["topo"], free), None):
        if agg is not None:
            k_fn(*args, **dict(kw, agg=agg))   # its chunk-start row
        rkw["agg"] = agg
        errs.append(_max_abs_err(fields(k_fn(*args, **rkw)),
                                 fields(A.pertask_fill_plain(*args, **rkw))))
    errs += [_max_abs_err(fields(k_fn(*a, **kw2)),
                          fields(A.pertask_fill_plain(*a, **kw2)))
             for a, kw2 in retry_calls]
    ms = _time_ms(lambda: k_fn(*args, **bkw))
    plain_ms = _time_ms(lambda: A.pertask_fill_plain(*args, **bkw), 5)
    steps_b = int((k_fn(*args, **bkw).nodes_t >= 0).sum())
    b, by = bound(node_bytes + lane_bytes + out_bytes + (N * L + 1) * 12
                  + steps_b * L * 12 + _nbytes(banned), steps_b * N * 70)
    out["pertask_fill:banned"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b,
        bound_by=by, checked=len(errs),
        shape=f"B={B} every lane banned from its first domains, "
              f"{len(retry_calls)} captured retry launches")
    return out


# ---------------------------------------------------------------------------
# the affinity cells (cross-gang anti terms, anchors, shared host ports)
# ---------------------------------------------------------------------------

def affinity_cluster(cell: str):
    from kai_scheduler_tpu_torch.apis import types as apis
    from kai_scheduler_tpu_torch.runtime.cluster import Cluster
    from kai_scheduler_tpu_torch.state import fleets, make_cluster
    if cell == "affinity":
        return Cluster.from_objects(*fleets.affinity_objects(
            apis, make_cluster, **AFFINITY))
    if cell.startswith("affinity_reclaim"):
        return Cluster.from_objects(*fleets.affinity_reclaim_objects(
            apis, make_cluster, **AFFINITY_RECLAIM))
    return Cluster.from_objects(*fleets.affinity_sharing_objects(
        apis, **AFFINITY_SHARING))


def affinity_config(cell: str):
    """An affinity cell's SchedulerConfig: allocate only, the five default
    actions at the default config (``affinity_reclaim``), or on the
    sequential victim engine (``affinity_reclaim_sequential``)."""
    from kai_scheduler_tpu_torch.framework.scheduler import SchedulerConfig
    from kai_scheduler_tpu_torch.framework.session import SessionConfig
    from kai_scheduler_tpu_torch.ops.victims import VictimConfig
    if cell == "affinity_reclaim":
        return SchedulerConfig()
    if cell == "affinity_reclaim_sequential":
        return SchedulerConfig(session=SessionConfig(victims=VictimConfig(
            batch_size=1, queue_depth=SEQUENTIAL_QUEUE_DEPTH)))
    return SchedulerConfig(actions=("allocate",))


def run_affinity_cycle(cell: str, device: str):
    """One cycle of an affinity cell (see :func:`affinity_config`)."""
    from kai_scheduler_tpu_torch.framework.scheduler import Scheduler
    cluster = affinity_cluster(cell)
    t0 = time.perf_counter()
    res = Scheduler(affinity_config(cell), device=device).run_once(cluster)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, cluster, time.perf_counter() - t0


def affinity_violations(pods: dict, placed: dict) -> tuple[list, dict]:
    """The affinity fleets' terms (``state/fleets.py``) checked on a
    cycle's placements (``placed``: pod name -> node name, e.g. from its
    BindRequests; ``pods``: pod name -> the pod object): two placed pods of
    one ``app`` service, or two on the shared host port, on one host, and
    a placed depender off its anchor's host.  Returns ``(violations,
    counts)``: a description of each, and the placed pods, anchors,
    dependers and anti keys seen."""
    by_host: dict = {}
    anchor_host = {}
    for name, node in placed.items():
        p = pods[name]
        key = p.labels.get("app") or (f"port-{p.host_ports[0]}"
                                      if p.host_ports else None)
        if key is not None:
            by_host.setdefault((key, node), []).append(name)
        if "cache" in p.labels:
            anchor_host[p.labels["cache"]] = node
    bad = [f"{k[1]} holds {v} of one anti term"
           for k, v in by_host.items() if len(v) > 1]
    dependers = 0
    for name, node in placed.items():
        for term in pods[name].pod_affinity:
            if not term.anti:
                (_, want), = term.match_labels
                dependers += 1
                if anchor_host.get(want) != node:
                    bad.append(f"depender {name} on {node}, its anchor on "
                               f"{anchor_host.get(want)}")
    return bad, dict(pods=len(placed), anchors=len(anchor_host),
                     dependers=dependers,
                     anti_keys=len({k for k, _ in by_host}))


def placed_pods(cell: str, res) -> dict:
    """pod name -> node name of every placement an affinity cycle
    committed: its BindRequests, and where it pipelined placements
    (reclaim's, which bind only once their victims leave) all of
    ``tensors.placements``, decoded with the name tables of a fresh
    snapshot of the cell's cluster; the bound pods must decode to their
    BindRequests' nodes."""
    from kai_scheduler_tpu_torch.state import build_snapshot
    placed = {b.pod_name: b.selected_node for b in res.bind_requests}
    if not bool(res.tensors.pipelined.any()):
        return placed
    fresh = affinity_cluster(cell)
    _, index = build_snapshot(*fresh.snapshot_lists(), device="cpu",
                              now=fresh.now)
    pl = res.tensors.placements.cpu()
    decoded = {index.task_names[g][t]: index.node_names[int(pl[g, t])]
               for g, t in (pl >= 0).nonzero().tolist()}
    if any(decoded.get(p) != n for p, n in placed.items()):
        raise AssertionError(f"{cell}: placements decode off the "
                             f"BindRequests")
    return decoded


def check_affinity_terms(cell: str, cluster, res) -> dict:
    """No two placed pods (bound, or pipelined) with a mutual required
    hostname anti term share a host; every placed depender shares its
    anchor's host."""
    bad, counts = affinity_violations(cluster.pods, placed_pods(cell, res))
    if bad:
        raise AssertionError(f"{cell}: {len(bad)} affinity violations, "
                             f"e.g. {bad[0]}")
    return counts


def check_affinity_cycle(cell: str, gpu, cpu, cluster, counts: dict) -> dict:
    """The GPU affinity cycle equals the CPU oracle (packed commit,
    BindRequests, evictions and move rebinds, chunk counts, the
    claimed-domain table ``anti_used`` byte for byte), honours every term,
    and launched the cell's kernels and modes."""
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
             _binds(cpu.move_bind_requests)),
            ("allocate chunks", res.chunks, cpu.chunks),
            ("victim steps", {k: v.steps for k, v in res.victim_stats.items()},
             {k: v.steps for k, v in cpu.victim_stats.items()})):
        if a != b:
            raise AssertionError(f"{cell}: {what} differ from the oracle")
    used = res.tensors.anti_used.cpu()
    if not torch.equal(used, cpu.tensors.anti_used):
        raise AssertionError(f"{cell}: anti_used differs from the oracle")
    terms = check_affinity_terms(cell, cluster, res)
    missing = [k for k in AFFINITY_CELLS[cell][2] if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{cell}: kernels never launched: {missing}")
    if cell.startswith("affinity_reclaim") and not res.evictions:
        raise AssertionError(f"{cell}: reclaim evicted nothing")
    t = res.tensors
    if not bool(torch.isfinite(t.queue_allocated).all()):
        raise AssertionError(f"{cell}: non-finite queue allocation")
    return dict(
        cycle_seconds=secs, binds=len(res.bind_requests),
        evictions=len(res.evictions), pipelined_tasks=int(t.pipelined.sum()),
        gangs_allocated=int(t.allocated.sum()),
        gangs_attempted=int(t.attempted.sum()),
        fit_reason_counts={int(k): int(v) for k, v in zip(
            *torch.unique(t.fit_reason.cpu(), return_counts=True))},
        placed_pods=int((t.placements >= 0).sum()),
        term_rows=int(t.anti_used.shape[0] - 1),
        claimed_cells=int(used.sum()), chunks=res.chunks,
        victim_stats={k: dataclasses.asdict(v)
                      for k, v in res.victim_stats.items()},
        phase_seconds=res.phase_seconds, action_seconds=res.action_seconds,
        launches=counts, **terms)


def affinity_kernel_checks(caps: dict) -> dict:
    """K12, K13 and the mask modes of K3 and K9 on the inputs captured from
    the affinity cells vs their plain versions, both on the card
    (tolerance 0), kernel and plain times, and the least time the card
    could take for these inputs."""
    from kai_scheduler_tpu_torch.ops import allocate as A
    out = {}

    def calls(*keys):
        return [(c, k, a, kw) for c in AFFINITY_CELLS
                for k in keys for a, kw in caps[c].calls.get(k, [])]

    def held(recs, plain, fields=lambda o: o):
        return max(_max_abs_err(fields(caps[c]._orig[k](*a, **kw)),
                                fields(plain(*a, **kw)))
                   for c, k, a, kw in recs)

    # K12 — per (lane, node) and used slot a level, a domain and a table
    # bit (~6 operations), a byte written per (lane, node); the bytes the
    # lanes' used slots need: each distinct (row, level) pair's N table
    # cells, each distinct level's domain row, each distinct need row's
    # static claims, the valid nodes, the lanes' gangs and slot rows, and
    # the B x N mask out
    recs = calls("affinity_mask", "affinity_mask:victims")
    err = held(recs, A.affinity_mask_plain)
    c, k, args, kw = max(recs, key=lambda r: (r[0] == "affinity",
                                             r[2][3].numel(),
                                             r[3]["attract"]))
    st, used, dom, cand = args
    g = st.gangs
    B, N, L = cand.shape[0], st.nodes.n, st.nodes.topology.shape[1]
    TA = g.anti_term_level.shape[0]
    KT, KP = g.anti_avoids.shape[1], g.attract_needs.shape[1] * kw["attract"]
    gi = cand.clamp(0, g.g - 1).long()
    slots = [g.anti_avoids[gi]] + ([g.attract_needs[gi]] if KP else [])
    pairs, levels, need_rows, used_slots = set(), set(), set(), 0
    for i, sl in enumerate(slots):
        on = sl >= 0
        rows = sl.clamp(0, TA - 1)
        lvl = g.anti_term_level[rows].clamp(0, L)
        used_slots += int(on.sum())
        key = (rows * (L + 1) + lvl)[on].unique().tolist()
        pairs.update(key)
        levels.update(x % (L + 1) for x in key)
        if i == 1:
            need_rows.update(rows[on].unique().tolist())
    fn = caps[c]._orig[k]
    ms = _time_ms(lambda: fn(*args, **kw))
    plain_ms = _time_ms(lambda: A.affinity_mask_plain(*args, **kw))
    nb = (N * (len(pairs) + 4 * len(levels) + len(need_rows) + 1)
          + _nbytes(cand) + B * (KT + KP) * 4 + B * N)
    b, by = bound(nb, N * (6 * used_slots + B))
    out["affinity_mask"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        checked=len(recs), shape=f"B={B} N={N} KT={KT} KP={KP} "
        f"table={tuple(used.shape)} used slots={used_slots} (row, level) "
        f"pairs={len(pairs)} ({c})")

    # K13 — marks the table in place: each (lane, mark slot, task) reads
    # its gang, slot row, level and node's domain and writes one cell
    # (~6 operations); the bytes are the lanes' inputs, the rows and
    # domains they read and the B x KT x T cell writes.  Each check and
    # timing runs on a copy of the captured table; the nearest library
    # call is ``index_put_`` of True at the cells, computed beforehand
    recs = calls("anti_mark", "anti_mark:victims")

    def marked(fn, a, kw):
        return fn(a[0], a[1].clone(), *a[2:], **kw)
    err = max(_max_abs_err(marked(caps[c]._orig[k], a, kw),
                           marked(A.anti_mark_plain, a, kw))
              for c, k, a, kw in recs)
    if not any(bool((marked(caps[c]._orig[k], a, kw) != a[1]).any())
               for c, k, a, kw in recs):
        raise AssertionError("anti_mark: no captured call marked a cell")
    c, k, args, kw = max(recs, key=lambda r: r[2][4].numel())
    st, used, dom, cand, nodes_b, take = args
    B, T = nodes_b.shape
    KT = st.gangs.anti_marks.shape[1]
    fn = caps[c]._orig[k]
    table = used.clone()
    ms = _time_ms(lambda: fn(st, table, dom, cand, nodes_b, take, **kw))
    plain_ms = _time_ms(lambda: A.anti_mark_plain(
        st, table, dom, cand, nodes_b, take, **kw))
    cells = A.anti_mark_cells(st, dom, cand, nodes_b, take)
    one = torch.ones((), dtype=torch.bool, device=used.device)
    lib_ms = _time_ms(lambda: table.index_put_(cells, one))
    nb = (_nbytes(cand, nodes_b, take) + B * KT * (4 + 4)
          + B * KT * T * (4 + 1))
    b, by = bound(nb, B * KT * T * 6)
    out["anti_mark"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        nearest_library_ms=lib_ms,
        nearest_library="index_put_ of True at the cells, computed "
        "beforehand", checked=len(recs), shape=f"B={B} T={T} KT={KT} "
        f"table={tuple(used.shape)}, in place ({c})")

    # K3 mask mode — kernel_checks' K3 bytes plus the [B, N] mask
    recs = [r for r in calls("uniform_fill", "uniform_fill:lanes")
            if r[2][11].dim() == 2]
    err = held(recs, A.uniform_fill_plain)
    c, k, args, kw = next(r for r in recs if r[0] == "affinity")
    (cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain, lt, tables,
     soft, valid) = args
    B, T = prior.shape
    N = valid.shape[1]
    Q = qan.shape[0]
    fn = caps[c]._orig[k]
    ms = _time_ms(lambda: fn(*args, **kw))
    plain_ms = _time_ms(lambda: A.uniform_fill_plain(*args, **kw))
    nb = (_nbytes(cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain,
                  soft, valid, *tables)
          + B * (12 + T + 3 * 4 + 1 + 4 * 3) + B * (2 * Q * 3 * 4 + T * 5 + 1))
    b, by = bound(nb, B * N * 11)
    out["uniform_fill:mask"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        checked=len(recs), shape=f"B={B} T={T} N={N} Q={Q} ({c})")

    # K9 mask mode — sharing_kernel_checks' K9 bytes plus the [B, N] mask
    recs = [r for r in calls("pertask_fill") if r[3].get("mask") is not None]
    err = held(recs, A.pertask_fill_plain, lambda o: o.fields())
    c, k, args, kw = recs[0]
    nodes, tt, cand, prior, free, dev, qa = args[:7]
    B, T = prior.shape
    N, D = dev.shape
    Q = qa.shape[0]
    fn = caps[c]._orig[k]
    steps = int((fn(*args, **kw).nodes_t >= 0).sum())
    ms = _time_ms(lambda: fn(*args, **kw))
    plain_ms = _time_ms(lambda: A.pertask_fill_plain(*args, **kw), 5)
    K_ = nodes.labels.shape[1]
    X = nodes.filter_masks.shape[0]
    L = nodes.topology.shape[1]
    node_bytes = N * (5 * 12 + 3 * 4 * D + 1 + 4 * K_ + 5 * X + 4 + 4 * L)
    lane_bytes = B * (8 + T * (12 + 1 + 4 * K_ + 4 * 5)) + B * N
    out_bytes = B * (2 * Q * 12 + T * 9 + 1 + T * (24 + 8 * D))
    b, by = bound(node_bytes + lane_bytes + out_bytes, steps * N * 60)
    out["pertask_fill:mask"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        checked=len(recs),
        shape=f"B={B} T={T} N={N} D={D} Q={Q} placed steps={steps} ({c})")
    return out


# ---------------------------------------------------------------------------
# the victim cells
# ---------------------------------------------------------------------------

def victim_config(cell: str):
    """The cell's SchedulerConfig: the default (the reference's five
    actions and VictimConfig), or the sequential victim engine."""
    from kai_scheduler_tpu_torch.framework.scheduler import SchedulerConfig
    from kai_scheduler_tpu_torch.framework.session import SessionConfig
    from kai_scheduler_tpu_torch.ops.victims import VictimConfig
    width = VICTIM_CELLS[cell][1]
    actions = CELL_ACTIONS.get(cell, SchedulerConfig().actions)
    if width is None:
        return SchedulerConfig(actions=actions)
    return SchedulerConfig(actions=actions, session=SessionConfig(
        victims=VictimConfig(batch_size=width,
                             queue_depth=SEQUENTIAL_QUEUE_DEPTH)))


def victim_cluster(cell: str):
    from kai_scheduler_tpu_torch.apis import types as apis
    from kai_scheduler_tpu_torch.runtime.cluster import Cluster
    from kai_scheduler_tpu_torch.state import make_cluster
    from kai_scheduler_tpu_torch.state.fleets import fragmented_objects
    kind = VICTIM_CELLS[cell][0]
    if kind == "saturated":
        return Cluster.from_objects(*make_cluster(**SATURATED))
    if kind == "preempt_many_queues":
        return Cluster.from_objects(*make_cluster(**PREEMPT_MANY))
    nodes, queues, groups, pods, now = fragmented_objects(apis,
                                                          **FRAGMENTED)
    cluster = Cluster.from_objects(nodes, queues, groups, pods)
    cluster.now = now
    return cluster


def run_victim_cycle(cell: str, device: str):
    from kai_scheduler_tpu_torch.framework.scheduler import Scheduler
    cluster = victim_cluster(cell)
    sched = Scheduler(victim_config(cell), device=device)
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
    need = VICTIM_NEED[cell]
    if cell != "fragmented":
        if not res.evictions or pipelined <= 0:
            raise AssertionError(f"{cell}: {len(res.evictions)} evictions, "
                                 f"{pipelined} pipelined placements")
    else:
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
    for cell in ("saturated_sequential", "fragmented"):
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
    for cell in ("saturated_sequential", "fragmented"):
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



def lane_kernel_checks(caps: dict) -> dict:
    """K8 and the victim wavefront's modes of K2-K4 on the inputs
    captured from the chunked cells vs their plain versions (K8's on CPU
    copies — its plain segment sums need the CPU's ordered
    ``index_add_``; K2-K4's on the card, as in :func:`kernel_checks`),
    kernel and plain times on the card, and the bound.  K8's nearest
    library call (NOT the same function): ``index_add_`` of the
    [B (N + 1), R] lane-node table alone, atomic order."""
    from kai_scheduler_tpu_torch.ops import allocate as A
    from kai_scheduler_tpu_torch.ops import victims as V
    cells = ("saturated", "preempt_many_queues")

    def calls(key):
        return [(cell, args, kw) for cell in cells
                for args, kw in caps[cell].calls.get(key, [])]

    def largest(recs, size):
        return max(recs, key=lambda rec: size(rec[1]))

    out = {}
    # K8 — the live pods' rows and the CSR lists once, the three outputs
    # once; 6 adds per live pod, 3 per (lane, node) and (lane, queue) of
    # the lane prefix, 2 per (lane, node) of own_incr, 1 per chain entry
    # of the roll-up
    recs = [(c, a, {"compose": k["compose"]})
            for c, a, k in calls("freed_by_lane")]
    errs = []
    for cell, (state, lane, B, chain), kw in recs:
        got = caps[cell]._orig["freed_by_lane"](state, lane, B, chain, **kw)
        want = V.freed_by_lane_plain(_cpu_state(state), lane.cpu(), B,
                                     chain.cpu(), **kw)
        errs.append(_max_abs_err(_to_cpu(got), want))
    cell, (state, lane, B, chain), kw = largest(
        recs, lambda a: a[2] * a[0].nodes.n)
    pods = V.PodIndex.of(state)
    k_ms = _time_ms(lambda: V.freed_by_lane(state, lane, B, chain, pods=pods,
                                            **kw))
    p_ms = _time_ms(lambda: V.freed_by_lane_plain(state, lane, B, chain,
                                                  **kw), 5)
    r, n, q = state.running, state.nodes, state.queues
    M, N, Q = r.m, n.n, q.q
    live = lane < B
    n_live = int(live.sum())
    seg = (torch.where(live, lane, B).long() * (N + 1)
           + torch.where(live, torch.clamp(r.node, min=0), N).long())
    req_m = torch.where(live[:, None], r.req, 0.0)

    def library():
        torch.zeros(((B + 1) * (N + 1), 3), device=lane.device).index_add_(
            0, seg, req_m)
    lib_ms = _time_ms(library)
    nnz = int(chain.sum())
    nbytes = (M * 4 + n_live * 12 + (N + 1 + M + Q + 1 + M) * 4 + Q * Q
              + B * N * 12 + B * Q * 12 + B * N)
    ops = (6 * n_live + (3 * B * (N + Q) if kw["compose"] else 0)
           + 2 * B * N + 3 * B * nnz)
    b, by = bound(nbytes, ops)
    out["freed_by_lane"] = dict(
        max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b,
        bound_by=by, nearest_library_ms=lib_ms,
        nearest_library="index_add_ of the [B (N + 1), R] lane-node table "
                        "only (atomic order)",
        shape=f"B={B} N={N} Q={Q} M={M} live={n_live} "
              f"compose={kw['compose']} ({cell})", checked=len(recs))

    # K2 with one pool per row: as kernel_checks' K2, plus the [Y, N, R]
    # pools read once
    recs = calls("type_tables:lanes")
    errs = [_max_abs_err(caps[c]._orig["type_tables:lanes"](*a, **k),
                         A.type_tables_plain(*a, **k)) for c, a, k in recs]
    cell, args, kw = largest(recs, lambda a: a[2].numel())
    nodes, free, extra, type_req, type_sel, type_cls, placement = args
    Y, N = type_req.shape[0], free.shape[0]
    k_ms = _time_ms(lambda: A.type_tables(*args, **kw))
    p_ms = _time_ms(lambda: A.type_tables_plain(*args, **kw))
    nb = _nbytes(free, extra, nodes.releasing, nodes.allocatable,
                 nodes.valid, nodes.labels, nodes.filter_masks, type_req,
                 type_sel, type_cls) + Y * N * 14
    b, by = bound(nb, Y * N * 45)
    out["type_tables:lanes"] = dict(
        max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b,
        bound_by=by, shape=f"Y={Y} N={N} per-row extra ({cell})",
        checked=len(recs))

    # K3 with per-lane queue tables, rows and score bias: as
    # kernel_checks' K3, plus the [B, Q, R] tables and [B, N] bias
    recs = calls("uniform_fill:lanes")
    errs = [_max_abs_err(caps[c]._orig["uniform_fill:lanes"](*a, **k),
                         A.uniform_fill_plain(*a, **k)) for c, a, k in recs]
    cell, args, kw = largest(recs, lambda a: a[1].numel())
    (cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain, lt, tables,
     soft, valid) = args
    B, T = prior.shape
    Q = qan.shape[0]
    N = valid.shape[0]
    k_ms = _time_ms(lambda: A.uniform_fill(*args, **kw))
    p_ms = _time_ms(lambda: A.uniform_fill_plain(*args, **kw))
    nb = (_nbytes(cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain,
                  soft, valid, *tables, kw["rows"], kw["score_bias"])
          + B * (12 + T + 3 * 4 + 1 + 4 * 3) + B * (2 * Q * 3 * 4 + T * 5 + 1))
    b, by = bound(nb, B * N * 11)
    out["uniform_fill:lanes"] = dict(
        max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b,
        bound_by=by, shape=f"B={B} T={T} N={N} Q={Q} per-lane ({cell})",
        checked=len(recs))

    # K4 with the per-entry freed credit: as kernel_checks' K4, plus the
    # [K, R] credit read once
    recs = calls("sparse_accept:credit")
    errs = [_max_abs_err(caps[c]._orig["sparse_accept:credit"](*a, **k),
                         A.sparse_accept_plain(*a, **k)) for c, a, k in recs]
    cell, args, kw = largest(recs, lambda a: a[0].numel())
    nodes_b = args[0]
    K = nodes_b.numel()
    k_ms = _time_ms(lambda: A.sparse_accept(*args, **kw))
    p_ms = _time_ms(lambda: A.sparse_accept_plain(*args, **kw))
    lg = max(1, (K - 1).bit_length())
    nb = (_nbytes(*args[:4], kw["credit"]) + K * 2 * 12 + 4 + K * 8)
    b, by = bound(nb, K * lg * lg // 2 + K * 21)
    out["sparse_accept:credit"] = dict(
        max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b,
        bound_by=by, shape=f"K={K} with credit ({cell})", checked=len(recs))
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
    t_start = time.perf_counter()
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

    # -- 5. the GPU-sharing cell (the per-task path): a warm-up run under
    # the profiler's CUDA activity with K9's and K10's inputs captured, then
    # timed runs (counts reset just before, read just after), one CPU
    # oracle run ------------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile
    with Capture(SHARING_KEEP) as scap, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, warm_s = run_sharing_cycle("cuda")
    sharing_in_cycle = in_cycle_device_ms(prof)
    del prof
    runs = []
    for _ in range(SHARING_RUNS):
        kernels.reset_launch_counts()
        res, cluster, secs = run_sharing_cycle("cuda")
        runs.append((res, cluster, secs, kernels.launch_counts()))
    cpu, _, cpu_s = run_sharing_cycle("cpu")
    recs = [check_sharing_cycle((res, secs), cpu, cluster, counts)
            for res, cluster, secs, counts in runs]
    secs_all = sorted(r["cycle_seconds"] for r in recs)
    rec = dict(recs[-1])
    rec.update(runs=len(recs), cycle_seconds_all=secs_all,
               cycle_seconds_median=statistics.median(secs_all),
               pods_bound_per_s_median=rec["binds"]
               / statistics.median(secs_all),
               warm_up_seconds=warm_s, cpu_oracle_seconds=cpu_s,
               in_cycle_ms=sharing_in_cycle)
    report["sharing"] = rec
    log(f"sharing: {len(recs)} cycles, median "
        f"{rec['cycle_seconds_median']:.4f} s (min {secs_all[0]:.4f}, max "
        f"{secs_all[-1]:.4f}; profiled warm-up {warm_s:.3f}), "
        f"{rec['binds']} binds ({rec['fractional_binds']} fractional, "
        f"{rec['pods_bound_per_s_median']:.0f} pods/s), "
        f"{rec['gangs_allocated']} gangs allocated of "
        f"{rec['gangs_attempted']} attempted, {rec['chunks']} chunks, fit "
        f"reasons {rec['fit_reason_counts']}, launches {rec['launches']}; "
        f"every commit, BindRequest and device index == CPU oracle "
        f"({cpu_s:.1f} s)")
    log("  phases (last run): " + ", ".join(
        f"{k} {v:.4f}" for k, v in rec["phase_seconds"].items()))
    log(f"  elapsed {time.perf_counter() - t_start:.0f} s")
    checks.update(sharing_kernel_checks(scap))
    del scap

    # -- 6. the topology cells: a warm-up run under the profiler's CUDA
    # activity with their kernels' inputs captured, timed runs (counts
    # reset just before, read just after), one CPU oracle run -------------
    tcaps = {}
    for cell, keep, reps in (("topology", TOPOLOGY_KEEP, TOPOLOGY_RUNS),
                             ("topology_subgroups", TOPO_SUB_KEEP,
                              TOPO_SUB_RUNS)):
        with Capture(keep) as tcap, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, _, warm_s = run_topology_cycle(cell, "cuda")
        in_cycle = in_cycle_device_ms(prof)
        del prof
        runs = []
        for _ in range(reps):
            kernels.reset_launch_counts()
            res, cluster, secs = run_topology_cycle(cell, "cuda")
            runs.append((res, cluster, secs, kernels.launch_counts()))
        cpu, _, cpu_s = run_topology_cycle(cell, "cpu")
        recs = [check_topology_cycle(cell, (res, secs), cpu, cluster, counts)
                for res, cluster, secs, counts in runs]
        secs_all = sorted(r["cycle_seconds"] for r in recs)
        rec = dict(recs[-1])
        rec.update(runs=len(recs), cycle_seconds_all=secs_all,
                   cycle_seconds_median=statistics.median(secs_all),
                   pods_bound_per_s_median=rec["binds"]
                   / statistics.median(secs_all),
                   warm_up_seconds=warm_s, cpu_oracle_seconds=cpu_s,
                   in_cycle_ms=in_cycle)
        report[cell] = rec
        tcaps[cell] = tcap
        log(f"{cell}: {len(recs)} cycles, median "
            f"{rec['cycle_seconds_median']:.4f} s (min {secs_all[0]:.4f}, "
            f"max {secs_all[-1]:.4f}; profiled warm-up {warm_s:.3f}), "
            f"{rec['binds']} binds ({rec['pods_bound_per_s_median']:.0f} "
            f"pods/s) in {rec['racks_used']} racks, "
            f"{rec['gangs_allocated']} gangs allocated of "
            f"{rec['gangs_attempted']} attempted, {rec['chunks']} chunks, "
            f"{rec['retries']} retries (the retry launch had a retried "
            f"lane in {rec['retry_chunks']} chunks), fit reasons "
            f"{rec['fit_reason_counts']}, launches {rec['launches']}; every "
            f"commit, BindRequest and retry count == CPU oracle "
            f"({cpu_s:.1f} s), every gang and subgroup in one rack")
        log("  phases (last run): " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec["phase_seconds"].items()))
        log(f"  elapsed {time.perf_counter() - t_start:.0f} s")
    topo_checks = topology_kernel_checks(tcaps["topology"],
                                         tcaps["topology_subgroups"])
    for k in ("topo_tables_build", "topo_tables_update"):
        checks[k] = topo_checks.pop(k)
    del tcaps

    # -- 7. the victim cells: one GPU run each (counts reset just before,
    # read just after), one CPU oracle run --------------------------------
    # (a first GPU run, not timed, under the profiler's CUDA activity
    # with the victim kernels' inputs captured, gives each kernel's
    # in-cycle device time)
    caps = {}
    for cell in VICTIM_CELLS:
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
            extra = ""
            if st and act in ("reclaim", "preempt") and \
                    VICTIM_CELLS[cell][1] is None:
                extra = (f"chunked wavefront: {st['steps']} chunks, "
                         f"{st['attempts']} lanes, {st['syncs']} host syncs, "
                         f"{st['demotions']} leftover demotions, "
                         f"{st['fallbacks']} sparse fallbacks, ")
            elif st:
                extra = (f"{st['steps']} steps, {st['attempts']} scenario "
                         f"attempts, {st['syncs']} host syncs, ")
            log(f"  {cell} action {act}: {extra}{sec:.4f} s")
        log("  phases: " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec["phase_seconds"].items()))
        log("  in-cycle kernel device ms / launches (profiled run): "
            + ", ".join(f"{k} {v['ms']:.3f} / {v['launches']}"
                        for k, v in in_cycle.items() if v["launches"]))
        log(f"  elapsed {time.perf_counter() - t_start:.0f} s")
    checks.update(victim_kernel_checks(caps))
    lane_checks = lane_kernel_checks(caps)
    checks["freed_by_lane"] = lane_checks.pop("freed_by_lane")
    del caps

    # -- 8. the affinity cells: a warm-up run under the profiler's CUDA
    # activity with K12's, K13's and the mask modes' inputs captured, timed
    # runs (counts reset just before, read just after), one CPU oracle run
    acaps = {}
    for cell, (reps, keep, _) in AFFINITY_CELLS.items():
        with Capture(keep) as acap, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, _, warm_s = run_affinity_cycle(cell, "cuda")
        in_cycle = in_cycle_device_ms(prof)
        del prof
        runs = []
        for _ in range(reps):
            kernels.reset_launch_counts()
            res, cluster, secs = run_affinity_cycle(cell, "cuda")
            runs.append((res, cluster, secs, kernels.launch_counts()))
        cpu, _, cpu_s = run_affinity_cycle(cell, "cpu")
        recs = [check_affinity_cycle(cell, (res, secs), cpu, cluster, counts)
                for res, cluster, secs, counts in runs]
        del runs
        secs_all = sorted(r["cycle_seconds"] for r in recs)
        rec = dict(recs[-1])
        rec.update(runs=len(recs), cycle_seconds_all=secs_all,
                   cycle_seconds_median=statistics.median(secs_all),
                   warm_up_seconds=warm_s, cpu_oracle_seconds=cpu_s,
                   in_cycle_ms=in_cycle)
        report[cell] = rec
        acaps[cell] = acap
        log(f"{cell}: {len(recs)} cycles, median "
            f"{rec['cycle_seconds_median']:.4f} s (min {secs_all[0]:.4f}, "
            f"max {secs_all[-1]:.4f}; profiled warm-up {warm_s:.3f}), "
            f"{rec['placed_pods']} pods placed ({rec['binds']} binds, "
            f"{rec['pipelined_tasks']} pipelined), {rec['evictions']} "
            f"evictions, {rec['gangs_allocated']} gangs allocated of "
            f"{rec['gangs_attempted']} attempted, {rec['chunks']} allocate "
            f"chunks, victim steps "
            f"{ {k: v['steps'] for k, v in rec['victim_stats'].items()} }, "
            f"{rec['term_rows']} term rows, {rec['claimed_cells']} claimed "
            f"cells, {rec['anti_keys']} anti keys / {rec['anchors']} anchors "
            f"/ {rec['dependers']} depender pods placed, fit "
            f"reasons {rec['fit_reason_counts']}, launches {rec['launches']};"
            f" every commit, BindRequest, eviction, chunk count and anti_used"
            f" == CPU oracle ({cpu_s:.1f} s), no host holds two pods of one "
            f"anti term, every depender beside its anchor")
        log("  phases (last run): " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec["phase_seconds"].items()))
        log("  in-cycle kernel device ms / launches (profiled run): "
            + ", ".join(f"{k} {v['ms']:.3f} / {v['launches']}"
                        for k, v in in_cycle.items() if v["launches"]))
        log(f"  elapsed {time.perf_counter() - t_start:.0f} s")
    aff_checks = affinity_kernel_checks(acaps)
    for k in ("affinity_mask", "anti_mark"):
        checks[k] = aff_checks.pop(k)
    del acaps
    #: the main path each kernel's launches are read from
    path_of = {k: ("headline", launches) for k in ALLOCATE_KERNELS}
    for k, cell in (("cumsum_ds", "saturated_sequential"),
                    ("freed_by_mask", "saturated_sequential"),
                    ("replace_victims", "fragmented"),
                    ("freed_by_lane", "saturated"),
                    ("pertask_fill", "sharing"),
                    ("dense_accept", "sharing"),
                    ("topo_tables_build", "topology"),
                    ("topo_tables_update", "topology"),
                    ("affinity_mask", "affinity"),
                    ("anti_mark", "affinity")):
        path_of[k] = (cell, report[cell]["launches"])
    #: each kernel mode and the cell whose run its row's launches read
    mode_path = {"type_tables:lanes": "saturated",
                 "uniform_fill:lanes": "saturated",
                 "sparse_accept:credit": "preempt_many_queues",
                 "uniform_fill:topology": "topology",
                 "uniform_fill:preferred": "topology",
                 "dense_accept:no_devices": "topology",
                 "pertask_fill:topology": "topology_subgroups",
                 "pertask_fill:banned": "topology_subgroups",
                 "uniform_fill:mask": "affinity",
                 "pertask_fill:mask": "affinity_sharing"}

    #: each mode's launches, counted by its wrapper at the launch in the
    #: last timed run of its cell (config 4 prefers no level: K3's
    #: preferred mode launches 0 times there, and is held on the captured
    #: inputs only)
    mode_launches = {m: report[c]["launches"][m]
                     for m, c in mode_path.items()}

    mode_checks = {**topo_checks, **aff_checks}
    for name, c in (list(checks.items()) + list(lane_checks.items())
                    + list(mode_checks.items())):
        cell, counts = (path_of[name] if name in path_of else
                        (mode_path[name], report[mode_path[name]]["launches"]))
        base = name.split(":")[0]
        if name in mode_launches:
            counts = {base: mode_launches[name]}
        lib = ("" if c.get("nearest_library_ms") is None else
               f", nearest library call {c['nearest_library']}: "
               f"{c['nearest_library_ms']:.4f} ms")
        in_cyc = ", ".join(
            f"{v} {report[v]['in_cycle_ms'][base]['ms']:.3f} ms / "
            f"{report[v]['in_cycle_ms'][base]['launches']} launches"
            for v in PROFILED_CELLS)
        log(f"kernel {name}: equal to its plain version (max_abs_err "
            f"{c['max_abs_err']}), {c['ms']:.4f} ms kernel, "
            f"{c['plain_ms']:.4f} ms plain, {counts[base]} launches per "
            f"{cell} cycle, bound {c['bound_ms']:.6f} ms by "
            f"{c['bound_by']} [{c['shape']}]{lib}; in-cycle device time "
            f"in the profiled runs: {in_cyc}")
    log(f"launch floor (one PyTorch call on one element): "
        f"{report['launch_floor_ms']:.4f} ms")
    report["kernel_checks"] = dict(checks, **lane_checks, **mode_checks)
    rows = []
    for name, info in kernels.KERNELS.items():
        c = checks[name]
        cell, counts = path_of[name]
        row = dict(name=name, route="cuda", source=info.source,
                   replaces=info.replaces, launches=counts[name],
                   max_abs_err=c["max_abs_err"], ms=c["ms"],
                   plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                   bound_by=c["bound_by"], library_ms=None,
                   launches_path=cell,
                   nearest_library_ms=c.get("nearest_library_ms"),
                   in_cycle_ms={v: report[v]["in_cycle_ms"][name]["ms"]
                                for v in PROFILED_CELLS})
        mode = f"{name}:lanes" if f"{name}:lanes" in lane_checks else \
            f"{name}:credit"
        if mode in lane_checks:
            m = lane_checks[mode]
            row["victim_mode"] = dict(
                cell=mode_path[mode], launches=mode_launches[mode],
                **{k: m[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "shape")})
        rows.append(row)
    # the topology and affinity paths' modes, a row each (the launches of
    # the kernel in the cell that runs the mode)
    for name, c in mode_checks.items():
        base = name.split(":")[0]
        info = kernels.KERNELS[base]
        cell = mode_path[name]
        rows.append(dict(
            name=name, route="cuda", source=info.source,
            replaces=info.replaces,
            launches=mode_launches[name],
            max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=None,
            launches_path=cell if mode_launches[name] else None,
            in_cycle_ms=({v: report[v]["in_cycle_ms"][base]["ms"]
                          for v in PROFILED_CELLS}
                         if mode_launches[name] else None)))
    report["kernels"] = rows
    report["card"] = card
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    report["seconds"] = time.perf_counter() - t_start
    log(f"chip_smoke: {report['seconds']:.0f} s")
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
