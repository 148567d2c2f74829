"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kai_scheduler_tpu_torch`` end to end on the card and fails
(non-zero exit, no result line) on any build error, launch error or
mismatch:

1. builds the hand-written CUDA kernels K1-K16 from ``csrc/`` (one
   ``nvcc`` per source, all started together; seventeen entry points: K11
   is a build and an update) and prints the card's name and power limit;
   every cell of steps 2-9 runs the classic snapshot
   (``incremental=False``, as in earlier slices) so its records stay
   comparable, and step 9b runs the journaled incremental and resident
   snapshot;
   every cycle below runs the cluster-health pass (K14) at the default
   ``analytics_every=1``, and its bundle rides the packed commit that
   must equal the oracle's;
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
     the rack level (the gang preferring its block), 300 gangs —
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
     batch_size=1)``, the sequential engine, its depth cut to 64
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
   - *sharing_reclaim* at the default config, the per-task path with the
     device share table (``SHARING_RECLAIM``): the sharing fleet ~79 %
     held by whole-device training gangs and 0.5 / 24 GiB inference
     shares of two over-quota leaves, nothing idle that a pending pod
     fits; consolidation (the solver's one-lane K9, K7 moving inference
     victims into a tainted pool) places the training gangs, reclaim's
     dense per-task wavefront (K8's device table, K9's lanes mode, the
     dense accept with its device terms) the other leaves' fractions and
     shares, preempt the over-quota leaves' urgent fractions — every
     action must have worked, fractions placed on devices; its CPU oracle
     runs in the oracle process and is compared at the end;
   - *mig_reclaim* at the default config (``MIG_RECLAIM``): 10,000 nodes x
     8 H100 under the mixed MIG strategy (7 x 1g.10gb, 3 x 2g.20gb or
     2 x 3g.40gb a GPU, or whole GPUs: E = 3), 80 % held by two
     over-quota leaves, the free slices stranded behind taken CPU;
     allocate's per-task chunks place what fits idle (K9 and K10
     extended), consolidation moves 3g victims into a tainted pool (K9's
     extended legacy mode, K7 with E = 3), reclaim's dense wavefront (K8's
     extended table, K9's extended lanes mode) and preempt the rest, the
     stale pass evicts (K6's [N, E] table) — every action must have
     worked; its CPU oracle runs in the oracle process;
   the packed commit, BindRequests, evictions (pod, move target) and
   move rebinds must equal the CPU oracle's; then K5-K8 and the victim
   modes of K2-K4 (per-lane pools, per-lane queue tables and score bias,
   the freed credit), K8's device and extended modes, K9's lanes, legacy
   and extended modes and K10's extended mode (with mig_reclaim's K6 and
   K7 calls, and sharing_reclaim's K7 calls) are held against their plain
   versions on the captured inputs and timed; then K8 (every mode), K7,
   K5 and K12 on ``state.kernel_edges``' inputs (1 to 4,096 lanes, node
   0's padding rows, tied scores, a victim that fits nowhere, K5's tile
   and root-chunk edges, K12 at 37 nodes, ...) are held against their
   plain versions, tolerance 0;
8. runs the four affinity cells (in-cycle affinity terms: cross-gang
   required anti-affinity, anchors with dependers, shared host ports) the
   same way — a profiled warm-up with the inputs captured, timed runs on
   fresh clusters with the counts reset just before and read just after,
   one CPU oracle run; every commit, BindRequest, eviction, chunk count and
   the claimed-domain table ``anti_used`` equal to the oracle's, no host
   holding two placed pods of one anti term, every placed depender beside
   its anchor; each cell's kernels and modes launched in every timed run:
   - *affinity* (allocate only, the uniform path, uncut, three timed runs):
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
9. runs the *repack_racks* cell (allocate only, the default analytics and
   repack knobs): 5,120 nodes x 8 accelerators in 640 racks of 8, 35,840
   running one-device preemptible pods leaving one device free per node,
   4 pending rack-required gangs of 32 — four cycles with a binder pass
   and a tick after each, under the profiler with K14's, K15's and K4's
   repack inputs captured, then timed (counts reset before the first
   cycle, read after the last), then on the CPU oracle: every cycle's
   commit (analytics and plan tails included), decisions and documents
   equal; the trigger fires on cycle 3 with 24 moves out of one rack,
   none into it, and cycle 4 binds the 32 pods there; then K14 (on the
   headline, sharing, affinity and repack_racks inputs), K15 and K4's
   repack mode are held against their plain versions and timed;
9b. runs the *resident_churn* cell (``bench.py``'s resident
   configuration): the headline fleet (10,000 nodes x 8, 6,250 gangs of 8,
   half running, each running pod on its own device), the five default
   actions, analytics every cycle, default repack knobs, and a churn of
   1% a cycle (250 running pods evicted, 250 pending pods bound to random
   nodes, a tick); ``SchedulerConfig(resident=True)`` runs the cold cycle,
   then two twins join from deep copies of its cluster and the three take
   the stream cycle by cycle — the patched twin (``incremental=True``) and
   the full twin (``incremental=False``, built at the resident run's
   padded sizes: the snapshotter's slack padding decides near-ties of the
   placement scores otherwise) — warm-up cycles until the mode
   is resident (at most 4), one resident cycle under the profiler's CUDA
   activity, then 8 timed ones; the resident run's launch counts reset
   just before each of its cycles and read just after, its device state
   read back against the host mirror after every cycle; every cycle's
   BindRequests, evictions and analytics document equal to both twins'
   and to the CPU oracle's (the same stream with ``resident=True`` on the
   CPU, in the oracle process), its packed commit byte-equal to all
   three, one ``delta-apply`` upload of the
   packed delta's bytes with 0 redundant bytes and one K16 launch a
   resident cycle; then K16 is held against its plain version on every
   captured delta (each checked for unique indices first) and timed
   beside the nearest ``index_put_`` loop, and K6's calls of the profiled
   cycle (reclaim's queue-only ``freeable`` bound, the stale pass) are
   held against the plain version on CPU copies and timed;
10. runs the headline's five and two of affinity's timed cycles again,
   each against its oracle, once the oracle process (below) is idle, and
   prints both medians beside those of the runs it was busy for;
11. prints one JSON line of per-kernel numbers (a row per kernel and per
   topology, mask, repack and queue-only mode; K3's rows with
   ``torch.topk``'s time as the nearest library call), the card line,
   and last ``{"ok":
   true, "device": {...}}``.

The CPU oracles of the affinity and sharing cells (the slowest), then
those of saturated, saturated_sequential, preempt_many_queues and
fragmented, run in one spawned child process beside the card's work, on
half the cores, and resident_churn's, then sharing_reclaim's and
mig_reclaim's, in a second one on a quarter of them, all submitted when the script starts; each cell is compared with
its oracle when the result arrives (sharing and the victim cells after
the last cell).  The log also goes, line by line,
to ``chiprun_out/chip_smoke.log``.  Longer output
(the compiler's register/spill report, per-phase numbers) goes to
``chiprun_out/chip_smoke.json``, and the first captured call of every
K3, K6, K9 and K10 mode, of K8's three modes and of K7 (its call with the
most victims on fragmented and on sharing_reclaim) to
``build/kernel_inputs.pt``
(``scripts/compare_kernels.py`` times another checkout's kernels on
them).  Imports nothing of JAX.
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
#: the first captured call of every K3, K6, K9 and K10 mode, saved for
#: scripts/compare_kernels.py (an older checkout's kernels on these inputs)
KERNEL_INPUTS_PATH = os.path.join(ROOT, "build", "kernel_inputs.pt")
KERNEL_INPUTS: dict = {}


#: the script's log, also written line by line to
#: ``chiprun_out/chip_smoke.log``, so that the whole log survives where only
#: the end of standard output is kept
_LOG_FILE = None


def log(msg: str) -> None:
    print(msg, flush=True)
    if _LOG_FILE is not None:
        _LOG_FILE.write(msg + "\n")
        _LOG_FILE.flush()


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
                     "uniform_fill": (0, 9), "sparse_accept": (0, 9),
                     "cluster_analytics": (0,)}

    def __init__(self, keep: dict):
        from kai_scheduler_tpu_torch.framework import scheduler
        from kai_scheduler_tpu_torch.ops import (allocate, drf, repack, stale,
                                                 victims)
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
                       (victims, "pertask_fill", "pertask_fill:lanes"),
                       (allocate, "pertask_fill", "pertask_fill"),
                       (allocate, "dense_accept", "dense_accept"),
                       (allocate, "topo_tables_build", "topo_tables_build"),
                       (allocate, "topo_tables_update",
                        "topo_tables_update"),
                       (allocate, "affinity_mask", "affinity_mask"),
                       (allocate, "anti_mark", "anti_mark"),
                       (victims, "affinity_mask", "affinity_mask:victims"),
                       (victims, "anti_mark", "anti_mark:victims"),
                       (scheduler, "cluster_analytics",
                        "cluster_analytics"),
                       (repack, "repack_fill", "repack_fill"),
                       (repack, "sparse_accept", "sparse_accept:repack"))
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


def _standalone(x):
    """``x`` with every tensor in it (through tuples, lists, dicts and
    dataclasses) copied into a storage of its own: the snapshot's leaves
    view one uploaded buffer under several dtypes, which ``torch.save``
    refuses."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_standalone(v) for v in x)
    if isinstance(x, dict):
        return {k: _standalone(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _standalone(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


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
    "affinity_mask": ("affinity_mask_nodes_kernel",),
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
    """The tensors of an output, in order (a table not built, None, has
    none)."""
    if out is None:
        return []
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


def k9_bound(nodes, prior, Q, D, steps, pools, more=0, ops=60):
    """K9's bound: the node tables once (with D device columns; the node
    pools each in ``pools`` once — a shared [N, .] table or each lane's
    [B, N, .] slice), the lanes' gang rows once, the lane outputs written
    once, plus ``more`` bytes; ``ops`` f32 operations a node per task
    step that placed (the fit on both pools, the bands, the score)."""
    B, T = prior.shape
    N = nodes.labels.shape[0]
    K = nodes.labels.shape[1]
    X = nodes.filter_masks.shape[0]
    L = nodes.topology.shape[1]
    node_bytes = (N * (4 * 12 + 2 * 4 * D + 1 + 4 * K + 5 * X + 4 + 4 * L)
                  + _nbytes(*pools))
    lane_bytes = B * (8 + T * (12 + 1 + 4 * K + 4 * 5))
    out_bytes = B * (2 * Q * 12 + T * 9 + 1 + T * (24 + 8 * D))
    return bound(node_bytes + lane_bytes + out_bytes + more, steps * N * ops)


def k3_nearest(args, kw) -> dict:
    """K3's nearest single PyTorch call, timed: ``torch.topk`` over the
    lanes' [B, N] f32 score rows (each lane's band row) at k = min(T, N).
    Not K3's function: no jitter, fill or assignment, and no tie order."""
    cand, prior, lt, tables = args[0], args[1], args[8], args[9]
    sc = tables[4]
    rows = kw.get("rows")
    ty = (lt.task_type0[cand.long()] if rows is None else rows).long()
    scores = sc[ty].contiguous()
    k = min(prior.shape[1], sc.shape[1])
    return dict(nearest_library_ms=_time_ms(lambda: torch.topk(scores, k)),
                nearest_library=f"torch.topk of the [B, N] score rows at "
                                f"k={k} (no fill, no tie order)")


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
                               shape=f"B={B} T={T} N={N} Q={Q}",
                               **k3_nearest(args, kw))
    KERNEL_INPUTS["uniform_fill"] = cap.calls["uniform_fill"][0]

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
                    "sparse_accept", "cluster_analytics")
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
                "fragmented": ("fragmented", None),
                "sharing_reclaim": ("sharing_reclaim", None),
                "mig_reclaim": ("mig_reclaim", None)}
#: the sequential cell's depth cut: reclaim attempts at most this many
#: preemptors per queue (the cell's 1,250 pending gangs wait in two
#: queues), about a tenth of the full run's steps, so that the script
#: stays within its time limit (cut from 128 when a slower host ran the
#: script in 1,132 s)
SEQUENTIAL_QUEUE_DEPTH = 64
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
    "saturated": dict(_LANES, cumsum_ds=(0, 1, 2, 3)),
    "saturated_sequential": {"cumsum_ds": (0, 1), "freed_by_mask": (0, 3)},
    "preempt_many_queues": dict(_LANES, cumsum_ds=(0,)),
    "fragmented": {"cumsum_ds": (0,), "freed_by_mask": (1, 40),
                   "replace_victims": (0, 20)},
    # consolidation's one-lane legacy fills (K9 through the solver) come
    # first, then reclaim's and preempt's chunks
    "sharing_reclaim": {"cumsum_ds": (0, 1, 5, 11),
                        "freed_by_lane": (0, 1, 2, 30),
                        "pertask_fill:lanes": (0, 1, 2, 30),
                        "pertask_fill": (0, 5, 40),
                        "replace_victims": (0, 5, 40)},
    # allocate's per-task chunks and consolidation's one-lane legacy fills
    # (K9 through the solver) share the allocate module's K9 site
    "mig_reclaim": {"cumsum_ds": (0, 1, 5, 10, 19),
                    "freed_by_lane": (0, 1, 2, 20),
                    "pertask_fill:lanes": (0, 1, 2, 20),
                    "pertask_fill": (0, 1, 2, 6, 10, 14, 18, 22),
                    "dense_accept": (0, 1, 2),
                    "freed_by_mask": (0, 1, 5, 30),
                    "replace_victims": (0, 5, 20)},
}
#: the victim cells whose calls of K5 are captured and held (the affinity
#: and resident cells' calls are held only through their cycles' oracles)
K5_CELLS = ("saturated", "saturated_sequential", "preempt_many_queues",
            "fragmented", "sharing_reclaim", "mig_reclaim")
#: the kernels each victim cell must launch
VICTIM_NEED = {
    "saturated": ("cumsum_ds", "freed_by_mask", "freed_by_lane",
                  "type_tables", "uniform_fill", "cluster_analytics"),
    "saturated_sequential": ("cumsum_ds", "freed_by_mask", "type_tables",
                             "uniform_fill", "cluster_analytics"),
    "preempt_many_queues": ("cumsum_ds", "freed_by_lane", "type_tables",
                            "uniform_fill", "sparse_accept",
                            "cluster_analytics"),
    "fragmented": ("cumsum_ds", "freed_by_mask", "replace_victims",
                   "type_tables", "uniform_fill", "cluster_analytics"),
    "sharing_reclaim": ("drf_water_fill", "cumsum_ds", "freed_by_mask",
                        "replace_victims", "freed_by_lane",
                        "freed_by_lane:devices", "pertask_fill",
                        "pertask_fill:lanes", "pertask_fill:legacy",
                        "cluster_analytics"),
    "mig_reclaim": ("drf_water_fill", "cumsum_ds", "freed_by_mask",
                    "replace_victims", "freed_by_lane",
                    "freed_by_lane:extended", "pertask_fill",
                    "pertask_fill:extended", "pertask_fill:lanes",
                    "pertask_fill:legacy", "dense_accept",
                    "dense_accept:extended", "cluster_analytics"),
}
#: the sharing_reclaim cell (the victim actions on the per-task path with
#: the device share table): ``state.fleets.sharing_reclaim_objects`` —
#: the sharing cell's fleet (10,000 nodes x 8 devices of 80 GiB, two
#: departments of two leaves) with ~79 % of the devices held by running
#: pods in the first two leaves (whole-device training gangs on 47 % of
#: the nodes, 0.5 and 24 GiB inference shares on 51 %, the CPU and memory
#: of those nodes taken, a tainted inference pool of 2 %); pending in the
#: other two leaves, in the sharing cell's proportions (training gangs of
#: 8 whole-device pods : 0.5 fractions : 24 GiB shares = 1 : 6 : 3, the
#: fractions and shares non-preemptible), plus urgent 0.5 fractions of the
#: first two leaves at priority 2.  The backlog is cut to 8 + 48 + 24
#: (+ 16 urgent) gangs so that the cell's CPU oracle (consolidation's
#: linear walk, the wavefront's dense [B, N, D] accept and the plain K9 at
#: 10,000 nodes, step by step) stays a small part of the script's time:
#: 43-46 s in an oracle process on the H100 machine's host
SHARING_RECLAIM = dict(num_nodes=10_000, training=8, fractions=48, memory=24,
                       urgent=16)
#: the mig_reclaim cell (MIG and other extended scalar resources through
#: allocate and the four victim actions): ``state.fleets.
#: mig_reclaim_objects`` — 10,000 nodes x 8 H100 80GB under the NVIDIA
#: device plugin's ``mixed`` MIG strategy (30 % of the nodes split every
#: GPU into 7 x 1g.10gb, 30 % into 3 x 2g.20gb, 10 % into 2 x 3g.40gb, 30 %
#: keep 8 whole GPUs: E = 3), two departments of two leaves; 80 % of the
#: slices and whole GPUs held by the first two leaves (one-slice inference
#: gangs whose CPU strands the free slices, training gangs of 8), a
#: tainted pool of 2 %, 16 running gangs stale below their quorum.
#: Pending in the other two leaves: one-slice inference gangs (1g : 2g :
#: 3g = 4 : 2 : 1, non-preemptible), 3g pairs and training gangs of 8
#: (preemptible), plus urgent 1g slices of the first two leaves at
#: priority 2.  Allocate places what fits idle (the whole nodes left, a few
#: roomy MIG nodes: K9 and K10 extended), consolidation moves 3g victims
#: into the pool (K7), reclaim's dense wavefront (K8's extended table,
#: K9's extended lanes mode) and preempt the rest, the stale pass evicts
#: (K6's [N, E] table).  The backlog is cut to 176 + 16 + 16 (+ 8 urgent)
#: gangs so that the cell's CPU oracle takes about a minute (54 s on a
#: 4-thread CPU run of the port, 46 s in an oracle process on the H100
#: machine's host)
MIG_RECLAIM = dict(num_nodes=10_000, inference=176, pairs=16, training=16,
                   urgent=8, stale=16)


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
#: fraction of a second a chunk at 10,000 nodes x 256 lanes (25 until the
#: oracle process that holds the sharing and affinity oracles set the
#: script's time: 952-956 s of oracles, 1,042-1,086 s in all)
SHARING_CUT = 50
SHARING = dict(num_nodes=10_000, shared_nodes=5_000,
               **{k: v // SHARING_CUT for k, v in SHARING_FULL.items()})
SHARING_RUNS = 3
#: K9 and K10 calls kept in the sharing warm-up: the first chunk (every
#: lane on the fresh fleet) and a later one
SHARING_KEEP = {"pertask_fill": (0, 20), "dense_accept": (0, 20),
                "cluster_analytics": (0,)}
#: the kernels a sharing (per-task) allocate cycle launches
SHARING_KERNELS = ("drf_water_fill", "pertask_fill", "dense_accept",
                   "cluster_analytics")
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
                    "topo_tables_update", "cluster_analytics")
#: the topology_subgroups cell (the per-task path) on the same tree:
#: ``state.fleets.topology_subgroup_objects`` with 300 gangs — a cycle is
#: one chunk per one to two gangs (every lane's domain-binpack band picks
#: the same fullest fitting rack), and the CPU oracle, which runs in the
#: main process, took 96-175 s for 600 gangs on the card's hosts: cut to
#: 300 when a slower host ran the script in 1,132 s
TOPO_SUB = dict(num_nodes=5_000, levels=(8, 16), gangs=300)
TOPO_SUB_RUNS = 3
#: K9's calls alternate between a chunk's first attempt and its retry
#: launch: keep the first chunk's pair and the twentieth's
TOPO_SUB_KEEP = {"pertask_fill": (0, 1, 40, 41), "dense_accept": (0, 20)}
TOPO_SUB_KERNELS = ("drf_water_fill", "pertask_fill",
                    "pertask_fill:topology", "pertask_fill:banned",
                    "dense_accept", "cluster_analytics")
#: the affinity cell (allocate only, the uniform path, uncut): the headline
#: backlog (10,000 nodes, 6,250 gangs of 8) as 64 services whose replicas
#: keep one per host across gangs (a required hostname anti term against
#: their own ``app``), 256 anchors, 256 four-pod dependers each needing its
#: anchor's host, 512 one-pod gangs sharing host port 8443 — 51,792 pods,
#: 321 term rows (padded to 512); K3's mask mode, K12, K13, K1, K2, K4
AFFINITY = dict(num_nodes=10_000, node_accel=8.0, num_gangs=6250,
                tasks_per_gang=8, services=64, anchors=256, dependers=256,
                port_gangs=512)
#: timed affinity cycles (~10 s each on the host); cut from 5 to 3 when
#: the resident_churn cell joined the script, for the time budget
AFFINITY_RUNS = 3
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
#: affinity runs repeated at the end with the oracle processes idle (cut
#: from 3 to 2 with AFFINITY_RUNS, and to 1 when a slower host ran the
#: script in 1,132 s)
IDLE_AFFINITY_RUNS = 1
#: per cell: (timed runs, kernel calls kept in its warm-up, the kernels
#: and modes every timed run must launch)
AFFINITY_CELLS = {
    "affinity": (AFFINITY_RUNS, {"affinity_mask": (0, 60),
                                 "anti_mark": (0, 60),
                                 "uniform_fill": (0, 60),
                                 "cluster_analytics": (0,)},
                 ("drf_water_fill", "type_tables", "uniform_fill",
                  "uniform_fill:mask", "sparse_accept", "affinity_mask",
                  "anti_mark", "cluster_analytics")),
    "affinity_reclaim": (1, {"affinity_mask:victims": (0, 1, 2),
                             "anti_mark:victims": (0, 1, 2),
                             "uniform_fill:lanes": (0, 1, 2)},
                         ("cumsum_ds", "freed_by_lane", "type_tables",
                          "type_tables:lanes", "uniform_fill",
                          "uniform_fill:lanes", "uniform_fill:mask",
                          "affinity_mask", "anti_mark",
                          "cluster_analytics")),
    # the affinity_reclaim fleet on the sequential victim engine, cut as
    # saturated_sequential is (``SEQUENTIAL_QUEUE_DEPTH``): reclaim's
    # scenario search confined to each preemptor's one-lane mask (K12 at
    # one lane, K3's mask mode through ``attempt_gang_dense``), every step
    # marked by K13
    "affinity_reclaim_sequential": (
        1, {"affinity_mask:victims": (0, 1, 2),
            "anti_mark:victims": (0, 1, 2), "uniform_fill": (0, 1, 2)},
        ("cumsum_ds", "freed_by_mask", "type_tables", "uniform_fill",
         "uniform_fill:mask", "affinity_mask", "anti_mark",
         "cluster_analytics")),
    "affinity_sharing": (AFFINITY_SHARING_RUNS,
                         {"affinity_mask": (0, 30), "anti_mark": (0, 30),
                          "pertask_fill": (0, 30)},
                         ("drf_water_fill", "pertask_fill",
                          "pertask_fill:mask", "dense_accept",
                          "affinity_mask", "anti_mark",
                          "cluster_analytics")),
}
#: the cells with a profiled run (each kernel's in-cycle device time)
#: the repack_racks cell (``state.fleets.repack_objects``, allocate only
#: at the default analytics and repack knobs), uncut: 5,120 nodes of 8
#: accelerators in 640 racks of 8, every node running 7 one-device
#: preemptible pods (35,840), one device free per node; 4 pending
#: rack-required gangs of 32 one-device pods.  The free devices are
#: scattered: gangs of 16 or more fit the cluster but no rack
#: (frag_score 5/9 > 0.5), so the trigger fires on cycle 3 and the plan
#: moves 24 pods out of rack 0; the gang places there on cycle 4.  The
#: victim actions refuse required topology, so the cell is allocate only.
REPACK_RACKS = dict(num_nodes=5_120, rack_size=8, node_accel=8,
                    running_per_node=7, gangs=4, gang_size=32)
REPACK_CYCLES = 4
REPACK_FIRES = 3
#: kernel calls kept in its profiled run: the firing cycle's analytics
#: pass, first fit and claim check
REPACK_KEEP = {"cluster_analytics": (2,), "repack_fill": (0,),
               "sparse_accept:repack": (0,)}
#: the cells with a profiled run (each kernel's in-cycle device time)
PROFILED_CELLS = ("sharing", "topology", "topology_subgroups", "saturated",
                  "saturated_sequential", "preempt_many_queues",
                  "fragmented", "sharing_reclaim", "mig_reclaim",
                  *AFFINITY_CELLS,
                  "repack_racks", "resident_churn")


def analytics_fields(res) -> dict:
    """The cycle's analytics numbers for its record; every cycle of every
    cell runs the analytics pass (the default ``analytics_every=1``)."""
    if not res.analytics:
        raise AssertionError("a cycle ran without the analytics pass")
    return dict(analytics_seconds=res.analytics_seconds,
                frag_score=res.analytics["fragmentation"]["score"],
                goodput=res.analytics["goodput"])


def log_analytics(rec: dict) -> None:
    log(f"  analytics (last run): {rec['analytics_seconds']:.4f} s host "
        f"dispatch, frag_score {rec['frag_score']}, goodput "
        f"{rec['goodput']}; the bundle rode the packed commit (== oracle)")


# ---------------------------------------------------------------------------
# the repack_racks cell: analytics every cycle, repack on the firing cycle
# ---------------------------------------------------------------------------

def run_repack_cycles(device: str):
    """``REPACK_CYCLES`` cycles of one Scheduler (allocate only, default
    analytics and repack knobs) on a fresh repack_racks cluster, each
    followed by a binder pass and a tick.  Returns per cycle ``(result,
    seconds, source racks of the moved pods, target racks of the moves,
    racks of the binds)``, and the launch counts of the whole run (reset
    just before the first cycle, read just after the last)."""
    from kai_scheduler_tpu_torch import kernels
    from kai_scheduler_tpu_torch.apis import types as apis
    from kai_scheduler_tpu_torch.binder import Binder
    from kai_scheduler_tpu_torch.framework.scheduler import (Scheduler,
                                                             SchedulerConfig)
    from kai_scheduler_tpu_torch.runtime.cluster import Cluster
    from kai_scheduler_tpu_torch.state.fleets import repack_objects
    cluster = Cluster.from_objects(*repack_objects(apis, **REPACK_RACKS))
    sched = Scheduler(SchedulerConfig(actions=("allocate",),
                                      incremental=False), device=device)
    binder = Binder()

    def rack(node):
        return cluster.nodes[node].labels["topo/rack"]
    out = []
    kernels.reset_launch_counts()
    for _ in range(REPACK_CYCLES):
        t0 = time.perf_counter()
        res = sched.run_once(cluster)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        moves = [ev for ev in res.evictions if ev.move_to is not None]
        out.append((res, secs,
                    {rack(cluster.pods[ev.pod_name].node) for ev in moves},
                    {rack(ev.move_to) for ev in moves},
                    {rack(b.selected_node) for b in res.bind_requests}))
        binder.reconcile(cluster)
        cluster.tick()
    return out, kernels.launch_counts()


def _repack_doc(res) -> dict:
    return {k: v for k, v in res.repack.items() if k != "solve_seconds"}


def check_repack_cycles(gpu, cpu, counts: dict) -> dict:
    """Every GPU cycle equals its CPU oracle cycle (packed commit with the
    analytics and plan tails, binds, evictions with their move targets,
    move rebinds, the analytics and repack documents); the trigger fires
    on cycle ``REPACK_FIRES`` alone, with 24 moves, none into the target
    rack; the next cycle binds the 32 pods of the target gang in one rack,
    at a fragmentation score below the stranded one; K14 launched every
    cycle, K15 and K4's repack mode once."""
    for i, (g, c) in enumerate(zip(gpu, cpu), 1):
        res, cres = g[0], c[0]
        if res.packed.tobytes() != cres.packed.tobytes():
            diff = int((res.packed != cres.packed).sum())
            raise AssertionError(f"repack_racks cycle {i}: packed commit "
                                 f"differs from the CPU oracle in {diff} "
                                 f"of {res.packed.size} i16")
        if _binds(res.bind_requests) != _binds(cres.bind_requests) or \
                _evictions(res) != _evictions(cres) or \
                _binds(res.move_bind_requests) != \
                _binds(cres.move_bind_requests):
            raise AssertionError(f"repack_racks cycle {i}: decisions "
                                 f"differ from the oracle")
        if res.analytics != cres.analytics or \
                _repack_doc(res) != _repack_doc(cres):
            raise AssertionError(f"repack_racks cycle {i}: documents "
                                 f"differ from the oracle")
    fired = [i for i, g in enumerate(gpu, 1) if g[0].repack]
    if fired != [REPACK_FIRES]:
        raise AssertionError(f"repack_racks: fired on cycles {fired}")
    res, _, src, dst, _ = gpu[REPACK_FIRES - 1]
    doc = res.repack
    if not doc["feasible"] or doc["migrations_executed"] != 24 or \
            len(res.move_bind_requests) != 24:
        raise AssertionError(f"repack_racks: firing moved "
                             f"{doc['migrations_executed']} pods")
    if src & dst or len(src) != 1:
        raise AssertionError(f"repack_racks: moves from {src} to {dst}")
    nxt, _, _, _, racks = gpu[REPACK_FIRES]
    big = [b for b in nxt.bind_requests
           if b.pod_name.startswith(doc["target_gang"] + "-")]
    if len(big) != 32 or racks != src:
        raise AssertionError(f"repack_racks: cycle {REPACK_FIRES + 1} "
                             f"bound {len(big)} pods of the target in "
                             f"racks {racks} (freed {src})")
    score = [g[0].analytics["fragmentation"]["score"] for g in gpu]
    if not score[REPACK_FIRES] < score[0]:
        raise AssertionError(f"repack_racks: frag scores {score}")
    need = dict(cluster_analytics=REPACK_CYCLES, repack_fill=1)
    need["sparse_accept:repack"] = 1
    if any(counts[k] != v for k, v in need.items()):
        raise AssertionError(f"repack_racks: launches {counts}")
    return dict(
        cycle_seconds_all=[g[1] for g in gpu],
        cpu_cycle_seconds_all=[c[1] for c in cpu],
        analytics_seconds_all=[g[0].analytics_seconds for g in gpu],
        repack_seconds=res.repack_seconds, frag_scores=score,
        target_gang=doc["target_gang"], target_rack=doc["target_rack"],
        migrations=doc["migrations_executed"], moved_from=sorted(src),
        moved_to=sorted(dst), gang_binds=len(big),
        phase_seconds=[g[0].phase_seconds for g in gpu],
        launches=counts, shape=REPACK_RACKS)


def _bundle_outputs(b):
    from kai_scheduler_tpu_torch.ops import analytics as AN
    return [getattr(b, f) for f in AN.F32_FIELDS + AN.I32_FIELDS]


def analytics_kernel_checks(caps: dict) -> dict:
    """K14 on the analytics inputs captured from the headline, sharing,
    affinity and repack_racks cycles vs its plain version (tolerance 0);
    timed on the headline's.  Bound: bytes — what the kernel reads of the
    node, running-pod, task and queue tables, once, and the bundle written
    once."""
    from kai_scheduler_tpu_torch.ops import analytics as AN
    errs, shapes, rec = [], [], None
    for cell, cap in caps.items():
        for args, kw in cap.calls.get("cluster_analytics", []):
            k_out = cap._orig["cluster_analytics"](*args, **kw)
            p_out = AN.cluster_analytics_plain(*args, **kw)
            errs.append(_max_abs_err(_bundle_outputs(k_out),
                                     _bundle_outputs(p_out)))
            st = args[0]
            shapes.append(f"{cell}: N={st.nodes.n} M={st.running.m} "
                          f"G={st.gangs.g} T={st.gangs.t} Q={st.queues.q}")
            if rec is None:
                rec = (args, kw, cap)
    args, kw, cap = rec
    st, res, ages = args
    n, r, g, q = st.nodes, st.running, st.gangs, st.queues
    ms = _time_ms(lambda: cap._orig["cluster_analytics"](*args, **kw))
    plain_ms = _time_ms(lambda: AN.cluster_analytics_plain(*args, **kw), 5)
    cfg = kw["config"]
    # the kernel reads one topology column (rack_level) of the nodes that
    # host a unit, and column 0 of the requests of the running pods and
    # placed tasks that count towards goodput; the rest in full
    unit = torch.tensor(cfg.unit_req, dtype=torch.float32, device=n.free.device)
    racked = int((AN.unit_pods_per_node(torch.clamp(n.free, min=0.0),
                                        n.valid, unit) > 0).sum())
    running = int((r.valid & ~r.releasing & ~res.victim).sum())
    placed = int(((res.placements >= 0) & g.task_valid
                  & res.allocated[:, None] & ~res.pipelined).sum())
    nb = (_nbytes(n.free, n.allocatable, n.valid, n.releasing,
                  res.free, res.releasing_extra, res.victim, res.placements,
                  res.allocated, res.pipelined, res.queue_allocated,
                  r.valid, r.releasing, g.valid, g.task_valid,
                  ages, q.valid, q.fair_share)
          + 4 * (racked + running + placed + len(cfg.gang_ladder))
          + 4 * (AN.f32_len(cfg, q=q.q, r=3, g=g.g) + min(cfg.top_k, g.g)))
    b, by = bound(nb, 40 * n.n + 4 * r.m + 6 * g.g * g.t + 4 * q.q * q.q)
    return {"cluster_analytics": dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b,
        bound_by=by, shape="; ".join(shapes), checked=len(errs))}


def repack_kernel_checks(cap: Capture) -> dict:
    """K15 and K4's repack mode on the repack_racks firing inputs vs their
    plain versions (tolerance 0), timed.  K15's bound: bytes — the pool,
    the destination and filter rows and the slots' pods read once (the
    walk's P dependent steps are its latency, not its work)."""
    from kai_scheduler_tpu_torch.ops import allocate as A
    from kai_scheduler_tpu_torch.ops import repack as RP
    out = {}
    (args, kw), = cap.calls["repack_fill"]
    k_out = cap._orig["repack_fill"](*args, **kw)
    p_out = RP.repack_fill_plain(*args, **kw)
    err = _max_abs_err(k_out, p_out)
    slot_pod, req, fclass, dest_ok, fmasks, free0 = args
    P, N = slot_pod.shape[0], free0.shape[0]
    ms = _time_ms(lambda: cap._orig["repack_fill"](*args, **kw))
    plain_ms = _time_ms(lambda: RP.repack_fill_plain(*args, **kw), 5)
    b, by = bound(_nbytes(slot_pod, dest_ok, fmasks, free0) + P * (12 + 4)
                  + P * 4, P * N * 8)
    out["repack_fill"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        shape=f"P={P} N={N} X={fmasks.shape[0]} "
              f"({int((k_out >= 0).sum())} placed)")
    (args, kw), = cap.calls["sparse_accept:repack"]
    plain_kw = {k: v for k, v in kw.items() if k != "mode"}
    k_out = cap._orig["sparse_accept:repack"](*args, **kw)
    p_out = A.sparse_accept_plain(*args, **plain_kw)
    err = _max_abs_err(k_out, p_out)
    if int(k_out[0]) < P:
        raise AssertionError("repack: K4 truncated a sound plan")
    K = args[0].numel()
    ms = _time_ms(lambda: cap._orig["sparse_accept:repack"](*args, **kw))
    plain_ms = _time_ms(lambda: A.sparse_accept_plain(*args, **plain_kw))
    lg = max(1, (K - 1).bit_length())
    nb = _nbytes(*args[:4]) + K * 2 * 12 + 4 + K * 8
    b, by = bound(nb, K * lg * lg // 2 + K * 18)
    out["sparse_accept:repack"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        shape=f"K={K} (B={K}, T=1) N={args[6]}")
    return out


# ---------------------------------------------------------------------------
# the resident_churn cell: the journaled incremental snapshot, resident
# ---------------------------------------------------------------------------

#: bench.py's ``bench_resident`` configuration: the headline fleet, half
#: of the gangs running, each running pod on its own device
RESIDENT_CHURN = dict(num_nodes=10_000, node_accel=8.0, num_gangs=6_250,
                      tasks_per_gang=8, running_fraction=0.5)
#: churn a cycle: 1% of the pods (250 evicted, 250 bound), then a tick
RESIDENT_FRAC = 0.01
#: untimed cycles after the cold one until the mode is resident, at most
RESIDENT_WARM = 4
#: timed cycles (after one more untimed cycle under the profiler)
RESIDENT_TIMED = 8
#: the three runs of the stream: the resident path, the patched twin
#: (incremental, changed leaves shipped) and the full twin (the whole
#: snapshot built and uploaded every cycle)
RESIDENT_KINDS = ("resident", "patched", "full")


def resident_config(kind: str):
    from kai_scheduler_tpu_torch.framework.scheduler import SchedulerConfig
    return {"resident": SchedulerConfig(resident=True),
            "patched": SchedulerConfig(incremental=True, resident=False),
            "full": SchedulerConfig(incremental=False)}[kind]


def resident_cluster():
    from kai_scheduler_tpu_torch.apis import types as apis
    from kai_scheduler_tpu_torch.runtime.cluster import Cluster
    from kai_scheduler_tpu_torch.state import fleets, make_cluster
    return Cluster.from_objects(*fleets.steady_objects(
        apis, make_cluster, **RESIDENT_CHURN))


class ResidentRun:
    """One run of the churn stream: its own cluster, churn generator
    (``default_rng(0)``) and Scheduler.  The first cycle is cold; every
    later one is preceded by one cycle of churn."""

    def __init__(self, kind: str, device: str, cluster=None):
        from kai_scheduler_tpu_torch.framework.scheduler import Scheduler
        import numpy as np
        self.kind, self.device = kind, device
        self.cluster = cluster if cluster is not None else resident_cluster()
        self.sched = Scheduler(resident_config(kind), device=device)
        self.rng = np.random.default_rng(0)
        self.cycles = 0

    def step(self, before=None, capacity=None):
        """One cycle; ``before`` runs just before ``run_once`` (the launch
        counts' reset); ``capacity`` (the full twin) pins the full build's
        padded sizes.  Returns ``(result, seconds)``."""
        import functools
        from kai_scheduler_tpu_torch.apis import types as apis
        from kai_scheduler_tpu_torch.framework import session
        from kai_scheduler_tpu_torch.state import fleets
        if self.cycles:
            fleets.churn_cluster(apis, self.cluster, self.rng, RESIDENT_FRAC,
                                 RESIDENT_CHURN["num_nodes"])
        if before is not None:
            before()
        orig = session.build_snapshot
        if capacity is not None:
            session.build_snapshot = functools.partial(orig,
                                                       capacity=capacity)
        try:
            t0 = time.perf_counter()
            res = self.sched.run_once(self.cluster)
            if self.device == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            session.build_snapshot = orig
        self.cycles += 1
        return res, secs

    @property
    def last(self) -> dict:
        snap = self.sched._snapshotter
        return dict(snap.stats.last) if snap is not None else {"mode": "open"}


def resident_record(res, last: dict) -> dict:
    """What a cycle decided, in plain data (the oracle process returns
    these)."""
    return dict(packed=res.packed,
                binds=[dataclasses.asdict(b) for b in res.bind_requests],
                evictions=[dataclasses.asdict(e) for e in res.evictions],
                analytics=res.analytics, mode=last["mode"],
                fallback_reason=last.get("fallback_reason", ""),
                bytes_shipped=last.get("bytes_shipped", 0))


def resident_schedule(run: ResidentRun, step):
    """Drive the cell's schedule on ``run`` (the resident one): the cold
    cycle, warm-up cycles until the mode is resident (at most
    ``RESIDENT_WARM``), one more untimed cycle ("profiled"), then
    ``RESIDENT_TIMED`` timed ones.  ``step(phase)`` runs one cycle of every
    run of the stream and returns the resident run's last stats."""
    step("cold")
    for _ in range(RESIDENT_WARM):
        if step("warm")["mode"] == "resident":
            break
    step("profiled")
    for _ in range(RESIDENT_TIMED):
        step("timed")


def run_resident_oracle():
    """The CPU oracle of the resident_churn cell: the port on the CPU with
    ``resident=True`` over the same stream, on its own cluster built from
    the same seed.  Returns ``(records, seconds)``."""
    t0 = time.perf_counter()
    run = ResidentRun("resident", "cpu")
    records = []

    def step(phase):
        res, _ = run.step()
        records.append(dict(resident_record(res, run.last), phase=phase))
        return run.last
    resident_schedule(run, step)
    return records, time.perf_counter() - t0


def _same_decisions(a: dict, b: dict) -> bool:
    return (a["binds"] == b["binds"] and a["evictions"] == b["evictions"]
            and a["analytics"] == b["analytics"])


def run_resident_cell(device: str = "cuda"):
    """The resident_churn cell on the card: the resident run's cold cycle
    (25,000 pods placed in ~2,400 allocate chunks), then the twins from
    deep copies of its cluster, and every later cycle of the three runs in
    turn; the resident run's launch counts reset just before its cycle
    and read just after, its device state read back and held against the
    host mirror after every cycle (outside the timing), K16's inputs
    captured on every resident cycle (the delta; after the cycle, outside
    its timing, one copy of a state of each layout), the "profiled" cycle
    under the profiler's CUDA activity.  Returns ``(per-cycle records, captured K16
    calls, profiler in-cycle table, fallbacks, set-up seconds, K6's
    captured calls)``."""
    import copy
    import weakref
    from torch.profiler import ProfilerActivity, profile
    from kai_scheduler_tpu_torch import kernels
    from kai_scheduler_tpu_torch.ops import resident as RS
    from kai_scheduler_tpu_torch.state.cluster_state import (
        state_from_leaves, state_leaves)
    t0 = time.perf_counter()
    runs = {"resident": ResidentRun("resident", device)}
    build_s = time.perf_counter() - t0
    # (layout, delta) of every resident cycle, and for each layout one
    # copy of a resident state, cloned after the cycle (outside its timing)
    captured, bases, pending = [], {}, []
    orig_apply = RS.apply_delta
    #: K6's calls in the profiled cycle (reclaim's bound, the stale pass)
    k6cap = Capture({"freed_by_mask": range(16)})

    def capture(state, delta):
        pending.append((state, delta))
        return orig_apply(state, delta)

    def take_captured():
        for state, delta in pending:
            leaves = state_leaves(state)
            key = tuple((k, tuple(t.shape)) for k, t in leaves.items())
            if key not in bases:
                bases[key] = state_from_leaves(
                    {k: t.clone() for k, t in leaves.items()})
            captured.append((bases[key], delta))
        pending.clear()
    records, in_cycle = [], None

    def join_twins():
        # the twins take the stream from here: the cold cycle is not a
        # resident cycle, and running it three times on the card cost
        # ~150 s of the script's budget.  Each twin starts from a deep
        # copy of the cluster the cold cycle left and from the resident
        # run's host-side history (the pending ages behind the
        # starvation table); its own first snapshot is a full build, as
        # the resident run's next one is (the cold cycle's BindRequests
        # dirty half the pods)
        src = runs["resident"]
        for kind in RESIDENT_KINDS[1:]:
            twin = ResidentRun(kind, device, copy.deepcopy(src.cluster))
            twin.cycles = src.cycles
            twin.sched._cycle_index = src.sched._cycle_index
            twin.sched._pending_age = dict(src.sched._pending_age)
            twin.sched._age_cluster = weakref.ref(twin.cluster)
            runs[kind] = twin

    def step(phase):
        nonlocal in_cycle
        rec = {"phase": phase}
        res_run = runs["resident"]
        RS.apply_delta = capture
        try:
            if phase == "profiled":
                acts = [ProfilerActivity.CUDA if device == "cuda"
                        else ProfilerActivity.CPU]
                with profile(activities=acts) as prof, k6cap:
                    res, secs = res_run.step(kernels.reset_launch_counts)
                    counts = kernels.launch_counts()
                in_cycle = in_cycle_device_ms(prof)
                del prof
                # the resident state changes in place next cycle: keep
                # copies of what K6 read
                k6cap.calls["freed_by_mask"] = [
                    (_standalone(a), _standalone(kw))
                    for a, kw in k6cap.calls.get("freed_by_mask", [])]
            else:
                res, secs = res_run.step(kernels.reset_launch_counts)
                counts = kernels.launch_counts()
        finally:
            RS.apply_delta = orig_apply
        take_captured()
        res_run.sched._snapshotter.verify_device_residency()
        rec["resident"] = dict(resident_record(res, res_run.last),
                               seconds=secs, launches=counts,
                               phases=res.phase_seconds, wire=res.wire,
                               action_seconds=res.action_seconds)
        if phase == "cold":
            join_twins()
            records.append(rec)
            return res_run.last
        # the full twin builds at the resident run's padded sizes: the
        # snapshotter pads with slack (11,250 nodes for 10,000), and the
        # padded shapes decide near-ties of the placement scores, in the
        # reference too; at the same sizes the full build equals the
        # snapshotter's mirror (what its verify mode asserts)
        cap = res_run.sched._snapshotter._capacity
        for kind in RESIDENT_KINDS[1:]:
            r, secs = runs[kind].step(
                capacity=cap if kind == "full" else None)
            rec[kind] = dict(resident_record(r, runs[kind].last),
                             seconds=secs, phases=r.phase_seconds)
        records.append(rec)
        return res_run.last
    resident_schedule(runs["resident"], step)
    fallbacks = {k: dict(r.sched._snapshotter.stats.fallbacks)
                 for k, r in runs.items() if r.sched._snapshotter}
    return (records, captured, in_cycle, fallbacks, build_s,
            k6cap.calls.get("freed_by_mask", []))


def check_resident_cell(records: list, oracle: list) -> dict:
    """Every cycle of the resident run equals both twins (BindRequests
    with their device indices, evictions, the analytics document) and its
    packed commit equals theirs and the CPU oracle's (the same padded
    sizes); every resident cycle made ONE ``delta-apply`` upload of
    the packed delta's bytes with 0 redundant bytes and launched K16 once;
    the warm-up reached resident mode and every timed cycle is
    resident."""
    if len(records) != len(oracle):
        raise AssertionError(f"resident_churn: {len(records)} cycles, the "
                             f"oracle {len(oracle)}")
    for i, (rec, orc) in enumerate(zip(records, oracle)):
        r = rec["resident"]
        # the twins join after the cold cycle
        others = [(rec[k], f"{k} twin") for k in RESIDENT_KINDS[1:]
                  if k in rec] + [(orc, "CPU oracle")]
        for other, name in others:
            if not _same_decisions(r, other):
                raise AssertionError(f"resident_churn cycle {i}: decisions "
                                     f"differ from the {name}")
            if r["packed"].tobytes() != other["packed"].tobytes():
                raise AssertionError(f"resident_churn cycle {i}: packed "
                                     f"commit differs from the {name}")
        if r["mode"] != orc["mode"]:
            raise AssertionError(f"resident_churn cycle {i}: mode "
                                 f"{r['mode']}, the oracle {orc['mode']}")
        if r["mode"] == "resident":
            w = r["wire"]
            da = w["by_reason"].get("delta-apply", {})
            if (sorted(w["by_reason"]) != ["delta-apply"]
                    or da.get("dispatches") != 1
                    or da.get("bytes") != r["bytes_shipped"]
                    or w["redundant_bytes"] != 0):
                raise AssertionError(f"resident_churn cycle {i}: uploads "
                                     f"{w['by_reason']}")
            if r["launches"]["resident_apply"] != 1:
                raise AssertionError(f"resident_churn cycle {i}: K16 "
                                     f"launched {r['launches']}")
    timed = [rec for rec in records if rec["phase"] == "timed"]
    if len(timed) != RESIDENT_TIMED or any(
            rec["resident"]["mode"] != "resident"
            for rec in records if rec["phase"] in ("profiled", "timed")):
        raise AssertionError("resident_churn: modes "
                             f"{[rec['resident']['mode'] for rec in records]}")
    modes: dict[str, int] = {}
    for rec in records:
        modes[rec["resident"]["mode"]] = \
            modes.get(rec["resident"]["mode"], 0) + 1
    secs = {k: [rec[k]["seconds"] for rec in timed] for k in RESIDENT_KINDS}
    last = timed[-1]["resident"]
    return dict(
        cycles=len(records), modes=modes,
        fallback_reasons=[rec["resident"]["fallback_reason"]
                          for rec in records],
        cycle_seconds_all=secs,
        cycle_seconds_median={k: statistics.median(v)
                              for k, v in secs.items()},
        phase_seconds_median={
            k: {ph: statistics.median(rec[k]["phases"][ph] for rec in timed)
                for ph in timed[0][k]["phases"]} for k in RESIDENT_KINDS},
        delta_bytes_all=[rec["resident"]["bytes_shipped"] for rec in timed],
        resident_reused_bytes=last["wire"]["resident_reused_bytes"],
        resident_uploaded_bytes=last["wire"]["resident_uploaded_bytes"],
        binds_all=[len(rec["resident"]["binds"]) for rec in timed],
        evictions_all=[len(rec["resident"]["evictions"]) for rec in timed],
        launches=last["launches"], action_seconds=last["action_seconds"],
        shape=RESIDENT_CHURN)


def resident_kernel_checks(captured: list) -> dict:
    """K16 on every captured delta vs its plain version, each on its own
    copy of a resident state of the delta's layout: the states must come
    out byte-equal.  Every captured delta is first checked for the kernel's
    precondition (no element addressed twice).  Timed on the last one:
    the kernel (median of 50), the plain version, and the nearest library
    equivalent — one ``index_put_`` per leaf that has entries, with its
    local indices and values already sliced out (the port never runs
    it).  Bound: bytes — the padded idx segments read once, the values of
    the live entries (``idx >= 0``; the kernel returns on a padding entry
    before it loads the value) read once, the changed elements written
    once."""
    from kai_scheduler_tpu_torch.ops import resident as RS
    from kai_scheduler_tpu_torch.state.cluster_state import (
        state_from_leaves, state_leaves)

    def clone(st):
        return state_from_leaves({k: t.clone()
                                  for k, t in state_leaves(st).items()})
    if not captured:
        raise AssertionError("resident_churn: no delta captured")
    for base, delta in captured:
        for key, idx in delta["idx"].items():
            live = idx[idx >= 0]
            if int(torch.unique(live).numel()) != int(live.numel()):
                raise AssertionError(f"K16: group {key} addresses an "
                                     f"element twice")
        k_st, p_st = clone(base), clone(base)
        RS.apply_delta(k_st, delta)
        RS.apply_delta_plain(p_st, delta)
        torch.cuda.synchronize()
        for (name, a), b in zip(state_leaves(k_st).items(),
                                state_leaves(p_st).values()):
            # bit for bit: NaN payloads and -0.0 included
            if not torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8)):
                raise AssertionError(f"K16: leaf {name} differs from the "
                                     f"plain version")
    base, delta = captured[-1]
    st = clone(base)
    ms = _time_ms(lambda: RS.apply_delta(st, delta))
    plain_ms = _time_ms(lambda: RS.apply_delta_plain(st, delta), 5)
    # the nearest library equivalent: index_put_ per changed leaf
    pl = list(state_leaves(st).items())
    puts, written = [], 0
    for (path, leaf), (cls, off) in zip(pl, RS.leaf_layout(pl)):
        idx, val = delta["idx"][cls], delta["val"][cls]
        if idx.numel() == 0:
            continue
        local = idx - off
        ok = (local >= 0) & (local < leaf.numel())
        if bool(ok.any()):
            puts.append((leaf.view(-1), local[ok].long(), val[ok]))
            written += int(ok.sum()) * leaf.element_size()

    def library():
        for flat, li, v in puts:
            flat.index_put_((li,), v)
    lib_ms = _time_ms(library)
    read = sum(idx.numel() * idx.element_size()
               + int((idx >= 0).sum()) * delta["val"][key].element_size()
               for key, idx in delta["idx"].items())
    entries = sum(t.numel() for t in delta["idx"].values())
    b, by = bound(read + written, entries * 16)
    return {"resident_apply": dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b,
        bound_by=by, nearest_library="index_put_ per changed leaf",
        nearest_library_ms=lib_ms, checked=len(captured),
        shape=f"{entries} padded entries in "
              f"{sum(1 for t in delta['idx'].values() if t.numel())} "
              f"groups, {len(puts)} changed leaves, {written} bytes "
              f"written")}


def resident_freed_checks(calls: list) -> dict:
    """K6 on resident_churn's captured calls — reclaim's ``freeable``
    bound (the queue-only mode) and the stale pass — each vs its plain
    version on CPU copies (the ordered sums need the CPU's
    ``index_add_``), tolerance 0.  Timed on the queue-only call: the
    kernel (median of 50), the plain version on the card, and the nearest
    library call, ``index_add_`` of the masked requests into the [Q, R]
    leaf table (atomic order, no roll-up).  Bound: bytes — the mask, the
    masked pods' requests, queue and preemptible flag once, the two
    rolled-up tables written once; operations: two adds per masked pod
    and resource and the roll-up's Q x Q x R multiply-adds."""
    from kai_scheduler_tpu_torch.ops import victims as V
    errs, queue_only, full = [], None, None
    for args, kw in calls:
        state, mask, chain = args[:3]
        got = V.freed_by_mask(*args, **kw)
        errs.append(_max_abs_err(_to_cpu(got), V.freed_by_mask_plain(
            _cpu_state(state), mask.cpu(), chain.cpu(),
            queues_only=kw.get("queues_only", False))))
        if kw.get("queues_only"):
            queue_only = queue_only or (args, kw)
        else:
            full = full or (args, kw)
    if queue_only is None:
        raise AssertionError("resident_churn: no queue-only K6 call")
    KERNEL_INPUTS["freed_by_mask:queues_only"] = queue_only
    (state, mask, chain, *rest), kw = queue_only
    k_ms = _time_ms(lambda: V.freed_by_mask(*queue_only[0], **kw))
    p_ms = _time_ms(lambda: V.freed_by_mask_plain(
        state, mask, chain, queues_only=True), 5)
    r, q = state.running, state.queues
    Q, R_ = q.q, r.req.shape[1]
    seg = torch.where(mask, torch.clamp(r.queue, min=0), Q).long()
    req_m = torch.where(mask[:, None], r.req, 0.0)
    lib_ms = _time_ms(lambda: torch.zeros(
        (Q + 1, R_), device=mask.device).index_add_(0, seg, req_m))
    nm = int(mask.sum())
    b, by = bound(r.m + nm * (4 * R_ + 4 + 1) + 2 * Q * R_ * 4,
                  2 * nm * R_ + 4 * Q * Q * R_)
    rec = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b,
               bound_by=by, nearest_library_ms=lib_ms,
               nearest_library="index_add_ of the [Q, R] leaf table only "
                               "(atomic order, no roll-up)",
               checked=len(calls),
               shape=f"M={r.m} masked={nm} Q={Q} R={R_} (resident_churn, "
                     f"reclaim's freeable)")
    if full is not None:
        KERNEL_INPUTS["freed_by_mask:resident_stale"] = full
        rec["stale_call_ms"] = _time_ms(lambda: V.freed_by_mask(
            *full[0], **full[1]))
        rec["stale_call_masked"] = int(full[0][1].sum())
    return {"freed_by_mask:queues_only": rec}


def fresh_cluster(shape: dict):
    from kai_scheduler_tpu_torch.runtime.cluster import Cluster
    from kai_scheduler_tpu_torch.state import make_cluster
    return Cluster.from_objects(*make_cluster(**shape))


def run_cycle(shape: dict, device: str):
    from kai_scheduler_tpu_torch.framework.scheduler import (Scheduler,
                                                             SchedulerConfig)
    cluster = fresh_cluster(shape)
    t0 = time.perf_counter()
    res = Scheduler(SchedulerConfig(actions=("allocate",),
                                    incremental=False),
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
        **analytics_fields(res), cycle_seconds=secs, binds=len(res.bind_requests),
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
    res = Scheduler(SchedulerConfig(actions=("allocate",),
                                    incremental=False),
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
        **analytics_fields(res), cycle_seconds=secs, binds=len(res.bind_requests),
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
    KERNEL_INPUTS["pertask_fill"] = (args, kw)
    nodes, tt, cand, prior, free, dev, qa = args[:7]
    B, T = prior.shape
    N, D = dev.shape
    Q = qa.shape[0]
    steps = int((A.pertask_fill_plain(*args, **kw).nodes_t
                 >= 0).sum())
    ms = _time_ms(lambda: cap._orig["pertask_fill"](*args, **kw))
    plain_ms = _time_ms(
        lambda: A.pertask_fill_plain(*args, **kw), 5)
    b, by = k9_bound(nodes, prior, Q, D, steps, args[8:10])
    out["pertask_fill"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b,
        bound_by=by, checked=len(errs),
        shape=f"B={B} T={T} N={N} D={D} Q={Q} placed steps={steps}")

    # K10 — every (lane, slot) entry's rows once, the pools and floors of
    # every node once (the zero claim reads them all), the lane deltas of
    # the queue tables once, the outputs written once; per touching
    # (lane, node) ~2 (6 + 2 D) operations for the cumulative tests and
    # the commit
    errs = []
    for args, kw in cap.calls["dense_accept"]:
        k_out = cap._orig["dense_accept"](*args, **kw)
        p_out = A.dense_accept_plain(*args, **kw)
        errs.append(_max_abs_err(k_out, p_out))
    args, kw = cap.calls["dense_accept"][0]
    KERNEL_INPUTS["dense_accept"] = (args, kw)
    nodes_b, ok = args[0], args[1]
    B, T = nodes_b.shape
    N, D = args[8].shape
    Q = args[13].shape[0]
    ent = ok[:, None] & (nodes_b >= 0)
    E = int(ent.sum())
    U = int(torch.unique(nodes_b[ent]).numel())
    ms = _time_ms(lambda: cap._orig["dense_accept"](*args, **kw))
    plain_ms = _time_ms(lambda: A.dense_accept_plain(*args, **kw), 5)
    nb = (B * T * (4 + 2 * 12 + 2 * 4 * D) + N * (2 * 12 + 2 * 4 * D)
          + N * (12 + 4 * D) + B * (3 + 2 * Q * 12) + 4 * Q * 12)
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
    res = Scheduler(SchedulerConfig(actions=("allocate",),
                                    incremental=False),
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
        **analytics_fields(res), cycle_seconds=secs, binds=len(res.bind_requests),
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
        checked=n, shape=f"B={B} T={T} N={N} ND={ND} Q={Q}",
        **k3_nearest(args, kw))
    KERNEL_INPUTS["uniform_fill:topology"] = (args, kw)

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
        checked=1, shape=f"B={B} N={N}, {B // 2 + B % 2} lanes preferring",
        **k3_nearest(args, pkw))
    KERNEL_INPUTS["uniform_fill:preferred"] = (args, pkw)

    # K10 without the device table (the uniform lanes' rows here; the
    # per-task path without GPU sharing runs the same mode) — the
    # entries' rows, the pools at their nodes and the queue deltas once
    calls = tcap.calls["dense_accept"]
    err, n = held("dense_accept", A.dense_accept_plain, calls)
    args, kw = calls[-1]
    KERNEL_INPUTS["dense_accept:no_devices"] = (args, kw)
    nodes_b, ok = args[0], args[1]
    B, T = nodes_b.shape
    N = args[7].shape[0]
    Q = args[13].shape[0]
    ent = ok[:, None] & (nodes_b >= 0)
    E = int(ent.sum())
    U = int(torch.unique(nodes_b[ent]).numel())
    k_fn = tcap._orig["dense_accept"]
    ms = _time_ms(lambda: k_fn(*args, **kw))
    plain_ms = _time_ms(lambda: A.dense_accept_plain(*args, **kw), 5)
    nb = (B * T * (4 + 2 * 12) + N * 24 + N * 12 + B * (3 + 2 * Q * 12)
          + 4 * Q * 12)
    b, by = bound(nb, E * 2 * 6)
    out["dense_accept:no_devices"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        checked=n, shape=f"B={B} T={T} Q={Q} entries={E} nodes={U}")

    # K9 subgroup-topology mode — sharing_kernel_checks' K9 bytes plus the
    # chunk-start [ND, R] aggregate once and each placed step's debit at
    # every level; per placed task step ~70 operations a node (the domain
    # gate and band)
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
    KERNEL_INPUTS["pertask_fill:topology"] = (args, kw)
    nodes, tt, cand, prior, free, dev, qa = args[:7]
    B, T = prior.shape
    N = free.shape[0]
    L = nodes.topology.shape[1]
    Q = qa.shape[0]
    first = k_fn(*args, **kw)
    steps = int((first.nodes_t >= 0).sum())
    ms = _time_ms(lambda: k_fn(*args, **kw))
    plain_ms = _time_ms(lambda: A.pertask_fill_plain(*args, **kw), 5)
    b, by = k9_bound(nodes, prior, Q, 0, steps, args[8:9],
                     (N * L + 1) * 12 + steps * L * 12, 70)
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
    KERNEL_INPUTS["pertask_fill:banned"] = (args, bkw)
    rkw = dict(bkw, active=~first.success, base=first)
    errs = [_max_abs_err(fields(k_fn(*args, **bkw)),
                         fields(A.pertask_fill_plain(*args, **bkw)))]
    for agg in (A.pertask_agg_scratch(kw["topo"], free), None):
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
    b, by = k9_bound(nodes, prior, Q, 0, steps_b, args[8:9],
                     (N * L + 1) * 12 + steps_b * L * 12 + _nbytes(banned),
                     70)
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
        return SchedulerConfig(incremental=False)
    if cell == "affinity_reclaim_sequential":
        return SchedulerConfig(incremental=False, session=SessionConfig(
            victims=VictimConfig(batch_size=1,
                                 queue_depth=SEQUENTIAL_QUEUE_DEPTH)))
    return SchedulerConfig(actions=("allocate",), incremental=False)


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
        **analytics_fields(res), cycle_seconds=secs, binds=len(res.bind_requests),
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
    KERNEL_INPUTS["affinity_mask"] = (args, kw)
    ms = _time_ms(lambda: fn(*args, **kw))
    one = [r for r in recs if r[2][3].numel() == 1]
    if one:
        KERNEL_INPUTS["affinity_mask:one_lane"] = one[0][2:]
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
        checked=len(recs), shape=f"B={B} T={T} N={N} Q={Q} ({c})",
        **k3_nearest(args, kw))
    KERNEL_INPUTS["uniform_fill:mask"] = (args, kw)

    # K9 mask mode — sharing_kernel_checks' K9 bytes plus the [B, N] mask
    recs = [r for r in calls("pertask_fill") if r[3].get("mask") is not None]
    err = held(recs, A.pertask_fill_plain, lambda o: o.fields())
    c, k, args, kw = recs[0]
    KERNEL_INPUTS["pertask_fill:mask"] = (args, kw)
    nodes, tt, cand, prior, free, dev, qa = args[:7]
    B, T = prior.shape
    N, D = dev.shape
    Q = qa.shape[0]
    fn = caps[c]._orig[k]
    steps = int((fn(*args, **kw).nodes_t >= 0).sum())
    ms = _time_ms(lambda: fn(*args, **kw))
    plain_ms = _time_ms(lambda: A.pertask_fill_plain(*args, **kw), 5)
    b, by = k9_bound(nodes, prior, Q, D, steps, args[8:10], B * N)
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
        return SchedulerConfig(actions=actions, incremental=False)
    return SchedulerConfig(actions=actions, incremental=False,
                           session=SessionConfig(victims=VictimConfig(
                               batch_size=width,
                               queue_depth=SEQUENTIAL_QUEUE_DEPTH)))


def victim_cluster(cell: str):
    from kai_scheduler_tpu_torch.apis import types as apis
    from kai_scheduler_tpu_torch.runtime.cluster import Cluster
    from kai_scheduler_tpu_torch.state import make_cluster
    from kai_scheduler_tpu_torch.state.fleets import fragmented_objects
    kind = VICTIM_CELLS[cell][0]
    if kind == "mig_reclaim":
        from kai_scheduler_tpu_torch.state.fleets import mig_reclaim_objects
        nodes, queues, groups, pods, now = mig_reclaim_objects(
            apis, **MIG_RECLAIM)
        cluster = Cluster.from_objects(nodes, queues, groups, pods)
        cluster.now = now
        return cluster
    if kind == "sharing_reclaim":
        from kai_scheduler_tpu_torch.state.fleets import \
            sharing_reclaim_objects
        return Cluster.from_objects(*sharing_reclaim_objects(
            apis, **SHARING_RECLAIM))
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
    if cell == "mig_reclaim":
        # every action did work: allocate bound slices, consolidation moved
        # MIG victims, reclaim and preempt pipelined, the stale pass evicted
        steps = {k: v.steps for k, v in res.victim_stats.items()}
        stale_ev = [e for e in res.evictions
                    if cluster.pod_groups[e.group].stale_since is not None]
        mig_binds = [b for b in res.bind_requests
                     if cluster.pods[b.pod_name].extended]
        if not moved or pipelined <= 0 or not stale_ev or not mig_binds \
                or min(steps.get(a, 0) for a in (
                    "consolidation", "reclaim", "preempt")) <= 0:
            raise AssertionError(
                f"{cell}: {len(moved)} moves, {pipelined} pipelined tasks, "
                f"{len(stale_ev)} stale evictions, {len(mig_binds)} MIG "
                f"binds, steps {steps}")
        for e in moved:
            br = cluster.bind_requests.get(e.pod_name)
            if br is None or br.selected_node != e.move_to:
                raise AssertionError(f"{cell}: moved victim {e.pod_name} "
                                     f"not rebound on {e.move_to}")
    elif cell == "sharing_reclaim":
        # every action did work: consolidation moved victims, reclaim and
        # preempt placed fractions on devices
        steps = {k: v.steps for k, v in res.victim_stats.items()}
        frac_dev = int((t.placement_device >= 0).sum())
        if not moved or pipelined <= 0 or frac_dev <= 0 or min(
                steps.get(a, 0) for a in ("consolidation", "reclaim",
                                          "preempt")) <= 0:
            raise AssertionError(f"{cell}: {len(moved)} moves, {pipelined} "
                                 f"pipelined tasks, {frac_dev} on a device, "
                                 f"steps {steps}")
        for e in moved:
            br = cluster.bind_requests.get(e.pod_name)
            if br is None or br.selected_node != e.move_to:
                raise AssertionError(f"{cell}: moved victim {e.pod_name} "
                                     f"not rebound on {e.move_to}")
    elif cell != "fragmented":
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
        **analytics_fields(res), cycle_seconds=secs, evictions=len(res.evictions),
        consolidation_moves=len(moved), stale_evictions=len(stale_ev),
        pipelined_tasks=pipelined, binds=len(res.bind_requests),
        tasks_on_a_device=int((t.placement_device >= 0).sum()),
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
    # (a combine per up-sweep pair, one per even prefix, the final add);
    # held on every captured call of the cells that launch it, timed on
    # the largest (and each cell's largest saved for compare_kernels.py)
    errs, big, shapes, per_cell = [], None, {}, {}
    for cell in K5_CELLS:
        for args, kw in caps[cell].calls.get("cumsum_ds", []):
            x = args[0]
            got = caps[cell]._orig["cumsum_ds"](x, **kw)
            errs.append(_max_abs_err(got.cpu(), NU.cumsum_ds(x.cpu(), **kw)))
            U = x.shape[kw.get("axis", 0)]
            shapes.setdefault(cell, []).append(f"U={U} C={x.numel() // U}")
            if cell not in per_cell or x.numel() > per_cell[cell][0].numel():
                per_cell[cell] = (x, kw)
            if big is None or x.numel() > big[0].numel():
                big = (x, kw)
    for cell, (x, kw) in per_cell.items():
        KERNEL_INPUTS[f"cumsum_ds:{cell}"] = ((x,), kw)
    x, kw = big
    k_ms = _time_ms(lambda: NU.cumsum_ds(x, **kw))
    p_ms = _time_ms(lambda: NU.cumsum_ds_plain(x.movedim(kw.get("axis", 0),
                                                         0)), 5)
    lib_ms = _time_ms(lambda: torch.cumsum(x, kw.get("axis", 0)))
    b, by = bound(2 * x.numel() * 4, 20 * x.numel())
    U = x.shape[kw.get("axis", 0)]
    out["cumsum_ds"] = dict(
        max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b,
        bound_by=by, nearest_library_ms=lib_ms,
        nearest_library="torch.cumsum (plain f32, not compensated)",
        shape=f"U={U} C={x.numel() // U}", checked=len(errs), shapes=shapes)

    # K6 — the mask, the masked pods' rows and the five outputs once each;
    # a few adds per masked pod plus the chain roll-up
    errs, rec = [], None
    for cell in ("saturated_sequential", "fragmented"):
        for args, kw in caps[cell].calls.get("freed_by_mask", []):
            state, mask, chain = args[:3]
            only = kw.get("queues_only", False)
            got = caps[cell]._orig["freed_by_mask"](*args, **kw)
            cst = _cpu_state(state)
            errs.append(_max_abs_err(_to_cpu(got), V.freed_by_mask_plain(
                cst, mask.cpu(), chain.cpu(), queues_only=only)))
            if not only and (rec is None
                             or int(mask.sum()) > int(rec[0][1].sum())):
                rec = (args, kw, cell)
    (state, mask, chain, *rest), kw, cell = rec
    KERNEL_INPUTS["freed_by_mask"] = next(
        (a, k) for a, k in caps["saturated_sequential"].calls["freed_by_mask"]
        if not k.get("queues_only"))
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
    # victim and node ~(3R + 3D + 2E + 12) operations for the fit test;
    # held on the fragmented and sharing_reclaim calls, timed on each
    # cell's call with the most victims (saved for compare_kernels.py)
    errs, recs = [], {}
    for cell in ("fragmented", "sharing_reclaim"):
        for args, kw in caps[cell].calls.get("replace_victims", []):
            got = caps[cell]._orig["replace_victims"](*args, **kw)
            cst = _cpu_state(args[0])
            errs.append(_max_abs_err(_to_cpu(got), V.replace_victims_plain(
                cst, *_to_cpu(args[1:]), **kw)))
            if (cell not in recs
                    or int(args[1].sum()) > int(recs[cell][0][1].sum())):
                recs[cell] = (args, kw)

    def k7_row(cell, args, kw):
        KERNEL_INPUTS[f"replace_victims:{cell}"] = (args, kw)
        state, mask = args[0], args[1]
        k_ms = _time_ms(lambda: V.replace_victims(*args, **kw))
        p_ms = _time_ms(lambda: V.replace_victims_plain(*args, **kw), 5)
        r, n = state.running, state.nodes
        N, D, E, R_ = n.n, n.d, r.extended.shape[1], r.req.shape[1]
        nv = min(int(mask.sum()), max(1, min(r.m, args[-1])))
        pools = N * (2 * R_ + 2 * D + 2 * E + 1) * 4 + N * 2
        nbytes = (pools + r.m + nv * (28 + 4 * E) + N * (R_ + D + E) * 4
                  + r.m * 4)
        b, by = bound(nbytes, nv * N * (3 * R_ + 3 * D + 2 * E + 12))
        return dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms,
                    bound_ms=b, bound_by=by, nearest_library_ms=None,
                    nearest_library=None,
                    shape=f"victims={nv} N={N} D={D} ({cell})",
                    checked=len(errs))
    rows = {cell: k7_row(cell, *rec) for cell, rec in recs.items()}
    out["replace_victims"] = dict(rows["fragmented"],
                                  sharing_reclaim=rows["sharing_reclaim"])
    return out


def victim_edge_checks() -> dict:
    """K8 (every mode, composed and not, at 1, 17, 256 and 300 lanes, and
    at 4,096 lanes with the device and extended tables both on: one node a
    block, its columns in slabs) and K7 (ties, a victim that fits nowhere,
    more victims than ``max_pods``, fractional, memory-based and
    whole-device victims, extended keys, a mix), K5 (around its 256-row
    tile and its chunk of roots, 216,001 rows, column counts off its
    8-column group, a [U, Q, R] table) and K12 (37, 48 and 100 nodes,
    both node vectors, gangs with no and with every slot used, junk lanes,
    attract on and off) on ``state.kernel_edges``' inputs — those the CPU
    parity tests hold the plain versions to the reference on — vs their
    plain versions on CPU copies, tolerance 0.  Returns the calls held per
    kernel."""
    from kai_scheduler_tpu_torch.ops import allocate as A
    from kai_scheduler_tpu_torch.ops import victims as V
    from kai_scheduler_tpu_torch.state import kernel_edges as KE
    from kai_scheduler_tpu_torch.state import state_from_numpy
    from kai_scheduler_tpu_torch.utils import numerics as NU
    held = {"freed_by_lane": 0, "replace_victims": 0, "cumsum_ds": 0,
            "affinity_mask": 0}
    for B in KE.K8_LANES + (4096,):
        lv, lane = KE.k8_case(B)
        st, cst = state_from_numpy(lv, "cuda"), state_from_numpy(lv, "cpu")
        chain = A._chain_membership(cst.queues.parent, KE.NUM_LEVELS)
        lane = torch.from_numpy(lane)
        runs = ([(True, "slab")] if B == 4096 else
                [(c, m) for c in (True, False) for m in KE.K8_MODES])
        for compose, mode in runs:
            kw = dict(compose=compose, devices=mode in ("devices", "slab"),
                      extended=mode in ("extended", "slab"))
            got = V.freed_by_lane(st, lane.cuda(), B, chain.cuda(), **kw)
            _max_abs_err(_to_cpu(got), V.freed_by_lane_plain(
                cst, lane, B, chain, **kw))
            held["freed_by_lane"] += 1
    for case in KE.K7_CASES:
        lv, mask, *pools, max_pods = KE.k7_case(case)
        st, cst = state_from_numpy(lv, "cuda"), state_from_numpy(lv, "cpu")
        args = (torch.from_numpy(mask), *map(torch.from_numpy, pools))
        got = V.replace_victims(st, *(a.cuda() for a in args), max_pods)
        _max_abs_err(_to_cpu(got), V.replace_victims_plain(cst, *args,
                                                           max_pods))
        held["replace_victims"] += 1
    for case in KE.K5_CASES:
        x = torch.from_numpy(KE.k5_case(case))
        got = NU.cumsum_ds(x.cuda()).cpu()
        if not torch.equal(got.view(torch.int32),
                           NU.cumsum_ds_plain(x).view(torch.int32)):
            raise AssertionError(f"cumsum_ds differs from its plain version "
                                 f"on edge case {case}")
        held["cumsum_ds"] += 1
    for case in KE.K12_CASES:
        st, used, dom, cand, attract = KE.k12_inputs(case, "cuda")
        got = A.affinity_mask(st, used, dom, cand, attract=attract)
        cst, *rest = KE.k12_inputs(case)
        _max_abs_err(got.cpu(), A.affinity_mask_plain(cst, *rest[:3],
                                                      attract=attract))
        held["affinity_mask"] += 1
    return held



def lane_kernel_checks(caps: dict) -> dict:
    """K8 (its device mode on sharing_reclaim's inputs) and the victim
    wavefront's modes of K2-K4 on the inputs captured from the chunked
    cells vs their plain versions (K8's on CPU copies — its plain segment
    sums need the CPU's ordered ``index_add_``; K2-K4's on the card, as in
    :func:`kernel_checks`), kernel and plain times on the card, and the
    bound.  K8's nearest library call (NOT the same function): one
    ``index_add_`` of its lane-node (or lane-device) table alone, atomic
    order."""
    from kai_scheduler_tpu_torch.ops import allocate as A
    from kai_scheduler_tpu_torch.ops import victims as V
    cells = ("saturated", "preempt_many_queues")

    def calls(key):
        return [(cell, args, kw) for cell in cells
                for args, kw in caps[cell].calls.get(key, [])]

    def largest(recs, size):
        return max(recs, key=lambda rec: size(rec[1]))

    def k8_row(recs, devices):
        """K8 on captured (cell, args, kw) calls; with ``devices``, its
        [B, N, D] table too.  The live pods' rows and the CSR lists once,
        the outputs written once; 6 adds per live pod, 3 per (lane, node)
        and (lane, queue) of the lane prefix, 2 per (lane, node) of
        own_incr, 1 per chain entry of the roll-up.  The device table adds
        the live pods' (device, share, mask) read once, the [B, N, D] table
        written once, 1 add per live fractional pod, D compares per live
        whole pod and D per (lane, node) of the lane prefix."""
        recs = [(c, a, {k: v for k, v in kw.items()
                        if k in ("compose", "devices")})
                for c, a, kw in recs]
        errs = []
        for cell, (state, lane, B, chain), kw in recs:
            got = caps[cell]._orig["freed_by_lane"](state, lane, B, chain,
                                                    **kw)
            want = V.freed_by_lane_plain(_cpu_state(state), lane.cpu(), B,
                                         chain.cpu(), **kw)
            errs.append(_max_abs_err(_to_cpu(got), want))
        cell, (state, lane, B, chain), kw = max(
            recs, key=lambda rc: (rc[1][2] * rc[1][0].nodes.n,
                                  int((rc[1][1] < rc[1][2]).sum())))
        KERNEL_INPUTS["freed_by_lane:devices" if devices
                      else "freed_by_lane"] = ((state, lane, B, chain), kw)
        pods = V.PodIndex.of(state)
        k_ms = _time_ms(lambda: V.freed_by_lane(state, lane, B, chain,
                                                pods=pods, **kw))
        p_ms = _time_ms(lambda: V.freed_by_lane_plain(state, lane, B, chain,
                                                      **kw), 5)
        r, n, q = state.running, state.nodes, state.queues
        M, N, Q, D = r.m, n.n, q.q, (n.d if devices else 0)
        live = lane < B
        n_live = int(live.sum())
        n_frac = int((live & (r.device >= 0)).sum()) if devices else 0
        if devices:
            seg = (torch.where(live, lane, B).long() * (N * D + 1)
                   + torch.where(live & (r.device >= 0),
                                 torch.clamp(r.node, min=0).long() * D
                                 + torch.clamp(r.device, min=0).long(),
                                 N * D))

            def library():
                torch.zeros(((B + 1) * (N * D + 1),),
                            device=lane.device).index_add_(0, seg,
                                                           r.accel_held)
            lib = ("index_add_ of the fractional shares into the "
                   "[B (N D + 1)] lane-device table only (atomic order)")
        else:
            seg = (torch.where(live, lane, B).long() * (N + 1)
                   + torch.where(live, torch.clamp(r.node, min=0),
                                 N).long())
            req_m = torch.where(live[:, None], r.req, 0.0)

            def library():
                torch.zeros(((B + 1) * (N + 1), 3),
                            device=lane.device).index_add_(0, seg, req_m)
            lib = ("index_add_ of the [B (N + 1), R] lane-node table only "
                   "(atomic order)")
        lib_ms = _time_ms(library)
        nnz = int(chain.sum())
        nbytes = (M * 4 + n_live * (12 + (12 if devices else 0))
                  + (N + 1 + M + Q + 1 + M) * 4 + Q * Q
                  + B * N * (12 + 4 * D) + B * Q * 12 + B * N)
        ops = (6 * n_live + n_frac + (n_live - n_frac) * D
               + (B * (N * (3 + D) + 3 * Q) if kw["compose"] else 0)
               + 2 * B * N + 3 * B * nnz)
        b, by = bound(nbytes, ops)
        frac = f"D={D} fractional={n_frac} " if devices else ""
        return dict(
            max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b,
            bound_by=by, nearest_library_ms=lib_ms, nearest_library=lib,
            shape=f"B={B} N={N} {frac}Q={Q} M={M} live={n_live} "
                  f"compose={kw['compose']} ({cell})", checked=len(recs))

    out = {"freed_by_lane": k8_row(calls("freed_by_lane"), False),
           "freed_by_lane:devices": k8_row(
               [("sharing_reclaim", a, kw) for a, kw in
                caps["sharing_reclaim"].calls["freed_by_lane"]], True)}

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
        checked=len(recs), **k3_nearest(args, kw))
    KERNEL_INPUTS["uniform_fill:lanes"] = (args, kw)

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


def log_victim_cell(cell, rec, res, secs, counts, cpu_s, in_cycle):
    """The victim cell's log lines: what the cycle did, per action."""
    log(f"{cell}: {secs:.3f} s cycle, {rec['evictions']} evictions "
        f"({rec['consolidation_moves']} consolidation moves, "
        f"{rec['stale_evictions']} stale), {rec['pipelined_tasks']} "
        f"pipelined tasks ({rec['tasks_on_a_device']} on a shared device), "
        f"{rec['binds']} binds, {rec['move_rebinds']} move rebinds, "
        f"{rec['gangs_allocated']} gangs allocated; launches {counts}; "
        f"commit, binds and evictions == CPU oracle ({cpu_s:.1f} s)")
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
    log_analytics(rec)
    log("  in-cycle kernel device ms / launches (profiled run): "
        + ", ".join(f"{k} {v['ms']:.3f} / {v['launches']}"
                    for k, v in in_cycle.items() if v["launches"]))


def pertask_lane_kernel_checks(cap: Capture) -> dict:
    """K9's lanes mode (each lane's own pools, queue table and score bias)
    and its legacy mode (the solver's one-lane attempt) on the inputs
    captured from the sharing_reclaim cell vs their plain versions, both
    on the card (tolerance 0); kernel and plain times and the bound (as
    :func:`sharing_kernel_checks`' K9, the pools each lane reads once, and
    the lanes' [B, Q, R] queue tables and [B, N] bias once).  The lanes
    mode's per-lane node summary is the design's scratch, not the
    function's, and is not counted."""
    from kai_scheduler_tpu_torch.ops import allocate as A
    out = {}
    for mode, key in (("pertask_fill:lanes", "pertask_fill:lanes"),
                      ("pertask_fill:legacy", "pertask_fill")):
        recs = [rc for rc in cap.calls.get(key, []) if rc[1].get("legacy")]
        errs = [_max_abs_err(cap._orig[key](*a, **k).fields(),
                             A.pertask_fill_plain(*a, **k).fields())
                for a, k in recs]
        args, kw = max(recs, key=lambda rc: rc[0][3].shape[0])
        KERNEL_INPUTS[mode] = (args, kw)
        nodes, tt, cand, prior, free, dev, qa, qan, extra, extra_dev = \
            args[:10]
        B, T = prior.shape
        N, D = dev.shape
        Q = qa.shape[-2]
        steps = int((A.pertask_fill_plain(*args, **kw).nodes_t >= 0).sum())
        ms = _time_ms(lambda: cap._orig[key](*args, **kw))
        plain_ms = _time_ms(lambda: A.pertask_fill_plain(*args, **kw), 5)
        b, by = k9_bound(nodes, prior, Q, D, steps, (extra, extra_dev),
                         _nbytes(qa, kw.get("score_bias")))
        out[mode] = dict(
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b,
            bound_by=by, checked=len(errs), nearest_library_ms=None,
            nearest_library=None,
            shape=f"B={B} T={T} N={N} D={D} Q={Q} placed steps={steps}")
    return out


def mig_kernel_checks(cap: Capture) -> dict:
    """The extended modes on the inputs captured from the mig_reclaim
    cell vs their plain versions (tolerance 0): K9's (allocate's per-task
    lanes, the victim wavefront's lanes with per-lane extended credit, the
    solver's legacy attempt), K10's and K8's (its extended table; on CPU
    copies, as K8's other modes); kernel and plain times on the card and
    the bound — each mode's function bytes plus the [N, E], [B, N, E] and
    [B, T, E] tensors it reads or writes, once.  K6's and K7's calls of
    this cell (the victims' [N, E] extended rows; the MIG victims'
    re-placement against the extended pools) are held too."""
    from kai_scheduler_tpu_torch.ops import allocate as A
    from kai_scheduler_tpu_torch.ops import victims as V
    out = {}

    def k9(key, recs, name):
        errs = [_max_abs_err(cap._orig[key](*a, **k).fields(),
                             A.pertask_fill_plain(*a, **k).fields())
                for a, k in recs]
        args, kw = max(recs, key=lambda rc: rc[0][3].shape[0])
        KERNEL_INPUTS[name] = (args, kw)
        nodes, tt, cand, prior, free, dev, qa, qan, extra, extra_dev = \
            args[:10]
        B, T = prior.shape
        N, D = dev.shape
        Q = qa.shape[-2]
        E = kw["ext"].shape[1]
        steps = int((A.pertask_fill_plain(*args, **kw).nodes_t >= 0).sum())
        ms = _time_ms(lambda: cap._orig[key](*args, **kw))
        plain_ms = _time_ms(lambda: A.pertask_fill_plain(*args, **kw), 5)
        b, by = k9_bound(nodes, prior, Q, D, steps,
                         (extra, extra_dev, kw["ext"], kw["ext_extra"],
                          nodes.extended_releasing),
                         _nbytes(qa, kw.get("score_bias"))
                         + 3 * B * T * E * 4 + E * 4)
        return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                    bound_ms=b, bound_by=by, checked=len(errs),
                    nearest_library_ms=None, nearest_library=None,
                    shape=f"B={B} T={T} N={N} D={D} E={E} Q={Q} placed "
                          f"steps={steps}")
    ext_calls = [rc for rc in cap.calls.get("pertask_fill", [])
                 if rc[1].get("ext") is not None]
    row = k9("pertask_fill", [rc for rc in ext_calls
                              if not rc[1].get("legacy")],
             "pertask_fill:extended")
    row["victim_lanes"] = k9("pertask_fill:lanes",
                             cap.calls["pertask_fill:lanes"],
                             "pertask_fill:lanes_extended")
    row["legacy"] = k9("pertask_fill", [rc for rc in ext_calls
                                        if rc[1].get("legacy")],
                       "pertask_fill:legacy_extended")
    out["pertask_fill:extended"] = row

    # K10 with the extended columns: the live entries' rows (R + D + E
    # each, with their bind-now rows), the pools at their nodes and the
    # zero claim's whole pools and floors, the queue deltas, once each
    recs = [rc for rc in cap.calls["dense_accept"]
            if rc[1].get("ext") is not None]
    errs = [_max_abs_err(cap._orig["dense_accept"](*a, **k),
                         A.dense_accept_plain(*a, **k)) for a, k in recs]
    args, kw = max(recs, key=lambda rc: int(rc[0][1].sum()))
    KERNEL_INPUTS["dense_accept:extended"] = (args, kw)
    ms = _time_ms(lambda: cap._orig["dense_accept"](*args, **kw))
    plain_ms = _time_ms(lambda: A.dense_accept_plain(*args, **kw), 5)
    nodes_b, ok = args[0], args[1]
    B, T = nodes_b.shape
    free, dev = args[7], args[8]
    E = kw["ext"].shape[1]
    D = dev.shape[1] if kw["track_devices"] else 0
    live = int(((nodes_b >= 0) & ok[:, None]).sum())
    C = 3 + D + E
    nb = (_nbytes(nodes_b, ok, args[2], args[11], args[12], args[13],
                  args[14]) + live * 2 * C * 4 + 2 * free.numel() * 4
          + 2 * (dev.numel() if D else 0) * 4 + 3 * kw["ext"].numel() * 4)
    b, by = bound(nb, live * C * 6 + free.numel() * 3)
    out["dense_accept:extended"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b,
        bound_by=by, checked=len(errs), nearest_library_ms=None,
        nearest_library=None, shape=f"B={B} T={T} E={E} live={live}")

    # K8's extended table (on CPU copies): as lane_kernel_checks' K8 with
    # the device table, plus each live pod's [E] row read once, the
    # [B, N, E] table written once (and composed in place)
    recs = [(a, {k: v for k, v in kw.items()
                 if k in ("compose", "devices", "extended")})
            for a, kw in cap.calls["freed_by_lane"]]
    errs = []
    for (state, lane, B, chain), kw in recs:
        got = cap._orig["freed_by_lane"](state, lane, B, chain, **kw)
        want = V.freed_by_lane_plain(_cpu_state(state), lane.cpu(), B,
                                     chain.cpu(), **kw)
        errs.append(_max_abs_err(_to_cpu(got), want))
    (state, lane, B, chain), kw = max(
        recs, key=lambda rc: int((rc[0][1] < rc[0][2]).sum()))
    KERNEL_INPUTS["freed_by_lane:extended"] = ((state, lane, B, chain), kw)
    pods = V.PodIndex.of(state)
    ms = _time_ms(lambda: V.freed_by_lane(state, lane, B, chain, pods=pods,
                                          **kw))
    plain_ms = _time_ms(lambda: V.freed_by_lane_plain(state, lane, B, chain,
                                                      **kw), 5)
    r, n, q = state.running, state.nodes, state.queues
    M, N, Q = r.m, n.n, q.q
    D = n.d if kw.get("devices") else 0
    E = r.extended.shape[1]
    live = lane < B
    n_live = int(live.sum())
    seg = (torch.where(live, lane, B).long() * (N + 1)
           + torch.where(live, torch.clamp(r.node, min=0), N).long())
    ext_m = torch.where(live[:, None], r.extended, 0.0)

    def library():
        torch.zeros(((B + 1) * (N + 1), E),
                    device=lane.device).index_add_(0, seg, ext_m)
    lib_ms = _time_ms(library)
    nbytes = (M * 4 + n_live * (12 + 4 * E + (12 if D else 0))
              + (N + 1 + M + Q + 1 + M) * 4 + Q * Q
              + B * N * (12 + 4 * D + 4 * E) + B * Q * 12 + B * N)
    ops = (6 * n_live + E * n_live
           + (B * (N * (3 + D + E) + 3 * Q) if kw["compose"] else 0)
           + 2 * B * N + 3 * B * int(chain.sum()))
    b, by = bound(nbytes, ops)
    out["freed_by_lane:extended"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b,
        bound_by=by, checked=len(errs), nearest_library_ms=lib_ms,
        nearest_library="index_add_ of the live pods' extended rows into "
                        "the [B (N + 1), E] lane-node table only (atomic "
                        "order)",
        shape=f"B={B} N={N} E={E} D={D} Q={Q} M={M} live={n_live} "
              f"compose={kw['compose']}")

    # K6 and K7 on this cell's calls (the victims' extended rows)
    k67 = {}
    for key in ("freed_by_mask", "replace_victims"):
        errs = []
        for args, kw in cap.calls.get(key, []):
            got = cap._orig[key](*args, **kw)
            cst = _cpu_state(args[0])
            want = (V.freed_by_mask_plain(
                cst, args[1].cpu(), args[2].cpu(),
                queues_only=kw.get("queues_only", False))
                if key == "freed_by_mask" else
                V.replace_victims_plain(cst, *_to_cpu(args[1:]), **kw))
            errs.append(_max_abs_err(_to_cpu(got), want))
        k67[key] = dict(checked=len(errs), max_abs_err=max(errs),
                        extended_rows=int(sum(
                            bool((a[0].running.extended[a[1]] > 0).any())
                            for a, _ in cap.calls.get(key, []))))
    out["freed_by_lane:extended"]["k6_k7"] = k67
    return out


def _oracle_process_init() -> None:
    # half the cores: the card's host-bound cycles run beside it
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))


def _resident_oracle_init() -> None:
    # a quarter of the cores: its result is needed last
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))


def main() -> int:
    global _LOG_FILE
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import concurrent.futures
    import multiprocessing
    os.makedirs(OUT_DIR, exist_ok=True)
    _LOG_FILE = open(os.path.join(OUT_DIR, "chip_smoke.log"), "w")
    # two child processes (spawned: they never touch CUDA) compute the
    # slowest CPU oracles beside the card's work: one the affinity and
    # sharing cells', in the order the card needs them, then four victim
    # cells'; the other resident_churn's, whose cold cycle alone (25,000
    # pods placed in ~2,400 allocate chunks) takes some 400-550 s on the
    # CPU, then the two per-task victim cells'; both are stopped on any
    # exit
    spawn = multiprocessing.get_context("spawn")
    pools = [concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=spawn, initializer=init)
        for init in (_oracle_process_init, _resident_oracle_init)]
    try:
        # the card's own thread sets the script's time (962 s on an
        # NVIDIA H100 machine with a slow host, with the four uniform
        # victim cells' oracles in it, ~60 s together): they follow the
        # sharing oracle in the first process and their cells compare
        # with them at the end.  (The first process's affinity oracle,
        # ~350 s, is then ready about when the card reaches the affinity
        # cells, so moving topology_subgroups' oracle out of the card's
        # thread too would only wait for it.)
        oracles = {"resident_churn": pools[1].submit(run_resident_oracle)}
        oracles.update({cell: pools[0].submit(run_affinity_cycle, cell, "cpu")
                        for cell in AFFINITY_CELLS})
        oracles["sharing"] = pools[0].submit(run_sharing_cycle, "cpu")
        for cell in ("saturated", "saturated_sequential",
                     "preempt_many_queues", "fragmented"):
            oracles[cell] = pools[0].submit(run_victim_cycle, cell, "cpu")
        # the two per-task victim cells' oracles (~70 s each) follow
        # resident_churn's in the second process
        for cell in ("sharing_reclaim", "mig_reclaim"):
            oracles[cell] = pools[1].submit(run_victim_cycle, cell, "cpu")
        return run(oracles)
    finally:
        for pool in pools:
            pool.shutdown(wait=False, cancel_futures=True)
            for proc in list((getattr(pool, "_processes", None)
                              or {}).values()):
                proc.terminate()
        _LOG_FILE.close()


def run(oracles: dict) -> int:
    """The phases above; ``oracles`` holds the oracle processes' futures
    of the CPU oracle runs that do not run on the card's thread (each
    ``(result, cluster, seconds)``; resident_churn's ``(records,
    seconds)``)."""
    from kai_scheduler_tpu_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {}

    def oracle_busy() -> bool:
        return not all(f.done() for f in oracles.values())

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
    #: the captures holding K14's inputs (headline, sharing, affinity,
    #: repack_racks), checked together at the end
    an_caps = {"headline": cap}
    report["launch_floor_ms"] = launch_floor_ms()

    # -- 3./4. timed cycles vs the CPU oracle --------------------------------
    # every run: counts reset just before, read just after, all > 0; every
    # run's commit equals the oracle's (the cycle is deterministic)
    launches, oracle_of = {}, {}
    for name, shape, reps in (("headline", HEADLINE, HEADLINE_RUNS),
                              ("contended", CONTENDED, CONTENDED_RUNS)):
        runs = []
        busy = oracle_busy()
        for _ in range(reps):
            kernels.reset_launch_counts()
            res, cluster, secs = run_cycle(shape, "cuda")
            counts = kernels.launch_counts()
            missing = [k for k in ALLOCATE_KERNELS if counts[k] <= 0]
            if missing:
                raise AssertionError(
                    f"{name}: kernels never launched: {missing}")
            runs.append((res, cluster, secs, counts))
        busy = busy and oracle_busy()
        cpu, _, cpu_s = run_cycle(shape, "cpu")
        oracle_of[name] = cpu
        recs = [check_cycle(name, shape, (res, secs), cpu, cluster)
                for res, cluster, secs, _ in runs]
        secs_all = sorted(r["cycle_seconds"] for r in recs)
        rec = dict(recs[-1])
        rec.update(runs=len(recs), cycle_seconds_all=secs_all,
                   cycle_seconds_median=statistics.median(secs_all),
                   pods_bound_per_s_median=rec["binds"]
                   / statistics.median(secs_all),
                   launches=runs[-1][3], cpu_oracle_seconds=cpu_s,
                   oracle_process_busy=busy)
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
        log_analytics(rec)

    # -- 5. the GPU-sharing cell (the per-task path): a warm-up run under
    # the profiler's CUDA activity with K9's and K10's inputs captured, then
    # timed runs (counts reset just before, read just after), one CPU
    # oracle run ------------------------------------------------------------
    # (its CPU oracle runs in the oracle process beside the cells below,
    # and is compared after the last cell)
    from torch.profiler import ProfilerActivity, profile
    with Capture(SHARING_KEEP) as scap, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, sharing_warm_s = run_sharing_cycle("cuda")
    sharing_in_cycle = in_cycle_device_ms(prof)
    del prof
    sharing_runs = []
    for _ in range(SHARING_RUNS):
        kernels.reset_launch_counts()
        res, cluster, secs = run_sharing_cycle("cuda")
        sharing_runs.append((res, cluster, secs, kernels.launch_counts()))
    log(f"sharing: {SHARING_RUNS} timed cycles run; elapsed "
        f"{time.perf_counter() - t_start:.0f} s")
    checks.update(sharing_kernel_checks(scap))
    an_caps["sharing"] = scap
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
        log_analytics(rec)
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
    caps, deferred = {}, {}
    for cell in VICTIM_CELLS:
        with Capture(VICTIM_KEEP[cell]) as cap, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_victim_cycle(cell, "cuda")
        in_cycle = in_cycle_device_ms(prof)
        del prof
        kernels.reset_launch_counts()
        res, cluster, secs = run_victim_cycle(cell, "cuda")
        counts = kernels.launch_counts()
        caps[cell] = cap
        # its CPU oracle runs in an oracle process: compared at the end
        deferred[cell] = (res, cluster, secs, counts, in_cycle)
        log(f"{cell}: {secs:.3f} s cycle run, launches {counts}; "
            f"compared with its oracle at the end; elapsed "
            f"{time.perf_counter() - t_start:.0f} s")
    checks.update(victim_kernel_checks(caps))
    lane_checks = lane_kernel_checks(caps)
    checks["freed_by_lane"] = lane_checks.pop("freed_by_lane")
    sr_checks = pertask_lane_kernel_checks(caps["sharing_reclaim"])
    sr_checks["freed_by_lane:devices"] = lane_checks.pop(
        "freed_by_lane:devices")
    sr_checks.update(mig_kernel_checks(caps["mig_reclaim"]))
    log(f"mig_reclaim: K6 and K7 on its calls == plain "
        f"{sr_checks['freed_by_lane:extended']['k6_k7']}")
    del caps
    report["victim_edges"] = victim_edge_checks()
    log(f"K8, K7, K5 and K12 on kernel_edges' inputs == plain "
        f"(tolerance 0): "
        f"{report['victim_edges']} calls; elapsed "
        f"{time.perf_counter() - t_start:.0f} s")
    log(f"victim kernels checked; elapsed {time.perf_counter() - t_start:.0f}"
        f" s")

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
        busy = oracle_busy()
        for _ in range(reps):
            kernels.reset_launch_counts()
            res, cluster, secs = run_affinity_cycle(cell, "cuda")
            runs.append((res, cluster, secs, kernels.launch_counts()))
        busy = busy and oracle_busy()
        cpu, _, cpu_s = oracles[cell].result()
        recs = [check_affinity_cycle(cell, (res, secs), cpu, cluster, counts)
                for res, cluster, secs, counts in runs]
        del runs
        secs_all = sorted(r["cycle_seconds"] for r in recs)
        rec = dict(recs[-1])
        rec.update(runs=len(recs), cycle_seconds_all=secs_all,
                   cycle_seconds_median=statistics.median(secs_all),
                   warm_up_seconds=warm_s, cpu_oracle_seconds=cpu_s,
                   in_cycle_ms=in_cycle, oracle_process_busy=busy)
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
        log_analytics(rec)
        log("  in-cycle kernel device ms / launches (profiled run): "
            + ", ".join(f"{k} {v['ms']:.3f} / {v['launches']}"
                        for k, v in in_cycle.items() if v["launches"]))
        log(f"  elapsed {time.perf_counter() - t_start:.0f} s")
    aff_checks = affinity_kernel_checks(acaps)
    an_caps["affinity"] = acaps["affinity"]
    for k in ("affinity_mask", "anti_mark"):
        checks[k] = aff_checks.pop(k)
    del acaps

    # -- 9. the repack_racks cell: four cycles under the profiler's CUDA
    # activity with K14's, K15's and K4's repack inputs captured, then the
    # timed run (counts reset just before its first cycle, read just after
    # its last), one CPU oracle run; every cycle against the oracle's ----
    with Capture(REPACK_KEEP) as rcap, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        warm, _ = run_repack_cycles("cuda")
    in_cycle = in_cycle_device_ms(prof)
    del prof
    gpu, counts = run_repack_cycles("cuda")
    t0 = time.perf_counter()
    cpu, _ = run_repack_cycles("cpu")
    cpu_s = time.perf_counter() - t0
    rec = check_repack_cycles(gpu, cpu, counts)
    rec.update(cpu_oracle_seconds=cpu_s, in_cycle_ms=in_cycle,
               warm_up_seconds_all=[w[1] for w in warm])
    report["repack_racks"] = rec
    del warm, gpu, cpu
    log(f"repack_racks: cycle seconds "
        f"{[round(x, 4) for x in rec['cycle_seconds_all']]} (profiled "
        f"run {[round(x, 4) for x in rec['warm_up_seconds_all']]}; CPU "
        f"oracle {[round(x, 4) for x in rec['cpu_cycle_seconds_all']]}, "
        f"{cpu_s:.1f} s), analytics seconds "
        f"{[round(x, 4) for x in rec['analytics_seconds_all']]}, frag_score "
        f"{rec['frag_scores']}; fired on cycle {REPACK_FIRES} for "
        f"{rec['target_gang']} (rack domain {rec['target_rack']}): "
        f"{rec['migrations']} moves from {rec['moved_from']} to "
        f"{rec['moved_to']}, solve {rec['repack_seconds']:.4f} s; cycle "
        f"{REPACK_FIRES + 1} bound its {rec['gang_binds']} pods in "
        f"{rec['moved_from']}; launches {counts}; every cycle's commit, "
        f"decision and document == CPU oracle")
    log(f"  elapsed {time.perf_counter() - t_start:.0f} s")

    # -- 9b. the resident_churn cell: the resident run and its two twins
    # over one churn stream, then the CPU oracle (the oracle process), then
    # K16 vs its plain version on every captured delta -------------------
    records, captured, in_cycle, fallbacks, build_s, k6_calls = \
        run_resident_cell()
    oracle, oracle_s = oracles["resident_churn"].result()
    rec = check_resident_cell(records, oracle)
    rec.update(in_cycle_ms=in_cycle, fallbacks=fallbacks,
               cluster_build_seconds=build_s, cpu_oracle_seconds=oracle_s)
    report["resident_churn"] = rec
    del records, oracle
    checks.update(resident_kernel_checks(captured))
    res_checks = resident_freed_checks(k6_calls)
    del captured, k6_calls
    med = rec["cycle_seconds_median"]
    log(f"resident_churn: {rec['cycles']} cycles (modes {rec['modes']}, "
        f"fallbacks {rec['fallback_reasons']}), {RESIDENT_TIMED} timed: "
        f"median resident {med['resident']:.4f} s, patched twin "
        f"{med['patched']:.4f} s, full twin {med['full']:.4f} s (all: "
        f"{rec['cycle_seconds_all']}); "
        f"delta bytes {rec['delta_bytes_all']}, resident reused "
        f"{rec['resident_reused_bytes']} B vs uploaded "
        f"{rec['resident_uploaded_bytes']} B; binds {rec['binds_all']}, "
        f"evictions {rec['evictions_all']}; launches {rec['launches']}; "
        f"every cycle's decisions == both twins and the CPU oracle "
        f"({oracle_s:.1f} s), packed == both twins and oracle, residency "
        f"verified after every cycle, one delta-apply upload and one K16 "
        f"launch a resident cycle")
    for k in RESIDENT_KINDS:
        log(f"  {k} phases (median of the timed): " + ", ".join(
            f"{ph} {v:.4f}" for ph, v in rec["phase_seconds_median"][k]
            .items()))
    log(f"  elapsed {time.perf_counter() - t_start:.0f} s")
    # the sharing cell against its CPU oracle (run in the oracle process)
    cpu, _, cpu_s = oracles["sharing"].result()
    recs = [check_sharing_cycle((res, secs), cpu, cluster, counts)
            for res, cluster, secs, counts in sharing_runs]
    del sharing_runs, cpu
    secs_all = sorted(r["cycle_seconds"] for r in recs)
    rec = dict(recs[-1])
    rec.update(runs=len(recs), cycle_seconds_all=secs_all,
               cycle_seconds_median=statistics.median(secs_all),
               pods_bound_per_s_median=rec["binds"]
               / statistics.median(secs_all),
               warm_up_seconds=sharing_warm_s, cpu_oracle_seconds=cpu_s,
               in_cycle_ms=sharing_in_cycle)
    report["sharing"] = rec
    log(f"sharing: {len(recs)} cycles, median "
        f"{rec['cycle_seconds_median']:.4f} s (min {secs_all[0]:.4f}, max "
        f"{secs_all[-1]:.4f}; profiled warm-up {sharing_warm_s:.3f}), "
        f"{rec['binds']} binds ({rec['fractional_binds']} fractional, "
        f"{rec['pods_bound_per_s_median']:.0f} pods/s), "
        f"{rec['gangs_allocated']} gangs allocated of "
        f"{rec['gangs_attempted']} attempted, {rec['chunks']} chunks, fit "
        f"reasons {rec['fit_reason_counts']}, launches {rec['launches']}; "
        f"every commit, BindRequest and device index == CPU oracle "
        f"({cpu_s:.1f} s, in the oracle process)")
    log("  phases (last run): " + ", ".join(
        f"{k} {v:.4f}" for k, v in rec["phase_seconds"].items()))
    log_analytics(rec)
    log(f"  elapsed {time.perf_counter() - t_start:.0f} s")
    # the victim cells whose CPU oracle ran in the oracle process
    for cell, (res, cluster, secs, counts, in_cycle) in deferred.items():
        cpu, _, cpu_s = oracles[cell].result()
        rec = check_victim_cycle(cell, (res, secs), cpu, cluster, counts)
        rec.update(cpu_oracle_seconds=cpu_s, in_cycle_ms=in_cycle)
        report[cell] = rec
        log_victim_cell(cell, rec, res, secs, counts, cpu_s, in_cycle)
        log(f"  elapsed {time.perf_counter() - t_start:.0f} s")
    del deferred

    # -- 10. what the oracle process costs the host-bound cycles: the
    # headline's and affinity's timed runs again, each checked against its
    # oracle, now that every oracle has returned and the process is idle
    if oracle_busy():
        raise AssertionError("the oracle process still has work")
    again = {"headline": (HEADLINE_RUNS, lambda: run_cycle(HEADLINE, "cuda"),
                          lambda res, cl, secs, counts: check_cycle(
                              "headline", HEADLINE, (res, secs),
                              oracle_of["headline"], cl)),
             "affinity": (IDLE_AFFINITY_RUNS,
                          lambda: run_affinity_cycle("affinity", "cuda"),
                          lambda res, cl, secs, counts: check_affinity_cycle(
                              "affinity", (res, secs),
                              oracles["affinity"].result()[0], cl, counts))}
    contention = {}
    for cell, (reps, cycle, check) in again.items():
        idle = []
        for _ in range(reps):
            kernels.reset_launch_counts()
            res, cluster, secs = cycle()
            check(res, cluster, secs, kernels.launch_counts())
            idle.append(secs)
            del res, cluster
        busy_all = report[cell]["cycle_seconds_all"]
        contention[cell] = dict(
            busy_during_timed_runs=report[cell]["oracle_process_busy"],
            seconds_all=busy_all, median=statistics.median(busy_all),
            idle_seconds_all=sorted(idle), idle_median=statistics.median(idle))
        c = contention[cell]
        log(f"oracle process cost, {cell}: median {c['median']:.4f} s over "
            f"{len(busy_all)} runs with the oracle process "
            f"{'busy' if c['busy_during_timed_runs'] else 'partly idle'}, "
            f"{c['idle_median']:.4f} s over {reps} runs with it idle "
            f"({[round(x, 4) for x in c['idle_seconds_all']]}); commits == "
            f"CPU oracle")
    report["oracle_contention"] = contention
    log(f"  elapsed {time.perf_counter() - t_start:.0f} s")
    checks.update(analytics_kernel_checks({**an_caps, "repack_racks": rcap}))
    rep_checks = repack_kernel_checks(rcap)
    checks["repack_fill"] = rep_checks.pop("repack_fill")
    del an_caps, rcap
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
                    ("anti_mark", "affinity"),
                    ("repack_fill", "repack_racks"),
                    ("resident_apply", "resident_churn")):
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
                 "pertask_fill:mask": "affinity_sharing",
                 "sparse_accept:repack": "repack_racks",
                 "freed_by_mask:queues_only": "resident_churn",
                 "freed_by_lane:devices": "sharing_reclaim",
                 "pertask_fill:lanes": "sharing_reclaim",
                 "pertask_fill:legacy": "sharing_reclaim",
                 "freed_by_lane:extended": "mig_reclaim",
                 "pertask_fill:extended": "mig_reclaim",
                 "dense_accept:extended": "mig_reclaim"}

    #: each mode's launches, counted by its wrapper at the launch in the
    #: last timed run of its cell (config 4 prefers no level: K3's
    #: preferred mode launches 0 times there, and is held on the captured
    #: inputs only)
    mode_launches = {m: report[c]["launches"][m]
                     for m, c in mode_path.items()}

    mode_checks = {**topo_checks, **aff_checks, **rep_checks, **res_checks,
                   **sr_checks}
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
    os.makedirs(os.path.dirname(KERNEL_INPUTS_PATH), exist_ok=True)
    torch.save(_standalone(KERNEL_INPUTS), KERNEL_INPUTS_PATH)
    log(f"kernel inputs ({', '.join(KERNEL_INPUTS)}) saved to "
        f"{KERNEL_INPUTS_PATH} for scripts/compare_kernels.py")
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
        if "shapes" in c:
            row["shapes"] = c["shapes"]
        mode = f"{name}:lanes" if f"{name}:lanes" in lane_checks else \
            f"{name}:credit"
        if mode in lane_checks:
            m = lane_checks[mode]
            row["victim_mode"] = dict(
                cell=mode_path[mode], launches=mode_launches[mode],
                nearest_library_ms=m.get("nearest_library_ms"),
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
            nearest_library_ms=c.get("nearest_library_ms"),
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
