"""kai-pulse — cluster-health analytics over the cycle's snapshot and
commit set.

Port of ``kai_scheduler_tpu/ops/analytics.py``.  One pass per analytics
cycle (``SchedulerConfig.analytics_every``) emits a fixed-shape bundle
that rides the packed commit (``framework/session._pack_commit``):

* **fragmentation** — per-resource free-fraction histograms over valid
  nodes, the unit pods each node can host (the allocate fit predicate,
  ``resource_fit_mask``), the best rack's unit pods, and the share of a
  ladder of gang sizes that the cluster could serve by raw free units but
  no single rack can host (``frag_score``, the repack trigger's signal);
* **goodput / utilization** — allocated over capacity per resource, and
  the unit throughput of surviving running pods plus this cycle's
  non-pipelined placements over the accelerator capacity;
* **fairness drift** — per queue ``max_r |allocated - fair_share| /
  capacity``, with max, mean and the Gini coefficient of the dominant
  allocated shares;
* **starvation** — each gang's pending age advanced by this cycle's
  outcome, and the ``top_k`` oldest in ``lax.top_k`` order.

The pass is hand-written CUDA kernel **K14** (``csrc/analytics.cu``, one
block); :func:`cluster_analytics_plain` is its plain PyTorch version, run
for CPU tensors.  Every sum over nodes, running pods, gang tasks or queues
is :func:`tree_sum`'s pairwise order on both sides, so the kernel and the
plain version agree bit for bit on any input.  XLA:CPU's reduction order
is not a simple function of the shapes: where the summands are not whole
numbers those sums can differ from the JAX reference's in the last bit;
whole-number summands (the usual case: device counts, unit pods,
allocatable capacity) are exact in any order.  The rack sums are whole
unit counts, exact in any order below 2**24 (asserted by the plain
version; the kernel adds them with atomics).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from .. import kernels
from ..state.cluster_state import ClusterState
from .allocate import AllocationResult, topk_lax_order
from .predicates import resource_fit_mask

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class AnalyticsConfig:
    """Static knobs of the cluster-health pass."""

    #: free-fraction histogram bins per resource axis
    hist_bins: int = 8
    #: canonical gang sizes (unit pods) for the largest-placeable probe
    gang_ladder: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)
    #: the unit-pod request (accel, cpu, mem) the ladder and stranded
    #: gauges probe with; accel-only: "whole idle devices"
    unit_req: tuple[float, float, float] = (1.0, 0.0, 0.0)
    #: topology level treated as the rack (clamped to the snapshot's
    #: levels; topology-free snapshots degrade to per-node domains)
    rack_level: int = 0
    #: starvation table size (oldest pending gangs)
    top_k: int = 8


@dataclasses.dataclass
class AnalyticsBundle:
    """The fixed-shape stats bundle one analytics pass emits."""

    free_hist: Tensor          # f32 [R, BINS]  valid-node counts
    ladder_cluster_ok: Tensor  # f32 [LAD] 1 = total free units cover rung
    ladder_rack_ok: Tensor     # f32 [LAD] 1 = some rack covers rung alone
    total_units: Tensor        # f32 []  placeable unit pods cluster-wide
    max_rack_units: Tensor     # f32 []  placeable unit pods, best rack
    stranded_frac: Tensor      # f32 [R] free stuck on nodes unfit for 1 unit
    frag_score: Tensor         # f32 []  rack-stranded rungs / feasible rungs
    util: Tensor               # f32 [R] allocated / capacity
    goodput: Tensor            # f32 []  effective throughput / accel capacity
    queue_drift: Tensor        # f32 [Q] max_r |alloc - fair| / cap_r
    drift_max: Tensor          # f32 []
    drift_mean: Tensor         # f32 []  over valid queues
    drift_gini: Tensor         # f32 []  over dominant allocated shares
    starv_age: Tensor          # f32 [K] top-K pending ages (cycles)
    starv_gang: Tensor         # i32 [K] gang index per table row
    pending_gangs: Tensor      # f32 []  gangs still pending after the cycle


#: bundle fields in flatten/unpack order — f32 parts then i32 parts
F32_FIELDS = (
    "free_hist", "ladder_cluster_ok", "ladder_rack_ok", "total_units",
    "max_rack_units", "stranded_frac", "frag_score", "util", "goodput",
    "queue_drift", "drift_max", "drift_mean", "drift_gini", "starv_age",
    "pending_gangs")
I32_FIELDS = ("starv_gang",)


def field_shapes(config: AnalyticsConfig, *, q: int, r: int,
                 g: int) -> dict:
    """Field name → shape for a (Q, R, G)-shaped snapshot."""
    lad = len(config.gang_ladder)
    k = min(config.top_k, max(g, 1))
    return {
        "free_hist": (r, config.hist_bins),
        "ladder_cluster_ok": (lad,), "ladder_rack_ok": (lad,),
        "total_units": (), "max_rack_units": (),
        "stranded_frac": (r,), "frag_score": (),
        "util": (r,), "goodput": (),
        "queue_drift": (q,), "drift_max": (), "drift_mean": (),
        "drift_gini": (),
        "starv_age": (k,),
        "pending_gangs": (),
        "starv_gang": (k,),
    }


def _shape_len(shape: tuple) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def f32_len(config: AnalyticsConfig, *, q: int, r: int, g: int) -> int:
    shapes = field_shapes(config, q=q, r=r, g=g)
    return sum(_shape_len(shapes[f]) for f in F32_FIELDS)


def i32_len(config: AnalyticsConfig, *, q: int, r: int, g: int) -> int:
    shapes = field_shapes(config, q=q, r=r, g=g)
    return sum(_shape_len(shapes[f]) for f in I32_FIELDS)


def flatten(bundle: AnalyticsBundle) -> tuple[Tensor, Tensor]:
    """Bundle → (flat f32, flat i32) in the canonical field order."""
    f32 = torch.cat([getattr(bundle, f).reshape(-1).to(torch.float32)
                     for f in F32_FIELDS])
    i32 = torch.cat([getattr(bundle, f).reshape(-1).to(torch.int32)
                     for f in I32_FIELDS])
    return f32, i32


def host_unpack(flat_f32, flat_i32, *, config: AnalyticsConfig,
                q: int, r: int, g: int) -> dict:
    """Flat copies (numpy arrays or tensors) → field name → array."""
    shapes = field_shapes(config, q=q, r=r, g=g)
    out = {}
    off = 0
    for f in F32_FIELDS:
        n = _shape_len(shapes[f])
        out[f] = flat_f32[off:off + n].reshape(shapes[f])
        off += n
    off = 0
    for f in I32_FIELDS:
        n = _shape_len(shapes[f])
        out[f] = flat_i32[off:off + n].reshape(shapes[f])
        off += n
    return out


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def tree_sum(x: Tensor, dim: int = 0) -> Tensor:
    """Sum over ``dim`` in a fixed pairwise order: pad with +0.0 to the
    next power of two, then add adjacent pairs (``x[2i] + x[2i+1]``) level
    by level.  Elementwise adds only, so the bits are the same on any
    device; K14 reduces in this order too."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    p = 1 << (n - 1).bit_length()
    if p > n:
        x = torch.cat([x, torch.zeros((p - n,) + x.shape[1:], dtype=x.dtype,
                                      device=x.device)])
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def unit_pods_per_node(free: Tensor, valid: Tensor, unit: Tensor) -> Tensor:
    """f32 [...] — unit pods each row of ``free`` [..., R] can host, gated
    on the allocate fit predicate (ref ``_unit_pods_per_node``)."""
    fits_one = resource_fit_mask(free, unit)
    per_axis = torch.where(unit > 0,
                           torch.floor(free / torch.clamp(unit, min=EPS)),
                           torch.inf)
    units = per_axis.amin(-1)
    units = torch.where(torch.isfinite(units), units, 0.0)
    return torch.where(valid & fits_one, torch.clamp(units, min=0.0), 0.0)


def rack_domain_ids(state: ClusterState, rack_level: int) -> Tensor:
    """i32 [N] — dense rack-domain id per node at the given topology level:
    a node without the label is its own domain ``N*L + n``; invalid node
    slots map to the junk id ``N*L + N`` (ref ``rack_domain_ids``, the one
    rack partition of the analytics gauges and the repack solver)."""
    n = state.nodes
    N, L = n.n, n.topology.shape[1]
    rl = min(max(rack_level, 0), L - 1)
    dom = n.topology[:, rl]
    node_slot = N * L + torch.arange(N, dtype=torch.int32, device=dom.device)
    junk = N * L + N
    return torch.where(n.valid, torch.where(dom >= 0, dom, node_slot),
                       junk).to(torch.int32)


def domain_sums(units: Tensor, seg: Tensor, num: int) -> Tensor:
    """f32 [num] — ``units`` summed per segment (XLA's scatter order on the
    CPU: ascending index from +0.0).  The values are whole unit counts,
    exact in any order while the total stays below 2**24."""
    out = torch.zeros((num,), dtype=units.dtype, device=units.device)
    return out.index_add_(0, seg.long(), units)


def gini(shares: Tensor, valid: Tensor) -> Tensor:
    """Gini coefficient of ``shares`` over valid queues (0 when fewer than
    two live queues or no allocation)."""
    s = torch.where(valid, shares, 0.0)
    n = valid.sum(dtype=torch.int32).to(torch.float32)
    pair = (s[:, None] - s[None, :]).abs() * (valid[:, None]
                                              & valid[None, :])
    total = tree_sum(s)
    return torch.where((n > 1) & (total > 0),
                       tree_sum(pair.reshape(-1))
                       / torch.clamp(2.0 * n * total, min=EPS), 0.0)


def cluster_analytics_plain(state: ClusterState, result: AllocationResult,
                            pending_age: Tensor, *,
                            config: AnalyticsConfig) -> AnalyticsBundle:
    """Plain PyTorch version of K14 (ref ``cluster_analytics``, ``:263``).
    The fragmentation family reads the PRE-decision pool
    (``state.nodes.free``); the outcome families read the cycle's commit
    set.  ``pending_age`` (f32 [G]) is each gang's pending age BEFORE this
    cycle."""
    nodes, queues, gangs = state.nodes, state.queues, state.gangs
    f32 = torch.float32
    dev = nodes.free.device
    R = nodes.free.shape[1]
    bins = config.hist_bins

    # --- fragmentation (pre-decision capacity shape) ----------------------
    free = torch.clamp(nodes.free, min=0.0)
    alloc_cap = nodes.allocatable
    valid = nodes.valid
    frac = torch.where(alloc_cap > 0,
                       free / torch.clamp(alloc_cap, min=EPS), 0.0)
    idx = torch.clamp(torch.floor(frac * bins).to(torch.int32), 0, bins - 1)
    idx = torch.where(valid[:, None], idx, bins)                   # [N, R]
    free_hist = (idx.T[:, :, None] == torch.arange(bins, device=dev)).sum(
        1, dtype=torch.int32).to(f32)
    unit = torch.tensor(config.unit_req, dtype=f32, device=dev)
    units = unit_pods_per_node(free, valid, unit)
    total_units = tree_sum(units)
    n_dom = nodes.n * nodes.topology.shape[1] + nodes.n
    seg = rack_domain_ids(state, config.rack_level)
    per_dom = domain_sums(units, seg, n_dom + 1)
    if float(per_dom.sum()) >= 2.0 ** 24:
        raise ValueError("cluster_analytics: unit pods reach 2**24; the "
                         "rack sums would depend on their order")
    per_dom[n_dom] = 0.0
    max_rack_units = per_dom.amax()
    ladder = torch.tensor(config.gang_ladder, dtype=f32, device=dev)
    ladder_cluster_ok = (total_units >= ladder).to(f32)
    ladder_rack_ok = (max_rack_units >= ladder).to(f32)
    stranded_rungs = ladder_cluster_ok * (1.0 - ladder_rack_ok)
    frag_score = stranded_rungs.sum() / torch.clamp(ladder_cluster_ok.sum(),
                                                    min=1.0)
    free_valid = torch.where(valid[:, None], free, 0.0)
    stuck = torch.where((units <= 0)[:, None], free_valid, 0.0)
    free_tot = tree_sum(free_valid)
    stranded_frac = torch.where(
        free_tot > 0, tree_sum(stuck) / torch.clamp(free_tot, min=EPS), 0.0)

    # --- goodput / utilization (post-decision) ---------------------------
    cap = tree_sum(torch.where(valid[:, None], alloc_cap, 0.0))
    post_free = torch.where(valid[:, None],
                            torch.clamp(result.free, min=0.0), 0.0)
    releasing = torch.where(valid[:, None],
                            nodes.releasing + result.releasing_extra, 0.0)
    idle = post_free + torch.clamp(releasing, min=0.0)
    util = torch.where(cap > 0, 1.0 - tree_sum(idle)
                       / torch.clamp(cap, min=EPS), 0.0)
    run = state.running
    surviving = run.valid & ~run.releasing & ~result.victim
    thr_running = tree_sum(torch.where(surviving, run.req[:, 0], 0.0))
    placed = ((result.placements >= 0) & gangs.task_valid
              & result.allocated[:, None] & ~result.pipelined)
    thr_placed = tree_sum(torch.where(placed, gangs.task_req[:, :, 0],
                                      0.0).reshape(-1))
    goodput = (thr_running + thr_placed) / torch.clamp(cap[0], min=EPS)

    # --- fairness drift ---------------------------------------------------
    qvalid = queues.valid
    cap1 = torch.clamp(cap, min=1.0)[None, :]
    dev_q = (result.queue_allocated - queues.fair_share).abs() / cap1
    queue_drift = torch.where(qvalid, dev_q.amax(1), 0.0)
    nq = qvalid.sum(dtype=torch.int32).to(f32)
    drift_max = queue_drift.amax()
    drift_mean = tree_sum(queue_drift) / torch.clamp(nq, min=1.0)
    dom_share = (result.queue_allocated / cap1).amax(1)
    drift_gini = gini(dom_share, qvalid)

    # --- starvation -------------------------------------------------------
    still_pending = gangs.valid & ~result.allocated
    age_next = torch.where(still_pending, pending_age + 1.0, 0.0)
    k = min(config.top_k, age_next.shape[0])
    top = topk_lax_order(age_next, k)
    pending_gangs = still_pending.sum(dtype=torch.int32).to(f32)

    return AnalyticsBundle(
        free_hist=free_hist, ladder_cluster_ok=ladder_cluster_ok,
        ladder_rack_ok=ladder_rack_ok, total_units=total_units,
        max_rack_units=max_rack_units, stranded_frac=stranded_frac,
        frag_score=frag_score, util=util, goodput=goodput,
        queue_drift=queue_drift, drift_max=drift_max, drift_mean=drift_mean,
        drift_gini=drift_gini, starv_age=age_next[top],
        starv_gang=top.to(torch.int32), pending_gangs=pending_gangs)


#: per-device copies of a config's gang ladder (no host copy per cycle)
_LADDERS: dict = {}


def _ladder_on(config: AnalyticsConfig, dev) -> Tensor:
    key = (config.gang_ladder, str(dev))
    t = _LADDERS.get(key)
    if t is None:
        t = torch.tensor(config.gang_ladder, dtype=torch.float32, device=dev)
        _LADDERS[key] = t
    return t


def cluster_analytics(state: ClusterState, result: AllocationResult,
                      pending_age: Tensor, *,
                      config: AnalyticsConfig) -> AnalyticsBundle:
    """K14 — the cluster-health bundle (see
    :func:`cluster_analytics_plain`).  CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    if not kernels.on_card(state.nodes.free):
        return cluster_analytics_plain(state, result, pending_age,
                                       config=config)
    nodes, queues, gangs, run = (state.nodes, state.queues, state.gangs,
                                 state.running)
    N, L = nodes.n, nodes.topology.shape[1]
    M, Q, G, T = run.m, queues.q, gangs.g, gangs.t
    R = nodes.free.shape[1]
    if R != 3:
        raise ValueError("cluster_analytics: R must be 3")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    ts = dict(
        free=nodes.free, alloc=nodes.allocatable, nvalid=nodes.valid,
        releasing=nodes.releasing, topology=nodes.topology,
        res_free=result.free, res_rel=result.releasing_extra,
        victim=result.victim, placements=result.placements,
        allocated=result.allocated, pipelined=result.pipelined,
        qa=result.queue_allocated, rvalid=run.valid,
        rreleasing=run.releasing, rreq=run.req, gvalid=gangs.valid,
        task_valid=gangs.task_valid, task_req=gangs.task_req,
        pending_age=pending_age, qvalid=queues.valid,
        fair_share=queues.fair_share)
    dev = kernels.require_cuda("cluster_analytics", ts, dict(
        free=f32, alloc=f32, nvalid=b, releasing=f32, topology=i32,
        res_free=f32, res_rel=f32, victim=b, placements=i32, allocated=b,
        pipelined=b, qa=f32, rvalid=b, rreleasing=b, rreq=f32, gvalid=b,
        task_valid=b, task_req=f32, pending_age=f32, qvalid=b,
        fair_share=f32))
    if pending_age.shape != (G,) or gangs.task_req.shape != (G, T, 3):
        raise ValueError("cluster_analytics: pending_age must be [G], "
                         "task_req [G, T, 3]")
    ladder = _ladder_on(config, dev)
    k = min(config.top_k, G)
    rl = min(max(config.rack_level, 0), L - 1)
    nf = f32_len(config, q=Q, r=R, g=G)
    out_f = torch.empty((nf,), dtype=f32, device=dev)
    out_i = torch.empty((k,), dtype=i32, device=dev)
    rack = torch.empty((N * L + N + 1,), dtype=f32, device=dev)
    scratch = torch.empty((N + Q,), dtype=f32, device=dev)  # units, shares
    u = [float(x) for x in config.unit_req]
    rc = kernels.library().kai_analytics(
        *(kernels.ptr(t) for t in ts.values()), kernels.ptr(ladder),
        L, rl, len(config.gang_ladder), config.hist_bins, *u, k, N, M, G, T,
        Q, kernels.ptr(rack), kernels.ptr(scratch), kernels.ptr(out_f),
        kernels.ptr(out_i), kernels.stream_of(out_f))
    kernels.check(rc, "cluster_analytics")
    kernels.count_launch("cluster_analytics")
    # the bundle's fields are views into the kernel's flat outputs
    return AnalyticsBundle(**host_unpack(out_f, out_i, config=config, q=Q,
                                         r=R, g=G))
