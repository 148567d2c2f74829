"""kai-repack — proactive min-migration defragmentation for a rack-stranded
gang.

Port of ``kai_scheduler_tpu/ops/repack.py``.  One solve over the snapshot
when the scheduler's trigger fires (``SchedulerConfig.repack_*``):

1. **target gang** — the oldest starving pending gang (the same pending
   ages the analytics pass reads) whose required topology level is the
   rack level, and whose quorum is cluster-feasible by raw free units but
   fits no single rack (probed with the gang's own unit request);
2. **min-migration rack** — movable running pods (valid, preemptible, not
   releasing, outside minruntime protection) in the canonical victim
   order (priority ascending, newest first, pod index); each pod's
   marginal unit gain at its place in its node's eviction order is fixed,
   so per-rack prefix sums of the gains give the exact number of
   migrations each rack needs; the fewest wins (lowest domain id on a
   tie), within the migration budget (``RepackConfig.max_migrations``);
3. **re-placement** — canonical ascending-node first fit of the selected
   victims outside the target rack, each within its node-filter class:
   hand-written CUDA kernel **K15** (``csrc/repack.cu``,
   :func:`repack_fill`; plain version :func:`repack_fill_plain`);
4. **claim check** — the plan's (node, request) claims through K4
   (:func:`.allocate.sparse_accept`, one claim per lane); a plan that
   over-subscribes a node is discarded whole.

The sorts, prefix sums, segment starts (``torch.cummax`` for the
reference's ``associative_scan(maximum)``) and segment reductions are
torch ops.  The plan is fixed-shape; the scheduler turns a feasible plan
into evictions with move targets that commit through the pipelined
rebind of consolidation moves (``Session.pipelined_rebind``).

The rack level comes only from the embedded :class:`AnalyticsConfig`, so
the trigger gauge and the solver read one rack partition.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from .. import kernels
from ..state.cluster_state import ClusterState
from ..utils.numerics import cumsum_blocked
from . import analytics as pulse
from . import ordering
from .allocate import EPS, sparse_accept

#: i32 sentinel for "no migration count" (well above any plan width)
_BIG = 1 << 30
_I32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class RepackConfig:
    """Static knobs of the repack solver."""

    #: the rack-domain and unit-probe knobs, shared with the analytics
    #: pass — the one place the rack level lives
    analytics: pulse.AnalyticsConfig = pulse.AnalyticsConfig()
    #: migration budget and plan width (the scheduler passes
    #: ``min(repack_max_migrations, VictimConfig.max_victim_pods)``)
    max_migrations: int = 64


@dataclasses.dataclass
class RepackPlan:
    """The fixed-shape bounded migration plan one repack solve emits."""

    move_pod: Tensor       # i32 [P] running-pod index, -1 unused
    move_node: Tensor      # i32 [P] destination node index, -1 unused
    num_moves: Tensor      # i32 []  moves in a feasible plan (else 0)
    feasible: Tensor       # bool [] plan fully frees the target rack
    target_gang: Tensor    # i32 []  gang the plan unblocks, -1 none
    target_rack: Tensor    # i32 []  dense rack-domain id, -1 none
    needed: Tensor         # f32 []  unit pods the gang still needs
    rack_units_before: Tensor  # f32 [] target-rack units pre-plan
    rack_units_after: Tensor   # f32 [] target-rack units post-plan
    total_units: Tensor    # f32 []  cluster-wide units for the gang


def repack_fill_plain(slot_pod: Tensor, req: Tensor, filter_class: Tensor,
                      dest_ok: Tensor, filter_masks: Tensor,
                      free0: Tensor) -> Tensor:
    """Plain PyTorch version of K15 (ref ``plan_repack``'s ``fill`` scan,
    ``:224-248``): i32 [P], the destination node of each plan slot — the
    lowest node outside the target rack that passes the pod's filter
    class and fits its request in the pool left by the slots before it;
    -1 for an unused slot or a pod that fits nowhere."""
    X = filter_masks.shape[0]
    free_d = free0.clone()
    out = []
    for p in range(slot_pod.shape[0]):
        pod = int(slot_pod[p])
        ps = max(pod, 0)
        vreq = req[ps]
        fc = min(max(int(filter_class[ps]), 0), X - 1)
        fit = (dest_ok & filter_masks[fc]
               & (free_d + EPS >= vreq[None, :]).all(-1))
        node = int(torch.argmax(fit.to(torch.int8))) if bool(fit.any()) \
            else -1
        if pod < 0:
            node = -1
        if node >= 0:
            free_d[node] = free_d[node] - vreq
        out.append(node)
    return torch.tensor(out, dtype=torch.int32, device=slot_pod.device)


def repack_fill(slot_pod: Tensor, req: Tensor, filter_class: Tensor,
                dest_ok: Tensor, filter_masks: Tensor,
                free0: Tensor) -> Tensor:
    """K15 — the plan slots' first-fit destinations (see
    :func:`repack_fill_plain`).  CPU tensors run the plain version; CUDA
    tensors launch one block or raise."""
    if not kernels.on_card(slot_pod):
        return repack_fill_plain(slot_pod, req, filter_class, dest_ok,
                                 filter_masks, free0)
    P = slot_pod.shape[0]
    M, R_ = req.shape
    X, N = filter_masks.shape
    f32, i32, b = torch.float32, torch.int32, torch.bool
    ts = dict(slot_pod=slot_pod, req=req, filter_class=filter_class,
              dest_ok=dest_ok, filter_masks=filter_masks, free0=free0)
    dev = kernels.require_cuda("repack_fill", ts, dict(
        slot_pod=i32, req=f32, filter_class=i32, dest_ok=b, filter_masks=b,
        free0=f32))
    if R_ != 3 or free0.shape != (N, 3) or dest_ok.shape != (N,) \
            or filter_class.shape != (M,):
        raise ValueError("repack_fill: req must be [M, 3], free0 [N, 3], "
                         "dest_ok [N], filter_class [M]")
    free_d = torch.empty((N, 3), dtype=f32, device=dev)
    nodes_p = torch.empty((P,), dtype=i32, device=dev)
    rc = kernels.library().kai_repack_fill(
        *(kernels.ptr(t) for t in ts.values()), P, N, X, M,
        kernels.ptr(free_d), kernels.ptr(nodes_p), kernels.stream_of(req))
    kernels.check(rc, "repack_fill")
    kernels.count_launch("repack_fill")
    return nodes_p


def _first_of_runs(keys: Tensor) -> Tensor:
    """i64 [M] — the index where each element's run of equal ``keys``
    starts (the reference's ``associative_scan(maximum)`` over the run
    starts)."""
    M = keys.shape[0]
    first = torch.ones((M,), dtype=torch.bool, device=keys.device)
    first[1:] = keys[1:] != keys[:-1]
    ar = torch.arange(M, device=keys.device)
    return torch.cummax(torch.where(first, ar, -1), 0).values


def plan_repack(state: ClusterState, pending_age: Tensor, dest_free: Tensor,
                *, config: RepackConfig) -> RepackPlan:
    """One whole-cluster min-migration repack solve (see the module doc;
    ref ``plan_repack``, ``:106``).  ``pending_age`` (f32 [G]) is each
    gang's pending age before this cycle; ``dest_free`` (f32 [N, R]) is
    the pool the migrations' destinations draw on (the cycle's
    post-decision idle pool).  Indexing keeps every value on the device:
    no host read."""
    n, g, r = state.nodes, state.gangs, state.running
    N, L = n.n, n.topology.shape[1]
    M, G = r.m, g.g
    P = max(1, int(config.max_migrations))
    rl = min(max(config.analytics.rack_level, 0), L - 1)
    dev = n.free.device
    f32, i32 = torch.float32, torch.int32

    # --- target gang: oldest starving rack-required pending gang ---------
    cand = g.valid & (g.required_level == rl)
    age_key = torch.where(cand, pending_age, -1.0)
    target = torch.argmax(age_key).reshape(1)                # first max
    has_target = age_key.index_select(0, target)[0] > 0.0
    unit = g.task_req.index_select(0, target)[0, 0]          # [R]
    needed = torch.clamp(g.min_needed.index_select(0, target)[0],
                         min=0).to(f32)

    # --- cluster-feasible but rack-stranded, probed with the gang's unit
    free0 = torch.clamp(n.free, min=0.0)
    units0 = pulse.unit_pods_per_node(free0, n.valid, unit)
    total_units = pulse.tree_sum(units0)
    seg = pulse.rack_domain_ids(state, rl)
    junk = N * L + N
    SEGS = junk + 1
    have = pulse.domain_sums(units0, seg, SEGS)
    max_rack = torch.cat([have[:junk], have.new_zeros(1)]).amax()
    candidacy = (has_target & (needed > 0) & (total_units >= needed)
                 & (max_rack < needed))

    # --- movable pods + canonical victim order ---------------------------
    gang_runtime = torch.full((G + 1,), -torch.inf, dtype=f32,
                              device=dev).scatter_reduce(
        0, torch.where(r.gang >= 0, r.gang, G).long(),
        torch.where(r.valid & (r.gang >= 0), r.runtime_s, -1.0),
        reduce="amax")[:G]
    mrt_g = state.queues.preempt_min_runtime_eff[
        torch.clamp(g.queue, min=0).long()]
    prot_g = (gang_runtime >= 0) & (gang_runtime < mrt_g)
    movable = (r.valid & ~r.releasing & r.preemptible & (r.node >= 0)
               & (r.gang >= 0) & (r.gang != target.to(i32))
               & ~prot_g[torch.clamp(r.gang, 0, G - 1).long()])
    node_m = torch.clamp(r.node, min=0).long()
    order = ordering.lexsort((r.runtime_s, r.priority.to(f32)))
    crank = torch.zeros((M,), dtype=i32, device=dev)
    crank[order] = torch.arange(M, dtype=i32, device=dev)

    # --- fixed per-pod marginal unit gains -------------------------------
    nkey = torch.where(movable, node_m.to(i32), N)
    p1 = ordering.lexsort((crank, nkey))
    mov1 = movable[p1]
    req1 = torch.where(mov1[:, None], r.req[p1], 0.0)            # [M, R]
    cs = cumsum_blocked(req1)
    ns = nkey[p1]
    sidx = _first_of_runs(ns)
    freed_incl = cs - (cs - req1)[sidx]
    nsafe = torch.clamp(ns, max=N - 1).long()
    base_free = free0[nsafe]
    nvalid = (ns < N) & n.valid[nsafe]
    u_incl = pulse.unit_pods_per_node(base_free + freed_incl, nvalid & mov1,
                                      unit)
    u_excl = pulse.unit_pods_per_node(base_free + freed_incl - req1,
                                      nvalid & mov1, unit)
    gain = torch.zeros((M,), dtype=f32, device=dev)
    gain[p1] = torch.where(mov1, u_incl - u_excl, 0.0)

    # --- per-rack min-migration counts -----------------------------------
    dkey = torch.where(movable, seg[node_m], junk)
    p2 = ordering.lexsort((crank, dkey))
    mov2 = movable[p2]
    gain2 = torch.where(mov2, gain[p2], 0.0)
    cg = torch.cumsum(gain2, 0)              # whole unit gains: exact
    ds = dkey[p2]
    sidx2 = _first_of_runs(ds)
    cum_d = cg - (cg - gain2)[sidx2]
    rank_in_rack = (torch.arange(M, device=dev) - sidx2).to(i32)
    dsafe = torch.clamp(ds, max=junk).long()
    reach = have[dsafe] + cum_d
    crosses = (mov2 & (ds < junk) & (reach >= needed) & (rank_in_rack < P))
    k_cand = torch.where(crosses, rank_in_rack + 1, _BIG)
    k_d = torch.full((SEGS,), _I32_MAX, dtype=i32, device=dev).scatter_reduce(
        0, dsafe, k_cand, reduce="amin")
    k_d[junk:].fill_(_BIG)
    best = torch.argmin(k_d).reshape(1)      # lowest id breaks ties
    k_star = k_d.index_select(0, best)[0]
    feasible_rack = k_star < _BIG
    best32 = best.to(i32)

    # --- victim selection (first k_star of the best rack, canonical) -----
    sel2 = mov2 & (ds == best32) & (rank_in_rack < k_star)
    slot = torch.where(sel2, rank_in_rack, P).long()
    slot_pod = torch.full((P + 1,), -1, dtype=i32, device=dev).scatter(
        0, slot, torch.where(sel2, p2.to(i32), -1))[:P]
    have_best = have.index_select(0, best)[0]
    rack_after = have_best + torch.where(sel2, gain2, 0.0).sum()

    # --- destination assignment: canonical ascending-node first fit ------
    dest_ok = n.valid & (seg != best32)
    free_dest0 = torch.where(dest_ok[:, None],
                             torch.clamp(dest_free, min=0.0), 0.0)
    nodes_p = repack_fill(slot_pod, r.req, r.filter_class, dest_ok,
                          n.filter_masks, free_dest0)
    placed = nodes_p >= 0
    all_placed = (placed == (slot_pod >= 0)).all()

    # --- sparse (node, request) claim re-verification (K4) ----------------
    req_b = torch.where((slot_pod >= 0)[:, None],
                        r.req[torch.clamp(slot_pod, min=0).long()], 0.0)
    first_bad, _, _ = sparse_accept(
        nodes_p[:, None].contiguous(), placed[:, None].contiguous(),
        placed[:, None].contiguous(), req_b, free_dest0, free_dest0, N,
        mode="repack")
    verified = first_bad >= P

    feasible = (candidacy & feasible_rack & all_placed & verified
                & (k_star > 0))
    keep = feasible & placed
    move_pod = torch.where(keep, slot_pod, -1)
    move_node = torch.where(keep, nodes_p, -1)
    rack_ok = candidacy & feasible_rack
    zero = torch.zeros((), dtype=f32, device=dev)
    return RepackPlan(
        move_pod=move_pod, move_node=move_node,
        num_moves=torch.where(feasible, (move_pod >= 0).sum(dtype=i32),
                              0).to(i32),
        feasible=feasible,
        target_gang=torch.where(candidacy, target[0].to(i32), -1).to(i32),
        target_rack=torch.where(rack_ok, best32[0], -1).to(i32),
        needed=torch.where(candidacy, needed, zero),
        rack_units_before=torch.where(rack_ok, have_best, zero),
        rack_units_after=torch.where(rack_ok, rack_after, zero),
        total_units=torch.where(candidacy, total_units, zero))
