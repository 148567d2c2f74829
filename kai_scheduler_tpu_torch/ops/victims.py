"""Victim-scenario engine — reclaim, preempt and consolidation.

Port of ``kai_scheduler_tpu/ops/victims.py``, the sequential engine: for a
pending *preemptor* gang, grow a victim set one eviction unit at a time and
simulate "evict victims, re-run allocation" for each scenario; the first
scenario whose simulation places the preemptor and passes the validators
wins (ref ``actions/common/solvers/job_solver.go:47-120``).  Victims are
ranked once per preemptor — victim jobs by the action-start frozen order,
pods within a gang newest first — so a scenario is a prefix of unit ranks.
Reclaim and preempt search that prefix with a capacity lower-bound probe,
an upper probe and a bisection (success is monotone in the prefix);
consolidation, whose every victim must also re-place, walks it linearly.

The reference's ``lax.while_loop`` s and ``lax.cond`` s are host loops here:
one device-to-host read per decision (the next preemptor, the search
bounds, each scenario attempt's success).  Three device programs of the
solver are hand-written CUDA kernels, each with its plain PyTorch version
(the wrapper runs the plain version only for CPU tensors):

- **K5** ``cumsum_ds`` (:mod:`..utils.numerics`) — the per-unit tables'
  compensated prefix sums;
- **K6** :func:`freed_by_mask` (``csrc/freed_by_mask.cu``) — what a
  scenario's victims release per node, device, extended scalar and queue;
- **K7** :func:`replace_victims` (``csrc/replace_victims.cu``) — the
  consolidation validator's greedy re-placement of every victim.

Each scenario attempt places the preemptor through K2 and K3 with one lane
(:func:`.allocate.attempt_gang_dense`).

At ``batch_size > 1`` (the default) reclaim (with ``chunk_reclaim``) and
preempt run the chunked victim wavefront instead
(:func:`_run_victim_action_chunked`): ``B`` preemptors per chunk, one host
read per chunk, every lane's freed pools from **K8**
:func:`freed_by_lane` (``csrc/freed_by_lane.cu``), every lane's placement
through K2 (one table row per lane) and K3 (per-lane queue tables and
score bias), and the sparse accept through K4 with the lanes' freed
credit.

With in-cycle affinity terms (``anti_groups``, ``attract_groups``) both
engines read and extend the cycle's claimed-domain table that allocate
began: each placement is confined to its gang's node mask (**K12**
:func:`.allocate.affinity_mask`, through K3's mask mode), a wavefront
lane whose terms meet an earlier lane's is deferred to the next chunk,
and each committed placement claims its domains (**K13**
:func:`.allocate.anti_mark`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import kernels
from ..apis.types import UNLIMITED
from ..state.cluster_state import ClusterState
from ..utils.numerics import cumsum_blocked, cumsum_ds
from . import ordering
from .allocate import (AllocateConfig, AllocationResult, LaneTables,
                       _ancestor_gate, _chain_membership, _pad_row,
                       affinity_mask, anti_defer_lanes, anti_domain_tables,
                       anti_mark, attempt_gang_dense, attract_defer_lanes,
                       check_supported, single_type_lanes, sparse_accept,
                       type_tables, uniform_fill)
from .scoring import W_OWN_FREED

Tensor = torch.Tensor
EPS = 1e-6
BIG = 2 ** 30
_INF = float("inf")
_I32_MIN = -2 ** 31
_I32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class VictimConfig:
    """Knobs of the victim actions — the reference's fields, one for one,
    with the same defaults (see ``kai_scheduler_tpu.ops.victims.
    VictimConfig`` for each knob's meaning).  ``batch_size > 1`` for
    reclaim (with ``chunk_reclaim``) or preempt selects the chunked
    wavefront; 1 the sequential engine."""

    placement: AllocateConfig = AllocateConfig(dynamic_order=False)
    saturation_multiplier: float = 1.0
    queue_depth: int | None = None
    queue_depth_preempt: int | None = None
    max_consolidation_preemptees: int = 64
    batch_size: int = 64
    batch_size_preempt: int | None = None
    chunk_reclaim: bool = False
    max_victim_pods: int = 512
    optimistic_preempt: bool | None = None
    sparse_unit_k: int | None = None


@dataclasses.dataclass
class VictimStats:
    """What one victim action did: preemptor steps taken, scenario
    attempts simulated, and device-to-host reads the host loop made.  A
    chunked action counts its wavefront chunks as ``steps`` and the lanes
    it attempted as ``attempts``, plus its leftover demotions and whether
    it fell back from the sparse to the dense path."""

    steps: int = 0
    attempts: int = 0
    syncs: int = 0
    demotions: int = 0
    fallbacks: int = 0


# ---------------------------------------------------------------------------
# K6: freed_by_mask
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PodIndex:
    """The running pods listed by node and by leaf queue (CSR, stable in
    pod index) — K6's segment order.  Pods do not change within a cycle,
    so the lists are built once per action."""

    node_off: Tensor   # i32 [N + 1]
    node_pods: Tensor  # i32 [M]
    queue_off: Tensor  # i32 [Q + 1]
    queue_pods: Tensor  # i32 [M]

    @classmethod
    def of(cls, state: ClusterState) -> "PodIndex":
        r = state.running

        def csr(key: Tensor, n: int):
            key = torch.clamp(key, min=0)
            pods = torch.sort(key, stable=True).indices.to(torch.int32)
            off = torch.zeros((n + 1,), dtype=torch.int32, device=key.device)
            # integer counts (bincount would read its size from the device)
            off[1:].index_add_(0, key.long(), torch.ones_like(pods))
            return off.cumsum(0, dtype=torch.int32), pods

        node_off, node_pods = csr(r.node, state.nodes.n)
        queue_off, queue_pods = csr(r.queue, state.queues.q)
        return cls(node_off, node_pods, queue_off, queue_pods)


def _rollup(chain: Tensor, leaf: Tensor) -> Tensor:
    """``einsum("qa,qr->ar", chain, leaf)`` summed in ascending ``q`` from
    +0.0, the order of the reference's dot on the CPU."""
    cf = chain.to(leaf.dtype)
    out = torch.zeros_like(leaf)
    for q in range(leaf.shape[0]):
        out = out + cf[q][:, None] * leaf[q][None, :]
    return out


def freed_by_mask_plain(state: ClusterState, mask: Tensor, chain: Tensor):
    """Plain PyTorch version of K6 (ref ``:143``): ``(freed_nodes [N, R],
    freed_devices [N, D], freed_queues [Q, R], freed_queues_nonpreemptible
    [Q, R], freed_extended [N, E])``.  Every segment sum adds in ascending
    pod order from +0.0 (``index_add_`` on the CPU is that loop)."""
    r, n, q = state.running, state.nodes, state.queues
    N, D, Q = n.n, n.d, q.q
    f32 = torch.float32

    def seg_sum(values: Tensor, seg: Tensor, num: int) -> Tensor:
        out = torch.zeros((num + 1,) + values.shape[1:], dtype=f32,
                          device=values.device)
        return out.index_add_(0, seg.long(), values)[:num]

    req_m = torch.where(mask[:, None], r.req, 0.0)
    node_seg = torch.where(mask, torch.clamp(r.node, min=0), N)
    freed_nodes = seg_sum(req_m, node_seg, N)
    frac = mask & (r.device >= 0)
    flat = torch.clamp(r.node, min=0) * D + torch.clamp(r.device, min=0)
    freed_dev = seg_sum(torch.where(frac, r.accel_held, 0.0),
                        torch.where(frac, flat, N * D), N * D).reshape(N, D)
    bits = (r.devices_mask[:, None] >> torch.arange(
        D, dtype=torch.int32, device=mask.device)[None, :]) & 1
    whole_bits = bits.to(f32) * (mask & (r.device < 0))[:, None]
    freed_dev = freed_dev + seg_sum(whole_bits, node_seg, N)
    leaf = seg_sum(req_m, torch.where(mask, torch.clamp(r.queue, min=0), Q), Q)
    np_mask = mask & ~r.preemptible
    leaf_np = seg_sum(torch.where(np_mask[:, None], r.req, 0.0),
                      torch.where(np_mask, torch.clamp(r.queue, min=0), Q), Q)
    freed_ext = seg_sum(torch.where(mask[:, None], r.extended, 0.0),
                        node_seg, N)
    return (freed_nodes, freed_dev, _rollup(chain, leaf),
            _rollup(chain, leaf_np), freed_ext)


def freed_by_mask(state: ClusterState, mask: Tensor, chain: Tensor,
                  pods: PodIndex | None = None):
    """K6 — resources released by evicting the masked running pods (see
    :func:`freed_by_mask_plain` for the contract).  CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise.  ``pods`` is
    the action's :class:`PodIndex` (built here when not given)."""
    if not kernels.on_card(mask):
        return freed_by_mask_plain(state, mask, chain)
    r, n, q = state.running, state.nodes, state.queues
    N, D, Q, M = n.n, n.d, q.q, r.m
    R_ = r.req.shape[1]
    E = r.extended.shape[1]
    if pods is None:
        pods = PodIndex.of(state)
    f32, i32, b = torch.float32, torch.int32, torch.bool
    ts = dict(mask=mask, req=r.req, device=r.device, held=r.accel_held,
              devices_mask=r.devices_mask, preemptible=r.preemptible,
              extended=r.extended, node_off=pods.node_off,
              node_pods=pods.node_pods, queue_off=pods.queue_off,
              queue_pods=pods.queue_pods, chain=chain)
    dev = kernels.require_cuda("freed_by_mask", ts, dict(
        mask=b, req=f32, device=i32, held=f32, devices_mask=i32,
        preemptible=b, extended=f32, node_off=i32, node_pods=i32,
        queue_off=i32, queue_pods=i32, chain=b))
    if mask.shape != (M,) or chain.shape != (Q, Q):
        raise ValueError("freed_by_mask: mask must be [M], chain [Q, Q]")
    leaf = torch.empty((2 * Q * R_,), dtype=f32, device=dev)
    outs = (torch.empty((N, R_), dtype=f32, device=dev),
            torch.empty((N, D), dtype=f32, device=dev),
            torch.empty((Q, R_), dtype=f32, device=dev),
            torch.empty((Q, R_), dtype=f32, device=dev),
            torch.empty((N, E), dtype=f32, device=dev))
    rc = kernels.library().kai_freed_by_mask(
        *(kernels.ptr(t) for t in ts.values()), N, R_, D, Q, E,
        kernels.ptr(leaf), *(kernels.ptr(t) for t in outs),
        kernels.stream_of(mask))
    kernels.check(rc, "freed_by_mask")
    kernels.count_launch("freed_by_mask")
    return outs


# ---------------------------------------------------------------------------
# K7: replace_victims
# ---------------------------------------------------------------------------

def replace_victims_plain(state: ClusterState, mask: Tensor, free: Tensor,
                          device_free: Tensor, releasing: Tensor,
                          device_releasing: Tensor, ext_free: Tensor,
                          ext_releasing: Tensor, max_pods: int):
    """Plain PyTorch version of K7 (ref ``_replace_victims``, ``:644``):
    every victim, in pod order, takes the fitting node with the least
    available accel (lowest index on ties), drawing on releasing capacity
    too.  Returns ``(free' [N, R], device_free' [N, D], extended_free'
    [N, E], moves i32 [M], all_ok bool [])``."""
    r, n = state.running, state.nodes
    M, D = r.m, n.d
    K = max(1, min(M, max_pods))
    dev = mask.device
    idxs = torch.nonzero(mask).flatten()
    n_vic = idxs.numel()
    free_l, dev_l, ext_l = free.clone(), device_free.clone(), ext_free.clone()
    moves = torch.full((M,), -1, dtype=torch.int32, device=dev)
    all_ok = n_vic <= K
    d_ar = torch.arange(D, device=dev)
    one_m_eps = 1.0 - EPS
    for m in idxs[:K].tolist():
        req = r.req[m]
        is_frac = bool(r.device[m] >= 0)
        p_n = torch.where(
            r.accel_mem[m] > 0,
            r.accel_mem[m] / torch.clamp(n.device_memory_gib, min=EPS),
            r.accel_held[m])                                  # [N]
        avail = free_l + releasing
        dev_avail = dev_l + device_releasing
        fit = ((avail + EPS >= req[None, :]).all(-1) & n.valid
               & n.filter_masks[r.filter_class[m]])
        ext_req = r.extended[m]
        fit = fit & (ext_l + ext_releasing + EPS >= ext_req[None, :]).all(-1)
        if is_frac:
            fit = fit & (dev_avail.amax(-1) >= p_n - EPS)
        else:
            whole_free = (dev_avail >= one_m_eps).to(free.dtype).sum(-1)
            fit = fit & (whole_free + EPS >= req[0])
        if not bool(fit.any()):
            all_ok = False
            continue
        score = torch.where(fit, -avail[:, 0], -_INF)
        node = int(torch.argmax(score))
        p = p_n[node]
        delta = req.clone()
        if is_frac:
            delta[0] = p
        free_l[node] = free_l[node] + (-delta)
        ext_l[node] = ext_l[node] + (-ext_req)
        dev_row = dev_avail[node]
        if is_frac:
            dev_delta = p * (d_ar == torch.argmax(dev_row)).to(free.dtype)
        else:
            k = int(torch.round(req[0]))
            fully = dev_row >= one_m_eps
            take = fully & (torch.cumsum(fully.to(torch.int32), 0) <= k)
            dev_delta = take.to(free.dtype)
        dev_l[node] = dev_l[node] + (-dev_delta)
        moves[m] = node
    return (free_l, dev_l, ext_l, moves,
            torch.tensor(all_ok, dtype=torch.bool, device=dev))


def replace_victims(state: ClusterState, mask: Tensor, free: Tensor,
                    device_free: Tensor, releasing: Tensor,
                    device_releasing: Tensor, ext_free: Tensor,
                    ext_releasing: Tensor, max_pods: int):
    """K7 — the consolidation validator's greedy re-placement (see
    :func:`replace_victims_plain`).  CPU tensors run the plain version;
    CUDA tensors launch one block or raise."""
    if not kernels.on_card(mask):
        return replace_victims_plain(state, mask, free, device_free,
                                     releasing, device_releasing, ext_free,
                                     ext_releasing, max_pods)
    r, n = state.running, state.nodes
    M, N, D = r.m, n.n, n.d
    R_ = r.req.shape[1]
    E = r.extended.shape[1]
    K = max(1, min(M, max_pods))
    f32, i32, b = torch.float32, torch.int32, torch.bool
    dev = mask.device
    # the first K victims in pod order (nonzero without a host read)
    m32 = mask.to(i32)
    pos = torch.cumsum(m32, 0, dtype=i32) - 1
    dest = torch.where(mask & (pos < K), pos, K).long()
    idxs = torch.zeros((K + 1,), dtype=i32, device=dev)
    idxs.scatter_(0, dest, torch.arange(M, dtype=i32, device=dev))
    n_vic = m32.sum(dtype=i32).reshape(1)
    free_o = free.contiguous().clone()
    dev_o = device_free.contiguous().clone()
    ext_o = ext_free.contiguous().clone()
    moves = torch.full((M,), -1, dtype=i32, device=dev)
    all_ok = torch.empty((), dtype=b, device=dev)
    ts = dict(idxs=idxs, n_vic=n_vic, req=r.req, device=r.device,
              accel_mem=r.accel_mem, held=r.accel_held,
              filter_class=r.filter_class, extended=r.extended,
              dev_mem=n.device_memory_gib, valid=n.valid,
              fmask=n.filter_masks, releasing=releasing.contiguous(),
              dev_releasing=device_releasing.contiguous(),
              ext_releasing=ext_releasing.contiguous(), free=free_o,
              dev=dev_o, ext=ext_o, moves=moves, all_ok=all_ok)
    kernels.require_cuda("replace_victims", ts, dict(
        idxs=i32, n_vic=i32, req=f32, device=i32, accel_mem=f32, held=f32,
        filter_class=i32, extended=f32, dev_mem=f32, valid=b, fmask=b,
        releasing=f32, dev_releasing=f32, ext_releasing=f32, free=f32,
        dev=f32, ext=f32, moves=i32, all_ok=b))
    p = [kernels.ptr(t) for t in ts.values()]
    rc = kernels.library().kai_replace_victims(
        p[0], p[1], K, *p[2:14], N, R_, D, E, *p[14:],
        kernels.stream_of(mask))
    kernels.check(rc, "replace_victims")
    kernels.count_launch("replace_victims")
    return free_o, dev_o, ext_o, moves, all_ok


# ---------------------------------------------------------------------------
# K8: freed_by_lane
# ---------------------------------------------------------------------------

def _rollup_lanes(chain: Tensor, leaf: Tensor) -> Tensor:
    """``einsum("qa,bqr->bar", chain, leaf)`` summed in ascending ``q``
    from +0.0 (:func:`_rollup` for every lane at once)."""
    cf = chain.to(leaf.dtype)
    out = torch.zeros_like(leaf)
    for q in range(leaf.shape[1]):
        out = out + cf[q][None, :, None] * leaf[:, q][:, None, :]
    return out


def freed_by_lane_plain(state: ClusterState, lane: Tensor, B: int,
                        chain: Tensor, *, compose: bool):
    """Plain PyTorch version of K8 (ref ``_freed_by_lane``, ``:738``):
    ``lane`` i32 [M] gives each pod the wavefront lane that consumes it
    (``B`` = none).  Returns ``(freed_nodes [B, N, R], freed_queues
    [B, Q, R], own_incr bool [B, N])``: with ``compose`` lane ``b``'s pool
    is the union of lanes ``<= b`` (a cumulative sum over lanes in the
    reference's ``jnp.cumsum`` order), else its own assignment only;
    ``own_incr`` marks the nodes where lane ``b``'s own pods free
    anything.  The device and extended tables the reference can add are
    not built: this package refuses the configurations that track them."""
    r, n, q = state.running, state.nodes, state.queues
    N, Q = n.n, q.q
    R_ = r.req.shape[1]
    live = lane < B
    lane_s = torch.where(live, lane, B).long()
    req_m = torch.where(live[:, None], r.req, 0.0)

    def seg_sum(seg: Tensor, num: int) -> Tensor:
        out = torch.zeros(((B + 1) * (num + 1), R_), dtype=req_m.dtype,
                          device=req_m.device)
        out.index_add_(0, seg, req_m)
        return out.reshape(B + 1, num + 1, R_)[:B, :num]

    node_s = torch.where(live, torch.clamp(r.node, min=0), N).long()
    own_n = seg_sum(lane_s * (N + 1) + node_s, N)
    queue_s = torch.where(live, torch.clamp(r.queue, min=0), Q).long()
    leaf_own = seg_sum(lane_s * (Q + 1) + queue_s, Q)
    freed_n = cumsum_blocked(own_n) if compose else own_n
    leaf_cum = cumsum_blocked(leaf_own) if compose else leaf_own
    own_sum = (own_n[..., 0] + own_n[..., 1]) + own_n[..., 2]
    return freed_n, _rollup_lanes(chain, leaf_cum), own_sum > EPS


def freed_by_lane(state: ClusterState, lane: Tensor, B: int, chain: Tensor,
                  *, compose: bool, pods: PodIndex | None = None):
    """K8 — per-lane freed capacity from a pod-to-lane assignment (see
    :func:`freed_by_lane_plain`).  CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise.  ``pods`` is the action's
    :class:`PodIndex` (K6's lists, reused)."""
    if not kernels.on_card(lane):
        return freed_by_lane_plain(state, lane, B, chain, compose=compose)
    r, n, q = state.running, state.nodes, state.queues
    N, Q, M = n.n, q.q, r.m
    R_ = r.req.shape[1]
    if pods is None:
        pods = PodIndex.of(state)
    f32, i32, b = torch.float32, torch.int32, torch.bool
    ts = dict(lane=lane, req=r.req, node_off=pods.node_off,
              node_pods=pods.node_pods, queue_off=pods.queue_off,
              queue_pods=pods.queue_pods, chain=chain)
    dev = kernels.require_cuda("freed_by_lane", ts, dict(
        lane=i32, req=f32, node_off=i32, node_pods=i32, queue_off=i32,
        queue_pods=i32, chain=b))
    if lane.shape != (M,) or chain.shape != (Q, Q) or R_ != 3:
        raise ValueError("freed_by_lane: lane must be [M], chain [Q, Q], "
                         "R 3")
    leaf = torch.empty((B, Q, R_), dtype=f32, device=dev)
    freed_n = torch.empty((B, N, R_), dtype=f32, device=dev)
    freed_q = torch.empty((B, Q, R_), dtype=f32, device=dev)
    own_incr = torch.empty((B, N), dtype=b, device=dev)
    rc = kernels.library().kai_freed_by_lane(
        *(kernels.ptr(t) for t in ts.values()), N, R_, Q, B, int(compose),
        *(kernels.ptr(t) for t in (leaf, freed_n, freed_q, own_incr)),
        kernels.stream_of(lane))
    kernels.check(rc, "freed_by_lane")
    kernels.count_launch("freed_by_lane")
    return freed_n, freed_q, own_incr


# ---------------------------------------------------------------------------
# victim ranking
# ---------------------------------------------------------------------------

def _segment_sum_i32(values: Tensor, seg: Tensor, num: int) -> Tensor:
    out = torch.zeros((num + 1,), dtype=torch.int32, device=values.device)
    return out.index_add_(0, seg.long(), values.to(torch.int32))[:num]


def _segment_reduce(values: Tensor, seg: Tensor, num: int, reduce: str,
                    init) -> Tensor:
    out = torch.full((num + 1,), init, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, seg.long(), values, reduce=reduce)[:num]


def _pod_order_static(state: ClusterState):
    """Within-gang pod order (newest first), once per action: ``(perm0
    [M], gang_perm [M])`` (ref ``:190``)."""
    r = state.running
    G = state.gangs.g
    gang_all = torch.where(r.valid & (r.gang >= 0), r.gang, G)
    perm0 = ordering.lexsort((r.runtime_s, gang_all))
    return perm0, gang_all[perm0]


def victim_statics(state: ClusterState):
    """Preemptor-independent victim-search inputs (ref ``:201``):
    ``(base0 [M], gang_runtime [G], pod_order)``."""
    r = state.running
    G = state.gangs.g
    base0 = (r.valid & ~r.releasing & (r.node >= 0) & r.preemptible
             & (r.gang >= 0))
    gang_runtime = _segment_reduce(
        torch.where(r.valid & (r.gang >= 0), r.runtime_s, -1.0),
        torch.where(r.gang >= 0, r.gang, G), G, "amax", -_INF)
    return base0, gang_runtime, _pod_order_static(state)


def frozen_job_rank(state: ClusterState, queue_allocated: Tensor,
                    fair_share: Tensor) -> Tensor:
    """Victim-job order frozen at action start (ref ``:222``): most
    saturated queue first, lowest priority first, newest first.  i32 [G]
    rank per gang."""
    g = state.gangs
    G = g.g
    f32 = torch.float32
    sat = (queue_allocated / torch.clamp(fair_share, min=EPS)).amax(-1)
    gq = torch.clamp(g.queue, min=0).long()
    rank_gang = ordering.lexsort((
        -g.creation_order.to(f32), g.priority.to(f32), -sat[gq]))
    out = torch.zeros((G,), dtype=torch.int32, device=sat.device)
    out[rank_gang] = torch.arange(G, dtype=torch.int32, device=sat.device)
    return out


def victim_candidates(state: ClusterState, gi: int, *, mode: str,
                      already_victim: Tensor, statics=None):
    """``(cand bool [M], protected bool [G])`` — pods eligible as victims
    for preemptor ``gi`` and the minruntime-protected gangs (ref
    ``:245``)."""
    r, g, q = state.running, state.gangs, state.queues
    if statics is None:
        statics = victim_statics(state)
    base0, gang_runtime, _ = statics
    base = base0 & ~already_victim
    my_queue = g.queue[gi:gi + 1]      # [1]: a 0-dim index reads the host
    gq = torch.clamp(g.queue, min=0).long()
    if mode == "reclaim":
        mrt_g = q.reclaim_min_runtime_eff[gq, my_queue.long()]
    else:
        mrt_g = q.preempt_min_runtime_eff[gq]
    protected = (gang_runtime >= 0) & (gang_runtime < mrt_g)
    if mode == "reclaim":
        return base & (r.queue != my_queue), protected
    if mode == "consolidate":
        return base & (r.gang != gi), protected
    return (base & (r.queue == my_queue)
            & (r.priority < g.priority[gi])), protected


def _rank_eviction_units(state: ClusterState, cand: Tensor,
                         queue_allocated: Tensor, fair_share: Tensor,
                         already_victim: Tensor, protected: Tensor | None,
                         pod_order=None, job_rank: Tensor | None = None):
    """Every candidate pod's global eviction-unit rank (ref ``:293``):
    ``(unit_rank i32 [M] — BIG for non-candidates, num_units i32 [])``.
    A gang's first ``active - minMember`` pods (newest first) are single
    units, the rest one whole-gang unit; protected gangs expose only
    their surplus units."""
    g, r = state.gangs, state.running
    G, M = g.g, r.m
    i32 = torch.int32
    dev = cand.device
    gang_of_pod = torch.where(cand, r.gang, G)
    pods_per_gang = _segment_sum_i32(cand, gang_of_pod, G)
    victim_gang = pods_per_gang > 0
    if job_rank is None:
        job_rank = frozen_job_rank(state, queue_allocated, fair_share)
    if pod_order is None:
        pod_order = _pod_order_static(state)
    perm0, gang_perm = pod_order
    cand_p = cand[perm0].to(i32)
    excl = torch.cumsum(cand_p, 0, dtype=i32) - cand_p
    base = _segment_reduce(excl, gang_perm, G, "amin", _I32_MAX)
    seq_p = excl - base[torch.clamp(gang_perm, max=G - 1).long()]
    seq = torch.zeros((M,), dtype=i32, device=dev)
    seq[perm0] = seq_p
    victims_in_gang = _segment_sum_i32(
        already_victim & (r.gang >= 0), torch.where(r.gang >= 0, r.gang, G),
        G)
    effective_active = g.running_count - victims_in_gang
    surplus = torch.minimum(
        torch.clamp(effective_active - g.min_member, min=0), pods_per_gang)
    whole_unit = pods_per_gang > surplus
    if protected is not None:
        whole_unit = whole_unit & ~protected
    units_per_gang = torch.where(victim_gang, surplus + whole_unit.to(i32),
                                 0).to(i32)
    units_by_rank = torch.zeros((G,), dtype=i32, device=dev)
    units_by_rank[job_rank.long()] = units_per_gang
    offsets = torch.cumsum(units_by_rank, 0, dtype=i32) - units_by_rank
    gsafe = torch.clamp(gang_of_pod, max=G - 1).long()
    unit_in_gang = torch.minimum(seq, surplus[gsafe])
    in_range = unit_in_gang < units_per_gang[gsafe]
    unit_rank = torch.where(cand & in_range,
                            offsets[job_rank[gsafe].long()] + unit_in_gang,
                            BIG).to(i32)
    return unit_rank, units_per_gang.sum(dtype=i32)


def _leveled_queue(chain: Tensor, depth: Tensor, vq: Tensor,
                   rq: Tensor) -> Tensor:
    """The victim-side ancestor just below the LCA with the reclaimer
    (ref ``:376``), batched over ``vq``/``rq`` (broadcast): i32, -1 when
    every victim ancestor is shared with the reclaimer."""
    cand_q = chain[vq.long()] & ~chain[rq.long()]
    d = torch.where(cand_q, depth, BIG)
    return torch.where(cand_q.any(-1), torch.argmin(d, -1), -1).to(
        torch.int32)


#: rounds of :func:`_ordered_segment_sum` gathered at once (bounds the
#: [segments, rounds, ...] staging tensor)
_ROUNDS_PER_GATHER = 16


def _ordered_segment_sum(values: Tensor, seg: Tensor, num: int,
                         max_len: int) -> Tensor:
    """``segment_sum`` with every segment added in ascending row order
    from +0.0 (the reference's scatter order) on any device, without
    atomics: rows sorted stably by segment, then round ``k`` adds every
    segment's ``k``-th row (gathered for a block of rounds at once;
    segments already exhausted add +0.0, which leaves a sum that starts
    at +0.0 unchanged).  ``max_len`` bounds the rows of any segment below
    ``num``."""
    dev = values.device
    out = torch.zeros((num,) + values.shape[1:], dtype=values.dtype,
                      device=dev)
    if seg.numel() == 0:
        return out
    order = torch.sort(seg, stable=True).indices
    s = seg[order].contiguous()
    v = values[order]
    ids = torch.arange(num, dtype=s.dtype, device=dev)
    start = torch.searchsorted(s, ids)
    length = torch.searchsorted(s, ids, right=True) - start
    tail = (1,) * (values.dim() - 1)
    for k0 in range(0, max_len, _ROUNDS_PER_GATHER):
        k = torch.arange(k0, min(max_len, k0 + _ROUNDS_PER_GATHER),
                         device=dev)
        idx = torch.clamp(start[:, None] + k[None, :], max=seg.shape[0] - 1)
        on = (k[None, :] < length[:, None]).view(idx.shape + tail)
        rows = torch.where(on, v[idx], 0.0)           # [num, rounds, ...]
        for j in range(k.shape[0]):
            out = out + rows[:, j]
    return out


# ---------------------------------------------------------------------------
# one preemptor's scenario search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Action:
    """Per-action constants the step loop hands each solve."""

    chain: Tensor
    statics: tuple
    job_rank: Tensor
    #: K6's pod lists (None on the CPU, where the plain version runs)
    pods: PodIndex | None
    lanes: LaneTables
    limit_eff: Tensor
    quota_eff: Tensor
    #: most running pods of any one gang — bounds a unit's pod count
    max_unit: int
    stats: VictimStats


def action_context(state: ClusterState, result: AllocationResult,
                   fair_share: Tensor, *, num_levels: int,
                   stats: VictimStats | None = None) -> _Action:
    """The per-action constants every solve reads, computed once at
    action start: ancestor chains, victim statics, the frozen job order,
    K6's pod lists (on the card), K3's one-type lane tables, the queue
    caps and the largest gang's running-pod count (one host read)."""
    g, q, r = state.gangs, state.queues, state.running
    G = g.g
    stats = stats or VictimStats()
    max_unit = int(_segment_sum_i32(
        r.valid & (r.gang >= 0), torch.where(r.gang >= 0, r.gang, G),
        G).max()) if G else 0
    stats.syncs += 1
    return _Action(
        chain=_chain_membership(q.parent, num_levels),
        statics=victim_statics(state),
        job_rank=frozen_job_rank(state, result.queue_allocated, fair_share),
        pods=PodIndex.of(state) if kernels.on_card(r.valid) else None,
        lanes=single_type_lanes(state),
        limit_eff=torch.where(q.limit <= UNLIMITED + 0.5, _INF, q.limit),
        quota_eff=torch.where(q.quota <= UNLIMITED + 0.5, _INF, q.quota),
        max_unit=max_unit, stats=stats)


def solve_for_preemptor(state: ClusterState, gi: int,
                        result: AllocationResult, fair_share: Tensor, *,
                        num_levels: int, mode: str, config: VictimConfig,
                        act: _Action, domain_mask: Tensor | None = None):
    """One preemptor's scenario search (ref ``:390``); ``domain_mask``
    bool [N] is the affinity gates' node mask (ref ``:402``, ``:539``),
    applied to every scenario's placement.  Returns ``None``
    when no scenario places it, else ``(victim_mask [M], nodes_t [T],
    pipe_t [T], moves [M] | None, free', device_free', extra', extra_dev',
    qa', qan', ext', ext_extra')`` — the commit-set fields a success
    writes (the uniform path places no devices: ``placement_device``
    stays -1)."""
    reclaim = mode == "reclaim"
    consolidate = mode == "consolidate"
    g, q, n, r = state.gangs, state.queues, state.nodes, state.running
    M, T = r.m, g.t
    stats = act.stats
    chain = act.chain
    free = result.free
    extra = result.releasing_extra
    extra_dev = result.device_releasing_extra
    ext_extra = result.extended_releasing_extra
    qa = result.queue_allocated
    qan = result.queue_allocated_nonpreemptible
    queue = g.queue[gi:gi + 1]         # [1]: a 0-dim index reads the host
    task_req = torch.where(g.task_valid[gi][:, None], g.task_req[gi], 0.0)
    total_req = torch.zeros_like(task_req[0])
    for t in range(T):
        total_req = total_req + task_req[t]
    nonpreempt = ~g.preemptible[gi]

    # ---- gates ----------------------------------------------------------
    nonpreempt_quota_ok = torch.where(
        nonpreempt, _ancestor_gate(q.parent, queue, num_levels, qan,
                                   q.quota, total_req), True)
    gate = ~nonpreempt if consolidate else nonpreempt_quota_ok
    cand, protected = victim_candidates(
        state, gi, mode=mode, already_victim=result.victim,
        statics=act.statics)
    gate = gate & cand.any()
    removed_victims = result.victim & (result.victim_move < 0)
    unit_rank, num_units = _rank_eviction_units(
        state, cand, qa, fair_share, removed_victims, protected,
        act.statics[2], act.job_rank)
    if consolidate:
        num_units = torch.clamp(num_units,
                                max=config.max_consolidation_preemptees)
    reclaimer_under_quota = _ancestor_gate(
        q.parent, queue, num_levels, qa, q.quota, total_req)
    m_req = torch.where(cand[:, None], r.req, 0.0)
    urank_safe = torch.clamp(unit_rank, max=M)

    # ---- per-unit tables over all unit ranks ------------------------------
    unit_req = _ordered_segment_sum(m_req, urank_safe, M, act.max_unit)
    cum_freed = cumsum_ds(unit_req, axis=0)
    cluster_free = torch.where(n.valid[:, None],
                               free + n.releasing + extra, 0.0).sum(0)
    enough = ((cluster_free[None, :] + cum_freed + EPS)
              >= total_req[None, :]).all(-1)
    ar_m = torch.arange(M, device=free.device)
    if reclaim:
        unit_leaf = _segment_reduce(torch.where(cand, r.queue, -1),
                                    urank_safe, M, "amax", _I32_MIN)
        leaf_safe = torch.clamp(unit_leaf, min=0)
        lq_u = _leveled_queue(chain, q.depth, leaf_safe, queue)
        contrib = chain[leaf_safe.long()] & (unit_leaf >= 0)[:, None]
        inc = contrib[:, :, None] * unit_req[:, None, :]      # [U, Q, R]
        csum_excl = cumsum_ds(inc, axis=0) - inc
        lq_safe = torch.clamp(lq_u, min=0).long()
        freed_excl = csum_excl[ar_m, lq_safe]
        remaining_u = qa[lq_safe] - freed_excl
        over_fs = (remaining_u > fair_share[lq_safe] + EPS).any(-1)
        over_q = (remaining_u > act.quota_eff[lq_safe] + EPS).any(-1)
        pass_u = (lq_u < 0) | over_fs | (reclaimer_under_quota & over_q)
    else:
        pass_u = torch.ones((M,), dtype=torch.bool, device=free.device)
    bad = (ar_m < num_units) & ~pass_u
    first_bad = torch.where(bad.any(), torch.argmax(bad.to(torch.int32)),
                            num_units)
    hi_t = torch.minimum(num_units, first_bad) - 1
    lo_t = torch.argmax(enough.to(torch.int32))
    gate_t, pre_t, lo, hi = torch.cat([
        t.to(torch.int64).reshape(1)
        for t in (gate, enough.any(), lo_t, hi_t)]).tolist()
    stats.syncs += 1
    if not (gate_t and pre_t and hi >= lo):
        return None

    cfg = config.placement
    max_pods = max(config.max_victim_pods,
                   config.max_consolidation_preemptees * T)

    def attempt(k: int):
        """Simulate scenario prefix ``k``: evict, credit, re-place."""
        stats.attempts += 1
        mask_k = cand & (unit_rank <= k)
        freed_nodes, freed_dev, freed_q, _, freed_ext = freed_by_mask(
            state, mask_k, chain, act.pods)
        extra_eff = extra + freed_nodes
        extra_dev_eff = extra_dev + freed_dev
        ext_extra_eff = ext_extra + freed_ext
        qa_eff = qa if consolidate else qa - freed_q
        free2, qa2, qan2, nodes_t, pipe_t, success = attempt_gang_dense(
            state, gi, free, qa_eff, qan, extra_eff, config=cfg,
            chain=chain, limit_eff=act.limit_eff, quota_eff=act.quota_eff,
            lt=act.lanes, domain_mask=domain_mask)
        dev2, ext2 = result.device_free, result.extended_free
        moves = None
        if reclaim:
            success = success & _ancestor_gate(
                q.parent, queue, num_levels, qa_eff, fair_share, total_req)
        if consolidate:
            free2, dev2, ext2, moves, all_ok = replace_victims(
                state, mask_k, free2, result.device_free,
                n.releasing + extra_eff,
                n.device_releasing + extra_dev_eff, ext2,
                n.extended_releasing + ext_extra_eff, max_pods)
            success = success & all_ok
        stats.syncs += 1
        ok = bool(success)
        return ok, (mask_k, nodes_t, pipe_t, moves, free2, dev2, extra_eff,
                    extra_dev_eff, qa2, qan2, ext2, ext_extra_eff)

    if consolidate:
        # allPodsReallocated is not monotone: the linear first-success walk
        for k in range(lo, hi + 1):
            ok, out = attempt(k)
            if ok:
                return out
        return None
    ok, out = attempt(lo)
    if ok:
        return out
    ok, best = attempt(hi)
    if not ok:
        return None
    lo_c, hi_c = lo, hi          # invariant: lo_c fails, hi_c succeeds
    while lo_c + 1 < hi_c:
        mid = (lo_c + hi_c) // 2
        ok, out = attempt(mid)
        if ok:
            hi_c, best = mid, out
        else:
            lo_c = mid
    return best


# ---------------------------------------------------------------------------
# the chunked victim wavefront
# ---------------------------------------------------------------------------

def _sparse_preempt_ok(config: VictimConfig) -> bool:
    """Static gate of the sparse preempt wavefront (ref ``:810``): uniform
    tasks, no device table, no extended resources, no subgroup topology;
    ``optimistic_preempt=False`` forces the dense composed path."""
    p = config.placement
    ok = (p.uniform_tasks and not p.track_devices and not p.extended
          and not p.subgroup_topology)
    if config.optimistic_preempt is not None:
        ok = ok and config.optimistic_preempt
    return ok


#: ``AllocationResult.wavefront_stats`` row per chunked action (columns:
#: chunks, valid lanes, lane slots, sparse fallbacks, leftover demotions)
_STATS_ROW = {"reclaim": 0, "preempt": 1}


def _searchsorted(arr: Tensor, v: Tensor, *, right: bool = False) -> Tensor:
    """``jnp.searchsorted`` with its default ``method="scan"``, batched:
    ``arr`` [..., n] with ``v`` [...] of the same leading dims, or a 1-D
    ``arr`` with ``v`` of any shape.  The
    reference's fixed bisection — ``ceil(log2(n + 1))`` halvings of
    ``[0, n]`` probing ``(low + high) // 2`` — so a row that rounding left
    unsorted answers as it does there.  Integer rows are sorted by
    construction (counts, ranks, running maxima): there it is the lower
    (upper) bound, ``torch.searchsorted``'s answer.  i32 [...]."""
    if not arr.is_floating_point():
        if arr.dim() == 1:
            return torch.searchsorted(arr, v, right=right).to(torch.int32)
        return torch.searchsorted(arr.contiguous(), v[..., None].contiguous(),
                                  right=right)[..., 0].to(torch.int32)
    n = arr.shape[-1]
    low = torch.zeros(v.shape, dtype=torch.long, device=v.device)
    high = torch.full(v.shape, n, dtype=torch.long, device=v.device)
    for _ in range(math.ceil(math.log2(n + 1))):
        mid = (low + high) // 2
        at = torch.clamp(mid, max=n - 1)
        probe = (arr[at] if arr.dim() == 1
                 else torch.gather(arr, -1, at[..., None])[..., 0])
        go_left = (v < probe) if right else (v <= probe)
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high.to(torch.int32)


def _lane_sum(w: Tensor, x: Tensor) -> Tensor:
    """``einsum("b,b...->...", w, x)`` added in ascending ``b`` from +0.0,
    for 0/1 weights ``w`` (exact products, so a fused multiply-add rounds
    as the separate product and add do)."""
    acc = torch.zeros(torch.broadcast_shapes(w[0].shape, x[0].shape),
                      dtype=x.dtype, device=x.device)
    for b in range(x.shape[0]):
        acc.addcmul_(w[b], x[b])
    return acc


def _ancestor_gate_lanes(parent: Tensor, q_b: Tensor, num_levels: int,
                         used_b: Tensor, cap: Tensor, req: Tensor) -> Tensor:
    """:func:`_ancestor_gate` with one ``used`` table per lane, [B, Q, R]."""
    ok = torch.ones(q_b.shape, dtype=torch.bool, device=q_b.device)
    ar = torch.arange(q_b.shape[0], device=q_b.device)
    cur = q_b
    for _ in range(num_levels):
        valid = cur >= 0
        idx = torch.clamp(cur, min=0).long()
        cap_q = cap[idx]
        fits = ((cap_q <= UNLIMITED + 0.5)
                | (used_b[ar, idx] + req <= cap_q + EPS)).all(-1)
        ok = ok & (~valid | fits)
        cur = torch.where(valid, parent[idx], -1)
    return ok


@dataclasses.dataclass
class _Tables:
    """The per-action unit tables one flavour of the wavefront probes."""

    sparse: bool
    # dense
    onehot_leaf: Tensor | None = None   # bool [U, Q]
    C_leaf: Tensor | None = None        # f32 [U, Q, R]
    cl: Tensor | None = None            # i32 [U + 1, Q]
    pos_q: Tensor | None = None         # i32 [Q, U]
    S_T: Tensor | None = None           # f32 [Q*R, U]   (reclaim)
    prio_by_q: Tensor | None = None     # f32 [Q, U]     (preempt)
    # sparse
    pos_c: Tensor | None = None         # i32 [Q, KU + 1]
    valid_pos: Tensor | None = None     # bool [Q, KU]
    Cq: Tensor | None = None            # f32 [Q, KU, R]
    prio_c: Tensor | None = None        # f32 [Q, KU]


def _unit_tables(sparse: bool, reclaim: bool, unit_req: Tensor,
                 unit_leaf: Tensor, unit_prio: Tensor | None, chain: Tensor,
                 Q: int, KU: int) -> _Tables:
    """The hoisted per-unit tables (ref ``:1013-1075``): the compact
    per-queue top-``KU`` tables of the sparse path, or the dense [U, Q]
    cumulatives."""
    M, R_ = unit_req.shape
    dev = unit_req.device
    i32 = torch.int32
    has_leaf = unit_leaf >= 0
    leaf_safe = torch.clamp(unit_leaf, min=0).long()
    ar_m = torch.arange(M, dtype=i32, device=dev)
    if sparse:
        leaf_key = torch.where(has_leaf, leaf_safe, Q)
        perm_u = torch.sort(leaf_key, stable=True).indices
        lk_p = leaf_key[perm_u]
        first_u = torch.ones((M,), dtype=torch.bool, device=dev)
        first_u[1:] = lk_p[1:] != lk_p[:-1]
        seg_start = torch.cummax(torch.where(first_u, ar_m, -1), 0).values
        r_in_q = torch.zeros((M,), dtype=i32, device=dev)
        r_in_q[perm_u] = ar_m - seg_start
        rk = torch.clamp(r_in_q, max=KU)
        # every duplicate target writes the junk rank M
        pos_c = torch.full((Q + 1, KU + 1), M, dtype=i32, device=dev)
        pos_c[torch.where(has_leaf, leaf_safe, Q),
              torch.where(has_leaf, rk, KU).long()] = torch.where(
                  has_leaf & (r_in_q < KU), ar_m, M)
        pos_c = pos_c[:Q].contiguous()
        pos_k = pos_c[:, :KU]
        valid_pos = pos_k < M
        pos_safe = torch.clamp(pos_k, max=M - 1).long()
        Cq = cumsum_ds(torch.where(valid_pos[..., None], unit_req[pos_safe],
                                   0.0), axis=1)
        prio_c = torch.where(valid_pos, unit_prio[pos_safe], 1e30)
        return _Tables(True, pos_c=pos_c, valid_pos=valid_pos, Cq=Cq,
                       prio_c=prio_c.contiguous())
    qidx = torch.arange(Q, device=dev)
    onehot_leaf = (unit_leaf[:, None] == qidx[None, :]) & has_leaf[:, None]
    C_leaf = cumsum_ds(onehot_leaf[:, :, None] * unit_req[:, None, :], axis=0)
    # (int scans run along the innermost axis: CUDA's outer-axis scan
    # walks the rows one by one)
    cnt_leaf = torch.cumsum(onehot_leaf.T.to(i32), 1, dtype=i32).T
    cl = torch.cat([torch.zeros((1, Q), dtype=i32, device=dev), cnt_leaf])
    r_in_q = cl[ar_m.long(), leaf_safe]
    rows = torch.where(has_leaf, leaf_safe, Q)
    pos_q = torch.full((Q + 1, M), M, dtype=i32, device=dev)
    pos_q[rows, r_in_q.long()] = ar_m
    pos_q = pos_q[:Q].contiguous()
    t = _Tables(False, onehot_leaf=onehot_leaf, C_leaf=C_leaf, cl=cl,
                pos_q=pos_q)
    if reclaim:
        inc_sub = ((chain[leaf_safe] & has_leaf[:, None])[:, :, None]
                   * unit_req[:, None, :])
        # the exclusive subtree cumulative, one row per (queue, resource)
        t.S_T = (cumsum_ds(inc_sub, axis=0) - inc_sub).reshape(
            M, Q * R_).T.contiguous()
    else:
        prio_by_q = torch.full((Q + 1, M), 1e30, device=dev)
        prio_by_q[rows, r_in_q.long()] = unit_prio
        t.prio_by_q = prio_by_q[:Q].contiguous()
    return t


def _run_victim_action_chunked(state: ClusterState, fair_share: Tensor,
                               result: AllocationResult, *, num_levels: int,
                               mode: str, config: VictimConfig,
                               remaining0: Tensor, act: _Action,
                               lq_tab: Tensor | None, cnt_q: Tensor,
                               task_req_g: Tensor) -> AllocationResult:
    """The wavefront victim search (ref ``_run_victim_action_chunked``,
    ``:831``): ``B`` preemptors per chunk in the frozen fairness order,
    each lane with its own budget over the frozen eviction-unit order, a
    pod-to-lane assignment, per-lane freed pools (K8), every lane's
    placement at once (K2 with one table row per lane, K3 with per-lane
    queue tables and the own-freed score bias) and a strict accept
    prefix (dense, or K4 with the lane-prefix freed credit).  The
    reference's ``lax.while_loop`` is a host loop with ONE device-to-host
    read per chunk, its ``any(remaining)`` test; the chunk body branches
    on no device value.  The action's sparse/dense choice (the
    reference's ``lax.cond`` on a queue overflowing ``sparse_unit_k``)
    reads once more."""
    reclaim = mode == "reclaim"
    stats = act.stats
    g, q, n, r = state.gangs, state.queues, state.nodes, state.running
    G, T, M, Q, N = g.g, g.t, r.m, q.q, n.n
    anti = config.placement.anti_groups
    if anti:
        dom_static = anti_domain_tables(state)
    R_ = n.free.shape[1]
    dev = state.device
    i32, f32 = torch.int32, torch.float32
    bs = (config.batch_size_preempt
          if not reclaim and config.batch_size_preempt is not None
          else config.batch_size)
    B = max(1, min(bs, G))
    pcfg = config.placement
    depth = (config.queue_depth_preempt
             if not reclaim and config.queue_depth_preempt is not None
             else config.queue_depth)
    chain = act.chain
    base0, gang_runtime, pod_order = act.statics
    quota_eff_q, limit_eff_q = act.quota_eff, act.limit_eff
    gq = torch.clamp(g.queue, min=0)
    gql = gq.long()
    row = _STATS_ROW[mode]
    if reclaim:
        protected = torch.zeros((G,), dtype=torch.bool, device=dev)
    else:
        mrt_g = q.preempt_min_runtime_eff[gql]
        protected = (gang_runtime >= 0) & (gang_runtime < mrt_g)

    # ---- hoisted: frozen eviction-unit order + per-unit inputs ----------
    cand0 = base0 & ~result.victim
    removed0 = result.victim & (result.victim_move < 0)
    unit_rank, num_units = _rank_eviction_units(
        state, cand0, result.queue_allocated, fair_share, removed0,
        protected, pod_order, act.job_rank)
    urank_safe = torch.clamp(unit_rank, max=M)
    unit_req = _ordered_segment_sum(torch.where(cand0[:, None], r.req, 0.0),
                                    urank_safe, M, act.max_unit)
    unit_leaf = _segment_reduce(torch.where(cand0, r.queue, -1), urank_safe,
                                M, "amax", _I32_MIN)
    has_leaf = unit_leaf >= 0
    leaf_safe = torch.clamp(unit_leaf, min=0).long()
    if reclaim:
        C_all = cumsum_ds(unit_req, axis=0)
        unit_prio = None
    else:
        C_all = None
        gang_prio_pod = g.priority[torch.clamp(r.gang, min=0).long()]
        unit_prio = _segment_reduce(
            torch.where(cand0, gang_prio_pod, -BIG), urank_safe, M, "amax",
            _I32_MIN).to(f32)

    # ---- hoisted: frozen preemptor order --------------------------------
    order0 = ordering.job_order_perm(g, q, result.queue_allocated,
                                     fair_share, state.total_capacity,
                                     remaining0)

    lanes = torch.arange(B, dtype=i32, device=dev)
    lanes_l = lanes.long()
    qidx = torch.arange(Q, device=dev)
    pod_leaf = torch.clamp(r.queue, 0, Q - 1).long()
    ar_m = torch.arange(M, device=dev)
    KU = (max(1, int(config.sparse_unit_k))
          if config.sparse_unit_k is not None else 256)
    sparse = (not reclaim) and _sparse_preempt_ok(config)
    fell_back = False
    if sparse and KU < M:
        cnt_units_q = _segment_sum_i32(has_leaf, torch.where(
            has_leaf, leaf_safe, Q), Q)
        stats.syncs += 1
        if bool((cnt_units_q > KU).any()):
            sparse, fell_back = False, True
    tb = _unit_tables(sparse, reclaim, unit_req, unit_leaf, unit_prio, chain,
                      Q, KU)

    # loop state; row G of each gang buffer is the junk row; K13 marks
    # this action's copy of the claimed-domain table
    res = dataclasses.replace(result)
    if anti:
        res.anti_used = result.anti_used.clone()
    placements = _pad_row(result.placements, -1)
    placement_device = _pad_row(result.placement_device, -1)
    pipelined = _pad_row(result.pipelined, False)
    allocated = _pad_row(result.allocated, False)
    attempted = _pad_row(result.attempted, False)
    fit_reason = _pad_row(result.fit_reason, 0)
    remaining = _pad_row(remaining0, False)
    wstats = result.wavefront_stats.clone()
    one = torch.ones((), dtype=i32, device=dev)
    if fell_back:
        wstats[row, 3].add_(one)
    c = torch.full((Q,), -1, dtype=i32, device=dev)
    q_att = torch.zeros((Q,), dtype=i32, device=dev)
    fuel = G
    while fuel > 0:
        stats.syncs += 1
        if not bool(remaining[:G].any()):
            break
        stats.steps += 1
        free, qa, qan = res.free, res.queue_allocated, \
            res.queue_allocated_nonpreemptible
        extra = res.releasing_extra

        # ---- lanes: first B remaining gangs in frozen order -------------
        flags = remaining[:G][order0]
        rnk = torch.cumsum(flags.to(i32), 0, dtype=i32) - 1
        pos = torch.where(flags & (rnk < B), rnk, B).long()
        cand_g = torch.full((B + 1,), G, dtype=torch.long, device=dev)
        cand_g[pos] = order0
        cand_g = cand_g[:B]
        # the flagged gangs fill the first lanes (storing a Python True
        # into a device tensor would wait on the host)
        cand_valid = lanes_l < flags.sum()
        gsafe_b = torch.clamp(cand_g, max=G - 1)
        q_b = gq[gsafe_b]
        qbl = q_b.long()
        same_q_b = q_b[None, :] == q_b[:, None]

        # ---- lane budgets over the frozen unit order --------------------
        lane_req = torch.where(cand_valid[:, None], task_req_g[gsafe_b], 0.0)
        cluster_free = torch.where(n.valid[:, None],
                                   free + n.releasing + extra, 0.0).sum(0)
        if reclaim:
            cum_req = cumsum_blocked(lane_req)
            targets = cum_req - cluster_free[None, :] - EPS
        else:
            seg_incl = (same_q_b & (lanes_l[None, :] <= lanes_l[:, None])
                        & cand_valid[None, :])
            cum_req_q = _lane_sum(seg_incl.to(f32).T[:, :, None],
                                  lane_req[:, None, :])
            targets = cum_req_q - cluster_free[None, :] - EPS
        need_b = cand_valid & (targets > 0).any(-1)
        if tb.sparse:
            pos_k = tb.pos_c[:, :KU]
            j_c = _searchsorted(pos_k, c, right=True)
            Cv_c = torch.where((j_c > 0)[:, None],
                               tb.Cq[qidx, torch.clamp(j_c - 1, min=0).long()],
                               0.0)
            base_b = Cv_c[qbl]
            v_b = targets + base_b
            pos_full_b = tb.pos_c[qbl]
            j_rb = _searchsorted(tb.Cq[qbl].transpose(1, 2).contiguous(), v_b)
            k_rb = torch.where(v_b > 0, torch.gather(
                pos_full_b, 1, torch.clamp(j_rb, max=KU).long()), 0)
        else:
            csafe = torch.clamp(c, 0, M - 1).long()
            Cv_at_c = torch.where((c >= 0)[:, None], tb.C_leaf[csafe, qidx],
                                  0.0)
            if reclaim:
                arr_b = C_all[None] - tb.C_leaf[:, qbl].transpose(0, 1)
                base_b = Cv_at_c.sum(0)[None, :] - Cv_at_c[qbl]
            else:
                arr_b = tb.C_leaf[:, qbl].transpose(0, 1)
                base_b = Cv_at_c[qbl]
            k_rb = _searchsorted(arr_b.transpose(1, 2).contiguous(),
                                 targets + base_b)
        K_cap = torch.where(need_b, k_rb.amax(1), -1).to(i32)
        if reclaim:
            vrank = torch.cumsum(cand_valid.to(i32), 0, dtype=i32) - 1
        else:
            vrank = (same_q_b & (lanes_l[None, :] < lanes_l[:, None])
                     & cand_valid[None, :]).sum(1, dtype=i32)
        if tb.sparse:
            av_c = (tb.valid_pos & (pos_k < num_units)
                    & (pos_k > c[:, None]))
            cav = torch.cumsum(av_c.to(i32), 1, dtype=i32)
            j_min = _searchsorted(cav[qbl], vrank + 1)
            K_min = torch.gather(pos_full_b, 1, torch.clamp(
                j_min, max=KU).long()[:, None])[:, 0]
        else:
            avail_u = (has_leaf & (ar_m < num_units)
                       & (ar_m > c[torch.clamp(unit_leaf, 0, Q - 1).long()]))
            # available units of each lane's own queue, counted along the
            # unit axis (only the lanes' B queues of the reference's
            # [U, Q] count)
            cum_av_own = torch.cumsum(
                (avail_u[None, :] & tb.onehot_leaf.T[qbl]).to(i32), 1,
                dtype=i32)                                        # [B, U]
            if reclaim:
                cum_av = torch.cumsum(avail_u.to(i32), 0, dtype=i32)
                cum_av_b = cum_av[None, :] - cum_av_own
            else:
                cum_av_b = cum_av_own
            K_min = _searchsorted(cum_av_b, vrank + 1)
        K_raw = torch.where(cand_valid, torch.maximum(K_cap, K_min), -1)
        K_b = torch.cummax(K_raw, 0).values
        insufficient_b = cand_valid & (K_raw >= num_units)

        # ---- strategy / priority admissibility bound --------------------
        if reclaim:
            S_cons = _rollup(chain, Cv_at_c)
            thr_fs = (qa - fair_share - EPS + S_cons).reshape(-1)
            S_T = tb.S_T
            bnd_fs = _searchsorted(S_T, thr_fs).reshape(Q, R_).amax(1)
            thr_qt = (torch.where(torch.isinf(quota_eff_q), -_INF,
                                  qa - quota_eff_q - EPS)
                      + S_cons).reshape(-1)
            bnd_qt = _searchsorted(S_T, thr_qt).reshape(Q, R_).amax(1)
            under_b = _ancestor_gate(q.parent, q_b, num_levels, qa, q.quota,
                                     lane_req)
            bnd_eff = torch.where(under_b[None, :],
                                  torch.maximum(bnd_fs, bnd_qt)[:, None],
                                  bnd_fs[:, None])                # [Q, B]
            lq_vb = lq_tab[:, qbl]
            x_vb = torch.clamp(torch.gather(
                bnd_eff, 0, torch.clamp(lq_vb, 0, Q - 1).long()), 0, M)
            cnt_before = tb.cl[x_vb.long(), qidx[:, None]]
            first_bad_vb = tb.pos_q[qidx[:, None],
                                    torch.clamp(cnt_before, 0, M - 1).long()]
            first_bad_vb = torch.where(lq_vb >= 0, first_bad_vb, M)
            hi_b = torch.minimum(first_bad_vb.amin(0), num_units) - 1
        else:
            prio_b = g.priority[gsafe_b].to(f32)
            if tb.sparse:
                allowed = _searchsorted(tb.prio_c[qbl], prio_b)
                hi_b = torch.gather(pos_full_b, 1, torch.clamp(
                    allowed, 0, KU).long()[:, None])[:, 0] - 1
            else:
                allowed = _searchsorted(tb.prio_by_q[qbl], prio_b)
                hi_b = tb.pos_q[qbl, torch.clamp(allowed, 0,
                                                 M - 1).long()] - 1
            hi_b = torch.where(allowed > 0, hi_b, -1)

        # ---- lane gates -------------------------------------------------
        nonpre_b = ~g.preemptible[gsafe_b]
        gate_np_b = _ancestor_gate(q.parent, q_b, num_levels, qan, q.quota,
                                   lane_req)
        gate_b = torch.where(nonpre_b, gate_np_b, True)
        gate_b = gate_b & cand_valid & (K_raw <= hi_b) & ~insufficient_b

        # ---- pod -> lane assignment + per-lane freed pools (K8) ---------
        live0 = cand0 & (unit_rank > c[pod_leaf])
        if reclaim:
            may = (q_b[None, :] != qidx[:, None]) & cand_valid[None, :]
            nxt = torch.where(may, lanes[None, :], B)
            next_ok = torch.flip(torch.cummin(torch.flip(nxt, (1,)), 1)
                                 .values, (1,))
            next_ok = torch.cat([next_ok, torch.full(
                (Q, 1), B, dtype=i32, device=dev)], 1)
            lane0 = _searchsorted(K_b, unit_rank)
            lane_of_pod = torch.where(
                live0, next_ok[pod_leaf, torch.clamp(lane0, max=B).long()], B)
        else:
            K_wm = torch.where(
                same_q_b & (lanes_l[None, :] <= lanes_l[:, None])
                & cand_valid[None, :], K_raw[None, :], -1).amax(1)
            cand_lane = ((pod_leaf[:, None] == qbl[None, :])
                         & cand_valid[None, :]
                         & (K_wm[None, :] >= urank_safe[:, None]))
            lane_of_pod = torch.where(
                live0, torch.where(cand_lane, lanes[None, :], B).amin(1), B)
        lane_of_pod = lane_of_pod.to(i32)
        freed_n_b, freed_q_b, own_incr_b = freed_by_lane(
            state, lane_of_pod, B, chain, compose=not tb.sparse,
            pods=act.pods)
        extra_b = extra[None] + freed_n_b                        # [B, N, R]
        qa_eff_b = qa[None] - freed_q_b                          # [B, Q, R]
        if reclaim:
            gate_b = gate_b & _ancestor_gate_lanes(
                q.parent, q_b, num_levels, qa_eff_b, fair_share, lane_req)
        lead = cand_valid & (torch.cumsum(cand_valid.to(i32), 0) == 1)
        bias_b = W_OWN_FREED * own_incr_b.to(f32)
        if not reclaim:
            bias_b = torch.where(lead[:, None], 0.0, bias_b)
        # the affinity gates (ref :1349-1360): each lane's node mask (K12)
        # and the lanes deferred behind an earlier lane's marks
        dmask_b = n.valid
        if anti:
            dmask_b = affinity_mask(state, res.anti_used, dom_static,
                                    gsafe_b.to(i32),
                                    attract=pcfg.attract_groups)
            dup_b = anti_defer_lanes(state, gsafe_b, cand_valid)
            if pcfg.attract_groups:
                dup_b = dup_b | attract_defer_lanes(state, gsafe_b,
                                                    cand_valid, res.anti_used)

        # ---- every lane's placement: K2 one row per lane, K3 ------------
        ty_b = g.task_type[gsafe_b, 0].long()
        tables = type_tables(n, free, extra_b, g.type_req[ty_b],
                             g.type_selector[ty_b], g.type_class[ty_b],
                             pcfg.placement)
        qa2_b, qan2_b, nodes_b, pipe_b, _ = uniform_fill(
            gsafe_b.to(i32), torch.full((B, T), -1, dtype=i32, device=dev),
            torch.full((B,), T, dtype=i32, device=dev), qa_eff_b, qan,
            limit_eff_q, quota_eff_q, chain, act.lanes, tables, n.soft_scores,
            dmask_b, dense=pcfg.dense_feasibility,
            stride=max(1, N // max(1, pcfg.batch_size)), hoisted=False,
            rows=lanes, score_bias=bias_b)
        placed_b = nodes_b >= 0
        # the reference's legacy protocol: min_needed tasks placed
        succ_b = placed_b.sum(1, dtype=i32) >= g.min_needed[gsafe_b]
        if anti:
            # a deferred lane is conflict-rejected, never terminal (ref
            # :1389-1392, :1545, :1549)
            succ_b = succ_b & ~dup_b
        ok_pre = gate_b & succ_b
        okm = ok_pre[:, None, None]
        d_qa = torch.where(okm, qa2_b - qa_eff_b, 0.0)
        d_qan = torch.where(okm, qan2_b - qan[None], 0.0)
        cum_qa = cumsum_blocked(d_qa)
        cum_qan = cumsum_blocked(d_qan)
        req_b = g.task_req[gsafe_b, 0]                           # [B, R]

        if tb.sparse:
            # sparse accept: each claim against chunk-start capacity plus
            # the lane-prefix of the freed deltas at its node (K4)
            ent_ok = ok_pre[:, None] & placed_b
            nsafe_e = torch.where(ent_ok, nodes_b, N).reshape(-1)
            nsafe_e = torch.clamp(nsafe_e, max=N - 1).long()
            lane_e_l = torch.arange(B * T, device=dev) // T
            credit = cumsum_blocked(freed_n_b[:, nsafe_e])[
                lane_e_l, torch.arange(B * T, device=dev)]
            first_bad_cap, node_e, lane_e = sparse_accept(
                nodes_b, ent_ok, pipe_b, req_b, free,
                free + n.releasing + extra, N, credit=credit.contiguous())
            accept = lanes < first_bad_cap
            qa_comp = qa[None] - cumsum_blocked(freed_q_b) + cum_qa
            nsafe_bt = torch.where(ent_ok, nodes_b, N).long()
            cnt_bn = torch.zeros((B, N + 1), dtype=f32, device=dev)
            cnt_bn.scatter_add_(1, nsafe_bt, torch.ones(
                (B, T), dtype=f32, device=dev))
            leftover_b = ((freed_n_b - cnt_bn[:, :N, None] * req_b[:, None, :])
                          > EPS).flatten(1).any(1)
        else:
            # dense accept: the accepted lanes' free/bind deltas (rebuilt
            # from the placements) must fit the composed pools
            cnt = torch.zeros((B, N + 1), dtype=i32, device=dev)
            nidx = torch.where(placed_b, nodes_b, N).long()
            cnt.scatter_add_(1, nidx, placed_b.to(i32))
            bind_cnt = torch.zeros((B, N + 1), dtype=i32, device=dev)
            bind_cnt.scatter_add_(1, nidx, (placed_b & ~pipe_b).to(i32))
            free2_b = free[None] - cnt[:, :N, None].to(f32) * req_b[:, None, :]
            bind_b = bind_cnt[:, :N, None].to(f32) * req_b[:, None, :]
            d_free = torch.where(okm, free[None] - free2_b, 0.0)
            d_bind = torch.where(okm, bind_b, 0.0)
            cum_free_d = cumsum_blocked(d_free)
            cum_bind = cumsum_blocked(d_bind)
            rel_floor_b = -(n.releasing[None] + extra_b) - EPS
            ok_node = (free[None] - cum_free_d >= rel_floor_b).flatten(1).all(1)
            ok_bind = (cum_bind <= torch.clamp(free[None], min=0.0)
                       + EPS).flatten(1).all(1)
            accept = ok_node & ok_bind
            qa_comp = qa[None] - freed_q_b + cum_qa
            if not reclaim:
                own_n = freed_n_b - torch.cat(
                    [torch.zeros_like(freed_n_b[:1]), freed_n_b[:-1]])
                leftover_b = (own_n - d_free > EPS).flatten(1).any(1)
        ok_qa = ((qa_comp <= limit_eff_q[None] + EPS)
                 | (cum_qa <= EPS)).flatten(1).all(1)
        ok_qan = ((qan[None] + cum_qan <= quota_eff_q[None] + EPS)
                  | (cum_qan <= EPS)).flatten(1).all(1)
        accept = accept & ok_qa & ok_qan
        if reclaim:
            chain_b = chain[qbl]
            accept = accept & ((qa_comp <= fair_share[None] + EPS)
                               | ~chain_b[:, :, None]).flatten(1).all(1)

        # ---- strict accept prefix (ref :1494-1549) -----------------------
        fail_own = cand_valid & ~(ok_pre & accept)
        if reclaim:
            prev_lo = torch.zeros((B,), dtype=torch.bool, device=dev)
        else:
            # leftover demotion: lanes after the first accepted lane whose
            # victims free more than its claims retry next chunk
            lo_i = (ok_pre & accept & leftover_b).to(i32)
            prev_lo = (torch.cumsum(lo_i, 0, dtype=i32) - lo_i) > 0
        bad = fail_own | (cand_valid & prev_lo)
        bad_i = bad.to(i32)
        bad_cum = torch.cumsum(bad_i, 0, dtype=i32)
        take = cand_valid & (bad_cum == 0)
        demoted = cand_valid & prev_lo & ok_pre & accept
        # every chunk retires >= 1 lane: the leading lane's accept is
        # implied by ok_pre (the reference's termination invariant)
        first_bad = bad & ((bad_cum - bad_i) == 0)
        if tb.sparse:
            first_fail = first_bad & ~ok_pre & lead
        else:
            first_fail = first_bad & ~ok_pre & ~prev_lo
        if anti:
            first_fail = first_fail & ~dup_b
        any_take = take.any()
        star = torch.argmax(torch.where(take, lanes, -1)).reshape(1)
        victims = (lane_of_pod <= star) & any_take
        if reclaim:
            M_v = torch.where(take[None, :] & may, K_b[None, :], -1).amax(1)
        else:
            M_v = torch.full((Q + 1,), -1, dtype=i32, device=dev)
            M_v = M_v.scatter_reduce(
                0, torch.where(cand_valid, q_b, Q).long(),
                torch.where(take & cand_valid, K_wm, -1).to(i32),
                reduce="amax")[:Q]
        c = torch.maximum(c, M_v)

        # ---- commit -----------------------------------------------------
        w = take.to(f32)
        if tb.sparse:
            le = lane_e.long()
            take_e = take[le] & ent_ok.reshape(-1)
            upd = torch.zeros((N + 1, R_), dtype=f32, device=dev)
            upd.index_add_(0, node_e.long(),
                           torch.where(take_e[:, None], req_b[le], 0.0))
            new_free = free - upd[:N]
            new_extra = extra + _lane_sum(w, freed_n_b)
            new_qa = (qa - _lane_sum(w, freed_q_b)) + _lane_sum(w, d_qa)
        else:
            new_free = free - _lane_sum(w, d_free)
            new_extra = torch.where(any_take, extra_b[star][0], extra)
            new_qa = (torch.where(any_take, qa_eff_b[star][0], qa)
                      + _lane_sum(w, d_qa))
        res = dataclasses.replace(
            res, free=new_free, releasing_extra=new_extra,
            queue_allocated=new_qa,
            queue_allocated_nonpreemptible=qan + _lane_sum(w, d_qan),
            victim=res.victim | victims)
        if anti:
            # taken lanes claim their placements' domains (ref :1628-1631)
            anti_mark(state, res.anti_used, dom_static, gsafe_b.to(i32),
                      torch.where(take[:, None], nodes_b, -1), take)
        tk = take[:, None]
        placements[cand_g] = torch.where(tk, nodes_b, placements[cand_g])
        placement_device[cand_g] = torch.where(tk, -1,
                                               placement_device[cand_g])
        pipelined[cand_g] = torch.where(tk, pipe_b, pipelined[cand_g])
        allocated[cand_g] = allocated[cand_g] | take
        attempted[cand_g] = attempted[cand_g] | take | first_fail
        fit_reason[cand_g] = torch.where(first_fail, 3, fit_reason[cand_g])
        wstats[row].add_(torch.stack([
            one, cand_valid.sum(dtype=i32), one * B, one * 0,
            demoted.sum(dtype=i32)]))
        done_b = take | first_fail
        remaining[cand_g] = remaining[cand_g] & ~done_b
        if depth is not None:
            q_att = q_att.index_add(0, qbl, done_b.to(i32))
            remaining[:G] = remaining[:G] & (q_att[gql] < depth)
        if reclaim:
            # live strategy-viability drop (see the sequential path)
            qa_l = res.queue_allocated
            under_g = _ancestor_gate(q.parent, gq, num_levels, qa_l, q.quota,
                                     task_req_g)
            lqs = torch.clamp(lq_tab, min=0).long()
            no_lq = lq_tab < 0
            over_fs_vc = no_lq | (qa_l[lqs] > fair_share[lqs] + EPS).any(-1)
            over_qt_vc = no_lq | (qa_l[lqs] > quota_eff_q[lqs] + EPS).any(-1)
            has_v = (cnt_q > 0)[:, None] & (qidx[:, None] != qidx[None, :])
            ev_fs_c = (has_v & over_fs_vc).any(0)
            ev_qt_c = (has_v & over_qt_vc).any(0)
            remaining[:G] = remaining[:G] & (ev_fs_c[gql]
                                             | (under_g & ev_qt_c[gql]))
        fuel -= 1

    stats.syncs += 1
    delta = (wstats[row] - result.wavefront_stats[row]).tolist()
    stats.attempts += delta[1]
    stats.demotions += delta[4]
    stats.fallbacks += int(fell_back)
    return dataclasses.replace(
        res, placements=placements[:G], placement_device=placement_device[:G],
        pipelined=pipelined[:G], allocated=allocated[:G],
        attempted=attempted[:G], fit_reason=fit_reason[:G],
        wavefront_stats=wstats)


# ---------------------------------------------------------------------------
# the action
# ---------------------------------------------------------------------------

def check_placement_ported(placement: AllocateConfig) -> None:
    """Raise ``NotImplementedError`` naming the first placement setting the
    victim actions have not ported: on top of allocate's refusals, the
    per-task path, the device share table (their scenario solver and
    wavefront run the uniform whole-gang kernel only) and topology — the
    required and subgroup levels (the solver's per-lane domain pick, ref
    ``:1055-1076``; the dense wavefront has none) and the uniform path's
    preferred band.  The in-cycle affinity terms run on uniform
    snapshots."""
    for bad, what in (
            (not placement.uniform_tasks,
             "uniform_tasks=False (the per-task placement path)"),
            (placement.track_devices,
             "track_devices=True (device share table)"),
            (placement.subgroup_topology,
             "subgroup_topology=True (subgroup / required topology)"),
            (placement.uniform_tasks and placement.preferred_topology,
             "preferred_topology=True")):
        if bad:
            raise NotImplementedError(
                f"victim actions: {what} is not ported to the PyTorch "
                f"package yet")
    # dynamic_order is read only by the allocate loop
    check_supported(dataclasses.replace(placement, dynamic_order=True))


def _check_ported(mode: str, config: VictimConfig) -> None:
    if mode not in ("reclaim", "preempt", "consolidate"):
        raise ValueError(f"unknown victim action mode: {mode!r}")
    check_placement_ported(config.placement)


def run_victim_action(state: ClusterState, fair_share: Tensor,
                      result: AllocationResult, *, num_levels: int,
                      mode: str, config: VictimConfig = VictimConfig()
                      ) -> AllocationResult:
    """The reclaim / preempt / consolidation action (ref ``:1699``)."""
    return run_victim_action_counted(state, fair_share, result,
                                     num_levels=num_levels, mode=mode,
                                     config=config)[0]


def run_victim_action_counted(state: ClusterState, fair_share: Tensor,
                              result: AllocationResult, *, num_levels: int,
                              mode: str,
                              config: VictimConfig = VictimConfig()
                              ) -> tuple[AllocationResult, VictimStats]:
    """:func:`run_victim_action`, also returning its :class:`VictimStats`.

    Scans pending unallocated gangs in fairness order and solves victim
    scenarios for each; successful preemptors commit as pipelined
    placements (tasks on victims' releasing capacity) and consolidation
    victims get a planned node in ``victim_move``.  The device choice
    follows ``state``."""
    _check_ported(mode, config)
    g, q, r, n = state.gangs, state.queues, state.running, state.nodes
    G, Q = g.g, q.q
    dev = state.device
    i32 = torch.int32
    total = state.total_capacity
    depth = (config.queue_depth_preempt
             if mode == "preempt" and config.queue_depth_preempt is not None
             else config.queue_depth)
    stats = VictimStats()
    act = action_context(state, result, fair_share, num_levels=num_levels,
                         stats=stats)
    chain, quota_eff_q = act.chain, act.quota_eff
    gq = torch.clamp(g.queue, min=0)
    gql = gq.long()

    # ---- vectorized viability prefilter (ref :1844-1908) ----------------
    base = (r.valid & ~r.releasing & (r.node >= 0) & r.preemptible
            & (r.gang >= 0))
    rq = torch.where(base, r.queue, Q)
    cnt_q = _segment_sum_i32(base, rq, Q)
    total_cnt = cnt_q.sum(dtype=i32)
    if mode == "reclaim":
        has_cand = (total_cnt - cnt_q[gql]) > 0
    elif mode == "consolidate":
        own = _segment_sum_i32(base, torch.where(base, r.gang, G), G)
        has_cand = (total_cnt - own) > 0
    else:
        minprio = _segment_reduce(torch.where(base, r.priority, BIG), rq, Q,
                                  "amin", _I32_MAX)
        has_cand = minprio[gql] < g.priority
    tr = torch.where(g.task_valid[:, :, None], g.task_req, 0.0)
    task_req_g = torch.zeros_like(tr[:, 0])
    for t in range(g.t):
        task_req_g = task_req_g + tr[:, t]
    gate_np = _ancestor_gate(q.parent, gq, num_levels,
                             result.queue_allocated_nonpreemptible, q.quota,
                             task_req_g)
    viable = has_cand & torch.where(~g.preemptible, gate_np, True)
    if mode == "reclaim":
        # lower bound of future queue allocation: everything any
        # candidate could ever free, rolled up the chain
        freeable = freed_by_mask(state, base, chain, act.pods)[2]
        qa_lower = torch.clamp(result.queue_allocated - freeable, min=0.0)
        viable = viable & _ancestor_gate(q.parent, gq, num_levels, qa_lower,
                                         fair_share, task_req_g)
    elif mode == "consolidate":
        viable = viable & g.preemptible
        spare = torch.where(n.valid[:, None],
                            result.free + n.releasing
                            + result.releasing_extra, 0.0).sum(0)
        viable = viable & (task_req_g <= spare[None, :] + EPS).all(-1)
    remaining = g.valid & (g.backoff <= 0) & ~result.allocated & viable

    if mode == "reclaim":
        # [victim leaf, reclaimer leaf] leveled-queue table for the live
        # strategy-viability drop
        qidx = torch.arange(Q, dtype=i32, device=dev)
        lq_tab = _leveled_queue(chain, q.depth, qidx[:, None], qidx[None, :])
        lqs = torch.clamp(lq_tab, min=0).long()
        no_lq = lq_tab < 0
        diff = qidx[:, None] != qidx[None, :]
        has_v = (cnt_q > 0)[:, None] & diff

    if (config.batch_size > 1 and mode in ("reclaim", "preempt")
            and (mode != "reclaim" or config.chunk_reclaim)):
        return _run_victim_action_chunked(
            state, fair_share, result, num_levels=num_levels, mode=mode,
            config=config, remaining0=remaining, act=act,
            lq_tab=lq_tab if mode == "reclaim" else None, cnt_q=cnt_q,
            task_req_g=task_req_g), stats
    res = dataclasses.replace(result)
    q_att = torch.zeros((Q,), dtype=i32, device=dev)
    # the affinity gates (ref :1730-1757, :1798-1804): the preemptor's
    # node mask (K12, one lane) confines every scenario's placement; each
    # step claims a success's domains (K13)
    anti = config.placement.anti_groups
    if anti:
        dom_static = anti_domain_tables(state)
        res.anti_used = result.anti_used.clone()    # K13 marks this copy
        no_nodes = torch.full((1, g.t), -1, dtype=i32, device=dev)
    fuel = G
    while fuel > 0:
        gi_t = ordering.select_next_gang(g, q, res.queue_allocated,
                                         fair_share, total,
                                         remaining).reshape(1)
        runnable_t = (remaining[gi_t] & g.valid[gi_t]
                      & (g.backoff[gi_t] <= 0) & ~res.allocated[gi_t])
        any_rem, gi, runnable = torch.cat([
            t.to(torch.int64).reshape(1)
            for t in (remaining.any(), gi_t, runnable_t)]).tolist()
        stats.syncs += 1
        if not any_rem:
            break
        stats.steps += 1
        won = None
        gi_b = gi_t.to(i32)
        if runnable:
            dmask = None
            if anti:
                dmask = affinity_mask(
                    state, res.anti_used, dom_static, gi_b,
                    attract=config.placement.attract_groups)[0]
            won = solve_for_preemptor(state, gi, res, fair_share,
                                      num_levels=num_levels, mode=mode,
                                      config=config, act=act,
                                      domain_mask=dmask)
        if won is not None:
            (victims, nodes_t, pipe_t, moves, free2, dev2, extra2,
             extra_dev2, qa2, qan2, ext2, ext_extra2) = won
            placements = res.placements.clone()
            placements[gi] = nodes_t
            pipelined = res.pipelined.clone()
            pipelined[gi] = pipe_t
            victim_move = res.victim_move
            if moves is not None:
                victim_move = torch.where(moves >= 0, moves, victim_move)
            res = dataclasses.replace(
                res, free=free2, device_free=dev2, releasing_extra=extra2,
                device_releasing_extra=extra_dev2, extended_free=ext2,
                extended_releasing_extra=ext_extra2, queue_allocated=qa2,
                queue_allocated_nonpreemptible=qan2, placements=placements,
                placement_device=_set_row(res.placement_device, gi, -1),
                pipelined=pipelined,
                allocated=_set_row(res.allocated, gi, True),
                victim=res.victim | victims, victim_move=victim_move)
        if anti:
            # every step marks, as the reference's does: a failed one sets
            # only the junk cell
            ok = (torch.ones if won is not None else torch.zeros)(
                (1,), dtype=torch.bool, device=dev)
            anti_mark(state, res.anti_used, dom_static, gi_b,
                      no_nodes if won is None else won[1][None].contiguous(),
                      ok)
        if runnable:
            res = dataclasses.replace(
                res, attempted=_set_row(res.attempted, gi, True))
        remaining = _set_row(remaining, gi, False)
        if depth is not None:
            if runnable:
                q_att[gql[gi:gi + 1]] += 1
            remaining = remaining & (q_att[gql] < depth)
        if mode == "reclaim":
            # live strategy-viability drop: a (victim queue, reclaimer)
            # pair that stops being strategy-evictable never recovers
            # within the action
            qa_l = res.queue_allocated
            under_g = _ancestor_gate(q.parent, gq, num_levels, qa_l, q.quota,
                                     task_req_g)
            over_fs_vc = no_lq | (qa_l[lqs] > fair_share[lqs] + EPS).any(-1)
            over_qt_vc = no_lq | (qa_l[lqs] > quota_eff_q[lqs] + EPS).any(-1)
            ev_fs_c = (has_v & over_fs_vc).any(0)
            ev_qt_c = (has_v & over_qt_vc).any(0)
            remaining = remaining & (ev_fs_c[gql] | (under_g & ev_qt_c[gql]))
        fuel -= 1
    return res, stats


def _set_row(t: Tensor, i: int, value) -> Tensor:
    """``t`` with row ``i`` set to the scalar ``value`` (a copy; ``fill_``
    on the device, where an item assignment would copy the scalar from
    the host and wait)."""
    out = t.clone()
    out[i].fill_(value)
    return out
