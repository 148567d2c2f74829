"""Hierarchical DRF fair-share division — the proportion plugin's core math.

Port of ``kai_scheduler_tpu/ops/drf.py`` (itself a rebuild of
``plugins/proportion/resource_division/resource_division.go``):

1. **Deserved pass** — every queue gets ``min(deserved, requestable)``.
2. **Over-quota pass** — the surplus is divided among still-unsatisfied
   queues, highest priority tier first; within a tier an iterative
   water-fill hands each queue ``remaining * shareWeight_i /
   sum(shareWeight)``, flooring unsatisfied queues to whole units per
   round.
3. **Remainder pass** — leftover whole units go one per queue, ordered by
   priority, then largest fractional remainder, then creation order.

Hierarchy is handled level by level: a parent's fair share becomes the
segment total for dividing among its children.

One level's division (``_divide_one_resource`` under the reference's
``vmap`` over resources) is **kernel K1**, ``csrc/drf_water_fill.cu``:
one launch per level, one block per resource, both ``while_loop`` s on
the device.  :func:`divide_level_plain` is its plain PyTorch version,
batched over resources; the wrapper :func:`drf_water_fill` runs it only
for CPU tensors.  Both take every segment sum in ascending queue index
from 0 — the order of the reference's ``segment_sum`` scatter — so the
f32 result is bit-identical to the reference's.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..apis.types import UNLIMITED
from ..state.cluster_state import ClusterState, QueueState

Tensor = torch.Tensor
_INT_MIN = -2 ** 31
#: most queues one block holds (one thread per queue); K1 raises above
MAX_QUEUES = 1024


def divide_level_limits(Q: int) -> None:
    """Raise ``NotImplementedError`` naming the limit K1's kernel does not
    take: more than ``MAX_QUEUES`` queues."""
    if Q > MAX_QUEUES:
        raise NotImplementedError(
            f"drf_water_fill: {Q} queues exceed the kernel's "
            f"MAX_QUEUES={MAX_QUEUES}")


def _segment_sum(values: Tensor, seg: Tensor, num_segments: int) -> Tensor:
    """``segment_sum`` over the queue axis [Q, ...] with each segment
    summed sequentially in ascending queue index, starting from 0."""
    out = torch.zeros((num_segments,) + values.shape[1:],
                      dtype=values.dtype, device=values.device)
    for q in range(values.shape[0]):
        out.index_add_(0, seg[q:q + 1], values[q:q + 1])
    return out


def _segment_max(values: Tensor, seg: Tensor, num_segments: int) -> Tensor:
    out = torch.full((num_segments,) + values.shape[1:], _INT_MIN,
                     dtype=values.dtype, device=values.device)
    idx = seg.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce(0, idx, values, reduce="amax")


def divide_level_plain(seg_total: Tensor, quota: Tensor, weight: Tensor,
                       limit: Tensor, request: Tensor, usage: Tensor,
                       priority: Tensor, seg: Tensor, creation: Tensor,
                       active: Tensor, k_value: Tensor,
                       rounds: list | None = None) -> Tensor:
    """Plain PyTorch version of K1: fair share [Q, R] for every resource
    across all sibling segments at one level.  ``seg_total`` f32 [S, R];
    quota/weight/limit/request/usage f32 [Q, R]; priority/seg/creation
    i32 [Q]; active bool [Q]; ``k_value`` f32 [].  ``rounds``, when
    given, receives one entry per priority tier: the water-fill rounds
    that tier ran.

    Resources are a batch dimension; each ``while_loop`` of the reference
    runs while ANY resource still loops, and a resource whose loop ended
    keeps its carry — the reference's ``vmap`` semantics."""
    S = seg_total.shape[0]
    Q, R_ = quota.shape
    segl = seg.long()
    q_total = seg_total[segl]
    unl = limit <= UNLIMITED + 0.5
    requestable = torch.where(unl, request, torch.minimum(request, limit))
    requestable = torch.clamp(requestable, min=0.0)
    deserved = torch.where(quota <= UNLIMITED + 0.5, q_total, quota)
    act = active[:, None].expand(Q, R_)
    prio = priority[:, None].expand(Q, R_)

    # -- pass 1: deserved ---------------------------------------------------
    fs = torch.where(act, torch.minimum(deserved, requestable), 0.0)
    remaining = torch.clamp(seg_total - _segment_sum(fs, segl, S), min=0.0)

    def unsatisfied(fs):
        sat = (request <= fs) | (~unl & (limit <= fs))
        return act & ~sat

    # -- pass 2: over-quota by priority tier --------------------------------
    rem_frac = torch.zeros_like(fs)
    processed = torch.zeros_like(act)
    while True:
        cand = unsatisfied(fs) & (weight > 0) & ~processed
        run = (cand & (remaining[segl] > 0)).any(0)              # [R]
        if not bool(run.any()):
            break
        pr = torch.where(cand, prio, _INT_MIN)
        cur_p = _segment_max(pr, segl, S)
        tier = cand & (prio == cur_p[segl])
        f_fs, f_rem, f_rf = fs, remaining, rem_frac
        again = torch.ones((R_,), dtype=torch.bool, device=fs.device)
        fill_rounds = 0
        while bool(again.any()):
            fill_rounds += 1
            unsat = unsatisfied(f_fs) & tier
            remreq = torch.where(
                unsat, torch.clamp(requestable - f_fs, min=0.0), 0.0)
            wants = unsat & (remreq > 0)
            tot_w = _segment_sum(torch.where(wants, weight, 0.0), segl, S)
            n_w = torch.where(
                wants & (tot_w[segl] > 0),
                weight / torch.clamp(tot_w[segl], min=1e-30), 0.0)
            share_w = torch.clamp(n_w + k_value * (n_w - usage),
                                  min=0.0) * wants
            sum_w = _segment_sum(share_w, segl, S)
            ok = wants & (sum_w[segl] > 0)
            fair = torch.where(
                ok, f_rem[segl] * share_w
                / torch.clamp(sum_w[segl], min=1e-30), 0.0)
            sat_now = remreq <= fair
            give = torch.where(
                ok, torch.where(sat_now, remreq, torch.floor(fair)), 0.0)
            new_rem = torch.where(ok & ~sat_now, fair - torch.floor(fair),
                                  0.0)
            n_rf = torch.where(
                ok, new_rem, torch.where(tier & sat_now, 0.0, f_rf))
            n_fs = f_fs + give
            gave = _segment_sum(give, segl, S)
            n_rem = torch.clamp(f_rem - gave, min=0.0)
            freed = _segment_sum(
                torch.where(ok & sat_now & (remreq < fair), 1.0, 0.0),
                segl, S)
            n_again = ((freed > 0) & (n_rem > 0) & (gave > 0)).any(0)
            f_fs = torch.where(again[None], n_fs, f_fs)
            f_rem = torch.where(again[None], n_rem, f_rem)
            f_rf = torch.where(again[None], n_rf, f_rf)
            again = again & n_again
        if rounds is not None:
            rounds.append(fill_rounds)
        fs = torch.where(run[None], f_fs, fs)
        remaining = torch.where(run[None], f_rem, remaining)
        rem_frac = torch.where(run[None], f_rf, rem_frac)
        processed = torch.where(run[None], processed | tier, processed)

    # -- pass 3: whole-unit remainders ---------------------------------------
    has_rem = act & (rem_frac > 0)                               # [Q, R]
    same_seg = (segl[:, None] == segl[None, :])[..., None]       # [Q, Q, 1]
    pi, pj = priority[:, None, None], priority[None, :, None]
    ri, rj = rem_frac[:, None, :], rem_frac[None, :, :]
    ci, cj = creation[:, None, None], creation[None, :, None]
    j_before_i = ((pj > pi) | ((pj == pi) & (rj > ri))
                  | ((pj == pi) & (rj == ri) & (cj < ci)))
    rank = (same_seg & has_rem[None, :, :] & j_before_i).sum(
        1, dtype=torch.int32)
    give3 = torch.where(
        has_rem,
        torch.clamp(remaining[segl] - rank.to(torch.float32), 0.0, 1.0),
        0.0)
    return fs + give3


def drf_water_fill(seg_total: Tensor, quota: Tensor, weight: Tensor,
                   limit: Tensor, request: Tensor, usage: Tensor,
                   priority: Tensor, seg: Tensor, creation: Tensor,
                   active: Tensor, k_value: Tensor
                   ) -> tuple[Tensor, Tensor | None]:
    """One hierarchy level's division for every resource — K1.

    Returns ``(fair_share [Q, R], overrun)``.  CPU tensors run
    :func:`divide_level_plain` (``overrun`` None); CUDA tensors launch the
    kernel (one block per resource) or raise, and ``overrun`` i32 [R] is
    nonzero for a resource whose loops hit the kernel's iteration cap
    (read it after the launch; it costs a sync)."""
    if not kernels.on_card(seg_total):
        return divide_level_plain(seg_total, quota, weight, limit, request,
                                  usage, priority, seg, creation, active,
                                  k_value), None
    Q, R_ = quota.shape
    if seg_total.shape != (Q + 1, R_):
        raise ValueError(f"seg_total {tuple(seg_total.shape)} is not "
                         f"[{Q + 1}, {R_}]")
    divide_level_limits(Q)
    f32, i32 = torch.float32, torch.int32
    ts = dict(seg_total=seg_total, quota=quota, weight=weight, limit=limit,
              request=request, usage=usage, priority=priority, seg=seg,
              creation=creation, active=active)
    dev = kernels.require_cuda("drf_water_fill", ts, dict(
        seg_total=f32, quota=f32, weight=f32, limit=f32, request=f32,
        usage=f32, priority=i32, seg=i32, creation=i32,
        active=torch.bool))
    for key in ("quota", "weight", "limit", "request", "usage"):
        if ts[key].shape != (Q, R_):
            raise ValueError(f"drf_water_fill: {key} is not [{Q}, {R_}]")
    fs = torch.empty((Q, R_), dtype=f32, device=dev)
    err = torch.empty((R_,), dtype=i32, device=dev)
    lib = kernels.library()
    rc = lib.kai_drf_level(
        *(kernels.ptr(ts[k]) for k in (
            "seg_total", "quota", "weight", "limit", "request", "usage",
            "priority", "seg", "creation", "active")),
        float(k_value), Q, R_, kernels.ptr(fs), kernels.ptr(err),
        kernels.stream_of(fs))
    kernels.check(rc, "drf_water_fill")
    kernels.count_launch("drf_water_fill")
    return fs, err


def divide_level(queues: QueueState, seg_total: Tensor, level_mask: Tensor,
                 k_value: Tensor) -> tuple[Tensor, Tensor | None]:
    """Run the three-pass division for every resource at one level
    (returns K1's ``(fair_share, overrun)``)."""
    seg = torch.where(queues.parent >= 0, queues.parent + 1, 0).to(
        torch.int32)
    return drf_water_fill(
        seg_total.contiguous(), queues.quota, queues.over_quota_weight,
        queues.limit, queues.request, queues.usage, queues.priority, seg,
        queues.creation_order, level_mask.contiguous(), k_value)


def set_fair_share(state: ClusterState, *, num_levels: int,
                   k_value: float = 0.0) -> Tensor:
    """``fair_share [Q, R]`` for the whole hierarchy: level 0 divides the
    cluster total; level d divides each parent's fair share among its
    children (ref ``SetResourcesShare``, ``resource_division.go:26-41``).
    On CUDA, a loop that overran its iteration cap raises here."""
    q = state.queues
    k = torch.tensor(k_value, dtype=torch.float32)
    total = state.total_capacity
    fair_share = torch.zeros_like(q.quota)
    errs = []
    for depth in range(num_levels):
        seg_total = torch.cat([total[None, :], fair_share], dim=0)
        level_mask = q.valid & (q.depth == depth)
        fs_level, overrun = divide_level(q, seg_total, level_mask, k)
        if overrun is not None:
            errs.append(overrun)
        fair_share = torch.where(level_mask[:, None], fs_level, fair_share)
    if errs and int(torch.stack(errs).max()) != 0:
        raise RuntimeError("drf_water_fill: a water-fill loop overran its "
                           "iteration cap")
    return fair_share
