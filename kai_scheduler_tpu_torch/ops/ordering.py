"""Queue-of-queues job ordering — the two-level priority heap, tensorized.

Port of ``kai_scheduler_tpu/ops/ordering.py``.  The reference pops the
next job from a heap of queues ordered by the proportion plugin's
QueueOrderFn and, within a queue, by JobOrderFn
(``actions/utils/job_order_by_queue.go:38``).  Here the pop is a lexsort
over composite keys.

Queue tiers: under-fair-share first, under-quota first, higher priority,
smaller dominant share, older.  Job tiers within a queue: below-min-member
gangs first, higher priority, older.

``jnp.lexsort`` sorts by its LAST key first; :func:`lexsort` reproduces it
with stable sorts chained from the least significant key to the most
significant, on the same f32 key casts.
"""
from __future__ import annotations

import torch

from ..apis.types import UNLIMITED
from ..state.cluster_state import GangState, QueueState

Tensor = torch.Tensor
BIG = 1e30


def lexsort(keys) -> Tensor:
    """``jnp.lexsort(keys)``: the permutation sorting by ``keys[-1]``,
    then ``keys[-2]``, ... (stable: ties keep index order).  Float keys
    compare with -0.0 == 0.0, as the reference's sort does."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in keys:
        if k.is_floating_point():
            # -0.0 + 0.0 == +0.0: a radix sort (CUDA) would otherwise
            # order -0.0 before +0.0
            k = k + 0.0
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def queue_order_keys(queues: QueueState, queue_allocated: Tensor,
                     fair_share: Tensor, total: Tensor):
    """Per-queue comparison keys (smaller = schedule sooner): (over fair
    share, over quota, -priority, dominant share), each f32 [Q]."""
    eps = 1e-6
    over_fs = (queue_allocated > fair_share + eps).any(-1)
    quota_eff = torch.where(queues.quota <= UNLIMITED + 0.5, BIG,
                            queues.quota)
    over_quota = (queue_allocated > quota_eff + eps).any(-1)
    safe_total = torch.clamp(total, min=eps)
    dom_share = (queue_allocated / safe_total[None, :]).amax(-1)
    return (over_fs.to(torch.float32), over_quota.to(torch.float32),
            -queues.priority.to(torch.float32), dom_share)


def job_order_perm(gangs: GangState, queues: QueueState,
                   queue_allocated: Tensor, fair_share: Tensor,
                   total: Tensor, remaining: Tensor) -> Tensor:
    """Full gang permutation [G] by the two-level heap order, remaining
    gangs first."""
    over_fs, over_quota, neg_prio, dom_share = queue_order_keys(
        queues, queue_allocated, fair_share, total)
    qi = gangs.queue.long()
    not_rem = (~remaining).to(torch.float32)
    below_min = gangs.running_count < gangs.min_member
    return lexsort((
        gangs.creation_order.to(torch.float32),
        -gangs.priority.to(torch.float32),
        (~below_min).to(torch.float32),
        dom_share[qi],
        neg_prio[qi],
        over_quota[qi],
        over_fs[qi],
        not_rem,
    ))


def select_next_gang(gangs: GangState, queues: QueueState,
                     queue_allocated: Tensor, fair_share: Tensor,
                     total: Tensor, remaining: Tensor) -> Tensor:
    """Index of the next gang to attempt — one ``PopNextJob`` as a cascade
    of masked min-reductions (smallest-index tie-break)."""
    over_fs, over_quota, neg_prio, dom_share = queue_order_keys(
        queues, queue_allocated, fair_share, total)
    qi = gangs.queue.long()
    below_min = gangs.running_count < gangs.min_member
    keys = (
        (~remaining).to(torch.float32),
        over_fs[qi], over_quota[qi], neg_prio[qi], dom_share[qi],
        (~below_min).to(torch.float32),
        -gangs.priority.to(torch.float32),
        gangs.creation_order.to(torch.float32),
    )
    best = torch.ones_like(remaining)
    for k in keys:
        m = torch.where(best, k, float("inf")).amin()
        best = best & (k <= m)
    return torch.argmax(best.to(torch.int32))
