"""stalegangeviction — evict gangs that fell below minMember.

Port of ``kai_scheduler_tpu/ops/stale.py`` (ref
``actions/stalegangeviction/stalegangeviction.go:29-60``): a gang whose
active pod count dropped under ``minMember`` after it started gets a
staleness grace period (default 60 s); past it, every surviving pod of the
gang is evicted so the group can be rescheduled atomically.  The
snapshot carries per-gang ``stale_s`` and ``running_count``; the release
of the victims' resources is K6 (:func:`.victims.freed_by_mask`).
"""
from __future__ import annotations

import dataclasses

import torch

from ..state.cluster_state import ClusterState
from .allocate import AllocationResult, _chain_membership
from .victims import freed_by_mask


def stale_gangs(state: ClusterState, grace_s: float) -> torch.Tensor:
    """bool [G] — gangs to evict wholesale this cycle."""
    g = state.gangs
    return ((g.stale_s >= grace_s) & (g.running_count > 0)
            & (g.running_count < g.min_member))


def stale_gang_eviction(state: ClusterState, result: AllocationResult, *,
                        grace_s: float = 60.0,
                        num_levels: int = 2) -> AllocationResult:
    """Mark every surviving pod of a stale gang as a victim and return its
    resources to the commit set's releasing pool and queue accounting."""
    r = state.running
    G = state.gangs.g
    stale = stale_gangs(state, grace_s)
    gang_of_pod = torch.where(r.gang >= 0, r.gang, G)
    pod_stale = torch.cat([stale, stale.new_zeros((1,))])[
        torch.clamp(gang_of_pod, max=G).long()]
    victims = (r.valid & ~r.releasing & (r.node >= 0) & pod_stale
               & ~result.victim)
    chain = _chain_membership(state.queues.parent, num_levels)
    freed_nodes, freed_dev, freed_q, freed_q_np, freed_ext = freed_by_mask(
        state, victims, chain)
    # the evicted pods have not terminated: their capacity is releasing,
    # and tasks placed on it must pipeline
    return dataclasses.replace(
        result,
        victim=result.victim | victims,
        releasing_extra=result.releasing_extra + freed_nodes,
        device_releasing_extra=result.device_releasing_extra + freed_dev,
        extended_releasing_extra=(result.extended_releasing_extra
                                  + freed_ext),
        queue_allocated=torch.clamp(result.queue_allocated - freed_q,
                                    min=0.0),
        queue_allocated_nonpreemptible=torch.clamp(
            result.queue_allocated_nonpreemptible - freed_q_np, min=0.0),
    )
