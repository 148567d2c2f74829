"""Cycle driver — ``scheduler.go`` ``Scheduler.Run``/``runOnce`` rebuilt.

Port of ``kai_scheduler_tpu/framework/scheduler.py``, classic path: every
cycle opens a session (snapshot + fair-share division), runs the
configured actions over one commit set, gathers the packed commit with
one device→host copy, and writes BindRequests and evictions back to the
``Cluster`` (a consolidation-moved victim also gets its pipelined
rebind).  Actions register by name (ref ``actions/factory.go:31-37``):
``allocate``, ``consolidation``, ``reclaim``, ``preempt`` and
``stalegangeviction``.  The reference runs its built-in actions as one
fused program; here each action is its own host-driven loop over the same
commit set, in the configured order.  The incremental, resident,
analytics, repack, tracing, decision-event, leader-election and usage-DB
branches of the reference wait for later slices.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Protocol

import numpy as np

from ..apis import types as apis
from ..device import resolve_device
from ..ops.allocate import AllocationResult, allocate_counted, init_result
from ..ops.stale import stale_gang_eviction
from ..ops.victims import VictimStats, run_victim_action_counted
from ..runtime.cluster import Cluster
from .session import Session, SessionConfig


@dataclasses.dataclass
class CycleResult:
    """Everything one ``runOnce`` decided (the Statement commit set)."""

    bind_requests: list[apis.BindRequest] = dataclasses.field(
        default_factory=list)
    #: victims of reclaim / preempt / consolidation / stalegangeviction
    evictions: list[apis.Eviction] = dataclasses.field(default_factory=list)
    #: pipelined rebinds of consolidation-moved victims
    move_bind_requests: list[apis.BindRequest] = dataclasses.field(
        default_factory=list)
    #: the commit set threaded through the action pipeline
    tensors: AllocationResult | None = None
    #: action name -> wall seconds
    action_seconds: dict[str, float] = dataclasses.field(
        default_factory=dict)
    session_seconds: float = 0.0
    #: Session.open wall seconds (snapshot build, upload, DRF division)
    open_seconds: float = 0.0
    #: packed-commit gather + BindRequest decode + API writes
    commit_seconds: float = 0.0
    #: contiguous checkpoints partitioning the cycle: snapshot / upload /
    #: solve_dispatch / device_wait / host_decode / commit (the
    #: reference's keys; here ``upload`` is the snapshot's one
    #: host-to-device copy and ``solve_dispatch`` includes the device
    #: time of the actions, whose wavefront syncs once per chunk)
    phase_seconds: dict[str, float] = dataclasses.field(default_factory=dict)
    cycle_index: int = 0
    cycle_seed: int = 0
    #: the packed i16 commit that crossed device→host (the parity surface)
    packed: "np.ndarray | None" = None
    #: allocate wavefront chunks run this cycle
    chunks: int = 0
    #: per-task allocate lanes retried in the next domain this cycle, and
    #: the chunks whose retry launch had at least one such lane
    retries: int = 0
    retry_chunks: int = 0
    #: victim action name -> preemptor steps, scenario attempts and host
    #: syncs it made this cycle
    victim_stats: dict[str, VictimStats] = dataclasses.field(
        default_factory=dict)


def cycle_seed_for(seed: int, cycle_index: int) -> int:
    """Deterministic per-cycle seed: a splitmix64-style mix of the
    configured stream seed and the logical cycle index (wall-clock-free)."""
    mask = 0xFFFFFFFFFFFFFFFF
    x = (seed * 0x9E3779B97F4A7C15 + cycle_index + 1) & mask
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & mask
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & mask
    x ^= x >> 31
    return x & 0x7FFFFFFF


class Action(Protocol):
    """An action mutates the cycle's commit set."""

    def __call__(self, session: Session, result: CycleResult) -> None: ...


_ACTION_REGISTRY: dict[str, Callable[[], Action]] = {}


def register_action(name: str):
    """ref ``framework.RegisterAction`` (``actions/factory.go:31-37``)."""
    def deco(builder: Callable[[], Action]):
        _ACTION_REGISTRY[name] = builder
        return builder
    return deco


def action_names() -> list[str]:
    return list(_ACTION_REGISTRY)


@register_action("allocate")
def _allocate_action() -> Action:
    def run(session: Session, result: CycleResult) -> None:
        result.tensors, counts = allocate_counted(
            session.state, session.state.queues.fair_share,
            num_levels=session.config.num_levels,
            config=session.config.allocate, init=result.tensors)
        result.chunks += counts.chunks
        result.retries += counts.retries
        result.retry_chunks += counts.retry_chunks
    return run


def _victim_action(mode: str) -> Action:
    def run(session: Session, result: CycleResult) -> None:
        name = "consolidation" if mode == "consolidate" else mode
        result.tensors, stats = run_victim_action_counted(
            session.state, session.state.queues.fair_share, result.tensors,
            num_levels=session.config.num_levels, mode=mode,
            config=session.config.victims)
        result.victim_stats[name] = stats
    return run


@register_action("reclaim")
def _reclaim_action() -> Action:
    """Cross-queue fairness enforcement — ref ``actions/reclaim``."""
    return _victim_action("reclaim")


@register_action("preempt")
def _preempt_action() -> Action:
    """Intra-queue priority preemption — ref ``actions/preempt``."""
    return _victim_action("preempt")


@register_action("consolidation")
def _consolidation_action() -> Action:
    """Evict-and-reallocate defragmentation — ref
    ``actions/consolidation`` (every victim must be re-placed; see
    ``victim_move``)."""
    return _victim_action("consolidate")


@register_action("stalegangeviction")
def _stale_action() -> Action:
    """Evict gangs below minMember past grace — ref
    ``actions/stalegangeviction``."""
    def run(session: Session, result: CycleResult) -> None:
        result.tensors = stale_gang_eviction(
            session.state, result.tensors,
            grace_s=session.config.stale_grace_s,
            num_levels=session.config.num_levels)
    return run


#: the reference's default action pipeline (``conf_util/
#: scheduler_conf_util.go:37``)
DEFAULT_ACTIONS = ("allocate", "consolidation", "reclaim", "preempt",
                   "stalegangeviction")


@dataclasses.dataclass
class SchedulerConfig:
    """ref ``conf/scheduler_conf.go:49-62`` — this slice's fields.

    The default action list is the reference's :data:`DEFAULT_ACTIONS`,
    at the reference's default ``VictimConfig``: reclaim and preempt run
    the chunked victim wavefront (``batch_size=64``; preempt's width
    auto-tuned per snapshot), consolidation the sequential engine.
    ``SessionConfig(victims=VictimConfig(batch_size=1))`` runs reclaim and
    preempt sequentially too."""

    actions: tuple[str, ...] = DEFAULT_ACTIONS
    session: SessionConfig = dataclasses.field(default_factory=SessionConfig)
    #: determinism seed: each cycle derives ``cycle_seed_for(seed, index)``
    seed: int = 0


class Scheduler:
    """The cycle driver, on ``device`` (default ``"cuda"``; raises when no
    CUDA device is present unless ``device="cpu"`` is asked for)."""

    def __init__(self, config: SchedulerConfig | None = None, *,
                 device="cuda"):
        self.config = config or SchedulerConfig()
        self.device = resolve_device(device)
        unknown = [a for a in self.config.actions
                   if a not in _ACTION_REGISTRY]
        if unknown:
            raise NotImplementedError(
                f"actions {unknown} are not ported yet; available: "
                f"{action_names()}")
        self._actions = [(name, _ACTION_REGISTRY[name]())
                         for name in self.config.actions]
        self._cycle_index = 0
        #: cycle-side view of fit-failure counts (see _record_fit_status),
        #: scoped to one cluster document
        self._fit_shadow: dict[str, int] = {}
        self._fit_shadow_cluster = None

    def run_once(self, cluster: Cluster) -> CycleResult:
        """One scheduling cycle: snapshot → actions → commit set."""
        t0 = time.perf_counter()
        session = Session.open(
            *cluster.snapshot_lists(), config=self.config.session,
            device=self.device, now=cluster.now,
            resource_claims=cluster.resource_claims,
            device_classes=cluster.device_classes,
            volume_claims=cluster.volume_claims,
            storage_classes=cluster.storage_classes)
        upload_s = session.index.upload_seconds
        t_open = time.perf_counter()
        open_s = t_open - t0
        result = CycleResult()
        result.cycle_index = self._cycle_index
        result.cycle_seed = cycle_seed_for(self.config.seed,
                                           self._cycle_index)
        self._cycle_index += 1
        result.tensors = init_result(session.state)
        result.open_seconds = open_s
        for name, action in self._actions:
            ta = time.perf_counter()
            action(session, result)
            result.action_seconds[name] = time.perf_counter() - ta
        t_solve = time.perf_counter()
        host = session.gather_host(result.tensors)
        result.packed = host["packed"]
        t_gather = time.perf_counter()
        result.bind_requests = session.bind_requests_from(
            result.tensors, host=host)
        result.evictions = session.evictions_from(host)
        t_decode = time.perf_counter()
        for br in result.bind_requests:
            cluster.create_bind_request(br)
        for ev in result.evictions:
            # moved victims restart and get a pipelined rebind on their
            # verified target node — evicted, not lost
            cluster.evict_pod(ev.pod_name, restart=ev.move_to is not None)
            if ev.move_to is not None:
                rebind = session.pipelined_rebind(cluster, ev)
                if rebind is not None:
                    result.move_bind_requests.append(rebind)
                    cluster.create_bind_request(rebind)
        result.commit_seconds = time.perf_counter() - t_solve
        self._record_fit_status(cluster, session, host)
        t_end = time.perf_counter()
        result.phase_seconds = {
            "snapshot": max(0.0, open_s - upload_s),
            "upload": upload_s,
            "solve_dispatch": t_solve - t_open,
            "device_wait": t_gather - t_solve,
            "host_decode": t_decode - t_gather,
            "commit": t_end - t_decode,
        }
        result.session_seconds = time.perf_counter() - t0
        return result

    def _record_fit_status(self, cluster: Cluster, session: Session,
                           host: dict) -> None:
        """Write fit failures back to PodGroup status — the
        status_updater's UnschedulableOnNodePool marking (inline writes;
        the reference's async worker pool waits for a later slice)."""
        allocated = host["allocated"]
        explanations = session.unschedulable_explanations(host)
        names = session.index.gang_names
        if (self._fit_shadow_cluster is None
                or self._fit_shadow_cluster() is not cluster):
            self._fit_shadow.clear()
            self._fit_shadow_cluster = weakref.ref(cluster)
        shadow = self._fit_shadow
        for gi in np.nonzero(allocated[:len(names)])[0]:
            group = cluster.pod_groups.get(names[gi])
            if group is None:
                continue
            had = shadow.get(names[gi])
            if had or group.fit_failures or group.unschedulable:
                shadow[names[gi]] = 0
                group.unschedulable = False
                group.unschedulable_reason = ""
                group.fit_failures = 0
        for name, reason in explanations.items():
            group = cluster.pod_groups.get(name)
            if group is None:
                continue
            failures = shadow.get(name, group.fit_failures) + 1
            shadow[name] = failures
            group.fit_failures = failures
            group.unschedulable_reason = reason
            if (group.scheduling_backoff >= 1
                    and failures >= group.scheduling_backoff):
                group.phase = apis.PodGroupPhase.UNSCHEDULABLE
                group.unschedulable = True
