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
commit set, in the configured order.

After the actions, an analytics cycle (every ``analytics_every`` cycles,
every cycle by default) runs the cluster-health pass over the snapshot
and the commit set (``ops/analytics.py``, kernel K14); the repack trigger
(``repack_enable``, on by default) fires after ``repack_trigger_cycles``
consecutive cycles whose fragmentation score exceeded
``repack_frag_threshold`` while a gang starves behind rack-stranded
capacity, and then solves a min-migration plan (``ops/repack.py``, K15
and K4) whose moves join the cycle's evictions and commit through the
pipelined rebind of consolidation moves.  The bundle and the plan ride
the one packed commit.  The incremental, resident, tracing, metrics,
decision-event (``starved`` events included), leader-election and
usage-DB branches of the reference wait for later slices.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Protocol

import numpy as np
import torch

from ..apis import types as apis
from ..device import resolve_device
from ..ops.allocate import AllocationResult, allocate_counted, init_result
from ..ops.analytics import cluster_analytics
from ..ops.repack import RepackConfig, plan_repack
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
    #: the cluster-health document (ops/analytics.py) — empty on cycles
    #: the analytics cadence skipped (``analytics_every``)
    analytics: dict = dataclasses.field(default_factory=dict)
    #: host seconds of the analytics dispatch (its device time lands in
    #: device_wait)
    analytics_seconds: float = 0.0
    #: the repack plan document (ops/repack.py) — empty on every cycle the
    #: trigger did not fire
    repack: dict = dataclasses.field(default_factory=dict)
    #: host seconds of the repack solve (0.0 when not fired)
    repack_seconds: float = 0.0


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
    #: run the cluster-health pass every K cycles (1 = every cycle, 0 =
    #: off); skipped cycles dispatch nothing and pack nothing extra
    analytics_every: int = 1
    #: pending age (cycles) the starvation document reports as its alarm
    #: level; 0 disables
    starvation_alarm_cycles: int = 32
    #: proactively migrate movable running pods to free a rack for a
    #: stranded rack-required gang (see the module doc); disabled =
    #: byte-identical commits to the repack-free scheduler
    repack_enable: bool = True
    #: fragmentation score above which a cycle counts toward the trigger
    #: streak
    repack_frag_threshold: float = 0.5
    #: consecutive high-fragmentation analytics cycles required to fire
    repack_trigger_cycles: int = 2
    #: cycles to wait after a firing (feasible or not) before the next
    repack_cooldown: int = 8
    #: per-firing migration cap and plan width; the effective budget is
    #: ``min(repack_max_migrations, VictimConfig.max_victim_pods)``; 0
    #: disables
    repack_max_migrations: int = 64


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
        #: name-keyed pending ages (cycles) and the repack trigger state,
        #: scoped to one cluster document (``_scope_ages``)
        self._pending_age: dict[str, int] = {}
        self._age_cluster = None
        self._frag_streak = 0
        self._repack_cooldown = 0
        self._repack_watch: dict[str, int] = {}
        self._last_analytics: dict = {}
        self._last_repack: dict = {}

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
        every = self.config.analytics_every
        run_analytics = every > 0 and self._cycle_index % every == 0
        self._cycle_index += 1
        result.tensors = init_result(session.state)
        result.open_seconds = open_s
        for name, action in self._actions:
            ta = time.perf_counter()
            action(session, result)
            result.action_seconds[name] = time.perf_counter() - ta
        bundle = None
        ages = None
        if run_analytics:
            ta = time.perf_counter()
            ages = self._pending_age_vector(cluster, session)
            bundle = cluster_analytics(session.state, result.tensors, ages,
                                       config=session.config.analytics)
            result.analytics_seconds = time.perf_counter() - ta
        repack_plan = None
        if self._repack_trigger(cluster, session):
            ta = time.perf_counter()
            if ages is None:
                ages = self._pending_age_vector(cluster, session)
            # destinations draw on the post-decision idle pool, so a move
            # never lands on capacity this cycle's placements took
            repack_plan = plan_repack(
                session.state, ages, result.tensors.free,
                config=RepackConfig(
                    analytics=session.config.analytics,
                    max_migrations=min(
                        self.config.repack_max_migrations,
                        session.config.victims.max_victim_pods)))
            result.repack_seconds = time.perf_counter() - ta
        t_solve = time.perf_counter()
        host = session.gather_host(result.tensors, analytics=bundle,
                                   repack_plan=repack_plan)
        result.packed = host["packed"]
        t_gather = time.perf_counter()
        result.bind_requests = session.bind_requests_from(
            result.tensors, host=host)
        result.evictions = session.evictions_from(host)
        plan_host = host.get("repack_plan")
        if plan_host is not None:
            tg = int(plan_host["target_gang"])
            names = session.index.gang_names
            target = names[tg] if 0 <= tg < len(names) else ""
            repack_evs = session.repack_evictions(plan_host, host, target)
            # repack migrations join the one eviction list: the commit
            # below moves them like consolidation victims
            result.evictions = result.evictions + repack_evs
            self._record_repack(plan_host, repack_evs, target, result)
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
        self._advance_starvation(cluster, session, host)
        if host.get("analytics") is not None:
            result.analytics = session.analytics_doc(
                host, alarm_cycles=self.config.starvation_alarm_cycles)
            self._last_analytics = result.analytics
            # the repack trigger streak: consecutive analytics cycles with
            # the fragmentation score above threshold
            score = float(host["analytics"]["frag_score"])
            self._frag_streak = (
                self._frag_streak + 1
                if score > self.config.repack_frag_threshold else 0)
        if self._repack_watch:
            self._watch_repack_unblocks(session, host)
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

    # -- analytics and repack ---------------------------------------------

    @property
    def last_analytics(self) -> dict:
        """The most recent cluster-health document (empty before the first
        analytics cycle); published documents are never mutated."""
        return self._last_analytics

    def _scope_ages(self, cluster: Cluster) -> None:
        """Reset the pending ages — and the repack trigger state derived
        from them — when the Scheduler is pointed at a different cluster
        document."""
        if (self._age_cluster is None
                or self._age_cluster() is not cluster):
            self._pending_age.clear()
            self._frag_streak = 0
            self._repack_cooldown = 0
            self._repack_watch.clear()
            self._last_analytics = {}
            self._age_cluster = weakref.ref(cluster)

    def _repack_trigger(self, cluster: Cluster, session: Session) -> bool:
        """The host-side repack gate (no device work): the fragmentation
        score was high for ``repack_trigger_cycles`` consecutive analytics
        cycles, the last document shows a starving gang and a
        cluster-feasible but rack-stranded ladder rung, the snapshot has
        required topology, and no cooldown runs."""
        cfg = self.config
        self._scope_ages(cluster)
        if (not cfg.repack_enable or cfg.repack_max_migrations <= 0
                or cfg.analytics_every <= 0):
            return False
        if self._repack_cooldown > 0:
            self._repack_cooldown -= 1
            return False
        if self._frag_streak < max(cfg.repack_trigger_cycles, 1):
            return False
        if not session.index.has_required_topology:
            return False
        doc = self._last_analytics
        if not doc:
            return False
        ladder = doc.get("fragmentation", {}).get("gang_ladder", ())
        stranded = any(r["cluster_feasible"] and not r["rack_placeable"]
                       for r in ladder)
        starving = bool(doc.get("starvation", {}).get("oldest"))
        return stranded and starving

    def _record_repack(self, plan: dict, executed: list, target: str,
                       result: CycleResult) -> None:
        """Account one repack firing: the cooldown, the unblock watch and
        the immutable plan document."""
        cfg = self.config
        # the cooldown applies whether or not the plan was feasible: an
        # infeasible instance stays infeasible until the cluster changes
        self._repack_cooldown = max(cfg.repack_cooldown, 0)
        if executed and target:
            # +2: _watch_repack_unblocks decrements the entry later in this
            # same (firing) cycle
            self._repack_watch[target] = max(cfg.repack_cooldown, 0) + 2
        doc = {
            "feasible": bool(plan["feasible"]),
            "target_gang": target,
            "target_rack": int(plan["target_rack"]),
            "needed_unit_pods": float(plan["needed"]),
            "rack_units_before": float(plan["rack_units_before"]),
            "rack_units_after": float(plan["rack_units_after"]),
            "total_unit_pods": float(plan["total_units"]),
            "migrations_planned": int(plan["num_moves"]),
            "migrations_executed": len(executed),
            "solve_seconds": result.repack_seconds,
            "moves": [{"pod": ev.pod_name, "to": ev.move_to}
                      for ev in executed],
        }
        result.repack = doc
        self._last_repack = doc

    def _watch_repack_unblocks(self, session: Session, host: dict) -> None:
        """Drop a firing's target from the watch once it places, or when
        its observation window ends."""
        names = session.index.gang_names
        allocated = host["allocated"]
        for nm in list(self._repack_watch):
            try:
                gi = names.index(nm)
            except ValueError:
                gi = -1
            if 0 <= gi < len(allocated) and allocated[gi]:
                del self._repack_watch[nm]
                continue
            self._repack_watch[nm] -= 1
            if self._repack_watch[nm] <= 0:
                del self._repack_watch[nm]

    @property
    def last_repack(self) -> dict:
        """The most recent repack firing's plan document (empty before the
        first firing)."""
        return self._last_repack

    def repack_status(self) -> dict:
        """The trigger's knobs, its live state and the last firing's plan
        document."""
        cfg = self.config
        return {
            "ok": bool(self._last_repack),
            "enabled": cfg.repack_enable,
            "frag_threshold": cfg.repack_frag_threshold,
            "trigger_cycles": cfg.repack_trigger_cycles,
            "cooldown_cycles": cfg.repack_cooldown,
            "max_migrations": cfg.repack_max_migrations,
            "frag_high_streak": self._frag_streak,
            "cooldown_remaining": self._repack_cooldown,
            "last": self._last_repack,
        }

    def _pending_age_vector(self, cluster: Cluster,
                            session: Session) -> torch.Tensor:
        """f32 [G] on the snapshot's device — each gang slot's pending age
        BEFORE this cycle, from the name-keyed counters the host keeps
        (``_advance_starvation`` advances them after decode)."""
        self._scope_ages(cluster)
        ages = np.zeros((session.state.gangs.g,), np.float32)
        if self._pending_age:
            names = session.index.gang_names
            valid = session.index.host_tables["gang_valid"]
            for gi in np.nonzero(valid[:len(names)])[0].tolist():
                a = self._pending_age.get(names[gi])
                if a:
                    ages[gi] = a
        return torch.from_numpy(ages).to(session.state.device)

    def _advance_starvation(self, cluster: Cluster, session: Session,
                            host: dict) -> None:
        """Advance the pending ages from this cycle's outcome: +1 for a
        gang still pending, reset on placement or exit."""
        if (self.config.starvation_alarm_cycles <= 0
                and self.config.analytics_every <= 0):
            return
        self._scope_ages(cluster)
        names = session.index.gang_names
        valid = host["gang_valid"][:len(names)]
        alloc = host["allocated"][:len(names)]
        old = self._pending_age
        self._pending_age = {
            names[gi]: old.get(names[gi], 0) + 1
            for gi in np.nonzero(valid & ~alloc)[0].tolist()}
