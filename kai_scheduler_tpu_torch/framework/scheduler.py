"""Cycle driver — ``scheduler.go`` ``Scheduler.Run``/``runOnce`` rebuilt.

Port of ``kai_scheduler_tpu/framework/scheduler.py``: every cycle takes
a snapshot, divides fair shares, runs the configured actions over one
commit set, gathers the packed commit with one device→host copy, and
writes BindRequests and evictions back to the ``Cluster`` (a
consolidation-moved victim also gets its pipelined rebind).  Actions
register by name (ref ``actions/factory.go:31-37``): ``allocate``,
``consolidation``, ``reclaim``, ``preempt`` and ``stalegangeviction``.

The snapshot, as in the reference's default configuration
(``incremental=True``), comes from the journaled incremental snapshotter
(``state/incremental.py``): it patches the previous cycle's host mirror
from the cluster's mutation journal and uploads only the changed leaves,
falling back to the full build whenever a patch cannot be proven
identical.  With ``resident=True`` a patched cycle uploads only a packed
journal delta and runs :func:`resident_cycle`: the delta written into the
device-resident snapshot in place (kernel K16), the fair-share division
(K1), the actions, the analytics pass (K14) and the commit pack, one host
composition over the resident state.  ``incremental=False`` builds the
whole snapshot every cycle (``Session.open``).

The actions run as one composition (:func:`run_actions`): the reference
fuses its built-in ones into one XLA program; here each action is its own
host-driven loop of kernel launches over the same commit set, in the
configured order.  A built-in action runs its body; an action registered
by a caller in place of a built-in one runs over the session instead.

After the actions, an analytics cycle (every ``analytics_every`` cycles,
every cycle by default) runs the cluster-health pass over the snapshot
and the commit set (``ops/analytics.py``, kernel K14); the repack trigger
(``repack_enable``, on by default) fires after ``repack_trigger_cycles``
consecutive cycles whose fragmentation score exceeded
``repack_frag_threshold`` while a gang starves behind rack-stranded
capacity, and then solves a min-migration plan (``ops/repack.py``, K15
and K4) whose moves join the cycle's evictions and commit through the
pipelined rebind of consolidation moves.  The bundle and the plan ride
the one packed commit (a resident cycle reads the plan back on its own).
Every upload goes through the transfer ledger, whose window closes into
``CycleResult.wire`` at the end of the cycle.  The tracing, metrics,
decision-event (``starved`` events included), leader-election, sharding
and usage-DB branches of the reference wait for later slices.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import weakref
from typing import Callable, Protocol

import numpy as np
import torch

from ..apis import types as apis
from ..device import resolve_device
from ..ops import drf
from ..ops import resident as resident_ops
from ..ops.allocate import AllocationResult, allocate_counted, init_result
from ..ops.analytics import cluster_analytics
from ..ops.repack import RepackConfig, plan_repack
from ..ops.stale import stale_gang_eviction
from ..ops.victims import VictimStats, run_victim_action_counted
from ..runtime import compile_watch
from ..runtime import wire_ledger as _wire
from ..runtime.cluster import Cluster
from ..state.incremental import IncrementalSnapshotter
from .session import Session, SessionConfig, _pack_commit


@dataclasses.dataclass
class PipelineCounts:
    """What the action pipeline did besides its commit set."""

    #: allocate wavefront chunks, per-task lanes retried in the next
    #: domain, and the chunks whose retry launch had such a lane
    chunks: int = 0
    retries: int = 0
    retry_chunks: int = 0
    #: victim action name -> its steps, attempts and host syncs
    victim_stats: dict[str, VictimStats] = dataclasses.field(
        default_factory=dict)
    #: action name -> host seconds
    action_seconds: dict[str, float] = dataclasses.field(
        default_factory=dict)


def _pure_allocate(st, fs, res, nl, acfg, vcfg, grace, counts):
    res, c = allocate_counted(st, fs, num_levels=nl, config=acfg, init=res)
    counts.chunks += c.chunks
    counts.retries += c.retries
    counts.retry_chunks += c.retry_chunks
    return res


def _pure_victims(mode: str):
    name = "consolidation" if mode == "consolidate" else mode

    def run(st, fs, res, nl, acfg, vcfg, grace, counts):
        res, stats = run_victim_action_counted(
            st, fs, res, num_levels=nl, mode=mode, config=vcfg)
        counts.victim_stats[name] = stats
        return res
    return run


def _pure_stale(st, fs, res, nl, acfg, vcfg, grace, counts):
    return stale_gang_eviction(st, res, grace_s=grace, num_levels=nl)


#: the built-in action bodies, composed by :func:`run_actions`
_PURE_ACTIONS = {
    "allocate": _pure_allocate,
    "consolidation": _pure_victims("consolidate"),
    "reclaim": _pure_victims("reclaim"),
    "preempt": _pure_victims("preempt"),
    "stalegangeviction": _pure_stale,
}


def run_actions(state, fair_share, steps, *, num_levels, acfg, vcfg,
                grace_s) -> tuple[AllocationResult, PipelineCounts]:
    """The action pipeline over a fresh commit set: each ``(name, step)``
    in order, timed; returns the commit set and the counts.  A step takes
    the arguments of the :data:`_PURE_ACTIONS` bodies."""
    res = init_result(state)
    counts = PipelineCounts()
    for name, step in steps:
        ta = time.perf_counter()
        res = step(state, fair_share, res, num_levels, acfg, vcfg, grace_s,
                   counts)
        counts.action_seconds[name] = time.perf_counter() - ta
    return res, counts


def _builtin_steps(actions) -> tuple:
    return tuple((name, _PURE_ACTIONS[name]) for name in actions)


#: the classic cycle's watched pipeline entry (``runtime/compile_watch``),
#: called over built-in steps only, whose signature stays the same
_fused_pipeline = compile_watch.watch("fused_pipeline", run_actions)


def resident_cycle(state, delta, ages, k_value, *, actions, num_levels,
                   acfg, vcfg, grace_s, track_devices, analytics_cfg):
    """One steady resident cycle over the device-resident snapshot.

    ``state`` is the resident ``ClusterState``; ``delta`` the packed
    journal delta on its device (``ops/resident.py``).  The delta is
    written into ``state`` IN PLACE (K16); then the fair-share division
    (K1), the actions over the solved copy, the analytics pass (K14) when
    ``analytics_cfg`` is given, and the commit pack — the reference's one
    fused program, composed here on the host from the same kernels.

    Returns ``(state, result, packed, counts)``: the post-delta state for
    the next cycle WITHOUT the fair-share replacement (fair share is
    derived every cycle, and the resident state must stay leaf-identical
    to the snapshotter's host mirror), the commit set, the i16 commit and
    the pipeline's counts.  Tensors of an earlier cycle's commit set may
    alias the resident leaves and change under the next apply.
    """
    state = resident_ops.apply_delta(state, delta)
    fair_share = drf.set_fair_share(state, num_levels=num_levels,
                                    k_value=k_value)
    solved = dataclasses.replace(state, queues=dataclasses.replace(
        state.queues, fair_share=fair_share))
    res, counts = run_actions(solved, fair_share, _builtin_steps(actions),
                              num_levels=num_levels, acfg=acfg, vcfg=vcfg,
                              grace_s=grace_s)
    bundle = None
    if analytics_cfg is not None:
        ta = time.perf_counter()
        bundle = cluster_analytics(solved, res, ages, config=analytics_cfg)
        counts.action_seconds["analytics"] = time.perf_counter() - ta
    packed = _pack_commit(res, solved, track_devices=track_devices,
                          analytics=bundle)
    return state, res, packed, counts


#: the resident cycle's one watched entry: it calls the unwatched bodies,
#: so a steady resident cycle counts exactly one watched call
_resident_cycle = compile_watch.watch("resident_cycle", resident_cycle)


def _analytics_body(*args, **kwargs):
    return cluster_analytics(*args, **kwargs)


def _repack_body(*args, **kwargs):
    return plan_repack(*args, **kwargs)


#: the classic cycle's analytics entry and every cycle's repack entry
_analytics = compile_watch.watch("analytics", _analytics_body)
_repack = compile_watch.watch("repack", _repack_body)


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
    #: snapshot wall seconds (refresh or build, upload, and the DRF
    #: division outside resident cycles)
    open_seconds: float = 0.0
    #: packed-commit gather + BindRequest decode + API writes
    commit_seconds: float = 0.0
    #: contiguous checkpoints partitioning the cycle: snapshot / upload /
    #: solve_dispatch / device_wait / host_decode / commit (the
    #: reference's keys; here ``upload`` is the snapshot's one
    #: host-to-device copy — the changed leaves, the packed delta or the
    #: full build — and ``solve_dispatch`` includes the device time of
    #: the actions, whose wavefront syncs once per chunk)
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
    #: the cycle's transfer summary (runtime/wire_ledger.py): bytes,
    #: leaves and dispatches by reason, redundant bytes, and the
    #: residency gauge — the ledger window rolled at the cycle's end
    wire: dict = dataclasses.field(default_factory=dict)


def _take_counts(result: CycleResult, counts: PipelineCounts) -> None:
    result.chunks += counts.chunks
    result.retries += counts.retries
    result.retry_chunks += counts.retry_chunks
    result.victim_stats.update(counts.victim_stats)
    result.action_seconds.update(counts.action_seconds)


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


class _BuiltinAction:
    """A built-in action's registry entry.  The cycle runs its
    :data:`_PURE_ACTIONS` body as a pipeline step; called as an action (by
    one registered in its place that wraps it) it runs the body watched as
    the reference's per-action entry."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, session: Session, result: CycleResult) -> None:
        cfg = session.config
        counts = PipelineCounts()
        result.tensors = _WATCHED_ACTIONS[self.name](
            session.state, session.state.queues.fair_share, result.tensors,
            cfg.num_levels, cfg.allocate, cfg.victims, cfg.stale_grace_s,
            counts)
        _take_counts(result, counts)


def _registry_step(action: Action, session: Session, result: CycleResult):
    """An action registered in place of a built-in one, as a pipeline
    step: it runs over the session and the cycle's result."""
    def step(st, fs, res, nl, acfg, vcfg, grace, counts):
        result.tensors = res
        action(session, result)
        return result.tensors
    return step


# the reference's actions (``actions/allocate``, ``actions/consolidation``
# — evict-and-reallocate, every victim re-placed —, ``actions/reclaim`` —
# cross-queue fairness —, ``actions/preempt`` — intra-queue priority —,
# ``actions/stalegangeviction`` — gangs below minMember past grace), each
# body watched under the reference's entry name
_WATCHED_ACTIONS = {
    name: compile_watch.watch(entry, _PURE_ACTIONS[name])
    for name, entry in (("allocate", "allocate"),
                        ("consolidation", "run_victim_action"),
                        ("reclaim", "run_victim_action"),
                        ("preempt", "run_victim_action"),
                        ("stalegangeviction", "stale_gang_eviction"))}
for _name in _WATCHED_ACTIONS:
    register_action(_name)(functools.partial(_BuiltinAction, _name))
del _name

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
    #: journaled incremental snapshot refresh (state/incremental.py):
    #: re-derive only dirty rows each cycle instead of the full host
    #: rebuild, falling back to the full builder on structural change,
    #: feature pods, or churn above the threshold
    incremental: bool = True
    #: keep the snapshot resident on the device across cycles: patched
    #: cycles upload only a packed journal delta and run
    #: :func:`resident_cycle`; requires ``incremental``; structural
    #: changes fall back to the full build automatically
    resident: bool = False
    #: after every patched refresh, rebuild from scratch and assert the
    #: patched mirror is element-wise identical; on the resident path,
    #: also read the resident state back and compare it with the mirror
    verify_incremental: bool = False
    #: dirty fraction above which patching falls back to a full rebuild
    incremental_dirty_threshold: float = 0.35


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
        #: every action is a built-in one: the watched classic pipeline
        #: and the resident path's precondition
        self._builtin_only = all(isinstance(a, _BuiltinAction)
                                 for _, a in self._actions)
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
        #: the incremental snapshotter, scoped to one cluster document (it
        #: understands one journal)
        self._snapshotter: IncrementalSnapshotter | None = None
        self._snapshotter_cluster = None

    def _steps(self, session: Session, result: CycleResult) -> tuple:
        """The configured actions as pipeline steps: a built-in one's
        :data:`_PURE_ACTIONS` body, an overriding one over the session."""
        return tuple(
            (name, _PURE_ACTIONS[name] if isinstance(a, _BuiltinAction)
             else _registry_step(a, session, result))
            for name, a in self._actions)

    def _snapshot(self, cluster: Cluster):
        """This cycle's Session: ``(session, resident delta or None,
        upload seconds)``."""
        cfg = self.config
        if not cfg.incremental:
            session = Session.open(
                *cluster.snapshot_lists(), config=cfg.session,
                device=self.device, now=cluster.now,
                resource_claims=cluster.resource_claims,
                device_classes=cluster.device_classes,
                volume_claims=cluster.volume_claims,
                storage_classes=cluster.storage_classes)
            return session, None, session.index.upload_seconds
        if (self._snapshotter_cluster is None
                or self._snapshotter_cluster() is not cluster):
            self._snapshotter = IncrementalSnapshotter(
                verify=cfg.verify_incremental,
                dirty_threshold=cfg.incremental_dirty_threshold,
                device=self.device)
            self._snapshotter_cluster = weakref.ref(cluster)
        snap = self._snapshotter
        delta = None
        # the resident path engages only over built-in actions (an
        # overriding action runs over a session's state)
        if cfg.resident and self._builtin_only:
            rr = snap.refresh_resident(cluster, now=cluster.now)
            if rr.mode == "resident":
                delta = rr.delta
                session = Session.resident(rr.index, config=cfg.session,
                                           host_state=rr.host)
            else:
                session = Session.from_state(rr.state, rr.index,
                                             config=cfg.session)
                session.host_state = rr.host
            index = rr.index
        else:
            state, index = snap.refresh(cluster, now=cluster.now)
            session = Session.from_state(state, index, config=cfg.session)
        # a full rebuild's upload is timed inside build_snapshot
        upload_s = (index.upload_seconds if snap.stats.last["mode"] == "full"
                    else float(snap.stats.last["ship_seconds"]))
        return session, delta, upload_s

    def run_once(self, cluster: Cluster) -> CycleResult:
        """One scheduling cycle: snapshot → actions → commit set."""
        t0 = time.perf_counter()
        session, delta, upload_s = self._snapshot(cluster)
        resident_mode = delta is not None
        t_open = time.perf_counter()
        open_s = t_open - t0
        result = CycleResult()
        result.cycle_index = self._cycle_index
        result.cycle_seed = cycle_seed_for(self.config.seed,
                                           self._cycle_index)
        every = self.config.analytics_every
        run_analytics = every > 0 and self._cycle_index % every == 0
        self._cycle_index += 1
        result.open_seconds = open_s
        cfg = session.config
        bundle = None
        ages = None
        packed = None
        if resident_mode:
            ta = time.perf_counter()
            if run_analytics:
                ages = self._pending_age_vector(cluster, session)
                ages_arg = ages
            else:
                # a cadence-skipped cycle: the resident cycle never reads
                # the ages; `ages` stays None so a repack firing below
                # still computes the real ones
                ages_arg = torch.zeros(
                    (session.host_state["gangs.valid"].shape[0],),
                    dtype=torch.float32, device=self.device)
            snap = self._snapshotter
            new_state, tensors, packed, counts = _resident_cycle(
                snap.device_state, delta, ages_arg, cfg.k_value,
                actions=tuple(self.config.actions),
                num_levels=cfg.num_levels, acfg=cfg.allocate,
                vcfg=cfg.victims, grace_s=cfg.stale_grace_s,
                track_devices=session.index.needs_device_table,
                analytics_cfg=cfg.analytics if run_analytics else None)
            # the post-delta state is both the session's state and the
            # next cycle's resident base
            snap.adopt_device_state(new_state)
            session.state = new_state
            result.tensors = tensors
            _take_counts(result, counts)
            result.analytics_seconds = counts.action_seconds.pop(
                "analytics", 0.0)
            result.action_seconds["resident_cycle"] = \
                time.perf_counter() - ta
            if self.config.verify_incremental:
                snap.verify_device_residency()
        else:
            ta = time.perf_counter()
            pipeline = _fused_pipeline if self._builtin_only else run_actions
            result.tensors, counts = pipeline(
                session.state, session.state.queues.fair_share,
                self._steps(session, result), num_levels=cfg.num_levels,
                acfg=cfg.allocate, vcfg=cfg.victims,
                grace_s=cfg.stale_grace_s)
            _take_counts(result, counts)
            result.action_seconds["pipeline"] = time.perf_counter() - ta
        if run_analytics and not resident_mode:
            ta = time.perf_counter()
            ages = self._pending_age_vector(cluster, session)
            bundle = _analytics(session.state, result.tensors, ages,
                                config=cfg.analytics)
            result.analytics_seconds = time.perf_counter() - ta
        repack_plan = None
        if self._repack_trigger(cluster, session):
            ta = time.perf_counter()
            if ages is None:
                ages = self._pending_age_vector(cluster, session)
            # destinations draw on the post-decision idle pool, so a move
            # never lands on capacity this cycle's placements took
            repack_plan = _repack(
                session.state, ages, result.tensors.free,
                config=RepackConfig(
                    analytics=cfg.analytics,
                    max_migrations=min(
                        self.config.repack_max_migrations,
                        cfg.victims.max_victim_pods)))
            result.repack_seconds = time.perf_counter() - ta
        t_solve = time.perf_counter()
        if resident_mode:
            host = session.gather_host(
                result.tensors, packed=packed,
                packed_analytics=run_analytics, repack_plan=repack_plan)
        else:
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
        result.wire = _wire.LEDGER.roll_cycle(result.cycle_index)
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
        """f32 [G] on the scheduler's device — each gang slot's pending
        age BEFORE this cycle, from the name-keyed counters the host keeps
        (``_advance_starvation`` advances them after decode).  The shape
        comes from the host mirror when the session has one (a resident
        cycle has no device state before its resident cycle runs)."""
        self._scope_ages(cluster)
        G = (session.host_state["gangs.valid"].shape[0]
             if session.host_state is not None else session.state.gangs.g)
        ages = np.zeros((G,), np.float32)
        if self._pending_age:
            names = session.index.gang_names
            valid = session.index.host_tables["gang_valid"]
            for gi in np.nonzero(valid[:len(names)])[0].tolist():
                a = self._pending_age.get(names[gi])
                if a:
                    ages[gi] = a
        return torch.from_numpy(ages).to(self.device)

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
