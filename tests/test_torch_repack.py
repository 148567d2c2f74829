"""The port's repack solver (``ops/repack.py``: K15's and K4's plain
versions) and the default cycle's analytics and repack (the reference's
``SchedulerConfig`` defaults) against the JAX reference on the CPU.

- ``plan_repack`` on both randomized families of ``tests/test_repack.py``
  (feasible and infeasible outcomes): every ``RepackPlan`` field
  byte-equal;
- the 8-node two-rack scenario of ``tests/test_repack.py`` through both
  Schedulers, each with its own ``Binder``, cycle by cycle: the packed
  commit (analytics bundle and plan tail included), BindRequests,
  evictions with their move targets, move rebinds, the analytics and
  repack documents and the cluster state after the binder; the trigger
  fires on cycle 3 and the gang places a cycle later;
- non-preemptible and minruntime-protected fillers are never moved;
  ``repack_enable=False`` leaves the gang stranded; an enabled scheduler
  whose trigger never fires commits what a disabled one commits;
- one case of each scenario catalog with the default analytics and repack
  knobs on both sides and the action list the catalog's parity test uses,
  followed by a binder pass on each side.

Analytics fields built on order-sensitive sums follow
``test_torch_analytics.assert_bundle_matches``."""
import dataclasses

import numpy as np
import pytest
import torch

import kai_scheduler_tpu_torch.framework.scheduler as port_scheduler
from kai_scheduler_tpu.binder import Binder as RefBinder
from kai_scheduler_tpu.framework.scheduler import Scheduler as RefScheduler
from kai_scheduler_tpu.framework.scheduler import \
    SchedulerConfig as RefSchedulerConfig
from kai_scheduler_tpu.framework.session import \
    SessionConfig as RefSessionConfig
from kai_scheduler_tpu.ops import repack as RR
from kai_scheduler_tpu.ops.victims import VictimConfig as RefVictimConfig
from kai_scheduler_tpu_torch.binder import Binder
from kai_scheduler_tpu_torch.framework.scheduler import (DEFAULT_ACTIONS,
                                                         Scheduler,
                                                         SchedulerConfig)
from kai_scheduler_tpu_torch.framework.session import SessionConfig
from kai_scheduler_tpu_torch.ops import analytics as A
from kai_scheduler_tpu_torch.ops import repack as R
from kai_scheduler_tpu_torch.ops.victims import VictimConfig
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from kai_scheduler_tpu_torch.state import make_cluster, state_from_numpy
from scenarios import (test_allocate_scenarios,
                       test_deletion_mixed_scenarios, test_dra_scenarios,
                       test_hierarchy_order_scenarios,
                       test_sharing_scenarios, test_topology_scenarios,
                       test_victim_scenarios)
from scenarios.harness import _build
import test_analytics as ref_analytics_tests
import test_repack as ref_repack_tests
from test_torch_analytics import assert_bundle_matches, summands
from test_torch_scenarios import _port_cluster, pad32  # noqa: F401
from test_torch_victims import leaves

from jax_executables import release_jax_executables  # noqa: F401

PLAN_FIELDS = [f.name for f in dataclasses.fields(R.RepackPlan)]

#: the knobs of the reference's ``_repack_cfg``, allocate only: the port's
#: victim actions refuse required topology
REPACK_KNOBS = dict(actions=("allocate",), repack_frag_threshold=0.2,
                    repack_trigger_cycles=2, repack_cooldown=3)


def port_plan(state, ages, cfg) -> dict:
    p = R.plan_repack(state, torch.from_numpy(ages), state.nodes.free,
                      config=cfg)
    return {f: getattr(p, f).numpy() for f in PLAN_FIELDS}


@pytest.mark.parametrize("family,seed", [
    ("random", 0), ("random", 1), ("random", 2),
    ("stranded", 0), ("stranded", 1), ("stranded", 2), ("stranded", 3),
    ("stranded", 4), ("stranded", 5)])
def test_plan_matches_reference(family, seed):
    state, ages = ref_repack_tests._randomized_case(family, seed)
    want = RR.plan_repack_jit(state, ages, state.nodes.free,
                              config=RR.RepackConfig(max_migrations=8))
    got = port_plan(state_from_numpy(leaves(state), "cpu"), ages,
                    R.RepackConfig(max_migrations=8))
    for f in PLAN_FIELDS:
        a = np.asarray(getattr(want, f))
        assert a.dtype == got[f].dtype and a.tobytes() == got[f].tobytes(), f


def test_plan_families_cover_both_outcomes():
    outcomes = set()
    for family, seed in (("random", 0), ("stranded", 0), ("stranded", 1),
                         ("stranded", 2), ("stranded", 3)):
        state, ages = ref_repack_tests._randomized_case(family, seed)
        outcomes.add(bool(port_plan(state_from_numpy(leaves(state), "cpu"),
                                    ages, R.RepackConfig(max_migrations=8))
                          ["feasible"]))
    assert outcomes == {True, False}


def test_minruntime_protected_fillers_are_not_movable():
    from kai_scheduler_tpu.state.cluster_state import build_snapshot
    for mrt, feasible in ((1000.0, False), (50.0, True)):
        cluster = ref_repack_tests._frag_cluster()
        cluster.queues["fill"] = dataclasses.replace(
            cluster.queues["fill"], preempt_min_runtime=mrt)
        cluster.now = 100.0
        state, index = build_snapshot(*cluster.snapshot_lists(),
                                      now=cluster.now)
        ages = np.zeros((state.gangs.g,), np.float32)
        ages[index.gang_names.index("big-gang")] = 3.0
        want = RR.plan_repack_jit(state, ages, state.nodes.free,
                                  config=RR.RepackConfig())
        got = port_plan(state_from_numpy(leaves(state), "cpu"), ages,
                        R.RepackConfig())
        assert bool(got["feasible"]) is feasible
        for f in PLAN_FIELDS:
            assert np.asarray(getattr(want, f)).tobytes() == \
                got[f].tobytes(), (mrt, f)


def test_config_defaults_match_reference():
    ref, port = RefSchedulerConfig(), SchedulerConfig()
    for f in ("analytics_every", "starvation_alarm_cycles", "repack_enable",
              "repack_frag_threshold", "repack_trigger_cycles",
              "repack_cooldown", "repack_max_migrations", "incremental",
              "resident", "verify_incremental",
              "incremental_dirty_threshold"):
        assert getattr(port, f) == getattr(ref, f), f
    assert dataclasses.asdict(SessionConfig().analytics) == \
        dataclasses.asdict(RefSessionConfig().analytics)
    assert [f.name for f in dataclasses.fields(R.RepackConfig)] == \
        ["analytics", "max_migrations"]


# ---------------------------------------------------------------------------
# whole cycles
# ---------------------------------------------------------------------------

@pytest.fixture
def captured(monkeypatch):
    """The port's analytics inputs of the last cycle (for the summands of
    the order-sensitive sums)."""
    seen = {}
    orig = port_scheduler.cluster_analytics

    def capture(state, result, ages, *, config):
        seen["state"], seen["result"] = state, result
        return orig(state, result, ages, config=config)
    monkeypatch.setattr(port_scheduler, "cluster_analytics", capture)
    return seen


def _docs(res) -> tuple:
    repack = {k: v for k, v in res.repack.items() if k != "solve_seconds"}
    return res.analytics, repack


def _loose_free(doc: dict, loose: list) -> dict:
    """The analytics document without the entries built on fields the
    bundle check held to a tolerance (rounded to 4 places they could still
    differ)."""
    doc = {k: dict(v) if isinstance(v, dict) else v for k, v in doc.items()}
    if "stranded_frac" in loose:
        doc["fragmentation"].pop("stranded_free_frac")
    if "util" in loose:
        doc.pop("utilization")
    if "goodput" in loose:
        doc.pop("goodput")
    if set(loose) & {"queue_drift", "drift_max", "drift_mean",
                     "drift_gini"}:
        doc.pop("fairness")
    return doc


def assert_cycle_matches(want, got, ref_packed, seen, what=""):
    """One cycle of both Schedulers: the packed commit (prefix, analytics
    tail by the bundle rule, plan tail), the decisions and the
    documents."""
    state = seen.get("state")
    packed = got.packed
    assert packed.dtype == ref_packed.dtype and \
        packed.shape == ref_packed.shape, what
    loose = []
    if got.analytics:
        cfg = A.AnalyticsConfig()
        q, g = state.queues.q, state.gangs.g
        nf = A.f32_len(cfg, q=q, r=3, g=g)
        ni = A.i32_len(cfg, q=q, r=3, g=g)
        plan = 0
        if got.repack:
            P = min(SchedulerConfig().repack_max_migrations,
                    VictimConfig().max_victim_pods)
            plan = 4 * P + 16
        end = packed.size - plan
        pre = end - 2 * (nf + ni)

        def bundle(p):
            a32 = np.frombuffer(p[pre:pre + 2 * nf].tobytes(), np.float32)
            ai = np.frombuffer(p[pre + 2 * nf:end].tobytes(), np.int32)
            return A.host_unpack(a32, ai, config=cfg, q=q, r=3, g=g)
        assert packed[:pre].tobytes() == ref_packed[:pre].tobytes(), what
        assert packed[end:].tobytes() == ref_packed[end:].tobytes(), what
        loose = assert_bundle_matches(bundle(ref_packed), bundle(packed),
                                      summands(state, seen["result"]))
    else:
        assert packed.tobytes() == ref_packed.tobytes(), what
    for field in ("bind_requests", "evictions", "move_bind_requests"):
        assert [dataclasses.asdict(b) for b in getattr(got, field)] == \
            [dataclasses.asdict(b) for b in getattr(want, field)], \
            (what, field)
    (wa, wr), (ga, gr) = _docs(want), _docs(got)
    assert _loose_free(ga, loose) == _loose_free(wa, loose), what
    assert gr == wr, what
    return loose


def _cluster_state(cluster) -> dict:
    return dict(
        pods={n: (int(p.status), p.node, list(p.accel_devices),
                  p.accel_portion)
              for n, p in cluster.pods.items()},
        binds={n: (b.phase, b.failures, b.selected_node)
               for n, b in cluster.bind_requests.items()},
        reservations=sorted(
            (k, r.uuid, sorted(r.owners))
            for k, r in cluster.reservations._by_group.items()),
        restarting=sorted(cluster.restarting), now=cluster.now)


def test_repack_scenario_matches_reference(pad32, captured):
    """The acceptance scenario of ``tests/test_repack.py`` through both
    Schedulers and binders: identical cycles; the trigger fires on cycle
    3 with the minimum 4 moves, none into the target rack; the gang
    places on cycle 4 in one rack, the fragmentation score below the
    stranded score."""
    ref_cluster = ref_repack_tests._frag_cluster()
    cluster = _port_cluster(ref_cluster)
    ref_sched = RefScheduler(ref_repack_tests._repack_cfg(
        incremental=False, **REPACK_KNOBS))
    sched = Scheduler(SchedulerConfig(incremental=False, **REPACK_KNOBS),
                      device="cpu")
    ref_binder, binder = RefBinder(), Binder()
    fired = placed = stranded = None
    for cyc in range(1, 10):
        want = ref_sched.run_once(ref_cluster)
        got = sched.run_once(cluster)
        assert_cycle_matches(want, got, pad32["packed"], captured, cyc)
        score = got.analytics["fragmentation"]["score"]
        stranded = score if stranded is None else stranded
        if got.repack:
            assert fired is None
            fired = cyc
            assert got.repack["feasible"] and \
                got.repack["migrations_executed"] == 4
            moves = [ev for ev in got.evictions if ev.reason == "repack"]
            assert len(moves) == 4 == len(got.move_bind_requests)
            rack = {cluster.nodes[ev.move_to].labels["topo/rack"]
                    for ev in moves}
            src = {cluster.nodes[cluster.pods[ev.pod_name].node]
                   .labels["topo/rack"] for ev in moves}
            assert not rack & src
        big = [b for b in got.bind_requests if b.pod_name.startswith("big-")]
        if big:
            placed = cyc
            assert len(big) == 8 and score < stranded
            assert len({cluster.nodes[b.selected_node].labels["topo/rack"]
                        for b in big}) == 1
        for c, b in ((ref_cluster, ref_binder), (cluster, binder)):
            b.reconcile(c)
            c.tick()
        assert _cluster_state(cluster) == _cluster_state(ref_cluster), cyc
        if placed:
            break
    assert stranded > 0.2 and (fired, placed) == (3, 4)
    assert sched.repack_status()["last"]["target_gang"] == "big-gang"
    assert sched.last_analytics == got.analytics


def _run_pair(ref_cluster, cycles, ref_cfg, cfg, pad32, captured,
              churn=None):
    cluster = _port_cluster(ref_cluster)
    ref_sched, sched = RefScheduler(ref_cfg), Scheduler(cfg, device="cpu")
    ref_binder, binder = RefBinder(), Binder()
    out = []
    for cyc in range(cycles):
        want = ref_sched.run_once(ref_cluster)
        got = sched.run_once(cluster)
        assert_cycle_matches(want, got, pad32["packed"], captured, cyc)
        out.append(got)
        for c, b in ((ref_cluster, ref_binder), (cluster, binder)):
            b.reconcile(c)
            if churn is not None:
                churn(c, cyc)
            c.tick()
        assert _cluster_state(cluster) == _cluster_state(ref_cluster), cyc
    return out, sched


def test_non_preemptible_fillers_are_never_moved(pad32, captured):
    """The analytics scenario's fillers are not preemptible: the trigger
    fires, the plan is infeasible, nothing moves and the gang stays."""
    res, sched = _run_pair(
        ref_analytics_tests._frag_cluster(), 5,
        ref_repack_tests._repack_cfg(incremental=False, **REPACK_KNOBS),
        SchedulerConfig(incremental=False, **REPACK_KNOBS), pad32, captured)
    fired = [r.repack for r in res if r.repack]
    assert fired and not any(d["feasible"] for d in fired)
    assert not any(r.evictions or r.bind_requests for r in res)
    assert res[-1].analytics["fragmentation"]["score"] > 0.2


def test_repack_disabled_leaves_gang_stranded(pad32, captured):
    knobs = dict(REPACK_KNOBS, repack_enable=False)
    res, sched = _run_pair(
        ref_repack_tests._frag_cluster(), 5,
        ref_repack_tests._repack_cfg(incremental=False, **knobs),
        SchedulerConfig(incremental=False, **knobs), pad32, captured)
    assert all(r.repack == {} and r.repack_seconds == 0.0 for r in res)
    assert not any(r.evictions or r.bind_requests for r in res)
    assert sched.repack_status()["ok"] is False


def test_untriggered_repack_commits_like_disabled():
    """An enabled scheduler whose trigger never fires commits the same
    packed bytes and documents as a disabled one, cycle by cycle, with
    churn (one running pod evicted a cycle)."""
    def run(enable: bool):
        cluster = Cluster.from_objects(*make_cluster(
            num_nodes=16, num_gangs=12, tasks_per_gang=2,
            running_fraction=0.5, seed=7))
        sched = Scheduler(SchedulerConfig(
            actions=("allocate", "reclaim", "preempt", "stalegangeviction"),
            repack_enable=enable, repack_frag_threshold=0.2,
            repack_trigger_cycles=2, repack_cooldown=3), device="cpu")
        rows = []
        for step in range(6):
            res = sched.run_once(cluster)
            assert res.repack == {} and res.repack_seconds == 0.0
            rows.append((res.packed.tobytes(), res.analytics,
                         [dataclasses.asdict(b) for b in res.bind_requests],
                         [dataclasses.asdict(e) for e in res.evictions]))
            running = sorted(p.name for p in cluster.pods.values()
                             if p.status.name == "RUNNING")
            if running:
                cluster.evict_pod(running[step % len(running)])
            cluster.tick()
        return rows
    on, off = run(True), run(False)
    assert on == off
    assert all(r[1] for r in on)


#: one case per scenario catalog (each one the port runs) and the action
#: list that catalog's parity test uses
CATALOG_CASES = [
    (test_allocate_scenarios, "elastic_grows_beyond_min_member", False),
    (test_hierarchy_order_scenarios, "departments_smaller_ratio_first",
     False),
    (test_sharing_scenarios, "memory_request_shares_device", False),
    (test_topology_scenarios, "required_rack_confines_gang", False),
    (test_dra_scenarios, "dra_exactly_at_max_consumers", False),
    (test_deletion_mixed_scenarios, "delete_one_fractional_job", False),
    (test_victim_scenarios, "preempt_lower_priority_same_queue", True),
]


@pytest.mark.parametrize("module,name,victims", CATALOG_CASES,
                         ids=[c[1] for c in CATALOG_CASES])
def test_catalog_case_with_default_knobs(module, name, victims, pad32,
                                         captured):
    """Two cycles of one catalog case at the reference's default analytics
    and repack knobs on both sides (allocate only, or the five default
    actions at the default victim config for the victim catalog), a
    binder pass after each."""
    case = {c.name: c for c in module.CASES}[name]
    ref_cluster = _build(case)
    if victims:
        patch = test_victim_scenarios._prepare(case)
        if patch is not None:
            patch(ref_cluster)
    actions = DEFAULT_ACTIONS if victims else ("allocate",)
    res, _ = _run_pair(
        ref_cluster, 2,
        RefSchedulerConfig(actions=actions, incremental=False,
                           session=RefSessionConfig(
                               victims=RefVictimConfig())),
        SchedulerConfig(actions=actions, incremental=False,
                        session=SessionConfig(victims=VictimConfig())),
        pad32, captured)
    assert all(r.analytics for r in res)
