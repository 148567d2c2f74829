"""The reference's allocate, hierarchy, GPU-sharing, topology, DRA,
deletion/mixed and victim scenario catalogs (``tests/scenarios/``,
traceable to the reference's Go suites) through both packages: one cycle
of each case with the reference's auto-tuned config — allocate only for
the allocate, hierarchy, sharing, topology, DRA and deletion/mixed
catalogs, the five
default actions for the victim catalog, both with the sequential victim
engine (``VictimConfig(batch_size=1)``) and at the default config (reclaim
and preempt through the chunked wavefront).  Where the port implements that
config, the packed i16 commit, the BindRequests, the evictions (with
their move targets) and the moves' pipelined rebinds must be equal; where
it does not, the port must refuse with ``NotImplementedError`` — never a
different result."""
import dataclasses
import enum
import functools
import re

import numpy as np
import pytest

import kai_scheduler_tpu.framework.session as ref_session
import kai_scheduler_tpu.state.cluster_state as ref_cs
from kai_scheduler_tpu.framework.scheduler import Scheduler as RefScheduler
from kai_scheduler_tpu.framework.scheduler import \
    SchedulerConfig as RefSchedulerConfig
from kai_scheduler_tpu.framework.session import \
    SessionConfig as RefSessionConfig
from kai_scheduler_tpu.ops.victims import VictimConfig as RefVictimConfig
import kai_scheduler_tpu_torch.framework.session as port_session
import kai_scheduler_tpu_torch.state.cluster_state as port_cs
from kai_scheduler_tpu_torch.apis import types as port_apis
from kai_scheduler_tpu_torch.framework.scheduler import (DEFAULT_ACTIONS,
                                                         Scheduler,
                                                         SchedulerConfig)
from kai_scheduler_tpu_torch.framework.session import SessionConfig
from kai_scheduler_tpu_torch.ops.allocate import AllocateConfig, \
    check_supported
from kai_scheduler_tpu_torch.ops.victims import (VictimConfig,
                                                 check_placement_ported)
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from scenarios import (test_allocate_scenarios,
                       test_deletion_mixed_scenarios, test_dra_scenarios,
                       test_hierarchy_order_scenarios,
                       test_sharing_scenarios, test_topology_scenarios,
                       test_victim_scenarios)
from scenarios.harness import _build
from jax_executables import release_jax_executables  # noqa: F401

CATALOGS = (test_allocate_scenarios, test_hierarchy_order_scenarios,
            test_sharing_scenarios, test_topology_scenarios,
            test_dra_scenarios, test_deletion_mixed_scenarios)
CASES = {c.name: c for m in CATALOGS for c in m.CASES}
assert len(CASES) == sum(len(m.CASES) for m in CATALOGS), "duplicate names"
VICTIM_CASES = {c.name: c for c in test_victim_scenarios.CASES}


def to_port(x):
    """A reference API object (or container of them) as the port's."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = getattr(port_apis, type(x).__name__)
        return cls(**{f.name: to_port(getattr(x, f.name))
                      for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return getattr(port_apis, type(x).__name__)(x.value)
    if isinstance(x, list):
        return [to_port(v) for v in x]
    if isinstance(x, tuple):
        return tuple(to_port(v) for v in x)
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    return x


@pytest.fixture
def pad32(monkeypatch):
    monkeypatch.setattr(port_session, "build_snapshot", functools.partial(
        port_cs.build_snapshot, pad=32))
    monkeypatch.setattr(ref_session, "build_snapshot", functools.partial(
        ref_cs.build_snapshot, pad=32))
    seen = {}
    orig = ref_session._pack_commit
    orig_open = ref_session.Session.from_state.__func__

    def capture(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen["packed"] = np.asarray(out)
        return out

    def from_state(cls, *args, **kwargs):
        ses = orig_open(cls, *args, **kwargs)
        seen["config"] = ses.config.allocate
        seen["victims"] = ses.config.victims
        return ses
    monkeypatch.setattr(ref_session, "_pack_commit", capture)
    monkeypatch.setattr(ref_session.Session, "from_state",
                        classmethod(from_state))
    return seen


@pytest.mark.parametrize("name", sorted(CASES))
def test_scenario_cycle_matches_reference_or_is_refused(name, pad32):
    ref_cluster = _build(CASES[name])
    cluster = _port_cluster(ref_cluster)
    want = RefScheduler(RefSchedulerConfig(
        actions=("allocate",), incremental=False, analytics_every=0,
        repack_enable=False)).run_once(ref_cluster)
    ref_cfg = pad32["config"]
    port_cfg = AllocateConfig(**{
        f.name: getattr(ref_cfg, f.name)
        for f in dataclasses.fields(ref_cfg) if f.name != "placement"})
    try:
        check_supported(port_cfg)
        supported = True
    except NotImplementedError:
        supported = False
    sched = Scheduler(SchedulerConfig(actions=("allocate",)), device="cpu")
    if not supported:
        with pytest.raises(NotImplementedError):
            sched.run_once(cluster)
        return
    got = sched.run_once(cluster)
    assert got.packed.tobytes() == pad32["packed"].tobytes()
    assert [dataclasses.asdict(b) for b in got.bind_requests] == \
        [dataclasses.asdict(b) for b in want.bind_requests]


def _port_cluster(ref_cluster) -> Cluster:
    cluster = Cluster.from_objects(
        *to_port(list(ref_cluster.snapshot_lists())))
    cluster.resource_claims = to_port(ref_cluster.resource_claims)
    cluster.device_classes = to_port(ref_cluster.device_classes)
    cluster.now = ref_cluster.now
    return cluster


def _refusal(cfg, check=check_supported) -> str | None:
    """Why the port refuses the reference's auto-tuned placement config
    (allocate's check by default; ``check_placement_ported`` for the
    victim actions' placement), or None where it implements it."""
    try:
        check(AllocateConfig(**{
            f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cfg) if f.name != "placement"}))
    except NotImplementedError as e:
        return str(e)
    return None


def _supported(cfg, check=check_supported) -> bool:
    return _refusal(cfg, check) is None


def _victim_cycle(name, batch_size):
    """One five-action cycle of a victim-catalog case on the reference
    (at the given victim wavefront width), and the port's twin cluster."""
    case = VICTIM_CASES[name]
    ref_cluster = _build(case)
    patch = test_victim_scenarios._prepare(case)
    if patch is not None:
        patch(ref_cluster)
    cluster = _port_cluster(ref_cluster)
    want = RefScheduler(RefSchedulerConfig(
        incremental=False, analytics_every=0, repack_enable=False,
        session=RefSessionConfig(victims=RefVictimConfig(
            batch_size=batch_size)))).run_once(ref_cluster)
    return want, cluster


#: the sequential victim engine (the case's plain id) and the default
#: config, whose reclaim and preempt run the chunked wavefront
VICTIM_WIDTHS = [
    pytest.param(name, b, id=name if b == 1 else f"{name}-default")
    for b in (1, VictimConfig().batch_size) for name in sorted(VICTIM_CASES)]


@pytest.mark.parametrize("name,batch_size", VICTIM_WIDTHS)
def test_victim_scenario_cycle_matches_reference_or_is_refused(
        name, batch_size, pad32):
    want, cluster = _victim_cycle(name, batch_size)
    sched = Scheduler(SchedulerConfig(
        actions=DEFAULT_ACTIONS,
        session=SessionConfig(victims=VictimConfig(batch_size=batch_size))),
        device="cpu")
    # allocate runs first: its refusal, else the victim actions' (which
    # name the placement setting they have not ported, topology included)
    reason = (_refusal(pad32["config"])
              or _refusal(pad32["victims"].placement, check_placement_ported))
    if reason is not None:
        with pytest.raises(NotImplementedError, match=re.escape(reason)):
            sched.run_once(cluster)
        return
    got = sched.run_once(cluster)
    assert got.packed.tobytes() == pad32["packed"].tobytes()
    for field in ("bind_requests", "evictions", "move_bind_requests"):
        assert [dataclasses.asdict(b) for b in getattr(got, field)] == \
            [dataclasses.asdict(b) for b in getattr(want, field)], field


def test_catalog_cases_run_on_the_port():
    """Most catalog cases need only what the port has ported, every
    topology case (required, subgroup and preferred levels) among them:
    the parity test above then compares commits instead of checking a
    refusal."""
    supported = {name for name, case in CASES.items()
                 if _supported(_auto_config(case))}
    assert len(supported) >= len(CASES) // 2, (len(supported), len(CASES))
    assert {c.name for c in test_topology_scenarios.CASES} <= supported


def _auto_config(case):
    """The reference's auto-tuned allocate config for a catalog case."""
    cluster = _build(case)
    _, index = ref_cs.build_snapshot(*cluster.snapshot_lists(), pad=32,
                                     now=cluster.now)
    return ref_session._auto_tune(ref_session.SessionConfig(), index, 32,
                                  32).allocate


def test_per_task_catalog_cases_run_on_the_port():
    """The per-task path runs the sharing catalog's fractional and
    memory-based cases, the hierarchy catalog's fractional reclaim cases
    and the topology catalog's subgroup-quorum cases; the topology
    catalog's required-level cases run on the uniform path with its
    domain tables, and its preferred-level case with the uniform
    preferred band; MIG (extended) stays refused."""
    runs, uniform, refused = set(), {}, {}
    for case in CASES.values():
        cfg = _auto_config(case)
        reason = _refusal(cfg)
        if reason is not None:
            refused[case.name] = reason
        elif cfg.uniform_tasks:
            uniform[case.name] = cfg
        else:
            runs.add(case.name)
    sharing = {c.name for c in test_sharing_scenarios.CASES}
    topology = {c.name for c in test_topology_scenarios.CASES}
    hierarchy = {c.name for c in test_hierarchy_order_scenarios.CASES}
    assert len(runs & sharing) == 9
    assert len(runs & hierarchy) == 3
    assert runs & topology == {
        "subgroups_quorum_both_sides",
        "subgroup_quorum_unsatisfiable_fails_whole_gang",
        "multiple_subgroup_jobs", "unbalanced_subgroup_hierarchy"}
    assert all("extended=True" in refused[n] for n in sharing - runs)
    assert not set(refused) & topology
    required = {n for n in topology if n in uniform
                and uniform[n].subgroup_topology}
    assert required == {"required_rack_confines_gang",
                        "required_rack_too_big_fails",
                        "binpack_picks_fullest_domain",
                        "two_required_gangs_two_racks"}
    assert uniform["preferred_rack_keeps_gang_local"].preferred_topology


@pytest.mark.parametrize("name", sorted(VICTIM_CASES))
def test_victim_cycle_on_per_task_snapshot_is_refused(name, pad32):
    """Spread scoring sends every snapshot down the per-task path (the
    whole-gang fill is the sequential greedy under binpack only); the
    victim actions have not ported it, so the five-action cycle refuses
    instead of running the uniform victim code on it."""
    case = VICTIM_CASES[name]
    ref_cluster = _build(case)
    patch = test_victim_scenarios._prepare(case)
    if patch is not None:
        patch(ref_cluster)
    spread = AllocateConfig(placement=dataclasses.replace(
        AllocateConfig().placement, binpack_accel=False, binpack_cpu=False))
    sched = Scheduler(SchedulerConfig(
        actions=DEFAULT_ACTIONS, session=SessionConfig(allocate=spread)),
        device="cpu")
    with pytest.raises(NotImplementedError, match="uniform_tasks=False"):
        sched.run_once(_port_cluster(ref_cluster))


def test_dra_and_deletion_catalogs_run_on_the_port():
    """Allocate runs every DRA case and the deletion/mixed catalog's cases
    but its three MIG ones, which it refuses by name (``extended=True``):
    the parity test above compares the rest byte for byte."""
    for catalog, refused_n in ((test_dra_scenarios, 0),
                               (test_deletion_mixed_scenarios, 3)):
        reasons = [_refusal(_auto_config(c)) for c in catalog.CASES]
        refused = [r for r in reasons if r is not None]
        assert len(refused) == refused_n, refused
        assert all("extended=True" in r for r in refused)
    assert len(test_dra_scenarios.CASES) == 17
    assert len(test_deletion_mixed_scenarios.CASES) == 16
