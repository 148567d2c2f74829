"""The reference's allocate and hierarchy scenario catalogs
(``tests/scenarios/``, traceable to the reference's Go suites) through
both packages: one allocate cycle of each case, with the reference's
auto-tuned config.  Where the port implements that config, the packed i16
commit and the BindRequests must be byte-equal; where it does not, the
port must refuse with ``NotImplementedError`` — never a different
result."""
import dataclasses
import enum
import functools

import numpy as np
import pytest

import kai_scheduler_tpu.framework.session as ref_session
import kai_scheduler_tpu.state.cluster_state as ref_cs
from kai_scheduler_tpu.framework.scheduler import Scheduler as RefScheduler
from kai_scheduler_tpu.framework.scheduler import \
    SchedulerConfig as RefSchedulerConfig
import kai_scheduler_tpu_torch.framework.session as port_session
import kai_scheduler_tpu_torch.state.cluster_state as port_cs
from kai_scheduler_tpu_torch.apis import types as port_apis
from kai_scheduler_tpu_torch.framework.scheduler import Scheduler
from kai_scheduler_tpu_torch.ops.allocate import AllocateConfig, \
    check_supported
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from scenarios import test_allocate_scenarios, test_hierarchy_order_scenarios
from scenarios.harness import _build

CASES = {c.name: c for c in (test_allocate_scenarios.CASES
                             + test_hierarchy_order_scenarios.CASES)}


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
        return ses
    monkeypatch.setattr(ref_session, "_pack_commit", capture)
    monkeypatch.setattr(ref_session.Session, "from_state",
                        classmethod(from_state))
    return seen


@pytest.mark.parametrize("name", sorted(CASES))
def test_scenario_cycle_matches_reference_or_is_refused(name, pad32):
    ref_cluster = _build(CASES[name])
    cluster = Cluster.from_objects(
        *to_port(list(ref_cluster.snapshot_lists())))
    cluster.resource_claims = to_port(ref_cluster.resource_claims)
    cluster.device_classes = to_port(ref_cluster.device_classes)
    cluster.now = ref_cluster.now
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
    if not supported:
        with pytest.raises(NotImplementedError):
            Scheduler(device="cpu").run_once(cluster)
        return
    got = Scheduler(device="cpu").run_once(cluster)
    assert got.packed.tobytes() == pad32["packed"].tobytes()
    assert [dataclasses.asdict(b) for b in got.bind_requests] == \
        [dataclasses.asdict(b) for b in want.bind_requests]


def test_catalog_cases_run_on_the_port():
    """Most catalog cases need only what this slice ported: the parity
    test above then compares commits instead of checking a refusal."""
    supported = 0
    for case in CASES.values():
        cluster = _build(case)
        _, index = ref_cs.build_snapshot(*cluster.snapshot_lists(), pad=32,
                                         now=cluster.now)
        cfg = ref_session._auto_tune(ref_session.SessionConfig(), index,
                                     32, 32).allocate
        try:
            check_supported(AllocateConfig(**{
                f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(cfg) if f.name != "placement"}))
            supported += 1
        except NotImplementedError:
            pass
    assert supported >= len(CASES) // 2, (supported, len(CASES))
