"""The port's whole cycle against the reference's classic cycle:
``Scheduler(device="cpu").run_once`` vs the reference ``Scheduler`` with
``actions=("allocate",)``, no incremental snapshot, no analytics and no
repack, on twin clusters built from the same seed.  Compared: the packed
i16 commit byte for byte, the BindRequests (pod, node, order and every
field), and the Cluster state after the binder applies them — over two
cycles, so the second snapshot sees the first one's binds."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import kai_scheduler_tpu.framework.session as ref_session
import kai_scheduler_tpu.state.cluster_state as ref_cs
from kai_scheduler_tpu.apis import types as ref_apis
from kai_scheduler_tpu.framework.scheduler import Scheduler as RefScheduler
from kai_scheduler_tpu.framework.scheduler import \
    SchedulerConfig as RefSchedulerConfig
from kai_scheduler_tpu.runtime.cluster import Cluster as RefCluster
from kai_scheduler_tpu.state.synthetic import make_cluster as ref_make
import kai_scheduler_tpu_torch.framework.session as port_session
from kai_scheduler_tpu_torch.apis import types as port_apis
import kai_scheduler_tpu_torch.state.cluster_state as port_cs
from kai_scheduler_tpu_torch.framework.scheduler import (Scheduler,
                                                         SchedulerConfig,
                                                         cycle_seed_for)
from kai_scheduler_tpu_torch.framework.session import _bitpack, _bitunpack
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from kai_scheduler_tpu_torch.state import make_cluster

SHAPES = {
    "headline_small": dict(num_nodes=48, node_accel=8.0, num_gangs=40,
                           tasks_per_gang=8),
    "contended_hierarchy": dict(num_nodes=10, num_gangs=60,
                                tasks_per_gang=4, num_departments=4,
                                queues_per_department=4, priority_spread=3),
    "running": dict(num_nodes=20, num_gangs=40, tasks_per_gang=4,
                    running_fraction=0.3, seed=3),
    "features": dict(num_nodes=16, num_gangs=36, tasks_per_gang=4,
                     running_fraction=0.25, seed=4, features=True),
}


def decorate(objs, apis):
    """The ``features`` cluster: zone labels on the nodes and a zone
    selector on every third gang (two task types, selector matching); a
    NoSchedule taint on node 0 (the empty filter class no longer spans
    the node axis); the last gang shares host port 8080 across its pods (a
    filter class and one-replica-per-node anti-self); every fourth gang
    is elastic (quorum 2: the rest re-push one task at a time); every
    other running pod is terminating (releasing capacity: placements
    that only fit on it pipeline)."""
    nodes, queues, groups, pods, topo = objs
    for i, nd in enumerate(nodes):
        nd.labels["zone"] = "a" if i % 2 else "b"
    nodes[0].taints = [apis.Taint(key="maintenance", effect="NoSchedule")]
    index = {g.name: i for i, g in enumerate(groups)}
    for g in groups:
        if index[g.name] % 4 == 2:
            g.min_member = 2
    for p in pods:
        gi = index[p.group]
        if gi == len(groups) - 1:
            p.host_ports = [8080]
        if gi % 3 == 1:
            p.node_selector = {"zone": "a"}
    running = [p for p in pods if p.status == apis.PodStatus.RUNNING]
    for p in running[::2]:
        p.status = apis.PodStatus.RELEASING
    return nodes, queues, groups, pods, topo


def objects(shape: dict, make, apis):
    """``make(**shape)``, decorated into the features cluster when the
    shape asks for it."""
    kw = {k: v for k, v in shape.items() if k != "features"}
    objs = make(**kw)
    return decorate(objs, apis) if shape.get("features") else objs


@pytest.fixture
def pad32(monkeypatch):
    """Both packages snapshot with pad=32 (the reference suite's padded
    builder) and the reference's packed commit is captured as it crosses
    to the host."""
    monkeypatch.setattr(port_session, "build_snapshot", functools.partial(
        port_cs.build_snapshot, pad=32))
    monkeypatch.setattr(ref_session, "build_snapshot", functools.partial(
        ref_cs.build_snapshot, pad=32))
    seen = {}
    orig = ref_session._pack_commit

    def capture(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen["packed"] = np.asarray(out)
        return out
    monkeypatch.setattr(ref_session, "_pack_commit", capture)
    return seen


def cluster_state(cluster) -> dict:
    return dict(
        pods={n: (int(p.status), p.node, list(p.accel_devices))
              for n, p in cluster.pods.items()},
        groups={n: (g.fit_failures, g.unschedulable,
                    g.unschedulable_reason, str(g.phase),
                    g.last_start_timestamp)
                for n, g in cluster.pod_groups.items()},
        binds=[dataclasses.asdict(b) for b in cluster.bind_requests.values()],
        now=cluster.now)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cycle_matches_reference(name, pad32):
    shape = SHAPES[name]
    ref_cluster = RefCluster.from_objects(*objects(shape, ref_make,
                                                   ref_apis))
    cluster = Cluster.from_objects(*objects(shape, make_cluster, port_apis))
    ref_sched = RefScheduler(RefSchedulerConfig(
        actions=("allocate",), incremental=False, analytics_every=0,
        repack_enable=False))
    sched = Scheduler(SchedulerConfig(), device="cpu")
    for cycle in range(2):
        want = ref_sched.run_once(ref_cluster)
        got = sched.run_once(cluster)
        assert got.packed.dtype == np.int16
        assert got.packed.tobytes() == pad32["packed"].tobytes(), cycle
        assert [dataclasses.asdict(b) for b in got.bind_requests] == \
            [dataclasses.asdict(b) for b in want.bind_requests], cycle
        assert (got.cycle_index, got.cycle_seed) == (want.cycle_index,
                                                     want.cycle_seed)
        assert set(got.phase_seconds) == set(want.phase_seconds)
        # the binder applies the binds; time moves on
        for c, res in ((ref_cluster, want), (cluster, got)):
            for br in res.bind_requests:
                c.bind_pod(br.pod_name, br.selected_node)
            c.tick()
        assert cluster_state(cluster) == cluster_state(ref_cluster), cycle


def test_cycle_seed_matches_reference():
    from kai_scheduler_tpu.framework.scheduler import \
        cycle_seed_for as ref_seed
    for seed in (0, 1, 12345):
        for i in range(4):
            assert cycle_seed_for(seed, i) == ref_seed(seed, i)


def test_unported_actions_raise():
    with pytest.raises(NotImplementedError, match="reclaim"):
        Scheduler(SchedulerConfig(actions=("allocate", "reclaim")),
                  device="cpu")


def test_bitpack_round_trip():
    rng = np.random.default_rng(0)
    for k in (1, 7, 8, 13, 64):
        b = rng.random(k) < 0.5
        packed = _bitpack(torch.from_numpy(b)).numpy()
        assert packed.dtype == np.int16
        assert np.array_equal(_bitunpack(packed, k), b)
