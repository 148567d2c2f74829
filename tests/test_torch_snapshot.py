"""The port's snapshot builder against the JAX reference: every leaf of
``build_snapshot`` bit-equal (same name, shape, dtype, bytes) and every
SnapshotIndex hint equal, on ``make_cluster`` variants built from the same
seeds by both packages' own copies of ``make_cluster``."""
import dataclasses

import numpy as np
import pytest
import torch

import kai_scheduler_tpu.state.cluster_state as ref_cs
from kai_scheduler_tpu.apis import types as ref_apis
from kai_scheduler_tpu.state.synthetic import make_cluster as ref_make
from kai_scheduler_tpu_torch.apis import types as port_apis
from kai_scheduler_tpu_torch.state import (build_snapshot, leaf_paths,
                                           make_cluster, state_from_numpy,
                                           state_to_numpy)
from jax_executables import release_jax_executables  # noqa: F401

SECTIONS = ("nodes", "queues", "gangs", "running")

#: small cousins of the headline shape, a contended one, a 4-department
#: hierarchy with three priorities, one with running gangs, and one with
#: topology levels and a required level (snapshot-only), the features
#: cluster (selectors, a taint, a host port, elastic gangs), and a
#: GPU-sharing cluster (the device table: running and terminating
#: fractions on their devices, fractional and memory-based requests on
#: nodes of two device sizes, subgroups, a zone level)
SHAPES = {
    "headline_small": dict(num_nodes=48, node_accel=8.0, num_gangs=40,
                           tasks_per_gang=8),
    "contended": dict(num_nodes=10, num_gangs=60, tasks_per_gang=4),
    "hierarchy": dict(num_nodes=24, num_gangs=30, tasks_per_gang=4,
                      num_departments=4, queues_per_department=4,
                      priority_spread=3, seed=1),
    "running": dict(num_nodes=20, num_gangs=40, tasks_per_gang=4,
                    running_fraction=0.3, seed=3),
    "topology": dict(num_nodes=32, num_gangs=12, tasks_per_gang=4,
                     topology_levels=(2, 4), required_level="topo/level1",
                     seed=2),
    "features": dict(num_nodes=16, num_gangs=36, tasks_per_gang=4,
                     running_fraction=0.25, seed=4, features=True),
    "sharing": dict(seed=6, sharing=True),
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
    shape asks for it (the sharing cluster is made by its own function)."""
    if shape.get("sharing"):
        from test_torch_pertask import sharing_objects
        return sharing_objects(apis, shape["seed"], topology=True)
    kw = {k: v for k, v in shape.items() if k != "features"}
    objs = make(**kw)
    return decorate(objs, apis) if shape.get("features") else objs


def ref_leaves(state) -> dict:
    return {f"{sec}.{f.name}": np.asarray(getattr(getattr(state, sec), f.name))
            for sec in SECTIONS
            for f in dataclasses.fields(getattr(state, sec))}


def build_both(shape):
    _, ref_index, ref_host = ref_cs.build_snapshot(
        *objects(shape, ref_make, ref_apis), pad=32, _return_host=True)
    state, index = build_snapshot(
        *objects(shape, make_cluster, port_apis), pad=32, device="cpu")
    return ref_host, ref_index, state, index


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_snapshot_leaves_bit_equal(name):
    ref_host, _, state, _ = build_both(SHAPES[name])
    ref = ref_leaves(ref_host)
    assert sorted(ref) == sorted(leaf_paths())
    port = state_to_numpy(state)
    for path in leaf_paths():
        a, b = np.asarray(ref[path]), port[path]
        assert a.dtype == b.dtype, path
        assert a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_snapshot_index_hints_equal(name):
    _, ref_index, _, index = build_both(SHAPES[name])
    for f in dataclasses.fields(ref_index):
        a, b = getattr(ref_index, f.name), getattr(index, f.name)
        if f.name == "host_tables":
            assert sorted(a) == sorted(b)
            for k in a:
                assert np.array_equal(a[k], b[k]), k
        else:
            assert a == b, f.name


def test_state_from_numpy_round_trip():
    ref_host, _, state, _ = build_both(SHAPES["hierarchy"])
    leaves = ref_leaves(ref_host)
    port = state_from_numpy(leaves, "cpu")
    back = state_to_numpy(port)
    for path, a in leaves.items():
        assert back[path].dtype == a.dtype and back[path].shape == a.shape
        assert back[path].tobytes() == a.tobytes(), path
    # the leaves are views into ONE buffer (one host-to-device copy)
    bases = {t.untyped_storage().data_ptr() for t in (
        port.nodes.free, port.queues.quota, port.gangs.task_req,
        port.running.valid)}
    assert len(bases) == 1
    assert port.total_capacity.dtype == torch.float32


def test_state_from_numpy_rejects_missing_and_foreign_leaves():
    ref_host, *_ = build_both(SHAPES["contended"])
    leaves = ref_leaves(ref_host)
    missing = dict(leaves)
    del missing["gangs.sig"]
    with pytest.raises(KeyError, match="gangs.sig"):
        state_from_numpy(missing, "cpu")
    wrong = dict(leaves)
    wrong["nodes.free"] = wrong["nodes.free"].astype(np.float64)
    with pytest.raises(TypeError, match="nodes.free"):
        state_from_numpy(wrong, "cpu")
