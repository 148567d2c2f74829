"""The port's allocate action (the kernels' plain versions, which the port
runs on the CPU) against the JAX reference's ``allocate_jit``: the same
snapshot — the reference's own leaves, carried over by
``state_from_numpy`` — and the same auto-tuned config must give an equal
``AllocationResult``, every field bit for bit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.state.cluster_state as ref_cs
from kai_scheduler_tpu.apis import types as ref_apis
from kai_scheduler_tpu.framework.session import Session as RefSession
from kai_scheduler_tpu.framework.session import SessionConfig as RefConfig
from kai_scheduler_tpu.ops.allocate import allocate_jit
from kai_scheduler_tpu.state.synthetic import make_cluster as ref_make
from kai_scheduler_tpu_torch.ops import allocate as A
from kai_scheduler_tpu_torch.state import state_from_numpy

SECTIONS = ("nodes", "queues", "gangs", "running")

SHAPES = {
    "headline_small": dict(num_nodes=48, node_accel=8.0, num_gangs=40,
                           tasks_per_gang=8),
    "contended": dict(num_nodes=10, num_gangs=60, tasks_per_gang=4),
    "hierarchy": dict(num_nodes=24, num_gangs=30, tasks_per_gang=4,
                      num_departments=4, queues_per_department=4,
                      priority_spread=3, seed=1),
    "running": dict(num_nodes=20, num_gangs=40, tasks_per_gang=4,
                    running_fraction=0.3, seed=3),
    "features": dict(num_nodes=16, num_gangs=36, tasks_per_gang=4,
                     running_fraction=0.25, seed=4, features=True),
}

#: config variants on top of the auto-tuned one: the default wavefront,
#: the fully sequential one (test_equivalence pins the reference at
#: batch_size=1; there the per-type tables are not hoisted since Y > B),
#: a narrow wavefront, and the rank-within-feasible tie jitter
VARIANTS = {
    "default": {},
    "batch1": {"batch_size": 1},
    "batch8": {"batch_size": 8},
    "rank_jitter": {"dense_feasibility": False},
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


def ref_leaves(state) -> dict:
    return {f"{sec}.{f.name}": np.asarray(getattr(getattr(state, sec), f.name))
            for sec in SECTIONS
            for f in dataclasses.fields(getattr(state, sec))}


def port_config(ref_cfg) -> A.AllocateConfig:
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ref_cfg) if f.name != "placement"}
    return A.AllocateConfig(**fields)


def run_both(shape: dict, overrides: dict):
    ref_state, ref_index = ref_cs.build_snapshot(
        *objects(shape, ref_make, ref_apis), pad=32)
    ses = RefSession.from_state(ref_state, ref_index, RefConfig())
    cfg = dataclasses.replace(ses.config.allocate, **overrides)
    want = allocate_jit(ses.state, ses.state.queues.fair_share,
                        num_levels=ses.config.num_levels, config=cfg)
    port = state_from_numpy(ref_leaves(ses.state), "cpu")
    got, chunks = A.allocate_counted(
        port, port.queues.fair_share, num_levels=ses.config.num_levels,
        config=port_config(cfg))
    return jax.device_get(want), got, chunks


def assert_results_equal(want, got):
    for f in dataclasses.fields(want):
        a = np.asarray(getattr(want, f.name))
        b = getattr(got, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.tobytes() == b.tobytes(), f.name


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_allocate_result_bit_equal(name, variant):
    want, got, chunks = run_both(SHAPES[name], VARIANTS[variant])
    assert_results_equal(want, got)
    assert chunks >= 1
    assert bool(got.allocated.any())


def test_contended_shape_exercises_failures_and_signature_skip():
    want, got, _ = run_both(SHAPES["contended"], {})
    reasons = set(got.fit_reason.tolist())
    assert 3 in reasons          # placement attempts failed
    assert 0 in reasons
    assert_results_equal(want, got)


def test_empty_large_cluster_ties_decide_every_placement():
    """On an empty cluster every node scores alike and the tie jitter
    (-1e-4/N)*k is below the f32 spacing of the ~109-point scores, so the
    lax.top_k tie order alone decides placements (the headline case)."""
    want, got, _ = run_both(dict(num_nodes=10_000, node_accel=8.0,
                                 num_gangs=6, tasks_per_gang=8), {})
    assert_results_equal(want, got)
    placed = got.placements[:6]
    assert bool((placed >= 0).all())


def test_topk_tie_order_matches_lax_top_k():
    rng = np.random.default_rng(0)
    rows = np.stack([
        np.full(64, 109.0, np.float32),                        # all tied
        rng.integers(0, 4, 64).astype(np.float32),             # few levels
        np.where(rng.random(64) < 0.5, -1e30, 9.0).astype(np.float32),
    ])
    for k in (1, 8, 64):
        _, want = jax.lax.top_k(rows, k)
        got = A.topk_lax_order(torch.from_numpy(rows), k)
        assert np.array_equal(np.asarray(want), got.numpy()), k
    # all tied: the lowest indices, ascending
    assert A.topk_lax_order(torch.from_numpy(rows[:1]), 8).tolist() == [
        list(range(8))]


@pytest.mark.parametrize("flag,value", [
    ("uniform_tasks", False), ("track_devices", True),
    ("subgroup_topology", True), ("preferred_topology", True),
    ("extended", True), ("anti_groups", True), ("attract_groups", True),
    ("queue_depth", 2), ("dynamic_order", False),
    ("sparse_wavefront", False)])
def test_unported_settings_raise_naming_the_flag(flag, value):
    base = A.AllocateConfig(track_devices=False, uniform_tasks=True,
                            subgroup_topology=False,
                            preferred_topology=False)
    cfg = dataclasses.replace(base, **{flag: value})
    ref_state, _ = ref_cs.build_snapshot(*ref_make(num_nodes=4,
                                                   num_gangs=2), pad=32)
    port = state_from_numpy(ref_leaves(ref_state), "cpu")
    with pytest.raises(NotImplementedError, match=flag):
        A.allocate(port, port.queues.fair_share, num_levels=2, config=cfg)
