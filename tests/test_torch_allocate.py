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
from jax_executables import release_jax_executables  # noqa: F401

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
    got, counts = A.allocate_counted(
        port, port.queues.fair_share, num_levels=ses.config.num_levels,
        config=port_config(cfg))
    return jax.device_get(want), got, counts.chunks


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
        # signed zeros tie (a compare has -0.0 == +0.0), -inf ties below
        rng.choice(np.array([0.0, -0.0, -np.inf, 1.0, -1.0], np.float32),
                   64),
        np.where(rng.random(64) < 0.5, -np.inf, -0.0).astype(np.float32),
    ])
    for k in (1, 8, 64):
        _, want = jax.lax.top_k(rows, k)
        got = A.topk_lax_order(torch.from_numpy(rows), k)
        assert np.array_equal(np.asarray(want), got.numpy()), k
    # all tied: the lowest indices, ascending
    assert A.topk_lax_order(torch.from_numpy(rows[:1]), 8).tolist() == [
        list(range(8))]


def uniform_fill_keys(rows: np.ndarray) -> np.ndarray:
    """K3's 64-bit selection key of every (score, node) (``uf_key`` in
    ``csrc/uniform_fill.cu``): the score's order-preserving integer
    (``kai_f32_key``) with its sign bit flipped, high, and ~node, low;
    the larger key is the better entry."""
    bits = rows.astype(np.float32).view(np.int32).astype(np.int64)
    f32key = np.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    hi = (f32key & 0xFFFFFFFF) ^ 0x80000000
    node = np.arange(rows.shape[-1], dtype=np.int64)
    lo = ~node & 0xFFFFFFFF
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


@pytest.mark.parametrize("k", [1, 8, 64])
def test_uniform_fill_key_order_matches_lax_top_k(k):
    """K3's top-k takes the k largest 64-bit keys in descending order: the
    order of ``lax.top_k`` on rows of ties, signed zeros (-0.0 below
    +0.0), the padding score KAI_BIG_NEG (-1e30), -inf and mixed values,
    at 64 nodes and at 1,001."""
    rng = np.random.default_rng(k)
    for n in (64, 1001):
        rows = np.stack([
            np.full(n, 109.0, np.float32),
            rng.integers(0, 4, n).astype(np.float32),
            np.where(rng.random(n) < 0.5, -1e30, 9.0).astype(np.float32),
            rng.choice(np.array([0.0, -0.0, -np.inf, 1.0, -1.0, -1e30],
                                np.float32), n),
            np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32),
            (rng.normal(size=n) * 1e-7 + 109.0).astype(np.float32),
        ])
        keys = uniform_fill_keys(rows)
        assert len(np.unique(keys[0])) == n
        got = np.array([sorted(range(n), key=lambda i, r=r: -int(r[i]))[:k]
                        for r in keys])
        _, want = jax.lax.top_k(rows, k)
        assert np.array_equal(np.asarray(want), got), n


#: settings the topology paths lifted from allocate; the victim actions
#: still refuse them (their placement check)
VICTIM_ONLY = ("subgroup_topology", "preferred_topology")
#: settings the per-task path lifted from allocate and, since, from the
#: victim actions: forced on, reclaim's result must equal the reference's
VICTIMS_LIFTED = ("uniform_tasks", "track_devices")
#: settings the port now runs on both allocate and the victim actions: on
#: a snapshot with term rows (with none the reference raises ValueError)
#: the port's result must equal the reference's
LIFTED = ("anti_groups", "attract_groups")


def _lifted_run_matches(flag: str, base: A.AllocateConfig):
    """``flag`` forced on (``attract_groups`` with ``anti_groups``, which
    it requires) over a small affinity backlog: cross-gang anti terms,
    anchors with dependers and a shared host port."""
    from kai_scheduler_tpu_torch.state import fleets
    objs = fleets.affinity_objects(
        ref_apis, ref_make, num_nodes=64, node_accel=8.0, num_gangs=24,
        tasks_per_gang=4, services=6, anchors=6, dependers=6, port_gangs=8)
    ref_state, ref_index = ref_cs.build_snapshot(*objs, pad=32)
    ses = RefSession.from_state(ref_state, ref_index, RefConfig())
    flags = {"anti_groups": True, flag: True}
    cfg = dataclasses.replace(base, **flags)
    ref_cfg = dataclasses.replace(ses.config.allocate, **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "placement"})
    want = allocate_jit(ses.state, ses.state.queues.fair_share,
                        num_levels=ses.config.num_levels, config=ref_cfg)
    port = state_from_numpy(ref_leaves(ses.state), "cpu")
    got = A.allocate(port, port.queues.fair_share,
                     num_levels=ses.config.num_levels, config=cfg)
    assert_results_equal(jax.device_get(want), got)
    assert bool(got.allocated.any()) and bool(got.anti_used.any())


def _victims_run_matches(flag: str, base: A.AllocateConfig):
    """``flag`` forced on (``track_devices`` on the per-task path, the one
    that tracks devices) for the sequential reclaim action over a small
    saturated cluster: the port's result equals the reference's."""
    import kai_scheduler_tpu.ops.victims as RV
    from kai_scheduler_tpu.ops.allocate import init_result as ref_init
    from kai_scheduler_tpu_torch.ops import victims as V
    cfg = dataclasses.replace(base, uniform_tasks=False,
                              track_devices=flag == "track_devices")
    ref_state, ref_index = ref_cs.build_snapshot(*ref_make(
        num_nodes=12, node_accel=4.0, num_gangs=16, tasks_per_gang=2,
        running_fraction=0.75, queue_accel_quota=4.0,
        partition_queues_by_running=True), pad=32)
    ses = RefSession.from_state(ref_state, ref_index, RefConfig())
    ref_cfg = dataclasses.replace(ses.config.allocate, **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "placement"})
    ref_vc = dataclasses.replace(ses.config.victims, placement=ref_cfg,
                                 batch_size=1)
    want = RV.run_victim_action_jit(
        ses.state, ses.state.queues.fair_share, ref_init(ses.state),
        num_levels=ses.config.num_levels, mode="reclaim", config=ref_vc)
    port = state_from_numpy(ref_leaves(ses.state), "cpu")
    got = V.run_victim_action(
        port, port.queues.fair_share, A.init_result(port),
        num_levels=ses.config.num_levels, mode="reclaim",
        config=V.VictimConfig(placement=cfg, batch_size=1))
    assert_results_equal(jax.device_get(want), got)
    assert bool(got.victim.any()) and bool(got.allocated.any())


@pytest.mark.parametrize("flag,value", [
    ("uniform_tasks", False), ("track_devices", True),
    ("subgroup_topology", True), ("preferred_topology", True),
    ("extended", True), ("anti_groups", True), ("attract_groups", True),
    ("queue_depth", 2), ("dynamic_order", False),
    ("sparse_wavefront", False)])
def test_unported_settings_raise_naming_the_flag(flag, value):
    """A setting the port has not ported raises ``NotImplementedError``
    naming it (the victim actions' own refusals for the settings only
    allocate runs); the affinity flags, ported since, run instead and
    must equal the reference on a snapshot with term rows, and the
    per-task flags run the victim actions equal to the reference."""
    base = A.AllocateConfig(track_devices=False, uniform_tasks=True,
                            subgroup_topology=False,
                            preferred_topology=False)
    if flag in LIFTED:
        _lifted_run_matches(flag, base)
        return
    if flag in VICTIMS_LIFTED:
        _victims_run_matches(flag, base)
        return
    cfg = dataclasses.replace(base, **{flag: value})
    ref_state, _ = ref_cs.build_snapshot(*ref_make(num_nodes=4,
                                                   num_gangs=2), pad=32)
    port = state_from_numpy(ref_leaves(ref_state), "cpu")
    if flag in VICTIM_ONLY:
        from kai_scheduler_tpu_torch.ops import victims as V
        with pytest.raises(NotImplementedError, match=flag):
            V.run_victim_action(
                port, port.queues.fair_share, A.init_result(port),
                num_levels=2, mode="reclaim",
                config=V.VictimConfig(placement=cfg))
        return
    with pytest.raises(NotImplementedError, match=flag):
        A.allocate(port, port.queues.fair_share, num_levels=2, config=cfg)


def test_uniform_fill_with_device_table_is_rejected():
    """The whole-gang fill does not track devices: the reference rejects
    that combination with a ValueError, and so does the port."""
    cfg = A.AllocateConfig(track_devices=True, uniform_tasks=True,
                           subgroup_topology=False)
    with pytest.raises(ValueError, match="track_devices=False"):
        A.check_supported(cfg)


def _tiers():
    from kai_scheduler_tpu_torch.ops.scoring import PlacementConfig
    return PlacementConfig(tiers=("resourcetype", "nodeplacement"))


#: each kernel's shape or tier limit on the card, past it by one, and the
#: limit's name the refusal must carry
KERNEL_LIMITS = {
    "K1_queues": (lambda D: D.divide_level_limits(D.MAX_QUEUES + 1),
                  "MAX_QUEUES"),
    "K2_tiers": (lambda D: A.type_tables_limits(_tiers()), "DEFAULT_TIERS"),
    "K3_topk": (lambda D: A.uniform_fill_limits(A.MAX_TOPK + 1, 10_000),
                "MAX_TOPK"),
    "K9_tasks": (lambda D: A.pertask_fill_limits(
        A.PERTASK_MAX_T + 1, 8, 1, A.PlacementConfig()), "PERTASK_MAX_T"),
    "K9_devices": (lambda D: A.pertask_fill_limits(
        8, A.PERTASK_MAX_D + 1, 1, A.PlacementConfig()), "PERTASK_MAX_D"),
    "K9_subgroups": (lambda D: A.pertask_fill_limits(
        8, 8, A.PERTASK_MAX_S + 1, A.PlacementConfig()), "PERTASK_MAX_S"),
    "K9_tiers": (lambda D: A.pertask_fill_limits(8, 8, 1, _tiers()),
                 "DEFAULT_TIERS"),
    "K10_lanes": (lambda D: A.dense_accept_limits(
        A.DENSE_ACCEPT_MAX_B + 1, 8), "DENSE_ACCEPT_MAX_B"),
    "K10_devices": (lambda D: A.dense_accept_limits(
        64, A.PERTASK_MAX_D + 1), "PERTASK_MAX_D"),
}


@pytest.mark.parametrize("name", sorted(KERNEL_LIMITS))
def test_kernel_limits_raise_not_implemented_naming_the_limit(name):
    """Past a kernel's shape or tier limit the card path refuses with
    ``NotImplementedError`` naming the limit (the port's contract for what
    it has not ported); at the limit it does not."""
    from kai_scheduler_tpu_torch.ops import drf as D
    call, limit = KERNEL_LIMITS[name]
    with pytest.raises(NotImplementedError, match=limit):
        call(D)
    D.divide_level_limits(D.MAX_QUEUES)
    A.type_tables_limits(A.PlacementConfig())
    A.uniform_fill_limits(A.MAX_TOPK, 10_000)
    A.pertask_fill_limits(A.PERTASK_MAX_T, A.PERTASK_MAX_D, A.PERTASK_MAX_S,
                          A.PlacementConfig())
    A.dense_accept_limits(A.DENSE_ACCEPT_MAX_B, A.PERTASK_MAX_D)
