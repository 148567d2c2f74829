"""The port's victim engine (the kernels' plain versions, which the port
runs on the CPU) against the JAX reference: ``freed_by_mask`` (K6),
``victim_candidates`` / ``_rank_eviction_units``, ``solve_for_preemptor``
per mode, ``_replace_victims`` (K7), ``run_victim_action`` per mode and
``stale_gang_eviction``.  Both sides read the same snapshot — the
reference's own leaves, carried over by ``state_from_numpy`` — at the
reference's auto-tuned config with ``VictimConfig(batch_size=1)`` (the
sequential engine), and every output must be bit-equal.  Each reference
result is computed once per case (module-scoped fixtures) to keep the
jaxlib compiles per worker few."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.ops.victims as RV
from kai_scheduler_tpu.apis import types as ref_apis
from kai_scheduler_tpu.framework.session import Session as RefSession
from kai_scheduler_tpu.framework.session import SessionConfig as RefConfig
from kai_scheduler_tpu.ops.allocate import _chain_membership as ref_chain
from kai_scheduler_tpu.ops.allocate import init_result as ref_init
from kai_scheduler_tpu.ops.stale import stale_gang_eviction as ref_stale
from kai_scheduler_tpu.state.cluster_state import \
    build_snapshot as ref_build
from kai_scheduler_tpu.state.synthetic import make_cluster as ref_make
from kai_scheduler_tpu_torch.ops import stale as S
from kai_scheduler_tpu_torch.ops import victims as V
from kai_scheduler_tpu_torch.ops.allocate import (AllocateConfig,
                                                  _chain_membership,
                                                  init_result)
from kai_scheduler_tpu_torch.state import fleets, state_from_numpy
from test_consolidation import fragmented_cluster
from test_victims import preempt_cluster, two_queue_cluster

from jax_executables import release_jax_executables  # noqa: F401

SECTIONS = ("nodes", "queues", "gangs", "running")


def leaves(state) -> dict:
    return {f"{sec}.{f.name}": np.asarray(getattr(getattr(state, sec),
                                                  f.name))
            for sec in SECTIONS
            for f in dataclasses.fields(getattr(state, sec))}


def port_victim_config(ref_vc) -> V.VictimConfig:
    pl = ref_vc.placement
    return V.VictimConfig(
        placement=AllocateConfig(**{
            f.name: getattr(pl, f.name) for f in dataclasses.fields(pl)
            if f.name != "placement"}),
        **{f.name: getattr(ref_vc, f.name)
           for f in dataclasses.fields(ref_vc) if f.name != "placement"})


@dataclasses.dataclass
class Case:
    """One snapshot on both sides at the auto-tuned sequential config."""

    ref: object        # reference ClusterState (fair share divided)
    port: object       # the port's ClusterState on the CPU
    num_levels: int
    ref_config: object
    config: V.VictimConfig
    index: object


def open_case(built, pad=None) -> Case:
    state, index = built
    ses = RefSession.from_state(state, index, RefConfig(
        victims=RV.VictimConfig(batch_size=1)))
    return Case(ses.state, state_from_numpy(leaves(ses.state), "cpu"),
                ses.config.num_levels, ses.config.victims,
                port_victim_config(ses.config.victims), index)


def assert_same(want, got, what=""):
    a = np.asarray(want)
    b = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype)
    assert a.tobytes() == b.tobytes(), what


def assert_results_equal(want, got):
    for f in dataclasses.fields(want):
        assert_same(getattr(want, f.name), getattr(got, f.name), f.name)


# ---------------------------------------------------------------------------
# the clusters
# ---------------------------------------------------------------------------

def saturated_small():
    """The saturated cell at 64 nodes: 256 running pods fill 64 x 4
    accelerators; 8 pending gangs of 8 wait in the other queues."""
    return ref_build(*ref_make(
        num_nodes=64, node_accel=4.0, num_gangs=40, tasks_per_gang=8,
        running_fraction=0.8, queue_accel_quota=6.0,
        partition_queues_by_running=True), pad=32)


def priorities_small():
    """A full cluster whose pending gangs outrank the running gangs of
    their own queues (three priority levels): preempt must evict."""
    return ref_build(*ref_make(
        num_nodes=16, node_accel=4.0, num_gangs=20, tasks_per_gang=4,
        running_fraction=0.8, priority_spread=3, pending_priority_boost=5,
        seed=2), pad=32)


def fragmented_small():
    """The fragmented cell at 24 nodes (6 pending 6-accel gangs, 3 stale
    gangs), built by the chip smoke test's own builder."""
    nodes, queues, groups, pods, now = fleets.fragmented_objects(
        ref_apis, num_nodes=24, pending=6, stale=3)
    return ref_build(nodes, queues, groups, pods, now=now, pad=32)


def elastic_hierarchy():
    """Two departments; an elastic running gang (quorum 2 of 5) and a
    minruntime-protected gang in one, a reclaimer in the other."""
    Vec, QR = ref_apis.ResourceVec, ref_apis.QueueResource
    nodes = [ref_apis.Node(f"n{i}", Vec(4.0, 64.0, 256.0)) for i in range(3)]
    queues = [ref_apis.Queue("d0", accel=QR(quota=6.0)),
              ref_apis.Queue("d1", accel=QR(quota=6.0)),
              ref_apis.Queue("a", parent="d0", accel=QR(quota=3.0),
                             reclaim_min_runtime=50.0),
              ref_apis.Queue("b", parent="d0", accel=QR(quota=3.0)),
              ref_apis.Queue("c", parent="d1", accel=QR(quota=6.0))]
    groups = [
        ref_apis.PodGroup("el", queue="b", min_member=2,
                          last_start_timestamp=0.0),
        ref_apis.PodGroup("young", queue="a", min_member=2,
                          creation_timestamp=1.0,
                          last_start_timestamp=80.0),
        ref_apis.PodGroup("old", queue="a", min_member=1,
                          creation_timestamp=2.0, last_start_timestamp=0.0),
        ref_apis.PodGroup("want", queue="c", min_member=3,
                          creation_timestamp=5.0)]
    pods = []
    for i in range(5):
        pods.append(ref_apis.Pod(
            f"el-{i}", "el", resources=Vec(1.0, 1.5, 4.0),
            status=ref_apis.PodStatus.RUNNING, node=f"n{i % 3}",
            creation_timestamp=float(i)))
    for i in range(3):
        pods.append(ref_apis.Pod(
            f"young-{i}", "young", resources=Vec(1.0, 1.0, 4.0),
            status=ref_apis.PodStatus.RUNNING, node=f"n{i % 3}"))
    for i in range(2):
        pods.append(ref_apis.Pod(
            f"old-{i}", "old", resources=Vec(1.0, 1.0, 4.0),
            status=ref_apis.PodStatus.RUNNING, node=f"n{(i + 1) % 3}"))
    for i in range(3):
        pods.append(ref_apis.Pod(f"want-{i}", "want",
                                 resources=Vec(1.0, 1.0, 4.0),
                                 creation_timestamp=5.0))
    return ref_build(nodes, queues, groups, pods, now=100.0, pad=32)


CLUSTERS = {
    "two_queue": two_queue_cluster,
    "preempt": preempt_cluster,
    "fragmented": fragmented_cluster,
    "saturated_small": saturated_small,
    "priorities_small": priorities_small,
    "fragmented_small": fragmented_small,
    "elastic_hierarchy": elastic_hierarchy,
}


@functools.lru_cache(maxsize=None)
def case(name: str) -> Case:
    return open_case(CLUSTERS[name]())


def fractional_leaves(c: Case, seed: int, memory_scale: bool):
    """The case's leaves with fractional cpu requests, GiB-to-TiB memory
    requests (``memory_scale``), fractional accel shares on devices (some
    memory-based), whole-device bit masks, and queues scattered over the
    pod axis — summation order changes the bits."""
    lv = leaves(c.ref)
    rng = np.random.default_rng(seed)
    M = lv["running.req"].shape[0]
    D = lv["nodes.device_free"].shape[1]
    req = lv["running.req"].copy()
    req[:, 1] = rng.uniform(0.1, 3.0, M)
    if memory_scale:
        req[:, 2] = rng.uniform(1, 10, M) * 10 ** rng.uniform(0, 7, M)
    lv["running.req"] = req.astype(np.float32)
    frac = rng.random(M) < 0.3
    lv["running.device"] = np.where(frac, rng.integers(0, D, M),
                                    -1).astype(np.int32)
    lv["running.accel_held"] = np.where(
        frac, rng.uniform(0.05, 0.9, M), 0.0).astype(np.float32)
    lv["running.accel_mem"] = np.where(
        frac & (rng.random(M) < 0.5), rng.uniform(1.0, 12.0, M),
        0.0).astype(np.float32)
    lv["running.devices_mask"] = np.where(
        frac, 0, rng.integers(0, 2 ** min(D, 8), M)).astype(np.int32)
    Q = lv["queues.parent"].shape[0]
    lv["running.queue"] = rng.integers(0, Q, M).astype(np.int32)
    lv["running.preemptible"] = rng.random(M) < 0.7
    r = c.ref.running
    ref = c.ref.replace(running=r.replace(**{
        k.split(".")[1]: jnp.asarray(v) for k, v in lv.items()
        if k.startswith("running.")}))
    return ref, state_from_numpy(lv, "cpu")


# ---------------------------------------------------------------------------
# K6 freed_by_mask
# ---------------------------------------------------------------------------

_ref_freed = jax.jit(RV.freed_by_mask)


@pytest.mark.parametrize("memory_scale", [False, True],
                         ids=["fractional", "memory_scale"])
def test_freed_by_mask_bit_equal(memory_scale):
    c = case("saturated_small")
    ref, port = fractional_leaves(c, 3, memory_scale)
    chain = _chain_membership(port.queues.parent, c.num_levels)
    rchain = ref_chain(ref.queues.parent, c.num_levels)
    rng = np.random.default_rng(4)
    for p in (0.1, 0.6, 1.0):
        mask = rng.random(port.running.m) < p
        want = _ref_freed(ref, jnp.asarray(mask), rchain)
        got = V.freed_by_mask(port, torch.from_numpy(mask), chain)
        for i, (w, g) in enumerate(zip(want, got, strict=True)):
            assert_same(w, g, f"output {i} p={p}")


@pytest.mark.parametrize("name", ["saturated_small", "priorities_small",
                                  "fragmented_small", "elastic_hierarchy"])
@pytest.mark.parametrize("fractional", [False, True])
def test_freed_by_mask_queues_only_equals_reference(name, fractional):
    """K6's queue-only mode (reclaim's ``freeable`` bound) through the
    plain version: the rolled-up queue tables of the reference's
    ``freed_by_mask``, bit for bit, on the victim parity snapshots (as
    built, and with fractional and memory-scale requests)."""
    c = case(name)
    ref, port = (fractional_leaves(c, 7, True) if fractional
                 else (c.ref, c.port))
    chain = _chain_membership(port.queues.parent, c.num_levels)
    rchain = ref_chain(ref.queues.parent, c.num_levels)
    rng = np.random.default_rng(len(name))
    for p in (0.0, 0.3, 1.0):
        mask = rng.random(port.running.m) < p
        want = _ref_freed(ref, jnp.asarray(mask), rchain)
        got = V.freed_by_mask(port, torch.from_numpy(mask), chain,
                              queues_only=True)
        assert len(got) == 2
        for i, g in enumerate(got):
            assert_same(want[2 + i], g, f"queue output {i} p={p}")


def _tree_sum(x: np.ndarray) -> np.float32:
    """A pairwise tree over ``x`` in f32 (adjacent pairs, an odd last
    element carried up)."""
    x = x.astype(np.float32)
    while x.size > 1:
        odd = x[-1:] if x.size % 2 else x[:0]
        x = np.concatenate([x[:x.size // 2 * 2:2] + x[1:x.size // 2 * 2:2],
                            odd]).astype(np.float32)
    return x[0] if x.size else np.float32(0.0)


def _queue_sums(values: np.ndarray, queue: np.ndarray, Q: int):
    """The plain K6's leaf queue sums (an identity chain: no roll-up) of
    ``values`` as pod requests, every pod masked."""
    c = case("saturated_small")
    lv = leaves(c.ref)
    M = values.shape[0]
    lv = {k: (v[:M] if k.startswith("running.") else v)
          for k, v in lv.items()}
    req = np.zeros((M, 3), np.float32)
    req[:, 0] = values
    lv["running.req"] = req
    lv["running.queue"] = queue.astype(np.int32)
    port = state_from_numpy(lv, "cpu")
    eye = torch.eye(port.queues.q, dtype=torch.bool)
    return V.freed_by_mask(port, torch.ones(M, dtype=torch.bool), eye,
                           queues_only=True)[0][:Q, 0].numpy()


@pytest.mark.parametrize("seed", range(6))
def test_whole_sums_below_2p24_are_order_free(seed):
    """The argument K6's tree sums rest on: whole-number f32 summands
    (either sign) whose magnitudes sum below 2^24 give the same bits in
    the plain version's ascending order, in a shuffled order and in a
    pairwise tree."""
    rng = np.random.default_rng(seed)
    M = int(rng.integers(2, 256))
    scale = float(rng.choice([1.0, 100.0, 60_000.0]))
    x = np.round(rng.uniform(-1, 1, M) * scale).astype(np.float32)
    if np.abs(x).sum() >= 2 ** 24:
        x = np.round(x / 4).astype(np.float32)
    assert np.abs(x.astype(np.float64)).sum() < 2 ** 24
    asc = _queue_sums(x, np.zeros(M), 1)[0]
    assert asc.tobytes() == np.float32(x.astype(np.float64).sum()).tobytes()
    for perm in (rng.permutation(M), rng.permutation(M)):
        shuffled = np.float32(0.0)
        for v in x[perm]:
            shuffled = np.float32(shuffled + v)
        assert shuffled.tobytes() == asc.tobytes()
        assert _tree_sum(x[perm]).tobytes() == asc.tobytes()


def test_fractional_sums_depend_on_order():
    """Why K6 keeps the ascending serial sum for fractional summands:
    their f32 sums differ between orders."""
    x = np.array([0.1, 0.2, 0.3, 1e8, -1e8, 0.7] * 8, np.float32)
    asc = _queue_sums(x, np.zeros(x.size), 1)[0]
    tree = _tree_sum(x)
    assert asc.tobytes() != tree.tobytes()


# ---------------------------------------------------------------------------
# victim ranking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mode,prior", [
    ("elastic_hierarchy", "reclaim", 0),
    ("elastic_hierarchy", "reclaim", 2),
    ("priorities_small", "preempt", 0),
    ("fragmented_small", "consolidate", 3),
])
def test_victim_candidates_and_unit_ranks_bit_equal(name, mode, prior):
    """Elastic surplus units, minruntime protection (quorum kept, surplus
    exposed) and victims accumulated earlier in the cycle (``prior`` of
    the candidates already removed)."""
    c = case(name)
    gi = int(np.nonzero(np.asarray(c.ref.gangs.valid))[0][0])
    fs = c.ref.queues.fair_share
    statics = RV.victim_statics(c.ref)
    already = np.zeros((c.port.running.m,), bool)
    cand0, _ = RV.victim_candidates(c.ref, jnp.asarray(gi), mode=mode,
                                    already_victim=jnp.asarray(already),
                                    statics=statics)
    already[np.nonzero(np.asarray(cand0))[0][:prior]] = True
    want_c, want_p = RV.victim_candidates(
        c.ref, jnp.asarray(gi), mode=mode,
        already_victim=jnp.asarray(already), statics=statics)
    got_c, got_p = V.victim_candidates(
        c.port, gi, mode=mode, already_victim=torch.from_numpy(already))
    assert_same(want_c, got_c, "cand")
    assert_same(want_p, got_p, "protected")
    want_u, want_n = RV._rank_eviction_units(
        c.ref, want_c, c.ref.queues.allocated, fs, jnp.asarray(already),
        want_p)
    got_u, got_n = V._rank_eviction_units(
        c.port, got_c, c.port.queues.allocated, c.port.queues.fair_share,
        torch.from_numpy(already), got_p)
    assert_same(want_u, got_u, "unit_rank")
    assert_same(want_n, got_n, "num_units")
    assert int(got_n) >= 1


# ---------------------------------------------------------------------------
# one preemptor's scenario search
# ---------------------------------------------------------------------------

SOLVES = {"reclaim": "saturated_small", "preempt": "priorities_small",
          "consolidate": "fragmented_small"}


@pytest.fixture(scope="module", params=sorted(SOLVES))
def solved(request):
    mode = request.param
    c = case(SOLVES[mode])
    gi = int(np.nonzero(np.asarray(c.ref.gangs.valid))[0][0])
    fs = c.ref.queues.fair_share
    solve = jax.jit(functools.partial(
        RV.solve_for_preemptor, num_levels=c.num_levels, mode=mode,
        config=c.ref_config))
    want = jax.device_get(solve(
        c.ref, jnp.asarray(gi), ref_init(c.ref), fs,
        ref_chain(c.ref.queues.parent, c.num_levels)))
    init = init_result(c.port)
    got = V.solve_for_preemptor(
        c.port, gi, init, c.port.queues.fair_share,
        num_levels=c.num_levels, mode=mode, config=c.config,
        act=V.action_context(c.port, init, c.port.queues.fair_share,
                             num_levels=c.num_levels))
    return mode, c, want, got


def test_solve_for_preemptor_bit_equal(solved):
    mode, c, want, got = solved
    (success, victims, nodes_t, dev_t, pipe_t, moves, free2, dev2, extra2,
     extra_dev2, qa2, qan2, ext2, ext_extra2) = want
    assert bool(success), "the case must exercise a successful scenario"
    assert got is not None
    (g_victims, g_nodes, g_dev_t, g_pipe, g_moves, g_free, g_dev, g_extra,
     g_extra_dev, g_qa, g_qan, g_ext, g_ext_extra) = got
    assert g_dev_t is None      # the uniform path places no devices
    if g_moves is None:
        g_moves = torch.full((c.port.running.m,), -1, dtype=torch.int32)
    assert np.all(np.asarray(dev_t) == -1)
    for what, w, g in (("victims", victims, g_victims),
                       ("nodes_t", nodes_t, g_nodes),
                       ("pipe_t", pipe_t, g_pipe), ("moves", moves, g_moves),
                       ("free", free2, g_free), ("device_free", dev2, g_dev),
                       ("extra", extra2, g_extra),
                       ("extra_dev", extra_dev2, g_extra_dev),
                       ("qa", qa2, g_qa), ("qan", qan2, g_qan),
                       ("ext", ext2, g_ext), ("ext_extra", ext_extra2,
                                              g_ext_extra)):
        assert_same(w, g, what)
    assert bool(g_victims.any())
    if mode == "consolidate":
        assert bool((g_moves >= 0).any())


# ---------------------------------------------------------------------------
# K7 _replace_victims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ties", "fractional", "over_cap"])
def test_replace_victims_bit_equal(kind):
    """``ties``: identical nodes, whole-device victims (the lowest index
    wins); ``fractional``: shares on devices, some memory-based;
    ``over_cap``: more victims than ``max_pods`` (the first K still
    re-place, the scenario is rejected)."""
    c = case("fragmented_small")
    if kind == "ties":
        ref, port = c.ref, c.port
    else:
        ref, port = fractional_leaves(c, 7, memory_scale=False)
    rng = np.random.default_rng({"ties": 0, "fractional": 1,
                                 "over_cap": 2}[kind])
    p, max_pods = (0.4, 4) if kind == "over_cap" else (0.15, 512)
    mask = rng.random(port.running.m) < p
    mask &= np.asarray(ref.running.valid)
    n, rn = port.nodes, ref.nodes
    want = jax.jit(RV._replace_victims, static_argnames=("max_pods",))(
        ref, jnp.asarray(mask), rn.free, rn.device_free, rn.releasing,
        rn.device_releasing, rn.extended_free, rn.extended_releasing,
        max_pods=max_pods)
    got = V.replace_victims(
        port, torch.from_numpy(mask), n.free, n.device_free, n.releasing,
        n.device_releasing, n.extended_free, n.extended_releasing, max_pods)
    for i, (w, g) in enumerate(zip(want, got, strict=True)):
        assert_same(w, g, f"output {i}")
    if kind == "over_cap":
        assert mask.sum() > max_pods and not bool(got[4])
    else:
        assert bool((got[3] >= 0).any())


# ---------------------------------------------------------------------------
# the actions
# ---------------------------------------------------------------------------

ACTIONS = [("two_queue", "reclaim"), ("saturated_small", "reclaim"),
           ("elastic_hierarchy", "reclaim"), ("preempt", "preempt"),
           ("priorities_small", "preempt"), ("fragmented", "consolidate"),
           ("fragmented_small", "consolidate")]


@pytest.fixture(scope="module", params=ACTIONS,
                ids=[f"{m}-{n}" for n, m in ACTIONS])
def acted(request):
    name, mode = request.param
    c = case(name)
    want = jax.device_get(RV.run_victim_action_jit(
        c.ref, c.ref.queues.fair_share, ref_init(c.ref),
        num_levels=c.num_levels, mode=mode, config=c.ref_config))
    got, stats = V.run_victim_action_counted(
        c.port, c.port.queues.fair_share, init_result(c.port),
        num_levels=c.num_levels, mode=mode, config=c.config)
    return c, want, got, stats


def test_run_victim_action_bit_equal(acted):
    c, want, got, stats = acted
    assert_results_equal(want, got)
    assert bool(got.victim.any()) and bool(got.allocated.any())
    assert stats.steps >= 1 and stats.attempts >= 1
    assert stats.syncs >= stats.steps + stats.attempts


def test_stale_gang_eviction_bit_equal():
    c = case("fragmented_small")
    for grace in (60.0, 500.0):
        want = jax.device_get(jax.jit(
            ref_stale, static_argnames=("grace_s", "num_levels"))(
                c.ref, ref_init(c.ref), grace_s=grace,
                num_levels=c.num_levels))
        got = S.stale_gang_eviction(c.port, init_result(c.port),
                                    grace_s=grace, num_levels=c.num_levels)
        assert_results_equal(want, got)
        assert int(got.victim.sum()) == (3 if grace == 60.0 else 0)


def test_reclaim_without_chunking_is_sequential_at_any_batch_size():
    """The reference runs reclaim through the sequential engine whenever
    ``chunk_reclaim`` is off (per-pair minruntime tables), whatever
    ``batch_size``: so does the port."""
    c = case("elastic_hierarchy")
    ref_cfg = dataclasses.replace(c.ref_config, batch_size=64,
                                  chunk_reclaim=False)
    want = jax.device_get(RV.run_victim_action_jit(
        c.ref, c.ref.queues.fair_share, ref_init(c.ref),
        num_levels=c.num_levels, mode="reclaim", config=ref_cfg))
    got = V.run_victim_action(
        c.port, c.port.queues.fair_share, init_result(c.port),
        num_levels=c.num_levels, mode="reclaim",
        config=port_victim_config(ref_cfg))
    assert_results_equal(want, got)


def test_unported_placement_raises():
    """Subgroup and required topology stay refused by name (the per-task
    path and the device table run since the victim actions ported them)."""
    c = case("two_queue")
    cfg = dataclasses.replace(c.config, placement=dataclasses.replace(
        c.config.placement, uniform_tasks=False, subgroup_topology=True))
    with pytest.raises(NotImplementedError, match="subgroup_topology"):
        V.run_victim_action(c.port, c.port.queues.fair_share,
                            init_result(c.port), num_levels=c.num_levels,
                            mode="consolidate", config=cfg)
