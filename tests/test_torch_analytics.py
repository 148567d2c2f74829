"""The port's cluster-health pass (``ops/analytics.py``, K14's plain
version) against the JAX reference's ``cluster_analytics_jit`` on the CPU:
the same snapshot (the reference's own leaves, carried over by
``state_from_numpy``), the same perturbed free pool, commit set and
pending ages, made from a seed, after ``tests/test_analytics.py`` — on
uniform, GPU-sharing and rack-topology snapshots.

Every bundle field is byte-equal to the reference's, except the fields
built on a sum whose summands are not exact in every order (the sums over
nodes, running pods, gang tasks and queues: the port adds in a fixed
pairwise tree, XLA:CPU in an order of its own).  Those fields are held to
``rtol=1e-6``, and only after the test shows that their summands were not
exact; with whole-number summands they are byte-equal too."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kai_scheduler_tpu.apis import types as ref_apis
from kai_scheduler_tpu.framework.session import Session as RefSession
from kai_scheduler_tpu.framework.session import SessionConfig as RefConfig
from kai_scheduler_tpu.ops import analytics as RA
from kai_scheduler_tpu.ops.allocate import init_result as ref_init
from kai_scheduler_tpu.state.cluster_state import \
    build_snapshot as ref_build
from kai_scheduler_tpu.state.synthetic import make_cluster as ref_make
from kai_scheduler_tpu_torch.ops import analytics as A
from kai_scheduler_tpu_torch.ops.allocate import AllocationResult
from kai_scheduler_tpu_torch.state import fleets, state_from_numpy
from test_torch_victims import leaves

from jax_executables import release_jax_executables  # noqa: F401

#: bundle fields whose value depends on a sum's order -> the summand
#: families (see :func:`summands`) that must all be exact for byte equality
ORDER_SENSITIVE = {
    "stranded_frac": ("free_valid", "stuck"),
    "util": ("idle", "cap"),
    "goodput": ("thr_running", "thr_placed", "cap"),
    "queue_drift": ("cap",),
    "drift_max": ("cap",),
    "drift_mean": ("queue_drift", "cap"),
    "drift_gini": ("share", "pair", "cap"),
}


def exact_in_any_order(x) -> bool:
    """True when every order of summing ``x`` in f32 gives the same bits:
    every summand is a multiple of one power of two 2**-e and the sum of
    their magnitudes times 2**e stays below 2**24."""
    x = np.asarray(x, np.float64).ravel()
    if not np.isfinite(x).all():
        return False
    for e in range(0, 25):
        y = x * 2.0 ** e
        if np.all(y == np.round(y)):
            return float(np.abs(y).sum()) < 2.0 ** 24
    return False


def summands(state, result) -> dict:
    """The summand families of the pass's sums, from the port's inputs
    (numpy, the plain version's formulas)."""
    n, q, g, r = state.nodes, state.queues, state.gangs, state.running
    valid = n.valid.numpy()[:, None]
    free = np.maximum(n.free.numpy(), 0.0)
    cap_n = np.where(valid, n.allocatable.numpy(), 0.0)
    units = A.unit_pods_per_node(
        torch.clamp(n.free, min=0.0), n.valid,
        torch.tensor(A.AnalyticsConfig().unit_req)).numpy()
    free_valid = np.where(valid, free, 0.0)
    idle = np.where(valid, np.maximum(result.free.numpy(), 0.0)
                    + np.maximum(n.releasing.numpy()
                                 + result.releasing_extra.numpy(), 0.0), 0.0)
    surviving = (r.valid & ~r.releasing & ~result.victim).numpy()
    placed = ((result.placements >= 0) & g.task_valid
              & result.allocated[:, None] & ~result.pipelined).numpy()
    cap = cap_n.astype(np.float32).sum(0, dtype=np.float64)
    cap1 = np.maximum(cap, 1.0)
    qa, fs = result.queue_allocated.numpy(), q.fair_share.numpy()
    qv = q.valid.numpy()
    drift = np.where(qv, (np.abs(qa - fs) / cap1).max(1), 0.0)
    share = np.where(qv, (qa / cap1).max(1), 0.0)
    return dict(
        units=units, free_valid=free_valid,
        stuck=np.where((units <= 0)[:, None], free_valid, 0.0),
        cap=cap_n, idle=idle,
        thr_running=np.where(surviving, r.req.numpy()[:, 0], 0.0),
        thr_placed=np.where(placed, g.task_req.numpy()[:, :, 0], 0.0),
        queue_drift=drift, share=share,
        pair=np.abs(share[:, None] - share[None, :])
        * (qv[:, None] & qv[None, :]))


def _column(family: np.ndarray, i):
    return family if i is None or family.ndim < 2 else family[..., i]


def assert_bundle_matches(want: dict, got: dict, fam: dict) -> list:
    """``want``/``got``: field -> numpy array.  Byte equality everywhere but
    the order-sensitive fields whose summands are not exact (those: rtol
    1e-6).  Returns the fields held to the tolerance."""
    assert exact_in_any_order(fam["units"]), "unit pods must be exact"
    loose = []
    for f in A.F32_FIELDS + A.I32_FIELDS:
        a, b = np.asarray(want[f]), np.asarray(got[f])
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.tobytes() == b.tobytes():
            continue
        need = ORDER_SENSITIVE.get(f)
        assert need is not None, f"{f} differs: {a} vs {b}"
        # per-resource fields depend on that resource's column only
        cols = range(a.shape[0]) if f in ("stranded_frac", "util") \
            else [None]
        for i in cols:
            ai, bi = (a, b) if i is None else (a[i], b[i])
            if ai.tobytes() == bi.tobytes():
                continue
            fams = [_column(fam[k], i if k in ("free_valid", "stuck",
                                              "idle", "cap") else None)
                    for k in need]
            if f in ("goodput",):
                fams[-1] = fam["cap"][:, 0]
            assert not all(exact_in_any_order(x) for x in fams), \
                f"{f}[{i}] differs although its summands are exact"
            if f == "util":
                # util = 1 - sum(idle) / cap: the tolerance holds the
                # order-sensitive quotient, not the difference's cancellation
                ai, bi = 1.0 - ai.astype(np.float64), \
                    1.0 - bi.astype(np.float64)
            np.testing.assert_allclose(bi, ai, rtol=1e-6, atol=0,
                                       err_msg=f)
        loose.append(f)
    return loose


def port_result(ref_res) -> AllocationResult:
    return AllocationResult(**{
        f.name: torch.from_numpy(np.array(getattr(ref_res, f.name)))
        for f in dataclasses.fields(AllocationResult)})


def _uniform():
    return ref_build(*ref_make(num_nodes=12, num_gangs=10, tasks_per_gang=2,
                               running_fraction=0.5, topology_levels=(3,),
                               seed=0), now=100.0, pad=32)


def _topology():
    return ref_build(*ref_make(num_nodes=40, num_gangs=24, tasks_per_gang=4,
                               running_fraction=0.4,
                               topology_levels=(2, 4),
                               required_level="topo/level1", seed=1),
                     now=100.0, pad=32)


def _sharing():
    return ref_build(*fleets.sharing_objects(
        ref_apis, num_nodes=24, shared_nodes=12, training=2, fractions=10,
        memory=6, launchers=1, seed=2), pad=32)


SNAPSHOTS = {"uniform": _uniform, "topology": _topology,
             "sharing": _sharing}


def case(name: str, seed: int):
    """(ref state, ref result, port state, port result, ages): the
    snapshot's fair share divided by the reference Session, its free pool
    lowered by whole or fractional amounts, and a commit set whose
    allocated flags, queue ledger, post-decision pool, victims and
    placements are drawn from the seed."""
    state, index = SNAPSHOTS[name]()
    state = RefSession.from_state(state, index, RefConfig()).state
    rng = np.random.default_rng(seed)
    G, T = state.gangs.g, state.gangs.t
    M = state.running.m
    lv = leaves(state)
    drop = rng.integers(0, 3, lv["nodes.free"].shape).astype(np.float32)
    if seed % 2:
        drop = drop * np.float32(0.3)
    lv["nodes.free"] = np.maximum(lv["nodes.free"] - drop, 0.0)
    state = state.replace(nodes=state.nodes.replace(
        free=jnp.asarray(lv["nodes.free"])))
    res = ref_init(state)
    placements = np.where(rng.random((G, T)) < 0.5,
                          rng.integers(0, state.nodes.n, (G, T)),
                          -1).astype(np.int32)
    res = res.replace(
        allocated=jnp.asarray(rng.random(G) < 0.3),
        placements=jnp.asarray(placements),
        pipelined=jnp.asarray(rng.random((G, T)) < 0.2),
        victim=jnp.asarray(rng.random(M) < 0.2),
        free=jnp.maximum(state.nodes.free - jnp.asarray(
            rng.integers(0, 2, lv["nodes.free"].shape).astype(np.float32)),
            0.0),
        queue_allocated=state.queues.allocated + jnp.asarray(
            rng.integers(0, 5, lv["queues.allocated"].shape)
            .astype(np.float32)))
    ages = np.where(np.asarray(state.gangs.valid),
                    rng.integers(0, 6, G), 0).astype(np.float32)
    return (state, res, state_from_numpy(lv, "cpu"), port_result(res),
            ages)


def _fields(bundle) -> dict:
    return {f: np.asarray(getattr(bundle, f))
            for f in A.F32_FIELDS + A.I32_FIELDS}


@pytest.mark.parametrize("name,seed", [(n, s) for n in sorted(SNAPSHOTS)
                                       for s in (0, 1, 2)])
def test_bundle_matches_reference(name, seed):
    state, res, pstate, pres, ages = case(name, seed)
    cfg = RA.AnalyticsConfig()
    want = _fields(RA.cluster_analytics_jit(state, res, ages, config=cfg))
    got = A.cluster_analytics(pstate, pres, torch.from_numpy(ages),
                              config=A.AnalyticsConfig())
    loose = assert_bundle_matches(want, _fields(got), summands(pstate, pres))
    # the histogram, ladder, unit pods, starvation table and counts never
    # depend on an order
    assert not set(loose) & {"free_hist", "ladder_cluster_ok",
                             "ladder_rack_ok", "total_units",
                             "max_rack_units", "frag_score", "starv_age",
                             "starv_gang", "pending_gangs"}
    if name == "sharing" and seed % 2:
        assert "stranded_frac" in loose or "util" in loose


def test_all_tie_ages_and_rack_levels():
    """Every age before the cycle 0 (the top-K is two runs of ties: the
    lower index first), the rack level at each level and beyond the
    snapshot's levels (clamped), a node without the rack label (its own
    domain)."""
    state, res, pstate, pres, ages = case("topology", 3)
    topo = np.asarray(state.nodes.topology).copy()
    topo[0, 0] = -1
    state = state.replace(nodes=state.nodes.replace(
        topology=jnp.asarray(topo)))
    pstate = dataclasses.replace(pstate, nodes=dataclasses.replace(
        pstate.nodes, topology=torch.from_numpy(topo)))
    zeros = np.zeros_like(ages)
    for rl in (0, 1, 5):
        want = _fields(RA.cluster_analytics_jit(
            state, res, zeros, config=RA.AnalyticsConfig(rack_level=rl,
                                                         top_k=16)))
        got = _fields(A.cluster_analytics(
            pstate, pres, torch.from_numpy(zeros),
            config=A.AnalyticsConfig(rack_level=rl, top_k=16)))
        assert_bundle_matches(want, got, summands(pstate, pres))
        # ages 1 (still pending) and 0 tie in two runs: lower index first
        age_next = (pstate.gangs.valid & ~pres.allocated).numpy()
        want_idx = np.lexsort((np.arange(age_next.size), ~age_next))[:16]
        assert np.array_equal(got["starv_gang"], want_idx)


def test_tree_sum_order():
    """``tree_sum`` pads to a power of two and adds adjacent pairs."""
    x = torch.tensor([1e8, 1.0, -1e8, 1.0, 0.5], dtype=torch.float32)
    # ((1e8 + 1) + (-1e8 + 1)) + ((0.5 + 0) + 0): the pairs round first
    assert float(A.tree_sum(x)) == float(
        (np.float32(1e8) + np.float32(1.0))
        + (np.float32(-1e8) + np.float32(1.0))) + 0.5
    assert A.tree_sum(torch.zeros((0, 3))).shape == (3,)
    cols = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    assert torch.equal(A.tree_sum(cols), cols.sum(0))


def test_flatten_unpack_round_trip():
    _, _, pstate, pres, ages = case("uniform", 0)
    cfg = A.AnalyticsConfig()
    b = A.cluster_analytics(pstate, pres, torch.from_numpy(ages),
                            config=cfg)
    f32, i32 = A.flatten(b)
    q, g = pstate.queues.q, pstate.gangs.g
    assert f32.shape[0] == A.f32_len(cfg, q=q, r=3, g=g)
    assert i32.shape[0] == A.i32_len(cfg, q=q, r=3, g=g)
    assert A.f32_len(cfg, q=q, r=3, g=g) == RA.f32_len(
        RA.AnalyticsConfig(), q=q, r=3, g=g)
    d = A.host_unpack(f32.numpy(), i32.numpy(), config=cfg, q=q, r=3, g=g)
    for f in A.F32_FIELDS + A.I32_FIELDS:
        assert np.asarray(d[f]).tobytes() == \
            getattr(b, f).numpy().tobytes(), f
    views = A.AnalyticsBundle(**A.host_unpack(f32, i32, config=cfg, q=q,
                                              r=3, g=g))
    assert _fields(views).keys() == _fields(b).keys()
    assert all(np.array_equal(_fields(views)[f], _fields(b)[f])
               for f in _fields(b))


def test_config_matches_reference():
    assert dataclasses.asdict(A.AnalyticsConfig()) == \
        dataclasses.asdict(RA.AnalyticsConfig())
    assert A.F32_FIELDS == RA.F32_FIELDS and A.I32_FIELDS == RA.I32_FIELDS
