"""The port's DRF division (K1's plain version, which the port runs on the
CPU) against the JAX reference: ``fair_share`` f32 bit-equal on the
snapshot shapes and on numpy-random queue tables whose limits, weights and
priorities make the tier and water-fill loops run more than one round."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.state.cluster_state as ref_cs
from kai_scheduler_tpu.ops import drf as ref_drf
from kai_scheduler_tpu.state.synthetic import make_cluster as ref_make
from kai_scheduler_tpu_torch.ops import drf
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
}

_ref_fair_share = jax.jit(ref_drf.set_fair_share,
                          static_argnames=("num_levels",))
_ref_divide = jax.jit(jax.vmap(
    ref_drf._divide_one_resource,
    in_axes=(1, 1, 1, 1, 1, 1, None, None, None, None, None), out_axes=1))


def ref_leaves(state) -> dict:
    return {f"{sec}.{f.name}": np.asarray(getattr(getattr(state, sec), f.name))
            for sec in SECTIONS
            for f in dataclasses.fields(getattr(state, sec))}


def bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a, np.float32)).tobytes()


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("k_value", [0.0, 0.5])
def test_fair_share_bit_equal_on_snapshots(name, k_value):
    ref_state, _ = ref_cs.build_snapshot(*ref_make(**SHAPES[name]), pad=32)
    want = _ref_fair_share(ref_state, num_levels=2, k_value=k_value)
    port = state_from_numpy(ref_leaves(ref_state), "cpu")
    got = drf.set_fair_share(port, num_levels=2, k_value=k_value)
    assert bits(got) == bits(want)


def random_tables(seed: int, Q: int = 12, R: int = 3):
    """One level's queue tables: sibling segments under three parents,
    deserved quotas (some UNLIMITED), weights (some 0), limits (some
    UNLIMITED), fractional requests, usage, three priorities, some
    inactive queues, k in {0, 0.5}."""
    rng = np.random.default_rng(seed)
    S = Q + 1
    parent = np.where(rng.random(Q) < 0.5, -1, rng.integers(0, 3, Q))
    return dict(
        seg_total=rng.integers(5, 60, (S, R)).astype(np.float32),
        quota=np.where(rng.random((Q, R)) < 0.2, -1.0,
                       rng.integers(0, 8, (Q, R))).astype(np.float32),
        weight=rng.choice([0.0, 0.5, 1.0, 2.0, 3.0], (Q, R)).astype(
            np.float32),
        limit=np.where(rng.random((Q, R)) < 0.5, -1.0,
                       rng.integers(1, 30, (Q, R))).astype(np.float32),
        request=(rng.integers(0, 40, (Q, R))
                 + rng.random((Q, R)).round(1)).astype(np.float32),
        usage=(rng.random((Q, R)) * 0.3).astype(np.float32),
        priority=rng.integers(0, 3, Q).astype(np.int32),
        seg=np.where(parent >= 0, parent + 1, 0).astype(np.int32),
        creation=rng.permutation(Q).astype(np.int32),
        active=rng.random(Q) < 0.85,
        k_value=np.float32(rng.choice([0.0, 0.5])),
    )


_ORDER = ("seg_total", "quota", "weight", "limit", "request", "usage",
          "priority", "seg", "creation", "active", "k_value")


@pytest.mark.parametrize("seed", range(24))
def test_divide_level_bit_equal_on_random_tables(seed):
    t = random_tables(seed)
    want = _ref_divide(*(t[k] for k in _ORDER))
    got = drf.divide_level_plain(
        *(torch.from_numpy(np.asarray(t[k])) for k in _ORDER))
    assert bits(got) == bits(want)


def test_random_tables_run_several_tiers_and_fill_rounds():
    """The random tables above do exercise the loops: across the seeds,
    levels run several priority tiers and tiers run several water-fill
    rounds."""
    tiers, rounds = [], []
    for seed in range(24):
        t = random_tables(seed)
        r: list = []
        drf.divide_level_plain(
            *(torch.from_numpy(np.asarray(t[k])) for k in _ORDER), rounds=r)
        tiers.append(len(r))
        rounds.extend(r)
    assert max(tiers) >= 3
    assert max(rounds) >= 2
    assert sum(n > 1 for n in rounds) >= 5


def test_wrapper_runs_the_plain_version_only_for_cpu_tensors():
    t = random_tables(3)
    args = [torch.from_numpy(np.asarray(t[k])) for k in _ORDER]
    fs, overrun = drf.drf_water_fill(*args)
    assert overrun is None
    assert torch.equal(fs, drf.divide_level_plain(*args))


def test_set_fair_share_of_deeper_hierarchy_matches_reference():
    """num_levels beyond the hierarchy depth leaves shares unchanged."""
    shape = SHAPES["hierarchy"]
    ref_state, _ = ref_cs.build_snapshot(*ref_make(**shape), pad=32)
    want = _ref_fair_share(ref_state, num_levels=3)
    port = state_from_numpy(ref_leaves(ref_state), "cpu")
    got = drf.set_fair_share(port, num_levels=3)
    assert bits(got) == bits(want)
    assert bits(got) == bits(functools.partial(
        drf.set_fair_share, num_levels=2)(port))
