"""The port's chunked victim wavefront (reclaim and preempt at
``batch_size > 1``, the reference's default ``VictimConfig``) against the
JAX reference, on the CPU: the kernels' plain versions, with K8
``freed_by_lane`` alone too.  Both sides read the same ``pad=32``
snapshot — the reference's own leaves, carried over by
``state_from_numpy`` — at the reference Session's auto-tuned config with
the test's overrides, and every ``AllocationResult`` field (placements,
victims, queue tables, ``wavefront_stats``, ...) must be bit-equal.  The
shapes mirror ``tests/test_victims_chunked.py``: the many-queue preempt
family on the sparse and the dense path at B in {8, 64, 256}, partitioned
reclaim at B in {8, 64}, the leftover-demotion snapshot, the sparse
overflow fallback, a queue-depth budget and fractional requests."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.ops.victims as RV
from kai_scheduler_tpu.framework.session import Session as RefSession
from kai_scheduler_tpu.framework.session import SessionConfig as RefConfig
from kai_scheduler_tpu.ops.allocate import _chain_membership as ref_chain
from kai_scheduler_tpu.ops.allocate import init_result as ref_init
from kai_scheduler_tpu.state.cluster_state import \
    build_snapshot as ref_build
from kai_scheduler_tpu.state.synthetic import make_cluster as ref_make
from kai_scheduler_tpu_torch.ops import victims as V
from kai_scheduler_tpu_torch.ops.allocate import (_chain_membership,
                                                  init_result)
from kai_scheduler_tpu_torch.state import state_from_numpy
from test_torch_victims import (assert_results_equal, assert_same, leaves,
                                port_victim_config)
from test_victims_chunked import _leftover_session

from jax_executables import release_jax_executables  # noqa: F401


@dataclasses.dataclass
class Snap:
    """One snapshot on both sides at the reference Session's auto-tuned
    (default, chunked) victim config."""

    ref: object
    port: object
    num_levels: int
    ref_config: object


def open_snap(built) -> Snap:
    state, index = built
    ses = RefSession.from_state(state, index, RefConfig())
    return Snap(ses.state, state_from_numpy(leaves(ses.state), "cpu"),
                ses.config.num_levels, ses.config.victims)


def many_queue():
    """16 leaf queues, each with a boosted pending preemptor over a
    saturated share of running gangs (the production steady state of the
    sparse path)."""
    return ref_build(*ref_make(
        num_nodes=48, node_accel=2.0, num_gangs=64, tasks_per_gang=2,
        running_fraction=48 / 64, num_departments=2, queues_per_department=8,
        pending_priority_boost=100, seed=0), pad=32)


def partitioned():
    """Over-quota running gangs in half the leaf queues, under-share
    reclaimers in the other half."""
    return ref_build(*ref_make(
        num_nodes=48, node_accel=4.0, num_gangs=24, tasks_per_gang=4,
        running_fraction=0.5, num_departments=2, queues_per_department=4,
        queue_accel_quota=8.0, partition_queues_by_running=True, seed=0),
        pad=32)


def overflow():
    """Two leaf queues with ten running gangs each: more candidate units
    per queue than a ``sparse_unit_k`` of 8 holds."""
    return ref_build(*ref_make(
        num_nodes=24, node_accel=2.0, num_gangs=24, tasks_per_gang=2,
        running_fraction=20 / 24, num_departments=1, queues_per_department=2,
        pending_priority_boost=100, seed=0), pad=32)


def wide_gangs():
    """8-task gangs over 8-accel nodes: each victim gang spreads over
    several nodes, so earlier lanes' claims shift later lanes' ties."""
    return ref_build(*ref_make(
        num_nodes=64, node_accel=8.0, num_gangs=80, tasks_per_gang=8,
        running_fraction=64 / 80, num_departments=2, queues_per_department=8,
        pending_priority_boost=100, seed=3), pad=32)


SNAPS = {"many_queue": many_queue, "partitioned": partitioned,
         "overflow": overflow, "wide_gangs": wide_gangs}


@functools.lru_cache(maxsize=None)
def snap(name: str) -> Snap:
    return open_snap(SNAPS[name]())


def fractional(s: Snap, seed: int) -> Snap:
    """``s`` with fractional cpu and GiB-to-TiB memory requests on the
    running pods (the victims whose freed capacity every lane sums) — the
    summation order decides the bits.  The preemptors' claims stay whole
    replicas (K4 sums them in no fixed order; see ``sparse_accept``)."""
    lv = leaves(s.ref)
    rng = np.random.default_rng(seed)
    M = lv["running.req"].shape[0]
    req = lv["running.req"].copy()
    req[:, 1] = rng.uniform(0.1, 3.0, M)
    req[:, 2] = rng.uniform(1, 10, M) * 10 ** rng.uniform(0, 3, M)
    lv["running.req"] = req.astype(np.float32)
    r = s.ref.running
    ref = s.ref.replace(running=r.replace(req=jnp.asarray(lv["running.req"])))
    return Snap(ref, state_from_numpy(lv, "cpu"), s.num_levels,
                s.ref_config)


def run_both(s: Snap, mode: str, **overrides):
    ref_cfg = dataclasses.replace(s.ref_config, **overrides)
    want = jax.device_get(RV.run_victim_action_jit(
        s.ref, s.ref.queues.fair_share, ref_init(s.ref),
        num_levels=s.num_levels, mode=mode, config=ref_cfg))
    got, stats = V.run_victim_action_counted(
        s.port, s.port.queues.fair_share, init_result(s.port),
        num_levels=s.num_levels, mode=mode,
        config=port_victim_config(ref_cfg))
    return want, got, stats


def check(want, got, stats, mode: str):
    assert_results_equal(want, got)
    row = V._STATS_ROW[mode]
    ws = got.wavefront_stats.numpy()[row]
    assert ws[0] >= 1, "the chunked path must have run"
    assert stats.steps == ws[0] and stats.attempts == ws[1]
    assert stats.syncs >= stats.steps
    assert bool(got.victim.any()) and bool(got.allocated.any())


# ---------------------------------------------------------------------------
# preempt: the sparse (optimistic) and the dense composed path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [8, 64, 256])
@pytest.mark.parametrize("path", ["sparse", "dense"])
def test_chunked_preempt_bit_equal(path, B):
    s = snap("many_queue")
    assert RV._sparse_preempt_ok(s.ref_config)
    want, got, stats = run_both(
        s, "preempt", batch_size=B, batch_size_preempt=B,
        optimistic_preempt=None if path == "sparse" else False)
    check(want, got, stats, "preempt")
    assert stats.fallbacks == 0


def test_chunked_preempt_wide_gangs_bit_equal():
    want, got, stats = run_both(snap("wide_gangs"), "preempt", batch_size=64,
                                batch_size_preempt=64)
    check(want, got, stats, "preempt")


# ---------------------------------------------------------------------------
# reclaim (chunk_reclaim: no reclaim-minruntime on the snapshot)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [8, 64])
def test_chunked_reclaim_bit_equal(B):
    s = snap("partitioned")
    assert s.ref_config.chunk_reclaim
    want, got, stats = run_both(s, "reclaim", batch_size=B)
    check(want, got, stats, "reclaim")


# ---------------------------------------------------------------------------
# leftover demotion, overflow fallback, queue depth, fractional requests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["sparse", "dense"])
def test_chunked_leftover_demotion_bit_equal(path):
    """An earlier lane's victims free more than its claims: later lanes
    of the chunk demote and retry as the leading lane."""
    ses = _leftover_session()
    s = Snap(ses.state, state_from_numpy(leaves(ses.state), "cpu"),
             ses.config.num_levels, ses.config.victims)
    want, got, stats = run_both(
        s, "preempt", batch_size=4, batch_size_preempt=4,
        optimistic_preempt=None if path == "sparse" else False)
    check(want, got, stats, "preempt")
    assert stats.demotions >= 1


def test_chunked_sparse_overflow_falls_back_dense_bit_equal():
    s = snap("overflow")
    want, got, stats = run_both(s, "preempt", batch_size=64,
                                batch_size_preempt=64, sparse_unit_k=8)
    check(want, got, stats, "preempt")
    assert stats.fallbacks == 1 and got.wavefront_stats[1, 3] == 1


@pytest.mark.parametrize("mode", ["reclaim", "preempt"])
def test_chunked_queue_depth_bit_equal(mode):
    s = snap("partitioned" if mode == "reclaim" else "many_queue")
    want, got, stats = run_both(s, mode, batch_size=8, batch_size_preempt=8,
                                queue_depth=1)
    check(want, got, stats, mode)


@pytest.mark.parametrize("mode,name", [("reclaim", "partitioned"),
                                       ("preempt", "many_queue")])
def test_chunked_fractional_requests_bit_equal(mode, name):
    s = fractional(snap(name), 11)
    want, got, stats = run_both(s, mode, batch_size=8, batch_size_preempt=8,
                                optimistic_preempt=False)
    check(want, got, stats, mode)


# ---------------------------------------------------------------------------
# K8 freed_by_lane alone
# ---------------------------------------------------------------------------

_ref_freed_by_lane = jax.jit(RV._freed_by_lane, static_argnames=(
    "B", "compose", "track_devices", "extended"))


@pytest.mark.parametrize("compose", [True, False])
@pytest.mark.parametrize("B", [4, 40])
def test_freed_by_lane_bit_equal(compose, B):
    """Fractional requests; every output bit-equal, except that the
    queue roll-up at 40 lanes agrees to 1e-6 relative: the reference's
    ``einsum("qa,bqr->bar")`` is an XLA:CPU dot whose accumulation order
    depends on the operand shapes (ascending over the 32 queues at 4
    lanes, two interleaved partial sums at 40), and K8 adds in ascending
    queue order.  (Whole-unit requests, and every cycle the wavefront
    tests above run, are bit-equal at any width.)"""
    s = fractional(snap("many_queue"), 5)
    M = s.port.running.m
    rng = np.random.default_rng(B + compose)
    lane = np.where(rng.random(M) < 0.6, rng.integers(0, B, M),
                    B).astype(np.int32)
    lane = np.where(np.asarray(s.ref.running.valid), lane, B)
    rchain = ref_chain(s.ref.queues.parent, s.num_levels)
    chain = _chain_membership(s.port.queues.parent, s.num_levels)
    want_n, _, want_q, _, want_own = _ref_freed_by_lane(
        s.ref, jnp.asarray(lane), B=B, chain=rchain, compose=compose,
        track_devices=False, extended=False)
    got_n, got_d, got_q, got_own, _ = V.freed_by_lane(
        s.port, torch.from_numpy(lane), B, chain, compose=compose)
    assert got_d is None
    assert_same(want_n, got_n, "freed_nodes")
    assert_same(want_own, got_own, "own_incr")
    if B == 4:
        assert_same(want_q, got_q, "freed_queues")
    else:
        np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                                   rtol=1e-6, atol=0)
    assert bool(got_own.any())
