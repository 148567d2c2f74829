"""K8 (``freed_by_lane``) and K7 (``replace_victims``) at the shapes the
card kernels' node tiles, column slabs, lane prefix and thread-block
clusters must survive: the port's plain versions against the reference's
``_freed_by_lane`` and ``_replace_victims`` on the seeded edge inputs of
``kai_scheduler_tpu_torch.state.kernel_edges`` (which the card tests and
``chip_smoke.py`` run through the kernels).

Every output is bit-equal, except the queue roll-up past one lane, held
to 1e-6 relative: the reference's ``einsum("qa,bqr->bar")`` is an XLA:CPU
dot whose accumulation order depends on the operand shapes, and the port
adds in ascending queue order (``test_torch_victims_chunked``'s
``test_freed_by_lane_bit_equal``; the requests here are fractional).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.ops.victims as RV
from kai_scheduler_tpu.ops.allocate import _chain_membership as ref_chain
from kai_scheduler_tpu.state.cluster_state import \
    build_snapshot as ref_build
from kai_scheduler_tpu.state.synthetic import make_cluster as ref_make
from kai_scheduler_tpu_torch.ops import victims as V
from kai_scheduler_tpu_torch.ops.allocate import _chain_membership
from kai_scheduler_tpu_torch.state import kernel_edges as KE
from kai_scheduler_tpu_torch.state import state_from_numpy
from test_torch_victims import assert_same

from jax_executables import release_jax_executables  # noqa: F401

@functools.lru_cache(maxsize=None)
def _ref_base():
    state, _ = ref_build(*ref_make(
        num_nodes=40, node_accel=8.0, num_gangs=120, tasks_per_gang=4,
        running_fraction=0.8, num_departments=2, queues_per_department=3,
        seed=0), pad=32)
    return state


def both(lv: dict):
    """The reference's ClusterState and the port's (on the CPU) over the
    same running, node and queue leaves."""
    base = _ref_base()
    secs = {}
    for sec in ("running", "nodes", "queues"):
        obj = getattr(base, sec)
        secs[sec] = obj.replace(**{
            f.name: jnp.asarray(lv[f"{sec}.{f.name}"])
            for f in dataclasses.fields(obj)})
    return base.replace(**secs), state_from_numpy(lv, "cpu")


_ref_freed_by_lane = jax.jit(RV._freed_by_lane, static_argnames=(
    "B", "compose", "track_devices", "extended"))


@pytest.mark.parametrize("mode", KE.K8_MODES)
@pytest.mark.parametrize("compose", [True, False])
@pytest.mark.parametrize("B", KE.K8_LANES)
def test_freed_by_lane_edges_bit_equal(B, compose, mode):
    lv, lane = KE.k8_case(B)
    ref, port = both(lv)
    devices, extended = mode == "devices", mode == "extended"
    want_n, want_d, want_q, want_e, want_own = _ref_freed_by_lane(
        ref, jnp.asarray(lane), B=B,
        chain=ref_chain(ref.queues.parent, KE.NUM_LEVELS), compose=compose,
        track_devices=devices, extended=extended)
    got_n, got_d, got_q, got_own, got_e = V.freed_by_lane(
        port, torch.from_numpy(lane), B,
        _chain_membership(port.queues.parent, KE.NUM_LEVELS), compose=compose,
        devices=devices, extended=extended)
    assert got_n.shape == (B, KE.EDGE_NODES, 3)
    assert_same(want_n, got_n, "freed_nodes")
    assert_same(want_own, got_own, "own_incr")
    for want, got, on, what in ((want_d, got_d, devices, "freed_devices"),
                                (want_e, got_e, extended, "freed_extended")):
        assert (got is not None) == on
        if on:
            assert_same(want, got, what)
            assert float(got.abs().sum()) > 0
    if B == 1:
        assert_same(want_q, got_q, "freed_queues")
    else:
        np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                                   rtol=1e-6, atol=0)
    # the edges the kernels' designs turn on are present
    live = lane < B
    assert int((live & (lv["running.node"] < 0)).sum()) == 1
    assert int((lv["running.node"] < 0).sum()) == KE.PADDING_ROWS
    assert (lv["running.devices_mask"][live] < 0).any()   # bit 31 held
    assert float(got_n[:, -5:].abs().sum()) == 0.0        # empty nodes


_ref_replace_victims = jax.jit(RV._replace_victims,
                               static_argnames=("max_pods",))


@pytest.mark.parametrize("case", KE.K7_CASES)
def test_replace_victims_edges_bit_equal(case):
    lv, mask, *pools, max_pods = KE.k7_case(case)
    ref, port = both(lv)
    want = _ref_replace_victims(ref, jnp.asarray(mask),
                                *map(jnp.asarray, pools), max_pods=max_pods)
    got = V.replace_victims(port, torch.from_numpy(mask),
                            *map(torch.from_numpy, pools), max_pods)
    for w, g, what in zip(want, got, ("free", "device_free",
                                      "extended_free", "moves", "all_ok")):
        assert_same(w, g, what)
    moves, all_ok = got[3].numpy(), bool(got[4])
    victims = np.flatnonzero(mask)
    placed = moves[victims]
    if case == "ties":
        # identical nodes: the lowest index, then the node just debited
        # (least avail) for the next victim
        assert placed.tolist() == [0] * len(victims)
    if case == "nofit":
        assert placed[1] == -1 and (np.delete(placed, 1) >= 0).all()
        assert not all_ok
    if case == "overflow":
        assert len(victims) > max_pods and not all_ok
        assert (placed[:max_pods] >= 0).all() and (placed[max_pods:] == -1).all()
    if case in ("fractional", "memory", "whole", "extended"):
        assert all_ok and (placed >= 0).all()
