"""The victim actions on per-task snapshots with the device share table
(GPU sharing: fractional and memory-based shares beside whole-device
pods) against the JAX reference, on the CPU, where the kernels run their
plain versions:

- K8's device table (``freed_by_lane_plain(..., devices=True)``) against
  the reference's ``_freed_by_lane(..., track_devices=True)`` at 1, 8 and
  40 lanes, composed and not: 0.5 and 24 GiB shares, whole-device bits,
  pods without a node;
- K9's lanes mode (``attempt_gang_in_domain_plain`` with per-lane
  ``extra``, ``extra_dev``, ``qa`` and ``score_bias``, the legacy
  protocol) against the reference's ``_attempt_gang_in_domain`` vmapped
  over lanes as the dense victim wavefront calls it;
- reclaim, preempt and consolidation on a small
  ``fleets.sharing_reclaim_objects`` fleet, action by action (every
  ``AllocationResult`` field bit-equal) and as whole five-action cycles
  through both Schedulers, sequential and chunked (the packed commit byte
  for byte, BindRequests with their devices, evictions, move rebinds);
- the stale-gang pass's K6 device table on that fleet.

Inputs are made from a seed with numpy; both packages build the fleet
with their own API objects."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.ops.victims as RV
from kai_scheduler_tpu.apis import types as ref_apis
from kai_scheduler_tpu.framework.scheduler import Scheduler as RefScheduler
from kai_scheduler_tpu.framework.scheduler import \
    SchedulerConfig as RefSchedulerConfig
from kai_scheduler_tpu.framework.session import \
    SessionConfig as RefSessionConfig
from kai_scheduler_tpu.ops import allocate as RA
from kai_scheduler_tpu.ops.allocate import _chain_membership as ref_chain
from kai_scheduler_tpu.ops.allocate import init_result as ref_init
from kai_scheduler_tpu.ops.stale import stale_gang_eviction as ref_stale
from kai_scheduler_tpu.ops.victims import VictimConfig as RefVictimConfig
from kai_scheduler_tpu.runtime.cluster import Cluster as RefCluster
from kai_scheduler_tpu.state.cluster_state import \
    build_snapshot as ref_build
from kai_scheduler_tpu_torch.apis import types as port_apis
from kai_scheduler_tpu_torch.framework.scheduler import (DEFAULT_ACTIONS,
                                                         Scheduler,
                                                         SchedulerConfig)
from kai_scheduler_tpu_torch.framework.session import SessionConfig
from kai_scheduler_tpu_torch.ops import allocate as A
from kai_scheduler_tpu_torch.ops import stale as S
from kai_scheduler_tpu_torch.ops import victims as V
from kai_scheduler_tpu_torch.ops.allocate import (_chain_membership,
                                                  init_result)
from kai_scheduler_tpu_torch.ops.scoring import W_OWN_FREED, PlacementConfig
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from kai_scheduler_tpu_torch.state import state_from_numpy
from kai_scheduler_tpu_torch.state.fleets import sharing_reclaim_objects
from test_torch_cycle import pad32  # noqa: F401
from test_torch_pertask import (PLACEMENTS, assert_bits, dense, make_lanes)
from test_torch_victims import (assert_results_equal, assert_same, leaves,
                                port_victim_config)
from test_torch_victims_chunked import Snap, open_snap

from jax_executables import release_jax_executables  # noqa: F401

#: the small fleet: 24 nodes (11 of whole-device training gangs, 12 of
#: inference shares, one in the tainted inference pool), 3 pending
#: training gangs, 4 fractions, 4 memory shares, 4 urgent fractions in the
#: over-quota leaves
FLEET = dict(num_nodes=24, training=3, fractions=4, memory=4, urgent=4)


@functools.lru_cache(maxsize=None)
def sharing_snap() -> Snap:
    return open_snap(ref_build(*sharing_reclaim_objects(ref_apis, **FLEET),
                               pad=32))


def _without_node(s: Snap, frac: float, seed: int) -> Snap:
    """``s`` with a share of the running pods' node set to -1 (the
    reference's segment sums credit them to node 0)."""
    lv = leaves(s.ref)
    rng = np.random.default_rng(seed)
    node = lv["running.node"].copy()
    node[rng.random(node.shape[0]) < frac] = -1
    lv["running.node"] = node
    r = s.ref.running
    ref = s.ref.replace(running=r.replace(node=jnp.asarray(node)))
    return Snap(ref, state_from_numpy(lv, "cpu"), s.num_levels,
                s.ref_config)


# ---------------------------------------------------------------------------
# K8: the device table
# ---------------------------------------------------------------------------

_ref_freed_by_lane = jax.jit(RV._freed_by_lane, static_argnames=(
    "B", "compose", "track_devices", "extended"))


@pytest.mark.parametrize("compose", [True, False])
@pytest.mark.parametrize("B", [1, 8, 40])
def test_freed_by_lane_device_table_bit_equal(compose, B):
    """Every output of K8's device mode bit-equal to the reference's at
    1, 8 and 40 lanes: the fractional shares (0.5 and 24 GiB of 80) summed
    per (lane, node, device) in pod order, then the whole-device bits."""
    s = _without_node(sharing_snap(), 0.05, B)
    assert s.ref_config.placement.track_devices
    M = s.port.running.m
    rng = np.random.default_rng(B + 7 * compose)
    lane = np.where(rng.random(M) < 0.7, rng.integers(0, B, M),
                    B).astype(np.int32)
    lane = np.where(np.asarray(s.ref.running.valid), lane, B)
    rchain = ref_chain(s.ref.queues.parent, s.num_levels)
    chain = _chain_membership(s.port.queues.parent, s.num_levels)
    want_n, want_d, want_q, _, want_own = _ref_freed_by_lane(
        s.ref, jnp.asarray(lane), B=B, chain=rchain, compose=compose,
        track_devices=True, extended=False)
    got_n, got_d, got_q, got_own, _ = V.freed_by_lane(
        s.port, torch.from_numpy(lane), B, chain, compose=compose,
        devices=True)
    assert_same(want_n, got_n, "freed_nodes")
    assert_same(want_d, got_d, "freed_devices")
    assert_same(want_q, got_q, "freed_queues")
    assert_same(want_own, got_own, "own_incr")
    r = s.port.running
    live = torch.from_numpy(lane) < B
    # the inputs carry every kind of pod the table sums
    held = r.accel_held[live & (r.device >= 0)]
    assert bool((held == 0.5).any()) and bool(((held - 0.3).abs() < 1e-6)
                                              .any())
    assert bool((live & (r.device < 0) & (r.devices_mask != 0)).any())
    assert bool((live & (r.node < 0)).any())
    assert float(got_d.sum()) > 0


# ---------------------------------------------------------------------------
# K9: the lanes mode
# ---------------------------------------------------------------------------

def _lane_pools(ln, B: int, seed: int) -> dict:
    """Per-lane pools over ``make_lanes``' chunk-start ones: each lane's
    own freed capacity on a few nodes (releasing accel, cpu and memory,
    0.5 / 0.3 / whole devices), its queue table below the chunk's, and an
    own-freed score bias where it freed anything."""
    rng = np.random.default_rng(seed)
    p = ln.pools
    N, D = p["dev"].shape
    extra = np.repeat(p["extra"][None], B, 0)
    extra_dev = np.repeat(p["extra_dev"][None], B, 0)
    bias = np.zeros((B, N), np.float32)
    for b in range(B):
        nodes = rng.choice(N, size=3, replace=False)
        for n in nodes:
            d = rng.choice(np.array([0.5, 0.3, 1.0], np.float32), size=D,
                           p=[0.3, 0.2, 0.5]) * (rng.random(D) < 0.4)
            extra_dev[b, n] += d.astype(np.float32)
            extra[b, n] += np.float32([d.sum(), 4.0, 16.0])
        bias[b, nodes] = W_OWN_FREED
    qa = np.repeat(p["qa"][None], B, 0)
    qa = (qa * rng.uniform(0.8, 1.0, qa.shape)).astype(np.float32)
    if B > 1:
        # the first two lanes differ only on one device: lane 1 frees half
        # of device 2 of a node lane 0 freed
        extra[1], extra_dev[1], qa[1], bias[1] = (
            extra[0], extra_dev[0].copy(), qa[0], bias[0])
        n0 = int(np.argmax(bias[0]))
        extra_dev[1, n0, 2] = np.float32(0.5)
    return dict(extra=extra.astype(np.float32),
                extra_dev=extra_dev.astype(np.float32), qa=qa, bias=bias)


def _ref_lanes(ln, lp: dict):
    """The reference's per-task attempt for every lane with per-lane
    pools, as the dense victim wavefront vmaps it (ref ``:1377-1385``):
    no prior placements, no quota."""
    st, cfg = ln.ref_state, ln.config
    p = {k: jnp.asarray(v) for k, v in ln.pools.items()}
    chain = RA._chain_membership(st.queues.parent, ln.num_levels)

    def one(gi, lane, ex_n, ex_d, qae, sb):
        pl = st.gangs.preferred_level[gi]
        return RA._attempt_gang_in_domain(
            st, gi, p["free"], p["dev"], qae, p["qan"], ln.num_levels, cfg,
            st.nodes.valid, st.nodes.topology[:, jnp.maximum(pl, 0)],
            pl >= 0, ex_n, ex_d, lane, chain, score_bias=sb)
    B = ln.cand.shape[0]
    out = jax.jit(jax.vmap(one))(
        ln.cand, jnp.arange(B, dtype=jnp.int32), lp["extra"],
        lp["extra_dev"], lp["qa"], lp["bias"])
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
@pytest.mark.parametrize("B", [1, 8, 37])
def test_pertask_lanes_mode_bit_equal(B, placement):
    ln = make_lanes(B, max(B, 2), placement)
    ln = dataclasses.replace(ln, cand=ln.cand[:B], prior=ln.prior[:B])
    lp = _lane_pools(ln, B, B)
    want = _ref_lanes(ln, lp)
    st = ln.port_state
    q = st.queues
    t = {k: torch.from_numpy(np.array(v))
         for k, v in ln.pools.items()}
    tl = {k: torch.from_numpy(v) for k, v in lp.items()}
    inf = float("inf")
    track = ln.config.track_devices
    got = A.pertask_fill(
        st.nodes, A.TaskTables.of(st), torch.from_numpy(ln.cand),
        torch.full((B, ln.prior.shape[1]), -1, dtype=torch.int32),
        t["free"], t["dev"], tl["qa"], t["qan"], tl["extra"],
        tl["extra_dev"] if track else t["extra_dev"],
        A._chain_membership(q.parent, ln.num_levels),
        torch.where(q.limit <= -0.5, inf, q.limit),
        torch.where(q.quota <= -0.5, inf, q.quota),
        placement=PlacementConfig(**PLACEMENTS[placement]),
        track_devices=track, score_bias=tl["bias"], legacy=True)
    (free2, dev2, qa2, qan2, nodes_t, dev_t, pipe_t, success, bind,
     devbind) = want[:10]
    assert_bits(nodes_t, got.nodes_t.numpy(), "nodes_t")
    assert_bits(dev_t, got.dev_t.numpy(), "dev_t")
    assert_bits(pipe_t, got.pipe_t.numpy(), "pipe_t")
    assert_bits(success, got.success.numpy(), "success")
    assert_bits(qa2, got.qa2.numpy(), "qa2")
    assert_bits(qan2, got.qan2.numpy(), "qan2")
    p = ln.pools
    assert_bits(free2, dense(p["free"], got, got.free_rows), "free2")
    assert_bits(bind, dense(np.zeros_like(p["free"]), got, got.bind_rows),
                "bind")
    if track:
        assert_bits(dev2, dense(p["dev"], got, got.dev_rows), "dev2")
        assert_bits(devbind, dense(np.zeros_like(p["dev"]), got,
                                   got.devbind_rows), "devbind")
    # the dense rebuild without a host read gives the same tables
    for pool, rows in ((p["free"], got.free_rows), (p["dev"], got.dev_rows)):
        assert_bits(dense(pool, got, rows), A.lane_rows_dense(
            torch.from_numpy(pool), got.nodes_t, rows).numpy(), "rows")
    assert int((got.nodes_t >= 0).sum()) > 0
    if B > 1:
        assert bool(got.pipe_t.any())


def test_score_bias_decides_a_tie():
    """One fraction on a fleet of equal nodes: without a bias the lane
    takes the first node; the own-freed bias on another node (a band of
    9.5, above the density band's 9) sends it there, as the reference's
    attempt does."""
    lv = leaves(sharing_snap().ref)
    port = state_from_numpy(lv, "cpu")
    n, q = port.nodes, port.queues
    N, D = n.n, n.d
    dev = torch.where(n.valid[:, None], 1.0, 0.0).expand(N, D).contiguous()
    free = torch.where(n.valid[:, None], n.allocatable, 0.0)
    gi = int(np.nonzero(lv["gangs.task_portion"][:, 0] == 0.5)[0][0])
    inf = float("inf")
    T = port.gangs.t

    def run(bias):
        return A.pertask_fill(
            n, A.TaskTables.of(port), torch.tensor([gi], dtype=torch.int32),
            torch.full((1, T), -1, dtype=torch.int32), free, dev,
            q.allocated, q.allocated_nonpreemptible,
            torch.zeros_like(free)[None], torch.zeros_like(dev)[None],
            A._chain_membership(q.parent, 2),
            torch.where(q.limit <= -0.5, inf, q.limit),
            torch.where(q.quota <= -0.5, inf, q.quota),
            placement=PlacementConfig(), track_devices=True,
            score_bias=bias, legacy=True)
    bias = torch.zeros((1, N))
    assert int(run(bias).nodes_t[0, 0]) == 0
    bias[0, 5] = W_OWN_FREED
    out = run(bias)
    assert int(out.nodes_t[0, 0]) == 5 and bool(out.success[0])


# ---------------------------------------------------------------------------
# the actions, one by one
# ---------------------------------------------------------------------------

def _run_both(s: Snap, mode: str, **overrides):
    ref_cfg = dataclasses.replace(s.ref_config, **overrides)
    want = jax.device_get(RV.run_victim_action_jit(
        s.ref, s.ref.queues.fair_share, ref_init(s.ref),
        num_levels=s.num_levels, mode=mode, config=ref_cfg))
    got, stats = V.run_victim_action_counted(
        s.port, s.port.queues.fair_share, init_result(s.port),
        num_levels=s.num_levels, mode=mode,
        config=port_victim_config(ref_cfg))
    return want, got, stats


@pytest.mark.parametrize("mode,B", [("reclaim", 1), ("reclaim", 8),
                                    ("reclaim", 64), ("preempt", 1),
                                    ("preempt", 8), ("preempt", 64),
                                    ("consolidate", 1)])
def test_victim_action_on_sharing_fleet_bit_equal(mode, B):
    """Every ``AllocationResult`` field bit-equal, the device pools, the
    releasing device pool and the fractional tasks' devices included."""
    s = sharing_snap()
    cfg = s.ref_config
    assert not cfg.placement.uniform_tasks and cfg.placement.track_devices
    want, got, stats = _run_both(s, mode, batch_size=B,
                                 batch_size_preempt=B)
    assert_results_equal(want, got)
    assert bool(got.victim.any()) and bool(got.allocated.any())
    if mode == "consolidate":
        assert bool((got.victim_move >= 0).any())
    else:
        assert bool((got.placement_device >= 0).any())
        assert not torch.equal(got.device_releasing_extra,
                               init_result(s.port).device_releasing_extra)
    if B > 1:
        assert int(got.wavefront_stats[V._STATS_ROW[mode], 0]) >= 1


# ---------------------------------------------------------------------------
# whole cycles
# ---------------------------------------------------------------------------

def _clusters(**shape):
    return tuple(cls.from_objects(*sharing_reclaim_objects(apis, **shape))
                 for apis, cls in ((ref_apis, RefCluster),
                                   (port_apis, Cluster)))


@pytest.mark.parametrize("B", [1, 64])
def test_sharing_reclaim_cycle_bit_equal(B, pad32):
    """The five default actions on the small fleet through both
    Schedulers: nothing fits idle, so reclaim (per-task lanes, K8's device
    table, K9's lanes mode), preempt (the inference gangs of the pending
    leaves) and consolidation (fractional victims re-placed onto devices
    by K7) do the cycle's work; packed commit, BindRequests, evictions and
    move rebinds equal."""
    ref_cluster, cluster = _clusters(**FLEET)
    cfg = dict(incremental=False, analytics_every=0, repack_enable=False)
    want = RefScheduler(RefSchedulerConfig(**cfg, session=RefSessionConfig(
        victims=RefVictimConfig(batch_size=B)))).run_once(ref_cluster)
    got = Scheduler(SchedulerConfig(
        actions=DEFAULT_ACTIONS, **cfg, session=SessionConfig(
            victims=V.VictimConfig(batch_size=B))), device="cpu").run_once(
        cluster)
    assert got.packed.tobytes() == pad32["packed"].tobytes()
    for field in ("bind_requests", "evictions", "move_bind_requests"):
        assert [dataclasses.asdict(b) for b in getattr(got, field)] == \
            [dataclasses.asdict(b) for b in getattr(want, field)], field
    stats = got.victim_stats
    assert stats["reclaim"].steps > 0 and stats["consolidation"].steps > 0
    if B > 1:
        assert stats["preempt"].steps > 0
    assert any(e.move_to is not None for e in got.evictions)
    assert bool(got.tensors.pipelined.any())


# ---------------------------------------------------------------------------
# stalegangeviction on a per-task snapshot
# ---------------------------------------------------------------------------

def test_stale_pass_device_table_bit_equal():
    """A whole-device gang and two inference gangs below their quorum,
    stale past the grace period: their pods' devices return to the
    releasing device pool as the reference credits them."""
    s = sharing_snap()
    lv = leaves(s.ref)
    G = lv["gangs.stale_s"].shape[0]
    running = lv["gangs.running_count"]
    pick = [int(i) for i in np.nonzero(running >= 1)[0][[0, -1, -2]]]
    stale = lv["gangs.stale_s"].copy()
    need = lv["gangs.min_member"].copy()
    stale[pick] = 120.0
    need[pick] = running[pick] + 1
    lv["gangs.stale_s"], lv["gangs.min_member"] = stale, need
    g = s.ref.gangs
    ref = s.ref.replace(gangs=g.replace(stale_s=jnp.asarray(stale),
                                        min_member=jnp.asarray(need)))
    port = state_from_numpy(lv, "cpu")
    want = jax.device_get(ref_stale(ref, ref_init(ref),
                                    num_levels=s.num_levels))
    got = S.stale_gang_eviction(port, init_result(port),
                                num_levels=s.num_levels)
    assert_results_equal(want, got)
    assert float(got.device_releasing_extra.sum()) > 0
    assert G > 3
