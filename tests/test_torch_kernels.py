"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card (bit-exact: tolerance 0).  These need a CUDA device and ``nvcc``; they
skip elsewhere, and ``python3 chip_smoke.py`` holds the same kernels at the
main path's full shapes."""
import dataclasses

import numpy as np
import pytest
import torch

from kai_scheduler_tpu_torch import kernels
from kai_scheduler_tpu_torch.apis import types as apis
from kai_scheduler_tpu_torch.framework.scheduler import Scheduler
from kai_scheduler_tpu_torch.framework.session import Session
from kai_scheduler_tpu_torch.ops import allocate as A
from kai_scheduler_tpu_torch.ops import drf
from kai_scheduler_tpu_torch.ops.scoring import PlacementConfig
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from kai_scheduler_tpu_torch.state import fleets, make_cluster
from kai_scheduler_tpu_torch.state import kernel_edges as KE

pytestmark = pytest.mark.cuda

#: the kernels an allocate-only cycle launches (K1-K4)
ALLOCATE_KERNELS = ("drf_water_fill", "type_tables", "uniform_fill",
                    "sparse_accept")

#: the allocate tests' features cluster (kept here too: this file runs on
#: the card's machine, which has no JAX to import those tests with)
SHAPES = {
    "contended_large": dict(num_nodes=400, num_gangs=300, tasks_per_gang=8,
                            num_departments=4, queues_per_department=4,
                            priority_spread=3),
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
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def assert_same(a, b):
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:   # a table neither side built
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def _session(cuda, **shape):
    return Session.open(*make_cluster(**shape), device=cuda)


def test_drf_water_fill_matches_plain(cuda):
    rng = np.random.default_rng(0)
    for _ in range(8):
        Q, R = 12, 3
        parent = np.where(rng.random(Q) < 0.5, -1, rng.integers(0, 3, Q))
        args = [
            rng.integers(5, 60, (Q + 1, R)).astype(np.float32),
            np.where(rng.random((Q, R)) < 0.2, -1.0,
                     rng.integers(0, 8, (Q, R))).astype(np.float32),
            rng.choice([0.0, 0.5, 1.0, 2.0], (Q, R)).astype(np.float32),
            np.where(rng.random((Q, R)) < 0.5, -1.0,
                     rng.integers(1, 30, (Q, R))).astype(np.float32),
            (rng.integers(0, 40, (Q, R))
             + rng.random((Q, R)).round(1)).astype(np.float32),
            (rng.random((Q, R)) * 0.3).astype(np.float32),
            rng.integers(0, 3, Q).astype(np.int32),
            np.where(parent >= 0, parent + 1, 0).astype(np.int32),
            rng.permutation(Q).astype(np.int32),
            rng.random(Q) < 0.85,
        ]
        t = [torch.from_numpy(a).to(cuda) for a in args]
        k = torch.tensor(0.5)
        before = kernels.KERNELS["drf_water_fill"].launches
        fs, overrun = drf.drf_water_fill(*t, k)
        assert kernels.KERNELS["drf_water_fill"].launches == before + 1
        assert int(overrun.max()) == 0
        assert_same(fs, drf.divide_level_plain(*t, k))


def test_type_tables_matches_plain(cuda):
    ses = _session(cuda, num_nodes=300, num_gangs=40, tasks_per_gang=4,
                   running_fraction=0.3)
    n, g = ses.state.nodes, ses.state.gangs
    extra = torch.zeros_like(n.free)
    args = (n, n.free, extra, g.type_req, g.type_selector, g.type_class,
            ses.config.allocate.placement)
    before = kernels.KERNELS["type_tables"].launches
    out = A.type_tables(*args)
    assert kernels.KERNELS["type_tables"].launches == before + 1
    assert_same(out, A.type_tables_plain(*args))


def _lanes(cuda):
    """One chunk's lane inputs on a contended hierarchy: 64 lanes over the
    first gangs, K2's tables, the queue caps and the ancestor chains."""
    ses = _session(cuda, num_nodes=300, num_gangs=200, tasks_per_gang=8,
                   num_departments=4, queues_per_department=4,
                   priority_spread=3)
    st, cfg = ses.state, ses.config.allocate
    g, n, q = st.gangs, st.nodes, st.queues
    B, T = 64, g.t
    cand = torch.arange(B, dtype=torch.int32, device=cuda)
    prior = torch.full((B, T), -1, dtype=torch.int32, device=cuda)
    quota_b = g.min_needed[:B].contiguous()
    lim = torch.where(q.limit <= -0.5, float("inf"), q.limit)
    quo = torch.where(q.quota <= -0.5, float("inf"), q.quota)
    chain = A._chain_membership(q.parent, 2)
    lt = A.LaneTables.of(st)
    tables = A.type_tables(n, n.free, torch.zeros_like(n.free), g.type_req,
                           g.type_selector, g.type_class, cfg.placement)
    args = (cand, prior, quota_b, q.allocated, q.allocated_nonpreemptible,
            lim, quo, chain, lt, tables, n.soft_scores, n.valid)
    return st, lt, args, dict(dense=True, stride=n.n // B, hoisted=True)


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("hoisted", [True, False])
def test_uniform_fill_matches_plain(cuda, dense, hoisted):
    _, _, args, kw = _lanes(cuda)
    kw.update(dense=dense, hoisted=hoisted)
    before = kernels.KERNELS["uniform_fill"].launches
    out = A.uniform_fill(*args, **kw)
    assert kernels.KERNELS["uniform_fill"].launches == before + 1
    assert_same(out, A.uniform_fill_plain(*args, **kw))


def test_sparse_accept_matches_plain(cuda):
    st, lt, args, kw = _lanes(cuda)
    _, _, nodes_b, pipe_b, succ = A.uniform_fill_plain(*args, **kw)
    n = st.nodes
    ent_ok = succ[:, None] & (nodes_b >= 0)
    req_b = lt.task_req0[args[0].long()]
    sa = (nodes_b, ent_ok, pipe_b, req_b, n.free, n.free + n.releasing, n.n)
    before = kernels.KERNELS["sparse_accept"].launches
    out = A.sparse_accept(*sa)
    assert kernels.KERNELS["sparse_accept"].launches == before + 1
    assert_same(out, A.sparse_accept_plain(*sa))


def _claims(B, T, N, seed=0):
    rng = np.random.default_rng(seed)
    nodes_b = np.where(rng.random((B, T)) < 0.8,
                       rng.integers(0, N, (B, T)), -1).astype(np.int32)
    ent_ok = (rng.random((B, T)) < 0.9) & (nodes_b >= 0)
    free = rng.integers(30, 400, (N, 3)).astype(np.float32)
    return (nodes_b, ent_ok, rng.random((B, T)) < 0.3,
            rng.choice([1.0, 2.0], (B, 3)).astype(np.float32), free,
            free + rng.integers(0, 5, (N, 3)).astype(np.float32))


@pytest.mark.parametrize("B,T", [(64, 8), (256, 32), (200, 40)])
def test_sparse_accept_matches_plain_any_chunk_size(cuda, B, T):
    """Chunks past 4,096 claim entries sort in a global scratch buffer
    instead of shared memory; both paths equal the plain version."""
    N = 1000
    sa = [torch.from_numpy(a).to(cuda) for a in _claims(B, T, N)]
    out = A.sparse_accept(*sa, N)
    assert_same(out, A.sparse_accept_plain(*sa, N))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cuda_cycle_commit_equals_cpu_cycle(cuda, name):
    """A whole cycle on the card (kernels) equals the same cycle on the
    CPU (plain versions), also on the features cluster of the allocate
    tests (selectors, a taint, a host port, elastic gangs, releasing
    capacity)."""
    shape = SHAPES[name]
    kernels.reset_launch_counts()
    gpu = Scheduler(device=cuda).run_once(
        Cluster.from_objects(*objects(shape, make_cluster, apis)))
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ALLOCATE_KERNELS), counts
    cpu = Scheduler(device="cpu").run_once(
        Cluster.from_objects(*objects(shape, make_cluster, apis)))
    assert gpu.packed.tobytes() == cpu.packed.tobytes()
    assert [dataclasses.astuple(b) for b in gpu.bind_requests] == \
        [dataclasses.astuple(b) for b in cpu.bind_requests]


# ---------------------------------------------------------------------------
# the victim path's kernels: K5 cumsum_ds, K6 freed_by_mask, K7
# replace_victims
# ---------------------------------------------------------------------------

def test_cumsum_ds_matches_plain(cuda):
    """K5 at the saturated cell's running-pod count, with Q*R columns and
    values whose f32 sums round (1e-3 to 1e9, both signs), plus the short
    and odd lengths the recursion treats apart."""
    from kai_scheduler_tpu_torch.utils.numerics import (cumsum_ds,
                                                        cumsum_ds_plain)
    rng = np.random.default_rng(0)
    for U, C in ((40_000, 18), (40_960, 3), (1, 4), (2, 1), (3, 2),
                 (7, 5), (1000, 18)):
        x = (rng.uniform(1, 10, (U, C)) * 10 ** rng.uniform(-3, 9, (U, C))
             * rng.choice([-1, 1], (U, C))).astype(np.float32)
        t = torch.from_numpy(x).to(cuda)
        before = kernels.KERNELS["cumsum_ds"].launches
        got = cumsum_ds(t)
        assert kernels.KERNELS["cumsum_ds"].launches == before + 1
        assert_same(got, cumsum_ds_plain(t.cpu()))
    t3 = torch.from_numpy(rng.random((500, 6, 3)).astype(np.float32))
    assert_same(cumsum_ds(t3.to(cuda)), cumsum_ds_plain(t3))


def _victim_state(cuda, seed=0, **shape):
    """A running cluster on the card with fractional requests: memory in
    GiB with fractions, fractional accel shares on devices, so summation
    order changes the bits."""
    from kai_scheduler_tpu_torch.state import state_from_numpy, state_to_numpy
    ses = _session(cuda, **shape)
    leaves = state_to_numpy(ses.state)
    rng = np.random.default_rng(seed)
    M = leaves["running.req"].shape[0]
    req = leaves["running.req"].copy()
    req[:, 1] = rng.uniform(0.1, 3.0, M).astype(np.float32)
    req[:, 2] = (rng.uniform(1, 10, M) * 10 ** rng.uniform(0, 7, M)
                 ).astype(np.float32)
    leaves["running.req"] = req
    frac = rng.random(M) < 0.3
    leaves["running.device"] = np.where(
        frac, rng.integers(0, ses.state.nodes.d, M), -1).astype(np.int32)
    leaves["running.accel_held"] = np.where(
        frac, rng.uniform(0.05, 0.9, M), 0.0).astype(np.float32)
    leaves["running.devices_mask"] = np.where(
        frac, 0, rng.integers(0, 16, M)).astype(np.int32)
    # scramble queues and preemptibility so pods of one node or queue
    # are far apart in pod order
    Q = ses.state.queues.q
    leaves["running.queue"] = rng.integers(0, Q, M).astype(np.int32)
    leaves["running.preemptible"] = rng.random(M) < 0.7
    return state_from_numpy(leaves, cuda), ses


def test_freed_by_mask_matches_plain(cuda):
    from kai_scheduler_tpu_torch.ops import victims as V
    st, ses = _victim_state(cuda, num_nodes=300, num_gangs=400,
                            tasks_per_gang=4, running_fraction=0.8,
                            num_departments=3, queues_per_department=3)
    chain = A._chain_membership(st.queues.parent, ses.config.num_levels)
    rng = np.random.default_rng(1)
    cst = _cpu_state(st)
    for p in (0.05, 0.5, 1.0):
        mask = torch.from_numpy(rng.random(st.running.m) < p).to(cuda)
        before = kernels.KERNELS["freed_by_mask"].launches
        got = V.freed_by_mask(st, mask, chain)
        assert kernels.KERNELS["freed_by_mask"].launches == before + 1
        want = V.freed_by_mask_plain(cst, mask.cpu(), chain.cpu())
        assert_same(got, want)


def _cpu_state(st):
    from kai_scheduler_tpu_torch.state import state_from_numpy, state_to_numpy
    return state_from_numpy(state_to_numpy(st), "cpu")


def test_replace_victims_matches_plain(cuda):
    """K7 with tied scores (identical empty nodes), fractional victims,
    and more victims than K (the scenario is rejected but the first K
    still re-place)."""
    from kai_scheduler_tpu_torch.ops import victims as V
    st, _ = _victim_state(cuda, num_nodes=200, num_gangs=300,
                          tasks_per_gang=4, running_fraction=0.6)
    n = st.nodes
    cst = _cpu_state(st)
    rng = np.random.default_rng(2)
    for p, max_pods in ((0.01, 512), (0.05, 512), (0.2, 16)):
        mask = torch.from_numpy(rng.random(st.running.m) < p).to(cuda)
        args = (mask, n.free, n.device_free, n.releasing, n.device_releasing,
                n.extended_free, n.extended_releasing, max_pods)
        before = kernels.KERNELS["replace_victims"].launches
        got = V.replace_victims(st, *args)
        assert kernels.KERNELS["replace_victims"].launches == before + 1
        want = V.replace_victims_plain(cst, *(
            a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
        assert_same(got, want)
        if max_pods == 16:
            assert not bool(got[4]) and int(mask.sum()) > 16


# ---------------------------------------------------------------------------
# the chunked victim wavefront's kernels: K8 freed_by_lane and the per-lane
# modes of K2, K3 and K4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compose", [True, False])
@pytest.mark.parametrize("B", [4, 64, 300])
def test_freed_by_lane_matches_plain(cuda, compose, B):
    """K8 on fractional requests with pods of one node or queue scattered
    over the pod axis, past one block of 16 lanes and past 256 lanes (two
    levels of block totals in the lane prefix)."""
    from kai_scheduler_tpu_torch.ops import victims as V
    st, ses = _victim_state(cuda, num_nodes=300, num_gangs=400,
                            tasks_per_gang=4, running_fraction=0.8,
                            num_departments=3, queues_per_department=3)
    chain = A._chain_membership(st.queues.parent, ses.config.num_levels)
    rng = np.random.default_rng(B)
    M = st.running.m
    lane = np.where(rng.random(M) < 0.7, rng.integers(0, B, M), B)
    lane = torch.from_numpy(lane.astype(np.int32)).to(cuda)
    before = kernels.KERNELS["freed_by_lane"].launches
    got = V.freed_by_lane(st, lane, B, chain, compose=compose)
    assert kernels.KERNELS["freed_by_lane"].launches == before + 1
    want = V.freed_by_lane_plain(_cpu_state(st), lane.cpu(), B, chain.cpu(),
                                 compose=compose)
    assert_same(got, want)


def _victim_lanes(cuda, B=48):
    """One victim-wavefront chunk's lane inputs: per-lane pools (K2's rows
    by lane, each lane's gang type), per-lane queue tables and the
    own-freed score band on a few nodes."""
    st, lt, args, kw = _lanes(cuda)
    g, n, q = st.gangs, st.nodes, st.queues
    rng = np.random.default_rng(7)
    cand = args[0][:B]
    extra_b = torch.from_numpy(rng.choice(
        [0.0, 0.0, 1.0, 2.5], (B, n.n, 3)).astype(np.float32)).to(cuda)
    ty = g.task_type[cand.long(), 0].long()
    tables = A.type_tables(n, n.free, extra_b, g.type_req[ty],
                           g.type_selector[ty], g.type_class[ty],
                           PlacementConfig())
    qa_b = (q.allocated[None] - torch.from_numpy(rng.choice(
        [0.0, 1.0, 0.5], (B, q.q, 3)).astype(np.float32)).to(cuda))
    bias = torch.from_numpy(np.where(rng.random((B, n.n)) < 0.05, 9.5,
                                     0.0).astype(np.float32)).to(cuda)
    rows = torch.arange(B, dtype=torch.int32, device=cuda)
    largs = (cand, args[1][:B], torch.full((B,), g.t, dtype=torch.int32,
                                           device=cuda), qa_b) + args[4:9] \
        + (tables,) + args[10:]
    return st, n, extra_b, ty, largs, dict(rows=rows, score_bias=bias)


def test_type_tables_per_row_extra_matches_plain(cuda):
    st, n, extra_b, ty, _, _ = _victim_lanes(cuda)
    g = st.gangs
    g_args = (n, n.free, extra_b, g.type_req[ty], g.type_selector[ty],
              g.type_class[ty], PlacementConfig())
    before = kernels.KERNELS["type_tables"].launches
    out = A.type_tables(*g_args)
    assert kernels.KERNELS["type_tables"].launches == before + 1
    assert_same(out, A.type_tables_plain(*g_args))


@pytest.mark.parametrize("hoisted", [True, False])
def test_uniform_fill_lane_modes_match_plain(cuda, hoisted):
    """K3 with per-lane queue tables, explicit table rows and the score
    bias, in both f32 orders of the bands."""
    _, _, _, _, largs, lkw = _victim_lanes(cuda)
    kw = dict(lkw, dense=False, stride=1, hoisted=hoisted)
    before = kernels.KERNELS["uniform_fill"].launches
    out = A.uniform_fill(*largs, **kw)
    assert kernels.KERNELS["uniform_fill"].launches == before + 1
    assert_same(out, A.uniform_fill_plain(*largs, **kw))


@pytest.mark.parametrize("B,T", [(64, 8), (256, 32)])
def test_sparse_accept_credit_matches_plain(cuda, B, T):
    """K4 with the victim wavefront's per-entry freed credit."""
    N = 1000
    sa = [torch.from_numpy(a).to(cuda) for a in _claims(B, T, N, seed=3)]
    rng = np.random.default_rng(4)
    credit = torch.from_numpy(np.where(
        rng.random((B * T, 3)) < 0.3, rng.uniform(0, 3, (B * T, 3)),
        0.0).astype(np.float32)).to(cuda)
    out = A.sparse_accept(*sa, N, credit=credit)
    assert_same(out, A.sparse_accept_plain(*sa, N, credit=credit))


@pytest.mark.parametrize("mode", ["reclaim", "preempt"])
def test_chunked_wavefront_reads_the_host_once_per_chunk(cuda, mode):
    """The chunk body branches on no device value: under
    ``torch.cuda.set_sync_debug_mode("warn")`` the action's
    synchronizing calls are exactly the reads it counts (the action's
    setup read, the sparse/dense choice, one loop test per chunk plus the
    last, the final stats read)."""
    import warnings

    from kai_scheduler_tpu_torch.ops import victims as V
    name = "saturated" if mode == "reclaim" else "preempt_many_queues"
    cluster, _ = _victim_cluster(name)
    ses = Session.open(*cluster.snapshot_lists(), device=cuda)
    st = ses.state
    res0 = A.init_result(st)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res, stats = V.run_victim_action_counted(
                st, st.queues.fair_share, res0,
                num_levels=ses.config.num_levels, mode=mode,
                config=ses.config.victims)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (switching the debug mode itself reports one, from torch.cuda)
    syncs = [f"{w.filename}:{w.lineno}" for w in seen
             if "synchroniz" in str(w.message)
             and not w.filename.endswith("torch/cuda/__init__.py")]
    assert stats.steps >= 1 and bool(res.victim.any())
    assert len(syncs) == stats.syncs, "\n".join(syncs)


def _victim_cluster(name):
    """The chip smoke test's victim cells at a few hundred nodes."""
    from kai_scheduler_tpu_torch.framework.scheduler import DEFAULT_ACTIONS
    if name == "saturated":
        cluster = Cluster.from_objects(*make_cluster(
            num_nodes=256, node_accel=4.0, num_gangs=160, tasks_per_gang=8,
            running_fraction=0.8, queue_accel_quota=25.0,
            partition_queues_by_running=True))
    elif name == "preempt_many_queues":
        cluster = Cluster.from_objects(*make_cluster(
            num_nodes=256, node_accel=8.0, num_gangs=320, tasks_per_gang=8,
            running_fraction=256 / 320, num_departments=2,
            queues_per_department=32, pending_priority_boost=100))
    else:
        nodes, queues, groups, pods, now = fleets.fragmented_objects(
            apis, num_nodes=300, pending=12, stale=4)
        cluster = Cluster.from_objects(nodes, queues, groups, pods)
        cluster.now = now
    return cluster, DEFAULT_ACTIONS


@pytest.mark.parametrize("name,batch_size", [
    pytest.param("saturated", 1, id="saturated"),
    pytest.param("fragmented", 1, id="fragmented"),
    pytest.param("saturated", 64, id="saturated-default"),
    pytest.param("preempt_many_queues", 64, id="preempt_many_queues-default"),
])
def test_cuda_victim_cycle_equals_cpu_cycle(cuda, name, batch_size):
    """The five default actions, at the sequential victim engine and at
    the default config (reclaim and preempt through the chunked
    wavefront): the card (K2, K3, K5-K8) equals the CPU (plain versions)
    in the packed commit, the evictions with their move targets and the
    move rebinds."""
    from kai_scheduler_tpu_torch.framework.scheduler import SchedulerConfig
    from kai_scheduler_tpu_torch.framework.session import SessionConfig
    from kai_scheduler_tpu_torch.ops.victims import VictimConfig
    out = {}
    for dev in (cuda, "cpu"):
        cluster, actions = _victim_cluster(name)
        kernels.reset_launch_counts()
        out[str(dev)] = Scheduler(SchedulerConfig(
            actions=actions, session=SessionConfig(
                victims=VictimConfig(batch_size=batch_size))),
            device=dev).run_once(cluster)
        if dev is cuda:
            counts = kernels.launch_counts()
            if batch_size > 1:
                assert counts["freed_by_lane"] > 0, counts
            else:
                assert counts["cumsum_ds"] > 0 and counts["freed_by_mask"] > 0
            if name == "fragmented":
                assert counts["replace_victims"] > 0
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.evictions
    assert gpu.packed.tobytes() == cpu.packed.tobytes()
    for field in ("bind_requests", "evictions", "move_bind_requests"):
        assert [dataclasses.astuple(b) for b in getattr(gpu, field)] == \
            [dataclasses.astuple(b) for b in getattr(cpu, field)], field


# ---------------------------------------------------------------------------
# K9 pertask_fill and K10 dense_accept (the per-task path)
# ---------------------------------------------------------------------------

def _sharing_lanes(cuda, *, B: int, num_nodes: int, placement: dict,
                   seed: int):
    """A GPU-sharing snapshot on the card (``fleets.sharing_objects``
    plus 40-pod training gangs) with random partial pools and
    victim-freed capacity on a fifth of the nodes, and B lanes of random
    gangs, a third of them with prior placements; returns the K9
    arguments."""
    objs = fleets.sharing_objects(
        apis, num_nodes=num_nodes, shared_nodes=num_nodes // 2, training=6,
        fractions=24, memory=12, launchers=4, seed=seed)
    nodes, queues, groups, pods = objs
    for k in range(3):
        name = f"wide-{k}"
        groups.append(apis.PodGroup(name, queue=groups[-1].queue,
                                    min_member=40, creation_timestamp=900.0))
        pods += [apis.Pod(f"{name}-{t}", name,
                          resources=apis.ResourceVec(1.0, 1.0, 4.0))
                 for t in range(40)]
    ses = Session.open(nodes, queues, groups, pods, device=cuda)
    st = ses.state
    g, n = st.gangs, st.nodes
    rng = np.random.default_rng(seed)
    N, D = n.device_free.shape
    dev = n.device_free.cpu().numpy().copy()
    used = rng.choice(np.array([0.0, 0.25, 0.5, 0.3, 1.0], np.float32),
                      size=dev.shape, p=[0.3, 0.15, 0.15, 0.1, 0.3])
    dev = np.where(dev > 0, np.maximum(dev - used, 0.0), dev)
    extra_dev = np.zeros_like(dev)
    freed = rng.random(N) < 0.2
    dev[freed] = 0.0
    extra_dev[freed, 2:4] = 1.0
    free = n.free.cpu().numpy().copy()
    free[:, 0] = np.minimum(free[:, 0], dev.sum(-1))
    extra = np.zeros_like(free)
    extra[freed, 0] = 2.0
    ng = len(ses.index.gang_names)
    G, T = g.task_valid.shape
    cand = rng.integers(0, ng, B).astype(np.int32)
    prior = np.full((B, T), -1, np.int32)
    tasks = g.task_valid.sum(-1).cpu().numpy()
    for b in range(0, B, 3):
        if tasks[cand[b]] > 1:   # an earlier attempt placed task 0
            prior[b, 0] = rng.integers(0, num_nodes)
    q = st.queues
    inf = float("inf")

    def t(x):
        return torch.from_numpy(x).to(cuda)
    args = (n, A.TaskTables.of(st), t(cand), t(prior), t(free), t(dev),
            q.allocated, q.allocated_nonpreemptible, t(extra), t(extra_dev),
            A._chain_membership(q.parent, ses.config.num_levels),
            torch.where(q.limit <= -0.5, inf, q.limit),
            torch.where(q.quota <= -0.5, inf, q.quota))
    return args, dict(placement=PlacementConfig(**placement),
                      track_devices=True)


#: (lanes, nodes, placement): up to 256 lanes, 40 task slots and 8
#: devices, binpack/gpupack and spread/gpuspread, and a fleet of 12 nodes
#: that every lane crowds onto
PERTASK_CASES = [
    (64, 400, {}),
    (256, 400, dict(binpack_accel=False, binpack_cpu=False,
                    device_pack=False)),
    (256, 12, {}),
    (200, 12, dict(device_pack=False)),
]


@pytest.mark.parametrize("B,num_nodes,placement", PERTASK_CASES)
def test_pertask_fill_matches_plain(cuda, B, num_nodes, placement):
    args, kw = _sharing_lanes(cuda, B=B, num_nodes=num_nodes,
                              placement=placement, seed=B + num_nodes)
    before = kernels.KERNELS["pertask_fill"].launches
    out = A.pertask_fill(*args, **kw)
    assert kernels.KERNELS["pertask_fill"].launches == before + 1
    assert_same(out.fields(),
                A.attempt_gang_in_domain_plain(*args, **kw).fields())
    assert bool((out.nodes_t >= 0).any()) and bool((out.dev_t >= 0).any())
    kw2 = dict(kw, track_devices=False)    # the no-device-table path
    assert_same(A.pertask_fill(*args, **kw2).fields(),
                A.attempt_gang_in_domain_plain(*args, **kw2).fields())


@pytest.mark.parametrize("B,num_nodes,placement", PERTASK_CASES)
def test_dense_accept_matches_plain(cuda, B, num_nodes, placement):
    """K10 on K9's lanes: every lane successful (many lanes on one node
    at 12 nodes) and a random subset; random queue gates."""
    args, kw = _sharing_lanes(cuda, B=B, num_nodes=num_nodes,
                              placement=placement, seed=B + num_nodes)
    lanes = A.pertask_fill(*args, **kw)
    n = args[0]
    free, dev, qa, qan, extra, extra_dev = args[4:10]
    rng = np.random.default_rng(B)
    rel_floor = -(n.releasing + extra) - A.EPS
    dev_floor = -(n.device_releasing + extra_dev) - A.EPS
    for subset in (1.0, 0.7):
        ok = lanes.success & torch.from_numpy(
            rng.random(B) < subset).to(cuda)
        gate = torch.from_numpy(rng.random(B) < 0.95).to(cuda)
        okm = ok[:, None, None]
        d_qa = torch.where(okm, lanes.qa2 - qa, 0.0)
        d_qan = torch.where(okm, lanes.qan2 - qan, 0.0)
        for track in (True, False):
            dargs = (lanes.nodes_t, ok, gate, lanes.free_rows,
                     lanes.dev_rows, lanes.bind_rows, lanes.devbind_rows,
                     free, dev, rel_floor, dev_floor, d_qa, d_qan, qa, qan)
            before = kernels.KERNELS["dense_accept"].launches
            out = A.dense_accept(*dargs, track_devices=track)
            assert kernels.KERNELS["dense_accept"].launches == before + 1
            assert_same(out, A.dense_accept_plain(*dargs,
                                                  track_devices=track))


def test_cuda_sharing_cycle_equals_cpu_cycle(cuda):
    """A small sharing cell through the Scheduler on the card and on the
    CPU: the packed commit and the BindRequests (device indices included)
    are equal, and the cycle went through K9 and K10."""
    from kai_scheduler_tpu_torch.framework.scheduler import SchedulerConfig
    shape = dict(num_nodes=300, shared_nodes=150, training=20,
                 fractions=120, memory=60, launchers=8)
    out, counts = {}, {}
    for device in ("cuda", "cpu"):
        cluster = Cluster.from_objects(*fleets.sharing_objects(
            apis, **shape))
        kernels.reset_launch_counts()
        out[device] = Scheduler(SchedulerConfig(actions=("allocate",)),
                                device=device).run_once(cluster)
        counts[device] = kernels.launch_counts()
    assert counts["cuda"]["pertask_fill"] > 0
    assert counts["cuda"]["dense_accept"] > 0
    assert counts["cpu"]["pertask_fill"] == 0
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.packed.tobytes() == cpu.packed.tobytes()
    assert [dataclasses.astuple(b) for b in gpu.bind_requests] == \
        [dataclasses.astuple(b) for b in cpu.bind_requests]
    assert any(b.selected_accel_groups for b in gpu.bind_requests)


# ---------------------------------------------------------------------------
# the topology path's kernels: K11 topo_tables, the topology modes of K3,
# K9 and K10
# ---------------------------------------------------------------------------

def _topo_session(cuda, seed=0, preferred=False):
    """A rack-required tree (4 blocks x 8 racks, 512 nodes) with running
    gangs and random whole-unit pools, so the racks differ in fill; with
    ``preferred`` every other gang prefers its block."""
    objs = make_cluster(num_nodes=512, node_accel=8.0, num_gangs=300,
                        tasks_per_gang=8, topology_levels=(4, 8),
                        required_level="topo/level1", running_fraction=0.3,
                        seed=seed)
    if preferred:
        for i, g in enumerate(objs[2]):
            if i % 2 == 0:
                g.topology_constraint = apis.TopologyConstraint(
                    topology="default", required_level="topo/level1",
                    preferred_level="topo/level0")
    ses = Session.open(*objs, device=cuda)
    n = ses.state.nodes
    rng = np.random.default_rng(seed)
    free = n.free.clone()
    free[:, 0] = torch.clamp(free[:, 0] - torch.from_numpy(
        rng.integers(0, 5, n.n).astype(np.float32)).to(cuda), min=0.0)
    return ses, free


def _topo_tables(ses, free):
    st = ses.state
    n, g = st.nodes, st.gangs
    topo = A.TopoStatic.of(n)
    extra = torch.zeros_like(n.free)
    tables = A.type_tables(n, free, extra, g.type_req, g.type_selector,
                           g.type_class, ses.config.allocate.placement)
    fp_build = (tables[1] & n.valid[None]).contiguous()
    avail = ((free + n.releasing) + extra).contiguous()
    return topo, tables, fp_build, avail, extra


def test_topo_tables_match_plain(cuda):
    """K11's build on a 512-node tree, then two updates with random taken
    lanes (some placing several replicas on one node)."""
    ses, free = _topo_session(cuda)
    n, g = ses.state.nodes, ses.state.gangs
    topo, _, fp_build, avail, _ = _topo_tables(ses, free)
    args = (topo, fp_build, avail, n.valid, g.type_req)
    before = kernels.KERNELS["topo_tables_build"].launches
    out = A.topo_tables_build(*args)
    assert kernels.KERNELS["topo_tables_build"].launches == before + 1
    assert_same(out, A.topo_tables_build_plain(*args))
    caps, agg, c_y = out
    rng = np.random.default_rng(1)
    for step, B in enumerate((64, 256)):
        T = 8
        nodes_b = torch.from_numpy(np.where(
            rng.random((B, T)) < 0.8, rng.integers(0, n.n // 2, (B, T)),
            -1).astype(np.int32)).to(cuda)
        take = torch.from_numpy(rng.random(B) < 0.7).to(cuda)
        req0 = torch.from_numpy(rng.choice([1.0, 2.0, 0.5], B).astype(
            np.float32)).to(cuda)
        avail = torch.clamp(avail - float(step + 1), min=0.0).contiguous()
        uargs = (topo, fp_build, caps, agg, c_y, avail, take, nodes_b, req0,
                 g.type_req)
        before = kernels.KERNELS["topo_tables_update"].launches
        got = A.topo_tables_update(*uargs)
        assert kernels.KERNELS["topo_tables_update"].launches == before + 1
        assert_same(got, A.topo_tables_update_plain(*uargs))
        caps, agg, c_y = got


@pytest.mark.parametrize("preferred", [False, True])
@pytest.mark.parametrize("hoisted", [True, False])
def test_uniform_fill_topology_modes_match_plain(cuda, preferred, hoisted):
    """K3 with the required level's pick and confinement (64 lanes, a third
    with a prior placement that locks its domain), the preferred band on
    every other gang, and the dense protocol's rows."""
    ses, free = _topo_session(cuda, preferred=preferred)
    st = ses.state
    g, n, q = st.gangs, st.nodes, st.queues
    topo, tables, fp_build, avail, _ = _topo_tables(ses, free)
    caps, agg, _ = A.topo_tables_build(topo, fp_build, avail, n.valid,
                                       g.type_req)
    B, T = 64, g.t
    rng = np.random.default_rng(2)
    cand = torch.from_numpy(rng.integers(0, 300, B).astype(np.int32)).to(cuda)
    prior = np.full((B, T), -1, np.int32)
    prior[::3, 0] = rng.integers(0, n.n, len(prior[::3]))
    prior = torch.from_numpy(prior).to(cuda)
    quota_b = torch.clamp(g.min_needed[cand.long()]
                          - (prior >= 0).sum(-1, dtype=torch.int32),
                          min=1).to(torch.int32)
    lim = torch.where(q.limit <= -0.5, float("inf"), q.limit)
    quo = torch.where(q.quota <= -0.5, float("inf"), q.quota)
    utopo = A.UniformTopo(
        topology=n.topology, srl0=g.subgroup_required_level[:, 0].contiguous(),
        dom_caps_y=caps, level_of_dom=topo.level_of_dom,
        order=A.order_by_agg(topo.level_of_dom, agg),
        pref_level=g.preferred_level if preferred else None)
    args = (cand, prior, quota_b, q.allocated, q.allocated_nonpreemptible,
            lim, quo, A._chain_membership(q.parent, 2), A.LaneTables.of(st),
            tables, n.soft_scores, n.valid)
    kw = dict(dense=False, stride=1, hoisted=hoisted, topo=utopo, free=free)
    before = kernels.KERNELS["uniform_fill"].launches
    out = A.uniform_fill(*args, **kw)
    assert kernels.KERNELS["uniform_fill"].launches == before + 1
    assert_same(out, A.uniform_fill_plain(*args, **kw))
    assert bool(out[4].any()) and bool((~out[4]).any())
    # K10 without the device table on these lanes' rows
    succ = out[4]
    okm = succ[:, None, None]
    d_qa = torch.where(okm, out[0] - q.allocated, 0.0)
    d_qan = torch.where(okm, out[1] - q.allocated_nonpreemptible, 0.0)
    dargs = (out[2], succ, torch.ones_like(succ), out[5], None, out[6], None,
             free, None, -(n.releasing) - A.EPS, None, d_qa, d_qan,
             q.allocated, q.allocated_nonpreemptible)
    before = kernels.KERNELS["dense_accept"].launches
    acc = A.dense_accept(*dargs, track_devices=False)
    assert kernels.KERNELS["dense_accept"].launches == before + 1
    want = A.dense_accept_plain(*dargs, track_devices=False)
    assert acc[2] is None and want[2] is None
    assert_same([acc[i] for i in (0, 1, 3, 4)],
                [want[i] for i in (0, 1, 3, 4)])


def _subgroup_topology_lanes(cuda, B=64, num_nodes=512, seed=0):
    objs = fleets.topology_subgroup_objects(
        apis, make_cluster, num_nodes=num_nodes, levels=(4, 8), gangs=200,
        seed=seed)
    ses = Session.open(*objs, device=cuda)
    st = ses.state
    g, n, q = st.gangs, st.nodes, st.queues
    rng = np.random.default_rng(seed)
    ng = len(ses.index.gang_names)
    cand = torch.from_numpy(rng.integers(0, ng, B).astype(np.int32)).to(cuda)
    T = g.t
    prior = torch.full((B, T), -1, dtype=torch.int32, device=cuda)
    free = n.free.clone()
    free[:, 1] = torch.clamp(free[:, 1] - torch.from_numpy(
        rng.random(n.n).astype(np.float32) * 3).to(cuda), min=0.0)
    inf = float("inf")
    args = (n, A.TaskTables.of(st), cand, prior, free, n.device_free,
            q.allocated, q.allocated_nonpreemptible, torch.zeros_like(free),
            torch.zeros_like(n.device_free),
            A._chain_membership(q.parent, ses.config.num_levels),
            torch.where(q.limit <= -0.5, inf, q.limit),
            torch.where(q.quota <= -0.5, inf, q.quota))
    cfg = ses.config.allocate
    assert cfg.subgroup_topology and not cfg.uniform_tasks
    return args, dict(placement=cfg.placement,
                      track_devices=cfg.track_devices,
                      topo=A.TopoStatic.of(n))


def test_pertask_fill_subgroup_topology_matches_plain(cuda):
    """K9's subgroup-topology mode (64 lanes on the chip cell's shape at
    512 nodes, CPU availability with fractions), then its banned mode on
    every lane, then the retry's active lanes over the first output —
    on a scratch of its own, and on the first launch's scratch, whose
    chunk-start row it copies instead of summing."""
    args, kw = _subgroup_topology_lanes(cuda)
    kernels.reset_launch_counts()
    agg = A.pertask_agg_scratch(kw["topo"], args[4])
    out = A.pertask_fill(*args, agg=agg, **kw)
    want = A.attempt_gang_in_domain_plain(*args, **kw)
    assert_same(out.fields(), want.fields())
    assert bool((out.sub_dom >= 0).any())
    banned = out.sub_dom
    assert_same(A.pertask_fill(*args, banned=banned, **kw).fields(),
                A.attempt_gang_in_domain_plain(*args, banned=banned,
                                               **kw).fields())
    active = ~out.success | (torch.arange(out.success.shape[0],
                                          device=cuda) % 5 == 0)
    want = A.pertask_fill_plain(*args, banned=banned, active=active,
                                base=out, **kw).fields()
    for scratch in (None, agg):
        got = A.pertask_fill(*args, banned=banned, active=active, base=out,
                             agg=scratch, **kw)
        assert_same(got.fields(), want)
        keep = ~active
        for a, b in zip(got.fields(), out.fields()):
            assert torch.equal(a[keep], b[keep])
    counts = kernels.launch_counts()
    assert (counts["pertask_fill"], counts["pertask_fill:topology"],
            counts["pertask_fill:banned"]) == (4, 1, 3)


@pytest.mark.parametrize("name", ["topology", "topology_subgroups"])
def test_cuda_topology_cycle_equals_cpu_cycle(cuda, name):
    """A small topology cell of each kind through the Scheduler on the card
    and on the CPU: packed commit and BindRequests equal; the uniform cell
    went through K11 and K3/K10, the per-task cell through K9 and K10."""
    from kai_scheduler_tpu_torch.framework.scheduler import SchedulerConfig
    out, counts = {}, {}
    for device in ("cuda", "cpu"):
        if name == "topology":
            objs = make_cluster(num_nodes=512, node_accel=8.0, num_gangs=300,
                                tasks_per_gang=8, topology_levels=(4, 8),
                                required_level="topo/level1")
        else:
            objs = fleets.topology_subgroup_objects(
                apis, make_cluster, num_nodes=512, levels=(4, 8), gangs=120)
        kernels.reset_launch_counts()
        out[device] = Scheduler(SchedulerConfig(actions=("allocate",)),
                                device=device).run_once(
            Cluster.from_objects(*objs))
        counts[device] = kernels.launch_counts()
    need = (("topo_tables_build", "topo_tables_update", "uniform_fill",
             "uniform_fill:topology", "dense_accept",
             "dense_accept:no_devices") if name == "topology"
            else ("pertask_fill", "pertask_fill:topology",
                  "pertask_fill:banned", "dense_accept"))
    assert all(counts["cuda"][k] > 0 for k in need), counts["cuda"]
    assert all(v == 0 for v in counts["cpu"].values())
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.packed.tobytes() == cpu.packed.tobytes()
    assert [dataclasses.astuple(b) for b in gpu.bind_requests] == \
        [dataclasses.astuple(b) for b in cpu.bind_requests]
    assert (gpu.retries, gpu.retry_chunks) == (cpu.retries,
                                                cpu.retry_chunks)


# ---------------------------------------------------------------------------
# the affinity gates: K12 affinity_mask, K13 anti_mark, and the mask modes
# of K3 and K9
# ---------------------------------------------------------------------------

def _affinity_session(cuda, num_nodes=512):
    objs = fleets.affinity_objects(
        apis, make_cluster, num_nodes=num_nodes, node_accel=8.0,
        num_gangs=240, tasks_per_gang=8, services=16, anchors=32,
        dependers=32, port_gangs=48)
    return Session.open(*objs, device=cuda)


def test_affinity_mask_and_anti_mark_match_plain(cuda):
    """K12 (with and without the need rows) and K13 on the affinity
    fleet's term tables with a random claimed-domain table, 256 lanes of
    random gangs (junk lanes at the clamped last gang) and random taken
    placements."""
    ses = _affinity_session(cuda)
    st = ses.state
    g = st.gangs
    rng = np.random.default_rng(0)
    dom = A.anti_domain_tables(st)
    shape = A.init_result(st).anti_used.shape
    used = torch.from_numpy(rng.random(shape) < 0.05).to(cuda)
    B, T = 256, g.t
    cand = torch.from_numpy(rng.integers(0, g.g, B).astype(np.int32)).to(cuda)
    kernels.reset_launch_counts()
    for attract in (False, True):
        assert_same(A.affinity_mask(st, used, dom, cand, attract=attract),
                    A.affinity_mask_plain(st, used, dom, cand,
                                          attract=attract))
    nodes_b = torch.from_numpy(rng.integers(-1, st.nodes.n, (B, T)).astype(
        np.int32)).to(cuda)
    take = torch.from_numpy(rng.random(B) < 0.5).to(cuda)
    want = A.anti_mark_placements(st, used, dom, cand, nodes_b, take)
    assert not torch.equal(want, used)
    got = A.anti_mark(st, used, dom, cand, nodes_b, take)   # in place
    assert got is used
    assert_same(got, want)
    counts = kernels.launch_counts()
    assert (counts["affinity_mask"], counts["anti_mark"]) == (2, 1)


def _lane_mask(cuda, B, valid, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.random((B, valid.shape[0])) < rng.choice([0.3, 0.7, 1.0],
                                                      (B, 1))
    return torch.from_numpy(m).to(cuda) & valid[None]


@pytest.mark.parametrize("hoisted", [True, False])
def test_uniform_fill_mask_mode_matches_plain(cuda, hoisted):
    _, _, args, kw = _lanes(cuda)
    kw.update(hoisted=hoisted)
    B = args[0].shape[0]
    args = args[:11] + (_lane_mask(cuda, B, args[11]),)
    kernels.reset_launch_counts()
    out = A.uniform_fill(*args, **kw)
    assert kernels.launch_counts()["uniform_fill:mask"] == 1
    assert_same(out, A.uniform_fill_plain(*args, **kw))


def test_pertask_fill_mask_mode_matches_plain(cuda):
    """K9's mask mode on the sharing lanes (device table), then with
    subgroup topology: every lane, and the banned retry over the first
    output."""
    args, kw = _sharing_lanes(cuda, B=64, num_nodes=400, placement={},
                              seed=3)
    mask = _lane_mask(cuda, 64, args[0].valid)
    kernels.reset_launch_counts()
    assert_same(A.pertask_fill(*args, mask=mask, **kw).fields(),
                A.attempt_gang_in_domain_plain(*args, mask=mask,
                                               **kw).fields())
    args, kw = _subgroup_topology_lanes(cuda)
    mask = _lane_mask(cuda, args[2].shape[0], args[0].valid, 1)
    out = A.pertask_fill(*args, mask=mask, **kw)
    assert_same(out.fields(), A.attempt_gang_in_domain_plain(
        *args, mask=mask, **kw).fields())
    active = ~out.success
    got = A.pertask_fill(*args, banned=out.sub_dom, active=active, base=out,
                         mask=mask, **kw)
    assert_same(got.fields(), A.pertask_fill_plain(
        *args, banned=out.sub_dom, active=active, base=out, mask=mask,
        **kw).fields())
    assert kernels.launch_counts()["pertask_fill:mask"] == 3


def test_cuda_affinity_cycle_equals_cpu_cycle(cuda):
    """The affinity fleet at 512 nodes through the allocate-only Scheduler
    on the card and on the CPU: packed commit, BindRequests and the
    claimed-domain table equal; the card's cycle went through K12, K13
    and K3's mask mode."""
    from kai_scheduler_tpu_torch.framework.scheduler import SchedulerConfig
    out, counts = {}, {}
    for device in ("cuda", "cpu"):
        objs = fleets.affinity_objects(
            apis, make_cluster, num_nodes=512, node_accel=8.0, num_gangs=240,
            tasks_per_gang=8, services=16, anchors=32, dependers=32,
            port_gangs=48)
        kernels.reset_launch_counts()
        out[device] = Scheduler(SchedulerConfig(actions=("allocate",)),
                                device=device).run_once(
            Cluster.from_objects(*objs))
        counts[device] = kernels.launch_counts()
    need = ("affinity_mask", "anti_mark", "uniform_fill:mask",
            "sparse_accept")
    assert all(counts["cuda"][k] > 0 for k in need), counts["cuda"]
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.packed.tobytes() == cpu.packed.tobytes()
    assert [dataclasses.astuple(b) for b in gpu.bind_requests] == \
        [dataclasses.astuple(b) for b in cpu.bind_requests]
    assert torch.equal(gpu.tensors.anti_used.cpu(), cpu.tensors.anti_used)


@pytest.mark.parametrize("batch_size", [1, 64])
def test_cuda_affinity_reclaim_cycle_equals_cpu_cycle(cuda, batch_size):
    """The affinity_reclaim fleet at 256 nodes through the five default
    actions on the card and on the CPU, with reclaim sequential (the
    one-lane mask of the scenario search) and chunked: packed commit,
    evictions and the claimed-domain table equal; K12, K13 and K3's mask
    mode launched."""
    from kai_scheduler_tpu_torch.framework.scheduler import SchedulerConfig
    from kai_scheduler_tpu_torch.framework.session import SessionConfig
    from kai_scheduler_tpu_torch.ops.victims import VictimConfig
    cfg = SchedulerConfig(session=SessionConfig(
        victims=VictimConfig(batch_size=batch_size)))
    out, counts = {}, {}
    for device in ("cuda", "cpu"):
        objs = fleets.affinity_reclaim_objects(
            apis, make_cluster, services=8, num_nodes=256, node_accel=4.0,
            num_gangs=160, tasks_per_gang=8, running_fraction=0.8,
            queue_accel_quota=30.0, partition_queues_by_running=True)
        kernels.reset_launch_counts()
        out[device] = Scheduler(cfg, device=device).run_once(
            Cluster.from_objects(*objs))
        counts[device] = kernels.launch_counts()
    need = ("affinity_mask", "anti_mark", "uniform_fill:mask")
    assert all(counts["cuda"][k] > 0 for k in need), counts["cuda"]
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.evictions
    assert gpu.packed.tobytes() == cpu.packed.tobytes()
    assert [dataclasses.astuple(e) for e in gpu.evictions] == \
        [dataclasses.astuple(e) for e in cpu.evictions]
    assert torch.equal(gpu.tensors.anti_used.cpu(), cpu.tensors.anti_used)


# ---------------------------------------------------------------------------
# the analytics pass (K14) and the repack plan's first fit (K15)
# ---------------------------------------------------------------------------

def _analytics_inputs(cuda, name: str, seed: int):
    """A snapshot on the card, its free pool lowered, and a commit set
    drawn from the seed: uniform (whole units), sharing (fractional and
    memory-based shares) and rack topology with one node unlabelled."""
    from kai_scheduler_tpu_torch.framework.session import Session
    from kai_scheduler_tpu_torch.ops.allocate import init_result
    if name == "sharing":
        objs = fleets.sharing_objects(apis, num_nodes=200, shared_nodes=100,
                                      training=20, fractions=80, memory=40,
                                      launchers=8, seed=seed)
    else:
        objs = make_cluster(num_nodes=300, num_gangs=200, tasks_per_gang=4,
                            running_fraction=0.5, seed=seed,
                            num_departments=3, queues_per_department=4,
                            topology_levels=(4, 5) if name == "topology"
                            else ())
    if name == "topology":
        objs[0][0].labels.clear()
    st = Session.open(*objs, device=cuda).state
    rng = np.random.default_rng(seed)
    G, T, M = st.gangs.g, st.gangs.t, st.running.m
    n = st.nodes

    def dev(a):
        return torch.from_numpy(a).to(cuda)
    drop = rng.choice([0.0, 1.0, 0.3, 2.0], n.free.shape).astype(np.float32)
    st = dataclasses.replace(st, nodes=dataclasses.replace(
        n, free=torch.clamp(n.free - dev(drop), min=0.0)))
    res = init_result(st)
    res = dataclasses.replace(
        res, allocated=dev(rng.random(G) < 0.3),
        placements=dev(np.where(rng.random((G, T)) < 0.5,
                                rng.integers(0, n.n, (G, T)), -1)
                       .astype(np.int32)),
        pipelined=dev(rng.random((G, T)) < 0.2),
        victim=dev(rng.random(M) < 0.2),
        free=torch.clamp(st.nodes.free - dev(rng.choice(
            [0.0, 1.0, 0.5], n.free.shape).astype(np.float32)), min=0.0),
        releasing_extra=dev(rng.choice([0.0, 0.0, 0.25], n.free.shape)
                            .astype(np.float32)),
        queue_allocated=st.queues.allocated + dev(rng.uniform(
            0, 5, st.queues.allocated.shape).astype(np.float32)))
    ages = dev(np.where(rng.random(G) < 0.5, rng.integers(0, 9, G), 0)
               .astype(np.float32))
    return st, res, ages


@pytest.mark.parametrize("name", ["uniform", "sharing", "topology"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_analytics_matches_plain(cuda, name, seed):
    """K14 against its plain version on the same card tensors, every field
    byte-equal: fractional summands (the pairwise tree order on both
    sides), a node without the rack label, all-tie ages (every age 0) and
    each rack level."""
    from kai_scheduler_tpu_torch.ops import analytics as AN
    st, res, ages = _analytics_inputs(cuda, name, seed)
    for rl, a in ((0, ages), (1, torch.zeros_like(ages)), (4, ages)):
        cfg = AN.AnalyticsConfig(rack_level=rl, top_k=8 + 8 * rl)
        before = kernels.KERNELS["cluster_analytics"].launches
        got = AN.cluster_analytics(st, res, a, config=cfg)
        assert kernels.KERNELS["cluster_analytics"].launches == before + 1
        want = AN.cluster_analytics_plain(st, res, a, config=cfg)
        for f in AN.F32_FIELDS + AN.I32_FIELDS:
            x, y = getattr(got, f), getattr(want, f).to(getattr(got, f).dtype)
            assert x.shape == y.shape, f
            assert x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes(), f


@pytest.mark.parametrize("slots", ["empty", "full", "mixed"])
def test_repack_fill_matches_plain(cuda, slots):
    """K15 against its plain version: an empty plan (every slot -1), a full
    plan of 64 pods (some fit nowhere), and a mixed one; filter classes
    and a destination mask."""
    from kai_scheduler_tpu_torch.ops import repack as RP
    rng = np.random.default_rng(len(slots))
    N, M, X, P = 700, 2000, 3, 64
    pods = rng.choice(M, P, replace=False).astype(np.int32)
    if slots == "empty":
        pods[:] = -1
    elif slots == "mixed":
        pods[rng.random(P) < 0.4] = -1
    req = rng.choice([1.0, 2.0, 0.5], (M, 3)).astype(np.float32)
    req[:, 2] *= 4
    t = dict(
        slot_pod=pods, req=req,
        filter_class=rng.integers(-1, X + 1, M).astype(np.int32),
        dest_ok=rng.random(N) < 0.8,
        filter_masks=rng.random((X, N)) < 0.7,
        free0=rng.choice([0.0, 1.0, 2.0, 8.0], (N, 3)).astype(np.float32))
    t = {k: torch.from_numpy(v).to(cuda) for k, v in t.items()}
    before = kernels.KERNELS["repack_fill"].launches
    got = RP.repack_fill(**t)
    assert kernels.KERNELS["repack_fill"].launches == before + 1
    want = RP.repack_fill_plain(**t)
    assert torch.equal(got, want)
    if slots == "empty":
        assert bool((got == -1).all())
    else:
        assert bool((got >= 0).any())


def test_cuda_repack_cycles_equal_cpu_cycles(cuda):
    """The repack_racks fleet at 256 nodes (32 racks) through four default
    allocate-only cycles on the card and on the CPU, each with its own
    binder: every packed commit (analytics and plan tails included) and
    document equal; the trigger fires on cycle 3 (K15 and K4's repack
    mode launched) and the gang places on cycle 4 in one rack."""
    from kai_scheduler_tpu_torch.binder import Binder
    from kai_scheduler_tpu_torch.framework.scheduler import SchedulerConfig
    runs = {}
    for device in ("cuda", "cpu"):
        cluster = Cluster.from_objects(*fleets.repack_objects(
            apis, num_nodes=256, gangs=2))
        sched = Scheduler(SchedulerConfig(actions=("allocate",),
                                          repack_frag_threshold=0.4),
                          device=device)
        binder, cycles = Binder(), []
        for _ in range(4):
            kernels.reset_launch_counts()
            res = sched.run_once(cluster)
            cycles.append((res, kernels.launch_counts()))
            binder.reconcile(cluster)
            cluster.tick()
        runs[device] = cycles
    for (g, counts), (c, _) in zip(runs["cuda"], runs["cpu"]):
        assert g.packed.tobytes() == c.packed.tobytes()
        assert g.analytics == c.analytics
        assert {k: v for k, v in g.repack.items() if k != "solve_seconds"} \
            == {k: v for k, v in c.repack.items() if k != "solve_seconds"}
        assert counts["cluster_analytics"] == 1
    fired = runs["cuda"][2]
    assert fired[0].repack["migrations_executed"] == 24
    assert fired[1]["repack_fill"] == 1 and \
        fired[1]["sparse_accept:repack"] == 1
    assert len(runs["cuda"][3][0].bind_requests) == 32


# ---------------------------------------------------------------------------
# K16: the packed-delta apply of the resident path
# ---------------------------------------------------------------------------

def _mirror_and_delta(seed: int, nan_bits: bool = False):
    """A host mirror of a small snapshot, a same-shape mutation of it (a
    few elements of a random subset of leaves), and the packed delta."""
    from kai_scheduler_tpu_torch.ops import resident as RS
    from kai_scheduler_tpu_torch.state.cluster_state import (
        build_snapshot, leaf_paths)
    rng = np.random.default_rng(seed)
    _s, _i, old = build_snapshot(*make_cluster(
        num_nodes=24, num_gangs=16, tasks_per_gang=4,
        running_fraction=0.5), device="cpu", return_host=True)
    new = {}
    for p in leaf_paths():
        leaf = old[p]
        if rng.random() > 0.6 or leaf.size == 0:
            new[p] = leaf
            continue
        a = leaf.copy().reshape(-1)
        idx = rng.choice(leaf.size, size=max(1, leaf.size // 10),
                         replace=False)
        if a.dtype.kind == "f":
            a[idx] += 1.5
            if nan_bits:
                a.view(np.uint32)[idx[:1]] = 0x7FC01234
                a.view(np.uint32)[idx[1:2]] = 0x80000000
        elif a.dtype.kind == "b":
            a[idx] = ~a[idx]
        else:
            a[idx] += 1
        new[p] = a.reshape(leaf.shape)
    delta, _m, stats = RS.pack_delta(old, new,
                                     min_buckets={"gangs.bool": 1024})
    return old, new, delta, stats


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resident_apply_matches_plain(cuda, seed):
    """K16 on a state uploaded as one buffer and on one whose leaves were
    swapped for separate tensors: the state comes out bit-equal to the
    plain version's (NaN payloads and -0.0 included) and equal to the new
    mirror; one launch; an empty delta launches nothing."""
    from kai_scheduler_tpu_torch.ops import resident as RS
    from kai_scheduler_tpu_torch.state.cluster_state import (
        state_from_leaves, state_from_numpy, state_leaves)
    old, new, delta, stats = _mirror_and_delta(seed, nan_bits=seed == 2)
    ddev = {part: {k: torch.from_numpy(v).to(cuda) for k, v in d.items()}
            for part, d in delta.items()}
    for swapped in (False, True):
        k_st = state_from_numpy(old, cuda)
        if swapped:
            k_st = state_from_leaves({k: t.clone() for k, t in
                                      state_leaves(k_st).items()})
        p_st = state_from_numpy(old, cuda)
        kernels.reset_launch_counts()
        RS.apply_delta(k_st, ddev)
        assert kernels.launch_counts()["resident_apply"] == 1
        RS.apply_delta_plain(p_st, ddev)
        torch.cuda.synchronize()
        for (p, a), b in zip(state_leaves(k_st).items(),
                             state_leaves(p_st).values()):
            got = a.cpu().numpy()
            # bit for bit against the plain version; by value against the
            # new mirror (the packer, as the reference's, sees -0.0 ==
            # +0.0 as unchanged)
            assert got.tobytes() == b.cpu().numpy().tobytes(), p
            assert np.array_equal(got, new[p],
                                  equal_nan=got.dtype.kind == "f"), p
    empty = {part: {k: v[:0] for k, v in d.items()}
             for part, d in ddev.items()}
    kernels.reset_launch_counts()
    RS.apply_delta(k_st, empty)
    assert kernels.launch_counts()["resident_apply"] == 0


def test_resident_apply_refuses_what_it_cannot_take(cuda):
    """On a CUDA state K16 launches or raises: a delta on the CPU, or a
    value segment of the wrong dtype, raises; nothing falls back to the
    plain version."""
    from kai_scheduler_tpu_torch.ops import resident as RS
    from kai_scheduler_tpu_torch.state.cluster_state import state_from_numpy
    old, _new, delta, _stats = _mirror_and_delta(0)
    st = state_from_numpy(old, cuda)
    on_cpu = {part: {k: torch.from_numpy(v) for k, v in d.items()}
              for part, d in delta.items()}
    with pytest.raises(ValueError):
        RS.apply_delta(st, on_cpu)
    bad = {part: {k: torch.from_numpy(v).to(cuda) for k, v in d.items()}
           for part, d in delta.items()}
    key = next(k for k, v in bad["val"].items()
               if v.numel() and v.dtype == torch.float32)
    bad["val"][key] = bad["val"][key].to(torch.float64)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError):
        RS.apply_delta(st, bad)
    assert kernels.launch_counts()["resident_apply"] == 0


def test_cuda_resident_cycles_equal_cpu_cycles(cuda):
    """``SchedulerConfig(resident=True)`` on the card and on the CPU over
    the same churn stream: every packed commit equal, the device state
    equal to the host mirror after every cycle, K16 once a resident
    cycle."""
    from kai_scheduler_tpu_torch.framework.scheduler import SchedulerConfig
    out = {}
    for device in ("cpu", cuda):
        cluster = Cluster.from_objects(*fleets.steady_objects(
            apis, make_cluster, num_nodes=64, num_gangs=48,
            tasks_per_gang=4))
        sched = Scheduler(SchedulerConfig(resident=True), device=device)
        rng = np.random.default_rng(0)
        rows = []
        for _ in range(6):
            kernels.reset_launch_counts()
            res = sched.run_once(cluster)
            mode = sched._snapshotter.stats.last["mode"]
            rows.append((res.packed.tobytes(), mode,
                         kernels.launch_counts()["resident_apply"]))
            sched._snapshotter.verify_device_residency()
            fleets.churn_cluster(apis, cluster, rng, 0.05, 64,
                                 restart=True)
        out[str(device)] = rows
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert [r[:2] for r in gpu] == [r[:2] for r in cpu]
    assert any(m == "resident" for _p, m, _l in gpu)
    assert all(n == (1 if m == "resident" else 0) for _p, m, n in gpu)


# ---------------------------------------------------------------------------
# the redesigned K9 (node summary, one global pass a step) and K10 (entries
# sorted by node): the edges of their designs
# ---------------------------------------------------------------------------

def test_pertask_summary_matches_plain(cuda):
    """K9's prologue (the chunk-start node summary) against its plain
    mirror on the sharing lanes' pools: the 14 f32 rows value-equal, the
    bit word bit-equal."""
    args, kw = _sharing_lanes(cuda, B=8, num_nodes=400, placement={},
                              seed=5)
    n, free, dev, extra, extra_dev = (args[0], args[4], args[5], args[8],
                                      args[9])
    got = A.pertask_summary(n, free, dev, extra, extra_dev)
    want = A.pertask_summary_plain(n, free, dev, extra, extra_dev)
    assert torch.equal(got[:-1], want[:-1])
    assert torch.equal(got[-1].view(torch.int32), want[-1].view(torch.int32))


def _tie_lanes(cuda, *, B: int, num_nodes: int, seed: int = 0):
    """K9's arguments on an empty fleet of identical nodes: every node
    scores alike but for the tie jitter, which is below f32 spacing over
    hundreds of consecutive ranks, so the lowest node of a tie wins
    across warp and tile boundaries."""
    objs = fleets.sharing_objects(
        apis, num_nodes=num_nodes, shared_nodes=0, training=4,
        fractions=8, memory=4, launchers=2, seed=seed)
    ses = Session.open(*objs, device=cuda)
    st = ses.state
    g, n, q = st.gangs, st.nodes, st.queues
    rng = np.random.default_rng(seed)
    ng = len(ses.index.gang_names)
    cand = torch.from_numpy(rng.integers(0, ng, B).astype(np.int32)).to(cuda)
    prior = torch.full((B, g.t), -1, dtype=torch.int32, device=cuda)
    inf = float("inf")
    args = (n, A.TaskTables.of(st), cand, prior, n.free.clone(),
            n.device_free.clone(), q.allocated, q.allocated_nonpreemptible,
            torch.zeros_like(n.free), torch.zeros_like(n.device_free),
            A._chain_membership(q.parent, ses.config.num_levels),
            torch.where(q.limit <= -0.5, inf, q.limit),
            torch.where(q.quota <= -0.5, inf, q.quota))
    return args, dict(placement=PlacementConfig(), track_devices=True)


@pytest.mark.parametrize("num_nodes", [1000, 20_000])
def test_pertask_fill_ties_and_tiles_match_plain(cuda, num_nodes):
    """Ties across warp and tile boundaries (identical nodes), an N that
    is no multiple of 32 or of a warp's range, and at 20,000 nodes an N
    past the shared-memory staging (the nodes past it evaluated again in
    the second pass)."""
    args, kw = _tie_lanes(cuda, B=64, num_nodes=num_nodes)
    out = A.pertask_fill(*args, **kw)
    assert_same(out.fields(), A.pertask_fill_plain(*args, **kw).fields())
    assert bool((out.nodes_t >= 0).any())


def test_pertask_fill_touched_node_wins(cuda):
    """Binpack sends a lane's later tasks to the node its earlier ones
    took (the touched node's live rows win the argmax), on the sharing
    lanes with and without the device table."""
    args, kw = _sharing_lanes(cuda, B=64, num_nodes=400, placement={},
                              seed=11)
    for track in (True, False):
        kw2 = dict(kw, track_devices=track)
        out = A.pertask_fill(*args, **kw2)
        assert_same(out.fields(),
                    A.pertask_fill_plain(*args, **kw2).fields())
        nt = out.nodes_t.cpu().numpy()
        repeats = [len(set(r[r >= 0])) < int((r >= 0).sum()) for r in nt]
        assert any(repeats)


def _widest_topology_lanes(cuda, B=32, seed=0):
    """K9 at its limits: T = 64 task slots in 31 rack-required subgroups
    (S = 32), every third task a 0.5 fraction, on 31-device nodes whose
    device tables are padded with a used-up 32nd device (D = 32; the
    snapshot takes 31 devices a node)."""
    nodes, queues, _, _, topo = make_cluster(
        num_nodes=128, node_accel=31.0, num_gangs=0,
        topology_levels=(2, 8))
    leaves = [q.name for q in queues if q.parent is not None]
    rack = apis.TopologyConstraint(topology="default",
                                   required_level="topo/level1")
    groups, pods = [], []
    for gi in range(12):
        name = f"wide-{gi}"
        subs = [apis.SubGroup(f"s{k}", min_member=2 if k < 30 else 4,
                              topology_constraint=rack) for k in range(31)]
        groups.append(apis.PodGroup(name, queue=leaves[gi % len(leaves)],
                                    min_member=64, sub_groups=subs,
                                    creation_timestamp=float(gi)))
        for t in range(64):
            frac = t % 3 == 0
            pods.append(apis.Pod(
                f"{name}-{t}", name,
                resources=apis.ResourceVec(0.0 if frac else 1.0, 1.0, 2.0),
                accel_portion=0.5 if frac else 0.0,
                subgroup=f"s{min(t // 2, 30)}", creation_timestamp=float(gi)))
    ses = Session.open(nodes, queues, groups, pods, topo, device=cuda)
    st = ses.state
    n, q = st.nodes, st.queues
    pad = torch.zeros((n.n, 1), dtype=torch.float32, device=cuda)
    n = dataclasses.replace(
        n, device_free=torch.cat([n.device_free, pad], 1).contiguous(),
        device_releasing=torch.cat([n.device_releasing, pad],
                                   1).contiguous())
    tt = A.TaskTables.of(st)
    assert (tt.task_valid.shape[1], n.device_free.shape[1],
            tt.subgroup_min_needed.shape[1]) == (64, 32, 32)
    rng = np.random.default_rng(seed)
    ng = len(ses.index.gang_names)
    cand = torch.from_numpy(rng.integers(0, ng, B).astype(np.int32)).to(cuda)
    prior = torch.full((B, 64), -1, dtype=torch.int32, device=cuda)
    inf = float("inf")
    args = (n, tt, cand, prior, n.free.clone(), n.device_free,
            q.allocated, q.allocated_nonpreemptible, torch.zeros_like(n.free),
            torch.zeros_like(n.device_free),
            A._chain_membership(q.parent, ses.config.num_levels),
            torch.where(q.limit <= -0.5, inf, q.limit),
            torch.where(q.quota <= -0.5, inf, q.quota))
    return args, dict(placement=ses.config.allocate.placement,
                      track_devices=True, topo=A.TopoStatic.of(n))


def test_pertask_fill_at_its_limits_with_topology(cuda):
    """T = 64, D = 32, S = 32 with subgroup topology: the first attempt,
    then the banned retry of two lanes only (a sparse ``active``) on the
    first launch's scratch."""
    args, kw = _widest_topology_lanes(cuda)
    agg = A.pertask_agg_scratch(kw["topo"], args[4])
    out = A.pertask_fill(*args, agg=agg, **kw)
    assert_same(out.fields(), A.pertask_fill_plain(*args, **kw).fields())
    assert bool((out.nodes_t >= 0).sum(-1).max() > 32)
    active = torch.zeros_like(out.success)
    active[3] = active[17] = True
    got = A.pertask_fill(*args, banned=out.sub_dom, active=active, base=out,
                         agg=agg, **kw)
    assert_same(got.fields(), A.pertask_fill_plain(
        *args, banned=out.sub_dom, active=active, base=out, **kw).fields())


def test_pertask_fill_all_false_mask_rows(cuda):
    """The mask mode with whole rows of the mask false: those lanes
    place nothing, the others as their plain version."""
    args, kw = _sharing_lanes(cuda, B=64, num_nodes=400, placement={},
                              seed=7)
    mask = _lane_mask(cuda, 64, args[0].valid, 2)
    mask[::5] = False
    out = A.pertask_fill(*args, mask=mask, **kw)
    assert_same(out.fields(), A.pertask_fill_plain(*args, mask=mask,
                                                   **kw).fields())
    assert bool((out.nodes_t[::5] < 0).all())


def _dense_inputs(cuda, *, B, T, N=64, D=8, Q=6, seed=0, one_node=False,
                  dup=False, failed=0.0, zero=False, floor_at=None):
    """K10's arguments, synthetic: each lane places its slots on random
    nodes (or slot 0 of every lane on node 7), whole-unit and fractional
    claims, some bind-now; a lane's repeated node carries the same final
    row in both slots, as K9 writes it.  ``floor_at`` puts node 7's cpu
    floor where the ``floor_at``-th lane's cumulative claim crosses it;
    ``zero`` puts one node's pool below its floor (the zero claim)."""
    rng = np.random.default_rng(seed)
    free = rng.choice(np.array([4.0, 8.0, 16.0, 300.0], np.float32), (N, 3))
    if one_node:
        free[:] = 300.0
    dev = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (N, D))
    rel_floor = -rng.choice(np.array([0.0, 1.0], np.float32), (N, 3)) - 1e-6
    dev_floor = -rng.choice(np.array([0.0, 0.5], np.float32), (N, D)) - 1e-6
    # distinct nodes within a lane (node 7 only in slot 0 with one_node)
    others = np.array([i for i in range(N) if not (one_node and i == 7)])
    nodes_b = np.stack([rng.choice(others, T, replace=False)
                        for _ in range(B)]).astype(np.int32)
    nodes_b[rng.random((B, T)) < 0.3] = -1
    if one_node:
        nodes_b[:, 0] = 7
    if dup:
        nodes_b[::3, 1] = nodes_b[::3, 0]
    claim = rng.choice(np.array([0.25, 0.5, 1.0, 2.0], np.float32), (B, T, 3))
    dclaim = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (B, T, D))
    bind = np.where(rng.random((B, T, 1)) < 0.5, claim, 0.0).astype(
        np.float32)
    dbind = np.where(rng.random((B, T, 1)) < 0.5, dclaim, 0.0).astype(
        np.float32)
    nb = np.clip(nodes_b, 0, None)
    if dup:   # the later slot repeats the first's final row
        for arr in (claim, dclaim, bind, dbind):
            arr[::3, 1] = arr[::3, 0]
    free_rows = np.where((nodes_b >= 0)[..., None], free[nb] - claim, 0.0)
    dev_rows = np.where((nodes_b >= 0)[..., None], dev[nb] - dclaim, 0.0)
    bind = np.where((nodes_b >= 0)[..., None], bind, 0.0)
    dbind = np.where((nodes_b >= 0)[..., None], dbind, 0.0)
    ok = rng.random(B) >= failed
    if floor_at is not None:   # lane k's claim at node 7 is claim[k, 0]
        cum = np.cumsum(np.where(ok, claim[:, 0, 1], 0.0))
        rel_floor[7, 1] = np.float32(300.0 - (cum[floor_at - 1]
                                              + cum[floor_at]) / 2)
    if zero:
        rel_floor[3, 0] = free[3, 0] + 1.0
    gate = rng.random(B) < 0.9
    d_qa = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (B, Q, 3))
    d_qan = d_qa * (rng.random((B, 1, 1)) < 0.5)
    qa = rng.random((Q, 3)).astype(np.float32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    return (t(nodes_b), t(ok), t(gate), t(free_rows.astype(np.float32)),
            t(dev_rows.astype(np.float32)), t(bind), t(dbind), t(free),
            t(dev), t(rel_floor.astype(np.float32)),
            t(dev_floor.astype(np.float32)), t(d_qa), t(d_qan.astype(
                np.float32)), t(qa), t(qa.copy()))


DENSE_EDGE_CASES = {
    # 256 lanes all on node 7, crossing the 16-lane blocks; the floor
    # crossed at lane 150
    "one_node": dict(B=256, T=2, one_node=True, floor_at=150),
    # a lane's node repeated in a second slot, and failed lanes
    "dup_slots": dict(B=64, T=4, dup=True),
    "failed": dict(B=128, T=4, failed=0.4),
    # first_bad = 0: the zero claim fails
    "zero_claim": dict(B=32, T=4, zero=True),
    # B x T at the shared-memory sort's limit (16,384 entries), and past
    # it (the sort in global memory)
    "limit": dict(B=256, T=64, N=4096),
    "past_limit": dict(B=256, T=80, N=4096),
}


@pytest.mark.parametrize("case", list(DENSE_EDGE_CASES))
def test_dense_accept_edges_match_plain(cuda, case):
    dargs = _dense_inputs(cuda, seed=len(case), **DENSE_EDGE_CASES[case])
    for track in (True, False):
        out = A.dense_accept(*dargs, track_devices=track)
        want = A.dense_accept_plain(*dargs, track_devices=track)
        assert_same(out, want)
    take = out[0]
    if case == "zero_claim":
        assert not bool(take.any())
    if case == "one_node":
        assert bool(take[:140].any()) and not bool(take[150:].any())


# ---------------------------------------------------------------------------
# K3 and K6 at the edges of their Hopper designs
# ---------------------------------------------------------------------------

def _uniform_inputs(cuda, num_nodes=300, tasks_per_gang=8, B=64,
                    running_fraction=0.0, seed=0):
    """One uniform chunk's lanes over random real gangs of a
    ``make_cluster`` fleet (K2's tables, the queue caps, the chains)."""
    ses = _session(cuda, num_nodes=num_nodes, num_gangs=max(B, 40),
                   tasks_per_gang=tasks_per_gang, num_departments=2,
                   queues_per_department=2,
                   running_fraction=running_fraction, seed=seed)
    st, cfg = ses.state, ses.config.allocate
    g, n, q = st.gangs, st.nodes, st.queues
    rng = np.random.default_rng(seed)
    ng = len(ses.index.gang_names)
    cand = torch.from_numpy(rng.integers(0, ng, B).astype(np.int32)).to(cuda)
    prior = torch.full((B, g.t), -1, dtype=torch.int32, device=cuda)
    lim = torch.where(q.limit <= -0.5, float("inf"), q.limit)
    quo = torch.where(q.quota <= -0.5, float("inf"), q.quota)
    tables = A.type_tables(n, n.free, torch.zeros_like(n.free), g.type_req,
                           g.type_selector, g.type_class, cfg.placement)
    args = (cand, prior, g.min_needed[cand.long()].contiguous(),
            q.allocated, q.allocated_nonpreemptible, lim, quo,
            A._chain_membership(q.parent, 2), A.LaneTables.of(st), tables,
            n.soft_scores, n.valid)
    return st, args


def _signed_zero_rows(cuda, args, B, N, stride, seed):
    """Tables and a score bias under which, in the dense hoisted order
    ``((bands + soft) + jitter) + bias``, every lane's scores are +0.0
    (bias = -jitter), -0.0 at the node whose jitter is -0.0 (bias -0.0),
    a few positives, and KAI_BIG_NEG where the lane's mask is off."""
    fi, fp, ci, cp, sc = args[9]
    rng = np.random.default_rng(seed)
    lanes = torch.arange(B)[:, None]
    offs = torch.arange(N)[None] - lanes * stride
    jit = A._jitter_scale(N) * torch.remainder(offs, N).to(torch.float32)
    bias = torch.where(jit == 0, torch.tensor(-0.0), -jit)
    bump = torch.from_numpy(rng.random((B, N)) < 0.005)
    bump[::4] = False
    bias = torch.where(bump, bias + 1.0, bias)
    tables = (fi, fp, ci, cp, torch.full_like(sc, -0.0))
    soft = torch.full_like(args[10], -0.0)
    valid = _lane_mask(cuda, B, args[11], seed).cpu()
    # every fourth lane keeps its -0.0 node and three +0.0 nodes of higher
    # index: lax.top_k puts those first (-0.0 ranks below +0.0, whatever
    # the index), so the -0.0 node takes no replica
    for b in range(0, B, 4):
        x = b * stride % N
        keep = [x] + rng.choice(np.arange(x + 1, N), 3,
                                replace=False).tolist()
        valid[b] = False
        valid[b, keep] = True
    return (args[:9] + (tables, soft, valid.to(cuda)),
            bias.to(cuda))


UNIFORM_EDGE_CASES = {
    # an empty cluster: every score ties, the lower node wins
    "ties": dict(),
    "k1": dict(tasks_per_gang=1, one_slot=True),
    "k64": dict(tasks_per_gang=64, B=32),
    # N not a multiple of a warp, of a block or of a step
    "n_odd": dict(num_nodes=1001),
    # more nodes than one block's threads hold in a step many times over
    "n_large": dict(num_nodes=20_000, B=8),
    # a partly filled cluster: distinct scores, the thresholds rise
    "partly_filled": dict(running_fraction=0.5, seed=3),
    # +0.0, -0.0, positives and KAI_BIG_NEG in one row
    "signed_zeros": dict(signed_zeros=True),
}


@pytest.mark.parametrize("case", list(UNIFORM_EDGE_CASES))
def test_uniform_fill_edges_match_plain(cuda, case):
    """K3 (plain mode, the mask mode, the per-lane victim mode with a
    score bias) byte-equal to its plain version at its design's edges."""
    spec = dict(UNIFORM_EDGE_CASES[case])
    zeros = spec.pop("signed_zeros", False)
    one_slot = spec.pop("one_slot", False)
    st, args = _uniform_inputs(cuda, **spec)
    if one_slot:   # T = 1: a top-k of one
        lt = dataclasses.replace(
            args[8], task_valid=args[8].task_valid[:, :1].contiguous())
        args = (args[0], args[1][:, :1].contiguous()) + args[2:8] + (lt,) \
            + args[9:]
    B, N = args[1].shape[0], st.nodes.n
    stride = max(1, N // B)
    runs = []
    if zeros:
        zargs, bias = _signed_zero_rows(cuda, args, B, N, stride, seed=5)
        runs.append((zargs, dict(dense=True, stride=stride, hoisted=True,
                                 score_bias=bias)))
    else:
        for dense in (True, False):
            for hoisted in (True, False):
                runs.append((args, dict(dense=dense, stride=stride,
                                        hoisted=hoisted)))
        masked = args[:11] + (_lane_mask(cuda, B, args[11], seed=1),)
        runs.append((masked, dict(dense=False, stride=1, hoisted=True)))
        rng = np.random.default_rng(2)
        q = st.queues
        qa_b = (q.allocated[None] - torch.from_numpy(rng.choice(
            [0.0, 1.0, 0.5], (B, q.q, 3)).astype(np.float32)).to(cuda))
        bias = torch.from_numpy(np.where(rng.random((B, N)) < 0.05, 9.5,
                                         0.0).astype(np.float32)).to(cuda)
        rows = torch.from_numpy((np.arange(B) % args[9][1].shape[0])
                                .astype(np.int32)).to(cuda)
        lanes = args[:3] + (qa_b,) + args[4:]
        runs.append((lanes, dict(dense=False, stride=1, hoisted=False,
                                 rows=rows, score_bias=bias)))
    for a, kw in runs:
        before = kernels.KERNELS["uniform_fill"].launches
        out = A.uniform_fill(*a, **kw)
        assert kernels.KERNELS["uniform_fill"].launches == before + 1
        assert_same(out, A.uniform_fill_plain(*a, **kw))
    if zeros:
        # the lanes cut to four nodes place, never on their -0.0 node
        placed = out[2][::4].cpu()
        minus = torch.arange(0, B, 4) * stride % N
        assert bool((placed >= 0).any(-1).all())
        assert not bool((placed == minus[:, None]).any())


def _freed_leaves(cuda, seed=0):
    from kai_scheduler_tpu_torch.state import state_to_numpy
    st, ses = _victim_state(cuda, seed=seed, num_nodes=1000,
                            num_gangs=1500, tasks_per_gang=4,
                            running_fraction=0.9,
                            num_departments=3, queues_per_department=3)
    return state_to_numpy(st), ses


def _freed_case(leaves, case, rng):
    """(leaves, mask) of one K6 edge case."""
    M = leaves["running.req"].shape[0]
    lv = dict(leaves)
    mask = rng.random(M) < 0.5
    if case == "empty_mask":
        mask[:] = False
    elif case == "all_masked":
        mask[:] = True
    elif case == "negative_node_queue":
        neg = rng.random(M) < 0.2
        lv["running.node"] = np.where(neg, -1, lv["running.node"]).astype(
            np.int32)
        lv["running.queue"] = np.where(rng.random(M) < 0.2, -1,
                                       lv["running.queue"]).astype(np.int32)
    elif case == "one_queue":
        lv["running.queue"] = np.zeros(M, np.int32)
        mask = rng.random(M) < 0.9
    elif case in ("whole_below_2p24", "whole_above_2p24"):
        # one queue; ones everywhere and one large value at a random
        # masked pod: the total lands at 2^24 - 1 (every order exact) or
        # past 2^24 (only the ascending order gives the reference's bits)
        lv["running.queue"] = np.zeros(M, np.int32)
        mask = rng.random(M) < 0.95
        req = np.ones_like(lv["running.req"])
        big = int(rng.choice(np.nonzero(mask)[0]))
        n_ones = int(mask.sum()) - 1
        req[big] = 2.0 ** 24 - 1 - n_ones
        if case == "whole_above_2p24":
            req[big] += 3 + n_ones // 2
        lv["running.req"] = req
    elif case == "shapes":
        # D = 0, E = 0, R = 12 (whole and fractional columns)
        N = lv["nodes.device_free"].shape[0]
        lv["nodes.device_free"] = np.zeros((N, 0), np.float32)
        lv["running.device"] = np.full(M, -1, np.int32)
        lv["running.extended"] = np.zeros((M, 0), np.float32)
        lv["running.req"] = np.where(
            rng.random((M, 12)) < 0.5, rng.integers(0, 9, (M, 12)),
            rng.random((M, 12))).astype(np.float32)
    return lv, mask


FREED_EDGE_CASES = ("empty_mask", "all_masked", "negative_node_queue",
                    "one_queue", "fractional", "whole_below_2p24",
                    "whole_above_2p24", "shapes")


@pytest.mark.parametrize("case", FREED_EDGE_CASES)
def test_freed_by_mask_edges_match_plain(cuda, case):
    """K6 and its queue-only mode byte-equal to the plain version at its
    design's edges (the fractional case: memory-scale and fractional
    summands, the ordered path)."""
    from kai_scheduler_tpu_torch.ops import victims as V
    from kai_scheduler_tpu_torch.state import state_from_numpy
    leaves, ses = _freed_leaves(cuda, seed=len(case))
    rng = np.random.default_rng(len(case))
    lv, mask_np = _freed_case(leaves, case, rng)
    st = state_from_numpy(lv, cuda)
    cst = state_from_numpy(lv, "cpu")
    chain = A._chain_membership(st.queues.parent, ses.config.num_levels)
    mask = torch.from_numpy(mask_np).to(cuda)
    kernels.reset_launch_counts()
    got = V.freed_by_mask(st, mask, chain)
    want = V.freed_by_mask_plain(cst, mask.cpu(), chain.cpu())
    assert_same(got, want)
    got_q = V.freed_by_mask(st, mask, chain, queues_only=True)
    assert_same(got_q, want[2:4])
    counts = kernels.launch_counts()
    assert (counts["freed_by_mask"],
            counts["freed_by_mask:queues_only"]) == (2, 1)
    if case.startswith("whole"):
        # the queue's pods span several of a queue block's tiles; past
        # 2^24 the ascending sum rounds (its bits are not the exact
        # total's, which a tree over these summands would give)
        vals = lv["running.req"][mask_np][:, 0]
        assert vals.size > 2 * 2048
        exact = float(vals.astype(np.float64).sum())
        assert (float(want[2][0, 0]) == exact) == (case == "whole_below_2p24")


# ---------------------------------------------------------------------------
# the victim actions on per-task snapshots: K8's device table, K9's lanes
# and legacy modes, the stale pass's K6 device table, whole cycles
# ---------------------------------------------------------------------------

def _device_state(cuda, D: int, seed: int, **shape):
    """A running cluster on the card with ``D`` devices a node (the
    snapshot takes 31 at most: at 32 the node device tables gain a 32nd
    column): fractional shares (0.5, 24 GiB of 80 and random) on random
    devices, whole-device pods with random ``devices_mask`` bits over every
    device (bit 31 included at 32 devices), so fractional and whole-device
    pods meet on one device; a few pods on no node.  ``shape`` overrides
    the cluster's size."""
    from kai_scheduler_tpu_torch.state import state_from_numpy, state_to_numpy
    ses = _session(cuda, **dict(dict(
        num_nodes=200, node_accel=float(min(D, 31)), num_gangs=300,
        tasks_per_gang=4, running_fraction=0.8, num_departments=3,
        queues_per_department=3), **shape))
    lv = state_to_numpy(ses.state)
    for k in ("nodes.device_free", "nodes.device_releasing"):
        lv[k] = np.pad(lv[k], ((0, 0), (0, D - lv[k].shape[1])))
    rng = np.random.default_rng(seed)
    M = lv["running.req"].shape[0]
    frac = rng.random(M) < 0.4
    lv["running.device"] = np.where(frac, rng.integers(0, D, M),
                                    -1).astype(np.int32)
    lv["running.accel_held"] = np.where(frac, rng.choice(np.float32(
        [0.5, 0.3, 0.05, 0.7]), M), 0.0).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, M, dtype=np.uint64) & ((1 << D) - 1)
    lv["running.devices_mask"] = np.where(frac, 0, bits.astype(
        np.uint32).view(np.int32)).astype(np.int32)
    node = lv["running.node"].copy()
    node[rng.random(M) < 0.03] = -1
    lv["running.node"] = node
    return state_from_numpy(lv, cuda), ses


FREED_DEVICE_CASES = ("random", "empty", "one_lane", "d1", "d32")


@pytest.mark.parametrize("compose", [True, False])
@pytest.mark.parametrize("case", FREED_DEVICE_CASES)
def test_freed_by_lane_device_table_matches_plain(cuda, case, compose):
    """K8's device mode byte-equal to its plain version: an empty lane
    assignment, every pod in one lane, one and 32 devices a node,
    fractional and whole-device pods on one device; composed and not."""
    from kai_scheduler_tpu_torch.ops import victims as V
    D = {"d1": 1, "d32": 32}.get(case, 8)
    st, ses = _device_state(cuda, D, seed=len(case))
    assert st.nodes.d == D
    chain = A._chain_membership(st.queues.parent, ses.config.num_levels)
    rng = np.random.default_rng(len(case) + compose)
    M, B = st.running.m, 64
    lane = np.where(rng.random(M) < 0.7, rng.integers(0, B, M), B)
    if case == "empty":
        lane[:] = B
    elif case == "one_lane":
        lane[:] = 0
    lane = torch.from_numpy(lane.astype(np.int32)).to(cuda)
    kernels.reset_launch_counts()
    got = V.freed_by_lane(st, lane, B, chain, compose=compose, devices=True)
    counts = kernels.launch_counts()
    assert (counts["freed_by_lane"], counts["freed_by_lane:devices"]) == (1, 1)
    want = V.freed_by_lane_plain(_cpu_state(st), lane.cpu(), B, chain.cpu(),
                                 compose=compose, devices=True)
    assert_same(got, want)
    assert got[1].shape == (B, st.nodes.n, D)
    assert (float(got[1].sum()) > 0) == (case != "empty")
    # without the device table the kernel writes none
    assert V.freed_by_lane(st, lane, B, chain, compose=compose)[1] is None


def _lanes_mode_args(cuda, B: int, seed: int):
    """``_sharing_lanes``' inputs with each lane's own freed pools on a
    few nodes (0.5, 0.3 and whole devices, with their accel, cpu and
    memory), its queue table below the chunk's and an own-freed score
    bias; lanes 0 and 1 differ on one device only."""
    from kai_scheduler_tpu_torch.ops.scoring import W_OWN_FREED
    args, kw = _sharing_lanes(cuda, B=B, num_nodes=400, placement={},
                              seed=seed)
    (n, tt, cand, prior, free, dev, qa, qan, extra, extra_dev, chain,
     lim, quo) = args
    rng = np.random.default_rng(seed)
    N, D = dev.shape
    ex = np.repeat(extra.cpu().numpy()[None], B, 0)
    exd = np.repeat(extra_dev.cpu().numpy()[None], B, 0)
    bias = np.zeros((B, N), np.float32)
    for b in range(B):
        nodes = rng.choice(N, size=4, replace=False)
        for nd in nodes:
            d = (rng.choice(np.float32([0.5, 0.3, 1.0]), D)
                 * (rng.random(D) < 0.4)).astype(np.float32)
            exd[b, nd] += d
            ex[b, nd] += np.float32([d.sum(), 4.0, 16.0])
        bias[b, nodes] = W_OWN_FREED
    qa_b = np.repeat(qa.cpu().numpy()[None], B, 0)
    qa_b = (qa_b * rng.uniform(0.8, 1.0, qa_b.shape)).astype(np.float32)
    if B > 1:
        ex[1], exd[1], qa_b[1], bias[1] = ex[0], exd[0].copy(), qa_b[0], \
            bias[0]
        exd[1, int(np.argmax(bias[0])), 2] = 0.5

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    prior = torch.full_like(prior, -1)
    return ((n, tt, cand, prior, free, dev, t(qa_b), qan, t(ex), t(exd),
             chain, lim, quo),
            dict(kw, score_bias=t(bias), legacy=True))


@pytest.mark.parametrize("B", [1, 64, 256])
def test_pertask_fill_lanes_mode_matches_plain(cuda, B):
    """K9's lanes mode (per-lane freed pools, device table included,
    queue tables and score bias; the legacy protocol) byte-equal to its
    plain version; and the legacy protocol alone, with shared pools."""
    args, kw = _lanes_mode_args(cuda, B, seed=B)
    kernels.reset_launch_counts()
    out = A.pertask_fill(*args, **kw)
    counts = kernels.launch_counts()
    assert (counts["pertask_fill"], counts["pertask_fill:lanes"],
            counts["pertask_fill:legacy"]) == (1, 1, 1)
    assert_same(out.fields(),
                A.attempt_gang_in_domain_plain(*args, **kw).fields())
    if B > 1:
        assert bool((out.nodes_t >= 0).any())
    # shared device pools, per-lane node pools (no device table tracked)
    kw2 = dict(kw, track_devices=False)
    args2 = args[:9] + (args[9][0].contiguous(),) + args[10:]
    assert_same(A.pertask_fill(*args2, **kw2).fields(),
                A.attempt_gang_in_domain_plain(*args2, **kw2).fields())
    # the legacy protocol on the chunk-start pools (the solver's call)
    base, _ = _sharing_lanes(cuda, B=B, num_nodes=400, placement={}, seed=B)
    base = base[:3] + (torch.full_like(base[3], -1),) + base[4:]
    kw3 = dict(placement=kw["placement"], track_devices=True, legacy=True)
    assert_same(A.pertask_fill(*base, **kw3).fields(),
                A.attempt_gang_in_domain_plain(*base, **kw3).fields())


def test_pertask_fill_score_bias_decides_a_tie(cuda):
    """One fraction on a fleet of equal nodes: the kernel takes node 0
    without a bias and the biased node with it, as the plain version."""
    from kai_scheduler_tpu_torch.ops.scoring import W_OWN_FREED
    objs = fleets.sharing_objects(apis, num_nodes=64, shared_nodes=0,
                                  training=0, fractions=2, memory=0,
                                  launchers=0)
    st = Session.open(*objs, device=cuda).state
    n, q = st.nodes, st.queues
    inf = float("inf")
    ext = torch.zeros((1,) + n.free.shape, device=cuda)
    args = (n, A.TaskTables.of(st), torch.zeros((1,), dtype=torch.int32,
                                                device=cuda),
            torch.full((1, st.gangs.t), -1, dtype=torch.int32, device=cuda),
            n.free, n.device_free, q.allocated, q.allocated_nonpreemptible,
            ext, n.device_releasing[None].contiguous(),
            A._chain_membership(q.parent, 2),
            torch.where(q.limit <= -0.5, inf, q.limit),
            torch.where(q.quota <= -0.5, inf, q.quota))
    for node in (None, 9):
        bias = torch.zeros((1, n.n), device=cuda)
        if node is not None:
            bias[0, node] = W_OWN_FREED
        kw = dict(placement=PlacementConfig(), track_devices=True,
                  score_bias=bias, legacy=True)
        out = A.pertask_fill(*args, **kw)
        assert_same(out.fields(),
                    A.attempt_gang_in_domain_plain(*args, **kw).fields())
        assert int(out.nodes_t[0, 0]) == (0 if node is None else node)


def _sharing_reclaim_cluster():
    return Cluster.from_objects(*fleets.sharing_reclaim_objects(
        apis, num_nodes=200, training=6, fractions=16, memory=16,
        urgent=8))


@pytest.mark.parametrize("batch_size", [1, 64])
def test_cuda_sharing_reclaim_cycle_equals_cpu_cycle(cuda, batch_size):
    """The sharing_reclaim cell at 200 nodes through the five default
    actions on the card and on the CPU: packed commit, BindRequests,
    evictions and move rebinds equal; the victim actions went through
    K8's device table and K9's lanes mode (chunked) or K9's legacy mode
    and K7 (sequential)."""
    from kai_scheduler_tpu_torch.framework.scheduler import SchedulerConfig
    from kai_scheduler_tpu_torch.framework.session import SessionConfig
    from kai_scheduler_tpu_torch.ops.victims import VictimConfig
    out, counts = {}, {}
    for device in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        out[device] = Scheduler(SchedulerConfig(
            incremental=False, session=SessionConfig(victims=VictimConfig(
                batch_size=batch_size))), device=device).run_once(
            _sharing_reclaim_cluster())
        counts[device] = kernels.launch_counts()
    c = counts["cuda"]
    assert c["pertask_fill:legacy"] > 0 and c["replace_victims"] > 0, c
    if batch_size > 1:
        assert c["freed_by_lane:devices"] > 0, c
        assert c["pertask_fill:lanes"] > 0, c
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.evictions
    assert gpu.packed.tobytes() == cpu.packed.tobytes()
    for field in ("bind_requests", "evictions", "move_bind_requests"):
        assert [dataclasses.astuple(b) for b in getattr(gpu, field)] == \
            [dataclasses.astuple(b) for b in getattr(cpu, field)], field


def test_stale_pass_device_table_matches_plain(cuda):
    """The stale pass on a per-task snapshot: K6's device table (the
    stale whole-device and inference gangs' shares) credits the releasing
    device pool as the plain version does."""
    from kai_scheduler_tpu_torch.ops import stale as S
    from kai_scheduler_tpu_torch.ops.allocate import init_result
    from kai_scheduler_tpu_torch.state import state_from_numpy, state_to_numpy
    ses = Session.open(*fleets.sharing_reclaim_objects(
        apis, num_nodes=200, training=4, fractions=4, memory=4),
        device=cuda)
    lv = state_to_numpy(ses.state)
    running = lv["gangs.running_count"]
    pick = np.nonzero(running >= 1)[0][::7]
    lv["gangs.stale_s"] = lv["gangs.stale_s"].copy()
    lv["gangs.stale_s"][pick] = 120.0
    lv["gangs.min_member"] = lv["gangs.min_member"].copy()
    lv["gangs.min_member"][pick] = running[pick] + 1
    res = {}
    for device in (cuda, "cpu"):
        st = state_from_numpy(lv, device)
        kernels.reset_launch_counts()
        res[str(device)] = S.stale_gang_eviction(
            st, init_result(st), num_levels=ses.config.num_levels)
        if device is cuda:
            assert kernels.launch_counts()["freed_by_mask"] == 1
    got, want = res[str(cuda)], res["cpu"]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a.cpu(), b), f.name
    assert float(want.device_releasing_extra.sum()) > 0


# ---------------------------------------------------------------------------
# MIG and other extended scalar resources: K8, K9 and K10's extended modes
# ---------------------------------------------------------------------------

def _mig_session(cuda, num_nodes=400, **kw):
    objs = fleets.mig_reclaim_objects(
        apis, num_nodes=num_nodes, **dict(dict(
            inference=96, pairs=16, training=8, urgent=8, stale=2), **kw))
    nodes, queues, groups, pods, now = objs
    cluster = Cluster.from_objects(nodes, queues, groups, pods)
    cluster.now = now
    return cluster, Session.open(nodes, queues, groups, pods, device=cuda,
                                 now=now)


def _widen_ext(st, E: int, rng):
    """The snapshot's extended tables ([N, 3] node pools, [G, T, 3]
    requests, [3] g-numbers) cut to one key or padded to ``E`` with more
    keys: whole slice counts with g-numbers 1-4, and fractional non-MIG
    keys (g-number 0) of 0.25 / 0.5 shares.  Returns ``(nodes, tt, ext,
    ext_rel)``."""
    n, g = st.nodes, st.gangs
    dv = n.free.device
    ext, rel = n.extended_free.cpu().numpy(), n.extended_releasing.cpu().numpy()
    te, acc = g.task_extended.cpu().numpy(), g.ext_accel.cpu().numpy()
    if E <= 3:
        ext, rel, te, acc = ext[:, :E], rel[:, :E], te[..., :E], acc[:E]
    else:
        k = E - 3
        N, (G, T) = ext.shape[0], te.shape[:2]
        frac = np.arange(k) % 2 == 1
        cap = np.where(frac, rng.choice([0.0, 0.5, 1.5], (N, k)),
                       rng.integers(0, 5, (N, k))).astype(np.float32)
        ext = np.concatenate([ext, cap], 1)
        rel = np.concatenate([rel, np.where(rng.random((N, k)) < 0.2, 1.0,
                                            0.0).astype(np.float32)], 1)
        req = np.where(frac, rng.choice([0.25, 0.5], (G, T, k)), 1.0)
        req = np.where((rng.random((G, T, k)) < 0.15)
                       & g.task_valid.cpu().numpy()[..., None], req, 0.0)
        te = np.concatenate([te, req.astype(np.float32)], 2)
        acc = np.concatenate([acc, np.where(frac, 0.0, np.arange(k) % 4 + 1)
                              .astype(np.float32)])

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dv)
    tt = dataclasses.replace(A.TaskTables.of(st), task_extended=t(te),
                             ext_accel=t(acc))
    return (dataclasses.replace(n, extended_releasing=t(rel)), tt, t(ext),
            t(rel))


def _mig_lanes(cuda, *, B: int, E: int, mode: str, seed: int = 0):
    """K9's arguments in the extended mode on the MIG fleet (nodes with
    accel 0 beside whole-GPU nodes), ``E`` keys: ``allocate`` (prior
    placements, a shared extended credit), ``lanes`` (per-lane node, queue
    and extended credit, score bias, the legacy protocol) or ``legacy``
    (the solver's one-lane call, shared pools)."""
    from kai_scheduler_tpu_torch.ops.scoring import W_OWN_FREED
    _, ses = _mig_session(cuda)
    st = ses.state
    rng = np.random.default_rng(seed + E)
    nodes, tt, ext, _ = _widen_ext(st, E, rng)
    g, q = st.gangs, st.queues
    N, T = nodes.n, g.t
    ng = len(ses.index.gang_names)
    nn = len(ses.index.node_names)
    # lanes of the pending gangs (the running gangs place nothing)
    pending = np.nonzero(g.task_valid.any(-1).cpu().numpy()[:ng])[0]
    cand = rng.choice(pending, B).astype(np.int32)
    prior = np.full((B, T), -1, np.int32)
    if mode == "allocate":
        # a prior placement on the first task of every third multi-task lane
        multi = g.task_valid.sum(-1).cpu().numpy()[cand] > 1
        pick = np.nonzero(multi & (np.arange(B) % 3 == 0))[0]
        prior[pick, 0] = rng.integers(0, nn, len(pick))
    xe = np.zeros((N, E), np.float32)
    xe[rng.choice(nn, 8, replace=False)] = 1.0
    inf = float("inf")

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    # the cpu and memory the running slices hold are free again, so the
    # extended pools decide the fits
    free = torch.cat([nodes.free[:, :1], nodes.allocatable[:, 1:]], 1)
    dev = nodes.device_free
    qa, extra = q.allocated, torch.zeros_like(free)
    extra_dev = torch.zeros_like(dev)
    kw = dict(placement=PlacementConfig(), track_devices=True, ext=ext,
              ext_extra=t(xe))
    if mode == "lanes":
        xb = np.repeat(xe[None], B, 0)
        bias = np.zeros((B, N), np.float32)
        ex = np.zeros((B,) + tuple(free.shape), np.float32)
        for b in range(B):
            pick = rng.choice(nn, 3, replace=False)
            xb[b, pick] += np.float32(rng.choice([1.0, 2.0]))
            ex[b, pick] += np.float32([0.0, 8.0, 32.0])
            bias[b, pick] = W_OWN_FREED
        qa_b = q.allocated.cpu().numpy()[None].repeat(B, 0)
        qa = t((qa_b * rng.uniform(0.8, 1.0, qa_b.shape)).astype(np.float32))
        extra = t(ex)
        extra_dev = extra_dev[None].expand(B, *dev.shape).contiguous()
        kw.update(ext_extra=t(xb), score_bias=t(bias), legacy=True)
    elif mode == "legacy":
        kw.update(legacy=True)
    args = (nodes, tt, t(cand), t(prior), free, dev, qa,
            q.allocated_nonpreemptible, extra, extra_dev,
            A._chain_membership(q.parent, ses.config.num_levels),
            torch.where(q.limit <= -0.5, inf, q.limit),
            torch.where(q.quota <= -0.5, inf, q.quota))
    return args, kw


@pytest.mark.parametrize("mode", ["allocate", "lanes", "legacy"])
@pytest.mark.parametrize("B", [1, 256])
@pytest.mark.parametrize("E", [1, 3, 8])
def test_pertask_fill_extended_mode_matches_plain(cuda, E, B, mode):
    """K9's extended mode byte-equal to its plain version at 1, 3 and 8
    keys (whole slices and fractional non-MIG keys), on a fleet whose MIG
    nodes have no whole device, in the allocate lanes, the victim lanes
    (per-lane extended credit) and the legacy protocol."""
    args, kw = _mig_lanes(cuda, B=1 if mode == "legacy" else B, E=E,
                          mode=mode, seed=B)
    kernels.reset_launch_counts()
    out = A.pertask_fill(*args, **kw)
    c = kernels.launch_counts()
    assert (c["pertask_fill"], c["pertask_fill:extended"]) == (1, 1)
    assert c["pertask_fill:lanes"] == (mode == "lanes")
    want = A.attempt_gang_in_domain_plain(*args, **kw)
    assert_same(out.fields(), want.fields())
    assert out.ext_rows.shape == (args[2].shape[0], args[3].shape[1], E)
    if mode != "legacy" and B > 1:
        placed = out.nodes_t >= 0
        assert bool(placed.any())
        assert bool((out.extbind_rows.sum(-1) > 0).any() | out.pipe_t.any())


@pytest.mark.parametrize("B", [1, 256])
def test_dense_accept_extended_mode_matches_plain(cuda, B):
    """K10 with the extended pool's columns (E = 3, whole and fractional
    claims, some bind-now) byte-equal to its plain version, with and
    without the device table."""
    dargs = _dense_inputs(cuda, B=B, T=4, seed=B)
    rng = np.random.default_rng(B + 1)
    nodes_b = dargs[0].cpu().numpy()
    N, E = dargs[7].shape[0], 3
    ext = rng.choice(np.float32([0.0, 1.0, 4.0, 300.0]), (N, E))
    ext_floor = (-rng.choice(np.float32([0.0, 1.0]), (N, E))
                 - np.float32(1e-6)).astype(np.float32)
    claim = rng.choice(np.float32([0.0, 0.5, 1.0]), (B, 4, E))
    nb = np.clip(nodes_b, 0, None)
    rows = np.where((nodes_b >= 0)[..., None], ext[nb] - claim, 0.0)
    bind = np.where((nodes_b >= 0)[..., None] & (rng.random((B, 4, 1))
                                                 < 0.5), claim, 0.0)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(cuda)
    ekw = dict(ext_rows=t(rows), extbind_rows=t(bind), ext=t(ext),
               ext_floor=t(ext_floor))
    for track in (True, False):
        kernels.reset_launch_counts()
        out = A.dense_accept(*dargs, track_devices=track, **ekw)
        assert kernels.launch_counts()["dense_accept:extended"] == 1
        assert_same(out, A.dense_accept_plain(*dargs, track_devices=track,
                                              **ekw))
    assert out[5].shape == (N, E)


@pytest.mark.parametrize("compose", [True, False])
@pytest.mark.parametrize("case", ["random", "empty"])
def test_freed_by_lane_extended_table_matches_plain(cuda, case, compose):
    """K8's extended table byte-equal to its plain version on the MIG
    fleet's running slices: an empty lane assignment and a random one,
    composed and not."""
    from kai_scheduler_tpu_torch.ops import victims as V
    _, ses = _mig_session(cuda)
    st = ses.state
    chain = A._chain_membership(st.queues.parent, ses.config.num_levels)
    rng = np.random.default_rng(len(case) + compose)
    M, B = st.running.m, 64
    lane = np.where(rng.random(M) < 0.7, rng.integers(0, B, M), B)
    if case == "empty":
        lane[:] = B
    lane = torch.from_numpy(lane.astype(np.int32)).to(cuda)
    kernels.reset_launch_counts()
    got = V.freed_by_lane(st, lane, B, chain, compose=compose, extended=True)
    c = kernels.launch_counts()
    assert (c["freed_by_lane"], c["freed_by_lane:extended"]) == (1, 1)
    want = V.freed_by_lane_plain(_cpu_state(st), lane.cpu(), B, chain.cpu(),
                                 compose=compose, extended=True)
    assert_same(got, want)
    assert (float(got[4].sum()) > 0) == (case != "empty")


def test_extended_limits_raise(cuda):
    """Past ``PERTASK_MAX_E`` (and K8's ``FREED_BY_LANE_MAX_E``) extended
    keys, each wrapper raises ``NotImplementedError`` naming the limit."""
    from kai_scheduler_tpu_torch.ops import victims as V
    args, kw = _mig_lanes(cuda, B=4, E=A.PERTASK_MAX_E + 1, mode="allocate")
    with pytest.raises(NotImplementedError, match="PERTASK_MAX_E"):
        A.pertask_fill(*args, **kw)
    dargs = _dense_inputs(cuda, B=4, T=2)
    E = A.PERTASK_MAX_E + 1
    N = dargs[7].shape[0]
    z = torch.zeros((N, E), device=cuda)
    with pytest.raises(NotImplementedError, match="PERTASK_MAX_E"):
        A.dense_accept(*dargs, track_devices=True,
                       ext_rows=torch.zeros((4, 2, E), device=cuda),
                       extbind_rows=torch.zeros((4, 2, E), device=cuda),
                       ext=z, ext_floor=z)
    _, ses = _mig_session(cuda, num_nodes=40)
    st = ses.state
    r = st.running
    wide = dataclasses.replace(st, running=dataclasses.replace(
        r, extended=torch.zeros((r.m, V.FREED_BY_LANE_MAX_E + 1),
                                device=cuda)))
    lane = torch.zeros((r.m,), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="FREED_BY_LANE_MAX_E"):
        V.freed_by_lane(wide, lane, 4, A._chain_membership(
            st.queues.parent, 2), compose=True, extended=True)


@pytest.mark.parametrize("batch_size", [1, 64])
def test_cuda_mig_reclaim_cycle_equals_cpu_cycle(cuda, batch_size):
    """The mig_reclaim cell at 200 nodes through the five default actions
    on the card and on the CPU: packed commit, BindRequests, evictions and
    move rebinds equal; allocate went through K9 and K10's extended modes,
    the victim actions through K9's extended legacy mode and K7 (and, when
    chunked, K8's extended table and K9's extended lanes mode)."""
    from kai_scheduler_tpu_torch.framework.scheduler import SchedulerConfig
    from kai_scheduler_tpu_torch.framework.session import SessionConfig
    from kai_scheduler_tpu_torch.ops.victims import VictimConfig
    out, counts = {}, {}
    for device in ("cuda", "cpu"):
        cluster, _ = _mig_session(cuda, num_nodes=200, inference=48,
                                  pairs=8, training=4)
        kernels.reset_launch_counts()
        out[device] = Scheduler(SchedulerConfig(
            incremental=False, session=SessionConfig(victims=VictimConfig(
                batch_size=batch_size))), device=device).run_once(cluster)
        counts[device] = kernels.launch_counts()
    c = counts["cuda"]
    for k in ("pertask_fill:extended", "dense_accept:extended",
              "pertask_fill:legacy", "replace_victims"):
        assert c[k] > 0, (k, c)
    if batch_size > 1:
        assert c["freed_by_lane:extended"] > 0, c
        assert c["pertask_fill:lanes"] > 0, c
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.evictions
    assert gpu.packed.tobytes() == cpu.packed.tobytes()
    for field in ("bind_requests", "evictions", "move_bind_requests"):
        assert [dataclasses.astuple(b) for b in getattr(gpu, field)] == \
            [dataclasses.astuple(b) for b in getattr(cpu, field)], field


# ---------------------------------------------------------------------------
# K8 and K7 at their edges (state.kernel_edges, the inputs the CPU parity
# tests hold the plain versions to the reference on) and at full width
# ---------------------------------------------------------------------------

#: every K8 mode at every edge width, composed and not; and 4,096 lanes
#: with the device and extended tables both on (43 columns: one node a
#: block, its columns in slabs)
K8_EDGES = [(B, compose, mode) for B in KE.K8_LANES
            for compose in (True, False) for mode in KE.K8_MODES] + [
                (4096, True, "slab")]


@pytest.mark.parametrize("B,compose,mode", K8_EDGES)
def test_freed_by_lane_edges_match_plain(cuda, B, compose, mode):
    """K8 byte-equal to its plain version on ``kernel_edges.k8_case``:
    37 nodes with 32 devices and 8 extended keys, node 0's padding rows
    with one live row, empty nodes, a leaf queue with no live pod, pods of
    queue -1."""
    from kai_scheduler_tpu_torch.ops import victims as V
    from kai_scheduler_tpu_torch.state import state_from_numpy
    lv, lane = KE.k8_case(B)
    st = state_from_numpy(lv, cuda)
    chain = A._chain_membership(st.queues.parent, KE.NUM_LEVELS)
    kw = dict(compose=compose, devices=mode in ("devices", "slab"),
              extended=mode in ("extended", "slab"))
    lane_t = torch.from_numpy(lane).to(cuda)
    kernels.reset_launch_counts()
    got = V.freed_by_lane(st, lane_t, B, chain, **kw)
    c = kernels.launch_counts()
    assert (c["freed_by_lane"], c["freed_by_lane:devices"],
            c["freed_by_lane:extended"]) == (1, int(kw["devices"]),
                                             int(kw["extended"]))
    want = V.freed_by_lane_plain(_cpu_state(st), lane_t.cpu(), B,
                                 chain.cpu(), **kw)
    assert_same(got, want)


@pytest.mark.parametrize("case", KE.K7_CASES)
def test_replace_victims_edges_match_plain(cuda, case):
    """K7 byte-equal to its plain version on ``kernel_edges.k7_case``:
    ties, a victim that fits nowhere, more victims than ``max_pods``,
    fractional, memory-based and whole-device victims, extended keys, a
    mix; 37 nodes (no multiple of the cluster's slice)."""
    from kai_scheduler_tpu_torch.ops import victims as V
    from kai_scheduler_tpu_torch.state import state_from_numpy
    lv, mask, *pools, max_pods = KE.k7_case(case)
    st = state_from_numpy(lv, cuda)
    args = (torch.from_numpy(mask).to(cuda),
            *(torch.from_numpy(p).to(cuda) for p in pools), max_pods)
    kernels.reset_launch_counts()
    got = V.replace_victims(st, *args)
    assert kernels.launch_counts()["replace_victims"] == 1
    want = V.replace_victims_plain(_cpu_state(st), *(
        a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    assert_same(got, want)


def test_victim_kernels_full_width_match_plain(cuda):
    """K8's device mode at 10,000 nodes x 8 devices and 256 lanes (composed
    and not), its extended mode on the MIG fleet at 10,000 nodes (E 3) and
    64 lanes, and K7 at 10,000 nodes x 8 devices with 12 victims, each
    byte-equal to its plain version."""
    from kai_scheduler_tpu_torch.ops import victims as V
    st, ses = _device_state(cuda, 8, seed=5, num_nodes=10_000,
                            node_accel=8.0, num_gangs=12_000)
    cst = _cpu_state(st)
    rng = np.random.default_rng(13)
    M = st.running.m
    chain = A._chain_membership(st.queues.parent, ses.config.num_levels)
    lane = np.where(rng.random(M) < 0.05, rng.integers(0, 256, M), 256)
    lane = torch.from_numpy(lane.astype(np.int32)).to(cuda)
    for compose in (True, False):
        got = V.freed_by_lane(st, lane, 256, chain, compose=compose,
                              devices=True)
        assert_same(got, V.freed_by_lane_plain(
            cst, lane.cpu(), 256, chain.cpu(), compose=compose,
            devices=True))
    n = st.nodes
    mask = torch.zeros((M,), dtype=torch.bool)
    mask[torch.from_numpy(rng.choice(M, 12, replace=False))] = True
    args = (mask.to(cuda), n.free, n.device_free, n.releasing,
            n.device_releasing, n.extended_free, n.extended_releasing, 512)
    got = V.replace_victims(st, *args)
    assert_same(got, V.replace_victims_plain(cst, *(
        a.cpu() if isinstance(a, torch.Tensor) else a for a in args)))
    assert bool(got[4]) and int((got[3] >= 0).sum()) == 12
    _, ses = _mig_session(cuda, num_nodes=10_000)
    st = ses.state
    M = st.running.m
    chain = A._chain_membership(st.queues.parent, ses.config.num_levels)
    lane = np.where(rng.random(M) < 0.02, rng.integers(0, 64, M), 64)
    lane = torch.from_numpy(lane.astype(np.int32)).to(cuda)
    got = V.freed_by_lane(st, lane, 64, chain, compose=True, extended=True)
    assert got[4].shape == (64, 10_000, 3)
    assert_same(got, V.freed_by_lane_plain(
        _cpu_state(st), lane.cpu(), 64, chain.cpu(), compose=True,
        extended=True))


# ---------------------------------------------------------------------------
# K5 and K12 at their edges (state.kernel_edges, the inputs the CPU parity
# tests hold the plain versions to the reference on)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(KE.K5_CASES))
def test_cumsum_ds_edges_match_plain(cuda, case):
    """K5 byte-equal to its plain version on ``kernel_edges.k5_case``:
    around its 256-row tile and its 256-tile chunk of roots, 216,001 rows,
    column counts that are no multiple of its 8-column group, a
    ``[U, Q, R]`` table, +0.0 and -0.0; one launch a call."""
    from kai_scheduler_tpu_torch.utils.numerics import (cumsum_ds,
                                                        cumsum_ds_plain)
    x = torch.from_numpy(KE.k5_case(case))
    kernels.reset_launch_counts()
    got = cumsum_ds(x.to(cuda))
    assert kernels.launch_counts()["cumsum_ds"] == 1
    assert_same(got.view(torch.int32), cumsum_ds_plain(x).view(torch.int32))


@pytest.mark.parametrize("case", list(KE.K12_CASES))
def test_affinity_mask_edges_match_plain(cuda, case):
    """K12 byte-equal to its plain version on ``kernel_edges.k12_case``:
    37 nodes (byte loads), 48 and 100 (16- and 4-node vectors), lanes on
    both sides of its 4/16-node switch, gangs with no used slot and with
    every slot used, -1 slots in the middle of a list, junk lanes, rows at
    each level and at the per-node level, nodes lacking a label, invalid
    nodes, ``attract`` on and off."""
    st, used, dom, cand, attract = KE.k12_inputs(case, cuda)
    kernels.reset_launch_counts()
    got = A.affinity_mask(st, used, dom, cand, attract=attract)
    assert kernels.launch_counts()["affinity_mask"] == 1
    cst, *rest = KE.k12_inputs(case)
    assert_same(got, A.affinity_mask_plain(cst, *rest[:3], attract=attract))
