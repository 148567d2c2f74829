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
    agg = A.pertask_agg_scratch(args[2].shape[0], kw["topo"], args[4])
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
