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
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from kai_scheduler_tpu_torch.state import make_cluster

pytestmark = pytest.mark.cuda

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
    assert all(v > 0 for v in kernels.launch_counts().values())
    cpu = Scheduler(device="cpu").run_once(
        Cluster.from_objects(*objects(shape, make_cluster, apis)))
    assert gpu.packed.tobytes() == cpu.packed.tobytes()
    assert [dataclasses.astuple(b) for b in gpu.bind_requests] == \
        [dataclasses.astuple(b) for b in cpu.bind_requests]
