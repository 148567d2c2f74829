"""The port's per-task allocate path (GPU sharing: fractional and
memory-based shares, heterogeneous gangs, subgroups, nominated nodes,
anti-self domains, the preferred-level band, spread and gpuspread) against
the JAX reference, on the CPU, where the kernels run their plain versions:

- K9's plain version, ``attempt_gang_in_domain_plain``, against the
  reference's ``_attempt_gang_in_domain`` jitted and vmapped over lanes
  as the allocate chunk runs it, bit for bit on every output (the pools
  compared as the dense rows the reference returns);
- K10's plain version, ``dense_accept_plain``, against the reference
  chunk's dense accept and commit (``allocate.py:1728-1795``, transcribed
  into a jitted JAX function over the reference lanes' dense outputs);
- whole allocate cycles on random GPU-sharing clusters at B in {1, 8, 64,
  256} through both Schedulers: the packed i16 commit byte for byte and
  the BindRequests (devices included);
- two cycles with a tick between them: BindRequests and the binder's
  device indices.

Inputs are made from a seed with numpy; both packages build them with
their own API objects."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.state.cluster_state as ref_cs
from kai_scheduler_tpu.apis import types as ref_apis
from kai_scheduler_tpu.framework.scheduler import Scheduler as RefScheduler
from kai_scheduler_tpu.framework.scheduler import \
    SchedulerConfig as RefSchedulerConfig
from kai_scheduler_tpu.framework.session import Session as RefSession
from kai_scheduler_tpu.framework.session import \
    SessionConfig as RefSessionConfig
from kai_scheduler_tpu.ops import allocate as RA
from kai_scheduler_tpu.ops.scoring import \
    PlacementConfig as RefPlacementConfig
from kai_scheduler_tpu.runtime.cluster import Cluster as RefCluster
from kai_scheduler_tpu_torch.apis import types as port_apis
from kai_scheduler_tpu_torch.framework.scheduler import (Scheduler,
                                                         SchedulerConfig)
from kai_scheduler_tpu_torch.framework.session import SessionConfig
from kai_scheduler_tpu_torch.ops import allocate as A
from kai_scheduler_tpu_torch.ops.scoring import PlacementConfig
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from kai_scheduler_tpu_torch.state import state_from_numpy
from test_torch_allocate import ref_leaves
from test_torch_cycle import cluster_state, pad32  # noqa: F401

from jax_executables import release_jax_executables  # noqa: F401


def sharing_objects(apis, seed: int, *, num_nodes: int = 20,
                    num_gangs: int = 48, topology: bool = False,
                    subgroups: bool = True, wide: int = 0):
    """A random GPU-sharing cluster: nodes of 4 or 8 devices with 40 or 80
    GiB each (a ``zone`` level when ``topology``); two departments of two
    leaf queues (one non-preemptible gang in five checks the quota gate);
    running fractional pods on device 0 of a third of the nodes, every
    third of them terminating (releasing share: pipelined fractions), and
    a terminating whole-device pod on every fifth node; pending gangs of
    whole-device pods, one-pod fractions (0.25, 0.5, 0.7), one-pod
    memory-based shares (10 or 24 GiB), several fractions, a launcher with
    one-device workers, elastic whole-device gangs and — when
    ``subgroups`` — a gang of two subgroups; with ``wide``, two more gangs
    of ``wide`` pods (whole devices, 24 GiB memory-based shares)."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(num_nodes):
        labels = {"kubernetes.io/hostname": f"node-{i}"}
        if topology:
            labels["zone"] = f"zone-{i % 3}"
        nodes.append(apis.Node(
            f"node-{i}", apis.ResourceVec(float(rng.choice([4, 8])), 64.0,
                                          256.0),
            labels=labels, accel_memory_gib=float(rng.choice([40, 80]))))
    quota = num_nodes * 6.0 / 4
    queues = [apis.Queue(f"dept-{d}",
                         accel=apis.QueueResource(quota=2 * quota))
              for d in range(2)]
    leaves = [f"queue-{d}-{j}" for d in range(2) for j in range(2)]
    queues += [apis.Queue(q, parent=f"dept-{k // 2}",
                          accel=apis.QueueResource(quota=quota))
               for k, q in enumerate(leaves)]
    groups, pods = [], []

    def gang(name, queue, specs, *, min_member=None, prio=0, created=0.0,
             running_on=None, status=None, sub_groups=(), **kw):
        groups.append(apis.PodGroup(
            name, queue=queue, min_member=min_member or len(specs),
            priority=prio, creation_timestamp=created,
            last_start_timestamp=0.0 if running_on else None,
            sub_groups=list(sub_groups), **kw))
        for t, spec in enumerate(specs):
            pod = apis.Pod(f"{name}-{t}", name, creation_timestamp=created,
                           **spec)
            if running_on:
                pod.status = status
                pod.node = running_on
            pods.append(pod)

    for i in range(0, num_nodes, 3):
        status = (apis.PodStatus.RELEASING if i % 9 == 0
                  else apis.PodStatus.RUNNING)
        gang(f"share-{i}", leaves[i % 4], [dict(
            resources=apis.ResourceVec(0.0, 1.0, 4.0), accel_portion=0.5,
            accel_devices=[0])], running_on=f"node-{i}", status=status)
    for i in range(1, num_nodes, 5):
        gang(f"old-{i}", leaves[i % 4], [dict(
            resources=apis.ResourceVec(1.0, 2.0, 8.0), accel_devices=[1])],
            running_on=f"node-{i}", status=apis.PodStatus.RELEASING)

    def frac(p):
        return dict(resources=apis.ResourceVec(0.0, 1.0, 4.0),
                    accel_portion=p)

    def whole(k=1.0):
        return dict(resources=apis.ResourceVec(k, 2.0, 8.0))

    for g in range(num_gangs):
        kind = int(rng.integers(0, 8))
        kw = dict(prio=int(rng.integers(0, 3)), created=float(g))
        if g % 5 == 4:
            kw["preemptibility"] = apis.Preemptibility.NON_PREEMPTIBLE
        q = leaves[g % 4]
        name = f"gang-{g}"
        if kind == 0:
            gang(name, q, [whole()] * int(rng.integers(1, 6)), **kw)
        elif kind == 1:
            gang(name, q, [frac(float(rng.choice([0.25, 0.5, 0.7])))], **kw)
        elif kind == 2:
            gang(name, q, [dict(resources=apis.ResourceVec(0.0, 1.0, 4.0),
                                accel_memory_gib=float(rng.choice([10, 24])))],
                 **kw)
        elif kind == 3:
            gang(name, q, [frac(0.5)] * int(rng.integers(2, 4)), **kw)
        elif kind == 4:
            gang(name, q, [dict(resources=apis.ResourceVec(0.0, 4.0, 16.0))]
                 + [whole()] * int(rng.integers(2, 5)), **kw)
        elif kind == 5:
            gang(name, q, [whole(2.0)] * 4, min_member=2, **kw)
        elif kind == 6 and subgroups:
            gang(name, q, [dict(whole(), subgroup="a")] * 2
                 + [dict(frac(0.5), subgroup="b")] * 2,
                 sub_groups=(apis.SubGroup("a", min_member=2),
                             apis.SubGroup("b", min_member=1)),
                 min_member=3, **kw)
        else:
            gang(name, q, [frac(0.25), whole()], **kw)
    if wide:
        gang("wide-whole", leaves[0], [whole()] * wide)
        gang("wide-memory", leaves[1], [dict(
            resources=apis.ResourceVec(0.0, 1.0, 4.0),
            accel_memory_gib=24.0)] * wide)
    topo = (apis.Topology("default", levels=["zone",
                                             "kubernetes.io/hostname"])
            if topology else None)
    return nodes, queues, groups, pods, topo


# ---------------------------------------------------------------------------
# K9: one attempt per lane
# ---------------------------------------------------------------------------

PLACEMENTS = {
    "binpack_gpupack": dict(),
    "spread_gpuspread": dict(binpack_accel=False, binpack_cpu=False,
                             device_pack=False),
    "binpack_gpuspread": dict(device_pack=False),
    "no_device_table": dict(),
}


@dataclasses.dataclass
class Lanes:
    """One chunk's lane inputs on both sides."""

    ref_state: object
    port_state: object
    config: object
    num_levels: int
    cand: np.ndarray
    prior: np.ndarray
    quota: np.ndarray
    pools: dict
    placement: str


def make_lanes(seed: int, B: int, placement: str) -> Lanes:
    """A snapshot with a zone level and two 20-pod gangs, then: anti-self
    at the node level on
    some gangs and at the zone level on others, a nominated node and a
    preferred zone on others; random partial pools (used share on devices,
    spent CPU), victim-freed capacity on some nodes (``extra``), queue
    allocations near their quotas; B lanes of random gangs, a third of
    them with prior placements on random nodes."""
    rng = np.random.default_rng(seed)
    state, index = ref_cs.build_snapshot(
        *sharing_objects(ref_apis, seed, topology=True, wide=20), pad=32)
    ses = RefSession.from_state(state, index, RefSessionConfig())
    st = ses.state
    g, n = st.gangs, st.nodes
    G, T = g.task_valid.shape
    N, D = n.device_free.shape
    L = n.topology.shape[1]
    ng = len(index.gang_names)
    asl = np.asarray(g.anti_self_level).copy()
    nom = np.asarray(g.task_nominated).copy()
    pref = np.asarray(g.preferred_level).copy()
    nn = len(index.node_names)
    cfg = dataclasses.replace(
        ses.config.allocate, subgroup_topology=False,
        track_devices=placement != "no_device_table",
        placement=RefPlacementConfig(**PLACEMENTS[placement]))
    free = np.asarray(n.free).copy()
    dev = np.asarray(n.device_free).copy()
    used = rng.choice(np.array([0.0, 0.25, 0.5, 0.3, 1.0], np.float32),
                      size=dev.shape, p=[0.2, 0.15, 0.15, 0.1, 0.4])
    dev = np.where(dev > 0, np.maximum(dev - used, 0.0), dev)
    # victim-freed capacity: a fifth of the nodes hold nothing idle but
    # two releasing devices (placements there pipeline)
    extra = np.zeros_like(free)
    extra_dev = np.zeros_like(dev)
    freed = np.nonzero(rng.random(nn) < 0.2)[0]
    dev[freed] = 0.0
    extra_dev[freed, 2:4] = 1.0
    extra[freed, 0] = 2.0
    free[:, 0] = np.minimum(free[:, 0], dev.sum(-1))
    free[:nn, 1] = np.maximum(
        free[:nn, 1] - rng.integers(0, 8, nn).astype(np.float32), 0.0)
    for gi in range(ng):
        r = gi % 6
        if r == 1:
            asl[gi] = L                      # one task per node
        elif r == 2:
            asl[gi] = 0                      # one task per zone
        elif r == 3:
            nom[gi, 0] = int(rng.choice(freed))  # pipelines there
        elif r == 4:
            pref[gi] = 0
    st = st.replace(gangs=g.replace(anti_self_level=jnp.asarray(asl),
                                    task_nominated=jnp.asarray(nom),
                                    preferred_level=jnp.asarray(pref)))
    qa = np.asarray(st.queues.allocated).copy()
    quota = np.asarray(st.queues.quota)
    qa = np.where(quota > 0, quota * rng.uniform(0.5, 1.0, qa.shape),
                  qa).astype(np.float32)
    cand = rng.integers(0, ng, B).astype(np.int32)
    # two lanes on the 20-pod gangs: task steps past one cumsum block
    cand[:2] = [index.gang_names.index(n)
                for n in ("wide-whole", "wide-memory")]
    prior = np.full((B, T), -1, np.int32)
    for b in range(0, B, 3):
        k = int(rng.integers(1, 3))
        valid_t = np.nonzero(np.asarray(g.task_valid[cand[b]]))[0]
        for t in valid_t[:k][:-1] if len(valid_t) > 1 else []:
            prior[b, t] = int(rng.integers(0, nn))
    quota_b = np.maximum(np.asarray(g.min_needed)[cand]
                         - (prior >= 0).sum(-1), 1).astype(np.int32)
    pools = dict(free=free, dev=dev.astype(np.float32), extra=extra,
                 extra_dev=extra_dev, qa=qa,
                 qan=np.asarray(st.queues.allocated_nonpreemptible))
    return Lanes(st, state_from_numpy(ref_leaves(st), "cpu"), cfg,
                 ses.config.num_levels, cand, prior, quota_b, pools,
                 placement)


def ref_attempts(ln: Lanes):
    """The reference's per-task attempt for every lane — the arguments
    the allocate chunk passes (``:1571``), vmapped over lanes and jitted."""
    st, cfg = ln.ref_state, ln.config
    p = {k: jnp.asarray(v) for k, v in ln.pools.items()}
    chain = RA._chain_membership(st.queues.parent, ln.num_levels)

    def one(gi, lane, prior, quota):
        pl = st.gangs.preferred_level[gi]
        return RA._attempt_gang_in_domain(
            st, gi, p["free"], p["dev"], p["qa"], p["qan"], ln.num_levels,
            cfg, st.nodes.valid, st.nodes.topology[:, jnp.maximum(pl, 0)],
            pl >= 0, p["extra"], p["extra_dev"], lane, chain,
            prior_nodes=prior, quota=quota)
    B = ln.cand.shape[0]
    out = jax.jit(jax.vmap(one))(ln.cand, jnp.arange(B, dtype=jnp.int32),
                                 ln.prior, ln.quota)
    return [np.asarray(o) for o in out]


def port_attempts(ln: Lanes) -> A.PerTaskOut:
    st = ln.port_state
    q = st.queues
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in ln.pools.items()}
    inf = float("inf")
    return A.attempt_gang_in_domain_plain(
        st.nodes, A.TaskTables.of(st), torch.from_numpy(ln.cand),
        torch.from_numpy(ln.prior), t["free"], t["dev"], t["qa"], t["qan"],
        t["extra"], t["extra_dev"],
        A._chain_membership(q.parent, ln.num_levels),
        torch.where(q.limit <= -0.5, inf, q.limit),
        torch.where(q.quota <= -0.5, inf, q.quota),
        placement=PlacementConfig(**PLACEMENTS[ln.placement]),
        track_devices=ln.config.track_devices)


def dense(pool: np.ndarray, out: A.PerTaskOut, rows: torch.Tensor):
    return A._dense_rows(torch.from_numpy(pool), out.nodes_t, rows).numpy()


def assert_bits(a: np.ndarray, b: np.ndarray, what: str):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), (
        what, np.argwhere(a != b)[:5].tolist())


@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
@pytest.mark.parametrize("seed", [0, 1])
def test_pertask_fill_bit_equal(seed, placement):
    ln = make_lanes(seed, 37, placement)
    want = ref_attempts(ln)
    got = port_attempts(ln)
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
    if ln.config.track_devices:
        assert_bits(dev2, dense(p["dev"], got, got.dev_rows), "dev2")
        assert_bits(devbind, dense(np.zeros_like(p["dev"]), got,
                                   got.devbind_rows), "devbind")
    # rows of unplaced slots are zero; the inputs exercise every branch
    none = (got.nodes_t < 0)[..., None]
    assert bool((got.free_rows.masked_select(none) == 0).all())
    placed = got.nodes_t >= 0
    assert int(placed.sum()) > 10
    assert bool(got.pipe_t.any()) and bool((placed & ~got.pipe_t).any())
    assert bool(~got.success.all()) and bool(got.success.any())
    if ln.config.track_devices:
        assert bool((got.dev_t >= 0).any())


# ---------------------------------------------------------------------------
# K10: the dense accept and commit
# ---------------------------------------------------------------------------

def ref_dense_accept(free, dev, qa, qan, rel_floor, dev_floor, outs, ok,
                     limit_eff, quota_eff, track):
    """The reference chunk's dense branch (``allocate.py:1719-1795``) as a
    jitted JAX function over the lanes' dense outputs."""
    free2_b, dev2_b, qa2_b, qan2_b, bind_b, devbind_b = outs
    EPS = RA.EPS
    okm = ok[:, None, None]
    d_qa = jnp.where(okm, qa2_b - qa, 0.0)
    d_qan = jnp.where(okm, qan2_b - qan, 0.0)
    cum_qa = jnp.cumsum(d_qa, axis=0)
    cum_qan = jnp.cumsum(d_qan, axis=0)
    d_free = jnp.where(okm, free - free2_b, 0.0)
    d_bind = jnp.where(okm, bind_b, 0.0)
    cum_free = jnp.cumsum(d_free, axis=0)
    cum_bind = jnp.cumsum(d_bind, axis=0)
    ok_node = jnp.all(free[None] - cum_free >= rel_floor[None], axis=(1, 2))
    ok_bind = jnp.all(cum_bind <= jnp.maximum(free[None], 0.0) + EPS,
                      axis=(1, 2))
    ok_qa = jnp.all((qa[None] + cum_qa <= limit_eff[None] + EPS)
                    | (cum_qa <= EPS), axis=(1, 2))
    ok_qan = jnp.all((qan[None] + cum_qan <= quota_eff[None] + EPS)
                     | (cum_qan <= EPS), axis=(1, 2))
    accept = ok_node & ok_bind & ok_qa & ok_qan
    if track:
        d_dev = jnp.where(okm, dev - dev2_b, 0.0)
        d_devbind = jnp.where(okm, devbind_b, 0.0)
        cum_dev = jnp.cumsum(d_dev, axis=0)
        cum_devbind = jnp.cumsum(d_devbind, axis=0)
        accept = accept & jnp.all(dev[None] - cum_dev >= dev_floor[None],
                                  axis=(1, 2))
        accept = accept & jnp.all(
            cum_devbind <= jnp.maximum(dev[None], 0.0) + EPS, axis=(1, 2))
    take = ok & accept
    w = take.astype(free.dtype)
    free = free - jnp.einsum("b,bnr->nr", w, d_free)
    qa = qa + jnp.einsum("b,bqr->qr", w, d_qa)
    qan = qan + jnp.einsum("b,bqr->qr", w, d_qan)
    if track:
        dev = dev - jnp.einsum("b,bnd->nd", w, d_dev)
    return take, free, dev, qa, qan, ok_qa & ok_qan


@pytest.mark.parametrize("B", [8, 32, 64, 256])
@pytest.mark.parametrize("placement", ["binpack_gpupack",
                                       "no_device_table"])
def test_dense_accept_bit_equal(B, placement):
    """The lanes of one chunk: K9's plain outputs through K10's plain
    version against the reference's dense accept on the reference lanes'
    outputs.  At up to 32 lanes XLA:CPU adds the commit's ``einsum`` over
    lanes in ascending order, as the port does; whole cycles at 64 and 256
    lanes run in ``test_allocate_cycle_bit_equal``."""
    ln = make_lanes(2, B, placement)
    want = ref_attempts(ln)
    got = port_attempts(ln)
    st = ln.ref_state
    n, q = st.nodes, st.queues
    p = {k: jnp.asarray(v) for k, v in ln.pools.items()}
    rel_floor = -(n.releasing + p["extra"]) - RA.EPS
    dev_floor = -(n.device_releasing + p["extra_dev"]) - RA.EPS
    limit_eff = jnp.where(q.limit <= -0.5, jnp.inf, q.limit)
    quota_eff = jnp.where(q.quota <= -0.5, jnp.inf, q.quota)
    valid = np.random.default_rng(B).random(B) < 0.9
    ok = want[7] & valid
    track = ln.config.track_devices
    ref = jax.jit(ref_dense_accept, static_argnames="track")(
        p["free"], p["dev"], p["qa"], p["qan"], rel_floor, dev_floor,
        (want[0], want[1], want[2], want[3], want[8], want[9]),
        jnp.asarray(ok), limit_eff, quota_eff, track=track)
    ref = [np.asarray(x) for x in ref]
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in ln.pools.items()}
    pq = ln.port_state.queues
    okt = got.success & torch.from_numpy(valid)
    okm = okt[:, None, None]
    d_qa = torch.where(okm, got.qa2 - t["qa"], 0.0)
    d_qan = torch.where(okm, got.qan2 - t["qan"], 0.0)
    from kai_scheduler_tpu_torch.utils.numerics import cumsum_blocked
    cum_qa, cum_qan = cumsum_blocked(d_qa, 0), cumsum_blocked(d_qan, 0)
    inf = float("inf")
    lim = torch.where(pq.limit <= -0.5, inf, pq.limit)
    quo = torch.where(pq.quota <= -0.5, inf, pq.quota)
    gate = (((t["qa"] + cum_qa <= lim + A.EPS) | (cum_qa <= A.EPS))
            .flatten(1).all(1)
            & ((t["qan"] + cum_qan <= quo + A.EPS) | (cum_qan <= A.EPS))
            .flatten(1).all(1))
    assert_bits(ref[5], gate.numpy(), "queue gates")
    pn = ln.port_state.nodes
    take, free, dev, qa, qan = A.dense_accept_plain(
        got.nodes_t, okt, gate, got.free_rows, got.dev_rows, got.bind_rows,
        got.devbind_rows, t["free"], t["dev"],
        -(pn.releasing + t["extra"]) - A.EPS,
        -(pn.device_releasing + t["extra_dev"]) - A.EPS, d_qa, d_qan,
        t["qa"], t["qan"], track_devices=track)
    for what, a, b in (("take", ref[0], take), ("free", ref[1], free),
                       ("dev", ref[2], dev), ("qa", ref[3], qa),
                       ("qan", ref[4], qan)):
        assert_bits(a, b.numpy(), what)
    assert bool(take.any())


# ---------------------------------------------------------------------------
# whole cycles
# ---------------------------------------------------------------------------

CYCLES = {
    "mixed": dict(seed=3),
    "zones": dict(seed=4, topology=True),
    "spread": dict(seed=5, placement=dict(binpack_accel=False,
                                          binpack_cpu=False,
                                          device_pack=False)),
}


def _schedulers(batch_size: int, placement: dict):
    ref = RefScheduler(RefSchedulerConfig(
        actions=("allocate",), incremental=False, analytics_every=0,
        repack_enable=False, session=RefSessionConfig(
            allocate=dataclasses.replace(
                RA.AllocateConfig(), batch_size=batch_size,
                placement=RefPlacementConfig(**placement)))))
    port = Scheduler(SchedulerConfig(
        actions=("allocate",), session=SessionConfig(
            allocate=dataclasses.replace(
                A.AllocateConfig(), batch_size=batch_size,
                placement=PlacementConfig(**placement)))), device="cpu")
    return ref, port


def _clusters(name: str, num_gangs: int):
    """Twin clusters, more demand than idle capacity: the last gangs to
    fit pipeline onto releasing devices."""
    kw = {k: v for k, v in CYCLES[name].items() if k != "placement"}
    seed = kw.pop("seed")
    return tuple(cls.from_objects(*sharing_objects(
        apis, seed, num_nodes=12, num_gangs=num_gangs, **kw))
        for apis, cls in ((ref_apis, RefCluster), (port_apis, Cluster)))


#: (cluster, lanes, pending gangs): the gang count keeps every lane
#: width real (B = min(batch_size, padded gangs)).  Spread runs at 1 and 8
#: lanes only: at 64 and 256 its cluster leaves one lane that succeeds
#: every chunk and is never accepted (a fraction bound-now on a device
#: whose node's idle accel another fraction's pipelined placement
#: overdrew), so both packages spin to the fuel bound, ~650 chunks
#: (ROADMAP §C); those cycles are equal too, at two minutes each.
CYCLE_CASES = [("mixed", 1, 40), ("mixed", 8, 40), ("mixed", 64, 70),
               ("mixed", 256, 260), ("zones", 8, 40), ("zones", 64, 70),
               ("spread", 1, 40), ("spread", 8, 40)]


@pytest.mark.parametrize("name,B,gangs", CYCLE_CASES)
def test_allocate_cycle_bit_equal(name, B, gangs, pad32):
    """One allocate cycle through both Schedulers: the packed commit
    (placements, device indices, pipelined bits, queue tables) byte for
    byte and the BindRequests field for field."""
    ref_cluster, cluster = _clusters(name, gangs)
    ref_sched, sched = _schedulers(B, CYCLES[name].get("placement", {}))
    want = ref_sched.run_once(ref_cluster)
    got = sched.run_once(cluster)
    assert got.packed.tobytes() == pad32["packed"].tobytes()
    assert [dataclasses.asdict(b) for b in got.bind_requests] == \
        [dataclasses.asdict(b) for b in want.bind_requests]
    assert any(b.selected_accel_groups for b in got.bind_requests)
    assert got.tensors.pipelined.any()
    assert min(B, got.tensors.allocated.shape[0]) == B


def test_two_cycles_with_tick(pad32):
    """Two allocate cycles with a tick between them: the binder applies
    each BindRequest with its device indices, the second snapshot sees
    the shared devices of the first cycle's binds."""
    ref_cluster, cluster = _clusters("mixed", num_gangs=70)
    ref_sched, sched = _schedulers(64, {})
    for cycle in range(2):
        want = ref_sched.run_once(ref_cluster)
        got = sched.run_once(cluster)
        assert got.packed.tobytes() == pad32["packed"].tobytes(), cycle
        assert [dataclasses.asdict(b) for b in got.bind_requests] == \
            [dataclasses.asdict(b) for b in want.bind_requests], cycle
        for c, res in ((ref_cluster, want), (cluster, got)):
            for br in res.bind_requests:
                c.bind_pod(br.pod_name, br.selected_node,
                           br.selected_accel_groups or None)
            c.tick()
        assert cluster_state(cluster) == cluster_state(ref_cluster), cycle
    devs = [p.accel_devices for p in cluster.pods.values()
            if p.accel_portion > 0 or p.accel_memory_gib > 0]
    assert any(devs)
