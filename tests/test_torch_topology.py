"""The port's topology-aware allocate (required, subgroup and preferred
levels, on the uniform and the per-task path) against the JAX reference,
on the CPU, where the kernels run their plain versions.  Every comparison
is bit for bit (tolerance 0):

- K11's plain build and update (``topo_tables_build_plain``,
  ``topo_tables_update_plain``) against the reference's
  ``topo_tables_build`` / ``topo_tables_update`` closures as ``allocate``
  runs them: the reference's chunk loop is stepped eagerly and its carried
  tables read after every chunk, the port's read at the same points;
- K3's plain version in its topology (required-level pick and
  confinement) and preferred modes, with the dense protocol's rows,
  against ``_attempt_gang_in_domain_uniform`` with the hoisted tables;
- K9's plain version in its subgroup-topology mode, with and without
  banned domains, and the retry's active-lane merge, against
  ``_attempt_gang_in_domain`` and the reference's in-cycle retry;
- whole allocate cycles through both Schedulers: the inputs of
  ``tests/test_topology_retry.py`` and of ``tests/test_topology.py``'s
  required and preferred levels, ``make_cluster`` topology cycles at 64
  and 256 lanes, and the chip cell's mixed and multi-subgroup gangs;
- the victim actions refuse a topology snapshot, naming the flag; the
  port's auto-tune derives the reference's flags on every catalog case.

Inputs are made from a seed with numpy; both packages build them with
their own API objects."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.framework.session as ref_session
import kai_scheduler_tpu.state.cluster_state as ref_cs
import kai_scheduler_tpu_torch.framework.session as port_session
import kai_scheduler_tpu_torch.state.cluster_state as port_cs
from kai_scheduler_tpu.apis import types as ref_apis
from kai_scheduler_tpu.framework.scheduler import Scheduler as RefScheduler
from kai_scheduler_tpu.framework.scheduler import \
    SchedulerConfig as RefSchedulerConfig
from kai_scheduler_tpu.framework.session import Session as RefSession
from kai_scheduler_tpu.framework.session import \
    SessionConfig as RefSessionConfig
from kai_scheduler_tpu.ops import allocate as RA
from kai_scheduler_tpu.ops import drf as ref_drf
from kai_scheduler_tpu.runtime.cluster import Cluster as RefCluster
from kai_scheduler_tpu.state import make_cluster as ref_make
from kai_scheduler_tpu_torch.apis import types as port_apis
from kai_scheduler_tpu_torch.framework.scheduler import (DEFAULT_ACTIONS,
                                                         Scheduler,
                                                         SchedulerConfig)
from kai_scheduler_tpu_torch.framework.session import SessionConfig
from kai_scheduler_tpu_torch.ops import allocate as A
from kai_scheduler_tpu_torch.ops import drf as port_drf
from kai_scheduler_tpu_torch.ops.scoring import PlacementConfig
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from kai_scheduler_tpu_torch.state import fleets
from kai_scheduler_tpu_torch.state import make_cluster as port_make
from kai_scheduler_tpu_torch.state import state_from_numpy
from scenarios.harness import _build
from test_torch_allocate import ref_leaves
from test_torch_cycle import pad32  # noqa: F401
from test_torch_pertask import (PLACEMENTS, assert_bits, make_lanes,
                                port_attempts)
from test_torch_scenarios import CASES, to_port

from jax_executables import release_jax_executables  # noqa: F401


def t_(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# K11: the domain tables, through the reference's own chunk loop
# ---------------------------------------------------------------------------

def _eager_lax(seen: list):
    """``jax.lax`` with a ``while_loop`` that runs eagerly and records the
    carry before the first chunk and after every chunk."""
    def while_loop(cond, body, carry):
        seen.append(carry)
        while bool(cond(carry)):
            carry = body(carry)
            seen.append(carry)
        return carry
    ns = {k: getattr(jax.lax, k) for k in dir(jax.lax)
          if not k.startswith("__")}
    ns["while_loop"] = while_loop
    return types.SimpleNamespace(**ns)


def _topo_cluster(num_gangs=40, **kw):
    """64 nodes in 2 blocks x 4 racks, some running gangs (partly used
    racks), rack-required gangs of 3 replicas."""
    shape = dict(num_nodes=64, node_accel=4.0, num_gangs=num_gangs,
                 tasks_per_gang=3, topology_levels=(2, 4),
                 required_level="topo/level1", running_fraction=0.2, seed=1)
    shape.update(kw)
    return shape


def test_topo_tables_build_and_update_match_the_reference_loop(monkeypatch):
    """A build and every chunk's update (well over two) of the uniform
    path's domain tables: the port's per-type replica counts, domain caps
    and domain aggregates equal the reference's carried tables after each
    chunk of the same cycle."""
    ref_state, ref_index = ref_cs.build_snapshot(
        *ref_make(**_topo_cluster()), pad=32)
    ses = RefSession.from_state(ref_state, ref_index, RefSessionConfig())
    cfg = dataclasses.replace(ses.config.allocate, batch_size=8)
    assert cfg.uniform_tasks and cfg.subgroup_topology
    seen = []
    monkeypatch.setattr(RA, "lax", _eager_lax(seen))
    with jax.disable_jit():
        RA.allocate(ses.state, ses.state.queues.fair_share,
                    num_levels=ses.config.num_levels, config=cfg)
    want = [tuple(np.asarray(x) for x in c[5:8]) for c in seen]

    got = []
    build, update = A.topo_tables_build, A.topo_tables_update

    def rec_build(*a, **k):
        out = build(*a, **k)
        got.append(out)
        return out

    def rec_update(*a, **k):
        out = update(*a, **k)
        got.append(out)
        return out
    monkeypatch.setattr(A, "topo_tables_build", rec_build)
    monkeypatch.setattr(A, "topo_tables_update", rec_update)
    port = state_from_numpy(ref_leaves(ses.state), "cpu")
    A.allocate(port, port.queues.fair_share,
               num_levels=ses.config.num_levels,
               config=A.AllocateConfig(**{
                   f.name: getattr(cfg, f.name)
                   for f in dataclasses.fields(cfg)
                   if f.name != "placement"}))
    assert len(got) == len(want) >= 4
    for i, (w, g) in enumerate(zip(want, got)):
        for what, a, b in zip(("dom_caps_y", "agg", "c_y"), w, g):
            assert_bits(a, b.numpy(), f"{what} after chunk {i}")
    # the tables move: replicas leave domains chunk by chunk
    assert not np.array_equal(want[0][1], want[-1][1])


def test_topo_tables_agg_sums_in_node_order():
    """The domain aggregate with fractional availability (where the sum's
    order shows) against the reference's scatter-add: per level
    ``zeros.at[dom_of].add(accel)``, ascending node order per domain."""
    rng = np.random.default_rng(3)
    state, _ = ref_cs.build_snapshot(*ref_make(**_topo_cluster()), pad=32)
    n = state.nodes
    N, L = n.topology.shape
    ND = N * L
    avail = (rng.random((N, 3)) * 7.3).astype(np.float32)
    valid = np.asarray(n.valid)
    dom_of = jnp.stack([jnp.where(n.valid & (n.topology[:, lvl] >= 0),
                                  n.topology[:, lvl], ND)
                        for lvl in range(L)])
    agg = jnp.zeros((ND + 1,), jnp.float32)
    for lvl in range(L):
        agg = agg.at[dom_of[lvl]].add(jnp.where(n.valid, avail[:, 0], 0.0))
    port_nodes = state_from_numpy(ref_leaves(state), "cpu").nodes
    st = A.TopoStatic.of(port_nodes)
    assert_bits(np.asarray(dom_of, np.int32), st.dom_of.numpy(), "dom_of")
    type_req = torch.tensor([[1.0, 1.0, 4.0], [2.5, 0.5, 1.0]])
    fp = torch.from_numpy(rng.random((2, N)) < 0.8) & t_(valid)
    caps, got, c_y = A.topo_tables_build_plain(st, fp, t_(avail), t_(valid),
                                               type_req)
    assert_bits(np.asarray(agg[:ND]), got.numpy(), "agg")
    # the kernel's CSR walks the same domains
    counts = np.diff(st.dom_ptr.numpy())
    assert counts.sum() == int((np.asarray(dom_of) < ND).sum())


# ---------------------------------------------------------------------------
# K3: the uniform fill's topology and preferred modes
# ---------------------------------------------------------------------------

def _uniform_lanes(seed: int, B: int, preferred: bool):
    """The topology cluster's snapshot with a quarter of the gangs
    unconstrained, a third preferring the block level (with
    ``preferred``), random whole-unit pools (racks of different fill),
    queue allocations near quota; B lanes of random gangs, every third
    with a prior placement."""
    rng = np.random.default_rng(seed)
    state, index = ref_cs.build_snapshot(
        *ref_make(**_topo_cluster(num_gangs=48)), pad=32)
    ses = RefSession.from_state(state, index, RefSessionConfig())
    st = ses.state
    g, n = st.gangs, st.nodes
    G, T = g.task_valid.shape
    ng = len(index.gang_names)
    nn = len(index.node_names)
    srl = np.asarray(g.subgroup_required_level).copy()
    srl[3:ng:4, 0] = -1
    pref = np.asarray(g.preferred_level).copy()
    if preferred:
        pref[1:ng:3] = 0
    st = st.replace(gangs=g.replace(subgroup_required_level=jnp.asarray(srl),
                                    preferred_level=jnp.asarray(pref)))
    free = np.asarray(n.free).copy()
    free[:nn, 0] = np.maximum(
        free[:nn, 0] - rng.integers(0, 4, nn).astype(np.float32), 0.0)
    extra = np.zeros_like(free)
    extra[rng.random(len(free)) < 0.1, 0] = 1.0
    qa = np.asarray(st.queues.allocated).copy()
    cand = rng.integers(0, ng, B).astype(np.int32)
    prior = np.full((B, T), -1, np.int32)
    for b in range(0, B, 3):
        prior[b, 0] = int(rng.integers(0, nn))
    quota_b = np.maximum(np.asarray(g.min_needed)[cand]
                         - (prior >= 0).sum(-1), 1).astype(np.int32)
    cfg = dataclasses.replace(ses.config.allocate, batch_size=B,
                              preferred_topology=preferred)
    return st, cfg, ses.config.num_levels, cand, prior, quota_b, dict(
        free=free, extra=extra, qa=qa,
        qan=np.asarray(st.queues.allocated_nonpreemptible))


@pytest.mark.parametrize("hoisted", [True, False])
@pytest.mark.parametrize("preferred", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_uniform_fill_topology_modes_bit_equal(seed, preferred, hoisted):
    B = 24
    st, cfg, levels, cand, prior, quota_b, p = _uniform_lanes(
        seed, B, preferred)
    port = state_from_numpy(ref_leaves(st), "cpu")
    pn, q = port.nodes, port.queues
    g = port.gangs
    free, extra = t_(p["free"]), t_(p["extra"])
    tables = A.type_tables_plain(pn, free, extra, g.type_req, g.type_selector,
                                 g.type_class, PlacementConfig())
    topo_st = A.TopoStatic.of(pn)
    fp_build = tables[1] & pn.valid[None]
    caps, agg, _ = A.topo_tables_build_plain(
        topo_st, fp_build, (free + pn.releasing) + extra, pn.valid,
        g.type_req)
    order = A.order_by_agg(topo_st.level_of_dom, agg)
    chain = A._chain_membership(q.parent, levels)
    inf = float("inf")
    lim = torch.where(q.limit <= -0.5, inf, q.limit)
    quo = torch.where(q.quota <= -0.5, inf, q.quota)
    topo = A.UniformTopo(
        topology=pn.topology, srl0=g.subgroup_required_level[:, 0].contiguous(),
        dom_caps_y=caps, level_of_dom=topo_st.level_of_dom, order=order,
        pref_level=g.preferred_level if preferred else None)
    got = A.uniform_fill_plain(
        t_(cand), t_(prior), t_(quota_b), t_(p["qa"]), t_(p["qan"]), lim, quo,
        chain, A.LaneTables.of(port), tables, pn.soft_scores, pn.valid,
        dense=False, stride=1, hoisted=hoisted, topo=topo, free=free)

    n = st.nodes
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    rchain = RA._chain_membership(st.queues.parent, levels)
    ttabs = (jnp.asarray(caps.numpy()), jnp.asarray(
        topo_st.level_of_dom.numpy()), jnp.asarray(order.numpy()))
    utabs = (tuple(jnp.asarray(x.numpy()) for x in tables) if hoisted
             else None)

    def one(gi, lane, pr, qb):
        pl = st.gangs.preferred_level[gi]
        return RA._attempt_gang_in_domain_uniform(
            st, gi, jp["free"], n.device_free, jp["qa"], jp["qan"], levels,
            cfg, n.valid, n.topology[:, jnp.maximum(pl, 0)], pl >= 0,
            jp["extra"], jnp.zeros_like(n.device_free), lane, rchain,
            prior_nodes=pr, quota=qb, topo_tables=ttabs,
            type_tables_u=utabs)
    want = [np.asarray(x) for x in jax.jit(jax.vmap(one))(
        cand, jnp.arange(B, dtype=jnp.int32), prior, quota_b)]
    free2, _, qa2, qan2, nodes_t, _, pipe_t, success, bind = want[:9]
    qa2_g, qan2_g, nodes_g, pipe_g, succ_g, free_rows, bind_rows = got
    assert_bits(nodes_t, nodes_g.numpy(), "nodes_t")
    assert_bits(pipe_t, pipe_g.numpy(), "pipe_t")
    assert_bits(success, succ_g.numpy(), "success")
    assert_bits(qa2, qa2_g.numpy(), "qa2")
    assert_bits(qan2, qan2_g.numpy(), "qan2")
    assert_bits(free2, A._dense_rows(free, nodes_g, free_rows).numpy(),
                "free2")
    assert_bits(bind, A._dense_rows(torch.zeros_like(free), nodes_g,
                                    bind_rows).numpy(), "bind")
    # the inputs exercise the modes: confined lanes land in one domain,
    # some lanes find no domain, some pipeline
    sub_dom = want[12][:, 0]
    assert (sub_dom >= 0).any() and (~success).any() and success.any()
    rack = np.asarray(n.topology)[:, 1]
    for b in np.nonzero(success & (sub_dom >= 0))[0]:
        placed = nodes_t[b][nodes_t[b] >= 0]
        assert set(rack[placed].tolist()) == {sub_dom[b]}
    assert pipe_t.any()


# ---------------------------------------------------------------------------
# K9: the per-task fill's subgroup-topology mode
# ---------------------------------------------------------------------------

def _topo_lanes(seed: int, B: int, placement: str):
    """``test_torch_pertask.make_lanes``' lanes with required levels: a
    third of the gangs require one zone for all their subgroups, a third
    one node (the hostname level) for their first subgroup — these often
    pass the aggregate gate and fail the fill, the retry's case."""
    ln = make_lanes(seed, B, placement)
    g = ln.ref_state.gangs
    srl = np.asarray(g.subgroup_required_level).copy()
    ng = int(np.asarray(g.valid).sum())
    srl[0:ng:3, :] = 0
    srl[1:ng:3, 0] = 1
    st = ln.ref_state.replace(gangs=g.replace(
        subgroup_required_level=jnp.asarray(srl)))
    return dataclasses.replace(
        ln, ref_state=st, port_state=state_from_numpy(ref_leaves(st), "cpu"),
        config=dataclasses.replace(ln.config, subgroup_topology=True))


def _ref_topo_attempts(ln, banned=None):
    st, cfg = ln.ref_state, ln.config
    p = {k: jnp.asarray(v) for k, v in ln.pools.items()}
    chain = RA._chain_membership(st.queues.parent, ln.num_levels)
    B = ln.cand.shape[0]
    if banned is None:
        banned = np.full((B, st.gangs.s), -1, np.int32)

    def one(gi, lane, prior, quota, ban):
        pl = st.gangs.preferred_level[gi]
        return RA._attempt_gang_in_domain(
            st, gi, p["free"], p["dev"], p["qa"], p["qan"], ln.num_levels,
            cfg, st.nodes.valid, st.nodes.topology[:, jnp.maximum(pl, 0)],
            pl >= 0, p["extra"], p["extra_dev"], lane, chain,
            prior_nodes=prior, quota=quota, banned_doms=ban)
    out = jax.jit(jax.vmap(one))(ln.cand, jnp.arange(B, dtype=jnp.int32),
                                 ln.prior, ln.quota, banned)
    return [np.asarray(o) for o in out]


def _assert_lanes(want, got: A.PerTaskOut, ln, lanes=slice(None)):
    (free2, dev2, qa2, qan2, nodes_t, dev_t, pipe_t, success, bind,
     devbind) = [w[lanes] for w in want[:10]]
    sub = lambda x: x[lanes]  # noqa: E731
    for what, a, b in (("nodes_t", nodes_t, got.nodes_t),
                       ("dev_t", dev_t, got.dev_t),
                       ("pipe_t", pipe_t, got.pipe_t),
                       ("success", success, got.success),
                       ("qa2", qa2, got.qa2), ("qan2", qan2, got.qan2),
                       ("sub_dom", want[12][lanes], got.sub_dom)):
        assert_bits(a, sub(b).numpy(), what)
    p = ln.pools
    nt = sub(got.nodes_t)

    def dense(pool, rows):
        return A._dense_rows(torch.from_numpy(pool), nt, sub(rows)).numpy()
    assert_bits(free2, dense(p["free"], got.free_rows), "free2")
    assert_bits(bind, dense(np.zeros_like(p["free"]), got.bind_rows), "bind")
    if ln.config.track_devices:
        assert_bits(dev2, dense(p["dev"], got.dev_rows), "dev2")
        assert_bits(devbind, dense(np.zeros_like(p["dev"]),
                                   got.devbind_rows), "devbind")


def _port_topo(ln, **kw):
    st = ln.port_state
    q = st.queues
    t = {k: t_(v) for k, v in ln.pools.items()}
    inf = float("inf")
    return A.pertask_fill(
        st.nodes, A.TaskTables.of(st), t_(ln.cand), t_(ln.prior), t["free"],
        t["dev"], t["qa"], t["qan"], t["extra"], t["extra_dev"],
        A._chain_membership(q.parent, ln.num_levels),
        torch.where(q.limit <= -0.5, inf, q.limit),
        torch.where(q.quota <= -0.5, inf, q.quota),
        placement=PlacementConfig(**PLACEMENTS[ln.placement]),
        track_devices=ln.config.track_devices,
        topo=A.TopoStatic.of(st.nodes), **kw)


@pytest.mark.parametrize("placement", ["binpack_gpupack", "no_device_table",
                                       "spread_gpuspread"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pertask_fill_subgroup_topology_bit_equal(seed, placement):
    """K9's plain version with the domain aggregates and locks, first
    without banned domains, then — as the retry runs it — with the first
    attempt's locked domains banned: for every lane, and merged over the
    lanes the retry selects (the others keep their first output)."""
    B = 37
    ln = _topo_lanes(seed, B, placement)
    want = _ref_topo_attempts(ln)
    got = _port_topo(ln)
    _assert_lanes(want, got, ln)
    sub_dom = want[12]
    assert (sub_dom >= 0).any() and want[7].any() and (~want[7]).any()

    # banned mode on every lane
    want_b = _ref_topo_attempts(ln, banned=sub_dom)
    got_b = _port_topo(ln, banned=t_(sub_dom))
    _assert_lanes(want_b, got_b, ln)

    # the retry: only the lanes that failed with a locked domain run again
    retry = ~want[7] & (sub_dom >= 0).any(-1)
    assert retry.any() and (~retry).any()
    merged = _port_topo(ln, banned=got.sub_dom, active=t_(retry), base=got)
    for lanes in (retry, ~retry):
        _assert_lanes(want_b if lanes is retry else want, merged, ln,
                      np.nonzero(lanes)[0])


def test_pertask_fill_without_topology_is_unchanged():
    """The mode is off without ``topo``: the outputs of the slice-4 lanes
    stay those of their own test (no ``sub_dom``)."""
    ln = make_lanes(0, 8, "binpack_gpupack")
    out = port_attempts(ln)
    assert out.sub_dom is None and len(out.fields()) == 10


# ---------------------------------------------------------------------------
# whole cycles
# ---------------------------------------------------------------------------

def _allocate_schedulers(batch_size: int | None = None):
    ref_alloc, port_alloc = RA.AllocateConfig(), A.AllocateConfig()
    if batch_size is not None:
        ref_alloc = dataclasses.replace(ref_alloc, batch_size=batch_size)
        port_alloc = dataclasses.replace(port_alloc, batch_size=batch_size)
    ref = RefScheduler(RefSchedulerConfig(
        actions=("allocate",), incremental=False, analytics_every=0,
        repack_enable=False, session=RefSessionConfig(allocate=ref_alloc)))
    port = Scheduler(SchedulerConfig(
        actions=("allocate",), session=SessionConfig(allocate=port_alloc)),
        device="cpu")
    return ref, port


def _cycle(objs_ref, objs_port, seen, batch_size=None):
    ref_sched, sched = _allocate_schedulers(batch_size)
    want = ref_sched.run_once(RefCluster.from_objects(*objs_ref))
    got = sched.run_once(Cluster.from_objects(*objs_port))
    assert got.packed.tobytes() == seen["packed"].tobytes()
    assert [dataclasses.asdict(b) for b in got.bind_requests] == \
        [dataclasses.asdict(b) for b in want.bind_requests]
    return want, got


def _retry_objects(apis, fragmented: bool):
    """``tests/test_topology_retry.py``'s two clusters."""
    def node(name, rack, accel):
        return apis.Node(name=name,
                         allocatable=apis.ResourceVec(accel, 32.0, 128.0),
                         labels={"rack": rack,
                                 "kubernetes.io/hostname": name})
    topology = apis.Topology(name="default",
                             levels=["rack", "kubernetes.io/hostname"])
    if fragmented:
        nodes = [node("a0", "rack-a", 2.0), node("a1", "rack-a", 2.0),
                 node("a2", "rack-a", 2.0), node("b0", "rack-b", 4.0),
                 node("b1", "rack-b", 4.0)]
    else:
        nodes = [node("a0", "rack-a", 4.0), node("a1", "rack-a", 4.0),
                 node("b0", "rack-b", 4.0), node("b1", "rack-b", 2.0)]
    queues = [apis.Queue(name="dept", accel=apis.QueueResource(quota=16.0)),
              apis.Queue(name="q", parent="dept",
                         accel=apis.QueueResource(quota=16.0))]
    pg = apis.PodGroup(name="gang", queue="q", min_member=2,
                       topology_constraint=apis.TopologyConstraint(
                           topology="default", required_level="rack"))
    pods = [apis.Pod(name="t0-small", group="gang",
                     resources=apis.ResourceVec(2.0, 1.0, 1.0)),
            apis.Pod(name="t1-big", group="gang",
                     resources=apis.ResourceVec(4.0, 1.0, 1.0))]
    return nodes, queues, [pg], pods, topology


@pytest.mark.parametrize("fragmented", [True, False])
def test_topology_retry_inputs_cycle_bit_equal(fragmented, pad32):
    """The fragmented fullest rack: the gang locks rack-a, fails the fill
    and lands in rack-b in the same cycle through the retry; the binpack
    case picks the most-packed fitting rack at once."""
    want, got = _cycle(_retry_objects(ref_apis, fragmented),
                       _retry_objects(port_apis, fragmented), pad32)
    assert {b.selected_node[0] for b in got.bind_requests} == {"b"}
    assert len(got.bind_requests) == 2
    assert got.retries == (1 if fragmented else 0)
    assert got.retry_chunks == (1 if fragmented else 0)


RACK, HOST = "topo/rack", "kubernetes.io/hostname"


def _racked(apis, racks=2, nodes_per_rack=2, accel=4.0):
    return [apis.Node(f"node-{r}-{i}", apis.ResourceVec(accel, 64.0, 256.0),
                      labels={RACK: f"rack-{r}", HOST: f"node-{r}-{i}"})
            for r in range(racks) for i in range(nodes_per_rack)]


def _level_case(apis, name: str):
    """``tests/test_topology.py``'s required- and preferred-level inputs."""
    V = apis.ResourceVec
    tc = apis.TopologyConstraint
    if name == "confined":
        return _racked(apis), [apis.PodGroup(
            "g0", queue="q0", min_member=4,
            topology_constraint=tc(required_level=RACK))], [
            apis.Pod(f"p{i}", "g0", resources=V(2.0, 1.0, 4.0))
            for i in range(4)]
    if name == "too_big":
        return _racked(apis), [apis.PodGroup(
            "g0", queue="q0", min_member=6,
            topology_constraint=tc(required_level=RACK))], [
            apis.Pod(f"p{i}", "g0", resources=V(2.0, 1.0, 4.0))
            for i in range(6)]
    if name == "binpack":
        filler = apis.PodGroup("filler", queue="q0", min_member=1,
                               last_start_timestamp=0.0)
        group = apis.PodGroup("g0", queue="q0", min_member=2,
                              topology_constraint=tc(required_level=RACK))
        pods = [apis.Pod("f0", "filler", resources=V(4.0, 1.0, 4.0),
                         status=apis.PodStatus.RUNNING, node="node-0-0")]
        pods += [apis.Pod(f"p{i}", "g0", resources=V(2.0, 1.0, 4.0))
                 for i in range(2)]
        return _racked(apis), [filler, group], pods
    if name == "unconstrained":
        return _racked(apis), [apis.PodGroup("g0", queue="q0",
                                             min_member=6)], [
            apis.Pod(f"p{i}", "g0", resources=V(2.0, 1.0, 4.0))
            for i in range(6)]
    return _racked(apis, racks=3, nodes_per_rack=2, accel=2.0), [
        apis.PodGroup("g0", queue="q0", min_member=4,
                      topology_constraint=tc(preferred_level=RACK))], [
        apis.Pod(f"p{i}", "g0", resources=V(1.0, 1.0, 4.0))
        for i in range(4)]


@pytest.mark.parametrize("name", ["confined", "too_big", "binpack",
                                  "unconstrained", "preferred"])
def test_topology_level_inputs_bit_equal(name):
    """``allocate`` with the default config (the per-task path with the
    device table, the subgroup-topology machinery and the preferred band)
    on ``tests/test_topology.py``'s inputs, as that file runs it: every
    field of the result equal."""
    objs = {}
    for key, apis in (("ref", ref_apis), ("port", port_apis)):
        nodes, groups, pods = _level_case(apis, name)
        objs[key] = (nodes, [apis.Queue("q0", accel=apis.QueueResource(
            quota=1000.0))], groups, pods,
            apis.Topology(name="default", levels=[RACK, HOST]))
    state, _ = ref_cs.build_snapshot(*objs["ref"], pad=32)
    fs = ref_drf.set_fair_share(state, num_levels=1)
    want = jax.device_get(RA.allocate_jit(state, fs, num_levels=1))
    pstate, _ = port_cs.build_snapshot(*objs["port"], pad=32, device="cpu")
    got = A.allocate(pstate, port_drf.set_fair_share(pstate, num_levels=1),
                     num_levels=1)
    for f in dataclasses.fields(want):
        assert_bits(np.asarray(getattr(want, f.name)),
                    getattr(got, f.name).numpy(), f.name)
    assert bool(got.allocated.any()) == (name != "too_big")


def _make_objects(make, apis, preferred: str | None, required: bool, **kw):
    objs = make(**_topo_cluster(**kw)) if required else make(
        **_topo_cluster(required_level=None, **kw))
    if preferred:
        for i, g in enumerate(objs[2]):
            if i % 2 == 0 and g.last_start_timestamp is None:
                g.topology_constraint = apis.TopologyConstraint(
                    topology="default",
                    required_level="topo/level1" if required else None,
                    preferred_level=preferred)
    return objs


#: (lanes, pending gangs, required level, preferred level on every other
#: gang): the gang count keeps every lane width real
MAKE_CLUSTER_CYCLES = [
    pytest.param(64, 100, True, None, id="required-64"),
    pytest.param(256, 300, True, None, id="required-256"),
    pytest.param(64, 100, True, "topo/level0", id="required-preferred-64"),
    pytest.param(64, 100, False, "topo/level0", id="preferred-64"),
]


@pytest.mark.parametrize("B,gangs,required,preferred", MAKE_CLUSTER_CYCLES)
def test_make_cluster_topology_cycle_bit_equal(B, gangs, required, preferred,
                                               pad32, monkeypatch):
    """``make_cluster``'s rack-required tree (2 blocks x 4 racks x 8
    nodes) through both Schedulers at 64 and 256 lanes, with the uniform
    preferred band on every other gang in two variants.  On this path the
    dense commit's lane sums (the reference's ``einsum`` over lanes, whose
    XLA:CPU order is reassociated beyond ~40 lanes) add whole units below
    2^24, which no order can change: asserted on every chunk's rows."""
    rows = []
    orig = A.dense_accept

    def rec(*args, **kw):
        rows.append((args[0], args[1], args[3], args[5], args[7]))
        return orig(*args, **kw)
    monkeypatch.setattr(A, "dense_accept", rec)
    want, got = _cycle(
        _make_objects(ref_make, ref_apis, preferred, required,
                      num_gangs=gangs, tasks_per_gang=4),
        _make_objects(port_make, port_apis, preferred, required,
                      num_gangs=gangs, tasks_per_gang=4), pad32,
        batch_size=B)
    assert got.tensors.allocated.any() and got.tensors.fit_reason.eq(3).any()
    assert min(B, got.tensors.allocated.shape[0]) == B
    assert bool(rows) == required
    for nodes_b, ok, free_rows, bind_rows, free in rows:
        hit = ok[:, None] & (nodes_b >= 0)
        d = free[nodes_b.clamp(min=0).long()] - free_rows
        for x in (d[hit], bind_rows[hit], free):
            assert bool((x == torch.round(x)).all())
            if x.numel():
                assert float(x.abs().max()) * nodes_b.shape[0] < 2 ** 24


def test_chip_cell_subgroup_topology_cycle_bit_equal(pad32):
    """The ``topology_subgroups`` chip cell's shape at 64 nodes: mixed
    gangs and two-subgroup gangs each required at the rack level (the
    gang preferred at the block level) on racks of different fill, the
    per-task path at its 64-lane cap — packed commit and BindRequests
    equal, retries counted alike."""
    kw = dict(num_nodes=64, levels=(2, 4), gangs=40, seed=0)
    want, got = _cycle(
        fleets.topology_subgroup_objects(ref_apis, ref_make, **kw),
        fleets.topology_subgroup_objects(port_apis, port_make, **kw),
        pad32)
    assert len(got.bind_requests) > 0
    assert got.tensors.fit_reason.eq(3).any()
    assert got.retry_chunks <= min(got.retries, got.chunks)
    assert (got.retry_chunks > 0) == (got.retries > 0)


# ---------------------------------------------------------------------------
# launch counts by mode
# ---------------------------------------------------------------------------

def test_launch_counts_by_mode():
    """Each topology mode has its own count beside its kernel's: a
    wrapper flags the modes of a launch, a reset zeroes them, an unknown
    mode is an error; K9's scratch is for the card only."""
    from kai_scheduler_tpu_torch import kernels
    kernels.reset_launch_counts()
    counts = kernels.launch_counts()
    for key in ("uniform_fill:topology", "uniform_fill:preferred",
                "dense_accept:no_devices", "pertask_fill:topology",
                "pertask_fill:banned"):
        assert counts[key] == 0
    try:
        kernels.count_launch("pertask_fill", topology=False, banned=True)
        kernels.count_launch("pertask_fill", topology=True, banned=False)
        kernels.count_launch("pertask_fill", topology=True, banned=False)
        counts = kernels.launch_counts()
        assert (counts["pertask_fill"], counts["pertask_fill:topology"],
                counts["pertask_fill:banned"]) == (3, 2, 1)
        with pytest.raises(KeyError):
            kernels.count_launch("pertask_fill", nonsense=True)
    finally:
        kernels.reset_launch_counts()
    assert kernels.launch_counts()["pertask_fill:banned"] == 0
    objs = port_make(num_nodes=8, topology_levels=(2, 2),
                     required_level="topo/level1")
    st = port_session.Session.open(*objs, device="cpu").state
    topo = A.TopoStatic.of(st.nodes)
    assert A.pertask_agg_scratch(4, topo, st.nodes.free) is None


# ---------------------------------------------------------------------------
# refusals and the auto-tune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preferred", [False, True])
def test_victim_actions_refuse_topology_by_name(preferred):
    """Allocate runs a topology snapshot; the victim actions have not
    ported topology (the solver's per-lane domain pick, ref
    ``victims.py:1055-1076``) and refuse it, naming the flag."""
    objs = _make_objects(port_make, port_apis,
                         "topo/level0" if preferred else None,
                         not preferred, num_gangs=8)
    sched = Scheduler(SchedulerConfig(actions=DEFAULT_ACTIONS), device="cpu")
    flag = "preferred_topology" if preferred else "subgroup_topology"
    with pytest.raises(NotImplementedError, match=f"victim actions: {flag}"):
        sched.run_once(Cluster.from_objects(*objs))
    ok = Scheduler(SchedulerConfig(actions=("allocate",)), device="cpu")
    assert ok.run_once(Cluster.from_objects(*objs)).bind_requests


@pytest.mark.parametrize("name", sorted(CASES))
def test_auto_tune_matches_reference(name):
    """The port's auto-tune derives the reference's allocate and victim
    placement flags from each catalog case's snapshot at pad=32 (the
    topology flags decide the paths this slice added)."""
    cluster = _build(CASES[name])
    lists = cluster.snapshot_lists()
    _, ref_index = ref_cs.build_snapshot(*lists, pad=32, now=cluster.now)
    _, port_index = port_cs.build_snapshot(*to_port(list(lists)), pad=32,
                                           now=cluster.now, device="cpu")
    want = ref_session._auto_tune(RefSessionConfig(), ref_index, 32, 32)
    got = port_session._auto_tune(SessionConfig(), port_index, 32, 32)
    for cfg_w, cfg_g in ((want.allocate, got.allocate),
                         (want.victims.placement, got.victims.placement)):
        for f in dataclasses.fields(cfg_w):
            if f.name != "placement":
                assert getattr(cfg_g, f.name) == getattr(cfg_w, f.name), \
                    f.name
    assert got.num_levels == want.num_levels

