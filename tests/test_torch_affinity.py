"""The port's in-cycle affinity machinery (cross-gang required
anti-affinity, shared host ports, required positive affinity: the cycle's
claimed-domain table ``anti_used``) against the JAX reference, on the CPU,
where the kernels run their plain versions.  Every comparison is bit for
bit (tolerance 0):

- the six gates (``anti_domain_tables``, ``anti_forbid_nodes``,
  ``anti_mark_placements``, ``anti_defer_lanes``, ``attract_allow_nodes``,
  ``attract_defer_lanes``) and the plain versions of K12
  (``affinity_mask``) and K13 (``anti_mark``) on seeded term tables: 4 and
  8 slots, 1 and 40 term rows, nodes lacking a level's label, padded nodes,
  junk lanes;
- K3's mask mode against ``_attempt_gang_in_domain_uniform`` vmapped with
  a per-lane ``domain_mask`` (the hoisted tables, anti-self gangs, a
  rack-required tree);
- K9's mask mode against ``_attempt_gang_in_domain`` (subgroup topology,
  the banned retry merged over its active lanes);
- whole cycles on the inputs of the reference's ``TestCrossGangAntiAffinity``,
  ``TestInCycleExclusion`` and ``TestInCycleAttraction``
  (``tests/test_taints_affinity.py``, rebuilt through ``to_port``):
  allocate only and the five default actions, sequential and chunked —
  the packed commit, the BindRequests, the evictions and ``anti_used``
  after every action (the packed commit does not carry it);
- the three card cells' fleets (``state/fleets.py``) at 256 nodes, at 1,
  8, 64 and 256 lanes.

Inputs are made from a seed with numpy; both packages build them with
their own API objects."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.framework.scheduler as ref_scheduler
import kai_scheduler_tpu.framework.session as ref_session
import kai_scheduler_tpu.state.cluster_state as ref_cs
import kai_scheduler_tpu_torch.framework.scheduler as port_scheduler
import test_taints_affinity as ref_tests
from kai_scheduler_tpu.apis import types as ref_apis
from kai_scheduler_tpu.framework.scheduler import Scheduler as RefScheduler
from kai_scheduler_tpu.framework.scheduler import \
    SchedulerConfig as RefSchedulerConfig
from kai_scheduler_tpu.framework.session import \
    SessionConfig as RefSessionConfig
from kai_scheduler_tpu.ops import allocate as RA
from kai_scheduler_tpu.ops.allocate import \
    AllocateConfig as RefAllocateConfig
from kai_scheduler_tpu.ops.victims import VictimConfig as RefVictimConfig
from kai_scheduler_tpu.runtime.cluster import Cluster as RefCluster
from kai_scheduler_tpu.state import make_cluster as ref_make
from kai_scheduler_tpu_torch.apis import types as port_apis
from kai_scheduler_tpu_torch.framework.scheduler import (DEFAULT_ACTIONS,
                                                         Scheduler,
                                                         SchedulerConfig)
from kai_scheduler_tpu_torch.framework.session import SessionConfig
from kai_scheduler_tpu_torch.ops import allocate as A
from kai_scheduler_tpu_torch.ops.scoring import PlacementConfig
from kai_scheduler_tpu_torch.ops.victims import (VictimConfig,
                                                 check_placement_ported)
from kai_scheduler_tpu_torch.state import fleets
from kai_scheduler_tpu_torch.state import make_cluster as port_make
from kai_scheduler_tpu_torch.state import state_from_numpy
from chip_smoke import affinity_violations
from test_torch_allocate import ref_leaves
from test_torch_pertask import assert_bits
from test_torch_scenarios import _port_cluster, _refusal, pad32  # noqa: F401
from test_torch_topology import (_assert_lanes, _port_topo, _topo_lanes,
                                 _uniform_lanes, t_)

from jax_executables import _release, release_jax_executables  # noqa: F401


@pytest.fixture(autouse=True)
def release_after_each():
    """Each cycle here compiles the reference's programs for shapes of its
    own; drop them after every test so one worker's mappings stay within
    ``vm.max_map_count`` (repeats read the persistent compilation cache)."""
    yield
    _release()


# ---------------------------------------------------------------------------
# the six gates, K12 and K13 on seeded term tables
# ---------------------------------------------------------------------------

def _gate_inputs(KT: int, TA: int, seed: int):
    """A 40-node snapshot (padded to 64) in 2 blocks x 4 racks with a fifth
    of its (node, level) labels removed, and random term tables: ``KT``
    mark and avoid slots, 2 need slots, ``TA`` rows at every level
    (hostname included), static claims on a third of the (row, node)
    pairs; a random claimed-domain table; B lanes of random gangs with
    the junk gang index (G, and -1) on some."""
    rng = np.random.default_rng(seed)
    state, _ = ref_cs.build_snapshot(*ref_make(
        num_nodes=40, num_gangs=12, tasks_per_gang=3, topology_levels=(2, 4),
        seed=seed), pad=32)
    g, n = state.gangs, state.nodes
    G, T = g.task_valid.shape
    N, L = n.topology.shape
    topo = np.asarray(n.topology).copy()
    topo[rng.random(topo.shape) < 0.2] = -1

    def slots(k):
        return jnp.asarray(rng.integers(-1, TA, (G, k)).astype(np.int32))
    st = state.replace(
        nodes=n.replace(topology=jnp.asarray(topo)),
        gangs=g.replace(
            anti_marks=slots(KT), anti_avoids=slots(KT),
            attract_needs=slots(2),
            anti_term_level=jnp.asarray(
                rng.integers(0, L + 1, TA).astype(np.int32)),
            attract_static=jnp.asarray(rng.random((TA, N)) < 0.3)))
    AD = N * L + N
    used = rng.random((TA + 1, AD + 1)) < 0.2
    B = 24
    cand = rng.integers(0, G, B).astype(np.int32)
    cand[[3, 7]] = G
    cand[11] = -1
    cand_valid = rng.random(B) < 0.8
    cand_valid[0] = True
    nodes_t = rng.integers(-1, N, (B, T)).astype(np.int32)
    take = rng.random(B) < 0.6
    return st, used, cand, cand_valid, nodes_t, take


@pytest.mark.parametrize("TA", [1, 40])
@pytest.mark.parametrize("KT", [4, 8])
def test_gates_and_plain_kernels_bit_equal(KT, TA):
    st, used, cand, cand_valid, nodes_t, take = _gate_inputs(KT, TA, KT + TA)
    port = state_from_numpy(ref_leaves(st), "cpu")
    tu = t_(used)
    dom_r, ta_r = RA.anti_domain_tables(st)
    dom_p = A.anti_domain_tables(port)
    assert ta_r == port.gangs.anti_term_level.shape[0] == TA
    assert_bits(np.asarray(dom_r), dom_p.numpy(), "dom_static")
    # padded nodes map to the junk id AD, unlabelled ones to their own slot
    N, L = np.asarray(st.nodes.topology).shape
    AD = N * L + N
    assert (dom_p[:, ~port.nodes.valid] == AD).all()
    assert (dom_p[:L] >= N * L).any()

    def both(name, *args):
        want = np.asarray(getattr(RA, name)(st, *(
            jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args)))
        got = getattr(A, name)(port, *(
            t_(a) if isinstance(a, np.ndarray) else a for a in args))
        assert_bits(want, got.numpy(), name)
        return want

    dom = np.asarray(dom_r)
    forbid = both("anti_forbid_nodes", used, dom, cand)
    allow = both("attract_allow_nodes", used, dom, cand)
    assert forbid.any() and (~forbid).any() and allow.any()
    assert (~allow).any()
    both("anti_forbid_nodes", used, dom, np.asarray(cand[0]))  # one gang
    marked = both("anti_mark_placements", used, dom, cand, nodes_t, take)
    assert (marked != used).any()
    defer = both("anti_defer_lanes", cand, cand_valid)
    both("attract_defer_lanes", cand, cand_valid, used)
    assert not defer[0]

    # K12 and K13's plain versions (the CPU wrappers) against the
    # reference's composition
    valid = np.asarray(st.nodes.valid)
    for attract in (False, True):
        want = valid & ~forbid & (allow if attract else True)
        got = A.affinity_mask(port, tu, dom_p, t_(cand), attract=attract)
        assert_bits(want, got.numpy(), f"affinity_mask attract={attract}")
    # the gate returns a new table; K13 marks the table it is given
    assert tu.numpy().tobytes() == used.tobytes()
    got = A.anti_mark(port, tu, dom_p, t_(cand), t_(nodes_t), t_(take))
    assert got is tu
    assert_bits(marked, tu.numpy(), "anti_mark")
    rows, cols = A.anti_mark_cells(port, dom_p, t_(cand), t_(nodes_t),
                                   t_(take))
    assert rows.shape == cols.shape == (len(cand), KT, nodes_t.shape[1])
    assert bool(tu[rows, cols].all())


def test_gates_refuse_a_snapshot_without_terms():
    """With no term rows the reference raises ``ValueError`` (its kernels
    are compiled without terms); so does the port."""
    state, _ = ref_cs.build_snapshot(*ref_make(num_nodes=4, num_gangs=2),
                                     pad=32)
    port = state_from_numpy(ref_leaves(state), "cpu")
    dom = A.anti_domain_tables(port)
    assert port.gangs.anti_term_level.shape[0] == 0
    used = A.init_result(port).anti_used                # [1, AD + 1]
    cand = torch.zeros((2,), dtype=torch.int32)
    for fn, args in (
            (A.anti_forbid_nodes, (used, dom, cand)),
            (A.attract_allow_nodes, (used, dom, cand)),
            (A.anti_mark_placements, (used, dom, cand,
                                      torch.full((2, 1), -1), cand >= 0)),
            (A.affinity_mask, (used, dom, cand))):
        kw = {"attract": True} if fn is A.affinity_mask else {}
        with pytest.raises(ValueError, match="without terms"):
            fn(port, *args, **kw)
    with pytest.raises(ValueError, match="without terms"):
        RA.anti_forbid_nodes(state, jnp.asarray(used.numpy()),
                             jnp.asarray(dom.numpy()), jnp.zeros(2, int))


# ---------------------------------------------------------------------------
# K3 and K9 mask modes
# ---------------------------------------------------------------------------

def _lane_mask(rng, B: int, valid: np.ndarray) -> np.ndarray:
    """A random [B, N] node mask with the valid nodes folded in: some
    lanes keep every node, some a handful."""
    m = rng.random((B, valid.shape[0])) < rng.choice([0.3, 0.7, 1.0],
                                                      (B, 1))
    m[1] = rng.random(valid.shape[0]) < 0.05
    return m & valid[None]


@pytest.mark.parametrize("preferred", [False, True])
def test_uniform_fill_mask_mode_bit_equal(preferred):
    """K3's plain version with a [B, N] ``valid`` (the mask mode) against
    the reference's whole-gang attempt with each lane's ``domain_mask``,
    on the rack-required tree with the hoisted per-type and domain tables
    and a fifth of the gangs anti-self (one replica per node)."""
    B = 24
    st, cfg, levels, cand, prior, quota_b, p = _uniform_lanes(
        2, B, preferred)
    rng = np.random.default_rng(5)
    asl = np.asarray(st.gangs.anti_self_level).copy()
    asl[::5] = st.nodes.topology.shape[1]
    st = st.replace(gangs=st.gangs.replace(anti_self_level=jnp.asarray(asl)))
    mask = _lane_mask(rng, B, np.asarray(st.nodes.valid))
    port = state_from_numpy(ref_leaves(st), "cpu")
    pn, q, g = port.nodes, port.queues, port.gangs
    free, extra = t_(p["free"]), t_(p["extra"])
    tables = A.type_tables_plain(pn, free, extra, g.type_req, g.type_selector,
                                 g.type_class, PlacementConfig())
    topo_st = A.TopoStatic.of(pn)
    caps, agg, _ = A.topo_tables_build_plain(
        topo_st, tables[1] & pn.valid[None], (free + pn.releasing) + extra,
        pn.valid, g.type_req)
    order = A.order_by_agg(topo_st.level_of_dom, agg)
    chain = A._chain_membership(q.parent, levels)
    inf = float("inf")
    topo = A.UniformTopo(
        topology=pn.topology,
        srl0=g.subgroup_required_level[:, 0].contiguous(),
        dom_caps_y=caps, level_of_dom=topo_st.level_of_dom, order=order,
        pref_level=g.preferred_level if preferred else None)
    got = A.uniform_fill(
        t_(cand), t_(prior), t_(quota_b), t_(p["qa"]), t_(p["qan"]),
        torch.where(q.limit <= -0.5, inf, q.limit),
        torch.where(q.quota <= -0.5, inf, q.quota), chain,
        A.LaneTables.of(port), tables, pn.soft_scores, t_(mask), dense=False,
        stride=1, hoisted=True, topo=topo, free=free)

    n = st.nodes
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    rchain = RA._chain_membership(st.queues.parent, levels)
    ttabs = (jnp.asarray(caps.numpy()), jnp.asarray(
        topo_st.level_of_dom.numpy()), jnp.asarray(order.numpy()))
    utabs = tuple(jnp.asarray(x.numpy()) for x in tables)

    def one(gi, lane, pr, qb, dm):
        pl = st.gangs.preferred_level[gi]
        return RA._attempt_gang_in_domain_uniform(
            st, gi, jp["free"], n.device_free, jp["qa"], jp["qan"], levels,
            cfg, n.valid & dm, n.topology[:, jnp.maximum(pl, 0)], pl >= 0,
            jp["extra"], jnp.zeros_like(n.device_free), lane, rchain,
            prior_nodes=pr, quota=qb, topo_tables=ttabs, type_tables_u=utabs)
    want = [np.asarray(x) for x in jax.jit(jax.vmap(one))(
        cand, jnp.arange(B, dtype=jnp.int32), prior, quota_b, mask)]
    free2, _, qa2, qan2, nodes_t, _, pipe_t, success, bind = want[:9]
    qa2_g, qan2_g, nodes_g, pipe_g, succ_g, free_rows, bind_rows = got
    for what, a, b in (("nodes_t", nodes_t, nodes_g), ("pipe_t", pipe_t,
                                                       pipe_g),
                       ("success", success, succ_g), ("qa2", qa2, qa2_g),
                       ("qan2", qan2, qan2_g)):
        assert_bits(a, b.numpy(), what)
    assert_bits(free2, A._dense_rows(free, nodes_g, free_rows).numpy(),
                "free2")
    assert_bits(bind, A._dense_rows(torch.zeros_like(free), nodes_g,
                                    bind_rows).numpy(), "bind")
    # the mask confines: no lane lands outside its row, and the narrow
    # lane cannot place as it does unmasked
    for b in range(B):
        placed = nodes_t[b][nodes_t[b] >= 0]
        assert mask[b, placed].all()
    assert success.any() and (~success).any()


@pytest.mark.parametrize("placement", ["binpack_gpupack", "no_device_table"])
def test_pertask_fill_mask_mode_bit_equal(placement):
    """K9's plain version with a per-lane ``mask`` against the reference's
    per-task attempt with each lane's ``domain_mask``, with subgroup
    topology: every lane, then the retry with the first attempt's locked
    domains banned, merged over the lanes it selects."""
    B = 29
    ln = _topo_lanes(3, B, placement)
    rng = np.random.default_rng(7)
    mask = _lane_mask(rng, B, np.asarray(ln.ref_state.nodes.valid))
    st, cfg = ln.ref_state, ln.config
    p = {k: jnp.asarray(v) for k, v in ln.pools.items()}
    chain = RA._chain_membership(st.queues.parent, ln.num_levels)

    def ref(banned):
        def one(gi, lane, prior, quota, ban, dm):
            pl = st.gangs.preferred_level[gi]
            return RA._attempt_gang_in_domain(
                st, gi, p["free"], p["dev"], p["qa"], p["qan"],
                ln.num_levels, cfg, st.nodes.valid & dm,
                st.nodes.topology[:, jnp.maximum(pl, 0)], pl >= 0,
                p["extra"], p["extra_dev"], lane, chain, prior_nodes=prior,
                quota=quota, banned_doms=ban)
        out = jax.jit(jax.vmap(one))(ln.cand, jnp.arange(B, dtype=jnp.int32),
                                     ln.prior, ln.quota, banned, mask)
        return [np.asarray(o) for o in out]
    want = ref(np.full((B, st.gangs.s), -1, np.int32))
    got = _port_topo(ln, mask=t_(mask))
    _assert_lanes(want, got, ln)
    sub_dom = want[12]
    retry = ~want[7] & (sub_dom >= 0).any(-1)
    assert want[7].any() and retry.any() and (~retry).any()
    want_b = ref(sub_dom)
    merged = _port_topo(ln, banned=got.sub_dom, active=t_(retry), base=got,
                        mask=t_(mask))
    for lanes, w in ((retry, want_b), (~retry, want)):
        _assert_lanes(w, merged, ln, np.nonzero(lanes)[0])
    for b in range(B):
        placed = want[4][b][want[4][b] >= 0]
        assert mask[b, placed].all()


# ---------------------------------------------------------------------------
# whole cycles: the reference's own affinity inputs
# ---------------------------------------------------------------------------

def _cross_gang(apis, levels=None, key="kubernetes.io/hostname"):
    return ref_tests.TestCrossGangAntiAffinity._cluster(
        levels=levels, key=key).snapshot_lists()


def _excl(apis, groups, pods, nodes=None):
    E = ref_tests.TestInCycleExclusion
    return (nodes or E._nodes(), E._queues(), groups, pods, None)


def _asymmetric(apis):
    term = apis.PodAffinityTerm(match_labels=(("app", "db"),), anti=True,
                                required=True)
    groups = [apis.PodGroup(name="labels", queue="q", min_member=2),
              apis.PodGroup(name="avoider", queue="q", min_member=2)]
    pods = ([apis.Pod(name=f"labels-{i}", group="labels",
                      resources=apis.ResourceVec(1.0, 1.0, 1.0),
                      labels={"app": "db"}) for i in range(2)]
            + [apis.Pod(name=f"avoider-{i}", group="avoider",
                        resources=apis.ResourceVec(1.0, 1.0, 1.0),
                        pod_affinity=[term]) for i in range(2)])
    return _excl(apis, groups, pods)


def _nodeports(apis):
    groups = [apis.PodGroup(name=g, queue="q", min_member=1)
              for g in ("pa", "pb", "plain")]
    pods = [apis.Pod(name="pa-0", group="pa",
                     resources=apis.ResourceVec(1.0, 1.0, 1.0),
                     host_ports=[8080]),
            apis.Pod(name="pb-0", group="pb",
                     resources=apis.ResourceVec(1.0, 1.0, 1.0),
                     host_ports=[8080]),
            apis.Pod(name="plain-0", group="plain",
                     resources=apis.ResourceVec(1.0, 1.0, 1.0))]
    return _excl(apis, groups, pods)


def _port_replicas(apis):
    groups = [apis.PodGroup(name="svc", queue="q", min_member=3)]
    pods = [apis.Pod(name=f"svc-{i}", group="svc",
                     resources=apis.ResourceVec(1.0, 1.0, 1.0),
                     host_ports=[9090]) for i in range(3)]
    return _excl(apis, groups, pods)


def _reverse_anti(apis):
    term = apis.PodAffinityTerm(match_labels=(("app", "web"),), anti=True,
                                required=True)
    groups = [apis.PodGroup(name="guard", queue="q", min_member=1,
                            last_start_timestamp=0.0),
              apis.PodGroup(name="web", queue="q", min_member=1)]
    pods = [apis.Pod(name="guard-0", group="guard",
                     resources=apis.ResourceVec(1.0, 1.0, 1.0),
                     status=apis.PodStatus.RUNNING, node="n0",
                     pod_affinity=[term]),
            apis.Pod(name="web-0", group="web",
                     resources=apis.ResourceVec(1.0, 1.0, 1.0),
                     labels={"app": "web"})]
    return _excl(apis, groups, pods)


def _reclaim_anti(apis):
    nodes = ref_tests.TestInCycleExclusion._nodes(n=2, accel=2.0)
    queues = [
        apis.Queue(name="dept", accel=apis.QueueResource(quota=4.0)),
        apis.Queue(name="q", parent="dept",
                   accel=apis.QueueResource(quota=2.0)),
        apis.Queue(name="qv", parent="dept",
                   accel=apis.QueueResource(quota=1.0))]
    term = apis.PodAffinityTerm(match_labels=(("app", "ha"),), anti=True,
                                required=True)
    groups, pods = [], []
    for i in range(4):
        groups.append(apis.PodGroup(name=f"run-{i}", queue="qv",
                                    min_member=1, last_start_timestamp=0.0))
        pods.append(apis.Pod(name=f"run-{i}-0", group=f"run-{i}",
                             resources=apis.ResourceVec(1.0, 1.0, 1.0),
                             status=apis.PodStatus.RUNNING,
                             node=f"n{i % 2}"))
    for gname in ("ha-a", "ha-b"):
        groups.append(apis.PodGroup(name=gname, queue="q", min_member=1))
        pods.append(apis.Pod(name=f"{gname}-0", group=gname,
                             resources=apis.ResourceVec(1.0, 1.0, 1.0),
                             labels={"app": "ha"}, pod_affinity=[term]))
    return nodes, queues, groups, pods, None


def _six_terms(apis):
    terms = [apis.PodAffinityTerm(match_labels=(("app", f"a{i}"),),
                                  anti=True, required=True)
             for i in range(6)]
    groups = [apis.PodGroup(name=f"l{i}", queue="q", min_member=1)
              for i in range(6)]
    groups.append(apis.PodGroup(name="hub", queue="q", min_member=1))
    pods = [apis.Pod(name=f"l{i}-0", group=f"l{i}",
                     resources=apis.ResourceVec(1.0, 1.0, 1.0),
                     labels={"app": f"a{i}"}) for i in range(6)]
    pods.append(apis.Pod(name="hub-0", group="hub",
                         resources=apis.ResourceVec(1.0, 1.0, 1.0),
                         pod_affinity=terms))
    nodes = [apis.Node(name=f"n{i}",
                       allocatable=apis.ResourceVec(1.0, 64.0, 256.0),
                       labels={"kubernetes.io/hostname": f"n{i}"})
             for i in range(8)]
    return _excl(apis, groups, pods, nodes)


def _attr(apis, nodes, groups, pods, topo=None):
    return nodes, ref_tests.TestInCycleAttraction._queues(), groups, pods, \
        topo


def _hosts(apis, n, accel, labels=None):
    return [apis.Node(name=f"n{i}",
                      allocatable=apis.ResourceVec(accel, 64.0, 256.0),
                      labels=labels(i) if labels else
                      {"kubernetes.io/hostname": f"n{i}"})
            for i in range(n)]


def _pod(apis, name, group, accel=1.0, **kw):
    return apis.Pod(name=name, group=group,
                    resources=apis.ResourceVec(accel, 1.0, 1.0), **kw)


def _anchor_node(apis):
    term = apis.PodAffinityTerm(match_labels=(("app", "db"),))
    groups = [apis.PodGroup(name="db", queue="q", min_member=1),
              apis.PodGroup(name="web", queue="q", min_member=1)]
    pods = [_pod(apis, "db-0", "db", labels={"app": "db"}),
            _pod(apis, "web-0", "web", pod_affinity=[term])]
    return _attr(apis, _hosts(apis, 4, 8.0), groups, pods)


def _anchor_rack(apis):
    topo = apis.Topology("t", levels=["rack", "host"])
    nodes = _hosts(apis, 9, 2.0, lambda i: {"rack": f"r{i // 3}",
                                             "host": f"n{i}"})
    term = apis.PodAffinityTerm(match_labels=(("app", "db"),),
                                topology_key="rack")
    groups = [apis.PodGroup(name="db", queue="q", min_member=1),
              apis.PodGroup(name="web", queue="q", min_member=2)]
    pods = [_pod(apis, "db-0", "db", 2.0, labels={"app": "db"})]
    pods += [_pod(apis, f"web-{i}", "web", 2.0, pod_affinity=[term])
             for i in range(2)]
    return _attr(apis, nodes, groups, pods, topo)


def _no_anchor(apis):
    nodes = [apis.Node(name="n0",
                       allocatable=apis.ResourceVec(8.0, 64.0, 256.0))]
    term = apis.PodAffinityTerm(match_labels=(("app", "db"),))
    groups = [apis.PodGroup(name="db", queue="q", min_member=1),
              apis.PodGroup(name="web", queue="q", min_member=1)]
    pods = [_pod(apis, "db-0", "db", 9.0, labels={"app": "db"}),
            _pod(apis, "web-0", "web", pod_affinity=[term])]
    return _attr(apis, nodes, groups, pods)


def _running_match(apis):
    nodes = [apis.Node(name=f"n{i}",
                       allocatable=apis.ResourceVec(3.0, 64.0, 256.0))
             for i in range(3)]
    term = apis.PodAffinityTerm(match_labels=(("app", "db"),))
    groups = [apis.PodGroup(name="run", queue="q", min_member=1,
                            last_start_timestamp=0.0),
              apis.PodGroup(name="db", queue="q", min_member=1),
              apis.PodGroup(name="web", queue="q", min_member=1)]
    pods = [_pod(apis, "run-0", "run", labels={"app": "db"},
                 status=apis.PodStatus.RUNNING, node="n0"),
            _pod(apis, "db-0", "db", labels={"app": "db"}),
            _pod(apis, "web-0", "web", pod_affinity=[term])]
    return _attr(apis, nodes, groups, pods)


def _racks4(apis, n, accel=1.0):
    return _hosts(apis, n, accel, lambda i: {"rack": f"r{i // 2}",
                                              "host": f"n{i}"})


def _self_bootstrap(apis):
    topo = apis.Topology("t", levels=["rack", "host"])
    term = apis.PodAffinityTerm(match_labels=(("app", "peer"),),
                                topology_key="rack")
    groups = [apis.PodGroup(name="peers", queue="q", min_member=2)]
    pods = [_pod(apis, f"peer-{i}", "peers", labels={"app": "peer"},
                 pod_affinity=[term]) for i in range(2)]
    return _attr(apis, _racks4(apis, 6), groups, pods, topo)


def _mixed_anchor(apis):
    nodes = [apis.Node(name=f"n{i}",
                       allocatable=apis.ResourceVec(1.0, 64.0, 256.0))
             for i in range(4)]
    term = apis.PodAffinityTerm(match_labels=(("app", "db"),))
    groups = [apis.PodGroup(name="mixed", queue="q", min_member=2),
              apis.PodGroup(name="web", queue="q", min_member=1)]
    pods = [_pod(apis, "mixed-0", "mixed", labels={"app": "db"}),
            _pod(apis, "mixed-1", "mixed"),
            _pod(apis, "web-0", "web", pod_affinity=[term])]
    return _attr(apis, nodes, groups, pods)


def _self_fold(apis):
    topo = apis.Topology("t", levels=["rack", "host"])
    term = apis.PodAffinityTerm(match_labels=(("app", "peer"),),
                                topology_key="rack")
    groups = [apis.PodGroup(
        name="peers", queue="q", min_member=3,
        topology_constraint=apis.TopologyConstraint(
            topology="t", required_level="host"))]
    pods = [_pod(apis, f"peer-{i}", "peers", labels={"app": "peer"},
                 pod_affinity=[term]) for i in range(3)]
    return _attr(apis, _racks4(apis, 4, 4.0), groups, pods, topo)


def _hostname_self_depender(apis):
    nodes = [apis.Node(name=f"n{i}",
                       allocatable=apis.ResourceVec(1.0, 64.0, 256.0))
             for i in range(4)]
    term = apis.PodAffinityTerm(match_labels=(("app", "db"),))
    groups = [apis.PodGroup(name="db", queue="q", min_member=2),
              apis.PodGroup(name="web", queue="q", min_member=1)]
    pods = [_pod(apis, f"db-{i}", "db", labels={"app": "db"},
                 pod_affinity=[term]) for i in range(2)]
    pods.append(_pod(apis, "web-0", "web", pod_affinity=[term]))
    return _attr(apis, nodes, groups, pods)


def _self_anchor_running(apis):
    topo = apis.Topology("t", levels=["rack", "host"])
    term = apis.PodAffinityTerm(match_labels=(("app", "db"),),
                                topology_key="rack")
    groups = [apis.PodGroup(name="run", queue="q", min_member=1,
                            last_start_timestamp=0.0),
              apis.PodGroup(name="fill", queue="q", min_member=1,
                            last_start_timestamp=0.0),
              apis.PodGroup(name="selfg", queue="q", min_member=1),
              apis.PodGroup(name="web", queue="q", min_member=1)]
    pods = [_pod(apis, "run-0", "run", labels={"app": "db"},
                 status=apis.PodStatus.RUNNING, node="n0"),
            _pod(apis, "fill-0", "fill", status=apis.PodStatus.RUNNING,
                 node="n1"),
            _pod(apis, "self-0", "selfg", labels={"app": "db"},
                 pod_affinity=[term]),
            _pod(apis, "web-0", "web", pod_affinity=[term])]
    return _attr(apis, _racks4(apis, 4), groups, pods, topo)


#: the reference's affinity tests' inputs (``tests/test_taints_affinity.py``
#: ``TestCrossGangAntiAffinity``, ``TestInCycleExclusion``,
#: ``TestInCycleAttraction``), built with an API module
REF_CASES = {
    "cross_gang_hostname": _cross_gang,
    "cross_gang_rack": lambda apis: _cross_gang(apis, True, "rack"),
    "asymmetric_anti": _asymmetric,
    "pending_nodeports": _nodeports,
    "port_replicas_spread": _port_replicas,
    "reverse_anti_vs_running": _reverse_anti,
    "reclaim_respects_anti": _reclaim_anti,
    "six_terms": _six_terms,
    "anchor_depender_node": _anchor_node,
    "anchor_depender_rack": _anchor_rack,
    "depender_without_anchor": _no_anchor,
    "depender_joins_running": _running_match,
    "self_match_bootstrap": _self_bootstrap,
    "mixed_label_anchor": _mixed_anchor,
    "self_fold_stricter_level": _self_fold,
    "hostname_self_with_depender": _hostname_self_depender,
    "self_anchor_running_match": _self_anchor_running,
}

#: allocate only; the five default actions with the sequential victim
#: engine; and at the default VictimConfig (reclaim and preempt chunked)
MODES = {"allocate": None, "sequential": 1, "default": 64}


def _record_tables(monkeypatch, module, seen: list):
    """Wrap every registered action of a scheduler module so the cycle
    records ``anti_used`` after each action (the reference then runs its
    actions one program each instead of one fused program)."""
    reg = dict(module._ACTION_REGISTRY)

    def wrap(name, builder):
        def build():
            act = builder()

            def run(session, result):
                act(session, result)
                seen.append((name, np.asarray(result.tensors.anti_used)))
            return run
        return build
    monkeypatch.setattr(module, "_ACTION_REGISTRY",
                        {k: wrap(k, b) for k, b in reg.items()})


def _configs(mode: str, allocate_batch: int | None = None,
             victim_batch: int | None = None):
    """The reference's and the port's SchedulerConfig for ``mode``, with
    the allocate or victim wavefront width set where given."""
    width = victim_batch or MODES[mode]
    ref_s, port_s = RefSessionConfig(), SessionConfig()
    if allocate_batch is not None:
        ref_s = dataclasses.replace(ref_s, allocate=RefAllocateConfig(
            batch_size=allocate_batch))
        port_s = dataclasses.replace(port_s, allocate=A.AllocateConfig(
            batch_size=allocate_batch))
    if width is None:
        return (RefSchedulerConfig(actions=("allocate",), incremental=False,
                                   analytics_every=0, repack_enable=False,
                                   session=ref_s),
                SchedulerConfig(actions=("allocate",), session=port_s))
    ref_s = dataclasses.replace(ref_s, victims=RefVictimConfig(
        batch_size=width))
    port_s = dataclasses.replace(port_s, victims=VictimConfig(
        batch_size=width))
    return (RefSchedulerConfig(incremental=False, analytics_every=0,
                               repack_enable=False, session=ref_s),
            SchedulerConfig(actions=DEFAULT_ACTIONS, session=port_s))


def run_cycle_pair(objs, mode: str, seen: dict, monkeypatch, **widths):
    """One cycle of ``objs`` (built with the reference's API) on both
    packages in ``mode`` (``widths``: see :func:`_configs`), ``anti_used``
    recorded after every action; the port's refusal (by name) where it
    has not ported the config.  Returns ``(want, got)``, or None when
    refused."""
    ref_cfg, port_cfg = _configs(mode, **widths)
    ref_cluster = RefCluster.from_objects(*objs)
    cluster = _port_cluster(ref_cluster)
    if MODES[mode] is not None:
        _, index = ref_cs.build_snapshot(*ref_cluster.snapshot_lists(),
                                         pad=32, now=ref_cluster.now)
        auto = ref_session._auto_tune(ref_cfg.session, index, 32, 32)
        reason = (_refusal(auto.allocate) or _refusal(
            auto.victims.placement, check_placement_ported))
        if reason is not None:
            with pytest.raises(NotImplementedError, match=re.escape(reason)):
                Scheduler(port_cfg, device="cpu").run_once(cluster)
            return None
    ref_tabs, port_tabs = [], []
    _record_tables(monkeypatch, ref_scheduler, ref_tabs)
    _record_tables(monkeypatch, port_scheduler, port_tabs)
    want = RefScheduler(ref_cfg).run_once(ref_cluster)
    got = Scheduler(port_cfg, device="cpu").run_once(cluster)
    assert got.packed.tobytes() == seen["packed"].tobytes()
    for field in ("bind_requests", "evictions", "move_bind_requests"):
        assert [dataclasses.asdict(b) for b in getattr(got, field)] == \
            [dataclasses.asdict(b) for b in getattr(want, field)], field
    assert [n for n, _ in port_tabs] == [n for n, _ in ref_tabs]
    for (name, a), (_, b) in zip(ref_tabs, port_tabs):
        assert_bits(a, b, f"anti_used after {name}")
    return want, got


def _pods_by_node(res) -> dict:
    return {b.pod_name: b.selected_node for b in res.bind_requests}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(REF_CASES))
def test_reference_affinity_inputs_cycle_bit_equal(name, mode, pad32,
                                                   monkeypatch):
    out = run_cycle_pair(REF_CASES[name](ref_apis), mode, pad32,
                         monkeypatch)
    if out is None:
        return
    want, got = out
    by_pod = _pods_by_node(got)
    if name == "cross_gang_hostname":
        assert len(set(by_pod.values())) == len(by_pod) == 3
    if name == "reclaim_respects_anti" and mode != "allocate":
        placed = got.tensors.placements.numpy()
        rows = [p[p >= 0][0] for p in placed if (p >= 0).any()]
        assert len(got.evictions) >= 2 and len(set(rows)) == len(rows) == 2
    if name == "anchor_depender_node":
        assert by_pod["web-0"] == by_pod["db-0"]


def test_reference_cases_exercise_both_gates_and_the_victims():
    """Most cases reach the anti gate, six the attract gate (one of them
    with a required level: K3's mask mode under its topology mode), and
    the victim actions run (rather than refuse) on all but four."""
    flags, refused = [], 0
    for build in REF_CASES.values():
        c = RefCluster.from_objects(*build(ref_apis))
        _, index = ref_cs.build_snapshot(*c.snapshot_lists(), pad=32)
        auto = ref_session._auto_tune(RefSessionConfig(), index, 32, 32)
        flags.append((auto.allocate.anti_groups, auto.allocate.attract_groups))
        refused += _refusal(auto.victims.placement,
                            check_placement_ported) is not None
    assert sum(a for a, _ in flags) >= 12 and sum(t for _, t in flags) >= 6
    assert refused <= 4


# ---------------------------------------------------------------------------
# the card cells' fleets at 256 nodes
# ---------------------------------------------------------------------------

def _fleet(apis, make, cell: str):
    if cell == "affinity":
        return fleets.affinity_objects(
            apis, make, num_nodes=256, node_accel=8.0, num_gangs=120,
            tasks_per_gang=8, services=16, anchors=24, dependers=24,
            port_gangs=40)
    if cell == "affinity_reclaim":
        return fleets.affinity_reclaim_objects(
            apis, make, services=8, num_nodes=256, node_accel=4.0,
            num_gangs=160, tasks_per_gang=8, running_fraction=0.8,
            queue_accel_quota=30.0, partition_queues_by_running=True)
    return fleets.affinity_sharing_objects(
        apis, num_nodes=256, shared_nodes=128, fractions=96, services=8,
        port_gangs=24) + (None,)


@pytest.mark.parametrize("B", [1, 8, 64, 256])
@pytest.mark.parametrize("cell", ["affinity", "affinity_reclaim",
                                  "affinity_sharing"])
def test_chip_cell_fleets_bit_equal(cell, B, pad32, monkeypatch):
    """The card cells' shapes at 256 nodes: allocate only on the uniform
    path (``affinity``) and on the per-task path (``affinity_sharing``)
    at ``B`` allocate lanes, the five default actions with ``B`` victim
    lanes on the saturated shape (``affinity_reclaim``); every placed pod
    pair with a mutual anti term on distinct hosts, every depender beside
    its anchor (``chip_smoke.affinity_violations``, the card's check: on
    the bound pods, and on reclaim's pipelined placements too)."""
    objs = _fleet(ref_apis, ref_make, cell)
    port_objs = _fleet(port_apis, port_make, cell)
    assert [p.name for p in port_objs[3]] == [p.name for p in objs[3]]
    if cell == "affinity_reclaim":
        _, got = run_cycle_pair(objs, "default", pad32, monkeypatch,
                                victim_batch=B)
        assert got.evictions
    else:
        _, got = run_cycle_pair(objs, "allocate", pad32, monkeypatch,
                                allocate_batch=B)
    cluster = RefCluster.from_objects(*objs)
    placed = {b.pod_name: b.selected_node for b in got.bind_requests}
    if cell == "affinity_reclaim":
        # reclaim's placements are pipelined (no BindRequest): decode them
        # with the snapshot's name tables
        _, index = ref_cs.build_snapshot(*cluster.snapshot_lists(), pad=32,
                                         now=cluster.now)
        pl = got.tensors.placements.numpy()
        placed.update({index.task_names[gi][t]: index.node_names[pl[gi, t]]
                       for gi, t in zip(*np.nonzero(pl >= 0))})
    bad, counts = affinity_violations(cluster.pods, placed)
    assert not bad, bad[:3]
    assert counts["pods"]
