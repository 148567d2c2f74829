"""MIG and other extended scalar resources (``extended=True``) through the
port's per-task allocate path and the four victim actions, against the
JAX reference, on the CPU, where the kernels run their plain versions:

- K9's extended mode (``attempt_gang_in_domain_plain`` with ``ext`` and
  ``ext_extra``) against the reference's ``_attempt_gang_in_domain`` with
  ``extended=True``, vmapped over lanes as the allocate chunk runs it
  (prior placements, quotas, the shared extended credit) and as the dense
  victim wavefront runs it (per-lane extended credit, the legacy
  protocol): E = 3 — two MIG profiles and one fractional non-MIG key,
  whose g-number is 0 — with an idle fit, a fit only through
  ``extended_releasing`` and a queue gate hit through the g-number
  equivalents alone;
- K8's extended table (``freed_by_lane_plain(..., extended=True)``)
  against the reference's ``_freed_by_lane(..., extended=True)`` at 1, 8
  and 40 lanes, composed and not; the stale pass's extended credit (K6's
  [N, E] table);
- whole cycles on a small ``fleets.mig_reclaim_objects`` fleet through
  both Schedulers: allocate alone, and the five default actions with the
  sequential victim engine and at the default (chunked) config — the
  packed commit byte for byte, BindRequests, evictions, move rebinds.

Inputs are made from a seed with numpy; both packages build them with
their own API objects."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.ops.victims as RV
import kai_scheduler_tpu.state.cluster_state as ref_cs
from kai_scheduler_tpu.apis import types as ref_apis
from kai_scheduler_tpu.framework.scheduler import Scheduler as RefScheduler
from kai_scheduler_tpu.framework.scheduler import \
    SchedulerConfig as RefSchedulerConfig
from kai_scheduler_tpu.framework.session import Session as RefSession
from kai_scheduler_tpu.framework.session import \
    SessionConfig as RefSessionConfig
from kai_scheduler_tpu.ops import allocate as RA
from kai_scheduler_tpu.ops.allocate import init_result as ref_init
from kai_scheduler_tpu.ops.stale import stale_gang_eviction as ref_stale
from kai_scheduler_tpu.ops.victims import VictimConfig as RefVictimConfig
from kai_scheduler_tpu.runtime.cluster import Cluster as RefCluster
from kai_scheduler_tpu_torch.apis import types as port_apis
from kai_scheduler_tpu_torch.framework.scheduler import (DEFAULT_ACTIONS,
                                                         Scheduler,
                                                         SchedulerConfig)
from kai_scheduler_tpu_torch.framework.session import SessionConfig
from kai_scheduler_tpu_torch.ops import allocate as A
from kai_scheduler_tpu_torch.ops import stale as S
from kai_scheduler_tpu_torch.ops import victims as V
from kai_scheduler_tpu_torch.ops.scoring import PlacementConfig
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from kai_scheduler_tpu_torch.state import state_from_numpy
from kai_scheduler_tpu_torch.state.fleets import mig_reclaim_objects
from test_torch_allocate import ref_leaves
from test_torch_cycle import pad32  # noqa: F401
from test_torch_pertask import assert_bits, dense
from test_torch_victims import assert_results_equal

from jax_executables import release_jax_executables  # noqa: F401

MIG_1G, MIG_3G = "nvidia.com/mig-1g.10gb", "nvidia.com/mig-3g.40gb"
#: a fractional extended scalar that is not a MIG profile (g-number 0)
VF = "example.com/vf-share"


def mig_objects(apis, seed: int, num_nodes: int = 16, num_gangs: int = 40):
    """A small mixed fleet with E = 3: 1g nodes (14 slices, a fractional
    ``VF`` capacity on some), 3g nodes (4 slices) and whole-GPU nodes;
    running one-slice pods in the first two leaves (every 3g slice
    held), a third of them terminating (releasing slices: tasks that land
    there pipeline); one department of three leaves, the last with an
    accel limit two above its allocation (its MIG gangs hit
    the limit gate through their g-number equivalents); pending one-slice
    1g and 3g gangs, 3-pod 1g gangs, VF shares (0.25, 0.5), a 1g + VF
    pair and whole-GPU gangs."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(num_nodes):
        kind = i % 3
        ext = ({MIG_1G: 14.0} if kind == 0 else
               {MIG_3G: 4.0} if kind == 1 else {})
        if kind == 0 and i % 2 == 0:
            ext[VF] = 1.5
        nodes.append(apis.Node(
            f"node-{i}", apis.ResourceVec(0.0 if kind < 2 else 4.0, 32.0,
                                          128.0),
            labels={"kubernetes.io/hostname": f"node-{i}"},
            accel_memory_gib=80.0, extended=ext))
    leaves = ["q-a", "q-b", "q-lim"]
    queues = [apis.Queue("dept", accel=apis.QueueResource(quota=-1.0))]
    queues += [apis.Queue(q, parent="dept",
                          accel=apis.QueueResource(
                              quota=40.0, limit=8.0 if q == "q-lim"
                              else -1.0)) for q in leaves]
    groups, pods = [], []

    def gang(name, queue, specs, *, running_on=None, status=None, prio=0,
             created=0.0, **kw):
        groups.append(apis.PodGroup(
            name, queue=queue, min_member=len(specs), priority=prio,
            creation_timestamp=created,
            last_start_timestamp=0.0 if running_on else None, **kw))
        for t, spec in enumerate(specs):
            pod = apis.Pod(f"{name}-{t}", name, creation_timestamp=created,
                           **spec)
            if running_on:
                pod.status, pod.node = status, running_on
            pods.append(pod)

    def mig(key, v=1.0, cpu=1.0):
        return dict(resources=apis.ResourceVec(0.0, cpu, 4.0),
                    extended={key: v})
    for i in range(num_nodes):
        kind = i % 3
        if kind == 2:
            continue
        key, cap = (MIG_1G, 14) if kind == 0 else (MIG_3G, 4)
        # every 3g slice is held: a 3g task fits only on releasing ones
        for j in range(cap if kind == 1 else int(cap * rng.uniform(0.5, 1))):
            status = (apis.PodStatus.RELEASING if (i + j) % 3 == 0
                      else apis.PodStatus.RUNNING)
            gang(f"run-{i}-{j}", leaves[(i + j) % 2], [mig(key)],
                 running_on=f"node-{i}", status=status)
    # the limited leaf sits at 6 of its 8: two more slices' g-numbers
    # (or one 3g) reach its limit
    gang("lim-run", "q-lim", [mig(MIG_1G)] * 6, running_on="node-0",
         status=apis.PodStatus.RUNNING)
    for g in range(num_gangs):
        kind = int(rng.integers(0, 7))
        q = leaves[g % 3]
        kw = dict(prio=int(rng.integers(0, 3)), created=float(g))
        if g % 4 == 3:
            kw["preemptibility"] = apis.Preemptibility.NON_PREEMPTIBLE
        if kind == 0:
            specs = [mig(MIG_1G)]
        elif kind == 1:
            specs = [mig(MIG_3G)]
        elif kind == 2:
            specs = [mig(MIG_1G)] * 3
        elif kind == 3:
            specs = [mig(VF, float(rng.choice([0.25, 0.5])))]
        elif kind == 4:
            specs = [mig(MIG_1G), mig(VF, 0.25)]
        elif kind == 5:
            specs = [dict(resources=apis.ResourceVec(1.0, 2.0, 8.0))] * 2
        else:
            specs = [mig(MIG_3G, cpu=2.0)] * 2
        gang(f"gang-{g}", q, specs, **kw)
    return nodes, queues, groups, pods


@dataclasses.dataclass
class Lanes:
    ref_state: object
    port_state: object
    config: object
    num_levels: int
    cand: np.ndarray
    prior: np.ndarray
    quota: np.ndarray
    pools: dict


@functools.lru_cache(maxsize=None)
def make_lanes(seed: int, B: int) -> Lanes:
    """One chunk's lanes on the MIG snapshot: random gangs, a third with a
    prior placement; the chunk-start pools spent a little (cpu) and an
    extended credit on a few nodes (victim-freed slices)."""
    rng = np.random.default_rng(seed)
    state, index = ref_cs.build_snapshot(*mig_objects(ref_apis, seed),
                                         pad=32)
    ses = RefSession.from_state(state, index, RefSessionConfig())
    st = ses.state
    cfg = ses.config.allocate
    assert cfg.extended and not cfg.uniform_tasks
    g, n = st.gangs, st.nodes
    G, T = g.task_valid.shape
    nn, ng = len(index.node_names), len(index.gang_names)
    assert len(index.extended_keys) == 3
    free = np.asarray(n.free).copy()
    free[:nn, 1] = np.maximum(free[:nn, 1] - rng.integers(0, 4, nn), 0.0)
    ext = np.asarray(n.extended_free).copy()
    ext_extra = np.zeros_like(ext)
    ext_extra[rng.choice(nn, 3, replace=False)] += np.float32(1.0)
    cand = rng.integers(0, ng, B).astype(np.int32)
    # two lanes on the limited leaf's gangs of 3 g-numbers or more
    lim = int(np.nonzero(np.asarray(st.queues.limit[:, 0]) == 8.0)[0][0])
    gq = (np.asarray(g.task_extended) * np.asarray(g.ext_accel)).sum((1, 2))
    big = np.nonzero((np.asarray(g.queue) == lim) & (gq > 2)
                     & (np.arange(G) < ng))[0]
    cand[2:4][:min(B - 2, 2)] = big[:2][:max(0, min(B - 2, 2))]
    prior = np.full((B, T), -1, np.int32)
    for b in range(0, B, 3):
        valid_t = np.nonzero(np.asarray(g.task_valid[cand[b]]))[0]
        if len(valid_t) > 1:
            prior[b, valid_t[0]] = int(rng.integers(0, nn))
    quota_b = np.maximum(np.asarray(g.min_needed)[cand]
                         - (prior >= 0).sum(-1), 1).astype(np.int32)
    pools = dict(free=free, dev=np.asarray(n.device_free),
                 extra=np.zeros_like(free),
                 extra_dev=np.zeros_like(np.asarray(n.device_free)),
                 qa=np.asarray(st.queues.allocated),
                 qan=np.asarray(st.queues.allocated_nonpreemptible),
                 ext=ext, ext_extra=ext_extra)
    return Lanes(st, state_from_numpy(ref_leaves(st), "cpu"), cfg,
                 ses.config.num_levels, cand, prior, quota_b, pools)


def ref_attempts(ln: Lanes, lane_extra: np.ndarray | None = None):
    """The reference's attempt for every lane: the allocate chunk's call
    (prior placements, quota, shared credit), or with ``lane_extra`` [B,
    N, E] the dense victim wavefront's (per-lane extended credit, the
    legacy protocol)."""
    st, cfg = ln.ref_state, ln.config
    p = {k: jnp.asarray(v) for k, v in ln.pools.items()}
    chain = RA._chain_membership(st.queues.parent, ln.num_levels)

    def one(gi, lane, prior, quota, xe):
        pl = st.gangs.preferred_level[gi]
        kw = (dict(prior_nodes=prior, quota=quota) if lane_extra is None
              else {})
        return RA._attempt_gang_in_domain(
            st, gi, p["free"], p["dev"], p["qa"], p["qan"], ln.num_levels,
            cfg, st.nodes.valid, st.nodes.topology[:, jnp.maximum(pl, 0)],
            pl >= 0, p["extra"], p["extra_dev"], lane, chain,
            ext_free=p["ext"], extra_extended_releasing=xe, **kw)
    B = ln.cand.shape[0]
    xe = (jnp.broadcast_to(p["ext_extra"], (B,) + ln.pools["ext"].shape)
          if lane_extra is None else jnp.asarray(lane_extra))
    out = jax.jit(jax.vmap(one))(ln.cand, jnp.arange(B, dtype=jnp.int32),
                                 ln.prior, ln.quota, xe)
    return [np.asarray(o) for o in out]


def port_attempts(ln: Lanes, lane_extra: np.ndarray | None = None):
    st = ln.port_state
    q = st.queues
    t = {k: torch.from_numpy(np.array(v)) for k, v in ln.pools.items()}
    inf = float("inf")
    legacy = lane_extra is not None
    return A.attempt_gang_in_domain_plain(
        st.nodes, A.TaskTables.of(st), torch.from_numpy(ln.cand),
        torch.full_like(torch.from_numpy(ln.prior), -1) if legacy
        else torch.from_numpy(ln.prior), t["free"], t["dev"], t["qa"],
        t["qan"], t["extra"], t["extra_dev"],
        A._chain_membership(q.parent, ln.num_levels),
        torch.where(q.limit <= -0.5, inf, q.limit),
        torch.where(q.quota <= -0.5, inf, q.quota),
        placement=PlacementConfig(), track_devices=ln.config.track_devices,
        legacy=legacy, ext=t["ext"],
        ext_extra=(t["ext_extra"] if lane_extra is None
                   else torch.from_numpy(lane_extra)))


def _assert_attempts(want, got: A.PerTaskOut, ln: Lanes):
    (free2, _, qa2, qan2, nodes_t, dev_t, pipe_t, success, bind, _, ext2,
     ext_bind) = want[:12]
    for what, a, b in (("nodes_t", nodes_t, got.nodes_t),
                       ("dev_t", dev_t, got.dev_t),
                       ("pipe_t", pipe_t, got.pipe_t),
                       ("success", success, got.success),
                       ("qa2", qa2, got.qa2), ("qan2", qan2, got.qan2)):
        assert_bits(a, b.numpy(), what)
    p = ln.pools
    assert_bits(free2, dense(p["free"], got, got.free_rows), "free2")
    assert_bits(bind, dense(np.zeros_like(p["free"]), got, got.bind_rows),
                "bind")
    assert_bits(ext2, dense(p["ext"], got, got.ext_rows), "ext2")
    assert_bits(ext_bind, dense(np.zeros_like(p["ext"]), got,
                                got.extbind_rows), "ext_bind")


@pytest.mark.parametrize("seed", [0, 1])
def test_pertask_fill_extended_bit_equal(seed):
    """The allocate chunk's lanes with the extended pools: an idle fit, a
    fit only through ``extended_releasing`` (pipelined), the limit gate
    hit through the g-number equivalents alone."""
    ln = make_lanes(seed, 48)
    want = ref_attempts(ln)
    got = port_attempts(ln)
    _assert_attempts(want, got, ln)
    placed = got.nodes_t >= 0
    te = ln.port_state.gangs.task_extended[torch.from_numpy(ln.cand)]
    on_ext = placed & (te.sum(-1) > 0)
    assert bool((on_ext & ~got.pipe_t).any()) and bool(
        (on_ext & got.pipe_t).any())
    # a lane of the limited leaf (6 of its 8 held) whose MIG gang, with
    # no accel request, fails: its g-number equivalents pass the limit
    g = ln.port_state.gangs
    lim = int(np.nonzero(np.asarray(ln.port_state.queues.limit[:, 0]) == 8.0)
              [0][0])
    cand = torch.from_numpy(ln.cand).long()
    gated = ((g.queue[cand] == lim) & ~got.success
             & (g.task_req[cand, :, 0].sum(-1) == 0)
             & ((te * g.ext_accel).sum((-1, -2)) > 2))
    assert bool(gated.any())
    assert bool(got.success.any())


@pytest.mark.parametrize("B", [1, 8, 37])
def test_pertask_lanes_mode_extended_bit_equal(B):
    """The dense victim wavefront's lanes: per-lane extended credit
    [B, N, E] on a few nodes each, the legacy protocol."""
    ln = make_lanes(2, max(B, 2))
    ln = dataclasses.replace(ln, cand=ln.cand[:B], prior=np.full_like(
        ln.prior[:B], -1), quota=ln.quota[:B])
    rng = np.random.default_rng(B)
    xe = np.repeat(ln.pools["ext_extra"][None], B, 0)
    nn = int(ln.port_state.nodes.valid.sum())
    for b in range(B):
        xe[b, rng.choice(nn, 2, replace=False)] += np.float32(
            rng.choice([1.0, 2.0]))
    want = ref_attempts(ln, xe)
    got = port_attempts(ln, xe)
    _assert_attempts(want, got, ln)
    if B > 1:
        assert bool((got.nodes_t >= 0).any())


# ---------------------------------------------------------------------------
# K8: the extended table
# ---------------------------------------------------------------------------

#: the small mig_reclaim fleet: 20 nodes (6 of 1g, 6 of 2g, 2 of 3g, 6
#: whole; nodes 16-19, a 3g node among them, the tainted pool), 14
#: one-slice gangs, 2 pairs, 2 training gangs, 4 urgent, 1 stale gang
FLEET = dict(num_nodes=20, inference=14, pairs=2, training=2, urgent=4,
             stale=1, pool_nodes=0.2)

_ref_freed_by_lane = jax.jit(RV._freed_by_lane, static_argnames=(
    "B", "compose", "track_devices", "extended"))


@functools.lru_cache(maxsize=None)
def mig_snap():
    nodes, queues, groups, pods, now = mig_reclaim_objects(ref_apis,
                                                           **FLEET)
    state, index = ref_cs.build_snapshot(nodes, queues, groups, pods,
                                         pad=32, now=now)
    ses = RefSession.from_state(state, index, RefSessionConfig())
    return (ses.state, state_from_numpy(ref_leaves(ses.state), "cpu"),
            ses.config)


@pytest.mark.parametrize("compose", [True, False])
@pytest.mark.parametrize("B", [1, 8, 40])
def test_freed_by_lane_extended_table_bit_equal(compose, B):
    """Every output of K8 with the extended table bit-equal to the
    reference's: each live pod's MIG slices summed at (lane, node) in pod
    order, composed over lanes or not."""
    ref, port, cfg = mig_snap()
    assert cfg.allocate.extended
    M = port.running.m
    rng = np.random.default_rng(B + 7 * compose)
    lane = np.where(rng.random(M) < 0.7, rng.integers(0, B, M),
                    B).astype(np.int32)
    lane = np.where(np.asarray(ref.running.valid), lane, B)
    rchain = RA._chain_membership(ref.queues.parent, cfg.num_levels)
    chain = A._chain_membership(port.queues.parent, cfg.num_levels)
    want_n, want_d, want_q, want_e, want_own = _ref_freed_by_lane(
        ref, jnp.asarray(lane), B=B, chain=rchain, compose=compose,
        track_devices=cfg.allocate.track_devices, extended=True)
    got_n, got_d, got_q, got_own, got_e = V.freed_by_lane(
        port, torch.from_numpy(lane), B, chain, compose=compose,
        devices=cfg.allocate.track_devices, extended=True)
    for what, a, b in (("freed_nodes", want_n, got_n),
                       ("freed_queues", want_q, got_q),
                       ("own_incr", want_own, got_own),
                       ("freed_extended", want_e, got_e)):
        assert_bits(np.asarray(a), b.numpy(), what)
    assert float(got_e.sum()) > 0
    assert V.freed_by_lane(port, torch.from_numpy(lane), B, chain,
                           compose=compose)[4] is None


def test_stale_pass_extended_bit_equal():
    """The stale pass on the MIG fleet: the stale gang's slices (K6's
    [N, E] table) return to the releasing extended pool as the reference
    credits them; every ``AllocationResult`` field bit-equal."""
    ref, port, cfg = mig_snap()
    want = jax.device_get(ref_stale(ref, ref_init(ref),
                                    num_levels=cfg.num_levels))
    got = S.stale_gang_eviction(port, A.init_result(port),
                                num_levels=cfg.num_levels)
    assert_results_equal(want, got)
    assert float(got.extended_releasing_extra.sum()) > 0


# ---------------------------------------------------------------------------
# whole cycles
# ---------------------------------------------------------------------------

def _clusters():
    out = []
    for apis, cls in ((ref_apis, RefCluster), (port_apis, Cluster)):
        nodes, queues, groups, pods, now = mig_reclaim_objects(apis,
                                                               **FLEET)
        c = cls.from_objects(nodes, queues, groups, pods)
        c.now = now
        out.append(c)
    return out


@pytest.mark.parametrize("actions,B", [
    pytest.param(("allocate",), 1, id="allocate"),
    pytest.param(DEFAULT_ACTIONS, 1, id="five_actions-sequential"),
    pytest.param(DEFAULT_ACTIONS, V.VictimConfig().batch_size,
                 id="five_actions-default")])
def test_mig_reclaim_cycle_bit_equal(actions, B, pad32):
    """One cycle of the small fleet through both Schedulers: allocate's
    per-task chunks place on the few idle slices and whole nodes (K9 and
    K10 extended); reclaim (K8's extended table and K9's lanes mode when
    chunked), preempt (the urgent 1g gangs), consolidation (MIG victims
    moved into the pool by K7) and the stale pass (K6's extended table)
    do the rest; packed commit, BindRequests, evictions and move rebinds
    equal."""
    ref_cluster, cluster = _clusters()
    cfg = dict(incremental=False, analytics_every=0, repack_enable=False)
    want = RefScheduler(RefSchedulerConfig(
        actions=actions, **cfg, session=RefSessionConfig(
            victims=RefVictimConfig(batch_size=B)))).run_once(ref_cluster)
    got = Scheduler(SchedulerConfig(
        actions=actions, **cfg, session=SessionConfig(
            victims=V.VictimConfig(batch_size=B))), device="cpu").run_once(
        cluster)
    assert got.packed.tobytes() == pad32["packed"].tobytes()
    for field in ("bind_requests", "evictions", "move_bind_requests"):
        assert [dataclasses.asdict(b) for b in getattr(got, field)] == \
            [dataclasses.asdict(b) for b in getattr(want, field)], field
    assert got.bind_requests
    if actions != ("allocate",):
        stats = got.victim_stats
        assert stats["reclaim"].steps > 0 and stats["preempt"].steps > 0
        assert got.evictions
