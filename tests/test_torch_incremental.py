"""The port's journaled incremental snapshot (``state/incremental.py``)
against the JAX reference's on the CPU.

The load-bearing property: a patched host mirror is element-wise
identical to a fresh full build (``verify=True`` asserts it after every
patch) AND, leaf by leaf and byte for byte, to the reference
snapshotter's mirror of the twin cluster under the same churn — with the
same refresh mode and fallback reason every cycle.  Both packages' builds
pad to 32 here (the reference suite's padded builder), so the capacities
match.  Also: the journal and its cursors, the fallbacks by their
reference reasons, the Scheduler with ``verify_incremental``, the
BindRequest sweep, and marks hammered from a thread.  The sharded case
waits for the mesh slice.
"""
import dataclasses
import functools
import threading

import jax
import numpy as np
import pytest

from kai_scheduler_tpu.apis import types as ref_apis
from kai_scheduler_tpu.binder import Binder as RefBinder
from kai_scheduler_tpu.framework.scheduler import Scheduler as RefScheduler
from kai_scheduler_tpu.framework.scheduler import \
    SchedulerConfig as RefSchedulerConfig
from kai_scheduler_tpu.runtime.cluster import Cluster as RefCluster
from kai_scheduler_tpu.state.incremental import \
    IncrementalSnapshotter as RefSnapshotter
from kai_scheduler_tpu.state.synthetic import make_cluster as ref_make
from kai_scheduler_tpu_torch.apis import types as apis
from kai_scheduler_tpu_torch.binder import Binder
from kai_scheduler_tpu_torch.framework.scheduler import (Scheduler,
                                                         SchedulerConfig)
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from kai_scheduler_tpu_torch.state import cluster_state as port_cs
from kai_scheduler_tpu_torch.state import make_cluster
from kai_scheduler_tpu_torch.state.cluster_state import (leaf_paths,
                                                         state_to_numpy)
from kai_scheduler_tpu_torch.state.incremental import (
    IncrementalSnapshotter, MutationJournal)

from jax_executables import release_jax_executables  # noqa: F401

INDEX_FIELDS = ("node_names", "queue_names", "gang_names", "task_names",
                "running_pod_names", "selector_keys", "label_vocab",
                "topology_levels", "needs_device_table", "uniform_gangs",
                "has_required_topology", "has_preferred_topology",
                "has_subgroup_topology", "has_extended_resources",
                "extended_keys", "has_reclaim_minruntime",
                "has_anti_groups", "has_attract_groups", "max_queue_depth",
                "num_leaf_queues", "num_pending_gangs", "num_anti_groups",
                "claims_by_pod", "dense_feasibility")


@pytest.fixture
def pad32(monkeypatch):
    """The port's builds pad to 32, as the reference suite's do."""
    monkeypatch.setattr(port_cs, "build_snapshot", functools.partial(
        port_cs.build_snapshot, pad=32))


def build(num_nodes=8, num_gangs=6, tasks_per_gang=2, **kw) -> Cluster:
    return Cluster.from_objects(*make_cluster(
        num_nodes=num_nodes, num_gangs=num_gangs,
        tasks_per_gang=tasks_per_gang, **kw))


def build_pair(**kw):
    """Twin clusters of both packages from the same seed."""
    kw = dict(dict(num_nodes=8, num_gangs=6, tasks_per_gang=2), **kw)
    return (RefCluster.from_objects(*ref_make(**kw)),
            Cluster.from_objects(*make_cluster(**kw)))


def refresh(snap, cluster):
    return snap.refresh(cluster, now=cluster.now)


def _ref_host(snap) -> dict:
    return {jax.tree_util.keystr(p).lstrip("."): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(snap._host)[0]}


def assert_mirrors_equal(ref_snap, snap, where=""):
    """The two snapshotters' last refresh: the same mode and fallback
    reason, the host mirrors byte-equal leaf by leaf, the same index."""
    for k in ("mode", "fallback_reason", "dirty_pods", "dirty_gangs",
              "leaves_shipped", "bytes_shipped"):
        assert snap.stats.last[k] == ref_snap.stats.last[k], (where, k)
    assert snap.stats.fallbacks == ref_snap.stats.fallbacks, where
    if ref_snap._host is None:
        assert snap._host is None, where
        return
    want = _ref_host(ref_snap)
    assert list(want) == leaf_paths()
    for p in leaf_paths():
        a, b = snap._host[p], np.asarray(want[p])
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (where, p)
        assert a.tobytes() == b.tobytes(), (where, p)
    for f in INDEX_FIELDS:
        assert getattr(snap._index, f) == getattr(ref_snap._index, f), \
            (where, f)
    # the device state the port shipped equals its mirror
    dev = state_to_numpy(snap._dev)
    for p in leaf_paths():
        assert dev[p].tobytes() == snap._host[p].tobytes(), (where, p)


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

class TestJournal:
    def test_cursor_consume_resets(self):
        j = MutationJournal()
        cur = j.register()
        j.mark_pod("a")
        j.mark_pod_added("b")
        j.mark_gang("g")
        j.mark_time()
        got = cur.consume()
        assert got.pods_dirty == {"a"}
        assert got.pods_added == ["b"]
        assert got.gangs_dirty == {"g"}
        assert got.time_dirty
        empty = cur.consume()
        assert not empty.pods_dirty and not empty.pods_added
        assert not empty.time_dirty

    def test_multiple_consumers_each_see_all_marks(self):
        j = MutationJournal()
        c1, c2 = j.register(), j.register()
        j.mark_pod("p")
        assert c1.consume().pods_dirty == {"p"}
        assert c2.consume().pods_dirty == {"p"}

    def test_readded_pod_escalates_and_merge_equals_marks(self):
        a, b = MutationJournal(), MutationJournal()
        ca, cb = a.register(), b.register()
        marks = [("pod_removed", "p"), ("pod_added", "p"), ("gang", "g"),
                 ("node", "n"), ("structural", "x"), ("time", "")]
        for kind, name in marks:
            {"pod_removed": a.mark_pod_removed, "pod_added": a.mark_pod_added,
             "gang": a.mark_gang, "node": a.mark_node,
             "structural": a.mark_structural,
             "time": lambda _n: a.mark_time()}[kind](name)
        b.merge(marks)
        ga, gb = ca.consume(), cb.consume()
        assert ga.structural == gb.structural == ["pod-readded", "x"]
        assert a.generation == b.generation == len(marks)
        for f in ("pods_dirty", "pods_added", "pods_removed", "gangs_dirty",
                  "nodes_dirty", "time_dirty"):
            assert getattr(ga, f) == getattr(gb, f), f
        with pytest.raises(ValueError):
            a.merge([("bogus", "x")])

    def test_cluster_ops_are_journaled(self):
        cluster = build()
        cur = cluster.journal.register()
        pod = next(p for p in cluster.pods.values()
                   if p.status == apis.PodStatus.PENDING)
        cluster.bind_pod(pod.name, list(cluster.nodes)[0])
        cluster.evict_pod(pod.name)
        cluster.tick()
        got = cur.consume()
        assert pod.name in got.pods_dirty
        assert pod.name in got.pods_removed
        assert got.time_dirty
        assert pod.group in got.gangs_dirty  # its gang started

    def test_submit_appends(self):
        cluster = build()
        cur = cluster.journal.register()
        g = apis.PodGroup(name="new-gang", queue="queue-0-0", min_member=1)
        cluster.submit(g, [apis.Pod(name="new-pod", group="new-gang")])
        got = cur.consume()
        assert got.gangs_added == ["new-gang"]
        assert got.pods_added == ["new-pod"]

    def test_binder_marks_every_phase_change(self):
        cluster = build(num_nodes=2, num_gangs=2)
        pend = [p for p in cluster.pods.values()
                if p.status == apis.PodStatus.PENDING]
        cluster.create_bind_request(apis.BindRequest(
            pod_name=pend[0].name, selected_node="node-0"))
        cluster.create_bind_request(apis.BindRequest(
            pod_name="ghost", selected_node="node-0"))
        cur = cluster.journal.register()
        res = Binder().reconcile(cluster)
        assert res.bound == [pend[0].name] and res.failed == ["ghost"]
        assert {pend[0].name, "ghost"} <= cur.consume().pods_dirty

    @pytest.mark.parametrize("how", ["deepcopy", "pickle"])
    def test_copied_cluster_keeps_its_own_journal(self, how):
        """A deep copy (a twin) or a pickled copy (an oracle process's
        result) starts a change feed of its own."""
        import copy
        import pickle
        cluster = build()
        cur = cluster.journal.register()
        twin = (copy.deepcopy(cluster) if how == "deepcopy"
                else pickle.loads(pickle.dumps(cluster)))
        assert twin.journal is not cluster.journal
        assert twin.pods.keys() == cluster.pods.keys()
        twin.tick()
        assert not cur.consume().time_dirty
        twin_cur = twin.journal.register()
        twin.tick()
        assert twin_cur.consume().time_dirty


# ---------------------------------------------------------------------------
# the port's mirror against the reference snapshotter's
# ---------------------------------------------------------------------------

def _pick(cluster, rng, statuses):
    names = [n for n, p in cluster.pods.items() if p.status in statuses]
    return names[int(rng.integers(len(names)))] if names else None


def _churn_op(pair, rng, submitted):
    """One randomized operation, drawn on the port cluster and applied to
    both twins by name."""
    ref_c, c = pair
    op = rng.choice(["bind", "evict", "submit", "tick", "mutate"])
    if op == "bind":
        name = _pick(c, rng, (apis.PodStatus.PENDING,))
        node = f"node-{rng.integers(8)}"
        if name is not None:
            for cl in pair:
                try:
                    cl.bind_pod(name, node)
                except RuntimeError:
                    pass
    elif op == "evict":
        name = _pick(c, rng, (apis.PodStatus.BOUND, apis.PodStatus.RUNNING))
        if name is not None:
            for cl in pair:
                cl.evict_pod(name)
    elif op == "submit":
        submitted[0] += 1
        name = f"extra-{submitted[0]}"
        n = int(rng.integers(1, 3))
        for a, cl in ((ref_apis, ref_c), (apis, c)):
            cl.submit(a.PodGroup(name=name, queue="queue-0-0",
                                 min_member=1),
                      [a.Pod(name=f"{name}-p{i}", group=name,
                             resources=a.ResourceVec(1, 1, 4))
                       for i in range(n)])
    elif op == "tick":
        for cl in pair:
            cl.tick()
    else:
        name = _pick(c, rng, (apis.PodStatus.RUNNING,))
        if name is not None:
            # direct, unjournaled: the drift sweep must catch it
            ref_c.pods[name].status = ref_apis.PodStatus.SUCCEEDED
            c.pods[name].status = apis.PodStatus.SUCCEEDED


@pytest.mark.parametrize("seed", [42, 7, 123, 2024])
def test_randomized_churn_mirror_matches_reference(seed, pad32):
    """Randomized bind/evict/submit/tick/direct-write streams: every
    cycle the port's mirror equals the reference snapshotter's, byte for
    byte, in the same mode; every patch equals a fresh build."""
    rng = np.random.default_rng(seed)
    pair = build_pair(num_gangs=8, running_fraction=0.25,
                      topology_levels=(2, 2), seed=seed % 5)
    ref_snap = RefSnapshotter(verify=True, dirty_threshold=1.0)
    snap = IncrementalSnapshotter(verify=True, dirty_threshold=1.0,
                                  device="cpu")
    refresh(ref_snap, pair[0])
    refresh(snap, pair[1])
    assert_mirrors_equal(ref_snap, snap, "cold")
    submitted = [0]
    for cycle in range(12):
        for _ in range(int(rng.integers(1, 4))):
            _churn_op(pair, rng, submitted)
        refresh(ref_snap, pair[0])
        refresh(snap, pair[1])
        assert_mirrors_equal(ref_snap, snap, cycle)
    assert snap.stats.patched >= 6, snap.stats


def test_patch_through_binder_devices_matches_reference(pad32):
    """Binder-bound pods carry concrete accel devices: the recorded-device
    occupancy path patches identically on both packages."""
    ref_c, c = build_pair(num_nodes=4, num_gangs=4)
    ref_snap = RefSnapshotter(verify=True, dirty_threshold=1.0)
    snap = IncrementalSnapshotter(verify=True, dirty_threshold=1.0,
                                  device="cpu")
    refresh(ref_snap, ref_c)
    refresh(snap, c)
    RefScheduler(RefSchedulerConfig(incremental=False)).run_once(ref_c)
    Scheduler(SchedulerConfig(incremental=False), device="cpu").run_once(c)
    RefBinder().reconcile(ref_c)
    Binder().reconcile(c)
    refresh(ref_snap, ref_c)
    refresh(snap, c)
    assert_mirrors_equal(ref_snap, snap, "bound")
    for cl in (ref_c, c):
        cl.tick()
    refresh(ref_snap, ref_c)
    refresh(snap, c)
    assert_mirrors_equal(ref_snap, snap, "tick")
    assert snap.stats.patched == 2


def test_bind_evict_submit_cycle_patches_identically():
    cluster = build(num_nodes=8, num_gangs=6, tasks_per_gang=2)
    snap = IncrementalSnapshotter(verify=True, dirty_threshold=1.0,
                                  device="cpu")
    refresh(snap, cluster)
    pend = [p for p in cluster.pods.values()
            if p.status == apis.PodStatus.PENDING]
    cluster.bind_pod(pend[0].name, "node-0")
    cluster.bind_pod(pend[1].name, "node-1")
    refresh(snap, cluster)
    cluster.evict_pod(pend[0].name)
    cluster.tick()
    refresh(snap, cluster)
    g = apis.PodGroup(name="late", queue="queue-0-0", min_member=1)
    cluster.submit(g, [apis.Pod(name="late-0", group="late",
                                resources=apis.ResourceVec(1, 1, 4))])
    refresh(snap, cluster)
    assert snap.stats.patched == 3
    assert snap.stats.full_builds == 1


def test_shapes_stay_pinned_and_unchanged_leaves_keep_their_tensors():
    cluster = build(num_nodes=8, num_gangs=6, tasks_per_gang=2)
    snap = IncrementalSnapshotter(dirty_threshold=1.0, device="cpu")
    state0, _ = refresh(snap, cluster)
    pend = [p.name for p in cluster.pods.values()
            if p.status == apis.PodStatus.PENDING]
    for i, name in enumerate(pend[:4]):
        cluster.bind_pod(name, f"node-{i % 8}")
    cluster.tick()
    state1, _ = refresh(snap, cluster)
    assert snap.stats.patched == 1
    a, b = port_cs.state_leaves(state0), port_cs.state_leaves(state1)
    assert [t.shape for t in a.values()] == [t.shape for t in b.values()]
    assert state1.nodes.labels is state0.nodes.labels
    assert state1.nodes.allocatable is state0.nodes.allocatable
    assert state1.running.valid is not state0.running.valid


# ---------------------------------------------------------------------------
# fallbacks, by the reference's reasons
# ---------------------------------------------------------------------------

FALLBACKS = {
    "node-membership-drift": lambda a, cl: cl.nodes.__setitem__(
        "node-extra", a.Node(name="node-extra",
                             allocatable=a.ResourceVec(8, 64, 256))),
    "queue-set-changed": lambda a, cl: cl.queues.__setitem__(
        "q-late", a.Queue(name="q-late", parent="dept-0")),
    "topology-changed": lambda a, cl: setattr(
        cl, "topology", dataclasses.replace(cl.topology)),
    "nonplain-pods": lambda a, cl: cl.submit(
        a.PodGroup(name="frac-gang", queue="queue-0-0", min_member=1),
        [a.Pod(name="frac-pod", group="frac-gang", accel_portion=0.5,
               resources=a.ResourceVec(0, 1, 1))]),
    "structural": lambda a, cl: cl.journal.mark_structural("test"),
    "node-dirty": lambda a, cl: cl.journal.mark_node("node-0"),
}


@pytest.mark.parametrize("reason", sorted(FALLBACKS))
def test_fallbacks_match_reference(reason, pad32):
    pair = build_pair(topology_levels=(2, 2))
    ref_snap = RefSnapshotter(verify=True, dirty_threshold=1.0)
    snap = IncrementalSnapshotter(verify=True, dirty_threshold=1.0,
                                  device="cpu")
    refresh(ref_snap, pair[0])
    refresh(snap, pair[1])
    for a, cl in ((ref_apis, pair[0]), (apis, pair[1])):
        FALLBACKS[reason](a, cl)
    refresh(ref_snap, pair[0])
    refresh(snap, pair[1])
    assert snap.stats.patched == 0
    assert reason in snap.stats.fallbacks
    assert_mirrors_equal(ref_snap, snap, reason)


def test_dirty_threshold_falls_back(pad32):
    ref_c, c = build_pair()
    ref_snap = RefSnapshotter(verify=True, dirty_threshold=0.0)
    snap = IncrementalSnapshotter(verify=True, dirty_threshold=0.0,
                                  device="cpu")
    refresh(ref_snap, ref_c)
    refresh(snap, c)
    name = next(n for n, p in c.pods.items()
                if p.status == apis.PodStatus.PENDING)
    for cl in (ref_c, c):
        cl.bind_pod(name, "node-0")
    refresh(ref_snap, ref_c)
    refresh(snap, c)
    assert "dirty-threshold" in snap.stats.fallbacks
    assert_mirrors_equal(ref_snap, snap, "dirty")


def test_feature_pod_leaves_and_patching_resumes():
    cluster = build()
    snap = IncrementalSnapshotter(verify=True, dirty_threshold=1.0,
                                  device="cpu")
    refresh(snap, cluster)
    FALLBACKS["nonplain-pods"](apis, cluster)
    refresh(snap, cluster)
    assert "nonplain-pods" in snap.stats.fallbacks
    cluster.evict_pod("frac-pod")
    cluster.tick()
    refresh(snap, cluster)
    pod = next(p for p in cluster.pods.values()
               if p.status == apis.PodStatus.PENDING)
    cluster.bind_pod(pod.name, "node-0")
    refresh(snap, cluster)
    assert snap.stats.patched >= 1


# ---------------------------------------------------------------------------
# the Scheduler, the BindRequest sweep
# ---------------------------------------------------------------------------

class TestSchedulerIntegration:
    def test_multi_cycle_e2e_with_verify_incremental(self):
        cluster = build(num_nodes=4, node_accel=8.0, num_gangs=4,
                        tasks_per_gang=2)
        cfg = SchedulerConfig(verify_incremental=True,
                              incremental_dirty_threshold=1.0)
        sched, binder = Scheduler(cfg, device="cpu"), Binder()
        r1 = sched.run_once(cluster)
        assert len(r1.bind_requests) == 8
        assert len(binder.reconcile(cluster).bound) == 8
        cluster.tick()
        assert sched.run_once(cluster).bind_requests == []
        for p in list(cluster.pods.values())[:2]:
            p.status = apis.PodStatus.SUCCEEDED
        cluster.tick()
        g = apis.PodGroup(name="late", queue="queue-0-0", min_member=2)
        cluster.submit(g, [apis.Pod(name=f"late-{i}", group="late",
                                    resources=apis.ResourceVec(1, 1, 4))
                           for i in range(2)])
        r3 = sched.run_once(cluster)
        assert len(r3.bind_requests) == 2
        snap = sched._snapshotter
        assert snap is not None and snap.verify
        assert snap.stats.patched >= 1, snap.stats

    def test_incremental_off_uses_plain_session_open(self):
        cluster = build(num_nodes=4, num_gangs=2)
        sched = Scheduler(SchedulerConfig(incremental=False), device="cpu")
        r = sched.run_once(cluster)
        assert sched._snapshotter is None
        assert len(r.bind_requests) == 4

    def test_a_new_cluster_document_gets_a_new_snapshotter(self):
        sched = Scheduler(device="cpu")
        sched.run_once(build(num_nodes=4, num_gangs=2))
        first = sched._snapshotter
        sched.run_once(build(num_nodes=4, num_gangs=2))
        assert sched._snapshotter is not first


def test_direct_bind_request_clear_is_swept(pad32):
    ref_c, c = build_pair(num_nodes=4, num_gangs=4)
    ref_snap = RefSnapshotter(verify=True, dirty_threshold=1.0)
    snap = IncrementalSnapshotter(verify=True, dirty_threshold=1.0,
                                  device="cpu")
    refresh(ref_snap, ref_c)
    refresh(snap, c)
    name = next(n for n, p in c.pods.items()
                if p.status == apis.PodStatus.PENDING)
    ref_c.create_bind_request(ref_apis.BindRequest(
        pod_name=name, selected_node="node-0"))
    c.create_bind_request(apis.BindRequest(pod_name=name,
                                           selected_node="node-0"))
    refresh(ref_snap, ref_c)
    state, _ = refresh(snap, c)
    assert int(state.running.valid.sum()) == 1
    assert_mirrors_equal(ref_snap, snap, "br")
    for cl in (ref_c, c):
        cl.bind_requests.clear()  # direct, unjournaled
    refresh(ref_snap, ref_c)
    state, _ = refresh(snap, c)
    assert int(state.running.valid.sum()) == 0
    assert_mirrors_equal(ref_snap, snap, "cleared")
    assert snap.stats.patched == 2


# ---------------------------------------------------------------------------
# concurrency: journal marks racing the snapshotter's consume
# ---------------------------------------------------------------------------

class TestJournalConcurrency:
    def test_marks_hammered_from_thread_patched_equals_fresh(self):
        cluster = build(num_nodes=6, num_gangs=4, tasks_per_gang=2)
        snap = IncrementalSnapshotter(device="cpu")
        refresh(snap, cluster)
        pending = [p for p in cluster.pods.values()
                   if p.status == apis.PodStatus.PENDING]
        assert pending
        stop = threading.Event()
        rounds = {"n": 0}

        def hammer():
            # in-place priority bumps + marks: a write the sweep cannot
            # attribute without the journal entry
            i = 0
            while not stop.is_set():
                pod = pending[i % len(pending)]
                pod.priority += 1
                cluster.journal.mark_pod(pod.name)
                cluster.journal.mark_time()
                rounds["n"] += 1
                i += 1

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        for _ in range(15):
            refresh(snap, cluster)
        stop.set()
        t.join(timeout=10)
        assert not t.is_alive()
        assert rounds["n"] > 0
        # with every mark retained, one quiet refresh converges to a
        # fresh full build
        _state, index = refresh(snap, cluster)
        _fs, fresh_index, fresh_host = port_cs.build_snapshot(
            *cluster.snapshot_lists(), device="cpu", now=cluster.now,
            capacity=snap._capacity, return_host=True)
        for p in leaf_paths():
            assert np.array_equal(snap._host[p], fresh_host[p]), p
        assert index.gang_names == fresh_index.gang_names
        assert index.task_names == fresh_index.task_names

    def test_consume_is_atomic_under_concurrent_marks(self):
        j = MutationJournal()
        cur = j.register()
        total = 2000
        seen: set[str] = set()
        done = threading.Event()

        def writer():
            for i in range(total):
                j.mark_pod(f"p{i}")
            done.set()

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        while not done.is_set():
            seen |= cur.consume().pods_dirty
        t.join(timeout=10)
        seen |= cur.consume().pods_dirty
        assert len(seen) == total
