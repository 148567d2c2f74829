"""The port's resident path (``ops/resident.py``, ``resident_cycle``)
against the JAX reference on the CPU.

- ``leaf_layout`` and the group table equal the reference's on the same
  snapshot (the leaf order is the reference's pytree flatten order);
- ``pack_delta`` byte-equal to the reference's on the same host mirrors
  (16 seeds of the reference test's randomized mutation): every ``idx``
  and ``val`` segment, the buckets and the counts; NaN stability, bucket
  hysteresis and the shape-change refusal;
- the plain ``apply_delta`` (K16's oracle) byte-equal to the reference's
  ``apply_delta`` on the same deltas;
- the soak: ``SchedulerConfig(resident=True)`` against the port's
  ``incremental=False`` twin and the reference's ``incremental=False``
  scheduler over 24 churn cycles (BindRequests, evictions and analytics
  documents equal; one ``delta-apply`` upload of the packed delta's bytes
  a resident cycle with zero redundant bytes; one watched call; the
  structural fallback at cycle 11 and the recovery; no late signature
  miss);
- the desync guard, the verify readback, the repack firing on a
  cadence-skipped resident cycle with the port's ``Binder``, and one
  8-node run whose packed commit is byte-equal to the reference's own
  ``resident=True`` cycle (the one test here that runs the reference's
  resident program).
"""
import copy
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.framework.session as ref_session
from kai_scheduler_tpu.apis import types as ref_apis
from kai_scheduler_tpu.binder import Binder as RefBinder
from kai_scheduler_tpu.framework.scheduler import Scheduler as RefScheduler
from kai_scheduler_tpu.framework.scheduler import \
    SchedulerConfig as RefSchedulerConfig
from kai_scheduler_tpu.ops import resident as ref_resident
from kai_scheduler_tpu.runtime.cluster import Cluster as RefCluster
from kai_scheduler_tpu.state.cluster_state import \
    build_snapshot as ref_build_snapshot
from kai_scheduler_tpu.state.synthetic import make_cluster as ref_make
from kai_scheduler_tpu_torch.apis import types as apis
from kai_scheduler_tpu_torch.binder import Binder
from kai_scheduler_tpu_torch.framework.scheduler import (Scheduler,
                                                         SchedulerConfig)
from kai_scheduler_tpu_torch.ops import resident as R
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from kai_scheduler_tpu_torch.runtime.compile_watch import WATCHER
from kai_scheduler_tpu_torch.runtime.wire_ledger import REASON_DELTA_APPLY
from kai_scheduler_tpu_torch.state import cluster_state as port_cs
from kai_scheduler_tpu_torch.state import fleets, make_cluster
from kai_scheduler_tpu_torch.state.cluster_state import (leaf_paths,
                                                         state_from_numpy,
                                                         state_leaves)
from kai_scheduler_tpu_torch.state.incremental import (
    IncrementalSnapshotter, IncrementalVerifyError)
import test_repack as ref_repack_tests
from test_torch_scenarios import _port_cluster

from jax_executables import release_jax_executables  # noqa: F401


# ---------------------------------------------------------------------------
# pack and apply against the reference
# ---------------------------------------------------------------------------

def _ref_mirror(now=100.0):
    """The reference's host mirror of the 8-node snapshot (a ClusterState
    of numpy leaves) and the same leaves keyed by dotted path."""
    objs = ref_make(num_nodes=8, node_accel=8.0, num_gangs=8,
                    tasks_per_gang=2, running_fraction=0.5)
    _s, _i, host = ref_build_snapshot(*objs, now=now, _return_host=True)
    return host, _as_dict(host)


def _as_dict(tree) -> dict:
    return {jax.tree_util.keystr(p).lstrip("."): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_ref(d: dict, like):
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like), [d[p] for p in leaf_paths()])


def _mutate(host: dict, rng, leaf_fraction=0.5, elem_fraction=0.05):
    """The reference test's randomized same-shape mutation, on the dict
    mirror: a few elements perturbed in a random subset of leaves."""
    out = {}
    for path in leaf_paths():
        leaf = host[path]
        if rng.random() > leaf_fraction or leaf.size == 0:
            out[path] = leaf
            continue
        new = leaf.copy()
        k = max(1, int(leaf.size * elem_fraction))
        idx = rng.choice(leaf.size, size=min(k, leaf.size), replace=False)
        flat = new.reshape(-1)
        if new.dtype.kind == "f":
            flat[idx] += 1.5
        elif new.dtype.kind == "b":
            flat[idx] = ~flat[idx]
        else:
            flat[idx] = flat[idx] + 1
        out[path] = new
    return out


def assert_delta_equal(got, want):
    assert set(got) == set(want) == {"idx", "val"}
    for part in ("idx", "val"):
        assert list(got[part]) == list(want[part])
        for k in want[part]:
            g, w = got[part][k], want[part][k]
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            w = np.asarray(w)
            assert (g.dtype, g.shape) == (w.dtype, w.shape), (part, k)
            assert g.tobytes() == w.tobytes(), (part, k)


def test_leaf_layout_and_groups_match_reference():
    ref_host, host = _ref_mirror()
    ref_pl = jax.tree_util.tree_flatten_with_path(ref_host)[0]
    assert [jax.tree_util.keystr(p).lstrip(".") for p, _ in ref_pl] == \
        leaf_paths()
    pl = [(p, host[p]) for p in leaf_paths()]
    assert R.leaf_layout(pl) == ref_resident.leaf_layout(ref_pl)
    assert R._groups(pl) == ref_resident._groups(ref_pl)
    # a device state addresses its leaves identically
    state = state_from_numpy(host, "cpu")
    spl = list(state_leaves(state).items())
    assert R.leaf_layout(spl) == ref_resident.leaf_layout(ref_pl)
    assert R._groups(spl) == ref_resident._groups(ref_pl)
    assert_delta_equal(R.empty_delta(host), ref_resident.empty_delta(ref_host))


@pytest.mark.parametrize("seed", range(16))
def test_pack_delta_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ref_host, old = _ref_mirror()
    new = _mutate(old, rng, leaf_fraction=rng.uniform(0.1, 0.9),
                  elem_fraction=rng.uniform(0.005, 0.3))
    floors = ({} if seed % 2 else
              {"running.int32": 1024, "gangs.float32": 512})
    want = ref_resident.pack_delta(ref_host, _as_ref(new, ref_host),
                                   min_buckets=floors)
    got = R.pack_delta(old, new, min_buckets=floors)
    assert_delta_equal(got[0], want[0])
    assert got[2] == want[2]
    assert got[2]["bytes"] == R.delta_nbytes(got[0])
    # merged mirrors: the same arrays, unchanged leaves keep the OLD ones
    want_merged = _as_dict(want[1])
    for p in leaf_paths():
        assert got[1][p] is want_merged[p], p


def test_apply_delta_plain_matches_reference():
    """The plain apply (K16's oracle) writes the reference's bytes, cycle
    after cycle, into one state in place."""
    rng = np.random.default_rng(11)
    ref_host, old = _ref_mirror()
    state = state_from_numpy(old, "cpu")
    ref_dev = jax.device_put(ref_host)
    apply = jax.jit(ref_resident.apply_delta)
    for trial in range(4):
        new = _mutate(old, rng)
        delta, merged, _ = R.pack_delta(old, new)
        tdelta = {part: {k: torch.from_numpy(v) for k, v in d.items()}
                  for part, d in delta.items()}
        assert R.apply_delta(state, tdelta) is state
        ref_dev = apply(ref_dev, jax.device_put(delta))
        want = _as_dict(ref_dev)
        got = state_leaves(state)
        for p in leaf_paths():
            assert got[p].numpy().tobytes() == \
                np.asarray(want[p]).tobytes(), (trial, p)
            assert np.array_equal(got[p].numpy(), new[p],
                                  equal_nan=new[p].dtype.kind == "f"), p
        old = merged


def test_apply_delta_keeps_nan_payloads_and_negative_zero():
    _r, old = _ref_mirror()
    new = dict(old)
    f = old["nodes.free"].copy()
    bits = f.reshape(-1).view(np.uint32)
    bits[0] = 0x7FC01234   # a NaN with a payload
    bits[1] = 0x80000000   # -0.0
    new["nodes.free"] = f
    delta, _m, stats = R.pack_delta(old, new)
    assert stats["elements"] >= 2
    state = state_from_numpy(old, "cpu")
    R.apply_delta(state, {part: {k: torch.from_numpy(v)
                                 for k, v in d.items()}
                          for part, d in delta.items()})
    assert state.nodes.free.numpy().tobytes() == f.tobytes()


def test_empty_delta_is_a_no_op():
    _r, old = _ref_mirror()
    state = state_from_numpy(old, "cpu")
    before = {p: t.clone() for p, t in state_leaves(state).items()}
    delta, _m, stats = R.pack_delta(old, dict(old))
    assert stats["bytes"] == 0
    R.apply_delta(state, {part: {k: torch.from_numpy(v)
                                 for k, v in d.items()}
                          for part, d in delta.items()})
    for p, t in state_leaves(state).items():
        assert torch.equal(t, before[p]), p


def test_pack_reuses_unchanged_leaf_objects():
    _r, old = _ref_mirror()
    same = {p: a.copy() for p, a in old.items()}
    delta, merged, stats = R.pack_delta(old, same)
    assert (stats["leaves"], stats["elements"], stats["bytes"]) == (0, 0, 0)
    assert all(k == 0 for k in stats["buckets"].values())
    assert all(merged[p] is old[p] for p in leaf_paths())
    real = R.pack_delta(old, _mutate(old, np.random.default_rng(1)))[0]
    for part in ("idx", "val"):
        assert list(delta[part]) == list(real[part]) == \
            list(R.empty_delta(old)[part])


def test_pack_bucket_hysteresis_pins_the_signature():
    rng = np.random.default_rng(5)
    _r, old = _ref_mirror()
    big = _mutate(old, rng, leaf_fraction=0.9, elem_fraction=0.2)
    delta1, merged, stats1 = R.pack_delta(old, big)
    small = _mutate(merged, rng, leaf_fraction=0.2, elem_fraction=0.01)
    delta2, _m, stats2 = R.pack_delta(merged, small,
                                      min_buckets=stats1["buckets"])
    for part in ("idx", "val"):
        assert {k: v.shape for k, v in delta2[part].items()} == \
            {k: v.shape for k, v in delta1[part].items()}
    assert all(stats2["buckets"][k] >= v
               for k, v in stats1["buckets"].items())


def test_pack_is_nan_stable():
    _r, old = _ref_mirror()
    f32 = next(p for p in leaf_paths()
               if old[p].dtype == np.float32 and old[p].size > 4)
    old[f32].reshape(-1)[1] = np.nan
    new = {p: a.copy() for p, a in old.items()}
    _d, _m, stats = R.pack_delta(old, new)
    assert stats["elements"] == 0 and stats["bytes"] == 0


def test_pack_rejects_shape_change():
    _r, old = _ref_mirror()
    bad = dict(old)
    first = leaf_paths()[0]
    bad[first] = np.zeros(old[first].shape + (2,), old[first].dtype)
    with pytest.raises(R.DeltaShapeError):
        R.pack_delta(old, bad)


def test_k16_leaf_table_follows_the_layout():
    """The table the card path hands K16: each group's leaves in
    ascending offsets that cover the group, one item size per group, and
    a refusal of more leaves than the kernel's table holds."""
    _r, old = _ref_mirror()
    state = state_from_numpy(old, "cpu")
    pl = list(state_leaves(state).items())
    tab, groups = R._leaf_table(tuple(t for _p, t in pl), pl)
    assert sorted(groups) == [k for k, _d in R._groups(pl)]
    for key, (begin, end, size, item, dtype) in groups.items():
        offs = list(tab.leaf_off[begin:end])
        assert offs == sorted(offs) and offs[0] == 0
        assert size == offs[-1] + tab.leaf_size[end - 1]
        assert item == (1 if key.endswith(".bool") else 4)
    wide = pl + [(f"nodes.extra{i}", pl[0][1]) for i in range(R.MAX_LEAVES)]
    with pytest.raises(ValueError, match="leaves"):
        R._leaf_table(tuple(t for _p, t in wide), wide)


# ---------------------------------------------------------------------------
# the soak: resident vs both classic twins
# ---------------------------------------------------------------------------

def _steady(apis_mod, make, cls, num_nodes=24, num_gangs=24):
    return cls.from_objects(*fleets.steady_objects(
        apis_mod, make, num_nodes=num_nodes, num_gangs=num_gangs,
        tasks_per_gang=2))


def _submit_extra_gang(apis_mod, cluster, cyc):
    """A fresh 2-pod gang through the journal's gangs_added/pods_added
    path — placed by resident cycles (appends are patchable)."""
    queue = next(iter(cluster.pod_groups.values())).queue
    name = f"soak-extra-{cyc}"
    group = apis_mod.PodGroup(name, queue=queue, min_member=2)
    pods = [apis_mod.Pod(f"{name}-{t}", name, apis_mod.ResourceVec(1, 1, 4))
            for t in range(2)]
    cluster.submit(group, pods)


def _asdicts(objs):
    return [dataclasses.asdict(o) for o in objs]


def test_soak_resident_matches_both_classic_twins_one_upload():
    num_nodes = 24
    c_res = _steady(apis, make_cluster, Cluster)
    c_twin = copy.deepcopy(c_res)
    c_ref = _steady(ref_apis, ref_make, RefCluster)
    s_res = Scheduler(SchedulerConfig(resident=True), device="cpu")
    s_twin = Scheduler(SchedulerConfig(incremental=False), device="cpu")
    s_ref = RefScheduler(RefSchedulerConfig(incremental=False))
    rngs = [np.random.default_rng(7) for _ in range(3)]
    resident_cycles = resident_with_binds = 0
    structural_at = 11
    recovered = False
    late_misses = 0
    late_buckets = set()
    for cyc in range(24):
        rep = WATCHER.report()["entries"]
        calls_before = {k: v["calls"] for k, v in rep.items()}
        misses_before = rep.get("resident_cycle", {}).get("misses", 0)
        r1 = s_res.run_once(c_res)
        rep = WATCHER.report()["entries"]
        calls_after = {k: v["calls"] for k, v in rep.items()}
        if cyc >= 18:
            late_misses += (rep.get("resident_cycle", {}).get("misses", 0)
                            - misses_before)
            # the delta's bucket tuple has settled: it is what the
            # watcher's signature sees move
            late_buckets.add(tuple(sorted(
                s_res._snapshotter._delta_buckets.items())))
        r2 = s_twin.run_once(c_twin)
        r3 = s_ref.run_once(c_ref)
        for other in (r2, r3):
            assert _asdicts(r1.bind_requests) == \
                _asdicts(other.bind_requests), cyc
            assert _asdicts(r1.evictions) == _asdicts(other.evictions), cyc
            assert r1.analytics == other.analytics, cyc
        last = s_res._snapshotter.stats.last
        if last["mode"] == "resident":
            resident_cycles += 1
            resident_with_binds += bool(r1.bind_requests)
            recovered |= cyc > structural_at
            dcalls = {k: calls_after.get(k, 0) - calls_before.get(k, 0)
                      for k in calls_after}
            assert {k: v for k, v in dcalls.items() if v} == \
                {"resident_cycle": 1}, cyc
            wire = r1.wire
            assert sorted(wire["by_reason"]) == [REASON_DELTA_APPLY], cyc
            da = wire["by_reason"][REASON_DELTA_APPLY]
            assert da["dispatches"] == 1, cyc
            assert da["bytes"] == last["bytes_shipped"] > 0, cyc
            assert wire["redundant_bytes"] == 0, cyc
            assert wire["resident_uploaded_bytes"] == da["bytes"], cyc
            assert (wire["resident_reused_bytes"]
                    == wire["resident_bytes"] > 0), cyc
        if cyc % 3 == 0:
            for a, cl in ((apis, c_res), (apis, c_twin), (ref_apis, c_ref)):
                _submit_extra_gang(a, cl, cyc)
        if cyc == structural_at:
            # a new node on all three: unpatchable, the resident path
            # falls back whole
            for a, cl in ((apis, c_res), (apis, c_twin), (ref_apis, c_ref)):
                node = a.Node(f"node-{num_nodes}",
                              a.ResourceVec(8.0, 64.0, 256.0))
                cl.nodes[node.name] = node
                cl.journal.mark_structural("test-node-added")
        for (a, cl), rng in zip(((apis, c_res), (apis, c_twin),
                                 (ref_apis, c_ref)), rngs):
            fleets.churn_cluster(a, cl, rng, 0.05, num_nodes,
                                 restart=True)
    assert resident_cycles >= 15, s_res._snapshotter.stats.fallbacks
    assert resident_with_binds >= 8, resident_with_binds
    assert "structural" in s_res._snapshotter.stats.fallbacks
    assert recovered
    assert late_misses == 0
    assert len(late_buckets) == 1, late_buckets


def test_desync_guard_forces_full_rebuild():
    cluster = _steady(apis, make_cluster, Cluster, 8, 8)
    snap = IncrementalSnapshotter(device="cpu")
    assert snap.refresh_resident(cluster, now=cluster.now).mode == "full"
    cluster.tick()
    assert snap.refresh_resident(cluster, now=cluster.now).mode == \
        "resident"
    # a cycle that raised before adopting: the guard is armed
    cluster.tick()
    assert snap.refresh_resident(cluster, now=cluster.now).mode == "full"
    assert "resident-desync" in snap.stats.fallbacks
    cluster.tick()
    rr = snap.refresh_resident(cluster, now=cluster.now)
    assert rr.mode == "resident"
    snap.adopt_device_state(R.apply_delta(snap.device_state, rr.delta))
    snap.verify_device_residency()


def test_desync_guard_holds_when_the_cycle_raises(monkeypatch):
    """A resident cycle that raises after the delta was staged (here in
    its first action) leaves the guard armed: the next cycle rebuilds."""
    import kai_scheduler_tpu_torch.framework.scheduler as S
    cluster = _steady(apis, make_cluster, Cluster)
    sched = Scheduler(SchedulerConfig(resident=True), device="cpu")
    rng = np.random.default_rng(2)

    def cycle():
        sched.run_once(cluster)
        fleets.churn_cluster(apis, cluster, rng, 0.05, 24, restart=True)
        return sched._snapshotter.stats.last

    modes = [cycle()["mode"] for _ in range(4)]
    assert "resident" in modes, sched._snapshotter.stats.fallbacks

    def boom(*a, **k):
        raise RuntimeError("injected")
    monkeypatch.setitem(S._PURE_ACTIONS, "allocate", boom)
    with pytest.raises(RuntimeError, match="injected"):
        sched.run_once(cluster)
    assert sched._snapshotter.stats.last["mode"] == "resident"
    monkeypatch.undo()
    assert cycle()["fallback_reason"] == "resident-desync"
    modes = [cycle()["mode"] for _ in range(3)]
    assert "resident" in modes, sched._snapshotter.stats.fallbacks
    sched._snapshotter.verify_device_residency()


def test_resident_verify_mode_passes_and_catches_divergence():
    cluster = _steady(apis, make_cluster, Cluster, 8, 8)
    sched = Scheduler(SchedulerConfig(resident=True,
                                      verify_incremental=True),
                      device="cpu")
    rng = np.random.default_rng(3)
    sched.run_once(cluster)
    for _ in range(3):
        fleets.churn_cluster(apis, cluster, rng, 0.1, 8, restart=True)
        sched.run_once(cluster)  # verify reads back and compares
    snap = sched._snapshotter
    assert snap.stats.patched >= 1
    snap._host["nodes.free"].reshape(-1)[0] += 1.0
    with pytest.raises(IncrementalVerifyError, match="resident leaf"):
        snap.verify_device_residency()


def test_repack_fires_with_real_ages_on_nonanalytics_resident_cycle():
    """With ``analytics_every=2`` the trigger fires on a cadence-skipped
    resident cycle; the solve still sees real pending ages, and each
    cycle equals the reference's classic cycle.  Allocate only, as in
    ``test_torch_repack.py``: the port's victim actions refuse the
    rack-required gang's topology."""
    ref_cluster = ref_repack_tests._frag_cluster()
    cluster = _port_cluster(ref_cluster)
    knobs = dict(actions=("allocate",), repack_frag_threshold=0.2,
                 repack_trigger_cycles=2, repack_cooldown=3,
                 analytics_every=2)
    sched = Scheduler(SchedulerConfig(resident=True, **knobs), device="cpu")
    ref_sched = RefScheduler(RefSchedulerConfig(incremental=False, **knobs))
    binder, ref_binder = Binder(), RefBinder()
    fired = placed = fired_mode = None
    for cyc in range(1, 12):
        res = sched.run_once(cluster)
        want = ref_sched.run_once(ref_cluster)
        assert _asdicts(res.bind_requests) == \
            _asdicts(want.bind_requests), cyc
        assert _asdicts(res.evictions) == _asdicts(want.evictions), cyc
        if res.repack and fired is None:
            fired = cyc
            fired_mode = sched._snapshotter.stats.last["mode"]
            assert res.repack["feasible"], res.repack
            assert res.repack["target_gang"] == "big-gang"
            assert res.repack["migrations_executed"] > 0
            assert {k: v for k, v in res.repack.items()
                    if k != "solve_seconds"} == \
                {k: v for k, v in want.repack.items()
                 if k != "solve_seconds"}
        if sum(b.pod_name.startswith("big-")
               for b in res.bind_requests) >= 8:
            placed = cyc
            break
        binder.reconcile(cluster)
        ref_binder.reconcile(ref_cluster)
        cluster.tick()
        ref_cluster.tick()
    assert fired is not None, "repack never fired"
    assert fired_mode == "resident", fired_mode
    assert placed is not None and placed >= fired


def test_resident_commit_matches_the_reference_resident_cycle(monkeypatch):
    """Four 8-node cycles on both packages at ``resident=True``: the
    packed commit of every cycle byte-equal (the same capacities: both
    snapshotters pad with the same slack, and the port's builds pad to
    32 as the reference suite's do), cold full build included."""
    monkeypatch.setattr(port_cs, "build_snapshot", functools.partial(
        port_cs.build_snapshot, pad=32))
    seen = []
    orig_pack = ref_session._pack_commit
    orig_gather = ref_session.Session.gather_host

    def pack(*args, **kwargs):
        out = orig_pack(*args, **kwargs)
        seen.append(np.asarray(out))
        return out

    def gather(self, result, analytics=None, *, packed=None, **kw):
        if packed is not None:
            seen.append(np.asarray(packed))
        return orig_gather(self, result, analytics, packed=packed, **kw)
    monkeypatch.setattr(ref_session, "_pack_commit", pack)
    monkeypatch.setattr(ref_session.Session, "gather_host", gather)
    c_ref = _steady(ref_apis, ref_make, RefCluster, 8, 8)
    cluster = _steady(apis, make_cluster, Cluster, 8, 8)
    s_ref = RefScheduler(RefSchedulerConfig(resident=True))
    sched = Scheduler(SchedulerConfig(resident=True), device="cpu")
    rngs = [np.random.default_rng(5), np.random.default_rng(5)]
    modes = []
    for cyc in range(4):
        want = s_ref.run_once(c_ref)
        got = sched.run_once(cluster)
        modes.append(sched._snapshotter.stats.last["mode"])
        assert modes[-1] == s_ref._snapshotter.stats.last["mode"], cyc
        assert got.packed.tobytes() == seen[-1].tobytes(), cyc
        assert _asdicts(got.bind_requests) == \
            _asdicts(want.bind_requests), cyc
        for (a, cl), rng in zip(((ref_apis, c_ref), (apis, cluster)),
                                rngs):
            fleets.churn_cluster(a, cl, rng, 0.1, 8, restart=True)
    assert modes.count("resident") >= 2, modes
