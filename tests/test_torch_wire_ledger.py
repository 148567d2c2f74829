"""The port's transfer ledger and signature watcher against the
reference's (``runtime/wire_ledger.py``, ``runtime/compile_watch.py``).

The ledger units of ``tests/test_wire_ledger.py`` run on private ledgers
of both packages fed the same trees: every rolled cycle summary and every
per-leaf event document must be equal.  Then the port's own cycle: the
snapshot's upload lands on the ledger, and a 22-cycle soak at 1% journaled
churn re-uploads no identical byte on the patch path, in one batched copy
a cycle.  The watcher: a shape change is a new signature, a repeat is
not, and the newest misses are kept as events.

Left for later slices: the call-graph coverage test (the auditors), the
``/debug/wire`` endpoint and its scrape hammer, and the metrics registry
(the serving slice).
"""
import json

import numpy as np
import pytest
import torch

from kai_scheduler_tpu.runtime.wire_ledger import \
    TransferLedger as RefLedger
from kai_scheduler_tpu_torch.apis import types as apis
from kai_scheduler_tpu_torch.framework import session as port_session
from kai_scheduler_tpu_torch.framework.scheduler import (Scheduler,
                                                         SchedulerConfig)
from kai_scheduler_tpu_torch.runtime.cluster import Cluster
from kai_scheduler_tpu_torch.runtime.compile_watch import (WATCHER,
                                                           CompileWatcher)
from kai_scheduler_tpu_torch.runtime.wire_ledger import (
    LEDGER, REASON_FULL_BUILD, REASON_JOURNAL_PATCH, TransferLedger)
from kai_scheduler_tpu_torch.state import fleets, make_cluster
from kai_scheduler_tpu_torch.state.cluster_state import build_snapshot

from jax_executables import release_jax_executables  # noqa: F401

WIRE_SUMMARY_KEYS = {"cycle", "by_reason", "bytes", "leaves",
                     "dispatches", "redundant_bytes", "redundant_leaves",
                     "resident_bytes", "resident_buffers",
                     "peak_resident_bytes", "dropped",
                     "unfingerprinted_bytes"}


def _tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal(16).astype(np.float32),
            "y": np.arange(12, dtype=np.int32).reshape(3, 4)}


class Pair:
    """A reference ledger and a port ledger fed the same calls; every
    rolled summary and event document must agree."""

    def __init__(self, **kw):
        self.ref, self.port = RefLedger(**kw), TransferLedger(**kw)

    def put(self, tree, **kw):
        self.ref.device_put(tree, **kw)
        return self.port.device_put(tree, device="cpu", **kw)

    def roll(self, cid):
        want, got = self.ref.roll_cycle(cid), self.port.roll_cycle(cid)
        assert got == want
        assert self.port.last(1)[0]["events"] == \
            self.ref.last(1)[0]["events"]
        return got

    def residency(self):
        assert self.port.residency() == self.ref.residency()
        return self.port.residency()


def test_ledger_records_batched_dispatch_and_leaf_events():
    led = Pair(retain_cycles=4)
    tree = _tree()
    out = led.put(tree, reason=REASON_FULL_BUILD, site="t",
                  replace_site=True, leaf_names=["x", "y"])
    assert set(out) == {"x", "y"}
    # one host buffer, one copy: the leaves are views of one storage
    assert out["x"].untyped_storage().data_ptr() == \
        out["y"].untyped_storage().data_ptr()
    for k in tree:
        assert np.array_equal(out[k].numpy(), tree[k])
    s = led.roll(0)
    assert WIRE_SUMMARY_KEYS <= set(s)
    assert s["leaves"] == 2 and s["dispatches"] == 1
    assert s["bytes"] == 16 * 4 + 12 * 4
    assert s["redundant_bytes"] == 0 and s["unfingerprinted_bytes"] == 0
    assert s["resident_buffers"] == 2 and s["resident_bytes"] == s["bytes"]
    [doc] = led.port.last(1)
    assert [e["leaf"] for e in doc["events"]] == ["x", "y"]
    ev = doc["events"][0]
    assert (ev["nbytes"], ev["dtype"], ev["shape"],
            ev["reason"], ev["redundant"]) == (
        64, "float32", [16], REASON_FULL_BUILD, False)


def test_ledger_redundancy_detector_counts_identical_reuploads():
    led = Pair()
    led.put(_tree(), reason=REASON_FULL_BUILD, site="t",
            replace_site=True, leaf_names=["x", "y"])
    led.roll(0)
    led.put(_tree(), reason=REASON_JOURNAL_PATCH, site="t",
            leaf_names=["x", "y"])
    s = led.roll(1)
    assert s["redundant_leaves"] == 2
    assert s["redundant_bytes"] == s["bytes"]
    assert s["by_reason"][REASON_JOURNAL_PATCH]["redundant_bytes"] \
        == s["bytes"]
    changed = _tree()
    changed["x"] = changed["x"] + 1.0
    led.put(changed, reason=REASON_JOURNAL_PATCH, site="t",
            leaf_names=["x", "y"])
    s = led.roll(2)
    assert s["redundant_leaves"] == 1  # only y
    assert s["redundant_bytes"] == 48
    # a full rebuild that re-ships identical bytes is caught even with
    # replace_site=True (the compare happens before supersession)
    led.put(changed, reason=REASON_FULL_BUILD, site="t",
            replace_site=True, leaf_names=["x", "y"])
    s = led.roll(3)
    assert s["redundant_leaves"] == 2


def test_ledger_residency_replace_site_and_shape_change():
    led = Pair()
    led.put({"a": np.zeros(8, np.float32), "b": np.zeros(4, np.float32)},
            reason=REASON_FULL_BUILD, site="t", replace_site=True,
            leaf_names=["a", "b"])
    assert led.residency() == {"buffers": 2, "bytes": 48, "peak_bytes": 48}
    led.put({"a": np.zeros(16, np.float32)}, reason=REASON_JOURNAL_PATCH,
            site="t", leaf_names=["a"])
    assert led.residency()["bytes"] == 64 + 16
    led.put({"a": np.zeros(16, np.float32)}, reason=REASON_FULL_BUILD,
            site="t", replace_site=True, leaf_names=["a"])
    r = led.residency()
    assert r["buffers"] == 1 and r["bytes"] == 64
    assert r["peak_bytes"] >= 80
    led.roll(0)
    # same content bytes, different shape: NOT redundant
    led.put({"a": np.zeros((4, 4), np.float32)},
            reason=REASON_JOURNAL_PATCH, site="t", leaf_names=["a"])
    assert led.roll(1)["redundant_leaves"] == 0


def test_ledger_ring_and_event_bounds():
    led = Pair(retain_cycles=2, max_events_per_cycle=3)
    for cid in range(4):
        led.put({f"l{i}": np.full(2, cid, np.float32) for i in range(5)},
                reason=REASON_FULL_BUILD, site="t",
                leaf_names=[f"l{i}" for i in range(5)])
        s = led.roll(cid)
        assert s["leaves"] == 5 and s["dropped"] == 2
    doc = led.port.wire_doc()
    assert [c["cycle"] for c in doc["cycles"]] == [2, 3]
    assert all(len(c["events"]) == 3 for c in doc["cycles"])
    json.dumps(doc)
    assert [c["cycle"] for c in led.port.wire_doc(cycles=1)["cycles"]] \
        == [3]
    want = led.ref.wire_doc()
    for k in ("window", "residency", "totals"):
        assert doc[k] == want[k], k


def test_ledger_leaf_names_pair_with_flatten_order():
    """Dict keys flatten SORTED: names pair with the sorted leaves."""
    led = Pair()
    tree = {}
    tree["z_small"] = np.zeros(2, np.float32)
    tree["a_big"] = np.zeros(100, np.float32)
    out = led.put(tree, reason=REASON_JOURNAL_PATCH, site="t",
                  leaf_names=sorted(tree))
    assert out["a_big"].shape == (100,) and out["z_small"].shape == (2,)
    s = led.roll(0)
    assert s["leaves"] == 2
    by = {e["leaf"]: e["nbytes"] for e in led.port.last(1)[0]["events"]}
    assert by == {"a_big": 400, "z_small": 8}
    with pytest.raises(ValueError):
        led.port.device_put(tree, device="cpu", reason=REASON_JOURNAL_PATCH,
                            site="t", leaf_names=["only-one"])


def test_ledger_reason_override_nested_trees_and_tensor_leaves():
    led = TransferLedger()
    with led.override_reason("fallback"):
        led.device_put({"x": np.zeros(4, np.float32)}, device="cpu",
                       reason=REASON_FULL_BUILD, site="t")
    # a tensor leaf is moved on its own and counted by size, never
    # fingerprinted (hashing it would itself read it back)
    led.device_put({"d": torch.zeros(4)}, device="cpu", reason="tensor",
                   site="t")
    # nested dicts keep their structure; names join the key path
    out = led.device_put({"idx": {"b": np.arange(3, dtype=np.int32)},
                          "val": {"b": np.ones(3, np.bool_)}},
                         device="cpu", reason="delta-apply", site="d",
                         transient=True)
    assert out["idx"]["b"].tolist() == [0, 1, 2]
    assert out["val"]["b"].dtype == torch.bool
    s = led.roll_cycle(0)
    assert set(s["by_reason"]) == {"fallback", "tensor", "delta-apply"}
    assert s["by_reason"]["tensor"]["unfingerprinted_bytes"] == 16
    # transient uploads stay out of the residency gauge
    assert s["resident_buffers"] == 2
    names = [e["leaf"] for e in led.last(1)[0]["events"]]
    assert names == ["x", "d", "idx.b", "val.b"]
    got = led.device_get({"a": torch.arange(4, dtype=torch.int32)},
                         reason="verify")
    assert got["a"].tolist() == [0, 1, 2, 3]
    assert led.roll_cycle(1)["downloads"] == {
        "verify": {"leaves": 1, "bytes": 16, "dispatches": 1}}


# ---------------------------------------------------------------------------
# the port's cycle on the ledger
# ---------------------------------------------------------------------------

def _steady_cluster(num_nodes=48, num_gangs=48):
    return Cluster.from_objects(*fleets.steady_objects(
        apis, make_cluster, num_nodes=num_nodes, num_gangs=num_gangs,
        tasks_per_gang=2))


def test_full_build_upload_lands_on_the_ledger():
    led_before = LEDGER.totals()["by_reason"].get(REASON_FULL_BUILD, {})
    objs = make_cluster(num_nodes=4, num_gangs=2)
    state, _ = build_snapshot(*objs, device="cpu")
    after = LEDGER.totals()["by_reason"][REASON_FULL_BUILD]
    assert after["dispatches"] == led_before.get("dispatches", 0) + 1
    assert after["leaves"] - led_before.get("leaves", 0) == 86
    assert after["bytes"] - led_before.get("bytes", 0) == sum(
        t.numel() * t.element_size() for t in (
            *vars(state.nodes).values(), *vars(state.queues).values(),
            *vars(state.gangs).values(), *vars(state.running).values()))


def test_cycle_result_carries_wire_summary():
    cluster = _steady_cluster(num_nodes=8, num_gangs=8)
    # close the window other tests of this process left open (uploads
    # outside a cycle land in the next rolled window)
    LEDGER.roll_cycle(-1)
    res = Scheduler(device="cpu").run_once(cluster)
    assert WIRE_SUMMARY_KEYS <= set(res.wire)
    # the cold cycle's build landed on the ledger as the incremental
    # engine's full rebuild
    assert res.wire["by_reason"]["fallback"]["bytes"] > 0
    assert res.wire["by_reason"]["fallback"]["dispatches"] == 1
    assert res.wire["resident_bytes"] > 0
    json.dumps(res.wire)


def test_patch_events_name_real_leaves_across_sections():
    """Every journal-patch event's (name -> dtype/shape/nbytes) matches
    the snapshotter's host leaf of that name, across sections."""
    cluster = _steady_cluster(num_nodes=16, num_gangs=16)
    sched = Scheduler(device="cpu")
    sched.run_once(cluster)
    rng = np.random.default_rng(1)
    checked_sections = set()
    for _ in range(6):
        fleets.churn_cluster(apis, cluster, rng, 0.05, num_nodes=16)
        res = sched.run_once(cluster)
        if sched._snapshotter.stats.last["mode"] != "patched":
            continue
        host = sched._snapshotter._host
        [doc] = LEDGER.last(1)
        assert doc["cycle"] == res.wire["cycle"]
        for ev in doc["events"]:
            if ev["reason"] != REASON_JOURNAL_PATCH:
                continue
            leaf = host[ev["leaf"]]
            assert ev["nbytes"] == int(leaf.nbytes), ev
            assert ev["dtype"] == str(leaf.dtype), ev
            assert ev["shape"] == list(leaf.shape), ev
            checked_sections.add(ev["leaf"].split(".")[0])
    assert len(checked_sections) >= 2, checked_sections


def test_soak_patch_path_never_reuploads_identical_bytes():
    """22 cycles at 1% journaled churn: every patched cycle ships changed
    bytes only (redundant == 0) in ONE batched copy."""
    cluster = _steady_cluster()
    sched = Scheduler(device="cpu")
    sched.run_once(cluster)
    rng = np.random.default_rng(0)
    patched = 0
    for _ in range(22):
        fleets.churn_cluster(apis, cluster, rng, 0.01, num_nodes=48)
        res = sched.run_once(cluster)
        last = sched._snapshotter.stats.last
        if last["mode"] != "patched":
            continue
        patched += 1
        pr = res.wire["by_reason"].get(REASON_JOURNAL_PATCH)
        assert pr is not None and pr["bytes"] > 0, res.wire
        assert pr["redundant_bytes"] == 0, res.wire
        assert pr["dispatches"] == 1, res.wire
        assert last["ship_dispatches"] == 1
        assert pr["leaves"] == last["leaves_shipped"]
        assert pr["bytes"] == last["bytes_shipped"]
    assert patched >= 15, sched._snapshotter.stats.fallbacks


# ---------------------------------------------------------------------------
# the signature watcher
# ---------------------------------------------------------------------------

def test_compile_watcher_attributes_shape_churn_to_entry():
    """The same entry at two padded shapes records two distinct misses; a
    repeat at a seen shape records none."""
    def snap(n_queues):
        objs = make_cluster(num_nodes=4, node_accel=8.0, num_gangs=4,
                            tasks_per_gang=1, num_departments=1,
                            queues_per_department=n_queues)
        return build_snapshot(*objs, device="cpu", now=1.0)[0]

    # num_levels=5 is unique to this test: the signatures are fresh
    st_small, st_big = snap(2), snap(40)
    before = WATCHER.report()["entries"]["set_fair_share"]
    sigs_before = {e["signature"] for e in WATCHER.events()}
    fs = port_session._set_fair_share
    fs(st_small, num_levels=5, k_value=0.0)
    fs(st_big, num_levels=5, k_value=0.0)
    fs(st_small, num_levels=5, k_value=0.0)  # seen: no new miss
    after = WATCHER.report()["entries"]["set_fair_share"]
    assert after["misses"] - before["misses"] == 2
    assert after["calls"] - before["calls"] == 3
    assert after["seconds"] > before["seconds"]
    new = [e for e in WATCHER.events()
           if e["entry"] == "set_fair_share"
           and e["signature"] not in sigs_before]
    assert len(new) == 2
    assert len({e["signature"] for e in new}) == 2


def test_compile_watcher_counts_misses_and_wrapped():
    w = CompileWatcher()

    def base(x):
        return x + 1
    f = w.wrap("toy", base)
    assert f.__wrapped__ is base and f.__kai_entry__ == "toy"
    f(torch.zeros(1))   # miss 1
    f(torch.zeros(2))   # miss 2
    f(torch.zeros(1))   # seen signature: no new miss
    f(np.zeros(1, np.float32))  # an array leaf: shape and dtype only
    rep = w.report()
    assert rep["entries"]["toy"] == {
        "signatures": 2, "misses": 2, "calls": 4,
        "seconds": rep["entries"]["toy"]["seconds"]}
    assert [e["entry"] for e in rep["events"]] == ["toy", "toy"]
    assert rep["events"][0]["signature"] != rep["events"][1]["signature"]
    # the event ring keeps the newest RETAIN_EVENTS misses
    for n in range(3, CompileWatcher.RETAIN_EVENTS + 3):
        f(torch.zeros(n))
    evs = w.events()
    assert len(evs) == CompileWatcher.RETAIN_EVENTS
    assert w.report()["entries"]["toy"]["misses"] == \
        CompileWatcher.RETAIN_EVENTS + 2
    assert len(w.events(5)) == 5 and w.events(5) == evs[-5:]


def test_watched_entries_cover_the_reference_entry_names():
    """The port's watched entries are the reference's production entries
    (its analysis-only probe helper aside)."""
    import kai_scheduler_tpu.framework.scheduler  # noqa: F401
    from kai_scheduler_tpu.runtime.compile_watch import WATCHER as REF
    import kai_scheduler_tpu_torch.framework.scheduler  # noqa: F401
    names = {"resident_cycle", "fused_pipeline", "stale_gang_eviction",
             "set_fair_share", "pack_commit", "allocate",
             "run_victim_action", "analytics", "repack"}
    assert names <= set(REF.entries())
    assert names <= set(WATCHER.entries())


def test_resident_cycle_is_one_watched_call_and_classic_four():
    cluster = _steady_cluster(num_nodes=8, num_gangs=8)
    sched = Scheduler(SchedulerConfig(resident=True), device="cpu")
    rng = np.random.default_rng(3)
    seen = []
    for _ in range(4):
        before = {k: v["calls"]
                  for k, v in WATCHER.report()["entries"].items()}
        sched.run_once(cluster)
        after = WATCHER.report()["entries"]
        seen.append((sched._snapshotter.stats.last["mode"], {
            k: v["calls"] - before.get(k, 0) for k, v in after.items()
            if v["calls"] != before.get(k, 0)}))
        fleets.churn_cluster(apis, cluster, rng, 0.1, num_nodes=8)
    assert seen[0] == ("full", {"fused_pipeline": 1, "set_fair_share": 1,
                                "pack_commit": 1, "analytics": 1})
    assert ("resident", {"resident_cycle": 1}) in seen[1:]
