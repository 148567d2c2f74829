"""Incremental snapshot engine: journaled dirty-set refresh.

Port of ``kai_scheduler_tpu/state/incremental.py``.  The reference keeps
cluster state incrementally current via API-server watches: each cycle
starts from an already-warm cache and only the objects that changed since
the last cycle cost any work.  Three pieces:

- :class:`MutationJournal` — the cluster hub's change feed.  Every
  mutation (``submit``/``bind_pod``/``evict_pod``/``tick``, binder
  commits) records dirty node/queue/gang/pod keys under a generation
  counter.  Multiple consumers each get their own :class:`JournalCursor`.

- :class:`IncrementalSnapshotter` — keeps the previous cycle's host
  mirror (the numpy leaves keyed by dotted path) and ``SnapshotIndex``
  and re-derives only dirty rows through the section builders shared with
  ``build_snapshot`` (``build_queue_tables``/``derive_rollups``; the
  pending-task and running-pod sections are re-assembled from cached
  per-entity encodes with vectorized numpy).  :meth:`refresh` uploads the
  changed leaves in ONE ledger call and swaps them into the device state;
  unchanged leaves keep their device tensors.  :meth:`refresh_resident`
  instead stages a packed journal delta (``ops/resident.py``) that the
  scheduler's resident cycle writes into the device state in place.

- Automatic **fallback to the full rebuild** whenever a patch cannot be
  proven identical to a fresh ``build_snapshot``: structural change
  (node/queue/pod-group set or order, topology swap, capacity overflow),
  vocabulary growth, feature pods (fractions, DRA, volumes, host ports,
  affinity, tolerations, selectors, nominated nodes, subgroups), a dirty
  fraction above ``dirty_threshold``, and ledger drift (an object mutated
  without a journal mark; a cheap identity/field sweep detects it).

The numpy body is the reference's, copied whole; only the device side
differs.  ``verify=True`` rebuilds from scratch after every patch and
asserts the patched mirror is element-wise identical, index name maps
included; :meth:`IncrementalSnapshotter.verify_device_residency` reads
the resident device state back and compares it with the mirror.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref

import numpy as np

from ..apis import types as apis
from ..device import resolve_device
from ..ops import resident as _resident
from ..runtime import wire_ledger as _wire
from . import cluster_state as _cs
from .cluster_state import (
    SnapshotCapacity,
    leaf_paths,
    _LEADER_ROLES,
    _round_up,
    build_queue_tables,
    dense_row_ids,
    derive_rollups,
)

R = apis.NUM_RESOURCES

_PENDING = int(apis.PodStatus.PENDING)
_BOUND = int(apis.PodStatus.BOUND)
_RUNNING = int(apis.PodStatus.RUNNING)
_RELEASING = int(apis.PodStatus.RELEASING)


class IncrementalVerifyError(AssertionError):
    """A patched snapshot diverged from a fresh full rebuild."""


class _Fallback(Exception):
    """Internal: abandon the patch attempt, run the full rebuild."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# ---------------------------------------------------------------------------
# Mutation journal
# ---------------------------------------------------------------------------


_CURSOR_FIELDS = ("pods_dirty", "pods_added", "pods_removed",
                  "gangs_dirty", "gangs_added", "nodes_dirty",
                  "structural", "time_dirty")


class JournalBatch:
    """One drained window of changes — private to the consumer that
    drained it (no lock needed to read it)."""

    __slots__ = _CURSOR_FIELDS

    def __init__(self):
        self.pods_dirty: set[str] = set()
        self.pods_added: list[str] = []
        self.pods_removed: set[str] = set()
        self.gangs_dirty: set[str] = set()
        self.gangs_added: list[str] = []
        self.nodes_dirty: set[str] = set()
        self.structural: list[str] = []
        self.time_dirty = False


class JournalCursor:
    """One consumer's pending change sets (drained by ``consume``).

    The cursor shares its journal's lock: marks (any thread — binder,
    status-updater workers, HTTP handler deltas) and ``consume`` (the
    snapshotter's refresh) are mutually exclusive, so a drain can never
    observe a half-recorded mutation or drop a mark that raced the
    field swap.
    """

    __slots__ = _CURSOR_FIELDS + ("_lock", "__weakref__")

    def __init__(self, lock: threading.Lock | None = None):
        self._lock = lock if lock is not None else threading.Lock()
        self._reset()

    def _reset(self) -> None:
        self.pods_dirty: set[str] = set()
        self.pods_added: list[str] = []
        self.pods_removed: set[str] = set()
        self.gangs_dirty: set[str] = set()
        self.gangs_added: list[str] = []
        self.nodes_dirty: set[str] = set()
        self.structural: list[str] = []
        self.time_dirty = False

    def consume(self) -> "JournalBatch":
        """Move the accumulated sets into a private batch and reset —
        atomically with respect to concurrent marks."""
        out = JournalBatch()
        with self._lock:
            for slot in _CURSOR_FIELDS:
                setattr(out, slot, getattr(self, slot))
            self._reset()
        return out


class MutationJournal:
    """The cluster hub's change feed (fan-out to registered cursors).

    Marks are cheap set/list inserts; with no cursor registered only the
    generation counter moves.  Consumers (one ``IncrementalSnapshotter``
    each) register a :class:`JournalCursor` and drain it per refresh.

    Thread-safe: marks may arrive from other threads (the binder, status
    writers) while the scheduler thread drains cursors — every mark and
    every ``consume`` runs under one journal lock (a torn or lost mark
    would let the snapshotter serve a silently stale patch).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.generation = 0  # guarded by _lock
        self._cursors: list = []  # weakrefs to JournalCursor

    def __deepcopy__(self, memo):
        # a deep-copied cluster document (a twin) starts its own change
        # feed: locks are not copyable, and the copy's mutations must not
        # dirty the original's consumers
        return MutationJournal()

    def __reduce__(self):
        # so does a cluster document sent to another process (an oracle
        # run's result): the receiver's copy starts its own change feed
        return (MutationJournal, ())

    def register(self) -> JournalCursor:
        cur = JournalCursor(self._lock)
        with self._lock:
            self._cursors.append(weakref.ref(cur))
        return cur

    def _each(self):
        if not self._cursors:
            return
        dead = False
        for ref in self._cursors:
            cur = ref()
            if cur is None:
                dead = True
            else:
                yield cur
        if dead:
            self._cursors = [r for r in self._cursors if r() is not None]

    # -- marks ------------------------------------------------------------

    def _apply_mark(self, kind: str, name: str) -> None:
        """One mark's cursor fan-out — caller holds ``self._lock``.
        The single implementation behind both the per-mark methods and
        the bulk :meth:`merge`, so a merged batch can never drift from
        the sequential mark semantics."""
        self.generation += 1
        for c in self._each():
            if kind == "pod":
                c.pods_dirty.add(name)
            elif kind == "pod_added":
                if name not in c.pods_removed and name not in c.pods_dirty:
                    c.pods_added.append(name)
                else:
                    # removed-then-readded (or dirtied) inside one window:
                    # position in the dict may have moved — too subtle to
                    # patch, let the sweep/full rebuild sort it out
                    c.structural.append("pod-readded")
            elif kind == "pod_removed":
                c.pods_removed.add(name)
            elif kind == "gang":
                c.gangs_dirty.add(name)
            elif kind == "gang_added":
                c.gangs_added.append(name)
            elif kind == "node":
                c.nodes_dirty.add(name)
            elif kind == "structural":
                c.structural.append(name)
            elif kind == "time":
                c.time_dirty = True
            else:
                raise ValueError(f"unknown journal mark kind {kind!r}")

    def mark_pod(self, name: str) -> None:
        with self._lock:
            self._apply_mark("pod", name)

    def mark_pod_added(self, name: str) -> None:
        with self._lock:
            self._apply_mark("pod_added", name)

    def mark_pod_removed(self, name: str) -> None:
        with self._lock:
            self._apply_mark("pod_removed", name)

    def mark_gang(self, name: str) -> None:
        with self._lock:
            self._apply_mark("gang", name)

    def mark_gang_added(self, name: str) -> None:
        with self._lock:
            self._apply_mark("gang_added", name)

    def mark_node(self, name: str) -> None:
        with self._lock:
            self._apply_mark("node", name)

    def mark_structural(self, reason: str) -> None:
        with self._lock:
            self._apply_mark("structural", reason)

    def mark_time(self) -> None:
        with self._lock:
            self._apply_mark("time", "")

    def merge(self, marks) -> None:
        """Replay an ordered batch of ``(kind, name)`` mark operations
        under ONE lock acquisition (the intake's bulk merge of staged
        marks into the hub journal).

        Event-for-event identical to calling the individual ``mark_*``
        methods in the same order: same per-cursor set/list mutations
        (including the pod-readded structural escalation, which is
        order-sensitive) and the same generation count.  Only the lock
        traffic is batched, so a 1M-event storm pays one acquisition
        per coalesce instead of one per mark."""
        if not marks:
            return
        with self._lock:
            for kind, name in marks:
                self._apply_mark(kind, name)


# ---------------------------------------------------------------------------
# The incremental snapshotter
# ---------------------------------------------------------------------------


def _slack(n: int) -> int:
    """Capacity headroom so modest growth between full rebuilds never
    changes a compiled shape (shapes recompile kernels)."""
    return n + max(2, n // 8)


def _is_plain_pod(pod: apis.Pod) -> bool:
    """Pods the patch path can encode row-wise.  Everything else rides
    the irregular intake paths of the full builder (filter classes,
    vocab growth, device-share bookkeeping) and forces a fallback."""
    return not (
        pod.node_selector or pod.tolerations or pod.node_affinity
        or pod.pod_affinity or pod.extended or pod.resource_claims
        or pod.volume_claims or pod.host_ports
        or pod.nominated_node is not None or pod.subgroup
        or pod.accel_portion > 0 or pod.accel_memory_gib > 0
        or pod.dra_accel_count > 0)


@dataclasses.dataclass
class SnapshotterStats:
    full_builds: int = 0
    patched: int = 0
    fallbacks: dict = dataclasses.field(default_factory=dict)
    leaves_shipped: int = 0
    bytes_shipped: int = 0
    #: the LAST refresh's stats — mode (patched/resident/full), fallback
    #: reason, dirty rows, changed leaves/bytes uploaded and upload
    #: seconds (the scheduler's ``upload`` phase)
    last: dict = dataclasses.field(default_factory=dict)

    def fallback(self, reason: str) -> None:
        key = reason.split(":")[0]
        self.fallbacks[key] = self.fallbacks.get(key, 0) + 1


@dataclasses.dataclass
class ResidentRefresh:
    """One resident refresh outcome (``refresh_resident``)."""

    #: "resident" — a packed delta is staged for the resident cycle;
    #: "full" — a structural/cold fallback rebuilt and re-uploaded
    mode: str
    index: object
    #: freshly built device state (mode "full" only)
    state: object | None
    #: device-side packed journal delta (mode "resident" only)
    delta: dict | None
    #: the host mirror — host-side snapshot reads for the Session (None
    #: while a persistent environment condition keeps the per-entity
    #: ledger cold, e.g. DRA/volume feature stores)
    host: dict | None


class IncrementalSnapshotter:
    """Journal-driven snapshot refresher for one ``Cluster``, on
    ``device`` (default ``"cuda"``; ``"cpu"`` only when asked for).

    ``refresh(cluster, now=..., queue_usage=...)`` returns the same
    ``(ClusterState, SnapshotIndex)`` pair ``build_snapshot`` would,
    either by patching the cached previous snapshot (dirty rows only,
    changed leaves only to the device) or by falling back to the full
    builder.  Single consumer per journal cursor; one snapshotter per
    cluster document.
    """

    def __init__(self, *, verify: bool = False,
                 dirty_threshold: float = 0.35, device="cuda"):
        self.verify = verify
        self.dirty_threshold = dirty_threshold
        self.device = resolve_device(device)
        self.stats = SnapshotterStats()
        self._cluster_ref = None
        self._cursor: JournalCursor | None = None
        self._host: dict | None = None  # host mirror (previous cycle)
        self._dev = None         # device ClusterState (previous cycle)
        self._index = None
        self._capacity = SnapshotCapacity()
        #: resident desync guard: True between a staged delta
        #: (refresh_resident) and its adoption (adopt_device_state)
        self._delta_outstanding = False
        #: bucket hysteresis: per-group segment lengths only grow (see
        #: ops/resident.pack_delta), so the delta's signature settles
        self._delta_buckets: dict[str, int] = {}

    # -- public -----------------------------------------------------------

    def _bind_cluster(self, cluster) -> None:
        if (self._cluster_ref is None
                or self._cluster_ref() is not cluster):
            self._cluster_ref = weakref.ref(cluster)
            journal = getattr(cluster, "journal", None)
            self._cursor = (journal.register()
                            if journal is not None else None)
            self._host = None

    def refresh(self, cluster, *, now: float | None = None,
                queue_usage=None):
        self._bind_cluster(cluster)
        j = (self._cursor.consume() if self._cursor is not None
             else None)
        reason = self._patch_blockers(cluster, j)
        if reason is None:
            try:
                host_new, index = self._patch(cluster, j, now,
                                              queue_usage)
            except _Fallback as exc:
                reason = exc.reason
            else:
                state = self._ship(host_new)
                self._index = index
                self.stats.patched += 1
                ship = self._last_ship
                self.stats.last = {
                    "mode": "patched", "fallback_reason": "",
                    "dirty_pods": self._last_dirty[0],
                    "dirty_gangs": self._last_dirty[1],
                    "leaves_shipped": ship[0], "bytes_shipped": ship[1],
                    "ship_seconds": ship[2], "ship_dispatches": ship[3],
                }
                if self.verify:
                    self._verify(cluster, now, queue_usage)
                return state, index
        self.stats.fallback(reason)
        out = self._full(cluster, now, queue_usage)
        # the full builder's upload happens inside build_snapshot: the
        # whole rebuild is one section
        self.stats.last = {
            "mode": "full", "fallback_reason": reason,
            "dirty_pods": 0, "dirty_gangs": 0,
            "leaves_shipped": 0, "bytes_shipped": 0,
            "ship_seconds": 0.0, "ship_dispatches": 0,
        }
        return out

    # -- the resident path ---------------------------------------------------

    def refresh_resident(self, cluster, *, now: float | None = None,
                         queue_usage=None) -> "ResidentRefresh":
        """The resident refresh: patch the host mirror, then stage a
        **packed journal delta** (``ops/resident.py``), uploaded as ONE
        transient ledger call, instead of shipping changed leaves.

        On success (``mode == "resident"``) the device state has NOT been
        touched yet: the scheduler's resident cycle applies the delta to
        :attr:`device_state` in place and hands the post-delta state back
        via :meth:`adopt_device_state` — until then a desync guard forces
        the next refresh to a full rebuild, so a cycle that raised between
        the two can never leave the mirror ahead of the device.  Every
        fallback returns ``mode == "full"`` with a freshly built and
        uploaded device state, exactly like :meth:`refresh`.
        """
        self._bind_cluster(cluster)
        j = (self._cursor.consume() if self._cursor is not None
             else None)
        reason = None
        if self._delta_outstanding:
            # the previous staged delta was never adopted (the cycle
            # raised between refresh and adopt): rebuild rather than diff
            # against a mirror the device may not match
            self._delta_outstanding = False
            self._host = None
            reason = "resident-desync"
        if reason is None:
            reason = self._patch_blockers(cluster, j)
        if reason is None:
            try:
                host_new, index = self._patch(cluster, j, now,
                                              queue_usage)
                delta, merged, dstats = _resident.pack_delta(
                    self._host, host_new,
                    min_buckets=self._delta_buckets)
            except _Fallback as exc:
                reason = exc.reason
            except _resident.DeltaShapeError as exc:
                reason = f"delta-shape:{exc}"
            else:
                t_ship = time.perf_counter()
                # ONE transient upload: the delta is consumed by this
                # cycle's apply and never joins the ledger's resident set
                delta_dev = _wire.LEDGER.device_put(
                    delta, device=self.device,
                    reason=_wire.REASON_DELTA_APPLY, site="delta",
                    transient=True)
                ship_s = time.perf_counter() - t_ship
                self._host = merged
                self._index = index
                self._delta_outstanding = True
                self._delta_buckets.update(dstats["buckets"])
                self.stats.patched += 1
                self.stats.leaves_shipped += dstats["leaves"]
                self.stats.bytes_shipped += dstats["bytes"]
                self.stats.last = {
                    "mode": "resident", "fallback_reason": "",
                    "dirty_pods": self._last_dirty[0],
                    "dirty_gangs": self._last_dirty[1],
                    "leaves_shipped": dstats["leaves"],
                    "bytes_shipped": dstats["bytes"],
                    "delta_elements": dstats["elements"],
                    "ship_seconds": ship_s, "ship_dispatches": 1,
                }
                if self.verify:
                    self._verify(cluster, now, queue_usage)
                return ResidentRefresh(
                    mode="resident", index=index, state=None,
                    delta=delta_dev, host=self._host)
        self.stats.fallback(reason)
        state, index = self._full(cluster, now, queue_usage)
        self.stats.last = {
            "mode": "full", "fallback_reason": reason,
            "dirty_pods": 0, "dirty_gangs": 0,
            "leaves_shipped": 0, "bytes_shipped": 0,
            "ship_seconds": 0.0, "ship_dispatches": 0,
        }
        return ResidentRefresh(mode="full", index=index, state=state,
                               delta=None, host=self._host)

    @property
    def device_state(self):
        """The device-resident ``ClusterState`` the resident cycle applies
        the staged delta to, in place."""
        return self._dev

    def adopt_device_state(self, state) -> None:
        """Install the resident cycle's post-delta state as the resident
        state for the next cycle (clears the desync guard armed by
        :meth:`refresh_resident`)."""
        self._dev = state
        self._delta_outstanding = False

    def verify_device_residency(self) -> None:
        """Read the device-resident state back (one accounted ledger
        readback, reason ``verify``) and assert it is leaf-wise identical
        to the host mirror."""
        if self._host is None or self._dev is None:
            return
        dev_host = _wire.LEDGER.device_get(
            _cs.state_leaves(self._dev), reason=_wire.REASON_VERIFY)
        for name in leaf_paths():
            mine, dev = self._host[name], dev_host[name]
            if dev.shape != mine.shape or dev.dtype != mine.dtype:
                raise IncrementalVerifyError(
                    f"resident leaf {name}: shape/dtype "
                    f"{dev.shape}/{dev.dtype} != "
                    f"{mine.shape}/{mine.dtype}")
            if not np.array_equal(dev, mine,
                                  equal_nan=mine.dtype.kind == "f"):
                bad = np.nonzero(dev != mine)
                raise IncrementalVerifyError(
                    f"resident leaf {name}: {len(bad[0])} elements "
                    f"diverged from the host mirror")

    # -- fallback decisions ----------------------------------------------

    def _patch_blockers(self, cluster, j) -> str | None:
        # environment conditions first: they also tell _full whether a
        # ledger rebuild is worth paying for
        if self._cursor is None:
            return "no-journal"
        if (cluster.resource_claims or cluster.device_classes
                or cluster.volume_claims or cluster.storage_classes):
            return "feature-stores"
        if self._host is None:
            return "cold"
        if j.structural:
            return f"structural:{j.structural[0]}"
        if j.nodes_dirty:
            return "node-dirty"
        if cluster.topology is not self._topology:
            return "topology-changed"
        if not self._clean:
            return "vocab-residue"
        if self._nonplain > 0:
            return "nonplain-pods"
        if self._nonplain_gangs > 0:
            return "nonplain-gangs"
        if self._present_twice > 0:
            return "inflight-move"
        live = int(self.p_live.sum())
        if len(self.p_objs) > 2 * max(live, 64):
            return "ledger-compaction"
        return None

    # ------------------------------------------------------------------
    # Full rebuild: run build_snapshot, then rebuild every ledger/cache
    # ------------------------------------------------------------------

    def _full(self, cluster, now, queue_usage):
        self.stats.full_builds += 1
        # go cold first: if the build raises (bad config propagates to
        # the caller), the next refresh must not patch over a cache that
        # no longer matches the already-consumed journal
        self._host = None
        lists = cluster.snapshot_lists()
        nodes, queues, groups, pods, topology = lists
        live_nodes = [n for n in nodes if not n.unschedulable]
        pend_per_group: dict[str, int] = {g.name: 0 for g in groups}
        n_running = 0
        for p in pods:
            if p.status == apis.PodStatus.PENDING:
                if p.group in pend_per_group:
                    pend_per_group[p.group] += 1
            elif p.status in (apis.PodStatus.BOUND, apis.PodStatus.RUNNING,
                              apis.PodStatus.RELEASING):
                n_running += 1
        max_pending = max(pend_per_group.values(), default=0)
        cap = SnapshotCapacity(
            nodes=_slack(len(live_nodes)), queues=_slack(len(queues)),
            gangs=_slack(len(groups)), tasks=_slack(max_pending),
            running=_slack(n_running), types=0)
        # through the module attribute so test harnesses that wrap
        # build_snapshot stay in effect.  The wire ledger re-labels the
        # build's upload "fallback": the incremental engine rebuilt in
        # full (cold start included), told apart from a deliberate build
        with _wire.LEDGER.override_reason(_wire.REASON_FALLBACK):
            state, index, host = _cs.build_snapshot(
                *lists, device=self.device, now=now,
                queue_usage=queue_usage,
                resource_claims=cluster.resource_claims,
                device_classes=cluster.device_classes,
                volume_claims=cluster.volume_claims,
                storage_classes=cluster.storage_classes,
                capacity=cap, return_host=True)
        # the per-entity ledger only pays off if a later cycle can
        # actually patch — skip it (stay cold) while a persistent
        # environment condition forces full rebuilds regardless, e.g. a
        # DRA/volume deployment whose feature stores never empty
        if (self._cursor is None or cluster.resource_claims
                or cluster.device_classes or cluster.volume_claims
                or cluster.storage_classes):
            return state, index
        # pin realized padded dims as the next capacity (floors already
        # include the slack via `cap`; Y absorbs its own round-up slack)
        old_capacity = self._capacity
        self._capacity = SnapshotCapacity(
            nodes=host["nodes.valid"].shape[0],
            queues=host["queues.valid"].shape[0],
            gangs=host["gangs.valid"].shape[0],
            tasks=host["gangs.task_valid"].shape[1],
            running=host["running.valid"].shape[0],
            types=host["gangs.type_req"].shape[0])
        if self._capacity != old_capacity:
            # bucket hysteresis is scoped to ONE snapshot shape: a
            # rebuild that re-padded the axes changes the signature
            # regardless, and carrying a larger previous cluster's floors
            # forward would pin every future delta to its historical
            # maximum (inflated wire bytes and scatter work for good).
            # Same-shape rebuilds keep the floors.
            self._delta_buckets.clear()
        self._host, self._dev, self._index = host, state, index
        self._rebuild_ledgers(cluster, lists, host, index)
        return state, index

    def _rebuild_ledgers(self, cluster, lists, host, index) -> None:
        nodes, queues, groups, pods, topology = lists
        self._topology = cluster.topology
        # --- node-section caches (valid until any node is dirty) ---------
        self._node_names = index.node_names
        self._node_index = {n: i for i, n in enumerate(index.node_names)}
        live_nodes = [n for n in nodes if not n.unschedulable]
        self._node_objs = live_nodes
        self._node_cache = [
            (n, n.allocatable, n.labels, n.taints, n.extended,
             n.accel_memory_gib) for n in live_nodes]
        # the patch path only reproduces builds whose dense id spaces
        # are trivial — any residual vocabulary (from since-departed
        # feature pods) keeps forcing full rebuilds until one comes out
        # clean
        self._clean = (
            not index.selector_keys and not index.label_vocab
            and not index.extended_keys
            and host["nodes.filter_masks"].shape[0] == 1)
        self._accel_counts = np.fromiter(
            (int(round(n.allocatable.accel)) for n in live_nodes),
            np.int64, len(live_nodes))
        N = host["nodes.valid"].shape[0]
        D = host["nodes.device_free"].shape[1]
        tmpl = np.zeros((N, D), np.float32)
        for i, c in enumerate(self._accel_counts):
            tmpl[i, :c] = 1.0
        self._dev_template = tmpl
        self._queue_names = list(index.queue_names)
        # topology level resolution caches (gang encodes)
        if topology is None:
            topos: list[apis.Topology] = []
        elif isinstance(topology, apis.Topology):
            topos = [topology]
        else:
            topos = list(topology)
        self._topo_levels = [lvl for t in topos for lvl in t.levels]
        self._topo_slices = {}
        off = 0
        for t in topos:
            self._topo_slices[t.name] = (off, list(t.levels))
            off += len(t.levels)
        # --- gang ledger --------------------------------------------------
        NG = len(groups)
        # rows start as None so _encode_gang's nonplain delta-tracking
        # sees a fresh row (not the gang it is about to encode)
        self.g_objs: list = [None] * NG
        self.g_names: list[str] = [g.name for g in groups]
        self._gang_index = {g.name: i for i, g in enumerate(groups)}
        self.g_queue = np.zeros((NG,), np.int32)
        self.g_minm = np.zeros((NG,), np.int32)
        self.g_prio = np.zeros((NG,), np.int32)
        self.g_preempt = np.zeros((NG,), bool)
        self.g_unsched = np.zeros((NG,), bool)
        self.g_start = np.full((NG,), -1.0, np.float64)
        self.g_stale = np.full((NG,), np.nan, np.float64)
        self.g_reqlvl = np.full((NG,), -1, np.int32)
        self.g_preflvl = np.full((NG,), -1, np.int32)
        self.g_tc: list = [None] * NG
        self._q_index = {n: i for i, n in enumerate(self._queue_names)}
        self._nonplain_gangs = 0
        for i, g in enumerate(groups):
            self._encode_gang(i, g)
        # --- pod ledger ---------------------------------------------------
        U = len(pods)
        self.p_objs: list = [None] * U
        self.p_names = np.empty((U,), object)
        #: per-row (obj, raw status, raw node) — ONE list index per pod
        #: in the sweep's hot loop
        self.p_sweep: list = [None] * U
        self.p_live = np.zeros((U,), bool)
        self.p_req = np.zeros((U, R), np.float32)
        self.p_prio = np.zeros((U,), np.int64)
        self.p_crea = np.zeros((U,), np.float64)
        self.p_group = np.full((U,), -1, np.int32)
        self.p_leader = np.zeros((U,), bool)
        self.p_plain = np.zeros((U,), bool)
        self.p_devmask = np.zeros((U,), np.int32)
        self.p_held = np.zeros((U,), np.float32)
        self.p_hasdev = np.zeros((U,), bool)
        self.p_eff_status = np.full((U,), -1, np.int8)
        self.p_eff_node = np.full((U,), -1, np.int32)
        self.p_iid = np.full((U,), -1, np.int32)
        self.p_ti = np.full((U,), -1, np.int32)
        self._intern: dict[tuple, int] = {}
        self._intern_req = np.zeros((0, R), np.float32)
        self._nonplain = 0
        self._present_twice = 0
        # NOTE: ledger rows follow the RAW pod-dict order — the lists
        # argument interleaves presentation copies, so encode from the
        # cluster store itself (presentation is re-derived per row)
        self._pod_row = {}
        for row, (name, pod) in enumerate(cluster.pods.items()):
            self._pod_row[name] = row
            self._encode_pod(row, pod, cluster)
        self._order = np.arange(U, dtype=np.int64)
        self._order_list = list(range(U))
        #: BindRequest presentation cache — a Pending BR re-presents its
        #: pod as bound (snapshot_lists), so BR creation/phase/target
        #: drift must dirty the pod even when the pod object is untouched
        self._br_cache = {
            name: (br, br.phase, br.selected_node)
            for name, br in cluster.bind_requests.items()}
        # cached per-pod task slots come from the freshly built tables
        self._task_names_obj = np.array(index.task_names, dtype=object) \
            if index.task_names else np.full(
                (host["gangs.valid"].shape[0],
                 host["gangs.task_valid"].shape[1]), None, object)
        self._seed_task_slots(host)
        # constant gang-side tables reused by identity between refreshes
        self._const = dict(
            task_selector=host["gangs.task_selector"],
            task_portion=host["gangs.task_portion"],
            task_accel_mem=host["gangs.task_accel_mem"],
            task_filter_class=host["gangs.task_filter_class"],
            task_nominated=host["gangs.task_nominated"],
            anti_self_level=host["gangs.anti_self_level"],
            anti_marks=host["gangs.anti_marks"],
            anti_avoids=host["gangs.anti_avoids"],
            attract_needs=host["gangs.attract_needs"],
            anti_term_level=host["gangs.anti_term_level"],
            attract_static=host["gangs.attract_static"],
            task_subgroup=host["gangs.task_subgroup"],
            task_extended=host["gangs.task_extended"],
            task_dra=host["gangs.task_dra"],
            ext_accel=host["gangs.ext_accel"],
            type_selector=host["gangs.type_selector"],
            type_portion=host["gangs.type_portion"],
            type_mem=host["gangs.type_mem"],
            type_class=host["gangs.type_class"],
            type_extended=host["gangs.type_extended"],
        )

    def _seed_task_slots(self, host) -> None:
        """Recover per-pod (gang, slot) assignments from the built task
        tables so undirty gangs never need re-sorting."""
        self.p_ti[:] = -1
        names = self._task_names_obj
        G, T = names.shape
        name_row = self._pod_row
        gi, ti = np.nonzero(host["gangs.task_valid"])
        for g0, t0 in zip(gi.tolist(), ti.tolist()):
            nm = names[g0, t0]
            if nm is not None:
                row = name_row.get(nm)
                if row is not None:
                    self.p_ti[row] = t0

    # -- per-entity encodes ------------------------------------------------

    def _encode_gang(self, i, g: apis.PodGroup) -> None:
        prev = self.g_objs[i]
        was_nonplain = bool(prev is not None and prev.sub_groups)
        self._nonplain_gangs += int(bool(g.sub_groups)) - int(was_nonplain)
        self.g_objs[i] = g
        self.g_names[i] = g.name
        self.g_queue[i] = self._q_index.get(g.queue, 0)
        self.g_minm[i] = g.min_member
        self.g_prio[i] = g.priority
        self.g_preempt[i] = (
            g.preemptibility == apis.Preemptibility.PREEMPTIBLE)
        self.g_unsched[i] = bool(g.unschedulable)
        self.g_start[i] = (-1.0 if g.last_start_timestamp is None
                           else g.last_start_timestamp)
        self.g_stale[i] = (np.nan if g.stale_since is None
                           else g.stale_since)
        tc = g.topology_constraint
        self.g_tc[i] = tc
        self.g_reqlvl[i] = self._resolve_level(tc, "required_level")
        self.g_preflvl[i] = self._resolve_level(tc, "preferred_level")

    def _resolve_level(self, tc, attr) -> int:
        if tc is None or not self._topo_levels:
            return -1
        start, lvls = self._topo_slices.get(
            tc.topology, (0, self._topo_levels))
        name = getattr(tc, attr)
        return start + lvls.index(name) if name in lvls else -1

    def _encode_pod(self, row, pod: apis.Pod, cluster) -> None:
        was_plain = bool(self.p_plain[row]) if self.p_live[row] else True
        was_twice = bool(self.p_live[row]
                         and self.p_eff_status[row] == -2)
        self.p_objs[row] = pod
        self.p_names[row] = pod.name
        self.p_live[row] = True
        self.p_sweep[row] = (pod, pod.status, pod.node)
        self.p_req[row] = pod.resources.as_tuple()
        self.p_prio[row] = pod.priority
        self.p_crea[row] = pod.creation_timestamp
        self.p_group[row] = self._gang_index.get(pod.group, -1)
        labels = pod.labels
        self.p_leader[row] = (
            (labels.get("training.kubeflow.org/job-role")
             or labels.get("ray.io/node-type")) not in _LEADER_ROLES
            if labels else True)
        plain = _is_plain_pod(pod) and all(
            0 <= d < 32 for d in pod.accel_devices)
        self.p_plain[row] = plain
        self._nonplain += (not plain) - (not was_plain)
        k = int(round(pod.resources.accel))
        devs = list(pod.accel_devices)[:k] if plain else []
        mask = 0
        for d in devs:
            mask |= 1 << int(d)
        self.p_devmask[row] = mask
        self.p_held[row] = float(len(devs))
        self.p_hasdev[row] = bool(pod.accel_devices)
        # presented (effective) status — the snapshot_lists semantics
        st, nd = int(pod.status), pod.node
        twice = False
        br = cluster.bind_requests.get(pod.name)
        if br is not None and br.phase == "Pending":
            if st == _PENDING:
                st, nd = _BOUND, br.selected_node
            elif st == _RELEASING:
                twice = True  # presented twice: old node + rebind target
        self._present_twice += int(twice) - int(was_twice)
        self.p_eff_status[row] = -2 if twice else st
        self.p_eff_node[row] = (self._node_index.get(nd, -1)
                                if nd is not None else -1)
        key = tuple(float(x) for x in pod.resources.as_tuple())
        iid = self._intern.get(key)
        if iid is None:
            iid = len(self._intern)
            self._intern[key] = iid
            self._intern_req = np.concatenate(
                [self._intern_req,
                 np.asarray([key], np.float32)], axis=0)
        self.p_iid[row] = iid

    def _release_pod(self, row) -> None:
        if not self.p_live[row]:
            return
        self.p_live[row] = False
        self._nonplain -= int(not self.p_plain[row])
        self._present_twice -= int(self.p_eff_status[row] == -2)
        self.p_objs[row] = None
        self.p_sweep[row] = None

    # ------------------------------------------------------------------
    # Patch path
    # ------------------------------------------------------------------

    def _grow_pods(self, extra: int) -> None:
        """Grow the ARRAY capacity (lists append exactly; arrays carry
        slack so appends stay amortized O(1))."""
        U = len(self.p_live)
        n = max(extra, U // 2, 64)
        self.p_names = np.concatenate(
            [self.p_names, np.empty((n,), object)])
        for name in ("p_live", "p_leader", "p_plain", "p_hasdev"):
            setattr(self, name, np.concatenate(
                [getattr(self, name), np.zeros((n,), bool)]))
        self.p_req = np.concatenate(
            [self.p_req, np.zeros((n, R), np.float32)])
        self.p_prio = np.concatenate(
            [self.p_prio, np.zeros((n,), np.int64)])
        self.p_crea = np.concatenate(
            [self.p_crea, np.zeros((n,), np.float64)])
        self.p_group = np.concatenate(
            [self.p_group, np.full((n,), -1, np.int32)])
        self.p_devmask = np.concatenate(
            [self.p_devmask, np.zeros((n,), np.int32)])
        self.p_held = np.concatenate(
            [self.p_held, np.zeros((n,), np.float32)])
        self.p_eff_status = np.concatenate(
            [self.p_eff_status, np.full((n,), -1, np.int8)])
        self.p_eff_node = np.concatenate(
            [self.p_eff_node, np.full((n,), -1, np.int32)])
        self.p_iid = np.concatenate(
            [self.p_iid, np.full((n,), -1, np.int32)])
        self.p_ti = np.concatenate(
            [self.p_ti, np.full((n,), -1, np.int32)])

    def _grow_gangs(self, extra: int) -> None:
        """Array-capacity growth; the g_* lists append exactly."""
        n = max(extra, 8)
        self.g_queue = np.concatenate(
            [self.g_queue, np.zeros((n,), np.int32)])
        self.g_minm = np.concatenate(
            [self.g_minm, np.zeros((n,), np.int32)])
        self.g_prio = np.concatenate(
            [self.g_prio, np.zeros((n,), np.int32)])
        self.g_preempt = np.concatenate(
            [self.g_preempt, np.zeros((n,), bool)])
        self.g_unsched = np.concatenate(
            [self.g_unsched, np.zeros((n,), bool)])
        self.g_start = np.concatenate(
            [self.g_start, np.full((n,), -1.0, np.float64)])
        self.g_stale = np.concatenate(
            [self.g_stale, np.full((n,), np.nan, np.float64)])
        self.g_reqlvl = np.concatenate(
            [self.g_reqlvl, np.full((n,), -1, np.int32)])
        self.g_preflvl = np.concatenate(
            [self.g_preflvl, np.full((n,), -1, np.int32)])

    def _apply_journal(self, cluster, j) -> tuple[set, set]:
        """Membership + dirty-field updates → (dirty pod rows, dirty
        gang rows).  Raises _Fallback on anything unpatchable."""
        dirty_gangs: set[int] = set()
        dirty_rows: set[int] = set()
        membership = bool(j.pods_added or j.pods_removed)
        # gang appends first so new pods resolve their group row
        if j.gangs_added:
            for name in j.gangs_added:
                g = cluster.pod_groups.get(name)
                if g is None or name in self._gang_index:
                    raise _Fallback("gang-add-drift")
                i = len(self._gang_index)
                if i >= len(self.g_queue):
                    self._grow_gangs(max(8, i // 4))
                self.g_objs.append(None)
                self.g_names.append("")
                self.g_tc.append(None)
                self._gang_index[name] = i
                self._encode_gang(i, g)
                dirty_gangs.add(i)
            # a pod encoded before its group existed now resolves
            unresolved = np.nonzero(self.p_live
                                    & (self.p_group < 0))[0]
            for row in unresolved.tolist():
                gi = self._gang_index.get(self.p_objs[row].group, -1)
                if gi >= 0:
                    self.p_group[row] = gi
                    dirty_rows.add(row)
                    dirty_gangs.add(gi)
        for name in j.gangs_dirty:
            i = self._gang_index.get(name)
            if i is None:
                continue  # deleted since; structural would have fired
            g = cluster.pod_groups.get(name)
            if g is None:
                raise _Fallback("gang-removed-unjournaled")
            self._encode_gang(i, g)
            dirty_gangs.add(i)
        for name in j.pods_removed:
            row = self._pod_row.get(name)
            if row is None or not self.p_live[row]:
                continue
            gi = int(self.p_group[row])
            if gi >= 0:
                dirty_gangs.add(gi)
            self._release_pod(row)
            del self._pod_row[name]
            membership = True
        added_rows: list[int] = []
        for name in j.pods_added:
            pod = cluster.pods.get(name)
            if pod is None:
                continue  # added then removed within the window
            if name in self._pod_row:
                raise _Fallback("pod-add-drift")
            row = len(self.p_objs)
            if row >= len(self.p_live):
                self._grow_pods(64)
            self.p_objs.append(None)
            self.p_sweep.append(None)
            self._pod_row[name] = row
            self._encode_pod(row, pod, cluster)
            dirty_rows.add(row)
            added_rows.append(row)
            gi = int(self.p_group[row])
            if gi >= 0:
                dirty_gangs.add(gi)
        for name in j.pods_dirty:
            row = self._pod_row.get(name)
            if row is None:
                continue
            pod = cluster.pods.get(name)
            if pod is None:
                raise _Fallback("pod-removed-unjournaled")
            gi_old = int(self.p_group[row])
            self._encode_pod(row, pod, cluster)
            dirty_rows.add(row)
            for gi in (gi_old, int(self.p_group[row])):
                if gi >= 0:
                    dirty_gangs.add(gi)
        if membership or added_rows:
            keep = self.p_live[self._order]
            order = self._order[keep]
            if added_rows:
                order = np.concatenate(
                    [order, np.asarray(added_rows, np.int64)])
            self._order = order
            self._order_list = order.tolist()
        return dirty_rows, dirty_gangs

    def _sweep(self, cluster, dirty_rows: set, dirty_gangs: set) -> None:
        """Detect un-journaled drift: object replacement, status/node
        writes, gang status writes, node mutations.  Cheap identity and
        field compares; anything the ledger cannot attribute raises
        _Fallback (full rebuild) rather than serving stale state."""
        if len(cluster.pods) != len(self._order_list):
            raise _Fallback("pod-membership-drift")
        # BindRequest drift (created/replaced/phase-flipped/cleared —
        # bench and test harnesses touch the store directly): re-encode
        # the affected pods' presentation
        brs = cluster.bind_requests
        br_cache = self._br_cache
        br_dirty: list[str] = []
        if brs or br_cache:
            for name, br in brs.items():
                c = br_cache.get(name)
                if (c is None or c[0] is not br or c[1] != br.phase
                        or c[2] != br.selected_node):
                    br_dirty.append(name)
            if len(br_cache) != len(brs) or br_dirty:
                # sorted: the set difference iterates in hash order,
                # which would make the dirty-row encode order (and any
                # tie-broken downstream buffer) run-dependent (KAI041)
                for name in sorted(br_cache.keys() - brs.keys()):
                    br_dirty.append(name)
                self._br_cache = {
                    name: (br, br.phase, br.selected_node)
                    for name, br in brs.items()}
        for name in br_dirty:
            row = self._pod_row.get(name)
            if row is None or not self.p_live[row]:
                continue
            if row not in dirty_rows:
                self._encode_pod(row, self.p_objs[row], cluster)
                dirty_rows.add(row)
                gi = int(self.p_group[row])
                if gi >= 0:
                    dirty_gangs.add(gi)
        cache = self.p_sweep
        changed: list[int] = []
        for row, pod in zip(self._order_list, cluster.pods.values()):
            c = cache[row]
            if c[1] is not pod.status or c[0] is not pod \
                    or c[2] != pod.node:
                changed.append(row)
        for row in changed:
            pod = self.p_objs[row]
            if pod is not cache[row][0] or pod is not cluster.pods.get(
                    pod.name if pod is not None else ""):
                raise _Fallback("pod-object-drift")
            if row not in dirty_rows:
                self._encode_pod(row, pod, cluster)
                dirty_rows.add(row)
                gi = int(self.p_group[row])
                if gi >= 0:
                    dirty_gangs.add(gi)
        if len(cluster.pod_groups) != len(self.g_objs):
            raise _Fallback("gang-membership-drift")
        for i, g in enumerate(cluster.pod_groups.values()):
            if self.g_objs[i] is not g:
                raise _Fallback("gang-object-drift")
            start = (-1.0 if g.last_start_timestamp is None
                     else g.last_start_timestamp)
            stale_c = self.g_stale[i]
            stale_eq = ((g.stale_since is None and np.isnan(stale_c))
                        or (g.stale_since is not None
                            and stale_c == g.stale_since))
            if (bool(g.unschedulable) != bool(self.g_unsched[i])
                    or self.g_start[i] != start or not stale_eq
                    or self.g_tc[i] is not g.topology_constraint):
                if g.sub_groups:
                    raise _Fallback("gang-grew-subgroups")
                self._encode_gang(i, g)
                dirty_gangs.add(i)
        # nodes: any drift at all → full rebuild (vocabularies, masks,
        # device tables and capacity all hang off the node section)
        node_vals = [n for n in cluster.nodes.values()
                     if not n.unschedulable]
        if len(node_vals) != len(self._node_objs):
            raise _Fallback("node-membership-drift")
        for cached, n in zip(self._node_cache, node_vals):
            if (cached[0] is not n or cached[1] is not n.allocatable
                    or cached[2] is not n.labels
                    or cached[3] is not n.taints
                    or cached[4] is not n.extended
                    or cached[5] != n.accel_memory_gib):
                raise _Fallback("node-drift")
        if cluster.topology is not self._topology:
            raise _Fallback("topology-drift")

    def _patch(self, cluster, j, now, queue_usage):
        dirty_rows, dirty_gangs = self._apply_journal(cluster, j)
        self._sweep(cluster, dirty_rows, dirty_gangs)
        self._last_dirty = (len(dirty_rows), len(dirty_gangs))
        if self._nonplain > 0:
            raise _Fallback("nonplain-pods")
        if self._nonplain_gangs > 0:
            raise _Fallback("nonplain-gangs")
        if self._present_twice > 0:
            raise _Fallback("inflight-move")
        live = int(self.p_live.sum())
        dirty_frac = max(
            len(dirty_rows) / max(live, 1),
            len(dirty_gangs) / max(len(self.g_objs), 1))
        if dirty_frac > self.dirty_threshold:
            raise _Fallback("dirty-threshold")
        cap = self._capacity
        if len(self.g_objs) > cap.gangs:
            raise _Fallback("overflow-gangs")
        if len(self._queue_names) != len(cluster.queues):
            raise _Fallback("queue-set-changed")
        host_old = self._host
        if now is None:
            order = self._order
            now = float(self.p_crea[order].max()) if len(order) else 0.0
        return self._assemble(
            cluster, dirty_gangs, now, queue_usage, host_old)

    # -- assembly ----------------------------------------------------------

    def _assemble(self, cluster, dirty_gangs, now, queue_usage, old):
        cap = self._capacity
        G, T = cap.gangs, cap.tasks
        N, Q, M = cap.nodes, cap.queues, cap.running
        NG = len(self.g_objs)
        order = self._order
        eff = self.p_eff_status[order]
        grp_all = self.p_group[order]
        # --- queues (always re-encoded; tiny) ----------------------------
        queues = list(cluster.queues.values())
        qt = build_queue_tables(queues, Q)
        if qt["queue_names"] != self._queue_names:
            raise _Fallback("queue-order-changed")
        # --- pending intake ----------------------------------------------
        pend = order[(eff == _PENDING) & (grp_all >= 0)]
        intake = pend[np.argsort(self.p_group[pend], kind="stable")]
        counts = (np.bincount(self.p_group[intake], minlength=NG)
                  if NG else np.zeros((0,), np.int64))
        if counts.size and int(counts.max()) > T:
            raise _Fallback("overflow-tasks")
        # fresh first-encounter type ids from the stable intern ids
        iid_seq = self.p_iid[intake]
        if len(iid_seq):
            uniq, first, inv = np.unique(
                iid_seq, return_index=True, return_inverse=True)
            order_first = np.argsort(first, kind="stable")
            rank = np.empty(len(uniq), np.int64)
            rank[order_first] = np.arange(len(uniq))
            tid_seq = rank[inv]
            reps = uniq[order_first]
            Yn = len(uniq)
        else:
            tid_seq = np.zeros((0,), np.int64)
            reps = np.zeros((0,), np.int64)
            Yn = 0
        Y = _round_up(max(Yn, 1, cap.types), 4)
        if Y != cap.types and Yn > cap.types:
            raise _Fallback("overflow-types")
        # --- dirty-gang task rows -----------------------------------------
        task_valid = old["gangs.task_valid"]
        task_req = old["gangs.task_req"]
        task_type_old = old["gangs.task_type"]
        tnames = self._task_names_obj
        if dirty_gangs:
            dg = np.asarray(sorted(dirty_gangs), np.int64)
            task_valid = task_valid.copy()
            task_req = task_req.copy()
            tnames = tnames.copy()
            task_valid[dg] = False
            task_req[dg] = 0.0
            tnames[dg] = None
            dflag = np.zeros((NG,), bool)
            dflag[dg[dg < NG]] = True
            dsel = dflag[self.p_group[intake]]
            rows_d = intake[dsel]
            if len(rows_d):
                names_d = self.p_names[rows_d].astype(str)
                order_d = np.lexsort((
                    names_d, self.p_crea[rows_d], -self.p_prio[rows_d],
                    self.p_leader[rows_d], self.p_group[rows_d]))
                rows_s = rows_d[order_d]
                g_of = self.p_group[rows_s]
                first_g = np.ones(len(rows_s), bool)
                first_g[1:] = g_of[1:] != g_of[:-1]
                seg_start = np.nonzero(first_g)[0]
                seg = np.cumsum(first_g) - 1
                ti = (np.arange(len(rows_s)) - seg_start[seg]).astype(
                    np.int32)
                self.p_ti[rows_s] = ti
                task_valid[g_of, ti] = True
                task_req[g_of, ti] = self._intern_req[self.p_iid[rows_s]]
                tnames[g_of, ti] = self.p_names[rows_s]
            self._task_names_obj = tnames
        # task_type renumbers globally (dense first-encounter ids)
        task_type = np.zeros((G, T), np.int32)
        if len(intake):
            task_type[self.p_group[intake], self.p_ti[intake]] = tid_seq
        task_type = self._swap_if_equal(task_type, task_type_old)
        # --- type table ---------------------------------------------------
        type_req = np.zeros((Y, R), np.float32)
        if Yn:
            type_req[:Yn] = self._intern_req[reps]
        type_req = self._swap_if_equal(type_req, old["gangs.type_req"])
        # --- gang scalar tables (vectorized over the ledger) -------------
        gk_valid = np.zeros((G,), bool)
        gk_valid[:NG] = counts > 0
        queue_col = np.zeros((G,), np.int32)
        queue_col[:NG] = self.g_queue[:NG]
        min_member = np.zeros((G,), np.int32)
        min_member[:NG] = self.g_minm[:NG]
        priority = np.zeros((G,), np.int32)
        priority[:NG] = self.g_prio[:NG]
        preemptible = np.zeros((G,), bool)
        preemptible[:NG] = self.g_preempt[:NG]
        creation = np.zeros((G,), np.int32)
        creation[:NG] = np.arange(NG, dtype=np.int32)
        backoff = np.zeros((G,), np.int32)
        backoff[:NG] = self.g_unsched[:NG].astype(np.int32)
        req_lvl = np.full((G,), -1, np.int32)
        req_lvl[:NG] = self.g_reqlvl[:NG]
        pref_lvl = np.full((G,), -1, np.int32)
        pref_lvl[:NG] = self.g_preflvl[:NG]
        S = old["gangs.subgroup_valid"].shape[1]
        sub_valid = np.zeros((G, S), bool)
        sub_valid[:NG, 0] = True
        sub_minm = np.zeros((G, S), np.int32)
        sub_minm[:NG, 0] = min_member[:NG]
        sub_rlvl = np.full((G, S), -1, np.int32)
        sub_rlvl[:NG] = np.where(req_lvl[:NG, None] >= 0,
                                 req_lvl[:NG, None], -1)
        stale_s = np.full((G,), -1.0, np.float32)
        has_stale = ~np.isnan(self.g_stale[:NG])
        stale_s[:NG] = np.where(
            has_stale,
            np.maximum(0.0, now - np.where(has_stale, self.g_stale[:NG],
                                           0.0)),
            -1.0).astype(np.float32)
        # --- running section ---------------------------------------------
        run_sel = (eff >= _BOUND) & (eff <= _RELEASING)
        run_rows = order[run_sel]
        Mu = len(run_rows)
        if Mu > M:
            raise _Fallback("overflow-running")
        r_node = self.p_eff_node[run_rows]
        r_grp = self.p_group[run_rows]
        r_rel = self.p_eff_status[run_rows] == _RELEASING
        r_req = self.p_req[run_rows].copy()
        rk = dict(
            req=np.zeros((M, R), np.float32),
            node=np.full((M,), -1, np.int32),
            queue=np.zeros((M,), np.int32),
            gang=np.full((M,), -1, np.int32),
            priority=np.zeros((M,), np.int32),
            preemptible=np.zeros((M,), bool),
            valid=np.zeros((M,), bool),
            releasing=np.zeros((M,), bool),
            runtime_s=np.zeros((M,), np.float32),
            device=np.full((M,), -1, np.int32),
            devices_mask=np.zeros((M,), np.int32),
            accel_held=np.zeros((M,), np.float32),
            accel_mem=np.zeros((M,), np.float32),
            filter_class=np.zeros((M,), np.int32),
            extended=np.zeros((M, old["running.extended"].shape[1]),
                              np.float32),
        )
        running_count = np.zeros((G,), np.int32)
        sub_running = np.zeros((G, S), np.int32)
        if Mu:
            rk["req"][:Mu] = r_req
            rk["node"][:Mu] = r_node
            rk["gang"][:Mu] = r_grp
            rk["valid"][:Mu] = True
            rk["releasing"][:Mu] = r_rel
            has_grp = r_grp >= 0
            gsafe = np.maximum(r_grp, 0)
            if NG:
                rk["queue"][:Mu] = np.where(
                    has_grp, self.g_queue[:NG][gsafe], 0)
                rk["priority"][:Mu] = np.where(
                    has_grp, self.g_prio[:NG][gsafe], 0)
                rk["preemptible"][:Mu] = (has_grp
                                          & self.g_preempt[:NG][gsafe])
                started = self.g_start[:NG][gsafe]
                rk["runtime_s"][:Mu] = np.where(
                    has_grp & (started >= 0),
                    np.maximum(0.0, now - started), -1.0)
            active = has_grp & ~r_rel
            np.add.at(running_count, gsafe[active], 1)
            np.add.at(sub_running,
                      (gsafe[active],
                       np.zeros(int(active.sum()), np.int64)), 1)
        self._occupancy(rk, run_rows, r_node, r_rel, N)
        min_needed = np.maximum(min_member - running_count, 0)
        sub_min_needed = np.maximum(sub_minm - sub_running, 0)
        # --- scheduling signatures (same code as the builder) ------------
        task_sub = self._const["task_subgroup"]
        big = np.int64(Y) * (S + 1) + 1
        comp = np.where(task_valid,
                        task_type.astype(np.int64) * (S + 1) + task_sub,
                        big)
        comp = np.sort(comp, axis=1)
        sub_mn = np.where(sub_valid, sub_min_needed, -2)
        sub_rl = np.where(sub_valid, sub_rlvl, -2)
        sig_mat = np.concatenate([
            comp, sub_mn, sub_rl,
            queue_col[:, None].astype(np.int64),
            min_needed[:, None], req_lvl[:, None],
            pref_lvl[:, None], self._const["anti_self_level"][:, None],
            preemptible[:, None].astype(np.int64),
            (~gk_valid[:, None]).astype(np.int64),
        ], axis=1, dtype=np.int64)
        sig = dense_row_ids(sig_mat).astype(np.int32)
        # --- rollups (shared section builder) ----------------------------
        gk_roll = dict(task_req=task_req, task_valid=task_valid,
                       queue=queue_col, valid=gk_valid,
                       task_extended=self._const["task_extended"])
        roll = derive_rollups(
            node_alloc=old["nodes.allocatable"],
            claim_used=np.zeros((N, R), np.float32),
            rk=rk, gk=gk_roll,
            g_of_ext=self._const["ext_accel"],
            r_mig=np.zeros((M,), np.float32),
            queue_usage=queue_usage, q_index=qt["q_index"],
            q_parent=qt["q_parent"], q_depth=qt["q_depth"],
            num_queues=len(queues))
        # --- hints (same expressions as the builder) ---------------------
        has_fracs = bool(self._const["task_portion"].any()
                         or self._const["task_accel_mem"].any()
                         or (rk["device"] >= 0).any())
        tvm = task_valid[:, :, None]
        uniform = (
            not has_fracs
            and bool((self._const["task_nominated"] < 0).all())
            and bool((self._const["anti_self_level"] == -1).all())
            and bool((np.where(tvm, task_req, task_req[:, :1])
                      == task_req[:, :1]).all())
            and bool((np.where(
                tvm, self._const["task_selector"],
                self._const["task_selector"][:, :1])
                == self._const["task_selector"][:, :1]).all())
            and bool((np.where(
                task_valid, self._const["task_filter_class"],
                self._const["task_filter_class"][:, :1])
                == self._const["task_filter_class"][:, :1]).all()))
        node_valid = old["nodes.valid"]
        dense = (
            len(self._node_names) >= 0
            and bool(old["nodes.filter_masks"][0][
                node_valid].all())
            and bool((self._const["anti_self_level"] < 0).all())
            and bool((sub_rlvl < 0).all()))
        # --- assemble the host mirror ------------------------------------
        sw = self._swap_if_equal
        host_new = dict(old)
        host_new.update({
            "gangs.queue": sw(queue_col, old["gangs.queue"]),
            "gangs.min_member": sw(min_member, old["gangs.min_member"]),
            "gangs.priority": sw(priority, old["gangs.priority"]),
            "gangs.preemptible": sw(preemptible, old["gangs.preemptible"]),
            "gangs.valid": sw(gk_valid, old["gangs.valid"]),
            "gangs.creation_order": sw(creation,
                                       old["gangs.creation_order"]),
            "gangs.backoff": sw(backoff, old["gangs.backoff"]),
            "gangs.task_req": sw(task_req, old["gangs.task_req"]),
            "gangs.task_valid": sw(task_valid, old["gangs.task_valid"]),
            "gangs.required_level": sw(req_lvl,
                                       old["gangs.required_level"]),
            "gangs.preferred_level": sw(pref_lvl,
                                        old["gangs.preferred_level"]),
            "gangs.running_count": sw(running_count,
                                      old["gangs.running_count"]),
            "gangs.min_needed": sw(min_needed, old["gangs.min_needed"]),
            "gangs.stale_s": sw(stale_s, old["gangs.stale_s"]),
            "gangs.task_type": sw(task_type, task_type_old),
            "gangs.sig": sw(sig, old["gangs.sig"]),
            "gangs.type_req": type_req,
            "gangs.subgroup_valid": sw(sub_valid,
                                       old["gangs.subgroup_valid"]),
            "gangs.subgroup_min_member": sw(
                sub_minm, old["gangs.subgroup_min_member"]),
            "gangs.subgroup_min_needed": sw(
                sub_min_needed, old["gangs.subgroup_min_needed"]),
            "gangs.subgroup_required_level": sw(
                sub_rlvl, old["gangs.subgroup_required_level"]),
        })
        host_new.update({
            f"running.{k}": sw(v, old[f"running.{k}"])
            for k, v in rk.items()})
        host_new.update({
            "queues.parent": sw(qt["q_parent"], old["queues.parent"]),
            "queues.depth": sw(qt["q_depth"], old["queues.depth"]),
            "queues.priority": sw(qt["q_priority"],
                                  old["queues.priority"]),
            "queues.quota": sw(qt["q_quota"], old["queues.quota"]),
            "queues.over_quota_weight": sw(
                qt["q_oqw"], old["queues.over_quota_weight"]),
            "queues.limit": sw(qt["q_limit"], old["queues.limit"]),
            "queues.allocated": sw(roll["q_alloc"],
                                   old["queues.allocated"]),
            "queues.allocated_nonpreemptible": sw(
                roll["q_alloc_np"],
                old["queues.allocated_nonpreemptible"]),
            "queues.request": sw(roll["q_request"], old["queues.request"]),
            "queues.usage": sw(roll["q_usage"], old["queues.usage"]),
            "queues.valid": sw(qt["q_valid"], old["queues.valid"]),
            "queues.creation_order": sw(qt["q_creation"],
                                        old["queues.creation_order"]),
            "queues.preempt_min_runtime": sw(
                qt["q_preempt_mrt"], old["queues.preempt_min_runtime"]),
            "queues.reclaim_min_runtime": sw(
                qt["q_reclaim_mrt"], old["queues.reclaim_min_runtime"]),
            "queues.preempt_min_runtime_eff": sw(
                np.asarray(qt["q_preempt_eff"], np.float32),
                old["queues.preempt_min_runtime_eff"]),
            "queues.reclaim_min_runtime_eff": sw(
                np.asarray(qt["q_reclaim_eff"], np.float32),
                old["queues.reclaim_min_runtime_eff"]),
        })
        host_new.update({
            "nodes.free": sw(roll["node_free"], old["nodes.free"]),
            "nodes.releasing": sw(roll["node_rel"], old["nodes.releasing"]),
            "nodes.device_free": sw(self._occ_dev_free,
                                    old["nodes.device_free"]),
            "nodes.device_releasing": sw(self._occ_dev_rel,
                                         old["nodes.device_releasing"]),
        })
        # --- index --------------------------------------------------------
        running_names = [""] * M
        if Mu:
            running_names[:Mu] = self.p_names[run_rows].tolist()
        index = _cs.SnapshotIndex(
            node_names=self._node_names,
            queue_names=qt["queue_names"],
            gang_names=list(self.g_names),
            task_names=self._task_names_obj.tolist(),
            running_pod_names=running_names,
            selector_keys=[],
            label_vocab={},
            topology_levels=self._topo_levels,
            needs_device_table=has_fracs,
            uniform_gangs=uniform,
            has_required_topology=bool((req_lvl >= 0).any()),
            has_preferred_topology=bool((pref_lvl >= 0).any()),
            has_subgroup_topology=bool((sub_rlvl >= 0).any()),
            has_extended_resources=False,
            extended_keys=[],
            has_reclaim_minruntime=bool((qt["q_reclaim_mrt"] > 0).any()),
            has_anti_groups=len(self._const["anti_term_level"]) > 0,
            num_anti_groups=len(self._const["anti_term_level"]),
            has_attract_groups=bool(
                (self._const["attract_needs"] >= 0).any()),
            max_queue_depth=int(qt["q_depth"].max(initial=0)),
            num_leaf_queues=int(
                (qt["q_valid"] & ~np.isin(
                    np.arange(Q),
                    qt["q_parent"][qt["q_parent"] >= 0])).sum()),
            num_pending_gangs=int(
                host_new["gangs.task_valid"].any(axis=1).sum()),
            claims_by_pod={},
            host_tables={
                "task_portion": self._const["task_portion"],
                "task_accel_mem": self._const["task_accel_mem"],
                "task_req0": np.ascontiguousarray(task_req[:, :, 0]),
                "task_dra": self._const["task_dra"],
                "running_gang": rk["gang"],
                "queue_usage": roll["q_usage"],
                # the device-side gangs.valid mask (gangs with pending
                # tasks), host copy: the starvation counters advance
                # against exactly what the analytics kernel sees
                "gang_valid": host_new["gangs.valid"],
            },
            dense_feasibility=dense,
        )
        # pre-seed the columnar name views (cached_property slots)
        index.task_names_arr = self._task_names_obj
        index.node_names_arr = np.array(self._node_names, dtype=object)
        index.gang_names_arr = np.array(index.gang_names, dtype=object)
        index.running_pod_names_arr = np.array(running_names,
                                               dtype=object)
        return host_new, index

    @staticmethod
    def _swap_if_equal(new: np.ndarray, old: np.ndarray) -> np.ndarray:
        """Reuse the previous cycle's array object when the recomputed
        content is identical — downstream, `is` short-circuits both the
        ship compare and the device transfer."""
        if (new is old) or (new.shape == old.shape
                            and new.dtype == old.dtype
                            and np.array_equal(new, old)):
            return old
        return new

    # -- device occupancy (gated subset of the builder's section) ---------

    def _occupancy(self, rk, run_rows, r_node, r_rel, N) -> None:
        D = self._dev_template.shape[1]
        dev_free = self._dev_template.copy()
        dev_rel = np.zeros((N, D), np.float32)
        whole_k = np.rint(self.p_req[run_rows, 0]).astype(np.int64)
        has_dev = self.p_hasdev[run_rows]
        on = r_node >= 0
        touches = on & (whole_k > 0)
        special = touches & has_dev
        node_special = np.zeros((N,), bool)
        node_special[r_node[special]] = True
        vec = touches & ~special & ~node_special[np.maximum(r_node, 0)]
        vj = np.nonzero(vec)[0]
        if len(vj):
            accel_counts_a = self._accel_counts
            vn = r_node[vj]
            ordv = np.argsort(vn, kind="stable")
            vj, vn = vj[ordv], vn[ordv]
            vk = whole_k[vj]
            cum = np.cumsum(vk) - vk
            first = np.ones(len(vj), bool)
            first[1:] = vn[1:] != vn[:-1]
            grp = np.cumsum(first) - 1
            off = cum - cum[np.nonzero(first)[0]][grp]
            k_eff = np.clip(accel_counts_a[vn] - off, 0, vk)
            end = off + k_eff
            rk["devices_mask"][vj] = (
                (np.int64(1) << end) - (np.int64(1) << off)
            ).astype(np.int32)
            rk["accel_held"][vj] = k_eff.astype(np.float32)
            tot = int(k_eff.sum())
            if tot:
                rep = np.repeat(np.arange(len(vj)), k_eff)
                dpos = (np.arange(tot)
                        - np.repeat(np.cumsum(k_eff) - k_eff, k_eff)
                        + np.repeat(off, k_eff))
                nrep = vn[rep]
                dev_free[nrep, dpos] = 0.0
                relm = r_rel[vj][rep]
                dev_rel[nrep[relm], dpos[relm]] += 1.0
        rest = np.nonzero(touches & ~vec)[0]
        if len(rest):
            # exact vectorized path for recorded-device whole pods: a
            # debit is the template value and order is irrelevant UNLESS
            # the node hosts a first-fit pod (no recorded devices) or a
            # double-booked device cell — only those nodes' pods replay
            # the builder's sequential loop
            seq_nodes = np.zeros((N,), bool)
            seq_nodes[r_node[rest[~has_dev[rest]]]] = True
            vecr = rest[~seq_nodes[r_node[rest]]]
            masks = self.p_devmask[run_rows[vecr]]

            def held_cells(sub, sub_masks):
                """(node*D + dev) flat indices of every held device."""
                pj, dj = np.nonzero(
                    (sub_masks[:, None] >> np.arange(D)) & 1)
                return r_node[sub][pj] * D + dj

            cells = held_cells(vecr, masks)
            cnt = np.bincount(cells, minlength=N * D)
            booked_nodes = np.nonzero(
                (cnt.reshape(N, D) > 1).any(axis=1))[0]
            if len(booked_nodes):
                seq_nodes[booked_nodes] = True
                keep = ~seq_nodes[r_node[vecr]]
                vecr, masks = vecr[keep], masks[keep]
                cells = held_cells(vecr, masks)
                cnt = np.bincount(cells, minlength=N * D)
            if len(vecr):
                tmpl = self._dev_template
                dev_free -= tmpl * (cnt.reshape(N, D) > 0)
                rk["devices_mask"][vecr] = masks
                rk["accel_held"][vecr] = self.p_held[run_rows[vecr]]
                relj = vecr[r_rel[vecr]]
                if len(relj):
                    rel_cells = held_cells(relj,
                                           self.p_devmask[run_rows[relj]])
                    dev_rel += (tmpl.reshape(-1) * np.bincount(
                        rel_cells, minlength=N * D)).reshape(N, D)
            seq = rest[seq_nodes[r_node[rest]]]
            if len(seq):
                self._occupancy_sequential(
                    rk, run_rows, r_node, r_rel, seq, whole_k,
                    dev_free, dev_rel)
        self._occ_dev_free = dev_free
        self._occ_dev_rel = dev_rel

    def _occupancy_sequential(self, rk, run_rows, r_node, r_rel, rest,
                              whole_k, dev_free, dev_rel) -> None:
        """Builder-identical per-pod loop for order-dependent cases
        (first-fit pods on device-recorded nodes, double-booked cells)."""
        for jj in rest.tolist():
            pod = self.p_objs[run_rows[jj]]
            ni = int(r_node[jj])
            k = int(whole_k[jj])
            if pod.accel_devices:
                devs = list(pod.accel_devices)[:k]
            else:
                devs = list(np.nonzero(
                    dev_free[ni] >= 1.0 - 1e-6)[0][:k])
            mask = 0
            for d0 in devs:
                taken = min(1.0, dev_free[ni, d0])
                dev_free[ni, d0] -= taken
                if r_rel[jj]:
                    dev_rel[ni, d0] += taken
                mask |= 1 << int(d0)
            rk["devices_mask"][jj] = mask
            rk["accel_held"][jj] = float(len(devs))

    # -- shipping ----------------------------------------------------------

    def _ship(self, host_new: dict):
        """Upload only the changed leaves; unchanged leaves keep their
        previous device tensors (and their previous host arrays, so the
        next cycle's compares short-circuit on identity).

        The changed leaves go in ONE ledger call (reason
        ``journal-patch``, one buffer, one copy) under the same leaf names
        the full build uses, so redundancy tracking spans both paths; the
        new tensors are swapped into a new ``ClusterState``.
        """
        t_ship = time.perf_counter()
        out_host = dict(self._host)
        changed: dict[str, np.ndarray] = {}
        bytes_ = 0
        for name in leaf_paths():
            new, old = host_new[name], self._host[name]
            # equal_nan on float leaves: a NaN-carrying leaf (unset stale
            # timestamps) must not read as changed forever
            if new is old or (
                    getattr(new, "shape", None) == old.shape
                    and new.dtype == old.dtype
                    and np.array_equal(new, old,
                                       equal_nan=new.dtype.kind == "f")):
                continue
            changed[name] = new
            out_host[name] = new
            bytes_ += int(new.nbytes)
        leaves = len(changed)
        dispatches = 0
        dev_leaves = _cs.state_leaves(self._dev)
        if changed:
            dispatches = 1
            dev_leaves.update(_wire.LEDGER.device_put(
                changed, device=self.device,
                reason=_wire.REASON_JOURNAL_PATCH))
        self._host = out_host
        self._dev = _cs.state_from_leaves(dev_leaves)
        ship_s = time.perf_counter() - t_ship
        self.stats.leaves_shipped += leaves
        self.stats.bytes_shipped += bytes_
        # the copy is asynchronous on the card: this times its enqueue,
        # and the cycle's first device read absorbs the rest
        self._last_ship = (leaves, bytes_, ship_s, dispatches)
        return self._dev

    # -- verification ------------------------------------------------------

    def _verify(self, cluster, now, queue_usage) -> None:
        """Assert the patched mirror equals a fresh full rebuild,
        element-wise, including the index name maps."""
        # reason "verify" on the wire ledger: the reference rebuild's
        # upload is deliberate, not patch-path redundancy
        with _wire.LEDGER.override_reason(_wire.REASON_VERIFY):
            _, fresh_index, fresh_host = _cs.build_snapshot(
                *cluster.snapshot_lists(), device=self.device, now=now,
                queue_usage=queue_usage,
                resource_claims=cluster.resource_claims,
                device_classes=cluster.device_classes,
                volume_claims=cluster.volume_claims,
                storage_classes=cluster.storage_classes,
                capacity=self._capacity, return_host=True)
        for name in leaf_paths():
            mine, ref = self._host[name], fresh_host[name]
            if mine.shape != ref.shape or mine.dtype != ref.dtype:
                raise IncrementalVerifyError(
                    f"leaf {name}: shape/dtype {mine.shape}/{mine.dtype}"
                    f" != {ref.shape}/{ref.dtype}")
            if not np.array_equal(mine, ref):
                bad = np.nonzero(mine != ref)
                raise IncrementalVerifyError(
                    f"leaf {name}: {len(bad[0])} mismatching elements "
                    f"(first at {[int(b[0]) for b in bad if len(b)]})")
        mine_i, ref_i = self._index, fresh_index
        for field in ("node_names", "queue_names", "gang_names",
                      "task_names", "running_pod_names", "selector_keys",
                      "label_vocab", "topology_levels",
                      "needs_device_table", "uniform_gangs",
                      "has_required_topology", "has_preferred_topology",
                      "has_subgroup_topology", "has_extended_resources",
                      "extended_keys", "has_reclaim_minruntime",
                      "has_anti_groups", "has_attract_groups",
                      "max_queue_depth", "num_leaf_queues",
                      "num_pending_gangs",
                      "num_anti_groups", "claims_by_pod",
                      "dense_feasibility"):
            if getattr(mine_i, field) != getattr(ref_i, field):
                raise IncrementalVerifyError(
                    f"index.{field}: {getattr(mine_i, field)!r} != "
                    f"{getattr(ref_i, field)!r}")
