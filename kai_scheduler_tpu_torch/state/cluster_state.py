"""The tensorized cluster snapshot — the PyTorch port.

Port of ``kai_scheduler_tpu/state/cluster_state.py``: the reference's
struct-of-arrays pytree (flax ``PyTreeNode`` classes) becomes plain
dataclasses of ``torch.Tensor`` with the SAME leaf names, shapes and
dtypes, so every per-cycle decision — fairness division, predicate
masks, scoring, gang allocation — stays a tensor op over static shapes:

- node axis  ``N``  (padded)            — ref NodeInfo
- queue axis ``Q``  (padded, 2+ levels) — ref QueueInfo
- gang axis  ``G``  (padded PodGroups)  — ref PodGroupInfo
- task axis  ``T``  (pending tasks per gang, padded) — ref tasksToAllocate
- running-pod axis ``M`` (bound/running pods, victims) — ref PodInfo
- resource axis ``R = 3`` (accel devices, cpu cores, mem GiB)
- selector-key axis ``K`` (label vocabulary for nodeSelector matching)
- topology-level axis ``L`` (domain id per physical level)

The host assembly (:func:`build_snapshot_host`) is the reference's numpy
code copied whole, so both packages derive identical leaves from the
same API objects; :func:`state_from_numpy` then uploads every leaf to the
device in ONE host-to-device copy (the leaves are views into one device
buffer) through the transfer ledger (``runtime/wire_ledger.py``, reason
``full-build`` unless the caller overrides it).
"""
from __future__ import annotations

import dataclasses
import functools
import re
import time

import numpy as np
import torch

from ..apis import types as apis
from ..device import resolve_device
from ..runtime import wire_ledger as _wire
from . import node_filters

UNLIMITED = apis.UNLIMITED
R = apis.NUM_RESOURCES

Tensor = torch.Tensor


@dataclasses.dataclass
class NodeState:
    """Per-node accounting — ref ``api/node_info/node_info.go:68-96``.

    ``free`` mirrors NodeInfo.Idle; ``releasing`` the resources of
    terminating pods; ``allocatable`` the total.  ``device_free`` is the
    per-accelerator share table (1.0 = device fully free).
    """

    allocatable: Tensor   # f32 [N, R]
    free: Tensor          # f32 [N, R]
    releasing: Tensor     # f32 [N, R]
    valid: Tensor         # bool [N]
    labels: Tensor        # i32 [N, K]   value-id per selector key, -1 = unset
    topology: Tensor      # i32 [N, L]   domain id per level
    device_free: Tensor       # f32 [N, D]  idle share per device
    device_releasing: Tensor  # f32 [N, D]  share being released per device
    device_memory_gib: Tensor  # f32 [N]
    #: hard feasibility per (filter-class, node), host-evaluated
    filter_masks: Tensor      # bool [X, N]
    #: soft bands per (filter-class, node), pre-weighted (K8sPlugins band)
    soft_scores: Tensor       # f32 [X, N]
    extended_free: Tensor       # f32 [N, E]
    extended_releasing: Tensor  # f32 [N, E]

    @property
    def n(self) -> int:
        return self.valid.shape[0]

    @property
    def d(self) -> int:
        return self.device_free.shape[1]


@dataclasses.dataclass
class QueueState:
    """Queue hierarchy + resource shares — ref ``api/queue_info`` and the
    proportion plugin's ``resource_share.ResourceShare``."""

    parent: Tensor        # i32 [Q]  index of parent queue, -1 = top level
    depth: Tensor         # i32 [Q]  0 = top level
    priority: Tensor      # i32 [Q]
    quota: Tensor         # f32 [Q, R]  deserved; UNLIMITED sentinel allowed
    over_quota_weight: Tensor  # f32 [Q, R]
    limit: Tensor         # f32 [Q, R]  maxAllowed; UNLIMITED sentinel
    allocated: Tensor     # f32 [Q, R]
    allocated_nonpreemptible: Tensor  # f32 [Q, R]
    request: Tensor       # f32 [Q, R]  allocated + pending requests
    usage: Tensor         # f32 [Q, R]  normalized historical usage
    fair_share: Tensor    # f32 [Q, R]  output of the DRF division kernel
    valid: Tensor         # bool [Q]
    creation_order: Tensor  # i32 [Q]  tie-break (older first)
    preempt_min_runtime: Tensor  # f32 [Q]
    reclaim_min_runtime: Tensor  # f32 [Q]
    preempt_min_runtime_eff: Tensor  # f32 [Q]
    reclaim_min_runtime_eff: Tensor  # f32 [Q, Q]  [victim, reclaimer]

    @property
    def q(self) -> int:
        return self.valid.shape[0]


@dataclasses.dataclass
class GangState:
    """Pending pod groups with padded task tables — ref PodGroupInfo.
    Field meanings follow the reference's ``GangState`` one for one."""

    queue: Tensor         # i32 [G]
    min_member: Tensor    # i32 [G]
    priority: Tensor      # i32 [G]
    preemptible: Tensor   # bool [G]
    valid: Tensor         # bool [G]
    creation_order: Tensor  # i32 [G]
    backoff: Tensor       # i32 [G]
    task_req: Tensor      # f32 [G, T, R]
    task_valid: Tensor    # bool [G, T]
    task_selector: Tensor  # i32 [G, T, K]
    task_portion: Tensor  # f32 [G, T]
    task_accel_mem: Tensor  # f32 [G, T]
    required_level: Tensor   # i32 [G]
    preferred_level: Tensor  # i32 [G]
    running_count: Tensor    # i32 [G]
    min_needed: Tensor       # i32 [G]
    stale_s: Tensor          # f32 [G]
    task_filter_class: Tensor  # i32 [G, T]
    task_type: Tensor          # i32 [G, T]
    sig: Tensor                # i32 [G]
    task_extended: Tensor      # f32 [G, T, E]
    ext_accel: Tensor          # f32 [E]
    task_dra: Tensor           # i32 [G, T]
    type_req: Tensor           # f32 [Y, R]
    type_selector: Tensor      # i32 [Y, K]
    type_portion: Tensor       # f32 [Y]
    type_mem: Tensor           # f32 [Y]
    type_class: Tensor         # i32 [Y]
    type_extended: Tensor      # f32 [Y, E]
    task_subgroup: Tensor        # i32 [G, T]
    subgroup_valid: Tensor       # bool [G, S]
    subgroup_min_member: Tensor  # i32 [G, S]
    subgroup_min_needed: Tensor  # i32 [G, S]
    subgroup_required_level: Tensor  # i32 [G, S]
    task_nominated: Tensor     # i32 [G, T]
    anti_self_level: Tensor    # i32 [G]
    anti_marks: Tensor         # i32 [G, KT]
    anti_avoids: Tensor        # i32 [G, KT]
    anti_term_level: Tensor    # i32 [TA]
    attract_needs: Tensor      # i32 [G, KP]
    attract_static: Tensor     # bool [TA, N]

    @property
    def s(self) -> int:
        return self.subgroup_valid.shape[1]

    @property
    def g(self) -> int:
        return self.valid.shape[0]

    @property
    def t(self) -> int:
        return self.task_valid.shape[1]


@dataclasses.dataclass
class RunningState:
    """Bound/running pods — the victim candidates (ref PodInfo)."""

    req: Tensor           # f32 [M, R]
    node: Tensor          # i32 [M]
    queue: Tensor         # i32 [M]
    gang: Tensor          # i32 [M]
    priority: Tensor      # i32 [M]
    preemptible: Tensor   # bool [M]
    valid: Tensor         # bool [M]
    releasing: Tensor     # bool [M]
    runtime_s: Tensor     # f32 [M]
    device: Tensor        # i32 [M]
    devices_mask: Tensor  # i32 [M]
    accel_held: Tensor    # f32 [M]
    accel_mem: Tensor     # f32 [M]
    filter_class: Tensor  # i32 [M]
    extended: Tensor      # f32 [M, E]

    @property
    def m(self) -> int:
        return self.valid.shape[0]


@dataclasses.dataclass
class ClusterState:
    """The full per-cycle snapshot handed to the solver kernels."""

    nodes: NodeState
    queues: QueueState
    gangs: GangState
    running: RunningState

    @property
    def device(self) -> torch.device:
        return self.nodes.valid.device

    @property
    def total_capacity(self) -> Tensor:
        """Cluster-wide allocatable per resource, f32 [R]."""
        return torch.where(self.nodes.valid[:, None], self.nodes.allocatable,
                           0.0).sum(0)


#: section name -> dataclass, in ClusterState field order
_SECTIONS = (("nodes", NodeState), ("queues", QueueState),
             ("gangs", GangState), ("running", RunningState))


def leaf_paths() -> list[str]:
    """Dotted field paths of every ClusterState leaf (``nodes.free`` ...)."""
    return [f"{sec}.{f.name}" for sec, cls in _SECTIONS
            for f in dataclasses.fields(cls)]


_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.bool_): torch.bool}


def state_from_numpy(leaves: dict[str, "np.ndarray"],
                     device: "str | torch.device" = "cuda") -> ClusterState:
    """Map ClusterState leaves, keyed by dotted field path and given as
    numpy arrays (the JAX reference's leaves convert one for one), to the
    port's ``ClusterState`` on ``device``.

    Every leaf is packed into one host buffer (16-byte aligned slots) and
    copied to the device in ONE transfer through the transfer ledger
    (reason ``full-build``, or the one its ``override_reason`` sets); the
    leaves are typed views into that buffer.  Solver code never writes
    into state leaves; the resident path's delta apply
    (``ops/resident.apply_delta``) does, in place, into the snapshot the
    incremental snapshotter keeps on the device between cycles.
    """
    dev = resolve_device(device)
    arrs = {}
    for path in leaf_paths():
        if path not in leaves:
            raise KeyError(f"missing leaf {path}")
        a = np.asarray(leaves[path])
        if a.dtype not in _NP_TO_TORCH:
            raise TypeError(f"leaf {path} has dtype {a.dtype}")
        arrs[path] = a
    views = _wire.LEDGER.device_put(
        arrs, device=dev, reason=_wire.REASON_FULL_BUILD, site="snapshot",
        replace_site=True)
    return state_from_leaves(views)


def state_from_leaves(views: dict[str, Tensor]) -> ClusterState:
    """A ``ClusterState`` over tensors keyed by dotted field path."""
    return ClusterState(**{
        sec: cls(**{f.name: views[f"{sec}.{f.name}"]
                    for f in dataclasses.fields(cls)})
        for sec, cls in _SECTIONS})


def state_leaves(state: ClusterState) -> dict[str, Tensor]:
    """The state's tensors keyed by dotted field path, in
    :func:`leaf_paths` order."""
    return {f"{sec}.{f.name}": getattr(getattr(state, sec), f.name)
            for sec, cls in _SECTIONS for f in dataclasses.fields(cls)}


def state_to_numpy(state: ClusterState) -> dict[str, "np.ndarray"]:
    """The inverse of :func:`state_from_numpy` (host copies)."""
    return {k: t.detach().cpu().numpy()
            for k, t in state_leaves(state).items()}


# ---------------------------------------------------------------------------
# Padding helpers
# ---------------------------------------------------------------------------

#: MINIMUM in-cycle exclusion term slots per gang (marks/avoids each);
#: the snapshot builder widens the slot dimension (bucketed to powers of
#: two) whenever a gang carries more distinct terms, so no term is ever
#: dropped — only the compiled shape changes
ANTI_SLOTS = 4


def _round_up(n: int, multiple: int = 8) -> int:
    """Pad sizes to multiples so capacity growth rarely recompiles."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n — the shared slot/row bucketing, so
    count drift across cycles rarely changes a compiled shape."""
    return 1 << max(0, n - 1).bit_length()


def dense_row_ids(mat: "np.ndarray") -> "np.ndarray":
    """Dense ids over distinct rows, identical to
    ``np.unique(mat, axis=0, return_inverse=True)[1]`` (ids index the
    lexicographically sorted distinct rows) but ~50x faster at the
    scheduling-signature shape: ``unique(axis=0)`` compares rows as
    void scalars, one memcmp per comparison, while a column lexsort +
    neighbor compare stays fully vectorized."""
    if not len(mat):
        return np.zeros((0,), np.int64)
    order = np.lexsort(mat.T[::-1])
    s = mat[order]
    neq = np.any(s[1:] != s[:-1], axis=1)
    ranks = np.concatenate([[0], np.cumsum(neq)])
    inv = np.empty(len(mat), np.int64)
    inv[order] = ranks
    return inv


#: leader-role label values — ref plugins/kubeflow (job-role master/
#: launcher) and plugins/ray (node-type head)
_LEADER_ROLES = ("master", "launcher", "head")


@dataclasses.dataclass(frozen=True)
class SnapshotCapacity:
    """Padded-size floors for the snapshot axes.

    The incremental snapshotter (``state/incremental.py``) pins these so
    consecutive cycles keep identical compiled shapes while entity
    counts drift — capacity only grows (with slack) at full rebuilds,
    mirroring how the reference's cache rarely reallocates.  Zero floors
    keep the plain count-derived padding.
    """

    nodes: int = 0
    queues: int = 0
    gangs: int = 0
    tasks: int = 0
    running: int = 0
    types: int = 0


# ---------------------------------------------------------------------------
# Per-section builders — factored out of build_snapshot so the
# incremental snapshotter (state/incremental.py) re-derives sections
# from cached encodes through the SAME code paths the full build runs.
# ---------------------------------------------------------------------------


def build_queue_tables(queues: list[apis.Queue], Q: int) -> dict:
    """Per-queue static tables + minruntime hierarchy resolution.

    Ref ``api/queue_info`` and ``plugins/minruntime`` (resolver.go) —
    see the inline comments.  Returns every ``q_*`` array keyed by name
    plus ``q_index``/``queue_names``.
    """
    queue_names = [q.name for q in queues]
    q_index = {name: i for i, name in enumerate(queue_names)}
    q_parent = np.full((Q,), -1, np.int32)
    q_depth = np.zeros((Q,), np.int32)
    q_priority = np.zeros((Q,), np.int32)
    q_quota = np.zeros((Q, R), np.float32)
    q_oqw = np.zeros((Q, R), np.float32)
    q_limit = np.full((Q, R), UNLIMITED, np.float32)
    q_valid = np.zeros((Q,), bool)
    q_creation = np.zeros((Q,), np.int32)
    q_preempt_mrt = np.zeros((Q,), np.float32)
    q_reclaim_mrt = np.zeros((Q,), np.float32)
    for i, q in enumerate(queues):
        q_valid[i] = True
        q_priority[i] = q.priority
        q_creation[i] = i
        q_preempt_mrt[i] = q.preempt_min_runtime
        q_reclaim_mrt[i] = q.reclaim_min_runtime
        if q.parent is not None:
            q_parent[i] = q_index[q.parent]
        for r in range(R):
            qr = q.resource(r)
            q_quota[i, r] = qr.quota
            q_oqw[i, r] = qr.over_quota_weight
            q_limit[i, r] = qr.limit
    # depth by chasing parents (hierarchy is shallow; bounded loop)
    for i in range(len(queues)):
        d, p = 0, int(q_parent[i])
        while p >= 0:
            d, p = d + 1, int(q_parent[p])
        q_depth[i] = d

    # --- minruntime hierarchy resolution (ref plugins/minruntime) ---------
    def _inherit(vals: np.ndarray) -> np.ndarray:
        """First set (>0) value walking self → root; 0 when none."""
        eff = vals.copy()
        cur = q_parent.copy()
        for _ in range(int(q_depth.max(initial=0)) + 1):
            unset = (eff <= 0) & (cur >= 0)
            if not unset.any():
                break
            eff[unset] = vals[cur[unset]]
            cur = np.where(cur >= 0, q_parent[np.maximum(cur, 0)], -1)
        return np.maximum(eff, 0.0)

    q_preempt_eff = _inherit(q_preempt_mrt)
    if not (q_reclaim_mrt > 0).any():
        # common case: no queue configures reclaim minruntime — skip the
        # O(Q^2 x depth) pairwise LCA resolution entirely
        q_reclaim_eff = np.zeros((Q, Q), np.float32)
    else:
        # ancestor-at-depth table for the LCA walk (top-level first)
        maxd = int(q_depth.max(initial=0)) + 1
        anc_at = np.full((Q, maxd), -1, np.int64)
        for i in range(len(queues)):
            chain_q, p = [i], int(q_parent[i])
            while p >= 0:
                chain_q.append(p)
                p = int(q_parent[p])
            for d, qx in enumerate(reversed(chain_q)):
                anc_at[i, d] = qx
        # match depth per (victim, reclaimer) pair; start queue = the
        # victim-side child of the LCA (clamped to the victim's leaf;
        # different top-level queues degenerate to the victim's top-level
        # queue — the "shadow parent" rule in resolver.go)
        eq = (anc_at[:, None, :] == anc_at[None, :, :]) & (
            anc_at[:, None, :] >= 0)                          # [Q, Q, D]
        match_d = (eq * (np.arange(maxd) + 1)).max(axis=-1) - 1
        start_d = np.minimum(match_d + 1,
                             q_depth[:, None].astype(np.int64))
        start_q = np.take_along_axis(
            np.broadcast_to(anc_at[:, None, :], (Q, Q, maxd)),
            start_d[:, :, None], axis=2)[:, :, 0]             # [Q, Q]
        q_reclaim_inh = _inherit(q_reclaim_mrt)
        q_reclaim_eff = q_reclaim_inh[np.maximum(start_q, 0)]
        q_reclaim_eff[start_q < 0] = 0.0
    return dict(
        queue_names=queue_names, q_index=q_index, q_parent=q_parent,
        q_depth=q_depth, q_priority=q_priority, q_quota=q_quota,
        q_oqw=q_oqw, q_limit=q_limit, q_valid=q_valid,
        q_creation=q_creation, q_preempt_mrt=q_preempt_mrt,
        q_reclaim_mrt=q_reclaim_mrt, q_preempt_eff=q_preempt_eff,
        q_reclaim_eff=q_reclaim_eff)


def derive_rollups(*, node_alloc, claim_used, rk, gk, g_of_ext, r_mig,
                   queue_usage, q_index, q_parent, q_depth,
                   num_queues) -> dict:
    """Derived node free/releasing + queue allocated/request/usage
    rollups — the host mirror of the queuecontroller status (vectorized
    scatter-adds over the running/pending tables).  Shared verbatim by
    the full build and the incremental patch path so both derive
    bit-identical ledgers from the same section tables.
    """
    N = node_alloc.shape[0]
    Q = q_parent.shape[0]
    node_used = np.zeros((N, R), np.float32)
    node_rel = np.zeros((N, R), np.float32)
    on_node = rk["valid"] & (rk["node"] >= 0)
    rel_m = on_node & rk["releasing"]
    used_m = on_node & ~rk["releasing"]
    # unknown nodes count for queues, not for node capacity
    np.add.at(node_rel, rk["node"][rel_m], rk["req"][rel_m])
    np.add.at(node_used, rk["node"][used_m], rk["req"][used_m])
    node_free = np.maximum(
        node_alloc - node_used - node_rel - claim_used, 0.0)

    q_alloc = np.zeros((Q, R), np.float32)
    q_alloc_np = np.zeros((Q, R), np.float32)
    q_request = np.zeros((Q, R), np.float32)
    vmask = rk["valid"]
    np.add.at(q_alloc, rk["queue"][vmask], rk["req"][vmask])
    np_mask = vmask & ~rk["preemptible"]
    np.add.at(q_alloc_np, rk["queue"][np_mask], rk["req"][np_mask])
    # The MIG g-equivalents enter the rollups — REQUESTED amounts, not
    # the capacity-clamped held table (rk["extended"]): like the
    # core-resource path, a running MIG pod on an unknown/overcommitted
    # node still counts toward its queue's ledger.
    if g_of_ext.any():
        np.add.at(q_alloc[:, 0], rk["queue"][vmask], r_mig[vmask])
        np.add.at(q_alloc_np[:, 0], rk["queue"][np_mask],
                  r_mig[np_mask])
    q_request += q_alloc
    pending_req = (gk["task_req"]
                   * gk["task_valid"][:, :, None]).sum(axis=1)  # [G, R]
    np.add.at(q_request, gk["queue"][gk["valid"]],
              pending_req[gk["valid"]])
    if g_of_ext.any():
        g_mig = ((gk["task_extended"]
                  * gk["task_valid"][:, :, None]).sum(axis=1)
                 @ g_of_ext)                                    # [G]
        np.add.at(q_request[:, 0], gk["queue"][gk["valid"]],
                  g_mig[gk["valid"]])
    # historical usage (usagedb feed), normalized usage/clusterCapacity —
    # the k_value term of the DRF waterfill (ref usagedb.go:20-60)
    q_usage = np.zeros((Q, R), np.float32)
    if queue_usage:
        for qname, vec in queue_usage.items():
            qi2 = q_index.get(qname)
            if qi2 is not None:
                q_usage[qi2] = np.asarray(vec, np.float32)
    # propagate to parents (requests/allocations roll up the hierarchy)
    for arr in (q_alloc, q_alloc_np, q_request, q_usage):
        for i in sorted(range(num_queues), key=lambda i: -q_depth[i]):
            p = q_parent[i]
            if p >= 0:
                arr[p] += arr[i]
    return dict(node_rel=node_rel, node_free=node_free, q_alloc=q_alloc,
                q_alloc_np=q_alloc_np, q_request=q_request,
                q_usage=q_usage)


# ---------------------------------------------------------------------------
# Snapshot builder (host): api objects -> ClusterState
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SnapshotIndex:
    """Host-side name<->index maps produced alongside a ClusterState so the
    commit path can translate placement tensors back into BindRequests.
    """

    node_names: list[str]
    queue_names: list[str]
    gang_names: list[str]
    #: task pod names per gang slot, [G][T]
    task_names: list[list[str | None]]
    running_pod_names: list[str]
    selector_keys: list[str]
    label_vocab: dict[tuple[str, str], int]
    topology_levels: list[str]
    #: snapshot-derived kernel-config hints (see AllocateConfig): whether
    #: any fractional/memory-based accel request exists (device table
    #: needed), whether every gang's pending tasks are identical replicas
    #: (whole-gang fast path valid), and whether any gang carries a
    #: required topology level (domain loop needed)
    needs_device_table: bool = True
    uniform_gangs: bool = False
    has_required_topology: bool = True
    has_subgroup_topology: bool = True
    has_preferred_topology: bool = True
    has_extended_resources: bool = False
    extended_keys: list[str] = dataclasses.field(default_factory=list)
    #: any queue configures reclaimMinRuntime — its per-(victim,
    #: reclaimer) LCA tables are lane-dependent, so the chunked victim
    #: path must stay off (see VictimConfig.chunk_reclaim)
    has_reclaim_minruntime: bool = False
    #: the snapshot emitted in-cycle exclusion term rows (mutual or
    #: asymmetric required anti-affinity between pending gangs, or a
    #: host port shared by >=2 pending gangs): the placement wavefronts
    #: track their claimed domains in-cycle (AllocateConfig.anti_groups)
    has_anti_groups: bool = False
    #: attraction need rows exist (same-cycle required positive affinity)
    has_attract_groups: bool = False
    #: deepest queue depth (0 = flat) — Session widens its division
    #: recursion to cover the whole hierarchy
    max_queue_depth: int = 1
    #: valid childless queues — preempt chunk width auto-tunes with
    #: this (preemptors spread across many queues fill wider chunks)
    num_leaf_queues: int = 0
    #: gangs with at least one pending task — the live preemptor
    #: spread; the Session clamps the victim wavefront's lane width to
    #: it so junk lanes stop paying freed-pool cost (-1 = unknown)
    num_pending_gangs: int = -1
    #: emitted term-row count (the anti_used table's row dimension is
    #: sized from the state arrays; this is informational)
    num_anti_groups: int = 0
    #: host (numpy) copies of the snapshot-side tables the commit path
    #: reads — kept so cycle results never transfer them back from the
    #: device (see framework.session._pack_commit)
    host_tables: dict = dataclasses.field(default_factory=dict)
    #: pod name → its ResourceClaim names (only pods that declare any) —
    #: the commit path records them on BindRequests
    claims_by_pod: dict = dataclasses.field(default_factory=dict)
    #: feasibility spans the whole node axis: no selectors, filter
    #: classes, anti-affinity, or topology constraints in the snapshot
    dense_feasibility: bool = False
    #: wall seconds of the snapshot's host-to-device copy (the port's
    #: split of the reference's snapshot phase; 0 on the CPU)
    upload_seconds: float = 0.0

    def node_index(self, name: str) -> int:
        return self.node_names.index(name)

    # object-array views of the name tables, built once per snapshot so
    # the commit path gathers names columnar instead of per-row indexing
    @functools.cached_property
    def task_names_arr(self) -> "np.ndarray":
        return np.array(self.task_names, dtype=object)

    @functools.cached_property
    def node_names_arr(self) -> "np.ndarray":
        return np.array(self.node_names, dtype=object)

    @functools.cached_property
    def gang_names_arr(self) -> "np.ndarray":
        return np.array(self.gang_names, dtype=object)

    @functools.cached_property
    def running_pod_names_arr(self) -> "np.ndarray":
        return np.array(self.running_pod_names, dtype=object)


def build_snapshot_host(
    nodes: list[apis.Node],
    queues: list[apis.Queue],
    pod_groups: list[apis.PodGroup],
    pods: list[apis.Pod],
    topology: apis.Topology | None = None,
    *,
    max_tasks_per_gang: int | None = None,
    pad: int = 8,
    now: float | None = None,
    queue_usage: dict[str, "np.ndarray"] | None = None,
    resource_claims: dict[str, apis.ResourceClaim] | None = None,
    device_classes: dict[str, apis.DeviceClass] | None = None,
    volume_claims: dict[str, apis.PersistentVolumeClaim] | None = None,
    storage_classes: dict[str, apis.StorageClass] | None = None,
    capacity: SnapshotCapacity | None = None,
) -> tuple[dict, "SnapshotIndex"]:
    """Flatten API objects into host (numpy) ClusterState leaves, keyed by
    dotted field path, plus the index for the commit path.

    The reference's assembly copied whole (its ``dtype`` knob aside: the
    port's float leaves are always f32), so both packages derive
    identical leaves from the same objects — the tensor analogue of the
    reference's snapshot step (``cache/cluster_info/cluster_info.go:229``
    snapshotNodes, ``:346`` snapshotPodGroups).
    """
    cap = capacity or SnapshotCapacity()
    # --- vocabularies -----------------------------------------------------
    selector_keys: list[str] = []
    for pod in pods:
        for k in pod.node_selector:
            if k not in selector_keys:
                selector_keys.append(k)
    label_vocab: dict[tuple[str, str], int] = {}

    def value_id(key: str, value: str) -> int:
        return label_vocab.setdefault((key, value), len(label_vocab))

    # multiple Topology CRDs (ref topology_plugin.go building one domain
    # tree PER Topology object): each tree's levels occupy a distinct
    # slice of the level axis; domain ids stay globally dense, and a
    # gang's TopologyConstraint resolves level names inside ITS named
    # tree
    if topology is None:
        topos: list[apis.Topology] = []
    elif isinstance(topology, apis.Topology):
        topos = [topology]
    else:
        topos = list(topology)
    topo_levels = [lvl for t in topos for lvl in t.levels]
    topo_slices: dict[str, tuple[int, list[str]]] = {}
    _off = 0
    for t in topos:
        topo_slices[t.name] = (_off, list(t.levels))
        _off += len(t.levels)

    def resolve_level(tc: "apis.TopologyConstraint | None",
                      attr: str) -> int:
        if tc is None or not topo_levels:
            return -1
        start, lvls = topo_slices.get(tc.topology, (0, topo_levels))
        name = getattr(tc, attr)
        return start + lvls.index(name) if name in lvls else -1

    L = max(1, len(topo_levels))
    K = max(1, len(selector_keys))

    # extended scalar-resource vocabulary (MIG profiles etc.)
    ext_keys = sorted(
        {k for nd in nodes for k in nd.extended}
        | {k for p in pods for k in p.extended})
    E = max(1, len(ext_keys))
    ext_index = {k: i for i, k in enumerate(ext_keys)}
    # MIG profiles count their g-number toward queue GPU accounting
    # (ref resource_info.go GetTotalGPURequest: totalGpusQuota +=
    # gpuPortion * count).  The per-key g-equivalent vector feeds the
    # snapshot rollups below AND ships with the state (GangState.
    # ext_accel) so the placement kernels apply the same equivalents to
    # their in-cycle queue deltas — MIG-heavy queues hit quota and
    # over-share gates in the cycle that places them.
    g_of_ext = np.zeros((E,), np.float32)
    for _ek, _col in ext_index.items():
        _m = re.search(r"mig-(\d+)g\.", _ek)
        if _m:
            g_of_ext[_col] = float(_m.group(1))

    # --- nodes ------------------------------------------------------------
    live_nodes = [n for n in nodes if not n.unschedulable]
    N = _round_up(max(len(live_nodes), cap.nodes), pad)
    node_alloc = np.zeros((N, R), np.float32)
    node_labels = np.full((N, K), -1, np.int32)
    node_topo = np.full((N, L), -1, np.int32)
    node_valid = np.zeros((N,), bool)
    node_names = [n.name for n in live_nodes]
    domain_vocab: dict[tuple[int, str], int] = {}
    # accel device table (GPU-group equivalent)
    accel_counts = [int(round(n.allocatable.accel)) for n in live_nodes]
    D = max(1, max(accel_counts, default=1))
    if D > 31:
        # whole-device occupancy is tracked as an int32 bitmask
        # (RunningState.devices_mask); >31 devices per node would overflow
        raise ValueError(
            f"nodes with {D} accel devices exceed the 31-devices-per-node "
            "limit of the device bitmask")
    dev_free = np.zeros((N, D), np.float32)
    dev_rel = np.zeros((N, D), np.float32)
    node_dev_mem = np.zeros((N,), np.float32)
    ext_free = np.zeros((N, E), np.float32)
    ext_rel = np.zeros((N, E), np.float32)
    accel_mems = [n.accel_memory_gib for n, c in zip(live_nodes, accel_counts)
                  if c > 0]
    #: cluster-min device memory quantifies memory-based requests for
    #: queue accounting (ref ClusterInfo.MinNodeGPUMemory)
    min_dev_mem = min(accel_mems) if accel_mems else 16.0
    for i, n in enumerate(live_nodes):
        node_alloc[i] = n.allocatable.as_tuple()
        node_valid[i] = True
        dev_free[i, :accel_counts[i]] = 1.0
        node_dev_mem[i] = n.accel_memory_gib
        for ek, ev in n.extended.items():
            ext_free[i, ext_index[ek]] = ev
        for ki, key in enumerate(selector_keys):
            if key in n.labels:
                node_labels[i, ki] = value_id(key, n.labels[key])
        # Topology domains: id per level = dense index of the label-path
        # prefix at that level, so equal ids <=> same physical domain
        # (ref plugins/topology/topology_structs.go DomainID = joined
        # path); the path prefix resets per Topology tree
        off = 0
        for t in topos:
            path: list[str] = []
            for lj, level_key in enumerate(t.levels):
                val = n.labels.get(level_key)
                if val is None:
                    break
                path.append(val)
                node_topo[i, off + lj] = domain_vocab.setdefault(
                    (off + lj, "/".join(path)), len(domain_vocab))
            off += len(t.levels)

    # --- queues (parents before children) --------------------------------
    Q = _round_up(max(len(queues), cap.queues), pad)
    qt = build_queue_tables(queues, Q)
    queue_names, q_index = qt["queue_names"], qt["q_index"]
    q_parent, q_depth = qt["q_parent"], qt["q_depth"]
    q_priority, q_quota, q_oqw = qt["q_priority"], qt["q_quota"], qt["q_oqw"]
    q_limit, q_valid, q_creation = qt["q_limit"], qt["q_valid"], qt["q_creation"]
    q_preempt_mrt, q_reclaim_mrt = qt["q_preempt_mrt"], qt["q_reclaim_mrt"]
    q_preempt_eff, q_reclaim_eff = qt["q_preempt_eff"], qt["q_reclaim_eff"]

    # --- pod groups + tasks ----------------------------------------------
    group_names = [g.name for g in pod_groups]
    g_index = {name: i for i, name in enumerate(group_names)}
    pending_by_group: dict[str, list[apis.Pod]] = {g.name: [] for g in pod_groups}
    running_pods: list[apis.Pod] = []
    for pod in pods:
        if pod.status == apis.PodStatus.PENDING:
            if pod.group in pending_by_group:
                pending_by_group[pod.group].append(pod)
        elif pod.status in (apis.PodStatus.BOUND, apis.PodStatus.RUNNING,
                            apis.PodStatus.RELEASING):
            running_pods.append(pod)

    max_pending = max([len(v) for v in pending_by_group.values()] + [1])
    T = max_tasks_per_gang or max_pending
    if T < max_pending:
        raise ValueError(
            f"max_tasks_per_gang={T} < largest gang ({max_pending} pending "
            "tasks); truncating would starve gangs whose min_member exceeds "
            "the cap")
    T = _round_up(max(T, cap.tasks), 4)
    G = _round_up(max(len(pod_groups), cap.gangs), pad)
    gk = dict(
        queue=np.zeros((G,), np.int32),
        min_member=np.zeros((G,), np.int32),
        priority=np.zeros((G,), np.int32),
        preemptible=np.zeros((G,), bool),
        valid=np.zeros((G,), bool),
        creation_order=np.zeros((G,), np.int32),
        backoff=np.zeros((G,), np.int32),
        task_req=np.zeros((G, T, R), np.float32),
        task_valid=np.zeros((G, T), bool),
        task_selector=np.full((G, T, K), -1, np.int32),
        task_portion=np.zeros((G, T), np.float32),
        task_accel_mem=np.zeros((G, T), np.float32),
        required_level=np.full((G,), -1, np.int32),
        preferred_level=np.full((G,), -1, np.int32),
        running_count=np.zeros((G,), np.int32),
        min_needed=np.zeros((G,), np.int32),
        stale_s=np.full((G,), -1.0, np.float32),
        task_filter_class=np.zeros((G, T), np.int32),
        task_nominated=np.full((G, T), -1, np.int32),
        anti_self_level=np.full((G,), -1, np.int32),
        anti_marks=np.full((G, ANTI_SLOTS), -1, np.int32),
        anti_avoids=np.full((G, ANTI_SLOTS), -1, np.int32),
        attract_needs=np.full((G, 2), -1, np.int32),
        task_type=np.zeros((G, T), np.int32),
        sig=np.zeros((G,), np.int32),
        task_extended=np.zeros((G, T, E), np.float32),
        ext_accel=g_of_ext,
        task_dra=np.zeros((G, T), np.int32),
    )
    # --- subgroup tables (slot 0 = implicit default subgroup, so the
    # slot count is max declared subgroups + 1) ----------------------------
    S = _round_up(max([len(g.sub_groups) for g in pod_groups] + [0]) + 1, 4)
    gk["task_subgroup"] = np.zeros((G, T), np.int32)
    gk["subgroup_valid"] = np.zeros((G, S), bool)
    gk["subgroup_min_member"] = np.zeros((G, S), np.int32)
    gk["subgroup_min_needed"] = np.zeros((G, S), np.int32)
    gk["subgroup_required_level"] = np.full((G, S), -1, np.int32)
    sub_slot: list[dict[str, int]] = [{} for _ in range(G)]
    sub_running = np.zeros((G, S), np.int32)
    # --- node-filter classes: dedupe pod specs ---------------------------
    filter_specs: list[tuple] = [node_filters.EMPTY_SPEC]
    spec_index: dict[tuple, int] = {node_filters.EMPTY_SPEC: 0}
    spec_pods: dict[tuple, apis.Pod] = {
        node_filters.EMPTY_SPEC: apis.Pod("", "")}

    #: consumers admitted this snapshot per claim name — dra_of runs
    #: once per pending pod in intake order, so the counter mirrors the
    #: reference's virtual ReservedFor growth within a cycle
    claim_admitted: dict[str, int] = {}

    def dra_of(pod: apis.Pod,
               queue_name: str | None = None) -> tuple[int, tuple]:
        """(device count, resolved DeviceClass constraint key) — real
        ResourceClaim objects drive the count and the node constraints
        (ref dynamicresources.go claim→deviceclass selection); bare
        ``dra_accel_count`` keeps the legacy unconstrained behavior.
        Non-accel device classes keep their node constraints but skip
        the accel accounting ("non gpu claims doesn't count for gpu
        limit").

        With ``queue_name`` (pending pods only) the upstream draPlugin
        preFilter gates apply (``dynamicresources.go:139-160``): a pod
        whose claim already has ``RESERVED_FOR_MAX`` consumers (existing
        + earlier pending referents this cycle — the virtual ReservedFor
        growth) never schedules, and a SHARED (non-template) GPU claim
        must carry the pod's queue under the ``kai.scheduler/queue``
        label.  Violations resolve to an unsatisfiable node constraint,
        so the gang stays pending with a feasibility fit error — the
        tensor analogue of the reference's preFilter error."""
        if not pod.resource_claims or not resource_claims:
            return pod.dra_accel_count, ()
        cnt, min_mem, bad = 0, 0.0, False
        sels: list[tuple[str, str]] = []
        #: this pod's provisional admissions — committed to the cycle
        #: counter only if the pod passes EVERY gate, so one rejected
        #: claim cannot inflate the virtual consumer count other claims
        #: see for later pods (the reference never grows ReservedFor for
        #: a pod its preFilter rejected)
        admit: dict[str, int] = {}
        for cname in pod.resource_claims:
            claim = resource_claims.get(cname)
            if claim is None:
                continue
            dc = (device_classes or {}).get(claim.device_class)
            is_accel = dc is None or dc.accel
            if queue_name is not None:
                taken = (claim.reserved_for
                         + claim_admitted.get(cname, 0)
                         + admit.get(cname, 0))
                bad_label = (is_accel and not claim.from_template
                             and claim.labels.get(apis.QUEUE_LABEL)
                             != queue_name)
                if taken >= apis.RESERVED_FOR_MAX or bad_label:
                    bad = True
                else:
                    admit[cname] = admit.get(cname, 0) + 1
            if dc is not None:
                min_mem = max(min_mem, dc.min_memory_gib)
                sels.extend(sorted(dc.node_selector.items()))
            if is_accel:
                cnt += claim.count
        if bad:
            return cnt, (float("inf"), ())
        for cname, inc in admit.items():
            claim_admitted[cname] = claim_admitted.get(cname, 0) + inc
        key = (min_mem, tuple(sels)) if (min_mem or sels) else ()
        return cnt, key

    def vol_of(pod: apis.Pod) -> tuple:
        """Resolved VolumeBinding label constraints: a BOUND claim pins
        to its volume's topology; an unbound WaitForFirstConsumer claim
        restricts to its class's allowedTopologies (the volume binds at
        PreBind) — ref the VolumeBinding predicate in
        ``k8s_internal/predicates/predicates.go:70-140``."""
        if not pod.volume_claims or not volume_claims:
            return ()
        items: list[tuple[str, str]] = []
        for vname in pod.volume_claims:
            pvc = volume_claims.get(vname)
            if pvc is None:
                continue
            if pvc.bound:
                items.extend(sorted(pvc.node_affinity.items()))
            else:
                sc = (storage_classes or {}).get(pvc.storage_class)
                if sc is not None:
                    items.extend(sorted(sc.allowed_topology.items()))
        return tuple(items)

    #: label keys any running pod's required anti selector mentions —
    #: incoming pods carrying them need the reverse-anti evaluation
    rev_keys = node_filters.reverse_anti_keys(running_pods)

    def filter_class_of(pod: apis.Pod, dra_key: tuple = ()) -> int:
        rev_labels = tuple(sorted(
            (k, v) for k, v in pod.labels.items() if k in rev_keys))
        # fast path: the overwhelming majority of pods carry no filter
        # spec at all — class 0 without building the canonical key
        if not (pod.tolerations or pod.node_affinity or pod.pod_affinity
                or dra_key or pod.volume_claims or pod.host_ports
                or rev_labels):
            return 0
        key = node_filters.pod_filter_spec(pod, dra_key, vol_of(pod),
                                           rev_labels)
        if key not in spec_index:
            spec_index[key] = len(filter_specs)
            filter_specs.append(key)
            spec_pods[key] = pod
        return spec_index[key]

    node_idx0 = {name: i for i, name in enumerate(node_names)}
    task_names: list[list[str | None]] = [[None] * T for _ in range(G)]
    for i, g in enumerate(pod_groups):
        gk["queue"][i] = q_index.get(g.queue, 0)
        gk["min_member"][i] = g.min_member
        gk["priority"][i] = g.priority
        gk["preemptible"][i] = g.preemptibility == apis.Preemptibility.PREEMPTIBLE
        gk["valid"][i] = bool(pending_by_group[g.name])
        gk["creation_order"][i] = i
        # the UnschedulableOnNodePool condition keeps the gang out of the
        # cycle until cleared (ref cluster_info skipping marked groups)
        gk["backoff"][i] = 1 if g.unschedulable else 0
        # declared subgroups take slots 1.. ; slot 0 is the default
        # subgroup (all tasks of a plain gang, quorum = gang minMember)
        for si, sg in enumerate(g.sub_groups[:S - 1], start=1):
            sub_slot[i][sg.name] = si
            gk["subgroup_valid"][i, si] = True
            gk["subgroup_min_member"][i, si] = sg.min_member
            gk["subgroup_required_level"][i, si] = resolve_level(
                sg.topology_constraint, "required_level")
        gk["subgroup_valid"][i, 0] = True
        gk["subgroup_min_member"][i, 0] = \
            0 if g.sub_groups else g.min_member
        gk["required_level"][i] = resolve_level(
            g.topology_constraint, "required_level")
        gk["preferred_level"][i] = resolve_level(
            g.topology_constraint, "preferred_level")
        # a gang-level required topology level is enforced through the
        # subgroup machinery: subgroups without their own constraint
        # (incl. the default slot 0) inherit it, so every task locks into
        # ONE domain at that level with the capacity-aware first pick
        if gk["required_level"][i] >= 0:
            for si in range(S):
                if gk["subgroup_required_level"][i, si] < 0:
                    gk["subgroup_required_level"][i, si] = \
                        gk["required_level"][i]

    # --- task intake: one global lexsort + a type-table gather -----------
    # Task-order semantics (ref plugins/kubeflow + plugins/ray leader pods
    # first on the job-role / node-type labels, then priority desc,
    # creation asc, name — the taskorder plugin) run as ONE vectorized
    # lexsort over all pending pods instead of a per-gang Python sort, and
    # every per-task field is an O(distinct-spec) encode + O(tasks) gather
    # — the host snapshot must stay a small fraction of the device cycle
    # at 50k pods.
    all_pend: list[apis.Pod] = []
    for g in pod_groups:
        all_pend.extend(pending_by_group[g.name])
    counts = np.fromiter(
        (len(pending_by_group[g.name]) for g in pod_groups), np.int64,
        len(pod_groups)) if pod_groups else np.zeros((0,), np.int64)
    nf = len(all_pend)
    anti_term_level = np.zeros((0,), np.int32)
    attract_static = np.zeros((0, node_topo.shape[0]), bool)
    incycle_pos_terms: set = set()
    task_type_index: dict[tuple, int] = {}
    if nf:
        gidx = np.repeat(np.arange(len(pod_groups)), counts)
        leader = np.fromiter(
            ((p.labels.get("training.kubeflow.org/job-role")
              or p.labels.get("ray.io/node-type")) not in _LEADER_ROLES
             for p in all_pend), bool, nf)
        prio_a = np.fromiter((p.priority for p in all_pend), np.int64, nf)
        crea_a = np.fromiter((p.creation_timestamp for p in all_pend),
                             np.float64, nf)
        names_a = np.array([p.name for p in all_pend])
        # gidx is already non-decreasing (groups appended in order), so
        # the stable lexsort only permutes within each gang
        order = np.lexsort((names_a, crea_a, -prio_a, leader, gidx))
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        gi_a = gidx
        ti_a = np.arange(nf) - starts[gidx]
        if (ti_a >= T).any():
            raise AssertionError("task slots exceed padded T")  # unreachable

        # distinct task specs: one dict probe per pod, everything heavier
        # once per distinct type
        def _tkey(p: apis.Pod, qname: str) -> tuple:
            dra_cnt, dra_key = dra_of(p, queue_name=qname)
            return (
                p.resources.as_tuple(),
                tuple(sorted(p.node_selector.items()))
                if p.node_selector else (),
                p.accel_portion, p.accel_memory_gib, dra_cnt,
                filter_class_of(p, dra_key),
                tuple(sorted(p.extended.items())) if p.extended else ())

        tid = np.fromiter(
            (task_type_index.setdefault(
                _tkey(p, pod_groups[gidx[j]].queue),
                len(task_type_index))
             for j, p in enumerate(all_pend)), np.int64, nf)
        Yn = len(task_type_index)
        t_req = np.zeros((Yn, R), np.float32)
        t_sel = np.full((Yn, K), -1, np.int32)
        t_por = np.zeros((Yn,), np.float32)
        t_mem = np.zeros((Yn,), np.float32)
        t_cls = np.zeros((Yn,), np.int32)
        t_ext = np.zeros((Yn, E), np.float32)
        t_dra = np.zeros((Yn,), np.int32)
        for (req_t, sel_items, por, memg, dra, cls,
             ext_items), y in task_type_index.items():
            t_req[y] = req_t
            # fractional / memory-based requests carry their share in the
            # accel slot so queue & node totals stay consistent
            # (memory-based quantified against the cluster-min device
            # memory, ref GetTasksToAllocateInitResource MinNodeGPUMemory);
            # DRA-claimed devices count like whole devices (ref
            # draGpuCounts added to total requested GPUs)
            if por > 0:
                t_req[y, 0] = por
            elif memg > 0:
                t_req[y, 0] = memg / min_dev_mem
            t_req[y, 0] += dra
            t_por[y], t_mem[y], t_cls[y], t_dra[y] = por, memg, cls, dra
            for k2, v2 in sel_items:
                t_sel[y, selector_keys.index(k2)] = value_id(k2, v2)
            for k2, v2 in ext_items:
                t_ext[y, ext_index[k2]] = v2

        tid_s = tid[order]
        gk["task_valid"][gi_a, ti_a] = True
        gk["task_req"][gi_a, ti_a] = t_req[tid_s]
        gk["task_selector"][gi_a, ti_a] = t_sel[tid_s]
        gk["task_portion"][gi_a, ti_a] = t_por[tid_s]
        gk["task_accel_mem"][gi_a, ti_a] = t_mem[tid_s]
        gk["task_filter_class"][gi_a, ti_a] = t_cls[tid_s]
        gk["task_extended"][gi_a, ti_a] = t_ext[tid_s]
        gk["task_dra"][gi_a, ti_a] = t_dra[tid_s]
        gk["task_type"][gi_a, ti_a] = tid_s
        names_obj = names_a.astype(object)[order]
        tnames_arr = np.full((G, T), None, object)
        tnames_arr[gi_a, ti_a] = names_obj
        task_names = tnames_arr.tolist()

        # sparse per-pod attributes: touch only the pods that carry them
        nom = np.fromiter(
            ((-1 if p.nominated_node is None
              else node_idx0.get(p.nominated_node, -1))
             for p in all_pend), np.int32, nf)
        gk["task_nominated"][gi_a, ti_a] = nom[order]
        has_subs_g = np.fromiter((bool(s) for s in sub_slot), bool, G)
        if has_subs_g.any():
            subcol = np.zeros((nf,), np.int32)
            for j in np.nonzero(has_subs_g[gidx])[0].tolist():
                subcol[j] = sub_slot[gidx[j]].get(
                    all_pend[j].subgroup or "", 0)
            gk["task_subgroup"][gi_a, ti_a] = subcol[order]
        paff = np.fromiter((bool(p.pod_affinity) for p in all_pend), bool,
                           nf)
        # gang-internal spread level (self-selecting required anti term)
        for j in np.nonzero(paff)[0].tolist():
            asl, _ = node_filters.anti_self_term(all_pend[j],
                                                 topo_levels, L)
            if asl >= 0:
                i = gidx[j]
                cur = gk["anti_self_level"][i]
                gk["anti_self_level"][i] = (asl if cur < 0
                                            else min(cur, asl))
        # in-cycle exclusion terms (see GangState.anti_marks): collect
        # each gang's required anti terms + label dicts, then emit
        # symmetric rows / forward+reverse row pairs / port rows
        terms_by_gang: dict[int, set] = {}
        pos_by_gang: dict[int, set] = {}
        for j in np.nonzero(paff)[0].tolist():
            i = gidx[j]
            for term in all_pend[j].pod_affinity:
                if not term.required:
                    continue
                lvl = (topo_levels.index(term.topology_key)
                       if term.topology_key in topo_levels else L)
                if term.anti:
                    terms_by_gang.setdefault(i, set()).add(
                        (term.match_labels, lvl))
                else:
                    pos_by_gang.setdefault(i, set()).add(
                        (term.match_labels, term.topology_key, lvl))
        ports_by_gang: dict[int, set] = {}
        port_counts: dict[int, dict] = {}
        for j, p in enumerate(all_pend):
            if p.host_ports:
                i = gidx[j]
                ports_by_gang.setdefault(i, set()).update(p.host_ports)
                cnts = port_counts.setdefault(i, {})
                # sorted: set order is hash-seed dependent, and these
                # counts feed the gang-kernel tables — two builds of the
                # same cluster must stay bit-identical (kai-lint KAI041)
                for prt in sorted(set(p.host_ports)):
                    cnts[prt] = cnts.get(prt, 0) + 1
        for i, cnts in port_counts.items():
            # replicas SHARING a port can never share a node; a gang
            # whose pods all use distinct ports co-locates freely.
            # Granularity note: anti-self is gang-wide, so a gang mixing
            # ported and portless pods over-spreads the portless ones —
            # conservative (never an invalid co-placement), and exact
            # for the dominant uniform-replica shape.
            if any(c >= 2 for c in cnts.values()):
                cur = gk["anti_self_level"][i]
                gk["anti_self_level"][i] = L if cur < 0 else min(cur, L)
        all_terms = sorted({t for s in terms_by_gang.values() for t in s})
        pos_terms = sorted({t for s in pos_by_gang.values() for t in s})
        labels_by_gang: dict[int, list] = {}
        # per-gang FULL pending label list (anchor strictness check:
        # every pod of an anchor gang must match the term selector)
        pend_labels_all: dict[int, list] = {}
        if pos_terms:
            for j, p in enumerate(all_pend):
                pend_labels_all.setdefault(gidx[j], []).append(
                    p.labels or {})
        if all_terms or pos_terms:
            term_keys = ({k for ml, _ in all_terms for k, _ in ml}
                         | {k for ml, _, _ in pos_terms for k, _ in ml})
            for j, p in enumerate(all_pend):
                if p.labels and term_keys & p.labels.keys():
                    labels_by_gang.setdefault(gidx[j], [])
                    if p.labels not in labels_by_gang[gidx[j]]:
                        labels_by_gang[gidx[j]].append(p.labels)
        rows: list[int] = []      # level per emitted row
        marks_of: dict[int, list] = {}
        avoids_of: dict[int, list] = {}

        def _slot(d, i, row):
            lst = d.setdefault(i, [])
            if row not in lst:
                lst.append(row)

        for ml, lvl in all_terms:
            carriers = {i for i, ts in terms_by_gang.items()
                        if (ml, lvl) in ts}
            matchers = {i for i, lds in labels_by_gang.items()
                        if any(all(ld.get(k) == v for k, v in ml)
                               for ld in lds)}
            if not matchers:
                continue  # nobody to exclude — row would never be marked
            if matchers == carriers:
                row = len(rows)
                rows.append(lvl)
                for i in carriers:
                    _slot(marks_of, i, row)
                    _slot(avoids_of, i, row)
            else:
                fwd = len(rows)
                rows.append(lvl)
                rev = len(rows)
                rows.append(lvl)
                for i in matchers:
                    _slot(marks_of, i, fwd)
                    _slot(avoids_of, i, rev)
                for i in carriers:
                    _slot(avoids_of, i, fwd)
                    _slot(marks_of, i, rev)
        all_ports = sorted({p for s in ports_by_gang.values() for p in s})
        for port in all_ports:
            carriers = {i for i, ps in ports_by_gang.items() if port in ps}
            if len(carriers) < 2:
                continue  # single carrier: anti_self covers it
            # Granularity note: marks claim ALL of a carrier gang's
            # placement nodes, so a gang mixing ported and portless
            # pods over-excludes the other carriers from its portless
            # nodes for ONE cycle (next cycle the filter masks see the
            # exact running ports) — conservative, never an invalid
            # co-placement; exact for uniform-replica gangs.
            row = len(rows)
            rows.append(L)  # per-node
            for i in carriers:
                _slot(marks_of, i, row)
                _slot(avoids_of, i, row)
        # attraction rows — required POSITIVE affinity with a PENDING
        # anchor (upstream InterPodAffinity over virtually-allocated
        # session state, ``k8s_internal/predicates/predicates.go:70-140``).
        # A term the carrier gang ITSELF matches folds into the
        # required-topology machinery (co-locate the gang in one domain
        # at the term's level — the upstream greedy where every pod
        # joins the first pod's virtual domain); carriers that do NOT
        # match get a need row they must find claimed at placement time:
        # statically by a running match (``attract_static``) or in-cycle
        # by an anchor gang's placement (anchors carry the row in
        # ``anti_marks``).  Terms handled in-cycle are excluded from the
        # static filter fold (``incycle_pos_terms``).
        needs_of: dict[int, list] = {}
        attract_rows: list[tuple[int, tuple, int]] = []

        def _running_match(ml) -> bool:
            return any(
                rp.status != apis.PodStatus.RELEASING
                and node_idx0.get(rp.node, -1) >= 0
                and all(rp.labels.get(k) == v for k, v in ml)
                for rp in running_pods)

        for ml, tkey, lvl in pos_terms:
            carriers = {i for i, ts in pos_by_gang.items()
                        if (ml, tkey, lvl) in ts}
            matchers = {i for i, lds in labels_by_gang.items()
                        if any(all(ld.get(k) == v for k, v in ml)
                               for ld in lds)}
            if not matchers:
                continue  # no pending anchor — the static fold decides
            # levels are outermost-first, so the STRICTER of two
            # required-colocation levels is the FINER one (max index —
            # one host implies one rack); contrast anti_self_level,
            # where coarser (min) is stricter for spreading
            self_skipped = False
            rm = _running_match(ml)
            for i in carriers & matchers:
                # self-anchored: the gang's own pods satisfy the term by
                # co-locating in one domain at the term's level.  With
                # running matches present the gang must still JOIN a
                # matched domain (static fold, or the need row below
                # when a depender row disables the fold); without, the
                # fold is skipped (the k8s self-match bootstrap rule).
                # Hostname-level self-affinity stays with the static
                # masks (next-cycle convergence).
                if lvl < L:
                    cur = gk["required_level"][i]
                    gk["required_level"][i] = (lvl if cur < 0
                                               else max(cur, lvl))
                    for si in range(S):
                        csg = gk["subgroup_required_level"][i, si]
                        gk["subgroup_required_level"][i, si] = (
                            lvl if csg < 0 else max(csg, lvl))
                    if not rm:
                        incycle_pos_terms.add((ml, tkey))
                        self_skipped = True
            dependers = carriers - matchers
            # anchors must mark ONLY domains that will hold a matching
            # pod, but marking is gang-granular (anti_mark_placements
            # claims EVERY placed task's domain) — so only gangs whose
            # pending pods ALL match the selector may anchor; a
            # mixed-label matcher stays out (its dependers converge
            # next cycle via the running-match masks, never a violation)
            anchors = {i for i in matchers
                       if all(all(ld.get(k) == v for k, v in ml)
                              for ld in pend_labels_all.get(i, []))}
            # a need row is emitted whenever dependers exist and the
            # term is handled in-cycle — including the anchor-less case
            # where a SELF-fold already skipped the shared static fold
            # (the row then confines dependers to running-match domains,
            # restoring exactly what the skipped fold enforced)
            if not dependers or not (anchors or self_skipped):
                continue
            row = len(rows)
            rows.append(lvl)
            for i in anchors:
                _slot(marks_of, i, row)
            # the row disables the shared static fold for EVERY pod
            # carrying the term, so carrier∩matcher gangs whose fold was
            # load-bearing get the need row as well: hostname-level
            # selfs (no node-granular fold exists) and folded selfs
            # with running matches (the fold also forced them INTO a
            # matched domain — the row's attract_static restores that
            # exactly, and in-cycle anchors extend it).  Only folded
            # selfs with NO running match go row-free: the k8s
            # self-match bootstrap lets them open a fresh domain.
            needy_selfs = {i for i in carriers & matchers
                           if lvl >= L or rm}
            for i in dependers | needy_selfs:
                lst = needs_of.setdefault(i, [])
                if row not in lst:
                    lst.append(row)
            incycle_pos_terms.add((ml, tkey))
            attract_rows.append((row, ml, lvl))
        needp = max((len(lst) for lst in needs_of.values()), default=0)
        if needp > gk["attract_needs"].shape[1]:
            Gp = gk["attract_needs"].shape[0]
            gk["attract_needs"] = np.full((Gp, _pow2_ceil(needp)), -1,
                                          np.int32)
        for i, lst in needs_of.items():
            gk["attract_needs"][i, :len(lst)] = lst
        # size the slot dimension from the snapshot: every distinct term
        # row a gang carries gets a slot (dropping one would unenforce a
        # required anti term for a cycle, and binds are permanent).  The
        # dim is bucketed to powers of two >= ANTI_SLOTS so term-count
        # drift across cycles rarely changes the compiled shape.
        need = max((len(lst) for d in (marks_of, avoids_of)
                    for lst in d.values()), default=0)
        if need > ANTI_SLOTS:
            slots = _pow2_ceil(need)
            Gp = gk["anti_marks"].shape[0]
            gk["anti_marks"] = np.full((Gp, slots), -1, np.int32)
            gk["anti_avoids"] = np.full((Gp, slots), -1, np.int32)
        for i, lst in marks_of.items():
            gk["anti_marks"][i, :len(lst)] = lst
        for i, lst in avoids_of.items():
            gk["anti_avoids"][i, :len(lst)] = lst
        # pad the row count to a power of two: anti_term_level's shape
        # sizes the anti_used table, and AllocateConfig-keyed kernels
        # recompile on every distinct shape — without padding a pending
        # set whose term count drifts 3 -> 4 -> 3 across cycles would
        # recompile every cycle.  Padded rows are never referenced (no
        # gang's marks/avoids point at them).
        if rows:
            rows = rows + [0] * (_pow2_ceil(len(rows)) - len(rows))
        anti_term_level = np.asarray(rows, np.int32)
        # statically-satisfied nodes per attract row: the domains (at
        # the row's level) that already hold a RUNNING match — OR-ed
        # with the in-cycle claims at placement time
        attract_static = np.zeros((len(rows), node_topo.shape[0]), bool)
        for row, ml, lvl in attract_rows:
            for rp in running_pods:
                if rp.status == apis.PodStatus.RELEASING:
                    continue
                ni = node_idx0.get(rp.node, -1)
                if ni < 0 or not all(
                        rp.labels.get(k) == v for k, v in ml):
                    continue
                if lvl < L:
                    d = node_topo[ni, lvl]
                    if d >= 0:
                        attract_static[row] |= node_topo[:, lvl] == d
                    else:
                        attract_static[row, ni] = True
                else:
                    attract_static[row, ni] = True

    # --- running pods -----------------------------------------------------
    # Pods whose node is missing from the snapshot (cordoned/deleted) keep
    # valid=True with node=-1: they still count toward queue allocation so
    # DRF fairness stays honest, but victim kernels skip node<0 rows.
    M = _round_up(max(len(running_pods), cap.running), pad)
    node_idx = {name: i for i, name in enumerate(node_names)}
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
        extended=np.zeros((M, E), np.float32),
    )
    running_names: list[str] = [""] * M
    if now is None:
        now = max([p.creation_timestamp for p in pods], default=0.0)
    Mu = len(running_pods)
    if Mu:
        # --- bulk per-pod fields (vectorized; the device-occupancy and
        # memory-share paths below stay per-pod but are guarded) ----------
        r_req = np.array([p.resources.as_tuple() for p in running_pods],
                         np.float32)
        r_node = np.fromiter(
            (node_idx.get(p.node, -1) for p in running_pods), np.int32, Mu)
        r_por = np.fromiter((p.accel_portion for p in running_pods),
                            np.float32, Mu)
        r_mem = np.fromiter((p.accel_memory_gib for p in running_pods),
                            np.float32, Mu)
        r_grp = np.fromiter(
            (g_index.get(p.group, -1) for p in running_pods), np.int32, Mu)
        r_rel = np.fromiter(
            (p.status == apis.PodStatus.RELEASING for p in running_pods),
            bool, Mu)
        # a running pod's node is known: debit its *actual* per-node
        # share so free accel stays equal to device_free.sum(-1)
        # (pending pods use the canonical cluster-min quantification)
        dm = np.where(r_node >= 0,
                      node_dev_mem[np.maximum(r_node, 0)], min_dev_mem)
        r_req[:, 0] = np.where(
            r_por > 0, r_por,
            np.where(r_mem > 0, r_mem / np.maximum(dm, 1e-6), r_req[:, 0]))
        rk["req"][:Mu] = r_req
        rk["node"][:Mu] = r_node
        rk["accel_mem"][:Mu] = r_mem
        rk["gang"][:Mu] = r_grp
        rk["valid"][:Mu] = True
        rk["releasing"][:Mu] = r_rel
        rk["filter_class"][:Mu] = np.fromiter(
            (filter_class_of(p, dra_of(p)[1]) for p in running_pods),
            np.int32, Mu)
        # group-derived fields via per-group tables + one gather
        ng = len(pod_groups)
        pg_queue = np.fromiter(
            (q_index.get(g2.queue, 0) for g2 in pod_groups), np.int32,
            ng) if ng else np.zeros((0,), np.int32)
        pg_prio = np.fromiter((g2.priority for g2 in pod_groups), np.int32,
                              ng) if ng else np.zeros((0,), np.int32)
        pg_pre = np.fromiter(
            (g2.preemptibility == apis.Preemptibility.PREEMPTIBLE
             for g2 in pod_groups), bool, ng) if ng else np.zeros((0,), bool)
        # float64: unix-epoch timestamps lose ~128s of precision in
        # float32, which corrupts minruntime protection windows
        pg_start = np.array(
            [(-1.0 if g2.last_start_timestamp is None
              else g2.last_start_timestamp) for g2 in pod_groups],
            np.float64) if ng else np.zeros((0,), np.float64)
        has_grp = r_grp >= 0
        gsafe = np.maximum(r_grp, 0)
        if ng:
            rk["queue"][:Mu] = np.where(has_grp, pg_queue[gsafe], 0)
            rk["priority"][:Mu] = np.where(has_grp, pg_prio[gsafe], 0)
            rk["preemptible"][:Mu] = has_grp & pg_pre[gsafe]
            # -1 sentinel when the gang never started: the reference's
            # minruntime protection returns NOT protected for a nil
            # LastStartTimestamp (minruntime.go isPreemptMinRuntimeProtected)
            started = pg_start[gsafe]
            rk["runtime_s"][:Mu] = np.where(
                has_grp & (started >= 0),
                np.maximum(0.0, now - started), -1.0)
        np.add.at(gk["running_count"], gsafe[has_grp & ~r_rel], 1)
        # subgroup attribution: pods of plain gangs (no declared
        # subgroups) count toward the default slot 0 in bulk; only gangs
        # with declared subgroups need the per-pod name lookup
        has_subs = np.fromiter((bool(s) for s in sub_slot), bool, G)
        active = has_grp & ~r_rel
        plain = active & ~has_subs[gsafe]
        np.add.at(sub_running, (gsafe[plain], np.zeros(int(plain.sum()),
                                                      np.int64)), 1)
        for j in np.nonzero(active & has_subs[gsafe])[0]:
            sub_running[r_grp[j], sub_slot[r_grp[j]].get(
                running_pods[j].subgroup or "", 0)] += 1
    if Mu:
        running_names[:Mu] = [p.name for p in running_pods]
        # --- device occupancy (GPU-group bookkeeping) --------------------
        # Fast path: whole-device pods with no recorded device list on
        # nodes carrying no fractional/pinned pods get first-fit devices —
        # which is exactly a contiguous per-node assignment in pod order,
        # computed as one grouped prefix sum.  Fractional pods, pods with
        # recorded devices, and every pod sharing a node with one take the
        # per-pod path (order within a node matches the old sequential
        # first-fit exactly: node sets are disjoint between the paths).
        whole_k = np.rint(r_req[:, 0] * (r_por <= 0) * (r_mem <= 0)
                          ).astype(np.int64)
        has_dev = np.fromiter((bool(p.accel_devices) for p in running_pods),
                              bool, Mu)
        has_ext = np.fromiter((bool(p.extended) for p in running_pods),
                              bool, Mu)
        on = r_node >= 0
        frac = (r_por > 0) | (r_mem > 0)
        touches = on & (frac | (whole_k > 0))
        special = touches & (frac | has_dev)
        node_special = np.zeros((N,), bool)
        node_special[r_node[special]] = True
        vec = touches & ~special & ~node_special[np.maximum(r_node, 0)]
        # extended scalars: only pods that carry them
        for j in np.nonzero(has_ext & on)[0].tolist():
            pod = running_pods[j]
            ni = int(r_node[j])
            for ek, ev in pod.extended.items():
                ei = ext_index[ek]
                taken = min(ev, float(ext_free[ni, ei]))
                ext_free[ni, ei] -= taken
                rk["extended"][j, ei] = taken
                if pod.status == apis.PodStatus.RELEASING:
                    ext_rel[ni, ei] += taken
        vj = np.nonzero(vec)[0]
        if len(vj):
            accel_counts_a = np.asarray(accel_counts, np.int64)
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
                (np.int64(1) << end) - (np.int64(1) << off)).astype(np.int32)
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
        for j in np.nonzero(touches & ~vec)[0].tolist():
            pod = running_pods[j]
            ni = int(r_node[j])
            if frac[j]:
                p = (pod.accel_portion if pod.accel_portion > 0
                     else pod.accel_memory_gib / max(node_dev_mem[ni], 1e-6))
                if pod.accel_devices:
                    d0 = pod.accel_devices[0]
                else:  # deterministic first-fit, matching the binder
                    fits = np.nonzero(dev_free[ni] >= p - 1e-6)[0]
                    d0 = int(fits[0]) if len(fits) else 0
                taken = min(p, dev_free[ni, d0])
                dev_free[ni, d0] -= taken
                if pod.status == apis.PodStatus.RELEASING:
                    dev_rel[ni, d0] += taken
                rk["device"][j] = d0
                rk["accel_held"][j] = p
            else:
                k = int(whole_k[j])
                if pod.accel_devices:
                    devs = list(pod.accel_devices)[:k]
                else:
                    devs = list(np.nonzero(
                        dev_free[ni] >= 1.0 - 1e-6)[0][:k])
                mask = 0
                for d0 in devs:
                    taken = min(1.0, dev_free[ni, d0])
                    dev_free[ni, d0] -= taken
                    if pod.status == apis.PodStatus.RELEASING:
                        dev_rel[ni, d0] += taken
                    mask |= 1 << int(d0)
                rk["devices_mask"][j] = mask
                rk["accel_held"][j] = float(len(devs))
    # --- allocated DRA claims hold concrete devices (ref
    # populateDRAGPUs): debit the device table and node accel pool —
    # running claim-holders' own req rows do NOT include the claimed
    # devices, so this is the single accounting point -----------------
    claim_used = np.zeros((N, R), np.float32)
    for claim in (resource_claims or {}).values():
        ni = node_idx.get(claim.node) if claim.node else None
        if ni is None:
            continue
        for d0 in claim.devices:
            if d0 < D:
                taken = min(1.0, float(dev_free[ni, d0]))
                dev_free[ni, d0] -= taken
                claim_used[ni, 0] += taken
    for i, grp_obj in enumerate(pod_groups):
        if grp_obj.stale_since is not None:
            gk["stale_s"][i] = max(0.0, now - grp_obj.stale_since)
    gk["min_needed"] = np.maximum(gk["min_member"] - gk["running_count"], 0)
    gk["subgroup_min_needed"] = np.maximum(
        gk["subgroup_min_member"] - sub_running, 0)

    # --- task-type table + scheduling signatures --------------------------
    Y = _round_up(max(len(task_type_index), 1, cap.types), 4)
    gk["type_req"] = np.zeros((Y, R), np.float32)
    gk["type_selector"] = np.full((Y, K), -1, np.int32)
    gk["type_portion"] = np.zeros((Y,), np.float32)
    gk["type_mem"] = np.zeros((Y,), np.float32)
    gk["type_class"] = np.zeros((Y,), np.int32)
    gk["type_extended"] = np.zeros((Y, E), np.float32)
    if nf:
        gk["type_req"][:Yn] = t_req
        gk["type_selector"][:Yn] = t_sel
        gk["type_portion"][:Yn] = t_por
        gk["type_mem"][:Yn] = t_mem
        gk["type_class"][:Yn] = t_cls
        gk["type_extended"][:Yn] = t_ext
    # scheduling-constraints signature (ref minimal_job_comparison.go):
    # equivalent gangs = identical rows of [sorted (type,subgroup) multiset
    # | per-subgroup (min_needed, required_level) | queue/quorum/topology
    # scalars] — one np.unique instead of a per-gang Python tuple build
    big = np.int64(Y) * (S + 1) + 1
    comp = np.where(gk["task_valid"],
                    gk["task_type"].astype(np.int64) * (S + 1)
                    + gk["task_subgroup"], big)
    comp.sort(axis=1)
    sub_mn = np.where(gk["subgroup_valid"], gk["subgroup_min_needed"], -2)
    sub_rl = np.where(gk["subgroup_valid"], gk["subgroup_required_level"],
                      -2)
    sig_mat = np.concatenate([
        comp, sub_mn, sub_rl,
        gk["queue"][:, None].astype(np.int64),
        gk["min_needed"][:, None], gk["required_level"][:, None],
        gk["preferred_level"][:, None], gk["anti_self_level"][:, None],
        gk["preemptible"][:, None].astype(np.int64),
        (~gk["valid"][:, None]).astype(np.int64),
    ], axis=1, dtype=np.int64)
    gk["sig"] = dense_row_ids(sig_mat).astype(np.int32)

    # --- derived node free/releasing + queue rollups (shared section) ----
    # The MIG g-equivalents enter the SNAPSHOT rollups — allocated,
    # request, and through them the fairness division — AND (via
    # GangState.ext_accel) the in-cycle placement queue deltas, so
    # over-share detection and the quota/reclaim gates fire for
    # pure-MIG queues in the same cycle (ref GetTotalGPURequest).
    r_mig = np.zeros((M,), np.float32)
    if g_of_ext.any():
        for _j, _pod in enumerate(running_pods):
            if _pod.extended:
                r_mig[_j] = sum(
                    g_of_ext[ext_index[k]] * v
                    for k, v in _pod.extended.items()
                    if k in ext_index)
    roll = derive_rollups(
        node_alloc=node_alloc, claim_used=claim_used, rk=rk, gk=gk,
        g_of_ext=g_of_ext, r_mig=r_mig, queue_usage=queue_usage,
        q_index=q_index, q_parent=q_parent, q_depth=q_depth,
        num_queues=len(queues))
    node_rel, node_free = roll["node_rel"], roll["node_free"]
    q_alloc, q_alloc_np = roll["q_alloc"], roll["q_alloc_np"]
    q_request, q_usage = roll["q_request"], roll["q_usage"]

    # --- evaluate filter classes against nodes (host, once per spec) ------
    running_views = [
        node_filters._RunningPodView(
            labels=pod.labels,
            node=int(rk["node"][j]),
            host_ports=tuple(pod.host_ports),
            anti_terms=tuple(
                (t.match_labels, t.topology_key)
                for t in pod.pod_affinity if t.required and t.anti))
        for j, pod in enumerate(running_pods)
        if pod.status != apis.PodStatus.RELEASING]
    filter_masks, soft_scores = node_filters.evaluate_filter_classes(
        filter_specs, spec_pods, live_nodes, node_topo, topo_levels,
        running_views, N, incycle_pos_terms=frozenset(incycle_pos_terms))

    # --- kernel-config hints derived from the snapshot shape --------------
    has_fracs = bool(gk["task_portion"].any() or gk["task_accel_mem"].any()
                     or (rk["device"] >= 0).any())
    tvm = gk["task_valid"][:, :, None]
    uniform = (
        not has_fracs
        and not ext_keys  # extended resources take the per-task path
        # declared subgroups need the per-task path; a gang-level
        # required topology level (slot 0) is native to the whole-gang
        # kernel's single-domain fill
        and not any(g.sub_groups for g in pod_groups)
        and bool((gk["task_nominated"] < 0).all())
        # per-node anti-self is supported by the whole-gang kernel (one
        # replica per node); coarser levels need the per-task path
        and bool(((gk["anti_self_level"] == -1)
                  | (gk["anti_self_level"] == L)).all())
        # padded task rows are zero — compare valid rows against task 0
        and bool((np.where(tvm, gk["task_req"],
                           gk["task_req"][:, :1]) ==
                  gk["task_req"][:, :1]).all())
        and bool((np.where(tvm, gk["task_selector"],
                           gk["task_selector"][:, :1]) ==
                  gk["task_selector"][:, :1]).all())
        and bool((np.where(gk["task_valid"], gk["task_filter_class"],
                           gk["task_filter_class"][:, :1]) ==
                  gk["task_filter_class"][:, :1]).all()))

    host = {}
    nodes_h = dict(
        allocatable=node_alloc, free=node_free, releasing=node_rel,
        valid=node_valid, labels=node_labels, topology=node_topo,
        device_free=dev_free, device_releasing=dev_rel,
        device_memory_gib=node_dev_mem,
        filter_masks=np.asarray(filter_masks),
        soft_scores=np.asarray(soft_scores, np.float32),
        extended_free=ext_free, extended_releasing=ext_rel)
    queues_h = dict(
        parent=q_parent, depth=q_depth, priority=q_priority, quota=q_quota,
        over_quota_weight=q_oqw, limit=q_limit, allocated=q_alloc,
        allocated_nonpreemptible=q_alloc_np, request=q_request,
        usage=q_usage, fair_share=np.zeros((Q, R), np.float32),
        valid=q_valid, creation_order=q_creation,
        preempt_min_runtime=q_preempt_mrt,
        reclaim_min_runtime=q_reclaim_mrt,
        preempt_min_runtime_eff=np.asarray(q_preempt_eff, np.float32),
        reclaim_min_runtime_eff=np.asarray(q_reclaim_eff, np.float32))
    gangs_h = dict(gk, anti_term_level=anti_term_level,
                   attract_static=attract_static)
    for sec, d in (("nodes", nodes_h), ("queues", queues_h),
                   ("gangs", gangs_h), ("running", rk)):
        for k, v in d.items():
            v = np.asarray(v)
            if v.dtype.kind == "f":
                v = v.astype(np.float32, copy=False)
            host[f"{sec}.{k}"] = v
    index = SnapshotIndex(
        node_names=node_names,
        queue_names=queue_names,
        gang_names=group_names,
        task_names=task_names,
        running_pod_names=running_names,
        selector_keys=selector_keys,
        label_vocab=label_vocab,
        topology_levels=topo_levels,
        needs_device_table=has_fracs,
        uniform_gangs=uniform,
        has_required_topology=bool((gk["required_level"] >= 0).any()),
        has_preferred_topology=bool((gk["preferred_level"] >= 0).any()),
        has_subgroup_topology=bool(
            (gk["subgroup_required_level"] >= 0).any()),
        has_extended_resources=bool(ext_keys),
        extended_keys=ext_keys,
        has_reclaim_minruntime=bool((q_reclaim_mrt > 0).any()),
        has_anti_groups=len(anti_term_level) > 0,
        num_anti_groups=len(anti_term_level),
        has_attract_groups=bool((gk["attract_needs"] >= 0).any()),
        max_queue_depth=int(q_depth.max(initial=0)),
        num_leaf_queues=int(
            (q_valid & ~np.isin(np.arange(Q),
                                q_parent[q_parent >= 0])).sum()),
        num_pending_gangs=int(gk["task_valid"].any(axis=1).sum()),
        claims_by_pod={p.name: list(p.resource_claims)
                       for p in all_pend if p.resource_claims},
        host_tables={
            "task_portion": gk["task_portion"],
            "task_accel_mem": gk["task_accel_mem"],
            "task_req0": np.ascontiguousarray(gk["task_req"][:, :, 0]),
            "task_dra": gk["task_dra"],
            "running_gang": rk["gang"],
            "queue_usage": q_usage,
            "gang_valid": gk["valid"],
        },
        dense_feasibility=(
            not selector_keys and len(filter_specs) == 1
            # class-0 must actually span the node axis: untolerated
            # NoSchedule/NoExecute taints shrink even the empty-spec mask
            and bool(np.asarray(filter_masks)[0][node_valid].all())
            and bool((gk["anti_self_level"] < 0).all())
            and bool((gk["subgroup_required_level"] < 0).all())),
    )
    return host, index


def build_snapshot(
    nodes: list[apis.Node],
    queues: list[apis.Queue],
    pod_groups: list[apis.PodGroup],
    pods: list[apis.Pod],
    topology: apis.Topology | None = None,
    *,
    device: "str | torch.device" = "cuda",
    return_host: bool = False,
    **kwargs,
):
    """Flatten API objects into a ClusterState on ``device`` (+ index for
    the commit path): the numpy assembly of :func:`build_snapshot_host`,
    then ONE host-to-device copy through the transfer ledger.
    ``index.upload_seconds`` records the copy's wall time (the snapshot
    phase minus the host assembly).  ``return_host=True`` also returns
    the host mirror — the numpy leaves keyed by dotted path, in
    :func:`leaf_paths` order — that the incremental snapshotter keeps to
    patch later cycles."""
    dev = resolve_device(device)
    host, index = build_snapshot_host(nodes, queues, pod_groups, pods,
                                      topology, **kwargs)
    t0 = time.perf_counter()
    state = state_from_numpy(host, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    index.upload_seconds = time.perf_counter() - t0
    if return_host:
        return state, index, {k: host[k] for k in leaf_paths()}
    return state, index
