"""In-memory cluster model — the framework's stand-in for the K8s API server.

Port of ``kai_scheduler_tpu/runtime/cluster.py`` (the parts one cycle
uses): intake writes objects into it, the scheduler snapshots it, the
binder commits bindings back, and the victim actions' evictions mark pods
releasing until the next ``tick`` reaps them (or, for consolidation
moves, returns them to PENDING for their pipelined rebind).  The
shared-device reservation registry (``runtime/reservation.py``) is the
binder's gpusharing plugin's; ``tick`` releases a deleted pod's entries.
Every mutation records the keys it dirtied in the cluster's mutation
journal (``state/incremental.MutationJournal``, through the
``intake/gate.py`` helpers): ``submit``, ``create_bind_request``,
``bind_pod``, ``evict_pod`` and ``tick`` (pods started, restarted and
reaped), so the incremental snapshotter refreshes in proportion to the
churn.  The intake surfaces (delta documents) wait for the intake slice.
"""
from __future__ import annotations

import dataclasses

from ..apis import types as apis
from ..intake import gate as _gate
from .reservation import ReservationRegistry


@dataclasses.dataclass
class Cluster:
    """Mutable cluster document store, keyed by object name."""

    nodes: dict[str, apis.Node] = dataclasses.field(default_factory=dict)
    queues: dict[str, apis.Queue] = dataclasses.field(default_factory=dict)
    pod_groups: dict[str, apis.PodGroup] = dataclasses.field(
        default_factory=dict)
    pods: dict[str, apis.Pod] = dataclasses.field(default_factory=dict)
    topology: apis.Topology | None = None
    bind_requests: dict[str, apis.BindRequest] = dataclasses.field(
        default_factory=dict)
    resource_claims: dict[str, apis.ResourceClaim] = dataclasses.field(
        default_factory=dict)
    device_classes: dict[str, apis.DeviceClass] = dataclasses.field(
        default_factory=dict)
    volume_claims: dict[str, apis.PersistentVolumeClaim] = dataclasses.field(
        default_factory=dict)
    storage_classes: dict[str, apis.StorageClass] = dataclasses.field(
        default_factory=dict)
    #: monotonic clock advanced by the simulation driver
    now: float = 0.0
    #: evicted pods whose workload controller will recreate them (the
    #: consolidation-move path) — on the next tick they return to PENDING
    #: instead of vanishing
    restarting: set[str] = dataclasses.field(default_factory=set)
    #: shared-device reservations (the binder's gpusharing plugin)
    reservations: ReservationRegistry = dataclasses.field(
        default_factory=ReservationRegistry)
    #: mutation journal: every state change records the keys it dirtied
    #: so the incremental snapshotter (state/incremental.py) refreshes in
    #: proportion to the churn; a deep copy starts a journal of its own
    journal: "object" = None

    def __post_init__(self):
        if self.journal is None:
            from ..state.incremental import MutationJournal
            self.journal = MutationJournal()

    @classmethod
    def from_objects(cls, nodes, queues, pod_groups, pods,
                     topology=None) -> "Cluster":
        c = cls(topology=topology)
        for n in nodes:
            c.nodes[n.name] = n
        for q in queues:
            c.queues[q.name] = q
        for g in pod_groups:
            c.pod_groups[g.name] = g
        for p in pods:
            c.pods[p.name] = p
        return c

    def submit(self, group: apis.PodGroup, pods: list[apis.Pod]) -> None:
        """Add a workload (PodGroup + its pods) — podgrouper output."""
        group.creation_timestamp = group.creation_timestamp or self.now
        if group.name in self.pod_groups:
            _gate.gang_touched(self.journal, group.name)
        else:
            _gate.gang_added(self.journal, group.name)
        self.pod_groups[group.name] = group
        for p in pods:
            p.creation_timestamp = p.creation_timestamp or self.now
            if p.name in self.pods:
                _gate.pod_touched(self.journal, p.name)
            else:
                _gate.pod_added(self.journal, p.name)
            self.pods[p.name] = p

    def snapshot_lists(self):
        """Stable-ordered object lists for ``build_snapshot``.  Pods with an
        in-flight (Pending) BindRequest are presented as BOUND on their
        selected node (ref ``cluster_info.go:323`` snapshotBindRequests)."""
        pods: list[apis.Pod] = []
        for p in self.pods.values():
            br = self.bind_requests.get(p.name)
            if (p.status == apis.PodStatus.PENDING and br is not None
                    and br.phase == "Pending"):
                pods.append(dataclasses.replace(
                    p, status=apis.PodStatus.BOUND, node=br.selected_node))
            elif (p.status == apis.PodStatus.RELEASING and br is not None
                    and br.phase == "Pending"):
                # consolidation move in flight: old node (releasing) AND
                # the rebind target
                pods.append(p)
                pods.append(dataclasses.replace(
                    p, status=apis.PodStatus.BOUND, node=br.selected_node,
                    accel_devices=[]))
            else:
                pods.append(p)
        return (list(self.nodes.values()), list(self.queues.values()),
                list(self.pod_groups.values()), pods, self.topology)

    def create_bind_request(self, br: apis.BindRequest) -> None:
        self.bind_requests[br.pod_name] = br
        # a Pending BindRequest changes the pod's snapshot presentation
        _gate.pod_touched(self.journal, br.pod_name)

    def node_device_free(self, node_name: str) -> list[float]:
        """Free share per accel device on a node, from pods' recorded
        devices and allocated DRA claims."""
        node = self.nodes[node_name]
        free = [1.0] * int(round(node.allocatable.accel))
        for claim in self.resource_claims.values():
            if claim.node == node_name:
                for d in claim.devices:
                    if d < len(free):
                        free[d] = 0.0
        for pod in self.pods.values():
            if pod.node != node_name or pod.status not in (
                    apis.PodStatus.BOUND, apis.PodStatus.RUNNING,
                    apis.PodStatus.RELEASING):
                continue
            if pod.accel_portion > 0 or pod.accel_memory_gib > 0:
                share = (pod.accel_portion if pod.accel_portion > 0
                         else pod.accel_memory_gib
                         / max(node.accel_memory_gib, 1e-6))
                for d in pod.accel_devices[:1]:
                    if d < len(free):
                        free[d] = max(0.0, free[d] - share)
            else:
                for d in pod.accel_devices:
                    if d < len(free):
                        free[d] = 0.0
        return free

    def bind_pod(self, pod_name: str, node_name: str,
                 devices: list[int] | None = None) -> None:
        """pods/binding subresource equivalent; assigns concrete accel
        devices (first fitting / first fully-free, as the snapshot
        builder assumes)."""
        pod = self.pods[pod_name]
        if node_name not in self.nodes:
            raise KeyError(f"node {node_name} not found")
        free = self.node_device_free(node_name)
        if pod.accel_portion > 0 or pod.accel_memory_gib > 0:
            node = self.nodes[node_name]
            share = (pod.accel_portion if pod.accel_portion > 0
                     else pod.accel_memory_gib
                     / max(node.accel_memory_gib, 1e-6))
            if devices:
                pod.accel_devices = devices[:1]
            else:
                fits = [d for d, f in enumerate(free) if f >= share - 1e-6]
                pod.accel_devices = fits[:1]
            if not pod.accel_devices:
                raise RuntimeError(
                    f"no device on {node_name} fits share {share} for "
                    f"{pod_name}")
        else:
            k = int(round(pod.resources.accel))
            if k > 0 and not pod.accel_devices:
                fully = [d for d, f in enumerate(free) if f >= 1.0 - 1e-6]
                if len(fully) < k:
                    raise RuntimeError(
                        f"only {len(fully)} fully-free devices on "
                        f"{node_name}, {pod_name} needs {k}")
                pod.accel_devices = fully[:k]
        pod.node = node_name
        pod.status = apis.PodStatus.BOUND
        _gate.pod_touched(self.journal, pod_name)
        group = self.pod_groups.get(pod.group)
        if group is not None and group.last_start_timestamp is None:
            group.last_start_timestamp = self.now
            _gate.gang_touched(self.journal, group.name)

    def evict_pod(self, pod_name: str, restart: bool = False) -> None:
        """Eviction = delete pod; its resources become releasing until the
        next tick reaps it.  ``restart=True`` models the workload
        controller recreating the pod (consolidation moves): after release
        it returns to PENDING so a pipelined rebind can land it on its
        planned node."""
        pod = self.pods.get(pod_name)
        if pod is not None:
            pod.status = apis.PodStatus.RELEASING
            _gate.pod_touched(self.journal, pod_name)
            if restart:
                self.restarting.add(pod_name)

    def tick(self, seconds: float = 1.0) -> None:
        """Advance time: bound pods start running, releasing pods vanish
        (their DRA claims deallocate and their device reservations drop
        them) or, when restarting, return to PENDING."""
        self.now += seconds
        _gate.time_advanced(self.journal)
        for name in list(self.pods):
            pod = self.pods[name]
            if pod.status == apis.PodStatus.RELEASING:
                for claim in self.resource_claims.values():
                    if claim.owner_pod == name:
                        claim.node = None
                        claim.devices = []
                        claim.owner_pod = None
                # ... and its device reservations drop this sharer
                self.reservations.release(name)
                if name in self.restarting:
                    self.restarting.discard(name)
                    pod.status = apis.PodStatus.PENDING
                    pod.node = None
                    pod.accel_devices = []
                    _gate.pod_touched(self.journal, name)
                else:
                    del self.pods[name]
                    _gate.pod_removed(self.journal, name)
            elif pod.status == apis.PodStatus.BOUND:
                pod.status = apis.PodStatus.RUNNING
                _gate.pod_touched(self.journal, name)
