"""Binder — consumes BindRequests and commits pod→node bindings.

Port of ``kai_scheduler_tpu/binder/binder.py``.  Reference: a separate
controller process (``pkg/binder``) watching
BindRequest CRs; per request it runs a PreBind plugin chain (volume
binding, DRA claims, GPU-sharing env injection), calls the
``pods/binding`` subresource, and on failure rolls back and retries up
to ``BackoffLimit`` (``binder/controllers/bindrequest_controller.go:55``,
``binder/binding/binder.go:34-130``).

Here the binder is an in-process reconciler over ``Cluster``: the plugin
chain is the same Name/PreBind/PostBind/Rollback protocol
(``binder/plugins/interface.go:16-24``), and async-ness is modeled by
processing whatever requests exist when ``reconcile`` runs.  Every phase
change of a BindRequest marks its pod in the cluster's mutation journal
(through ``intake/gate.py``): a Pending request presents its pod as bound
in the snapshot, so the incremental snapshotter must re-encode it.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

from ..apis import types as apis
from ..intake import gate as _gate
from ..runtime.cluster import Cluster


class BinderPlugin(Protocol):
    """ref ``binder/plugins/interface.go:16-24``."""

    name: str

    def pre_bind(self, cluster: Cluster, pod: apis.Pod,
                 request: apis.BindRequest) -> None: ...

    def post_bind(self, cluster: Cluster, pod: apis.Pod,
                  request: apis.BindRequest) -> None: ...

    def rollback(self, cluster: Cluster, pod: apis.Pod,
                 request: apis.BindRequest) -> None: ...


@dataclasses.dataclass
class GpuSharingPlugin:
    """Fractional-accelerator bind support.

    The reference's gpusharing binder plugin injects visible-device env
    vars resolved through a reservation pod per shared GPU group
    (``binder/binding/resourcereservation/``).  Here:
    device identity is scheduler-owned (no discovery round trip), and
    the share group is pinned through the cluster's
    ``ReservationRegistry`` — PreBind joins the target device's
    reservation (creating it for the first sharer), Rollback leaves it,
    and the registry's UUID is what the runtime mounts.
    """

    name: str = "gpusharing"
    _saved_portions: dict = dataclasses.field(default_factory=dict)
    _acquired: dict = dataclasses.field(default_factory=dict)

    def pre_bind(self, cluster, pod, request):
        if request.received_resource_type == apis.ReceivedResourceType.FRACTION:
            self._saved_portions[pod.name] = pod.accel_portion
            pod.accel_portion = request.received_accel_portion or pod.accel_portion
            if request.selected_accel_groups:
                dev = request.selected_accel_groups[0]
                cluster.reservations.acquire(
                    request.selected_node, dev, pod.name)
                self._acquired[pod.name] = (request.selected_node, dev)

    def post_bind(self, cluster, pod, request):
        self._saved_portions.pop(pod.name, None)
        self._acquired.pop(pod.name, None)

    def rollback(self, cluster, pod, request):
        if pod.name in self._saved_portions:
            pod.accel_portion = self._saved_portions.pop(pod.name)
        if pod.name in self._acquired:
            node, dev = self._acquired.pop(pod.name)
            cluster.reservations.release(pod.name, node, dev)


@dataclasses.dataclass
class DynamicResourcesPlugin:
    """DRA claim binding — the k8s-plugins binder plugin's claim path
    (``pkg/binder/plugins/k8s-plugins`` binding ResourceClaims through
    the upstream DRA manager).

    PreBind allocates each named claim onto the target node: verifies
    the claim's DeviceClass constraints against the node, picks concrete
    fully-free devices (first-fit over the runtime device table), and
    writes the allocation onto the claim object.  Rollback deallocates.
    """

    name: str = "dynamicresources"
    _bound: dict = dataclasses.field(default_factory=dict)

    def pre_bind(self, cluster, pod, request):
        names = [c for c in request.resource_claim_allocations
                 if isinstance(c, str)]
        if not names:
            return
        node = cluster.nodes[request.selected_node]
        done: list[str] = []
        try:
            for cname in names:
                claim = cluster.resource_claims.get(cname)
                if claim is None:
                    raise RuntimeError(f"unknown ResourceClaim {cname}")
                if claim.node is not None and claim.owner_pod != pod.name:
                    raise RuntimeError(
                        f"claim {cname} already allocated on {claim.node}")
                if (claim.node == node.name
                        and claim.owner_pod == pod.name):
                    # already satisfied for THIS pod on THIS node (a
                    # retried bind after snapshot/restore) — its devices
                    # are the ones node_device_free counts as taken;
                    # re-allocating would demand count MORE
                    continue
                dc = cluster.device_classes.get(claim.device_class)
                if dc is not None:
                    if (dc.min_memory_gib > 0
                            and node.accel_memory_gib < dc.min_memory_gib):
                        raise RuntimeError(
                            f"node {node.name} devices below class "
                            f"{dc.name} min memory")
                    for k, v in dc.node_selector.items():
                        if node.labels.get(k) != v:
                            raise RuntimeError(
                                f"node {node.name} fails class {dc.name} "
                                f"selector {k}={v}")
                free = cluster.node_device_free(node.name)
                fully = [d for d, f in enumerate(free) if f >= 1.0 - 1e-6]
                if len(fully) < claim.count:
                    raise RuntimeError(
                        f"only {len(fully)} free devices on {node.name} "
                        f"for claim {cname} (needs {claim.count})")
                claim.node = node.name
                claim.devices = fully[:claim.count]
                claim.owner_pod = pod.name
                done.append(cname)
            self._bound[pod.name] = done
        except Exception:
            for cname in done:  # deallocate this pod's partial progress
                claim = cluster.resource_claims[cname]
                claim.node = None
                claim.devices = []
                claim.owner_pod = None
            raise

    def post_bind(self, cluster, pod, request):
        self._bound.pop(pod.name, None)

    def rollback(self, cluster, pod, request):
        for cname in self._bound.pop(pod.name, []):
            claim = cluster.resource_claims.get(cname)
            if claim is not None:
                claim.node = None
                claim.devices = []
                claim.owner_pod = None


@dataclasses.dataclass
class VolumeBindingPlugin:
    """Volume binding at PreBind — the k8s-plugins binder plugin's
    volumebinding path (``pkg/binder/plugins/`` binding
    WaitForFirstConsumer PVCs once the pod's node is chosen).

    PreBind binds each unbound claim: verifies its StorageClass
    allowedTopologies against the target node, then records the
    volume's topology as the node's matching labels (hostname fallback)
    so future cycles pin co-users to it.  Rollback unbinds claims bound
    in this attempt.
    """

    name: str = "volumebinding"
    _bound: dict = dataclasses.field(default_factory=dict)

    def pre_bind(self, cluster, pod, request):
        if not pod.volume_claims:
            return
        node = cluster.nodes[request.selected_node]

        def node_label(k):
            # hostname falls back to the node name — per-node volume
            # pins must work on unlabeled nodes
            return node.labels.get(
                k, node.name if k == "kubernetes.io/hostname" else None)

        done: list[str] = []
        try:
            for vname in pod.volume_claims:
                pvc = cluster.volume_claims.get(vname)
                if pvc is None:
                    raise RuntimeError(f"unknown PVC {vname}")
                if pvc.bound:
                    if any(node_label(k) != v
                           for k, v in pvc.node_affinity.items()):
                        raise RuntimeError(
                            f"PVC {vname} volume not reachable from "
                            f"{node.name}")
                    continue
                sc = cluster.storage_classes.get(pvc.storage_class)
                topo = dict(sc.allowed_topology) if sc else {}
                if any(node.labels.get(k) != v for k, v in topo.items()):
                    raise RuntimeError(
                        f"node {node.name} outside PVC {vname} class "
                        "topology")
                # the provisioned volume's topology: the class topology,
                # or pinned to the node when the class does not restrict
                pvc.node_affinity = topo or {
                    "kubernetes.io/hostname": node.name}
                pvc.bound = True
                done.append(vname)
            self._bound[pod.name] = done
        except Exception:
            for vname in done:
                pvc = cluster.volume_claims[vname]
                pvc.bound = False
                pvc.node_affinity = {}
            raise

    def post_bind(self, cluster, pod, request):
        self._bound.pop(pod.name, None)

    def rollback(self, cluster, pod, request):
        for vname in self._bound.pop(pod.name, []):
            pvc = cluster.volume_claims.get(vname)
            if pvc is not None:
                pvc.bound = False
                pvc.node_affinity = {}


@dataclasses.dataclass
class BindResult:
    bound: list[str] = dataclasses.field(default_factory=list)
    failed: list[str] = dataclasses.field(default_factory=list)
    retrying: list[str] = dataclasses.field(default_factory=list)


class Binder:
    """BindRequest reconciler with backoff."""

    def __init__(self, plugins: list[BinderPlugin] | None = None):
        self.plugins = plugins if plugins is not None else [
            VolumeBindingPlugin(), DynamicResourcesPlugin(),
            GpuSharingPlugin()]

    def reconcile(self, cluster: Cluster) -> BindResult:
        """Process all pending BindRequests once (one controller sweep)."""
        result = BindResult()
        for br in list(cluster.bind_requests.values()):
            if br.phase != "Pending":
                continue
            pod = cluster.pods.get(br.pod_name)
            if pod is None or pod.status in (apis.PodStatus.SUCCEEDED,
                                             apis.PodStatus.FAILED):
                br.phase = "Failed"
                _gate.pod_touched(cluster.journal, br.pod_name)
                result.failed.append(br.pod_name)
                continue
            if pod.status == apis.PodStatus.RELEASING:
                # pipelined rebind: the old pod is still vacating; wait
                # for its restart (consolidation move path)
                result.retrying.append(br.pod_name)
                continue
            if pod.status != apis.PodStatus.PENDING:
                br.phase = "Failed"
                _gate.pod_touched(cluster.journal, br.pod_name)
                result.failed.append(br.pod_name)
                continue
            done: list[BinderPlugin] = []
            try:
                for plugin in self.plugins:
                    plugin.pre_bind(cluster, pod, br)
                    done.append(plugin)
                cluster.bind_pod(br.pod_name, br.selected_node,
                                 devices=br.selected_accel_groups or None)
            except Exception:
                for plugin in reversed(done):
                    plugin.rollback(cluster, pod, br)
                br.failures += 1
                if br.failures > br.backoff_limit:
                    br.phase = "Failed"
                    _gate.pod_touched(cluster.journal, br.pod_name)
                    result.failed.append(br.pod_name)
                else:
                    result.retrying.append(br.pod_name)
                continue
            for plugin in self.plugins:
                plugin.post_bind(cluster, pod, br)
            br.phase = "Succeeded"
            _gate.pod_touched(cluster.journal, br.pod_name)
            result.bound.append(br.pod_name)
        return result
