"""CRD-equivalent API objects.

These dataclasses are the framework's "wire protocol" between intake
(podgrouper / admission), the scheduler core, and the binder — the role
played in the reference by the CRDs under ``pkg/apis``:

- ``Queue``        ref ``pkg/apis/scheduling/v2/queue_types.go:31-73``
- ``PodGroup``     ref ``pkg/apis/scheduling/v2alpha2/podgroup_types.go:34-77``
- ``BindRequest``  ref ``pkg/apis/scheduling/v1alpha2/bindrequest_types.go:12-51``
- ``Topology``     ref ``pkg/apis/kai/v1alpha1/topology_types.go:53-81``

They are host-side (pure Python) objects; ``state.cluster_state`` flattens
them into device tensors for the solver kernels.

This is the PyTorch port's own copy of the objects one allocate cycle
reads (``kai_scheduler_tpu.apis.types`` is the reference): the port
imports nothing of the JAX package.  The operator-level CRDs
(SchedulingShard, Config) and Eviction wait for the slices that use them.
"""
from __future__ import annotations

import dataclasses
import enum

# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------

#: Resource vector layout used across every tensor in the framework.
#: Units are chosen so float32 is exact enough at cluster scale:
#: accelerators in device counts, CPU in cores, memory in GiB.
RESOURCE_ACCEL = 0  #: accelerator devices (TPU chips; "GPU" in the reference)
RESOURCE_CPU = 1    #: CPU cores (float)
RESOURCE_MEM = 2    #: memory, GiB (float)
NUM_RESOURCES = 3
RESOURCE_NAMES = ("accel", "cpu", "memory")

#: Sentinel meaning "no limit" — ref ``commonconstants.UnlimitedResourceQuantity``.
UNLIMITED = -1.0


@dataclasses.dataclass(frozen=True)
class ResourceVec:
    """A (accel, cpu, mem) triple — ref ``api/resource_info/resource_info.go:34-37``."""

    accel: float = 0.0
    cpu: float = 0.0
    memory: float = 0.0

    def as_tuple(self) -> tuple[float, float, float]:
        return (self.accel, self.cpu, self.memory)

    def __add__(self, other: "ResourceVec") -> "ResourceVec":
        return ResourceVec(self.accel + other.accel, self.cpu + other.cpu,
                           self.memory + other.memory)


# ---------------------------------------------------------------------------
# Queue (ref pkg/apis/scheduling/v2/queue_types.go)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QueueResource:
    """Per-resource queue knobs — quota / overQuotaWeight / limit.

    Ref ``queue_types.go`` ``QueueResource{Quota,OverQuotaWeight,Limit}``.
    ``quota`` is the deserved (guaranteed) amount; ``limit`` the hard cap
    (``UNLIMITED`` for none); ``over_quota_weight`` the share weight for
    dividing surplus.
    """

    quota: float = 0.0
    over_quota_weight: float = 1.0
    limit: float = UNLIMITED


@dataclasses.dataclass
class Queue:
    """A scheduling queue; 2+-level hierarchy via ``parent``.

    Ref ``pkg/apis/scheduling/v2/queue_types.go:31-73``.
    """

    name: str
    parent: str | None = None
    priority: int = 0
    accel: QueueResource = dataclasses.field(default_factory=QueueResource)
    #: cpu/memory deserved quota defaults to UNLIMITED — accelerators are
    #: the managed resource; an unspecified cpu/mem quota must not gate
    #: non-preemptible workloads (matches the reference treating absent
    #: queue resources as unbounded deserved share).
    cpu: QueueResource = dataclasses.field(
        default_factory=lambda: QueueResource(quota=UNLIMITED))
    memory: QueueResource = dataclasses.field(
        default_factory=lambda: QueueResource(quota=UNLIMITED))
    #: minimum runtime before a job in this queue may be preempted / reclaimed
    #: (seconds) — ref queue_types.go ``PreemptMinRuntime``/``ReclaimMinRuntime``.
    preempt_min_runtime: float = 0.0
    reclaim_min_runtime: float = 0.0
    creation_timestamp: float = 0.0

    def resource(self, r: int) -> QueueResource:
        return (self.accel, self.cpu, self.memory)[r]


# ---------------------------------------------------------------------------
# Pods & PodGroups (ref pkg/apis/scheduling/v2alpha2/podgroup_types.go)
# ---------------------------------------------------------------------------

class PodStatus(enum.IntEnum):
    """Lifecycle of a task, reduced to what the scheduler needs.

    Ref ``pkg/scheduler/api/pod_status`` (Pending/Bound/Running/Releasing...).
    """

    PENDING = 0
    BOUND = 1      # scheduled this cycle or earlier, pod not yet running
    RUNNING = 2
    RELEASING = 3  # terminating; resources count as "releasing"
    SUCCEEDED = 4
    FAILED = 5


@dataclasses.dataclass
class Pod:
    """One task of a pod group — ref ``api/pod_info/pod_info.go:68-106``."""

    name: str
    group: str
    resources: ResourceVec = dataclasses.field(default_factory=ResourceVec)
    priority: int = 0
    status: PodStatus = PodStatus.PENDING
    node: str | None = None              # set when bound/running
    subgroup: str | None = None          # hierarchical gang subgroup name
    #: fraction of one accelerator requested (GPU-sharing); 0 => whole devices
    #: ref api/resource_info/gpu_resource_requirment.go portion
    accel_portion: float = 0.0
    #: memory-based share request, GiB of one device's memory (converted to
    #: a per-node portion against Node.accel_memory_gib) — ref
    #: gpu_resource_requirment.go gpuMemory
    accel_memory_gib: float = 0.0
    #: concrete device indices occupied on the bound node — whole-device
    #: pods list each device; fractional pods list their shared device.
    #: Assigned by the binder (ref SelectedGPUGroups + reservation pod).
    accel_devices: list[int] = dataclasses.field(default_factory=list)
    node_selector: dict[str, str] = dataclasses.field(default_factory=dict)
    #: pod labels — the match target of other pods' PodAffinityTerms
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    tolerations: list["Toleration"] = dataclasses.field(default_factory=list)
    #: required node-affinity matchExpressions, ANDed
    node_affinity: list["AffinityExpr"] = dataclasses.field(
        default_factory=list)
    pod_affinity: list["PodAffinityTerm"] = dataclasses.field(
        default_factory=list)
    #: preempted pods carry the node their preemption cleared — the
    #: nominatednode plugin gives it a dominating score bonus
    nominated_node: str | None = None
    #: extended scalar requests — MIG profiles etc. (ref migResources)
    extended: dict[str, float] = dataclasses.field(default_factory=dict)
    #: accelerators requested through DRA ResourceClaims — added to the
    #: accel accounting like whole devices (ref draGpuCounts; the claim
    #: allocation is recorded on the BindRequest)
    dra_accel_count: int = 0
    #: names of ResourceClaim objects this pod consumes (ref
    #: pod.spec.resourceClaims); when set, the claims' counts and their
    #: DeviceClass constraints drive the DRA accounting instead of
    #: ``dra_accel_count``
    resource_claims: list[str] = dataclasses.field(default_factory=list)
    #: PersistentVolumeClaim names (ref pod volumes → the VolumeBinding
    #: predicate + the binder's volume binding plugin)
    volume_claims: list[str] = dataclasses.field(default_factory=list)
    #: host ports the pod needs exclusively on its node (ref the
    #: NodePorts predicate)
    host_ports: list[int] = dataclasses.field(default_factory=list)
    creation_timestamp: float = 0.0


class Preemptibility(str, enum.Enum):
    """Ref podgroup_types.go ``Preemptibility``."""

    PREEMPTIBLE = "Preemptible"
    NON_PREEMPTIBLE = "NonPreemptible"


# ---------------------------------------------------------------------------
# Node-filter vocabulary: taints, tolerations, affinity
# (ref k8s_internal/predicates/predicates.go:70-140 — the upstream
# TaintToleration / NodeAffinity / InterPodAffinity filter surface)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Taint:
    """A node taint — upstream corev1.Taint semantics."""

    key: str
    value: str = ""
    #: "NoSchedule" | "PreferNoSchedule" | "NoExecute"
    effect: str = "NoSchedule"


@dataclasses.dataclass(frozen=True)
class Toleration:
    """A pod toleration — upstream corev1.Toleration semantics.

    ``key=None`` with operator "Exists" tolerates every taint;
    ``effect=None`` matches all effects.
    """

    key: str | None = None
    operator: str = "Equal"    # "Equal" | "Exists"
    value: str = ""
    effect: str | None = None

    def tolerates(self, taint: Taint) -> bool:
        if self.effect is not None and self.effect != taint.effect:
            return False
        if self.key is None:
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        return self.operator == "Exists" or self.value == taint.value


@dataclasses.dataclass(frozen=True)
class AffinityExpr:
    """One node-affinity matchExpression (requiredDuringScheduling term).

    Operators: In / NotIn / Exists / DoesNotExist / Gt / Lt — upstream
    NodeSelectorRequirement semantics.  A pod's expressions are ANDed.
    """

    key: str
    operator: str = "In"
    values: tuple[str, ...] = ()

    def matches(self, labels: dict[str, str]) -> bool:
        present = self.key in labels
        val = labels.get(self.key)
        if self.operator == "In":
            return present and val in self.values
        if self.operator == "NotIn":
            return not present or val not in self.values
        if self.operator == "Exists":
            return present
        if self.operator == "DoesNotExist":
            return not present
        if self.operator in ("Gt", "Lt"):
            if not present or not self.values:
                return False
            try:
                lhs, rhs = int(val), int(self.values[0])
            except ValueError:
                return False
            return lhs > rhs if self.operator == "Gt" else lhs < rhs
        raise ValueError(f"unknown affinity operator {self.operator!r}")


@dataclasses.dataclass(frozen=True)
class PodAffinityTerm:
    """Inter-pod (anti-)affinity term — upstream PodAffinityTerm reduced
    to a label-equality selector over existing pods plus a topology key
    (ref ``plugins/podaffinity``, upstream InterPodAffinity).

    ``topology_key`` names a Topology level label; an unknown key means
    per-node (hostname) granularity.  ``required=False`` terms contribute
    score instead of filtering.
    """

    match_labels: tuple[tuple[str, str], ...] = ()
    topology_key: str = "kubernetes.io/hostname"
    anti: bool = False
    required: bool = True

    def selects(self, labels: dict[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in self.match_labels)


@dataclasses.dataclass
class TopologyConstraint:
    """Gang placement constraint against a Topology tree.

    Ref ``podgroup_types.go:366-381`` — ``Required`` level: every pod of the
    gang must land inside one domain at that level; ``Preferred``: best-effort
    locality at that level.
    """

    topology: str | None = None
    required_level: str | None = None
    preferred_level: str | None = None


@dataclasses.dataclass
class SubGroup:
    """Hierarchical gang subgroup — ref podgroup_types.go ``SubGroups``."""

    name: str
    min_member: int = 0
    parent: str | None = None
    topology_constraint: TopologyConstraint | None = None


class PodGroupPhase(str, enum.Enum):
    """Ref ``podgroup_types.go`` PodGroupPhase / podgroupcontroller."""

    PENDING = "Pending"
    SCHEDULED = "Scheduled"
    RUNNING = "Running"
    UNSCHEDULABLE = "Unschedulable"
    STALE = "Stale"          # below minMember after having started


@dataclasses.dataclass
class PodGroup:
    """The gang unit — ref ``podgroup_types.go:34-77``."""

    name: str
    queue: str
    min_member: int = 1
    priority: int = 0
    #: object labels — the shard partition selector matches these (ref
    #: SchedulingNodePoolParams.GetLabelSelector, conf/scheduler_conf.go:96)
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    preemptibility: Preemptibility = Preemptibility.PREEMPTIBLE
    topology_constraint: TopologyConstraint | None = None
    sub_groups: list[SubGroup] = dataclasses.field(default_factory=list)
    #: number of failed scheduling cycles before the group is marked
    #: unschedulable — ref podgroup_types.go:69-70 ``SchedulingBackoff``
    #: (the reference supports -1 = never and 1; any positive value works
    #: here).  See ``utils/pod_group_utils.go`` NoSchedulingBackoff.
    scheduling_backoff: int = -1
    creation_timestamp: float = 0.0
    # --- status (written by the scheduler / podgroup controller) ---------
    #: consecutive cycles every action failed to place the group
    fit_failures: int = 0
    #: the UnschedulableOnNodePool condition: the snapshot skips the group
    #: until the condition is cleared (pod-set or capacity change)
    unschedulable: bool = False
    #: human-readable fit failure explanation — ref api/unschedule_info.go
    unschedulable_reason: str = ""
    #: pending-pod count observed when the condition was last evaluated —
    #: pod churn clears the unschedulable mark (podgroup controller)
    observed_pending: int = -1
    #: wall-clock the gang became running (for minruntime protection)
    last_start_timestamp: float | None = None
    #: status maintained by the podgroup controller
    phase: PodGroupPhase = PodGroupPhase.PENDING
    #: wall-clock the gang dropped below minMember while started — feeds
    #: the stalegangeviction action (ref PodGroupInfo staleness tracking).
    stale_since: float | None = None


# ---------------------------------------------------------------------------
# Nodes & Topology (ref pkg/apis/kai/v1alpha1/topology_types.go)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Node:
    """Schedulable machine — ref ``api/node_info/node_info.go:68-96``."""

    name: str
    allocatable: ResourceVec = dataclasses.field(default_factory=ResourceVec)
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    taints: list["Taint"] = dataclasses.field(default_factory=list)
    #: accelerator memory per device, GiB (for memory-based sharing)
    accel_memory_gib: float = 16.0
    #: extended scalar resources — MIG profiles
    #: (e.g. {"nvidia.com/mig-1g.5gb": 4}) and any other named scalar
    #: (ref GpuResourceRequirement.migResources / Resource.scalars)
    extended: dict[str, float] = dataclasses.field(default_factory=dict)
    unschedulable: bool = False


@dataclasses.dataclass
class Topology:
    """Ordered physical levels, outermost first — ref topology_types.go:53-81.

    ``levels`` holds node-label keys, e.g. ["cloud.provider.com/block",
    "cloud.provider.com/rack", "kubernetes.io/hostname"].
    """

    name: str
    levels: list[str] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# BindRequest (ref pkg/apis/scheduling/v1alpha2/bindrequest_types.go)
# ---------------------------------------------------------------------------

class ReceivedResourceType(str, enum.Enum):
    REGULAR = "Regular"
    FRACTION = "Fraction"


@dataclasses.dataclass
class BindRequest:
    """The scheduler->binder contract — ref bindrequest_types.go:12-51."""

    pod_name: str
    selected_node: str
    received_resource_type: ReceivedResourceType = ReceivedResourceType.REGULAR
    received_accel_count: int = 0
    received_accel_portion: float = 0.0
    #: memory-based share request, GiB — makes the bind record
    #: self-contained for memory-based fractions (ref ReceivedGpuMemory)
    received_accel_memory_gib: float = 0.0
    #: device indices chosen by the scheduler (fractional: the shared
    #: device; whole: filled by the binder) — ref SelectedGPUGroups
    selected_accel_groups: list[int] = dataclasses.field(default_factory=list)
    #: DRA claims this bind must allocate — claim NAMES when the pod
    #: declares ResourceClaims (the binder resolves concrete devices and
    #: records them on the claim objects), legacy integer placeholders
    #: for bare ``dra_accel_count`` pods — ref ResourceClaimAllocations
    resource_claim_allocations: list = dataclasses.field(
        default_factory=list)
    backoff_limit: int = 3
    #: filled by the binder
    phase: str = "Pending"   # Pending | Succeeded | Failed
    failures: int = 0


@dataclasses.dataclass
class StorageClass:
    """ref ``api/storageclass_info`` — bind mode + topology restriction
    (the storagecapacity/csidriver surface reduced to what placement
    actually consumes)."""

    name: str
    #: "Immediate" or "WaitForFirstConsumer" (volume binds at PreBind)
    bind_mode: str = "WaitForFirstConsumer"
    #: node-label constraints where volumes of this class can exist
    #: (allowedTopologies)
    allowed_topology: dict[str, str] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class PersistentVolumeClaim:
    """ref ``api/storageclaim_info`` — the VolumeBinding predicate's
    subject.  A BOUND claim pins pods to its volume's topology
    (``node_affinity``); an unbound WaitForFirstConsumer claim restricts
    to its class's allowed topology and binds at PreBind."""

    name: str
    storage_class: str = ""
    capacity_gib: float = 0.0
    bound: bool = False
    #: the bound volume's topology (zone/hostname labels) — pods using
    #: the claim must land on matching nodes
    node_affinity: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DeviceClass:
    """DRA device selection — ref resource.k8s.io DeviceClass with CEL
    selectors (``plugins/dynamicresources/dynamicresources.go:30-70``).
    On the structured device model the CEL surface degenerates to the
    attributes devices actually expose here: per-device memory and the
    owning node's labels."""

    name: str
    #: device must have at least this much memory (CEL
    #: ``device.capacity['memory']`` comparisons)
    min_memory_gib: float = 0.0
    #: this class allocates ACCELERATOR devices (counts toward the accel
    #: request and the queue's gpu quota); False = a non-gpu device
    #: class, ignored by the accel accounting (ref allocate_dra_test.go
    #: "non gpu claims doesn't count for gpu limit")
    accel: bool = True
    #: node-label constraints (CEL node attribute selectors)
    node_selector: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ResourceClaim:
    """DRA ResourceClaim — ref resource.k8s.io ResourceClaim; allocation
    status is written by the binder (ref ``bindResourceClaims`` in the
    k8s-plugins binder plugin)."""

    name: str
    device_class: str = ""
    #: devices requested (ref exactCount)
    count: int = 1
    #: allocation status — set by the binder, cleared on rollback
    node: str | None = None
    devices: list[int] = dataclasses.field(default_factory=list)
    owner_pod: str | None = None
    #: claim labels — SHARED gpu claims must carry the pod's queue under
    #: ``kai.scheduler/queue`` (ref dynamicresources.go
    #: validateSharedGpuClaimQueueLabel)
    labels: dict = dataclasses.field(default_factory=dict)
    #: created from a ResourceClaimTemplate (per-pod): exempt from the
    #: shared-claim queue-label rule
    from_template: bool = True
    #: existing consumers in Status.ReservedFor — the scheduler may not
    #: admit pods past ``RESERVED_FOR_MAX`` total (ref
    #: dynamicresources.go preFilter)
    reserved_for: int = 0


#: resource.k8s.io ResourceClaimReservedForMaxSize — the consumer cap a
#: claim may never exceed (ref dynamicresources.go:149)
RESERVED_FOR_MAX = 256

#: queue label key shared claims must carry (ref common/constants
#: DefaultQueueLabel)
QUEUE_LABEL = "kai.scheduler/queue"


@dataclasses.dataclass
class Eviction:
    """A victim eviction decision emitted by reclaim/preempt/consolidation
    and stalegangeviction."""

    pod_name: str
    group: str
    reason: str = ""
    #: consolidation move target: the victim was verified to fit on this
    #: node and gets a pipelined rebind there.  None = plain eviction.
    move_to: str | None = None
