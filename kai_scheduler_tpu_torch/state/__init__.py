from .cluster_state import (  # noqa: F401
    ClusterState,
    GangState,
    NodeState,
    QueueState,
    RunningState,
    SnapshotCapacity,
    SnapshotIndex,
    build_snapshot,
    build_snapshot_host,
    leaf_paths,
    state_from_numpy,
    state_to_numpy,
)
from .synthetic import make_cluster  # noqa: F401
