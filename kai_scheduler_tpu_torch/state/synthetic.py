"""Synthetic cluster generators — the test & benchmark harness.

Mirrors the role of the reference's fake-cluster builders
(``pkg/scheduler/test_utils/test_utils.go:40-70`` TestTopologyBasic with
``jobs_fake/``, ``nodes_fake/``; and the benchmark sizes in
``pkg/scheduler/actions/benchmark_test.go:30-121``), plus the five
benchmark configs from ``BASELINE.json``.

A verbatim copy of the reference module of the same name in
``kai_scheduler_tpu.state``, kept in the PyTorch port so that the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

from ..apis import types as apis


def make_cluster(
    *,
    num_nodes: int = 16,
    node_accel: float = 8.0,
    node_cpu: float = 64.0,
    node_mem: float = 256.0,
    num_departments: int = 2,
    queues_per_department: int = 2,
    queue_accel_quota: float | None = None,
    num_gangs: int = 8,
    tasks_per_gang: int = 2,
    task_accel: float = 1.0,
    task_cpu: float = 1.0,
    task_mem: float = 4.0,
    running_fraction: float = 0.0,
    #: running gangs take the first half of the leaf queues, pending the
    #: second half — creates over-quota victims vs under-share
    #: reclaimers (the reclaim benchmark shape)
    partition_queues_by_running: bool = False,
    priority_spread: int = 1,
    #: added to every PENDING gang's priority — makes each pending gang
    #: outrank the running gangs of its own queue (the many-queue
    #: preempt shape)
    pending_priority_boost: int = 0,
    topology_levels: tuple[int, ...] = (),
    required_level: str | None = None,
    seed: int = 0,
) -> tuple[list[apis.Node], list[apis.Queue], list[apis.PodGroup], list[apis.Pod], apis.Topology | None]:
    """Build a synthetic cluster.

    ``topology_levels``: sizes of physical domains outermost-first, e.g.
    ``(4, 8)`` = 4 blocks x 8 racks each; hostname level appended
    automatically.  ``running_fraction`` of gangs start as running
    (round-robin over nodes) — victims for reclaim/preempt tests.
    """
    rng = np.random.default_rng(seed)

    topology = None
    level_keys: list[str] = []
    if topology_levels:
        level_keys = [f"topo/level{i}" for i in range(len(topology_levels))]
        topology = apis.Topology(
            name="default", levels=level_keys + ["kubernetes.io/hostname"])

    nodes = []
    for i in range(num_nodes):
        labels = {"kubernetes.io/hostname": f"node-{i}"}
        if topology_levels:
            # nest nodes into the domain tree by index arithmetic
            span = num_nodes
            idx = i
            for key, size in zip(level_keys, topology_levels):
                span = max(1, span // size)
                labels[key] = f"{key.split('/')[-1]}-{idx // span}"
                idx = idx % span
        nodes.append(apis.Node(
            name=f"node-{i}",
            allocatable=apis.ResourceVec(node_accel, node_cpu, node_mem),
            labels=labels,
        ))

    total_accel = num_nodes * node_accel
    num_queues = num_departments * queues_per_department
    if queue_accel_quota is None:
        queue_accel_quota = total_accel / max(1, num_queues)
    queues = []
    for d in range(num_departments):
        queues.append(apis.Queue(
            name=f"dept-{d}",
            accel=apis.QueueResource(quota=queue_accel_quota * queues_per_department),
            creation_timestamp=float(d),
        ))
    for d in range(num_departments):
        for j in range(queues_per_department):
            queues.append(apis.Queue(
                name=f"queue-{d}-{j}",
                parent=f"dept-{d}",
                accel=apis.QueueResource(quota=queue_accel_quota),
                creation_timestamp=float(d * queues_per_department + j),
            ))
    leaf_queues = [q.name for q in queues if q.parent is not None]

    pod_groups: list[apis.PodGroup] = []
    pods: list[apis.Pod] = []
    num_running = int(num_gangs * running_fraction)
    node_cursor = 0
    for g in range(num_gangs):
        running = g < num_running
        if partition_queues_by_running and len(leaf_queues) >= 2:
            half = len(leaf_queues) // 2
            pool = leaf_queues[:half] if running else leaf_queues[half:]
            queue = pool[g % len(pool)]
        else:
            queue = leaf_queues[g % len(leaf_queues)]
        pg = apis.PodGroup(
            name=f"gang-{g}",
            queue=queue,
            min_member=tasks_per_gang,
            priority=int(rng.integers(0, priority_spread))
            + (0 if running else pending_priority_boost),
            creation_timestamp=float(g),
            last_start_timestamp=0.0 if running else None,
            topology_constraint=(
                apis.TopologyConstraint(topology="default",
                                        required_level=required_level)
                if required_level else None),
        )
        pod_groups.append(pg)
        for t in range(tasks_per_gang):
            pod = apis.Pod(
                name=f"gang-{g}-pod-{t}",
                group=pg.name,
                resources=apis.ResourceVec(task_accel, task_cpu, task_mem),
                creation_timestamp=float(g),
            )
            if running:
                pod.status = apis.PodStatus.RUNNING
                pod.node = nodes[node_cursor % num_nodes].name
                node_cursor += 1
            pods.append(pod)
    return nodes, queues, pod_groups, pods, topology
