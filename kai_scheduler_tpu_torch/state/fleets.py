"""Synthetic fleets built with the object API: the shapes of the
card-smoke cells (``chip_smoke.py``) and of the tests that hold them.

Each builder takes the object-API module (``apis``) it builds with, so a
parity test can build the same fleet for the JAX reference and for the
port; it imports nothing of either package itself.
"""
from __future__ import annotations

import numpy as np


def fragmented_objects(apis, *, num_nodes: int, pending: int, stale: int,
                       node_accel: float = 8.0, victim_accel: float = 2.0,
                       pending_accel: float = 6.0, now: float = 1000.0):
    """A fragmented full cluster, built with the object API: every node
    runs two preemptible one-pod gangs of ``victim_accel``, created node
    by node (so newest-first victim ranks free one node at a time);
    ``pending`` one-pod gangs of ``pending_accel`` fit no node idle but fit
    the cluster's spare capacity; the first gang on each of the first
    ``stale`` nodes declares a quorum of 2 with one pod left, stale since
    ``now - 120`` s (past the 60 s grace).  One department and one leaf
    queue, every quota unlimited.  Returns ``(nodes, queues, groups, pods,
    now)``."""
    unl = apis.QueueResource(quota=-1.0)
    queues = [apis.Queue("dept", accel=unl),
              apis.Queue("q0", parent="dept", accel=unl)]
    nodes, groups, pods = [], [], []
    for i in range(num_nodes):
        node = f"node-{i}"
        nodes.append(apis.Node(node, apis.ResourceVec(node_accel, 64.0,
                                                      256.0),
                               labels={"kubernetes.io/hostname": node}))
        for j in range(2):
            name = f"run-{i}-{j}"
            is_stale = j == 0 and i < stale
            groups.append(apis.PodGroup(
                name, queue="q0", min_member=2 if is_stale else 1,
                creation_timestamp=float(2 * i + j),
                last_start_timestamp=float(2 * i + j),
                stale_since=now - 120.0 if is_stale else None))
            pods.append(apis.Pod(
                f"{name}-0", name,
                resources=apis.ResourceVec(victim_accel, 1.0, 4.0),
                status=apis.PodStatus.RUNNING, node=node,
                creation_timestamp=float(2 * i + j)))
    for k in range(pending):
        name = f"want-{k}"
        groups.append(apis.PodGroup(name, queue="q0", min_member=1,
                                    creation_timestamp=now + k))
        pods.append(apis.Pod(f"{name}-0", name,
                             resources=apis.ResourceVec(pending_accel, 1.0,
                                                        4.0),
                             creation_timestamp=now + k))
    return nodes, queues, groups, pods, now


def sharing_objects(apis, *, num_nodes: int, shared_nodes: int,
                    training: int, fractions: int, memory: int,
                    launchers: int, node_accel: int = 8,
                    accel_memory_gib: float = 80.0, seed: int = 0):
    """A GPU-sharing fleet, built with the object API: ``num_nodes`` nodes
    of ``node_accel`` devices (64 CPU, 256 GiB, ``accel_memory_gib`` per
    device); two departments of two leaf queues with ``make_cluster``'s
    quota rule (each leaf deserves a quarter of the devices); one running
    pod at ``accel_portion=0.5`` on device 0 of each of the first
    ``shared_nodes`` nodes; pending, round-robin over the four leaves with
    priorities 0-2 drawn from ``seed``: ``training`` gangs of 8
    whole-device pods, ``fractions`` one-pod gangs at
    ``accel_portion=0.5``, ``memory`` one-pod gangs at
    ``accel_memory_gib=24`` and ``launchers`` gangs of one launcher pod
    (no device, 4 CPU, 16 GiB) plus 5 one-device workers, interleaved in
    that proportion.  Returns ``(nodes, queues, groups, pods)``."""
    rng = np.random.default_rng(seed)
    nodes = [apis.Node(f"node-{i}", apis.ResourceVec(float(node_accel), 64.0,
                                                     256.0),
                       labels={"kubernetes.io/hostname": f"node-{i}"},
                       accel_memory_gib=accel_memory_gib)
             for i in range(num_nodes)]
    quota = num_nodes * node_accel / 4
    queues = []
    for d in range(2):
        queues.append(apis.Queue(f"dept-{d}",
                                 accel=apis.QueueResource(quota=2 * quota),
                                 creation_timestamp=float(d)))
    leaves = [f"queue-{d}-{j}" for d in range(2) for j in range(2)]
    for k, name in enumerate(leaves):
        queues.append(apis.Queue(name, parent=f"dept-{k // 2}",
                                 accel=apis.QueueResource(quota=quota),
                                 creation_timestamp=float(k)))
    groups, pods = [], []
    for i in range(shared_nodes):
        name = f"shared-{i}"
        groups.append(apis.PodGroup(name, queue=leaves[i % 4], min_member=1,
                                    last_start_timestamp=0.0))
        pods.append(apis.Pod(f"{name}-0", name,
                             resources=apis.ResourceVec(0.0, 1.0, 4.0),
                             accel_portion=0.5,
                             status=apis.PodStatus.RUNNING,
                             node=f"node-{i}", accel_devices=[0]))
    kinds = (["training"] * training + ["fraction"] * fractions
             + ["memory"] * memory + ["launcher"] * launchers)
    # interleave the kinds evenly over the creation order
    total = len(kinds)
    counts = {"training": training, "fraction": fractions,
              "memory": memory, "launcher": launchers}
    order = sorted(
        (((j + 0.5) / n, k) for k, n in counts.items() for j in range(n)))
    for g, (_, kind) in enumerate(order[:total]):
        name = f"{kind}-{g}"
        queue = leaves[g % 4]
        prio = int(rng.integers(0, 3))
        if kind == "training":
            specs = [dict(resources=apis.ResourceVec(1.0, 4.0, 16.0))] * 8
        elif kind == "fraction":
            specs = [dict(resources=apis.ResourceVec(0.0, 1.0, 4.0),
                          accel_portion=0.5)]
        elif kind == "memory":
            specs = [dict(resources=apis.ResourceVec(0.0, 1.0, 4.0),
                          accel_memory_gib=24.0)]
        else:
            specs = ([dict(resources=apis.ResourceVec(0.0, 4.0, 16.0))]
                     + [dict(resources=apis.ResourceVec(1.0, 4.0, 16.0))] * 5)
        groups.append(apis.PodGroup(name, queue=queue, min_member=len(specs),
                                    priority=prio,
                                    creation_timestamp=float(g)))
        pods += [apis.Pod(f"{name}-{t}", name, creation_timestamp=float(g),
                          **spec) for t, spec in enumerate(specs)]
    return nodes, queues, groups, pods


def topology_subgroup_objects(apis, make_cluster, *, num_nodes: int,
                              levels: tuple, gangs: int, seed: int = 0):
    """A topology fleet with mixed and multi-subgroup gangs, built with
    ``make_cluster``'s tree (``levels`` blocks x racks, 8 accelerators a
    node, four leaf queues) and the object API: a running one-pod gang of
    5 accelerators on every other node of the first half of the blocks,
    so the racks differ in fill; ``gangs`` pending gangs alternating
    between (a) two 4-accelerator pods and six 2-accelerator pods,
    required at ``topo/level1`` (the mixed shape of the in-cycle retry
    tests), and (b) two subgroups, each required at ``topo/level1`` —
    "prefill", 4 pods of 2 accelerators, and "decode", 4 pods of 1 — the
    gang preferred at ``topo/level0``.  Priorities 0-2 drawn from
    ``seed``.  Returns ``(nodes, queues, groups, pods, topology)``."""
    rng = np.random.default_rng(seed)
    nodes, queues, _, _, topo = make_cluster(
        num_nodes=num_nodes, node_accel=8.0, num_gangs=0,
        topology_levels=levels)
    leaves = [q.name for q in queues if q.parent is not None]
    block_span = max(1, num_nodes // levels[0])
    groups, pods = [], []
    for i in range(0, num_nodes, 2):
        if i // block_span >= levels[0] // 2:
            break
        name = f"busy-{i}"
        groups.append(apis.PodGroup(name, queue=leaves[i % len(leaves)],
                                    min_member=1, last_start_timestamp=0.0))
        pods.append(apis.Pod(f"{name}-0", name,
                             resources=apis.ResourceVec(5.0, 4.0, 16.0),
                             status=apis.PodStatus.RUNNING,
                             node=nodes[i].name))
    rack = apis.TopologyConstraint(topology="default",
                                   required_level="topo/level1")
    for g in range(gangs):
        name = f"topo-{g}"
        kw = dict(queue=leaves[g % len(leaves)],
                  priority=int(rng.integers(0, 3)),
                  creation_timestamp=float(g))
        if g % 2 == 0:
            specs = ([dict(resources=apis.ResourceVec(4.0, 4.0, 16.0))] * 2
                     + [dict(resources=apis.ResourceVec(2.0, 2.0, 8.0))] * 6)
            groups.append(apis.PodGroup(name, min_member=8,
                                        topology_constraint=rack, **kw))
        else:
            specs = ([dict(resources=apis.ResourceVec(2.0, 2.0, 8.0),
                           subgroup="prefill")] * 4
                     + [dict(resources=apis.ResourceVec(1.0, 2.0, 8.0),
                             subgroup="decode")] * 4)
            groups.append(apis.PodGroup(
                name, min_member=8, sub_groups=[
                    apis.SubGroup("prefill", min_member=4,
                                  topology_constraint=rack),
                    apis.SubGroup("decode", min_member=4,
                                  topology_constraint=rack)],
                topology_constraint=apis.TopologyConstraint(
                    topology="default", preferred_level="topo/level0"),
                **kw))
        pods += [apis.Pod(f"{name}-{t}", name, creation_timestamp=float(g),
                          **spec) for t, spec in enumerate(specs)]
    return nodes, queues, groups, pods, topo


def _anti_self_term(apis, key: str, value: str):
    """A required hostname anti-affinity term against ``key=value``."""
    return apis.PodAffinityTerm(match_labels=((key, value),), anti=True,
                                required=True)


def affinity_objects(apis, make_cluster, *, num_nodes: int,
                     node_accel: float, num_gangs: int, tasks_per_gang: int,
                     services: int = 64, anchors: int = 256,
                     dependers: int = 256, depender_tasks: int = 4,
                     port_gangs: int = 512, port: int = 8443):
    """An allocate backlog with in-cycle affinity terms, built with
    ``make_cluster`` and the object API: ``make_cluster``'s empty cluster
    and ``num_gangs`` gangs of ``tasks_per_gang`` replicas, gang i's pods
    labelled ``app=svc-{i % services}`` with a required hostname
    anti-affinity term against their own ``app`` (a service's replicas one
    per host, across its gangs); then ``anchors`` one-pod gangs labelled
    ``cache=c{k}``, ``dependers`` gangs of ``depender_tasks`` pods with a
    required hostname affinity to ``cache=c{k % anchors}``, and
    ``port_gangs`` one-pod gangs sharing host port ``port``, every pod of
    one accelerator, round-robin over the leaf queues.  Returns ``(nodes,
    queues, groups, pods, topology)``."""
    nodes, queues, groups, pods, topo = make_cluster(
        num_nodes=num_nodes, node_accel=node_accel, num_gangs=num_gangs,
        tasks_per_gang=tasks_per_gang)
    index = {g.name: i for i, g in enumerate(groups)}
    for p in pods:
        app = f"svc-{index[p.group] % services}"
        p.labels = dict(p.labels, app=app)
        p.pod_affinity = [_anti_self_term(apis, "app", app)]
    leaves = [q.name for q in queues if q.parent is not None]
    t0 = float(num_gangs)

    def gang(name: str, n_pods: int, **pod_kw):
        k = len(groups)
        groups.append(apis.PodGroup(name, queue=leaves[k % len(leaves)],
                                    min_member=n_pods,
                                    creation_timestamp=t0 + k))
        pods.extend(apis.Pod(f"{name}-{t}", name,
                             resources=apis.ResourceVec(1.0, 1.0, 4.0),
                             creation_timestamp=t0 + k, **pod_kw)
                    for t in range(n_pods))
    for k in range(anchors):
        gang(f"cache-{k}", 1, labels={"cache": f"c{k}"})
    for k in range(dependers):
        need = apis.PodAffinityTerm(match_labels=(("cache",
                                                   f"c{k % anchors}"),))
        gang(f"reader-{k}", depender_tasks, pod_affinity=[need])
    for k in range(port_gangs):
        gang(f"port-{k}", 1, host_ports=[port])
    return nodes, queues, groups, pods, topo


def affinity_reclaim_objects(apis, make_cluster, *, services: int = 64,
                             **shape):
    """``make_cluster(**shape)`` (a saturated shape: running pods fill the
    nodes, pending gangs wait in other queues) with the pending gangs' pods
    labelled ``app=ha-{i % services}`` (``i`` counting the pending gangs)
    and carrying a required hostname anti-affinity term against their own
    ``app``; the running pods carry neither.  Returns ``(nodes, queues,
    groups, pods, topology)``."""
    nodes, queues, groups, pods, topo = make_cluster(**shape)
    pending = {}
    for g in groups:
        if g.last_start_timestamp is None:
            pending[g.name] = len(pending)
    for p in pods:
        if p.group in pending:
            app = f"ha-{pending[p.group] % services}"
            p.labels = dict(p.labels, app=app)
            p.pod_affinity = [_anti_self_term(apis, "app", app)]
    return nodes, queues, groups, pods, topo


def affinity_sharing_objects(apis, *, num_nodes: int, shared_nodes: int,
                             fractions: int, services: int, port_gangs: int,
                             port: int = 8443, seed: int = 0):
    """:func:`sharing_objects`' nodes, queues and running fractions, with a
    pending backlog of ``fractions`` one-pod 0.5-fraction gangs in
    ``services`` services (``app=frac-{k % services}``, each with a
    required hostname anti-affinity term against its own ``app``) and
    ``port_gangs`` one-pod whole-device gangs sharing host port ``port``,
    interleaved, round-robin over the four leaves with priorities 0-2
    drawn from ``seed``.  Returns ``(nodes, queues, groups, pods)``."""
    rng = np.random.default_rng(seed)
    nodes, queues, groups, pods = sharing_objects(
        apis, num_nodes=num_nodes, shared_nodes=shared_nodes, training=0,
        fractions=0, memory=0, launchers=0)
    leaves = [q.name for q in queues if q.parent is not None]
    every = max(1, (fractions + port_gangs) // max(1, port_gangs))
    k_frac = k_port = 0
    for g in range(fractions + port_gangs):
        is_port = k_port < port_gangs and (g % every == every - 1
                                           or k_frac >= fractions)
        kw = dict(queue=leaves[g % len(leaves)],
                  priority=int(rng.integers(0, 3)),
                  creation_timestamp=float(g))
        if is_port:
            name = f"port-{k_port}"
            k_port += 1
            spec = dict(resources=apis.ResourceVec(1.0, 1.0, 4.0),
                        host_ports=[port])
        else:
            app = f"frac-{k_frac % services}"
            name = f"frac-{k_frac}"
            k_frac += 1
            spec = dict(resources=apis.ResourceVec(0.0, 1.0, 4.0),
                        accel_portion=0.5, labels={"app": app},
                        pod_affinity=[_anti_self_term(apis, "app", app)])
        groups.append(apis.PodGroup(name, min_member=1, **kw))
        pods.append(apis.Pod(f"{name}-0", name, creation_timestamp=float(g),
                             **spec))
    return nodes, queues, groups, pods
