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


def sharing_reclaim_objects(apis, *, num_nodes: int, training: int,
                            fractions: int, memory: int,
                            training_nodes: float = 0.47,
                            pool_nodes: float = 0.02, urgent: int = 0,
                            node_accel: int = 8,
                            accel_memory_gib: float = 80.0, seed: int = 0):
    """A GPU-sharing fleet that the running pods hold, built with the object
    API: ``sharing_objects``' nodes and queues (two departments of two leaf
    queues, each leaf deserving a quarter of the devices).

    Running, in the first two leaves (alternating; over their fair share):
    on the first ``training_nodes`` of the nodes one gang of ``node_accel``
    whole-device pods (4 CPU, 16 GiB each, priority 1); on the last
    ``pool_nodes`` nothing — an inference pool, tainted
    ``dedicated=inference:NoSchedule``; on the others inference pods at
    priority 0 that tolerate the taint: two one-pod gangs at
    ``accel_portion=0.5`` (6 CPU, 24 GiB) on each of devices 0-2 and three
    one-pod gangs at ``accel_memory_gib=24`` (4 CPU, 18.5 GiB) on each of
    devices 3-4, which leaves 4 CPU and 1 GiB of the node and devices 5-7
    stranded.  About 80 % of the devices are held (at the default shares),
    and no pending pod fits idle anywhere.

    Pending, in the other two leaves, interleaved in creation order with
    priorities 0-2 drawn from ``seed``: ``training`` preemptible gangs of
    ``node_accel`` whole-device pods (4 CPU, 16 GiB); ``fractions``
    one-pod gangs at ``accel_portion=0.5`` and ``memory`` one-pod gangs at
    ``accel_memory_gib=24`` (1 CPU, 4 GiB), both non-preemptible (the
    inference class); then ``urgent`` one-pod 0.5-fraction gangs at
    priority 2 in the first two leaves, non-preemptible — the over-quota
    teams' own urgent work, which may not reclaim (their queues are over
    their fair share) but preempts their own priority-0 pods.
    Consolidation serves the training gangs (their inference victims move
    into the pool), reclaim the rest of the other leaves' backlog, preempt
    the urgent gangs.  Returns ``(nodes, queues, groups, pods)``."""
    rng = np.random.default_rng(seed)
    nodes, queues, _, _ = sharing_objects(
        apis, num_nodes=num_nodes, shared_nodes=0, training=0, fractions=0,
        memory=0, launchers=0, node_accel=node_accel,
        accel_memory_gib=accel_memory_gib)
    leaves = [q.name for q in queues if q.parent is not None]
    n_train = int(round(num_nodes * training_nodes))
    n_pool = max(1, int(round(num_nodes * pool_nodes)))
    for nd in nodes[num_nodes - n_pool:]:
        nd.taints = [apis.Taint(key="dedicated", value="inference")]
    tol = [apis.Toleration(key="dedicated", value="inference")]
    groups, pods = [], []
    k = 0

    def gang(name, queue, prio, specs, node):
        nonlocal k
        groups.append(apis.PodGroup(name, queue=queue, min_member=len(specs),
                                    priority=prio, creation_timestamp=float(k),
                                    last_start_timestamp=0.0))
        pods.extend(apis.Pod(f"{name}-{t}", name, creation_timestamp=float(k),
                             status=apis.PodStatus.RUNNING, node=node, **spec)
                    for t, spec in enumerate(specs))
        k += 1
    for i in range(num_nodes - n_pool):
        node = f"node-{i}"
        if i < n_train:
            gang(f"train-{i}", leaves[k % 2], 1, [
                dict(resources=apis.ResourceVec(1.0, 4.0, 16.0),
                     accel_devices=[d]) for d in range(node_accel)], node)
            continue
        for d in range(5):
            frac = d < 3
            for j in range(2 if frac else 3):
                spec = (dict(resources=apis.ResourceVec(0.0, 6.0, 24.0),
                             accel_portion=0.5) if frac else
                        dict(resources=apis.ResourceVec(0.0, 4.0, 18.5),
                             accel_memory_gib=24.0))
                gang(f"{'infer' if frac else 'embed'}-{i}-{d}-{j}",
                     leaves[k % 2], 0,
                     [dict(spec, accel_devices=[d], tolerations=tol)], node)
    counts = {"training": training, "fraction": fractions, "memory": memory}
    order = sorted(
        (((j + 0.5) / n, kd) for kd, n in counts.items() for j in range(n)))
    t0 = float(k)
    for g, (_, kind) in enumerate(order):
        name = f"want-{kind}-{g}"
        if kind == "training":
            specs = [dict(resources=apis.ResourceVec(1.0, 4.0, 16.0))] * \
                node_accel
        elif kind == "fraction":
            specs = [dict(resources=apis.ResourceVec(0.0, 1.0, 4.0),
                          accel_portion=0.5)]
        else:
            specs = [dict(resources=apis.ResourceVec(0.0, 1.0, 4.0),
                          accel_memory_gib=24.0)]
        groups.append(apis.PodGroup(
            name, queue=leaves[2 + g % 2], min_member=len(specs),
            priority=int(rng.integers(0, 3)), creation_timestamp=t0 + g,
            preemptibility=(apis.Preemptibility.PREEMPTIBLE
                            if kind == "training"
                            else apis.Preemptibility.NON_PREEMPTIBLE)))
        pods += [apis.Pod(f"{name}-{t}", name, creation_timestamp=t0 + g,
                          **spec) for t, spec in enumerate(specs)]
    t0 += len(order)
    for u in range(urgent):
        name = f"urgent-{u}"
        groups.append(apis.PodGroup(
            name, queue=leaves[u % 2], min_member=1, priority=2,
            creation_timestamp=t0 + u,
            preemptibility=apis.Preemptibility.NON_PREEMPTIBLE))
        pods.append(apis.Pod(f"{name}-0", name, creation_timestamp=t0 + u,
                             resources=apis.ResourceVec(0.0, 1.0, 4.0),
                             accel_portion=0.5))
    return nodes, queues, groups, pods


#: the H100 80GB MIG profiles of the mixed-strategy fleet (NVIDIA MIG User
#: Guide): key, slices a GPU, g-number
MIG_PROFILES = (("nvidia.com/mig-1g.10gb", 7, 1),
                ("nvidia.com/mig-2g.20gb", 3, 2),
                ("nvidia.com/mig-3g.40gb", 2, 3))


def mig_node_kind(i: int) -> int:
    """Node ``i``'s MIG layout under the device plugin's ``mixed``
    strategy: 0-2 (every GPU split into that profile of
    :data:`MIG_PROFILES`) or 3 (eight whole GPUs), in the proportion
    3 : 3 : 1 : 3."""
    return (0, 0, 0, 1, 1, 1, 2, 3, 3, 3)[i % 10]


def mig_reclaim_objects(apis, *, num_nodes: int, inference: int, pairs: int,
                        training: int, urgent: int = 0, stale: int = 0,
                        held: float = 0.8, pool_nodes: float = 0.02,
                        node_accel: int = 8, seed: int = 0,
                        now: float = 1000.0):
    """An H100 fleet partitioned with MIG beside whole-GPU training,
    built with the object API.  Nodes of ``node_accel`` GPUs (64 CPU,
    256 GiB) under the ``mixed`` MIG strategy (:func:`mig_node_kind`): 30 %
    split every GPU into 7 x ``mig-1g.10gb``, 30 % into 3 x ``mig-2g.20gb``,
    10 % into 2 x ``mig-3g.40gb`` (no whole GPU left: allocatable accel 0)
    and 30 % keep their GPUs whole.  Two departments of two leaf queues;
    each leaf's accel quota is a quarter of the fleet's g-number
    equivalents (whole GPUs plus each slice's g-number, the snapshot's
    queue accounting).  The last ``pool_nodes`` of the nodes are an
    inference pool, tainted ``dedicated=inference:NoSchedule`` and empty.

    Running, in the first two leaves (alternating; over their fair share),
    created kind by kind (the whole nodes', then the 1g, 2g and 3g nodes'):
    a gang of ``node_accel`` whole-GPU pods (priority 1) on ``held`` of
    the whole nodes; ``held`` of every other node's slices as one-pod
    inference gangs of one slice (priority 0, tolerating the pool's
    taint), whose CPU leaves one core of the node free — the free slices
    are stranded, except on every 256th node, whose pods take half the
    CPU.  The first ``stale`` 2g nodes' first gang declares a quorum of
    2 with its one pod left, stale since ``now - 120`` s.

    Pending, in the other two leaves, interleaved in creation order with
    priorities 0-2 drawn from ``seed``: ``inference`` non-preemptible
    one-slice gangs (1g : 2g : 3g = 4 : 2 : 1; 2 CPU, 8 GiB),
    ``pairs`` preemptible gangs of two 3g pods and ``training``
    preemptible gangs of ``node_accel`` whole GPUs (4 CPU, 16 GiB); then
    ``urgent`` non-preemptible one-slice 1g gangs at priority 2 in the
    first two leaves, which preempt their own priority-0 pods.  Returns
    ``(nodes, queues, groups, pods, now)``."""
    rng = np.random.default_rng(seed)
    n_pool = max(1, int(round(num_nodes * pool_nodes)))
    nodes, equiv = [], 0.0
    for i in range(num_nodes):
        kind = mig_node_kind(i)
        ext, accel = {}, float(node_accel)
        if kind < 3:
            key, per_gpu, g = MIG_PROFILES[kind]
            ext, accel = {key: float(per_gpu * node_accel)}, 0.0
            equiv += per_gpu * node_accel * g
        else:
            equiv += node_accel
        nodes.append(apis.Node(
            f"node-{i}", apis.ResourceVec(accel, 64.0, 256.0),
            labels={"kubernetes.io/hostname": f"node-{i}"},
            accel_memory_gib=80.0, extended=ext))
    for nd in nodes[num_nodes - n_pool:]:
        nd.taints = [apis.Taint(key="dedicated", value="inference")]
    quota = equiv / 4
    queues = [apis.Queue(f"dept-{d}",
                         accel=apis.QueueResource(quota=2 * quota),
                         creation_timestamp=float(d)) for d in range(2)]
    leaves = [f"queue-{d}-{j}" for d in range(2) for j in range(2)]
    queues += [apis.Queue(q, parent=f"dept-{k // 2}",
                          accel=apis.QueueResource(quota=quota),
                          creation_timestamp=float(k))
               for k, q in enumerate(leaves)]
    tol = [apis.Toleration(key="dedicated", value="inference")]
    groups, pods = [], []
    k = 0

    def gang(name, queue, prio, specs, node, **kw):
        nonlocal k
        groups.append(apis.PodGroup(name, queue=queue, priority=prio,
                                    creation_timestamp=float(k),
                                    last_start_timestamp=0.0,
                                    min_member=kw.pop("min_member",
                                                      len(specs)), **kw))
        pods.extend(apis.Pod(f"{name}-{t}", name, creation_timestamp=float(k),
                             status=apis.PodStatus.RUNNING, node=node, **spec)
                    for t, spec in enumerate(specs))
        k += 1
    n_stale = 0
    # created kind by kind — the training gangs, then the 1g, 2g and 3g
    # slices — so that the newest victims (the victim order's first) are
    # the largest slices
    run_order = sorted(range(num_nodes - n_pool),
                       key=lambda i: ((mig_node_kind(i) + 1) % 4, i))
    for i in run_order:
        node, kind = f"node-{i}", mig_node_kind(i)
        if kind == 3:
            if (i // 10) % 10 < round(held * 10):
                gang(f"train-{i}", leaves[k % 2], 1, [
                    dict(resources=apis.ResourceVec(1.0, 4.0, 16.0))
                    for _ in range(node_accel)], node)
            continue
        key, per_gpu, _ = MIG_PROFILES[kind]
        n_run = int(per_gpu * node_accel * held)
        cpu = (32.0 if i % 256 == 5 else 63.0) / n_run
        for j in range(n_run):
            spec = dict(resources=apis.ResourceVec(0.0, cpu, 4.0),
                        extended={key: 1.0}, tolerations=tol)
            kw = {}
            if kind == 1 and j == 0 and n_stale < stale:
                kw = dict(min_member=2, stale_since=now - 120.0)
                n_stale += 1
            gang(f"infer-{i}-{j}", leaves[k % 2], 0, [spec], node, **kw)
    counts = {"inference": inference, "pair": pairs, "training": training}
    order = sorted(
        (((j + 0.5) / n, kd) for kd, n in counts.items() for j in range(n)))
    t0 = float(k)
    slice_kind = (0, 0, 0, 0, 1, 1, 2)
    for g, (_, kind) in enumerate(order):
        name = f"want-{kind}-{g}"
        if kind == "inference":
            key = MIG_PROFILES[slice_kind[g % 7]][0]
            specs = [dict(resources=apis.ResourceVec(0.0, 2.0, 8.0),
                          extended={key: 1.0})]
        elif kind == "pair":
            specs = [dict(resources=apis.ResourceVec(0.0, 2.0, 8.0),
                          extended={MIG_PROFILES[2][0]: 1.0})] * 2
        else:
            specs = [dict(resources=apis.ResourceVec(1.0, 4.0, 16.0))] * \
                node_accel
        groups.append(apis.PodGroup(
            name, queue=leaves[2 + g % 2], min_member=len(specs),
            priority=int(rng.integers(0, 3)), creation_timestamp=t0 + g,
            preemptibility=(apis.Preemptibility.NON_PREEMPTIBLE
                            if kind == "inference"
                            else apis.Preemptibility.PREEMPTIBLE)))
        pods += [apis.Pod(f"{name}-{t}", name, creation_timestamp=t0 + g,
                          **spec) for t, spec in enumerate(specs)]
    t0 += len(order)
    for u in range(urgent):
        name = f"urgent-{u}"
        groups.append(apis.PodGroup(
            name, queue=leaves[u % 2], min_member=1, priority=2,
            creation_timestamp=t0 + u,
            preemptibility=apis.Preemptibility.NON_PREEMPTIBLE))
        pods.append(apis.Pod(f"{name}-0", name, creation_timestamp=t0 + u,
                             resources=apis.ResourceVec(0.0, 2.0, 8.0),
                             extended={MIG_PROFILES[0][0]: 1.0}))
    return nodes, queues, groups, pods, now


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


def repack_objects(apis, *, num_nodes: int = 5_120, rack_size: int = 8,
                   node_accel: int = 8, running_per_node: int = 7,
                   gangs: int = 4, gang_size: int = 32,
                   rack_label: str = "topo/rack"):
    """A near-full GPU cluster whose free devices are scattered one per
    node, built with the object API (after the reference's repack
    acceptance scenario, ``tests/test_repack.py``, at a cluster's size):
    ``num_nodes`` nodes of ``node_accel`` devices (64 CPU, 256 GiB) in
    racks of ``rack_size`` nodes (topology levels ``[rack_label,
    kubernetes.io/hostname]``); every node runs ``running_per_node``
    one-device preemptible one-pod gangs in queue ``serve`` (quota equal
    to its usage, started at t=0), created node by node; ``gangs`` pending
    gangs of ``gang_size`` one-device pods in queue ``train`` (quota
    ``gangs * gang_size``), each required to fit one rack.  With the
    defaults every rack holds 8 free devices: gangs of 16 or more are
    cluster-feasible but rack-stranded.  Returns ``(nodes, queues, groups,
    pods, topology)``."""
    topo = apis.Topology(name="default",
                         levels=[rack_label, "kubernetes.io/hostname"])
    nodes, groups, pods = [], [], []
    for i in range(num_nodes):
        name = f"node-{i}"
        nodes.append(apis.Node(
            name, apis.ResourceVec(float(node_accel), 64.0, 256.0),
            labels={rack_label: f"rack-{i // rack_size}",
                    "kubernetes.io/hostname": name}))
    used = float(num_nodes * running_per_node)
    queues = [apis.Queue("serve", accel=apis.QueueResource(quota=used)),
              apis.Queue("train", accel=apis.QueueResource(
                  quota=float(gangs * gang_size)))]
    for i in range(num_nodes):
        for j in range(running_per_node):
            g = apis.PodGroup(f"serve-{i}-{j}", queue="serve", min_member=1,
                              preemptibility=apis.Preemptibility.PREEMPTIBLE,
                              last_start_timestamp=0.0)
            groups.append(g)
            pods.append(apis.Pod(f"{g.name}-0", g.name,
                                 apis.ResourceVec(1.0, 1.0, 4.0),
                                 status=apis.PodStatus.RUNNING,
                                 node=f"node-{i}"))
    for k in range(gangs):
        g = apis.PodGroup(
            f"big-{k}", queue="train", min_member=gang_size,
            creation_timestamp=float(k),
            topology_constraint=apis.TopologyConstraint(
                topology="default", required_level=rack_label))
        groups.append(g)
        for t in range(gang_size):
            pods.append(apis.Pod(f"big-{k}-{t}", g.name,
                                 apis.ResourceVec(1.0, 1.0, 4.0),
                                 creation_timestamp=float(k)))
    return nodes, queues, groups, pods, topo


def steady_objects(apis, make_cluster, *, num_nodes: int,
                   num_gangs: int, tasks_per_gang: int,
                   node_accel: float = 8.0, running_fraction: float = 0.5,
                   seed: int = 0):
    """A steadily busy cluster: ``make_cluster``'s fleet with a share of
    the gangs running, each running pod holding its own accelerator on its
    node (as the binder would have recorded it), so churned rebinds stay
    on the incremental snapshotter's patch path.  Returns ``(nodes,
    queues, groups, pods, topology)``."""
    nodes, queues, groups, pods, topo = make_cluster(
        num_nodes=num_nodes, node_accel=node_accel, num_gangs=num_gangs,
        tasks_per_gang=tasks_per_gang, running_fraction=running_fraction,
        seed=seed)
    cursor: dict = {}
    for p in pods:
        if p.status == apis.PodStatus.RUNNING:
            c = cursor.get(p.node, 0)
            p.accel_devices = [c]
            cursor[p.node] = c + 1
    return nodes, queues, groups, pods, topo


def churn_cluster(apis, cluster, rng, frac: float, num_nodes: int = 10_000,
                  restart: bool = False) -> None:
    """One cycle of steady churn through the mutation paths the cluster
    hub journals: evict ``frac / 2`` of the pods from the running ones
    (``restart=True``: their controller recreates them pending), bind as
    many pending pods to uniformly random nodes (``rng``; a pod that fits
    none of the node's devices stays pending), and tick."""
    k = max(1, int(len(cluster.pods) * frac / 2))
    running = [p.name for p in cluster.pods.values()
               if p.status == apis.PodStatus.RUNNING][:k]
    for nm in running:
        cluster.evict_pod(nm, restart=restart)
    pending = [p for p in cluster.pods.values()
               if p.status == apis.PodStatus.PENDING][:k]
    for p in pending:
        try:
            cluster.bind_pod(p.name, f"node-{rng.integers(0, num_nodes)}")
        except RuntimeError:
            pass  # the node's devices are taken: the pod stays pending
    cluster.tick()
