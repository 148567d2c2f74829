"""Seeded edge inputs of K8 (``ops.victims.freed_by_lane``), K7
(``ops.victims.replace_victims``), K5 (``utils.numerics.cumsum_ds``) and
K12 (``ops.allocate.affinity_mask``): the shapes the card kernels' node
tiles, column slabs, lane prefix, thread-block clusters, row tiles and
node vectors must survive, as numpy leaves of a small snapshot
(``state_from_numpy`` turns them into a ``ClusterState`` on any device)
or as plain numpy arrays.

Shared by the CPU parity tests (each case through the reference's
``_freed_by_lane`` / ``_replace_victims`` and the port's plain versions),
the card tests and ``chip_smoke.py`` (each case through the kernel and its
plain version), so that all three hold the same inputs.  Imports nothing
of JAX.

- :func:`k8_case` — ``EDGE_NODES`` nodes (no multiple of a tile) with 32
  devices each and 8 extended keys; fractional requests; fractional shares
  on every device and whole-device masks over all 32 bits (bit 31 held);
  node 0 holding ``PADDING_ROWS`` rows of node -1 (the snapshotter's
  padding, filed under node 0), one of them live; empty nodes; a leaf
  queue whose pods are all outside the lanes; pods of queue -1; B lanes
  (``K8_LANES``: one, past a block of 16, 256, and 300 — two levels of
  block totals).
- :func:`k7_case` — one consolidation re-placement per case of
  ``K7_CASES`` on ``EDGE_NODES`` nodes: tied scores, a victim that fits
  nowhere, more victims than ``max_pods``, two victims on one node,
  fractional and memory-based shares tied between devices, whole-device
  pods taking the first free devices, extended keys, and a mix with
  invalid nodes, filter classes and releasing capacity.
- :func:`k5_case` — a ``[U, C]`` (or ``[U, Q, R]``) f32 table per case of
  ``K5_CASES``: U of 1, 2, 3 and around K5's 256-row tile (255, 256, 257,
  513: a last tile of one row), around its 256-tile chunk of roots (65,535
  to 65,793) and 216,001 rows (the MIG fleet's running pods); C of 1, 3,
  5, 11 (no multiple of K5's 8-column group) and 24; values 1e-3 to 1e9
  of both signs with +0.0 and -0.0.
- :func:`k12_case` — K12's inputs per case of ``K12_CASES``: 37 nodes (no
  multiple of K12's 4- or 16-node vectors), 48 and 100; a two-level
  topology with nodes lacking a level's label and invalid nodes; term rows
  at each topology level and at the per-node level; gangs with no used
  slot, every slot used, -1 slots in the middle of a list, and need rows
  claimed statically; junk lanes at gang G and lane -1; ``attract`` on and
  off; lane counts on both sides of K12's 4/16-node switch.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

#: nodes of every edge case: not a multiple of K8's node tile or of K7's
#: cluster slice
EDGE_NODES = 37
#: devices a node (K8's device table takes 32; the snapshot builds 8)
EDGE_DEVICES = 32
#: extended keys (the card kernels take 8)
EDGE_EXTENDED = 8
#: rows of node -1 (filed under node 0 by ``PodIndex``)
PADDING_ROWS = 260
#: queue levels of the edge snapshot (two departments of three leaves)
NUM_LEVELS = 2
K8_LANES = (1, 17, 256, 300)
K8_MODES = ("plain", "devices", "extended")
K7_CASES = ("ties", "nofit", "overflow", "fractional", "memory", "whole",
            "extended", "mixed")


@functools.lru_cache(maxsize=None)
def _base() -> dict:
    """The port's snapshot of a small running cluster (6 leaf queues, 384
    running rows padded), as leaves, cut to ``EDGE_NODES`` nodes with
    ``EDGE_DEVICES`` devices and ``EDGE_EXTENDED`` extended keys."""
    from kai_scheduler_tpu_torch.framework.session import Session
    from kai_scheduler_tpu_torch.state import make_cluster, state_to_numpy
    ses = Session.open(*make_cluster(
        num_nodes=40, node_accel=8.0, num_gangs=120, tasks_per_gang=4,
        running_fraction=0.8, num_departments=2, queues_per_department=3,
        seed=0), device="cpu")
    lv = state_to_numpy(ses.state)
    N, D, E = EDGE_NODES, EDGE_DEVICES, EDGE_EXTENDED
    for k, v in list(lv.items()):
        if k.startswith("nodes.") and k not in ("nodes.filter_masks",
                                                "nodes.soft_scores"):
            lv[k] = v[:N]
    for k in ("nodes.filter_masks", "nodes.soft_scores"):
        lv[k] = lv[k][:, :N]
    for k in ("nodes.device_free", "nodes.device_releasing"):
        lv[k] = np.pad(lv[k], ((0, 0), (0, D - lv[k].shape[1])))
    for k in ("nodes.extended_free", "nodes.extended_releasing"):
        lv[k] = np.zeros((N, E), np.float32)
    M = lv["running.req"].shape[0]
    lv["running.extended"] = np.zeros((M, E), np.float32)
    return lv


def _leaves() -> dict:
    return {k: v.copy() for k, v in _base().items()}


def _leaf_queues(lv: dict) -> np.ndarray:
    """The queues no other queue names as parent."""
    parent = lv["queues.parent"]
    valid = lv["queues.valid"]
    q = np.arange(parent.shape[0])
    return q[valid & ~np.isin(q, parent[valid])]


def k8_case(B: int, seed: int = 0):
    """``(leaves, lane i32 [M])`` for a K8 call at ``B`` lanes (see the
    module docstring)."""
    lv = _leaves()
    rng = np.random.default_rng(seed + B)
    M = lv["running.req"].shape[0]
    N, D, E = EDGE_NODES, EDGE_DEVICES, EDGE_EXTENDED
    # rows 0 .. PADDING_ROWS - 1 on node -1; the rest on nodes 1 .. N - 6
    # (the last five nodes empty), a few more on node 0
    node = np.where(np.arange(M) < PADDING_ROWS, -1,
                    rng.integers(1, N - 5, M)).astype(np.int32)
    node[PADDING_ROWS:PADDING_ROWS + 6] = 0
    lv["running.node"] = node
    leaves = _leaf_queues(lv)
    queue = rng.choice(leaves, M).astype(np.int32)
    queue[rng.random(M) < 0.05] = -1
    queue[PADDING_ROWS // 2] = leaves[1]   # the live padding row's queue
    lv["running.queue"] = queue
    req = np.stack([rng.choice(np.float32([0.5, 1.0, 2.0, 0.25]), M),
                    rng.uniform(0.1, 3.0, M),
                    rng.uniform(1, 10, M) * 10 ** rng.uniform(0, 6, M)],
                   1).astype(np.float32)
    lv["running.req"] = req
    frac = rng.random(M) < 0.4
    lv["running.device"] = np.where(frac, rng.integers(0, D, M),
                                    -1).astype(np.int32)
    lv["running.accel_held"] = np.where(frac, rng.choice(np.float32(
        [0.5, 0.3, 0.05, 0.7]), M), 0.0).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, M, dtype=np.uint64)
    bits[~frac & (np.arange(M) % 7 == 0)] |= np.uint64(1 << 31)
    lv["running.devices_mask"] = np.where(frac, 0, bits.astype(
        np.uint32).view(np.int32)).astype(np.int32)
    lv["running.extended"] = rng.choice(np.float32(
        [0.0, 0.0, 1.0, 0.5, 3.0]), (M, E))
    lane = np.where(rng.random(M) < 0.6, rng.integers(0, B, M), B)
    lane[:PADDING_ROWS] = B
    lane[PADDING_ROWS // 2] = rng.integers(0, B)   # one live padding row
    lane[queue == leaves[0]] = B                   # a leaf with no live pod
    return lv, lane.astype(np.int32)


def k7_case(case: str):
    """``(leaves, mask bool [M], free [N, R], device_free [N, D],
    releasing [N, R], device_releasing [N, D], ext_free [N, E],
    ext_releasing [N, E], max_pods)`` for a K7 call (see the module
    docstring)."""
    lv = _leaves()
    rng = np.random.default_rng(K7_CASES.index(case))
    M = lv["running.req"].shape[0]
    N, E = EDGE_NODES, EDGE_EXTENDED
    D = EDGE_DEVICES if case in ("whole", "mixed") else 8
    for k in ("nodes.device_free", "nodes.device_releasing"):
        lv[k] = lv[k][:, :D]
    f32 = np.float32
    free = np.tile(f32([8.0, 64.0, 512.0]), (N, 1))
    rel = np.zeros((N, 3), f32)
    dev = np.ones((N, D), f32)
    dev_rel = np.zeros((N, D), f32)
    ext = np.zeros((N, E), f32)
    ext_rel = np.zeros((N, E), f32)
    lv["nodes.valid"] = np.ones(N, bool)
    lv["nodes.device_memory_gib"] = np.full(N, 80.0, f32)
    lv["nodes.filter_masks"] = np.ones((1, N), bool)
    lv["running.filter_class"] = np.zeros(M, np.int32)
    lv["running.accel_mem"] = np.zeros(M, f32)
    lv["running.accel_held"] = np.zeros(M, f32)
    lv["running.device"] = np.full(M, -1, np.int32)
    lv["running.extended"] = np.zeros((M, E), f32)
    req = np.tile(f32([1.0, 1.0, 4.0]), (M, 1))
    victims = [5, 9, 40, 41, 77]
    max_pods = 64
    if case == "nofit":
        req[9] = [100.0, 1.0, 4.0]        # fits nowhere; the rest still do
    elif case == "overflow":
        victims = [3, 5, 9, 12, 40, 41, 77]
        max_pods = 4
    elif case == "fractional":
        # two devices tie at each node's maximum: the first one takes it
        dev[:] = f32([0.5, 1.0, 1.0, 0.2, 0.0, 1.0, 0.3, 0.9])
        dev[::3, 1] = 0.4
        for m in victims:
            lv["running.device"][m] = 2
            lv["running.accel_held"][m] = 0.5
            req[m, 0] = 0.5
    elif case == "memory":
        # memory-based shares: the portion is node-relative
        lv["nodes.device_memory_gib"] = rng.choice(f32([16.0, 40.0, 80.0]),
                                                   N)
        dev[:] = rng.choice(f32([0.3, 0.5, 1.0]), (N, D))
        for m in victims:
            lv["running.device"][m] = 0
            lv["running.accel_mem"][m] = 24.0
            lv["running.accel_held"][m] = 0.3
            req[m, 0] = 0.3
    elif case == "whole":
        # every other device partly used: whole pods take the first k free
        dev[:, 1::2] = 0.5
        dev[::4, :5] = 0.0
        req[victims, 0] = f32([3.0, 2.0, 1.0, 5.0, 2.0])
    elif case == "extended":
        ext[:] = rng.choice(f32([0.0, 1.0, 2.0, 7.0]), (N, E))
        ext_rel[::5] = 1.0
        lv["running.extended"][victims] = rng.choice(
            f32([0.0, 1.0, 2.0]), (len(victims), E))
    elif case == "mixed":
        victims = sorted(rng.choice(M, 12, replace=False).tolist())
        free = rng.choice(f32([0.0, 2.0, 5.0, 8.0]), (N, 3)) * f32(
            [1.0, 8.0, 64.0])
        rel = rng.choice(f32([0.0, 0.0, 1.0, 2.5]), (N, 3))
        dev = rng.choice(f32([0.0, 0.25, 0.5, 1.0]), (N, D))
        dev_rel = rng.choice(f32([0.0, 0.0, 0.5]), (N, D))
        ext = rng.choice(f32([0.0, 1.0, 3.0]), (N, E))
        lv["nodes.valid"] = rng.random(N) < 0.9
        lv["nodes.filter_masks"] = rng.random((3, N)) < 0.7
        lv["running.filter_class"] = rng.integers(0, 3, M).astype(np.int32)
        for m in victims[::3]:
            lv["running.device"][m] = rng.integers(0, D)
            lv["running.accel_held"][m] = f32(0.5)
            req[m, 0] = 0.5
        req[victims, 1] = rng.uniform(0.1, 3.0, len(victims))
        lv["running.extended"][victims[1::4]] = 1.0
    lv["running.req"] = req
    mask = np.zeros(M, bool)
    mask[victims] = True
    return (lv, mask, free, dev, rel, dev_rel, ext, ext_rel, max_pods)


# ---------------------------------------------------------------------------
# K5 cumsum_ds
# ---------------------------------------------------------------------------

#: (U, trailing shape) of each K5 case
K5_CASES = {
    "u1": (1, (3,)), "u2": (2, (24,)), "u3": (3, (1,)),
    "u255": (255, (5,)), "u256": (256, (24,)), "u257": (257, (3,)),
    "u513_c11": (513, (11,)), "u4097_c1": (4097, (1,)),
    "u65535": (65_535, (3,)), "u65536": (65_536, (5,)),
    "u65537": (65_537, (24,)), "u65793": (65_793, (1,)),
    "u216001": (216_001, (3,)), "uqr": (1_000, (7, 3)),
}


def k5_case(case: str) -> np.ndarray:
    """The f32 table of a K5 case (see the module docstring)."""
    U, tail = K5_CASES[case]
    rng = np.random.default_rng(list(K5_CASES).index(case))
    shape = (U,) + tail
    x = (rng.uniform(1, 10, shape) * 10 ** rng.uniform(-3, 9, shape)
         * rng.choice([-1, 1], shape)).astype(np.float32)
    x[rng.random(shape) < 0.03] = 0.0
    x[rng.random(shape) < 0.03] = -0.0
    x.flat[0] = -0.0
    return x


# ---------------------------------------------------------------------------
# K12 affinity_mask
# ---------------------------------------------------------------------------

#: (nodes, lanes, attract) of each K12 case: 37 nodes take byte loads, 48
#: and 100 K12's 16- and 4-node vectors; 300 lanes at 37 nodes and 264 at
#: 48 give K12 16 nodes a thread, 40 lanes 4
K12_CASES = {
    "n37": (37, 40, False), "n37_attract": (37, 40, True),
    "n37_wide": (37, 300, True), "n48_wide": (48, 264, False),
    "n48_wide_attract": (48, 264, True), "n100": (100, 40, True),
    "n100_avoid": (100, 40, False), "n100_one_lane": (100, 1, True),
}
#: topology levels, term rows, gangs, avoid slots and need slots of every
#: K12 case
K12_LEVELS, K12_TERMS, K12_GANGS, K12_KT, K12_KP = 2, 9, 12, 6, 3


def k12_case(case: str) -> dict:
    """K12's inputs for one case, as numpy arrays: the nodes' ``valid`` and
    ``topology`` (domain ids of two levels, -1 where a node lacks the
    level's label), the gangs' ``anti_avoids``, ``attract_needs``,
    ``anti_term_level`` and ``attract_static``, the claimed-domain table
    ``anti_used`` [TA + 1, N L + N + 1], the lanes' gangs ``cand`` and
    ``attract``."""
    N, B, attract = K12_CASES[case]
    rng = np.random.default_rng(list(K12_CASES).index(case))
    L, TA, G, KT, KP = (K12_LEVELS, K12_TERMS, K12_GANGS, K12_KT, K12_KP)
    valid = rng.random(N) < 0.85
    valid[:32] = True                       # runs of 16 consecutive cells
    valid[33] = False
    # level 0: 3 blocks (ids 0..2), level 1: 6 racks (ids 3..8); some nodes
    # lack the rack label, a few the block label
    topo = np.stack([np.arange(N) % 3, 3 + np.arange(N) % 6], 1)
    topo[rng.random(N) < 0.15, 1] = -1
    topo[rng.random(N) < 0.05, 0] = -1
    # term rows at the block level, the rack level and the per-node level
    # (L), one past it (clamped to L) and one below 0 (clamped to 0)
    term_level = np.array([0, 1, 2, 1, 0, 2, 3, -1, 1], np.int32)
    avoids = rng.integers(0, TA, (G, KT)).astype(np.int32)
    avoids[rng.random((G, KT)) < 0.4] = -1
    avoids[0] = -1                          # no used avoid slot
    avoids[1] = np.arange(KT) % TA          # every slot used
    avoids[2] = [-1, 3, -1, -1, 5, -1]      # -1 in the middle
    avoids[3, 2] = TA + 4                   # past the table: clamped
    needs = rng.integers(0, TA, (G, KP)).astype(np.int32)
    needs[rng.random((G, KP)) < 0.4] = -1
    needs[0] = -1
    needs[1] = [0, 2, 6]
    needs[2] = [-1, 1, -1]
    needs[4] = [2, -1, 2]
    AD1 = N * L + N + 1
    used = rng.random((TA + 1, AD1)) < 0.35
    used[:, AD1 - 1] = rng.random(TA + 1) < 0.5   # the junk column
    static = rng.random((TA, N)) < 0.3
    static[0] = False
    cand = rng.integers(0, G, B).astype(np.int32)
    cand[:min(B, 6)] = np.arange(min(B, 6))
    if B > 8:
        cand[6] = G                         # a junk lane: clamped to G - 1
        cand[7] = -1                        # clamped to 0
    return dict(valid=valid, topology=topo.astype(np.int32),
                anti_avoids=avoids, attract_needs=needs,
                anti_term_level=term_level, attract_static=static,
                anti_used=used, cand=cand, attract=attract)


@dataclasses.dataclass
class K12Nodes:
    """The node fields K12 reads (``valid``, ``topology``, ``n``)."""
    valid: object
    topology: object

    @property
    def n(self) -> int:
        return self.valid.shape[0]


@dataclasses.dataclass
class K12Gangs:
    """The gang fields K12 reads."""
    anti_avoids: object
    attract_needs: object
    anti_term_level: object
    attract_static: object

    @property
    def g(self) -> int:
        return self.anti_avoids.shape[0]


@dataclasses.dataclass
class K12State:
    """The part of a ``ClusterState`` K12 and its plain version read."""
    nodes: K12Nodes
    gangs: K12Gangs


def k12_inputs(case: str, device="cpu"):
    """``(state, anti_used, dom_static, cand, attract)`` of a K12 case as
    port tensors on ``device`` (``dom_static`` from the port's
    ``anti_domain_tables``), ready for ``affinity_mask`` and its plain
    version."""
    import torch

    from ..ops.allocate import anti_domain_tables
    c = k12_case(case)
    t = {k: torch.from_numpy(v).to(device) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    st = K12State(K12Nodes(t["valid"], t["topology"]),
                  K12Gangs(t["anti_avoids"], t["attract_needs"],
                           t["anti_term_level"], t["attract_static"]))
    return st, t["anti_used"], anti_domain_tables(st), t["cand"], \
        c["attract"]
