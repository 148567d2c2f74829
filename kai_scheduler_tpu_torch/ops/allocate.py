"""The allocate action — gang all-or-nothing placement as a wavefront.

Port of ``kai_scheduler_tpu/ops/allocate.py``: the auto-tuned variants
the reference runs on snapshots without extended resources — the
uniform whole-gang kernel with hoisted per-type tables
(gangs of identical replicas, no device shares, binpack) under the
sparse wavefront, or under the dense one with the required topology
level's domain tables, the preferred-level band on either; and the
per-task path under the dense wavefront (GPU sharing: fractional and
memory-based shares with the device table; heterogeneous gangs,
subgroups and their required levels with the in-cycle domain retry,
nominated nodes, anti-self domains, the preferred-level band, spread
scoring) — both with the dynamic pop order, and both with the in-cycle
affinity terms (cross-gang required anti-affinity, shared host ports and
required positive affinity: the claimed-domain table ``anti_used``).

Reference hot path (``actions/allocate/allocate.go:52-156``): pop jobs
from the fairness heap; place each gang whole or not at all.  Here each
chunk of the wavefront takes the next ``B`` gangs of the hoisted pop
order, attempts them independently against the chunk-start state, and
accepts the maximal order-prefix whose cumulative claims fit; the
reference's ``lax.while_loop`` over chunks is a host loop with one sync
per chunk.

Eight device programs of the chunk body are hand-written CUDA kernels,
each with its plain PyTorch version in this module (the wrapper runs the
plain version only for CPU tensors):

- **K2** :func:`type_tables` (``csrc/type_tables.cu``) — per (task type,
  node) fit on idle and on idle+releasing, whole-replica counts and the
  plugin score bands; replaces ``build_type_tables`` (ref ``:1552``).
- **K3** :func:`uniform_fill` (``csrc/uniform_fill.cu``) — every lane's
  whole-gang placement: queue gate, required-domain pick and confinement,
  tie jitter, preferred band, top-k over nodes in ``lax.top_k`` order,
  cumulative fill, node-ascending replica assignment; replaces
  ``_attempt_gang_in_domain_uniform`` under the lane vmap (ref ``:915``,
  ``:1690``).
- **K4** :func:`sparse_accept` (``csrc/sparse_accept.cu``) — the stable
  node sort of the chunk's claims and the first lane that over-subscribes
  a node; replaces ``sparse_entry_tables`` + ``sparse_accept_first_bad``
  (ref ``:283``, ``:313``).
- **K9** :func:`pertask_fill` (``csrc/pertask_fill.cu``) — every lane's
  per-task placement, T task steps in order against the lane's live
  pools and domain aggregates; replaces ``_attempt_gang_in_domain`` under
  the lane vmap (ref ``:517``, ``:1699``) and, launched again over the
  failed lanes, ``_attempt_gang``'s in-cycle retry (``:1274-1289``).
- **K10** :func:`dense_accept` (``csrc/dense_accept.cu``) — the dense
  accept prefix over the lanes' cumulative node and device claims and
  the weighted commit (ref ``:1730-1795``).
- **K11** :func:`topo_tables_build` / :func:`topo_tables_update`
  (``csrc/topo_tables.cu``) — the uniform path's per-type replica counts
  and per-domain capacities and aggregates, built once per action and
  kept current at the nodes each commit touched (ref ``:1461``,
  ``:1490``).
- **K12** :func:`affinity_mask` (``csrc/affinity.cu``) — each lane's node
  mask from the claimed-domain table: no avoid row has claimed the node's
  domain, every need row has; replaces ``anti_forbid_nodes`` +
  ``attract_allow_nodes`` (ref ``:171``, ``:232``) under the lane axis.
  K3 and K9 take it as their mask mode.
- **K13** :func:`anti_mark` (same source) — the taken lanes' placements
  claimed in their mark rows, in place on the action's copy of the table;
  replaces ``anti_mark_placements`` (ref ``:189``).

Everything else in the chunk is elementwise work, scatters and sorts and
stays as PyTorch ops.  JAX's out-of-bounds-dropping scatters at the junk
gang index ``G`` become writes into one extra buffer row that is sliced
off.  A configuration the port does not implement raises
``NotImplementedError`` naming the flag; it never silently returns a
different result.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..apis.types import UNLIMITED
from ..state.cluster_state import ClusterState, NodeState
from . import ordering
from ..utils.numerics import cumsum_blocked
from .predicates import (_accel_pool_ok, feasible_nodes, feasible_nodes_dual,
                         node_portion, resource_fit_mask, selector_mask)
from .scoring import (BIG_NEG, DEFAULT_TIERS, W_NOMINATED, W_TOPOLOGY,
                      PlacementConfig, gpu_sharing_score, pick_device,
                      score_bands, score_nodes_for_task)

Tensor = torch.Tensor
EPS = 1e-6
_INF = float("inf")


@dataclasses.dataclass
class AllocationResult:
    """The cycle's running commit set — the Statement, as a value (same
    fields, shapes and dtypes as the reference's ``AllocationResult``)."""

    placements: Tensor     # i32 [G, T]  node index per task, -1 unplaced
    extended_free: Tensor  # f32 [N, E]
    placement_device: Tensor  # i32 [G, T]
    pipelined: Tensor      # bool [G, T] placed onto releasing resources
    allocated: Tensor      # bool [G]    gang committed this cycle
    attempted: Tensor      # bool [G]    gang was popped and tried
    free: Tensor           # f32 [N, R]  idle pool after commits
    device_free: Tensor    # f32 [N, D]
    releasing_extra: Tensor         # f32 [N, R]
    device_releasing_extra: Tensor  # f32 [N, D]
    extended_releasing_extra: Tensor  # f32 [N, E]
    queue_allocated: Tensor  # f32 [Q, R]
    queue_allocated_nonpreemptible: Tensor  # f32 [Q, R]
    victim: Tensor         # bool [M]
    victim_move: Tensor    # i32 [M]
    #: 0 = placed/not tried, 1 = feasibility prefilter, 2 = signature
    #: skip, 3 = placement attempt failed — i32 [G]
    fit_reason: Tensor
    anti_used: Tensor      # bool [TA+1, AD+1]
    wavefront_stats: Tensor  # i32 [2, 5]


def init_result(state: ClusterState) -> AllocationResult:
    """Fresh commit set at cycle start (an empty Statement)."""
    g, n, q = state.gangs, state.nodes, state.queues
    G, T = g.g, g.t
    dev = state.device
    TA = g.anti_term_level.shape[0]
    AD = n.n * n.topology.shape[1] + n.n
    return AllocationResult(
        anti_used=torch.zeros((TA + 1, AD + 1), dtype=torch.bool,
                              device=dev),
        wavefront_stats=torch.zeros((2, 5), dtype=torch.int32, device=dev),
        placements=torch.full((G, T), -1, dtype=torch.int32, device=dev),
        extended_free=n.extended_free,
        placement_device=torch.full((G, T), -1, dtype=torch.int32,
                                    device=dev),
        pipelined=torch.zeros((G, T), dtype=torch.bool, device=dev),
        allocated=torch.zeros((G,), dtype=torch.bool, device=dev),
        attempted=torch.zeros((G,), dtype=torch.bool, device=dev),
        free=n.free,
        device_free=n.device_free,
        releasing_extra=torch.zeros_like(n.free),
        device_releasing_extra=torch.zeros_like(n.device_free),
        extended_releasing_extra=torch.zeros_like(n.extended_free),
        queue_allocated=q.allocated,
        queue_allocated_nonpreemptible=q.allocated_nonpreemptible,
        victim=torch.zeros((state.running.m,), dtype=torch.bool, device=dev),
        victim_move=torch.full((state.running.m,), -1, dtype=torch.int32,
                               device=dev),
        fit_reason=torch.zeros((G,), dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# the affinity gates: the cycle's claimed-domain table ``anti_used``
# ---------------------------------------------------------------------------

def anti_domain_tables(state: ClusterState) -> Tensor:
    """Per-LEVEL dense domain ids of the in-cycle exclusion table (ref
    ``:150``): ``dom_static`` i32 [L+1, N] — rows 0..L-1 the topology
    levels (a node LACKING the level's label is its own per-node domain
    ``N*L + node``), row L the per-node granularity; padded node slots map
    to the junk id ``AD = N*L + N``."""
    n = state.nodes
    N, L = n.n, n.topology.shape[1]
    ND = N * L
    AD = ND + N
    node_slot = ND + torch.arange(N, dtype=torch.int32, device=n.valid.device)
    rows = [torch.where(n.valid, torch.where(n.topology[:, lvl] >= 0,
                                             n.topology[:, lvl], node_slot),
                        AD) for lvl in range(L)]
    rows.append(torch.where(n.valid, node_slot, AD))
    return torch.stack(rows).to(torch.int32).contiguous()


def _term_rows(state: ClusterState, slots: Tensor, what: str):
    """The term rows of a gang's slots: ``(t_safe, level)`` — the slot
    clipped to a real row, the row's level clipped to ``[0, L]``."""
    g = state.gangs
    TA = g.anti_term_level.shape[0]
    if TA <= 0:
        raise ValueError(f"{what} kernels compiled without terms")
    L = state.nodes.topology.shape[1]
    t_safe = torch.clamp(slots, 0, TA - 1).long()
    return t_safe, torch.clamp(g.anti_term_level[t_safe], 0, L).long()


def _gang_rows(state: ClusterState, gang_idx: Tensor) -> Tensor:
    """``max(g, 0)``, clamped to a real row as JAX's gathers clamp."""
    return torch.clamp(gang_idx, 0, state.gangs.g - 1).long()


def _claimed_at(anti_used: Tensor, dom_static: Tensor, t_safe: Tensor,
                lvl: Tensor, static: Tensor | None = None) -> Tensor:
    """bool [..., N]: ``anti_used[t, dom_static[lvl]]`` for every slot's
    (row, level) — each distinct pair gathered once over the nodes (OR-ed
    with its row of ``static`` when given), then spread to the slots."""
    L1 = dom_static.shape[0]
    pair, inv = torch.unique(t_safe * L1 + lvl, return_inverse=True)
    row, lv = pair // L1, pair % L1
    hit = anti_used[row[:, None], dom_static[lv].long()]     # [U, N]
    if static is not None:
        hit = hit | static[row]
    return hit[inv]


def anti_forbid_nodes(state: ClusterState, anti_used: Tensor,
                      dom_static: Tensor, gang_idx: Tensor) -> Tensor:
    """bool [..., N] — nodes whose domain one of the gang's avoid rows
    has claimed this cycle (ref ``:171``; ``gang_idx`` of any shape)."""
    avoids = state.gangs.anti_avoids[_gang_rows(state, gang_idx)]  # [..., KT]
    t_safe, lvl = _term_rows(state, avoids, "anti")
    hit = _claimed_at(anti_used, dom_static, t_safe, lvl)    # [..., KT, N]
    return (hit & (avoids >= 0)[..., None]).any(-2)


def anti_mark_cells(state: ClusterState, dom_static: Tensor,
                    gang_idx: Tensor, nodes_t: Tensor,
                    valid: Tensor) -> tuple[Tensor, Tensor]:
    """The (row, column) cells the committed placements claim, long
    [..., KT, T] each (ref ``:189``): every (mark slot, placed task) names
    (row, domain of its node); an unused pair names the junk cell (TA, AD),
    as the reference's scatter does.  ``valid`` gates whole gangs/lanes."""
    marks = state.gangs.anti_marks[_gang_rows(state, gang_idx)]  # [..., KT]
    t_safe, lvl = _term_rows(state, marks, "anti")
    TA = state.gangs.anti_term_level.shape[0]
    AD = dom_static.shape[1] * dom_static.shape[0]
    placed = (nodes_t >= 0) & valid[..., None]               # [..., T]
    doms = dom_static[lvl[..., None],
                      torch.clamp(nodes_t, min=0).long()[..., None, :]]
    ok = placed[..., None, :] & (marks >= 0)[..., None]      # [..., KT, T]
    return (torch.where(ok, t_safe[..., None], TA),
            torch.where(ok, doms.long(), AD))


def anti_mark_placements(state: ClusterState, anti_used: Tensor,
                         dom_static: Tensor, gang_idx: Tensor,
                         nodes_t: Tensor, valid: Tensor) -> Tensor:
    """A new table: ``anti_used`` with the committed placements' cells
    (:func:`anti_mark_cells`) set True (ref ``:189``)."""
    out = anti_used.clone()
    out[anti_mark_cells(state, dom_static, gang_idx, nodes_t, valid)] = True
    return out


def _slot_meets(a: Tensor, b: Tensor, a_on: Tensor, b_on: Tensor) -> Tensor:
    """bool [B, B]: lane i's slots ``a`` (where ``a_on``) share a row with
    lane j's slots ``b`` (where ``b_on``)."""
    return ((a[:, None, :, None] == b[None, :, None, :])
            & a_on[:, None, :, None] & b_on[None, :, None, :]).any(3).any(2)


def _earlier_valid(hit: Tensor, cand_valid: Tensor) -> Tensor:
    """bool [B]: a valid lane meets an EARLIER valid lane in ``hit``."""
    B = hit.shape[0]
    ar = torch.arange(B, device=hit.device)
    earlier = ar[None, :] < ar[:, None]
    return (hit & earlier & cand_valid[None, :]).any(1) & cand_valid


def anti_defer_lanes(state: ClusterState, cand_g: Tensor,
                     cand_valid: Tensor) -> Tensor:
    """bool [B] — lanes whose avoid rows meet an EARLIER valid lane's mark
    rows this chunk (ref ``:213``): they retry next chunk against the
    updated table."""
    gi = _gang_rows(state, cand_g)
    marks = state.gangs.anti_marks[gi]                       # [B, KT]
    avoids = state.gangs.anti_avoids[gi]
    return _earlier_valid(_slot_meets(avoids, marks, avoids >= 0,
                                      marks >= 0), cand_valid)


def attract_allow_nodes(state: ClusterState, anti_used: Tensor,
                        dom_static: Tensor, gang_idx: Tensor) -> Tensor:
    """bool [..., N] — nodes permitted by the gang's need rows (ref
    ``:232``): EVERY need row claims the node's domain at the row's level,
    statically (``attract_static``) or in this cycle; unused slots pass."""
    g = state.gangs
    needs = g.attract_needs[_gang_rows(state, gang_idx)]     # [..., KP]
    t_safe, lvl = _term_rows(state, needs, "attract")
    claimed = _claimed_at(anti_used, dom_static, t_safe, lvl,
                          g.attract_static)                  # [..., KP, N]
    return (claimed | (needs < 0)[..., None]).all(-2)


def attract_defer_lanes(state: ClusterState, cand_g: Tensor,
                        cand_valid: Tensor, anti_used: Tensor) -> Tensor:
    """bool [B] — lanes with a still-UNCLAIMED need row that an EARLIER
    valid lane would mark (ref ``:257``): they sit the chunk out, so an
    anchor and its depender in one chunk land in order.  Lane 0 never
    defers."""
    g = state.gangs
    TA = g.anti_term_level.shape[0]
    AD = anti_used.shape[1] - 1
    gi = _gang_rows(state, cand_g)
    needs = g.attract_needs[gi]                              # [B, KP]
    marks = g.anti_marks[gi]                                 # [B, KT]
    row_any = anti_used[:TA, :AD].any(1) | g.attract_static.any(1)  # [TA]
    open_need = (needs >= 0) & ~row_any[torch.clamp(needs, 0, TA - 1).long()]
    return _earlier_valid(_slot_meets(needs, marks, open_need, marks >= 0),
                          cand_valid)


# ---------------------------------------------------------------------------
# K12 / K13: the lanes' node mask and the marking of the taken placements
# ---------------------------------------------------------------------------

def affinity_mask_plain(state: ClusterState, anti_used: Tensor,
                        dom_static: Tensor, cand: Tensor, *,
                        attract: bool) -> Tensor:
    """Plain PyTorch version of K12: bool [B, N], each lane's allowed nodes
    — the valid nodes no avoid row has claimed and, with ``attract``, that
    every need row has claimed (ref ``:1670-1680``, and ``n.valid &
    domain_mask`` of ``_attempt_gang`` ``:1259``)."""
    mask = state.nodes.valid & ~anti_forbid_nodes(state, anti_used,
                                                  dom_static, cand)
    if attract:
        mask = mask & attract_allow_nodes(state, anti_used, dom_static, cand)
    return mask


def affinity_mask(state: ClusterState, anti_used: Tensor, dom_static: Tensor,
                  cand: Tensor, *, attract: bool) -> Tensor:
    """K12 — every lane's node mask (see :func:`affinity_mask_plain`).  CPU
    tensors run the plain version; CUDA tensors launch one thread per
    (lane, node) or raise."""
    if not kernels.on_card(anti_used):
        return affinity_mask_plain(state, anti_used, dom_static, cand,
                                   attract=attract)
    g, n = state.gangs, state.nodes
    B = cand.shape[0]
    N, L = n.n, n.topology.shape[1]
    TA = g.anti_term_level.shape[0]
    KT, KP = g.anti_avoids.shape[1], g.attract_needs.shape[1]
    if TA <= 0:
        raise ValueError("anti kernels compiled without terms")
    i32, b = torch.int32, torch.bool
    ts = dict(anti_used=anti_used, dom_static=dom_static,
              term_level=g.anti_term_level, avoids=g.anti_avoids,
              needs=g.attract_needs, attract_static=g.attract_static,
              valid=n.valid, cand=cand)
    dev = kernels.require_cuda("affinity_mask", ts, dict(
        anti_used=b, dom_static=i32, term_level=i32, avoids=i32, needs=i32,
        attract_static=b, valid=b, cand=i32))
    if anti_used.shape != (TA + 1, N * L + N + 1) or \
            dom_static.shape != (L + 1, N):
        raise ValueError("affinity_mask: anti_used must be [TA+1, AD+1] and "
                         "dom_static [L+1, N]")
    out = torch.empty((B, N), dtype=b, device=dev)
    rc = kernels.library().kai_affinity_mask(
        *(kernels.ptr(t) for t in ts.values()), B, N, L, TA, g.g, KT, KP,
        int(attract), kernels.ptr(out), kernels.stream_of(anti_used))
    kernels.check(rc, "affinity_mask")
    kernels.count_launch("affinity_mask")
    return out


def anti_mark_plain(state: ClusterState, anti_used: Tensor,
                    dom_static: Tensor, cand: Tensor, nodes_b: Tensor,
                    take: Tensor) -> Tensor:
    """Plain PyTorch version of K13: sets the taken lanes' cells
    (:func:`anti_mark_cells`) True in ``anti_used`` itself and returns it."""
    anti_used[anti_mark_cells(state, dom_static, cand, nodes_b, take)] = True
    return anti_used


def anti_mark(state: ClusterState, anti_used: Tensor, dom_static: Tensor,
              cand: Tensor, nodes_b: Tensor, take: Tensor) -> Tensor:
    """K13 — claims the taken lanes' placements in ``anti_used`` IN PLACE
    and returns it (``cand`` i32 [B], ``nodes_b`` i32 [B, T], ``take`` bool
    [B]; the table only grows within a cycle, and each action marks a copy
    of its own).  CPU tensors run :func:`anti_mark_plain`; CUDA tensors
    launch one thread per (lane, mark slot, task), or raise."""
    if not kernels.on_card(anti_used):
        return anti_mark_plain(state, anti_used, dom_static, cand, nodes_b,
                               take)
    g, n = state.gangs, state.nodes
    B, T = nodes_b.shape
    N, L = n.n, n.topology.shape[1]
    TA = g.anti_term_level.shape[0]
    if TA <= 0:
        raise ValueError("anti kernels compiled without terms")
    i32, b = torch.int32, torch.bool
    ts = dict(dom_static=dom_static, term_level=g.anti_term_level,
              marks=g.anti_marks, cand=cand, nodes_b=nodes_b, take=take)
    kernels.require_cuda("anti_mark", dict(ts, anti_used=anti_used), dict(
        anti_used=b, dom_static=i32, term_level=i32, marks=i32, cand=i32,
        nodes_b=i32, take=b))
    if anti_used.shape != (TA + 1, N * L + N + 1) or take.shape != (B,):
        raise ValueError("anti_mark: anti_used must be [TA+1, AD+1] and "
                         "take [B]")
    rc = kernels.library().kai_anti_mark(
        *(kernels.ptr(t) for t in ts.values()), B, T, N, L, TA, g.g,
        g.anti_marks.shape[1], kernels.ptr(anti_used),
        kernels.stream_of(anti_used))
    kernels.check(rc, "anti_mark")
    kernels.count_launch("anti_mark")
    return anti_used


@dataclasses.dataclass(frozen=True)
class AllocateConfig:
    """Knobs of the allocate action — the reference's fields, one for one
    (see ``kai_scheduler_tpu.ops.allocate.AllocateConfig`` for each
    knob's meaning).  :func:`allocate` raises ``NotImplementedError`` for
    the settings this slice does not implement."""

    placement: PlacementConfig = PlacementConfig()
    queue_depth: int | None = None
    dynamic_order: bool = True
    batch_size: int = 256
    track_devices: bool = True
    uniform_tasks: bool = False
    prefilter: bool = True
    subgroup_topology: bool = True
    extended: bool = False
    dense_feasibility: bool = False
    signature_skip: bool = True
    anti_groups: bool = False
    attract_groups: bool = False
    preferred_topology: bool = True
    sparse_wavefront: bool = True
    hoist_type_tables: bool = True


def check_supported(config: AllocateConfig) -> None:
    """Raise ``NotImplementedError`` naming the first setting that needs
    a path the allocate action has not ported (and ``ValueError`` for the
    combination the reference itself rejects).

    Both paths take the required and subgroup topology levels
    (``subgroup_topology``), the preferred-level band and the in-cycle
    affinity terms (``anti_groups``, ``attract_groups``); the per-task
    path also takes the device share table (``track_devices``).  The
    victim actions keep their own, narrower check
    (``victims.check_placement_ported``)."""
    if config.uniform_tasks and config.track_devices:
        raise ValueError(
            "uniform_tasks fast path requires track_devices=False")
    unsupported = [
        (config.extended, "extended=True (MIG/DRA scalar resources)"),
        (config.queue_depth is not None, "queue_depth"),
        (not config.dynamic_order, "dynamic_order=False"),
        (not config.sparse_wavefront, "sparse_wavefront=False"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(
                f"allocate: {what} is not ported to the PyTorch package yet")


def _replica_count(avail: Tensor, req: Tensor, mask: Tensor) -> Tensor:
    """i32 [..., N] whole replicas of ``req`` [..., R] fitting in each
    node's ``avail`` [N, R] row, zero outside ``mask`` — the reference's
    one place for the count arithmetic (``:358``)."""
    pos = req > EPS
    c = torch.where(pos[..., None, :],
                    (avail + EPS) / torch.clamp(req, min=EPS)[..., None, :],
                    _INF)                                   # [..., N, R]
    c = torch.floor(c.amin(-1))
    return torch.where(mask, torch.clamp(c, 0.0, 1e9), 0.0).to(torch.int32)


def _chain_membership(parent: Tensor, num_levels: int) -> Tensor:
    """bool [Q, Q]: ``C[q, a]`` — queue ``a`` is ``q`` or an ancestor."""
    Q = parent.shape[0]
    eye = torch.eye(Q, dtype=torch.bool, device=parent.device)
    member = torch.zeros((Q, Q), dtype=torch.bool, device=parent.device)
    cur = torch.arange(Q, dtype=torch.int32, device=parent.device)
    for _ in range(num_levels):
        valid = cur >= 0
        idx = torch.clamp(cur, min=0).long()
        member = member | (valid[:, None] & eye[idx])
        cur = torch.where(valid, parent[idx], -1)
    return member


# ---------------------------------------------------------------------------
# K2: per-type fit / replica-count / score tables
# ---------------------------------------------------------------------------

def type_tables_plain(nodes: NodeState, free: Tensor, extra: Tensor,
                      type_req: Tensor, type_selector: Tensor,
                      type_class: Tensor, placement: PlacementConfig):
    """Plain PyTorch version of K2: for every task type y and node n,
    ``fit_idle``, ``fit_pipe`` (bool [Y, N]), the whole replicas that fit
    on idle and on idle+releasing+extra (i32 [Y, N]) and the summed plugin
    bands (f32 [Y, N], unmasked — the lanes add the soft and jitter
    bands and mask).  ``extra`` is one [N, R] pool for every row, or one
    pool per row, [Y, N, R] (the victim wavefront: row b is lane b's
    gang type with the lane's own freed capacity).  Rows repeat when each
    lane names its own type's row: with one shared pool each distinct row
    is computed once (a row depends on its own inputs only)."""
    if extra.dim() == 2 and type_req.shape[0] > 1:
        key = torch.cat([type_req.view(torch.int32), type_selector,
                         type_class[:, None]], 1)
        uniq, inv = torch.unique(key, dim=0, return_inverse=True)
        if uniq.shape[0] < key.shape[0]:
            first = torch.full((uniq.shape[0],), key.shape[0],
                               dtype=torch.int64, device=key.device)
            first.scatter_reduce_(0, inv, torch.arange(
                key.shape[0], device=key.device), reduce="amin")
            return tuple(t[inv] for t in type_tables_plain(
                nodes, free, extra, type_req[first], type_selector[first],
                type_class[first], placement))
    zero = torch.zeros(type_req.shape[:-1], dtype=type_req.dtype,
                       device=type_req.device)
    fi, fp = feasible_nodes_dual(
        nodes, type_req, type_selector, zero, zero, free=free,
        device_free=None, extra_releasing=extra,
        extra_device_releasing=None, devices=False, task_class=type_class)
    cp = _replica_count(free + nodes.releasing + extra, type_req, fp)
    ci = _replica_count(free, type_req, fi)
    sc = score_bands(nodes, free, type_req, fi, fp, placement)
    return fi, fp, ci, cp, sc


def _tier_limit(name: str, placement: PlacementConfig) -> None:
    if tuple(placement.tiers) != DEFAULT_TIERS:
        raise NotImplementedError(
            f"{name}: the CUDA kernel composes the default tiers "
            f"DEFAULT_TIERS={DEFAULT_TIERS}, not {tuple(placement.tiers)}")


def type_tables_limits(placement: PlacementConfig) -> None:
    """Raise ``NotImplementedError`` naming the limit K2's kernel does not
    take: a plugin tier list other than ``DEFAULT_TIERS``."""
    _tier_limit("type_tables", placement)


def type_tables(nodes: NodeState, free: Tensor, extra: Tensor,
                type_req: Tensor, type_selector: Tensor, type_class: Tensor,
                placement: PlacementConfig):
    """K2 — ``(fit_idle, fit_pipe, c_idle, c_pipe, bands)`` per (type,
    node), once per chunk against chunk-start ``free``.  CPU tensors run
    :func:`type_tables_plain`; CUDA tensors launch the kernel or raise."""
    if not kernels.on_card(free):
        return type_tables_plain(nodes, free, extra, type_req, type_selector,
                                 type_class, placement)
    type_tables_limits(placement)
    N, R_ = free.shape
    Y, K = type_selector.shape
    X = nodes.filter_masks.shape[0]
    if R_ != 3 or type_req.shape != (Y, R_):
        raise ValueError("type_tables: resource axis must be 3")
    per_row = extra.dim() == 3
    if extra.shape != ((Y, N, R_) if per_row else (N, R_)):
        raise ValueError("type_tables: extra must be [N, R] or [Y, N, R]")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    ts = dict(free=free, releasing=nodes.releasing, extra=extra,
              allocatable=nodes.allocatable, valid=nodes.valid,
              labels=nodes.labels, filter_masks=nodes.filter_masks,
              type_req=type_req, type_selector=type_selector,
              type_class=type_class)
    dev = kernels.require_cuda("type_tables", ts, dict(
        free=f32, releasing=f32, extra=f32, allocatable=f32, valid=b,
        labels=i32, filter_masks=b, type_req=f32, type_selector=i32,
        type_class=i32))
    fi = torch.empty((Y, N), dtype=b, device=dev)
    fp = torch.empty((Y, N), dtype=b, device=dev)
    ci = torch.empty((Y, N), dtype=i32, device=dev)
    cp = torch.empty((Y, N), dtype=i32, device=dev)
    sc = torch.empty((Y, N), dtype=f32, device=dev)
    lib = kernels.library()
    rc = lib.kai_type_tables(
        *(kernels.ptr(t) for t in ts.values()),
        N, R_, K, Y, X, int(placement.binpack_accel),
        int(placement.binpack_cpu), int(per_row),
        *(kernels.ptr(t) for t in (fi, fp, ci, cp, sc)),
        kernels.stream_of(free))
    kernels.check(rc, "type_tables")
    kernels.count_launch("type_tables", lanes=per_row)
    return fi, fp, ci, cp, sc


# ---------------------------------------------------------------------------
# K11: the domain tables of the required topology levels
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TopoStatic:
    """The action's static domain tables (ref ``:1418-1460``).  The
    snapshot numbers every (level, label path) with one dense id below
    ``ND = N * L``; each id belongs to one level."""

    #: topology level of each domain id, -1 where no node has it — i32 [ND]
    level_of_dom: Tensor
    #: node -> domain id per level, ``ND`` for padded or unlabelled
    #: nodes — i32 [L, N]
    dom_of: Tensor
    #: the nodes of each domain, ascending (XLA:CPU's scatter-add order):
    #: domain d holds ``dom_nodes[dom_ptr[d]:dom_ptr[d + 1]]`` —
    #: i32 [ND + 1] and i32 [M]
    dom_ptr: Tensor
    dom_nodes: Tensor

    @classmethod
    def of(cls, nodes: NodeState) -> "TopoStatic":
        N, L = nodes.topology.shape
        ND = N * L
        dv = nodes.topology.device
        i32 = torch.int32
        dom_of = torch.stack([
            torch.where(nodes.valid & (nodes.topology[:, lvl] >= 0),
                        nodes.topology[:, lvl], ND)
            for lvl in range(L)]).to(i32)                    # [L, N]
        level_of_dom = torch.full((ND + 1,), -1, dtype=i32, device=dv)
        for lvl in range(L):
            level_of_dom[dom_of[lvl].long()] = lvl
        # a stable sort of the level-major ids keeps each domain's nodes
        # ascending (a domain lives on one level); junk ids sort last
        flat = dom_of.reshape(-1)
        perm = torch.sort(flat, stable=True).indices
        counts = torch.bincount(flat.long(), minlength=ND + 1)[:ND]
        dom_ptr = torch.zeros((ND + 1,), dtype=i32, device=dv)
        dom_ptr[1:] = torch.cumsum(counts, 0, dtype=i32)
        M = int(dom_ptr[-1])
        return cls(level_of_dom=level_of_dom[:ND].contiguous(),
                   dom_of=dom_of.contiguous(), dom_ptr=dom_ptr,
                   dom_nodes=(perm[:M] % N).to(i32).contiguous())


def topo_tables_build_plain(st: TopoStatic, fp_build: Tensor, avail: Tensor,
                            valid: Tensor, type_req: Tensor):
    """Plain PyTorch version of K11's build (ref ``topo_tables_build``
    ``:1461``): per type the replicas that fit on each node's ``avail``
    (idle + releasing + victim-freed) where the type fit at the action's
    start (``fp_build`` [Y, N]), ``c_y`` i32 [Y, N + 1] with a zero junk
    column; their sums per domain, ``dom_caps_y`` i32 [Y, ND]; and the
    domains' aggregate accelerator, ``agg`` f32 [ND], summed per domain in
    ascending node order from +0.0 (XLA:CPU's scatter-add order)."""
    L, N = st.dom_of.shape
    ND = N * L
    Y = type_req.shape[0]
    # ref _replicas_at (:1448): _replica_count's arithmetic per type
    c_all = _replica_count(avail, type_req, fp_build)        # [Y, N]
    c_y = torch.cat([c_all, torch.zeros((Y, 1), dtype=torch.int32,
                                        device=c_all.device)], 1)
    caps = torch.zeros((Y, ND + 1), dtype=torch.int32, device=c_all.device)
    agg = torch.zeros((ND + 1,), dtype=avail.dtype, device=avail.device)
    accel = torch.where(valid, avail[:, 0], 0.0)
    for lvl in range(L):
        ids = st.dom_of[lvl].long()
        caps.index_add_(1, ids, c_all)
        agg.index_add_(0, ids, accel)
    return caps[:, :ND].contiguous(), agg[:ND].contiguous(), c_y


def topo_tables_update_plain(st: TopoStatic, fp_build: Tensor,
                             dom_caps_y: Tensor, agg: Tensor, c_y: Tensor,
                             avail: Tensor, take: Tensor, nodes_b: Tensor,
                             req0_b: Tensor, type_req: Tensor):
    """Plain PyTorch version of K11's update (ref ``topo_tables_update``
    ``:1490``) after a chunk's commit: the replica counts of the nodes the
    taken lanes placed on are recomputed from ``avail`` (the committed
    pools), their per-node changes pushed into every level's domain caps,
    and each placed replica's accelerator request ``req0_b`` [B] taken off
    its node's domains in entry order (lane-major).  Returns new
    ``(dom_caps_y, agg, c_y)``."""
    L, N = st.dom_of.shape
    ND = N * L
    Y = type_req.shape[0]
    dv = c_y.device
    placed = take[:, None] & (nodes_b >= 0)                  # [B, T]
    idxs = torch.where(placed, nodes_b, N).reshape(-1).long()  # [K]
    isafe = torch.clamp(idxs, max=N - 1)
    c_new = _replica_count(avail[isafe], type_req, fp_build[:, isafe])
    c_new = torch.where((idxs < N)[None, :], c_new, 0)       # [Y, K]
    # duplicate touches write the same count, so the scatter is defined
    c_at = torch.zeros((Y, N + 1), dtype=torch.int32, device=dv)
    c_at[:, idxs] = c_new
    touched = torch.zeros((N + 1,), dtype=torch.bool, device=dv)
    touched[idxs] = True
    d_node = torch.where(touched[None, :], c_at - c_y, 0)[:, :N]
    c_y = torch.where(touched[None, :], c_at, c_y)
    caps = torch.cat([dom_caps_y, torch.zeros((Y, 1), dtype=torch.int32,
                                              device=dv)], 1)
    accel = torch.where(placed, req0_b[:, None], 0.0).reshape(-1)
    agg = agg.clone()
    for lvl in range(L):
        caps.index_add_(1, st.dom_of[lvl].long(), d_node)
        dom = torch.where(idxs < N, st.dom_of[lvl][isafe].long(), ND)
        agg.index_add_(0, torch.clamp(dom, max=ND - 1),
                       torch.where(dom < ND, -accel, 0.0))
    return caps[:, :ND].contiguous(), agg, c_y


def _topo_common(name: str, st: TopoStatic, tensors: dict, dtypes: dict):
    dv = kernels.require_cuda(name, dict(
        tensors, level_of_dom=st.level_of_dom, dom_of=st.dom_of,
        dom_ptr=st.dom_ptr, dom_nodes=st.dom_nodes), dict(
        dtypes, level_of_dom=torch.int32, dom_of=torch.int32,
        dom_ptr=torch.int32, dom_nodes=torch.int32))
    if tensors["type_req"].shape[1] != 3:
        raise ValueError(f"{name}: resource axis must be 3")
    return dv


def topo_tables_build(st: TopoStatic, fp_build: Tensor, avail: Tensor,
                      valid: Tensor, type_req: Tensor):
    """K11 build (see :func:`topo_tables_build_plain`).  CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    if not kernels.on_card(avail):
        return topo_tables_build_plain(st, fp_build, avail, valid, type_req)
    L, N = st.dom_of.shape
    ND = N * L
    Y = type_req.shape[0]
    f32, i32, b = torch.float32, torch.int32, torch.bool
    dv = _topo_common("topo_tables_build", st, dict(
        fp_build=fp_build, avail=avail, valid=valid, type_req=type_req),
        dict(fp_build=b, avail=f32, valid=b, type_req=f32))
    caps = torch.empty((Y, ND), dtype=i32, device=dv)
    agg = torch.empty((ND,), dtype=f32, device=dv)
    c_y = torch.empty((Y, N + 1), dtype=i32, device=dv)
    rc = kernels.library().kai_topo_tables_build(
        *(kernels.ptr(t) for t in (st.dom_ptr, st.dom_nodes, fp_build, avail,
                                   type_req)),
        N, L, Y, *(kernels.ptr(t) for t in (caps, agg, c_y)),
        kernels.stream_of(avail))
    kernels.check(rc, "topo_tables_build")
    kernels.count_launch("topo_tables_build")
    return caps, agg, c_y


def topo_tables_update(st: TopoStatic, fp_build: Tensor, dom_caps_y: Tensor,
                       agg: Tensor, c_y: Tensor, avail: Tensor, take: Tensor,
                       nodes_b: Tensor, req0_b: Tensor, type_req: Tensor):
    """K11 update (see :func:`topo_tables_update_plain`).  CPU tensors run
    the plain version; CUDA tensors launch the kernel on copies of the
    three tables or raise."""
    if not kernels.on_card(avail):
        return topo_tables_update_plain(st, fp_build, dom_caps_y, agg, c_y,
                                        avail, take, nodes_b, req0_b,
                                        type_req)
    L, N = st.dom_of.shape
    B, T = nodes_b.shape
    Y = type_req.shape[0]
    f32, i32, b = torch.float32, torch.int32, torch.bool
    _topo_common("topo_tables_update", st, dict(
        fp_build=fp_build, dom_caps_y=dom_caps_y, agg=agg, c_y=c_y,
        avail=avail, take=take, nodes_b=nodes_b, req0_b=req0_b,
        type_req=type_req), dict(
        fp_build=b, dom_caps_y=i32, agg=f32, c_y=i32, avail=f32, take=b,
        nodes_b=i32, req0_b=f32, type_req=f32))
    caps, agg, c_y = dom_caps_y.clone(), agg.clone(), c_y.clone()
    rc = kernels.library().kai_topo_tables_update(
        *(kernels.ptr(t) for t in (st.dom_of, fp_build, avail, take, nodes_b,
                                   req0_b, type_req)),
        N, L, Y, B, T, *(kernels.ptr(t) for t in (caps, agg, c_y)),
        kernels.stream_of(avail))
    kernels.check(rc, "topo_tables_update")
    kernels.count_launch("topo_tables_update")
    return caps, agg, c_y


def order_by_agg(level_of_dom: Tensor, agg: Tensor) -> Tensor:
    """i32 [ND]: the domains fullest-first for the chunk's pick — a STABLE
    ascending sort of ``agg`` with ``inf`` on ids that are not domains
    (ref ``:1660``; many domains tie, so stability is part of the
    contract).  ``+ 0.0`` folds -0.0 into +0.0, which a CUDA radix sort
    would otherwise order apart."""
    key = torch.where(level_of_dom >= 0, agg + 0.0, _INF)
    return torch.sort(key, stable=True).indices.to(torch.int32)


# ---------------------------------------------------------------------------
# K3: the uniform whole-gang fill, one lane per gang attempt
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LaneTables:
    """Gang-side inputs of the uniform fill, gathered once per action —
    task slot 0 of a uniform gang is its replica (contiguous copies)."""

    task_req0: Tensor    # f32 [G, R]
    task_valid: Tensor   # bool [G, T]
    queue: Tensor        # i32 [G]
    preemptible: Tensor  # bool [G]
    anti_self: Tensor    # i32 [G]
    task_type0: Tensor   # i32 [G]
    task_class0: Tensor  # i32 [G]

    @classmethod
    def of(cls, state: ClusterState) -> "LaneTables":
        g = state.gangs
        return cls(task_req0=g.task_req[:, 0].contiguous(),
                   task_valid=g.task_valid.contiguous(),
                   queue=g.queue.contiguous(),
                   preemptible=g.preemptible.contiguous(),
                   anti_self=g.anti_self_level.contiguous(),
                   task_type0=g.task_type[:, 0].contiguous(),
                   task_class0=g.task_filter_class[:, 0].contiguous())


def topk_lax_order(scores: Tensor, k: int) -> Tensor:
    """Indices of the ``k`` best entries of each f32 row in ``lax.top_k``
    order: score descending in the total order of f32 (-0.0 below +0.0, as
    XLA compares), the LOWER index first among ties (``torch.topk``
    promises no tie order).  Each score becomes its order-preserving
    integer, combined with its reversed index into one unique int64 key,
    whose top-k is that order."""
    N = scores.shape[-1]
    bits = scores.view(torch.int32).to(torch.int64)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    rev = N - 1 - torch.arange(N, dtype=torch.int64, device=scores.device)
    return torch.topk(key * N + rev, k, dim=-1).indices


def _jitter_scale(N: int) -> Tensor:
    """``(-1e-4 / N)`` — a Python float the reference rounds to f32."""
    return torch.tensor(-1e-4 / N, dtype=torch.float32)


@dataclasses.dataclass
class UniformTopo:
    """K3's topology inputs.  ``dom_caps_y``/``order`` (the required
    level's pick, one chunk's tables) and ``pref_level`` (the preferred
    band) are each optional."""

    topology: Tensor                    # i32 [N, L]
    #: gang-level required level (subgroup slot 0) per gang — i32 [G]
    srl0: Tensor | None = None
    dom_caps_y: Tensor | None = None    # i32 [Y, ND] live replica caps
    level_of_dom: Tensor | None = None  # i32 [ND]
    order: Tensor | None = None         # i32 [ND] :func:`order_by_agg`
    pref_level: Tensor | None = None    # i32 [G]

    @property
    def required(self) -> bool:
        return self.dom_caps_y is not None

    @property
    def preferred(self) -> bool:
        return self.pref_level is not None


def uniform_fill_plain(cand: Tensor, prior: Tensor, quota_b: Tensor,
                       qa: Tensor, qan: Tensor, limit_eff: Tensor,
                       quota_eff: Tensor, chain: Tensor, lt: LaneTables,
                       tables, soft_scores: Tensor, valid: Tensor, *,
                       dense: bool, stride: int, hoisted: bool,
                       rows: Tensor | None = None,
                       score_bias: Tensor | None = None,
                       topo: UniformTopo | None = None,
                       free: Tensor | None = None):
    """Plain PyTorch version of K3, batched over the B lanes.

    ``cand`` i32 [B] gang per lane (already clamped to a real row),
    ``prior`` i32 [B, T] earlier attempts' nodes, ``quota_b`` i32 [B]
    replicas this attempt may add; ``tables`` are K2's outputs.  Returns
    ``(qa2 [B,Q,R], qan2 [B,Q,R], nodes_t i32 [B,T], pipe_t bool [B,T],
    success bool [B])`` — the reference's ``sparse_out`` tuple.

    ``hoisted`` selects the reference's f32 order of the score bands:
    with per-chunk type tables ``((bands + soft) + jitter)``, without
    (``Yu > B``) ``(bands + (jitter + soft))``.

    ``valid`` is the nodes every lane may use, bool [N], or each lane's
    own, [B, N] (the mask mode: the affinity gates' node mask, K12, ANDed
    into the fits after the hoisted type tables, ref ``:1010-1011``,
    ``:1020-1021``).

    The victim wavefront's lanes add three things: ``qa`` may be one
    table per lane, [B, Q, R] (each lane's queue allocation net of its
    own victims); ``rows`` i32 [B] names each lane's row of the tables
    (instead of its gang's task type); ``score_bias`` f32 [B, N] joins
    the bands last — ``((bands + soft) + jitter) + bias`` hoisted,
    ``bands + ((jitter + soft) + bias)`` not.

    The topology modes (``topo``; ref ``:1030-1092`` with the chunk's
    hoisted tables, and ``:1135-1139``): a lane whose gang requires a
    level picks ONE domain whose live replica capacity holds its whole
    chunk — the ``(lane mod n_fit)``-th fitting domain fullest first, or
    the domain its earlier placements locked — and is confined to it (no
    domain: the gang fails); a lane whose gang prefers a level adds
    ``W_TOPOLOGY`` on the nodes sharing the preferred domain of its
    best-scoring node before the top-k.  With ``free`` [N, R] the lanes
    also return the dense protocol's rows (ref ``:1177-1180``): per task
    slot, ``free - count * req`` and ``min(count, c_idle) * req`` of the
    node it took, ``count`` the lane's replicas there — f32 [B, T, R]
    each, zero where the slot placed nothing."""
    fi_y, fp_y, ci_y, cp_y, sc_y = tables
    B, T = prior.shape
    N = valid.shape[-1]
    dev = prior.device
    i32 = torch.int32
    gi = cand.long()
    req = lt.task_req0[gi]                                   # [B, R]
    tv = lt.task_valid[gi]                                   # [B, T]
    tcount = tv.sum(-1, dtype=i32)
    anc = chain[lt.queue[gi].long()]                         # [B, Q]
    nonpre = ~lt.preemptible[gi]
    opn = lt.anti_self[gi] >= 0
    already = prior >= 0
    unplaced = tcount - already.sum(-1, dtype=i32)
    goal = torch.minimum(quota_b, unplaced)
    prior_on_node = torch.zeros((B, N), dtype=i32, device=dev).scatter_add_(
        1, torch.clamp(prior, min=0).long(), already.to(i32)) > 0

    # ---- queue capacity gate: max replicas within every ancestor cap ----
    req_pos = req > EPS

    def max_copies(used, cap):
        room = cap - used
        if room.dim() == 2:
            room = room[None]
        head = torch.where(
            req_pos[:, None, :],
            room / torch.clamp(req, min=EPS)[:, None, :],
            _INF)                                            # [B, Q, R]
        head = torch.where(anc[:, :, None], head, _INF)
        m = torch.floor(head + EPS).flatten(1).amin(1)
        return torch.clamp(m, 0.0, 1e9).to(i32)

    m_gate = max_copies(qa, limit_eff)
    m_gate = torch.where(nonpre, torch.minimum(m_gate,
                                               max_copies(qan, quota_eff)),
                         m_gate)

    def lane_clamp(c, mask):
        c = torch.where(mask, c, 0)
        c = torch.where(opn[:, None] & prior_on_node, 0, c)
        return torch.where(opn[:, None], torch.clamp(c, max=1), c)

    ty = (lt.task_type0[gi] if rows is None else rows).long()
    fit_idle = fi_y[ty] & valid
    fit_pipe = fp_y[ty] & valid
    c_pipe = lane_clamp(cp_y[ty], fit_pipe)                  # [B, N]
    lanes = torch.arange(B, dtype=i32, device=dev)
    if topo is not None and topo.required:
        in_dom = _uniform_domain(topo, gi, lt.task_type0[gi].long(), prior,
                                 already, torch.minimum(goal, m_gate), lanes)
        fit_idle = fit_idle & in_dom
        fit_pipe = fit_pipe & in_dom
        c_pipe = torch.where(in_dom, c_pipe, 0)
    c_idle = torch.minimum(lane_clamp(ci_y[ty], fit_idle), c_pipe)

    if dense:
        offs = torch.arange(N, dtype=i32, device=dev)[None] \
            - lanes[:, None] * stride
    else:
        rank_feas = torch.cumsum(fit_pipe.to(i32), -1, dtype=i32) - 1
        offs = rank_feas - lanes[:, None]
    jitter = _jitter_scale(N).to(dev) * torch.remainder(offs, N).to(
        torch.float32)
    soft = soft_scores[lt.task_class0[gi].long()]
    bands = sc_y[ty]
    if hoisted:
        base = (bands + soft) + jitter
        if score_bias is not None:
            base = base + score_bias
    else:
        extra_bands = jitter + soft
        if score_bias is not None:
            extra_bands = extra_bands + score_bias
        base = bands + extra_bands
    scores = torch.where(fit_pipe, base, BIG_NEG)
    if topo is not None and topo.preferred:
        # preferred-level locality band anchored at the best node (the
        # first maximum, as jnp.argmax)
        pl = topo.pref_level[gi]
        pref_doms = topo.topology.t()[torch.clamp(pl, min=0).long()]
        best = scores.argmax(-1, keepdim=True)
        band = torch.where((pl >= 0)[:, None]
                           & (pref_doms == pref_doms.gather(1, best)),
                           W_TOPOLOGY, 0.0)
        scores = torch.where(fit_pipe, scores + band, scores)

    # ---- greedy fill by score order (lax.top_k: value desc, lower index
    # first among ties == a stable descending sort's prefix) ------------
    k = min(T, N)
    order = topk_lax_order(scores, k)                        # [B, k]
    feas_sorted = fit_pipe.gather(1, order)
    c_sorted = torch.where(feas_sorted, c_pipe.gather(1, order), 0)
    want = torch.minimum(goal, m_gate)
    cum = torch.cumsum(c_sorted, -1, dtype=i32)
    placed_sorted = torch.minimum(
        torch.clamp(want[:, None] - (cum - c_sorted), min=0), c_sorted)
    total_placed = torch.minimum(cum[:, -1], want)
    placed_per_node = torch.zeros((B, N), dtype=i32, device=dev).scatter_add_(
        1, order, placed_sorted)

    # new placements take their nodes in ASCENDING NODE ORDER
    cum_n = torch.cumsum(placed_per_node, -1, dtype=i32)
    elig = tv & ~already
    elig_rank = torch.cumsum(elig.to(i32), -1, dtype=i32) - 1
    npos = torch.where(elig, elig_rank, T).to(i32)
    nidx = torch.clamp(torch.searchsorted(cum_n, npos, right=True),
                       max=N - 1)                            # [B, T]
    placed_t = elig & (npos < total_placed[:, None])
    nodes_t = torch.where(placed_t, nidx.to(i32), -1)
    rank_in_node = npos - (cum_n.gather(1, nidx)
                           - placed_per_node.gather(1, nidx))
    pipe_t = placed_t & (rank_in_node >= c_idle.gather(1, nidx))
    q_delta = total_placed.to(torch.float32)[:, None] * req  # [B, R]
    anc_d = anc.to(torch.float32)[:, :, None] * q_delta[:, None, :]
    qa2 = (qa if qa.dim() == 3 else qa[None]) + anc_d
    qan2 = qan[None] + torch.where(nonpre[:, None, None], anc_d, 0.0)
    success = (goal > 0) & (total_placed >= goal)
    if free is None:
        return qa2, qan2, nodes_t, pipe_t, success
    at = torch.clamp(nodes_t, min=0).long()
    cnt = placed_per_node.gather(1, at).to(torch.float32)[..., None]
    bcnt = torch.minimum(placed_per_node, c_idle).gather(1, at).to(
        torch.float32)[..., None]
    hit = placed_t[..., None]
    free_rows = torch.where(hit, free[at] - cnt * req[:, None, :], 0.0)
    bind_rows = torch.where(hit, bcnt * req[:, None, :], 0.0)
    return qa2, qan2, nodes_t, pipe_t, success, free_rows, bind_rows


def _uniform_domain(topo: UniformTopo, gi: Tensor, ty: Tensor, prior: Tensor,
                    already: Tensor, want0: Tensor, lanes: Tensor) -> Tensor:
    """bool [B, N]: each lane's confinement to its required domain (ref
    ``:1036-1089``, the hoisted-table branch); every node where the gang
    has no required level."""
    L = topo.topology.shape[1]
    srl0 = topo.srl0[gi]                                     # [B]
    dom_col = topo.topology.t()[torch.clamp(srl0, 0, L - 1).long()]
    dom_caps = topo.dom_caps_y[ty]                           # [B, ND]
    fits = ((dom_caps >= torch.clamp(want0, min=1)[:, None])
            & (topo.level_of_dom[None] == srl0[:, None]))
    order = topo.order.long()
    fs = fits[:, order]                                      # fullest first
    n_fit = fs.sum(-1, dtype=torch.int32)
    sel = torch.remainder(lanes, torch.clamp(n_fit, min=1)) + 1
    hit = fs & (torch.cumsum(fs.to(torch.int32), -1, dtype=torch.int32)
                == sel[:, None])
    pos = hit.to(torch.int32).argmax(-1)                     # first hit
    target = torch.where(n_fit > 0, order[pos].to(torch.int32), -1)
    first = already.to(torch.int32).argmax(-1, keepdim=True)
    prior_dom = torch.where(
        already.any(-1),
        dom_col.gather(1, torch.clamp(prior.gather(1, first),
                                      min=0).long())[:, 0], -1)
    target = torch.where(prior_dom >= 0, prior_dom, target)
    # no fitting domain fails the gang: nodes without the level's label
    # (dom_col -1) must not match target -1
    return ~(srl0 >= 0)[:, None] | ((target >= 0)[:, None]
                                     & (dom_col == target[:, None]))


#: most task slots per gang the K3 kernel's per-thread top-k holds
MAX_TOPK = 64


def uniform_fill_limits(T: int, N: int) -> None:
    """Raise ``NotImplementedError`` naming the limit K3's kernel does not
    take: a top-k of ``min(T, N)`` above ``MAX_TOPK``."""
    if min(T, N) > MAX_TOPK:
        raise NotImplementedError(
            f"uniform_fill: a top-k of {min(T, N)} exceeds the kernel's "
            f"MAX_TOPK={MAX_TOPK}")


def uniform_fill(cand: Tensor, prior: Tensor, quota_b: Tensor, qa: Tensor,
                 qan: Tensor, limit_eff: Tensor, quota_eff: Tensor,
                 chain: Tensor, lt: LaneTables, tables,
                 soft_scores: Tensor, valid: Tensor, *, dense: bool,
                 stride: int, hoisted: bool, rows: Tensor | None = None,
                 score_bias: Tensor | None = None,
                 topo: UniformTopo | None = None,
                 free: Tensor | None = None):
    """K3 — every lane's whole-gang placement (see
    :func:`uniform_fill_plain` for the contract).  CPU tensors run the
    plain version; CUDA tensors launch one block per lane or raise.  A
    [B, N] ``valid`` runs the mask mode (each block reads its lane's
    row)."""
    if not kernels.on_card(prior):
        return uniform_fill_plain(cand, prior, quota_b, qa, qan, limit_eff,
                                  quota_eff, chain, lt, tables, soft_scores,
                                  valid, dense=dense, stride=stride,
                                  hoisted=hoisted, rows=rows,
                                  score_bias=score_bias, topo=topo, free=free)
    fi_y, fp_y, ci_y, cp_y, sc_y = tables
    B, T = prior.shape
    Q, R_ = qan.shape
    qa_lanes = qa.dim() == 3
    if qa.shape != ((B, Q, R_) if qa_lanes else (Q, R_)):
        raise ValueError("uniform_fill: qa must be [Q, R] or [B, Q, R]")
    Y, N = fp_y.shape
    G = lt.queue.shape[0]
    X = soft_scores.shape[0]
    uniform_fill_limits(T, N)
    if R_ != 3:
        raise ValueError("uniform_fill: resource axis must be 3")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    ts = dict(cand=cand, prior=prior, quota_b=quota_b, qa=qa, qan=qan,
              limit_eff=limit_eff, quota_eff=quota_eff, chain=chain,
              task_req0=lt.task_req0, task_valid=lt.task_valid,
              queue=lt.queue, preemptible=lt.preemptible,
              anti_self=lt.anti_self, task_type0=lt.task_type0,
              task_class0=lt.task_class0, fi=fi_y, fp=fp_y, ci=ci_y,
              cp=cp_y, sc=sc_y, soft=soft_scores, valid=valid)
    tp = topo or UniformTopo(topology=None)
    opt = dict(rows=rows, score_bias=score_bias, topology=tp.topology,
               srl0=tp.srl0, dom_caps_y=tp.dom_caps_y,
               level_of_dom=tp.level_of_dom, order=tp.order,
               pref_level=tp.pref_level, free=free)
    dev = kernels.require_cuda("uniform_fill", dict(
        ts, **{k: v for k, v in opt.items() if v is not None}), dict(
        cand=i32, prior=i32, quota_b=i32, qa=f32, qan=f32, limit_eff=f32,
        quota_eff=f32, chain=b, task_req0=f32, task_valid=b, queue=i32,
        preemptible=b, anti_self=i32, task_type0=i32, task_class0=i32,
        fi=b, fp=b, ci=i32, cp=i32, sc=f32, soft=f32, valid=b, rows=i32,
        score_bias=f32, topology=i32, srl0=i32, dom_caps_y=i32,
        level_of_dom=i32, order=i32, pref_level=i32, free=f32))
    if rows is not None and rows.shape != (B,):
        raise ValueError("uniform_fill: rows must be [B]")
    if score_bias is not None and score_bias.shape != (B, N):
        raise ValueError("uniform_fill: score_bias must be [B, N]")
    masked = valid.dim() == 2
    if valid.shape != ((B, N) if masked else (N,)):
        raise ValueError("uniform_fill: valid must be [N] or [B, N]")
    L = 0 if tp.topology is None else tp.topology.shape[1]
    if tp.required and (tp.srl0 is None or tp.dom_caps_y.shape[1] != N * L):
        raise ValueError("uniform_fill: the required level needs srl0 and "
                         "[Y, N * L] domain caps")
    qa2 = torch.empty((B, Q, R_), dtype=f32, device=dev)
    qan2 = torch.empty((B, Q, R_), dtype=f32, device=dev)
    nodes_t = torch.empty((B, T), dtype=i32, device=dev)
    pipe_t = torch.empty((B, T), dtype=b, device=dev)
    success = torch.empty((B,), dtype=b, device=dev)
    outs = [qa2, qan2, nodes_t, pipe_t, success]
    if free is not None:
        outs += [torch.empty((B, T, R_), dtype=f32, device=dev)
                 for _ in range(2)]
    lib = kernels.library()
    rc = lib.kai_uniform_fill(
        *(kernels.ptr(t) for t in ts.values()),
        *(None if v is None else kernels.ptr(v) for v in opt.values()),
        B, T, N, Q, Y, G, X, L, int(dense), int(stride), int(hoisted),
        int(qa_lanes), int(masked), float(_jitter_scale(N)),
        *(kernels.ptr(t) for t in outs[:5]),
        *(kernels.ptr(t) for t in outs[5:]), *([None, None] * (free is None)),
        kernels.stream_of(prior))
    kernels.check(rc, "uniform_fill")
    kernels.count_launch("uniform_fill", lanes=qa_lanes,
                         topology=tp.required,
                         preferred=tp.pref_level is not None, mask=masked)
    return tuple(outs)


# ---------------------------------------------------------------------------
# K4: the sparse accept prefix
# ---------------------------------------------------------------------------

def sparse_entry_tables(nodes_b: Tensor, ent_ok: Tensor, N: int):
    """Node-sorted view of a chunk's K = B*T placement entries (ref
    ``:283``): entries are generated lane-major and sorted STABLY by node,
    so within a node they stay in lane order.  Returns (node_e [K] with
    ``N`` as junk, lane_e [K], perm [K], ns [K], lane_s [K], sidx [K] the
    sorted position of each entry's node-segment start, ok_s [K])."""
    B, T = nodes_b.shape
    node_e = torch.where(ent_ok, nodes_b, N).reshape(-1)
    lane_e = torch.arange(B, dtype=torch.int32,
                          device=nodes_b.device).repeat_interleave(T)
    perm = torch.sort(node_e, stable=True).indices
    ns = node_e[perm]
    first = torch.ones_like(ns, dtype=torch.bool)
    first[1:] = ns[1:] != ns[:-1]
    ar = torch.arange(ns.shape[0], device=ns.device)
    sidx = torch.cummax(torch.where(first, ar, -1), 0).values
    return node_e, lane_e, perm, ns, lane_e[perm], sidx, \
        ent_ok.reshape(-1)[perm]


def sparse_accept_plain(nodes_b: Tensor, ent_ok: Tensor, pipe_b: Tensor,
                        req_b: Tensor, free: Tensor, pipe_pool: Tensor,
                        N: int, credit: Tensor | None = None):
    """Plain PyTorch version of K4 (ref ``sparse_accept_first_bad``):
    each entry's node-cumulative claim must fit ``pipe_pool`` (plus the
    entry's ``credit`` [K, R], lane-major like the entries, when given:
    the victim wavefront's lane-prefix freed capacity at the claim's
    node, compared as ``(pipe_pool + credit) + EPS``) and the bind-now
    subset must fit the idle pool.  Returns (first_bad i32 [] — B when
    every claim fits, node_e i32 [K], lane_e i32 [K]).

    The claims are whole-unit requests in the snapshots this path runs,
    so the f32 prefix sums are exact whatever their order."""
    B = nodes_b.shape[0]
    node_e, lane_e, perm, ns, lane_s, sidx, ok_s = \
        sparse_entry_tables(nodes_b, ent_ok, N)
    lsl = lane_s.long()
    req_s = torch.where(ok_s[:, None], req_b[lsl], 0.0)     # [K, R]
    cs = torch.cumsum(req_s, 0)
    cum_e = cs - (cs - req_s)[sidx]
    nsafe = torch.clamp(ns, max=N - 1).long()
    real = ns < N
    cap_pipe = pipe_pool[nsafe]
    if credit is not None:
        cap_pipe = cap_pipe + credit[perm]
    viol = (cum_e > cap_pipe + EPS).any(-1) & real
    bind_e = (ent_ok & ~pipe_b).reshape(-1)[perm]
    reqb_s = torch.where(bind_e[:, None], req_b[lsl], 0.0)
    csb = torch.cumsum(reqb_s, 0)
    cumb_e = csb - (csb - reqb_s)[sidx]
    cap_bind = torch.clamp(free, min=0.0)[nsafe] + EPS
    viol = viol | ((cumb_e > cap_bind).any(-1) & real)
    first_bad = torch.where(viol, lane_s, B).amin().to(torch.int32)
    return first_bad, node_e.to(torch.int32), lane_e


#: claim entries (B*T, padded to a power of two) K4 keeps in shared
#: memory; larger chunks get a global scratch buffer of 32 bytes each
SMEM_ENTRIES = 4096


def sparse_accept(nodes_b: Tensor, ent_ok: Tensor, pipe_b: Tensor,
                  req_b: Tensor, free: Tensor, pipe_pool: Tensor, N: int,
                  credit: Tensor | None = None):
    """K4 — the first lane whose claims over-subscribe a node (see
    :func:`sparse_accept_plain`).  CPU tensors run the plain version;
    CUDA tensors launch one block or raise."""
    if not kernels.on_card(nodes_b):
        return sparse_accept_plain(nodes_b, ent_ok, pipe_b, req_b, free,
                                   pipe_pool, N, credit)
    B, T = nodes_b.shape
    R_ = req_b.shape[1]
    K = B * T
    if R_ != 3 or free.shape != (N, R_) or pipe_pool.shape != (N, R_):
        raise ValueError("sparse_accept: pools must be [N, 3]")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    ts = dict(nodes_b=nodes_b, ent_ok=ent_ok, pipe_b=pipe_b, req_b=req_b,
              free=free, pipe_pool=pipe_pool)
    if credit is not None:
        if credit.shape != (K, R_):
            raise ValueError("sparse_accept: credit must be [B*T, 3]")
        ts["credit"] = credit
    dev = kernels.require_cuda("sparse_accept", ts, dict(
        nodes_b=i32, ent_ok=b, pipe_b=b, req_b=f32, free=f32,
        pipe_pool=f32, credit=f32))
    first_bad = torch.empty((), dtype=i32, device=dev)
    node_e = torch.empty((K,), dtype=i32, device=dev)
    lane_e = torch.empty((K,), dtype=i32, device=dev)
    Kp = 1 << max(1, (K - 1).bit_length())
    scratch = (torch.empty((Kp * 32,), dtype=torch.uint8, device=dev)
               if Kp > SMEM_ENTRIES else None)
    lib = kernels.library()
    rc = lib.kai_sparse_accept(
        *(kernels.ptr(ts[k]) for k in ("nodes_b", "ent_ok", "pipe_b",
                                       "req_b", "free", "pipe_pool")),
        None if credit is None else kernels.ptr(credit), B, T, N, R_,
        None if scratch is None else kernels.ptr(scratch),
        kernels.ptr(first_bad), kernels.ptr(node_e), kernels.ptr(lane_e),
        kernels.stream_of(nodes_b))
    kernels.check(rc, "sparse_accept")
    kernels.count_launch("sparse_accept", credit=credit is not None)
    return first_bad, node_e, lane_e


# ---------------------------------------------------------------------------
# K9: the per-task fill, one lane per gang attempt
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TaskTables:
    """Gang-side inputs of the per-task fill, one row per gang (the
    lanes read their gang's row)."""

    task_req: Tensor           # f32 [G, T, R]
    task_valid: Tensor         # bool [G, T]
    task_selector: Tensor      # i32 [G, T, K]
    task_portion: Tensor       # f32 [G, T]
    task_accel_mem: Tensor     # f32 [G, T]
    task_class: Tensor         # i32 [G, T]
    task_nominated: Tensor     # i32 [G, T]
    task_subgroup: Tensor      # i32 [G, T]
    subgroup_min_needed: Tensor  # i32 [G, S]
    min_needed: Tensor         # i32 [G]
    queue: Tensor              # i32 [G]
    preemptible: Tensor        # bool [G]
    anti_self: Tensor          # i32 [G]
    preferred_level: Tensor    # i32 [G]
    subgroup_required_level: Tensor  # i32 [G, S]

    @classmethod
    def of(cls, state: ClusterState) -> "TaskTables":
        g = state.gangs
        return cls(**{k: v.contiguous() for k, v in dict(
            task_req=g.task_req, task_valid=g.task_valid,
            task_selector=g.task_selector, task_portion=g.task_portion,
            task_accel_mem=g.task_accel_mem,
            task_class=g.task_filter_class,
            task_nominated=g.task_nominated,
            task_subgroup=g.task_subgroup,
            subgroup_min_needed=g.subgroup_min_needed,
            min_needed=g.min_needed, queue=g.queue,
            preemptible=g.preemptible, anti_self=g.anti_self_level,
            preferred_level=g.preferred_level,
            subgroup_required_level=g.subgroup_required_level).items()})


@dataclasses.dataclass
class PerTaskOut:
    """What every lane of the per-task fill returns.  The pools come as
    the lane's FINAL rows at the nodes it placed on (row ``t`` belongs to
    ``nodes_t[:, t]``; zeros where that task was not placed): a lane
    touches at most T nodes, and the accept needs ``free - free2`` (ref
    ``:1731``), which is not the sum of the task deltas in f32."""

    qa2: Tensor            # f32 [B, Q, R]
    qan2: Tensor           # f32 [B, Q, R]
    nodes_t: Tensor        # i32 [B, T]
    dev_t: Tensor          # i32 [B, T]  device of a fractional task
    pipe_t: Tensor         # bool [B, T]
    success: Tensor        # bool [B]
    free_rows: Tensor      # f32 [B, T, R]
    dev_rows: Tensor       # f32 [B, T, D]
    bind_rows: Tensor      # f32 [B, T, R]  bind-now claims
    devbind_rows: Tensor   # f32 [B, T, D]
    #: the subgroups' locked domains (subgroup-topology mode) — i32 [B, S]
    sub_dom: Tensor | None = None

    def fields(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)
                     if getattr(self, f.name) is not None)


def _device_rows(nodes: NodeState, dev: Tensor, extra_dev: Tensor,
                 dev_l: Tensor, ix: Tensor, nodes_t: Tensor, t: int,
                 req0: Tensor, por: Tensor, mem: Tensor):
    """The device table's part of task ``t``'s step for the active lanes
    ``ix``, [k, N] each: the pool tests on idle and on idle+releasing share
    (``_accel_pool_ok``), the gpusharingorder band and the node portion.
    They are computed once per distinct (portion, memory, request) against
    the chunk-start device pool and patched at the nodes each lane already
    took this attempt (its live rows): the per-lane values, without a
    [k, N, D] pass."""
    key = torch.stack([por, mem, req0], -1)
    uk, inv = torch.unique(key, dim=0, return_inverse=True)
    u_frac = (uk[:, 0] > 0) | (uk[:, 1] > 0)
    p_u = node_portion(nodes, uk[:, 0], uk[:, 1])            # [U, N]
    dev_pipe = (dev + nodes.device_releasing) + extra_dev
    ok_idle = _accel_pool_ok(dev, p_u, u_frac, uk[:, 2])[inv]
    ok_pipe = _accel_pool_ok(dev_pipe, p_u, u_frac, uk[:, 2])[inv]
    gsh = gpu_sharing_score(dev, p_u, u_frac)[inv]
    portion_n = p_u[inv]
    j, s = torch.nonzero(nodes_t[ix, :t] >= 0, as_tuple=True)
    if j.numel():
        # one extra node axis of size 1 keeps the tensor functions' shapes
        pn = nodes_t[ix[j], s].long()
        live = dev_l[ix[j], pn][:, None]                     # [P, 1, D]
        live_pipe = ((live + nodes.device_releasing[pn][:, None])
                     + extra_dev[pn][:, None])
        p_live = portion_n[j, pn][:, None]
        frac = (por[j] > 0) | (mem[j] > 0)
        ok_idle[j, pn] = _accel_pool_ok(live, p_live, frac, req0[j])[:, 0]
        ok_pipe[j, pn] = _accel_pool_ok(live_pipe, p_live, frac,
                                        req0[j])[:, 0]
        gsh[j, pn] = gpu_sharing_score(live, p_live, frac)[:, 0]
    return ok_idle, ok_pipe, gsh, portion_n


def attempt_gang_in_domain_plain(
        nodes: NodeState, tt: TaskTables, cand: Tensor, prior: Tensor,
        free: Tensor, dev: Tensor, qa: Tensor, qan: Tensor, extra: Tensor,
        extra_dev: Tensor, chain: Tensor, limit_eff: Tensor,
        quota_eff: Tensor, *, placement: PlacementConfig,
        track_devices: bool, topo: TopoStatic | None = None,
        banned: Tensor | None = None,
        lane_ids: Tensor | None = None,
        mask: Tensor | None = None) -> PerTaskOut:
    """Plain PyTorch version of K9: the reference's
    ``_attempt_gang_in_domain`` (``:517``) for every lane ``b`` of a chunk
    (gang ``cand[b]``, tie-break lane ``b``, prior placements ``prior[b]``),
    against the chunk-start pools — the re-push protocol's subgroup quorum
    and eligible set, the hoisted queue prefix gates, anti-self domains,
    the nominated-node, soft, preferred-topology and tie-jitter bands,
    the gpusharingorder band, ``pick_device`` for fractions, the
    whole-device rank-and-take and the bind-now / pipelined bookkeeping.
    The extended branch stays out (``allocate`` refuses it).  Batched
    over the B lanes; T task steps in order.

    ``topo`` turns on the subgroup-topology mode (ref ``:650-668``,
    ``:734-760``, ``:855-866``, ``:878-882``): the domain aggregate of
    the chunk-start pools, summed per domain in node order, kept live per
    lane; the subgroups' domain locks, seeded from prior placements; the
    remaining-chunk gate and the domain-binpack band on a subgroup's first
    placement; and the ``sub_dom`` output.  ``banned`` i32 [B, S] bars
    each lane's subgroups from one domain (the in-cycle retry);
    ``lane_ids`` i32 [B] gives each lane its tie-break lane (default: its
    row); and ``mask`` bool [B, N] confines each lane to its own nodes
    (the mask mode: the affinity gates' node mask, K12; ref ``allowed =
    domain_mask & ~forbidden`` ``:720`` with ``domain_mask = n.valid &
    mask`` ``:1259``)."""
    B, T = prior.shape
    N, R_ = free.shape
    D = dev.shape[1]
    L = nodes.topology.shape[1]
    dv = free.device
    i32, f32 = torch.int32, torch.float32
    gi = cand.long()
    arB = torch.arange(B, device=dv)
    ar_n = torch.arange(N, dtype=i32, device=dv)
    task_req = tt.task_req[gi]                               # [B, T, R]
    task_valid = tt.task_valid[gi]
    task_sel = tt.task_selector[gi]
    portion = tt.task_portion[gi]
    mem = tt.task_accel_mem[gi]
    tclass = tt.task_class[gi]
    tnom = tt.task_nominated[gi]
    nonpre = ~tt.preemptible[gi]
    topo_t = nodes.topology.t()                              # [L, N]
    # gang-internal anti-affinity: no two tasks in one domain at the level
    asl = tt.anti_self[gi]
    has_asl = asl >= 0
    doms_self = torch.where((asl >= L)[:, None], ar_n[None],
                            topo_t[torch.clamp(asl, 0, L - 1).long()])
    already = prior >= 0
    unplaced_t = task_valid & ~already
    forbidden = torch.zeros((B, N), dtype=torch.bool, device=dv)
    if bool((has_asl[:, None] & already).any()):
        prior_doms = doms_self.gather(1, torch.clamp(prior, min=0).long())
        forbidden = has_asl[:, None] & (
            (doms_self[:, :, None] == prior_doms[:, None, :])
            & already[:, None, :]).any(-1)                   # [B, N]
    pl = tt.preferred_level[gi]
    has_pref = pl >= 0
    pref_doms = topo_t[torch.clamp(pl, min=0).long()]        # [B, N]
    first_prior = already.to(i32).argmax(-1, keepdim=True)
    pref_dom = torch.where(
        already.any(-1),
        pref_doms.gather(1, torch.clamp(prior.gather(1, first_prior),
                                        min=0).long())[:, 0], -1)

    # subgroup quorum: while any subgroup is below quorum the eligible set
    # is the union of per-subgroup quorum chunks (+ extra tasks for a gang
    # minMember above their sum); once quorate, one scale-up task
    sub = tt.task_subgroup[gi].long()
    S = tt.subgroup_min_needed.shape[1]
    n_already = already.sum(-1, dtype=i32)
    already_s = torch.zeros((B, S), dtype=i32, device=dv).scatter_add_(
        1, sub, already.to(i32))
    deficit = torch.clamp(tt.subgroup_min_needed[gi] - already_s, min=0)
    min_needed = tt.min_needed[gi]
    in_quorum = (deficit > 0).any(-1) | (n_already < min_needed)
    ar_t = torch.arange(T, device=dv)
    earlier_same = ((sub[:, None, :] == sub[:, :, None])
                    & (ar_t[None, :] < ar_t[:, None])[None])
    rank_in_sub = (earlier_same & unplaced_t[:, None, :]).sum(-1, dtype=i32)
    elig_quorum = unplaced_t & (rank_in_sub < deficit.gather(1, sub))
    extra_needed = torch.clamp(
        min_needed - n_already - deficit.sum(-1, dtype=i32), min=0)
    rest = unplaced_t & ~elig_quorum
    rank_rest = torch.cumsum(rest.to(i32), -1, dtype=i32) - 1
    elig_quorum = elig_quorum | (rest & (rank_rest < extra_needed[:, None]))
    first_unplaced = unplaced_t & (
        torch.cumsum(unplaced_t.to(i32), -1, dtype=i32) - 1 < 1)
    eligible = torch.where(in_quorum[:, None], elig_quorum, first_unplaced)
    goal = eligible.sum(-1, dtype=i32)
    if topo is not None:
        # the remaining request of each subgroup's chunk, summed in task
        # order from +0.0 (the reference's segment_sum)
        sub_rem = torch.zeros((B, S, R_), dtype=f32, device=dv)
        for t in range(T):
            sub_rem[arB, sub[:, t]] = sub_rem[arB, sub[:, t]] + torch.where(
                eligible[:, t, None], task_req[:, t], 0.0)
        # the domains' aggregate of the chunk-start pools (every lane
        # starts from the same one), per domain in ascending node order
        ND = N * L
        avail0 = torch.where(nodes.valid[:, None],
                             (free + nodes.releasing) + extra, 0.0)
        agg0 = torch.zeros((ND + 1, R_), dtype=f32, device=dv)
        for lvl in range(L):
            agg0.index_add_(0, topo.dom_of[lvl].long(), avail0)
        agg = agg0.expand(B, ND + 1, R_).clone()
        srl = tt.subgroup_required_level[gi]                 # [B, S]
        prior_level = srl.gather(1, sub)                     # [B, T]
        prior_sub_dom = nodes.topology[
            torch.clamp(prior, min=0).long(),
            torch.clamp(prior_level, 0, L - 1).long()]
        sub_dom = torch.full((B, S), -1, dtype=i32, device=dv).scatter_reduce(
            1, sub, torch.where(already & (prior_level >= 0), prior_sub_dom,
                                -1).to(i32), reduce="amax")

    # queue capacity gates for every task prefix, hoisted out of the loop
    anc = chain[tt.queue[gi].long()]                         # [B, Q]
    req_valid = torch.where(eligible[..., None], task_req, 0.0)
    cum_req = cumsum_blocked(req_valid, 1)                   # [B, T, R]
    exempt = ~anc[:, None, :, None]
    gate_lim = ((qa + cum_req[:, :, None, :] <= limit_eff + EPS)
                | exempt).flatten(2).all(-1)                 # [B, T]
    gate_quota = ((qan + cum_req[:, :, None, :] <= quota_eff + EPS)
                  | exempt).flatten(2).all(-1)
    gate_t = gate_lim & torch.where(nonpre[:, None], gate_quota, True)

    free_l = free.expand(B, N, R_).clone()
    dev_l = dev.expand(B, N, D).clone()
    bind = torch.zeros_like(free_l)
    dbind = torch.zeros_like(dev_l)
    nodes_t = torch.full((B, T), -1, dtype=i32, device=dv)
    dev_t = torch.full((B, T), -1, dtype=i32, device=dv)
    pipe_t = torch.zeros((B, T), dtype=torch.bool, device=dv)
    count = torch.zeros((B,), dtype=i32, device=dv)
    q_delta = torch.zeros((B, R_), dtype=f32, device=dv)
    jitter_scale = _jitter_scale(N).to(dv)
    lanes = (torch.arange(B, dtype=i32, device=dv) if lane_ids is None
             else lane_ids)
    ar_d = torch.arange(D, device=dv)
    for t in range(T):
        # a lane whose task t is not eligible or fails its queue gate
        # changes nothing this step (placed is False), so the step runs on
        # the active lanes only
        ix = torch.nonzero(eligible[:, t] & gate_t[:, t]).flatten()
        if ix.numel() == 0:
            continue
        k_ = ix.numel()
        arK = torch.arange(k_, device=dv)
        req = task_req[ix, t]
        por, me = portion[ix, t], mem[ix, t]
        cls = tclass[ix, t]
        is_frac = (por > 0) | (me > 0)
        fl = free_l[ix]
        if track_devices:
            # feasible_nodes_dual's device branch, with the device table's
            # share of the work done once per distinct share request
            ok_idle, ok_pipe, gsh, portion_n = _device_rows(
                nodes, dev, extra_dev, dev_l, ix, nodes_t, t, req[:, 0],
                por, me)
            req_nosum = req.clone()
            req_nosum[:, 0] = torch.where(is_frac, 0.0, req[:, 0])
            sel = (selector_mask(nodes.labels, task_sel[ix, t])
                   & nodes.valid) & nodes.filter_masks[cls.long()]
            fit_idle = (resource_fit_mask(fl, req_nosum) & ok_idle) & sel
            fit_pipe = (resource_fit_mask((fl + nodes.releasing) + extra,
                                          req_nosum) & ok_pipe) & sel
        else:
            fit_idle, fit_pipe = feasible_nodes_dual(
                nodes, req, task_sel[ix, t], por, me, free=fl,
                device_free=None, extra_releasing=extra,
                extra_device_releasing=None, devices=False,
                task_class=cls)
        allowed = nodes.valid[None] & ~forbidden[ix]
        if mask is not None:
            allowed = allowed & mask[ix]
        if topo is not None:
            # a subgroup with a required level stays in the domain its
            # first placement locked; that first placement needs a domain
            # whose aggregate still holds the subgroup's remaining chunk,
            # and binpacks among them (fullest fitting domain first)
            s_t = sub[ix, t]
            level_t = srl[ix, s_t]
            has_srl = level_t >= 0
            dom_col = topo_t[torch.clamp(level_t, 0, L - 1).long()]  # [k, N]
            locked = sub_dom[ix, s_t]
            allowed = allowed & ((~has_srl | (locked < 0))[:, None]
                                 | (dom_col == locked[:, None]))
            needs_pick = has_srl & (locked < 0)
            dom_band = torch.zeros((k_, N), dtype=f32, device=dv)
            # the domain gate and band, for the lanes whose subgroup picks
            # its domain at this step (elsewhere both are inert)
            pk = torch.nonzero(needs_pick).flatten()
            if pk.numel():
                dc = dom_col[pk]
                node_agg = agg[ix[pk][:, None], torch.clamp(dc, min=0).long()]
                dom_ok = ((node_agg + EPS >= sub_rem[ix[pk], s_t[pk]][
                    :, None, :]).all(-1) & (dc >= 0))
                if banned is not None:
                    dom_ok = dom_ok & (dc != banned[ix[pk], s_t[pk]][:, None])
                allowed[pk] = allowed[pk] & dom_ok
                agg_accel = node_agg[..., 0]
                mx = torch.where(dom_ok, agg_accel, 0.0).amax(-1)
                dom_band[pk] = torch.where(
                    dom_ok, W_TOPOLOGY * (1.0 - agg_accel / torch.clamp(
                        mx, min=EPS)[:, None]), 0.0)
        fit_idle = fit_idle & allowed
        fit_pipe = fit_pipe & allowed
        # bands in the reference's f32 order: ((((topology + domain) +
        # jitter) + soft) + nominated) + gpusharingorder, then
        # compose_scores' (0 + tiers) + extra; the domain band is zero
        # without subgroup topology
        pd = pref_dom[ix]
        topo_band = torch.where(
            (has_pref[ix] & (pd >= 0))[:, None]
            & (pref_doms[ix] == pd[:, None]), W_TOPOLOGY, 0.0)
        if topo is not None:
            topo_band = topo_band + dom_band
        rank_feas = torch.cumsum(fit_pipe.to(i32), -1, dtype=i32) - 1
        jitter = jitter_scale * torch.remainder(
            rank_feas - lanes[ix, None], N).to(f32)
        extra_bands = (((topo_band + jitter)
                        + nodes.soft_scores[cls.long()])
                       + torch.where(ar_n[None] == tnom[ix, t, None],
                                     W_NOMINATED, 0.0))
        if track_devices:
            extra_bands = extra_bands + gsh
        scores = score_nodes_for_task(nodes, fl, req, fit_idle, fit_pipe,
                                      placement, extra=extra_bands)
        node = scores.argmax(-1)                             # first max
        placed = fit_pipe.any(-1)
        is_pipe = placed & ~fit_idle[arK, node]
        if track_devices:
            dev_row = dev_l[ix, node]                        # [k, D]
            dev_rel_row = (nodes.device_releasing[node]
                           + extra_dev[node])
            p = portion_n[arK, node]
            frac_row = torch.where(is_pipe[:, None], dev_row + dev_rel_row,
                                   dev_row)
            frac_dev = pick_device(frac_row, p,
                                   pack=placement.device_pack)
            k = torch.round(req[:, 0]).to(i32)
            elig_d = dev_row + dev_rel_row >= 1.0 - EPS
            key = torch.where(elig_d, -dev_row, _INF)
            rank = ((key[:, None, :] < key[:, :, None])
                    | ((key[:, None, :] == key[:, :, None])
                       & (ar_d[None, :] < ar_d[:, None]))).sum(-1)
            take_whole = elig_d & (rank < k[:, None])
            dev_delta = torch.where(
                is_frac[:, None],
                p[:, None] * (ar_d[None] == frac_dev[:, None]).to(f32),
                take_whole.to(f32))
            dev_delta = torch.where(placed[:, None], dev_delta, 0.0)
            dev_l[ix, node] = dev_row + (-dev_delta)
            dbind[ix, node] = dbind[ix, node] + torch.where(
                is_pipe[:, None], 0.0, dev_delta)
        else:
            p = req[:, 0]
            frac_dev = torch.full((k_,), -1, dtype=i32, device=dv)
        delta = torch.where(placed[:, None], req, 0.0)
        # the node's accel debit uses its own share (memory-based
        # portions differ per node); the queue debit stays canonical
        delta_node = delta.clone()
        delta_node[:, 0] = torch.where(
            placed, torch.where(is_frac, p, req[:, 0]), 0.0)
        free_l[ix, node] = fl[arK, node] + (-delta_node)
        bind[ix, node] = bind[ix, node] + torch.where(
            is_pipe[:, None], 0.0, delta_node)
        q_delta[ix] = q_delta[ix] + delta
        ds = doms_self[ix]
        forbidden[ix] = forbidden[ix] | ((has_asl[ix] & placed)[:, None] & (
            ds == ds.gather(1, node[:, None])))
        nodes_t[ix, t] = torch.where(placed, node.to(i32), -1)
        dev_t[ix, t] = torch.where(placed & is_frac, frac_dev, -1)
        pipe_t[ix, t] = is_pipe
        count[ix] = count[ix] + placed.to(i32)
        pref_dom[ix] = torch.where(placed & (pd < 0),
                                   pref_doms[ix, node], pd)
        if topo is not None:
            sub_dom[ix, s_t] = torch.where(placed & has_srl & (locked < 0),
                                           dom_col[arK, node], locked)
            sub_rem[ix, s_t] = sub_rem[ix, s_t] + (-delta)
            # the node's domain at every level loses the placement
            for lvl in range(L):
                did = nodes.topology[node, lvl].long()
                did = torch.where(did >= 0, did, N * L)
                agg[ix, did] = agg[ix, did] + (-delta_node)

    ancf = anc.to(f32)[:, :, None] * q_delta[:, None, :]     # [B, Q, R]
    qa2 = qa[None] + ancf
    qan2 = qan[None] + torch.where(nonpre[:, None, None], ancf, 0.0)
    success = (goal > 0) & (count >= goal)
    at = torch.clamp(nodes_t, min=0).long()
    hit = (nodes_t >= 0)[..., None]

    def rows(pool):
        return torch.where(hit, pool[arB[:, None], at], 0.0)
    return PerTaskOut(qa2=qa2, qan2=qan2, nodes_t=nodes_t, dev_t=dev_t,
                      pipe_t=pipe_t, success=success, free_rows=rows(free_l),
                      dev_rows=rows(dev_l), bind_rows=rows(bind),
                      devbind_rows=rows(dbind),
                      sub_dom=None if topo is None else sub_dom)


#: most task slots per gang, devices per node and subgroups per gang K9
#: keeps per lane
PERTASK_MAX_T = 64
PERTASK_MAX_D = 32
PERTASK_MAX_S = 32
#: widest chunk K10 takes: its lane walk reproduces XLA:CPU's blocked
#: cumsum with one level of block totals (up to 16 blocks of 16 lanes)
DENSE_ACCEPT_MAX_B = 256


def pertask_fill_limits(T: int, D: int, S: int,
                        placement: PlacementConfig) -> None:
    """Raise ``NotImplementedError`` naming the limit K9's kernel does not
    take: more than ``PERTASK_MAX_T`` task slots, ``PERTASK_MAX_D``
    devices a node or ``PERTASK_MAX_S`` subgroups, or a plugin tier list
    other than ``DEFAULT_TIERS``."""
    for v, cap, what in ((T, PERTASK_MAX_T, "PERTASK_MAX_T"),
                         (D, PERTASK_MAX_D, "PERTASK_MAX_D"),
                         (S, PERTASK_MAX_S, "PERTASK_MAX_S")):
        if v > cap:
            raise NotImplementedError(
                f"pertask_fill: {v} exceeds the kernel's {what}={cap}")
    _tier_limit("pertask_fill", placement)


def dense_accept_limits(B: int, D: int) -> None:
    """Raise ``NotImplementedError`` naming the limit K10's kernel does not
    take: more than ``DENSE_ACCEPT_MAX_B`` lanes or ``PERTASK_MAX_D``
    devices a node."""
    for v, cap, what in ((B, DENSE_ACCEPT_MAX_B, "DENSE_ACCEPT_MAX_B"),
                         (D, PERTASK_MAX_D, "PERTASK_MAX_D")):
        if v > cap:
            raise NotImplementedError(
                f"dense_accept: {v} exceeds the kernel's {what}={cap}")


def pertask_fill_plain(nodes: NodeState, tt: TaskTables, cand: Tensor,
                       prior: Tensor, free: Tensor, dev: Tensor, qa: Tensor,
                       qan: Tensor, extra: Tensor, extra_dev: Tensor,
                       chain: Tensor, limit_eff: Tensor, quota_eff: Tensor, *,
                       placement: PlacementConfig, track_devices: bool,
                       topo: TopoStatic | None = None,
                       banned: Tensor | None = None,
                       active: Tensor | None = None,
                       base: PerTaskOut | None = None,
                       agg: Tensor | None = None,
                       mask: Tensor | None = None) -> PerTaskOut:
    """Plain PyTorch version of K9 with the retry's lane selection (see
    :func:`pertask_fill`): :func:`attempt_gang_in_domain_plain` over every
    lane, or over the ``active`` lanes only — each with its own lane index
    — merged into ``base``.  ``agg``, the kernel's scratch, is not read:
    this version sums its domain aggregates itself."""
    def plain(c, p, **kw):
        return attempt_gang_in_domain_plain(
            nodes, tt, c, p, free, dev, qa, qan, extra, extra_dev, chain,
            limit_eff, quota_eff, placement=placement,
            track_devices=track_devices, topo=topo, **kw)
    if active is None:
        return plain(cand, prior, banned=banned, mask=mask)
    ix = torch.nonzero(active).flatten()
    if ix.numel() == 0:
        return base
    sub = plain(cand[ix], prior[ix], banned=banned[ix],
                lane_ids=ix.to(torch.int32),
                mask=None if mask is None else mask[ix])
    merged = {}
    for f in dataclasses.fields(base):
        v = getattr(base, f.name)
        if v is not None:
            v = v.clone()
            v[ix] = getattr(sub, f.name)
        merged[f.name] = v
    return PerTaskOut(**merged)


def pertask_fill(nodes: NodeState, tt: TaskTables, cand: Tensor,
                 prior: Tensor, free: Tensor, dev: Tensor, qa: Tensor,
                 qan: Tensor, extra: Tensor, extra_dev: Tensor, chain: Tensor,
                 limit_eff: Tensor, quota_eff: Tensor, *,
                 placement: PlacementConfig, track_devices: bool,
                 topo: TopoStatic | None = None,
                 banned: Tensor | None = None, active: Tensor | None = None,
                 base: PerTaskOut | None = None,
                 agg: Tensor | None = None,
                 mask: Tensor | None = None) -> PerTaskOut:
    """K9 — every lane's per-task placement (see
    :func:`attempt_gang_in_domain_plain` for the contract).  CPU tensors
    run the plain version; CUDA tensors launch one block per lane or
    raise.

    The in-cycle retry (ref ``:1274-1289``) passes ``active`` bool [B],
    the lanes to attempt again, with ``banned`` and the first attempt's
    output ``base``: only the active lanes run (each with its own lane
    index, so its tie jitter is the reference's), and every other lane
    returns ``base``'s output unchanged.

    With ``topo``, ``agg`` is the domain-aggregate scratch
    (:func:`pertask_agg_scratch`; one is allocated per call without it).
    A first launch sums the chunk-start aggregate into its last row; a
    retry launch given the scratch of its chunk's first launch copies
    that row into the retried lanes' rows and sums nothing.

    ``mask`` bool [B, N] runs the mask mode: each block reads its lane's
    row of the affinity gates' node mask (K12)."""
    if active is not None and base is None:
        raise ValueError("pertask_fill: active lanes need the base output")
    if not kernels.on_card(free):
        return pertask_fill_plain(
            nodes, tt, cand, prior, free, dev, qa, qan, extra, extra_dev,
            chain, limit_eff, quota_eff, placement=placement,
            track_devices=track_devices, topo=topo, banned=banned,
            active=active, base=base, agg=agg, mask=mask)
    B, T = prior.shape
    N, R_ = free.shape
    D = dev.shape[1]
    G, _, K = tt.task_selector.shape
    S = tt.subgroup_min_needed.shape[1]
    X = nodes.filter_masks.shape[0]
    L = nodes.topology.shape[1]
    Q = qa.shape[0]
    pertask_fill_limits(T, D, S, placement)
    if R_ != 3:
        raise ValueError("pertask_fill: resource axis must be 3")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    gang = dict(task_req=tt.task_req, task_valid=tt.task_valid,
                task_selector=tt.task_selector, task_portion=tt.task_portion,
                task_accel_mem=tt.task_accel_mem, task_class=tt.task_class,
                task_nominated=tt.task_nominated,
                task_subgroup=tt.task_subgroup,
                subgroup_min_needed=tt.subgroup_min_needed,
                min_needed=tt.min_needed, queue=tt.queue,
                preemptible=tt.preemptible, anti_self=tt.anti_self,
                preferred_level=tt.preferred_level)
    node = dict(free=free, dev=dev, releasing=nodes.releasing, extra=extra,
                device_releasing=nodes.device_releasing, extra_dev=extra_dev,
                allocatable=nodes.allocatable, valid=nodes.valid,
                labels=nodes.labels, filter_masks=nodes.filter_masks,
                soft_scores=nodes.soft_scores,
                device_memory_gib=nodes.device_memory_gib,
                topology=nodes.topology)
    queue = dict(qa=qa, qan=qan, limit_eff=limit_eff, quota_eff=quota_eff,
                 chain=chain)
    lane = dict(cand=cand, prior=prior)
    dtypes = dict(task_req=f32, task_valid=b, task_selector=i32,
                  task_portion=f32, task_accel_mem=f32, task_class=i32,
                  task_nominated=i32, task_subgroup=i32,
                  subgroup_min_needed=i32, min_needed=i32, queue=i32,
                  preemptible=b, anti_self=i32, preferred_level=i32,
                  subgroup_required_level=i32,
                  free=f32, dev=f32, releasing=f32, extra=f32,
                  device_releasing=f32, extra_dev=f32, allocatable=f32,
                  valid=b, labels=i32, filter_masks=b, soft_scores=f32,
                  device_memory_gib=f32, topology=i32, qa=f32, qan=f32,
                  limit_eff=f32, quota_eff=f32, chain=b, cand=i32,
                  prior=i32, dom_ptr=i32, dom_nodes=i32, banned=i32,
                  active=b, mask=b)
    ts = dict(**gang, **node, **queue, **lane,
              subgroup_required_level=tt.subgroup_required_level)
    opt = dict(dom_ptr=None if topo is None else topo.dom_ptr,
               dom_nodes=None if topo is None else topo.dom_nodes,
               banned=banned, active=active, mask=mask)
    dv = kernels.require_cuda("pertask_fill", dict(
        ts, **{k: v for k, v in opt.items() if v is not None}), dtypes)
    if banned is not None and (topo is None or banned.shape != (B, S)):
        raise ValueError("pertask_fill: banned needs topo and is [B, S]")
    if mask is not None and mask.shape != (B, N):
        raise ValueError("pertask_fill: mask must be [B, N]")
    if base is not None:
        out = PerTaskOut(**{f.name: getattr(base, f.name).clone()
                            for f in dataclasses.fields(base)
                            if getattr(base, f.name) is not None})
    else:
        out = PerTaskOut(
            qa2=torch.empty((B, Q, R_), dtype=f32, device=dv),
            qan2=torch.empty((B, Q, R_), dtype=f32, device=dv),
            nodes_t=torch.empty((B, T), dtype=i32, device=dv),
            dev_t=torch.empty((B, T), dtype=i32, device=dv),
            pipe_t=torch.empty((B, T), dtype=b, device=dv),
            success=torch.empty((B,), dtype=b, device=dv),
            free_rows=torch.empty((B, T, R_), dtype=f32, device=dv),
            dev_rows=torch.empty((B, T, D), dtype=f32, device=dv),
            bind_rows=torch.empty((B, T, R_), dtype=f32, device=dv),
            devbind_rows=torch.empty((B, T, D), dtype=f32, device=dv),
            sub_dom=(None if topo is None else
                     torch.empty((B, S), dtype=i32, device=dv)))
    if (out.sub_dom is None) != (topo is None):
        raise ValueError("pertask_fill: base must come from the same mode")
    # the lanes' live domain aggregates: one [ND + 1, R] table per lane
    # in global memory, and the chunk-start table in the last row
    agg_ready = topo is not None and agg is not None and active is not None
    if topo is not None:
        if agg is None:
            agg = pertask_agg_scratch(B, topo, free)
        elif (agg.shape != (B + 1, N * L + 1, R_) or agg.dtype != f32
              or agg.device != free.device or not agg.is_contiguous()):
            raise ValueError(f"pertask_fill: agg must be f32 "
                             f"[{B + 1}, {N * L + 1}, {R_}] on the card")
    rc = kernels.library().kai_pertask_fill(
        *(kernels.ptr(v) for v in ts.values()),
        *(None if v is None else kernels.ptr(v)
          for v in (*opt.values(), agg if topo is not None else None)),
        B, T, N, D, K, X, L, S, Q, G, int(placement.binpack_accel),
        int(placement.binpack_cpu), int(placement.device_pack),
        int(track_devices), int(agg_ready), float(_jitter_scale(N)),
        *(kernels.ptr(v) for v in out.fields()),
        *([None] * (topo is None)), kernels.stream_of(free))
    kernels.check(rc, "pertask_fill")
    kernels.count_launch("pertask_fill",
                         topology=topo is not None and banned is None,
                         banned=banned is not None, mask=mask is not None)
    return out


def pertask_agg_scratch(B: int, topo: TopoStatic | None,
                        free: Tensor) -> Tensor | None:
    """K9's domain-aggregate scratch for ``B`` lanes, f32
    [B + 1, ND + 1, R] (a row per lane, the chunk-start table last),
    allocated once per action and passed to every :func:`pertask_fill`
    launch; None without ``topo`` and for CPU tensors (the plain version
    keeps its own)."""
    if topo is None or not kernels.on_card(free):
        return None
    N, R_ = free.shape
    L = topo.dom_of.shape[0]
    return torch.empty((B + 1, N * L + 1, R_), dtype=torch.float32,
                       device=free.device)


# ---------------------------------------------------------------------------
# K10: the dense accept prefix and the weighted commit
# ---------------------------------------------------------------------------

def _lane_sum(w: Tensor, d: Tensor) -> Tensor:
    """``einsum("b,b...->...", w, d)`` for 0/1 weights, added in ascending
    lane order from +0.0 (XLA:CPU's order for up to 32 lanes)."""
    acc = torch.zeros_like(d[0])
    for bi in torch.nonzero(w > 0).flatten().tolist():
        acc = acc + d[bi]
    return acc


def _dense_rows(pool: Tensor, nodes_b: Tensor, rows: Tensor,
                cols: Tensor | None = None) -> Tensor:
    """[B, U, C]: ``pool`` rows at nodes ``cols`` (all nodes when None) for
    every lane, with each lane's rows written at its placed nodes
    (duplicates carry the same row)."""
    B, T = nodes_b.shape
    base = pool if cols is None else pool[cols]
    out = base.expand((B,) + base.shape).clone()
    bi, ti = torch.nonzero(nodes_b >= 0, as_tuple=True)
    nb = nodes_b[bi, ti].long()
    at = nb if cols is None else torch.searchsorted(cols, nb)
    out[bi, at] = rows[bi, ti]
    return out


def dense_accept_plain(nodes_b: Tensor, ok: Tensor, gate_ok: Tensor,
                       free_rows: Tensor, dev_rows: Tensor, bind_rows: Tensor,
                       devbind_rows: Tensor, free: Tensor, dev: Tensor,
                       rel_floor: Tensor, dev_floor: Tensor, d_qa: Tensor,
                       d_qan: Tensor, qa: Tensor, qan: Tensor, *,
                       track_devices: bool):
    """Plain PyTorch version of K10 (ref ``:1728-1795``, the dense branch):
    the lanes' cumulative claims (``jnp.cumsum`` over lanes in XLA:CPU's
    blocked order) must keep every node above its releasing floor, the
    bind-now claims within the chunk-start idle pool and, with the device
    table, the same for every device; ``take = ok & gate_ok & accept``;
    the taken lanes' claims and queue deltas are committed.  ``ok`` is
    the lanes' success, ``gate_ok`` the joint queue gates.  Returns
    ``(take [B], free [N, R], dev [N, D], qa [Q, R], qan [Q, R])``.

    Only the nodes some successful lane placed on carry claims: the
    reference's [B, N, *] cumulatives are built over those columns, and
    every other node is tested with its zero claim (``free - 0 >=
    floor``, the same test for every lane)."""
    placed = ok[:, None] & (nodes_b >= 0)
    cols = torch.unique(nodes_b[placed]).long()              # sorted
    nodes_u = torch.where(placed, nodes_b, -1)
    okm = ok[:, None, None]
    free_u = free[cols]
    d_free = torch.where(
        okm, free_u - _dense_rows(free, nodes_u, free_rows, cols), 0.0)
    d_bind = torch.where(okm, _dense_rows(
        torch.zeros_like(free), nodes_u, bind_rows, cols), 0.0)
    cum_free = cumsum_blocked(d_free, 0)
    cum_bind = cumsum_blocked(d_bind, 0)
    accept = gate_ok & bool((free >= rel_floor).all()) \
        & (free_u - cum_free >= rel_floor[cols]).flatten(1).all(1) \
        & (cum_bind <= torch.clamp(free_u, min=0.0) + EPS).flatten(1).all(1)
    if track_devices:
        dev_u = dev[cols]
        d_dev = torch.where(
            okm, dev_u - _dense_rows(dev, nodes_u, dev_rows, cols), 0.0)
        d_devbind = torch.where(okm, _dense_rows(
            torch.zeros_like(dev), nodes_u, devbind_rows, cols), 0.0)
        cum_dev = cumsum_blocked(d_dev, 0)
        cum_devbind = cumsum_blocked(d_devbind, 0)
        accept = accept & bool((dev >= dev_floor).all()) \
            & (dev_u - cum_dev >= dev_floor[cols]).flatten(1).all(1) \
            & (cum_devbind <= torch.clamp(dev_u, min=0.0) + EPS
               ).flatten(1).all(1)
    take = ok & accept
    w = take.to(torch.float32)
    free = free.clone()
    free[cols] = free_u - _lane_sum(w, d_free)
    if track_devices:
        dev = dev.clone()
        dev[cols] = dev_u - _lane_sum(w, d_dev)
    return (take, free, dev, qa + _lane_sum(w, d_qa),
            qan + _lane_sum(w, d_qan))


def dense_accept(nodes_b: Tensor, ok: Tensor, gate_ok: Tensor,
                 free_rows: Tensor, dev_rows: Tensor | None,
                 bind_rows: Tensor, devbind_rows: Tensor | None,
                 free: Tensor, dev: Tensor | None,
                 rel_floor: Tensor, dev_floor: Tensor | None, d_qa: Tensor,
                 d_qan: Tensor, qa: Tensor, qan: Tensor, *,
                 track_devices: bool):
    """K10 — the dense accept prefix and the commit (see
    :func:`dense_accept_plain` for the contract).  CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise.  The kernel
    walks, per node, only the lanes that placed there (K9's or K3's rows)
    and never builds the [B, N, R] / [B, N, D] cumulatives.  Without the
    device table (``track_devices=False``: the uniform lanes) the four
    device arguments may be None and ``dev`` comes back as given."""
    args = (nodes_b, ok, gate_ok, free_rows, dev_rows, bind_rows,
            devbind_rows, free, dev, rel_floor, dev_floor, d_qa, d_qan, qa,
            qan)
    if not kernels.on_card(free):
        return dense_accept_plain(*args, track_devices=track_devices)
    B, T = nodes_b.shape
    N, R_ = free.shape
    D = dev.shape[1] if track_devices else 0
    Q = qa.shape[0]
    dense_accept_limits(B, D)
    if R_ != 3:
        raise ValueError("dense_accept: resource axis must be 3")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    names = ("nodes_b", "ok", "gate_ok", "free_rows", "dev_rows",
             "bind_rows", "devbind_rows", "free", "dev", "rel_floor",
             "dev_floor", "d_qa", "d_qan", "qa", "qan")
    ts = dict(zip(names, args))
    if not track_devices:
        for k in ("dev_rows", "devbind_rows", "dev", "dev_floor"):
            ts[k] = None
    dv = kernels.require_cuda("dense_accept", {
        k: v for k, v in ts.items() if v is not None}, dict(
        nodes_b=i32, ok=b, gate_ok=b, free_rows=f32, dev_rows=f32,
        bind_rows=f32, devbind_rows=f32, free=f32, dev=f32, rel_floor=f32,
        dev_floor=f32, d_qa=f32, d_qan=f32, qa=f32, qan=f32))
    first_bad = torch.full((1,), B, dtype=i32, device=dv)
    take = torch.empty((B,), dtype=b, device=dv)
    free2 = free.clone()
    dev2 = dev.clone() if track_devices else None
    qa2, qan2 = torch.empty_like(qa), torch.empty_like(qan)
    rc = kernels.library().kai_dense_accept(
        *(None if t is None else kernels.ptr(t) for t in ts.values()),
        B, T, N, D, Q, int(track_devices),
        kernels.ptr(first_bad), kernels.ptr(take), kernels.ptr(free2),
        None if dev2 is None else kernels.ptr(dev2), kernels.ptr(qa2),
        kernels.ptr(qan2), kernels.stream_of(free))
    kernels.check(rc, "dense_accept")
    kernels.count_launch("dense_accept", no_devices=not track_devices)
    return take, free2, (dev2 if track_devices else dev), qa2, qan2


# ---------------------------------------------------------------------------
# the action
# ---------------------------------------------------------------------------

def _attempt_gang(state: ClusterState, cand: Tensor, prior: Tensor,
                  quota_b: Tensor, qa: Tensor, qan: Tensor, *,
                  config: AllocateConfig, chain: Tensor,
                  limit_eff: Tensor, quota_eff: Tensor, lt: LaneTables,
                  tables, hoisted: bool, topo: UniformTopo | None = None,
                  free: Tensor | None = None, mask: Tensor | None = None,
                  rows: Tensor | None = None):
    """Try to place every uniform lane's gang (ref ``_attempt_gang``,
    ``:1208``, under the chunk's lane vmap) through the whole-gang fill,
    K3: placements only (the sparse protocol), or with ``free`` the dense
    protocol's rows; ``topo`` carries the required-level tables and the
    preferred band; ``mask`` bool [B, N] is each lane's node mask (valid
    nodes folded in: K12's output); ``rows`` i32 [B] names each lane's
    row of ``tables`` where they hold only the chunk's own types."""
    N = state.nodes.n
    return uniform_fill(
        cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain, lt,
        tables, state.nodes.soft_scores,
        state.nodes.valid if mask is None else mask,
        dense=config.dense_feasibility,
        stride=max(1, N // max(1, config.batch_size)), hoisted=hoisted,
        topo=topo, free=free, rows=rows)


def _ancestor_gate(parent: Tensor, q: Tensor, num_levels: int, used: Tensor,
                   cap: Tensor, req: Tensor) -> Tensor:
    """True iff ``used[a] + req <= cap[a]`` (per resource, UNLIMITED caps
    skipped) for queue ``q`` and every ancestor ``a`` (ref ``:405``).
    Batched: ``q`` i32 [...], ``req`` f32 [..., R] -> bool [...]."""
    ok = torch.ones(q.shape, dtype=torch.bool, device=q.device)
    cur = q
    for _ in range(num_levels):
        valid = cur >= 0
        idx = torch.clamp(cur, min=0).long()
        cap_q = cap[idx]
        fits = ((cap_q <= UNLIMITED + 0.5)
                | (used[idx] + req <= cap_q + EPS)).all(-1)
        ok = ok & (~valid | fits)
        cur = torch.where(valid, parent[idx], -1)
    return ok


def attempt_gang_dense(state: ClusterState, gi: int, free: Tensor,
                       qa: Tensor, qan: Tensor, extra: Tensor, *,
                       config: AllocateConfig, chain: Tensor,
                       limit_eff: Tensor, quota_eff: Tensor,
                       lt: LaneTables, domain_mask: Tensor | None = None):
    """One gang's whole placement with dense outputs — the reference's
    ``_attempt_gang`` (``:1208``) as the victim solver calls it: lane 0, no
    prior placements and no re-push quota (its ``legacy`` protocol:
    success iff at least ``min_needed`` tasks place), no hoisted tables.
    Routes through K2 for the gang's task type against ``(free, extra)``
    and K3 with one lane; ``lt`` must map every gang to type row 0
    (:func:`single_type_lanes`).  ``domain_mask`` bool [N] (the affinity
    gates' mask, ref ``:1259``) runs K3's mask mode with one lane.

    Returns ``(free2 [N, R], qa2 [Q, R], qan2 [Q, R], nodes_t i32 [T],
    pipe_t bool [T], success bool [])``; the device and extended pools
    pass through untouched (the uniform path tracks neither)."""
    g, n = state.gangs, state.nodes
    T, N = g.t, n.n
    dev = free.device
    ty = g.task_type[gi, :1].long()
    tables = type_tables(n, free, extra, g.type_req.index_select(0, ty),
                         g.type_selector.index_select(0, ty),
                         g.type_class.index_select(0, ty), config.placement)
    cand = torch.full((1,), gi, dtype=torch.int32, device=dev)
    prior = torch.full((1, T), -1, dtype=torch.int32, device=dev)
    quota_b = torch.full((1,), T, dtype=torch.int32, device=dev)
    qa2, qan2, nodes_t, pipe_t, _ = uniform_fill(
        cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain, lt,
        tables, n.soft_scores,
        n.valid if domain_mask is None else (n.valid & domain_mask)[None],
        dense=config.dense_feasibility,
        stride=max(1, N // max(1, config.batch_size)), hoisted=False)
    nodes_t, pipe_t = nodes_t[0], pipe_t[0]
    placed = nodes_t >= 0
    success = placed.sum(dtype=torch.int32) >= g.min_needed[gi]
    per_node = torch.zeros((N + 1,), dtype=torch.int32, device=dev)
    per_node.index_add_(0, torch.where(placed, nodes_t, N).long(),
                        placed.to(torch.int32))
    free2 = free - per_node[:N, None].to(free.dtype) * g.task_req[gi, 0][None]
    return free2, qa2[0], qan2[0], nodes_t, pipe_t, success


def single_type_lanes(state: ClusterState) -> LaneTables:
    """:class:`LaneTables` whose every gang reads type row 0 — the layout
    of the one-row K2 tables :func:`attempt_gang_dense` builds."""
    lt = LaneTables.of(state)
    return dataclasses.replace(lt,
                               task_type0=torch.zeros_like(lt.task_type0))


def _pad_row(t: Tensor, fill) -> Tensor:
    """``t`` with one junk row appended (the target of scatters at the
    out-of-range gang index ``G``, which JAX drops)."""
    pad = torch.full((1,) + t.shape[1:], fill, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t, pad], 0)


def allocate(state: ClusterState, fair_share: Tensor, *, num_levels: int,
             config: AllocateConfig = AllocateConfig(),
             init: AllocationResult | None = None) -> AllocationResult:
    """Run the allocate action over every pending gang (ref ``:1293``).

    The device choice follows ``state``: CUDA state launches the kernels,
    CPU state runs their plain versions."""
    return allocate_counted(state, fair_share, num_levels=num_levels,
                            config=config, init=init)[0]


@dataclasses.dataclass
class AllocateCounts:
    """What one allocate action did besides its commit."""

    #: wavefront chunks (one host sync each)
    chunks: int = 0
    #: per-task lanes attempted again in the next domain after their
    #: required-level domain failed the fill (the in-cycle retry)
    retries: int = 0
    #: chunks whose retry launch had at least one such lane
    retry_chunks: int = 0


def allocate_counted(state: ClusterState, fair_share: Tensor, *,
                     num_levels: int,
                     config: AllocateConfig = AllocateConfig(),
                     init: AllocationResult | None = None
                     ) -> tuple[AllocationResult, AllocateCounts]:
    """:func:`allocate`, also returning its :class:`AllocateCounts`."""
    check_supported(config)
    g, n, q = state.gangs, state.nodes, state.queues
    G, T, N = g.g, g.t, n.n
    dev = state.device
    i32 = torch.int32
    total = state.total_capacity
    B = max(1, min(config.batch_size, G))
    if config.subgroup_topology and not config.uniform_tasks:
        # the reference's cap on the per-task path's lanes with domain
        # aggregates (ref :1312)
        B = min(B, 64)
    if init is None:
        init = init_result(state)

    extra = init.releasing_extra
    limit_eff = torch.where(q.limit <= UNLIMITED + 0.5, _INF, q.limit)
    quota_eff = torch.where(q.quota <= UNLIMITED + 0.5, _INF, q.quota)

    remaining0 = g.valid & (g.backoff <= 0) & ~init.allocated
    fit_reason = init.fit_reason
    if config.prefilter:
        # whole-gang feasibility over the task-type table: a gang whose
        # min_needed tasks cannot each find ANY node is hopeless
        type_fit = feasible_nodes(
            n, g.type_req, g.type_selector, g.type_portion, g.type_mem,
            task_class=g.type_class, free=n.free + init.releasing_extra,
            device_free=n.device_free + init.device_releasing_extra,
            include_releasing=True).any(-1)                  # [Y]
        task_ok = type_fit[g.task_type.long()] & g.task_valid
        feas = task_ok.sum(-1, dtype=i32) >= g.min_needed
        pre_dropped = remaining0 & ~feas
        remaining0 = remaining0 & feas
        fit_reason = torch.where(pre_dropped, 1, fit_reason).to(i32)

    # ---- the hoisted pop order: every gang's AT-POP queue keys are a
    # static function of the snapshot while pops succeed (ref :1354) ----
    below_min = g.running_count < g.min_member
    f32 = torch.float32
    sjr_perm = ordering.lexsort((
        g.creation_order.to(f32), -g.priority.to(f32),
        (~below_min).to(f32)))
    static_job_rank = torch.zeros((G,), dtype=i32, device=dev)
    static_job_rank[sjr_perm] = torch.arange(G, dtype=i32, device=dev)
    gq0 = torch.clamp(g.queue, min=0).long()
    gang_req_all = torch.where(
        (g.task_valid & remaining0[:, None])[:, :, None], g.task_req,
        0.0).sum(1)                                          # [G, R]
    ord2 = ordering.lexsort((static_job_rank.to(f32), gq0.to(f32)))
    req2 = gang_req_all[ord2]
    # fractional and memory-based requests: XLA:CPU's cumsum order
    cs_excl = cumsum_blocked(req2, 0) - req2
    qm = gq0[ord2]
    is_first = torch.ones_like(qm, dtype=torch.bool)
    is_first[1:] = qm[1:] != qm[:-1]
    base = torch.zeros((q.q + 1,) + req2.shape[1:], dtype=f32, device=dev)
    base[torch.where(is_first, qm, q.q)] = cs_excl
    base = base[:q.q]
    cum_excl_g = torch.zeros_like(gang_req_all)
    cum_excl_g[ord2] = cs_excl - base[qm]
    at_pop = init.queue_allocated[gq0] + cum_excl_g
    pop_fs = (at_pop > fair_share[gq0] + EPS).any(-1)
    pop_qt = (at_pop > quota_eff[gq0] + EPS).any(-1)
    pop_dom = (at_pop / torch.clamp(total, min=EPS)[None, :]).amax(-1)
    nprio_q = -q.priority.to(f32)
    pop_order = ordering.lexsort((
        static_job_rank.to(f32), pop_dom, nprio_q[gq0], pop_qt.to(f32),
        pop_fs.to(f32)))

    chain = _chain_membership(q.parent, num_levels)
    # the uniform kernel's lanes emit placements only and the chunk accepts
    # on K = B*T sparse claim entries (K3, K4); the per-task lanes (K9),
    # and the uniform lanes under a required level (K3 with the domain
    # tables), emit their pools' rows at the nodes they touched and the
    # chunk runs the dense accept (K10) — the reference's rule (ref :1537)
    uniform = config.uniform_tasks
    sparse = (uniform and not config.extended and not config.track_devices
              and config.sparse_wavefront and not config.subgroup_topology)
    Yu = g.type_req.shape[0]
    hoisted = config.hoist_type_tables and Yu <= B
    lt = LaneTables.of(state)
    tt = None if uniform else TaskTables.of(state)
    extra_dev = init.device_releasing_extra
    rel_floor = -(n.releasing + extra) - EPS
    dev_floor = -(n.device_releasing + extra_dev) - EPS
    topo_st = TopoStatic.of(n) if config.subgroup_topology else None
    # the uniform path's domain tables: built once per action, then kept
    # up to date at the nodes each chunk's commit touched (ref :1418-1528)
    hoist_topo = uniform and config.subgroup_topology
    if hoist_topo:
        fp_build = feasible_nodes_dual(
            n, g.type_req, g.type_selector,
            torch.zeros((Yu,), dtype=f32, device=dev),
            torch.zeros((Yu,), dtype=f32, device=dev), free=init.free,
            device_free=None, extra_releasing=extra,
            extra_device_releasing=None, devices=False,
            task_class=g.type_class)[1] & n.valid[None, :]   # [Y, N]
        dom_caps_y, dom_agg, c_y = topo_tables_build(
            topo_st, fp_build, (init.free + n.releasing) + extra, n.valid,
            g.type_req)
        srl0 = g.subgroup_required_level[:, 0].contiguous()
    pref_level = (g.preferred_level.contiguous()
                  if uniform and config.preferred_topology else None)
    # the in-cycle affinity terms: each lane's node mask (K12) and the
    # chunk's deferred lanes, the taken placements' domains claimed (K13)
    # after each commit (ref :1525-1530, :1665-1680, :1855-1859)
    anti = config.anti_groups
    anti_used = init.anti_used
    if anti:
        dom_static = anti_domain_tables(state)
        anti_used = anti_used.clone()       # K13 marks this action's copy

    # loop state; row G of each gang buffer is the junk row
    placements = _pad_row(init.placements, -1)
    placement_device = _pad_row(init.placement_device, -1)
    pipelined = _pad_row(init.pipelined, False)
    allocated = _pad_row(init.allocated, False)
    attempted = _pad_row(init.attempted, False)
    fit_reason = _pad_row(fit_reason, 0)
    remaining = _pad_row(remaining0, False)
    failed_sig = torch.zeros((G,), dtype=i32, device=dev)
    free, qa, qan = (init.free, init.queue_allocated,
                     init.queue_allocated_nonpreemptible)
    dev_free = init.device_free
    gq = g.queue.long()
    sig = g.sig.long()
    lanes_b = torch.arange(B, dtype=i32, device=dev)
    retries = torch.zeros((), dtype=torch.int64, device=dev)
    retry_chunks = torch.zeros((), dtype=torch.int64, device=dev)
    # K9's domain-aggregate scratch, shared by every chunk's two launches
    agg_scratch = (None if uniform else
                   pertask_agg_scratch(B, topo_st, init.free))
    fuel = G * (T + 1)
    chunks = 0
    while fuel > 0 and bool(remaining[:G].any()):
        # first B remaining gangs of the hoisted pop order, with the LIVE
        # over-fair-share gate (the reference heap's tier-1 treatment)
        over_fs_live = (qa > fair_share + EPS).any(-1)       # [Q]
        rem = remaining[:G]
        elig = rem & ~over_fs_live[torch.clamp(gq, min=0)]
        elig = torch.where(elig.any(), elig, rem)
        flags = elig[pop_order]
        rnk = torch.cumsum(flags.to(i32), 0, dtype=i32) - 1
        pos = torch.where(flags & (rnk < B), rnk, B).long()
        cand = torch.full((B + 1,), G, dtype=torch.long, device=dev)
        cand[pos] = pop_order
        cand = cand[:B]
        cand_valid = torch.zeros((B + 1,), dtype=torch.bool, device=dev)
        cand_valid[pos] = True
        cand_valid = cand_valid[:B]
        # gathers at the junk index clamp to the last row, as JAX's do
        cand_c = torch.clamp(cand, max=G - 1)

        # re-push protocol: a below-quorum gang attempts its remaining
        # quorum; an at/above-quorum gang scales up one task per attempt
        prior_b = placements[cand_c]                         # [B, T]
        placed_cnt = (prior_b >= 0).sum(-1, dtype=i32)
        need = g.min_needed[cand_c]
        quota_b = torch.where(placed_cnt < need, need - placed_cnt, 1).to(i32)

        dev_rows = devbind_rows = None
        dmask_b = dup_b = None
        if anti:
            dmask_b = affinity_mask(state, anti_used, dom_static,
                                    cand_c.to(i32),
                                    attract=config.attract_groups)
            dup_b = anti_defer_lanes(state, cand_c, cand_valid)
            if config.attract_groups:
                dup_b = dup_b | attract_defer_lanes(state, cand_c,
                                                    cand_valid, anti_used)
        if uniform:
            ty_rows = None
            if hoisted:
                tables = type_tables(n, free, extra, g.type_req,
                                     g.type_selector, g.type_class,
                                     config.placement)
            else:
                # more types than lanes: the reference builds each lane's
                # fit and bands itself (ref :1548), so the tables hold one
                # row per lane, its own type's (no host read)
                ty = lt.task_type0[cand_c].long()
                tables = type_tables(n, free, extra, g.type_req[ty],
                                     g.type_selector[ty], g.type_class[ty],
                                     config.placement)
                ty_rows = lanes_b
            utopo = None
            if hoist_topo or pref_level is not None:
                utopo = UniformTopo(topology=n.topology,
                                    pref_level=pref_level)
            if hoist_topo:
                utopo = dataclasses.replace(
                    utopo, srl0=srl0, dom_caps_y=dom_caps_y,
                    level_of_dom=topo_st.level_of_dom,
                    order=order_by_agg(topo_st.level_of_dom, dom_agg))
            outs = _attempt_gang(
                state, cand_c.to(i32), prior_b, quota_b, qa, qan,
                config=config, chain=chain, limit_eff=limit_eff,
                quota_eff=quota_eff, lt=lt, tables=tables, hoisted=hoisted,
                topo=utopo, free=None if sparse else free, mask=dmask_b,
                rows=ty_rows)
            qa2_b, qan2_b, nodes_b, pipe_b, succ_b = outs[:5]
            if not sparse:
                free_rows, bind_rows = outs[5:]
            devt_b = None
        else:
            lanes_out = pertask_fill(
                n, tt, cand_c.to(i32), prior_b, free, dev_free, qa, qan,
                extra, extra_dev, chain, limit_eff, quota_eff,
                placement=config.placement,
                track_devices=config.track_devices, topo=topo_st,
                agg=agg_scratch, mask=dmask_b)
            if topo_st is not None:
                # in-cycle retry over the next domain (ref :1274-1289):
                # a lane whose locked domain failed the fill is attempted
                # again with those domains banned; no other lane runs
                retry = (cand_valid & ~lanes_out.success
                         & (lanes_out.sub_dom >= 0).any(-1))
                lanes_out = pertask_fill(
                    n, tt, cand_c.to(i32), prior_b, free, dev_free, qa, qan,
                    extra, extra_dev, chain, limit_eff, quota_eff,
                    placement=config.placement,
                    track_devices=config.track_devices, topo=topo_st,
                    banned=lanes_out.sub_dom, active=retry, base=lanes_out,
                    agg=agg_scratch, mask=dmask_b)
                retries += retry.sum()
                retry_chunks += retry.any()
            qa2_b, qan2_b, nodes_b, pipe_b, succ_b, devt_b = (
                lanes_out.qa2, lanes_out.qan2, lanes_out.nodes_t,
                lanes_out.pipe_t, lanes_out.success, lanes_out.dev_t)
            free_rows, bind_rows = lanes_out.free_rows, lanes_out.bind_rows
            dev_rows = lanes_out.dev_rows
            devbind_rows = lanes_out.devbind_rows
        succ_b = succ_b & cand_valid
        # a deferred lane is conflict-rejected: it retries next chunk and
        # is neither done nor failed, even where its own attempt failed
        # (ref :1706-1707, :1808-1810)
        settled = succ_b
        if dup_b is not None:
            succ_b = succ_b & ~dup_b
            settled = succ_b | dup_b

        ok = succ_b[:, None, None]
        d_qa = torch.where(ok, qa2_b - qa, 0.0)              # [B, Q, R]
        d_qan = torch.where(ok, qan2_b - qan, 0.0)
        if sparse:
            cum_qa = torch.cumsum(d_qa, 0)
            cum_qan = torch.cumsum(d_qan, 0)
        else:
            # fractional and memory-based deltas: XLA:CPU's cumsum order,
            # both tables in one pass
            cum_qa, cum_qan = cumsum_blocked(
                torch.stack([d_qa, d_qan], 1), 0).unbind(1)
        ok_qa = ((qa[None] + cum_qa <= limit_eff[None] + EPS)
                 | (cum_qa <= EPS)).flatten(1).all(1)
        ok_qan = ((qan[None] + cum_qan <= quota_eff[None] + EPS)
                  | (cum_qan <= EPS)).flatten(1).all(1)
        if sparse:
            # sparse prefix test on the K = B*T claim entries
            req_b = lt.task_req0[cand_c]                     # [B, R]
            ent_ok = succ_b[:, None] & (nodes_b >= 0)
            first_bad, node_e, lane_e = sparse_accept(
                nodes_b, ent_ok, pipe_b, req_b, free,
                (free + n.releasing) + extra, N)
            prefix_ok = lanes_b < first_bad
            take = succ_b & prefix_ok & ok_qa & ok_qan

            # commit: the accepted lanes' claims leave the idle pool
            # (whole units, so the scatter-add order is exact)
            le = lane_e.long()
            take_e = take[le] & ent_ok.reshape(-1)
            upd = torch.zeros((N + 1, free.shape[1]), dtype=f32, device=dev)
            upd.index_add_(0, node_e.long(),
                           torch.where(take_e[:, None], req_b[le], 0.0))
            free = free - upd[:N]
            w = take.to(f32)[:, None, None]
            qa = qa + (w * d_qa).sum(0)
            qan = qan + (w * d_qan).sum(0)
        else:
            take, free, dev_free, qa, qan = dense_accept(
                nodes_b, succ_b, ok_qa & ok_qan, free_rows, dev_rows,
                bind_rows, devbind_rows, free, dev_free, rel_floor,
                dev_floor, d_qa, d_qan, qa, qan,
                track_devices=config.track_devices)

        nodes_b = torch.where(take[:, None], nodes_b, -1)
        pipe_b = torch.where(take[:, None], pipe_b, False)
        new_cnt = (nodes_b >= 0).sum(-1, dtype=i32)
        total_cnt = placed_cnt + new_cnt
        valid_cnt = lt.task_valid[cand_c].sum(-1, dtype=i32)
        # done: whole, or failed (failure is final — capacity only
        # shrinks); successful partial gangs re-enter the heap
        done_b = cand_valid & ((take & (total_cnt >= valid_cnt)) | ~settled)
        fail_fresh = cand_valid & ~settled & (placed_cnt == 0)
        fit_reason[cand] = torch.where(
            fail_fresh, 3, torch.where(take, 0, fit_reason[cand])).to(i32)
        new_t = nodes_b >= 0
        placements[cand] = torch.where(new_t, nodes_b, placements[cand])
        placement_device[cand] = torch.where(
            new_t, -1 if devt_b is None else devt_b,
            placement_device[cand]).to(i32)
        pipelined[cand] = torch.where(new_t, pipe_b, pipelined[cand])
        allocated[cand] = allocated[cand] | (take & (total_cnt >= need))
        attempted[cand] = attempted[cand] | cand_valid
        remaining[cand] = remaining[cand] & ~done_b
        if config.signature_skip:
            # one quorum-attempt failure retires every equivalent gang
            failed_sig = failed_sig.scatter_reduce(
                0, sig[cand_c], fail_fresh.to(i32), reduce="amax")
            skip_now = remaining[:G] & (failed_sig[sig] > 0)
            fit_reason[:G] = torch.where(skip_now, 2, fit_reason[:G])
            remaining[:G] = remaining[:G] & ~skip_now
        if anti:
            # taken lanes claim their placements' domains in their mark
            # rows (ref :1855-1859)
            anti_mark(state, anti_used, dom_static, cand_c.to(i32),
                      nodes_b.contiguous(), take)
        if hoist_topo:
            # the committed replicas' nodes and domains (ref :1861)
            req0_b = g.type_req[g.task_type[cand_c, 0].long(), 0]
            dom_caps_y, dom_agg, c_y = topo_tables_update(
                topo_st, fp_build, dom_caps_y, dom_agg, c_y,
                (free + n.releasing) + extra, take, nodes_b.contiguous(),
                req0_b.contiguous(), g.type_req)
        fuel -= 1
        chunks += 1

    result = dataclasses.replace(
        init, placements=placements[:G], placement_device=placement_device[:G],
        pipelined=pipelined[:G], allocated=allocated[:G],
        attempted=attempted[:G], fit_reason=fit_reason[:G], free=free,
        device_free=dev_free, queue_allocated=qa,
        queue_allocated_nonpreemptible=qan, anti_used=anti_used)
    return result, AllocateCounts(chunks=chunks, retries=int(retries),
                                  retry_chunks=int(retry_chunks))
