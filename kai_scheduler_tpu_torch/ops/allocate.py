"""The allocate action — gang all-or-nothing placement as a wavefront.

Port of ``kai_scheduler_tpu/ops/allocate.py``, first sub-slice: the
auto-tuned variant that the repo's headline cluster (and every snapshot
whose gangs are uniform replicas with no fractions, extended resources,
topology or affinity terms) runs — the uniform whole-gang kernel under the
sparse wavefront with hoisted per-type tables and the dynamic pop order.

Reference hot path (``actions/allocate/allocate.go:52-156``): pop jobs
from the fairness heap; place each gang whole or not at all.  Here each
chunk of the wavefront takes the next ``B`` gangs of the hoisted pop
order, attempts them independently against the chunk-start state, and
accepts the maximal order-prefix whose cumulative claims fit; the
reference's ``lax.while_loop`` over chunks is a host loop with one sync
per chunk.

Three device programs of the chunk body are hand-written CUDA kernels,
each with its plain PyTorch version in this module (the wrapper runs the
plain version only for CPU tensors):

- **K2** :func:`type_tables` (``csrc/type_tables.cu``) — per (task type,
  node) fit on idle and on idle+releasing, whole-replica counts and the
  plugin score bands; replaces ``build_type_tables`` (ref ``:1552``).
- **K3** :func:`uniform_fill` (``csrc/uniform_fill.cu``) — every lane's
  whole-gang placement: queue gate, tie jitter, top-k over nodes in
  ``lax.top_k`` order, cumulative fill, node-ascending replica assignment;
  replaces ``_attempt_gang_in_domain_uniform`` under the lane vmap (ref
  ``:915``, ``:1690``).
- **K4** :func:`sparse_accept` (``csrc/sparse_accept.cu``) — the stable
  node sort of the chunk's claims and the first lane that over-subscribes
  a node; replaces ``sparse_entry_tables`` + ``sparse_accept_first_bad``
  (ref ``:283``, ``:313``).

Everything else in the chunk is elementwise work, scatters and sorts and
stays as PyTorch ops.  JAX's out-of-bounds-dropping scatters at the junk
gang index ``G`` become writes into one extra buffer row that is sliced
off.  A configuration this slice does not implement raises
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
from .predicates import feasible_nodes, feasible_nodes_dual
from .scoring import BIG_NEG, DEFAULT_TIERS, PlacementConfig, score_bands

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
    a path this slice has not ported."""
    unsupported = [
        (not config.uniform_tasks,
         "uniform_tasks=False (the per-task placement path)"),
        (config.track_devices, "track_devices=True (device share table)"),
        (config.subgroup_topology,
         "subgroup_topology=True (subgroup / required topology)"),
        (config.preferred_topology, "preferred_topology=True"),
        (config.extended, "extended=True (MIG/DRA scalar resources)"),
        (config.anti_groups, "anti_groups=True"),
        (config.attract_groups, "attract_groups=True"),
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
    bands and mask)."""
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


def type_tables(nodes: NodeState, free: Tensor, extra: Tensor,
                type_req: Tensor, type_selector: Tensor, type_class: Tensor,
                placement: PlacementConfig):
    """K2 — ``(fit_idle, fit_pipe, c_idle, c_pipe, bands)`` per (type,
    node), once per chunk against chunk-start ``free``.  CPU tensors run
    :func:`type_tables_plain`; CUDA tensors launch the kernel or raise."""
    if not kernels.on_card(free):
        return type_tables_plain(nodes, free, extra, type_req, type_selector,
                                 type_class, placement)
    if tuple(placement.tiers) != DEFAULT_TIERS:
        raise NotImplementedError(
            f"type_tables: the CUDA kernel composes the default tiers "
            f"{DEFAULT_TIERS}, not {tuple(placement.tiers)}")
    N, R_ = free.shape
    Y, K = type_selector.shape
    X = nodes.filter_masks.shape[0]
    if R_ != 3 or type_req.shape != (Y, R_):
        raise ValueError("type_tables: resource axis must be 3")
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
        int(placement.binpack_cpu),
        *(kernels.ptr(t) for t in (fi, fp, ci, cp, sc)),
        kernels.stream_of(free))
    kernels.check(rc, "type_tables")
    kernels.count_launch("type_tables")
    return fi, fp, ci, cp, sc


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
    """Indices of the ``k`` best entries of each row in ``lax.top_k``
    order: score descending, the LOWER index first among ties (a stable
    descending sort's prefix; ``torch.topk`` promises no tie order)."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _jitter_scale(N: int) -> Tensor:
    """``(-1e-4 / N)`` — a Python float the reference rounds to f32."""
    return torch.tensor(-1e-4 / N, dtype=torch.float32)


def uniform_fill_plain(cand: Tensor, prior: Tensor, quota_b: Tensor,
                       qa: Tensor, qan: Tensor, limit_eff: Tensor,
                       quota_eff: Tensor, chain: Tensor, lt: LaneTables,
                       tables, soft_scores: Tensor, valid: Tensor, *,
                       dense: bool, stride: int, hoisted: bool):
    """Plain PyTorch version of K3, batched over the B lanes.

    ``cand`` i32 [B] gang per lane (already clamped to a real row),
    ``prior`` i32 [B, T] earlier attempts' nodes, ``quota_b`` i32 [B]
    replicas this attempt may add; ``tables`` are K2's outputs.  Returns
    ``(qa2 [B,Q,R], qan2 [B,Q,R], nodes_t i32 [B,T], pipe_t bool [B,T],
    success bool [B])`` — the reference's ``sparse_out`` tuple.

    ``hoisted`` selects the reference's f32 order of the score bands:
    with per-chunk type tables ``((bands + soft) + jitter)``, without
    (``Yu > B``) ``(bands + (jitter + soft))``."""
    fi_y, fp_y, ci_y, cp_y, sc_y = tables
    B, T = prior.shape
    N = valid.shape[0]
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
        head = torch.where(
            req_pos[:, None, :],
            (cap - used)[None] / torch.clamp(req, min=EPS)[:, None, :],
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

    ty = lt.task_type0[gi].long()
    fit_idle = fi_y[ty] & valid
    fit_pipe = fp_y[ty] & valid
    c_pipe = lane_clamp(cp_y[ty], fit_pipe)                  # [B, N]
    c_idle = torch.minimum(lane_clamp(ci_y[ty], fit_idle), c_pipe)

    lanes = torch.arange(B, dtype=i32, device=dev)
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
    else:
        base = bands + (jitter + soft)
    scores = torch.where(fit_pipe, base, BIG_NEG)

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
    qa2 = qa[None] + anc_d
    qan2 = qan[None] + torch.where(nonpre[:, None, None], anc_d, 0.0)
    success = (goal > 0) & (total_placed >= goal)
    return qa2, qan2, nodes_t, pipe_t, success


#: most task slots per gang the K3 kernel's per-thread top-k holds
MAX_TOPK = 64


def uniform_fill(cand: Tensor, prior: Tensor, quota_b: Tensor, qa: Tensor,
                 qan: Tensor, limit_eff: Tensor, quota_eff: Tensor,
                 chain: Tensor, lt: LaneTables, tables,
                 soft_scores: Tensor, valid: Tensor, *, dense: bool,
                 stride: int, hoisted: bool):
    """K3 — every lane's whole-gang placement (see
    :func:`uniform_fill_plain` for the contract).  CPU tensors run the
    plain version; CUDA tensors launch one block per lane or raise."""
    if not kernels.on_card(prior):
        return uniform_fill_plain(cand, prior, quota_b, qa, qan, limit_eff,
                                  quota_eff, chain, lt, tables, soft_scores,
                                  valid, dense=dense, stride=stride,
                                  hoisted=hoisted)
    fi_y, fp_y, ci_y, cp_y, sc_y = tables
    B, T = prior.shape
    Q, R_ = qa.shape
    Y, N = fp_y.shape
    G = lt.queue.shape[0]
    X = soft_scores.shape[0]
    if min(T, N) > MAX_TOPK:
        raise ValueError(f"uniform_fill: top-k of {min(T, N)} exceeds the "
                         f"kernel's {MAX_TOPK}")
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
    dev = kernels.require_cuda("uniform_fill", ts, dict(
        cand=i32, prior=i32, quota_b=i32, qa=f32, qan=f32, limit_eff=f32,
        quota_eff=f32, chain=b, task_req0=f32, task_valid=b, queue=i32,
        preemptible=b, anti_self=i32, task_type0=i32, task_class0=i32,
        fi=b, fp=b, ci=i32, cp=i32, sc=f32, soft=f32, valid=b))
    qa2 = torch.empty((B, Q, R_), dtype=f32, device=dev)
    qan2 = torch.empty((B, Q, R_), dtype=f32, device=dev)
    nodes_t = torch.empty((B, T), dtype=i32, device=dev)
    pipe_t = torch.empty((B, T), dtype=b, device=dev)
    success = torch.empty((B,), dtype=b, device=dev)
    lib = kernels.library()
    rc = lib.kai_uniform_fill(
        *(kernels.ptr(t) for t in ts.values()),
        B, T, N, Q, Y, G, X, int(dense), int(stride), int(hoisted),
        float(_jitter_scale(N)),
        *(kernels.ptr(t) for t in (qa2, qan2, nodes_t, pipe_t, success)),
        kernels.stream_of(prior))
    kernels.check(rc, "uniform_fill")
    kernels.count_launch("uniform_fill")
    return qa2, qan2, nodes_t, pipe_t, success


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
                        N: int):
    """Plain PyTorch version of K4 (ref ``sparse_accept_first_bad``):
    each entry's node-cumulative claim must fit ``pipe_pool`` and the
    bind-now subset must fit the idle pool.  Returns (first_bad i32 [] —
    B when every claim fits, node_e i32 [K], lane_e i32 [K]).

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
    viol = (cum_e > pipe_pool[nsafe] + EPS).any(-1) & real
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
                  req_b: Tensor, free: Tensor, pipe_pool: Tensor, N: int):
    """K4 — the first lane whose claims over-subscribe a node (see
    :func:`sparse_accept_plain`).  CPU tensors run the plain version;
    CUDA tensors launch one block or raise."""
    if not kernels.on_card(nodes_b):
        return sparse_accept_plain(nodes_b, ent_ok, pipe_b, req_b, free,
                                   pipe_pool, N)
    B, T = nodes_b.shape
    R_ = req_b.shape[1]
    K = B * T
    if R_ != 3 or free.shape != (N, R_) or pipe_pool.shape != (N, R_):
        raise ValueError("sparse_accept: pools must be [N, 3]")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    ts = dict(nodes_b=nodes_b, ent_ok=ent_ok, pipe_b=pipe_b, req_b=req_b,
              free=free, pipe_pool=pipe_pool)
    dev = kernels.require_cuda("sparse_accept", ts, dict(
        nodes_b=i32, ent_ok=b, pipe_b=b, req_b=f32, free=f32,
        pipe_pool=f32))
    first_bad = torch.empty((), dtype=i32, device=dev)
    node_e = torch.empty((K,), dtype=i32, device=dev)
    lane_e = torch.empty((K,), dtype=i32, device=dev)
    Kp = 1 << max(1, (K - 1).bit_length())
    scratch = (torch.empty((Kp * 32,), dtype=torch.uint8, device=dev)
               if Kp > SMEM_ENTRIES else None)
    lib = kernels.library()
    rc = lib.kai_sparse_accept(
        *(kernels.ptr(t) for t in ts.values()), B, T, N, R_,
        None if scratch is None else kernels.ptr(scratch),
        kernels.ptr(first_bad), kernels.ptr(node_e), kernels.ptr(lane_e),
        kernels.stream_of(nodes_b))
    kernels.check(rc, "sparse_accept")
    kernels.count_launch("sparse_accept")
    return first_bad, node_e, lane_e


# ---------------------------------------------------------------------------
# the action
# ---------------------------------------------------------------------------

def _attempt_gang(state: ClusterState, cand: Tensor, prior: Tensor,
                  quota_b: Tensor, qa: Tensor, qan: Tensor, *,
                  config: AllocateConfig, chain: Tensor,
                  limit_eff: Tensor, quota_eff: Tensor, lt: LaneTables,
                  tables, hoisted: bool):
    """Try to place every lane's gang (ref ``_attempt_gang``, ``:1208``,
    under the chunk's lane vmap): this slice routes to the uniform
    whole-gang fill with sparse outputs, K3 (``allocate`` has refused
    every other configuration)."""
    N = state.nodes.n
    return uniform_fill(
        cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain, lt,
        tables, state.nodes.soft_scores, state.nodes.valid,
        dense=config.dense_feasibility,
        stride=max(1, N // max(1, config.batch_size)), hoisted=hoisted)


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


def allocate_counted(state: ClusterState, fair_share: Tensor, *,
                     num_levels: int,
                     config: AllocateConfig = AllocateConfig(),
                     init: AllocationResult | None = None
                     ) -> tuple[AllocationResult, int]:
    """:func:`allocate`, also returning the number of wavefront chunks
    (host syncs) it ran."""
    check_supported(config)
    g, n, q = state.gangs, state.nodes, state.queues
    G, T, N = g.g, g.t, n.n
    dev = state.device
    i32 = torch.int32
    total = state.total_capacity
    B = max(1, min(config.batch_size, G))
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
    cs_excl = torch.cumsum(req2, 0) - req2
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
    Yu = g.type_req.shape[0]
    hoisted = config.hoist_type_tables and Yu <= B
    lt = LaneTables.of(state)

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
    gq = g.queue.long()
    sig = g.sig.long()
    lanes_b = torch.arange(B, dtype=i32, device=dev)
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

        tables = type_tables(n, free, extra, g.type_req, g.type_selector,
                             g.type_class, config.placement)
        qa2_b, qan2_b, nodes_b, pipe_b, succ_b = _attempt_gang(
            state, cand_c.to(i32), prior_b, quota_b, qa, qan,
            config=config, chain=chain,
            limit_eff=limit_eff, quota_eff=quota_eff, lt=lt, tables=tables,
            hoisted=hoisted)
        succ_b = succ_b & cand_valid

        ok = succ_b[:, None, None]
        d_qa = torch.where(ok, qa2_b - qa, 0.0)              # [B, Q, R]
        d_qan = torch.where(ok, qan2_b - qan, 0.0)
        cum_qa = torch.cumsum(d_qa, 0)
        cum_qan = torch.cumsum(d_qan, 0)
        # sparse prefix test on the K = B*T claim entries
        req_b = lt.task_req0[cand_c]                         # [B, R]
        ent_ok = succ_b[:, None] & (nodes_b >= 0)
        first_bad, node_e, lane_e = sparse_accept(
            nodes_b, ent_ok, pipe_b, req_b, free,
            (free + n.releasing) + extra, N)
        prefix_ok = lanes_b < first_bad
        ok_qa = ((qa[None] + cum_qa <= limit_eff[None] + EPS)
                 | (cum_qa <= EPS)).flatten(1).all(1)
        ok_qan = ((qan[None] + cum_qan <= quota_eff[None] + EPS)
                  | (cum_qan <= EPS)).flatten(1).all(1)
        take = succ_b & prefix_ok & ok_qa & ok_qan

        # commit: the accepted lanes' claims leave the idle pool (whole
        # units, so the scatter-add order is exact)
        le = lane_e.long()
        take_e = take[le] & ent_ok.reshape(-1)
        upd = torch.zeros((N + 1, free.shape[1]), dtype=f32, device=dev)
        upd.index_add_(0, node_e.long(),
                       torch.where(take_e[:, None], req_b[le], 0.0))
        free = free - upd[:N]
        w = take.to(f32)[:, None, None]
        qa = qa + (w * d_qa).sum(0)
        qan = qan + (w * d_qan).sum(0)

        nodes_b = torch.where(take[:, None], nodes_b, -1)
        pipe_b = torch.where(take[:, None], pipe_b, False)
        new_cnt = (nodes_b >= 0).sum(-1, dtype=i32)
        total_cnt = placed_cnt + new_cnt
        valid_cnt = lt.task_valid[cand_c].sum(-1, dtype=i32)
        # done: whole, or failed (failure is final — capacity only
        # shrinks); successful partial gangs re-enter the heap
        done_b = cand_valid & ((take & (total_cnt >= valid_cnt)) | ~succ_b)
        fail_fresh = cand_valid & ~succ_b & (placed_cnt == 0)
        fit_reason[cand] = torch.where(
            fail_fresh, 3, torch.where(take, 0, fit_reason[cand])).to(i32)
        new_t = nodes_b >= 0
        placements[cand] = torch.where(new_t, nodes_b, placements[cand])
        placement_device[cand] = torch.where(new_t, -1,
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
        fuel -= 1
        chunks += 1

    result = dataclasses.replace(
        init, placements=placements[:G], placement_device=placement_device[:G],
        pipelined=pipelined[:G], allocated=allocated[:G],
        attempted=attempted[:G], fit_reason=fit_reason[:G], free=free,
        queue_allocated=qa, queue_allocated_nonpreemptible=qan)
    return result, chunks
