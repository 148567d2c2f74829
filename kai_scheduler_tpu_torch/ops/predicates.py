"""Pod×node feasibility masks — the predicates plugin, tensorized.

Port of ``kai_scheduler_tpu/ops/predicates.py``.  The reference checks each
candidate node for a task through a chain of predicate functions
(``plugins/predicates/predicates.go:104-130``); here the whole chain is one
broadcast expression producing a boolean ``[..., N]`` mask, written with a
leading batch dimension where the reference vmaps.

Covered predicate surface: node validity, resource fit against ``free``
(idle) and against ``free + releasing`` (the pipeline variant),
nodeSelector equality via the label-vocabulary encoding, the
device-granular accel fit (fractional and whole devices), and the
host-evaluated filter classes (taints, affinity).

Every comparison keeps the reference's f32 order of operations
(``avail + EPS >= req``, ``(free + releasing) + extra``) so the masks are
bit-identical to the reference's.
"""
from __future__ import annotations

import torch

from ..apis.types import RESOURCE_ACCEL
from ..state.cluster_state import NodeState

Tensor = torch.Tensor
EPS = 1e-6


def selector_mask(node_labels: Tensor, task_selector: Tensor) -> Tensor:
    """nodeSelector match — bool [..., N]: every required key matches.

    ``node_labels`` i32 [N, K]; ``task_selector`` i32 [..., K] (-1 = any).
    """
    required = task_selector[..., None, :] >= 0              # [..., 1, K]
    matches = node_labels == task_selector[..., None, :]     # [..., N, K]
    return (~required | matches).all(-1)


def resource_fit_mask(available: Tensor, task_req: Tensor) -> Tensor:
    """True where the task's request fits the node's available vector —
    ``available`` f32 [N, R], ``task_req`` f32 [..., R] → bool [..., N]."""
    return (available + EPS >= task_req[..., None, :]).all(-1)


def node_portion(nodes: NodeState, task_portion: Tensor,
                 task_accel_mem: Tensor | None) -> Tensor:
    """Per-node effective share of one device — f32 [..., N]: plain
    fractions are node-independent; memory-based requests divide by each
    node's per-device memory (no clamp: > 1 is infeasible)."""
    p = task_portion[..., None] * torch.ones_like(nodes.device_memory_gib)
    if task_accel_mem is not None:
        mem = task_accel_mem[..., None]
        by_mem = mem / torch.clamp(nodes.device_memory_gib, min=EPS)
        p = torch.where(mem > 0, by_mem, p)
    return p


def _accel_pool_ok(df: Tensor, p: Tensor, is_frac: Tensor,
                   req_accel: Tensor) -> Tensor:
    """A fractional task needs ONE device with enough free share; a
    whole-device task enough fully-free devices.  bool [..., N]."""
    frac_ok = df.amax(-1) >= p - EPS                          # [..., N]
    whole_free = (df >= 1.0 - EPS).to(torch.float32).sum(-1)  # [N]
    whole_ok = whole_free + EPS >= req_accel[..., None]
    return torch.where(is_frac[..., None], frac_ok, whole_ok)


def accel_fit_mask(nodes: NodeState, task_req: Tensor,
                   task_portion: Tensor | None,
                   task_accel_mem: Tensor | None, device_free: Tensor,
                   include_releasing: bool) -> Tensor:
    """Device-granular accel feasibility — the ``FittingGPUs`` check.
    bool [..., N]."""
    df = device_free
    if include_releasing:
        df = df + nodes.device_releasing
    req_accel = task_req[..., RESOURCE_ACCEL]
    if task_portion is None:
        is_frac = torch.zeros(req_accel.shape, dtype=torch.bool,
                              device=req_accel.device)
        p = torch.zeros(req_accel.shape + (nodes.n,),
                        device=req_accel.device)
    else:
        mem = (torch.zeros_like(task_portion) if task_accel_mem is None
               else task_accel_mem)
        is_frac = (task_portion > 0) | (mem > 0)
        p = node_portion(nodes, task_portion, task_accel_mem)
    return _accel_pool_ok(df, p, is_frac, req_accel)


def feasible_nodes(nodes: NodeState, task_req: Tensor, task_selector: Tensor,
                   task_portion: Tensor | None = None,
                   task_accel_mem: Tensor | None = None, *,
                   task_class: Tensor | None = None,
                   free: Tensor | None = None,
                   device_free: Tensor | None = None,
                   include_releasing: bool = False) -> Tensor:
    """Full predicate chain → bool [..., N]; ``include_releasing`` gives
    the pipeline variant (fits once terminating pods release)."""
    avail = nodes.free if free is None else free
    df = nodes.device_free if device_free is None else device_free
    if include_releasing:
        avail = avail + nodes.releasing
    req = task_req
    if task_portion is not None:
        # fractional / memory-based accel is checked at device granularity
        # — drop it from the node-sum check
        mem = (torch.zeros_like(task_portion) if task_accel_mem is None
               else task_accel_mem)
        is_frac = (task_portion > 0) | (mem > 0)
        req = req.clone()
        req[..., RESOURCE_ACCEL] = torch.where(
            is_frac, 0.0, req[..., RESOURCE_ACCEL])
    fit = resource_fit_mask(avail, req)
    accel = accel_fit_mask(nodes, task_req, task_portion, task_accel_mem,
                           df, include_releasing)
    sel = selector_mask(nodes.labels, task_selector)
    out = fit & accel & sel & nodes.valid
    if task_class is not None:
        # taints/affinity/pod-affinity, host-evaluated per filter class
        out = out & nodes.filter_masks[task_class.long()]
    return out


def feasible_nodes_dual(nodes: NodeState, task_req: Tensor,
                        task_selector: Tensor, task_portion: Tensor,
                        task_accel_mem: Tensor, *, free: Tensor,
                        device_free: Tensor | None,
                        extra_releasing: Tensor,
                        extra_device_releasing: Tensor | None,
                        devices: bool = True,
                        task_class: Tensor | None = None
                        ) -> tuple[Tensor, Tensor]:
    """(fit_idle, fit_pipe) in one pass, sharing the selector/validity
    work between the idle pool and the idle+releasing (pipeline) pool.
    Batched over any leading dims of ``task_req`` [..., R].

    ``devices=False`` (the allocate main path) skips the device table —
    exact when the snapshot holds no fractional/memory-based tasks."""
    is_frac = (task_portion > 0) | (task_accel_mem > 0)
    sel = selector_mask(nodes.labels, task_selector) & nodes.valid
    if task_class is not None:
        sel = sel & nodes.filter_masks[task_class.long()]
    if not devices:
        fit_idle = resource_fit_mask(free, task_req) & sel
        avail = free + nodes.releasing + extra_releasing
        fit_pipe = resource_fit_mask(avail, task_req) & sel
        return fit_idle, fit_pipe
    req_nosum = task_req.clone()
    req_nosum[..., RESOURCE_ACCEL] = torch.where(
        is_frac, 0.0, task_req[..., RESOURCE_ACCEL])
    p = node_portion(nodes, task_portion, task_accel_mem)
    req_accel = task_req[..., RESOURCE_ACCEL]

    def pools(avail, df):
        return (resource_fit_mask(avail, req_nosum)
                & _accel_pool_ok(df, p, is_frac, req_accel))

    fit_idle = pools(free, device_free) & sel
    fit_pipe = pools(
        free + nodes.releasing + extra_releasing,
        device_free + nodes.device_releasing + extra_device_releasing) & sel
    return fit_idle, fit_pipe
