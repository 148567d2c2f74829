"""Node-order scoring — the NodeOrderFn plugin family, tensorized.

Port of ``kai_scheduler_tpu/ops/scoring.py``.  Each plugin is a pure
function producing a ``[..., N]`` score tensor and composition is a sum
in tier order.  Score bands follow ``plugins/scores/scores.go:7-14`` so
plugin priorities compose exactly as in the reference: a higher band
always dominates all lower bands combined.

The f32 order of every operation follows the reference (``(na - mn) /
max(span, 1e-30)``, ``1 - frac``, ``9 * raw``, bands summed from 0 in tier
order, then ``+ extra``), so the scores are bit-identical to it.  The
device-granular bands (gpusharingorder, ``pick_device``) belong to the
per-task path and wait for its slice.
"""
from __future__ import annotations

import dataclasses

import torch

from ..apis.types import RESOURCE_ACCEL, RESOURCE_CPU
from ..state.cluster_state import NodeState

Tensor = torch.Tensor

# ref plugins/scores/scores.go
MAX_HIGH_DENSITY = 9.0
W_RESOURCE_TYPE = 10.0
W_AVAILABILITY = 100.0
W_GPU_SHARING = 1_000.0
W_TOPOLOGY = 10_000.0
W_K8S_PLUGINS = 100_000.0
W_NOMINATED = 1_000_000.0
#: wavefront-only band of the victim actions (see the reference module)
W_OWN_FREED = 9.5

BIG_NEG = -1e30

#: the default scoring tiers (ref ``conf_util/scheduler_conf_util.go:40-60``)
DEFAULT_TIERS = ("nodeplacement", "resourcetype", "nodeavailability")


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """binpack vs spread per resource type — ref nodeplacement plugin
    args and SchedulingShard.PlacementStrategy."""

    binpack_accel: bool = True
    binpack_cpu: bool = True
    #: gpupack vs gpuspread at the device granularity
    device_pack: bool = True
    #: the scoring plugin tiers (registry names, ordered)
    tiers: tuple[str, ...] = DEFAULT_TIERS


def density_score(non_allocated: Tensor, allocatable: Tensor,
                  fit_mask: Tensor, *, binpack: bool) -> Tensor:
    """Binpack/spread score in [0, MAX_HIGH_DENSITY] — ref
    ``nodeplacement/pack.go``: normalize each node's non-allocated amount
    into the [min, max] range over fitting nodes that have the resource;
    min == max degenerates to the max score for all."""
    has_res = allocatable > 0
    cand = fit_mask & has_res
    big = torch.finfo(non_allocated.dtype).max
    mn = torch.where(cand, non_allocated, big).amin(-1, keepdim=True)
    mx = torch.where(cand, non_allocated, -big).amax(-1, keepdim=True)
    span = mx - mn
    frac = torch.where(span > 0,
                       (non_allocated - mn) / torch.clamp(span, min=1e-30),
                       0.0)
    raw = torch.where(span > 0, (1.0 - frac) if binpack else frac, 1.0)
    return torch.where(cand, MAX_HIGH_DENSITY * raw, 0.0)


def placement_score(nodes: NodeState, free: Tensor, task_req: Tensor,
                    fit_mask: Tensor,
                    config: PlacementConfig = PlacementConfig()) -> Tensor:
    """nodeplacement plugin: density on the task's dominant resource —
    accel density for accel tasks, cpu density for cpu-only tasks."""
    non_alloc = free + nodes.releasing
    is_accel_task = task_req[..., RESOURCE_ACCEL] > 0
    accel_s = density_score(
        non_alloc[:, RESOURCE_ACCEL], nodes.allocatable[:, RESOURCE_ACCEL],
        fit_mask, binpack=config.binpack_accel)
    cpu_s = density_score(
        non_alloc[:, RESOURCE_CPU], nodes.allocatable[:, RESOURCE_CPU],
        fit_mask, binpack=config.binpack_cpu)
    return torch.where(is_accel_task[..., None], accel_s, cpu_s)


def resource_type_score(nodes: NodeState, task_req: Tensor) -> Tensor:
    """resourcetype plugin: +W_RESOURCE_TYPE when a CPU-only task lands on
    a CPU-only node."""
    cpu_only_task = task_req[..., RESOURCE_ACCEL] <= 0
    cpu_only_node = nodes.allocatable[:, RESOURCE_ACCEL] <= 0
    return torch.where(cpu_only_task[..., None] & cpu_only_node,
                       W_RESOURCE_TYPE, 0.0)


def availability_score(idle_fit: Tensor) -> Tensor:
    """nodeavailability plugin: +W_AVAILABILITY where the task fits on
    idle resources now (vs only after terminating pods release)."""
    return torch.where(idle_fit, W_AVAILABILITY, 0.0)


def compose_scores(fit_mask: Tensor, *components: Tensor) -> Tensor:
    """Sum plugin bands from 0 in order and mask infeasible nodes to
    BIG_NEG — ref ``session.go:243-262``."""
    total = torch.zeros(fit_mask.shape, dtype=torch.float32,
                        device=fit_mask.device)
    for c in components:
        total = total + c
    return torch.where(fit_mask, total, BIG_NEG)


def score_bands(nodes: NodeState, free: Tensor, task_req: Tensor,
                fit_idle: Tensor, fit_pipeline: Tensor,
                config: PlacementConfig = PlacementConfig()) -> Tensor:
    """The configured plugin tiers summed (no mask, no extra bands) —
    f32 [..., N]; the first term of :func:`score_nodes_for_task`."""
    from ..plugins import ScoreContext, compose
    ctx = ScoreContext(nodes=nodes, free=free, task_req=task_req,
                       fit_idle=fit_idle, fit_pipe=fit_pipeline,
                       placement=config)
    return compose(ctx, config.tiers)


def score_nodes_for_task(nodes: NodeState, free: Tensor, task_req: Tensor,
                         fit_idle: Tensor, fit_pipeline: Tensor,
                         config: PlacementConfig = PlacementConfig(),
                         extra: Tensor | None = None) -> Tensor:
    """The configured scoring stack — f32 [..., N] with infeasible nodes
    at BIG_NEG (``config.tiers`` selects and orders the plugins)."""
    comps = [score_bands(nodes, free, task_req, fit_idle, fit_pipeline,
                         config)]
    if extra is not None:
        comps.append(extra)
    return compose_scores(fit_pipeline, *comps)


def _register_builtins() -> None:
    from ..plugins import register_score_plugin

    @register_score_plugin("nodeplacement")
    def _nodeplacement(ctx):
        return placement_score(ctx.nodes, ctx.free, ctx.task_req,
                               ctx.fit_pipe, ctx.placement)

    @register_score_plugin("resourcetype")
    def _resourcetype(ctx):
        return resource_type_score(ctx.nodes, ctx.task_req)

    @register_score_plugin("nodeavailability")
    def _nodeavailability(ctx):
        return availability_score(ctx.fit_idle)


_register_builtins()
