"""The score-plugin registry machinery (port of the reference's
``plugins/registry.py``).

Plugins are pure functions over a :class:`ScoreContext`; registration
mirrors ``framework.RegisterPluginBuilder`` (``plugins/factory.go``) and
tier configuration mirrors the ConfigMap's plugin lists — a
``tuple[str, ...]`` of names, resolvable from a comma-separated string.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class ScoreContext:
    """Everything a scoring plugin may consult.  ``task_req`` and the
    masks may carry leading batch dimensions (one row per task type)."""

    nodes: object                 # NodeState
    free: torch.Tensor            # f32 [N, R]
    task_req: torch.Tensor        # f32 [..., R]
    fit_idle: torch.Tensor        # bool [..., N]
    fit_pipe: torch.Tensor        # bool [..., N]
    placement: object             # scoring.PlacementConfig


ScorePlugin = Callable[[ScoreContext], torch.Tensor]

_SCORE_REGISTRY: dict[str, ScorePlugin] = {}


def register_score_plugin(name: str):
    """ref ``framework.RegisterPluginBuilder`` (``plugins/factory.go:47``)."""
    def deco(fn: ScorePlugin) -> ScorePlugin:
        _SCORE_REGISTRY[name] = fn
        return fn
    return deco


def available_plugins() -> list[str]:
    _ensure_builtins()
    return sorted(_SCORE_REGISTRY)


def resolve(names: tuple[str, ...]) -> list[ScorePlugin]:
    _ensure_builtins()
    missing = [n for n in names if n not in _SCORE_REGISTRY]
    if missing:
        raise KeyError(
            f"unknown score plugins {missing}; available: "
            f"{available_plugins()}")
    return [_SCORE_REGISTRY[n] for n in names]


def parse_tiers(spec: str) -> tuple[str, ...]:
    """Comma/whitespace-separated plugin list → tier tuple."""
    return tuple(s for s in spec.replace(",", " ").split() if s)


def compose(ctx: ScoreContext, names: tuple[str, ...]) -> torch.Tensor:
    """Sum the selected plugins' bands in tier order, starting from 0 —
    f32 [..., N] (no feasibility mask)."""
    total = torch.zeros(ctx.fit_pipe.shape, dtype=torch.float32,
                        device=ctx.fit_pipe.device)
    for fn in resolve(names):
        total = total + fn(ctx)
    return total


def _ensure_builtins() -> None:
    """Builtin plugins live in ops.scoring; import lazily to avoid the
    circular import (scoring uses this registry for composition)."""
    if "nodeplacement" not in _SCORE_REGISTRY:
        from ..ops import scoring  # noqa: F401  (registers on import)
