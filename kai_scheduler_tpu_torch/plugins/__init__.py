"""Score-plugin registry — composable score-tensor plugins.

Port of ``kai_scheduler_tpu/plugins``: a scoring plugin is a pure
``ScoreContext -> [..., N] score band`` function, the configuration is a
tuple of plugin names (string-selectable, orderable, disableable), and
composition is a sum in tier order — each plugin already scales itself
into its score band (``plugins/scores/scores.go``).
"""
from .registry import (ScoreContext, available_plugins, compose,
                       parse_tiers, register_score_plugin, resolve)

__all__ = [
    "ScoreContext", "available_plugins", "compose", "parse_tiers",
    "register_score_plugin", "resolve",
]
