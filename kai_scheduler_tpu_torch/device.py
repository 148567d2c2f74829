"""Device selection for the port's entry points.

Every entry point takes ``device=`` (default ``"cuda"``) and resolves it
here.  There is no silent fallback: asking for CUDA on a machine without
a CUDA device raises, and the CPU (where the kernels' plain PyTorch
versions run) is used only when the caller asks for it.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: "str | torch.device | None" = DEFAULT_DEVICE
                   ) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "kernels' plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
