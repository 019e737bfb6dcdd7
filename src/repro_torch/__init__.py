"""PyTorch + CUDA port of the ``repro`` package for one NVIDIA Hopper card.

Module names mirror ``src/repro/`` so each piece has an obvious counterpart.
The package imports torch, numpy and the stdlib only (never ``jax`` and
never ``repro``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; :func:`resolve_device` raises when no card is present
instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when a CUDA device is requested and none is available, so a
    missing card never turns silently into a CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
