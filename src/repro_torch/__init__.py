"""PyTorch + CUDA port of the ``repro`` package for one NVIDIA Hopper card.

Module names mirror ``src/repro/`` so each piece has an obvious counterpart.
The package imports torch, numpy and the stdlib only (never ``jax`` and
never ``repro``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; :func:`resolve_device` raises when no card is present
instead of falling back.  The package's ``__init__`` imports no torch
(only :func:`resolve_device` does), so a checkpoint writer process that
imports ``repro_torch.runtime.procs`` loads numpy and the stdlib only.
"""

from __future__ import annotations


def resolve_device(device="cuda"):
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when a CUDA device is requested and none is available, so a
    missing card never turns silently into a CPU run."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
