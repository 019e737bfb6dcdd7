"""Gradient-compression hooks of ZeRO.

Counterpart of ``repro/parallel/zero.py::compress_grads``: under ``grad_reduce_dtype="bf16"`` each
microbatch's gradients are rounded to bf16 before the fp32 sum, as the
JAX package rounds the cross-data-axis reduction payload.  The moment
sharding (``state_spec``) arrives with the grid slice.
"""

from __future__ import annotations

from typing import Sequence

import torch


def compress_grads(grads: Sequence[torch.Tensor], dtype_name: str):
    if dtype_name == "fp32":
        return list(grads)
    if dtype_name == "bf16":
        return [g.to(torch.bfloat16) for g in grads]
    raise KeyError(dtype_name)

