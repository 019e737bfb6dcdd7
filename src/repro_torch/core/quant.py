"""Per-row symmetric int8 quantization of the shards a ring hop sends.

Counterpart of ``repro/core/quant.py`` (``ParallelConfig.comm_dtype=
"int8"``): the shard about to cross a ring hop is cast to int8 with one
fp32 scale per row of its trailing axis, the pair (int8 payload, fp32
scales) is sent, and the receiver dequantizes it into the operand's own
dtype.  The hop itself (``comm.q_hop``) and the ring kernels' int8
variants (``kernels/ring_matmul.py``) build on these functions; the
kernels compute the same arithmetic in CUDA.

* ``scale = max|row| / 127`` (1.0 for an all-zero row, which then
  round-trips exactly) and ``q = clip(round(x / scale), -127, 127)``;
* the division is a true fp32 division and the rounding half to even,
  as ``jnp.round``: a reciprocal multiply (what PyTorch's CUDA division
  by a Python scalar does) moves values across rounding boundaries, so
  both operands of every division here are tensors;
* :func:`quant_ok` keeps integer payloads (token ids) and trailing
  extents below :data:`MIN_QUANT_DIM` full width, per hop.
"""

from __future__ import annotations

from typing import Tuple

import torch

COMM_DTYPES = ("bf16", "int8")
# trailing extents below this keep full-width hops (the 4-byte row scale
# stops paying for itself), as in the JAX package
MIN_QUANT_DIM = 16


def check_comm_dtype(comm_dtype: str) -> str:
    """Validate a wire dtype string (a typo must not silently mean bf16)."""
    if comm_dtype not in COMM_DTYPES:
        raise ValueError(f"comm_dtype={comm_dtype!r} not in {COMM_DTYPES}")
    return comm_dtype


def quant_ok(shape, dtype: torch.dtype) -> bool:
    """May a shard of this shape and dtype cross a hop quantized?"""
    return len(shape) >= 1 and shape[-1] >= MIN_QUANT_DIM and dtype.is_floating_point


def hop_int8(comm_dtype: str, shape, dtype: torch.dtype) -> bool:
    """Does a shard of this shape and dtype cross a hop of this wire as int8?"""
    return comm_dtype == "int8" and quant_ok(shape, dtype)


def quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 of x's shape, scale fp32 of ``x.shape[:-1] + (1,)``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequant_int8(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(q, scale)`` back to ``dtype`` through one fp32 product."""
    return (q.float() * scale).to(dtype)
