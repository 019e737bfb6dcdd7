"""Wrapper of the CUDA SwiGLU backward kernel (``csrc/swiglu_bwd.cu``).

The elementwise half of the gated FFN's derivative: from the gradient g
of ``act(a) * b`` and the fp32 products a, b it returns
``(g * b * act'(a), g * act(a))`` in g's dtype.  CUDA tensors only; the
CPU path lives in ``kernels/ops.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

ACTS = {"gelu": 2, "silu": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def swiglu_bwd(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
               act: str = "silu"):
    """(dA, dB) for h = act(a) * b; g in the compute dtype, a and b fp32,
    all the same shape and contiguous."""
    if g.device.type != "cuda":
        raise ValueError(f"CUDA SwiGLU backward kernel got a {g.device} tensor")
    if act not in ACTS:
        raise ValueError(f"the gated backward takes {sorted(ACTS)}, got {act!r}")
    if g.dtype not in DTYPES:
        raise TypeError(f"SwiGLU backward takes fp32 or bf16 gradients, got {g.dtype}")
    for t in (g, a, b):
        if t.shape != g.shape or t.device != g.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("g, a, b must share shape and device, contiguous and "
                             "16-byte aligned")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("a and b are the fp32 products of the forward")
    da, db = torch.empty_like(g), torch.empty_like(g)
    lib = build.library("swiglu_bwd")
    code = lib.hk_swiglu_bwd(g.data_ptr(), a.data_ptr(), b.data_ptr(), da.data_ptr(),
                             db.data_ptr(), g.numel(), ACTS[act], DTYPES[g.dtype],
                             torch.cuda.current_stream(g.device).cuda_stream)
    build.check(lib, code, "hk_swiglu_bwd")
    return da, db
