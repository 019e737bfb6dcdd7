"""Wrappers of the CUDA matmul kernels (``csrc/matmul.cu``).

Counterpart of ``repro/kernels/matmul.py``: ``matmul`` computes
``act(x @ w + bias)`` and ``gated_matmul`` ``act(x @ w1) * (x @ w1b)``,
fp32 sums, output in x's dtype.  Both take CUDA tensors only and raise on
anything the kernel does not take; the CPU path lives in ``kernels/ops.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

ACTS = {"none": 0, "relu2": 1, "gelu": 2, "silu": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SKINNY_M = 16          # M at or below this takes the split-K streaming path
SMS = 132              # H100 SXM streaming multiprocessors


def split_k(M: int, N: int, K: int) -> int:
    """K splits of the skinny path: enough 64-column blocks to keep about
    four per SM reading weights, with chunks of at least 64 rows."""
    if M > SKINNY_M:
        return 1
    col_blocks = -(-N // 64)
    return max(1, min(-(-4 * SMS // col_blocks), K // 64))


def _check(x: torch.Tensor, *ws: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"CUDA matmul kernel got a {x.device} tensor")
    if x.dtype not in DTYPES:
        raise TypeError(f"CUDA matmul kernel takes fp32 or bf16, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be [M, K] with M >= 1, got {tuple(x.shape)}")
    K = x.shape[1]
    for t in (x, *ws):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError("operands must share x's device and dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte aligned")
    N = ws[0].shape[1]
    for w in ws:
        if w.dim() != 2 or tuple(w.shape) != (K, N):
            raise ValueError(f"w must be [{K}, N], got {tuple(w.shape)}")
    if K % 8 or N % 8:
        raise ValueError(f"K={K} and N={N} must be multiples of 8")


def _launch(fn: str, x, ws, bias, act: str, n_ws: int) -> torch.Tensor:
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    _check(x, *ws)
    M, K = x.shape
    N = ws[0].shape[1]
    if bias is not None:
        if bias.shape != (N,) or bias.dtype != x.dtype or bias.device != x.device \
                or not bias.is_contiguous():
            raise ValueError("bias must be a contiguous [N] tensor like x")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    splits = split_k(M, N, K)
    work = (torch.empty(n_ws * splits * M * N, dtype=torch.float32, device=x.device)
            if M <= SKINNY_M else None)
    lib = build.library("matmul")
    ptrs = [t.data_ptr() for t in ws] + ([] if n_ws == 2 else
                                         [bias.data_ptr() if bias is not None else None])
    code = getattr(lib, fn)(
        x.data_ptr(), *ptrs, out.data_ptr(),
        work.data_ptr() if work is not None else None,
        M, N, K, ACTS[act], DTYPES[x.dtype], splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, fn)
    return out


def matmul(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           *, act: str = "none") -> torch.Tensor:
    """y = act(x @ w + bias) on the card.  x [M,K], w [K,N]."""
    return _launch("hk_matmul", x, (w,), bias, act, 1)


def gated_matmul(x: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor, *,
                 act: str = "silu") -> torch.Tensor:
    """y = act(x @ w1) * (x @ w1b) on the card; one x tile feeds both."""
    return _launch("hk_gated_matmul", x, (w1, w1b), None, act, 2)
