"""Wrappers of the CUDA matmul kernels (``csrc/matmul.cu``).

Counterpart of ``repro/kernels/matmul.py``: ``matmul`` computes
``act(x @ w + bias)`` and ``gated_matmul`` ``act(x @ w1) * (x @ w1b)``,
fp32 sums, output in x's dtype.  ``tile_matmul`` is the counterpart of
``repro/kernels/ring_matmul.py::_tile_mm_raw``: ``x @ w`` with an
``out_dtype``, where either operand may be a transposed view (``w.t()``,
``x.t()``), which the kernel reads in place.  All take CUDA tensors only
and raise on anything the kernel does not take; the CPU path lives in
``kernels/ops.py``.
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


def _launch(fn: str, x, ws, bias, act: str, n_ws: int, keep_ab: bool = False):
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
    ab = [torch.empty((M, N), dtype=torch.float32, device=x.device)
          for _ in range(2 if keep_ab else 0)]
    extra = ([t.data_ptr() for t in ab] or [None, None]) if n_ws == 2 else []
    code = getattr(lib, fn)(
        x.data_ptr(), *ptrs, out.data_ptr(),
        work.data_ptr() if work is not None else None, *extra,
        M, N, K, ACTS[act], DTYPES[x.dtype], splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, fn)
    return (out, *ab) if keep_ab else out


def matmul(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           *, act: str = "none") -> torch.Tensor:
    """y = act(x @ w + bias) on the card.  x [M,K], w [K,N]."""
    return _launch("hk_matmul", x, (w,), bias, act, 1)


def gated_matmul(x: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor, *,
                 act: str = "silu", keep_ab: bool = False):
    """y = act(x @ w1) * (x @ w1b) on the card; one x tile feeds both.

    ``keep_ab`` also returns the fp32 products ``a = x @ w1`` and
    ``b = x @ w1b`` as ``(y, a, b)``: the SwiGLU backward reads them."""
    return _launch("hk_gated_matmul", x, (w1, w1b), None, act, 2, keep_ab)


def layout(t: torch.Tensor):
    """(transposed, leading dim) of a 2-D operand: row-major with rows
    ``stride(0)`` apart, or column-major (a ``.t()`` view of a row-major
    tensor) with columns ``stride(1)`` apart.  Raises on anything else."""
    rows, cols = t.shape
    if t.stride(1) == 1 and (rows <= 1 or t.stride(0) >= cols):
        return False, t.stride(0) if rows > 1 else cols
    if t.stride(0) == 1 and (cols <= 1 or t.stride(1) >= rows):
        return True, t.stride(1) if cols > 1 else rows
    raise ValueError(f"operand of shape {tuple(t.shape)} and strides {t.stride()} is "
                     "neither row- nor column-major")


def tile_matmul(x: torch.Tensor, w: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w on the card with fp32 sums, stored in ``out_dtype`` (x's dtype
    or fp32).  x [M,K] and w [K,N] are each row-major or a transposed view;
    both transposed is refused.  Any extent: stored rows (K for x, M for
    x.t(), N for w, K for w.t()) off 8 elements are read element by element."""
    if x.device.type != "cuda":
        raise ValueError(f"CUDA tile matmul kernel got a {x.device} tensor")
    if x.dtype not in DTYPES:
        raise TypeError(f"CUDA tile matmul takes fp32 or bf16, got {x.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or x.shape[0] < 1:
        raise ValueError(f"need x [M,K], w [K,N]; got {tuple(x.shape)}, {tuple(w.shape)}")
    if w.device != x.device or w.dtype != x.dtype:
        raise TypeError("x and w must share device and dtype")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {x.dtype} or float32, got {out_dtype}")
    M, K = x.shape
    N = w.shape[1]
    ta, lda = layout(x)
    tb, ldb = layout(w)
    if ta and tb:
        raise ValueError("x and w are both transposed views; the kernel takes one at most")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    lib = build.library("matmul")
    code = lib.hk_tile_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, lda, ldb, int(ta), int(tb),
        DTYPES[x.dtype], DTYPES[out_dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, "hk_tile_matmul")
    return out
