"""Wrappers of the CUDA matmul kernels (``csrc/matmul.cu``).

Counterpart of ``repro/kernels/matmul.py``: ``matmul`` computes
``act(x @ w + bias)`` and ``gated_matmul`` ``act(x @ w1) * (x @ w1b)``,
fp32 sums, output in x's dtype.  ``tile_matmul`` is the counterpart of
``repro/kernels/ring_matmul.py::_tile_mm_raw``: ``x @ w`` with an
``out_dtype``, where either operand may be a transposed view (``w.t()``,
``x.t()``), which the kernel reads in place.  All take CUDA tensors only
and raise on anything the kernel does not take; the CPU path lives in
``kernels/ops.py``.

Each call takes one of four paths (``IMPLS``), which :func:`mm_impl`
chooses from the dtype, the shapes and the strides alone:

* ``"wgmma"``: bf16 on Hopper's tensor cores through wgmma, operands
  staged by TMA, persistent blocks; every bf16 ``matmul`` with M > 16 and
  every bf16 ``tile_matmul`` whose operands TMA can address (leading dims
  and addresses on 16 bytes).  :func:`wg_plan` picks its tile width and
  how far K is split so that the product fills the SMs;
* ``"wmma"``: the bf16 kernel on ``mma.sync``, for operands TMA cannot
  address (the ring backward's ragged dw products) and the gated matmul;
* ``"skinny"``: M <= 16 (decode) in ``matmul`` and ``gated_matmul``,
  streaming the weights with K split over blocks;
* ``"simt"``: fp32 operands, held to 2e-4.

``impl=`` overrides the choice (the card's tests and ``chip_smoke.py`` run
both tensor-core paths on the same inputs); a path that cannot take the
operands raises, and a kernel that fails raises: nothing falls back to
another path.  ``IMPL_LAUNCHES`` counts the launches of each path.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build

ACTS = {"none": 0, "relu2": 1, "gelu": 2, "silu": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
IMPLS = ("wgmma", "wmma", "simt", "skinny")   # numbered as csrc/matmul.cu's IMPL_*
SKINNY_M = 16          # M at or below this takes the split-K streaming path
SMS = 132              # H100 SXM streaming multiprocessors
WG_BM, WG_BK = 128, 64  # rows of a wgmma tile (two warpgroups of 64), K of a stage
WG_BNS = (128, 256)     # tile widths of the wgmma path
WG_MIN_KPER = 10        # k-blocks of 64 a split of K keeps at least
WG_MAX_SPLITS = 16

# launches per path, counted where each wrapper launches its kernel
IMPL_LAUNCHES: Dict[str, Dict[str, int]] = {
    "matmul": {p: 0 for p in IMPLS}, "tile_matmul": {p: 0 for p in IMPLS}}


def reset_impl_launches() -> None:
    """Zero ``IMPL_LAUNCHES``."""
    for counts in IMPL_LAUNCHES.values():
        for path in counts:
            counts[path] = 0


def split_k(M: int, N: int, K: int) -> int:
    """K splits of the skinny path: enough 64-column blocks to keep about
    four per SM reading weights, with chunks of at least 64 rows."""
    if M > SKINNY_M:
        return 1
    col_blocks = -(-N // 64)
    return max(1, min(-(-4 * SMS // col_blocks), K // 64))


def mm_impl(dtype: torch.dtype, M: int, N: int, K: int, ta: bool = False, tb: bool = False,
            lda: Optional[int] = None, ldb: Optional[int] = None, ptr_align: int = 16, *,
            tile: bool = False) -> str:
    """The path of one product x [M,K] @ w [K,N]: ``ta``/``tb`` say an
    operand is a transposed view, ``lda``/``ldb`` its leading dim (by
    default the stored row length), ``ptr_align`` the byte alignment both
    operands' addresses share; ``tile`` for ``tile_matmul``, which has no
    skinny path.  ``"skinny"`` for M <= 16 in ``matmul``; else ``"simt"``
    for fp32; else ``"wgmma"`` when TMA can address both operands (leading
    dims on 8 elements, addresses on 16 bytes); else ``"wmma"``."""
    if not tile and M <= SKINNY_M:
        return "skinny"
    if dtype != torch.bfloat16:
        return "simt"
    lda = (M if ta else K) if lda is None else lda
    ldb = (K if tb else N) if ldb is None else ldb
    if min(M, N, K) >= 1 and lda % 8 == 0 and ldb % 8 == 0 and ptr_align % 16 == 0:
        return "wgmma"
    return "wmma"


def wg_plan(M: int, N: int, K: int) -> Tuple[int, int]:
    """(tile width, K splits) of a wgmma product.  The rules follow the
    sweep of every main-path product over the candidate plans on the H100
    (``tools/wg_plans.py``; its table is in PERF.md):

    * 256-wide tiles when they make many waves (4 x SMS or more: the
      heads, where their better ratio of products to operand bytes pays),
      when one wave of them covers at least 70% of the SMs over a K loop
      of 32 k-blocks or more, or when K alone is long (256 k-blocks or
      more: the head's dx, split below); else 128-wide, whose shorter
      epilogue wins at a K loop of 16;
    * K split only while the tiles cover at most half the SMs: into at
      most SMS // tiles parts of at least WG_MIN_KPER k-blocks each (a
      shorter loop loses more to the fp32 partials' round trip than the
      extra SMs win), none of them empty (:func:`split_ranges`)."""
    mt, kb = -(-M // WG_BM), -(-K // WG_BK)
    wide = mt * -(-N // 256)
    bn = 256 if (wide >= 4 * SMS or (kb >= 32 and wide >= 0.7 * SMS) or kb >= 256) else 128
    tiles = mt * -(-N // bn)
    splits = max(1, min(SMS // tiles, kb // WG_MIN_KPER, WG_MAX_SPLITS))
    if splits > 1:
        splits = -(-kb // -(-kb // splits))       # no split left empty
    return bn, splits


def split_ranges(K: int, splits: int) -> List[Tuple[int, int]]:
    """The k-blocks [kb0, kb1) of each split, as the wgmma kernel walks them:
    ceil(kblocks / splits) each, the last one shorter."""
    kb = -(-K // WG_BK)
    per = -(-kb // splits)
    return [(s * per, min(kb, (s + 1) * per)) for s in range(splits)]


def shared_align(*ts: torch.Tensor) -> int:
    """The byte alignment all these tensors' addresses share (up to 256)."""
    return math.gcd(256, *(t.data_ptr() for t in ts))


def _choose(impl: Optional[str], chosen: str, dtype: torch.dtype, M: int, tile: bool,
            tma: bool) -> str:
    """``impl`` (or the chosen path) after checking that it takes these
    operands; ``tma``: whether TMA can address them."""
    impl = impl or chosen
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl in ("wgmma", "wmma") and dtype != torch.bfloat16:
        raise TypeError(f"the {impl} path takes bf16, got {dtype}")
    if impl == "simt" and dtype != torch.float32:
        raise TypeError(f"the simt path takes fp32, got {dtype}")
    if impl == "skinny" and (tile or M > SKINNY_M):
        raise ValueError(f"the skinny path takes matmul with M <= {SKINNY_M}")
    if impl == "wgmma" and not tma:
        raise ValueError("TMA cannot address these operands (a leading dim or an address "
                         "off 16 bytes): the wgmma path does not take them")
    return impl


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


def _launch(fn: str, x, ws, bias, act: str, n_ws: int, keep_ab: bool = False,
            impl: Optional[str] = None):
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
    lib = build.library("matmul")
    ptrs = [t.data_ptr() for t in ws] + ([] if n_ws == 2 else
                                         [bias.data_ptr() if bias is not None else None])
    if n_ws == 2:           # the gated kernel: skinny for M <= 16, else wmma or simt
        splits = split_k(M, N, K)
        work = (torch.empty(n_ws * splits * M * N, dtype=torch.float32, device=x.device)
                if M <= SKINNY_M else None)
        ab = [torch.empty((M, N), dtype=torch.float32, device=x.device)
              for _ in range(2 if keep_ab else 0)]
        extra = [t.data_ptr() for t in ab] or [None, None]
        tail = [splits]
    else:
        ab = []
        # _check keeps K, N and the addresses on 16 bytes: TMA addresses every bf16 operand
        impl = _choose(impl, mm_impl(x.dtype, M, N, K), x.dtype, M, tile=False,
                       tma=x.dtype == torch.bfloat16)
        bn, splits = wg_plan(M, N, K) if impl == "wgmma" else (0, split_k(M, N, K))
        work = (torch.empty(splits * M * N, dtype=torch.float32, device=x.device)
                if impl == "skinny" or splits > 1 else None)
        extra = []
        tail = [splits, IMPLS.index(impl), bn]
    code = getattr(lib, fn)(
        x.data_ptr(), *ptrs, out.data_ptr(),
        work.data_ptr() if work is not None else None, *extra,
        M, N, K, ACTS[act], DTYPES[x.dtype], *tail,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, fn)
    if n_ws == 1:
        IMPL_LAUNCHES["matmul"][impl] += 1
    return (out, *ab) if keep_ab else out


def matmul(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           *, act: str = "none", impl: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ w + bias) on the card.  x [M,K], w [K,N].  ``impl``: the
    path, by default :func:`mm_impl`'s choice."""
    return _launch("hk_matmul", x, (w,), bias, act, 1, impl=impl)


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
                out_dtype: Optional[torch.dtype] = None,
                impl: Optional[str] = None) -> torch.Tensor:
    """x @ w on the card with fp32 sums, stored in ``out_dtype`` (x's dtype
    or fp32).  x [M,K] and w [K,N] are each row-major or a transposed view;
    both transposed is refused.  Any extent: operands TMA cannot address
    take the wmma path, which reads stored rows off 8 elements element by
    element.  ``impl``: the path, by default :func:`mm_impl`'s choice."""
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
    chosen = mm_impl(x.dtype, M, N, K, ta, tb, lda, ldb, shared_align(x, w), tile=True)
    impl = _choose(impl, chosen, x.dtype, M, tile=True, tma=chosen == "wgmma")
    bn, splits = wg_plan(M, N, K) if impl == "wgmma" else (0, 1)
    work = (torch.empty(splits * M * N, dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    lib = build.library("matmul")
    code = lib.hk_tile_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        work.data_ptr() if work is not None else None, M, N, K, lda, ldb, int(ta), int(tb),
        DTYPES[x.dtype], DTYPES[out_dtype], IMPLS.index(impl), bn, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, "hk_tile_matmul")
    IMPL_LAUNCHES["tile_matmul"][impl] += 1
    return out
