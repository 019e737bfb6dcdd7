"""Wrappers of the CUDA matmul kernels (``csrc/matmul.cu``).

Counterpart of ``repro/kernels/matmul.py``: ``matmul`` computes
``act(x @ w + bias)`` and ``gated_matmul`` ``act(x @ w1) * (x @ w1b)``,
fp32 sums, output in x's dtype.  ``tile_matmul`` is the counterpart of
``repro/kernels/ring_matmul.py::_tile_mm_raw``: ``x @ w`` with an
``out_dtype``, where either operand may be a transposed view (``w.t()``,
``x.t()``), which the kernel reads in place.  All take CUDA tensors only
and raise on anything the kernel does not take; the CPU path lives in
``kernels/ops.py``.

Each call takes one of five paths (``IMPLS``), which :func:`mm_impl`
chooses from the dtype, the shapes and the strides alone:

* ``"wgmma"``: bf16 on Hopper's tensor cores through wgmma, operands
  staged by TMA, persistent blocks; every bf16 ``matmul`` and
  ``gated_matmul`` with M > 16 and every bf16 ``tile_matmul`` whose
  operands TMA can address (leading dims and addresses on 16 bytes).
  :func:`wg_plan` picks its tile width and how far K is split so that the
  product fills the SMs;
* ``"gemv"``: bf16 with M <= 16 (decode) in ``matmul`` and
  ``gated_matmul``: the weights streamed by TMA at the memory rate, the
  products on ``mma.sync``, K split over the blocks of a cluster
  (:func:`gemv_plan`) and summed in the same launch;
* ``"wmma"``: the bf16 kernel on ``mma.sync``, for operands TMA cannot
  address (the ring backward's ragged dw products);
* ``"skinny"``: fp32 with M <= 16, streaming the weights with K split over
  blocks and a second kernel adding the splits;
* ``"simt"``: fp32 operands, held to 2e-4.

``impl=`` overrides the choice (the card's tests and ``chip_smoke.py`` run
the old and the new bf16 path on the same inputs: wgmma against wmma,
gemv against skinny); a path that cannot take the operands raises, and a
kernel that fails raises: nothing falls back to another path.
``IMPL_LAUNCHES`` counts the launches of each path.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build

ACTS = {"none": 0, "relu2": 1, "gelu": 2, "silu": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
IMPLS = ("wgmma", "wmma", "simt", "skinny", "gemv")  # numbered as csrc/matmul.cu's IMPL_*
SKINNY_M = 16          # M at or below this takes a decode path (gemv, or skinny for fp32)
SMS = 132              # H100 SXM streaming multiprocessors
WG_BM, WG_BK = 128, 64  # rows of a wgmma tile (two warpgroups of 64), K of a stage
WG_BNS = (128, 256)     # tile widths of the wgmma path
WG_MIN_KPER = 10        # k-blocks of 64 a split of K keeps at least
WG_MIN_KPER_GATED = 8   # the same for the gate, whose units do two products
WG_MAX_SPLITS = 16
GV_BN, GV_BK = 128, 64  # columns of a gemv block's weight panel, rows of a stage
GV_MAX_SPLITS = 8       # K splits of a gemv panel: the blocks of one (portable) cluster
GV_SMEM = 232448        # shared memory a block may use
GV_RING = {False: 4 * GV_BN * GV_BK * 2, True: 3 * 2 * GV_BN * GV_BK * 2}  # stages' bytes

# launches per path, counted where each wrapper launches its kernel
IMPL_LAUNCHES: Dict[str, Dict[str, int]] = {
    "matmul": {p: 0 for p in IMPLS}, "gated_matmul": {p: 0 for p in IMPLS},
    "tile_matmul": {p: 0 for p in IMPLS if p != "gemv"}}


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
    decode path.  For M <= 16 in ``matmul`` (and ``gated_matmul``):
    ``"gemv"`` for bf16, ``"skinny"`` for fp32; else ``"simt"`` for fp32;
    else ``"wgmma"`` when TMA can address both operands (leading dims on 8
    elements, addresses on 16 bytes); else ``"wmma"``."""
    if not tile and M <= SKINNY_M:
        return "gemv" if dtype == torch.bfloat16 else "skinny"
    if dtype != torch.bfloat16:
        return "simt"
    lda = (M if ta else K) if lda is None else lda
    ldb = (K if tb else N) if ldb is None else ldb
    if min(M, N, K) >= 1 and lda % 8 == 0 and ldb % 8 == 0 and ptr_align % 16 == 0:
        return "wgmma"
    return "wmma"


def gated_impl(dtype: torch.dtype, M: int, N: int, K: int) -> str:
    """The path of one gated product x [M,K] @ (w1, w1b) [K,N]: the plain
    product's (:func:`mm_impl`), since ``gated_matmul`` takes contiguous
    operands on 16 bytes only: gemv (bf16) or skinny (fp32) for M <= 16,
    else wgmma (bf16) or simt (fp32)."""
    return mm_impl(dtype, M, N, K)


def wg_plan(M: int, N: int, K: int, gated: bool = False) -> Tuple[int, int]:
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
      extra SMs win), none of them empty (:func:`split_ranges`).

    ``gated``: the gated tile is 128 wide (two accumulators of 64 x 128
    fill a consumer's registers as one 64 x 256 does), and a split keeps 8
    k-blocks or more, since a unit does two products: the gate's sweep
    (PERF.md) has M = 77 (24 tiles) 23% faster split in two, M = 512 (96
    tiles) unsplit."""
    mt, kb = -(-M // WG_BM), -(-K // WG_BK)
    wide = mt * -(-N // 256)
    bn = 256 if (not gated and (wide >= 4 * SMS or (kb >= 32 and wide >= 0.7 * SMS)
                                or kb >= 256)) else 128
    tiles = mt * -(-N // bn)
    min_kper = WG_MIN_KPER_GATED if gated else WG_MIN_KPER
    splits = max(1, min(SMS // tiles, kb // min_kper, WG_MAX_SPLITS))
    if splits > 1:
        splits = -(-kb // -(-kb // splits))       # no split left empty
    return bn, splits


def gemv_plan(M: int, N: int, K: int, gated: bool = False, experts: int = 1) -> int:
    """K splits of a gemv product: the 128-column panels split until they
    make at least one block per SM (ranges of kblocks // ceil(SMS / panels)
    64-deep k-blocks, at least one), or further where x's rows of a range
    would not fit in a block's shared memory beside the ring of stages, up
    to GV_MAX_SPLITS, the blocks of one cluster; none left empty.  Raises
    where even that many ranges do not fit.  ``experts``: the MoE's grouped
    form (``kernels/moe.py``), one such product an expert, whose panels
    all fill the SMs together."""
    kb, panels = -(-K // GV_BK), experts * -(-N // GV_BN)
    room = (GV_SMEM - GV_RING[gated] - 2048) // (2 * M) - 8      # x's elements a row
    kper = max(1, min(kb // -(-SMS // panels), room // GV_BK), -(-kb // GV_MAX_SPLITS))
    if kper * GV_BK > room:
        raise ValueError(f"K={K} is too long for the gemv path at M={M}: at most "
                         f"{GV_MAX_SPLITS * (room // GV_BK) * GV_BK}")
    return -(-kb // kper)


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
    if impl in ("wgmma", "wmma", "gemv") and dtype != torch.bfloat16:
        raise TypeError(f"the {impl} path takes bf16, got {dtype}")
    if impl == "simt" and dtype != torch.float32:
        raise TypeError(f"the simt path takes fp32, got {dtype}")
    if impl in ("skinny", "gemv") and (tile or M > SKINNY_M):
        raise ValueError(f"the {impl} path takes matmul or gated_matmul with M <= {SKINNY_M}")
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


def plan(impl: str, M: int, N: int, K: int, gated: bool = False) -> Tuple[int, int]:
    """(tile width, K splits) of a ``matmul`` or ``gated_matmul`` call on
    ``impl``: wgmma's from :func:`wg_plan`, gemv's from :func:`gemv_plan`,
    skinny's from :func:`split_k`; the other paths do not split."""
    if impl == "wgmma":
        return wg_plan(M, N, K, gated)
    if impl == "gemv":
        return GV_BN, gemv_plan(M, N, K, gated)
    return 0, split_k(M, N, K) if impl == "skinny" else 1


def _launch(fn: str, x, ws, bias, act: str, keep_ab: bool = False,
            impl: Optional[str] = None):
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    _check(x, *ws)
    M, K = x.shape
    N = ws[0].shape[1]
    gated = len(ws) == 2
    if bias is not None:
        if bias.shape != (N,) or bias.dtype != x.dtype or bias.device != x.device \
                or not bias.is_contiguous():
            raise ValueError("bias must be a contiguous [N] tensor like x")
    # _check keeps K, N and the addresses on 16 bytes: TMA addresses every bf16 operand
    impl = _choose(impl, mm_impl(x.dtype, M, N, K), x.dtype, M, tile=False,
                   tma=x.dtype == torch.bfloat16)
    bn, splits = plan(impl, M, N, K, gated)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    work = (torch.empty(len(ws) * splits * M * N, dtype=torch.float32, device=x.device)
            if impl == "skinny" or (impl == "wgmma" and splits > 1) else None)
    ab = [torch.empty((M, N), dtype=torch.float32, device=x.device)
          for _ in range(2 if keep_ab else 0)]
    ptrs = [t.data_ptr() for t in ws]
    if gated:
        extra = [t.data_ptr() for t in ab] or [None, None]
    else:
        ptrs.append(bias.data_ptr() if bias is not None else None)
        extra = []
    lib = build.library("matmul")
    code = getattr(lib, fn)(
        x.data_ptr(), *ptrs, out.data_ptr(),
        work.data_ptr() if work is not None else None, *extra,
        M, N, K, ACTS[act], DTYPES[x.dtype], splits, IMPLS.index(impl), bn,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, fn)
    IMPL_LAUNCHES["gated_matmul" if gated else "matmul"][impl] += 1
    return (out, *ab) if keep_ab else out


def matmul(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           *, act: str = "none", impl: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ w + bias) on the card.  x [M,K], w [K,N].  ``impl``: the
    path, by default :func:`mm_impl`'s choice."""
    return _launch("hk_matmul", x, (w,), bias, act, impl=impl)


def gated_matmul(x: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor, *,
                 act: str = "silu", keep_ab: bool = False, impl: Optional[str] = None):
    """y = act(x @ w1) * (x @ w1b) on the card; one x tile feeds both.

    ``keep_ab`` also returns the fp32 products ``a = x @ w1`` and
    ``b = x @ w1b`` as ``(y, a, b)``: the SwiGLU backward reads them.
    ``impl``: the path, by default :func:`gated_impl`'s choice."""
    return _launch("hk_gated_matmul", x, (w1, w1b), None, act, keep_ab, impl)


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
