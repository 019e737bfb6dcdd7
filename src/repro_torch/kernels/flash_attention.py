"""Wrappers of the CUDA flash-attention kernels (``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention.py``, with the mask of the
model path (``models/attention._sdpa``): per-batch ``q_offset`` and
``kv_len``.  The forward can also return each row's log-sum-exp, which the
backward (``flash_attention_bwd``, training's mask only) reads.  CUDA
tensors only; the CPU path lives in ``kernels/ops.py``.

Each call takes one of two paths: ``"wgmma"``, the bf16 kernels on the
tensor cores (K/V staged by TMA), or ``"simt"``, the fp32-FMA kernels that
keep fp32 inputs at the fp32 bound and serve decode and short prefills
with the key split.  :func:`forward_impl` and :func:`backward_impl` choose
from the shapes alone; ``impl=`` overrides them (the card's tests and
``chip_smoke.py`` run both paths on the same inputs).  A path's kernel
that fails raises: nothing falls back to the other.

q and k have their head dim dk, v and the output theirs, dv.  The
tensor-core kernels are built for (dk, dv) = (64, 64), (96, 64) and
(128, 128) (``KERNEL_DIMS``): MLA's dk 96 = dn + dr = 64 + 32 against
its dv 64 runs natively, with no column of padding.  The SIMT kernels
take (64, 64) and (128, 128).  Any other dims, multiples of 8
up to 128, run on the path's least pair that holds both
(:func:`kernel_dims`): q and k are zero-padded to its dk, v to its dv, and
the output is sliced back.  Zero columns add exact zeros to every dot
product, and the scale stays the caller's ``dk ** -0.5``.
``DIM_LAUNCHES`` counts each launch by path and kernel dims, and whether
it ran native or padded.

:func:`mla_decode` wraps the absorbed MLA decode (``csrc/mla_decode.cu``):
row 3's function with one latent kv head shared by every query head, on
two routes that :func:`mla_impl` chooses between: ``"wgmma"`` (bf16 on the
tensor cores, the latent tiles by TMA) or ``"simt"`` (fp32 FMAs: fp32
inputs, and bf16 in a layout TMA does not take).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, Optional, Tuple

import torch

import torch.nn.functional as F

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the (dk, dv) pairs each path's kernels are built for, least work first
KERNEL_DIMS = {"wgmma": ((64, 64), (96, 64), (128, 128)), "simt": ((64, 64), (128, 128))}
MAX_HEAD_DIM = 128
BQ, BK = 16, 32        # rows per block and keys per tile of the SIMT kernels
TC_ROWS = 64           # rows per block of the tensor-core kernels (one wgmma's M)
SMS = 132              # H100 SXM streaming multiprocessors
IMPLS = ("wgmma", "simt")

# launches per path, counted where each path's kernels launch
IMPL_LAUNCHES: Dict[str, Dict[str, int]] = {
    "flash_attention": {"wgmma": 0, "simt": 0},
    "flash_attention_bwd": {"wgmma": 0, "simt": 0},
    "mla_decode": {"wgmma": 0, "simt": 0}}
# forward launches by (path, query length), so a run shows which path each
# prefill length took
SQ_LAUNCHES: Counter = Counter()
# forward and backward launches by (kernel, path, kernel dk, kernel dv,
# "native" or "padded"), so a run shows every MLA call took (96, 64) natively
DIM_LAUNCHES: Counter = Counter()


def reset_impl_launches() -> None:
    """Zero ``IMPL_LAUNCHES``, ``SQ_LAUNCHES`` and ``DIM_LAUNCHES``."""
    for counts in IMPL_LAUNCHES.values():
        for path in counts:
            counts[path] = 0
    SQ_LAUNCHES.clear()
    DIM_LAUNCHES.clear()


def forward_impl(dtype: torch.dtype, B: int, nh: int, nkv: int, Sq: int, Sk: int,
                 dk: int, dv: Optional[int] = None) -> str:
    """The forward's path: ``"wgmma"`` for bf16 when the rows of one
    (batch, kv-head), Sq x (nh / nkv), fill at least one tile of TC_ROWS;
    else ``"simt"``: fp32 inputs (held to 2e-4, which a bf16 product
    cannot meet), and decode and short prefills, which are byte-bound and
    would fill a few of a wgmma's 64 rows (4 slots x 2 rows: 8).  ``dk``
    and ``dv`` (default dk) are the caller's head dims, checked by
    :func:`kernel_dims`."""
    kernel_dims(dk, dk if dv is None else dv)
    if dtype == torch.bfloat16 and Sq * (nh // nkv) >= TC_ROWS:
        return "wgmma"
    return "simt"


def backward_impl(dtype: torch.dtype, B: int, nh: int, nkv: int, Sq: int, Sk: int,
                  dk: int, dv: Optional[int] = None) -> str:
    """The backward's path: ``"wgmma"`` for bf16, ``"simt"`` for fp32 (any
    head dims the wrapper takes)."""
    kernel_dims(dk, dk if dv is None else dv)
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def kernel_dims(dk: int, dv: int, impl: str = "wgmma") -> Tuple[int, int]:
    """The kernels' (dk, dv) that run the caller's (dk, dv) on path
    ``impl``: the first pair of ``KERNEL_DIMS[impl]`` that holds both, the
    caller's own where the path has it ((96, 64) runs natively on the
    tensor cores; on the SIMT path it pads to (128, 128)).  A dim that is
    not a multiple of 8 in (0, 128] raises."""
    for d in (dk, dv):
        if d % 8 or not 0 < d <= MAX_HEAD_DIM:
            raise ValueError(f"head dims ({dk}, {dv}): each must be a multiple of 8 in "
                             f"(0, {MAX_HEAD_DIM}]")
    return next(p for p in KERNEL_DIMS[impl] if p[0] >= dk and p[1] >= dv)


def _pad(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to ``dp`` (itself when it is)."""
    return t if t.shape[-1] == dp else F.pad(t, (0, dp - t.shape[-1]))


def _impl(impl: Optional[str], chosen: str, dtype: torch.dtype) -> str:
    impl = impl or chosen
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "wgmma" and dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core path takes bf16, got {dtype}")
    return impl


def kv_splits(B: int, nh: int, nkv: int, Sq: int, Sk: int) -> int:
    """Blocks the keys are split over: 1 when the (batch, kv-head, row-tile)
    grid already covers the card twice, else enough to do so (decode)."""
    blocks = B * nkv * -(-Sq * (nh // nkv) // BQ)
    tiles = -(-Sk // BK)
    if blocks >= 2 * SMS:
        return 1
    per = -(-tiles // min(tiles, -(-2 * SMS // blocks)))      # tiles per split
    return -(-tiles // per)


def _per_batch(t: Optional[torch.Tensor], B: int, q: torch.Tensor, what: str):
    if t is None:
        return None
    if t.dtype != torch.int32 or t.shape != (B,) or t.device != q.device \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous int32 [{B}] tensor on {q.device}")
    return t.data_ptr()


def _check_strided(q: torch.Tensor, *ts: torch.Tensor) -> None:
    vec = 16 // q.element_size()            # elements per 16-byte load
    for t in (q, *ts):
        if t.dtype != q.dtype or t.device != q.device or t.stride(3) != 1:
            raise ValueError("q, k, v (and o, dO) must share dtype and device, with dh "
                             "contiguous")
        if any(st % vec for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError("q, k, v strides must be multiples of 16 bytes, "
                             "their data 16-byte aligned")


def _count(name: str, impl: str, dims: Tuple[int, int], kdims: Tuple[int, int]) -> None:
    IMPL_LAUNCHES[name][impl] += 1
    DIM_LAUNCHES[(name, impl, *kdims, "native" if dims == kdims else "padded")] += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None, return_lse: bool = False,
                    impl: Optional[str] = None):
    """q [B,nh,Sq,dk]; k [B,nkv,Sk,dk]; v [B,nkv,Sk,dv] -> [B,nh,Sq,dv].

    Any strides are taken as long as the head dim is contiguous, so
    permuted views of [B, S, heads, d] tensors go in without a copy; the
    output is [B, Sq, nh, dv] memory seen as [B, nh, Sq, dv], so the
    model's ``transpose(1, 2).reshape(B, Sq, nh * dv)`` is a view.
    ``return_lse`` also returns each row's log-sum-exp of the scaled
    scores, fp32 [B,nh,Sq] (the keys are then not split over blocks).
    ``impl``: the path, by default :func:`forward_impl`'s choice.  Dims
    off the path's kernels run zero-padded (module docstring) and come out
    as a view of the padded output."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA flash-attention kernel got a {q.device} tensor")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash attention takes fp32 or bf16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError("q must be [B,nh,Sq,dk], k [B,nkv,Sk,dk] and v [B,nkv,Sk,dv]")
    B, nh, Sq, dk = q.shape
    _, nkv, Sk, _ = k.shape
    dv = v.shape[3]
    if k.shape[0] != B or k.shape[3] != dk or nh % nkv:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}")
    impl = _impl(impl, forward_impl(q.dtype, B, nh, nkv, Sq, Sk, dk, dv), q.dtype)
    (kdk, kdv), scale = kernel_dims(dk, dv, impl), dk ** -0.5
    q, k, v = _pad(q, kdk), _pad(k, kdk), _pad(v, kdv)
    _check_strided(q, k, v)
    o = torch.empty((B, Sq, nh, kdv), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _per_batch(q_offset, B, q, "q_offset"), _per_batch(kv_len, B, q, "kv_len"))
    lse_ptr = lse.data_ptr() if lse is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build.library("flash_attention")
    if impl == "wgmma":
        code = lib.hk_flash_attention_tc(*ptrs, B, nh, nkv, Sq, Sk, kdk, kdv, *strides,
                                         int(causal), scale, lse_ptr, stream)
        build.check(lib, code, "hk_flash_attention_tc")
    else:
        nsplit = 1 if return_lse else kv_splits(B, nh, nkv, Sq, Sk)
        part = (torch.empty(B * nh * Sq * nsplit * (kdk + 2), dtype=torch.float32,
                            device=q.device) if nsplit > 1 else None)
        code = lib.hk_flash_attention(*ptrs, B, nh, nkv, Sq, Sk, kdk, *strides, int(causal),
                                      scale, nsplit, part.data_ptr() if part is not None else None,
                                      lse_ptr, DTYPES[q.dtype], stream)
        build.check(lib, code, "hk_flash_attention")
    _count("flash_attention", impl, (dk, dv), (kdk, kdv))
    SQ_LAUNCHES[(impl, Sq)] += 1
    o = o[..., :dv]
    return (o, lse) if return_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, impl: Optional[str] = None):
    """(dq, dk, dv) of ``flash_attention`` under the training mask: q_offset
    0, no kv_len, Sq == Sk.  q [B,nh,S,dk], k [B,nkv,S,dk], v [B,nkv,S,dv];
    ``o`` and ``lse`` are the forward's outputs, ``do`` the gradient of
    ``o`` ([B,nh,S,dv]); all by strides with the head dim contiguous.  The
    gradients come out in the inputs' dtype, shapes and layouts.
    ``impl``: the path, by default :func:`backward_impl`'s choice.
    Deterministic on both paths.  Dims off the path's kernels run
    zero-padded, as the forward does."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA flash-attention backward got a {q.device} tensor")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash attention takes fp32 or bf16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3] \
            or o.shape != (*q.shape[:3], v.shape[3]) or do.shape != o.shape:
        raise ValueError("q must be [B,nh,S,dk], k [B,nkv,S,dk], v [B,nkv,S,dv] and o, do "
                         "[B,nh,S,dv]")
    B, nh, Sq, dk = q.shape
    _, nkv, Sk, _ = k.shape
    dv = v.shape[3]
    if Sq != Sk or k.shape[0] != B or k.shape[3] != dk or nh % nkv:
        raise ValueError("the attention backward takes the training mask only "
                         f"(Sq == Sk): q {tuple(q.shape)}, k {tuple(k.shape)}")
    if lse.shape != (B, nh, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be the forward's contiguous fp32 [B, nh, Sq]")
    impl = _impl(impl, backward_impl(q.dtype, B, nh, nkv, Sq, Sk, dk, dv), q.dtype)
    (kdk, kdv), scale = kernel_dims(dk, dv, impl), dk ** -0.5
    q, k = _pad(q, kdk), _pad(k, kdk)
    v, o, do = _pad(v, kdv), _pad(o, kdv), _pad(do, kdv)
    _check_strided(q, k, v, o, do)
    dq, dk_, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    D = torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *[st for t in (q, k, v, o, do, dq, dk_, dv_) for st in t.stride()[:3]])
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
              lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(),
              B, nh, nkv, Sq, Sk)
    tail = (ctypes.addressof(strides), int(causal), scale)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build.library("flash_attention")
    if impl == "wgmma":
        code = lib.hk_flash_attention_bwd_tc(*common, kdk, kdv, *tail, stream)
        build.check(lib, code, "hk_flash_attention_bwd_tc")
    else:
        code = lib.hk_flash_attention_bwd(*common, kdk, *tail, DTYPES[q.dtype], stream)
        build.check(lib, code, "hk_flash_attention_bwd")
    _count("flash_attention_bwd", impl, (dk, dv), (kdk, kdv))
    return dq[..., :dk], dk_[..., :dk], dv_[..., :dv]


# ---------------------------------------------------------------------------
# the absorbed MLA decode (csrc/mla_decode.cu)
# ---------------------------------------------------------------------------

MLA_DIMS = (256, 32)   # (latent, rope) dims the kernel takes: minicpm3-4b's
MLA_HEADS = 64         # query heads a block takes at most
MLA_TILE = {"wgmma": 64, "simt": 32}   # keys per tile of each route
MLA_PART = MLA_DIMS[0] + 4   # floats of a split's partial row
TMA_MAX_STRIDE = 1 << 40     # bytes: cuTensorMapEncodeTiled takes strides below this


def mla_splits(B: int, T: int, impl: str = "simt") -> int:
    """Blocks the keys of a row are split over on route ``impl``: enough
    for the B rows to cover the card twice, at least one tile of
    ``MLA_TILE[impl]`` keys each (the splits cover T in whole tiles)."""
    tiles = -(-T // MLA_TILE[impl])
    if B >= 2 * SMS:
        return 1
    per = -(-tiles // min(tiles, -(-2 * SMS // B)))           # tiles per split
    return -(-tiles // per)


def mla_impl(dtype: torch.dtype, B: int, nh: int, T: int, strides, ptrs) -> str:
    """The absorbed decode's route, from the dtype, the shapes, ``strides``
    (the batch and row strides of q_lat, q_rope, c_kv and k_rope in that
    order, in elements) and ``ptrs`` (their four addresses) alone:
    ``"wgmma"`` for bf16 whose latent rows TMA can address (c_kv's and
    k_rope's addresses on 16 bytes, their strides positive multiples of 16
    bytes below ``TMA_MAX_STRIDE``: a broadcast over the batch, stride 0,
    is not one), else ``"simt"`` (fp32 inputs, held to the fp32 bound,
    which a bf16 product cannot meet; and the layouts above)."""
    if dtype != torch.bfloat16:
        return "simt"
    elt = 2
    tma = all(0 < st * elt < TMA_MAX_STRIDE and st * elt % 16 == 0 for st in strides[4:])
    tma = tma and all(ptr % 16 == 0 for ptr in ptrs[2:])
    return "wgmma" if tma and 0 < nh <= MLA_HEADS and B >= 1 and T >= 1 else "simt"


def mla_decode(q_lat: torch.Tensor, q_rope: torch.Tensor, c_kv: torch.Tensor,
               k_rope: torch.Tensor, kv_len: torch.Tensor, scale: float, *,
               impl: Optional[str] = None) -> torch.Tensor:
    """o_lat fp32 [B, nh, L] of ``ref.mla_decode_plain`` on the card.

    q_lat [B, nh, L], q_rope [B, nh, R]; c_kv [B, T, L], k_rope [B, T, R]
    (the gathered latent cache), all fp32 or all bf16, by strides with
    the last dim contiguous (16-byte aligned strides); kv_len a contiguous
    int32 [B] on the same card; (L, R) = ``MLA_DIMS``, nh up to
    ``MLA_HEADS``, any T.  ``impl``: the route, by default
    :func:`mla_impl`'s choice; ``"simt"`` takes every input, ``"wgmma"``
    raises where :func:`mla_impl` would not choose it."""
    if q_lat.device.type != "cuda":
        raise ValueError(f"CUDA MLA decode kernel got a {q_lat.device} tensor")
    if q_lat.dtype not in DTYPES:
        raise TypeError(f"the MLA decode takes fp32 or bf16, got {q_lat.dtype}")
    if q_lat.dim() != 3 or q_rope.dim() != 3 or c_kv.dim() != 3 or k_rope.dim() != 3:
        raise ValueError("q_lat, q_rope must be [B, nh, dim] and c_kv, k_rope [B, T, dim]")
    B, nh, Ld = q_lat.shape
    T, R = c_kv.shape[1], k_rope.shape[2]
    if (q_rope.shape != (B, nh, R) or c_kv.shape != (B, T, Ld) or k_rope.shape != (B, T, R)
            or (Ld, R) != MLA_DIMS or not 0 < nh <= MLA_HEADS or T < 1):
        raise ValueError(f"the MLA decode takes (L, R) = {MLA_DIMS} and up to {MLA_HEADS} "
                         f"heads: q_lat {tuple(q_lat.shape)}, q_rope {tuple(q_rope.shape)}, "
                         f"c_kv {tuple(c_kv.shape)}, k_rope {tuple(k_rope.shape)}")
    ts = (q_lat, q_rope, c_kv, k_rope)
    vec = 16 // q_lat.element_size()
    for t in ts:
        if t.dtype != q_lat.dtype or t.device != q_lat.device or t.stride(2) != 1:
            raise ValueError("q_lat, q_rope, c_kv, k_rope must share dtype and device, "
                             "with the last dim contiguous")
        if any(st % vec for st in t.stride()[:2]) or t.data_ptr() % 16:
            raise ValueError("MLA decode strides must be multiples of 16 bytes, the data "
                             "16-byte aligned")
    strides = tuple(st for t in ts for st in t.stride()[:2])
    chosen = mla_impl(q_lat.dtype, B, nh, T, strides, tuple(t.data_ptr() for t in ts))
    impl = _impl(impl, chosen, q_lat.dtype)
    if impl == "wgmma" and chosen != "wgmma":
        raise ValueError("TMA cannot address these latent rows: the wgmma route does not "
                         "take them")
    kl = _per_batch(kv_len, B, q_lat, "kv_len")
    o = torch.empty((B, nh, Ld), dtype=torch.float32, device=q_lat.device)
    nsplit = mla_splits(B, T, impl)
    part = (torch.empty(B * nh * nsplit * MLA_PART, dtype=torch.float32, device=q_lat.device)
            if nsplit > 1 else None)
    args = (*(t.data_ptr() for t in ts), kl, o.data_ptr(), B, nh, T, Ld, R, *strides,
            float(scale), nsplit, part.data_ptr() if part is not None else None)
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    lib = build.library("mla_decode")
    if impl == "wgmma":
        build.check(lib, lib.hk_mla_decode_tc(*args, stream), "hk_mla_decode_tc")
    else:
        build.check(lib, lib.hk_mla_decode(*args, DTYPES[q_lat.dtype], stream), "hk_mla_decode")
    IMPL_LAUNCHES["mla_decode"][impl] += 1
    return o
