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

The kernels are built for head dims 64 and 128 (``HEAD_DIMS``).  Any
other multiple of 8 up to 128 (MLA's 96 = 64 + 32) is zero-padded to the
next of them (:func:`padded_head_dim`) and the outputs sliced back: zero
columns add exact zeros to every dot product, and the scale stays the
caller's ``dh ** -0.5``.  At dh 96 that is a third more work.

:func:`mla_decode` wraps the absorbed MLA decode (``csrc/mla_decode.cu``):
row 3's function with one latent kv head shared by every query head.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, Optional

import torch

import torch.nn.functional as F

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
BQ, BK = 16, 32        # rows per block and keys per tile of the SIMT kernels
TC_ROWS = 64           # rows per block of the tensor-core kernels (one wgmma's M)
SMS = 132              # H100 SXM streaming multiprocessors
IMPLS = ("wgmma", "simt")

# launches per path, counted where each path's kernels launch
IMPL_LAUNCHES: Dict[str, Dict[str, int]] = {
    "flash_attention": {"wgmma": 0, "simt": 0},
    "flash_attention_bwd": {"wgmma": 0, "simt": 0},
    "mla_decode": {"simt": 0}}
# forward launches by (path, query length), so a run shows which path each
# prefill length took
SQ_LAUNCHES: Counter = Counter()


def reset_impl_launches() -> None:
    """Zero ``IMPL_LAUNCHES`` and ``SQ_LAUNCHES``."""
    for counts in IMPL_LAUNCHES.values():
        for path in counts:
            counts[path] = 0
    SQ_LAUNCHES.clear()


def forward_impl(dtype: torch.dtype, B: int, nh: int, nkv: int, Sq: int, Sk: int,
                 dh: int) -> str:
    """The forward's path: ``"wgmma"`` for bf16 when the rows of one
    (batch, kv-head), Sq x (nh / nkv), fill at least one tile of TC_ROWS;
    else ``"simt"``: fp32 inputs (held to 2e-4, which a bf16 product
    cannot meet), and decode and short prefills, which are byte-bound and
    would fill a few of a wgmma's 64 rows (4 slots x 2 rows: 8).  ``dh``
    is the caller's head dim, which runs padded (:func:`padded_head_dim`)."""
    padded_head_dim(dh)
    if dtype == torch.bfloat16 and Sq * (nh // nkv) >= TC_ROWS:
        return "wgmma"
    return "simt"


def backward_impl(dtype: torch.dtype, B: int, nh: int, nkv: int, Sq: int, Sk: int,
                  dh: int) -> str:
    """The backward's path: ``"wgmma"`` for bf16, ``"simt"`` for fp32 (any
    head dim the wrapper takes)."""
    padded_head_dim(dh)
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def padded_head_dim(dh: int) -> int:
    """The kernel head dim that runs ``dh``: the least of ``HEAD_DIMS`` at
    or above it.  A head dim that is not a multiple of 8 in (0, 128]
    raises."""
    if dh % 8 or not 0 < dh <= HEAD_DIMS[-1]:
        raise ValueError(f"head_dim {dh} is not a multiple of 8 in (0, {HEAD_DIMS[-1]}]")
    return next(d for d in HEAD_DIMS if d >= dh)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None, return_lse: bool = False,
                    impl: Optional[str] = None):
    """q [B,nh,Sq,dh]; k,v [B,nkv,Sk,dh] -> [B,nh,Sq,dh] in q's layout.

    Any strides are taken as long as dh is contiguous, so permuted views of
    [B, S, heads, dh] tensors go in without a copy.  ``return_lse`` also
    returns each row's log-sum-exp of the scaled scores, fp32 [B,nh,Sq]
    (the keys are then not split over blocks).  ``impl``: the path, by
    default :func:`forward_impl`'s choice.  A dh off ``HEAD_DIMS`` runs
    zero-padded (module docstring) and comes out as a view of the padded
    output."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA flash-attention kernel got a {q.device} tensor")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash attention takes fp32 or bf16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be [B,nh,Sq,dh] and k, v [B,nkv,Sk,dh]")
    B, nh, Sq, dh = q.shape
    _, nkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != dh or nh % nkv:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}")
    dp, scale = padded_head_dim(dh), dh ** -0.5
    q, k, v = (_pad(t, dp) for t in (q, k, v))
    _check_strided(q, k, v)
    impl = _impl(impl, forward_impl(q.dtype, B, nh, nkv, Sq, Sk, dp), q.dtype)
    o = torch.empty_like(q)
    lse = (torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              _per_batch(q_offset, B, q, "q_offset"), _per_batch(kv_len, B, q, "kv_len"),
              B, nh, nkv, Sq, Sk, dp,
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
              int(causal), scale)
    lse_ptr = lse.data_ptr() if lse is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build.library("flash_attention")
    if impl == "wgmma":
        code = lib.hk_flash_attention_tc(*common, lse_ptr, stream)
        build.check(lib, code, "hk_flash_attention_tc")
    else:
        nsplit = 1 if return_lse else kv_splits(B, nh, nkv, Sq, Sk)
        part = (torch.empty(B * nh * Sq * nsplit * (dp + 2), dtype=torch.float32,
                            device=q.device) if nsplit > 1 else None)
        code = lib.hk_flash_attention(*common, nsplit,
                                      part.data_ptr() if part is not None else None,
                                      lse_ptr, DTYPES[q.dtype], stream)
        build.check(lib, code, "hk_flash_attention")
    IMPL_LAUNCHES["flash_attention"][impl] += 1
    SQ_LAUNCHES[(impl, Sq)] += 1
    o = o[..., :dh]
    return (o, lse) if return_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, impl: Optional[str] = None):
    """(dq, dk, dv) of ``flash_attention`` under the training mask: q_offset
    0, no kv_len, Sq == Sk.  ``o`` and ``lse`` are the forward's outputs, ``do``
    the gradient of ``o``; all by strides with dh contiguous.  The gradients
    come out in the inputs' dtype and layouts.  ``impl``: the path, by
    default :func:`backward_impl`'s choice.  Deterministic on both paths.
    A dh off ``HEAD_DIMS`` runs zero-padded, as the forward does."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA flash-attention backward got a {q.device} tensor")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash attention takes fp32 or bf16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or o.shape != q.shape \
            or do.shape != q.shape:
        raise ValueError("q, o, do must be [B,nh,S,dh] and k, v [B,nkv,S,dh]")
    B, nh, Sq, dh = q.shape
    _, nkv, Sk, _ = k.shape
    if Sq != Sk or k.shape[0] != B or k.shape[3] != dh or nh % nkv:
        raise ValueError("the attention backward takes the training mask only "
                         f"(Sq == Sk): q {tuple(q.shape)}, k {tuple(k.shape)}")
    if lse.shape != (B, nh, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be the forward's contiguous fp32 [B, nh, Sq]")
    dp, scale = padded_head_dim(dh), dh ** -0.5
    q, k, v, o, do = (_pad(t, dp) for t in (q, k, v, o, do))
    _check_strided(q, k, v, o, do)
    impl = _impl(impl, backward_impl(q.dtype, B, nh, nkv, Sq, Sk, dp), q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    D = torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *[st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]])
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
              lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              B, nh, nkv, Sq, Sk, dp, ctypes.addressof(strides), int(causal), scale)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build.library("flash_attention")
    if impl == "wgmma":
        code = lib.hk_flash_attention_bwd_tc(*common, stream)
        build.check(lib, code, "hk_flash_attention_bwd_tc")
    else:
        code = lib.hk_flash_attention_bwd(*common, DTYPES[q.dtype], stream)
        build.check(lib, code, "hk_flash_attention_bwd")
    IMPL_LAUNCHES["flash_attention_bwd"][impl] += 1
    return dq[..., :dh], dk[..., :dh], dv[..., :dh]


# ---------------------------------------------------------------------------
# the absorbed MLA decode (csrc/mla_decode.cu)
# ---------------------------------------------------------------------------

MLA_DIMS = (256, 32)   # (latent, rope) dims the kernel takes: minicpm3-4b's
MLA_HEADS = 64         # query heads a block takes at most
MLA_BT = 32            # keys per tile
MLA_PART = MLA_DIMS[0] + 4   # floats of a split's partial row


def mla_splits(B: int, T: int) -> int:
    """Blocks the keys of a row are split over: enough for the B rows to
    cover the card twice, at least one tile of MLA_BT keys each."""
    tiles = -(-T // MLA_BT)
    if B >= 2 * SMS:
        return 1
    per = -(-tiles // min(tiles, -(-2 * SMS // B)))           # tiles per split
    return -(-tiles // per)


def mla_decode(q_lat: torch.Tensor, q_rope: torch.Tensor, c_kv: torch.Tensor,
               k_rope: torch.Tensor, kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """o_lat fp32 [B, nh, L] of ``ref.mla_decode_plain`` on the card.

    q_lat [B, nh, L], q_rope [B, nh, R]; c_kv [B, T, L], k_rope [B, T, R]
    (the gathered latent cache), all fp32 or all bf16, by strides with
    the last dim contiguous (16-byte aligned strides); kv_len a contiguous
    int32 [B] on the same card; (L, R) = ``MLA_DIMS``, nh up to
    ``MLA_HEADS``, any T."""
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
    vec = 16 // q_lat.element_size()
    for t in (q_lat, q_rope, c_kv, k_rope):
        if t.dtype != q_lat.dtype or t.device != q_lat.device or t.stride(2) != 1:
            raise ValueError("q_lat, q_rope, c_kv, k_rope must share dtype and device, "
                             "with the last dim contiguous")
        if any(st % vec for st in t.stride()[:2]) or t.data_ptr() % 16:
            raise ValueError("MLA decode strides must be multiples of 16 bytes, the data "
                             "16-byte aligned")
    kl = _per_batch(kv_len, B, q_lat, "kv_len")
    o = torch.empty((B, nh, Ld), dtype=torch.float32, device=q_lat.device)
    nsplit = mla_splits(B, T)
    part = (torch.empty(B * nh * nsplit * MLA_PART, dtype=torch.float32, device=q_lat.device)
            if nsplit > 1 else None)
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    lib = build.library("mla_decode")
    code = lib.hk_mla_decode(q_lat.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
                             k_rope.data_ptr(), kl, o.data_ptr(), B, nh, T, Ld, R,
                             *q_lat.stride()[:2], *q_rope.stride()[:2], *c_kv.stride()[:2],
                             *k_rope.stride()[:2], float(scale), nsplit,
                             part.data_ptr() if part is not None else None,
                             DTYPES[q_lat.dtype], stream)
    build.check(lib, code, "hk_mla_decode")
    IMPL_LAUNCHES["mla_decode"]["simt"] += 1
    return o
