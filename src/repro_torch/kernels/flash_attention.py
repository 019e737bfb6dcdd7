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
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, Optional

import torch

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
    "flash_attention_bwd": {"wgmma": 0, "simt": 0}}
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
    would fill a few of a wgmma's 64 rows (4 slots x 2 rows: 8)."""
    if dtype == torch.bfloat16 and dh in HEAD_DIMS and Sq * (nh // nkv) >= TC_ROWS:
        return "wgmma"
    return "simt"


def backward_impl(dtype: torch.dtype, B: int, nh: int, nkv: int, Sq: int, Sk: int,
                  dh: int) -> str:
    """The backward's path: ``"wgmma"`` for bf16, ``"simt"`` for fp32."""
    return "wgmma" if dtype == torch.bfloat16 and dh in HEAD_DIMS else "simt"


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
    default :func:`forward_impl`'s choice."""
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
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    _check_strided(q, k, v)
    impl = _impl(impl, forward_impl(q.dtype, B, nh, nkv, Sq, Sk, dh), q.dtype)
    o = torch.empty_like(q)
    lse = (torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              _per_batch(q_offset, B, q, "q_offset"), _per_batch(kv_len, B, q, "kv_len"),
              B, nh, nkv, Sq, Sk, dh,
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
              int(causal), dh ** -0.5)
    lse_ptr = lse.data_ptr() if lse is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build.library("flash_attention")
    if impl == "wgmma":
        code = lib.hk_flash_attention_tc(*common, lse_ptr, stream)
        build.check(lib, code, "hk_flash_attention_tc")
    else:
        nsplit = 1 if return_lse else kv_splits(B, nh, nkv, Sq, Sk)
        part = (torch.empty(B * nh * Sq * nsplit * (dh + 2), dtype=torch.float32,
                            device=q.device) if nsplit > 1 else None)
        code = lib.hk_flash_attention(*common, nsplit,
                                      part.data_ptr() if part is not None else None,
                                      lse_ptr, DTYPES[q.dtype], stream)
        build.check(lib, code, "hk_flash_attention")
    IMPL_LAUNCHES["flash_attention"][impl] += 1
    SQ_LAUNCHES[(impl, Sq)] += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, impl: Optional[str] = None):
    """(dq, dk, dv) of ``flash_attention`` under the training mask: q_offset
    0, no kv_len, Sq == Sk.  ``o`` and ``lse`` are the forward's outputs, ``do``
    the gradient of ``o``; all by strides with dh contiguous.  The gradients
    come out in the inputs' dtype and layouts.  ``impl``: the path, by
    default :func:`backward_impl`'s choice.  Deterministic on both paths."""
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
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    if lse.shape != (B, nh, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be the forward's contiguous fp32 [B, nh, Sq]")
    _check_strided(q, k, v, o, do)
    impl = _impl(impl, backward_impl(q.dtype, B, nh, nkv, Sq, Sk, dh), q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    D = torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *[st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]])
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
              lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              B, nh, nkv, Sq, Sk, dh, ctypes.addressof(strides), int(causal), dh ** -0.5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build.library("flash_attention")
    if impl == "wgmma":
        code = lib.hk_flash_attention_bwd_tc(*common, stream)
        build.check(lib, code, "hk_flash_attention_bwd_tc")
    else:
        code = lib.hk_flash_attention_bwd(*common, DTYPES[q.dtype], stream)
        build.check(lib, code, "hk_flash_attention_bwd")
    IMPL_LAUNCHES["flash_attention_bwd"][impl] += 1
    return dq, dk, dv
