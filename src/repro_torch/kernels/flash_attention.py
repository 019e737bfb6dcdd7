"""Wrappers of the CUDA flash-attention kernels (``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention.py``, with the mask of the
model path (``models/attention._sdpa``): per-batch ``q_offset`` and
``kv_len``.  The forward can also return each row's log-sum-exp, which the
backward (``flash_attention_bwd``, training's mask only) reads.  CUDA
tensors only; the CPU path lives in ``kernels/ops.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
BQ, BK = 16, 32        # rows per block and keys per tile, as in the .cu file
SMS = 132              # H100 SXM streaming multiprocessors


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
                    kv_len: Optional[torch.Tensor] = None, return_lse: bool = False):
    """q [B,nh,Sq,dh]; k,v [B,nkv,Sk,dh] -> [B,nh,Sq,dh] in q's layout.

    Any strides are taken as long as dh is contiguous, so permuted views of
    [B, S, heads, dh] tensors go in without a copy.  ``return_lse`` also
    returns each row's log-sum-exp of the scaled scores, fp32 [B,nh,Sq]
    (the keys are then not split over blocks)."""
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
    o = torch.empty_like(q)
    nsplit = 1 if return_lse else kv_splits(B, nh, nkv, Sq, Sk)
    lse = (torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    part = (torch.empty(B * nh * Sq * nsplit * (dh + 2), dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    lib = build.library("flash_attention")
    code = lib.hk_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _per_batch(q_offset, B, q, "q_offset"), _per_batch(kv_len, B, q, "kv_len"),
        B, nh, nkv, Sq, Sk, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), dh ** -0.5, nsplit, part.data_ptr() if part is not None else None,
        lse.data_ptr() if lse is not None else None, DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, "hk_flash_attention")
    return (o, lse) if return_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True):
    """(dq, dk, dv) of ``flash_attention`` under the training mask: q_offset
    0, no kv_len, Sq == Sk.  ``o`` and ``lse`` are the forward's outputs, ``do``
    the gradient of ``o``; all by strides with dh contiguous.  The gradients
    come out in the inputs' dtype and layouts."""
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
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    D = torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *[st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]])
    lib = build.library("flash_attention")
    code = lib.hk_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, nh, nkv, Sq, Sk, dh, ctypes.addressof(strides), int(causal),
        dh ** -0.5, DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, "hk_flash_attention_bwd")
    return dq, dk, dv
