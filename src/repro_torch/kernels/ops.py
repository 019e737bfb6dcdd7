"""Dispatch between the CUDA kernels and their plain versions.

A tensor on the CPU takes the plain PyTorch version (``kernels/ref.py``);
a CUDA tensor launches the hand-written kernel or raises — there is no
fallback.  ``LAUNCHES`` counts kernel launches made through this module,
one per call that reached the card, so a run can show which kernels its
main path went through (:func:`reset_launches` zeroes it).  Counterpart of
``repro/kernels/ops.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ref as _ref

LAUNCHES: Dict[str, int] = {"matmul": 0, "gated_matmul": 0, "flash_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel or plain path for device {x.device}")
    return False


def matmul(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           *, act: str = "none") -> torch.Tensor:
    """act(x @ w + bias); x [M,K], w [K,N]."""
    if _on_cpu(x):
        return _ref.matmul_plain(x, w, bias, act=act)
    out = _mm.matmul(x, w, bias, act=act)
    LAUNCHES["matmul"] += 1
    return out


def gated_matmul(x: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor, *,
                 act: str = "silu") -> torch.Tensor:
    """act(x @ w1) * (x @ w1b); x [M,K], w1/w1b [K,N]."""
    if _on_cpu(x):
        return _ref.gated_matmul_plain(x, w1, w1b, act=act)
    out = _mm.gated_matmul(x, w1, w1b, act=act)
    LAUNCHES["gated_matmul"] += 1
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: Optional[torch.Tensor] = None,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,nh,Sq,dh]; k,v [B,nkv,Sk,dh]; mask of ``ref.attention_plain``."""
    if _on_cpu(q):
        return _ref.attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                    kv_len=kv_len)
    out = _fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                              kv_len=kv_len)
    LAUNCHES["flash_attention"] += 1
    return out
