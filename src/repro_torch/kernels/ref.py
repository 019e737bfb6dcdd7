"""Plain PyTorch versions of the port's kernels.

Each computes exactly what its CUDA kernel computes, in fp32 from the
input dtype with one cast at the end.  The CPU path of ``kernels/ops.py``
runs these, and ``chip_smoke.py`` holds each kernel against its plain
version on the card.  Counterpart of ``repro/kernels/ref.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30        # masked score, as models/attention.py uses


def relu2(x: torch.Tensor) -> torch.Tensor:
    r = torch.relu(x)
    return r * r


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, which is what jax.nn.gelu computes by default."""
    return F.gelu(x, approximate="tanh")


# the kernels' epilogue activations by name
EPILOGUE_ACTS = {"none": lambda y: y, "relu2": relu2, "gelu": gelu, "silu": F.silu}


def _epilogue(y: torch.Tensor, act: str) -> torch.Tensor:
    if act not in EPILOGUE_ACTS:
        raise ValueError(f"unknown activation {act!r}")
    return EPILOGUE_ACTS[act](y)


def matmul_plain(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 act: str = "none") -> torch.Tensor:
    """act(x @ w + bias) in fp32, cast to x.dtype.  x [M,K], w [K,N]."""
    y = x.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    return _epilogue(y, act).to(x.dtype)


def gated_matmul_plain(x: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor,
                       *, act: str = "silu") -> torch.Tensor:
    """act(x @ w1) * (x @ w1b), both products and the gate in fp32 and one
    cast at the end, as the Pallas kernel's epilogue does."""
    xf = x.float()
    return (_epilogue(xf @ w1.float(), act) * (xf @ w1b.float())).to(x.dtype)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention with the mask of ``models/attention._sdpa``.

    q [B,nh,Sq,dh]; k,v [B,nkv,Sk,dh]; q-head h reads kv-head h // (nh/nkv).
    Key ``kpos`` is visible to query ``qpos`` of batch row b when
    ``kpos <= q_offset[b] + qpos`` (if causal) and ``kpos < kv_len[b]``;
    ``q_offset`` defaults to 0 and ``kv_len`` to Sk.  Masked scores are
    -1e30, so a row with no visible key averages all of v (the kernel
    writes 0 there; the model never produces such a row)."""
    B, nh, Sq, dh = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    g = nh // nkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (dh ** -0.5)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((B, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[None, :]
        if q_offset is not None:
            qpos = qpos + q_offset.reshape(B, 1).to(q.device)
        mask &= kpos[None, None, :] <= qpos[:, :, None]
    if kv_len is not None:
        mask &= kpos[None, None, :] < kv_len.reshape(B, 1, 1).to(q.device)
    s = s.masked_fill(~mask[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
