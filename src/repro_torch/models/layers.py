"""Shared model layers: initializers, norms, RoPE, embeddings, activations.

Counterpart of ``repro/models/layers.py``; the same math in PyTorch, with
explicit ``torch.Generator``s in place of JAX keys (the two draw different
numbers from one seed, so parity tests carry JAX's parameters across
through ``repro_torch.bridge``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import EPILOGUE_ACTS


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def normal_init(shape: Sequence[int], generator: torch.Generator,
                scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init in fp32 on the generator's device.

    ``shape`` may carry a leading layer axis: fan-in is ``shape[-2]``, which
    for the JAX package's per-layer 2-D shapes is its ``shape[0]``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return t * std


def embed_init(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    return normal_init(shape, generator, scale=0.02)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(kind: str, dim: int, device, layers: Sequence[int] = ()):
    p = {"scale": torch.ones((*layers, dim), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((*layers, dim), dtype=torch.float32, device=device)
    return p


def apply_norm(kind: str, params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm / LayerNorm over the last dim, fp32 statistics."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * params["scale"]).to(x.dtype)
    if kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * params["scale"] + params["bias"]).to(x.dtype)
    raise KeyError(kind)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMSNorm over head_dim of [..., head_dim]."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

# mlp_kind -> the matmul kernels' fused epilogue activation
EPILOGUE_ACT = {"swiglu": "silu", "geglu": "gelu", "relu2": "relu2", "gelu": "gelu"}

ACTIVATIONS = {kind: EPILOGUE_ACTS[act] for kind, act in EPILOGUE_ACT.items()}

GATED = {"swiglu": True, "geglu": True, "relu2": False, "gelu": False}


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout; identity when rate is 0 or no generator is given.
    The mask comes from ``generator`` (on x's device), so its bits differ
    from ``jax.random``'s: parity with the JAX package holds at rate 0."""
    if rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [B,S] -> cos,sin [B,S,head_dim//2] in fp32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B,S,H,D] (D even, split-half convention)."""
    d = x.shape[-1] // 2
    xf1, xf2 = x[..., :d].float(), x[..., d:].float()
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def init_embed(generator: torch.Generator, vocab: int, dim: int):
    return {"table": embed_init((vocab, dim), generator)}


def apply_embed(params, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    return F.embedding(ids, params["table"]).to(compute_dtype)
