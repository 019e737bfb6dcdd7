"""Mamba2 (SSD, state-space duality) mixer.  [arXiv:2405.21060]

Counterpart of ``repro/models/ssm.py``.  The prefill's chunked scan is
``PCtx.ssd`` (the SSD kernel on the card, ``ref.ssd_plain`` on the CPU);
the single-token recurrence of decode, the causal depthwise conv, the
softplus, the D skip and the gated RMSNorm are plain PyTorch, as the JAX
package computes them in jnp outside any Pallas kernel.  The conv is
written as the JAX package's K shifted multiply-adds, not ``F.conv1d``
(cuDNN would run an fp32 convolution in TF32).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L


class SSMState(NamedTuple):
    conv: torch.Tensor     # [(L,) B, K-1, conv_channels], the compute dtype
    ssm: torch.Tensor      # [(L,) B, nheads, head_dim, state], fp32


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def n_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm.head_dim


def conv_channels(cfg: ModelConfig) -> int:
    s = cfg.ssm
    return d_inner(cfg) + 2 * s.n_groups * s.state_dim


def init_mamba(cfg: ModelConfig, generator: torch.Generator, layers: int):
    """Stacked [layers, ...] mixer parameters in fp32."""
    s = cfg.ssm
    H, Di, nh = cfg.d_model, d_inner(cfg), n_heads(cfg)
    gs = s.n_groups * s.state_dim
    dev = generator.device
    u = torch.rand((layers, nh), generator=generator, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "wz": L.normal_init((layers, H, Di), generator),
        "wx": L.normal_init((layers, H, Di), generator),
        "wB": L.normal_init((layers, H, gs), generator),
        "wC": L.normal_init((layers, H, gs), generator),
        "wdt": L.normal_init((layers, H, nh), generator),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),          # softplus^-1(dt)
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)).expand(layers, nh).clone(),
        "D": torch.ones((layers, nh), dtype=torch.float32, device=dev),
        "conv_w": L.normal_init((layers, s.conv_kernel, conv_channels(cfg)), generator,
                                scale=0.5),
        "norm": torch.ones((layers, Di), dtype=torch.float32, device=dev),
        "wo": L.normal_init((layers, Di, H), generator, scale=1.0 / Di ** 0.5),
    }


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """Single-token recurrence.  state [b,nh,dh,ds] fp32, x [b,nh,dh],
    dt [b,nh], B/C [b,g,ds] -> (y [b,nh,dh] in x's dtype, new state)."""
    hpg = x.shape[1] // B.shape[1]
    Bh = B.float().repeat_interleave(hpg, dim=1)            # [b,nh,ds]
    Ch = C.float().repeat_interleave(hpg, dim=1)
    dtf = dt.float()
    dA = torch.exp(dtf * A.float())                         # [b,nh]
    xdt = x.float() * dtf[..., None]                        # [b,nh,dh]
    new = state * dA[..., None, None] + xdt[..., :, None] * Bh[..., None, :]
    y = torch.einsum("bhdn,bhn->bhd", new, Ch)
    return y.to(x.dtype), new


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,C], w [K,C] depthwise causal conv: K shifted multiply-adds in
    fp32, cast to x's dtype."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S, :].float() * w[i]
    return out.to(x.dtype)


def conv_step(conv_state: torch.Tensor, xt: torch.Tensor, w: torch.Tensor):
    """conv_state [B,K-1,C], xt [B,C] -> (y [B,C], new_state)."""
    window = torch.cat([conv_state, xt[:, None, :]], dim=1)          # [B,K,C]
    y = torch.einsum("bkc,kc->bc", window.float(), w.float()).to(xt.dtype)
    return y, window[:, 1:, :]


def apply_mamba(pctx, cfg: ModelConfig, p, x: torch.Tensor, *,
                state: Optional[SSMState] = None,
                ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """x [B,S,H] -> (y [B,S,H], updated recurrent state or None).

    With a state, a length-1 input is one decode step (``conv_step`` and
    ``ssd_decode_step``); a longer one is a prefill that starts the scan
    from ``state.ssm`` and, as in the JAX package, convolves the input
    alone (the serving path prefills from a zero state).  The conv state
    it returns is the last K-1 conv inputs, zeros in front of a prompt
    shorter than that.  The gated norm's fp32 output is cast to the
    compute dtype before ``wo`` (JAX keeps it fp32 there), so the bf16
    matmul kernel runs."""
    s = cfg.ssm
    B_, S, _ = x.shape
    Di, nh = d_inner(cfg), n_heads(cfg)
    gs = s.n_groups * s.state_dim

    z, xs = pctx.mixer_in_many(x, p["wz"], p["wx"])     # [B,S,Di]
    Bp = pctx.small_proj(x, p["wB"])                    # [B,S,g*ds]
    Cp = pctx.small_proj(x, p["wC"])
    dt = pctx.small_proj(x, p["wdt"])                   # [B,S,nh]

    conv_in = torch.cat([xs, Bp, Cp], dim=-1)
    new_conv = None
    if state is not None and S == 1:
        cy, new_conv = conv_step(state.conv, conv_in[:, 0, :], p["conv_w"])
        conv_out = cy[:, None, :]
    else:
        conv_out = causal_conv(conv_in, p["conv_w"])
        if state is not None:
            K = s.conv_kernel
            new_conv = torch.cat([state.conv, conv_in], dim=1)[:, -(K - 1):, :]
    conv_out = F.silu(conv_out)

    # views of the conv output: the scan reads them through their strides
    xh = conv_out[..., :Di].reshape(B_, S, nh, s.head_dim)
    Bh = conv_out[..., Di:Di + gs].reshape(B_, S, s.n_groups, s.state_dim)
    Ch = conv_out[..., Di + gs:].reshape(B_, S, s.n_groups, s.state_dim)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())

    new_ssm = None
    if state is not None and S == 1:
        y, new_ssm = ssd_decode_step(state.ssm, xh[:, 0], dtv[:, 0], A,
                                     Bh[:, 0], Ch[:, 0])
        y = y[:, None]
    else:
        y, fin = pctx.ssd(xh, dtv, A, Bh, Ch, chunk=min(s.chunk_size, S),
                          init_state=None if state is None else state.ssm)
        if state is not None:
            new_ssm = fin

    y = y + xh * p["D"][None, None, :, None]            # skip; promotes to fp32
    y = y.reshape(B_, S, Di)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = L.apply_norm("rmsnorm", {"scale": p["norm"]}, y * F.silu(z))
    out = pctx.mixer_out(y.to(x.dtype), p["wo"])
    new_state = SSMState(new_conv, new_ssm) if state is not None else None
    return out, new_state


def init_ssm_state(cfg: ModelConfig, layers: int, batch: int, dtype, device) -> SSMState:
    """Zero states of every layer: conv [L, B, K-1, C] in ``dtype``, ssm
    [L, B, nh, dh, ds] in fp32."""
    s = cfg.ssm
    return SSMState(
        torch.zeros((layers, batch, s.conv_kernel - 1, conv_channels(cfg)),
                    dtype=dtype, device=device),
        torch.zeros((layers, batch, n_heads(cfg), s.head_dim, s.state_dim),
                    dtype=torch.float32, device=device))
