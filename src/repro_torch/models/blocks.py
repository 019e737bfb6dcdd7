"""Pre-norm residual blocks: attention (GQA, or MLA when ``cfg.mla``) +
MLP, and mamba.  Counterpart of ``repro/models/blocks.py::
init_attn_block``/``apply_attn_block`` and ``init_mamba_block``/
``apply_mamba_block``."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import mlp as MLP
from repro_torch.models import ssm as SSM


def init_attn_block(cfg: ModelConfig, generator: torch.Generator, layers: int):
    """Stacked [layers, ...] block parameters (the JAX package's vmapped init)."""
    dev = generator.device
    p: Dict[str, Any] = {
        "norm1": L.init_norm(cfg.norm_kind, cfg.d_model, dev, (layers,)),
        "norm2": L.init_norm(cfg.norm_kind, cfg.d_model, dev, (layers,)),
    }
    p["attn"] = (ATT.init_mla if cfg.mla else ATT.init_attn)(cfg, generator, layers)
    p["mlp"] = MLP.init_mlp(cfg, generator, layers)
    return p


def apply_attn_block(pctx, cfg: ModelConfig, p, x: torch.Tensor, *,
                     positions: torch.Tensor,
                     cache=None) -> Tuple[torch.Tensor, Any]:
    """Returns (x, new_cache).  The norms run on the canonical residual
    (``PCtx.norm``), the mixers gather and scatter internally."""
    h = pctx.norm(cfg.norm_kind, p["norm1"], x)
    mixer = ATT.apply_mla if cfg.mla else ATT.apply_attn
    a, new_cache = mixer(pctx, cfg, p["attn"], h, positions=positions, cache=cache)
    x = x + a
    h = pctx.norm(cfg.norm_kind, p["norm2"], x)
    return x + MLP.apply_mlp(pctx, cfg, p["mlp"], h).to(x.dtype), new_cache


def init_mamba_block(cfg: ModelConfig, generator: torch.Generator, layers: int):
    """Stacked [layers, ...] mamba block parameters (norm + mixer, no MLP)."""
    return {"norm1": L.init_norm(cfg.norm_kind, cfg.d_model, generator.device, (layers,)),
            "mixer": SSM.init_mamba(cfg, generator, layers)}


def apply_mamba_block(pctx, cfg: ModelConfig, p, x: torch.Tensor, *,
                      state: Optional[SSM.SSMState] = None,
                      ) -> Tuple[torch.Tensor, Optional[SSM.SSMState]]:
    """Returns (x, new_state)."""
    h = L.apply_norm(cfg.norm_kind, p["norm1"], x)
    m, new_state = SSM.apply_mamba(pctx, cfg, p["mixer"], h, state=state)
    return x + m.to(x.dtype), new_state
