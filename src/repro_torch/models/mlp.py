"""Dense MLP block.  Counterpart of ``repro/models/mlp.py::init_mlp``/
``apply_mlp``; MoE comes with its own slice."""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L


def init_mlp(cfg: ModelConfig, generator: torch.Generator, layers: int):
    """Stacked [layers, ...] MLP parameters in fp32."""
    H, F = cfg.d_model, cfg.d_ff
    p = {"w1": L.normal_init((layers, H, F), generator),
         "w2": L.normal_init((layers, F, H), generator, scale=1.0 / F ** 0.5)}
    if L.GATED[cfg.mlp_kind]:
        p["w1b"] = L.normal_init((layers, H, F), generator)
    return p


def apply_mlp(pctx, cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return pctx.ffn(x, p["w1"], p["w2"], L.EPILOGUE_ACT[cfg.mlp_kind], p.get("w1b"))
