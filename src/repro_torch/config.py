"""Model configuration for the port (dense decoder fields only).

A copy of the parts of ``repro/config.py`` the serving slice reads: the
frozen :class:`ModelConfig` with ``padded_vocab``/``resolved_head_dim``/
``scaled``, and the arch registry.  MoE/MLA/SSM/enc-dec fields and the
parallel, checkpoint and guard configs arrive with the slices that use them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # only "dense" is served by this slice
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    mlp_kind: str = "swiglu"                # swiglu | relu2 | gelu | geglu
    norm_kind: str = "rmsnorm"              # rmsnorm | layernorm
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (as the JAX package pads)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


_REGISTRY: Dict[str, ModelConfig] = {}
_SMOKE_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE_REGISTRY[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _SMOKE_REGISTRY[name]


def _ensure_loaded():
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers everything)
