"""Single-device execution context — the dispatch hub between model code and
the kernels.

Counterpart of the ``mesh is None`` branches of ``repro/parallel/context.py``:
model code calls the methods here and never the kernels directly.  Every
projection, the FFN, the LM head, attention and the SSD scan route through
``kernels/ops.py`` (the CUDA kernel for a CUDA tensor, the plain version on
the CPU).  One signal picks the route, ``ops.needs_grad``: when autograd
will differentiate, projections, the head and the FFN's down-projection
go through the differentiable tile matmul, and the FFN's gated
up-projection and attention through their differentiable ops; otherwise
(prefill and decode, under ``inference_mode``) the forward-only kernels
with fused epilogues run.  ``mode="train"`` only enables :meth:`dropout`,
as in the JAX package.  ``plain=True`` routes them to
the plain versions on any device, differentiated by PyTorch's autograd:
it is the reference that ``chip_smoke.py`` holds the kernel path (forward
and gradients) against on the card.  Norms, the embedding and residual
adds need no dispatch on one device, so the model calls
``models/layers.py`` for them directly.  The data x mx x my grid arrives in a later
slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import torch

from repro_torch.config import ParallelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import layers as L

_PLAIN = SimpleNamespace(matmul=ref.matmul_plain,
                         gated_matmul=ref.gated_matmul_plain,
                         attention=ref.attention_plain,
                         tile_matmul=ref.tile_matmul_plain,
                         ssd=ref.ssd_plain)

MODES = ("serve", "train")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[..., K] -> contiguous [M, K] (a view when x is already contiguous)."""
    return x.reshape(-1, x.shape[-1])


@dataclass(frozen=True)
class PCtx:
    plain: bool = False                    # plain versions even on CUDA
    mode: str = "serve"                    # serve | train (enables dropout)
    pcfg: ParallelConfig = field(default_factory=ParallelConfig)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")

    @property
    def ops(self):
        return _PLAIN if self.plain else ops

    @property
    def train(self) -> bool:
        return self.mode == "train"

    # ------------------------------------------------------------------
    # projections
    # ------------------------------------------------------------------
    def _proj(self, x: torch.Tensor, w: torch.Tensor, act: str = "none"):
        """act(x @ w) with the weight cast to x's dtype (an fp32 master in
        training: its gradient flows back through the cast)."""
        w = w.to(x.dtype)
        if ops.needs_grad(x, w):
            y = self.ops.tile_matmul(_rows(x), w, out_dtype=torch.float32 if act != "none"
                                     else None)
            if act != "none":                      # the epilogue, in fp32 then cast
                y = ref.EPILOGUE_ACTS[act](y).to(x.dtype)
        else:
            y = self.ops.matmul(_rows(x), w, act=act)
        return y.reshape(*x.shape[:-1], w.shape[1])

    def ffn(self, x: torch.Tensor, w1, w2, act: str, w1b=None):
        """FFN: act(x @ w1) [* (x @ w1b)] @ w2; ``act`` names the kernel's
        epilogue activation (``layers.EPILOGUE_ACT``)."""
        x2 = _rows(x)
        if w1b is not None:
            h = self.ops.gated_matmul(x2, w1.to(x.dtype), w1b.to(x.dtype), act=act)
        else:
            h = _rows(self._proj(x2, w1, act))
        return self._proj(h, w2).reshape(*x.shape[:-1], w2.shape[1])

    def mixer_in_many(self, x: torch.Tensor, *ws: torch.Tensor):
        """Several mixer-in projections of the same residual entry (Q/K/V)."""
        return tuple(self._proj(x, w) for w in ws)

    def mixer_out(self, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Projection out of a token mixer."""
        return self._proj(y, w)

    def small_proj(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Tiny projection (mamba dt/B/C) whose output is too narrow to tile:
        a plain matmul in x's dtype, as the JAX package leaves its einsum
        to XLA."""
        return torch.matmul(x, w.to(x.dtype))

    def lm_head(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Final projection to vocab logits; ``w`` is [d, V]: a contiguous
        matrix in serving, in training the untied head or the transposed
        view of the tied table, which the tile kernel reads in place."""
        return self._proj(x, w)

    # ------------------------------------------------------------------
    # attention
    # ------------------------------------------------------------------
    def attention(self, q, k, v, *, causal: bool = True,
                  q_offset: Optional[torch.Tensor] = None,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q [B,nh,Sq,dh]; k,v [B,nkv,Sk,dh] (views of [B,S,heads,dh])."""
        return self.ops.attention(q, k, v, causal=causal, q_offset=q_offset,
                                  kv_len=kv_len)

    # ------------------------------------------------------------------
    # the Mamba2 scan
    # ------------------------------------------------------------------
    def ssd(self, x, dt, A, B, C, *, chunk: int, init_state=None):
        """SSD chunked scan -> (y, fp32 final state); ``ref.ssd_plain``'s
        shapes (the kernel on the card)."""
        return self.ops.ssd(x, dt, A, B, C, chunk=chunk, init_state=init_state)

    # ------------------------------------------------------------------
    # residual-stream ops
    # ------------------------------------------------------------------
    def dropout(self, x: torch.Tensor, rate: float,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Inverted dropout in train mode; identity otherwise, or at rate 0,
        or without a generator."""
        if not self.train:
            return x
        return L.dropout(x, rate, generator)
