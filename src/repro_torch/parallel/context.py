"""Single-device execution context — the dispatch hub between model code and
the kernels.

Counterpart of the ``mesh is None`` branches of ``repro/parallel/context.py``:
model code calls the methods here and never the kernels directly.  Every
projection, the FFN, the LM head and attention route through
``kernels/ops.py`` (the CUDA kernel for a CUDA tensor, the plain version on
the CPU).  ``plain=True`` routes them to the plain versions on any
device: it is the reference forward that ``chip_smoke.py`` holds the
kernel forward against on the card.  Norms, the embedding and residual
adds need no dispatch on one device, so the model calls
``models/layers.py`` for them directly.  The data x mx x my grid arrives in a later
slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref

_PLAIN = SimpleNamespace(matmul=ref.matmul_plain,
                         gated_matmul=ref.gated_matmul_plain,
                         attention=ref.attention_plain)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[..., K] -> contiguous [M, K] (a view when x is already contiguous)."""
    return x.reshape(-1, x.shape[-1])


@dataclass(frozen=True)
class PCtx:
    plain: bool = False                    # plain versions even on CUDA

    @property
    def ops(self):
        return _PLAIN if self.plain else ops

    # ------------------------------------------------------------------
    # projections
    # ------------------------------------------------------------------
    def _proj(self, x: torch.Tensor, w: torch.Tensor, act: str = "none"):
        y = self.ops.matmul(_rows(x), w.to(x.dtype), act=act)
        return y.reshape(*x.shape[:-1], w.shape[1])

    def ffn(self, x: torch.Tensor, w1, w2, act: str, w1b=None):
        """FFN: act(x @ w1) [* (x @ w1b)] @ w2; ``act`` names the kernel's
        epilogue activation (``layers.EPILOGUE_ACT``)."""
        x2 = _rows(x)
        if w1b is not None:
            h = self.ops.gated_matmul(x2, w1.to(x.dtype), w1b.to(x.dtype), act=act)
        else:
            h = self.ops.matmul(x2, w1.to(x.dtype), act=act)
        return self.ops.matmul(h, w2.to(x.dtype)).reshape(*x.shape[:-1], w2.shape[1])

    def mixer_in_many(self, x: torch.Tensor, *ws: torch.Tensor):
        """Several mixer-in projections of the same residual entry (Q/K/V)."""
        return tuple(self._proj(x, w) for w in ws)

    def mixer_out(self, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Projection out of a token mixer."""
        return self._proj(y, w)

    def lm_head(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Final projection to vocab logits; ``w`` is a contiguous [d, V]."""
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
