"""Hecaton's fused LM-head loss, single-device branch.

Counterpart of the ``mesh is None`` branch of
``repro/core/hecaton.py::fused_lm_loss``: the head logits come out of the
tile matmul in fp32 (``preferred_element_type=float32`` in the JAX
package), then ``lse - gold`` per token, masked.  The grid branch (vocab
chunks over the hidden axis, ring-reduced LSE) arrives with the grid
slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def fused_lm_loss(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                  loss_mask: Optional[torch.Tensor], *,
                  tile_matmul=ops.tile_matmul) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked NLL, mask count); the caller divides.

    x [B,S,H] in the compute dtype; w [H,V] (the tied head is the
    transposed view of the table, read in place); labels, loss_mask [B,S].
    The [B*S, V] fp32 logits live only until this loss's backward."""
    if loss_mask is None:
        loss_mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    lf = tile_matmul(x.reshape(-1, x.shape[-1]), w.to(x.dtype), out_dtype=torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.reshape(-1, 1).long())[:, 0]
    wmask = loss_mask.reshape(-1).float()
    return torch.sum((lse - gold) * wmask), torch.sum(wmask)
