"""Training step builder: microbatch gradient accumulation (the paper's
mini-batch scheduling, §III-B a), remat policy, gradient compression,
clipping and AdamW.

Counterpart of ``repro/train/step.py`` on one device: a Python loop over
microbatches takes the place of ``lax.scan``.  Each microbatch's
gradients come from ``torch.autograd.grad``, are rounded to
``pcfg.grad_reduce_dtype`` and summed in fp32; the graph, and with it the
head's fp32 logits, is freed before the next microbatch runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.config import GuardConfig, ModelConfig, ParallelConfig, RunConfig
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel import zero
from repro_torch.parallel.context import PCtx


def microbatch_split(batch: Dict, n_micro: int) -> List[Dict]:
    """[B, ...] -> n_micro batches of [B/n_micro, ...].  A ``dropout_rng``
    generator is shared: each microbatch draws its own mask from it in
    turn."""
    out = [dict() for _ in range(n_micro)]
    for k, v in batch.items():
        if k == "dropout_rng":
            for mb in out:
                mb[k] = v
            continue
        if not isinstance(v, torch.Tensor):
            continue
        B = v.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} % microbatches {n_micro}")
        for mb, part in zip(out, v.chunk(n_micro, dim=0)):
            mb[k] = part
    return out


def build_train_step(cfg: ModelConfig, pcfg: ParallelConfig, rc: RunConfig, *,
                     total_steps: int = 10_000, compute_dtype=torch.bfloat16,
                     guard: Optional[GuardConfig] = None):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` are fp32 leaves that require grad; they and the optimizer
    state are updated in place.  Metrics: ``loss``, ``aux``,
    ``grad_norm``, ``lr`` (+ ``update_ok``, ``update_skipped``,
    ``nonfinite`` under ``guard``), as 0-d tensors."""
    pctx = PCtx(mode="train", pcfg=pcfg)
    n_micro = pcfg.microbatches

    def train_step(params, opt_state, batch):
        items = lm.flatten(params)
        leaves = [t for _, t in items]
        gsum = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        asum = torch.zeros_like(lsum)
        for mb in microbatch_split(batch, n_micro):
            mb["_dtype"] = compute_dtype
            loss, metrics = lm.train_loss(pctx, cfg, params, mb, remat=pcfg.remat)
            grads = zero.compress_grads(torch.autograd.grad(loss, leaves),
                                        pcfg.grad_reduce_dtype)
            for acc, g in zip(gsum, grads):
                acc.add_(g.float())
            del grads, loss
            lsum += metrics["loss"].detach()
            asum += metrics["aux"].detach()
        grads = lm.unflatten([p for p, _ in items], [g / n_micro for g in gsum])
        del gsum
        params, opt_state, om = adamw.update(params, grads, opt_state, rc, total_steps,
                                             guard=guard)
        return params, opt_state, {"loss": lsum / n_micro, "aux": asum / n_micro, **om}

    return train_step


def init_train_state(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """(fp32 parameters that require grad, AdamState)."""
    params = lm.init_master_params(cfg, seed=seed, device=device)
    for _, t in lm.flatten(params):
        t.requires_grad_(True)
    return params, adamw.init(params)
