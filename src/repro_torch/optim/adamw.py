"""AdamW with warmup-cosine schedule, global-norm clipping and the
in-graph skip-update guard.

Counterpart of ``repro/optim/adamw.py``.  Parameters and moments are the
JAX package's nested dicts of tensors (fp32); the step counter and the
gradient-norm EWMA are 0-d tensors on the parameters' device, so an
unguarded step never waits for the host.  Unlike the JAX package, the
update writes parameters and moments in place (one leaf's temporaries at
a time instead of a second copy of the whole state).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import GuardConfig, RunConfig
from repro_torch.models.lm import flatten


class AdamState(NamedTuple):
    step: torch.Tensor           # int32 [], accepted updates so far
    mu: Any
    nu: Any
    # EWMA of accepted (finite, non-spiking) gradient norms, read by the
    # guard's spike test; 0.0 means unseeded
    gnorm_ewma: torch.Tensor


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def init(params) -> AdamState:
    dev = flatten(params)[0][1].device
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev), _zeros_like(params),
                     _zeros_like(params), torch.zeros((), dtype=torch.float32, device=dev))


def lr_schedule(rc: RunConfig, step: torch.Tensor, total_steps: int = 10_000) -> torch.Tensor:
    """Linear warmup, then cosine to 10% of ``rc.lr``; fp32 like the JAX
    package's (int32 step, float32 arithmetic)."""
    warm = torch.clamp((step + 1).to(torch.float32) / max(1, rc.warmup_steps), max=1.0)
    prog = torch.clamp((step - rc.warmup_steps).to(torch.float32) /
                       max(1, total_steps - rc.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return rc.lr * warm * (0.1 + 0.9 * cos)


def global_norm_sq(leaves) -> torch.Tensor:
    """Sum of squared elements of every leaf, in fp32."""
    return torch.sum(torch.stack([torch.sum(torch.square(g.float())) for g in leaves]))


def global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(global_norm_sq(leaves))


def clip_by_global_norm(leaves, max_norm: float, norm: Optional[torch.Tensor] = None):
    """(clipped leaves, norm); ``norm`` substitutes a precomputed norm."""
    g = global_norm(leaves) if norm is None else norm
    scale = torch.clamp(max_norm / (g + 1e-6), max=1.0)
    return [(a * scale).to(a.dtype) for a in leaves], g


def guard_predicate(gnorm: torch.Tensor, ewma: torch.Tensor, guard: GuardConfig):
    """``(ok, finite)``: all gradients finite (read off the global norm: a
    NaN or Inf anywhere reaches it) and no spike against the EWMA of
    accepted norms (an unseeded EWMA never flags one)."""
    finite = torch.isfinite(gnorm)
    spike = (ewma > 0.0) & (gnorm > guard.grad_spike_factor * ewma)
    return finite & ~spike, finite


def update(params, grads, state: AdamState, rc: RunConfig, total_steps: int = 10_000, *,
           grad_norm: Optional[torch.Tensor] = None,
           guard: Optional[GuardConfig] = None) -> Tuple[Any, AdamState, Dict]:
    """One AdamW step on ``params`` (updated in place and returned).

    With ``guard`` the update is applied only when :func:`guard_predicate`
    holds; a skipped step leaves params and every optimizer leaf bit-
    unchanged and does not advance the step.  The JAX package picks the
    branch on the device with ``lax.cond``; here the predicate is read on
    the host, one synchronisation per guarded step."""
    p_items, g_items = flatten(params), flatten(grads)
    if [p for p, _ in p_items] != [p for p, _ in g_items]:
        raise ValueError("grads must have the parameters' tree")
    leaves, gnorm = clip_by_global_norm([g for _, g in g_items], rc.grad_clip, norm=grad_norm)
    lr = lr_schedule(rc, state.step, total_steps)
    metrics = {"grad_norm": gnorm, "lr": lr}
    if guard is not None:
        ok, finite = guard_predicate(gnorm, state.gnorm_ewma, guard)
        metrics.update(update_ok=ok, update_skipped=1.0 - ok.to(torch.float32),
                       nonfinite=1.0 - finite.to(torch.float32))
        if not bool(ok):                                  # the host sync
            return params, state, metrics

    b1, b2, eps = rc.beta1, rc.beta2, 1e-8
    step = state.step + 1
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    with torch.no_grad():
        for (_, p), g, (_, m), (_, v) in zip(p_items, leaves, flatten(state.mu),
                                             flatten(state.nu)):
            gf = g.float()
            m2 = b1 * m + (1 - b1) * gf
            v2 = b2 * v + (1 - b2) * gf * gf
            delta = m2 / bc1 / (torch.sqrt(v2 / bc2) + eps) + rc.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            m.copy_(m2)
            v.copy_(v2)
    a = guard.grad_ewma_alpha if guard is not None else 0.1
    ewma = state.gnorm_ewma
    folded = torch.where(ewma > 0.0, (1.0 - a) * ewma + a * gnorm, gnorm)
    return params, AdamState(step, state.mu, state.nu, folded), metrics
