"""Serving step builders (paged prefill, one-token decode) and sampling.

Counterpart of ``repro/serve/step.py``'s ``build_prefill_paged``,
``build_decode_step`` and the sampling entry point.  PyTorch runs eagerly,
so a builder returns a plain function where the JAX package returns one to
jit.  Random draws come from a ``torch.Generator`` the caller seeds.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import lm
from repro_torch.parallel.context import PCtx


def build_prefill_paged(cfg: ModelConfig, *, compute_dtype=torch.bfloat16):
    """Prefill one admitted sequence into a cache tree (the pool's
    ``prefill_tree``: a paged K/V view, or the ssm family's zero state rows,
    which come back updated for ``CachePool.absorb_prefill``).

    ``tokens`` is ``[1, P]`` with P possibly past the true prompt length
    (padding to a block multiple; ssm prompts run at their exact length);
    ``length`` is the true length and picks the logits row.  Padded
    positions write into the leased tail or the null block and stay masked
    by the slot's length."""
    pctx = PCtx()

    def prefill(params, caches, tokens: torch.Tensor, length: int):
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
        mb = {"tokens": tokens, "positions": pos, "_dtype": compute_dtype}
        out = lm.forward(pctx, cfg, params, mb, caches=caches)
        i = max(int(length) - 1, 0)
        return out.logits[:, i:i + 1], out.caches

    return prefill


def build_decode_step(cfg: ModelConfig, *, compute_dtype=torch.bfloat16):
    """One-token decode over all slots of a cache tree (paged K/V, or the
    pool's SSM states, advanced in place)."""
    pctx = PCtx()

    def decode_step(params, caches, tokens: torch.Tensor, positions: torch.Tensor):
        """tokens [B,1]; positions [B,1] absolute positions of the new token."""
        mb = {"tokens": tokens, "positions": positions, "_dtype": compute_dtype}
        out = lm.forward(pctx, cfg, params, mb, caches=caches)
        return out.logits, out.caches

    return decode_step


# ---------------------------------------------------------------------------
# sampling — the single serve-path entry point
# ---------------------------------------------------------------------------

def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _categorical(lf: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row of fp32 logits ``[..., V]``."""
    probs = torch.softmax(lf, dim=-1).reshape(-1, lf.shape[-1])
    return torch.multinomial(probs, 1, generator=generator).reshape(lf.shape[:-1])


def temperature_sample(logits: torch.Tensor, generator: torch.Generator,
                       temperature: float = 1.0) -> torch.Tensor:
    """Categorical sample from temperature-scaled logits (fp32 softmax)."""
    lf = logits.float() / max(temperature, 1e-6)
    return _categorical(lf, generator).to(torch.int32)


def top_p_sample(logits: torch.Tensor, generator: torch.Generator,
                 top_p: float = 0.9, temperature: float = 1.0) -> torch.Tensor:
    """Nucleus sampling: keep the smallest prefix of the descending-sorted
    distribution whose cumulative mass reaches ``top_p``, renormalize,
    sample, and map back through the sort permutation."""
    lf = logits.float() / max(temperature, 1e-6)
    sorted_lf, sort_idx = torch.sort(lf, dim=-1, descending=True, stable=True)
    probs = torch.softmax(sorted_lf, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p                 # always keeps the first
    masked = torch.where(keep, sorted_lf, torch.full_like(sorted_lf, -torch.inf))
    choice = _categorical(masked, generator)
    return torch.gather(sort_idx, -1, choice[..., None])[..., 0].to(torch.int32)


def sample(logits: torch.Tensor, *, method: str = "greedy",
           generator: Optional[torch.Generator] = None, temperature: float = 1.0,
           top_p: float = 0.9) -> torch.Tensor:
    """Unified sampling entry point (greedy / temperature / top-p).
    ``logits`` is ``[..., V]``; returns int32 ids with the leading shape."""
    if method == "greedy":
        return greedy_sample(logits)
    if generator is None:
        raise ValueError(f"sampling method {method!r} needs a torch.Generator")
    if method == "temperature":
        return temperature_sample(logits, generator, temperature)
    if method == "top_p":
        return top_p_sample(logits, generator, top_p, temperature)
    raise ValueError(f"unknown sampling method {method!r}")
