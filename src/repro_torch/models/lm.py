"""Decoder-only LM assembly (dense family).

Counterpart of ``repro/models/lm.py::init_params``, ``forward`` (dense
branch) and ``LMOut``.  Parameters are the JAX package's nested dict with
stacked ``[L, ...]`` leaves; a Python loop over layers takes the place of
``lax.scan`` and indexes each leaf (a view, no copy).  Two differences in
storage, neither in the math: matmul weights and the embedding are kept in
the compute dtype (the JAX package casts its fp32 masters on every call;
norm scales stay fp32), and ``params["head"]`` holds the LM head as one
contiguous ``[d, V]`` matrix made at load time — for tied embeddings the
transposed table, so no step ever copies ``embed.T``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import blocks as BLK
from repro_torch.models import layers as L

# leaves that stay fp32 whatever the compute dtype (norm scales and biases)
FP32_LEAVES = ("scale", "bias", "q_norm", "k_norm")


class LMOut(NamedTuple):
    logits: Any
    caches: Any


def _map_leaves(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, k) for k, v in tree.items()}
    return fn(key, tree)


def prepare_params(params: Dict[str, Any], dtype) -> Dict[str, Any]:
    """Cast a parameter tree for serving in ``dtype`` and add ``"head"``
    (embeddings are tied when the tree has no ``lm_head``)."""
    out = _map_leaves(params, lambda k, t: t.float() if k in FP32_LEAVES
                      else t.to(dtype).contiguous())
    out["head"] = (out["lm_head"]["w"] if "lm_head" in out
                   else out["embed"]["table"].t().contiguous())
    return out


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameters from a seeded ``torch.Generator`` on ``device``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": L.init_embed(g, cfg.padded_vocab, cfg.d_model),
        "final_norm": L.init_norm(cfg.norm_kind, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": L.normal_init((cfg.d_model, cfg.padded_vocab), g,
                                                scale=0.02)}
    params["blocks"] = BLK.init_attn_block(cfg, g, cfg.num_layers)
    return prepare_params(params, dtype)


def forward(pctx, cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            caches: Optional[Dict[str, Any]] = None) -> LMOut:
    """batch: tokens [B,S] (+ positions [B,S], "_dtype"); caches: {"attn":
    PagedKVCache with [L, ...] arenas} or None."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    tokens = batch["tokens"]
    B, S = tokens.shape
    compute_dtype = batch.get("_dtype", torch.bfloat16)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)

    x = L.apply_embed(params["embed"], tokens, compute_dtype)
    attn = None if caches is None else caches["attn"]
    for i in range(cfg.num_layers):
        p_l = _map_leaves(params["blocks"], lambda _, t: t[i])
        cache_l = None if attn is None else attn._replace(k=attn.k[i], v=attn.v[i])
        x, _ = BLK.apply_attn_block(pctx, cfg, p_l, x, positions=positions,
                                    cache=cache_l)
    new_caches = None if attn is None else {
        "attn": attn._replace(lengths=attn.lengths + S)}

    x = L.apply_norm(cfg.norm_kind, params["final_norm"], x)
    logits = pctx.lm_head(x.to(compute_dtype), params["head"])
    return LMOut(logits, new_caches)
