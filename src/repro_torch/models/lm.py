"""Decoder-only LM assembly (dense, MoE and SSM families).

Counterpart of ``repro/models/lm.py::init_params``, ``init_caches``,
``forward`` (dense, MLA, MoE and ``ssm`` branches, over the dense, paged and
int8 paged caches, with ``remat``, ``skip_head`` and the ``hidden`` output),
``xent_loss``, ``head_loss``, ``train_loss`` and ``LMOut``.  Parameters
are the JAX package's nested dict with stacked ``[L, ...]`` leaves; a
Python loop over layers takes the place of ``lax.scan`` and unbinds each
leaf once into per-layer views.

On the grid (``pctx.mesh``, training of the dense family) the same
forward runs on this rank's blocks: ``tokens`` is its block (hecaton
[B, S/mx]; megatron [B, S/n] under the seq residual, else [B, S]), the
positions cover the full sequence, and the embedding, norms,
projections and the loss are ``PCtx``'s grid methods.

Two parameter forms.  Training keeps the JAX form: fp32 masters, each
cast to the compute dtype at its use, and the tied head reads
``embed.table`` through a transposed view (the tile kernel's NT layout),
so the table is one leaf that receives both the embedding's and the
head's gradient.  Serving (``prepare_params``) stores matmul weights and
the embedding in the compute dtype (norm scales stay fp32) and adds
``params["head"]``, one contiguous ``[d, V]`` matrix made at load time —
for tied embeddings the transposed table — so no decode step ever copies
``embed.T``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.core import hecaton as HEC
from repro_torch.core import overlap as OV
from repro_torch.core import schedule
from repro_torch.models import attention as ATT
from repro_torch.models import blocks as BLK
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.parallel import comm
from repro_torch.parallel import megatron as MEG

# leaves that stay fp32 whatever the compute dtype: norm scales and biases
# (MLA's q_norm and kv_norm too), the mamba mixer's small leaves (its
# dt bias, decay, skip, gated-norm scale and conv taps), and the MoE router,
# whose logits JAX takes in fp32 from the fp32 masters
FP32_LEAVES = ("scale", "bias", "q_norm", "k_norm", "kv_norm", "dt_bias", "A_log", "D",
               "norm", "conv_w", "router")
FAMILIES = ("dense", "moe", "ssm")


class LMOut(NamedTuple):
    logits: Any
    caches: Any
    hidden: Any = None               # post-final-norm states (skip_head)
    aux: Any = None                  # the MoE's summed aux loss (fp32), else None


def _map_leaves(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, k) for k, v in tree.items()}
    return fn(key, tree)


def flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in sorted key order, as ``jax.tree.leaves`` walks
    a dict."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in flatten(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def unflatten(paths, leaves) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


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
    """Random serving parameters from a seeded ``torch.Generator`` on
    ``device`` (the fp32 masters of :func:`init_master_params`, prepared)."""
    return prepare_params(init_master_params(cfg, seed=seed, device=device), dtype)


def init_master_params(cfg: ModelConfig, *, seed: int = 0,
                       device="cuda") -> Dict[str, Any]:
    """Random fp32 parameters in the JAX package's form, from a seeded
    ``torch.Generator`` on ``device``."""
    if cfg.family not in FAMILIES:
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
    init_block = BLK.init_mamba_block if cfg.family == "ssm" else BLK.init_attn_block
    params["blocks"] = init_block(cfg, g, cfg.num_layers)
    return params


def init_caches(cfg: ModelConfig, batch: int, s_max: int, dtype, device="cuda"):
    """Stacked per-layer dense decode caches (``serve/cache.init_dense``)."""
    from repro_torch.serve import cache as CM
    return CM.init_dense(cfg, batch, s_max, dtype, device)


def head_weight(cfg: ModelConfig, params, dtype, pctx=None) -> torch.Tensor:
    """The LM head as [d, V] in ``dtype``: serving's prepared matrix, else
    the untied ``lm_head.w`` or the tied table through ``pctx.head_weight``
    (its transposed view on one device; on the grid this rank's [H, V/my]
    vocab chunk)."""
    if "head" in params:
        return params["head"]
    if cfg.tie_embeddings:
        if pctx is not None:
            return pctx.head_weight(params["embed"]["table"], dtype)
        return params["embed"]["table"].to(dtype).t()
    return params["lm_head"]["w"].to(dtype)


def _layer_stack(pctx, cfg: ModelConfig, stacked, x: torch.Tensor,
                 positions: torch.Tensor, remat: str, cache=None,
                 aux: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The layer loop: each stacked leaf is unbound once (one backward
    node stacks its per-layer gradients), and each layer runs under the
    remat policy (``core/schedule.py``).  ``cache`` (a KVCache,
    PagedKVCache or QuantPagedKVCache or their MLA counterparts, or for
    the ssm family an SSMState,
    with [L, ...] leaves) gives layer i its rows, which it writes in
    place.  ``aux``, a list, receives each MoE layer's aux loss in layer
    order: a MoE layer returns it beside x, so that it leaves the
    checkpointed function as an output (a backward's recompute of the
    layer appends nothing)."""
    items = flatten(stacked)
    paths = [p for p, _ in items]
    per_layer = [leaf.unbind(0) for _, leaf in items]

    def layer(x, i, *leaves):
        p = unflatten(paths, leaves)
        if cfg.family == "ssm":
            state = None if cache is None else SSM.SSMState(cache.conv[i], cache.ssm[i])
            x, new = BLK.apply_mamba_block(pctx, cfg, p, x, state=state)
            if new is not None:
                state.conv.copy_(new.conv)
                state.ssm.copy_(new.ssm)
            return x
        cache_l = None if cache is None else ATT.layer_cache(cache, i)
        x, _, aux_l = BLK.apply_attn_block(pctx, cfg, p, x, positions=positions, cache=cache_l)
        return x if aux_l is None else (x, aux_l)

    layer = schedule.apply_remat(layer, remat)
    for i in range(cfg.num_layers):
        x = layer(x, i, *(ls[i] for ls in per_layer))
        if isinstance(x, tuple):
            x, aux_l = x
            if aux is not None:
                aux.append(aux_l)
    return x


def forward(pctx, cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            caches: Optional[Dict[str, Any]] = None, remat: str = "none",
            skip_head: bool = False) -> LMOut:
    """batch: tokens [B,S] (+ positions [B,S], "_dtype", "dropout_rng" a
    ``torch.Generator``); caches: {"attn": a KVCache, PagedKVCache or
    QuantPagedKVCache with [L, ...] leaves, or for MLA their latent
    counterparts MLACache, PagedMLACache, QuantPagedMLACache} (dense and
    moe) or {"mamba": SSMState
    with [L, B, ...] leaves} (ssm), updated in place and returned with
    their lengths advanced, or None.  ``skip_head`` returns the
    post-final-norm ``hidden`` instead of logits (``train_loss``).  The
    MoE family's ``aux`` is the sum of its layers' aux losses."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if pctx.mesh is not None and cfg.family == "moe":
        raise NotImplementedError(f"MoE ({cfg.name}) on the rank grid (EP x TP) is not "
                                  "ported yet; it runs on one device")
    if pctx.mesh is not None and cfg.family != "dense":
        raise NotImplementedError(f"the grid step takes the dense family, not {cfg.family!r}")
    if pctx.mesh is not None and cfg.mla:
        raise NotImplementedError(f"MLA ({cfg.name}) on the rank grid is not ported; it runs "
                                  "on one device")
    tokens = batch["tokens"]
    B, S = tokens.shape
    S *= pctx.seq_shards                      # a grid rank may hold a token shard
    compute_dtype = batch.get("_dtype", torch.bfloat16)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)

    aux_l: Optional[List[torch.Tensor]] = [] if cfg.moe else None
    x = pctx.embed(params["embed"]["table"], tokens, compute_dtype)
    if cfg.embed_dropout:
        x = pctx.dropout(x, cfg.embed_dropout, batch.get("dropout_rng"))
    if cfg.family == "ssm":
        states = None if caches is None else caches["mamba"]
        x = _layer_stack(pctx, cfg, params["blocks"], x, positions, remat, states)
        new_caches = None if states is None else {"mamba": states}
    else:
        attn = None if caches is None else caches["attn"]
        x = _layer_stack(pctx, cfg, params["blocks"], x, positions, remat, attn, aux_l)
        new_caches = None if attn is None else {"attn": ATT.advance(attn, S)}
    aux = None
    if aux_l:                                 # 0 + aux_0 + aux_1 + ..., as the scan carries it
        aux = aux_l[0]
        for a in aux_l[1:]:
            aux = aux + a

    x = pctx.norm(cfg.norm_kind, params["final_norm"], x)
    if skip_head:
        return LMOut(None, new_caches, hidden=x, aux=aux)
    logits = pctx.lm_head(x.to(compute_dtype), head_weight(cfg, params, compute_dtype, pctx))
    return LMOut(logits, new_caches, aux=aux)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def xent_loss(logits: torch.Tensor, labels: torch.Tensor,
              loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable softmax cross-entropy in fp32, mean over the (masked) tokens."""
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    if loss_mask is None:
        return nll.mean()
    w = loss_mask.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def head_loss(pctx, cfg: ModelConfig, params, hidden: torch.Tensor,
              labels: torch.Tensor, *, mask: Optional[torch.Tensor] = None,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Post-final-norm hidden states -> mean masked NLL: the fused loss
    (fp32 logits out of the tile kernel, ``core/hecaton.fused_lm_loss``)
    under ``pcfg.fused_loss``, else logits in the compute dtype and
    :func:`xent_loss`.  On the grid: hecaton's fused loss; megatron's
    ``fused_lm_loss_seq`` where ``seq_loss_ok``; otherwise the head's
    vocab-sharded logits and a sharded cross-entropy
    (``megatron.xent_loss_sharded``), with the labels brought to the
    logits' token layout."""
    head_w = head_weight(cfg, params, compute_dtype, pctx)
    hidden = hidden.to(compute_dtype)
    fused = pctx.pcfg.fused_loss
    if pctx.mesh is not None:
        if pctx.use_hecaton and fused:
            nll, cnt = HEC.fused_lm_loss(hidden, head_w, labels, mask, mesh=pctx.mesh,
                                         **pctx.grid_kwargs())
            return nll / torch.clamp(cnt, min=1.0)
        if (pctx.use_megatron and fused
                and MEG.seq_loss_ok(pctx, pctx.global_seq_len(), cfg.padded_vocab)):
            nll, cnt = MEG.fused_lm_loss_seq(pctx, hidden, head_w, labels, mask)
            return nll / torch.clamp(cnt, min=1.0)
        return _grid_xent(pctx, pctx.lm_head(hidden, head_w), labels, mask)
    if fused:
        nll, cnt = HEC.fused_lm_loss(hidden, head_w, labels, mask,
                                     tile_matmul=pctx.ops.tile_matmul)
        return nll / torch.clamp(cnt, min=1.0)
    return xent_loss(pctx.lm_head(hidden, head_w), labels, mask)


def _grid_xent(pctx, logits, labels, mask):
    """The sharded cross-entropy of the grid's logits.  Hecaton's come out
    tokens over ``my`` and vocab over ``mx``: the labels (tokens over
    ``mx``) are gathered and this rank's ``my`` chunk kept.  Megatron's
    hold every token, vocab over ``model``: token-sharded labels are
    gathered over ``model`` (bulk, as GSPMD gathers them)."""
    def regather(t, ax):
        OV.log_route("xent_loss", "all_gather", "bulk", ax, comm.axis_size(ax), t)
        return comm.raw_all_gather(t, ax, 1)
    if pctx.use_hecaton:
        n, j = comm.axis_size("my"), comm.axis_index("my")
        relay = lambda t: None if t is None else regather(t, "mx").chunk(n, dim=1)[j]
        return MEG.xent_loss_sharded(pctx, logits, relay(labels), relay(mask), "mx", ("my",))
    if pctx.seq_sharded:
        labels = regather(labels, "model")
        mask = None if mask is None else regather(mask, "model")
    return MEG.xent_loss_sharded(pctx, logits, labels, mask, "model", ())


def train_loss(pctx, cfg: ModelConfig, params, batch, *, remat: str = "fusion"):
    """(loss + aux_loss * aux, {"loss", "aux"}), as ``repro/models/lm.py``'s:
    the MoE family adds its layers' summed load-balance loss at
    ``cfg.moe.aux_loss``; the dense family has no auxiliary loss (aux 0)."""
    out = forward(pctx, cfg, params, batch, remat=remat, skip_head=True)
    loss = head_loss(pctx, cfg, params, out.hidden, batch["labels"],
                     mask=batch.get("loss_mask"),
                     compute_dtype=batch.get("_dtype", torch.bfloat16))
    if out.aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"loss": loss, "aux": aux}
    return loss + cfg.moe.aux_loss * out.aux, {"loss": loss, "aux": out.aux}
