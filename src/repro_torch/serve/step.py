"""Serving step builders (prefill into dense or paged caches, one-token
decode), the grid's cache layout, and sampling.

Counterpart of ``repro/serve/step.py``'s ``build_prefill``,
``build_prefill_paged``, ``build_decode_step``, ``cache_specs`` and the
sampling entry point.  PyTorch runs eagerly, so a builder returns a plain
function where the JAX package returns one to jit.  Random draws come
from a ``torch.Generator`` the caller seeds.

On the rank grid (``mesh`` a ``launch/mesh.Grid``, the dense family
without MLA) every rank runs the step on its blocks, as in training:

* the parameters are this rank's blocks of the master-form tree in the
  compute dtype (:func:`grid_params`), the strategy's tiling with the
  non-fused head (hecaton's ``lm_head`` over ``(my, mx)``, the tied
  table's block transposed);
* prefill (``PCtx`` mode ``"prefill"``) takes this rank's block of the
  prompt batch (``parallel/specs.local_batch``: rows over the data axes,
  tokens over ``mx``) and runs the strategy's dataflow without autograd;
  the dense caches it fills hold this rank's rows and kv heads
  (:func:`cache_specs`: only the "heads fully sharded" layout, kv heads
  over the model axes, is ported);
* decode (mode ``"decode"``) runs the 1D layout over the combined model
  axes with the replicated residual (DESIGN.md §4).  JAX lets GSPMD
  re-lay hecaton's 2D weight tiles into that layout on every call; the
  decode step here re-lays them once, on its first call with a parameter
  tree (and again only for another tree), into megatron's blocks
  (``specs.param_specs(..., strategy="megatron")``): the same values, so
  the same logits.  Its kv heads are the ones prefill wrote, because
  both layouts index the model axes row-major over (mx, my);
* both return the logits of this rank's rows over the whole vocabulary
  (prefill the last prompt token's), gathered from the vocab shards.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig, ParallelConfig, RunConfig
from repro_torch.models import attention as ATT
from repro_torch.models import lm
from repro_torch.parallel import comm, specs
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.context import PCtx
from repro_torch.serve import cache as CM


def build_prefill(cfg: ModelConfig, pcfg: Optional[ParallelConfig] = None,
                  rc: Optional[RunConfig] = None, mesh=None, *,
                  compute_dtype=torch.bfloat16):
    """Prefill a batch of prompts of one length into fresh dense caches of
    ``rc.seq_len`` positions.  ``(params, batch) ->
    (logits of the last token [B, 1, V], caches)``; ``batch["tokens"]`` is
    [B, S] (on the grid this rank's block; under megatron ``batch`` also
    carries the ``positions`` [B, S] of the whole prompt, whose length
    decides whether the seq residual cuts it)."""
    pcfg = pcfg or ParallelConfig()

    def prefill(params, batch):
        tokens = batch["tokens"]
        B = tokens.shape[0]
        seq_len = batch["positions"].shape[1] if "positions" in batch else None
        pctx = PCtx(mode="serve" if mesh is None else "prefill", pcfg=pcfg, mesh=mesh,
                    seq_len=seq_len)
        caches = init_caches(cfg, pcfg, mesh, B, rc.seq_len, compute_dtype, tokens.device)
        mb = dict(batch, _dtype=compute_dtype)
        out = lm.forward(pctx, cfg, params, mb, caches=caches)
        return _last_logits(pctx, out.logits), out.caches

    return prefill


def build_prefill_paged(cfg: ModelConfig, *, compute_dtype=torch.bfloat16):
    """Prefill one admitted sequence into a cache tree (the pool's
    ``prefill_tree``: a paged K/V view, fp or int8, or the ssm family's
    zero state rows, which come back updated for
    ``CachePool.absorb_prefill``).

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


def build_decode_step(cfg: ModelConfig, pcfg: Optional[ParallelConfig] = None,
                      rc: Optional[RunConfig] = None, mesh=None, *,
                      compute_dtype=torch.bfloat16):
    """One-token decode over every row of a cache tree; the tree decides
    the layout (dense ``KVCache``, paged ``PagedKVCache`` or int8
    ``QuantPagedKVCache``, MLA's latent counterparts of the three, or the
    ssm family's states, all advanced in place).  On the grid ``params`` are :func:`grid_params`' blocks; the
    step re-lays them for the 1D layout once per tree (module
    docstring)."""
    pcfg = pcfg or ParallelConfig()
    pctx = PCtx(mode="serve" if mesh is None else "decode", pcfg=pcfg, mesh=mesh)
    memo = {}

    def decode_step(params, caches, tokens: torch.Tensor, positions: torch.Tensor):
        """tokens [B,1]; positions [B,1] absolute positions of the new token."""
        if mesh is not None:
            if memo.get("of") is not params:
                memo.clear()
                memo["of"], memo["params"] = params, relay_for_decode(params, mesh, pcfg)
            params = memo["params"]
        mb = {"tokens": tokens, "positions": positions, "_dtype": compute_dtype}
        out = lm.forward(pctx, cfg, params, mb, caches=caches)
        return _vocab_whole(pctx, out.logits), out.caches

    return decode_step


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

def grid_params(full, grid, pcfg: ParallelConfig, dtype):
    """This rank's serving blocks of a master-form parameter tree (fp32, as
    ``lm.init_master_params`` or the JAX export gives it): the strategy's
    tiling with the non-fused head, matmul weights in ``dtype`` and the
    fp32 leaves of ``lm.FP32_LEAVES`` kept."""
    local = specs.shard_tree(full, specs.param_specs(full, grid, fused_loss=False,
                                                      strategy=pcfg.strategy), grid)
    return _cast(local, dtype)


def _cast(tree, dtype):
    return lm._map_leaves(tree, lambda k, t: t.detach().float() if k in lm.FP32_LEAVES
                          else t.detach().to(dtype).contiguous())


def relay_for_decode(params, grid, pcfg: ParallelConfig):
    """:func:`grid_params`' blocks re-laid into the decode layout (the 1D
    tiling over the combined model axes): each leaf gathered whole, one at
    a time, and cut to this rank's megatron block.  A tied table's block
    [V/n, H] also gives the head ``"head"`` [H, V/n], made contiguous once
    as ``lm.prepare_params`` makes one card's (the decode matmul reads
    contiguous operands)."""
    src = specs.param_specs(params, grid, fused_loss=False, strategy=pcfg.strategy)
    dst = specs.param_specs(params, grid, fused_loss=False, strategy="megatron")
    items = lm.flatten(params)
    with torch.no_grad():
        leaves = [specs.local_slice(specs.gather_full(t, specs.spec_of(src, p)),
                                    specs.spec_of(dst, p), grid) for p, t in items]
    out = lm.unflatten([p for p, _ in items], leaves)
    if "lm_head" not in out:
        out["head"] = out["embed"]["table"].t().contiguous()
    return out


def cache_specs(cfg: ModelConfig, pcfg: ParallelConfig, mesh, batch: int):
    """Spec tree of the dense caches of a global ``batch`` (the structure
    of :func:`serve.cache.init_dense`'s tree): K and V ``[L, B, S, nkv,
    dh]`` with B over the data axes (when they divide it) and the kv heads
    over the model axes, lengths replicated.  JAX's solver picks the
    layout; only "heads fully sharded" is ported, other layouts raise.
    None on one device."""
    if mesh is None:
        return None
    if cfg.family != "dense":
        raise NotImplementedError(f"grid caches for family {cfg.family!r} are not ported yet")
    if cfg.mla:
        raise NotImplementedError(f"grid caches for MLA ({cfg.name}) are not ported: its latent "
                                  "caches have no kv-head axis to shard")
    ax = shd.axis_info(mesh, pcfg.strategy)
    lay = shd.solve_attn_layout(ax, cfg.num_kv_heads, max(1, batch // ax.n_data))
    if lay.note != "heads fully sharded":
        raise NotImplementedError(f"cache layout {lay.note!r} is not ported; only 'heads "
                                  "fully sharded' (kv heads over the model axes) is")
    b = None if batch % ax.n_data else shd.one(lay.batch_axes)
    kv = (None, b, None, shd.one(lay.head_axes), None)
    return {"attn": ATT.KVCache(kv, kv, ())}


def init_caches(cfg: ModelConfig, pcfg: ParallelConfig, mesh, batch: int, s_max: int,
                dtype, device):
    """Fresh dense caches for ``batch`` rows, this rank's part of them on
    the grid (``batch`` is then the rank's rows; the heads are cut by
    :func:`cache_specs`)."""
    if mesh is None:
        return lm.init_caches(cfg, batch, s_max, dtype, device)
    ax = shd.axis_info(mesh, pcfg.strategy)
    spec = cache_specs(cfg, pcfg, mesh, batch * ax.n_data)["attn"].k
    return CM.init_dense(cfg, batch, s_max, dtype, device,
                         kv_heads=cfg.num_kv_heads // mesh.size(spec[3]))


def _vocab_whole(pctx, logits):
    """The grid's vocab-sharded logits [B, S, V/n] gathered over the
    vocab's axis (decode: ``model``)."""
    if pctx.mesh is None:
        return logits
    return comm.raw_all_gather(logits.contiguous(), pctx.ax.model_axes[0], 2)


def _last_logits(pctx, logits):
    """The last token's logits [B, 1, V] of every row this rank holds.  On
    hecaton's grid the head's logits come out tokens over ``my`` and vocab
    over ``mx``: the last token lives on the last ``my`` rank, whose vocab
    shards are gathered over ``mx`` and summed over ``my`` (every other
    rank adds zeros); megatron's prefill holds every token, vocab over
    ``model``."""
    last = logits[:, -1:].contiguous()
    if pctx.mesh is None:
        return last
    if not pctx.use_hecaton:
        return _vocab_whole(pctx, last)
    full = comm.raw_all_gather(last, "mx", 2)
    if comm.axis_index("my") != comm.axis_size("my") - 1:
        full = torch.zeros_like(full)
    return comm.raw_psum(full, "my")


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
