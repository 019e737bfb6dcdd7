"""Training step builder: microbatch gradient accumulation (the paper's
mini-batch scheduling, §III-B a), remat policy, gradient compression,
clipping and AdamW.

Counterpart of ``repro/train/step.py``: a Python loop over microbatches
takes the place of ``lax.scan``.  Each microbatch's gradients come from
``torch.autograd.grad``, are rounded to ``pcfg.grad_reduce_dtype`` and
summed in fp32; the graph, and with it the head's fp32 logits, is freed
before the next microbatch runs.

On the grid (``mesh`` a ``Grid``, either strategy) every rank runs the
step on its blocks: its parameter blocks (``parallel/specs.py``), its
block of every microbatch (``specs.local_batch``).  The loss is global
on every rank (the loss sums over all of them), so each rank
differentiates ``loss / world`` and holds its own contribution to each
gradient; a leaf's gradient is then summed over the axes that replicate
it (norm scales over every model axis, every leaf over ``data``), which
is the gradient reduction over ``data`` and GSPMD's implicit sums in
one.  The global gradient norm for clipping and the guard is a ``psum``
over the strategy's axes (``data`` then ``mx``, ``my`` or ``model``: each
rank once), each replicated leaf counted once.  ZeRO-1: each data rank updates
its part of every leaf (``zero.state_spec``) and the parts are gathered
over ``data``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.config import GuardConfig, ModelConfig, ParallelConfig, RunConfig
from repro_torch.launch.mesh import Grid
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel import comm, specs, zero
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
                     guard: Optional[GuardConfig] = None, mesh: Optional[Grid] = None,
                     plain: bool = False):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` are fp32 leaves that require grad; they and the optimizer
    state are updated in place.  Metrics: ``loss``, ``aux``,
    ``grad_norm``, ``lr`` (+ ``update_ok``, ``update_skipped``,
    ``nonfinite`` under ``guard``), as 0-d tensors.  With ``mesh`` the
    grid step: params are this rank's blocks, ``opt_state`` comes from
    :func:`init_grid_opt_state` and ``batch`` is this rank's block
    (``specs.local_batch``)."""
    pctx = PCtx(mode="train", pcfg=pcfg, mesh=mesh, plain=plain, seq_len=rc.seq_len)
    n_micro = pcfg.microbatches
    if mesh is not None:
        return _grid_step(cfg, pcfg, rc, pctx, total_steps, compute_dtype, guard)

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


# ---------------------------------------------------------------------------
# the hecaton grid
# ---------------------------------------------------------------------------

def _leaf_info(params, mesh: Grid, pcfg: ParallelConfig):
    """Per leaf (flatten order): its spec, the axes that replicate it, and
    the dim along which ZeRO-1 splits it over ``data`` (or None)."""
    ax = specs.shd.axis_info(mesh, pcfg.strategy)
    out = []
    for path, t in lm.flatten(params):
        spec = specs.leaf_spec(path, t.dim(), ax, pcfg.fused_loss)
        full = [d * mesh.size(tuple(specs._entry_axes(e))) if e is not None else d
                for d, e in zip(t.shape, tuple(spec) + (None,) * (t.dim() - len(spec)))]
        mspec = zero.state_spec(spec, full, ("data",), mesh.sizes)
        ddim = zero.data_dim(spec, mspec) if mesh.size("data") > 1 else None
        out.append((spec, specs.replicated_axes(spec, mesh, pcfg.strategy), ddim))
    return out


def _part(t: torch.Tensor, ddim, mesh: Grid) -> torch.Tensor:
    """This data rank's part of a block (a view), or the block."""
    if ddim is None:
        return t
    return t.chunk(mesh.size("data"), dim=ddim)[mesh.axis_index("data")]


def init_grid_opt_state(params, mesh: Grid, pcfg: ParallelConfig) -> adamw.AdamState:
    """AdamW state over this rank's ZeRO-1 parts of its parameter blocks."""
    items = lm.flatten(params)
    info = _leaf_info(params, mesh, pcfg)
    parts = lm.unflatten([p for p, _ in items],
                         [_part(t.detach(), d, mesh) for (_, t), (_, _, d) in zip(items, info)])
    return adamw.init(parts)


def grid_global_norm(grads, info, axes) -> torch.Tensor:
    """sqrt of the sum of squares over every element of the global
    gradient: each rank's blocks, a replicated leaf divided by the ranks
    that hold it, then a psum over ``axes``, the strategy's
    (``specs.grid_axes``), which hold every rank once."""
    sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g, (_, repl, _) in zip(grads, info):
        n = 1
        for a in repl:
            n *= comm.axis_size(a)
        sq = sq + torch.sum(torch.square(g.float())) / n
    return torch.sqrt(_raw_psum_axes(sq, axes))


def _raw_psum_axes(x, axes):
    for a in axes:
        x = comm.raw_psum(x, a)
    return x


def _grid_step(cfg, pcfg, rc, pctx, total_steps, compute_dtype, guard):
    mesh = pctx.mesh
    n_micro = pcfg.microbatches

    s_loc = rc.seq_len // pctx.seq_shards

    def train_step(params, opt_state, batch):
        if batch["tokens"].shape[1] != s_loc:
            raise ValueError(f"tokens {tuple(batch['tokens'].shape)}: this rank's block of a "
                             f"{rc.seq_len}-token sequence holds {s_loc}")
        items = lm.flatten(params)
        paths, leaves = [p for p, _ in items], [t for _, t in items]
        info = _leaf_info(params, mesh, pcfg)
        gsum = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        asum = torch.zeros_like(lsum)
        for mb in microbatch_split(batch, n_micro):
            mb["_dtype"] = compute_dtype
            loss, metrics = lm.train_loss(pctx, cfg, params, mb, remat=pcfg.remat)
            grads = torch.autograd.grad(loss / mesh.world, leaves)
            grads = [_raw_psum_axes(g, repl) for g, (_, repl, _) in zip(grads, info)]
            grads = zero.compress_grads(grads, pcfg.grad_reduce_dtype)
            for acc, g in zip(gsum, grads):
                acc.add_(g.float())
            del grads, loss
            lsum += metrics["loss"].detach()
            asum += metrics["aux"].detach()
        grads = [g / n_micro for g in gsum]
        del gsum
        gnorm = grid_global_norm(grads, info, specs.grid_axes(pcfg.strategy))
        p_parts = [_part(t.detach(), d, mesh) for t, (_, _, d) in zip(leaves, info)]
        g_parts = [_part(g, d, mesh) for g, (_, _, d) in zip(grads, info)]
        _, opt_state, om = adamw.update(lm.unflatten(paths, p_parts),
                                        lm.unflatten(paths, g_parts), opt_state, rc,
                                        total_steps, grad_norm=gnorm, guard=guard)
        with torch.no_grad():
            for t, part, (_, _, d) in zip(leaves, p_parts, info):
                if d is not None:
                    t.copy_(comm.raw_all_gather(part.contiguous(), "data", d))
        return params, opt_state, {"loss": lsum / n_micro, "aux": asum / n_micro, **om}

    return train_step


def eval_loss(cfg: ModelConfig, pcfg: ParallelConfig, params, batch, *,
              compute_dtype=torch.bfloat16, mesh: Optional[Grid] = None,
              plain: bool = False) -> float:
    """The loss a step would report for ``batch`` (the mean over its
    microbatches), without gradients or an update."""
    pctx = PCtx(mode="train", pcfg=pcfg, mesh=mesh, plain=plain)
    total = 0.0
    with torch.no_grad():
        for mb in microbatch_split(batch, pcfg.microbatches):
            mb["_dtype"] = compute_dtype
            total += float(lm.train_loss(pctx, cfg, params, mb, remat="none")[0])
    return total / pcfg.microbatches
