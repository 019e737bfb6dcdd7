"""Megatron-style 1D tensor parallelism: the paper's baseline ("F" in Fig. 8).

Counterpart of ``repro/parallel/megatron.py``.  Column-parallel then
row-parallel linears over one ``model`` axis (the grid's mx * my ranks of
a data index, ``launch/mesh.py``).  Each function is the body of the JAX
function's ``shard_map``, run by every rank on its own blocks inside a
grid world (``parallel/comm.py``); ``pctx`` (``parallel/context.PCtx``)
carries the strategy's axes, the overlap mode, the wire dtype, the plain
switch, the residual layout and the step's global sequence length.

Two residual layouts (``ParallelConfig.residual``):

* ``"seq"`` (the default; Korthikanti sequence parallel): between blocks
  a rank holds its token shard [B, S/n, H].  Column-parallel gathers the
  sequence at entry (a ring AG-matmul under ``overlap``, a bulk all-gather
  otherwise), row-parallel reduce-scatters it at exit (a ring matmul-RS,
  or a bulk reduce-scatter).  Q/K/V share one gather
  (:func:`col_parallel_shared`), so does the gated FFN pair (:func:`ffn`),
  and the loss rings the head's vocab chunks over the model axis while
  the labels stay token-sharded (:func:`fused_lm_loss_seq`).
* ``"replicated"``: every rank of the model axis holds [B, S, H]; the
  column-parallel forward is local and the row-parallel output is
  all-reduced (a matmul-RS over the hidden columns and a ring all-gather
  under ``overlap``, a bulk psum otherwise).

A sequence the model ring cannot divide (``sharding.seq_shardable`` of
the global extent) runs the replicated layout, as JAX's per-call
fallback does; ``seq_loss_ok`` falls back to the logits and a sharded
cross-entropy.  The gates are JAX's: ``_seq_ring``, ``_ring_info``
(``overlap.rs_ok``), ``seq_loss_ok`` and, inside the dispatchers of
``core/overlap.py``, the ``fused_ok_*`` gates of the ring kernels.
Every collective goes through those dispatchers or ``comm``, and its
route is logged in ``OV.ROUTES``.

Gradients follow ``comm``'s convention, not JAX's ``custom_vjp``: a
rank's gradient of an activation is its own contribution, and the sum
over the ranks is the transpose of a collective.  In the replicated
layout JAX all-reduces the column-parallel dx in its backward and keeps
the row-parallel backward local; here the column-parallel backward is
local (each rank's dx is its heads' part) and the transpose of the row's
all-reduce (of the embedding's psum, of the loss's sums) adds the parts
once.  Same gradients, the same all-reduce bytes, one place: under
``overlap`` the row's transpose is a ring reduce-scatter and the
contracted AG-matmul (``ag_matmul_contract``).  The local products are
the tile matmul (``kernels/ops.tile_mm``) and the gated pair the gated
kernel's differentiable op, as ``PCtx`` runs them on one device.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import overlap as OV
from repro_torch.kernels import ops, ref
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd


def _mm(pctx, x, w):
    """A rank's local product: the tile matmul where autograd will
    differentiate, else (serving) ``PCtx``'s forward-only matmul, as one
    device runs it."""
    if not ops.needs_grad(x, w):
        return pctx._proj(x, w)
    return ops.tile_mm(x, w, plain=pctx.plain)


def _ag(x, ax, dim, op):
    OV.log_route(op, "all_gather", "bulk", ax, comm.axis_size(ax), x)
    return comm.all_gather(x, ax, dim)


def _rs(y, ax, dim, op):
    OV.log_route(op, "reduce_scatter", "bulk", ax, comm.axis_size(ax), y)
    return comm.psum_scatter(y, ax, dim)


def _ar(y, ax, op):
    OV.log_route(op, "all_reduce", "bulk", ax, comm.axis_size(ax), y)
    return comm.psum(y, ax)


def _ring_info(pctx, h_total: int):
    """(axis, n) when the model ring can decompose a replicated-layout
    all-reduce over ``h_total`` hidden columns; None: the bulk path."""
    a = pctx.ax
    if pctx.pcfg.overlap == "none" or a is None or len(a.model_axes) != 1:
        return None
    ax = a.model_axes[0]
    n = a.size(ax)
    if not OV.rs_ok(h_total, n):
        return None
    return ax, n


def _seq_ring(pctx, seq_len: int):
    """(axis, n) when the seq residual applies to a (global) sequence
    extent; None keeps the replicated residual."""
    a = pctx.ax
    if pctx.residual != "seq" or a is None:
        return None
    if not shd.seq_shardable(a, seq_len):
        return None
    ax = a.model_axes[0]
    return ax, a.size(ax)


def _seq(pctx):
    """:func:`_seq_ring` of the step's sequence: a rank's blocks are local,
    so the extent JAX reads off ``x.shape[1]`` comes from ``pctx`` (which
    a replicated residual, decode's, never needs)."""
    if pctx.residual != "seq":
        return None
    return _seq_ring(pctx, pctx.global_seq_len())


def col_parallel(pctx, x, w):
    """y = x @ W with W's output dim sharded over the model axis: w
    [H, O/n] -> y [B, S, O/n].  Seq layout: x is the token shard [B, S/n,
    H], gathered at entry.  Replicated layout: x [B, S, H], a local
    product."""
    seq = _seq(pctx)
    if seq is not None:
        return _col_seq(pctx, x, w, seq)
    return _mm(pctx, x, w)


def _col_seq(pctx, x, w, ring):
    ax, n = ring
    ov = pctx.pcfg.overlap
    if ov != "none":
        return OV.ag_matmul(x, w, ax, dim=1, n=n, overlap=ov, comm_dtype=pctx.comm_dtype,
                            plain=pctx.plain)
    return _mm(pctx, _ag(x, ax, 1, "col_parallel"), w)


def _gather_seq(pctx, x, ring, op):
    """The token shard gathered over the model ring: the ring (both ways
    under bidir) or the bulk all-gather."""
    ax, n = ring
    ov = pctx.pcfg.overlap
    if ov != "none":
        OV.log_ring(op, "all_gather", ov, x.shape[1], ax, n, x, comm_dtype=pctx.comm_dtype)
        return OV.ring_all_gather(x, ax, dim=1, n=n, bidir=ov == "bidir",
                                  comm_dtype=pctx.comm_dtype)
    return _ag(x, ax, 1, op)


def col_parallel_shared(pctx, x, ws):
    """Several column-parallel projections of the same residual entry
    (Q/K/V), sharing one sequence gather in the seq layout; otherwise
    per-weight :func:`col_parallel`."""
    seq = _seq(pctx)
    if seq is None or len(ws) == 1:
        return tuple(col_parallel(pctx, x, w) for w in ws)
    xg = _gather_seq(pctx, x, seq, "col_parallel_shared")
    return tuple(_mm(pctx, xg, w) for w in ws)


def row_parallel(pctx, y, w):
    """out = y @ W with W's input dim sharded: y [B, S, F/n], w [F/n, H].
    Seq layout: the partial sums reduce-scatter the sequence (out [B, S/n,
    H]); replicated: they are all-reduced (out [B, S, H])."""
    seq = _seq(pctx)
    if seq is not None:
        return _row_seq(pctx, y, w, seq)
    ring = _ring_info(pctx, w.shape[-1])
    if ring is not None:
        return _row_ring(pctx, y, w, ring)
    return _ar(_mm(pctx, y, w), pctx.ax.model_axes[0], "row_parallel")


def _row_seq(pctx, y, w, ring):
    ax, n = ring
    ov = pctx.pcfg.overlap
    if ov != "none" and OV.rs_ok(y.shape[1], n):
        return OV.matmul_rs(y, w, ax, scatter_dim=1, n=n, overlap=ov,
                            comm_dtype=pctx.comm_dtype, plain=pctx.plain)
    return _rs(_mm(pctx, y, w), ax, 1, "row_parallel")


def _row_ring(pctx, y, w, ring):
    """The all-reduce as a matmul-RS over the hidden columns and a ring
    all-gather of the reduced chunks; its transpose (a ring reduce-scatter
    of the cotangents' parts, then the contracted AG-matmul) is the sum
    over the model axis of the backward."""
    ax, n = ring
    ov, cd = pctx.pcfg.overlap, pctx.comm_dtype
    part = OV.matmul_rs(y, w, ax, scatter_dim=2, n=n, overlap=ov, comm_dtype=cd,
                        plain=pctx.plain)
    OV.log_ring("row_parallel", "all_gather", ov, part.shape[2], ax, n, part, comm_dtype=cd)
    return OV.ring_all_gather(part, ax, dim=2, n=n, bidir=ov == "bidir", comm_dtype=cd)


def _up(pctx, x, w1, w1b, act: str):
    """act(x @ w1) [* (x @ w1b)], local: the gated kernel for the pair."""
    if w1b is None:
        return ref.EPILOGUE_ACTS[act](_mm(pctx, x, w1))
    h = pctx.ops.gated_matmul(x.reshape(-1, x.shape[-1]), w1, w1b, act=act)
    return h.reshape(*x.shape[:-1], w1.shape[1])


def ffn(pctx, x, w1, w2, act: str, w1b=None):
    """Column -> row FFN; ``act`` names the epilogue activation
    (``layers.EPILOGUE_ACT``).  The seq layout gathers the token shard once
    for the gated pair and reduce-scatters the down-projection."""
    seq = _seq(pctx)
    if seq is not None:
        return _ffn_seq(pctx, x, w1, w2, act, w1b, seq)
    return row_parallel(pctx, _up(pctx, x, w1, w1b, act), w2)


def _ffn_seq(pctx, x, w1, w2, act, w1b, ring):
    ax, n = ring
    ov = pctx.pcfg.overlap
    if w1b is not None:
        h = _up(pctx, _gather_seq(pctx, x, ring, "ffn"), w1, w1b, act)
    elif ov != "none":
        h = ref.EPILOGUE_ACTS[act](OV.ag_matmul(x, w1, ax, dim=1, n=n, overlap=ov,
                                                comm_dtype=pctx.comm_dtype, plain=pctx.plain))
    else:
        h = _up(pctx, _ag(x, ax, 1, "ffn"), w1, None, act)
    if ov != "none" and OV.rs_ok(h.shape[1], n):
        return OV.matmul_rs(h, w2, ax, scatter_dim=1, n=n, overlap=ov,
                            comm_dtype=pctx.comm_dtype, plain=pctx.plain)
    return _rs(_mm(pctx, h, w2), ax, 1, "ffn")


def seq_loss_ok(pctx, seq_len: int, vocab: int) -> bool:
    """Gate of :func:`fused_lm_loss_seq`: the seq layout applies to this
    (global) sequence extent and the (padded) vocab chunks evenly over
    the ring."""
    seq = _seq_ring(pctx, seq_len)
    if seq is None:
        return False
    _, n = seq
    return n > 1 and vocab % n == 0


def _loss_step(x, wk, labels, m_run, s_run, gold, v_off: int, plain: bool):
    """One ring step of the loss: the logits of this rank's tokens against
    the vocab chunk it holds (fp32), folded into the running max, sum-exp
    and gold logit."""
    lg = ops.tile_mm(x, wk, out_dtype=torch.float32, plain=plain)
    v_loc = wk.shape[1]
    new_m = torch.maximum(m_run, lg.detach().amax(dim=-1))
    s_run = s_run * torch.exp(m_run - new_m) + torch.exp(lg - new_m[..., None]).sum(dim=-1)
    lid = labels.long() - v_off
    hit = (lid >= 0) & (lid < v_loc)
    own = torch.gather(lg, -1, lid.clamp(0, v_loc - 1)[..., None])[..., 0]
    return new_m, s_run, gold + torch.where(hit, own, torch.zeros_like(own))


def fused_lm_loss_seq(pctx, x, w, labels, loss_mask):
    """(masked NLL sum, mask count), summed over every rank; the caller
    divides.  x [B, S/n, H] (this rank's tokens), w [H, V/n] (its vocab
    chunk), labels and loss_mask [B, S/n]: the labels never leave their
    token shard.  At step k a rank holds vocab chunk (i + k) mod n, folds
    its partial logits into an online softmax, and passes the chunk to
    its left neighbour (n - 1 hops of ``comm.ring_hop`` on the wire
    dtype).  Each step's logits are recomputed in the backward
    (``jax.checkpoint(body)`` in the JAX package), and the chunk's
    gradient rides the reversed ring back to its owner.  Callers check
    :func:`seq_loss_ok` first."""
    ax, n = _seq(pctx)
    cd = pctx.comm_dtype
    if loss_mask is None:
        loss_mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    w = w.to(x.dtype)
    b, s_loc = x.shape[:2]
    v_loc = w.shape[1]
    i = comm.axis_index(ax)
    OV.log_route("fused_lm_loss_seq", "ppermute", "ring", ax, n, w, comm_dtype=cd)
    # -1e30, not -inf: exp(m_run - new_m) stays finite at step 0
    m_run = torch.full((b, s_loc), -1e30, dtype=torch.float32, device=x.device)
    s_run = torch.zeros((b, s_loc), dtype=torch.float32, device=x.device)
    gold = torch.zeros_like(s_run)
    wk = w
    for k in range(n):
        m_run, s_run, gold = checkpoint(_loss_step, x, wk, labels, m_run, s_run, gold,
                                        ((i + k) % n) * v_loc, pctx.plain, use_reentrant=False)
        if k < n - 1:
            wk = comm.ring_hop(wk, ax, -1, cd)
    lse = m_run + torch.log(s_run)
    wm = loss_mask.float()
    acc = torch.stack([torch.sum((lse - gold) * wm), torch.sum(wm)])
    acc = comm.psum(acc, pctx.ax.data_axes + (ax,))
    return acc[0], acc[1]


def xent_loss_sharded(pctx, logits, labels, loss_mask, v_ax: str, tok_axes):
    """Mean masked NLL of logits whose vocab is split over ``v_ax`` (this
    rank's [B, T, V/n] block, chunk ``axis_index(v_ax)``) and whose tokens
    are split over ``tok_axes`` (labels and mask in the logits' token
    layout): the max and sum-exp reduced over ``v_ax``, the gold logit
    picked by the rank that owns it, both sums over the data and token
    axes.  JAX's ``xent_loss`` under GSPMD."""
    lf = logits.float()
    v_loc = lf.shape[-1]
    mloc = lf.detach().amax(dim=-1)
    m = comm.raw_all_gather(mloc[None], v_ax, 0).amax(dim=0)
    lse = m + torch.log(comm.psum(torch.exp(lf - m[..., None]).sum(dim=-1), v_ax))
    lid = labels.long() - comm.axis_index(v_ax) * v_loc
    hit = (lid >= 0) & (lid < v_loc)
    own = torch.gather(lf, -1, lid.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = comm.psum(torch.where(hit, own, torch.zeros_like(own)), v_ax)
    wm = (torch.ones(labels.shape, device=lf.device) if loss_mask is None
          else loss_mask.float())
    acc = torch.stack([torch.sum((lse - gold) * wm), torch.sum(wm)])
    acc = comm.psum(acc, pctx.ax.data_axes + tuple(tok_axes))
    return acc[0] / torch.clamp(acc[1], min=1.0)
