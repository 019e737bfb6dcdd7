"""Hecaton's distributed training method (paper §IV, Algorithm 1).

Counterpart of ``repro/core/hecaton.py``.  Each grid op is the body of
the JAX op's ``shard_map``, run by every rank on its own blocks inside a
grid world (``parallel/comm.py``): ``linear_seq_scatter``, ``mixer_in``,
``mixer_out``, ``ffn_block`` (with the gated pair), ``embed_2d`` and the
grid branch of ``fused_lm_loss`` (vocab chunks over the hidden axis, a
log-sum-exp reduced across the chunks, loss and mask count summed over
every rank).  ``overlap`` picks bulk collectives (``"none"``, Algorithm 1
verbatim) or the ring lattice of ``core/overlap.py`` (``"ring"``,
``"bidir"``, ``"fused"``), whose hops cross in ``comm_dtype`` (``"int8"``:
quantized where ``core/quant.quant_ok`` admits the shard; the bulk path
ignores it, as in JAX); every collective's route is logged there
(``OV.ROUTES``).
``plain=True`` sends every product to its plain version (the reference
path).  ``fused_lm_loss`` with ``mesh=None`` is the single-device branch:
the head logits come out of the tile matmul in fp32.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import overlap as OV
from repro_torch.kernels import ops
from repro_torch.parallel import comm

# local vocab slice above which the embedding's vocab collect takes the
# ring reduce-scatter instead of the one-hot matmul-RS (the JAX value)
EMBED_FUSED_VMAX = 2048



def _ag(x, ax, dim, op):
    OV.log_route(op, "all_gather", "bulk", ax, comm.axis_size(ax), x)
    return comm.all_gather(x, ax, dim)


def _rs(x, ax, dim, op):
    OV.log_route(op, "reduce_scatter", "bulk", ax, comm.axis_size(ax), x)
    return comm.psum_scatter(x, ax, dim)


# ---------------------------------------------------------------------------
# pattern 1: the fused-linear dataflow (Algorithm 1, seq-scatter)
# ---------------------------------------------------------------------------

def linear_seq_scatter(x, w, *, t_ax: str = "mx", h_ax: str = "my", overlap: str = "none",
                       comm_dtype: str = "bf16", plain: bool = False):
    """x [B, T/t, H/h] (tokens over t_ax, hidden over h_ax), w [H/h, O/t]
    -> y [B, T/h, O/t] (the transposed tiling)."""
    OV.check_mode(overlap)
    n_t, n_h = comm.axis_size(t_ax), comm.axis_size(h_ax)
    if overlap != "none":
        return OV.ring_linear(x, w, g_ax=t_ax, n_g=n_t, s_ax=h_ax, n_s=n_h, gather_dim=1,
                              scatter_dim=1, overlap=overlap, comm_dtype=comm_dtype,
                              plain=plain)
    xg = _ag(x, t_ax, 1, "linear_seq_scatter")
    return _rs(ops.tile_mm(xg, w, plain=plain), h_ax, 1, "linear_seq_scatter")


# ---------------------------------------------------------------------------
# pattern 2: the token-mixer dataflow (paper §IV-C)
# ---------------------------------------------------------------------------

def mixer_in(x, w, *, t_ax: str = "mx", h_ax: str = "my", overlap: str = "none",
             comm_dtype: str = "bf16", plain: bool = False):
    """x [B, T/t, H/h] -> [B, T, O/(t,h)]: the sequence gathered, the
    output hidden sharded over the whole grid (chunk t_idx * n_h + h_idx)."""
    OV.check_mode(overlap)
    n_t, n_h = comm.axis_size(t_ax), comm.axis_size(h_ax)
    if overlap != "none":
        return OV.ring_linear(x, w, g_ax=t_ax, n_g=n_t, s_ax=h_ax, n_s=n_h, gather_dim=1,
                              scatter_dim=2, overlap=overlap, comm_dtype=comm_dtype,
                              plain=plain)
    xg = _ag(x, t_ax, 1, "mixer_in")
    return _rs(ops.tile_mm(xg, w, plain=plain), h_ax, 2, "mixer_in")


def mixer_out(a, w, *, t_ax: str = "mx", h_ax: str = "my", overlap: str = "none",
              comm_dtype: str = "bf16", plain: bool = False):
    """a [B, T, Hm/(t,h)] -> [B, T/t, O/h]; w [Hm/t, O/h].  The gathered dim
    is the contraction dim, so the overlapped gather accumulates partial
    products (``ag_matmul_contract``)."""
    OV.check_mode(overlap)
    n_t, n_h = comm.axis_size(t_ax), comm.axis_size(h_ax)
    if overlap != "none":
        bidir, kw = overlap == "bidir", dict(comm_dtype=comm_dtype)
        rs_ok = OV.rs_ok(a.shape[1], n_t)
        if OV.fuse_side(a.shape[-1], w.shape[-1]) == "rs" and rs_ok:
            OV.log_ring("mixer_out", "all_gather", overlap, a.shape[2], h_ax, n_h, a, **kw)
            ag = OV.ring_all_gather(a, h_ax, dim=2, n=n_h, bidir=bidir, **kw)
            return OV.matmul_rs(ag, w, t_ax, scatter_dim=1, n=n_t, overlap=overlap,
                                plain=plain, **kw)
        yp = OV.ag_matmul_contract(a, w, h_ax, n=n_h, overlap=overlap, plain=plain, **kw)
        if not rs_ok:
            return _rs(yp, t_ax, 1, "mixer_out")
        OV.log_ring("mixer_out", "reduce_scatter", overlap, yp.shape[1] // n_t, t_ax, n_t, yp,
                    **kw)
        return OV.ring_reduce_scatter(yp, t_ax, dim=1, n=n_t, bidir=bidir, **kw)
    ag = _ag(a, h_ax, 2, "mixer_out")
    return _rs(ops.tile_mm(ag, w, plain=plain), t_ax, 1, "mixer_out")


# ---------------------------------------------------------------------------
# the fused FFN block (paper §IV-B "two rounds of transposition")
# ---------------------------------------------------------------------------

def ffn_block(x, w1, w2, *, act_fn: Callable, t_ax: str = "mx", h_ax: str = "my", w1b=None,
              overlap: str = "none", comm_dtype: str = "bf16", plain: bool = False):
    """Two chained seq-scatter linears with swapped axis roles: x [B, T/t,
    H/h], w1 (and w1b) [H/h, F/t], w2 [F/t, H/h] -> [B, T/t, H/h].  The
    gated up-projections share one gathered x (the pair)."""
    OV.check_mode(overlap)
    n_t, n_h = comm.axis_size(t_ax), comm.axis_size(h_ax)
    if overlap != "none":
        kw = dict(overlap=overlap, comm_dtype=comm_dtype, plain=plain)
        if w1b is not None:
            OV.log_ring("ffn_block", "all_gather", overlap, x.shape[1], t_ax, n_t, x,
                        comm_dtype=comm_dtype)
            xg = OV.ring_all_gather(x, t_ax, dim=1, n=n_t, bidir=overlap == "bidir",
                                    comm_dtype=comm_dtype)
            if OV.rs_ok(xg.shape[1], n_h):
                h, g = OV.matmul_rs_pair(xg, w1, w1b, h_ax, scatter_dim=1, n=n_h, **kw)
            else:
                h = _rs(ops.tile_mm(xg, w1, plain=plain), h_ax, 1, "ffn_block")
                g = _rs(ops.tile_mm(xg, w1b, plain=plain), h_ax, 1, "ffn_block")
            h = act_fn(h) * g
        else:
            h = act_fn(OV.ring_linear(x, w1, g_ax=t_ax, n_g=n_t, s_ax=h_ax, n_s=n_h, **kw))
        return OV.ring_linear(h, w2, g_ax=h_ax, n_g=n_h, s_ax=t_ax, n_s=n_t, **kw)
    xg = _ag(x, t_ax, 1, "ffn_block")
    h = _rs(ops.tile_mm(xg, w1, plain=plain), h_ax, 1, "ffn_block")
    if w1b is not None:
        h = act_fn(h) * _rs(ops.tile_mm(xg, w1b, plain=plain), h_ax, 1, "ffn_block")
    else:
        h = act_fn(h)
    hg = _ag(h, h_ax, 1, "ffn_block")
    return _rs(ops.tile_mm(hg, w2, plain=plain), t_ax, 1, "ffn_block")


# ---------------------------------------------------------------------------
# the vocab-parallel embedding (paper §IV-B steps 2-3)
# ---------------------------------------------------------------------------

def embed_2d(ids, table, *, t_ax: str = "mx", compute_dtype=torch.bfloat16,
             seq_sharded: bool = True, overlap: str = "none", comm_dtype: str = "bf16",
             plain: bool = False):
    """ids [B, S/t] (tokens over t_ax), table [V/t, H/h] -> [B, S/t, H/h]:
    each rank looks up its vocab slice for all tokens of its column, and a
    reduce-scatter over t_ax sums the vocab partials and tiles the tokens
    (megatron's ``t_ax="model"`` with the whole hidden dim: the seq
    residual).  ``seq_sharded=False``: ids [B, S] whole on every rank of
    t_ax, the partials summed by a psum over t_ax, out [B, S, H/h] (the
    replicated residual, and a sequence the ring cannot divide)."""
    OV.check_mode(overlap)
    n_t = comm.axis_size(t_ax)
    bidir = overlap == "bidir"
    if not seq_sharded:
        idg = ids
    elif overlap != "none":
        # integer ids: quant_ok keeps these hops full width
        OV.log_ring("embed_2d", "all_gather", overlap, ids.shape[1], t_ax, n_t, ids,
                    comm_dtype=comm_dtype)
        idg = OV.ring_all_gather(ids, t_ax, dim=1, n=n_t, bidir=bidir, comm_dtype=comm_dtype)
    else:
        idg = _ag(ids, t_ax, 1, "embed_2d")
    v_loc = table.shape[0]
    lid = idg.long() - comm.axis_index(t_ax) * v_loc
    ok = (lid >= 0) & (lid < v_loc)
    if (seq_sharded and overlap == "fused" and v_loc <= EMBED_FUSED_VMAX
            and OV.rs_ok(idg.shape[1], n_t)):
        # one-hot form: the vocab partial is onehot @ table slice, a matmul
        # the fused dispatcher can run as one matmul-RS kernel
        onehot = (torch.where(ok, lid, v_loc)[..., None]
                  == torch.arange(v_loc, device=ids.device)).to(compute_dtype)
        return OV.matmul_rs(onehot, table.to(compute_dtype), t_ax, scatter_dim=1, n=n_t,
                            overlap=overlap, comm_dtype=comm_dtype, plain=plain)
    emb = table[lid.clamp(0, v_loc - 1)]
    emb = (emb * ok[..., None]).to(compute_dtype)
    if not seq_sharded:
        OV.log_route("embed_2d", "all_reduce", "bulk", t_ax, n_t, emb)
        return comm.psum(emb, t_ax)
    if overlap != "none" and OV.rs_ok(emb.shape[1], n_t):
        OV.log_ring("embed_2d", "reduce_scatter", overlap, emb.shape[1] // n_t, t_ax, n_t, emb,
                    comm_dtype=comm_dtype)
        return OV.ring_reduce_scatter(emb, t_ax, dim=1, n=n_t, bidir=bidir,
                                      comm_dtype=comm_dtype)
    return _rs(emb, t_ax, 1, "embed_2d")


# ---------------------------------------------------------------------------
# the fused chunked LM head + cross-entropy
# ---------------------------------------------------------------------------

def fused_lm_loss(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                  loss_mask: Optional[torch.Tensor], *, mesh=None,
                  tile_matmul=ops.tile_matmul, t_ax: str = "mx", h_ax: str = "my",
                  n_chunks: int = 8, overlap: str = "none", comm_dtype: str = "bf16",
                  plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked NLL, mask count); the caller divides.

    ``mesh=None``: x [B,S,H] in the compute dtype, w [H,V] (the tied head
    is the transposed view of the table, read in place), labels and
    loss_mask [B,S]; the [B*S, V] fp32 logits live until the backward.

    On a grid (``mesh`` a ``Grid``): x [B, S/t, H/h] canonical, w [H, V/h]
    (vocab over h_ax), labels and loss_mask [B, S/t].  The tokens are cut
    into ``n_chunks`` chunks; per chunk the [tc, V/h] fp32 logits come out
    of the contracted gather over h_ax, the log-sum-exp and the gold logit
    are reduced over h_ax, and the chunk is recomputed in the backward
    (``jax.checkpoint`` in the JAX package).  Both sums are reduced over
    data and t_ax, so every rank returns the global values."""
    if loss_mask is None:
        loss_mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    if mesh is None:
        lf = tile_matmul(x.reshape(-1, x.shape[-1]), w.to(x.dtype), out_dtype=torch.float32)
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.reshape(-1, 1).long())[:, 0]
        wmask = loss_mask.reshape(-1).float()
        return torch.sum((lse - gold) * wmask), torch.sum(wmask)

    OV.check_mode(overlap)
    w = w.to(x.dtype)
    b, s_loc, _ = x.shape
    v_loc = w.shape[1]
    v_off = comm.axis_index(h_ax) * v_loc
    n_h = comm.axis_size(h_ax)
    nc = n_chunks
    while s_loc % nc:
        nc -= 1
    tc = s_loc // nc

    def chunk(xc, wl, lc, mc):
        if overlap != "none":
            lg = OV.ag_matmul_contract(xc, wl, h_ax, n=n_h, overlap=overlap,
                                       out_dtype=torch.float32, comm_dtype=comm_dtype,
                                       plain=plain)
        else:
            lg = ops.tile_mm(_ag(xc, h_ax, 2, "fused_lm_loss"), wl, out_dtype=torch.float32,
                             plain=plain)
        mloc = lg.detach().amax(dim=-1)
        mglob = comm.raw_all_gather(mloc[None], h_ax, 0).amax(dim=0)
        e = torch.exp(lg - mglob[..., None])
        lse = mglob + torch.log(comm.psum(e.sum(dim=-1), h_ax))
        lid = lc.long() - v_off
        hit = (lid >= 0) & (lid < v_loc)
        own = torch.gather(lg, -1, lid.clamp(0, v_loc - 1)[..., None])[..., 0]
        gold = comm.psum(torch.where(hit, own, torch.zeros_like(own)), h_ax)
        wm = mc.float()
        return torch.stack([torch.sum((lse - gold) * wm), torch.sum(wm)])

    acc = torch.zeros(2, dtype=torch.float32, device=x.device)
    for c in range(nc):
        sl = slice(c * tc, (c + 1) * tc)
        acc = acc + checkpoint(chunk, x[:, sl], w, labels[:, sl], loss_mask[:, sl],
                               use_reentrant=False)
    acc = comm.psum(acc, ("data", t_ax))
    return acc[0], acc[1]
