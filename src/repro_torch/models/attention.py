"""GQA attention with the paged KV cache of the serving tier.

Counterpart of the dense-GQA parts of ``repro/models/attention.py``:
``init_attn``, ``PagedKVCache``/``init_paged_kv``, ``paged_write``/
``paged_gather`` and ``apply_attn`` (one device, and training on the
hecaton grid, where each rank attends with its own heads over the full
sequence).  The softmax attention itself is
``PCtx.attention`` (the flash-attention kernel on the card), which reads
the g q-heads of a group against one kv-head, so K/V are never repeated.
Unlike the JAX package, the arenas are updated in place: a decode step
writes one token per slot instead of copying the whole arena.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L


def init_attn(cfg: ModelConfig, generator: torch.Generator, layers: int):
    """Stacked [layers, ...] attention parameters in fp32."""
    dh = cfg.resolved_head_dim
    nh, nkv, H = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    p = {
        "wq": L.normal_init((layers, H, nh * dh), generator),
        "wk": L.normal_init((layers, H, nkv * dh), generator),
        "wv": L.normal_init((layers, H, nkv * dh), generator),
        "wo": L.normal_init((layers, nh * dh, H), generator,
                            scale=1.0 / (nh * dh) ** 0.5),
    }
    if cfg.qk_norm:
        dev = generator.device
        p["q_norm"] = torch.ones((layers, dh), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((layers, dh), dtype=torch.float32, device=dev)
    return p


class PagedKVCache(NamedTuple):
    """Block-paged KV cache (docs/DESIGN.md §10).

    One arena of fixed-size blocks shared by every decode slot; slot b owns
    the blocks in ``block_table[b]`` (0 = the null block that absorbs writes
    from padded or inactive slots).  Inside ``lm.forward`` the arenas carry a
    leading layer axis; table and lengths are shared by all layers."""
    k: torch.Tensor            # [(L,) n_blocks, block, nkv, dh]
    v: torch.Tensor
    block_table: torch.Tensor  # [B, max_blocks] int64 block ids (0 = null)
    lengths: torch.Tensor      # [B] int32 tokens already written per slot


def init_paged_kv(cfg: ModelConfig, num_blocks: int, block: int, batch: int,
                  max_blocks: int, dtype, device, layers: int) -> PagedKVCache:
    dh = cfg.resolved_head_dim
    shape = (layers, num_blocks, block, cfg.num_kv_heads, dh)
    return PagedKVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros((batch, max_blocks), dtype=torch.int64, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def paged_write(arena: torch.Tensor, vals: torch.Tensor, block_table: torch.Tensor,
                lengths: torch.Tensor) -> None:
    """Scatter ``vals`` [B, S, ...] into the block arena, in place.

    Token s of row b lands at absolute position ``lengths[b] + s``: block
    ``block_table[b, pos // block]``, offset ``pos % block``.  Positions past
    the table resolve to its last entry (the null block unless the slot
    leases the whole table), as in the JAX package."""
    B, S = vals.shape[:2]
    block = arena.shape[1]
    pos = lengths.long()[:, None] + torch.arange(S, device=vals.device)[None, :]
    blk_slot = torch.clamp(pos // block, max=block_table.shape[1] - 1)
    blk = torch.gather(block_table, 1, blk_slot)                    # [B,S]
    arena[blk, pos % block] = vals.to(arena.dtype)


def paged_gather(arena: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Slot-contiguous [B, max_blocks*block, ...] view of the pages.

    Positions past a slot's length read null-block or stale data; attention
    masks them with the per-slot lengths."""
    B, nblk = block_table.shape
    g = arena[block_table]                     # [B, nblk, block, ...]
    return g.reshape(B, nblk * arena.shape[1], *arena.shape[2:])


def apply_attn(pctx, cfg: ModelConfig, p, x: torch.Tensor, *, positions: torch.Tensor,
               cache: Optional[PagedKVCache] = None,
               ) -> Tuple[torch.Tensor, Optional[PagedKVCache]]:
    """Causal self-attention: x [B,S,H] -> (y [B,S,H], cache with lengths
    advanced by S).  On the grid x and y are canonical blocks and
    ``positions`` covers the full sequence (the mixer gathers it).

    With a paged cache, decode (S == 1) masks each slot at its own length;
    prefill (S > 1) runs one sequence and offsets its queries by the slot's
    length, as ``_sdpa`` does with ``q_offset``/``kv_len``."""
    dh = cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    B, S, _ = x.shape

    qp, kp, vp = pctx.mixer_in_many(x, p["wq"], p["wk"], p["wv"])
    # on the grid: the full sequence and this rank's heads
    S = qp.shape[1]
    q, k, v = pctx.local_heads(cfg, qp, kp, vp, B * pctx.data_shards)
    if cfg.qk_norm:
        q = L.rms_head_norm(p["q_norm"], q)
        k = L.rms_head_norm(p["k_norm"], k)
    cos, sin = L.rope_cos_sin(positions, dh, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)

    new_cache, q_off, kv_len = None, None, None
    if cache is not None:
        paged_write(cache.k, k, cache.block_table, cache.lengths)
        paged_write(cache.v, v, cache.block_table, cache.lengths)
        new_cache = cache._replace(lengths=cache.lengths + S)
        k = paged_gather(cache.k, cache.block_table).to(q.dtype)
        v = paged_gather(cache.v, cache.block_table).to(q.dtype)
        if S > 1 and B != 1:
            raise ValueError("paged prefill runs one sequence at a time")
        # decode: q_off = length, kv_len = length + 1 is the grouped-decode
        # mask; prefill: the prompt's queries start at the slot's length
        q_off, kv_len = cache.lengths, new_cache.lengths
    o = pctx.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       causal=True, q_offset=q_off, kv_len=kv_len)
    y = pctx.mixer_out(o.transpose(1, 2).reshape(B, S, -1), p["wo"])
    return y, new_cache
