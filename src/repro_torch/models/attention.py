"""GQA and MLA attention with the serving tier's KV caches.

Counterpart of the dense-GQA parts of ``repro/models/attention.py``:
``init_attn``, the three caches of a dense model and their factories
(``KVCache``/``init_kv_cache``, the per-sequence arena with one length
shared by the batch; ``PagedKVCache``/``init_paged_kv``, the block pool;
``QuantPagedKVCache``/``init_paged_kv_quant``, the int8 block pool with
fp32 row scales, DESIGN.md §11), ``paged_write``/``paged_gather``,
``quant_paged_write``/``quant_paged_gather`` and ``apply_attn`` (one
device; on the rank grid training, prefill and decode, where each rank
attends with its own heads over the full sequence).  The softmax
attention itself is ``PCtx.attention`` (the flash-attention kernel on
the card), which reads the g q-heads of a group against one kv-head, so
K/V are never repeated.  The int8 arena is dequantized into the compute
dtype at gather time and then runs the same attention, as the JAX
package does.  Unlike the JAX package, the caches are updated in place:
a decode step writes one token per row instead of copying the whole
arena.

Multi-head latent attention (minicpm3-4b, one device): ``init_mla``, the
latent caches ``MLACache``/``PagedMLACache``/``QuantPagedMLACache`` (the
normed latent ``c_kv`` [.., kv_lora] and the rotated ``k_rope`` [.., dr],
no head axis) with their factories, and ``apply_mla`` in JAX's two
forms: prefill and training up-project the latent through ``wkv_b`` and
run ``PCtx.attention`` with q and k at dk = dn + dr and v at its own dv
(JAX pads v to dk; the port does not); decode (one token against a
cache) is the absorbed form, whose
attention over the latent rows is ``PCtx.mla_decode`` (the absorbed
decode kernel on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import quant as Q
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


def init_mla(cfg: ModelConfig, generator: torch.Generator, layers: int):
    """Stacked [layers, ...] MLA parameters in fp32 (``repro``'s
    ``init_mla``): the query's low-rank pair ``wq_a``/``wq_b`` with the
    ``q_norm`` between them, ``wkv_a`` into the latent and the rope key,
    ``kv_norm`` on the latent, its up-projection ``wkv_b`` to per-head
    (k_nope | v), and ``wo``."""
    m = cfg.mla
    H, nh = cfg.d_model, cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    dev = generator.device
    return {
        "wq_a": L.normal_init((layers, H, m.q_lora_rank), generator),
        "q_norm": torch.ones((layers, m.q_lora_rank), dtype=torch.float32, device=dev),
        "wq_b": L.normal_init((layers, m.q_lora_rank, nh * (dn + dr)), generator),
        "wkv_a": L.normal_init((layers, H, m.kv_lora_rank + dr), generator),
        "kv_norm": torch.ones((layers, m.kv_lora_rank), dtype=torch.float32, device=dev),
        "wkv_b": L.normal_init((layers, m.kv_lora_rank, nh * (dn + dv)), generator),
        "wo": L.normal_init((layers, nh * dv, H), generator, scale=1.0 / (nh * dv) ** 0.5),
    }


class KVCache(NamedTuple):
    """Dense per-sequence KV cache: every row owns ``S_max`` positions up
    front, and one ``length`` (the tokens already written) is shared by
    the batch, as the JAX package's ``dynamic_update_slice`` writes all
    rows at one offset.  Inside ``lm.forward`` every leaf carries a
    leading layer axis (``length`` too, as the JAX tree stacks it)."""
    k: torch.Tensor            # [(L,) B, S_max, nkv, dh]
    v: torch.Tensor
    length: torch.Tensor       # [(L,)] int32


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


class QuantPagedKVCache(NamedTuple):
    """Int8 block-paged KV arena (docs/DESIGN.md §11): the protocol of
    :class:`PagedKVCache`, with per-token-per-head symmetric int8 payloads
    and a trailing-1 fp32 scale arena beside each (``max|row| / 127`` over
    the head dim; 1.0 where nothing was written, so untouched blocks
    dequantize to exact zeros).  A head dim below ``quant.MIN_QUANT_DIM``
    keeps the compute dtype (:func:`quant_arena_dtype`), and its scale
    arena stays at 1.0."""
    k: torch.Tensor            # int8 [(L,) n_blocks, block, nkv, dh]
    k_scale: torch.Tensor      # fp32 [(L,) n_blocks, block, nkv, 1]
    v: torch.Tensor
    v_scale: torch.Tensor
    block_table: torch.Tensor  # [B, max_blocks] int64 block ids (0 = null)
    lengths: torch.Tensor      # [B] int32


class MLACache(NamedTuple):
    """Dense per-sequence latent cache of MLA: :class:`KVCache`'s protocol
    with the normed latent and the rotated rope key, which every head
    shares, in place of per-head K and V."""
    c_kv: torch.Tensor         # [(L,) B, S_max, kv_lora]
    k_rope: torch.Tensor       # [(L,) B, S_max, dr]
    length: torch.Tensor       # [(L,)] int32


class PagedMLACache(NamedTuple):
    """Block-paged latent cache: :class:`PagedKVCache`'s protocol."""
    c_kv: torch.Tensor         # [(L,) n_blocks, block, kv_lora]
    k_rope: torch.Tensor       # [(L,) n_blocks, block, dr]
    block_table: torch.Tensor  # [B, max_blocks] int64
    lengths: torch.Tensor      # [B] int32


class QuantPagedMLACache(NamedTuple):
    """Int8 block-paged latent cache (DESIGN.md §11): a per-row fp32 scale
    arena beside each payload; a component narrower than
    ``quant.MIN_QUANT_DIM`` (the smoke config's 4-wide rope rows) keeps
    the compute dtype and its scales stay 1.0."""
    c_kv: torch.Tensor         # int8 [(L,) n_blocks, block, kv_lora]
    c_scale: torch.Tensor      # fp32 [(L,) n_blocks, block, 1]
    k_rope: torch.Tensor       # int8 [(L,) n_blocks, block, dr]
    r_scale: torch.Tensor      # fp32 [(L,) n_blocks, block, 1]
    block_table: torch.Tensor  # [B, max_blocks] int64
    lengths: torch.Tensor      # [B] int32


# the leaves of each cache that hold one entry per layer (the rest, the
# block table and the slots' lengths, are shared by every layer)
LAYER_LEAVES = {KVCache: ("k", "v", "length"), PagedKVCache: ("k", "v"),
                QuantPagedKVCache: ("k", "k_scale", "v", "v_scale"),
                MLACache: ("c_kv", "k_rope", "length"), PagedMLACache: ("c_kv", "k_rope"),
                QuantPagedMLACache: ("c_kv", "c_scale", "k_rope", "r_scale")}
DENSE_CACHES = (KVCache, MLACache)


def layer_cache(cache, i: int):
    """Layer ``i``'s view of a cache whose per-layer leaves are stacked."""
    return cache._replace(**{f: getattr(cache, f)[i] for f in LAYER_LEAVES[type(cache)]})


def advance(cache, n: int):
    """The cache with its lengths moved on by ``n`` written tokens."""
    if isinstance(cache, DENSE_CACHES):
        return cache._replace(length=cache.length + n)
    return cache._replace(lengths=cache.lengths + n)


def init_kv_cache(cfg: ModelConfig, batch: int, s_max: int, dtype, device,
                  layers: int, kv_heads: int = 0) -> KVCache:
    """Zero dense caches for ``layers`` layers (``kv_heads``: the heads a
    grid rank holds, default all of them)."""
    shape = (layers, batch, s_max, kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((layers,), dtype=torch.int32, device=device))


def init_mla_cache(cfg: ModelConfig, batch: int, s_max: int, dtype, device,
                   layers: int) -> MLACache:
    """Zero dense latent caches for ``layers`` layers."""
    m = cfg.mla
    return MLACache(
        torch.zeros((layers, batch, s_max, m.kv_lora_rank), dtype=dtype, device=device),
        torch.zeros((layers, batch, s_max, m.qk_rope_head_dim), dtype=dtype, device=device),
        torch.zeros((layers,), dtype=torch.int32, device=device))


def dense_write(arena: torch.Tensor, vals: torch.Tensor, length: torch.Tensor) -> None:
    """Write ``vals`` [B, S, ...] at positions ``length .. length + S - 1``
    of every row of the dense arena [B, S_max, ...], in place."""
    pos = length.long() + torch.arange(vals.shape[1], device=vals.device)
    arena.index_copy_(1, pos, vals.to(arena.dtype))


def quant_arena_dtype(row_dim: int, dtype):
    """int8 for rows of at least ``quant.MIN_QUANT_DIM`` elements, else the
    dense dtype (a narrower row's scale would eat the byte win; the JAX
    package's ``_quant_arena_dtype``)."""
    return torch.int8 if row_dim >= Q.MIN_QUANT_DIM else dtype


def init_paged_kv(cfg: ModelConfig, num_blocks: int, block: int, batch: int,
                  max_blocks: int, dtype, device, layers: int) -> PagedKVCache:
    dh = cfg.resolved_head_dim
    shape = (layers, num_blocks, block, cfg.num_kv_heads, dh)
    return PagedKVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros((batch, max_blocks), dtype=torch.int64, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def init_paged_kv_quant(cfg: ModelConfig, num_blocks: int, block: int, batch: int,
                        max_blocks: int, dtype, device, layers: int) -> QuantPagedKVCache:
    dh, nkv = cfg.resolved_head_dim, cfg.num_kv_heads
    shape = (layers, num_blocks, block, nkv, dh)
    dt = quant_arena_dtype(dh, dtype)
    ones = lambda: torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=device)  # noqa: E731
    return QuantPagedKVCache(
        torch.zeros(shape, dtype=dt, device=device), ones(),
        torch.zeros(shape, dtype=dt, device=device), ones(),
        torch.zeros((batch, max_blocks), dtype=torch.int64, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def init_paged_mla(cfg: ModelConfig, num_blocks: int, block: int, batch: int,
                   max_blocks: int, dtype, device, layers: int) -> PagedMLACache:
    m = cfg.mla
    return PagedMLACache(
        torch.zeros((layers, num_blocks, block, m.kv_lora_rank), dtype=dtype, device=device),
        torch.zeros((layers, num_blocks, block, m.qk_rope_head_dim), dtype=dtype,
                    device=device),
        torch.zeros((batch, max_blocks), dtype=torch.int64, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def init_paged_mla_quant(cfg: ModelConfig, num_blocks: int, block: int, batch: int,
                         max_blocks: int, dtype, device, layers: int) -> QuantPagedMLACache:
    """Int8 latent arenas, each component by :func:`quant_arena_dtype`'s
    rule on its own row width."""
    m = cfg.mla
    lead = (layers, num_blocks, block)
    ones = lambda: torch.ones(lead + (1,), dtype=torch.float32, device=device)  # noqa: E731
    return QuantPagedMLACache(
        torch.zeros(lead + (m.kv_lora_rank,), dtype=quant_arena_dtype(m.kv_lora_rank, dtype),
                    device=device), ones(),
        torch.zeros(lead + (m.qk_rope_head_dim,),
                    dtype=quant_arena_dtype(m.qk_rope_head_dim, dtype), device=device), ones(),
        torch.zeros((batch, max_blocks), dtype=torch.int64, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def _slots(arena: torch.Tensor, block_table: torch.Tensor, lengths: torch.Tensor, S: int):
    """(block ids, offsets) [B, S] of positions ``lengths[b] + s``; a
    position past the table resolves to its last entry."""
    block = arena.shape[1]
    pos = lengths.long()[:, None] + torch.arange(S, device=arena.device)[None, :]
    blk_slot = torch.clamp(pos // block, max=block_table.shape[1] - 1)
    return torch.gather(block_table, 1, blk_slot), pos % block


def paged_write(arena: torch.Tensor, vals: torch.Tensor, block_table: torch.Tensor,
                lengths: torch.Tensor) -> None:
    """Scatter ``vals`` [B, S, ...] into the block arena, in place.

    Token s of row b lands at absolute position ``lengths[b] + s``: block
    ``block_table[b, pos // block]``, offset ``pos % block``.  Positions past
    the table resolve to its last entry (the null block unless the slot
    leases the whole table), as in the JAX package."""
    blk, off = _slots(arena, block_table, lengths, vals.shape[1])
    arena[blk, off] = vals.to(arena.dtype)


def paged_gather(arena: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Slot-contiguous [B, max_blocks*block, ...] view of the pages.

    Positions past a slot's length read null-block or stale data; attention
    masks them with the per-slot lengths."""
    B, nblk = block_table.shape
    g = arena[block_table]                     # [B, nblk, block, ...]
    return g.reshape(B, nblk * arena.shape[1], *arena.shape[2:])


def quant_paged_write(arena: torch.Tensor, scales: torch.Tensor, vals: torch.Tensor,
                      block_table: torch.Tensor, lengths: torch.Tensor) -> None:
    """Quantize ``vals`` [B, S, ...] per trailing-axis row
    (``quant.quant_int8``) and scatter the int8 payload and its fp32 scales
    at the same arena indices, in place (the null-block rule of
    :func:`paged_write`).  A dense-dtype arena (:func:`quant_arena_dtype`)
    takes ``vals`` as they are and leaves its scales at 1.0."""
    if arena.dtype != torch.int8:
        paged_write(arena, vals, block_table, lengths)
        return
    q, s = Q.quant_int8(vals)
    blk, off = _slots(arena, block_table, lengths, vals.shape[1])
    arena[blk, off] = q
    scales[blk, off] = s


def quant_paged_gather(arena: torch.Tensor, scales: torch.Tensor, block_table: torch.Tensor,
                       dtype) -> torch.Tensor:
    """:func:`paged_gather` of an int8 arena, dequantized into ``dtype``
    (a dense-dtype arena is only cast).  Positions past a slot's length
    read finite values (the scales start at 1.0) that attention masks."""
    if arena.dtype != torch.int8:
        return paged_gather(arena, block_table).to(dtype)
    B, nblk = block_table.shape
    g = Q.dequant_int8(arena[block_table], scales[block_table], dtype)
    return g.reshape(B, nblk * arena.shape[1], *arena.shape[2:])


# each payload leaf's scale leaf in the int8 arenas
SCALE_LEAVES = {"k": "k_scale", "v": "v_scale", "c_kv": "c_scale", "k_rope": "r_scale"}


def cache_rows(cache, vals, dtype):
    """Write ``vals`` (one [B, S, ...] tensor per payload leaf of a layer's
    ``cache``: (k, v), or MLA's (c_kv, k_rope)) at the cache's lengths, in
    place, and return what attention reads: (each leaf's rows [B, T, ...]
    in ``dtype``, q_offset, kv_len, the cache advanced by S).

    A dense cache writes every row at its one ``length`` and masks all
    rows there.  A paged cache (fp, or int8 quantized at write and
    dequantized at gather) masks each slot at its own length: decode
    (S == 1) has q_offset = length and kv_len = length + 1, the grouped
    decode mask; prefill (S > 1) runs one sequence whose queries start at
    the slot's length, as ``_sdpa`` does with ``q_offset``/``kv_len``."""
    B, S = vals[0].shape[:2]
    names = [f for f in LAYER_LEAVES[type(cache)] if f in SCALE_LEAVES]
    new = advance(cache, S)
    if isinstance(cache, DENSE_CACHES):
        for f, v in zip(names, vals):
            dense_write(getattr(cache, f), v, cache.length)
        return ([getattr(cache, f).to(dtype) for f in names],
                cache.length.reshape(1).expand(B).contiguous(),
                new.length.reshape(1).expand(B).contiguous(), new)
    if S > 1 and B != 1:
        raise ValueError("paged prefill runs one sequence at a time")
    bt, rows = cache.block_table, []
    for f, v in zip(names, vals):
        arena = getattr(cache, f)
        if hasattr(cache, SCALE_LEAVES[f]):
            scales = getattr(cache, SCALE_LEAVES[f])
            quant_paged_write(arena, scales, v, bt, cache.lengths)
            rows.append(quant_paged_gather(arena, scales, bt, dtype))
        else:
            paged_write(arena, v, bt, cache.lengths)
            rows.append(paged_gather(arena, bt).to(dtype))
    return rows, cache.lengths, new.lengths, new


def apply_attn(pctx, cfg: ModelConfig, p, x: torch.Tensor, *, positions: torch.Tensor,
               cache=None) -> Tuple[torch.Tensor, Optional[NamedTuple]]:
    """Causal self-attention: x [B,S,H] -> (y [B,S,H], cache with lengths
    advanced by S).  On the grid x and y are canonical blocks and
    ``positions`` covers the full sequence (the mixer gathers it); a
    cache there holds this rank's kv heads.  The caches' writes and masks
    are :func:`cache_rows`'."""
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
        (k, v), q_off, kv_len, new_cache = cache_rows(cache, (k, v), q.dtype)
    o = pctx.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       causal=True, q_offset=q_off, kv_len=kv_len)
    y = pctx.mixer_out(o.transpose(1, 2).reshape(B, S, -1), p["wo"])
    return y, new_cache


def apply_mla(pctx, cfg: ModelConfig, p, x: torch.Tensor, *, positions: torch.Tensor,
              cache=None) -> Tuple[torch.Tensor, Optional[NamedTuple]]:
    """Multi-head latent attention on one device: x [B,S,H] -> (y [B,S,H],
    cache with lengths advanced by S), over a dense, paged or int8 latent
    cache (:func:`cache_rows`) or none.

    Prefill and training up-project the latent (``wkv_b``, the product
    op) into per-head k_nope and v, and attend with q = [q_nope | q_rope]
    against k = [k_nope | k_rope] at dk = dn + dr and v at its own dv
    (a view of the up-projection): the JAX package pads v to dk and
    slices the output back, which the zero columns leave equal.
    Decode (S == 1 with a cache) never builds per-head K/V: q_nope is
    absorbed into the latent through ``wkv_b``'s k part, ``PCtx.mla_decode``
    attends over the latent rows with scale (dn + dr)^-0.5, and its fp32
    o_lat goes out through ``wkv_b``'s v part."""
    if pctx.mesh is not None:
        raise NotImplementedError("MLA on the rank grid is not ported (the latent caches have "
                                  "no head axis to shard)")
    m = cfg.mla
    nh, lora = cfg.num_heads, m.kv_lora_rank
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    B, S, _ = x.shape

    ql, kv = pctx.mixer_in_many(x, p["wq_a"], p["wkv_a"])
    ql = L.apply_norm("rmsnorm", {"scale": p["q_norm"]}, ql)
    q = pctx.mixer_in(ql, p["wq_b"], interior=True).reshape(B, S, nh, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    c_kv = L.apply_norm("rmsnorm", {"scale": p["kv_norm"]}, kv[..., :lora])
    cos, sin = L.rope_cos_sin(positions, dr, cfg.rope_theta)
    q_rope = L.apply_rope(q_rope, cos, sin)
    k_rope = L.apply_rope(kv[:, :, None, lora:], cos, sin)[:, :, 0, :]

    new_cache, q_off, kv_len = None, None, None
    if cache is not None:
        (c_kv, k_rope), q_off, kv_len, new_cache = cache_rows(cache, (c_kv, k_rope), x.dtype)

    if cache is not None and S == 1:
        # the absorbed decode: per-head K/V are never built
        wkv = p["wkv_b"].reshape(lora, nh, dn + dv)
        q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], wkv[..., :dn].to(x.dtype))
        o_lat = pctx.mla_decode(q_lat.contiguous(), q_rope[:, 0], c_kv, k_rope, kv_len,
                                (dn + dr) ** -0.5)
        o = torch.einsum("bhl,lhd->bhd", o_lat, wkv[..., dn:].float()).to(x.dtype)
    else:
        kv_up = pctx.mixer_in(c_kv, p["wkv_b"], interior=True)
        T = kv_up.shape[1]
        kv_up = kv_up.reshape(B, T, nh, dn + dv)
        k = torch.cat([kv_up[..., :dn], k_rope[:, :, None, :].expand(B, T, nh, dr)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        o = pctx.attention(qq.transpose(1, 2), k.transpose(1, 2),
                           kv_up[..., dn:].transpose(1, 2), causal=True, q_offset=q_off,
                           kv_len=kv_len).transpose(1, 2)
    y = pctx.mixer_out(o.reshape(B, S, nh * dv), p["wo"])
    return y, new_cache
