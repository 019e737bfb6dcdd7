"""KV caches of the decode service: the dense layout and the paged block
pool (docs/DESIGN.md §10).

Counterpart of ``repro/serve/cache.py`` for dense models' attention
arena and the ssm family's per-slot states: ``init_dense``,
``dense_cache_bytes``, ``PoolConfig``, ``blocks_for``, ``NULL_BLOCK`` and
``CachePool``.

* **dense** (:func:`init_dense`): every leaf is ``[L, B, S_max, ...]``,
  so each sequence pins ``S_max`` tokens up front; ``serve/step.
  build_prefill`` fills it and the grid's serving path shards it
  (``serve/step.cache_specs``).
* **paged** (:class:`CachePool`): one arena of fixed-size blocks that the
  slots lease through a block table.  The host accounting is the JAX
  package's, line for line, for both families: the admission gate leases
  ``ceil(prompt_len / block)`` blocks into a free slot or leaves the
  request queued, ``ensure_append`` leases lazily before each decode
  token, ``free_slot`` returns a lease, and the peak of ``blocks_in_use``
  is tracked against the dense ``[slots, max_seq]`` arena.  With
  ``quant_kv=True`` the arenas hold int8 payloads and fp32 row scales
  (``models/attention.QuantPagedKVCache``, DESIGN.md §11).

An MLA model (``cfg.mla``) keeps its latent caches in both layouts:
``MLACache`` dense, ``PagedMLACache`` or ``QuantPagedMLACache`` in the
pool (``c_kv`` and ``k_rope``, each with a scale arena when int8).

The steps write the device arenas and the decode tick's SSM states in
place, so the JAX package's ``absorb_decode`` has no counterpart here; a
prefill runs on fresh zero state rows, which ``absorb_prefill`` scatters
into the slot's row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as ATT
from repro_torch.models import ssm as SSM


def init_dense(cfg: ModelConfig, batch: int, s_max: int, dtype, device="cuda",
               kv_heads: int = 0):
    """Stacked per-layer dense decode caches: ``{"attn": KVCache}`` with K
    and V ``[L, B, S_max, nkv, dh]`` and one int32 length per layer (MLA:
    an ``MLACache`` with ``[L, B, S_max, kv_lora]`` and ``[L, B, S_max,
    dr]`` latents), or for
    the ssm family ``{"mamba": SSMState}`` with ``[L, B, ...]`` conv
    (``dtype``) and SSM (fp32) states.  ``kv_heads`` is the kv heads a
    grid rank holds (default all)."""
    if cfg.family == "ssm":
        return {"mamba": SSM.init_ssm_state(cfg, cfg.num_layers, batch, dtype,
                                            torch.device(device))}
    if cfg.family != "dense":
        raise NotImplementedError(f"dense caches for family {cfg.family!r} are not ported yet")
    if cfg.mla:
        return {"attn": ATT.init_mla_cache(cfg, batch, s_max, dtype, torch.device(device),
                                           cfg.num_layers)}
    return {"attn": ATT.init_kv_cache(cfg, batch, s_max, dtype, torch.device(device),
                                      cfg.num_layers, kv_heads)}


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a cache tree (dicts and NamedTuples)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def dense_cache_bytes(cfg: ModelConfig, batch: int, s_max: int, dtype) -> int:
    """Total bytes of the dense cache :func:`init_dense` builds (sized on
    the ``meta`` device, nothing allocated)."""
    return tree_bytes(init_dense(cfg, batch, s_max, dtype, "meta"))


NULL_BLOCK = 0           # reserved trash block backing unleased table entries


@dataclass(frozen=True)
class PoolConfig:
    """Shape of the paged pool: ``slots`` decode rows, ``block`` tokens per
    block, ``num_blocks`` including the null block, ``max_seq`` tokens per
    sequence (sizes the block table)."""
    slots: int
    block: int
    num_blocks: int
    max_seq: int

    def __post_init__(self):
        for name in ("slots", "block", "max_seq"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name}={getattr(self, name)} must be >= 1")
        if self.num_blocks < 2:
            raise ValueError(f"num_blocks={self.num_blocks}: need the null "
                             "block + >= 1 leasable block")

    @property
    def max_blocks_per_slot(self) -> int:
        return -(-self.max_seq // self.block)

    @property
    def leasable_blocks(self) -> int:
        return self.num_blocks - 1          # block 0 is never leased

    @property
    def dense_equiv_blocks(self) -> int:
        """Blocks a dense [slots, max_seq] arena would pin up front."""
        return self.slots * self.max_blocks_per_slot


def blocks_for(tokens: int, block: int) -> int:
    return max(1, -(-tokens // block))


class CachePool:
    """Host-side paged cache manager: device arenas + block accounting.

    The cache tree handed to the steps is assembled per call from the
    arenas and the CURRENT host block table and lengths (``decode_tree`` /
    ``prefill_tree``); the host copy of table and lengths is authoritative."""

    def __init__(self, cfg: ModelConfig, pool: PoolConfig, *, device,
                 dtype=torch.float32, quant_kv: bool = False):
        if cfg.family not in ("dense", "ssm"):
            raise NotImplementedError(f"paged pool for family {cfg.family!r} "
                                      "is not ported yet")
        self.cfg, self.pool = cfg, pool
        self.quant_kv = bool(quant_kv)
        self.device = torch.device(device)
        mb = pool.max_blocks_per_slot
        self.arenas: Dict[str, Any] = {}
        self.states: Dict[str, SSM.SSMState] = {}
        if cfg.family == "ssm":
            # per-slot rows [L, slots, ...]; the ssm family has no attention arena
            self.states["mamba"] = SSM.init_ssm_state(cfg, cfg.num_layers, pool.slots, dtype,
                                                      self.device)
        else:
            # int8 payload + fp32 row-scale arenas (DESIGN §11), or the
            # compute dtype's; the table and lengths are rebuilt per call
            if cfg.mla:
                mk = ATT.init_paged_mla_quant if self.quant_kv else ATT.init_paged_mla
            else:
                mk = ATT.init_paged_kv_quant if self.quant_kv else ATT.init_paged_kv
            paged = mk(cfg, pool.num_blocks, pool.block, pool.slots, mb, dtype, self.device,
                       cfg.num_layers)
            self._paged_type = type(paged)
            self.arenas["attn"] = tuple(getattr(paged, f)
                                        for f in ATT.LAYER_LEAVES[self._paged_type])
        # host accounting
        self.table = np.zeros((pool.slots, mb), np.int32)
        self.lengths = np.zeros(pool.slots, np.int32)
        self.active = np.zeros(pool.slots, bool)
        self.free: List[int] = list(range(1, pool.num_blocks))
        self.owned: List[List[int]] = [[] for _ in range(pool.slots)]
        self.peak_blocks_in_use = 0

    # -- accounting ------------------------------------------------------
    @property
    def blocks_in_use(self) -> int:
        return self.pool.leasable_blocks - len(self.free)

    @property
    def free_slots(self) -> List[int]:
        return [s for s in range(self.pool.slots) if not self.active[s]]

    def _lease(self, slot: int) -> bool:
        if not self.free:
            return False
        b = self.free.pop()
        self.owned[slot].append(b)
        self.table[slot, len(self.owned[slot]) - 1] = b
        self.peak_blocks_in_use = max(self.peak_blocks_in_use, self.blocks_in_use)
        return True

    def can_admit(self, prompt_len: int) -> bool:
        return (prompt_len <= self.pool.max_seq
                and bool(self.free_slots)
                and len(self.free) >= blocks_for(prompt_len, self.pool.block))

    def admit(self, prompt_len: int) -> Optional[int]:
        """Admission gate: lease prompt blocks into a free slot, or None."""
        if not self.can_admit(prompt_len):
            return None
        slot = self.free_slots[0]
        for _ in range(blocks_for(prompt_len, self.pool.block)):
            self._lease(slot)               # can_admit checked the free list
        self.active[slot] = True
        self.lengths[slot] = 0              # prefill commits the real length
        return slot

    def commit_prefill(self, slot: int, prompt_len: int) -> None:
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.lengths[slot] = prompt_len

    def ensure_append(self, slot: int) -> bool:
        """Lease the block holding position ``lengths[slot]`` if missing.

        False = out of blocks (caller runs the eviction protocol) or the
        slot hit ``max_seq``."""
        need = self.lengths[slot] // self.pool.block + 1
        if need > self.pool.max_blocks_per_slot:
            return False
        while len(self.owned[slot]) < need:
            if not self._lease(slot):
                return False
        return True

    def advance(self, slot: int) -> None:
        self.lengths[slot] += 1

    def free_slot(self, slot: int) -> None:
        self.free.extend(self.owned[slot])
        self.owned[slot] = []
        self.table[slot] = NULL_BLOCK
        self.lengths[slot] = 0
        self.active[slot] = False

    # -- device tree assembly -------------------------------------------
    def _paged(self, table_rows: np.ndarray, lengths_rows: np.ndarray):
        """The paged cache over the arenas (their per-layer leaves, in the
        constructor's order) with this table and these lengths."""
        return self._paged_type(*self.arenas["attn"],
                     torch.as_tensor(table_rows, dtype=torch.int64).to(self.device),
                     torch.as_tensor(lengths_rows, dtype=torch.int32).to(self.device))

    def decode_tree(self):
        """Cache tree for one decode tick over all ``slots`` rows (the SSM
        states themselves, which the tick updates in place)."""
        out: Dict[str, Any] = {}
        if "attn" in self.arenas:
            out["attn"] = self._paged(self.table, self.lengths)
        if "mamba" in self.states:
            out["mamba"] = self.states["mamba"]
        return out

    def prefill_tree(self, slot: int):
        """Cache tree for a single-slot prefill (batch 1, length 0): the
        slot's paged view, and fresh zero SSM state rows ``[L, 1, ...]``."""
        out: Dict[str, Any] = {}
        if "attn" in self.arenas:
            out["attn"] = self._paged(self.table[slot:slot + 1], np.zeros(1, np.int32))
        if "mamba" in self.states:
            out["mamba"] = SSM.SSMState(*(torch.zeros_like(a[:, :1])
                                          for a in self.states["mamba"]))
        return out

    def absorb_prefill(self, slot: int, new_tree) -> None:
        """Scatter a prefill's SSM state rows into ``slot`` (the attention
        arenas were written in place)."""
        if "mamba" in self.states:
            for full, one in zip(self.states["mamba"], new_tree["mamba"]):
                full[:, slot].copy_(one[:, 0])

    # -- reporting -------------------------------------------------------
    @property
    def block_bytes(self) -> int:
        """Bytes one leased block pins across all layers' paged arenas,
        scales included (0 for the ssm family, which has none)."""
        return sum(a[:, 0].numel() * a.element_size() for a in self.arenas.get("attn", ()))

    def paged_bytes_in_use(self) -> int:
        """Bytes of the blocks leased now."""
        return self.block_bytes * self.blocks_in_use

    def paged_bytes_peak(self) -> int:
        """Bytes leased at the pool's high-water mark."""
        return self.block_bytes * self.peak_blocks_in_use
