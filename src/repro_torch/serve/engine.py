"""Continuous-batching decode engine over the paged cache pool
(docs/DESIGN.md §10).

Counterpart of ``repro/serve/engine.py``, with the same protocol: each tick
it admits queued requests whose arrival has passed while the pool's gate
lets their prompt blocks in (one single-sequence prefill per admission,
then the first token is sampled), runs one decode step over ALL slots
(inactive slots carry token 0 at length 0 and write the null block), and
finishes sequences on EOS or their token budget.  Running out of blocks
mid-decode preempts the youngest sequence and requeues it from its prompt;
greedy decode makes the replay token-identical, and sampling draws from a
``torch.Generator`` seeded from (seed, request id, step), which restores
the same draws on replay.  Attention prompts are right-padded to a block
multiple; ssm prompts run at their exact length, because padding a
recurrence would corrupt the carried conv and SSD states.  Times are host
clocks around work that ends in ``torch.cuda.synchronize()`` (where JAX
uses ``block_until_ready``).  ``quant_kv`` keeps the attention arenas
as int8 payloads with fp32 row scales (``CachePool(quant_kv=True)``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.serve import step as SRV
from repro_torch.serve.cache import CachePool, PoolConfig, blocks_for


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [plen] int32 token ids
    max_new: int                # generation budget (includes the EOS token)
    arrival: int = 0            # tick at which the request becomes visible


@dataclass
class Finished:
    rid: int
    prompt_len: int
    tokens: List[int]           # generated ids (EOS included when hit)
    reason: str                 # "eos" | "max_new"
    preemptions: int = 0


@dataclass
class _Running:
    req: Request
    slot: int
    admit_seq: int              # monotone admission counter (eviction order)
    pending: int                # next input token id
    generated: List[int] = field(default_factory=list)


def draw_seed(seed: int, rid: int, step: int) -> int:
    """Generator seed of request ``rid``'s ``step``-th draw."""
    return ((seed * 1_000_003 + rid) * 1_000_003 + step) % (1 << 63)


class DecodeEngine:
    def __init__(self, cfg: ModelConfig, params, pool: PoolConfig, *,
                 device="cuda", compute_dtype=torch.float32,
                 eos_id: Optional[int] = None, method: str = "greedy",
                 temperature: float = 1.0, top_p: float = 0.9, seed: int = 0,
                 quant_kv: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.pool = CachePool(cfg, pool, device=self.device, dtype=compute_dtype,
                              quant_kv=quant_kv)
        self.eos_id = eos_id
        self.method, self.temperature, self.top_p = method, temperature, top_p
        self.seed = seed
        self.exact_prefill = cfg.family in ("ssm", "hybrid")
        self._prefill = SRV.build_prefill_paged(cfg, compute_dtype=compute_dtype)
        self._decode = SRV.build_decode_step(cfg, compute_dtype=compute_dtype)
        self.queue: deque = deque()
        self.running: Dict[int, _Running] = {}      # slot -> state
        self.finished: Dict[int, Finished] = {}
        self.tick = 0
        self._admit_seq = 0
        self._preempt_counts: Dict[int, int] = {}
        self.stats = {"prefill_s": [], "decode_ticks": 0, "decode_tokens": 0,
                      "decode_s": 0.0, "preemptions": 0}

    # -- submission ------------------------------------------------------
    def submit(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new
        if total > self.pool.pool.max_seq:
            raise ValueError(f"request {req.rid}: prompt+max_new={total} "
                             f"exceeds max_seq={self.pool.pool.max_seq}")
        if blocks_for(total, self.pool.pool.block) > self.pool.pool.leasable_blocks:
            raise ValueError(f"request {req.rid}: needs more blocks than the "
                             "pool owns — it could never finish")
        self.queue.append(req)

    def warmup(self, prompt_lens=(1,)) -> None:
        """Run each prefill width and one decode tick before timing starts
        (first-call costs: kernel builds, allocator growth).  Leases and
        frees a slot per width; reads stay masked by committed lengths."""
        with torch.inference_mode():
            for plen_i in sorted(set(int(p) for p in prompt_lens)):
                slot = self.pool.admit(plen_i)
                if slot is None:
                    raise RuntimeError("warmup needs an idle pool")
                tokens, plen = self._pad_prompt(np.zeros(plen_i, np.int32))
                self._prefill(self.params, self.pool.prefill_tree(slot), tokens, plen)
                self.pool.free_slot(slot)
            S = self.pool.pool.slots
            zeros = torch.zeros((S, 1), dtype=torch.int64, device=self.device)
            self._decode(self.params, self.pool.decode_tree(), zeros, zeros)
        self._sync()
        self.pool.peak_blocks_in_use = 0            # warmup doesn't count

    # -- internals -------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pad_prompt(self, prompt: np.ndarray):
        """Right-pad to the next block multiple (one prefill width per
        block count), or not at all for an exact-length family."""
        plen = len(prompt)
        bs = self.pool.pool.block
        buf = np.zeros(plen if self.exact_prefill else blocks_for(plen, bs) * bs, np.int64)
        buf[:plen] = prompt
        return torch.from_numpy(buf)[None, :].to(self.device), plen

    def _sample(self, logits: torch.Tensor, rids: List[int], steps: List[int]) -> List[int]:
        """One token per row of ``logits`` [n, V]."""
        if self.method == "greedy":
            return SRV.sample(logits, method="greedy").tolist()
        out = []
        for row, rid, step in zip(logits, rids, steps):
            g = torch.Generator(device=logits.device)
            g.manual_seed(draw_seed(self.seed, rid, step))
            out.append(int(SRV.sample(row, method=self.method, generator=g,
                                      temperature=self.temperature,
                                      top_p=self.top_p)))
        return out

    def _finish(self, slot: int, reason: str) -> None:
        st = self.running.pop(slot)
        self.pool.free_slot(slot)
        self.finished[st.req.rid] = Finished(
            st.req.rid, len(st.req.prompt), list(st.generated), reason,
            self._preempt_counts.get(st.req.rid, 0))

    def _record_token(self, st: _Running, tok: int) -> bool:
        """Append a sampled token; True if the sequence is done."""
        st.generated.append(tok)
        if self.eos_id is not None and tok == self.eos_id:
            self._finish(st.slot, "eos")
            return True
        if len(st.generated) >= st.req.max_new:
            self._finish(st.slot, "max_new")
            return True
        st.pending = tok
        return False

    def _admit_ready(self) -> None:
        while self.queue and self.queue[0].arrival <= self.tick:
            req = self.queue[0]
            slot = self.pool.admit(len(req.prompt))
            if slot is None:
                return
            self.queue.popleft()
            t0 = time.perf_counter()
            tokens, plen = self._pad_prompt(np.asarray(req.prompt, np.int32))
            last, tree = self._prefill(self.params, self.pool.prefill_tree(slot),
                                       tokens, plen)
            self._sync()
            self.stats["prefill_s"].append(time.perf_counter() - t0)
            self.pool.absorb_prefill(slot, tree)
            self.pool.commit_prefill(slot, len(req.prompt))
            st = _Running(req, slot, self._admit_seq, pending=-1)
            self._admit_seq += 1
            self.running[slot] = st
            self._record_token(st, self._sample(last[:, 0], [req.rid], [0])[0])

    def _evict_youngest(self) -> None:
        slot = max(self.running, key=lambda s: self.running[s].admit_seq)
        st = self.running.pop(slot)
        self.pool.free_slot(slot)
        st.req.arrival = self.tick          # requeue: restart from the prompt
        self.queue.appendleft(st.req)
        self.stats["preemptions"] += 1
        self._preempt_counts[st.req.rid] = self._preempt_counts.get(st.req.rid, 0) + 1

    def _ensure_appends(self) -> None:
        for slot in sorted(self.running, key=lambda s: self.running[s].admit_seq):
            while slot in self.running and not self.pool.ensure_append(slot):
                if len(self.running) == 1:
                    raise RuntimeError("pool exhausted with one sequence "
                                       "running — submit() sizing bug")
                self._evict_youngest()

    def _decode_tick(self) -> None:
        self._ensure_appends()
        if not self.running:
            return
        S = self.pool.pool.slots
        tokens = np.zeros((S, 1), np.int64)
        for slot, st in self.running.items():
            tokens[slot, 0] = st.pending
        positions = self.pool.lengths.astype(np.int64)[:, None]
        t0 = time.perf_counter()
        logits, _ = self._decode(self.params, self.pool.decode_tree(),
                                 torch.from_numpy(tokens).to(self.device),
                                 torch.from_numpy(positions).to(self.device))
        self._sync()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_ticks"] += 1
        slots = list(self.running)
        sts = [self.running[s] for s in slots]
        toks = self._sample(logits[slots, 0], [st.req.rid for st in sts],
                            [len(st.generated) for st in sts])
        for slot, st, tok in zip(slots, sts, toks):
            self.pool.advance(slot)
            self.stats["decode_tokens"] += 1
            self._record_token(st, tok)

    # -- driving ---------------------------------------------------------
    def step(self) -> None:
        """One engine tick: admit what fits, then decode every slot once."""
        with torch.inference_mode():
            self._admit_ready()
            self._decode_tick()
        self.tick += 1

    def run(self, requests: List[Request]) -> Dict[int, Finished]:
        """Drive a whole arrival trace to completion."""
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            self.submit(r)
        while self.queue or self.running:
            self.step()
        return self.finished
