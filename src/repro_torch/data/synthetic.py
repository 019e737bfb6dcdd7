"""Deterministic synthetic LM data.

Counterpart of ``repro/data/synthetic.py``.  ``SyntheticLM.batch_at`` is
a numpy copy of the JAX package's, so both packages train on
bit-identical batches.  ``Prefetcher`` builds the next batches on a
background thread (numpy, then pinned host tensors) and copies each to
the device without blocking when it is taken, so host data generation
overlaps device compute (the paper's on/off-package overlap, §III-B).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


class SyntheticLM:
    """Deterministic, seekable synthetic token stream.

    Tokens follow t[i+1] = (a * t[i] + noise) % vocab with a few "motifs" so
    next-token prediction is learnable but not trivial.
    """

    def __init__(self, vocab: int, seq_len: int, global_batch: int, *, seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step): resuming at step k regenerates the
        identical batch.  The JAX package's single-host stream (host 0)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, 0]))
        B, S, V = self.global_batch, self.seq_len, self.vocab
        base = rng.integers(0, V, size=(B, 1), dtype=np.int64)
        mult = 1 + (rng.integers(1, 7, size=(B, 1), dtype=np.int64) * 2)
        idx = np.arange(S + 1, dtype=np.int64)[None, :]
        toks = (base + mult * idx) % V
        # inject motif repeats (content-based predictability)
        motif_len = min(8, S // 4) or 1
        motif = rng.integers(0, V, size=(B, motif_len), dtype=np.int64)
        pos = rng.integers(0, max(1, S - 2 * motif_len), size=(B,))
        for b in range(B):
            toks[b, pos[b]:pos[b] + motif_len] = motif[b]
            toks[b, pos[b] + motif_len:pos[b] + 2 * motif_len] = motif[b]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with a bounded queue: the worker makes
    host tensors (pinned when the device is a card); ``__next__`` copies
    them to ``device`` without blocking the host."""

    def __init__(self, it: Iterator, device="cpu", depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.device = torch.device(device)
        self._stop = threading.Event()
        pin = self.device.type == "cuda"

        def work():
            for batch in it:
                if self._stop.is_set():
                    return
                host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
                if pin:
                    host = {k: v.pin_memory() for k, v in host.items()}
                self.q.put(host)

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return {k: v.to(self.device, non_blocking=True) for k, v in self.q.get().items()}

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
