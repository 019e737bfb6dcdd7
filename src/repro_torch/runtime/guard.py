"""Loss-spike and skip-streak guard, hang watchdog, data blocklist.

Counterpart of ``repro/runtime/guard.py`` (docs/DESIGN.md §8), plain
Python.  Three escalating defenses:

1. **In-graph skip guard** (``optim/adamw.update(guard=...)``, wired by
   ``train/step.build_train_step(guard=...)``): a step whose gradients
   are not finite, or whose norm spikes against the EWMA of accepted
   norms, leaves parameters and moments bit-unchanged and reports
   ``update_skipped``.
2. **Loss-spike rollback** (:class:`TrainingGuard`): the loop feeds every
   step's loss (read on the host) and ``update_skipped``; ``patience``
   spiking losses in a row, or ``skip_cap`` skipped updates in a row,
   raise :class:`DivergenceError` with the poisoned window.
   ``runtime/fault.run_supervised`` then fences the writers, retires the
   checkpoints newer than the first poisoned step and publishes the
   poisoned data indices to ``blocklist.json``; the restarted run's
   stream (:func:`blocklisted_stream`) skips them, so it is bit-identical
   to a clean run that never saw them.
3. **Hang watchdog** (:class:`Watchdog`): armed before each step and
   disarmed once its loss is on the host; a step longer than
   ``hang_timeout`` raises :class:`HangError` at :meth:`Watchdog.check`,
   and ``on_hang`` fires during the hang.

Blocklisted values are data indices (``batch_at`` arguments), not loop
steps: loop step ``s`` of a blocklist-aware run consumes
:func:`data_index` ``(s, blocklist)``, the s-th index not blocklisted.
The sidecar is published atomically (tmp + ``os.replace``) and merges
with what is on disk; a missing or torn file reads as empty.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

BLOCKLIST = "blocklist.json"


class DivergenceError(RuntimeError):
    """Training diverged: a sustained loss spike or too many skipped
    updates in a row.  ``first_step`` is the first poisoned loop step
    (checkpoints newer than it are retired), ``data_indices`` the
    poisoned ``batch_at`` indices, ``rollback`` the policy bit."""

    def __init__(self, msg: str, *, kind: str, first_step: int,
                 data_indices: Sequence[int], rollback: bool = True):
        super().__init__(msg)
        self.kind = kind                          # "loss_spike" | "skip_cap"
        self.first_step = first_step
        self.data_indices = tuple(data_indices)
        self.rollback = rollback


class HangError(RuntimeError):
    """A step outlived the watchdog's ``hang_timeout``; retryable like any
    other incarnation death."""

    def __init__(self, step: int, elapsed: float, timeout: float):
        super().__init__(f"step {step} hung: {elapsed:.3f}s exceeds hang_timeout="
                         f"{timeout:.3f}s")
        self.step = step
        self.elapsed = elapsed
        self.timeout = timeout


class TrainingGuard:
    """Watches each step's loss and ``update_skipped`` and raises
    :class:`DivergenceError` on sustained divergence.  A spiking loss is
    not folded into the EWMA (a sustained spike must not become the
    baseline); a non-finite loss counts as a spike; a skipped step's loss
    touches neither the EWMA nor the spike streak."""

    def __init__(self, gcfg):
        self.gcfg = gcfg
        self.loss_ewma: Optional[float] = None
        self.spike_streak = 0
        self.skip_streak = 0
        self._spike_window: List[tuple] = []      # (loop step, data index)
        self._skip_window: List[tuple] = []
        self.events: List[str] = []

    def observe(self, step: int, loss: float, metrics=None,
                data_index: Optional[int] = None):
        """Feed one finished step; raises when the spike streak reaches
        ``patience`` or the skip streak ``skip_cap``."""
        g = self.gcfg
        di = step if data_index is None else data_index
        skipped = bool(metrics is not None
                       and float(metrics.get("update_skipped", 0.0)) >= 0.5)
        if skipped:
            self.skip_streak += 1
            self._skip_window.append((step, di))
            if self.skip_streak >= g.skip_cap:
                self._raise("skip_cap", self._skip_window,
                            f"{self.skip_streak} consecutive updates skipped in-graph "
                            f"(skip_cap={g.skip_cap})")
            return
        self.skip_streak = 0
        self._skip_window.clear()

        finite = loss == loss and abs(loss) != float("inf")
        if self.loss_ewma is None:
            if finite:
                self.loss_ewma = loss             # the first healthy loss seeds
            return
        spiking = (not finite) or loss > g.loss_spike_factor * self.loss_ewma
        if spiking:
            self.spike_streak += 1
            self._spike_window.append((step, di))
            if self.spike_streak >= g.patience:
                self._raise("loss_spike", self._spike_window,
                            f"loss {loss:.4f} spiked >{g.loss_spike_factor}x ewma "
                            f"{self.loss_ewma:.4f} for {self.spike_streak} consecutive "
                            f"steps (patience={g.patience})")
            return                                # the EWMA stays frozen
        self.spike_streak = 0
        self._spike_window.clear()
        a = g.loss_ewma_alpha
        self.loss_ewma = (1 - a) * self.loss_ewma + a * loss

    def _raise(self, kind: str, window: List[tuple], why: str):
        first_step = window[0][0]
        indices = [di for _, di in window]
        self.events.append(f"{kind} at step {first_step}: {why}")
        raise DivergenceError(
            f"divergence ({kind}) first poisoned step {first_step}, data indices "
            f"{indices}: {why}",
            kind=kind, first_step=first_step, data_indices=indices,
            rollback=self.gcfg.rollback)


class Watchdog:
    """Per-step hang detector.  The loop calls :meth:`arm` before a step
    and :meth:`disarm` + :meth:`check` once its loss is on the host.  A
    daemon thread wakes every ``poll`` seconds; an armed step older than
    ``timeout`` is recorded and ``on_hang(step, elapsed)`` fires.  The
    thread only records and calls ``on_hang``: it touches no device, so
    it runs while the training thread blocks in a device wait.
    :meth:`check` raises the recorded :class:`HangError` and clears it,
    so one watchdog serves a whole supervised run."""

    def __init__(self, timeout: float, *,
                 on_hang: Optional[Callable[[int, float], None]] = None,
                 poll: float = 0.02, clock: Callable[[], float] = time.monotonic):
        assert timeout > 0.0, f"hang_timeout={timeout} must be > 0"
        self.timeout = timeout
        self.on_hang = on_hang
        self.poll = poll
        self.clock = clock
        self._lock = threading.Lock()
        self._armed_step: Optional[int] = None
        self._armed_at = 0.0
        self._trip: Optional[HangError] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, name="watchdog", daemon=True)
        self._thread.start()

    def arm(self, step: int):
        with self._lock:
            self._armed_step = step
            self._armed_at = self.clock()

    def disarm(self):
        with self._lock:
            self._armed_step = None

    def check(self):
        """Raise (and clear) a pending :class:`HangError`."""
        with self._lock:
            trip, self._trip = self._trip, None
        if trip is not None:
            raise trip

    @property
    def tripped(self) -> bool:
        with self._lock:
            return self._trip is not None

    def _watch(self):
        while not self._stop.wait(self.poll):
            fire = None
            with self._lock:
                if self._armed_step is not None and self._trip is None:
                    elapsed = self.clock() - self._armed_at
                    if elapsed > self.timeout:
                        self._trip = HangError(self._armed_step, elapsed, self.timeout)
                        fire = (self._armed_step, elapsed)
                        self._armed_step = None   # one trip per arm
            if fire is not None and self.on_hang is not None:
                self.on_hang(*fire)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


def blocklist_path(directory: str) -> str:
    return os.path.join(directory, BLOCKLIST)


def load_blocklist(directory: Optional[str]) -> List[int]:
    """The sorted poisoned data indices, or [] (no directory, no file or a
    torn file all mean nothing is blocklisted)."""
    if not directory:
        return []
    try:
        with open(blocklist_path(directory)) as f:
            return sorted({int(i) for i in json.load(f)["data_indices"]})
    except (OSError, ValueError, KeyError, TypeError):
        return []


def publish_blocklist(directory: str, data_indices: Iterable[int]) -> List[int]:
    """Merge ``data_indices`` into the sidecar and publish it atomically
    (tmp + ``os.replace``); returns the merged sorted list."""
    merged = sorted(set(load_blocklist(directory)) | {int(i) for i in data_indices})
    os.makedirs(directory, exist_ok=True)
    tmp = blocklist_path(directory) + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"data_indices": merged}, f, sort_keys=True)
    os.replace(tmp, blocklist_path(directory))
    return merged


def data_index(step: int, blocklist: Sequence[int]) -> int:
    """Loop step -> data index under a blocklist: step ``s`` consumes the
    s-th index not blocklisted (the identity for an empty blocklist)."""
    idx = step
    for b in sorted(set(blocklist)):
        if b <= idx:
            idx += 1
    return idx


def blocklisted_stream(batch_at: Callable[[int], dict], start_step: int,
                       blocklist: Sequence[int]) -> Iterator[dict]:
    """Yields ``batch_at(data_index(s, blocklist))`` for ``s = start_step, ...``."""
    bl = sorted(set(blocklist))
    s = start_step
    while True:
        yield batch_at(data_index(s, bl))
        s += 1
