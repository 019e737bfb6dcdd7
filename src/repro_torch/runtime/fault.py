"""Fault injection, straggler detection and the supervised restart loop.

Counterpart of ``repro/runtime/fault.py``, plain Python:

* :class:`FailureInjector` fails deterministically: a whole incarnation
  at the top of a step (:meth:`~FailureInjector.check`), one logical
  checkpoint writer inside the torn window (``check_writer``, the
  manager's ``writer_fault`` hook), or one writer PROCESS of the fleet
  (``proc_fault``, the manager's ``proc_fault`` hook; kinds
  :attr:`~FailureInjector.PROC_KINDS`, run in the child by
  ``runtime/procs.inject_fault``).
* :class:`StepTimer` keeps an EWMA of step seconds (the first
  ``warmup_steps`` samples discarded, frozen while steps are slow) and
  reports a straggler after ``patience`` slow steps in a row.
* :func:`run_supervised` rebuilds the state from the newest published
  checkpoint and reruns after any ``Exception``: it fences the writers
  (``ckpt.abort()``), on a :class:`~repro_torch.runtime.guard.DivergenceError`
  with ``rollback`` retires the checkpoints newer than the first
  poisoned step and publishes the poisoned data indices, pins the resume
  step once after that, and backs off exponentially up to a cap.
* :func:`rebalance_data_shards` moves a data shard from each straggler
  to the least-loaded healthy host.  After an elastic restart (another
  data width) ``core/schedule.choose_microbatches`` is the rule that
  re-plans the microbatches so the global batch stays the same.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.runtime.guard import DivergenceError, publish_blocklist


class FailureInjector:
    """Deterministic failures at given steps.

    ``fail_at`` maps step -> kind (the whole incarnation dies at the top
    of that step); ``writer_fail_at`` maps step -> writer (that writer of
    the step's save dies between its shard writes and its partial
    manifest); ``proc_fail_at`` maps step -> (writer, kind[, extra
    fields]) for a writer process of the fleet: ``kill9``, ``sigstop``
    (hangs until its lease fences it), ``slow`` (sleeps with heartbeats
    flowing: must not be killed) and ``corrupt`` (truncates a shard after
    checksumming it).  Each fires once."""

    PROC_KINDS = ("kill9", "sigstop", "slow", "corrupt")

    def __init__(self, fail_at: Optional[Dict[int, str]] = None,
                 writer_fail_at: Optional[Dict[int, int]] = None,
                 proc_fail_at: Optional[Dict[int, tuple]] = None):
        self.fail_at = dict(fail_at or {})
        self.writer_fail_at = dict(writer_fail_at or {})
        self.proc_fail_at = dict(proc_fail_at or {})
        for spec in self.proc_fail_at.values():
            assert spec[1] in self.PROC_KINDS, (
                f"proc fault kind {spec[1]!r} not in {self.PROC_KINDS}")
        self.log: List[str] = []

    def check(self, step: int):
        if step in self.fail_at:
            kind = self.fail_at.pop(step)
            self.log.append(f"step {step}: injected {kind}")
            raise RuntimeError(f"injected failure: {kind} at step {step}")

    def check_writer(self, step: int, writer: int):
        """The ``writer_fault`` hook: raises inside writer ``writer`` of the
        save of ``step``, after its shards and before its partial manifest."""
        if self.writer_fail_at.get(step) == writer:
            del self.writer_fail_at[step]
            self.log.append(f"step {step}: injected writer {writer} death")
            raise RuntimeError(
                f"injected failure: checkpoint writer {writer} died at step {step} "
                f"(post shard-write, pre manifest-publish)")

    def proc_fault(self, step: int, writer: int) -> Optional[Dict]:
        """The ``proc_fault`` hook: the fault spec the fleet ships to writer
        ``writer``'s process during the save of ``step``, or None."""
        spec = self.proc_fail_at.get(step)
        if spec is None or spec[0] != writer:
            return None
        del self.proc_fail_at[step]
        kind = spec[1]
        extra = dict(spec[2]) if len(spec) > 2 else {}
        self.log.append(f"step {step}: injected proc fault {kind} into writer {writer}")
        return {"kind": kind, **extra}


@dataclass
class StepTimer:
    """EWMA of step seconds with straggler detection.  The first
    ``warmup_steps`` samples are discarded (a first step that builds and
    warms up would poison the baseline); a slow step is not folded."""
    alpha: float = 0.1
    straggler_factor: float = 2.5
    patience: int = 3
    warmup_steps: int = 1
    ewma: Optional[float] = None
    slow_streak: int = 0
    _seen: int = 0
    events: List[str] = field(default_factory=list)

    def record(self, dt: float) -> bool:
        """True when a sustained straggler is detected."""
        if self._seen < self.warmup_steps:
            self._seen += 1
            return False
        if self.ewma is None:
            self.ewma = dt
            return False
        is_slow = dt > self.straggler_factor * self.ewma
        self.slow_streak = self.slow_streak + 1 if is_slow else 0
        if not is_slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        if self.slow_streak >= self.patience:
            self.events.append(f"straggler: {dt:.3f}s vs ewma {self.ewma:.3f}s "
                               f"x{self.slow_streak}")
            self.slow_streak = 0
            return True
        return False


@dataclass
class Incarnation:
    """One supervised attempt; killed and replaced on failure."""
    index: int
    start_step: int


NON_RETRYABLE = (KeyboardInterrupt, AssertionError)


def run_supervised(make_state: Callable[[Optional[int]], tuple], run_steps: Callable, *,
                   max_restarts: int = 5,
                   on_restart: Optional[Callable[[Incarnation], None]] = None,
                   ckpt=None, backoff_base: float = 0.5, backoff_cap: float = 30.0,
                   sleep_fn: Callable[[float], None] = time.sleep):
    """(Re)build the state and run until ``run_steps`` returns.

    ``make_state(step or None) -> (state, start_step)`` restores or starts
    cold; ``run_steps(state, start_step, incarnation) -> final_state``.
    Returns (final state, incarnations used).  Any ``Exception`` is an
    incarnation death; ``KeyboardInterrupt`` and ``AssertionError``
    (:data:`NON_RETRYABLE`) propagate.  After a death, in this order:
    ``ckpt.abort()`` fences the writer group; a :class:`DivergenceError`
    with ``rollback`` retires the published steps after its first
    poisoned step (``ckpt.retire_steps_after``) and publishes its data
    indices to ``ckpt.dir``'s blocklist; ``ckpt.latest_step()`` is read
    once and passed to the next ``make_state``; then the supervisor
    sleeps ``min(backoff_cap, backoff_base * 2**k)`` through ``sleep_fn``
    (k: earlier failures).  The hooks are looked up on ``ckpt`` by name,
    so a manager without a directory still supervises."""
    restarts = 0
    resume_step = None
    while True:
        state, start = make_state(resume_step)
        inc = Incarnation(index=restarts, start_step=start)
        if on_restart and restarts:
            on_restart(inc)
        try:
            return run_steps(state, start, inc), restarts + 1
        except BaseException as e:
            if isinstance(e, NON_RETRYABLE) or not isinstance(e, Exception):
                raise
            restarts += 1
            if ckpt is not None:
                ckpt.abort()
                if isinstance(e, DivergenceError) and getattr(e, "rollback", False):
                    # fence first, then retire: an in-flight save of a
                    # poisoned step must not land after the rollback
                    retire = getattr(ckpt, "retire_steps_after", None)
                    if retire is not None:
                        retire(e.first_step)
                    d = getattr(ckpt, "dir", None)
                    if d:
                        publish_blocklist(d, e.data_indices)
                latest = getattr(ckpt, "latest_step", None)
                resume_step = latest() if callable(latest) else None
            if restarts > max_restarts:
                raise RuntimeError(f"exceeded {max_restarts} restarts; last error: {e}")
            sleep_fn(min(backoff_cap, backoff_base * 2 ** (restarts - 1)))


def rebalance_data_shards(num_hosts: int, slow_hosts: List[int],
                          shards_per_host: Optional[List[int]] = None) -> List[int]:
    """Move one data shard from each straggler to the least-loaded healthy
    host; returns a new assignment (never the input list)."""
    shards = list(shards_per_host or [1] * num_hosts)
    for s in slow_hosts:
        if shards[s] <= 0:
            continue
        healthy = [h for h in range(num_hosts) if h not in slow_hosts]
        if not healthy:
            break
        tgt = min(healthy, key=lambda h: shards[h])
        shards[s] -= 1
        shards[tgt] += 1
    return shards
