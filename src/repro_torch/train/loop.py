"""Training loop: a fold of ``train_step`` over a seekable data stream,
with checkpoints at step boundaries and the runtime's hooks.

Counterpart of ``repro/train/loop.py``: each step's loss is read on the
host, which waits for the step to finish, and kept in ``history`` with
the step's wall time in ``step_s`` and its start on the host clock in
``step_t0``.  Every ``ckpt_every`` steps the loop hands ``{"params",
"opt_state"}`` to ``ckpt.save_async(step + 1, ...)``: on an
``AsyncCheckpointManager`` that only snapshots the state into host
buffers, which must happen here, because the next step updates
parameters and moments in place.  Each save's stall is kept in
``save_s`` as (step, seconds).  On normal exit the loop drains the saves
in flight (``wait_until_finished``), which also raises a writer's error.

The runtime's hooks (``runtime/``): ``injector`` fails steps at their
top and is wired as the manager's ``writer_fault`` (and, for writer
processes, ``proc_fault``) hook; ``timer`` records each step's seconds
and calls ``on_straggler(step, timer)`` on a sustained straggler;
``watchdog`` is armed before each step and disarmed and checked once its
loss is on the host (a hung step raises ``HangError``); ``guard`` (a
``TrainingGuard``) observes each step's loss and metrics before the
boundary save, so a ``DivergenceError`` never lets poisoned state
publish; ``data_index_fn`` maps a loop step to the data index it
consumed (under a blocklist), which the guard reports.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional


def train(train_step: Callable, state: Dict, data_iter, *, start_step: int = 0,
          num_steps: int = 100, ckpt=None, ckpt_every: int = 50, log_every: int = 10,
          injector=None, timer=None, on_straggler: Optional[Callable] = None, guard=None,
          watchdog=None, data_index_fn: Optional[Callable[[int], int]] = None,
          log_fn: Callable = print) -> Dict:
    params, opt_state = state["params"], state["opt_state"]
    history = state.setdefault("history", [])
    step_s = state.setdefault("step_s", [])
    step_t0 = state.setdefault("step_t0", [])
    save_s = state.setdefault("save_s", [])
    if (ckpt is not None and injector is not None and hasattr(injector, "check_writer")
            and getattr(ckpt, "writer_fault", None) is None):
        ckpt.writer_fault = injector.check_writer
    if (ckpt is not None and injector is not None and hasattr(injector, "proc_fault")
            and getattr(ckpt, "writer_procs", False)
            and getattr(ckpt, "proc_fault", None) is None):
        ckpt.proc_fault = injector.proc_fault
    for step in range(start_step, num_steps):
        batch = next(data_iter)
        if injector is not None:
            injector.check(step)
        if watchdog is not None:
            watchdog.arm(step)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])                 # waits for the step
        dt = time.perf_counter() - t0
        if watchdog is not None:
            watchdog.disarm()
            watchdog.check()                          # raises HangError if tripped
        if timer is not None and timer.record(dt) and on_straggler:
            on_straggler(step, timer)
        history.append((step, loss))
        step_s.append(dt)
        step_t0.append(t0)
        if step % log_every == 0 or step == num_steps - 1:
            log_fn(f"step {step:5d} loss {loss:.4f} "
                   f"gnorm {float(metrics.get('grad_norm', 0)):.3f} "
                   f"{dt*1e3:.0f}ms")
        if guard is not None:
            # before the boundary save: poisoned state must not publish
            guard.observe(step, loss, metrics,
                          data_index=data_index_fn(step) if data_index_fn else step)
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            t1 = time.perf_counter()
            ckpt.save_async(step + 1, {"params": params, "opt_state": opt_state})
            save_s.append((step + 1, time.perf_counter() - t1))
    if ckpt is not None:
        ckpt.wait_until_finished()
    state.update(params=params, opt_state=opt_state)
    return state
