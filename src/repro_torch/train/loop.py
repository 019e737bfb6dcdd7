"""Training loop: a fold of ``train_step`` over a seekable data stream,
with checkpoints at step boundaries.

Counterpart of ``repro/train/loop.py`` with its checkpoint hooks (its
fault injector, step timer, guard and watchdog hooks come with the
training runtime): each step's loss is read on the host, which waits for
the step to finish, and kept in ``history`` with the step's wall time in
``step_s`` and its start on the host clock in ``step_t0``.  Every
``ckpt_every`` steps the loop hands ``{"params", "opt_state"}`` to
``ckpt.save_async(step + 1, ...)``: on an ``AsyncCheckpointManager`` that
only snapshots the state into host buffers, which must happen here,
because the next step updates parameters and moments in place.  Each
save's stall is kept in ``save_s`` as (step, seconds).  On normal exit the
loop drains the saves in flight (``wait_until_finished``), which also
raises a writer's error.
"""

from __future__ import annotations

import time
from typing import Callable, Dict


def train(train_step: Callable, state: Dict, data_iter, *, start_step: int = 0,
          num_steps: int = 100, ckpt=None, ckpt_every: int = 50, log_every: int = 10,
          log_fn: Callable = print) -> Dict:
    params, opt_state = state["params"], state["opt_state"]
    history = state.setdefault("history", [])
    step_s = state.setdefault("step_s", [])
    step_t0 = state.setdefault("step_t0", [])
    save_s = state.setdefault("save_s", [])
    for step in range(start_step, num_steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])                 # waits for the step
        dt = time.perf_counter() - t0
        history.append((step, loss))
        step_s.append(dt)
        step_t0.append(t0)
        if step % log_every == 0 or step == num_steps - 1:
            log_fn(f"step {step:5d} loss {loss:.4f} "
                   f"gnorm {float(metrics.get('grad_norm', 0)):.3f} "
                   f"{dt*1e3:.0f}ms")
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            t1 = time.perf_counter()
            ckpt.save_async(step + 1, {"params": params, "opt_state": opt_state})
            save_s.append((step + 1, time.perf_counter() - t1))
    if ckpt is not None:
        ckpt.wait_until_finished()
    state.update(params=params, opt_state=opt_state)
    return state
