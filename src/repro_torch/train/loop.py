"""Training loop: a fold of ``train_step`` over a seekable data stream.

Counterpart of ``repro/train/loop.py`` without its checkpoint, fault and
guard hooks (a later slice ports those): each step's loss is read on the
host, which waits for the step to finish, and kept in ``history`` with
the step's wall time in ``step_s``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict


def train(train_step: Callable, state: Dict, data_iter, *, start_step: int = 0,
          num_steps: int = 100, log_every: int = 10, log_fn: Callable = print) -> Dict:
    params, opt_state = state["params"], state["opt_state"]
    history = state.setdefault("history", [])
    step_s = state.setdefault("step_s", [])
    for step in range(start_step, num_steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])                 # waits for the step
        dt = time.perf_counter() - t0
        history.append((step, loss))
        step_s.append(dt)
        if step % log_every == 0 or step == num_steps - 1:
            log_fn(f"step {step:5d} loss {loss:.4f} "
                   f"gnorm {float(metrics.get('grad_norm', 0)):.3f} "
                   f"{dt*1e3:.0f}ms")
    state.update(params=params, opt_state=opt_state)
    return state
