"""Checkpoints of the hecaton grid's training state, as global leaves.

The JAX package saves global arrays and restores them onto any mesh
through ``shardings``.  On the port's grid each rank holds blocks of the
parameters (``parallel/specs.py``) and ZeRO-1 parts of its blocks for the
AdamW moments (``train/step._leaf_info`` / ``_part``), so:

* **save**: every rank takes part in making each global leaf, one leaf at
  a time (a parameter all-gathered over the axes of its spec; a moment
  first over ``data``, its ZeRO-1 split, then the same way), and rank 0,
  the coordinator, snapshots it to the host and writes through its
  manager.  The leaves reach the manager as callables, so no rank holds a
  second copy of the whole state on the card;
* **restore**: rank 0 names the step (its newest complete one) and every
  rank reads that step, keeping its block (``specs.local_slice``) and of a
  moment its ZeRO-1 part, on its card.

A checkpoint written on one card restores on the grid and the other way
round: the leaves and their names are the single-device ones.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.checkpoint import manager as M
from repro_torch.launch.mesh import Grid
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamState
from repro_torch.parallel import comm, specs
from repro_torch.train import step as TS


def _layouts(params, grid: Grid, pcfg) -> Dict[Tuple[str, ...], Tuple]:
    """{param path: (spec, ZeRO-1 data dim or None)} for this rank's blocks."""
    info = TS._leaf_info(params, grid, pcfg)
    return {path: (spec, ddim) for (path, _), (spec, _, ddim) in zip(lm.flatten(params), info)}


def _map(tree, fn):
    items = lm.flatten(tree)
    return lm.unflatten([p for p, _ in items], [fn(p, t) for p, t in items])


def global_leaves(state: Dict, grid: Grid, pcfg) -> Dict:
    """``{"params", "opt_state"}`` with each sharded leaf replaced by a
    callable that all-gathers its global array (every rank must call them,
    in the manager's leaf order)."""
    params, opt = state["params"], state["opt_state"]
    lay = _layouts(params, grid, pcfg)

    def param(path, t):
        return lambda: specs.gather_full(t.detach(), lay[path][0])

    def moment(path, t):
        spec, ddim = lay[path]

        def gather():
            block = t if ddim is None else comm.raw_all_gather(t.contiguous(), "data", ddim)
            return specs.gather_full(block, spec)
        return gather

    return {"params": _map(params, param),
            "opt_state": AdamState(opt.step, _map(opt.mu, moment), _map(opt.nu, moment),
                                   opt.gnorm_ewma)}


def placements(state: Dict, grid: Grid, pcfg) -> Dict:
    """The restore placements of a rank's state: each global parameter to
    its block, each global moment to its ZeRO-1 part, on the state's
    device (the 0-d leaves go whole)."""
    params = state["params"]
    lay = _layouts(params, grid, pcfg)
    dev = lm.flatten(params)[0][1].device

    def param(path, _):
        return lambda full: specs.local_slice(full, lay[path][0], grid).to(dev)

    def moment(path, _):
        spec, ddim = lay[path]
        return lambda full: TS._part(specs.local_slice(full, spec, grid), ddim, grid).to(
            dev, copy=True)

    opt = state["opt_state"]
    return {"params": _map(params, param),
            "opt_state": AdamState(None, _map(opt.mu, moment), _map(opt.nu, moment), None)}


def restore(directory: str, state: Dict, grid: Grid, pcfg,
            manager: Optional[M.CheckpointManager], verify: bool = True) -> Tuple[Dict, int]:
    """(this rank's restored state, step), or (``state``, 0) when rank 0's
    ``manager`` lists no complete step.  Every rank restores the step rank
    0 names, so no two ranks read different "latest" steps.  The restored
    parameters require grad."""
    latest = manager.latest_step() if grid.rank == 0 else None
    step = comm.broadcast_object(latest)
    if step is None:
        return state, 0
    out = M.read_step(directory, step, state, placements(state, grid, pcfg), verify)
    for _, t in lm.flatten(out["params"]):
        t.requires_grad_(True)
    return out, step


class GridCheckpointer:
    """The training loop's checkpoint on one rank of the grid: rank 0
    holds the manager (``manager``); every other rank passes None and only
    takes part in the gathers."""

    def __init__(self, manager: Optional[M.CheckpointManager], grid: Grid, pcfg):
        self.manager, self.grid, self.pcfg = manager, grid, pcfg

    def save_async(self, step: int, state: Dict, extra_meta: Optional[Dict] = None) -> None:
        lazy = global_leaves(state, self.grid, self.pcfg)
        if self.manager is not None:
            self.manager.save_async(step, lazy, extra_meta)
            return
        for leaf in M._leaf_paths(lazy).values():
            if callable(leaf):
                leaf()

    def wait_until_finished(self):
        if self.manager is not None:
            self.manager.wait_until_finished()

    def close(self):
        if self.manager is not None:
            self.manager.close()

