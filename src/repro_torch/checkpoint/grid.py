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

The 1F1B pipeline (``parallel/pipeline.py``) saves the JAX pipeline's
layout, ``{"params": [stage trees], "opt_state": [stage AdamStates]}``,
whose leaf names carry the stage as their second segment
(``params/1/blocks/attn/wq``, ``opt_state/0/.mu/embed/table``;
``pipeline.stage_writer_map`` reads it).  Each stage's leaves are
gathered inside its pod as above, and the pod's rank 0 sends each to
rank 0, the coordinator, over ``pod`` (``comm.pod_exchange``); on
restore every rank reads its own stage's leaves only and keeps its
blocks.  :class:`GridCheckpointer` also carries the hooks
``runtime/fault.run_supervised`` looks up (``abort``,
``retire_steps_after``, ``latest_step``, ``dir``), so a supervised grid
or pipeline run rolls back on every rank together.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

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


def _named_step(grid: Grid, manager, step: Optional[int]) -> Optional[int]:
    """``step``, or the newest complete step of rank 0's ``manager``, on
    every rank (so no two ranks read different "latest" steps)."""
    if step is not None:
        return step
    return comm.broadcast_object(manager.latest_step() if grid.rank == 0 else None)


def restore(directory: str, state: Dict, grid: Grid, pcfg,
            manager: Optional[M.CheckpointManager], verify: bool = True) -> Tuple[Dict, int]:
    """(this rank's restored state, step), or (``state``, 0) when rank 0's
    ``manager`` lists no complete step.  Every rank restores the step rank
    0 names.  The restored parameters require grad."""
    step = _named_step(grid, manager, None)
    if step is None:
        return state, 0
    out = M.read_step(directory, step, state, placements(state, grid, pcfg), verify)
    for _, t in lm.flatten(out["params"]):
        t.requires_grad_(True)
    return out, step


# ---------------------------------------------------------------------------
# the 1F1B pipeline
# ---------------------------------------------------------------------------

def _stage_state_tree(paths, leaf):
    """A stage's ``{"params", "opt_state"}`` tree with ``leaf(kind, path)``
    at each leaf (kind: "param", "mu", "nu", "step", "gnorm_ewma")."""
    tree = lambda kind: lm.unflatten(paths, [leaf(kind, p) for p in paths])  # noqa: E731
    return tree("param"), AdamState(leaf("step", ()), tree("mu"), tree("nu"),
                                    leaf("gnorm_ewma", ()))


def pipeline_global_leaves(state: Dict, runner) -> Dict:
    """The pipeline state of every stage as callables in the JAX layout:
    on rank 0 each returns the global array, elsewhere None (every rank
    must call them, in the manager's leaf order)."""
    grid, me, p = runner.grid, runner.stage, runner.n_stages
    mine = global_leaves(state, runner.stage_grid, runner.inner)
    own = {"param": dict(lm.flatten(mine["params"])), "mu": dict(lm.flatten(mine["opt_state"].mu)),
           "nu": dict(lm.flatten(mine["opt_state"].nu))}
    head = grid.pod_grid().rank == 0                 # the pod's rank on rank 0's pod line
    params, opts = [], []
    for s in range(p):
        shapes = runner.stage_shapes[s]

        def leaf(kind, path, s=s, shapes=shapes):
            shape = shapes[path] if path else ()
            dtype = torch.int32 if kind == "step" else torch.float32

            def call():
                val = None
                if s == me:
                    if kind in own:
                        val = own[kind][path]()
                    else:
                        val = getattr(state["opt_state"], kind).detach()
                if s == 0 or not head:
                    return val if grid.rank == 0 else None
                got = comm.pod_exchange(val if me == s else None, 0 if me == s else None,
                                        [s] if me == 0 else [], shape, dtype)
                return got.get(s)
            return call
        sp, so = _stage_state_tree(list(shapes), leaf)
        params.append(sp)
        opts.append(so)
    return {"params": params, "opt_state": opts}


def restore_pipeline(directory: str, state: Dict, runner,
                     manager: Optional[M.CheckpointManager], verify: bool = True,
                     step: Optional[int] = None) -> Tuple[Dict, int]:
    """:func:`restore` for a pipeline rank: it reads its own stage's leaves
    of the JAX pipeline layout and keeps its blocks; ``step`` (the same on
    every rank) names the step instead of rank 0's manager."""
    step = _named_step(runner.grid, manager, step)
    if step is None:
        return state, 0
    me, p = runner.stage, runner.n_stages
    at_me = lambda x: [x if k == me else None for k in range(p)]  # noqa: E731
    pl = placements(state, runner.stage_grid, runner.inner)
    out = M.read_step(directory, step,
                      {"params": at_me(state["params"]), "opt_state": at_me(state["opt_state"])},
                      {"params": at_me(pl["params"]), "opt_state": at_me(pl["opt_state"])},
                      verify)
    new = {"params": out["params"][me], "opt_state": out["opt_state"][me]}
    for _, t in lm.flatten(new["params"]):
        t.requires_grad_(True)
    return new, step


class GridCheckpointer:
    """The training loop's checkpoint on one rank of the grid: rank 0
    holds the manager (``manager``); every other rank passes None and only
    takes part in the gathers.  With a pipeline ``runner`` the state is
    that rank's stage, saved in the pipeline layout."""

    def __init__(self, manager: Optional[M.CheckpointManager], grid: Grid, pcfg, runner=None):
        self.manager, self.grid, self.pcfg, self.runner = manager, grid, pcfg, runner

    def _together(self, fn) -> None:
        """Run rank 0's ``fn`` (every other rank runs its part of the same
        save, or nothing) and raise on every rank when it raised there: a
        failed save (a quorum lost, a writer's sticky error) ends the
        incarnation of every rank, as a supervised restart needs."""
        err = None
        try:
            fn()
        except Exception as e:             # noqa: BLE001  (re-raised below)
            err = e
        why = comm.broadcast_object(None if err is None else f"{type(err).__name__}: {err}")
        if err is not None:
            raise err
        if why is not None:
            raise RuntimeError(f"rank 0's checkpoint failed: {why}")

    def save_async(self, step: int, state: Dict, extra_meta: Optional[Dict] = None) -> None:
        # a sticky writer error raises before any rank starts the gathers
        self._together(lambda: self.manager is not None and self.manager.check_error())
        lazy = (global_leaves(state, self.grid, self.pcfg) if self.runner is None
                else pipeline_global_leaves(state, self.runner))

        def save():
            if self.manager is not None:
                self.manager.save_async(step, lazy, extra_meta)
                return
            for leaf in M._leaf_paths(lazy).values():
                if callable(leaf):
                    leaf()
        self._together(save)

    def wait_until_finished(self):
        self._together(lambda: self.manager is not None and self.manager.wait_until_finished())

    @property
    def writer_fault(self):
        """The manager's ``writer_fault`` hook (``train/loop`` wires an
        injector's into it)."""
        return None if self.manager is None else self.manager.writer_fault

    @writer_fault.setter
    def writer_fault(self, hook):
        if self.manager is not None:
            self.manager.writer_fault = hook

    def close(self):
        if self.manager is not None:
            self.manager.close()

    # the hooks of runtime/fault.run_supervised: rank 0 fences, retires and
    # (through ``dir``) publishes the blocklist; every rank takes the step
    # rank 0 names, a broadcast that also orders the blocklist's write
    # before any rank reads it
    @property
    def dir(self) -> Optional[str]:
        return None if self.manager is None else self.manager.dir

    def abort(self):
        if self.manager is not None:
            self.manager.abort()

    def retire_steps_after(self, step: int):
        return [] if self.manager is None else self.manager.retire_steps_after(step)

    def latest_step(self) -> Optional[int]:
        return _named_step(self.grid, self.manager, None)

