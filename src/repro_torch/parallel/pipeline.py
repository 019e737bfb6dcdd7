"""Inter-pod 1F1B pipeline parallelism (``ParallelConfig.pod_axis_role ==
"pipeline"``).

Counterpart of ``repro/parallel/pipeline.py``.  Across packages the
off-package links are the slow tier, so each pod owns a contiguous
*stage* of the block stack and microbatches stream through the stages
under a 1F1B (one-forward-one-backward) schedule: the only inter-pod
traffic is one boundary activation (and its cotangent) per microbatch
per stage boundary.

Two layers, as in the JAX module:

1. **The schedule** (:func:`schedule_1f1b`, :func:`stage_order`), the
   stage partition (:func:`split_stage_layers`, :func:`validate_pipeline`,
   :func:`stage_params`, :func:`merge_stage_grads`) and the checkpoint
   writer map (:func:`stage_writer_map`): plain Python, copied, with the
   same error messages.
2. **The runner** (:class:`PipelineRunner`).  The port runs one process
   per rank over a grid with a leading ``pod`` axis
   (``launch/mesh.Grid(..., pods=p)``); rank (s, d, x, y) runs stage s.
   Every rank walks the same tick table and runs its own stage's task at
   each tick; after a tick on which any stage produced a boundary tensor,
   the ranks of each ``pod`` group exchange them
   (``comm.pod_exchange``): rank (s, d, x, y) sends its block of the
   canonical residual to (s+1, d, x, y), and its block of the cotangent
   to (s-1, d, x, y).  Inside a stage the grid is the pod's
   (``Grid.pod_grid``), so hecaton's 2D tiling or the megatron baseline,
   the overlap lattice and the residual layout compose unchanged.  A
   one-rank stage (data = mx = my = 1) runs with ``mesh=None``, the
   single-device ``PCtx``: its products, gate and attention take the
   one-card kernels, and it opens no group and touches no symmetric
   buffer for its axes of size 1.

Stage-granular remat, as in JAX: an F tick runs the stage forward, keeps
only its output and stashes its boundary input; a B tick recomputes the
stage from the stash under autograd and pulls the cotangent back.  The F
tick runs the same differentiable ops as the recompute (its graph is
dropped at once), so the activation sent on is the one the stage
differentiates through, as JAX's F tick and its vjp run the same ops.
The last stage's F tick only admits the microbatch; its B tick runs
forward, head loss and backward.  ``embed_dropout`` is refused: the F
tick and its recompute would have to draw one mask.

The cotangent convention: the last stage differentiates ``loss / W``
with W the stage's own rank count (its inner world), as ``train/step``'s
grid step differentiates ``loss / world``; every rank's cotangent of its
block is then its own contribution, and the stage before pulls back
exactly what it receives.  Where a stage holds the residual whole on
several ranks (megatron's ``replicated`` layout), each replica receives
its replica's partial cotangent, and the psum that made the replicated
output sums them in its backward.

Gradients accumulate per stage as the grid step does (per microbatch the
replicated leaves summed over their axes, rounded to
``grad_reduce_dtype``, summed in fp32, divided by m).  The global-norm
clip couples the stages: each stage's square-sum is taken inside its
grid, summed over ``pod``, and every stage's AdamW consumes that one
norm, so a guarded step skips on every stage together.  The loss and
the learning rate are broadcast from the last stage over ``pod``, so the
loop's history and a guard on every rank see the same values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, ParallelConfig, RunConfig
from repro_torch.launch.mesh import POD, Grid
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel import comm, specs, zero
from repro_torch.parallel.context import PCtx

# ---------------------------------------------------------------------------
# 1F1B schedule (plain Python)
# ---------------------------------------------------------------------------

F = "F"
B = "B"


@dataclass(frozen=True)
class PipeTask:
    """One unit of stage work: forward or backward of one microbatch."""
    kind: str          # "F" | "B"
    mb: int            # microbatch index


def stage_order(stage: int, n_stages: int, n_micro: int) -> List[PipeTask]:
    """Per-stage 1F1B op order: ``min(p-1-s, m)`` warm-up forwards, then
    strict F, B alternation until the forwards run out, then the
    remaining backwards (Megatron-LM's non-interleaved 1F1B)."""
    p, m = n_stages, n_micro
    warmup = min(p - 1 - stage, m)
    order = [PipeTask(F, i) for i in range(warmup)]
    for i in range(m - warmup):
        order.append(PipeTask(F, warmup + i))
        order.append(PipeTask(B, i))
    for i in range(m - warmup, m):
        order.append(PipeTask(B, i))
    return order


@dataclass(frozen=True)
class PipeSchedule:
    """Tick-synchronous 1F1B table: ``ticks[t][s]`` is stage ``s``'s task at
    tick ``t`` (or None for a bubble); a task runs only once its
    dependency completed at a strictly earlier tick."""
    n_stages: int
    n_micro: int
    ticks: Tuple[Tuple[Optional[PipeTask], ...], ...]

    @property
    def makespan(self) -> int:
        return len(self.ticks)

    def bubble_ticks(self, stage: int) -> int:
        """Idle ticks of ``stage`` within the makespan."""
        return sum(1 for t in self.ticks if t[stage] is None)

    @property
    def bubble_fraction(self) -> float:
        """Idle over total ticks of a stage (uniform in 1F1B); theory
        predicts ``(p-1)/(m+p-1)``."""
        return self.bubble_ticks(0) / self.makespan

    def peak_in_flight(self, stage: int) -> int:
        """Most microbatches stashed at once at ``stage`` (``min(p - stage,
        m)`` under 1F1B)."""
        peak = cur = 0
        for t in self.ticks:
            task = t[stage]
            if task is None:
                continue
            cur += 1 if task.kind == F else -1
            peak = max(peak, cur)
        return peak


def schedule_1f1b(n_stages: int, n_micro: int) -> PipeSchedule:
    """Simulate the stage orders into a tick table: F(s, i) needs F(s-1, i),
    B(s, i) needs B(s+1, i); each stage runs its next op as soon as its
    dependency completed at an earlier tick."""
    p, m = n_stages, n_micro
    assert p >= 1 and m >= 1, (p, m)
    orders = [stage_order(s, p, m) for s in range(p)]
    pos = [0] * p
    done: Dict[Tuple[str, int, int], int] = {}
    ticks: List[Tuple[Optional[PipeTask], ...]] = []
    t = 0
    while any(pos[s] < len(orders[s]) for s in range(p)):
        row: List[Optional[PipeTask]] = []
        fired = []
        for s in range(p):
            if pos[s] >= len(orders[s]):
                row.append(None)
                continue
            task = orders[s][pos[s]]
            if task.kind == F:
                dep = None if s == 0 else (F, s - 1, task.mb)
            else:
                dep = None if s == p - 1 else (B, s + 1, task.mb)
            if dep is None or done.get(dep, t) < t:
                row.append(task)
                fired.append((task.kind, s, task.mb))
                pos[s] += 1
            else:
                row.append(None)
        assert fired, f"1F1B deadlock at tick {t} (p={p}, m={m})"
        for key in fired:
            done[key] = t
        ticks.append(tuple(row))
        t += 1
    return PipeSchedule(p, m, tuple(ticks))


# ---------------------------------------------------------------------------
# stage partition of the model
# ---------------------------------------------------------------------------

def split_stage_layers(num_layers: int, n_stages: int) -> List[range]:
    """Contiguous per-stage layer ranges; the stack must divide evenly."""
    if num_layers % n_stages:
        raise ValueError(f"num_layers={num_layers} must divide evenly into "
                         f"{n_stages} pipeline stages")
    lps = num_layers // n_stages
    return [range(s * lps, (s + 1) * lps) for s in range(n_stages)]


def validate_pipeline(cfg: ModelConfig, pcfg: ParallelConfig) -> None:
    """Raise on model/parallel combinations the 1F1B runner does not support."""
    if not pcfg.pipeline_enabled:
        raise ValueError("pod_axis_role='pipeline' requires pods > 1 "
                         f"(got pods={pcfg.pods})")
    if cfg.family == "moe":
        raise NotImplementedError(f"MoE ({cfg.name}) in the 1F1B pipeline is not ported: "
                                  "the stages carry no aux loss; it trains on one device")
    pattern = sorted({"mamba"} if cfg.family == "ssm" or cfg.ssm is not None else {"attn"})
    if cfg.family != "dense" or pattern != ["attn"]:
        raise ValueError(
            f"pipeline stages support uniform token-only attention stacks (dense) "
            f"only; {cfg.name!r} is family={cfg.family!r} with pattern {pattern} — vlm "
            f"patch injection / audio frames / mamba states are not staged")
    if cfg.tie_embeddings:
        raise ValueError("pipeline does not support tie_embeddings: the table would need "
                         "to live on both the first and last stage with summed grads")
    split_stage_layers(cfg.num_layers, pcfg.pipeline_stages)


def stage_params(params, cfg: ModelConfig, stage: int, n_stages: int) -> Dict[str, Any]:
    """One stage's subtree of a full parameter tree (tensors or numpy
    arrays, stacked ``[L, ...]`` blocks): stage 0 owns the embedding, the
    last stage the final norm and the head, every stage its contiguous
    blocks (views of the full leaves)."""
    rng = split_stage_layers(cfg.num_layers, n_stages)[stage]
    items = lm.flatten(params["blocks"])
    sp: Dict[str, Any] = {"blocks": lm.unflatten(
        [p for p, _ in items], [a[rng.start:rng.stop] for _, a in items])}
    if stage == 0:
        sp["embed"] = params["embed"]
    if stage == n_stages - 1:
        sp["final_norm"] = params["final_norm"]
        if "lm_head" in params:
            sp["lm_head"] = params["lm_head"]
    return sp


def _cat(leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.cat([t.detach() for t in leaves], 0)
    return np.concatenate([np.asarray(a) for a in leaves], 0)


def merge_stage_grads(stage_trees: Sequence[Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Per-stage trees -> one full-model tree (the inverse of
    :func:`stage_params`)."""
    items = [lm.flatten(t["blocks"]) for t in stage_trees]
    out = {"blocks": lm.unflatten([p for p, _ in items[0]],
                                  [_cat([it[k][1] for it in items])
                                   for k in range(len(items[0]))]),
           "embed": stage_trees[0]["embed"],
           "final_norm": stage_trees[-1]["final_norm"]}
    if "lm_head" in stage_trees[-1]:
        out["lm_head"] = stage_trees[-1]["lm_head"]
    return out


def stage_writer_map(n_writers: int):
    """Checkpoint shard -> writer for pipeline state: the state is
    ``{"params": [stage trees], "opt_state": [...]}``, so a leaf name's
    second segment is its stage, and ``stage % n_writers`` writes it (a
    pod persists its own stage).  None for a leaf outside the stage lists
    (the manager's byte-balanced partition takes it)."""
    def _map(name: str):
        parts = name.split("/")
        if len(parts) >= 2:
            try:
                return int(parts[1]) % n_writers
            except ValueError:
                return None
        return None
    return _map


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _sends(task: Optional[PipeTask], s: int, p: int) -> Optional[int]:
    """The stage that stage ``s``'s ``task`` sends a boundary tensor to."""
    if task is None:
        return None
    if task.kind == F:
        return s + 1 if s < p - 1 else None
    return s - 1 if s > 0 else None


class PipelineRunner:
    """One rank's side of the 1F1B table: rank ``grid.rank`` of a grid with
    ``pods == pcfg.pipeline_stages`` runs stage ``grid.axis_index("pod")``
    on its pod's grid, with an inner one-pod ``ParallelConfig`` (the same
    strategy, overlap, residual and wire).  ``plain`` sends every product
    to its plain version (the reference the card is held against).

    ``executed`` (this stage's tasks in the order run) and ``max_stash``
    (its most stashed microbatches) are recorded per step, as the JAX
    runner records them per stage; ``boundary_bytes`` counts the bytes this
    rank received over ``pod`` in the last step."""

    _BATCH_KEYS = ("tokens", "labels", "loss_mask", "dropout_rng")

    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig, rc: RunConfig, grid: Grid, *,
                 total_steps: int = 10_000, compute_dtype=torch.bfloat16, guard=None,
                 plain: bool = False):
        validate_pipeline(cfg, pcfg)
        if cfg.embed_dropout:
            raise ValueError("the pipeline runner does not support embed_dropout > 0 "
                             f"(got {cfg.embed_dropout})")
        if grid.pods != pcfg.pipeline_stages:
            raise ValueError(f"pipeline of {pcfg.pipeline_stages} stages on a grid of "
                             f"{grid.pods} pods")
        if (grid.data, grid.mx, grid.my) != (pcfg.data, pcfg.mx, pcfg.my):
            raise ValueError(f"stage grid {grid.data}x{grid.mx}x{grid.my} != the config's "
                             f"{pcfg.data}x{pcfg.mx}x{pcfg.my}")
        self.cfg, self.pcfg, self.rc, self.grid = cfg, pcfg, rc, grid
        self.total_steps, self.compute_dtype, self.guard = total_steps, compute_dtype, guard
        self.n_stages, self.n_micro = pcfg.pipeline_stages, pcfg.microbatches
        self.stage = grid.axis_index(POD)
        self.sched = schedule_1f1b(self.n_stages, self.n_micro)
        self.inner = pcfg.with_(pods=1, pod_axis_role="data")
        self.stage_grid = grid.pod_grid()
        self.pctx = PCtx(mode="train", pcfg=self.inner,
                         mesh=self.stage_grid if grid.pod_world > 1 else None, plain=plain,
                         seq_len=rc.seq_len)
        self.stage_cfg = cfg.scaled(num_layers=cfg.num_layers // self.n_stages)
        self.stage_shapes: List[Dict[Tuple[str, ...], Tuple[int, ...]]] = []
        self.executed: List[PipeTask] = []
        self.max_stash = 0
        self.boundary_bytes = 0

    # -- state placement ---------------------------------------------------

    def place_params(self, full) -> Dict[str, Any]:
        """A full fp32 parameter tree (the same on every rank) -> this rank's
        blocks of its stage, leaves that require grad.  Records every
        stage's global leaf shapes (``stage_shapes``, which the pipeline
        checkpoint reads)."""
        self.stage_shapes = [{p: tuple(t.shape) for p, t in lm.flatten(
            stage_params(full, self.cfg, s, self.n_stages))} for s in range(self.n_stages)]
        sp = stage_params(full, self.cfg, self.stage, self.n_stages)
        out = specs.shard_tree(sp, self.param_specs(sp), self.stage_grid)
        for _, t in lm.flatten(out):
            t.requires_grad_(True)
        return out

    def param_specs(self, sp):
        return specs.param_specs(sp, self.stage_grid, self.inner.fused_loss,
                                 self.inner.strategy)

    def init_opt(self, sp) -> adamw.AdamState:
        """AdamW over this rank's ZeRO-1 parts of its stage blocks."""
        from repro_torch.train import step as TS
        return TS.init_grid_opt_state(sp, self.stage_grid, self.inner)

    def local_batch(self, batch) -> Dict[str, Any]:
        """This rank's block of a global batch: the block its rank of the
        stage grid holds (every stage gets all keys; stage 0 reads the
        tokens, the last stage the labels and mask)."""
        return specs.local_batch(batch, self.stage_grid, self.n_micro, self.inner.strategy,
                                 self.inner.residual)

    # -- stage cores ---------------------------------------------------------

    def _blocks(self, sp, x: torch.Tensor) -> torch.Tensor:
        Bsz, S = x.shape[0], x.shape[1] * self.pctx.seq_shards
        positions = torch.arange(S, device=x.device)[None].expand(Bsz, S)
        return lm._layer_stack(self.pctx, self.stage_cfg, sp["blocks"], x, positions,
                               self.pcfg.remat)

    def _first(self, sp, mb) -> torch.Tensor:
        x = self.pctx.embed(sp["embed"]["table"], mb["tokens"], self.compute_dtype)
        return self._blocks(sp, x)

    def _last_loss(self, sp, x: torch.Tensor, mb) -> torch.Tensor:
        y = self._blocks(sp, x)
        hidden = self.pctx.norm(self.cfg.norm_kind, sp["final_norm"], y)
        return lm.head_loss(self.pctx, self.cfg, sp, hidden, mb["labels"],
                            mask=mb.get("loss_mask"), compute_dtype=self.compute_dtype)

    def _boundary_shape(self, mb) -> Tuple[int, ...]:
        """This rank's block of the canonical residual of one microbatch."""
        h = self.cfg.d_model
        if self.pctx.use_hecaton:
            h //= self.stage_grid.size("my")
        return (mb["tokens"].shape[0], mb["tokens"].shape[1], h)

    def _split(self, batch) -> List[Dict[str, Any]]:
        from repro_torch.train.step import microbatch_split
        unknown = [k for k in batch if k not in self._BATCH_KEYS and hasattr(batch[k], "shape")]
        if unknown:
            # e.g. custom "positions": the stages rebuild arange positions, so
            # dropping a caller's key would mistrain
            raise ValueError(f"pipeline runner does not support batch keys {unknown}; "
                             f"supported: {self._BATCH_KEYS}")
        mbs = microbatch_split(batch, self.n_micro)
        for mb in mbs:
            mb["_dtype"] = self.compute_dtype
        return mbs

    # -- 1F1B execution ------------------------------------------------------

    def loss_and_grads(self, sp, batch) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Run the table once on this rank's block of ``batch``: (the mean
        loss on the last stage's ranks, None elsewhere; this rank's mean
        gradient of each leaf of ``sp``, in ``lm.flatten`` order)."""
        from repro_torch.train.step import _leaf_info, _raw_psum_axes
        p, m, s = self.n_stages, self.n_micro, self.stage
        mbs = self._split(batch)
        leaves = [t for _, t in lm.flatten(sp)]
        info = _leaf_info(sp, self.stage_grid, self.inner)
        inner_world = self.stage_grid.world
        shape = self._boundary_shape(mbs[0])
        gsum: List[torch.Tensor] = []
        acts: Dict[int, torch.Tensor] = {}
        cots: Dict[int, torch.Tensor] = {}
        inflight, executed, losses = set(), [], []
        self.max_stash, self.boundary_bytes = 0, 0

        def accumulate(dp):
            dp = zero.compress_grads([_raw_psum_axes(g, repl) for g, (_, repl, _)
                                      in zip(dp, info)], self.pcfg.grad_reduce_dtype)
            if not gsum:
                gsum.extend(torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                            for g in dp)
            for acc, g in zip(gsum, dp):
                acc.add_(g.float())

        for row in self.sched.ticks:
            task = row[s]
            out = None
            if task is not None:
                executed.append(task)
                i = task.mb
                if task.kind == F:
                    if s < p - 1:
                        # the recompute's ops, not the forward kernels
                        y = self._first(sp, mbs[i]) if s == 0 else self._blocks(sp, acts[i])
                        out = y.detach()
                        del y
                    # the last stage's forward runs inside its B tick
                    inflight.add(i)
                    self.max_stash = max(self.max_stash, len(inflight))
                else:
                    if s == p - 1:
                        x = acts.pop(i).requires_grad_(True)
                        loss = self._last_loss(sp, x, mbs[i])
                        *dp, out = torch.autograd.grad(loss / inner_world, leaves + [x])
                        losses.append(loss.detach())
                        del loss
                    elif s > 0:
                        x = acts.pop(i).requires_grad_(True)
                        y = self._blocks(sp, x)
                        *dp, out = torch.autograd.grad(y, leaves + [x],
                                                       grad_outputs=cots.pop(i))
                        del y
                    else:
                        y = self._first(sp, mbs[i])
                        dp = torch.autograd.grad(y, leaves, grad_outputs=cots.pop(i))
                        del y
                    inflight.discard(i)
                    accumulate(list(dp))
                    del dp
            # the boundary hop of this tick, along every pod group at once
            dests = [_sends(row[q], q, p) for q in range(p)]
            if any(d is not None for d in dests):
                srcs = [q for q in (s - 1, s + 1) if 0 <= q < p and dests[q] == s]
                got = comm.pod_exchange(out, dests[s],
                                        srcs, shape, self.compute_dtype)
                for q, t in got.items():
                    (acts if q == s - 1 else cots)[row[q].mb] = t
                    self.boundary_bytes += t.numel() * t.element_size()
        self.executed = executed
        grads = [g / m for g in gsum]
        loss = None
        if losses:
            loss = losses[0]
            for x in losses[1:]:
                loss = loss + x
            loss = loss / m
        return loss, grads

    # -- the train step -------------------------------------------------------

    def train_step(self, sp, opt_state, batch):
        """(this rank's stage blocks, its AdamW state, its block of the batch)
        -> updated in place, and metrics (``loss``, ``aux``, ``grad_norm``,
        ``lr``, with a guard ``update_ok``/``update_skipped``/``nonfinite``),
        the same on every rank."""
        from repro_torch.train import step as TS
        loss, grads = self.loss_and_grads(sp, batch)
        info = TS._leaf_info(sp, self.stage_grid, self.inner)
        mesh = self.stage_grid
        dev = grads[0].device
        sq = TS.grid_norm_sq(grads, info, specs.grid_axes(self.inner.strategy))
        gnorm = torch.sqrt(comm.raw_psum(sq, POD))
        items = lm.flatten(sp)
        paths, leaves = [p for p, _ in items], [t for _, t in items]
        p_parts = [TS._part(t.detach(), d, mesh) for t, (_, _, d) in zip(leaves, info)]
        g_parts = [TS._part(g, d, mesh) for g, (_, _, d) in zip(grads, info)]
        del grads
        _, opt_state, om = adamw.update(lm.unflatten(paths, p_parts),
                                        lm.unflatten(paths, g_parts), opt_state, self.rc,
                                        self.total_steps, grad_norm=gnorm, guard=self.guard)
        with torch.no_grad():
            for t, part, (_, _, d) in zip(leaves, p_parts, info):
                if d is not None:
                    t.copy_(comm.raw_all_gather(part.contiguous(), "data", d))
        # the loss and the learning rate, from the last stage to every rank
        last = self.stage == self.n_stages - 1
        mine = (torch.stack([loss.float(), om["lr"].float()]) if last
                else torch.zeros(2, dtype=torch.float32, device=dev))
        both = comm.raw_psum(mine, POD)
        metrics = dict(om, loss=both[0], lr=both[1], grad_norm=gnorm,
                       aux=torch.zeros((), dtype=torch.float32, device=dev))
        return sp, opt_state, metrics


def build_pipeline_train_step(cfg: ModelConfig, pcfg: ParallelConfig, rc: RunConfig,
                              grid: Grid, *, total_steps: int = 10_000,
                              compute_dtype=torch.bfloat16, guard=None, plain: bool = False):
    """Pipeline counterpart of ``train/step.build_train_step``: returns
    ``(runner, step_fn)``; the step takes (this rank's stage blocks, its
    AdamW state, its block of the batch) as the grid step takes its
    blocks, so ``train/loop.train`` drives either."""
    runner = PipelineRunner(cfg, pcfg, rc, grid, total_steps=total_steps,
                            compute_dtype=compute_dtype, guard=guard, plain=plain)
    return runner, runner.train_step
