"""Training launcher: one device, or the hecaton grid of ranks.

Counterpart of ``repro/launch/train.py``.  With ``--data``, ``--mx`` and
``--my`` all 1 (the default) it is the JAX launcher's ``mesh is None``
path: synthetic data through the prefetcher, the microbatched step
(``train/step.py``) folded by ``train/loop.py``, the final loss printed
as the JAX launcher prints it (remat ``fusion`` and bf16 gradient
rounding, the JAX defaults).  Like the JAX launcher on one device,
compute defaults to fp32; ``--dtype bfloat16`` computes in bf16 over the
fp32 masters.

``--strategy hecaton --data D --mx X --my Y`` spawns D*X*Y rank
processes (``torch.multiprocessing``, gloo rendezvous through a file in
a temporary directory), each on card ``rank % device_count`` — on a
one-card machine every rank shares card 0, which shows that the grid
computes the right function, not how fast a grid runs.  Every rank
builds the same seeded parameters and keeps its blocks
(``parallel/specs.py``), and reads its block of each global batch.
``--strategy megatron`` (the paper's baseline) runs the same D*X*Y ranks,
with the same device-to-rank map, as a (data, model) grid of
``model = X*Y`` (``parallel/megatron.py``), its residual between blocks
token-sharded over ``model`` (``ParallelConfig.residual``'s default).
``--overlap`` picks the collectives: ``none`` (bulk),
``ring`` (ppermute rings), ``bidir`` (half shards circulating both ways)
or ``fused`` (the ring kernels where the JAX gates allow them);
``--comm-dtype int8`` sends the ring hops as int8 payloads with fp32 row
scales (the fused route: the int8 variants of the ring kernels).  ``--layers`` cuts the
depth of the chosen arch.  The kernels are built in the launcher before
the ranks start.

``--pods N --pod-role pipeline`` (N > 1) runs the 1F1B pipeline
(``parallel/pipeline.py``) as the JAX launcher's ``_train_pipeline``
does: N x D*X*Y rank processes, rank (s, d, x, y) running stage s of the
block stack on its pod's D x X x Y grid (either strategy), the
stage-boundary activations and cotangents crossing over the ``pod``
groups.  Its learning-rate horizon is ``--steps`` (the JAX pipeline's
``total_steps=args.steps``); ``--ckpt-writers`` defaults to one writer
per stage, pinned by ``stage_writer_map``, and the checkpoint holds the
JAX pipeline layout (``checkpoint/grid.py``); the guard, watchdog and
blocklist are wired as on the grid.  It ends with ``pipeline[N stages x
(XxY)] final loss ...``.  On one card the stage processes take turns
(time-slicing), so a run shows the function, not a pipeline speed.
``--pods N`` with the default ``--pod-role data`` makes the pods more
data parallelism, as the JAX launcher does: N x D*X*Y rank processes,
laid out row-major over (pod, data, mx, my), which is a grid of N*D data
ranks: the batch, the gradient sum and the ZeRO-1 moments over
``("pod", "data")``, pod-major, are those over that data axis
(``_grid_shape``); every other flag works as on one pod, and the run
ends with ``grid[NxDxXxY] final loss ...``.

``--device`` defaults to ``cuda`` (the CUDA kernels); ``--device cpu``
runs the plain PyTorch versions (gloo carries the grid's data).

The MoE family (``granite-moe-3b-a800m``, ``grok-1-314b``) trains on
one device: the router, the grouped expert products, the combine and
the dispatch differentiate through their kernels' backwards, and the
loss adds ``aux_loss`` times the layers' load-balance loss.
``--layers`` cuts its depth to fit the card (granite at 8 of its 32
layers: ~0.96 B parameters, ~15 GB of fp32 state; grok-1 trains at its
smoke size only).  The rank grid and the pipeline refuse it by name.

``--arch minicpm3-4b`` (MLA) trains on one device only, its attention
on the flash kernels at the padded head dim 96 -> 128; ``--layers``
cuts its depth to fit the card (8 layers: ~14 GB of fp32 state).  The
grid flags and ``--pods`` > 1 refuse it.

``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps in the JAX
package's format (``checkpoint/manager.py``): async saves unless
``--ckpt-sync``, ``--ckpt-keep`` kept, ``--ckpt-writers`` logical writers
and ``--ckpt-quorum`` of them to publish, ``--ckpt-no-verify`` to skip the
crc check on restore.  A run whose directory holds a complete step
restores the newest one (printing ``restored checkpoint at step N``),
feeds the batches from that step on and trains to ``--steps``; on the
grid rank 0 writes global leaves and every rank restores its blocks
(``checkpoint/grid.py``), so a checkpoint of either path restores on the
other.  ``--ckpt-procs`` runs each writer as an OS process
(``runtime/procs.py``; on the grid, rank 0's children) with a
``--ckpt-writer-timeout`` heartbeat lease; the fleet is spawned while
the run sets up.

The training runtime (``runtime/``, as the JAX launcher wires it):
``--guard`` arms the in-graph skip guard (``--guard-spike-factor``) and
a ``TrainingGuard`` on every rank (``--guard-loss-spike``,
``--guard-patience``, ``--guard-skip-cap``), which raises
``DivergenceError`` on a sustained loss spike or skip streak;
``--hang-timeout`` arms the ``Watchdog``; ``--no-rollback`` clears the
policy bit the supervisor reads.  A ``blocklist.json`` in the checkpoint
directory makes step ``s`` consume data index ``data_index(s,
blocklist)`` on every rank.  Like the JAX launcher this one does not
supervise restarts: ``runtime/fault.run_supervised`` is a library
function.  The learning-rate schedule's horizon is ``LR_HORIZON``
(10,000 steps, the JAX launcher's), whatever ``--steps`` is.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --dtype bfloat16 --steps 20 --batch 8 --seq 512 --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --dtype bfloat16 --strategy hecaton --data 1 --mx 2 --my 2 --overlap fused \\
        --comm-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --dtype bfloat16 --strategy megatron --data 1 --mx 2 --my 2 --overlap fused
    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-tinyllama-1.1b \\
        --dtype bfloat16 --pods 2 --pod-role pipeline --batch 8 --seq 512 --microbatches 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m \\
        --layers 8 --dtype bfloat16 --batch 8 --seq 512 --microbatches 2
"""

from __future__ import annotations

import argparse
import os
import time

from repro_torch.config import COMM_DTYPES, OVERLAP_MODES, POD_ROLES, STRATEGIES
from repro_torch.runtime.guard import BLOCKLIST  # noqa: F401  (the sidecar's name)

DTYPES = ("float32", "bfloat16")
LR_HORIZON = 10_000                # total_steps of the schedule, as in the JAX launcher


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced smoke config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the arch to this many layers (0: all of them)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (kernels) or cpu")
    ap.add_argument("--dtype", default="float32", choices=DTYPES,
                    help="compute dtype (masters stay fp32)")
    ap.add_argument("--strategy", default="hecaton", choices=STRATEGIES,
                    help="hecaton's 2D tiling over mx x my, or the megatron baseline's 1D "
                         "model axis of mx * my ranks")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--mx", type=int, default=1)
    ap.add_argument("--my", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1,
                    help="packages; with --pod-role pipeline each pod runs one 1F1B stage of "
                         "the block stack")
    ap.add_argument("--pod-role", default="data", choices=POD_ROLES,
                    help="what the pod axis does when --pods > 1: more data parallelism, "
                         "or one 1F1B stage per pod")
    ap.add_argument("--overlap", default="none", choices=OVERLAP_MODES,
                    help="grid collectives: bulk, ppermute rings (one way or both), or the "
                         "ring kernels")
    ap.add_argument("--comm-dtype", default="bf16", choices=COMM_DTYPES,
                    help="ring wire dtype: the operands' own, or int8 with fp32 row scales")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="seconds before a grid run is stopped as hung (0: none)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-keep", type=int, default=3)
    ap.add_argument("--ckpt-sync", action="store_true",
                    help="blocking saves (default: the async staged writer)")
    ap.add_argument("--ckpt-writers", type=int, default=0,
                    help="logical checkpoint writers (0: one per pipeline stage, else 1)")
    ap.add_argument("--ckpt-quorum", type=int, default=0,
                    help="partial manifests required before a step publishes (0: all)")
    ap.add_argument("--ckpt-no-verify", action="store_true",
                    help="skip per-shard checksum verification on restore")
    ap.add_argument("--ckpt-procs", action="store_true",
                    help="run each logical checkpoint writer as its own OS process "
                         "(heartbeat leases, orphan-range reassignment; runtime/procs.py)")
    ap.add_argument("--ckpt-writer-timeout", type=float, default=5.0,
                    help="heartbeat-lease deadline in seconds: a writer process whose "
                         "heartbeat stalls longer is SIGKILL-fenced and its range reassigned")
    ap.add_argument("--guard", action="store_true",
                    help="arm the self-healing guard: in-graph NaN/spike skip-update and "
                         "loss-spike divergence detection")
    ap.add_argument("--guard-spike-factor", type=float, default=10.0,
                    help="skip the update when the grad norm exceeds this multiple of its EWMA")
    ap.add_argument("--guard-loss-spike", type=float, default=2.0,
                    help="a loss above this multiple of the loss EWMA counts toward patience")
    ap.add_argument("--guard-patience", type=int, default=3,
                    help="consecutive spiking losses before DivergenceError")
    ap.add_argument("--guard-skip-cap", type=int, default=3,
                    help="consecutive skipped updates before DivergenceError")
    ap.add_argument("--hang-timeout", type=float, default=0.0,
                    help="seconds before an armed step counts as hung (0: watchdog off)")
    ap.add_argument("--no-rollback", action="store_true",
                    help="on divergence, restart without retiring poisoned checkpoints or "
                         "blocklisting the poison window")
    return ap


def _stages(args) -> int:
    return args.pods if args.pod_role == "pipeline" else 1


def _grid_shape(args):
    """(data, pods) of the rank grid.  The pod role ``data`` folds the pods
    into the data axis: ranks row-major over (pod, data, mx, my) are the
    ranks of a grid of pods * data data ranks, and JAX's ``P(("pod",
    "data"))`` deals the batch, and ZeRO-1 its moment parts, pod-major,
    which is that data axis's index."""
    if _stages(args) > 1:
        return args.data, args.pods
    return args.pods * args.data, 1


def _ckpt_config(args):
    from repro_torch.config import CheckpointConfig
    return CheckpointConfig(every=args.ckpt_every, keep=args.ckpt_keep,
                            async_=not args.ckpt_sync, writers=args.ckpt_writers or _stages(args),
                            quorum=args.ckpt_quorum or None, verify=not args.ckpt_no_verify,
                            writer_procs=args.ckpt_procs,
                            writer_timeout=args.ckpt_writer_timeout)


def _make_manager(args, ccfg):
    """(the run's checkpoint manager, its writer fleet or None).  A
    pipeline's shards are pinned to writers by stage
    (``pipeline.stage_writer_map``).  The fleet is spawned here, while the
    run sets up, not in the background of the first timed steps."""
    from repro_torch.checkpoint.manager import make_manager
    writer_map = None
    if _stages(args) > 1:
        from repro_torch.parallel.pipeline import stage_writer_map
        writer_map = stage_writer_map(ccfg.writers)
    mgr = make_manager(args.ckpt_dir, ccfg, writer_map=writer_map)
    fleet = None
    if ccfg.writer_procs:
        fleet = mgr.fleet()
        fleet.ensure_spawned()
    return mgr, fleet


def _parent_pid(pid: int) -> int:
    with open(f"/proc/{pid}/status") as f:
        return next(int(line.split()[1]) for line in f if line.startswith("PPid:"))


def _guard_cfg(args):
    """The GuardConfig the flags describe, or None without ``--guard``: it
    arms the step's skip guard and the loop's TrainingGuard."""
    if not args.guard:
        return None
    from repro_torch.config import GuardConfig
    return GuardConfig(grad_spike_factor=args.guard_spike_factor,
                       loss_spike_factor=args.guard_loss_spike, patience=args.guard_patience,
                       skip_cap=args.guard_skip_cap, hang_timeout=args.hang_timeout,
                       rollback=not args.no_rollback)


def _guard_runtime(args, gcfg, ckpt_dir, start, batch_at, log_fn=print):
    """The loop's side of the runtime: (TrainingGuard, Watchdog,
    data_index_fn, stream).  The stream yields ``batch_at(data_index(s,
    blocklist))`` from ``start`` on, the batches an uninterrupted run over
    the filtered data would take."""
    from repro_torch.runtime import guard as G
    tguard = G.TrainingGuard(gcfg) if gcfg is not None else None
    wd = G.Watchdog(args.hang_timeout) if args.hang_timeout > 0 else None
    bl = G.load_blocklist(ckpt_dir)
    if bl:
        log_fn(f"blocklist: skipping poisoned data indices {bl}")
    stream = G.blocklisted_stream(batch_at, start, bl)
    return tguard, wd, (lambda s: G.data_index(s, bl)), stream


def _ckpt_report(state, mgr, start, restore_s, fleet=None) -> dict:
    """What the run's checkpoints cost: the restored step and its seconds,
    each boundary save's stall, each published write (step, host-clock
    start and end, bytes), each step's start on the host clock; with
    writer processes, each slot's seconds from spawn to its first
    heartbeat, the handover arena that ran (shm or spill), each save's
    seconds in the fleet (the pack into the arena, each writer) and the
    fleet's events."""
    return {"start": start, "restore_s": restore_s, "save_s": state.get("save_s", []),
            "writes": list(mgr.writes) if mgr is not None else [],
            "step_t0": state.get("step_t0", []),
            "spawn_s": list(fleet.spawn_s) if fleet is not None else [],
            "handover": fleet.arena_kind if fleet is not None else None,
            "fleet_saves": list(fleet.saves) if fleet is not None else [],
            "fleet_events": list(fleet.events) if fleet is not None else []}


def _recording(step, grad_norms, lrs, auxes):
    """``step`` that also keeps each step's grad norm, learning rate and
    aux loss."""
    def wrapped(p, o, b):
        p, o, m = step(p, o, b)
        grad_norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        auxes.append(float(m["aux"]))
        return p, o, m
    return wrapped


def run(args, log_fn=print) -> dict:
    """Train as ``args`` describe; returns the run's history and times."""
    if args.pods > 1 or args.data * args.mx * args.my > 1:
        return run_grid(args, log_fn=log_fn)
    import torch
    from repro_torch import resolve_device
    from repro_torch.config import ParallelConfig, RunConfig
    from repro_torch.data.synthetic import Prefetcher, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.runtime.fault import StepTimer
    from repro_torch.train import loop as train_loop
    from repro_torch.train import step as TS

    dev = resolve_device(args.device)
    cfg = _config(args)
    rc = RunConfig("custom", "train", args.seq, args.batch, lr=args.lr)
    pcfg = ParallelConfig(microbatches=args.microbatches, pods=args.pods,
                          pod_axis_role=args.pod_role)
    t0 = time.perf_counter()
    params, opt_state = TS.init_train_state(cfg, device=dev)
    ccfg = _ckpt_config(args)
    ckpt, fleet = _make_manager(args, ccfg) if args.ckpt_dir else (None, None)
    start, restore_s = 0, None
    if ckpt is not None and ckpt.latest_step() is not None:
        t1 = time.perf_counter()
        restored, start = ckpt.restore({"params": params, "opt_state": opt_state})
        params, opt_state = restored["params"], restored["opt_state"]
        for _, t in lm.flatten(params):
            t.requires_grad_(True)
        restore_s = time.perf_counter() - t1
        log_fn(f"restored checkpoint at step {start}")
    gcfg = _guard_cfg(args)
    grad_norms, lrs, auxes = [], [], []
    step = _recording(TS.build_train_step(cfg, pcfg, rc, total_steps=LR_HORIZON,
                                          compute_dtype=getattr(torch, args.dtype), guard=gcfg),
                      grad_norms, lrs, auxes)
    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    tguard, wd, dix, stream = _guard_runtime(args, gcfg, args.ckpt_dir, start, ds.batch_at,
                                             log_fn)
    it = Prefetcher(stream, device=dev)
    setup_s = time.perf_counter() - t0
    state = {"params": params, "opt_state": opt_state}
    try:
        state = train_loop.train(step, state, it, start_step=start, num_steps=args.steps,
                                 ckpt=ckpt, ckpt_every=ccfg.every, timer=StepTimer(),
                                 guard=tguard, watchdog=wd, data_index_fn=dix, log_fn=log_fn)
    finally:
        if wd is not None:
            wd.close()
        it.close()
        if ckpt is not None:
            ckpt.close()                 # train() already drained the saves in flight
    h = state["history"]
    if h:
        log_fn(f"final loss {h[-1][1]:.4f} (first {h[0][1]:.4f})")
    return {"cfg": cfg, "history": h, "step_s": state["step_s"], "setup_s": setup_s,
            "tokens_per_step": args.batch * args.seq, "state": state,
            "grad_norms": grad_norms, "lrs": lrs, "aux": auxes,
            "first_data_index": dix(start),
            "ckpt": _ckpt_report(state, ckpt, start, restore_s, fleet)}


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

def _config(args):
    """The run's config, cut to ``--layers`` when given."""
    from repro_torch.config import get_config, get_smoke_config
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    return cfg.scaled(num_layers=args.layers) if args.layers else cfg


def _check_grid_args(args) -> None:
    from repro_torch.core import overlap as OV
    from repro_torch.core import quant as Q
    if args.strategy not in STRATEGIES:
        raise ValueError(f"strategy={args.strategy!r} not in {STRATEGIES}")
    OV.check_mode(args.overlap)
    Q.check_comm_dtype(args.comm_dtype)


def run_grid(args, log_fn=print, check_plain: bool = False) -> dict:
    """Spawn the grid's ranks (a pipeline's: every stage's) and train;
    returns rank 0's history, grad norms and times with every rank's
    kernel launches and the bytes its logged collectives received
    (``overlap.route_bytes``), and rank 0's route table; a pipeline adds
    each rank's stage, executed order, stash peak, boundary bytes of the
    last step, and attention and matmul launches per path.
    ``check_plain`` first has every rank train the same steps from
    the same parameters through the plain versions on the grid (their
    losses and grad norms, and how far the kernels' final parameters lie
    from the plain run's), and rank 0 compute the first batch's loss
    through the single-device path on the full parameters."""
    from repro_torch import resolve_device
    from repro_torch.core import overlap as OV
    from repro_torch.parallel import comm

    _check_grid_args(args)
    cfg0 = _config(args)
    if cfg0.mla:
        raise NotImplementedError(f"MLA ({args.arch}) trains on one device only: the rank grid "
                                  "and the pod axis do not take it")
    if cfg0.moe and _stages(args) > 1:
        from repro_torch.config import ParallelConfig
        from repro_torch.parallel import pipeline as PIPE
        PIPE.validate_pipeline(cfg0, ParallelConfig(pods=args.pods,
                                                    pod_axis_role=args.pod_role))
    if cfg0.moe:
        raise NotImplementedError(f"MoE ({args.arch}) on the rank grid (EP x TP) is not "
                                  "ported; it trains on one device")
    if check_plain and args.ckpt_dir:
        raise ValueError("check_plain trains from the initial parameters: no --ckpt-dir")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()                       # once, before the ranks start
    world = args.pods * args.data * args.mx * args.my
    opts = dict(vars(args), check_plain=check_plain)
    t0 = time.perf_counter()
    results = comm.run_ranks(_grid_rank, world, (opts, comm.temp_init_file()), args.timeout)
    for line in results[0]["log"]:
        log_fn(line)
    r0 = results[0]
    cfg = _config(args)
    h = r0["history"]
    pods = f"{args.pods}x" if args.pods > 1 else ""
    if h and _stages(args) > 1:
        log_fn(f"pipeline[{args.pods} stages x ({args.mx}x{args.my})] final loss "
               f"{h[-1][1]:.4f} (first {h[0][1]:.4f})")
    elif h:
        log_fn(f"grid[{pods}{args.data}x{args.mx}x{args.my}] final loss {h[-1][1]:.4f} "
               f"(first {h[0][1]:.4f})")
    pipe = {k: {r: results[r][k] for r in sorted(results)}
            for k in ("stage", "executed", "max_stash", "boundary_bytes", "paths")}
    return {"cfg": cfg, "history": h, "grad_norms": r0["grad_norms"], "lrs": r0["lrs"],
            "histories": {r: results[r]["history"] for r in sorted(results)},
            "skipped": {r: results[r]["skipped"] for r in sorted(results)},
            "first_data_index": r0["first_data_index"], "pids": r0["pids"],
            "step_s": r0["step_s"], "setup_s": r0["setup_s"],
            "tokens_per_step": args.batch * args.seq, "routes": r0["routes"],
            "launches": {r: results[r]["launches"] for r in sorted(results)},
            "checks": r0["checks"], "world": world, "ckpt": r0["ckpt"],
            "nop_bytes": {r: OV.route_bytes(results[r]["routes"]) for r in sorted(results)},
            "pipeline": pipe, "wall_s": time.perf_counter() - t0}


def _grid_rank(rank: int, opts: dict, init_file: str) -> dict:
    import numpy as np
    import torch
    from repro_torch import resolve_device
    from repro_torch.checkpoint import grid as CG
    from repro_torch.config import ParallelConfig, RunConfig
    from repro_torch.core import overlap as OV
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import matmul as MM
    from repro_torch.kernels import ops
    from repro_torch.kernels import ring_matmul as RM
    from repro_torch.launch.mesh import Grid
    from repro_torch.models import lm
    from repro_torch.parallel import comm, specs
    from repro_torch.runtime import guard as G
    from repro_torch.train import loop as train_loop
    from repro_torch.train import step as TS

    a = argparse.Namespace(**opts)
    dev = resolve_device(a.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    data, pods = _grid_shape(a)
    grid = Grid(data, a.mx, a.my, rank, pods=pods)
    pipe = pods > 1
    t0 = time.perf_counter()
    w = comm.init_world(grid, device=dev, init_file=init_file)
    try:
        dev = w.device
        cfg = _config(a)
        dtype = getattr(torch, a.dtype)
        rc = RunConfig("custom", "train", a.seq, a.batch, lr=a.lr)
        pcfg = ParallelConfig(strategy=a.strategy, data=data, mx=a.mx, my=a.my,
                              overlap=a.overlap, comm_dtype=a.comm_dtype,
                              microbatches=a.microbatches, pods=pods,
                              pod_axis_role=a.pod_role)
        gcfg = _guard_cfg(a)
        full = lm.init_master_params(cfg, seed=0, device=dev)
        runner = None
        if pipe:
            # the JAX pipeline's lr horizon is the run's length
            from repro_torch.parallel import pipeline as PP
            runner, kstep = PP.build_pipeline_train_step(cfg, pcfg, rc, grid,
                                                         total_steps=a.steps,
                                                         compute_dtype=dtype, guard=gcfg)
            params = runner.place_params(full)
        else:
            params = specs.shard_tree(full, specs.param_specs(full, grid, strategy=a.strategy),
                                      grid)
            for _, t in lm.flatten(params):
                t.requires_grad_(True)
            kstep = TS.build_train_step(cfg, pcfg, rc, total_steps=LR_HORIZON,
                                        compute_dtype=dtype, mesh=grid, guard=gcfg)
        ds = SyntheticLM(cfg.vocab_size, a.seq, a.batch)

        def local(step):
            b = ds.batch_at(step)
            lb = (runner.local_batch(b) if pipe else
                  specs.local_batch(b, grid, a.microbatches, a.strategy, pcfg.residual))
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in lb.items()}

        checks, plain_params = {}, None
        if a.check_plain:
            if rank == 0:
                b0 = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(0).items()}
                checks["single_step0_loss"] = TS.eval_loss(
                    cfg, ParallelConfig(microbatches=a.microbatches), full, b0,
                    compute_dtype=dtype)
            init = [t.detach().clone() for _, t in lm.flatten(params)]
            plain_params = lm.unflatten([p for p, _ in lm.flatten(params)],
                                        [t.clone().requires_grad_(True) for t in init])
            if pipe:
                prunner, pstep = PP.build_pipeline_train_step(
                    cfg, pcfg, rc, grid, total_steps=a.steps, compute_dtype=dtype, plain=True)
                popt = prunner.init_opt(plain_params)
            else:
                pstep = TS.build_train_step(cfg, pcfg, rc, compute_dtype=dtype, mesh=grid,
                                            plain=True)
                popt = TS.init_grid_opt_state(plain_params, grid, pcfg)
            checks["plain_losses"], checks["plain_grad_norms"] = [], []
            for s in range(a.steps):
                plain_params, popt, m = pstep(plain_params, popt, local(s))
                checks["plain_losses"].append(float(m["loss"]))
                checks["plain_grad_norms"].append(float(m["grad_norm"]))
            del popt
            comm.barrier()
        del full
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        opt_state = (runner.init_opt(params) if pipe
                     else TS.init_grid_opt_state(params, grid, pcfg))
        state = {"params": params, "opt_state": opt_state}
        del params, opt_state
        ccfg = _ckpt_config(a)
        ckpt, mgr, fleet, start, restore_s, lines = None, None, None, 0, None, []
        writer_ppids = {}
        if a.ckpt_dir:
            # rank 0 writes (and names the step to restore, and runs the
            # writer processes, whose parent it is); every rank reads
            if rank == 0:
                mgr, fleet = _make_manager(a, ccfg)
            if fleet is not None:
                writer_ppids = {s: _parent_pid(pid) for s, pid in fleet.pids().items()}
            t1 = time.perf_counter()
            if pipe:
                state, start = CG.restore_pipeline(a.ckpt_dir, state, runner, mgr, ccfg.verify)
            else:
                state, start = CG.restore(a.ckpt_dir, state, grid, pcfg, mgr, ccfg.verify)
            if start:
                restore_s = time.perf_counter() - t1
                lines.append(f"restored {'pipeline ' if pipe else ''}checkpoint at step {start}")
            ckpt = CG.GridCheckpointer(mgr, grid, pcfg, runner)
        # every rank runs the same guard on the same values (the loss and
        # the grad norm are global), so all of them skip or raise together
        grad_norms, lrs, auxes, skipped = [], [], [], []
        step = _recording(kstep, grad_norms, lrs, auxes)
        if gcfg is not None:
            def step(p, o, b, _inner=step):
                p, o, m = _inner(p, o, b)
                skipped.append(float(m["update_skipped"]))
                return p, o, m
        tguard, wd, dix, stream = _guard_runtime(a, gcfg, a.ckpt_dir, start, local,
                                                 lines.append)
        setup_s = time.perf_counter() - t0
        ops.reset_launches()
        OV.clear_routes()
        try:
            state = train_loop.train(step, state, stream, start_step=start, num_steps=a.steps,
                                     ckpt=ckpt, ckpt_every=ccfg.every, guard=tguard,
                                     watchdog=wd, data_index_fn=dix, log_fn=lines.append)
        finally:
            if wd is not None:
                wd.close()
            if ckpt is not None:
                ckpt.close()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        launches = dict(ops.LAUNCHES)
        if plain_params is not None:
            # per leaf: |kernels - plain| over |plain - initial|, this rank's blocks
            checks["param_rel"] = {
                ".".join(path): float((k.detach() - q.detach()).norm()
                                      / (q.detach() - t0).norm().clamp_min(1e-30))
                for (path, k), (_, q), t0 in zip(lm.flatten(state["params"]),
                                                 lm.flatten(plain_params), init)}
        paths = {"attention": {k: dict(v) for k, v in FA.IMPL_LAUNCHES.items()},
                 "matmul": {k: dict(v) for k, v in MM.IMPL_LAUNCHES.items()},
                 "ring": {k: dict(v) for k, v in RM.IMPL_LAUNCHES.items()}}
        comm.barrier()
        return {"history": state["history"], "grad_norms": grad_norms, "lrs": lrs,
                "aux": auxes, "stage": grid.axis_index("pod"), "paths": paths,
                "executed": [(t.kind, t.mb) for t in runner.executed] if pipe else None,
                "max_stash": runner.max_stash if pipe else None,
                "boundary_bytes": runner.boundary_bytes if pipe else None,
                "skipped": skipped, "first_data_index": dix(start),
                "pids": {"rank": os.getpid(), "writer_parents": writer_ppids},
                "step_s": state["step_s"], "setup_s": setup_s,
                "launches": launches, "routes": OV.route_table(), "checks": checks,
                "ckpt": _ckpt_report(state, mgr, start, restore_s, fleet), "log": lines}
    finally:
        comm.shutdown()


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
