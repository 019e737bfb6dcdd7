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
``--overlap`` picks the collectives: ``none`` (bulk), ``ring`` (ppermute
rings), ``bidir`` (half shards circulating both ways) or ``fused`` (the
ring kernels where the JAX gates allow them); ``--comm-dtype int8``
sends the ring hops as int8 payloads with fp32 row scales (the fused
route: the int8 variants of the ring kernels).  ``--layers`` cuts the
depth of the chosen arch.  The kernels are built in the launcher before
the ranks start.

``--device`` defaults to ``cuda`` (the CUDA kernels); ``--device cpu``
runs the plain PyTorch versions (gloo carries the grid's data).

``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps in the JAX
package's format (``checkpoint/manager.py``): async saves unless
``--ckpt-sync``, ``--ckpt-keep`` kept, ``--ckpt-writers`` logical writers
and ``--ckpt-quorum`` of them to publish, ``--ckpt-no-verify`` to skip the
crc check on restore.  A run whose directory holds a complete step
restores the newest one (printing ``restored checkpoint at step N``),
feeds the batches from that step on and trains to ``--steps``; on the
grid rank 0 writes global leaves and every rank restores its blocks
(``checkpoint/grid.py``), so a checkpoint of either path restores on the
other.  The JAX launcher's ``--ckpt-procs`` / ``--ckpt-writer-timeout``
(writer processes) and its data blocklist belong to the training
runtime, which is not ported: they raise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --dtype bfloat16 --steps 20 --batch 8 --seq 512 --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --dtype bfloat16 --strategy hecaton --data 1 --mx 2 --my 2 --overlap fused \\
        --comm-dtype int8
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

from repro_torch.config import COMM_DTYPES, OVERLAP_MODES

DTYPES = ("float32", "bfloat16")
BLOCKLIST = "blocklist.json"       # the JAX guard's sidecar in a checkpoint directory


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
    ap.add_argument("--strategy", default="hecaton",
                    help="hecaton (the megatron baseline is not ported)")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--mx", type=int, default=1)
    ap.add_argument("--my", type=int, default=1)
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
                    help="logical checkpoint writers (0: 1)")
    ap.add_argument("--ckpt-quorum", type=int, default=0,
                    help="partial manifests required before a step publishes (0: all)")
    ap.add_argument("--ckpt-no-verify", action="store_true",
                    help="skip per-shard checksum verification on restore")
    ap.add_argument("--ckpt-procs", action="store_true",
                    help="writer processes: not ported (raises)")
    ap.add_argument("--ckpt-writer-timeout", type=float, default=None,
                    help="writer processes' lease deadline: not ported (raises)")
    return ap


def _check_ckpt_args(args) -> None:
    from repro_torch.checkpoint.manager import PROCS_NOT_PORTED
    if args.ckpt_procs or args.ckpt_writer_timeout is not None:
        raise NotImplementedError(PROCS_NOT_PORTED)
    if args.ckpt_dir and os.path.exists(os.path.join(args.ckpt_dir, BLOCKLIST)):
        raise NotImplementedError(
            f"{args.ckpt_dir} holds a data blocklist ({BLOCKLIST}); the training runtime "
            f"that honours it is not ported: ROADMAP queue 1 item 2")


def _ckpt_config(args):
    from repro_torch.config import CheckpointConfig
    return CheckpointConfig(every=args.ckpt_every, keep=args.ckpt_keep,
                            async_=not args.ckpt_sync, writers=args.ckpt_writers or 1,
                            quorum=args.ckpt_quorum or None, verify=not args.ckpt_no_verify)


def _ckpt_report(state, mgr, start, restore_s) -> dict:
    """What the run's checkpoints cost: the restored step and its seconds,
    each boundary save's stall, each published write (step, host-clock
    start and end, bytes), each step's start on the host clock."""
    return {"start": start, "restore_s": restore_s, "save_s": state.get("save_s", []),
            "writes": list(mgr.writes) if mgr is not None else [],
            "step_t0": state.get("step_t0", [])}


def run(args, log_fn=print) -> dict:
    """Train as ``args`` describe; returns the run's history and times."""
    _check_ckpt_args(args)
    if args.data * args.mx * args.my > 1:
        return run_grid(args, log_fn=log_fn)
    import torch
    from repro_torch import resolve_device
    from repro_torch.checkpoint.manager import make_manager
    from repro_torch.config import ParallelConfig, RunConfig
    from repro_torch.data.synthetic import Prefetcher, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import loop as train_loop
    from repro_torch.train import step as TS

    dev = resolve_device(args.device)
    cfg = _config(args)
    rc = RunConfig("custom", "train", args.seq, args.batch, lr=args.lr)
    pcfg = ParallelConfig(microbatches=args.microbatches)
    t0 = time.perf_counter()
    params, opt_state = TS.init_train_state(cfg, device=dev)
    ccfg = _ckpt_config(args)
    ckpt = make_manager(args.ckpt_dir, ccfg) if args.ckpt_dir else None
    start, restore_s = 0, None
    if ckpt is not None and ckpt.latest_step() is not None:
        t1 = time.perf_counter()
        restored, start = ckpt.restore({"params": params, "opt_state": opt_state})
        params, opt_state = restored["params"], restored["opt_state"]
        for _, t in lm.flatten(params):
            t.requires_grad_(True)
        restore_s = time.perf_counter() - t1
        log_fn(f"restored checkpoint at step {start}")
    step = TS.build_train_step(cfg, pcfg, rc, compute_dtype=getattr(torch, args.dtype))
    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    it = Prefetcher((ds.batch_at(s) for s in itertools.count(start)), device=dev)
    setup_s = time.perf_counter() - t0
    state = {"params": params, "opt_state": opt_state}
    try:
        state = train_loop.train(step, state, it, start_step=start, num_steps=args.steps,
                                 ckpt=ckpt, ckpt_every=ccfg.every, log_fn=log_fn)
    finally:
        it.close()
        if ckpt is not None:
            ckpt.close()                 # train() already drained the saves in flight
    h = state["history"]
    if h:
        log_fn(f"final loss {h[-1][1]:.4f} (first {h[0][1]:.4f})")
    return {"cfg": cfg, "history": h, "step_s": state["step_s"], "setup_s": setup_s,
            "tokens_per_step": args.batch * args.seq, "state": state,
            "ckpt": _ckpt_report(state, ckpt, start, restore_s)}


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

def _config(args):
    from repro_torch.config import get_config, get_smoke_config
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    return cfg.scaled(num_layers=args.layers) if args.layers else cfg


def _check_grid_args(args) -> None:
    from repro_torch.core import overlap as OV
    from repro_torch.core import quant as Q
    if args.strategy != "hecaton":
        raise NotImplementedError(f"strategy {args.strategy!r} is not ported (ROADMAP queue 1)")
    OV.check_mode(args.overlap)
    Q.check_comm_dtype(args.comm_dtype)


def run_grid(args, log_fn=print, check_plain: bool = False) -> dict:
    """Spawn the grid's ranks and train; returns rank 0's history, grad
    norms and times with every rank's kernel launches and rank 0's route
    table.  ``check_plain`` first has every rank train the same steps from
    the same parameters through the plain versions on the grid (their
    losses and grad norms, and how far the kernels' final parameters lie
    from the plain run's), and rank 0 compute the first batch's loss
    through the single-device path on the full parameters."""
    from repro_torch import resolve_device
    from repro_torch.parallel import comm

    _check_grid_args(args)
    _check_ckpt_args(args)
    if check_plain and args.ckpt_dir:
        raise ValueError("check_plain trains from the initial parameters: no --ckpt-dir")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()                       # once, before the ranks start
    world = args.data * args.mx * args.my
    opts = dict(vars(args), check_plain=check_plain)
    t0 = time.perf_counter()
    results = comm.run_ranks(_grid_rank, world, (opts, comm.temp_init_file()), args.timeout)
    for line in results[0]["log"]:
        log_fn(line)
    r0 = results[0]
    cfg = _config(args)
    h = r0["history"]
    if h:
        log_fn(f"grid[{args.data}x{args.mx}x{args.my}] final loss {h[-1][1]:.4f} "
               f"(first {h[0][1]:.4f})")
    return {"cfg": cfg, "history": h, "grad_norms": r0["grad_norms"],
            "step_s": r0["step_s"], "setup_s": r0["setup_s"],
            "tokens_per_step": args.batch * args.seq, "routes": r0["routes"],
            "launches": {r: results[r]["launches"] for r in sorted(results)},
            "checks": r0["checks"], "world": world, "ckpt": r0["ckpt"],
            "wall_s": time.perf_counter() - t0}


def _grid_rank(rank: int, opts: dict, init_file: str) -> dict:
    import numpy as np
    import torch
    from repro_torch import resolve_device
    from repro_torch.checkpoint import grid as CG
    from repro_torch.checkpoint.manager import make_manager
    from repro_torch.config import ParallelConfig, RunConfig
    from repro_torch.core import overlap as OV
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Grid
    from repro_torch.models import lm
    from repro_torch.parallel import comm, specs
    from repro_torch.train import loop as train_loop
    from repro_torch.train import step as TS

    a = argparse.Namespace(**opts)
    dev = resolve_device(a.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    grid = Grid(a.data, a.mx, a.my, rank)
    t0 = time.perf_counter()
    w = comm.init_world(grid, device=dev, init_file=init_file)
    try:
        dev = w.device
        cfg = _config(a)
        dtype = getattr(torch, a.dtype)
        rc = RunConfig("custom", "train", a.seq, a.batch, lr=a.lr)
        pcfg = ParallelConfig(data=a.data, mx=a.mx, my=a.my, overlap=a.overlap,
                              comm_dtype=a.comm_dtype, microbatches=a.microbatches)
        full = lm.init_master_params(cfg, seed=0, device=dev)
        params = specs.shard_tree(full, specs.param_specs(full, grid), grid)
        for _, t in lm.flatten(params):
            t.requires_grad_(True)
        ds = SyntheticLM(cfg.vocab_size, a.seq, a.batch)

        def local(step):
            lb = specs.local_batch(ds.batch_at(step), grid, a.microbatches)
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
        opt_state = TS.init_grid_opt_state(params, grid, pcfg)
        state = {"params": params, "opt_state": opt_state}
        del params, opt_state
        ccfg = _ckpt_config(a)
        ckpt, mgr, start, restore_s, lines = None, None, 0, None, []
        if a.ckpt_dir:
            # rank 0 writes (and names the step to restore); every rank reads
            mgr = make_manager(a.ckpt_dir, ccfg) if rank == 0 else None
            t1 = time.perf_counter()
            state, start = CG.restore(a.ckpt_dir, state, grid, pcfg, mgr, ccfg.verify)
            if start:
                restore_s = time.perf_counter() - t1
                lines.append(f"restored checkpoint at step {start}")
            ckpt = CG.GridCheckpointer(mgr, grid, pcfg)
        kstep = TS.build_train_step(cfg, pcfg, rc, compute_dtype=dtype, mesh=grid)
        grad_norms = []

        def step(p, o, b):
            p, o, m = kstep(p, o, b)
            grad_norms.append(float(m["grad_norm"]))
            return p, o, m

        setup_s = time.perf_counter() - t0
        ops.reset_launches()
        OV.clear_routes()
        try:
            state = train_loop.train(step, state, (local(s) for s in itertools.count(start)),
                                     start_step=start, num_steps=a.steps, ckpt=ckpt,
                                     ckpt_every=ccfg.every, log_fn=lines.append)
        finally:
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
        comm.barrier()
        return {"history": state["history"], "grad_norms": grad_norms,
                "step_s": state["step_s"], "setup_s": setup_s,
                "launches": launches, "routes": OV.route_table(), "checks": checks,
                "ckpt": _ckpt_report(state, mgr, start, restore_s), "log": lines}
    finally:
        comm.shutdown()


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
