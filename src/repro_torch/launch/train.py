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

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --dtype bfloat16 --steps 20 --batch 8 --seq 512 --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --dtype bfloat16 --strategy hecaton --data 1 --mx 2 --my 2 --overlap fused \\
        --comm-dtype int8
"""

from __future__ import annotations

import argparse
import time

from repro_torch.config import COMM_DTYPES, OVERLAP_MODES

DTYPES = ("float32", "bfloat16")


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
    return ap


def run(args, log_fn=print) -> dict:
    """Train as ``args`` describe; returns the run's history and times."""
    if args.data * args.mx * args.my > 1:
        return run_grid(args, log_fn=log_fn)
    import torch
    from repro_torch import resolve_device
    from repro_torch.config import ParallelConfig, RunConfig
    from repro_torch.data.synthetic import Prefetcher, SyntheticLM
    from repro_torch.train import loop as train_loop
    from repro_torch.train import step as TS

    dev = resolve_device(args.device)
    cfg = _config(args)
    rc = RunConfig("custom", "train", args.seq, args.batch, lr=args.lr)
    pcfg = ParallelConfig(microbatches=args.microbatches)
    t0 = time.perf_counter()
    params, opt_state = TS.init_train_state(cfg, device=dev)
    step = TS.build_train_step(cfg, pcfg, rc, total_steps=args.steps,
                               compute_dtype=getattr(torch, args.dtype))
    it = Prefetcher(iter(SyntheticLM(cfg.vocab_size, args.seq, args.batch)), device=dev)
    setup_s = time.perf_counter() - t0
    state = {"params": params, "opt_state": opt_state}
    try:
        state = train_loop.train(step, state, it, num_steps=args.steps, log_fn=log_fn)
    finally:
        it.close()
    h = state["history"]
    log_fn(f"final loss {h[-1][1]:.4f} (first {h[0][1]:.4f})")
    return {"cfg": cfg, "history": h, "step_s": state["step_s"], "setup_s": setup_s,
            "tokens_per_step": args.batch * args.seq, "state": state}


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
    log_fn(f"grid[{args.data}x{args.mx}x{args.my}] final loss {h[-1][1]:.4f} "
           f"(first {h[0][1]:.4f})")
    return {"cfg": cfg, "history": h, "grad_norms": r0["grad_norms"],
            "step_s": r0["step_s"], "setup_s": r0["setup_s"],
            "tokens_per_step": args.batch * args.seq, "routes": r0["routes"],
            "launches": {r: results[r]["launches"] for r in sorted(results)},
            "checks": r0["checks"], "world": world,
            "wall_s": time.perf_counter() - t0}


def _grid_rank(rank: int, opts: dict, init_file: str) -> dict:
    import numpy as np
    import torch
    from repro_torch import resolve_device
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
            pstep = TS.build_train_step(cfg, pcfg, rc, total_steps=a.steps,
                                        compute_dtype=dtype, mesh=grid, plain=True)
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
        kstep = TS.build_train_step(cfg, pcfg, rc, total_steps=a.steps, compute_dtype=dtype,
                                    mesh=grid)
        grad_norms = []

        def step(p, o, b):
            p, o, m = kstep(p, o, b)
            grad_norms.append(float(m["grad_norm"]))
            return p, o, m

        def stream():
            s = 0
            while True:
                yield local(s)
                s += 1
        setup_s = time.perf_counter() - t0
        lines = []
        ops.reset_launches()
        OV.clear_routes()
        state = train_loop.train(step, {"params": params, "opt_state": opt_state}, stream(),
                                 num_steps=a.steps, log_fn=lines.append)
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
                "log": lines}
    finally:
        comm.shutdown()


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
