"""Training launcher, single device.

Counterpart of ``repro/launch/train.py`` without a mesh (its
``mesh is None`` path): synthetic data through the prefetcher, the
microbatched step (``train/step.py``) folded by ``train/loop.py``, the
final loss printed as the JAX launcher prints it (remat ``fusion`` and
bf16 gradient rounding, the JAX defaults).  ``--device`` defaults
to ``cuda`` (the CUDA kernels); ``--device cpu`` runs the plain PyTorch
versions.  Like the JAX launcher on one device, compute defaults to fp32;
``--dtype bfloat16`` computes in bf16 over the fp32 masters.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --dtype bfloat16 --steps 20 --batch 8 --seq 512 --microbatches 2
"""

from __future__ import annotations

import argparse
import time

DTYPES = ("float32", "bfloat16")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (kernels) or cpu")
    ap.add_argument("--dtype", default="float32", choices=DTYPES,
                    help="compute dtype (masters stay fp32)")
    return ap


def run(args, log_fn=print) -> dict:
    """Train as ``args`` describe; returns the run's history and times."""
    import torch
    from repro_torch import resolve_device
    from repro_torch.config import ParallelConfig, RunConfig, get_config, get_smoke_config
    from repro_torch.data.synthetic import Prefetcher, SyntheticLM
    from repro_torch.train import loop as train_loop
    from repro_torch.train import step as TS

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
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


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
