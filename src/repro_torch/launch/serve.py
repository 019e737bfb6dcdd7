"""Serving launcher: continuous-batching decode over the paged cache pool.

Counterpart of ``repro/launch/serve.py``, with the same flags and report:
a synthetic arrival trace (more requests than slots, mixed prompt lengths)
runs after a warm-up, and prefill latency and decode tok/s are reported
separately.  ``--device`` defaults to ``cuda`` (the CUDA kernels);
``--device cpu`` runs the plain PyTorch versions.  The dense archs,
``minicpm3-4b`` (MLA: latent caches, the absorbed decode kernel) and
``mamba2-130m`` (the ssm family, prompts at their exact lengths) serve.
``--quant-kv`` keeps the paged K/V as int8 with fp32 row scales and
prints one block's bytes beside the compute dtype's arena's.

``--data D --mx X --my Y`` (any of them > 1) serves on the rank grid
instead: D*X*Y rank processes (as the training launcher spawns them;
on a one-card machine they share card 0), each holding its blocks of
the seeded parameters (``serve/step.grid_params``; not MLA), prefill a batch of
``--slots`` prompts of the longest ``--prompt-lens`` length into sharded
dense caches (``serve/step.build_prefill``: hecaton's dataflow, the ring
kernels under ``--overlap fused``) and decode ``--gen`` tokens greedily
(``build_decode_step``: the 1D layout over the model axes).  The paged
engine does not run on a grid.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --mx 1 --my 2 --prompt-lens 16 --gen 8

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --dtype bfloat16 --slots 4 --requests 8 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --dtype bfloat16 --prompt-lens 64,200,512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b \
        --dtype bfloat16 --prompt-lens 64,256,512 --gen 32 [--quant-kv]
"""

from __future__ import annotations

import argparse
import time

DTYPES = ("float32", "bfloat16")


def build_trace(rng, n_requests, vocab, prompt_lens, gen, arrival_every):
    """Deterministic synthetic arrival trace with mixed prompt lengths."""
    import numpy as np
    from repro_torch.serve.engine import Request
    reqs = []
    for i in range(n_requests):
        plen = prompt_lens[i % len(prompt_lens)]
        prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=gen,
                            arrival=i // max(1, arrival_every)))
    return reqs


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4, help="decode slots")
    ap.add_argument("--block", type=int, default=16, help="tokens per KV pool block")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="pool blocks incl. the null block (0 = auto)")
    ap.add_argument("--max-seq", type=int, default=0,
                    help="per-sequence prompt+gen cap (0 = auto)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="new arrivals per engine tick")
    ap.add_argument("--prompt-lens", default="8,24,16",
                    help="comma list cycled over the trace")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop generation at this token id (-1 = off)")
    ap.add_argument("--sample", default="greedy",
                    choices=["greedy", "temperature", "top_p"])
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (kernels) or cpu")
    ap.add_argument("--dtype", default="float32", choices=DTYPES,
                    help="compute and weight dtype")
    ap.add_argument("--quant-kv", action="store_true",
                    help="store paged K/V as int8 + per-row fp32 scales "
                         "(docs/DESIGN.md §11)")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--mx", type=int, default=1)
    ap.add_argument("--my", type=int, default=1)
    ap.add_argument("--overlap", default="none", choices=("none", "ring", "bidir", "fused"),
                    help="the grid's collectives (fused: the ring kernels)")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="seconds before a grid run is stopped as hung (0: none)")
    return ap


def run(args) -> dict:
    """Serve the trace that ``args`` describe; returns the report's numbers."""
    if args.data * args.mx * args.my > 1:
        return run_grid(args)
    import numpy as np
    import torch
    from repro_torch.config import get_config, get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serve.cache import CachePool, PoolConfig, blocks_for, dense_cache_bytes
    from repro_torch.serve.engine import DecodeEngine

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dtype = getattr(torch, args.dtype)
    prompt_lens = [int(x) for x in args.prompt_lens.split(",") if x]
    max_seq = args.max_seq or max(prompt_lens) + args.gen
    num_blocks = args.num_blocks or args.slots * blocks_for(max_seq, args.block) + 1
    pool = PoolConfig(slots=args.slots, block=args.block, num_blocks=num_blocks,
                      max_seq=max_seq)
    params = lm.init_params(cfg, seed=args.seed, device=args.device, dtype=dtype)
    eng = DecodeEngine(cfg, params, pool, device=args.device, compute_dtype=dtype,
                       eos_id=None if args.eos_id < 0 else args.eos_id,
                       method=args.sample, temperature=args.temperature,
                       top_p=args.top_p, seed=args.seed, quant_kv=args.quant_kv)
    t0 = time.perf_counter()
    eng.warmup(prompt_lens=prompt_lens)
    warm_s = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed)
    reqs = build_trace(rng, args.requests, cfg.vocab_size, prompt_lens, args.gen,
                       args.arrival_every)
    fin = eng.run(reqs)
    pf = eng.stats["prefill_s"]
    dec_s = max(eng.stats["decode_s"], 1e-9)
    return {
        "engine": eng, "finished": fin, "warmup_s": warm_s,
        "sequences": len(fin), "ticks": eng.stats["decode_ticks"],
        "preemptions": eng.stats["preemptions"],
        "prefill_ms_mean": 1e3 * sum(pf) / max(1, len(pf)),
        "prefill_ms_max": 1e3 * max(pf),
        "decode_tokens": eng.stats["decode_tokens"], "decode_s": dec_s,
        "decode_tok_s": eng.stats["decode_tokens"] / dec_s,
        "peak_blocks": eng.pool.peak_blocks_in_use,
        "leasable_blocks": pool.leasable_blocks,
        "dense_equiv_blocks": pool.dense_equiv_blocks,
        "dense_cache_bytes": dense_cache_bytes(cfg, args.slots, max_seq, dtype),
        "paged_peak_bytes": eng.pool.paged_bytes_peak(),
        "block_bytes": eng.pool.block_bytes,
        # one block of the compute dtype's arena, the int8 pool's yardstick
        "dense_block_bytes": CachePool(cfg, PoolConfig(1, args.block, 2, args.block),
                                       device="meta", dtype=dtype).block_bytes,
    }


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

def run_grid(args, teacher=None, keep_logits: bool = False) -> dict:
    """Serve one batch on the rank grid (module docstring).  ``teacher``
    ([slots, gen] token ids) feeds decode tick i token ``teacher[:, i]``
    instead of the greedy one, so every tick's logits can be held against
    another path's; ``keep_logits`` returns each rank's logits of the
    prefill and of every tick.  Returns the tokens of every row, the
    prefill's and the ticks' seconds, each rank's kernel launches in
    prefill and in decode, and its prefill's ring launches by route
    (``ring_paths``)."""
    import numpy as np
    from repro_torch import resolve_device
    from repro_torch.config import get_config, get_smoke_config
    from repro_torch.parallel import comm
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.mla:
        raise NotImplementedError(f"MLA ({cfg.name}) does not serve on the rank grid; it serves "
                                  "on one device")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()                       # once, before the ranks start
    world = args.data * args.mx * args.my
    t0 = time.perf_counter()
    res = comm.run_ranks(_grid_rank, world, (vars(args), teacher, keep_logits,
                                             comm.temp_init_file()), args.timeout)
    rows = [res[r] for r in sorted(res) if res[r]["model_index"] == 0]
    r0 = res[0]
    return {"tokens": np.concatenate([r["tokens"] for r in rows]),
            "prefill_s": r0["prefill_s"], "decode_s": r0["decode_s"],
            "decode_tok_s": args.slots * (args.gen - 1) / max(r0["decode_s"], 1e-9),
            "launches": {r: {"prefill": res[r]["prefill_launches"],
                             "decode": res[r]["decode_launches"]} for r in sorted(res)},
            "ring_paths": {r: res[r]["prefill_ring_paths"] for r in sorted(res)},
            "logits": {r: res[r]["logits"] for r in sorted(res)} if keep_logits else None,
            "rows": {r: res[r]["rows"] for r in sorted(res)},
            "world": world, "wall_s": time.perf_counter() - t0}


def _grid_rank(rank: int, opts: dict, teacher, keep_logits: bool, init_file: str) -> dict:
    import numpy as np
    import torch
    from repro_torch import resolve_device
    from repro_torch.config import ParallelConfig, RunConfig, get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ring_matmul as RM
    from repro_torch.launch.mesh import MODEL, Grid
    from repro_torch.models import lm
    from repro_torch.parallel import comm, specs
    from repro_torch.serve import step as SRV

    a = argparse.Namespace(**opts)
    dev = resolve_device(a.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    grid = Grid(a.data, a.mx, a.my, rank)
    w = comm.init_world(grid, device=dev, init_file=init_file)
    try:
        dev = w.device
        cfg = get_smoke_config(a.arch) if a.smoke else get_config(a.arch)
        dtype = getattr(torch, a.dtype)
        pcfg = ParallelConfig(data=a.data, mx=a.mx, my=a.my, overlap=a.overlap)
        plen = max(int(x) for x in a.prompt_lens.split(",") if x)
        rc = RunConfig("serve", "decode", plen + a.gen, a.slots)
        params = SRV.grid_params(lm.init_master_params(cfg, seed=a.seed, device=dev), grid,
                                 pcfg, dtype)
        prompts = np.random.default_rng(a.seed).integers(0, cfg.vocab_size,
                                                         size=(a.slots, plen))
        lb = specs.local_batch({"tokens": prompts}, grid)
        nd, di = grid.data, grid.coords["data"]
        rows = slice(di * a.slots // nd, (di + 1) * a.slots // nd)
        prefill = SRV.build_prefill(cfg, pcfg, rc, grid, compute_dtype=dtype)
        decode = SRV.build_decode_step(cfg, pcfg, rc, grid, compute_dtype=dtype)
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        kept = []
        with torch.inference_mode():
            ops.reset_launches()
            t0 = time.perf_counter()
            local = torch.from_numpy(np.ascontiguousarray(lb["tokens"])).to(dev)
            pos = torch.arange(plen, device=dev)[None].expand(local.shape[0], plen)
            logits, caches = prefill(params, {"tokens": local, "positions": pos})
            sync()
            prefill_s = time.perf_counter() - t0
            prefill_launches = dict(ops.LAUNCHES)
            prefill_ring_paths = {k: dict(v) for k, v in RM.IMPL_LAUNCHES.items()}
            ops.reset_launches()
            toks = [SRV.greedy_sample(logits)[:, 0].cpu()]
            if keep_logits:
                kept.append(logits.float().cpu().numpy())
            t0 = time.perf_counter()
            for i in range(a.gen - 1):
                tok = (toks[-1] if teacher is None
                       else torch.as_tensor(np.asarray(teacher)[rows, i]))
                pos = torch.full((tok.shape[0], 1), plen + i, dtype=torch.int64, device=dev)
                logits, caches = decode(params, caches, tok[:, None].long().to(dev), pos)
                toks.append(SRV.greedy_sample(logits)[:, 0].cpu())
                if keep_logits:
                    kept.append(logits.float().cpu().numpy())
            sync()
            decode_s = time.perf_counter() - t0
        comm.barrier()
        return {"tokens": torch.stack(toks, dim=1).numpy(), "prefill_s": prefill_s,
                "decode_s": decode_s, "prefill_launches": prefill_launches,
                "decode_launches": dict(ops.LAUNCHES), "logits": kept,
                "prefill_ring_paths": prefill_ring_paths,
                "rows": (rows.start, rows.stop), "model_index": grid.axis_index(MODEL)}
    finally:
        comm.shutdown()


def main(argv=None):
    args = parser().parse_args(argv)
    if args.data * args.mx * args.my > 1:
        r = run_grid(args)
        print(f"grid[{args.data}x{args.mx}x{args.my}] {args.overlap}: "
              f"{args.slots} prompts, prefill {1e3 * r['prefill_s']:.1f} ms, decode "
              f"{r['decode_tok_s']:.1f} tok/s")
        for i, t in enumerate(r["tokens"][:4]):
            print(f"  row={i} tokens={t[:10].tolist()}")
        return
    r = run(args)
    print(f"warmup {r['warmup_s']:.2f}s")
    print(f"{r['sequences']} sequences  ticks={r['ticks']}  "
          f"preemptions={r['preemptions']}")
    print(f"prefill latency  mean {r['prefill_ms_mean']:.1f} ms  "
          f"max {r['prefill_ms_max']:.1f} ms")
    print(f"decode           {r['decode_tokens']} tokens in {r['decode_s']:.2f}s  "
          f"({r['decode_tok_s']:.1f} tok/s)")
    print(f"pool             peak {r['peak_blocks']}/{r['leasable_blocks']} blocks  "
          f"(dense arena equiv {r['dense_equiv_blocks']} blocks / "
          f"{r['dense_cache_bytes']} B)")
    if args.quant_kv:
        print(f"int8 kv          block {r['block_bytes']} B vs {r['dense_block_bytes']} B "
              f"in {args.dtype} ({r['block_bytes'] / r['dense_block_bytes']:.4f})")
    for rid in sorted(r["finished"])[:4]:
        f = r["finished"][rid]
        print(f"  rid={rid} plen={f.prompt_len} {f.reason:7s} tokens={f.tokens[:10]}")


if __name__ == "__main__":
    main()
