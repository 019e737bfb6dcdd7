"""Serving launcher: continuous-batching decode over the paged cache pool.

Counterpart of ``repro/launch/serve.py``, with the same flags and report:
a synthetic arrival trace (more requests than slots, mixed prompt lengths)
runs after a warm-up, and prefill latency and decode tok/s are reported
separately.  ``--device`` defaults to ``cuda`` (the CUDA kernels);
``--device cpu`` runs the plain PyTorch versions.  The dense archs and
``mamba2-130m`` (the ssm family, prompts at their exact lengths) serve.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --dtype bfloat16 --slots 4 --requests 8 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --dtype bfloat16 --prompt-lens 64,200,512 --gen 32
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
    return ap


def run(args) -> dict:
    """Serve the trace that ``args`` describe; returns the report's numbers."""
    import numpy as np
    import torch
    from repro_torch.config import get_config, get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serve.cache import PoolConfig, blocks_for, dense_cache_bytes
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
                       top_p=args.top_p, seed=args.seed)
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
    }


def main(argv=None):
    args = parser().parse_args(argv)
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
    for rid in sorted(r["finished"])[:4]:
        f = r["finished"][rid]
        print(f"  rid={rid} plen={f.prompt_len} {f.reason:7s} tokens={f.tokens[:10]}")


if __name__ == "__main__":
    main()
