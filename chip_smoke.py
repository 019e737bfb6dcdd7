#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one H100; exits non-zero on any failure

Phases, each fatal on failure:

1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   (one process per source, in parallel) and print the seconds; print the
   card's name and power limit as nvidia-smi reports them;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (qwen3-0.6b at full width), in fp32 and
   bf16, with the tolerance and its reason; time the kernel, the plain
   version and, where one PyTorch call computes the same function, that
   call (a yardstick only: the port never calls it), beside the least time
   the card could take (bytes over 3.35 TB/s or operations over the peak);
3. serve full-width qwen3-0.6b in bf16 (random weights from a seed, made on
   the card) through the port's serving entry point, after checking that
   one prompt's prefill logits through the kernels match the plain-op
   forward; the kernels' launch counts are zeroed just before the serving
   run and read just after, and each must be > 0;
4. print one JSON line of per-kernel numbers, then the result line.

``--profile`` also traces decode ticks with torch.profiler and prints the
device's busy share and its time per kernel.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import matmul as kmm  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel.context import PCtx  # noqa: E402
from repro_torch.serve.cache import CachePool, PoolConfig  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,             # dense bf16 tensor cores
            torch.float32: 67e12}               # fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
TOL = {torch.float32: (2e-4, "fp32 sums in another order; the repo's fp32 bound"),
       torch.bfloat16: (2e-2, "one bf16 rounding of the output (2^-8 relative); "
                              "the repo's bf16 bound")}
ARCH = "qwen3-0.6b"
SLOTS, BLOCK, REQUESTS, GEN = 4, 16, 8, 32
PROMPT_LENS = (64, 256, 512)
SEED = 0
DEV = "cuda"
KERNELS = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:90"),
    "gated_matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                     "src/repro/kernels/matmul.py:132"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:84"),
}


def log(*a):
    print(*a, flush=True)


def bench_ms(calls, reps=10):
    """Device ms per call over a cycle of ``calls`` (each on its own inputs,
    so that together they exceed the L2 cache).  The cycle is captured in a
    CUDA graph and replayed between CUDA events, so the host's launch cost
    (larger than a small kernel's run time on this machine) is not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up, as graph capture needs
        for c in calls[:3]:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def n_copies(nbytes):
    return int(min(32, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))))


def bound(nbytes, nops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)


def record(results, kernel, case, dtype, main, out, want, kern_calls, plain_calls,
           lib_calls, nbytes, nops):
    tol, why = TOL[dtype]
    err = (out.float() - want.float()).abs().max().item()
    ok = bool(torch.allclose(out.float(), want.float(), atol=tol, rtol=tol)) and \
        bool(torch.isfinite(out.float()).all())
    b_ms, b_by = bound(nbytes, nops, dtype)
    r = dict(kernel=kernel, case=case, dtype=str(dtype).replace("torch.", ""),
             main=main, max_err=err, tol=tol, reason=why, ok=ok,
             kernel_ms=bench_ms(kern_calls), plain_ms=bench_ms(plain_calls),
             library_ms=bench_ms(lib_calls) if lib_calls else None,
             bound_ms=b_ms, bound_by=b_by)
    results.append(r)
    log("case " + json.dumps(r))
    return ok


def check_matmul(results, gen, M, K, N, dtype, *, gated=False, act="none",
                 bias=False, main=True):
    elt = torch.tensor([], dtype=dtype).element_size()
    nw = 2 if gated else 1
    nbytes = (M * K + nw * K * N + M * N + (N if bias else 0)) * elt
    sets = []
    for _ in range(n_copies(nbytes)):
        x = randn(gen, (M, K), dtype)
        ws = [randn(gen, (K, N), dtype, K ** -0.5) for _ in range(nw)]
        b = randn(gen, (N,), dtype) if bias else None
        sets.append((x, ws, b))
    x, ws, b = sets[0]
    if gated:
        kern = lambda s: kmm.gated_matmul(s[0], *s[1], act=act)
        plain = lambda s: ref.gated_matmul_plain(s[0], *s[1], act=act)
        lib = None
    else:
        kern = lambda s: kmm.matmul(s[0], s[1][0], s[2], act=act)
        plain = lambda s: ref.matmul_plain(s[0], s[1][0], s[2], act=act)
        lib = (lambda s: torch.matmul(s[0], s[1][0])) if (act == "none" and not bias) \
            else None
    name = "gated_matmul" if gated else "matmul"
    case = f"M={M} K={K} N={N} act={act}" + (" bias" if bias else "")
    return record(results, name, case, dtype, main, kern(sets[0]), plain(sets[0]),
                  [lambda s=s: kern(s) for s in sets],
                  [lambda s=s: plain(s) for s in sets],
                  [lambda s=s: lib(s) for s in sets] if lib else None,
                  nbytes, nw * 2 * M * K * N)


def sdpa_mask(B, Sq, Sk, q_off, kv_len, device):
    kpos = torch.arange(Sk, device=device)
    qpos = q_off[:, None] + torch.arange(Sq, device=device)[None, :]
    m = (kpos[None, None, :] <= qpos[:, :, None]) & \
        (kpos[None, None, :] < kv_len[:, None, None])
    return m[:, None]                                   # [B,1,Sq,Sk]


def check_attention(results, gen, B, nh, nkv, dh, Sq, Sk, q_off, kv_len, dtype, *,
                    main=True, label=""):
    elt = torch.tensor([], dtype=dtype).element_size()
    qo = torch.tensor(q_off, dtype=torch.int32, device=DEV)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=DEV)
    # data-dependent work: visible (query, key) pairs and the K/V rows read
    pairs = sum(min(kv_len[b], q_off[b] + i + 1) for b in range(B) for i in range(Sq))
    kv_rows = sum(min(kv_len[b], q_off[b] + Sq) for b in range(B))
    nbytes = (2 * B * Sq * nh * dh + 2 * kv_rows * nkv * dh) * elt
    nops = 4 * pairs * nh * dh
    sets = []
    for _ in range(n_copies(B * Sk * nkv * dh * 2 * elt)):
        # the model's layout: [B, S, heads, dh], handed over as transposed views
        q = randn(gen, (B, Sq, nh, dh), dtype).transpose(1, 2)
        k = randn(gen, (B, Sk, nkv, dh), dtype).transpose(1, 2)
        v = randn(gen, (B, Sk, nkv, dh), dtype).transpose(1, 2)
        sets.append((q, k, v))
    mask = sdpa_mask(B, Sq, Sk, qo, kl, DEV)
    kern = lambda s: kfa.flash_attention(*s, causal=True, q_offset=qo, kv_len=kl)
    plain = lambda s: ref.attention_plain(*s, causal=True, q_offset=qo, kv_len=kl)
    lib = lambda s: F.scaled_dot_product_attention(*s, attn_mask=mask, enable_gqa=True)
    case = f"{label} B={B} nh={nh} nkv={nkv} dh={dh} Sq={Sq} Sk={Sk}"
    return record(results, "flash_attention", case, dtype, main, kern(sets[0]),
                  plain(sets[0]), [lambda s=s: kern(s) for s in sets],
                  [lambda s=s: plain(s) for s in sets],
                  [lambda s=s: lib(s) for s in sets], nbytes, nops)


def kernel_phase(cfg):
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    nh, nkv, F_ = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    # (K, N) of every projection on the path; head N is the padded vocab
    proj = [(d, nh * dh), (d, nkv * dh), (nh * dh, d), (F_, d), (d, cfg.padded_vocab)]
    max_seq = max(PROMPT_LENS) + GEN
    Sk = -(-max_seq // BLOCK) * BLOCK                 # gathered page view
    results, ok = [], True
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16                # the serving dtype
        for M in (SLOTS, max(PROMPT_LENS)):           # decode tick, longest prefill
            for K, N in proj:
                ok &= check_matmul(results, gen, M, K, N, dtype, main=main)
            ok &= check_matmul(results, gen, M, d, F_, dtype, gated=True, act="silu",
                               main=main)
        lens = [63, 300, 511, 0]                      # per-slot lengths, one idle
        ok &= check_attention(results, gen, SLOTS, nh, nkv, dh, 1, Sk, lens,
                              [n + 1 for n in lens], dtype, main=main, label="decode")
        for P in PROMPT_LENS:
            ok &= check_attention(results, gen, 1, nh, nkv, dh, P, Sk, [0], [P], dtype,
                                  main=main, label="prefill")
    # off-path coverage: ragged M, the other epilogues, a continued prefill, dh=64
    ok &= check_matmul(results, gen, 100, d, 2 * d, torch.bfloat16, main=False)
    for act in ("gelu", "relu2", "silu"):
        ok &= check_matmul(results, gen, 256, d, d, torch.bfloat16, act=act, bias=True,
                           main=False)
        ok &= check_matmul(results, gen, SLOTS, d, d, torch.float32, act=act, bias=True,
                           main=False)
    ok &= check_matmul(results, gen, 77, d, F_, torch.bfloat16, gated=True, act="gelu",
                       main=False)
    ok &= check_attention(results, gen, 1, nh, nkv, dh, 64, Sk, [100], [164],
                          torch.bfloat16, main=False, label="continued-prefill")
    ok &= check_attention(results, gen, 2, 8, 2, 64, 128, 128, [0, 0], [128, 97],
                          torch.float32, main=False, label="dh64")
    return results, ok


def model_check(cfg):
    """One prompt's prefill logits: the kernel forward against the plain-op
    forward in bf16, and both against the plain fp32 forward."""
    plen = PROMPT_LENS[1]
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(1, plen))).to(DEV)
    logits = {}
    for name, dtype, plain in (("kernel", torch.bfloat16, False),
                               ("plain", torch.bfloat16, True),
                               ("plain_fp32", torch.float32, True)):
        # same seed: the bf16 weights are the fp32 ones rounded
        params = lm.init_params(cfg, seed=SEED, device=DEV, dtype=dtype)
        pool = CachePool(cfg, PoolConfig(1, BLOCK, plen // BLOCK + 1, plen), device=DEV,
                         dtype=dtype)
        slot = pool.admit(plen)
        with torch.inference_mode():
            out = lm.forward(PCtx(plain=plain), cfg, params,
                             {"tokens": toks, "_dtype": dtype},
                             caches=pool.prefill_tree(slot))
        logits[name] = out.logits.float()
        del params, pool, out
        torch.cuda.empty_cache()
    rel = lambda a, b: ((logits[a] - logits[b]).norm() / logits[b].norm()).item()
    err = (logits["kernel"] - logits["plain"]).abs().max().item()
    r_kp, r_k32, r_p32 = rel("kernel", "plain"), rel("kernel", "plain_fp32"), \
        rel("plain", "plain_fp32")
    # bf16 activations are rounded after every op, and the two bf16 paths
    # round differently where their fp32 sums (in another order) straddle a
    # rounding boundary; over 28 layers of ~10 roundings each that random
    # walk reaches about 2^-9 * sqrt(280) = 3.3e-2 relative, so the bf16
    # paths are held to 5e-2 of each other, and the kernel path must be as
    # close to the fp32 forward as the plain bf16 path is (25% margin)
    ok = (bool(torch.isfinite(logits["kernel"]).all()) and r_kp <= 5e-2
          and r_k32 <= 1.25 * r_p32 + 1e-3)
    log("model_check " + json.dumps(dict(
        prompt=plen, max_abs_err=err, rel_kernel_vs_plain=r_kp,
        rel_kernel_vs_fp32=r_k32, rel_plain_vs_fp32=r_p32, tol_rel=5e-2, ok=ok)))
    return ok


def serve_phase(profile):
    args = launch_serve.parser().parse_args([
        "--arch", ARCH, "--dtype", "bfloat16", "--device", DEV,
        "--slots", str(SLOTS), "--block", str(BLOCK), "--requests", str(REQUESTS),
        "--prompt-lens", ",".join(map(str, PROMPT_LENS)), "--gen", str(GEN),
        "--seed", str(SEED)])
    ops.reset_launches()
    r = launch_serve.run(args)                    # the main path
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    fin = r["finished"]
    vocab = get_config(ARCH).padded_vocab
    ok = (len(fin) == REQUESTS
          and all(len(f.tokens) == GEN and all(0 <= t < vocab for t in f.tokens)
                  for f in fin.values())
          and all(n > 0 for n in launches.values()))
    keys = ("sequences", "ticks", "preemptions", "prefill_ms_mean", "prefill_ms_max",
            "decode_tokens", "decode_s", "decode_tok_s", "peak_blocks",
            "dense_equiv_blocks", "paged_peak_bytes", "dense_cache_bytes", "warmup_s")
    log("serve " + json.dumps({k: r[k] for k in keys}))
    log("kernels " + json.dumps(launches))
    if profile:
        profile_decode(r["engine"])
    return ok, launches


def profile_decode(eng):
    """Device time per kernel, and the device's busy share, over decode
    ticks of a fresh 4-request trace."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    reqs = launch_serve.build_trace(np.random.default_rng(1), SLOTS,
                                    eng.cfg.vocab_size, [PROMPT_LENS[0]], 16, SLOTS)
    for q in reqs:
        eng.submit(q)
    eng.step()                                    # admissions + first tick
    ticks = 8
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    summary = dict(ticks=ticks, wall_ms_per_tick=1e3 * wall / ticks,
                   device_ms_per_tick=dev_us / 1e3 / ticks,
                   device_busy_share=dev_us / 1e6 / wall)
    log("profile " + json.dumps(summary))
    log(events.table(sort_by="self_device_time_total", row_limit=25))
    while eng.queue or eng.running:
        eng.step()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace decode ticks with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build {time.perf_counter() - t0:.2f}s " +
        json.dumps({k: v.strip()[-400:] for k, v in logs.items()}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         check=True, capture_output=True, text=True).stdout.strip()

    cfg = get_config(ARCH)
    results, ok_k = kernel_phase(cfg)
    ok_m = model_check(cfg)
    ok_s, launches = serve_phase(args.profile)

    line = []
    for name, (src, replaces) in KERNELS.items():
        rows = [r for r in results if r["kernel"] == name and r["main"]]
        libs = [r["library_ms"] for r in rows]
        b_by = {}
        for r in rows:
            b_by[r["bound_by"]] = b_by.get(r["bound_by"], 0.0) + r["bound_ms"]
        line.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_err"] for r in rows),
            "ms": sum(r["kernel_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(b_by, key=b_by.get),
            "library_ms": None if None in libs else sum(libs),
        })
    failed = [n for n, ok in (("kernels", ok_k), ("model_check", ok_m), ("serve", ok_s))
              if not ok]
    if failed:
        print("chip_smoke: failed phases: " + ", ".join(failed), file=sys.stderr)
        return 1
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
