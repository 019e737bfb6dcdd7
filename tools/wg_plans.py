"""Time the wgmma matmul (``csrc/matmul.cu``, ``wg::mm``) under each tile
plan at the main path's bf16 products, on the card.

    python3 tools/wg_plans.py          # one H100; prints one JSON line a product

For every product of the one-card training step (the 17 tile-matmul
cases of ``chip_smoke.py``) and every prefill matmul of qwen3-0.6b's
serving (M = 512), each candidate (tile width 128 or 256, K split 1 to 4
ways where each split keeps 4 k-blocks or more and the units stay within
two waves) is forced in place of ``kernels/matmul.wg_plan`` and timed as
``chip_smoke.bench_ms`` times a kernel (a CUDA-graph replay over copies
that exceed the L2 cache), beside ``torch.matmul``.  Each line gives the
times in ms, the fastest candidate and what ``wg_plan`` picks; the rules
of ``wg_plan`` were read off this table.

Then the gate's products (``gated_matmul`` on wgmma, whose tile is 128
wide): the training gate 2048 x 1024 x 3072 keeping its fp32 products,
the prefill gate 512 x 1024 x 3072 and the off-path 77 x 1024 x 3072,
each K split of 1 to 4 ways (``gated`` lines), beside
``torch.matmul(x, [w1 | w1b])``, the two products alone; the gated rule
of ``wg_plan`` was read off these lines.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import matmul as kmm  # noqa: E402

BF = torch.bfloat16


def products():
    """(layout, M, K, N, out dtype): chip_smoke's main-path bf16 cases."""
    d, q, kv, f, v, t = 1024, 2048, 1024, 3072, 152064, cs.TRAIN_M
    out = []
    for k, n in ((d, q), (d, kv), (q, d), (f, d)):
        out += [("NN", t, k, n, BF), ("NT", t, n, k, BF), ("TN", k, t, n, BF)]
    out += [("NT", t, f, d, BF), ("TN", d, t, f, BF), ("NT", t, d, v, torch.float32),
            ("NN", t, v, d, BF), ("TN", d, t, v, BF)]
    out += [("NN", 512, k, n, BF) for k, n in ((d, q), (d, kv), (q, d), (f, d), (d, v))]
    return out


def gated_products():
    """(M, K, N, keep_ab): the gate at training, prefill and off-path M."""
    return [(cs.TRAIN_M, 1024, 3072, True), (512, 1024, 3072, False), (77, 1024, 3072, False)]


def sweep_gated(gen):
    chosen = kmm.wg_plan
    for M, K, N, keep in gated_products():
        nbytes = (M * K + 2 * K * N + M * N) * 2 + (8 * M * N if keep else 0)
        sets = [(cs.randn(gen, (M, K), BF), cs.randn(gen, (K, N), BF, K ** -0.5),
                 cs.randn(gen, (K, N), BF, K ** -0.5)) for _ in range(cs.n_copies(nbytes))]
        kb, tiles, times = -(-K // kmm.WG_BK), -(-M // kmm.WG_BM) * -(-N // 128), {}
        for splits in (1, 2, 3, 4):
            if splits > 1 and (kb // splits < 4 or tiles * splits > 2 * kmm.SMS + 8):
                continue
            kmm.wg_plan = lambda *_, p=(128, splits), **__: p
            times[f"128x{splits}"] = cs.bench_ms(
                [lambda s=s: kmm.gated_matmul(*s, keep_ab=keep, impl="wgmma") for s in sets])
        kmm.wg_plan = chosen
        cats = [(s[0], torch.cat(s[1:], dim=1)) for s in sets]
        prod = cs.bench_ms([lambda c=c: torch.matmul(*c) for c in cats])
        bn, splits = chosen(M, N, K, gated=True)
        print("gated " + json.dumps(dict(
            case=f"M={M} K={K} N={N}" + (" keep_ab" if keep else ""), ms=times,
            fastest=min(times, key=times.get), wg_plan=f"{bn}x{splits}",
            products_only_ms=prod)), flush=True)


def main():
    if not torch.cuda.is_available():
        print("wg_plans: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    chosen = kmm.wg_plan
    for layout, M, K, N, od in products():
        nbytes = (M * K + K * N) * 2 + M * N * torch.tensor([], dtype=od).element_size()
        sets = [(cs._stored(cs.randn(gen, (M, K), BF), layout == "TN"),
                 cs._stored(cs.randn(gen, (K, N), BF, K ** -0.5), layout == "NT"))
                for _ in range(cs.n_copies(nbytes))]
        kb, times = -(-K // kmm.WG_BK), {}
        for bn in kmm.WG_BNS:
            tiles = -(-M // kmm.WG_BM) * -(-N // bn)
            for splits in (1, 2, 3, 4):
                if splits > 1 and (kb // splits < 4 or tiles * splits > 2 * kmm.SMS + 8):
                    continue
                kmm.wg_plan = lambda *_, p=(bn, splits): p
                calls = [lambda s=s: kmm.tile_matmul(*s, out_dtype=od, impl="wgmma")
                         for s in sets]
                times[f"{bn}x{splits}"] = cs.bench_ms(calls)
        kmm.wg_plan = chosen
        lib = cs.bench_ms([lambda s=s: (torch.matmul(*s) if od == BF
                                        else torch.mm(*s, out_dtype=od)) for s in sets])
        bn, splits = chosen(M, N, K)
        print("plan " + json.dumps(dict(
            case=f"{layout} M={M} K={K} N={N} out={str(od).replace('torch.', '')}",
            ms=times, fastest=min(times, key=times.get), wg_plan=f"{bn}x{splits}",
            library_ms=lib)), flush=True)
    sweep_gated(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
