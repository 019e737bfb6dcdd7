"""Hold rows 1 and 2's gemv and SIMT routes bit for bit across two
checkouts, on the card.

``csrc/matmul.cuh``'s ``gv::gemv`` and ``mm_simt_f32`` carry an expert
coordinate (blockIdx.z) for the MoE's grouped products; a single product
launches them with one expert.  This script runs ``matmul`` (row 1),
``gated_matmul`` (row 2, with and without its kept fp32 products) and the
fp32 ``tile_matmul`` in its three layouts on the gemv route (bf16, M <= 16)
and the simt route (fp32) at seeded inputs, through the checkout whose
``src`` is first on ``PYTHONPATH``, and saves the outputs; ``--compare``
then holds two such files equal bit for bit:

    PYTHONPATH=<other checkout>/src python3 tools/gemv_simt_bit_equal.py --save a.pt
    PYTHONPATH=src python3 tools/gemv_simt_bit_equal.py --save b.pt
    python3 tools/gemv_simt_bit_equal.py --compare a.pt b.pt

Each checkout builds its own kernels into its own ``build/``.  The
comparison prints one JSON line: the cases, those that differ, the card
and its power limit.
"""

import argparse
import json
import subprocess
import sys

import torch

SEED = 0
# (M, K, N): decode slots over qwen3-0.6b's and granite-moe-3b-a800m's
# projections, the K splits of gemv_plan's cluster among them, and widths
# off the 128-column panel
GEMV = [(1, 1024, 3072), (4, 1024, 3072), (16, 3072, 1024), (4, 1536, 2048),
        (7, 512, 1536), (4, 1024, 151936), (3, 96, 136)]
SIMT = [(37, 96, 136), (64, 1024, 512), (5, 200, 72)]


def card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def outputs():
    from repro_torch.kernels import matmul as kmm
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    out = {}
    for M, K, N in GEMV:
        x, w, wb = randn((M, K), torch.bfloat16), *(randn((K, N), torch.bfloat16, K ** -0.5)
                                                     for _ in range(2))
        b = randn((N,), torch.bfloat16)
        for act in ("none", "silu", "gelu"):
            out[f"matmul gemv {M}x{K}x{N} {act}"] = kmm.matmul(x, w, act=act, impl="gemv")
        out[f"matmul gemv {M}x{K}x{N} bias relu2"] = kmm.matmul(x, w, b, act="relu2",
                                                                 impl="gemv")
        out[f"gated gemv {M}x{K}x{N} silu"] = kmm.gated_matmul(x, w, wb, impl="gemv")
        for i, t in enumerate(kmm.gated_matmul(x, w, wb, act="gelu", keep_ab=True,
                                               impl="gemv")):
            out[f"gated gemv {M}x{K}x{N} gelu keep_ab {i}"] = t
    for M, K, N in SIMT:
        x, w, wb = randn((M, K), torch.float32), *(randn((K, N), torch.float32, K ** -0.5)
                                                    for _ in range(2))
        b = randn((N,), torch.float32)
        out[f"matmul simt {M}x{K}x{N} bias silu"] = kmm.matmul(x, w, b, act="silu",
                                                                impl="simt")
        for i, t in enumerate(kmm.gated_matmul(x, w, wb, keep_ab=True, impl="simt")):
            out[f"gated simt {M}x{K}x{N} keep_ab {i}"] = t
        out[f"tile simt {M}x{K}x{N} NN"] = kmm.tile_matmul(x, w)
        out[f"tile simt {M}x{K}x{N} TN"] = kmm.tile_matmul(x.t().contiguous().t(), w)
        out[f"tile simt {M}x{K}x{N} NT"] = kmm.tile_matmul(x, w.t().contiguous().t())
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save", help="write this checkout's outputs here")
    ap.add_argument("--compare", nargs=2, help="two saved files to hold equal bit for bit")
    args = ap.parse_args(argv)
    if args.save:
        if not torch.cuda.is_available():
            print("gemv_simt_bit_equal: no CUDA device available", file=sys.stderr)
            return 1
        torch.save(outputs(), args.save)
    if args.compare:
        a, b = (torch.load(p) for p in args.compare)
        differ = sorted(k for k in a.keys() | b.keys()
                        if k not in a or k not in b or not torch.equal(a[k], b[k]))
        print(json.dumps(dict(cases=len(a.keys() | b.keys()), differ=differ,
                              bit_equal=not differ, card=card())))
        return 0 if not differ else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
