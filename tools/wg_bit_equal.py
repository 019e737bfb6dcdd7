"""Hold the kernels built from ``csrc/wg.cuh`` bit for bit across two
checkouts, on the card.

``wg.cuh``'s producer loop (``wg::load_unit``) is shared by row 1, 2 and
4's ``wg::mm`` / ``wg::mm_gated`` (``matmul.cu``), the ring kernels of rows
5 to 7i (``ring_matmul.cu``) and the MoE's grouped products (``moe.cu``).
This script, run through the checkout whose ``src`` is first on
``PYTHONPATH``, saves

* the SASS of every kernel function of the matmul and ring libraries
  (``cuobjdump -sass``, by mangled name): equal text is the same machine
  code, so those kernels compute what they did, bit for bit;
* the outputs of ``matmul``, ``gated_matmul`` (with its kept products) and
  ``tile_matmul`` (NN, TN, NT) on the wgmma route, and of the MoE's grouped
  forward products (plain and gated, NN), at seeded inputs;

and ``--compare`` holds two such files equal:

    PYTHONPATH=<other checkout>/src python3 tools/wg_bit_equal.py --save a.pt
    PYTHONPATH=src python3 tools/wg_bit_equal.py --save b.pt
    python3 tools/wg_bit_equal.py --compare a.pt b.pt

Each checkout builds its own kernels into its own ``build/``.  The
comparison prints one JSON line: the functions and outputs compared, those
that differ, the card and its power limit.
"""

import argparse
import json
import os
import re
import subprocess

import torch

SEED = 0
# (M, K, N): qwen3-0.6b's training microbatch over its projections, a K split
# (wg_plan) and edges off the 128 x 128 tile
MM = [(2048, 1024, 3072), (2048, 3072, 1024), (128, 3072, 1024), (200, 136, 264)]
# (E, C, K, N): granite-moe-3b-a800m's experts at a 512-token prefill and off the tile
MOE = [(40, 128, 1536, 512), (40, 37, 512, 1536)]
LIBS = ("matmul", "ring_matmul")


def card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def sass(name):
    """{mangled function name: its SASS text} of one built library."""
    from repro_torch.kernels import build
    lib = build.library(name)._name
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    # an anonymous namespace's mangled name carries a hash of the source's path, which
    # differs between two checkouts: one name stands for it in both
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    parts = re.split(r"^[ \t]*Function :(.*)$", text, flags=re.M)
    return {f.strip(): body for f, body in zip(parts[1::2], parts[2::2])}


def outputs():
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import moe as kmoe
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    out = {}
    for M, K, N in MM:
        x, w, wb = randn((M, K)), randn((K, N), K ** -0.5), randn((K, N), K ** -0.5)
        out[f"matmul {M}x{K}x{N}"] = kmm.matmul(x, w, act="silu", impl="wgmma")
        for i, t in enumerate(kmm.gated_matmul(x, w, wb, act="silu", keep_ab=True,
                                               impl="wgmma")):
            out[f"gated_matmul {M}x{K}x{N} [{i}]"] = t
        out[f"tile_matmul nn {M}x{K}x{N}"] = kmm.tile_matmul(x, w)
        g = randn((M, N))
        out[f"tile_matmul nt {M}x{K}x{N}"] = kmm.tile_matmul(g, w.t())
        out[f"tile_matmul tn {M}x{K}x{N}"] = kmm.tile_matmul(x.t(), g)
    for E, C, K, N in MOE:
        x, w, wb = randn((E, C, K)), randn((E, K, N), K ** -0.5), randn((E, K, N), K ** -0.5)
        out[f"moe grouped {E}x{C}x{K}x{N}"] = kmoe.grouped(x, w)
        out[f"moe grouped gated {E}x{C}x{K}x{N}"] = kmoe.grouped(x, w, wb, act="silu")
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save", metavar="FILE")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.save:
        if not torch.cuda.is_available():
            raise SystemExit("wg_bit_equal: no CUDA device")
        torch.save({"sass": {n: sass(n) for n in LIBS}, "outputs": outputs()}, args.save)
        return
    if not args.compare:
        raise SystemExit("give --save FILE or --compare A B")
    a, b = (torch.load(p) for p in args.compare)
    funcs = sorted({(lib, f) for d in (a, b) for lib in d["sass"] for f in d["sass"][lib]})
    sass_diff = [f"{lib} {f}" for lib, f in funcs
                 if a["sass"][lib].get(f) != b["sass"][lib].get(f)]
    names = sorted(set(a["outputs"]) | set(b["outputs"]))
    out_diff = [n for n in names if n not in a["outputs"] or n not in b["outputs"]
                or not torch.equal(a["outputs"][n], b["outputs"][n])]
    print(json.dumps(dict(functions=len(funcs), functions_differ=sass_diff,
                          outputs=len(names), outputs_differ=out_diff, card=card(),
                          ok=not sass_diff and not out_diff)))


if __name__ == "__main__":
    main()
