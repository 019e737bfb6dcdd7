"""What the key split buys the absorbed MLA decode on each route
(``csrc/mla_decode.cu``: ``mla::decode_wgmma`` on the tensor cores,
``mla::decode`` SIMT), on the card.

    python3 tools/mla_splits.py            # one H100

Builds the kernels (``kernels/build.py``), prints ``nvcc -Xptxas -v``'s
register, shared-memory and spill report for the source's kernels, then
times ``hk_mla_decode_tc`` (wgmma) and ``hk_mla_decode`` (SIMT) at
minicpm3-4b's dims (40 heads, latent 256, rope 32, bf16) with the key
split forced over each route's choices (1, 2, a few between, one tile a
split, and the wrapper's ``flash_attention.mla_splits``), at the serving
tick of ``chip_smoke.mla_kernel_phase`` (4 slots over T 544) and at single
rows of 32 to 544 keys.  The two routes run in turns within each case
(wgmma, SIMT, SIMT, wgmma, each reading averaged).  Each time is a call in
a CUDA graph of 20 calls (``chip_smoke.bench_ms``'s method, on one input
set, so the L2 may hold it).  One JSON line a case, route and split: the
card, its power limit, the shape, the split, whether the wrapper chooses
it, and the us per call.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402

NH, (LAT, ROPE) = 40, kfa.MLA_DIMS
CASES = (("serving tick", 4, 544, [64, 301, 512, 1]), ("one row of 32", 1, 32, [32]),
         ("one row of 64", 1, 64, [64]), ("one row of 128", 1, 128, [128]),
         ("one row of 544", 1, 544, [544]))
ENTRY = {"wgmma": "hk_mla_decode_tc", "simt": "hk_mla_decode"}


def splits(impl, B, T):
    """The split counts timed on ``impl``: 1, 2, 3, 5, one tile a split and
    the wrapper's choice, each at most the tiles T has."""
    tiles = -(-T // kfa.MLA_TILE[impl])
    return sorted({n for n in (1, 2, 3, 5, tiles, kfa.mla_splits(B, T, impl)) if n <= tiles})


def time_us(lib, impl, B, T, kv_len, nsplit, calls=20, reps=10):
    g = torch.Generator(device="cuda").manual_seed(0)
    q_lat = torch.randn((B, NH, LAT), generator=g, device="cuda").bfloat16()
    q_rope = torch.randn((B, NH, ROPE), generator=g, device="cuda").bfloat16()
    kv = torch.randn((B, T, LAT + ROPE), generator=g, device="cuda").bfloat16()
    c_kv, k_rope = kv[..., :LAT], kv[..., LAT:]
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    o = torch.empty((B, NH, LAT), device="cuda")
    part = torch.empty(B * NH * nsplit * kfa.MLA_PART, device="cuda")
    fn = getattr(lib, ENTRY[impl])
    dtype = () if impl == "wgmma" else (1,)           # the SIMT entry names the dtype

    def call():
        code = fn(q_lat.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(), k_rope.data_ptr(),
                  kl.data_ptr(), o.data_ptr(), B, NH, T, LAT, ROPE, *q_lat.stride()[:2],
                  *q_rope.stride()[:2], *c_kv.stride()[:2], *k_rope.stride()[:2], 96 ** -0.5,
                  nsplit, part.data_ptr(), *dtype, torch.cuda.current_stream().cuda_stream)
        build.check(lib, code, ENTRY[impl])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            call()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / (reps * calls)


def main():
    if not torch.cuda.is_available():
        print("mla_splits: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], check=True, capture_output=True, text=True).stdout.strip()
    report = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                             os.devnull, str(build.CSRC / "mla_decode.cu")],
                            capture_output=True, text=True)
    print("\n".join(line for line in (report.stdout + report.stderr).splitlines()
                    if "registers" in line or "spill" in line or "Compiling" in line))
    lib = build.library("mla_decode")
    for label, B, T, kv_len in CASES:
        runs = [(impl, n) for impl in kfa.IMPLS for n in splits(impl, B, T)]
        us = {r: [] for r in runs}
        for r in runs + runs[::-1]:                   # in turns, each reading averaged
            us[r].append(time_us(lib, r[0], B, T, kv_len, r[1]))
        for impl, n in runs:
            print(json.dumps(dict(card=smi, case=label, B=B, T=T, kv_len=kv_len, route=impl,
                                  nsplit=n, chosen=n == kfa.mla_splits(B, T, impl),
                                  us=sum(us[(impl, n)]) / 2)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
