"""Where the tensor-core ring kernels (``ringtc::ag_wgmma``,
``ringtc::rs_wgmma``, ``ringtc::contract_wgmma``, ``ringtc::rs_int8_wgmma``
in ``csrc/ring_matmul.cu``) spend a loopback call's time, on the card.

    python3 tools/ring_phases.py           # one H100

Writes a copy of ``csrc/ring_matmul.cu`` into ``build/`` (git-ignored) in
which the producer thread, the first copy thread and the first consumer
thread of every block record ``%globaltimer`` (ns) at each phase of the
first four ring steps, builds it with the repo's nvcc flags, puts it in
place of the ring library (``build._libs``), and runs the loopback ring
(``kernels/ring_loopback.py``) at three full-width blocks of
``chip_smoke.py``: the K/V in-projection AG-matmul and the K/V input
gradient's matmul-RS over tokens on a ring of two, megatron's
O-projection matmul-RS on the ring of four; then on the int8 wire the
K/V and FFN-down AG-matmuls, the O-projection's contracted AG-matmul and
the K/V input gradient's matmul-RS on a ring of two, and megatron's
O-projection matmul-RS on the ring of four.  Each case is checked
against ``ring_loopback.reference``, timed as ``chip_smoke.py`` times it
(CUDA-graph replays, ``bench_ms``), and its stamps are read from the last
replay (the table is cleared before each case: a grid of fewer blocks
than the cap leaves the rest unstamped).  One JSON line a case: the time
a call, and for each rank the median over its blocks (and the latest
block) of each stamp, in us after
the first block of any rank entered.  The phases (``s`` the step):
``enter`` (the producer starts), ``landed_s`` (AG: the producer saw
hop s - 1 land), ``copy_start_s`` / ``copy_done_s`` (AG: the forward of
step s began, after the credit wait / was counted; on the int8 wire the
shard was quantized before the ring kernel, by ``quant_pair``), ``loop_s`` (the
consumers' first main loop of step s done), ``step_s`` (the consumers
began step s), ``waited_s`` (RS: the hop and the credit of step s seen),
``arrived_s`` (RS: the step's tiles counted; int8: this block's rows of
the hop written), ``barrier_s`` (int8 RS: the grid barrier after step s's
folds passed, and the credit for the slot seen).  The markers are placed by
matching lines of ``csrc/ring_matmul.cu``: an edit to those lines needs
the same edit in ``MARKS``.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ring_loopback as LB  # noqa: E402

SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "ring_matmul.cu")
OUT = os.path.join(ROOT, "build", "ring_phases")
RANKS, BLOCKS, SLOTS = 16, 256, 36
STAMPS = f'''
__device__ unsigned long long g_stamps[{RANKS}][{BLOCKS}][{SLOTS}];
__device__ __forceinline__ void stamp_at(int me, int k) {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (me < {RANKS} && blockIdx.x < {BLOCKS} && k < {SLOTS}) g_stamps[me][blockIdx.x][k] = t;
}}
'''
# (line of csrc/ring_matmul.cu, the stamp, put before or after it, times the line appears)
MARKS = (
    ("    if (threadIdx.x == 0) {  // the producer\n      int it = 0;\n",
     "      stamp_at(rg.me, 0);\n", "after", 2),
    ("    if (threadIdx.x == 0) {  // the producer: A is x's rows of the step, B w's columns\n",
     "      stamp_at(rg.me, 0);\n", "after", 2),
    ("  asm volatile(\"fence.proxy.async.global;\\n\" ::: \"memory\");\n"
     "  return (hin & 1) ? smap1 : smap0;\n", "  if (s < 4) stamp_at(rg.me, 4 + s);\n", "before",
     1),
    ("      if (ct == 0 && hout >= 2) spin_geq(rg.my_credit, hout - 1, rg.timeout_ns, local);\n",
     "      if (ct == 0 && s < 4) stamp_at(rg.me, 8 + s);\n", "after", 1),
    ("        release(rg.right_landed, hout + 1, local);\n    }\n",
     "    if (ct == 0 && s < 4 && s < rg.n - 1) stamp_at(rg.me, 12 + s);\n", "after", 1),
    # the consumers: AG-matmul (either wire), the contracted AG-matmul, matmul-RS (either wire)
    ("      // row m of the step lands at (m / t) n t + src t + m % t of out\n",
     "      if (threadIdx.x == 128 && u == (int)blockIdx.x && s < 4) stamp_at(rg.me, 16 + s);\n",
     "before", 1),
    ("      if (regs && !last) continue;                    // the sums stay in registers\n",
     "      if (threadIdx.x == 128 && u == (int)blockIdx.x && s < 4) stamp_at(rg.me, 16 + s);\n",
     "before", 1),
    ("      wg::mma_unit<BN, false, false, false>(ring, full, empty, acc, accb, 0, kbt, c, tt, "
     "it,\n                                            wait);\n",
     "      if (threadIdx.x == 128 && u == (int)blockIdx.x && s < 4) stamp_at(rg.me, 16 + s);\n",
     "after", 2),
    ("        rg.my_slot[(rg.hop0 + s - 1) & 1] + align16((long long)M * h));\n",
     "    if (threadIdx.x == 128 && s < 4) stamp_at(rg.me, 20 + s);\n", "after", 1),
    ("        rg.my_slot[(rg.hop0 + s - 1) & 1] + align16((long long)m * hl));\n",
     "    if (threadIdx.x == 128 && s < 4) stamp_at(rg.me, 20 + s);\n", "after", 1),
    ("    for (int u = blockIdx.x; u < units; u += gridDim.x) {\n"
     "      const wg::Unit w = wg::unit_at<BN>(u, mt, nt, 1, kbt, kbt);\n"
     "      wg::mma_unit",
     "    if (threadIdx.x == 128 && s < 4) stamp_at(rg.me, 20 + s);\n", "before", 2),
    ("        named_sync(BAR_CONSUMERS, 256);\n        waited = true;\n",
     "        if (threadIdx.x == 128 && s < 4) stamp_at(rg.me, 24 + s);\n", "after", 2),
    ("      if (s > 0) release(rg.left_credit, hout, local);\n    }\n",
     "    if (threadIdx.x == 128 && s < 4) stamp_at(rg.me, 28 + s);\n", "after", 1),
    ("      if (s > 0 && blockIdx.x == 0) release(rg.left_credit, hout, local);\n"
     "      if (hout >= 2) spin_geq(rg.my_credit, hout - 1, rg.timeout_ns, local);\n",
     "      if (s < 4) stamp_at(rg.me, 32 + s);\n", "after", 1),
    ("    named_sync(BAR_QUANT, 32 * QUANT_WARPS);  // this block's rows of the hop are written\n",
     "    if (threadIdx.x == 128 && s < 4) stamp_at(rg.me, 28 + s);\n", "after", 1),
)
PHASES = {0: "enter"}
for base, name in ((4, "landed"), (8, "copy_start"), (12, "copy_done"), (16, "loop"),
                   (20, "step"), (24, "waited"), (28, "arrived"), (32, "barrier")):
    PHASES.update({base + s: f"{name}_{s}" for s in range(4)})
# (n, axis, case, wire)
CASES = ((2, "my", cs.RING_CASES[0], "bf16"), (2, "my", cs.RING_CASES[5], "bf16"),
         (4, "model", cs.MEG_RING_CASES[0], "bf16"), (2, "my", cs.RING_CASES[0], "int8"),
         (2, "my", cs.RING_CASES[1], "int8"), (2, "my", cs.RING_CASES[4], "int8"),
         (2, "my", cs.RING_CASES[5], "int8"), (4, "model", cs.MEG_RING_CASES[0], "int8"))


def stamped_source():
    """csrc/ring_matmul.cu with a stamp at each marker and hk_stamps to read them."""
    csrc = os.path.dirname(SRC)
    s = open(SRC).read()
    for h in ("hopper.cuh", "wg.cuh"):
        s = s.replace(f'#include "{h}"', f'#include "{csrc}/{h}"')
    s = s.replace("namespace ringtc {\n", "namespace ringtc {\n" + STAMPS, 1)
    for line, code, where, count in MARKS:
        if s.count(line) != count:
            raise RuntimeError(f"a marker line is not in {SRC} {count} time(s): {line!r}")
        s = s.replace(line, line + code if where == "after" else code + line)
    return s.replace("const char* hk_error_string", "int hk_stamps(void* out) {\n"
                     "  return (int)cudaMemcpyFromSymbol(out, ringtc::g_stamps, "
                     "sizeof(ringtc::g_stamps));\n}\n\n"
                     "int hk_stamps_clear() {\n  void* p = nullptr;\n"
                     "  const cudaError_t e = cudaGetSymbolAddress(&p, ringtc::g_stamps);\n"
                     "  return (int)(e != cudaSuccess ? e : cudaMemset(p, 0, "
                     "sizeof(ringtc::g_stamps)));\n}\n\nconst char* hk_error_string")


def main():
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, "ring_phases.cu"), os.path.join(OUT, "libring_phases.so")
    with open(cu, "w") as f:
        f.write(stamped_source())
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        print((r.stdout + r.stderr)[-6000:])
        return 1
    build.build_all()
    lib = ctypes.CDLL(so)
    for fn, argtypes in build.ARGTYPES["ring_matmul"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hk_error_string.argtypes = [ctypes.c_int]
    lib.hk_error_string.restype = ctypes.c_char_p
    lib.hk_stamps.argtypes = [ctypes.c_void_p]
    lib.hk_stamps_clear.argtypes = []
    build._libs["ring_matmul"] = lib
    torch.backends.cuda.matmul.allow_tf32 = False
    for n, ax, (kernel, label, xs, ws, sd, _), wire in CASES:
        lb = LB.LoopbackRing(n, ax)
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        xl = [cs.randn(gen, xs, torch.bfloat16) for _ in range(n)]
        wl = [cs.randn(gen, ws, torch.bfloat16, ws[0] ** -0.5) for _ in range(n)]
        int8 = wire == "int8"
        if kernel == "ag_matmul":
            run = lambda r=True: LB.ag_matmul(lb, xl, wl, int8=int8, impl="wgmma",  # noqa: E731
                                              reset=r)
        elif kernel == "ag_matmul_contract":
            run = lambda r=True: LB.ag_matmul_contract(  # noqa: E731
                lb, xl, wl, int8=int8, impl="wgmma", reset=r)
        else:
            run = lambda r=True: LB.matmul_rs(lb, xl, wl, sd, int8=int8,  # noqa: E731
                                              impl="wgmma", reset=r)
        mags = LB.partial_magnitudes(xl, wl, sd) if kernel == "matmul_rs" else None
        ok = cs._ring_errs(kernel, run(), LB.reference(kernel, xl, wl, sd, int8=int8),
                           torch.bfloat16, n, int8, mags)[0]
        # a grid may use fewer blocks than the cap: clear the last case's stamps first
        if lib.hk_stamps_clear():
            raise RuntimeError("hk_stamps_clear failed")
        ms = cs.bench_ms([run])            # every replay stamps the same slots anew
        st = np.zeros((RANKS, BLOCKS, SLOTS), dtype=np.uint64)
        torch.cuda.synchronize()
        if lib.hk_stamps(st.ctypes.data):
            raise RuntimeError("hk_stamps failed")
        kname = kernel + ("_int8" if int8 else "")
        blocks = lb.cap(kname, torch.bfloat16, "wgmma", torch.bfloat16)
        got = st[:n, :blocks].astype(np.int64)
        t0 = got[:, :, 0][got[:, :, 0] > 0].min()
        ranks = {}
        for rk in range(n):
            ph = {}
            for k, name in PHASES.items():
                v = got[rk, :, k]
                v = v[v >= t0]
                if v.size:
                    ph[name] = [round(float(np.median(v) - t0) / 1e3, 2),
                                round(float(v.max() - t0) / 1e3, 2)]
            ranks[f"rank{rk}"] = ph
        print(json.dumps(dict(case=label, kernel=kname, n=n, blocks=blocks, ok=ok,
                              graph_us_per_call=1e3 * ms, phases_us_median_latest=ranks)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
