"""Where the tensor-core SSD scan (``tc::ssd`` in ``csrc/ssd.cu``) spends
its time, on the card.

    python3 tools/ssd_phases.py            # one H100; S = 64, 200, 512
    python3 tools/ssd_phases.py 512 2100   # other lengths

Writes a copy of ``csrc/ssd.cu`` into ``build/`` (git-ignored) in which
thread 128 of every block records ``%globaltimer`` (ns) at each phase of
its first chunk, builds it with the repo's nvcc flags and runs it at
mamba2-130m's prefill shapes (batch 1, 24 heads of dh 64, ds 128, chunk
min(128, S), a zero initial state; the inputs of ``chip_smoke.check_ssd``).
Prints ``nvcc -Xptxas -v``'s report for ``tc::ssd``, then one JSON line a
length: the time a call in a CUDA graph (``chip_smoke.bench_ms``), and
for each cluster rank (chunk) the mean over heads of each phase's stamp
in us after the first block entered.  The phases, in order: ``enter``;
``init`` (barriers made, the cluster arrive); ``scan`` (dt, the cumsum);
``tma`` (x, B, C landed); ``products`` (the scores, y_diag and the
chunk's state contribution); ``cluster_wait``; ``recv`` (h_{c-1} here);
``hp`` (read); ``publish`` (h_c sent on, or stored for the last chunk);
``y`` (y_off and y stored); ``exit``.  The stamps cost a few hundred ns
in all, so the graph time here runs a little above ``chip_smoke.py``'s.
The markers are placed by matching lines of ``csrc/ssd.cu``: an edit to
those lines needs the same edit in ``MARKS``.
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
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "ssd.cu")
OUT = os.path.join(ROOT, "build", "ssd_phases")
STAMPS = '''
__device__ unsigned long long g_stamps[4096][16];
#define STAMP(k)                                                                            \\
  if (threadIdx.x == 128 && round == 0) {                                                   \\
    unsigned long long t;                                                                   \\
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));                                     \\
    g_stamps[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x][k] = t;         \\
  }
'''
# (line of csrc/ssd.cu, phase, stamp before or after it)
MARKS = (
    ("  if (tid == 0) {\n    bar_init(load_bar, 1);", "enter", "before"),
    ("  cluster_arrive();\n  __syncthreads();\n", "init", "after"),
    ("    bar_wait(load_bar, round & 1);\n", "scan", "before"),
    ("    bar_wait(load_bar, round & 1);\n", "tma", "after"),
    ("    keep(st);\n", "products", "after"),
    ("    if (round == 0) cluster_wait();\n", "cluster_wait", "after"),
    ("        cp_async_wait();\n", "recv", "after"),
    ("    } else {\n      zero(hp);\n    }\n", "hp", "after"),
    ("    if (!last_chunk && tid == 0) copy_to_peer(recv_next, recv, STATE_BYTES, bar_next);\n",
     "publish", "after"),
    ("  }\n  // no block leaves while a peer", "y", "before"),
    ("  cluster_arrive();\n  cluster_wait();\n", "exit", "after"),
)
PHASES = [m[1] for m in MARKS]


def stamped_source():
    """csrc/ssd.cu with a STAMP at each marker and hk_stamps to read them."""
    s = open(SRC).read().replace('#include "hopper.cuh"',
                                 f'#include "{os.path.dirname(SRC)}/hopper.cuh"')
    s = s.replace("namespace cg = cooperative_groups;",
                  "namespace cg = cooperative_groups;\n" + STAMPS)
    for k, (line, phase, where) in enumerate(MARKS):
        if s.count(line) != 1:
            raise RuntimeError(f"the marker line of {phase!r} is not in {SRC} exactly once")
        stamp = f"  {{ const int round = 0; STAMP({k}) }}\n" if phase in ("enter", "init", "exit") \
            else f"    STAMP({k})\n"
        s = s.replace(line, line + stamp if where == "after" else stamp + line)
    return s.replace("const char* hk_error_string", "int hk_stamps(void* out) {\n"
                     "  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n}\n\n"
                     "const char* hk_error_string")


def main(argv):
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, "ssd_phases.cu"), os.path.join(OUT, "libssd_phases.so")
    with open(cu, "w") as f:
        f.write(stamped_source())
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, cu],
                       capture_output=True, text=True)
    report = (r.stdout + r.stderr).splitlines()
    for i, line in enumerate(report):
        if "tc3ssd" in line and "Compiling" in line:
            print("\n".join(report[i:i + 4]))
    if r.returncode:
        print("\n".join(report[-40:]))
        return 1
    lib = ctypes.CDLL(so)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hk_ssd_tc.argtypes = [P] * 8 + [I] * 7 + [L] * 6 + [P]
    lib.hk_stamps.argtypes = [P]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    nh, dh, ds, b = 24, 64, 128, 1
    for S in [int(a) for a in argv] or [64, 200, 512]:
        Q = min(128, S)
        conv = cs.randn(gen, (b, S, nh * dh + 2 * ds), torch.bfloat16)
        x = conv[..., :nh * dh].reshape(b, S, nh, dh)
        B = conv[..., nh * dh:nh * dh + ds].reshape(b, S, 1, ds)
        C = conv[..., nh * dh + ds:].reshape(b, S, 1, ds)
        dt = F.softplus(cs.randn(gen, (b, S, nh), torch.float32) - 2.5)
        A = -torch.arange(1, nh + 1, dtype=torch.float32, device="cuda")
        h0 = torch.zeros((b, nh, dh, ds), device="cuda")
        y = torch.empty((b, S, nh, dh), dtype=torch.bfloat16, device="cuda")
        fin = torch.empty((b, nh, dh, ds), device="cuda")

        def call():
            code = lib.hk_ssd_tc(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                                 C.data_ptr(), h0.data_ptr(), y.data_ptr(), fin.data_ptr(), b, S,
                                 nh, dh, 1, ds, Q, x.stride(0), x.stride(1), B.stride(0),
                                 B.stride(1), C.stride(0), C.stride(1),
                                 torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"hk_ssd_tc: CUDA error {code}")

        call()
        y_p, fin_p = cs.ref.ssd_plain(x, dt, A, B, C, chunk=Q, init_state=h0)
        ok = bool(torch.allclose(y.float(), y_p.float(), atol=2e-2, rtol=2e-2)
                  and torch.allclose(fin, fin_p, atol=2e-4, rtol=2e-4))
        ms = cs.bench_ms([call] * 20)
        call()
        torch.cuda.synchronize()
        st = np.zeros((4096, 16), dtype=np.uint64)
        if lib.hk_stamps(st.ctypes.data):
            raise RuntimeError("hk_stamps failed")
        K = min(-(-S // Q), 8)
        blocks = st[:K * nh, :len(PHASES)].astype(np.int64)
        rel = (blocks - blocks[:, 0].min()) / 1e3
        ranks = {f"chunk{r}": {p: round(float(rel[[h * K + r for h in range(nh)], k].mean()), 2)
                               for k, p in enumerate(PHASES)} for r in range(K)}
        print(json.dumps(dict(S=S, chunks=-(-S // Q), ok=ok, graph_us_per_call=1e3 * ms,
                              phases_us=ranks)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
