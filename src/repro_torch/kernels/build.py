"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process into a
shared library with a plain C interface (all sources at once, in
parallel), then loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC --split-compile=0 \
        -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

``--split-compile=0`` lets each nvcc optimize and assemble its device
code on every core in parallel, so the longest source no longer builds
on one core while the others wait.

The build directory is ``build/kernels`` at the root of the checkout (git
ignores it); a library is named by the hash of its source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.  Nothing is built
or loaded at import: the first call that needs a kernel builds them.
Pointer and stream arguments are ``ctypes.c_void_p``; every C entry returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("matmul", "flash_attention", "swiglu_bwd", "ssd", "ring_matmul", "mla_decode", "moe")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--split-compile=0"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_ulonglong
ARGTYPES = {
    "matmul": {
        "hk_matmul": [_P] * 5 + [_I] * 8 + [_P],
        "hk_gated_matmul": [_P] * 7 + [_I] * 8 + [_P],
        "hk_tile_matmul": [_P] * 4 + [_I] * 3 + [_L, _L] + [_I] * 7 + [_P],
    },
    "flash_attention": {
        "hk_flash_attention": [_P, _P, _P, _P, _P, _P] + [_I] * 6 + [_L] * 12
                              + [_I, _F, _I, _P, _P, _I, _P],
        "hk_flash_attention_bwd": [_P] * 10 + [_I] * 6 + [_P, _I, _F, _I, _P],
        "hk_flash_attention_tc": [_P] * 6 + [_I] * 7 + [_L] * 12 + [_I, _F, _P, _P],
        "hk_flash_attention_bwd_tc": [_P] * 10 + [_I] * 7 + [_P, _I, _F, _P],
    },
    "swiglu_bwd": {
        "hk_swiglu_bwd": [_P] * 5 + [_L, _I, _I, _P],
    },
    "mla_decode": {
        "hk_mla_decode": [_P] * 6 + [_I] * 5 + [_L] * 8 + [_F, _I, _P, _I, _P],
        "hk_mla_decode_tc": [_P] * 6 + [_I] * 5 + [_L] * 8 + [_F, _I, _P, _P],
    },
    "moe": {
        "hk_moe_grouped": [_P] * 6 + [_I] * 9 + [_P],
        "hk_moe_combine": [_P] * 4 + [_I] * 4 + [_P],
        "hk_moe_combine_bwd": [_P] * 7 + [_I] * 5 + [_P],
    },
    "ssd": {
        "hk_ssd": [_P] * 8 + [_I] * 7 + [_L] * 6 + [_I, _P],
        "hk_ssd_tc": [_P] * 8 + [_I] * 7 + [_L] * 6 + [_P],
    },
    "ring_matmul": {
        "hk_set_device": [_I],
        "hk_sym_alloc": [_L, _P, _P],
        "hk_sym_open": [_P, _P],
        "hk_sym_close": [_P],
        "hk_sym_free": [_P],
        "hk_pingpong": [_P, _P, _I, _I, _U, _U, _P, _P],
        "hk_ring_ag_matmul": [_P, _P, _P, _P] + [_I] * 7 + [_P],
        "hk_ring_matmul_rs": [_P, _P, _P, _P] + [_I] * 8 + [_P],
        "hk_ring_ag_matmul_contract": [_P] * 5 + [_I] * 7 + [_P],
        "hk_ring_ag_matmul_int8": [_P] * 5 + [_I] * 7 + [_P],
        "hk_ring_matmul_rs_int8": [_P] * 5 + [_I] * 9 + [_P],
        "hk_ring_ag_matmul_contract_int8": [_P] * 6 + [_I] * 7 + [_P],
        "hk_ring_occupancy": [_I] * 4 + [_P, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):      # an edited header rebuilds every source
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source that has no up-to-date library, all in parallel.

    Returns each source's compiler output (empty for a reused library).
    Raises if any compile fails.  A file lock in the build directory keeps
    processes that start together (the ranks of a grid) from compiling
    the same sources at once: the first builds, the others then reuse."""
    import fcntl
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_missing()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_missing() -> Dict[str, str]:
    nvcc = nvcc_path()
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {name: "" for name in SOURCES}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)          # atomic: concurrent build processes agree
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            if not all(_lib_path(n).exists() for n in SOURCES):
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in ARGTYPES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.hk_error_string.argtypes = [ctypes.c_int]
            lib.hk_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        msg = lib.hk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
