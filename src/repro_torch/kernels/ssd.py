"""Wrapper of the CUDA SSD chunked-scan kernels (``csrc/ssd.cu``).

Counterpart of ``repro/kernels/ssd.py::ssd``, widened to what the model's
``ssd_chunked`` does: a ragged length (S need not be a multiple of the
chunk), an optional fp32 initial state, and the fp32 final state
returned beside y.  x, B and C may be the model's slices of the conv
output: they are read in place through their (batch, position) strides,
with the head (group) dimension and the last one packed, when every row
starts on 16 bytes; an operand that does not is copied once.  CUDA
tensors only; the CPU path lives in ``kernels/ops.py``.

Each call takes one of two routes (``IMPLS``), which :func:`ssd_impl`
chooses from the dtype and the shapes alone:

* ``"wgmma"`` (``tc::ssd``): bf16 on Hopper's tensor cores, one block per
  chunk, the chunks of a head a thread-block cluster that carries the
  state through distributed shared memory; mamba2's dh 64 and ds 128, any
  chunk up to 128: every bf16 prefill of the mamba2 models;
* ``"simt"`` (``ssd_scan``): fp32 FMAs, for fp32 inputs (held to 2e-4)
  and every shape the tensor-core kernel does not take.

``impl=`` overrides the choice (the card's tests and ``chip_smoke.py``
run both routes on the same inputs); a route that cannot take the
operands raises, and a kernel that fails raises: nothing falls back to
the other route.  ``IMPL_LAUNCHES`` counts the launches of each route.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SLICE = 16             # rows of the state one SIMT block owns (csrc/ssd.cu P)
HEAD_DIMS = (16, 32, 64, 128)   # SIMT: a head's dh / 16 blocks form one cluster of <= 8
MAX_CHUNK = 128
MAX_STATE = 128
TC_HEAD_DIM, TC_STATE = 64, 128  # the one (dh, ds) of the tensor-core kernel (tc::DH, tc::DS)
TC_CLUSTER = 8                  # chunks of a head in flight at once (tc::MAX_CLUSTER)
IMPLS = ("wgmma", "simt")

# launches per route, counted where each route's kernel launches
IMPL_LAUNCHES: Dict[str, int] = {p: 0 for p in IMPLS}


def reset_impl_launches() -> None:
    """Zero ``IMPL_LAUNCHES``."""
    for path in IMPL_LAUNCHES:
        IMPL_LAUNCHES[path] = 0


def ssd_impl(dtype: torch.dtype, dh: int, ds: int, chunk: int) -> str:
    """The route of one scan: ``"wgmma"`` for bf16 at dh 64 and ds 128
    (mamba2's heads) with a chunk of 1 to 128; else ``"simt"``."""
    if dtype == torch.bfloat16 and dh == TC_HEAD_DIM and ds == TC_STATE \
            and 1 <= chunk <= MAX_CHUNK:
        return "wgmma"
    return "simt"


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """[b, S, heads, d] with its last two dims packed (the stride of a dim
    of size 1 is never read) and every (batch, position) row on 16 bytes,
    as the kernel's vector loads and TMA maps need: ``t`` itself, or a
    packed copy."""
    packed = (t.stride(3) == 1 or t.shape[3] == 1) and \
        (t.stride(2) == t.shape[3] or t.shape[2] == 1)
    elt = t.element_size()
    if packed and t.data_ptr() % 16 == 0 and t.stride(0) * elt % 16 == 0 \
            and t.stride(1) * elt % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, chunk: int, init_state: Optional[torch.Tensor] = None,
        impl: Optional[str] = None):
    """(y [b,S,nh,dh] in x's dtype, final state [b,nh,dh,ds] fp32).

    x [b,S,nh,dh]; dt [b,S,nh] fp32 (post-softplus); A [nh] fp32; B, C
    [b,S,g,ds] in x's dtype; ``init_state`` [b,nh,dh,ds] fp32 or None.
    ``impl`` forces a route (default :func:`ssd_impl`'s choice)."""
    if x.device.type != "cuda":
        raise ValueError(f"CUDA SSD kernel got a {x.device} tensor")
    if x.dtype not in DTYPES:
        raise TypeError(f"CUDA SSD kernel takes fp32 or bf16, got {x.dtype}")
    if x.dim() != 4 or B.dim() != 4 or C.dim() != 4:
        raise ValueError("x must be [b,S,nh,dh] and B, C [b,S,g,ds]")
    b, S, nh, dh = x.shape
    g, ds = B.shape[2], B.shape[3]
    if tuple(B.shape) != (b, S, g, ds) or C.shape != B.shape:
        raise ValueError(f"B and C must be [{b},{S},g,ds], got {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    if tuple(dt.shape) != (b, S, nh) or tuple(A.shape) != (nh,):
        raise ValueError(f"dt must be [{b},{S},{nh}] and A [{nh}]")
    for t in (dt, A, B, C) + ((init_state,) if init_state is not None else ()):
        if t.device != x.device:
            raise ValueError("operands must share x's device")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("B and C must share x's dtype")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("dt and A must be fp32")
    if not dt.is_contiguous() or not A.is_contiguous():
        raise ValueError("dt and A must be contiguous")
    if not 1 <= chunk <= MAX_CHUNK or ds % 8 or not 8 <= ds <= MAX_STATE \
            or dh not in HEAD_DIMS or nh % g:
        raise ValueError(f"chunk={chunk} must lie in [1, 128], ds={ds} be a multiple "
                         f"of 8 up to 128, dh={dh} one of {HEAD_DIMS} and nh={nh} a "
                         f"multiple of g={g}")
    if init_state is not None and (tuple(init_state.shape) != (b, nh, dh, ds)
                                   or init_state.dtype != torch.float32
                                   or not init_state.is_contiguous()):
        raise ValueError(f"init_state must be a contiguous fp32 [{b},{nh},{dh},{ds}]")
    chosen = ssd_impl(x.dtype, dh, ds, chunk)
    impl = chosen if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"unknown SSD route {impl!r}; one of {IMPLS}")
    if impl == "wgmma" and chosen != "wgmma":
        raise ValueError(f"the wgmma SSD route takes bf16 with dh={TC_HEAD_DIM} and "
                         f"ds={TC_STATE}; got {x.dtype}, dh={dh}, ds={ds}")
    x, B, C = (_rows_aligned(t) for t in (x, B, C))
    y = torch.empty((b, S, nh, dh), dtype=x.dtype, device=x.device)
    final = torch.empty((b, nh, dh, ds), dtype=torch.float32, device=x.device)
    lib = build.library("ssd")
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            init_state.data_ptr() if init_state is not None else None,
            y.data_ptr(), final.data_ptr(), b, S, nh, dh, g, ds, chunk,
            x.stride(0), x.stride(1), B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if impl == "wgmma":
        code = lib.hk_ssd_tc(*args, stream)
        build.check(lib, code, "hk_ssd_tc")
    else:
        code = lib.hk_ssd(*args, DTYPES[x.dtype], stream)
        build.check(lib, code, "hk_ssd")
    IMPL_LAUNCHES[impl] += 1
    return y, final
