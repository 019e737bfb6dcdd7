"""Wrappers of the CUDA kernels of the MoE's experts (``csrc/moe.cu``).

No pallas_call computes the experts: the JAX package runs them as
einsums and a scatter-add (``repro/models/mlp.py:110-132``), and these
kernels replace those:

* :func:`grouped` computes ``act(x_e @ w_e)`` for every expert e of
  x [E, C, K], w [E, K, N], or with ``wb`` the gated
  ``act(x_e @ w_e) * (x_e @ wb_e)``, in one launch: fp32 sums, the gate
  in fp32, one cast to x's dtype;
* :func:`combine` computes each token's ``sum_j gate[t, j] *
  yd[slot_of[t, j]]`` over its valid assignments (``slot_of`` -1:
  dropped), one block a token, in fp32 in j order, one cast: no atomics,
  the same sum every run.

The products take one of three routes (``IMPLS``), which
:func:`grouped_impl` chooses from the dtype and C alone (the operands
are contiguous, which the wrapper checks):

* ``"wgmma"``: bf16 with C > 16 (a prefill): ``wg::mm``'s persistent TMA
  and wgmma loop with the expert a third coordinate of the work unit,
  read through 3-D TMA maps, so a tile never reads across an expert;
* ``"gemv"``: bf16 with C <= 16 (decode): row 1/2's ``gv::gemv``
  (``csrc/matmul.cuh``) with the expert in the grid, K split over a
  cluster (``matmul.gemv_plan`` with ``experts``);
* ``"simt"``: fp32, row 1's SIMT tile (``matmul.cuh``'s ``mm_simt_f32``)
  with the expert in the grid, held to 2e-4.

:func:`launch` runs one product on a route named by its caller (the
card's tests hold a route on shapes the main path does not send it); a
route that cannot take the operands raises, and nothing falls back to
another.  CUDA tensors only; the CPU path lives in ``kernels/ops.py``.
``IMPL_LAUNCHES`` counts the launches of each route (the combine has
one, ``"token"``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matmul as _mm

ACTS = _mm.ACTS
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
IMPLS = ("wgmma", "gemv", "simt")     # numbered as csrc/moe.cu's IMPL_*
GEMV_MAX_C = 16                       # rows an expert at or below which bf16 takes gemv

# launches per route, counted where each wrapper launches its kernel
IMPL_LAUNCHES: Dict[str, Dict[str, int]] = {
    "moe_grouped_gated": {p: 0 for p in IMPLS},
    "moe_grouped_mm": {p: 0 for p in IMPLS},
    "moe_combine": {"token": 0}}


def reset_impl_launches() -> None:
    """Zero ``IMPL_LAUNCHES``."""
    for counts in IMPL_LAUNCHES.values():
        for path in counts:
            counts[path] = 0


def grouped_impl(dtype: torch.dtype, C: int) -> str:
    """The route of one grouped product with C rows an expert: ``"simt"``
    for fp32, else ``"gemv"`` for C <= 16 and ``"wgmma"`` above."""
    if dtype != torch.bfloat16:
        return "simt"
    return "gemv" if C <= GEMV_MAX_C else "wgmma"


def _check(x: torch.Tensor, *ws: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"CUDA MoE kernel got a {x.device} tensor")
    if x.dtype not in DTYPES:
        raise TypeError(f"CUDA MoE kernel takes fp32 or bf16, got {x.dtype}")
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"x must be [E, C, K], got {tuple(x.shape)}")
    E, _, K = x.shape
    N = ws[0].shape[-1]
    for t in (x, *ws):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError("operands must share x's device and dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte aligned")
    for w in ws:
        if tuple(w.shape) != (E, K, N):
            raise ValueError(f"w must be [{E}, {K}, N], got {tuple(w.shape)}")
    if K % 8 or N % 8:
        raise ValueError(f"K={K} and N={N} must be multiples of 8")


def grouped(x: torch.Tensor, w: torch.Tensor, wb: Optional[torch.Tensor] = None, *,
            act: str = "none") -> torch.Tensor:
    """[E, C, N] in x's dtype: ``act(x_e @ w_e)``, or with ``wb``
    ``act(x_e @ w_e) * (x_e @ wb_e)``, for every expert, one launch on
    :func:`grouped_impl`'s route."""
    C = x.shape[1] if x.dim() == 3 else 0        # launch refuses any other x
    return launch(x, w, wb, act=act, impl=grouped_impl(x.dtype, C))


def launch(x: torch.Tensor, w: torch.Tensor, wb: Optional[torch.Tensor] = None, *,
           act: str = "none", impl: str) -> torch.Tensor:
    """:func:`grouped`'s product on the route ``impl``, which raises where
    it cannot take the operands."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    ws = (w,) if wb is None else (w, wb)
    _check(x, *ws)
    E, C, K = x.shape
    N = w.shape[-1]
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if (impl == "simt") != (x.dtype == torch.float32):
        raise TypeError(f"the {impl} route does not take {x.dtype}")
    if impl == "gemv" and C > GEMV_MAX_C:
        raise ValueError(f"the gemv route takes C <= {GEMV_MAX_C}, got C={C}")
    splits = _mm.gemv_plan(C, N, K, wb is not None, experts=E) if impl == "gemv" else 1
    out = torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    lib = build.library("moe")
    code = lib.hk_moe_grouped(x.data_ptr(), w.data_ptr(),
                              wb.data_ptr() if wb is not None else None, out.data_ptr(),
                              E, C, K, N, ACTS[act], DTYPES[x.dtype], IMPLS.index(impl), splits,
                              torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, "hk_moe_grouped")
    IMPL_LAUNCHES["moe_grouped_mm" if wb is None else "moe_grouped_gated"][impl] += 1
    return out


def combine(yd: torch.Tensor, gate: torch.Tensor, slot_of: torch.Tensor) -> torch.Tensor:
    """[T, H] in yd's dtype: each token's gated sum of its experts' rows.
    yd [E, C, H] (rows e * C + c), gate fp32 [T, k], slot_of int32 [T, k]
    with entries in [-1, E * C)."""
    if yd.device.type != "cuda":
        raise ValueError(f"CUDA MoE combine got a {yd.device} tensor")
    if yd.dtype not in DTYPES:
        raise TypeError(f"CUDA MoE combine takes fp32 or bf16, got {yd.dtype}")
    H = yd.shape[-1]
    if slot_of.dim() != 2 or gate.shape != slot_of.shape or H % 2 or H < 2:
        raise ValueError(f"need gate and slot_of [T, k] and an even H; got "
                         f"{tuple(gate.shape)}, {tuple(slot_of.shape)}, H={H}")
    if gate.dtype != torch.float32 or slot_of.dtype != torch.int32:
        raise TypeError("gate must be fp32 and slot_of int32")
    for t in (yd, gate, slot_of):
        if t.device != yd.device or not t.is_contiguous():
            raise ValueError("yd, gate and slot_of must be contiguous on one device")
    T, k = slot_of.shape
    out = torch.empty((T, H), dtype=yd.dtype, device=yd.device)
    lib = build.library("moe")
    code = lib.hk_moe_combine(yd.data_ptr(), gate.data_ptr(), slot_of.data_ptr(),
                              out.data_ptr(), T, k, H, DTYPES[yd.dtype],
                              torch.cuda.current_stream(yd.device).cuda_stream)
    build.check(lib, code, "hk_moe_combine")
    IMPL_LAUNCHES["moe_combine"]["token"] += 1
    return out
