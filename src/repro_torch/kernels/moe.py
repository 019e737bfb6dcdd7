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
  the same sum every run.  With unit gates it is also the dispatch
  gather's backward (``kernels/ops.py``, ``moe_dispatch``).

For training (the derivatives of the same einsums, which JAX takes with
``jax.value_and_grad``):

* :func:`grouped` with ``keep_ab`` also returns the gated form's fp32
  products ``a = x_e @ w_e`` and ``b = x_e @ wb_e`` (for the SwiGLU
  backward kernel), and with ``grad`` (implied by ``keep_ab``) takes the
  wgmma route at any C;
* :func:`grouped_t` computes the two backward layouts: ``"nt"``,
  ``g_e @ w_e.T`` with w [E, K, N] read transposed in place (dx), and
  ``"tn"``, ``x_e.T @ g_e`` contracted over the expert's C rows (dw);
* :func:`combine_bwd` computes the combine's derivative: ``dyd[s] =
  gate[t, j] * dy[t]`` (zero for an empty slot) and ``dgate[t, j] =
  dy[t] . yd[s]`` (zero for a dropped assignment), one block a token,
  no atomics.

The products take one of three routes (``IMPLS``), which
:func:`grouped_impl` chooses from the dtype, C and whether the product
is differentiated (the operands are contiguous, which the wrapper
checks):

* ``"wgmma"``: bf16 with C > 16 (a prefill), and bf16 at any C in
  training (every layout, the kept products): ``wg::mm``'s persistent
  TMA and wgmma loop with the expert a third coordinate of the work unit,
  read through 3-D TMA maps, so a tile never reads across an expert;
* ``"gemv"``: bf16 with C <= 16 when serving (decode): row 1/2's
  ``gv::gemv`` (``csrc/matmul.cuh``) with the expert in the grid, K split
  over a cluster (``matmul.gemv_plan`` with ``experts``); it has no kept
  products and no NT or TN layout;
* ``"simt"``: fp32, row 1's SIMT tile (``matmul.cuh``'s ``mm_simt_f32``)
  with the expert in the grid, in every layout, held to 2e-4.

:func:`launch` runs one product on a route named by its caller (the
card's tests hold a route on shapes the main path does not send it); a
route that cannot take the operands raises, and nothing falls back to
another.  CUDA tensors only; the CPU path lives in ``kernels/ops.py``.
``IMPL_LAUNCHES`` counts the launches of each route (the combine and its
backward have one, ``"token"``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matmul as _mm

ACTS = _mm.ACTS
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
IMPLS = ("wgmma", "gemv", "simt")     # numbered as csrc/moe.cu's IMPL_*
LAYOUTS = ("nn", "nt", "tn")          # numbered as csrc/moe.cu's LAYOUT_*
GEMV_MAX_C = 16                       # rows an expert at or below which bf16 serving takes gemv

# launches per route, counted where each wrapper launches its kernel
IMPL_LAUNCHES: Dict[str, Dict[str, int]] = {
    "moe_grouped_gated": {p: 0 for p in IMPLS},
    "moe_grouped_mm": {p: 0 for p in IMPLS},
    "moe_grouped_nt": {p: 0 for p in IMPLS},
    "moe_grouped_tn": {p: 0 for p in IMPLS},
    "moe_combine": {"token": 0},
    "moe_combine_bwd": {"token": 0}}


def reset_impl_launches() -> None:
    """Zero ``IMPL_LAUNCHES``."""
    for counts in IMPL_LAUNCHES.values():
        for path in counts:
            counts[path] = 0


def grouped_impl(dtype: torch.dtype, C: int, grad: bool = False) -> str:
    """The route of one grouped product with C rows an expert: ``"simt"``
    for fp32; for bf16 ``"wgmma"`` when the product is differentiated
    (``grad``: the kept products and the NT and TN layouts are wgmma's
    alone), else ``"gemv"`` for C <= 16 and ``"wgmma"`` above."""
    if dtype != torch.bfloat16:
        return "simt"
    return "gemv" if C <= GEMV_MAX_C and not grad else "wgmma"


def _dims(x: torch.Tensor, w: torch.Tensor, layout: str):
    """(E, M, K, N) of out [E, M, N] = A_e B_e over K for ``layout``: A = x
    [E, M, K] (or "tn": x [E, K, M]), B = w [E, K, N] (or "nt": w [E, N,
    K])."""
    if x.dim() != 3 or w.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"x and w must be 3-D stacks, got {tuple(x.shape)}, {tuple(w.shape)}")
    E = x.shape[0]
    M, K = (x.shape[2], x.shape[1]) if layout == "tn" else (x.shape[1], x.shape[2])
    N = w.shape[1] if layout == "nt" else w.shape[2]
    want = (E, N, K) if layout == "nt" else (E, K, N)
    if tuple(w.shape) != want:
        raise ValueError(f"layout {layout}: w must be {list(want)}, got {tuple(w.shape)}")
    return E, M, K, N


def _check(x: torch.Tensor, *ws: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"CUDA MoE kernel got a {x.device} tensor")
    if x.dtype not in DTYPES:
        raise TypeError(f"CUDA MoE kernel takes fp32 or bf16, got {x.dtype}")
    for t in (x, *ws):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError("operands must share x's device and dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte aligned")


def grouped(x: torch.Tensor, w: torch.Tensor, wb: Optional[torch.Tensor] = None, *,
            act: str = "none", keep_ab: bool = False, grad: bool = False):
    """[E, C, N] in x's dtype: ``act(x_e @ w_e)``, or with ``wb``
    ``act(x_e @ w_e) * (x_e @ wb_e)``, for every expert, one launch on
    :func:`grouped_impl`'s route (``grad``: differentiated).  With
    ``keep_ab`` (gated) also the fp32 products: (out, a, b)."""
    C = x.shape[1] if x.dim() == 3 else 0        # launch refuses any other x
    return launch(x, w, wb, act=act, keep_ab=keep_ab,
                  impl=grouped_impl(x.dtype, C, grad or keep_ab))


def grouped_t(x: torch.Tensor, w: torch.Tensor, *, layout: str) -> torch.Tensor:
    """The backward's grouped products, [E, M, N] in x's dtype with fp32
    sums: ``"nt"``, x [E, M, K] @ w [E, N, K] transposed (dx = g w^T), or
    ``"tn"``, x [E, K, M] transposed @ w [E, K, N] (dw = x^T g), on the
    wgmma (bf16) or simt (fp32) route."""
    if layout not in ("nt", "tn"):
        raise ValueError(f"grouped_t takes layout 'nt' or 'tn', got {layout!r}")
    C = x.shape[1] if x.dim() == 3 else 0
    return launch(x, w, layout=layout, impl=grouped_impl(x.dtype, C, grad=True))


def launch(x: torch.Tensor, w: torch.Tensor, wb: Optional[torch.Tensor] = None, *,
           act: str = "none", impl: str, layout: str = "nn", keep_ab: bool = False):
    """One grouped product on the route ``impl``, which raises where it
    cannot take the operands: :func:`grouped`'s (``layout`` "nn") or
    :func:`grouped_t`'s."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    ws = (w,) if wb is None else (w, wb)
    _check(x, *ws)
    E, M, K, N = _dims(x, w, layout)
    if wb is not None and (layout != "nn" or tuple(wb.shape) != tuple(w.shape)):
        raise ValueError("the gated form is NN, wb shaped as w")
    if keep_ab and wb is None:
        raise ValueError("keep_ab keeps the gated form's products")
    if N % 8 or (M if layout == "tn" else K) % 8:
        raise ValueError(f"N={N} and the stored rows (K={K}, or tn's M={M}) must be "
                         "multiples of 8")
    if (impl == "simt") != (x.dtype == torch.float32):
        raise TypeError(f"the {impl} route does not take {x.dtype}")
    if impl == "gemv" and (M > GEMV_MAX_C or layout != "nn" or keep_ab):
        raise ValueError(f"the gemv route takes C <= {GEMV_MAX_C} in an NN product with no "
                         f"kept products; got C={M}, layout {layout}, keep_ab={keep_ab}")
    splits = _mm.gemv_plan(M, N, K, wb is not None, experts=E) if impl == "gemv" else 1
    out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    ab = [torch.empty((E, M, N), dtype=torch.float32, device=x.device)
          for _ in range(2)] if keep_ab else [None, None]
    lib = build.library("moe")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    code = lib.hk_moe_grouped(x.data_ptr(), w.data_ptr(), ptr(wb), out.data_ptr(),
                              ptr(ab[0]), ptr(ab[1]), E, M, K, N, ACTS[act], DTYPES[x.dtype],
                              IMPLS.index(impl), splits, LAYOUTS.index(layout),
                              torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, "hk_moe_grouped")
    name = {"nt": "moe_grouped_nt", "tn": "moe_grouped_tn"}.get(
        layout, "moe_grouped_mm" if wb is None else "moe_grouped_gated")
    IMPL_LAUNCHES[name][impl] += 1
    return (out, *ab) if keep_ab else out


def _check_slots(yd: torch.Tensor, gate: torch.Tensor, slot_of: torch.Tensor) -> None:
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


def combine(yd: torch.Tensor, gate: torch.Tensor, slot_of: torch.Tensor) -> torch.Tensor:
    """[T, H] in yd's dtype: each token's gated sum of its experts' rows.
    yd [E, C, H] (rows e * C + c), gate fp32 [T, k], slot_of int32 [T, k]
    with entries in [-1, E * C)."""
    _check_slots(yd, gate, slot_of)
    H = yd.shape[-1]
    T, k = slot_of.shape
    out = torch.empty((T, H), dtype=yd.dtype, device=yd.device)
    lib = build.library("moe")
    code = lib.hk_moe_combine(yd.data_ptr(), gate.data_ptr(), slot_of.data_ptr(),
                              out.data_ptr(), T, k, H, DTYPES[yd.dtype],
                              torch.cuda.current_stream(yd.device).cuda_stream)
    build.check(lib, code, "hk_moe_combine")
    IMPL_LAUNCHES["moe_combine"]["token"] += 1
    return out


def combine_bwd(dy: torch.Tensor, yd: torch.Tensor, gate: torch.Tensor,
                slot_of: torch.Tensor, slot_tok: torch.Tensor):
    """(dyd shaped as yd in its dtype, dgate fp32 [T, k]): the combine's
    derivative for the gradient dy [T, H] of its output.  slot_tok int32
    [E, C] is each slot's assignment t k + j, or at least T k for an empty
    slot (``mlp._dispatch_indices``), whose row of dyd is zeroed."""
    _check_slots(yd, gate, slot_of)
    H = yd.shape[-1]
    T, k = slot_of.shape
    rows = yd.numel() // H
    if dy.shape != (T, H) or dy.dtype != yd.dtype or dy.device != yd.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous [{T}, {H}] in yd's dtype, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if slot_tok.numel() != rows or slot_tok.dtype != torch.int32 \
            or slot_tok.device != yd.device or not slot_tok.is_contiguous():
        raise ValueError(f"slot_tok must be contiguous int32 with {rows} entries")
    dyd = torch.empty_like(yd)
    dgate = torch.empty((T, k), dtype=torch.float32, device=yd.device)
    lib = build.library("moe")
    code = lib.hk_moe_combine_bwd(dy.data_ptr(), yd.data_ptr(), gate.data_ptr(),
                                  slot_of.data_ptr(), slot_tok.data_ptr(), dyd.data_ptr(),
                                  dgate.data_ptr(), T, k, rows, H, DTYPES[yd.dtype],
                                  torch.cuda.current_stream(yd.device).cuda_stream)
    build.check(lib, code, "hk_moe_combine_bwd")
    IMPL_LAUNCHES["moe_combine_bwd"]["token"] += 1
    return dyd, dgate
