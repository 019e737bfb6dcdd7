"""Dispatch between the CUDA kernels and their plain versions.

A tensor on the CPU takes the plain PyTorch version (``kernels/ref.py``);
a CUDA tensor launches the hand-written kernel or raises — there is no
fallback.  ``LAUNCHES`` counts kernel launches made through this module
(and through ``kernels/ring_matmul.py``, whose ring kernels count here
too), one per call that reached the card, so a run can show which
kernels its main path went through (:func:`reset_launches` zeroes it).
Counterpart of ``repro/kernels/ops.py``.

Training differentiates through three ops, each a ``torch.library``
custom op with a registered backward (the counterpart of the JAX
package's ``custom_vjp``), so that a selective-checkpoint policy
(``core/schedule.py``) can name their outputs:

* ``tile_matmul`` (``ring_matmul.tile_matmul``): backward dx = g wᵀ and
  dw = xᵀ g through the same tile kernel, with the transposed operands
  read in place;
* ``gated_matmul`` when its inputs need a gradient: the forward kernel
  also keeps the fp32 products a = x w1, b = x w1b; the backward is the
  SwiGLU-backward kernel and four tile products;
* ``attention`` when its inputs need a gradient: the forward kernel also
  writes the row log-sum-exp; the backward is the flash-attention
  backward kernel.

Without a gradient (:func:`needs_grad` false: serving, under
``inference_mode``) ``matmul``, ``gated_matmul`` and ``attention`` launch
their forward kernels directly, without the custom ops' dispatch cost on
the host-bound decode tick; ``matmul``, ``ssd`` (the Mamba2 prefill
scan), ``mla_decode`` (MLA's absorbed decode attention) and the MoE's
``moe_grouped_gated``, ``moe_grouped_mm`` and ``moe_combine`` (its
experts' grouped products and their token-major combine) are
forward-only and raise when asked for a gradient.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import moe as _moe
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import swiglu as _sw

LAUNCHES: Dict[str, int] = {"matmul": 0, "gated_matmul": 0, "flash_attention": 0,
                            "tile_matmul": 0, "swiglu_bwd": 0, "flash_attention_bwd": 0,
                            "ssd": 0, "ag_matmul": 0, "matmul_rs": 0,
                            "ag_matmul_contract": 0, "ag_matmul_int8": 0,
                            "matmul_rs_int8": 0, "ag_matmul_contract_int8": 0,
                            "mla_decode": 0, "moe_grouped_gated": 0, "moe_grouped_mm": 0,
                            "moe_combine": 0}


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and the attention, matmul, MoE, SSD and ring
    wrappers' per-path counts (``flash_attention.IMPL_LAUNCHES``,
    ``matmul.IMPL_LAUNCHES``, ``moe.IMPL_LAUNCHES``,
    ``ssd.IMPL_LAUNCHES``, ``ring_matmul.IMPL_LAUNCHES``)."""
    from repro_torch.kernels import ring_matmul as _rm   # it imports this module
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    _fa.reset_impl_launches()
    _mm.reset_impl_launches()
    _moe.reset_impl_launches()
    _ssd.reset_impl_launches()
    _rm.reset_impl_launches()


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel or plain path for device {x.device}")
    return False


def needs_grad(*ts) -> bool:
    """Whether autograd will differentiate through an op on these inputs:
    the one signal that picks a differentiable op over a forward kernel."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


# ---------------------------------------------------------------------------
# forward kernels (serving)
# ---------------------------------------------------------------------------

def matmul(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           *, act: str = "none") -> torch.Tensor:
    """act(x @ w + bias); x [M,K], w [K,N].  Forward only."""
    if needs_grad(x, w, bias):
        raise RuntimeError("ops.matmul has no backward; differentiable projections go "
                           "through ops.tile_matmul")
    if _on_cpu(x):
        return _ref.matmul_plain(x, w, bias, act=act)
    out = _mm.matmul(x, w, bias, act=act)
    LAUNCHES["matmul"] += 1
    return out


def gated_matmul(x: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor, *,
                 act: str = "silu") -> torch.Tensor:
    """act(x @ w1) * (x @ w1b); x [M,K], w1/w1b [K,N]."""
    if needs_grad(x, w1, w1b):
        return torch.ops.repro_torch.gated_matmul(x, w1, w1b, act)[0]
    if _on_cpu(x):
        return _ref.gated_matmul_plain(x, w1, w1b, act=act)
    out = _mm.gated_matmul(x, w1, w1b, act=act)
    LAUNCHES["gated_matmul"] += 1
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: Optional[torch.Tensor] = None,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,nh,Sq,dk]; k [B,nkv,Sk,dk]; v [B,nkv,Sk,dv] -> [B,nh,Sq,dv]
    (dv may differ from dk: MLA's 64 against 96); mask of
    ``ref.attention_plain``.  With a gradient, only the training mask (no
    q_offset, no kv_len)."""
    if needs_grad(q, k, v):
        if q_offset is not None or kv_len is not None:
            raise ValueError("the attention backward takes the training mask only "
                             "(no q_offset, no kv_len)")
        return torch.ops.repro_torch.attention(q, k, v, causal)[0]
    if _on_cpu(q):
        return _ref.attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                    kv_len=kv_len)
    out = _fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                              kv_len=kv_len)
    LAUNCHES["flash_attention"] += 1
    return out


def mla_decode(q_lat: torch.Tensor, q_rope: torch.Tensor, c_kv: torch.Tensor,
               k_rope: torch.Tensor, kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """MLA's absorbed decode attention: o_lat fp32 [B, nh, L]; shapes of
    ``ref.mla_decode_plain``.  Forward only."""
    if needs_grad(q_lat, q_rope, c_kv, k_rope):
        raise RuntimeError("ops.mla_decode has no backward; MLA trains through the "
                           "prefill form (ops.attention)")
    if _on_cpu(q_lat):
        return _ref.mla_decode_plain(q_lat, q_rope, c_kv, k_rope, kv_len, scale)
    out = _fa.mla_decode(q_lat, q_rope, c_kv, k_rope, kv_len, scale)
    LAUNCHES["mla_decode"] += 1
    return out


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, chunk: int, init_state: Optional[torch.Tensor] = None):
    """Mamba2 SSD chunked scan: (y in x's dtype, fp32 final state); shapes
    of ``ref.ssd_plain``.  Forward only."""
    if needs_grad(x, dt, A, B, C, init_state):
        raise RuntimeError("ops.ssd has no backward; SSM training is not ported yet")
    if _on_cpu(x):
        return _ref.ssd_plain(x, dt, A, B, C, chunk=chunk, init_state=init_state)
    out = _ssd.ssd(x, dt, A, B, C, chunk=chunk, init_state=init_state)
    LAUNCHES["ssd"] += 1
    return out


def _moe_forward_only(what: str, *ts) -> None:
    if needs_grad(*ts):
        raise RuntimeError(f"ops.{what} has no backward; MoE training is not ported yet")


def moe_grouped_gated(xd: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor, *,
                      act: str = "silu") -> torch.Tensor:
    """act(xd_e @ w1_e) * (xd_e @ w1b_e) for every expert, one launch;
    shapes of ``ref.grouped_gated_plain``.  Forward only."""
    _moe_forward_only("moe_grouped_gated", xd, w1, w1b)
    if _on_cpu(xd):
        return _ref.grouped_gated_plain(xd, w1, w1b, act=act)
    out = _moe.grouped(xd, w1, w1b, act=act)
    LAUNCHES["moe_grouped_gated"] += 1
    return out


def moe_grouped_mm(h: torch.Tensor, w: torch.Tensor, *, act: str = "none") -> torch.Tensor:
    """act(h_e @ w_e) for every expert, one launch; shapes of
    ``ref.grouped_mm_plain``.  Forward only."""
    _moe_forward_only("moe_grouped_mm", h, w)
    if _on_cpu(h):
        return _ref.grouped_mm_plain(h, w, act=act)
    out = _moe.grouped(h, w, act=act)
    LAUNCHES["moe_grouped_mm"] += 1
    return out


def moe_combine(yd: torch.Tensor, gate: torch.Tensor, slot_of: torch.Tensor) -> torch.Tensor:
    """Each token's gated sum of its experts' rows in a fixed order;
    shapes of ``ref.moe_combine_plain``.  Forward only."""
    _moe_forward_only("moe_combine", yd, gate)
    if _on_cpu(yd):
        return _ref.moe_combine_plain(yd, gate, slot_of)
    out = _moe.combine(yd, gate, slot_of)
    LAUNCHES["moe_combine"] += 1
    return out


# ---------------------------------------------------------------------------
# the tile matmul (forward and backward products)
# ---------------------------------------------------------------------------

def _tile(x: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype]):
    if _on_cpu(x):
        return _ref.tile_matmul_plain(x, w, out_dtype=out_dtype)
    out = _mm.tile_matmul(x, w, out_dtype=out_dtype)
    LAUNCHES["tile_matmul"] += 1
    return out


@torch.library.custom_op("repro_torch::tile_matmul", mutates_args=())
def _tile_matmul_op(x: torch.Tensor, w: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return _tile(x, w, out_dtype)


def _tile_setup(ctx, inputs, output):
    x, w, _ = inputs
    ctx.save_for_backward(x, w)


def _tile_bwd(ctx, g):
    """``_tile_mm_bwd``: g is cast to x's dtype; dx comes out in x's dtype,
    dw in w's, both through the tile kernel (NT and TN)."""
    x, w = ctx.saved_tensors
    g = g.to(x.dtype)
    dx = _tile(g, w.t(), x.dtype) if ctx.needs_input_grad[0] else None
    dw = _tile(x.t(), g, w.dtype) if ctx.needs_input_grad[1] else None
    return dx, dw, None


_tile_matmul_op.register_autograd(_tile_bwd, setup_context=_tile_setup)


def tile_matmul(x: torch.Tensor, w: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w with fp32 sums, stored in ``out_dtype`` (x's dtype or fp32);
    differentiable.  Either operand may be a transposed view."""
    return torch.ops.repro_torch.tile_matmul(x, w, out_dtype)


def tile_mm(x: torch.Tensor, w: torch.Tensor, *, out_dtype: Optional[torch.dtype] = None,
            plain: bool = False) -> torch.Tensor:
    """x [..., h] @ w [h, o] through :func:`tile_matmul` (x's dtype unless
    ``out_dtype``); ``plain`` takes its plain version (the reference path)."""
    tile = _ref.tile_matmul_plain if plain else tile_matmul
    y = tile(x.reshape(-1, x.shape[-1]), w, out_dtype=out_dtype or x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# the gated matmul with its backward
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::gated_matmul", mutates_args=())
def _gated_op(x: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor,
              act: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(act(a) * b, a, b): the kernel keeps the fp32 products a, b."""
    if _on_cpu(x):
        return _ref.gated_products_plain(x, w1, w1b, act=act)
    out = _mm.gated_matmul(x, w1, w1b, act=act, keep_ab=True)
    LAUNCHES["gated_matmul"] += 1
    return out


def _gated_setup(ctx, inputs, output):
    x, w1, w1b, act = inputs
    _, a, b = output
    ctx.act = act
    ctx.save_for_backward(x, w1, w1b, a, b)


def _gated_bwd(ctx, g, _ga, _gb):
    x, w1, w1b, a, b = ctx.saved_tensors
    g = g.to(x.dtype).contiguous()
    if _on_cpu(g):
        da, db = _ref.swiglu_bwd_plain(g, a, b, act=ctx.act)
    else:
        da, db = _sw.swiglu_bwd(g, a, b, act=ctx.act)
        LAUNCHES["swiglu_bwd"] += 1
    dx = _tile(da, w1.t(), x.dtype) + _tile(db, w1b.t(), x.dtype) \
        if ctx.needs_input_grad[0] else None
    dw1 = _tile(x.t(), da, w1.dtype) if ctx.needs_input_grad[1] else None
    dw1b = _tile(x.t(), db, w1b.dtype) if ctx.needs_input_grad[2] else None
    return dx, dw1, dw1b, None


_gated_op.register_autograd(_gated_bwd, setup_context=_gated_setup)


# ---------------------------------------------------------------------------
# attention with its backward
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::attention", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(o [B,nh,Sq,dv], lse) under the training mask; q and k at dk, v at
    dv."""
    if _on_cpu(q):
        return _ref.attention_plain(q, k, v, causal=causal, return_lse=True)
    out = _fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    LAUNCHES["flash_attention"] += 1
    return out


def _attention_setup(ctx, inputs, output):
    q, k, v, causal = inputs
    o, lse = output
    ctx.causal = causal
    ctx.save_for_backward(q, k, v, o, lse)


def _attention_bwd(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    do = do.to(q.dtype)
    if _on_cpu(q):
        return (*_ref.attention_bwd_plain(q, k, v, do, causal=ctx.causal), None)
    if do.stride(-1) != 1:
        do = do.contiguous()
    dq, dk, dv = _fa.flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal)
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv, None


_attention_op.register_autograd(_attention_bwd, setup_context=_attention_setup)

# the ops whose outputs the "fusion" remat policy keeps (core/schedule.py)
SAVEABLE = (torch.ops.repro_torch.tile_matmul.default,
            torch.ops.repro_torch.gated_matmul.default)
