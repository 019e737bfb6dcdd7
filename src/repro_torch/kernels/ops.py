"""Dispatch between the CUDA kernels and their plain versions.

A tensor on the CPU takes the plain PyTorch version (``kernels/ref.py``);
a CUDA tensor launches the hand-written kernel or raises — there is no
fallback.  ``LAUNCHES`` counts kernel launches made through this module
(and through ``kernels/ring_matmul.py``, whose ring kernels count here
too), one per call that reached the card, so a run can show which
kernels its main path went through (:func:`reset_launches` zeroes it).
Counterpart of ``repro/kernels/ops.py``.

Training differentiates through these ops, each a ``torch.library``
custom op with a registered backward (the counterpart of the JAX
package's ``custom_vjp``, or of its autodiff through an einsum), so that
a selective-checkpoint policy (``core/schedule.py``) can name their
outputs:

* ``tile_matmul`` (``ring_matmul.tile_matmul``): backward dx = g wᵀ and
  dw = xᵀ g through the same tile kernel, with the transposed operands
  read in place;
* ``gated_matmul`` when its inputs need a gradient: the forward kernel
  also keeps the fp32 products a = x w1, b = x w1b; the backward is the
  SwiGLU-backward kernel and four tile products;
* ``attention`` when its inputs need a gradient: the forward kernel also
  writes the row log-sum-exp; the backward is the flash-attention
  backward kernel;
* the MoE's ``moe_grouped_gated`` (the grouped gated kernel keeping a
  and b; backward: the SwiGLU backward, two NT and two TN grouped
  products), ``moe_grouped_mm`` (backward: one NT, one TN),
  ``moe_combine`` (backward: the combine's backward kernel) and
  ``moe_dispatch`` (the gather; backward: the combine kernel with unit
  gates).  Their backwards use no atomics, so a step repeats bit for
  bit.  None of them is in ``SAVEABLE``: JAX's ``fusion`` policy saves
  no dot with a batch dim, and the experts' einsums carry e.

Without a gradient (:func:`needs_grad` false: serving, under
``inference_mode``) ``matmul``, ``gated_matmul``, ``attention`` and the
MoE's ops launch their forward kernels directly, without the custom
ops' dispatch cost on the host-bound decode tick; ``matmul``, ``ssd``
(the Mamba2 prefill scan) and ``mla_decode`` (MLA's absorbed decode
attention) are forward-only and raise when asked for a gradient.
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
                            "moe_combine": 0, "moe_grouped_nt": 0, "moe_grouped_tn": 0,
                            "moe_combine_bwd": 0, "moe_dispatch_bwd": 0}


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


def moe_grouped_gated(xd: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor, *,
                      act: str = "silu") -> torch.Tensor:
    """act(xd_e @ w1_e) * (xd_e @ w1b_e) for every expert, one launch;
    shapes of ``ref.grouped_gated_plain``.  Differentiable."""
    if needs_grad(xd, w1, w1b):
        return torch.ops.repro_torch.moe_grouped_gated(xd, w1, w1b, act)[0]
    if _on_cpu(xd):
        return _ref.grouped_gated_plain(xd, w1, w1b, act=act)
    out = _moe.grouped(xd, w1, w1b, act=act)
    LAUNCHES["moe_grouped_gated"] += 1
    return out


def moe_grouped_mm(h: torch.Tensor, w: torch.Tensor, *, act: str = "none") -> torch.Tensor:
    """act(h_e @ w_e) for every expert, one launch; shapes of
    ``ref.grouped_mm_plain``.  Differentiable: with a gradient the product
    is the custom op, and an activation follows it in PyTorch on the
    product in h's dtype (JAX's order: the cast, then ``act``)."""
    if needs_grad(h, w):
        y = torch.ops.repro_torch.moe_grouped_mm(h, w)
        return y if act == "none" else _ref.EPILOGUE_ACTS[act](y)
    if _on_cpu(h):
        return _ref.grouped_mm_plain(h, w, act=act)
    out = _moe.grouped(h, w, act=act)
    LAUNCHES["moe_grouped_mm"] += 1
    return out


def moe_combine(yd: torch.Tensor, gate: torch.Tensor, slot_of: torch.Tensor,
                slot_tok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each token's gated sum of its experts' rows in a fixed order;
    shapes of ``ref.moe_combine_plain``.  Differentiable in yd and gate,
    which needs ``slot_tok`` (``moe.combine_bwd``'s empty slots)."""
    if needs_grad(yd, gate):
        if slot_tok is None:
            raise ValueError("the combine's backward needs slot_tok (the dispatch's slots)")
        return torch.ops.repro_torch.moe_combine(yd, gate, slot_of, slot_tok)
    if _on_cpu(yd):
        return _ref.moe_combine_plain(yd, gate, slot_of)
    out = _moe.combine(yd, gate, slot_of)
    LAUNCHES["moe_combine"] += 1
    return out


def moe_dispatch(x: torch.Tensor, tok_of_slot: torch.Tensor, slot_valid: torch.Tensor,
                 slot_of: torch.Tensor) -> torch.Tensor:
    """The dispatch gather ``x[tok_of_slot] * slot_valid`` -> [E, C, H]
    (``ref.moe_dispatch_plain``, a PyTorch gather on every device).
    Differentiable in x: the backward sums each token's slot gradients
    through the combine kernel with unit gates, in a fixed order, where
    the gather's own backward would scatter-add with atomics."""
    if needs_grad(x):
        return torch.ops.repro_torch.moe_dispatch(x, tok_of_slot, slot_valid, slot_of)
    return _ref.moe_dispatch_plain(x, tok_of_slot, slot_valid)


# ---------------------------------------------------------------------------
# the MoE's grouped products, combine and dispatch with their backwards
# ---------------------------------------------------------------------------

def _grouped_t(x: torch.Tensor, w: torch.Tensor, layout: str) -> torch.Tensor:
    """A backward grouped product (``moe.grouped_t``): "nt" g w^T, "tn"
    x^T g."""
    if _on_cpu(x):
        plain = _ref.grouped_nt_plain if layout == "nt" else _ref.grouped_tn_plain
        return plain(x, w)
    out = _moe.grouped_t(x, w, layout=layout)
    LAUNCHES["moe_grouped_" + layout] += 1
    return out


@torch.library.custom_op("repro_torch::moe_grouped_gated", mutates_args=())
def _moe_gated_op(xd: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor,
                  act: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(act(a) * b, a, b) for every expert: the kernel keeps the fp32
    products a = xd_e w1_e, b = xd_e w1b_e."""
    if _on_cpu(xd):
        return _ref.grouped_gated_products_plain(xd, w1, w1b, act=act)
    out = _moe.grouped(xd, w1, w1b, act=act, keep_ab=True)
    LAUNCHES["moe_grouped_gated"] += 1
    return out


def _moe_gated_setup(ctx, inputs, output):
    xd, w1, w1b, act = inputs
    _, a, b = output
    ctx.act = act
    ctx.save_for_backward(xd, w1, w1b, a, b)


def _moe_gated_bwd(ctx, g, _ga, _gb):
    """``_gated_bwd`` grouped: the SwiGLU backward over the [E C, F] rows,
    then dxd = da w1^T + db w1b^T (NT) and dw1 = xd^T da, dw1b = xd^T db
    (TN), each in its operand's dtype."""
    xd, w1, w1b, a, b = ctx.saved_tensors
    g = g.to(xd.dtype).contiguous()
    if _on_cpu(g):
        da, db = _ref.swiglu_bwd_plain(g, a, b, act=ctx.act)
    else:
        da, db = _sw.swiglu_bwd(g, a, b, act=ctx.act)
        LAUNCHES["swiglu_bwd"] += 1
    dxd = _grouped_t(da, w1, "nt") + _grouped_t(db, w1b, "nt") \
        if ctx.needs_input_grad[0] else None
    dw1 = _grouped_t(xd, da, "tn") if ctx.needs_input_grad[1] else None
    dw1b = _grouped_t(xd, db, "tn") if ctx.needs_input_grad[2] else None
    return dxd, dw1, dw1b, None


_moe_gated_op.register_autograd(_moe_gated_bwd, setup_context=_moe_gated_setup)


@torch.library.custom_op("repro_torch::moe_grouped_mm", mutates_args=())
def _moe_mm_op(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h_e @ w_e for every expert (no activation: training applies it
    after the op)."""
    if _on_cpu(h):
        return _ref.grouped_mm_plain(h, w)
    out = _moe.grouped(h, w, grad=True)
    LAUNCHES["moe_grouped_mm"] += 1
    return out


def _moe_mm_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _moe_mm_bwd(ctx, g):
    """dh = g w^T (NT), dw = h^T g (TN); g cast to h's dtype."""
    h, w = ctx.saved_tensors
    g = g.to(h.dtype).contiguous()
    dh = _grouped_t(g, w, "nt") if ctx.needs_input_grad[0] else None
    dw = _grouped_t(h, g, "tn") if ctx.needs_input_grad[1] else None
    return dh, dw


_moe_mm_op.register_autograd(_moe_mm_bwd, setup_context=_moe_mm_setup)


@torch.library.custom_op("repro_torch::moe_combine", mutates_args=())
def _moe_combine_op(yd: torch.Tensor, gate: torch.Tensor, slot_of: torch.Tensor,
                    slot_tok: torch.Tensor) -> torch.Tensor:
    if _on_cpu(yd):
        return _ref.moe_combine_plain(yd, gate, slot_of)
    out = _moe.combine(yd, gate, slot_of)
    LAUNCHES["moe_combine"] += 1
    return out


def _moe_combine_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _moe_combine_bwd(ctx, dy):
    """(dyd, dgate) from the combine's backward kernel: no atomics."""
    yd, gate, slot_of, slot_tok = ctx.saved_tensors
    dy = dy.to(yd.dtype).contiguous()
    if _on_cpu(dy):
        dyd, dgate = _ref.moe_combine_bwd_plain(dy, yd, gate, slot_of)
    else:
        dyd, dgate = _moe.combine_bwd(dy, yd, gate, slot_of, slot_tok)
        LAUNCHES["moe_combine_bwd"] += 1
    return dyd, dgate, None, None


_moe_combine_op.register_autograd(_moe_combine_bwd, setup_context=_moe_combine_setup)


@torch.library.custom_op("repro_torch::moe_dispatch", mutates_args=())
def _moe_dispatch_op(x: torch.Tensor, tok_of_slot: torch.Tensor, slot_valid: torch.Tensor,
                     slot_of: torch.Tensor) -> torch.Tensor:
    return _ref.moe_dispatch_plain(x, tok_of_slot, slot_valid)


def _moe_dispatch_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[3])


def _moe_dispatch_bwd(ctx, dxd):
    """dx[t] = sum_j dxd[slot_of[t, j]]: the combine kernel with unit
    gates (``hk_moe_combine``), token-major in j order."""
    (slot_of,) = ctx.saved_tensors
    dxd = dxd.contiguous()
    if _on_cpu(dxd):
        return _ref.moe_dispatch_bwd_plain(dxd, slot_of), None, None, None
    ones = torch.ones(slot_of.shape, dtype=torch.float32, device=dxd.device)
    dx = _moe.combine(dxd, ones, slot_of)
    LAUNCHES["moe_dispatch_bwd"] += 1
    return dx, None, None, None


_moe_dispatch_op.register_autograd(_moe_dispatch_bwd, setup_context=_moe_dispatch_setup)


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
