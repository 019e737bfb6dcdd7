"""Plain PyTorch versions of the port's kernels.

Each computes exactly what its CUDA kernel computes, in fp32 from the
input dtype with one cast at the end.  The CPU path of ``kernels/ops.py``
runs these, and ``chip_smoke.py`` holds each kernel against its plain
version on the card.  Counterpart of ``repro/kernels/ref.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30        # masked score, as models/attention.py uses


def relu2(x: torch.Tensor) -> torch.Tensor:
    r = torch.relu(x)
    return r * r


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, which is what jax.nn.gelu computes by default."""
    return F.gelu(x, approximate="tanh")


# the kernels' epilogue activations by name
EPILOGUE_ACTS = {"none": lambda y: y, "relu2": relu2, "gelu": gelu, "silu": F.silu}


def _epilogue(y: torch.Tensor, act: str) -> torch.Tensor:
    if act not in EPILOGUE_ACTS:
        raise ValueError(f"unknown activation {act!r}")
    return EPILOGUE_ACTS[act](y)


def matmul_plain(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 act: str = "none") -> torch.Tensor:
    """act(x @ w + bias) in fp32, cast to x.dtype.  x [M,K], w [K,N]."""
    y = x.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    return _epilogue(y, act).to(x.dtype)


def gated_matmul_plain(x: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor,
                       *, act: str = "silu") -> torch.Tensor:
    """act(x @ w1) * (x @ w1b), both products and the gate in fp32 and one
    cast at the end, as the Pallas kernel's epilogue does."""
    return gated_products_plain(x, w1, w1b, act=act)[0]


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None, return_lse: bool = False):
    """Softmax attention with the mask of ``models/attention._sdpa``.

    q [B,nh,Sq,dh]; k,v [B,nkv,Sk,dh]; q-head h reads kv-head h // (nh/nkv).
    Key ``kpos`` is visible to query ``qpos`` of batch row b when
    ``kpos <= q_offset[b] + qpos`` (if causal) and ``kpos < kv_len[b]``;
    ``q_offset`` defaults to 0 and ``kv_len`` to Sk.  Masked scores are
    -1e30, so a row with no visible key averages all of v, as ``_sdpa``
    does.  ``return_lse`` also returns each row's log-sum-exp of the
    scaled, masked scores (fp32 [B,nh,Sq]), which the kernel's backward
    reads."""
    B, nh, Sq, dh = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    g = nh // nkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (dh ** -0.5)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((B, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[None, :]
        if q_offset is not None:
            qpos = qpos + q_offset.reshape(B, 1).to(q.device)
        mask &= kpos[None, None, :] <= qpos[:, :, None]
    if kv_len is not None:
        mask &= kpos[None, None, :] < kv_len.reshape(B, 1, 1).to(q.device)
    s = s.masked_fill(~mask[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True):
    """(dq, dk, dv) of :func:`attention_plain` under the training mask
    (q_offset 0, no kv_len): PyTorch's autograd of the plain forward, in
    the inputs' dtypes."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = attention_plain(qq, kk, vv, causal=causal)
        return torch.autograd.grad(o, (qq, kk, vv), do)


def tile_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w in fp32, stored in ``out_dtype`` (default x.dtype); either
    operand may be a transposed view.  The plain version of the tile
    matmul (``ring_matmul._tile_mm_raw``)."""
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


def gated_products_plain(x: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor, *,
                         act: str = "silu"):
    """(act(a) * b in x.dtype, a, b) with the fp32 products a = x @ w1 and
    b = x @ w1b: the gated kernel's output and the two products it keeps
    for the backward."""
    xf = x.float()
    a, b = xf @ w1.float(), xf @ w1b.float()
    return (_epilogue(a, act) * b).to(x.dtype), a, b


def _act_and_grad(a: torch.Tensor, act: str):
    if act == "silu":
        s = torch.sigmoid(a)
        return a * s, s * (1 + a * (1 - s))
    if act == "gelu":
        c = 0.7978845608028654                       # sqrt(2/pi)
        t = torch.tanh(c * (a + 0.044715 * a ** 3))
        return (0.5 * a * (1 + t),
                0.5 * (1 + t) + 0.5 * a * (1 - t * t) * c * (1 + 3 * 0.044715 * a * a))
    raise ValueError(f"the gated backward takes silu or gelu, got {act!r}")


def swiglu_bwd_plain(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                     act: str = "silu"):
    """(dA, dB) = (g * b * act'(a), g * act(a)) in fp32, cast to g.dtype:
    the elementwise derivative of the gated epilogue act(a) * b."""
    f, df = _act_and_grad(a.float(), act)
    gf = g.float()
    return (gf * b.float() * df).to(g.dtype), (gf * f).to(g.dtype)
