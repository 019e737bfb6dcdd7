"""Plain PyTorch versions of the port's kernels.

Each computes exactly what its CUDA kernel computes, in fp32 from the
input dtype with one cast at the end (``ssd_plain`` also returns its fp32
state).  The CPU path of ``kernels/ops.py``
runs these, and ``chip_smoke.py`` holds each kernel against its plain
version on the card.  Counterpart of ``repro/kernels/ref.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import quant as Q
from repro_torch.parallel import comm

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

    q [B,nh,Sq,dk]; k [B,nkv,Sk,dk]; v [B,nkv,Sk,dv], any dv (MLA's 64
    against dk 96), giving o [B,nh,Sq,dv]; the scale is dk^-0.5; q-head h
    reads kv-head h // (nh/nkv).
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


def mla_decode_plain(q_lat: torch.Tensor, q_rope: torch.Tensor, c_kv: torch.Tensor,
                     k_rope: torch.Tensor, kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """Absorbed MLA decode (``models/attention.apply_mla``'s decode form):
    every query head attends over one shared latent kv head.

    q_lat [B,nh,L] and q_rope [B,nh,R] (the query already absorbed into
    the latent, and its rotary part); c_kv [B,T,L] and k_rope [B,T,R] (the
    latent cache); kv_len [B] masks positions ``>= kv_len[b]``.  The score
    is ``(q_lat . c_kv + q_rope . k_rope) * scale``, masked to -1e30 and
    softmaxed over T; returns ``o_lat = p . c_kv`` in fp32 [B,nh,L], all
    in fp32 from the inputs' dtype."""
    B, T = c_kv.shape[0], c_kv.shape[1]
    s = (torch.einsum("bhl,btl->bht", q_lat.float(), c_kv.float())
         + torch.einsum("bhr,btr->bht", q_rope.float(), k_rope.float())) * scale
    mask = torch.arange(T, device=c_kv.device)[None, :] < kv_len.reshape(B, 1).to(c_kv.device)
    p = torch.softmax(s.masked_fill(~mask[:, None, :], NEG_INF), dim=-1)
    return torch.einsum("bht,btl->bhl", p, c_kv.float())


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True):
    """(dq, dk, dv) of :func:`attention_plain` under the training mask
    (q_offset 0, no kv_len), at any dv: PyTorch's autograd of the plain
    forward, in the inputs' dtypes and shapes."""
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


def grouped_gated_plain(xd: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor, *,
                        act: str = "silu") -> torch.Tensor:
    """act(xd_e @ w1_e) * (xd_e @ w1b_e) for every expert e: xd [E,C,H],
    w1 and w1b [E,H,F] -> [E,C,F] in xd.dtype; both products and the gate
    in fp32, one cast (``moe::grouped_gated``)."""
    xf = xd.float()
    return (_epilogue(torch.bmm(xf, w1.float()), act) * torch.bmm(xf, w1b.float())
            ).to(xd.dtype)


def grouped_mm_plain(h: torch.Tensor, w: torch.Tensor, *, act: str = "none") -> torch.Tensor:
    """act(h_e @ w_e) for every expert e: h [E,C,K], w [E,K,N] -> [E,C,N]
    in h.dtype, fp32 sums and one cast (``moe::grouped_mm``)."""
    return _epilogue(torch.bmm(h.float(), w.float()), act).to(h.dtype)


def moe_combine_plain(yd: torch.Tensor, gate: torch.Tensor,
                      slot_of: torch.Tensor) -> torch.Tensor:
    """The token-major combine of the experts' rows (``moe::combine``):
    ``y[t] = sum_j gate[t,j] * yd[slot_of[t,j]]`` over the valid j
    (``slot_of >= 0``; -1 is a dropped assignment) in j order, each
    product and sum in fp32, one cast.  yd [E,C,H] (its rows numbered
    e*C + c), gate fp32 [T,k], slot_of int [T,k] -> [T,H] in yd.dtype."""
    H = yd.shape[-1]
    rows = yd.reshape(-1, H).float()
    y = torch.zeros((slot_of.shape[0], H), dtype=torch.float32, device=yd.device)
    for j in range(slot_of.shape[1]):
        s = slot_of[:, j].long()
        term = gate[:, j, None].float() * rows[s.clamp(min=0)]
        y = torch.where((s >= 0)[:, None], y + term, y)
    return y.to(yd.dtype)


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


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., Q] -> pairwise sums over (j, i] as ``cum_i - cum_j`` on the
    lower triangle, -inf above it (``models/ssm.py::_segsum``).  The
    difference is formed before any exp: exp(cum_i) * exp(-cum_j) would
    overflow fp32 once a chunk's decay passes ~88."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return d.masked_fill(~tri, -torch.inf)


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, *, chunk: int, init_state: Optional[torch.Tensor] = None):
    """Mamba2 SSD chunked scan, the plain version of the ``ssd`` kernel and
    the counterpart of ``repro/models/ssm.py::ssd_chunked``.

    x [b,S,nh,dh]; dt [b,S,nh] (post-softplus); A [nh] (negative); B, C
    [b,S,g,ds] with g groups shared by nh/g heads each; ``init_state``
    [b,nh,dh,ds] (zeros when None).  Returns (y [b,S,nh,dh] in x's dtype,
    without the D skip; the fp32 final state [b,nh,dh,ds]).  A ragged tail
    is padded with dt = 0 steps (decay 1, no input), which leave the
    output rows (cut off) and the carried state unchanged."""
    b, S, nh, dh = x.shape
    g, ds = B.shape[2], B.shape[3]
    pad = -S % chunk
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc, hpg = (S + pad) // chunk, nh // g
    xc = x.reshape(b, nc, chunk, nh, dh).float()
    dtc = dt.reshape(b, nc, chunk, nh).float()
    Bh = B.reshape(b, nc, chunk, g, ds).float().repeat_interleave(hpg, dim=3)
    Ch = C.reshape(b, nc, chunk, g, ds).float().repeat_interleave(hpg, dim=3)

    dA = dtc * A.float()                                       # [b,nc,Q,nh]
    dAcum = torch.cumsum(dA, dim=2)
    # intra-chunk: the attention-like masked product
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))          # [b,nc,nh,Q,Q]
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh) * Lmat
    y_diag = torch.einsum("bchqk,bckhd->bcqhd", scores, xc * dtc[..., None])
    # each chunk's contribution to the state, then the inter-chunk recurrence
    decay_to_end = torch.exp(dAcum[:, :, -1:, :] - dAcum)      # [b,nc,Q,nh]
    states = torch.einsum("bcqhn,bcqh,bcqhd->bchdn", Bh, decay_to_end * dtc, xc)
    chunk_decay = torch.exp(dAcum[:, :, -1, :])                # [b,nc,nh]
    h = (torch.zeros((b, nh, dh, ds), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prevs = []
    for c in range(nc):
        prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prevs = torch.stack(prevs, dim=1)                          # [b,nc,nh,dh,ds]
    # the carried state's contribution
    y_off = torch.einsum("bcqhn,bchdn,bcqh->bcqhd", Ch, prevs, torch.exp(dAcum))
    y = (y_diag + y_off).reshape(b, S + pad, nh, dh)[:, :S]
    return y.to(x.dtype), h


def _split_bf16(t: torch.Tensor):
    """fp32 t as bf16 hi + lo (each returned as fp32): hi = bf16(t), lo =
    bf16(t - hi); hi + lo is t to about 2^-16 relative."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def ssd_tc_emulated(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, *, chunk: int, init_state: Optional[torch.Tensor] = None,
                    split_scores: bool = True, split_state: bool = True,
                    split_h: bool = True):
    """The arithmetic of the SSD kernel's tensor-core route (``tc::ssd`` in
    ``csrc/ssd.cu``), in plain PyTorch, for the tests: ``ssd_plain``'s
    contract with the kernel's roundings.  x, B and C are read as bf16
    (the route's input dtype); every product sums in fp32.  Per chunk:

    * the scores (C_i . B_j) exp(cum_i - cum_j) dt_j on j <= i, split into
      bf16 hi + lo (the register A operands of y_diag = S x);
    * the chunk's state contribution (x o w)^T B with w = exp(cum_last -
      cum) dt, x o w split into bf16 hi + lo;
    * y_off = exp(cum_i) C_i . h_prev^T with the fp32 carried state split
      into bf16 hi + lo;
    * the carry h_c = exp(cum_last) h_{c-1} + states_c in fp32.

    ``split_scores``, ``split_state`` and ``split_h`` False round that
    operand to bf16 once instead: the cheaper plans the kernel does not
    take (tests/test_torch_ssd_tc.py shows what they would cost)."""
    b, S, nh, dh = x.shape
    g, ds = B.shape[2], B.shape[3]
    pad = -S % chunk
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc, hpg = (S + pad) // chunk, nh // g
    bf = lambda t: t.to(torch.bfloat16).float()
    xc = bf(x.reshape(b, nc, chunk, nh, dh))
    dtc = dt.reshape(b, nc, chunk, nh).float()
    Bh = bf(B.reshape(b, nc, chunk, g, ds)).repeat_interleave(hpg, dim=3)
    Ch = bf(C.reshape(b, nc, chunk, g, ds)).repeat_interleave(hpg, dim=3)

    cum = torch.cumsum(dtc * A.float(), dim=2)                 # [b,nc,Q,nh]
    Lmat = torch.exp(_segsum((dtc * A.float()).permute(0, 1, 3, 2)))   # [b,nc,nh,Q,Q]
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh) * Lmat * \
        dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    parts = _split_bf16(scores) if split_scores else (bf(scores),)
    y = sum(torch.einsum("bchqk,bckhd->bcqhd", p, xc) for p in parts)
    xw = xc * (torch.exp(cum[:, :, -1:, :] - cum) * dtc)[..., None]   # [b,nc,Q,nh,dh]
    parts = _split_bf16(xw) if split_state else (bf(xw),)
    states = sum(torch.einsum("bcqhd,bcqhn->bchdn", p, Bh) for p in parts)
    h = (torch.zeros((b, nh, dh, ds), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    for c in range(nc):
        hs = _split_bf16(h) if split_h else (bf(h),)
        off = sum(torch.einsum("bqhn,bhdn->bqhd", Ch[:, c], p) for p in hs)
        y[:, c] += off * torch.exp(cum[:, c])[..., None]
        h = h * torch.exp(cum[:, c, -1])[..., None, None] + states[:, c]
    return y.reshape(b, S + pad, nh, dh)[:, :S].to(x.dtype), h


def ssd_seq_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor) -> torch.Tensor:
    """The sequential (non-chunked) SSD recurrence, the strongest oracle
    (``repro/kernels/ref.py::ssd_ref``): h_t = h_{t-1} exp(dt_t A) +
    dt_t x_t B_t^T, y_t = h_t C_t.  Shapes as :func:`ssd_plain`."""
    b, S, nh, dh = x.shape
    g, ds = B.shape[2], B.shape[3]
    hpg = nh // g
    Bh = B.float().repeat_interleave(hpg, dim=2)
    Ch = C.float().repeat_interleave(hpg, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = torch.zeros((b, nh, dh, ds), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t] * Af)[..., None, None]
        h = h * dA + torch.einsum("bhd,bhn->bhdn", xf[:, t] * dtf[:, t, :, None], Bh[:, t])
        ys.append(torch.einsum("bhdn,bhn->bhd", h, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


# ---------------------------------------------------------------------------
# the ring collective matmuls (per rank, inside a grid world)
# ---------------------------------------------------------------------------
# Each is one rank's part of the collective, written with the bulk
# collectives of ``parallel/comm.py`` and one matmul in fp32, then cast:
# what the ring kernels (``csrc/ring_matmul.cu``) compute with the ring
# inside one launch.

def ag_matmul_plain(x: torch.Tensor, w: torch.Tensor, ax: str, *, dim: int = 1) -> torch.Tensor:
    """all_gather(x over ``ax`` along ``dim``) @ w; x [b,t,h], w [h,o]."""
    return (comm.raw_all_gather(x, ax, dim).float() @ w.float()).to(x.dtype)


def matmul_rs_plain(x: torch.Tensor, w: torch.Tensor, ax: str, *,
                    scatter_dim: int) -> torch.Tensor:
    """psum_scatter(x @ w over ``ax`` along ``scatter_dim``), summed in fp32."""
    return comm.raw_psum_scatter(x.float() @ w.float(), ax, scatter_dim).to(x.dtype)


def ag_matmul_contract_plain(x: torch.Tensor, w: torch.Tensor, ax: str, *,
                             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """all_gather(x over ``ax`` along its last dim) @ w: the gathered dim is
    contracted; w [n*h_loc, o]."""
    xg = comm.raw_all_gather(x, ax, x.dim() - 1)
    return (xg.float() @ w.float()).to(out_dtype or x.dtype)


def matmul_rs_pair_plain(x: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor, ax: str, *,
                         scatter_dim: int):
    """(x @ w1, x @ w1b), each reduce-scattered as :func:`matmul_rs_plain`."""
    return (matmul_rs_plain(x, w1, ax, scatter_dim=scatter_dim),
            matmul_rs_plain(x, w1b, ax, scatter_dim=scatter_dim))


# ---------------------------------------------------------------------------
# the int8 wire (comm_dtype="int8"): what the ring kernels' int8 variants
# compute, the ring's emulated semantics of the JAX package
# ---------------------------------------------------------------------------

def gather_over_int8(x: torch.Tensor, ax: str, dim: int) -> torch.Tensor:
    """all_gather(x over ``ax`` along ``dim``) as the int8 wire delivers it:
    every other rank's shard quantized once per row, gathered and
    dequantized into x's dtype; this rank's own shard exact, as the ring
    uses it at step 0."""
    q, s = Q.quant_int8(x)
    d = Q.dequant_int8(comm.raw_all_gather(q[None], ax, 0), comm.raw_all_gather(s[None], ax, 0),
                       x.dtype)
    d[comm.axis_index(ax)] = x
    return torch.cat(list(d.unbind(0)), dim=dim)


def ag_matmul_int8_plain(x: torch.Tensor, w: torch.Tensor, ax: str, *,
                         dim: int = 1) -> torch.Tensor:
    """:func:`ag_matmul_plain` with the other ranks' shards over the int8 wire."""
    return (gather_over_int8(x, ax, dim).float() @ w.float()).to(x.dtype)


def ag_matmul_contract_int8_plain(x: torch.Tensor, w: torch.Tensor, ax: str, *,
                                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`ag_matmul_contract_plain` with the other ranks' shards over the
    int8 wire; the fp32 sum is never quantized."""
    xg = gather_over_int8(x, ax, x.dim() - 1)
    return (xg.float() @ w.float()).to(out_dtype or x.dtype)


def matmul_rs_int8_plain(x: torch.Tensor, w: torch.Tensor, ax: str, *,
                         scatter_dim: int) -> torch.Tensor:
    """:func:`matmul_rs_plain` as a ring whose accumulator crosses every hop
    quantized: the arriving accumulator is dequantized into x's dtype and
    this step's contribution, rounded to x's dtype, is added in x's dtype
    before the next quantized hop (the TPU kernel's fold and requantize)."""
    n, idx = comm.axis_size(ax), comm.axis_index(ax)
    y = (x.float() @ w.float()).to(x.dtype)
    if y.shape[scatter_dim] % n:
        raise ValueError(f"matmul-RS: extent {y.shape[scatter_dim]} does not chunk by ring {n}")
    chunk = y.shape[scatter_dim] // n
    acc = y.narrow(scatter_dim, ((idx - 1) % n) * chunk, chunk)
    for s in range(1, n):
        acc = comm.raw_ring_hop(acc, ax, 1, "int8") + \
            y.narrow(scatter_dim, ((idx + n - 1 - s) % n) * chunk, chunk)
    return acc.contiguous()


def matmul_rs_pair_int8_plain(x: torch.Tensor, w1: torch.Tensor, w1b: torch.Tensor, ax: str, *,
                              scatter_dim: int):
    """(x @ w1, x @ w1b), each a ring of :func:`matmul_rs_int8_plain`: each
    half of a row crosses with its own scale."""
    return (matmul_rs_int8_plain(x, w1, ax, scatter_dim=scatter_dim),
            matmul_rs_int8_plain(x, w1b, ax, scatter_dim=scatter_dim))
