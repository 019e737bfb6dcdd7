"""The bf16 flash attention on the tensor cores (``csrc/flash_attention.cu``,
namespace ``tc``): its path choice, its rounding, and on the card its
kernels.

On the CPU:

* ``forward_impl`` / ``backward_impl`` pick the path of the main path's
  cases from the shapes alone (training, prefill 64/256/512 and bf16
  backward on the tensor cores; decode and fp32 on the SIMT kernels);
* an emulation of the tensor-core kernels' arithmetic, written here and
  not in the package (64-key tiles, online softmax in fp32 log2 units, P
  and dS rounded to bf16 before their products, fp32 sums), held against
  ``ref.attention_plain`` / ``ref.attention_bwd_plain`` and against the
  JAX model's ``_sdpa`` and its ``jax.vjp`` at the bf16 bound, 2e-2 (one
  bf16 rounding of each output; P and dS in bf16 add ~2^-9 relative per
  term, averaged over the keys); at dk = dv and at MLA's dk 96 / dv 64
  (a ``dh`` parameter given as (dk, dv)), which JAX's model computes on
  v padded to 96 and sliced back.

Marked ``cuda`` (skipped without a card): both paths against the plain
version at the training shape and at ragged ones, prefill with q_offset
and kv_len, an empty row, the LSE (fp32, 2e-4), and the backward's
determinism (two calls ``torch.equal``).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_attention_tc.py
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JATT
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref

BF = torch.bfloat16
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
BK = 64                      # keys of a K/V tile in the tensor-core kernels
NEG = -1e30                  # masked score, as the kernels use


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # small ops: thread start-up dominates
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the path choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,B,nh,nkv,Sq,Sk,dh,want", [
    (BF, 4, 16, 8, 512, 512, 128, "wgmma"),           # training microbatch
    (BF, 1, 16, 8, 64, 544, 128, "wgmma"),            # prefill 64
    (BF, 1, 16, 8, 256, 544, 128, "wgmma"),           # prefill 256
    (BF, 1, 16, 8, 512, 544, 128, "wgmma"),           # prefill 512
    (BF, 4, 16, 8, 1, 544, 128, "simt"),              # decode: 2 rows a block
    (torch.float32, 4, 16, 8, 512, 512, 128, "simt"),  # fp32: held to 2e-4
    (BF, 1, 3, 1, 21, 21, 64, "simt"),                # 63 rows: under one tile
    (BF, 1, 3, 1, 22, 22, 64, "wgmma"),               # 66 rows
], ids=["train", "prefill64", "prefill256", "prefill512", "decode", "fp32",
        "g3-63rows", "g3-66rows"])
def test_forward_impl_choice(dtype, B, nh, nkv, Sq, Sk, dh, want):
    assert kfa.forward_impl(dtype, B, nh, nkv, Sq, Sk, dh) == want


@pytest.mark.parametrize("dtype,want", [(BF, "wgmma"), (torch.float32, "simt")])
def test_backward_impl_choice(dtype, want):
    assert kfa.backward_impl(dtype, 4, 16, 8, 512, 512, 128) == want


def test_reset_launches_zeroes_the_path_counts():
    kfa.IMPL_LAUNCHES["flash_attention"]["wgmma"] = 3
    kfa.IMPL_LAUNCHES["flash_attention_bwd"]["simt"] = 2
    kfa.SQ_LAUNCHES[("wgmma", 512)] += 1
    ops.reset_launches()
    assert all(n == 0 for c in kfa.IMPL_LAUNCHES.values() for n in c.values())
    assert not kfa.SQ_LAUNCHES


# ---------------------------------------------------------------------------
# an emulation of the tensor-core kernels' arithmetic
# ---------------------------------------------------------------------------

def _bf(t: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16, held in fp32."""
    return t.to(BF).float()


def _visible(B, Sq, Sk, causal, q_off, kv_len):
    """[B, 1, Sq, Sk] mask of ``_sdpa`` and whether each batch row is empty
    (kv_len 0: every key counts with score 0, as the kernels do)."""
    q_off = torch.zeros(B, dtype=torch.long) if q_off is None else q_off.long()
    klen = torch.full((B,), Sk, dtype=torch.long) if kv_len is None else kv_len.long()
    kpos = torch.arange(Sk)
    vis = kpos[None, None, :] < klen[:, None, None]
    if causal:
        qpos = q_off[:, None] + torch.arange(Sq)[None, :]
        vis = vis & (kpos[None, None, :] <= qpos[:, :, None])
    empty = klen <= 0
    vis = torch.where(empty[:, None, None], torch.ones_like(vis), vis)
    return vis[:, None], empty


def _dims(dh):
    """(dk, dv) of a ``dh`` parameter: one int for dk = dv, or the pair."""
    return dh if isinstance(dh, tuple) else (dh, dh)


def emulate_fwd(q, k, v, *, causal=True, q_offset=None, kv_len=None):
    """(o in bf16, lse fp32) as the tensor-core forward computes them: scores
    in fp32 over 64-key tiles (dk wide), the online softmax in log2 units,
    P rounded to bf16 before P V (dv wide), fp32 sums."""
    B, nh, Sq, dh = q.shape
    Sk, g, dv = k.shape[2], nh // k.shape[1], v.shape[3]
    qf, kf, vf = q.float(), k.float().repeat_interleave(g, 1), v.float().repeat_interleave(g, 1)
    vis, empty = _visible(B, Sq, Sk, causal, q_offset, kv_len)
    sl2 = dh ** -0.5 * math.log2(math.e)
    m = torch.full((B, nh, Sq, 1), NEG)
    l = torch.zeros((B, nh, Sq, 1))
    acc = torch.zeros((B, nh, Sq, dv))
    for k0 in range(0, Sk, BK):
        s = qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2)
        x = torch.where(empty[:, None, None, None], torch.zeros_like(s), s * sl2)
        x = torch.where(vis[..., k0:k0 + BK], x, torch.full_like(x, NEG))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _bf(p) @ vf[:, :, k0:k0 + BK]
        m = m_new
    o = (acc / l).to(q.dtype)
    return o, (m * math.log(2) + torch.log(l))[..., 0]


def emulate_bwd(q, k, v, o, lse, do, *, causal=True):
    """(dq, dk, dv) as the tensor-core backward computes them: P recomputed
    from the LSE in log2 units, D = rowsum(dO o), dS = P (dP - D); P and dS
    rounded to bf16 before dV = P^T dO, dK = dS^T Q, dQ = dS K; fp32 sums,
    the GQA sum over the group included."""
    B, nh, S, dh = q.shape
    nkv = k.shape[1]
    g = nh // nkv
    scale, l2e = dh ** -0.5, math.log2(math.e)
    qf, dof = q.float(), do.float()
    kf, vf = k.float().repeat_interleave(g, 1), v.float().repeat_interleave(g, 1)
    vis, _ = _visible(B, S, S, causal, None, None)
    D = (dof * o.float()).sum(-1, keepdim=True)
    p = torch.exp2(qf @ kf.transpose(-1, -2) * (scale * l2e) - lse[..., None] * l2e)
    p = torch.where(vis, p, torch.zeros_like(p))
    ds = p * (dof @ vf.transpose(-1, -2) - D)
    per_group = lambda t: t.reshape(B, nkv, g, S, t.shape[-1]).sum(2)
    dv = per_group(_bf(p).transpose(-1, -2) @ dof)
    dk = per_group(_bf(ds).transpose(-1, -2) @ qf) * scale
    dq = (_bf(ds) @ kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _inputs(seed, B, nh, nkv, Sq, Sk, dh):
    """bf16 q, k at dk, v (and dO) at dv from numpy, as the model's
    [B, S, heads, d] tensors handed over as transposed views."""
    dk, dv = _dims(dh)
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(BF).transpose(1, 2)
    return t(B, Sq, nh, dk), t(B, Sk, nkv, dk), t(B, Sk, nkv, dv), t(B, Sq, nh, dv)


def _close(a, b, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


# (B, nh, nkv, dh, Sq, Sk, q_off, kv_len): g 2 and 3, dh 64 and 128, a row
# tile that ends inside a query's group, a prefill with offsets and an empty
# row; then MLA's (dk, dv) = (96, 64) at g 1 (as minicpm3-4b) and 3
MLA = (96, 64)
FWD_CASES = [
    (2, 4, 2, 64, 33, 33, None, None),
    (3, 3, 1, 128, 40, 130, [0, 50, 7], [40, 90, 0]),
    (1, 6, 2, 64, 130, 130, None, None),
    (2, 2, 1, 128, 70, 100, [30, 0], [100, 70]),
    (2, 4, 4, MLA, 80, 80, None, None),
    (3, 3, 1, MLA, 40, 130, [0, 50, 7], [40, 90, 0]),
    (1, 4, 4, MLA, 70, 100, [30], [100]),
]


@pytest.mark.parametrize("B,nh,nkv,dh,Sq,Sk,q_off,kv_len", FWD_CASES)
def test_emulated_forward_rounding_within_bf16_bound(B, nh, nkv, dh, Sq, Sk, q_off, kv_len):
    q, k, v, _ = _inputs(0, B, nh, nkv, Sq, Sk, dh)
    t = lambda a: None if a is None else torch.tensor(a, dtype=torch.int32)
    kw = dict(causal=True, q_offset=t(q_off), kv_len=t(kv_len))
    o, lse = emulate_fwd(q, k, v, **kw)
    o_p, lse_p = ref.attention_plain(q, k, v, return_lse=True, **kw)
    _close(o, o_p, BF)
    if kv_len is None:                    # the LSE is the backward's, training's mask
        _close(lse, lse_p, torch.float32)
    if kv_len is not None and 0 in kv_len:
        b = kv_len.index(0)               # the empty row averages all of v
        mean_v = v[b].float().mean(1).repeat_interleave(nh // nkv, 0)
        _close(o[b], mean_v[:, None].expand(nh, Sq, v.shape[3]), BF)


@pytest.mark.parametrize("B,nh,nkv,dh,S,causal", [
    (2, 4, 2, 64, 80, True), (1, 3, 1, 128, 33, True), (1, 6, 2, 64, 130, False),
    (2, 4, 2, 128, 65, True), (2, 4, 4, MLA, 80, True), (1, 6, 2, MLA, 130, False)])
def test_emulated_backward_rounding_within_bf16_bound(B, nh, nkv, dh, S, causal):
    q, k, v, do = _inputs(1, B, nh, nkv, S, S, dh)
    o, lse = emulate_fwd(q, k, v, causal=causal)
    got = emulate_bwd(q, k, v, o, lse, do, causal=causal)
    want = ref.attention_bwd_plain(q, k, v, do, causal=causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == BF
        _close(a, b, BF)


@pytest.mark.parametrize("B,nh,nkv,dh,S", [(1, 4, 2, 64, 96), (2, 3, 1, 128, 40),
                                           (2, 4, 4, MLA, 80), (1, 6, 2, MLA, 130)])
def test_emulation_matches_jax_sdpa_and_its_vjp(B, nh, nkv, dh, S):
    """The same bf16 inputs through the JAX model's ``_sdpa`` (fp32, k and v
    repeated to the q heads; at dv < dk, v zero-padded to dk and the output
    sliced back, as ``repro/models/attention.py`` runs MLA) and ``jax.vjp``
    of it, and through the emulation: output and gradients at the bf16
    bound."""
    q, k, v, do = _inputs(2, B, nh, nkv, S, S, dh)
    g, (dk_, dv_) = nh // nkv, _dims(dh)
    o, lse = emulate_fwd(q, k, v, causal=True)
    dq, dk, dv = emulate_bwd(q, k, v, o, lse, do, causal=True)
    assert o.shape[-1] == dv.shape[-1] == dv_ and dq.shape[-1] == dk.shape[-1] == dk_
    j = lambda t: jnp.asarray(t.transpose(1, 2).float().numpy())      # [B, S, heads, d]
    rep = lambda t: jnp.repeat(t, g, axis=2)
    pad = lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, 0), (0, dk_ - dv_)))
    fn = lambda a, b, c: JATT._sdpa(a, rep(b), rep(pad(c)), causal=True,
                                    q_offset=jnp.int32(0))[..., :dv_]
    o_j, vjp = jax.vjp(fn, j(q), j(k), j(v))
    dq_j, dk_j, dv_j = vjp(j(do))
    back = lambda a: torch.from_numpy(np.array(a)).transpose(1, 2)
    for a, b in ((o, o_j), (dq, dq_j), (dk, dk_j), (dv, dv_j)):
        _close(a, back(b), BF)


# ---------------------------------------------------------------------------
# on the card: both paths against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")
    return torch.device("cuda")


def _card_inputs(dev, seed, B, nh, nkv, Sq, Sk, dh):
    return tuple(t.to(dev) for t in _inputs(seed, B, nh, nkv, Sq, Sk, dh))


# the training shape, ragged shapes (S 33 and 80, g 1 and 3, dh 64), a
# prefill with q_offset and kv_len and one with an empty row; MLA's (96, 64)
# natively on wgmma (padded to 128 on the SIMT path)
CARD_FWD = [
    (4, 16, 8, 128, 512, 512, None, None),
    (2, 2, 2, 64, 33, 33, None, None),
    (2, 6, 2, 64, 80, 80, None, None),
    (1, 16, 8, 128, 256, 544, [0], [256]),
    (2, 6, 2, 64, 80, 130, [17, 40], [97, 120]),
    (3, 6, 2, 128, 40, 130, [0, 50, 7], [40, 90, 0]),
    (1, 8, 8, MLA, 256, 544, [0], [256]),
    (2, 6, 2, MLA, 80, 130, [17, 40], [97, 120]),
    (3, 6, 2, MLA, 40, 130, [0, 50, 7], [40, 90, 0]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("impl", kfa.IMPLS)
@pytest.mark.parametrize("B,nh,nkv,dh,Sq,Sk,q_off,kv_len", CARD_FWD)
def test_card_forward_both_paths_match_plain(dev, impl, B, nh, nkv, dh, Sq, Sk, q_off, kv_len):
    q, k, v, _ = _card_inputs(dev, 3, B, nh, nkv, Sq, Sk, dh)
    t = lambda a: None if a is None else torch.tensor(a, dtype=torch.int32, device=dev)
    kw = dict(causal=True, q_offset=t(q_off), kv_len=t(kv_len))
    lse_wanted = q_off is None
    got = kfa.flash_attention(q, k, v, return_lse=lse_wanted, impl=impl, **kw)
    want = ref.attention_plain(q, k, v, return_lse=lse_wanted, **kw)
    torch.cuda.synchronize()
    got, want = (got, want) if lse_wanted else ((got,), (want,))
    for a, b in zip(got, want):
        _close(a, b, a.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", kfa.IMPLS)
@pytest.mark.parametrize("B,nh,nkv,dh,S,causal", [
    (4, 16, 8, 128, 512, True), (2, 2, 2, 64, 33, True), (2, 6, 2, 64, 80, True),
    (2, 6, 2, 64, 80, False), (1, 3, 1, 128, 130, True), (2, 8, 8, MLA, 130, True),
    (2, 6, 2, MLA, 80, False)])
def test_card_backward_both_paths_match_plain_and_repeat(dev, impl, B, nh, nkv, dh, S,
                                                         causal):
    q, k, v, do = _card_inputs(dev, 4, B, nh, nkv, S, S, dh)
    o, lse = kfa.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, impl=impl)
    again = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, impl=impl)
    want = ref.attention_bwd_plain(q, k, v, do, causal=causal)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == BF
        _close(a, b, BF)
    assert all(torch.equal(a, b) for a, b in zip(got, again))      # deterministic


@pytest.mark.cuda
def test_card_default_paths_and_counts(dev):
    """The wrappers' default paths at the training and decode shapes, as the
    per-path counts record them; the tensor-core path refuses fp32."""
    ops.reset_launches()
    q, k, v, do = _card_inputs(dev, 5, 2, 4, 2, 64, 64, 64)
    o, lse = kfa.flash_attention(q, k, v, causal=True, return_lse=True)
    kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    kl = torch.tensor([10, 64], dtype=torch.int32, device=dev)
    kfa.flash_attention(q[:, :, :1], k, v, causal=True, q_offset=kl - 1, kv_len=kl)
    assert kfa.IMPL_LAUNCHES == {"flash_attention": {"wgmma": 1, "simt": 1},
                                 "flash_attention_bwd": {"wgmma": 1, "simt": 0},
                                 "mla_decode": {"wgmma": 0, "simt": 0}}
    assert kfa.SQ_LAUNCHES == {("wgmma", 64): 1, ("simt", 1): 1}
    with pytest.raises(TypeError, match="bf16"):
        kfa.flash_attention(q.float(), k.float(), v.float(), impl="wgmma")
    ops.reset_launches()
