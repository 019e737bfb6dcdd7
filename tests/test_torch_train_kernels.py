"""The training slice's kernels (plain versions and ops) against the JAX
package, on the CPU.

* ``ref.tile_matmul_plain`` against ``ring_matmul._tile_mm_raw`` in
  interpret mode (the Pallas kernel body itself), in the three layouts
  the training path uses (NN; NT, w read transposed; TN, x read
  transposed) with ``out_dtype`` fp32 and bf16, at ragged shapes;
  ``ops.tile_matmul``'s gradients against ``jax.vjp`` of the
  ``tile_matmul`` custom_vjp.
* ``ref.attention_bwd_plain`` (and ``ops.attention``'s backward) against
  ``jax.vjp`` of ``models/attention._sdpa``, causal and not, GQA; a row
  with no visible key against ``_sdpa`` and ``_sdpa_grouped_decode``.
* The gated FFN's backward (``ref.swiglu_bwd_plain`` and four tile
  products, through ``ops.gated_matmul``) against ``jax.vjp`` of the
  gated FFN in fp32.

Tolerances: fp32 1e-5 (sums in another order than XLA's at these small
sizes); bf16 outputs 2e-2, one bf16 rounding of each (the repo's bf16
bound, tests/test_kernels.py::_tol).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ring_matmul as RM
from repro.models import attention as JA
from repro_torch.bridge import to_tensor
from repro_torch.kernels import ops, ref

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
# (layout, M, K, N): the dims no operand stores rows along are ragged
SHAPES = [("NN", 24, 40, 56), ("NN", 37, 48, 40), ("NT", 24, 40, 56), ("NT", 37, 48, 43),
          ("TN", 24, 40, 56), ("TN", 40, 29, 48)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _rand(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return a if dtype == "float32" else np.asarray(jnp.asarray(a, jnp.bfloat16))


@pytest.mark.parametrize("layout,M,K,N", SHAPES)
@pytest.mark.parametrize("dtype,out_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                             ("bfloat16", "float32")])
def test_tile_matmul_plain_matches_pallas(layout, M, K, N, dtype, out_dtype):
    rng = np.random.default_rng(0)
    # stored operands: x^T is [K, M] for TN, w^T is [N, K] for NT
    xs = _rand(rng, (K, M) if layout == "TN" else (M, K), dtype)
    ws = _rand(rng, (N, K) if layout == "NT" else (K, N), dtype, K ** -0.5)
    xj, wj = jnp.asarray(xs), jnp.asarray(ws)
    xj, wj = (xj.T if layout == "TN" else xj), (wj.T if layout == "NT" else wj)
    want = RM._tile_mm_raw(xj, wj, out_dtype=jnp.dtype(out_dtype), interpret=True)
    xt, wt = to_tensor(xs, "cpu"), to_tensor(ws, "cpu")
    xt, wt = (xt.t() if layout == "TN" else xt), (wt.t() if layout == "NT" else wt)
    got = ref.tile_matmul_plain(xt, wt, out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (M, N)
    tol = F32 if out_dtype == "float32" else BF16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_transposed", [False, True])
def test_tile_matmul_grads_match_jax_vjp(dtype, w_transposed):
    """ops.tile_matmul's backward (dx = g w^T, dw = x^T g, g cast to x's
    dtype) against the custom_vjp of ring_matmul.tile_matmul; with
    ``w_transposed`` w is the transposed view of a stored [N, K] table, the
    tied head's layout, and its gradient reaches the table."""
    rng = np.random.default_rng(1)
    M, K, N = 24, 40, 48
    x = _rand(rng, (M, K), dtype)
    w = _rand(rng, (N, K) if w_transposed else (K, N), dtype, K ** -0.5)
    g = _rand(rng, (M, N), dtype)
    wj = jnp.asarray(w).T if w_transposed else jnp.asarray(w)
    y, vjp = jax.vjp(RM.tile_matmul, jnp.asarray(x), wj)
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt = to_tensor(x, "cpu").requires_grad_()
    wt = to_tensor(w, "cpu").requires_grad_()
    yt = ops.tile_matmul(xt, wt.t() if w_transposed else wt)
    dx, dw = torch.autograd.grad(yt, (xt, wt), to_tensor(g, "cpu"))
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(yt), np.asarray(y, np.float32), **tol)
    np.testing.assert_allclose(_np(dx), np.asarray(dx_j, np.float32), **tol)
    dw_j = np.asarray(dw_j, np.float32)
    np.testing.assert_allclose(_np(dw), dw_j.T if w_transposed else dw_j, **tol)


def _sdpa_gqa(q, k, v, causal):
    """_sdpa on [B,S,heads,dh] with k, v repeated to the q-heads."""
    g = q.shape[2] // k.shape[2]
    return JA._sdpa(q, JA._repeat_kv(k, g), JA._repeat_kv(v, g), causal=causal,
                    q_offset=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nh,nkv", [(4, 2), (4, 4)])
def test_attention_bwd_plain_matches_jax_vjp(causal, nh, nkv):
    rng = np.random.default_rng(2)
    B, S, dh = 2, 13, 16
    q, do = (_rand(rng, (B, S, nh, dh), "float32") for _ in range(2))
    k, v = (_rand(rng, (B, S, nkv, dh), "float32") for _ in range(2))
    o_j, vjp = jax.vjp(lambda a, b, c: _sdpa_gqa(a, b, c, causal), q, k, v)
    grads_j = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (to_tensor(a, "cpu").transpose(1, 2) for a in (q, k, v, do))
    grads = ref.attention_bwd_plain(tq, tk, tv, tdo, causal=causal)
    for got, want in zip(grads, grads_j):
        np.testing.assert_allclose(_np(got.transpose(1, 2)), np.asarray(want), **F32)
    # the differentiable op (the kernel's CPU path) gives the same
    leaves = [t.detach().requires_grad_() for t in (tq, tk, tv)]
    o = ops.attention(*leaves, causal=causal)
    np.testing.assert_allclose(_np(o.transpose(1, 2)), np.asarray(o_j), **F32)
    for got, want in zip(torch.autograd.grad(o, leaves, tdo), grads_j):
        np.testing.assert_allclose(_np(got.transpose(1, 2)), np.asarray(want), **F32)


def test_attention_row_without_keys_matches_sdpa():
    """kv_len 0 leaves a row no visible key: _sdpa's -1e30 fill averages
    all of v uniformly, and so does the plain version (and the kernel,
    tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(3)
    nh, nkv, dh, S = 4, 2, 16, 9
    q = _rand(rng, (1, S, nh, dh), "float32")
    k, v = (_rand(rng, (1, S, nkv, dh), "float32") for _ in range(2))
    g = nh // nkv
    want = JA._sdpa(q, JA._repeat_kv(k, g), JA._repeat_kv(v, g), causal=True,
                    q_offset=jnp.zeros((), jnp.int32), kv_len=jnp.zeros((), jnp.int32))
    tq, tk, tv = (to_tensor(a, "cpu").transpose(1, 2) for a in (q, k, v))
    got = ref.attention_plain(tq, tk, tv, causal=True,
                              kv_len=torch.zeros(1, dtype=torch.int32))
    np.testing.assert_allclose(_np(got.transpose(1, 2)), np.asarray(want), **F32)
    np.testing.assert_allclose(_np(got[0, 0]), np.broadcast_to(v[0, :, 0].mean(0), (S, dh)),
                               **F32)
    # decode: one slot of three at kv_len 0, the grouped-decode mask
    B, L = 3, 11
    q1 = _rand(rng, (B, 1, nh, dh), "float32")
    kc, vc = (_rand(rng, (B, L, nkv, dh), "float32") for _ in range(2))
    kv_len = np.array([5, 0, 11], np.int32)
    want = JA._sdpa_grouped_decode(jnp.asarray(q1).reshape(B, 1, nkv, g, dh), kc, vc,
                                   kv_len=jnp.asarray(kv_len)[:, None])
    got = ref.attention_plain(*(to_tensor(a, "cpu").transpose(1, 2) for a in (q1, kc, vc)),
                              causal=True, q_offset=torch.tensor(np.maximum(kv_len - 1, 0)),
                              kv_len=torch.tensor(kv_len))
    np.testing.assert_allclose(_np(got.transpose(1, 2)),
                               np.asarray(want).reshape(B, 1, nh, dh), **F32)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_backward_matches_jax_vjp(act):
    """dx, dw1, dw1b of act(x w1) * (x w1b) through ops.gated_matmul (the
    SwiGLU-backward plain version and four tile products) against jax.vjp
    of the gated FFN, fp32."""
    rng = np.random.default_rng(4)
    M, K, F = 20, 32, 48
    x = _rand(rng, (M, K), "float32")
    w1, w1b = (_rand(rng, (K, F), "float32", K ** -0.5) for _ in range(2))
    g = _rand(rng, (M, F), "float32")
    fn = {"silu": jax.nn.silu, "gelu": jax.nn.gelu}[act]
    h_j, vjp = jax.vjp(lambda a, b, c: fn(a @ b) * (a @ c), x, w1, w1b)
    grads_j = vjp(jnp.asarray(g))
    leaves = [to_tensor(a, "cpu").requires_grad_() for a in (x, w1, w1b)]
    h = ops.gated_matmul(*leaves, act=act)
    np.testing.assert_allclose(_np(h), np.asarray(h_j), **F32)
    for got, want in zip(torch.autograd.grad(h, leaves, to_tensor(g, "cpu")), grads_j):
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    # the elementwise half alone, with the fp32 products the kernel keeps
    a, b = (to_tensor(np.asarray(x @ w, np.float32), "cpu") for w in (w1, w1b))
    da, db = ref.swiglu_bwd_plain(to_tensor(g, "cpu"), a, b, act=act)
    _, vjp2 = jax.vjp(lambda p, r: fn(p) * r, jnp.asarray(x @ w1), jnp.asarray(x @ w1b))
    for got, want in zip((da, db), vjp2(jnp.asarray(g))):
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_forward_only_matmul_refuses_a_gradient():
    x = torch.randn(4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="tile_matmul"):
        ops.matmul(x, torch.randn(8, 8))
    with torch.no_grad():
        assert ops.matmul(x, torch.randn(8, 8)).shape == (4, 8)


def test_training_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes on the CPU."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import swiglu as ksw
    x, q = torch.zeros((8, 16)), torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="CUDA tile matmul"):
        kmm.tile_matmul(x, x.t())
    with pytest.raises(ValueError, match="CUDA flash-attention backward"):
        kfa.flash_attention_bwd(q, q, q, q, torch.zeros((1, 2, 8)), q)
    with pytest.raises(ValueError, match="CUDA SwiGLU"):
        ksw.swiglu_bwd(x, x, x)


def test_tile_layout_reads_transposed_views_in_place():
    """Row-major operands and .t() views of row-major ones are taken with
    their leading dims (no copy); anything else is refused."""
    from repro_torch.kernels import matmul as kmm
    t = torch.zeros((24, 40))
    assert kmm.layout(t) == (False, 40)
    assert kmm.layout(t.t()) == (True, 40)
    assert kmm.layout(t[:, :16]) == (False, 40)          # a slice keeps its leading dim
    assert kmm.layout(t[:1]) == (False, 40)
    with pytest.raises(ValueError, match="neither row- nor column-major"):
        kmm.layout(t[::2, ::2])
