"""The port's plain kernel versions against the JAX package's kernels.

Inputs are made with numpy from a seed and fed to both.  The Pallas kernels
run in interpret mode, as tests/test_kernels.py runs them on the CPU.
Tolerances: fp32 2e-4 (same math, fp32 sums in another order), bf16 2e-2
(one bf16 rounding of the output, 2^-8 relative, plus input rounding);
Pallas flash attention in fp32 2e-3, the bound tests/test_kernels.py holds
it to against its own oracle (online softmax rescales in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as FA
from repro.kernels import matmul as MM
from repro.models import attention as JATT
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops
from repro_torch.kernels import ref

TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # tiny ops: thread start-up dominates
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return j, t


def _close(t: torch.Tensor, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (128, 256, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "gelu", "relu2", "silu"])
def test_matmul_plain_vs_pallas(M, K, N, dtype, act):
    rng = np.random.default_rng(0)
    x, xt = _pair(rng.standard_normal((M, K)), dtype)
    w, wt = _pair(rng.standard_normal((K, N)) / np.sqrt(K), dtype)
    b, bt = _pair(rng.standard_normal(N), dtype)
    y = MM.matmul(x, w, b, act=act, block_m=128, block_n=128, block_k=128,
                  interpret=True)
    out = ref.matmul_plain(xt, wt, bt, act=act)
    assert out.dtype == xt.dtype
    _close(out, y, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_matmul_plain_vs_pallas(dtype, act):
    rng = np.random.default_rng(1)
    x, xt = _pair(rng.standard_normal((256, 256)), dtype)
    w1, w1t = _pair(rng.standard_normal((256, 128)) / 16, dtype)
    w1b, w1bt = _pair(rng.standard_normal((256, 128)) / 16, dtype)
    y = MM.gated_matmul(x, w1, w1b, act=act, block_k=128, interpret=True)
    _close(ref.gated_matmul_plain(xt, w1t, w1bt, act=act), y, TOL[dtype])


@pytest.mark.parametrize("B,nh,nkv,S,dh", [(1, 4, 4, 128, 64), (2, 4, 2, 128, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_vs_pallas_flash(B, nh, nkv, S, dh, causal, dtype):
    rng = np.random.default_rng(2)
    q, qt = _pair(rng.standard_normal((B, nh, S, dh)), dtype)
    k, kt = _pair(rng.standard_normal((B, nkv, S, dh)), dtype)
    v, vt = _pair(rng.standard_normal((B, nkv, S, dh)), dtype)
    o = FA.flash_attention(q, k, v, causal=causal, block_q=64, block_k=64,
                           interpret=True)
    tol = TOL[dtype] if dtype == "bfloat16" else dict(rtol=2e-3, atol=2e-3)
    _close(ref.attention_plain(qt, kt, vt, causal=causal), o, tol)


@pytest.mark.parametrize("Sq,Sk,q_off,kv_len", [(8, 24, 0, 8), (8, 24, 5, 13),
                                                (16, 32, 3, 19), (1, 16, 9, 10)])
def test_attention_plain_vs_sdpa_offsets(Sq, Sk, q_off, kv_len):
    """Prefill mask: q_offset shifts the causal diagonal, kv_len cuts the
    unfilled cache tail (``_sdpa`` takes kv repeated to the q heads)."""
    rng = np.random.default_rng(3)
    B, nh, nkv, dh = 1, 4, 2, 16
    q = rng.standard_normal((B, Sq, nh, dh)).astype(np.float32)
    k = rng.standard_normal((B, Sk, nkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, Sk, nkv, dh)).astype(np.float32)
    o = JATT._sdpa(jnp.asarray(q), jnp.repeat(jnp.asarray(k), nh // nkv, axis=2),
                   jnp.repeat(jnp.asarray(v), nh // nkv, axis=2), causal=True,
                   q_offset=jnp.int32(q_off), kv_len=jnp.int32(kv_len))
    t = lambda a: torch.from_numpy(a).transpose(1, 2)
    out = ref.attention_plain(t(q), t(k), t(v), causal=True,
                              q_offset=torch.tensor([q_off], dtype=torch.int32),
                              kv_len=torch.tensor([kv_len], dtype=torch.int32))
    _close(out.transpose(1, 2), o, TOL["float32"])


def test_attention_plain_vs_grouped_decode():
    """Decode mask: one query per slot, each slot at its own length."""
    rng = np.random.default_rng(4)
    B, nh, nkv, dh, Sk = 4, 4, 2, 16, 24
    lens = np.array([1, 7, 24, 13], np.int32)
    q = rng.standard_normal((B, 1, nh, dh)).astype(np.float32)
    k = rng.standard_normal((B, Sk, nkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, Sk, nkv, dh)).astype(np.float32)
    o = JATT._sdpa_grouped_decode(jnp.asarray(q).reshape(B, 1, nkv, nh // nkv, dh),
                                  jnp.asarray(k), jnp.asarray(v),
                                  kv_len=jnp.asarray(lens)[:, None])
    t = lambda a: torch.from_numpy(a).transpose(1, 2)
    lt = torch.from_numpy(lens)
    out = ref.attention_plain(t(q), t(k), t(v), causal=True, q_offset=lt - 1, kv_len=lt)
    _close(out.transpose(1, 2), np.asarray(o).reshape(B, 1, nh, dh), TOL["float32"])


def test_ops_take_plain_on_cpu_and_count_nothing():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    wb = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 4, 3, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 2, 5, 16)).astype(np.float32))
    ops.reset_launches()
    assert torch.equal(ops.matmul(x, w, act="silu"), ref.matmul_plain(x, w, act="silu"))
    assert torch.equal(ops.gated_matmul(x, w, wb), ref.gated_matmul_plain(x, w, wb))
    assert torch.equal(ops.attention(q, kv, kv), ref.attention_plain(q, kv, kv))
    lat, lens = q[:, :, 0], torch.tensor([3, 5], dtype=torch.int32)
    assert torch.equal(ops.mla_decode(lat, lat[..., :4], kv[:, 0], kv[:, 1, :, :4], lens, 0.3),
                       ref.mla_decode_plain(lat, lat[..., :4], kv[:, 0], kv[:, 1, :, :4], lens,
                                            0.3))
    xd, we = x.reshape(2, 2, 32), w.expand(2, 32, 16).contiguous()
    assert torch.equal(ops.moe_grouped_gated(xd, we, we), ref.grouped_gated_plain(xd, we, we))
    slots = torch.tensor([[0, -1], [3, 1]], dtype=torch.int32)
    assert torch.equal(ops.moe_combine(xd, torch.ones(2, 2), slots),
                       ref.moe_combine_plain(xd, torch.ones(2, 2), slots))
    assert ops.LAUNCHES == {"matmul": 0, "gated_matmul": 0, "flash_attention": 0,
                            "tile_matmul": 0, "swiglu_bwd": 0, "flash_attention_bwd": 0,
                            "ssd": 0, "ag_matmul": 0, "matmul_rs": 0,
                            "ag_matmul_contract": 0, "ag_matmul_int8": 0,
                            "matmul_rs_int8": 0, "ag_matmul_contract_int8": 0,
                            "mla_decode": 0, "moe_grouped_gated": 0, "moe_grouped_mm": 0,
                            "moe_combine": 0}
    assert torch.equal(ops.tile_matmul(x, w), ref.tile_matmul_plain(x, w))
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes on the CPU."""
    x = torch.zeros((4, 32))
    w = torch.zeros((32, 16))
    q = torch.zeros((1, 2, 4, 64))
    with pytest.raises(ValueError, match="CUDA matmul"):
        tmm.matmul(x, w)
    with pytest.raises(ValueError, match="CUDA matmul"):
        tmm.gated_matmul(x, w, w)
    with pytest.raises(ValueError, match="CUDA flash"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.matmul(x.to("meta"), w.to("meta"))


@pytest.mark.parametrize("M,N,K,want", [(4, 1024, 1024, 16), (4, 3072, 1024, 11),
                                        (4, 152064, 1024, 1), (64, 1024, 1024, 1)])
def test_split_k_choice(M, N, K, want):
    """Decode shapes split K until about four 64-column blocks per SM read
    weights; prefill shapes (M > 16) never split."""
    assert tmm.split_k(M, N, K) == want


@pytest.mark.parametrize("B,nh,nkv,Sq,Sk,want", [(4, 16, 8, 1, 544, 9), (1, 16, 8, 512, 544, 1),
                                                 (1, 16, 8, 64, 544, 5), (1, 16, 8, 1, 32, 1)])
def test_kv_split_choice(B, nh, nkv, Sq, Sk, want):
    """Decode grids (batch x kv-heads blocks) split the keys until about two
    blocks per SM; a 512-token prefill grid is large enough unsplit."""
    assert tfa.kv_splits(B, nh, nkv, Sq, Sk) == want
