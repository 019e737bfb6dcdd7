"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips with a reason on a host without an NVIDIA
card (the CPU-only tier-1 run).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the repo's (tests/test_kernels.py::_tol): fp32 2e-4 (fp32
sums in another order), bf16 2e-2 (one bf16 rounding of the output).
"""

import numpy as np
import pytest
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.parallel.context import PCtx
from repro_torch.serve.cache import CachePool, PoolConfig
from repro_torch.serve.engine import DecodeEngine, Request

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _close(a, b, dtype):
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("M", [1, 4, 16, 17, 100, 256])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act,bias", [("none", False), ("gelu", True), ("relu2", True),
                                      ("silu", False)])
def test_matmul_kernel(dev, M, dtype, act, bias):
    K, N = 192, 200
    x = _randn((M, K), dtype, dev, 0)
    w = _randn((K, N), dtype, dev, 1, K ** -0.5)
    b = _randn((N,), dtype, dev, 2) if bias else None
    _close(kmm.matmul(x, w, b, act=act), ref.matmul_plain(x, w, b, act=act), dtype)


@pytest.mark.parametrize("M", [4, 33, 128])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_matmul_kernel(dev, M, dtype, act):
    K, N = 256, 136
    x = _randn((M, K), dtype, dev, 3)
    w1 = _randn((K, N), dtype, dev, 4, K ** -0.5)
    w1b = _randn((K, N), dtype, dev, 5, K ** -0.5)
    _close(kmm.gated_matmul(x, w1, w1b, act=act),
           ref.gated_matmul_plain(x, w1, w1b, act=act), dtype)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Sk,q_off,kv_len", [
    (1, 40, 80, [0], [40]), (1, 33, 96, [17], [50]), (3, 1, 70, [0, 9, 69], [1, 10, 70]),
    (2, 64, 64, None, None)])
def test_flash_attention_kernel(dev, dh, dtype, B, Sq, Sk, q_off, kv_len):
    nh, nkv = 6, 2
    q = _randn((B, Sq, nh, dh), dtype, dev, 6).transpose(1, 2)
    k = _randn((B, Sk, nkv, dh), dtype, dev, 7).transpose(1, 2)
    v = _randn((B, Sk, nkv, dh), dtype, dev, 8).transpose(1, 2)
    t = lambda a: None if a is None else torch.tensor(a, dtype=torch.int32, device=dev)
    kw = dict(causal=True, q_offset=t(q_off), kv_len=t(kv_len))
    _close(kfa.flash_attention(q, k, v, **kw), ref.attention_plain(q, k, v, **kw), dtype)


CFG = ModelConfig(name="cuda-test", family="dense", num_layers=2, d_model=128,
                  num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=500, head_dim=64,
                  qk_norm=True, tie_embeddings=True)


def test_forward_kernels_match_plain(dev):
    """fp32 prefill through the kernels vs the plain-op forward."""
    params = lm.init_params(CFG, seed=0, device=dev, dtype=torch.float32)
    pool = CachePool(CFG, PoolConfig(1, 16, 5, 64), device=dev)
    slot = pool.admit(48)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 500, (1, 48))).to(dev)
    batch = {"tokens": toks, "_dtype": torch.float32}
    ops.reset_launches()
    a = lm.forward(PCtx(), CFG, params, batch, caches=pool.prefill_tree(slot))
    assert all(n > 0 for n in ops.LAUNCHES.values()), ops.LAUNCHES
    b = lm.forward(PCtx(plain=True), CFG, params, batch,
                   caches=pool.prefill_tree(slot))
    _close(a.logits, b.logits, torch.float32)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def test_engine_greedy_tokens_card_vs_cpu(dev):
    """fp32 greedy tokens through the kernels equal the CPU plain path's on
    a trace where two slots compete for 4 leasable blocks of 16."""
    params = lm.init_params(CFG, seed=1, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 500, n).astype(np.int32) for n in (20, 9, 33, 14)]
    toks, pre = {}, {}
    for device, p in ((dev, params), ("cpu", _to_cpu(params))):
        eng = DecodeEngine(CFG, p, PoolConfig(2, 16, 5, 48), device=device)
        fin = eng.run([Request(i, q, 12, i // 2) for i, q in enumerate(prompts)])
        toks[str(device)] = [fin[i].tokens for i in range(4)]
        pre[str(device)] = eng.stats["preemptions"]
    assert toks["cuda"] == toks["cpu"] and pre["cuda"] == pre["cpu"]
