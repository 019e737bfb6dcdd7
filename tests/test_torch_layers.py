"""The port's model layers against ``repro/models/layers.py``.

Same inputs from a numpy seed into both.  Tolerances: fp32 2e-5 (the same
elementwise math; rsqrt, pow and the transcendental functions differ by a
few ulp between XLA and PyTorch), bf16 2e-2 (one bf16 rounding of the
output, 2^-8 relative, can land on either side)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a, dtype="float32"):
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(t, j, dtype="float32"):
    assert t.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **TOL[dtype])


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(kind, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((2, 5, 64)) * 3 + 0.5, dtype)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    _close(TL.apply_norm(kind, tp, xt), JL.apply_norm(kind, jp, xj), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_head_norm(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((2, 3, 4, 16)), dtype)
    s = rng.standard_normal(16).astype(np.float32)
    _close(TL.rms_head_norm(torch.from_numpy(s), xt),
           JL.rms_head_norm(jnp.asarray(s), xj), dtype)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(theta, dtype):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    cj, sj = JL.rope_cos_sin(jnp.asarray(pos), 128, theta)
    ct, st = TL.rope_cos_sin(torch.from_numpy(pos), 128, theta)
    # angles up to 4096 rad: a 1-ulp difference in a frequency moves cos/sin
    # by up to 4096 * 2^-24 ~ 2.4e-4
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=5e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=5e-4)
    xj, xt = _pair(rng.standard_normal((2, 7, 4, 128)), dtype)
    # same cos/sin into both, so apply_rope itself is held at the dtype's bound
    _close(TL.apply_rope(xt, torch.from_numpy(np.array(cj)), torch.from_numpy(np.array(sj))),
           JL.apply_rope(xj, cj, sj), dtype)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_activations(kind):
    x = np.linspace(-6, 6, 241).astype(np.float32)
    xj, xt = _pair(x)
    _close(TL.ACTIVATIONS[kind](xt), JL.ACTIVATIONS[kind](xj))
    assert TL.GATED[kind] == JL.GATED[kind]


def test_embed_lookup():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((32, 8)).astype(np.float32)
    ids = rng.integers(0, 32, size=(2, 5)).astype(np.int32)
    j = JL.apply_embed({"table": jnp.asarray(table)}, jnp.asarray(ids), jnp.bfloat16)
    t = TL.apply_embed({"table": torch.from_numpy(table)}, torch.from_numpy(ids).long(),
                       torch.bfloat16)
    _close(t, j, "bfloat16")


def test_normal_init_truncated_fan_in():
    g = torch.Generator().manual_seed(0)
    w = TL.normal_init((3, 256, 64), g)             # stacked: fan-in is 256
    std = 1 / 16
    assert w.dtype == torch.float32 and w.shape == (3, 256, 64)
    assert w.abs().max() <= 3 * std + 1e-6
    # a ±3σ-truncated unit normal has std 0.9866
    assert abs(w.std().item() / std - 0.9866) < 0.02
    e = TL.embed_init((1000, 16), g)
    assert e.abs().max() <= 0.06 + 1e-6
