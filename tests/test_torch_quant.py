"""The port's int8 wire (``core/quant.py``, ``comm.q_hop``) against the
JAX package's ``repro.core.quant``, on the CPU.

* ``quant_int8`` / ``dequant_int8`` / ``quant_ok`` on numpy inputs from a
  seed, fp32 and bf16: the int8 values equal JAX's on at least 99.9% of
  elements and never differ by more than one level, the scales within one
  fp32 ulp; all-zero rows round-trip exactly; integer payloads and
  trailing extents below 16 are refused (they cross full width).
* One quantized hop on a ring of two ranks (gloo), shift +1 and -1,
  forward and the gradient (the cotangent crosses back quantized),
  against ``quant.ring_hop(..., "int8")`` under ``shard_map`` on a fake
  2-device mesh (one subprocess writes the reference): equal to 1e-6,
  and a narrow shard crosses exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro_torch.core import quant as Q

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as TW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _inputs(rows, h, seed, zero_rows=(1,)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, h)) * rng.lognormal(size=(rows, 1)) * 3).astype(np.float32)
    for r in zero_rows:
        x[r] = 0.0
    return x


def _to_jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,h,seed", [(64, 256, 0), (33, 17, 1), (8, 1000, 2), (5, 8, 3)])
def test_quant_int8_matches_jax(dtype, rows, h, seed):
    x = _inputs(rows, h, seed)
    xt = torch.from_numpy(x).to(dtype)
    q, s = Q.quant_int8(xt)
    jq, js = JQ.quant_int8(_to_jax(x, dtype))
    jq, js = np.asarray(jq).astype(np.int32), np.asarray(js)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == xt.shape and s.shape == (rows, 1)
    diff = np.abs(q.numpy().astype(np.int32) - jq)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, diff.mean()
    ulp = np.spacing(np.abs(js))
    assert np.all(np.abs(s.numpy() - js) <= ulp)
    d = Q.dequant_int8(q, s, dtype)
    jd = np.asarray(JQ.dequant_int8(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                                    _to_jax(x, dtype).dtype)).astype(np.float32)
    assert d.dtype == dtype
    np.testing.assert_array_equal(d.float().numpy(), jd)
    # zero rows: scale 1, q 0, exact zeros back; never NaN or Inf
    assert float(s[1]) == 1.0 and not q[1].any() and not d[1].float().any()
    assert torch.isfinite(d.float()).all()


@pytest.mark.parametrize("shape,dtype", [
    ((4, 16), torch.float32), ((4, 15), torch.float32), ((2, 3, 64), torch.bfloat16),
    ((7,), torch.float32), ((16,), torch.float32), ((4, 64), torch.int32),
    ((4, 64), torch.int64), ((), torch.float32), ((3, 0), torch.float32)])
def test_quant_ok_matches_jax(shape, dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32,
           torch.int64: jnp.int64}[dtype]
    assert Q.quant_ok(shape, dtype) == JQ.quant_ok(shape, jdt)
    assert not Q.quant_ok(shape, dtype) or shape[-1] >= Q.MIN_QUANT_DIM == JQ.MIN_QUANT_DIM


def test_check_comm_dtype():
    assert Q.COMM_DTYPES == JQ.COMM_DTYPES
    for cd in Q.COMM_DTYPES:
        assert Q.check_comm_dtype(cd) == cd
    for bad in ("int4", "fp8", "bfloat16"):
        with pytest.raises(ValueError):
            Q.check_comm_dtype(bad)


@pytest.fixture(scope="module")
def qhop_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("qhop_ref") / "qhop.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "_jax_grid_ref.py"), "qhop",
                        str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return str(out), TW.run_world((1, 1, 2), TW.qhop_job, (str(out),))


@pytest.mark.parametrize("shift", [1, -1])
@pytest.mark.parametrize("name", [c[0] for c in TW.QHOP_CASES])
def test_q_hop_matches_jax(qhop_world, name, shift):
    from repro_torch.launch.mesh import Grid
    from repro_torch.parallel import specs
    ref, world = qhop_world
    z = np.load(ref)
    key = f"qhop/{name}/{shift}"
    for rank, res in sorted(world.items()):
        grid = Grid(1, 1, 2, rank)
        out, grad = res[key]
        want = specs.local_slice(torch.from_numpy(z[f"{key}/out"]), ("my", None), grid).numpy()
        gwant = specs.local_slice(torch.from_numpy(z[f"{key}/grad"]), ("my", None),
                                  grid).numpy()
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6, err_msg=f"{key} {rank}")
        np.testing.assert_allclose(grad, gwant, rtol=1e-6, atol=1e-6, err_msg=f"{key} {rank}")
        # what arrives is the other rank's rows: exactly so for a narrow
        # shard (full width), within half a level for a quantized one (and
        # a bf16 rounding of the dequantized value)
        sent = specs.local_slice(torch.from_numpy(z[f"qhop/{name}/in"]), ("my", None),
                                 Grid(1, 1, 2, 1 - rank)).numpy()
        if name == "narrow":
            np.testing.assert_array_equal(out, sent)
        else:
            level = np.abs(sent).max(axis=-1, keepdims=True) / 127
            eps = 2.0 ** -8 if name == "bf16" else 0.0
            assert np.all(np.abs(out - sent) <= 0.5 * level * (1 + 1e-5) + eps * np.abs(sent))
            assert np.any(out != sent)
