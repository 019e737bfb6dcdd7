"""The port's ring collective matmuls against the JAX package, on the CPU.

* The gates (``pick_block``, ``aligned``, ``fused_ok_ag``/``_rs``/
  ``_contract``) give the JAX package's answers on a grid of shapes,
  itemsizes and ring sizes, and the five full-width route decisions of
  the grid step (qwen3-0.6b, mesh 1x2x2, microbatch 4 x 512, bf16) are
  the fused ones; in fp32 the VMEM budget sends three of them to the ring.
* Each of the four ring ops (``ag_matmul``, ``matmul_rs`` over tokens and
  over columns, ``ag_matmul_contract``, ``matmul_rs_pair``), forward and
  the gradients of sum(out * ct), on a 4-rank world (1x2x2, gloo) against
  ``repro.kernels.ring_matmul`` under ``shard_map`` on a fake 4-device
  mesh (one subprocess writes the reference), at a tile-aligned and a
  ragged shape.  On the CPU the port runs the plain versions (bulk
  collectives, one fp32 matmul) and its backward the transposed rings;
  the JAX package runs its ppermute-emulated rings with the Pallas tile
  loop in interpret mode.  Tolerance 2e-5, as ``tests/_mp/check_hecaton.py``.
* The same ops on the int8 wire (``comm_dtype="int8"``) against JAX's
  int8 rings (each hop ``quant.q_hop``), at those shapes and two wide
  ones where every hopped shard quantizes.  Tolerance 2e-5 on all but
  0.1% of the elements, and one int8 level (the tensor's largest
  magnitude over 127) on those: a product that sums in another order
  can round to the neighbouring level where its value sits on a rounding
  boundary.  The int8 results lie far outside that tolerance of the bf16
  wire's (checked), and at the narrow shapes, where ``quant_ok`` keeps
  every hop full width, they equal it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ring_matmul as JRM
from repro_torch.kernels import ring_matmul as RM

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as TW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def ring_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring_ref") / "ring.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "_jax_grid_ref.py"), "ring",
                        str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return str(out)


@pytest.fixture(scope="module")
def ring_world(ring_ref):
    return TW.run_world((1, 2, 2), TW.ring_job, (ring_ref,))


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pref", [128, 512])
@pytest.mark.parametrize("dim", [1, 7, 64, 96, 128, 130, 200, 256, 384, 512, 520, 1000,
                                 1024, 1536, 3000])
def test_pick_block_and_aligned_match_jax(dim, pref):
    assert RM.pick_block(dim, pref) == JRM.pick_block(dim, pref)
    assert RM.aligned(dim, pref) == JRM.aligned(dim, pref)


GATE_SHAPES = [
    ((4, 256, 512), (512, 512)), ((4, 512, 512), (512, 1024)), ((4, 256, 1536), (1536, 512)),
    ((4, 512, 512), (512, 1536)), ((2, 8, 16), (16, 24)), ((2, 100, 512), (512, 256)),
    ((4, 256, 520), (520, 512)), ((1, 128, 512), (512, 200)), ((8, 512, 1024), (1024, 3072)),
    ((4, 32, 512), (512, 76032)),
]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("xw", GATE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_gates_match_jax(xw, n, itemsize):
    x, w = xw
    for sd in (1, 2):
        assert RM.fused_ok_rs(x, w, n, sd, itemsize) == JRM.fused_ok_rs(x, w, n, sd, itemsize)
    assert RM.fused_ok_ag(x, w, n, 1, itemsize) == JRM.fused_ok_ag(x, w, n, 1, itemsize)
    wc = (n * x[-1], w[-1])
    assert RM.fused_ok_contract(x, wc, n, itemsize) == \
        JRM.fused_ok_contract(x, wc, n, itemsize)


# the grid step's per-rank blocks at full width (qwen3-0.6b, 1x2x2, 4 x 512)
FULL_WIDTH = {
    "q_in_rs": ("rs", (4, 512, 512), (512, 1024), 2),
    "kv_in_ag": ("ag", (4, 256, 512), (512, 512), 1),
    "o_proj_contract": ("contract", (4, 512, 512), (1024, 512), None),
    "up_pair_rs": ("rs", (4, 512, 512), (512, 1536), 1),
    "down_ag": ("ag", (4, 256, 1536), (1536, 512), 1),
}
FP32_FUSED = {"q_in_rs", "kv_in_ag"}          # the VMEM budget refuses the others


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_routes(name):
    kind, x, w, d = FULL_WIDTH[name]
    gate = {"rs": lambda i: RM.fused_ok_rs(x, w, 2, d, i),
            "ag": lambda i: RM.fused_ok_ag(x, w, 2, d, i),
            "contract": lambda i: RM.fused_ok_contract(x, w, 2, i)}[kind]
    jgate = {"rs": lambda i: JRM.fused_ok_rs(x, w, 2, d, i),
             "ag": lambda i: JRM.fused_ok_ag(x, w, 2, d, i),
             "contract": lambda i: JRM.fused_ok_contract(x, w, 2, i)}[kind]
    assert gate(2) and jgate(2)                          # bf16: every block fused
    assert gate(4) == jgate(4) == (name in FP32_FUSED)   # fp32: VMEM budget


def test_int8_wire_raises():
    """The wire dtype is validated: a typo raises, int8 is taken."""
    for bad in ("int4", "fp8", "INT8"):
        with pytest.raises(ValueError, match="comm_dtype"):
            RM.check_comm_dtype(bad)
    assert RM.check_comm_dtype("int8") == "int8" and RM.check_comm_dtype("bf16") == "bf16"


# ---------------------------------------------------------------------------
# the ops on a 4-rank world against JAX under shard_map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", TW.RING_SHAPES)
@pytest.mark.parametrize("name", sorted(TW.RING_CASES))
def test_ring_op_matches_jax(ring_world, ring_ref, name, shape):
    from repro_torch.launch.mesh import Grid
    from repro_torch.parallel import specs
    z = np.load(ring_ref)
    case, key = TW.RING_CASES[name], f"{shape}/{name}"
    for rank, res in sorted(ring_world.items()):
        grid = Grid(1, 2, 2, rank)
        outs, grads = res[key]
        for i, (o, s) in enumerate(zip(outs, case["outs"])):
            want = specs.local_slice(torch.from_numpy(z[f"{key}/out{i}"]), s, grid).numpy()
            np.testing.assert_allclose(o, want, err_msg=f"{key} out{i} rank {rank}", **TOL)
        for i, (g, s) in enumerate(zip(grads, case["ins"])):
            want = specs.local_slice(torch.from_numpy(z[f"{key}/grad{i}"]), s, grid).numpy()
            np.testing.assert_allclose(g, want, err_msg=f"{key} grad{i} rank {rank}", **TOL)


def _int8_close(got, want, err_msg):
    """Within TOL except on at most 0.1% of the elements, and there within
    one int8 level of the tensor."""
    bad = np.abs(got - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)
    level = float(np.abs(want).max()) / 127
    assert bad.mean() <= 1e-3, (err_msg, bad.mean())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL["atol"] + level, err_msg=err_msg)


def _local_ref(z, key, spec, grid):
    from repro_torch.parallel import specs
    return specs.local_slice(torch.from_numpy(z[key]), spec, grid).numpy()


@pytest.mark.parametrize("shape", TW.INT8_RING_SHAPES)
@pytest.mark.parametrize("name", sorted(TW.RING_CASES))
def test_ring_op_int8_matches_jax(ring_world, ring_ref, name, shape):
    from repro_torch.launch.mesh import Grid
    z = np.load(ring_ref)
    case, key = TW.RING_CASES[name], f"int8/{shape}/{name}"
    for rank, res in sorted(ring_world.items()):
        grid = Grid(1, 2, 2, rank)
        outs, grads = res[key]
        for i, (o, s) in enumerate(zip(outs, case["outs"])):
            _int8_close(o, _local_ref(z, f"{key}/out{i}", s, grid), f"{key} out{i} rank {rank}")
        for i, (g, s) in enumerate(zip(grads, case["ins"])):
            _int8_close(g, _local_ref(z, f"{key}/grad{i}", s, grid), f"{key} grad{i} rank {rank}")


# ops whose every hopped shard (forward and backward) is at least
# quant.MIN_QUANT_DIM wide at the aligned shape; matmul_rs_cols scatters a
# 12-wide chunk there, and at the ragged shape every hop is narrower
QUANTIZED_AT_ALIGNED = ("ag_matmul", "matmul_rs_tokens", "ag_matmul_contract", "matmul_rs_pair")


@pytest.mark.parametrize("shape", TW.RING_SHAPES)
@pytest.mark.parametrize("name", sorted(TW.RING_CASES))
def test_int8_tolerance_tells_the_wires_apart(ring_world, ring_ref, name, shape):
    """Where the hops quantize, every output and gradient of the int8 op
    differs from the bf16 wire's (JAX bf16 = port bf16 to 2e-5) by at
    least 10x the int8 test's tolerance, on at least 10x the share of
    elements that test lets off: the int8 check could not pass on the
    bf16 wire.  Where quant_ok keeps every hop full width, they agree."""
    from repro_torch.launch.mesh import Grid
    z = np.load(ring_ref)
    case, key = TW.RING_CASES[name], f"{shape}/{name}"
    quantized = shape == "aligned" and name in QUANTIZED_AT_ALIGNED
    for rank, res in sorted(ring_world.items()):
        grid = Grid(1, 2, 2, rank)
        outs, grads = res[f"int8/{key}"]
        specs_ = [(f"out{i}", s) for i, s in enumerate(case["outs"])] + \
            [(f"grad{i}", s) for i, s in enumerate(case["ins"])]
        for got, (k, s) in zip(outs + grads, specs_):
            bf16 = _local_ref(z, f"{key}/{k}", s, grid)
            gap = np.abs(got - bf16)
            tol = TOL["atol"] + TOL["rtol"] * np.abs(bf16)
            if quantized:
                assert gap.max() >= 10 * tol.max(), (key, k, rank, gap.max(), tol.max())
                assert (gap > tol).mean() >= 1e-2, (key, k, rank, (gap > tol).mean())
            else:
                np.testing.assert_allclose(got, bf16, err_msg=f"{key} {k} rank {rank}", **TOL)
