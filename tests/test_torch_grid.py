"""The port's hecaton grid against the JAX package, on the CPU in fp32.

One subprocess runs the JAX references on fake 4-device meshes and
writes an npz (``tests/_jax_grid_ref.py``); two gloo worlds run the port
(``tests/_torch_world.py``):

* each hecaton op's grid branch (``linear_seq_scatter``, ``mixer_in``,
  ``mixer_out``, ``ffn_block`` with the gated pair, ``embed_2d``,
  ``fused_lm_loss``) under each variant (``overlap`` none, ring, fused,
  bidir on the bf16 wire; ring, bidir, fused on the int8 wire) on 1x2x2,
  forward and the gradients of sum(out * ct), each rank's blocks against
  the JAX global arrays cut by the same specs; tolerance 2e-5, as
  ``tests/_mp/check_hecaton.py`` (measured ~2e-7 on both wires);
* two steps of the grid training step on the qwen3-0.6b smoke config (2
  layers) on 1x2x2 and 2x1x2 under each variant, from the JAX initial
  parameters, against ``repro.train.step.build_train_step`` on the same
  mesh and variant (fp32 gradient reduction, lr 1e-3 from the first
  step): on the bf16 wire the loss and every updated parameter,
  gathered, within 1e-5 relative (per leaf, L2; measured ~1e-6).  On the
  int8 wire the first step's loss within 1e-5 too, the second's within
  1e-4 and each leaf within 5e-3 (measured 5.1e-6, 3.4e-5 and 1.6e-3):
  an fp32 product that sums in another order than JAX's can round to
  the neighbouring int8 level where it sits on a rounding boundary (a
  few of the ~1e5 quantized values a step), and AdamW's first update,
  lr * g / |g|, turns such a change into a 2 lr move of any element
  whose gradient it flips.  The int8 losses also stay within 5% of the
  bf16 wire's (JAX's ``QUANT_RTOL``);
* the port's route log against the JAX gates' decisions (``bidir``
  degrading to ``ring`` on odd extents), the layout helpers (leaf specs,
  ZeRO-1 moment specs, the attention solver, the rank layout) against
  the JAX package's, the validation of the mode and wire strings, and
  the launcher's grid run on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.config import get_smoke_config as jax_smoke
from repro.kernels import ring_matmul as JRM
from repro.models import lm as jlm
from repro.parallel import sharding as jshd
from repro.parallel import specs as jspecs
from repro.parallel import zero as jzero
from repro_torch.config import ParallelConfig
from repro_torch.core import overlap as OV
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Grid
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import specs, zero
from repro_torch.parallel.context import PCtx

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as TW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
MESHES = [(1, 2, 2), (2, 1, 2)]


@pytest.fixture(scope="module")
def grid_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("grid_ref") / "grid.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "_jax_grid_ref.py"), "grid",
                        str(out)], env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return str(out)


@pytest.fixture(scope="module")
def worlds(grid_ref):
    return {shape: TW.run_world(shape, TW.grid_job, (grid_ref, shape == (1, 2, 2)))
            for shape in MESHES}


# ---------------------------------------------------------------------------
# hecaton ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", TW.VARIANTS)
@pytest.mark.parametrize("op", sorted(TW.OP_CASES))
def test_hecaton_op_matches_jax(worlds, grid_ref, op, mode):
    z = np.load(grid_ref)
    case, key = TW.OP_CASES[op], f"op/{mode}/{op}"
    for rank, res in sorted(worlds[(1, 2, 2)].items()):
        grid = Grid(1, 2, 2, rank)
        out, grads = res[key]
        want = specs.local_slice(torch.from_numpy(z[f"{key}/out"]), case["out"], grid)
        np.testing.assert_allclose(out, want.numpy(), err_msg=f"{key} rank {rank}", **TOL)
        for (name, spec), g in zip(case["ins"].items(), grads):
            want = specs.local_slice(torch.from_numpy(z[f"{key}/grad_{name}"]), spec, grid)
            np.testing.assert_allclose(g, want.numpy(), err_msg=f"{key} d{name} rank {rank}",
                                       **TOL)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# per step: loss and leaf tolerances (relative), by wire
STEP_TOL = {"bf16": ((1e-5, 1e-5), 1e-5), "int8": ((1e-5, 1e-4), 5e-3)}
QUANT_RTOL = 0.05           # int8 against bf16 wire losses (tests/_mp/check_overlap.py)


@pytest.mark.parametrize("mode", TW.VARIANTS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_train_steps_match_jax(worlds, grid_ref, shape, mode):
    z = np.load(grid_ref)
    key = f"train/{shape[0]}x{shape[1]}x{shape[2]}/{mode}"
    runs = worlds[shape]
    want = z[f"{key}/losses"]
    loss_tol, leaf_tol = STEP_TOL[TW.variant(mode)[1]]
    for rank, res in runs.items():          # every rank reports the global loss
        got = np.asarray(res["train"][mode]["losses"])
        assert np.all(np.abs(got - want) <= np.asarray(loss_tol) * np.abs(want)), \
            (rank, got, want)
    params = runs[0]["train"][mode]["params"]
    names = [k[len(f"{key}/params/"):] for k in z.files if k.startswith(f"{key}/params/")]
    assert sorted(names) == sorted(params)
    worst = max(names, key=lambda n: _rel(params[n], z[f"{key}/params/{n}"]))
    assert _rel(params[worst], z[f"{key}/params/{worst}"]) <= leaf_tol, worst
    moved = _rel(params[worst], z[f"train/init/{worst}"])
    assert moved > 1e-4                      # the steps did update the parameters


@pytest.mark.parametrize("mode", ["ring", "bidir", "fused"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_int8_losses_track_the_bf16_wire(worlds, shape, mode):
    """The int8 wire's losses within JAX's QUANT_RTOL of the bf16 wire's,
    and not equal to them (the hops did quantize)."""
    train = worlds[shape][0]["train"]
    q, b = np.asarray(train[f"{mode}-int8"]["losses"]), np.asarray(train[mode]["losses"])
    assert np.all(np.abs(q - b) <= QUANT_RTOL * np.abs(b)), (q, b)
    assert np.any(q != b)
    assert {r["comm_dtype"] for r in train[f"{mode}-int8"]["routes"]
            if r["route"] != "bulk"} == {"int8"}


_GATES = {
    "ag_matmul": lambda r: JRM.fused_ok_ag(r["x"], r["w"], r["n"], 1, r["itemsize"]),
    "matmul_rs": lambda r: any(JRM.fused_ok_rs(r["x"], r["w"], r["n"], d, r["itemsize"])
                               for d in (1, 2)),
    "ag_matmul_contract": lambda r: JRM.fused_ok_contract(r["x"], r["w"], r["n"],
                                                          r["itemsize"]),
    "matmul_rs_pair": lambda r: JRM.fused_ok_rs(r["x"], r["w"], r["n"], 1, r["itemsize"]),
}


def _extents(r):
    """The extents a ring record's halvable chunk can be: a dim of x, or a
    dim of x or w's last dim split over the ring."""
    dims = list(r["x"]) + ([r["w"][-1]] if r["w"] else [])
    return set(dims) | {d // r["n"] for d in dims}


def _ring_want(mode, r):
    """JAX's ring primitives halve the chunk under bidir when it is even."""
    assert r["chunk"] in _extents(r), r
    return "bidir" if mode == "bidir" and r["chunk"] % 2 == 0 else "ring"


@pytest.mark.parametrize("mode", TW.VARIANTS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_routes_follow_jax_gates(worlds, shape, mode):
    routes = worlds[shape][0]["train"][mode]["routes"]
    overlap, wire = TW.variant(mode)
    assert routes
    seen = set()
    for r in routes:
        seen.add(r["route"])
        if overlap == "none":
            assert r["route"] == "bulk", r
        elif r["op"] in _GATES and overlap == "fused" and _GATES[r["op"]](r):
            assert r["route"] == "fused", r
        elif r["route"] != "bulk":
            assert r["route"] == _ring_want(overlap, r), r
        if r["route"] != "bulk":
            assert r["comm_dtype"] == wire, r
    if overlap == "fused":
        assert "fused" in seen
    if overlap == "bidir":
        assert "bidir" in seen


# ---------------------------------------------------------------------------
# layouts and options
# ---------------------------------------------------------------------------

def _jax_axis_info(grid):
    return jshd.AxisInfo(("data",), "mx", "my", ("mx", "my"), grid.sizes)


def _flat_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("shape", MESHES + [(2, 2, 2)], ids=lambda s: "x".join(map(str, s)))
def test_leaf_and_moment_specs_match_jax(shape):
    grid = Grid(*shape)
    cfg = jax_smoke("qwen3-0.6b")
    shapes = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))
    jax_ax = _jax_axis_info(grid)
    fake_mesh = SimpleNamespace(axis_names=("data", "mx", "my"),
                                devices=np.empty(shape))
    for path, leaf in _flat_paths(shapes):
        jspec = tuple(jspecs._leaf_spec(path, leaf.shape, jax_ax, "hecaton", fused_loss=True))
        spec = specs.leaf_spec(path, len(leaf.shape), shd.axis_info(grid))
        assert spec == jspec, path
        jm = tuple(jzero.state_spec(jax.sharding.PartitionSpec(*jspec), leaf.shape, ("data",),
                                    fake_mesh, True))
        assert zero.state_spec(spec, leaf.shape, ("data",), grid.sizes) == jm, path


@pytest.mark.parametrize("heads,batch", [(16, 4), (4, 2), (40, 8), (6, 4), (3, 1)])
@pytest.mark.parametrize("shape", MESHES + [(1, 4, 4)], ids=lambda s: "x".join(map(str, s)))
def test_attention_layout_matches_jax(shape, heads, batch):
    grid = Grid(*shape)
    a = shd.solve_attn_layout(shd.axis_info(grid), heads, batch)
    b = jshd.solve_attn_layout(_jax_axis_info(grid), heads, batch)
    assert (a.batch_axes, a.head_axes, a.note) == (b.batch_axes, b.head_axes, b.note)
    assert a.q_spec() == tuple(b.q_spec())


@pytest.mark.parametrize("shape", MESHES + [(2, 2, 2), (1, 4, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rank_layout_is_the_jax_device_layout(shape):
    devs = np.arange(np.prod(shape)).reshape(shape)      # make_small_mesh's reshape
    for r in range(devs.size):
        g = Grid(*shape, r)
        assert devs[g.coords_of(r)] == r
        for ax in ("data", "mx", "my"):
            line = np.moveaxis(devs, ("data", "mx", "my").index(ax), 0)
            idx = tuple(c for a, c in zip(("data", "mx", "my"), g.coords_of(r)) if a != ax)
            assert g.axis_ranks(ax) == list(line[(slice(None),) + idx])


def test_bidir_and_int8_raise():
    """bidir and int8 are taken; a typo of either raises ValueError in
    check_mode / check_comm_dtype, ParallelConfig (so PCtx never sees
    one), and the launcher's checks."""
    from repro_torch.kernels import ring_matmul as RM
    assert OV.check_mode("bidir") == "bidir" and RM.check_comm_dtype("int8") == "int8"
    ctx = PCtx(mode="train", pcfg=ParallelConfig(mx=2, overlap="bidir", comm_dtype="int8"),
               mesh=Grid(1, 2, 1))
    assert ctx.comm_dtype == "int8" and ctx.grid_kwargs()["comm_dtype"] == "int8"
    with pytest.raises(ValueError, match="overlap"):
        OV.check_mode("rings")
    with pytest.raises(ValueError, match="comm_dtype"):
        RM.check_comm_dtype("int4")
    with pytest.raises(ValueError, match="overlap"):
        ParallelConfig(mx=2, overlap="rings")
    with pytest.raises(ValueError, match="comm_dtype"):
        ParallelConfig(mx=2, comm_dtype="int4")
    args = launch_train.parser().parse_args(["--smoke", "--device", "cpu", "--mx", "2",
                                             "--overlap", "bidir", "--comm-dtype", "int8"])
    launch_train._check_grid_args(args)
    for field, bad in (("overlap", "rings"), ("comm_dtype", "int4")):
        with pytest.raises(ValueError, match=field):
            launch_train._check_grid_args(SimpleNamespace(**dict(vars(args), **{field: bad})))
    for extra in (["--overlap", "rings"], ["--comm-dtype", "int4"]):
        with pytest.raises(SystemExit):          # argparse refuses it first
            launch_train.parser().parse_args(["--smoke", *extra])


def test_launcher_grid_on_cpu():
    """The launcher's grid path end to end (1x2x2, fused, smoke config): the
    plain-version grid trained alongside gives every step's loss and grad
    norm and the final parameters, the single-device port the first
    step's loss."""
    args = launch_train.parser().parse_args(
        "--smoke --device cpu --steps 2 --batch 4 --seq 16 --microbatches 2 --mx 2 --my 2 "
        "--overlap fused --timeout 300".split())
    r = launch_train.run_grid(args, log_fn=lambda *a: None, check_plain=True)
    losses = [loss for _, loss in r["history"]]
    checks = r["checks"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    np.testing.assert_allclose(checks["plain_losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(checks["plain_grad_norms"], r["grad_norms"], rtol=1e-5)
    assert abs(checks["single_step0_loss"] - losses[0]) <= 1e-5 * abs(losses[0]), checks
    assert max(checks["param_rel"].values()) <= 1e-5, checks["param_rel"]
    assert sorted(r["launches"]) == [0, 1, 2, 3]
    assert any(x["route"] == "fused" for x in r["routes"])


def test_launcher_grid_bidir_int8_on_cpu():
    """The launcher's grid path with --overlap bidir --comm-dtype int8 (1x2x2,
    smoke config): the plain-version grid trained alongside runs the
    same rings on the same wire, so the two agree as on the bf16 wire;
    the single-device port has no wire, so its first loss is within
    JAX's QUANT_RTOL."""
    args = launch_train.parser().parse_args(
        "--smoke --device cpu --steps 2 --batch 4 --seq 16 --microbatches 2 --mx 2 --my 2 "
        "--overlap bidir --comm-dtype int8 --timeout 300".split())
    r = launch_train.run_grid(args, log_fn=lambda *a: None, check_plain=True)
    losses = [loss for _, loss in r["history"]]
    checks = r["checks"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    np.testing.assert_allclose(checks["plain_losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(checks["plain_grad_norms"], r["grad_norms"], rtol=1e-5)
    assert abs(checks["single_step0_loss"] - losses[0]) <= QUANT_RTOL * abs(losses[0])
    routes = {(x["route"], x["comm_dtype"]) for x in r["routes"]}
    assert ("bidir", "int8") in routes and not any(x == "fused" for x, _ in routes)


def test_bidir_degrades_to_ring_on_odd_chunks():
    """Each bidir dispatcher (and the pure rings) on an extent that halves
    and on an odd one (1x1x2 world, fp32, both wires): the dispatchers'
    route log says bidir or ring as JAX's primitives decide, a degraded
    collective (the pure rings' too) equals the ring's result exactly, and
    every result matches the bulk collective (bf16 wire; int8 within its
    quantization)."""
    res = TW.run_world((1, 1, 2), TW.bidir_job)
    for rank, cases in res.items():
        for (name, chunk, wire), (routes, got, ring, bulk) in cases.items():
            want = "bidir" if chunk % 2 == 0 else "ring"
            assert routes is None or routes == [want], (name, chunk, routes)
            if want == "ring":
                np.testing.assert_array_equal(got, ring, err_msg=f"{name} {chunk} {wire}")
            tol = 2e-5 if wire == "bf16" else 0.05 * float(np.abs(bulk).max())
            np.testing.assert_allclose(got, bulk, rtol=2e-5, atol=tol,
                                       err_msg=f"{name} {chunk} {wire} rank {rank}")
