"""The port's megatron baseline against the JAX package, on the CPU in fp32.

The fixture writes the inputs (numpy, fixed seeds; the qwen3-0.6b smoke
config's initial parameters from ``repro.models.lm.init_params``), starts
three JAX subprocesses on fake ``("data", "model")`` meshes
(``tests/_jax_megatron_ref.py``: the ops, and the step cases in two
halves), and meanwhile
runs two gloo worlds of the port (``tests/_torch_world.megatron_job``): (1, 4) as the 1x2x2 grid
and (2, 2) as 2x1x2, the same ranks and device-to-rank map as hecaton's.

* each op of ``parallel/megatron.py`` (``col_parallel``,
  ``col_parallel_shared`` with three weights, ``row_parallel``, the gated
  ``ffn``, ``fused_lm_loss_seq``) and ``core/hecaton.embed_2d`` with
  ``t_ax="model"`` (``seq_sharded`` on in the seq layout, off in the
  replicated one) in both residual layouts under overlap none, ring,
  bidir and fused on the bf16 wire, ring and fused on the int8 wire, and
  the seq layout asked of a sequence the ring cannot divide (the per-call
  fallback): forward and the gradients of sum(out * ct), each rank's
  blocks against the JAX global arrays cut by the same specs (a gradient
  of an input that several ranks hold whole summed over them, as
  ``train/step.py`` sums a leaf's), within 2e-5 on both wires, as
  ``tests/test_torch_grid.py`` holds the hecaton ops;
* two fp32 steps of the qwen3-0.6b smoke config against
  ``repro.train.step.build_train_step``: seq x {none, fused} on both
  meshes, seq x fused on the int8 wire and replicated x fused on (1, 4),
  and the non-fused head loss (seq, ring), and hecaton's non-fused head
  loss on the 1x2x2 grid (fused overlap): the loss and every updated
  parameter within 1e-5 relative (int8: the second loss 1e-4, each leaf
  5e-3, ``test_torch_grid.py``'s bounds and reasons);
* the route log against JAX's gates on the same shapes
  (``seq_shardable``, ``seq_loss_ok``, ``rs_ok``, the ``fused_ok_*`` of
  the ring kernels), the layouts (leaf, moment and batch specs against
  ``repro.parallel.specs``, the ``model`` rank layout against
  ``devs.reshape(data, mx * my)``), the options' validation, and the
  launcher's megatron run on the CPU.
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

from repro.config import ParallelConfig as JParallelConfig
from repro.config import get_smoke_config as jax_smoke
from repro.kernels import ring_matmul as JRM
from repro.models import lm as jlm
from repro.parallel import sharding as jshd
from repro.parallel import specs as jspecs
from repro.parallel import zero as jzero
from repro_torch.config import ParallelConfig
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Grid
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import specs, zero
from repro_torch.parallel.context import PCtx

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as TW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
# per step: loss and leaf tolerances (relative), by wire (test_torch_grid.STEP_TOL)
STEP_TOL = {"bf16": ((1e-5, 1e-5), 1e-5), "int8": ((1e-5, 1e-4), 5e-3)}
WORLDS = {(1, 4): (1, 2, 2), (2, 2): (2, 1, 2)}
OP = dict(B=2, T=16, T_RAGGED=18, H=32, F=64, KV=16, V=64)


def _op_inputs(rng):
    """Op inputs (``op/in/*``) and cotangents (``op/ct/*``), the ragged
    sequence's under ``_r`` and ``ragged/``."""
    B, H, F, KV, V = OP["B"], OP["H"], OP["F"], OP["KV"], OP["V"]
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    z = {"w1": f(H, F, scale=H ** -0.5), "w1b": f(H, F, scale=H ** -0.5),
         "w2": f(F, H, scale=F ** -0.5), "wq": f(H, F, scale=H ** -0.5),
         "wk": f(H, KV, scale=H ** -0.5), "wv": f(H, KV, scale=H ** -0.5),
         "table": f(V, H, scale=0.5), "head": f(H, V, scale=H ** -0.5)}
    cts = {}
    for sfx, T in (("", OP["T"]), ("_r", OP["T_RAGGED"])):
        z["x" + sfx], z["y" + sfx] = f(B, T, H), f(B, T, F)
        z["ids" + sfx] = rng.integers(0, V, size=(B, T)).astype(np.int32)
        z["labels" + sfx] = rng.integers(0, V, size=(B, T)).astype(np.int32)
        z["mask" + sfx] = (rng.random((B, T)) > 0.2).astype(np.float32)
        pre = "ragged/" if sfx else ""
        cts.update({pre + "col_parallel": f(B, T, F),
                    pre + "col_parallel_shared": f(B, T, F + 2 * KV),
                    pre + "row_parallel": f(B, T, H), pre + "ffn": f(B, T, H),
                    pre + "embed_2d": f(B, T, H), pre + "fused_lm_loss_seq": f(2)})
    out = {f"op/in/{k}": v for k, v in z.items()}
    out.update({f"op/ct/{k}": v for k, v in cts.items()})
    return out


@pytest.fixture(scope="module")
def meg(tmp_path_factory):
    d = tmp_path_factory.mktemp("megatron_ref")
    inputs = d / "inputs.npz"
    z = _op_inputs(np.random.default_rng(7))
    params0 = jlm.init_params(jax_smoke("qwen3-0.6b"), jax.random.PRNGKey(0))
    for kp, v in jax.tree_util.tree_flatten_with_path(params0)[0]:
        z["init/" + "/".join(str(getattr(k, "key", k)) for k in kp)] = np.asarray(v)
    np.savez(inputs, **z)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               # LLVM at -O0 halves the compile time that dominates the
               # references; it only reorders fp32 sums (every leaf within
               # 1.3e-6 relative of the default level's, losses equal)
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_backend_optimization_level=0")
    outs = {part: d / f"jax_{part.replace(':', '_').replace('/', '_')}.npz"
            for part in ("ops", "train:0/2", "train:1/2")}
    procs = {part: subprocess.Popen([sys.executable, str(ROOT / "tests" / "_jax_megatron_ref.py"),
                                     str(inputs), str(o), part], env=env,
                                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for part, o in outs.items()}
    try:
        worlds = {m: TW.run_world(shape, TW.megatron_job, (str(inputs), m == (1, 4)))
                  for m, shape in WORLDS.items()}
        errs = {part: p.communicate(timeout=900)[1] for part, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for part, p in procs.items():
        assert p.returncode == 0, errs[part][-4000:]
    ref = {}
    for o in outs.values():
        ref.update(np.load(o))
    return SimpleNamespace(inputs=np.load(inputs), ref=_Ref(ref), worlds=worlds)


class _Ref(dict):
    """The parts' arrays as one npz-like mapping."""

    @property
    def files(self):
        return list(self)


def _grid(m, rank):
    return Grid(*WORLDS[m], rank)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

OP_CASES = [(v, name) for v in TW.MEG_OP_VARIANTS for name in TW.meg_op_names(v)]


@pytest.mark.parametrize("variant,op", OP_CASES,
                         ids=[f"{TW.meg_variant_key(v)}-{o}" for v, o in OP_CASES])
def test_megatron_op_matches_jax(meg, variant, op):
    key = f"op/{TW.meg_variant_key(variant)}/{op}"
    z = meg.ref
    T = OP["T_RAGGED"] if variant[0] == "seq-ragged" else OP["T"]
    seq = variant[0] == "seq"
    (ins_spec, outs_spec), _ = TW.meg_op_specs(op, seq and T % 4 == 0)
    want_out = z[f"{key}/out"]
    if op == "col_parallel_shared":
        want_outs = np.split(want_out, np.cumsum([OP["F"], OP["KV"]]), -1)
    else:
        want_outs = [want_out]
    for rank, res in sorted(meg.worlds[(1, 4)].items()):
        grid = _grid((1, 4), rank)
        outs, grads = res[key]
        for o, w, s in zip(outs, want_outs, outs_spec):
            want = specs.local_slice(torch.from_numpy(w), s, grid)
            np.testing.assert_allclose(o, want.numpy(), err_msg=f"{key} rank {rank}", **TOL)
        for (name, s), g in zip(ins_spec.items(), grads):
            want = specs.local_slice(torch.from_numpy(z[f"{key}/grad_{name}"]), s, grid)
            np.testing.assert_allclose(g, want.numpy(), err_msg=f"{key} d{name} rank {rank}",
                                       **TOL)


def _fused_ok(r):
    """JAX's gate for a dispatcher's record (the port logs x's own itemsize)."""
    if r["op"] == "ag_matmul":
        return JRM.fused_ok_ag(r["x"], r["w"], r["n"], 1, r["itemsize"])
    if r["op"] == "matmul_rs":
        return any(JRM.fused_ok_rs(r["x"], r["w"], r["n"], d, r["itemsize"]) for d in (1, 2))
    if r["op"] == "ag_matmul_contract":
        return JRM.fused_ok_contract(r["x"], r["w"], r["n"], r["itemsize"])
    return False


@pytest.mark.parametrize("variant", TW.MEG_OP_VARIANTS, ids=TW.meg_variant_key)
def test_op_routes_follow_jax_gates(meg, variant):
    """Every collective of the ops runs on the model ring of four; the seq
    layout's per-call gates (``seq_shardable``, ``seq_loss_ok``) decide as
    JAX's on the same extents; fused where the kernels' gates allow,
    bidir where the chunk halves, bulk under ``none``, on the variant's
    wire."""
    lay, ov, wire = variant
    k = TW.meg_variant_key(variant)
    T = OP["T_RAGGED"] if lay == "seq-ragged" else OP["T"]
    jax_ax = jshd.AxisInfo(("data",), None, None, ("model",), {"data": 1, "model": 4})
    for rank, res in meg.worlds[(1, 4)].items():
        assert res[f"gate/{k}/seq_shardable"] == jshd.seq_shardable(jax_ax, T)
        assert res[f"gate/{k}/seq_loss_ok"] == bool(meg.ref[f"gate/{k}/seq_loss_ok"])
        routes = res[f"routes/{k}"]
        assert routes and {r["axis"] for r in routes} == {"model"}
        assert {r["n"] for r in routes} == {4}
        ops = {r["op"] for r in routes}
        if lay == "seq":
            assert "fused_lm_loss_seq" in ops
        else:                                      # the replicated path, per call
            assert ops & {"col_parallel_shared", "ffn", "fused_lm_loss_seq"} == set()
            assert any(r["collective"] == "all_reduce" for r in routes)
        for r in routes:
            if r["op"] == "fused_lm_loss_seq":     # JAX's loss ring: one way, any mode
                assert r["route"] == "ring"
            elif ov == "none" or r["collective"] == "all_reduce":
                assert r["route"] == "bulk", r
            elif ov == "fused" and _fused_ok(r):
                assert r["route"] == "fused", r
            else:
                assert r["route"] == ("bidir" if ov == "bidir" and r["chunk"] % 2 == 0
                                      else "ring"), r
            if r["route"] != "bulk":
                assert r["comm_dtype"] == wire, r
        if ov == "fused" and lay != "seq-ragged":
            assert any(r["route"] == "fused" for r in routes)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", TW.MEG_TRAIN_CASES, ids=TW.meg_case_key)
def test_train_steps_match_jax(meg, case):
    z = meg.ref
    key = f"train/{TW.meg_case_key(case)}"
    runs = meg.worlds[case[0]]
    want = z[f"{key}/losses"]
    loss_tol, leaf_tol = STEP_TOL[case[3]]
    for rank, res in runs.items():                  # every rank reports the global loss
        got = np.asarray(res["train"][TW.meg_case_key(case)]["losses"])
        assert np.all(np.abs(got - want) <= np.asarray(loss_tol) * np.abs(want)), \
            (rank, got, want)
    params = runs[0]["train"][TW.meg_case_key(case)]["params"]
    names = [k[len(f"{key}/params/"):] for k in z.files if k.startswith(f"{key}/params/")]
    assert sorted(names) == sorted(params)
    worst = max(names, key=lambda n: _rel(params[n], z[f"{key}/params/{n}"]))
    assert _rel(params[worst], z[f"{key}/params/{worst}"]) <= leaf_tol, worst
    assert _rel(params[worst], meg.inputs[f"init/{worst}"]) > 1e-4      # the steps moved it


@pytest.mark.parametrize("case", TW.MEG_TRAIN_CASES, ids=TW.meg_case_key)
def test_step_routes_follow_jax_gates(meg, case):
    """The step's collectives: the seq layout gathers at entry and
    reduce-scatters at exit on the model ring (every full-sequence
    matmul-RS fused where JAX's gate allows), the loss rings the head's
    vocab chunks where ``seq_loss_ok``, else the logits' labels are
    gathered; the replicated layout all-reduces.  Hecaton's non-fused
    loss gathers its labels over ``mx`` and the tied head is the table
    block transposed (no gather)."""
    (d, m), lay, ov, wire, fused = case[:5]
    routes = meg.worlds[(d, m)][0]["train"][TW.meg_case_key(case)]["routes"]
    ops = {r["op"] for r in routes}
    if TW.meg_strategy(case) == "hecaton":
        assert routes and {r["axis"] for r in routes} <= {"data", "mx", "my"}
        xent = [r for r in routes if r["op"] == "xent_loss"]
        assert xent and all(r["route"] == "bulk" and r["axis"] == "mx" for r in xent)
        assert not ops & {"fused_lm_loss", "fused_lm_loss_seq", "head_weight"}, ops
        assert any(r["route"] == "fused" for r in routes)
        return
    assert {r["axis"] for r in routes} <= {"model", "data"} and routes
    assert ("fused_lm_loss_seq" in ops) == (fused and lay == "seq")
    assert ("xent_loss" in ops) == (not fused)
    for r in routes:
        if r["op"] in ("fused_lm_loss_seq",):
            assert r["route"] == "ring", r
        elif ov == "none" or r["collective"] == "all_reduce" or r["op"] == "xent_loss":
            assert r["route"] == "bulk", r
        elif ov == "fused" and _fused_ok(r):
            assert r["route"] == "fused", r
        else:
            assert r["route"] in ("ring", "bidir"), r
        if r["route"] != "bulk":
            assert r["comm_dtype"] == wire, r
    if lay == "seq" and ov == "fused":
        rs = [r for r in routes if r["op"] == "matmul_rs"]
        assert rs and all(r["route"] == "fused" for r in rs)
    if lay == "replicated":
        assert not any(r["op"] in ("col_parallel_shared", "ffn") for r in routes)


# ---------------------------------------------------------------------------
# layouts and options
# ---------------------------------------------------------------------------

def _flat_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _fake_mesh(d, m):
    return SimpleNamespace(axis_names=("data", "model"), devices=np.empty((d, m)),
                           shape={"data": d, "model": m})


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2), (2, 2, 2), (1, 4, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_leaf_and_moment_specs_match_jax(shape):
    grid = Grid(*shape)
    d, m = grid.data, grid.mx * grid.my
    jax_ax = jshd.AxisInfo(("data",), None, None, ("model",), {"data": d, "model": m})
    assert shd.axis_info(grid, "megatron") == shd.AxisInfo(
        ("data",), None, None, ("model",), grid.sizes)
    for cfg_name in ("qwen3-0.6b", "paper-llama2-7b"):
        cfg = jax_smoke(cfg_name)
        shapes = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))
        for path, leaf in _flat_paths(shapes):
            for fused in (True, False):
                jspec = tuple(jspecs._leaf_spec(path, leaf.shape, jax_ax, "megatron",
                                                fused_loss=fused))
                spec = specs.leaf_spec(path, len(leaf.shape), shd.axis_info(grid, "megatron"),
                                       fused)
                assert spec == jspec, (path, fused)
            jm = tuple(jzero.state_spec(jax.sharding.PartitionSpec(*jspec), leaf.shape,
                                        ("data",), _fake_mesh(d, m), True))
            assert zero.state_spec(spec, leaf.shape, ("data",), grid.sizes) == jm, path
            want_repl = tuple(a for a in ("data", "model")
                              if a not in specs.spec_axes(spec) and grid.size(a) > 1)
            assert specs.replicated_axes(spec, grid, "megatron") == want_repl


@pytest.mark.parametrize("fused", [True, False], ids=["fused_loss", "xent"])
def test_hecaton_leaf_specs_match_jax_under_either_loss(fused):
    """Hecaton's leaf specs with and without the fused loss: the untied
    head (paper-llama2-7b's) is ``(None, my)`` for the fused loss only,
    else a ``W_IN`` leaf like the rest."""
    grid = Grid(1, 2, 2)
    jax_ax = jshd.AxisInfo(("data",), "mx", "my", ("mx", "my"), grid.sizes)
    ax = shd.axis_info(grid, "hecaton")
    for cfg_name in ("qwen3-0.6b", "paper-llama2-7b"):
        cfg = jax_smoke(cfg_name)
        shapes = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))
        for path, leaf in _flat_paths(shapes):
            jspec = tuple(jspecs._leaf_spec(path, leaf.shape, jax_ax, "hecaton",
                                            fused_loss=fused))
            assert specs.leaf_spec(path, len(leaf.shape), ax, fused) == jspec, path


@pytest.mark.parametrize("residual", ["seq", "replicated"])
@pytest.mark.parametrize("S", [16, 18, 1])
@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2)], ids=lambda s: "x".join(map(str, s)))
def test_batch_blocks_follow_jax_batch_specs(shape, S, residual):
    """``local_batch`` cuts tokens over ``model`` exactly where JAX's
    ``batch_specs`` puts ``model`` on the sequence (seq residual and a
    sequence the ring divides), and each rank's block is the global
    batch cut by that spec."""
    grid0 = Grid(*shape)
    d, m = grid0.data, grid0.mx * grid0.my
    jpcfg = JParallelConfig(strategy="megatron", data=d, model=m, mx=1, my=m,
                            residual=residual)
    mesh = _fake_mesh(d, m)
    jspec = tuple(jspecs.batch_specs(mesh, jpcfg, microbatched=False, seq_len=S)["tokens"])
    assert specs.seq_axis(grid0, "megatron", residual, S) == jspec[1]
    B = 4
    tokens = np.arange(B * S).reshape(B, S)
    for r in range(grid0.world):
        grid = Grid(*shape, r)
        got = specs.local_batch({"tokens": tokens}, grid, 1, "megatron", residual)["tokens"]
        want = specs.local_slice(torch.from_numpy(tokens), jspec, grid).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2), (2, 2, 2), (1, 4, 2), (3, 2, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_model_axis_is_the_jax_megatron_reshape(shape):
    """Rank r's ``model`` index and group are its place in
    ``devs.reshape(data, mx * my)`` (``make_small_mesh("megatron")``),
    and the index equals ``axis_index(("mx", "my"))`` (hecaton's heads)."""
    d, mx, my = shape
    devs = np.arange(d * mx * my).reshape(d, mx * my)
    for r in range(devs.size):
        g = Grid(*shape, r)
        row, col = divmod(r, mx * my)
        assert g.axis_index("model") == col == g.axis_index(("mx", "my"))
        assert g.size("model") == mx * my
        assert g.axis_ranks("model") == list(devs[row])
        assert g.axis_ranks("data") == list(devs[:, col])
        assert g.rank_at(model=col) == r


def test_strategy_and_residual_validation():
    """megatron is taken everywhere hecaton was; a typo of the strategy or
    the residual raises in ParallelConfig, the sharding helpers and the
    launcher."""
    cfg = ParallelConfig(strategy="megatron", mx=2, my=2, residual="replicated")
    ctx = PCtx(mode="train", pcfg=cfg, mesh=Grid(1, 2, 2), seq_len=16)
    assert ctx.use_megatron and not ctx.use_hecaton and ctx.residual == "replicated"
    assert ctx.seq_shards == 1 and ctx.attn_layout(16, 8).note == "heads fully sharded"
    seq = PCtx(mode="train", pcfg=ParallelConfig(strategy="megatron", mx=2, my=2),
               mesh=Grid(1, 2, 2), seq_len=16)
    assert seq.seq_shards == 4 and seq.seq_sharded
    assert PCtx(mode="train", pcfg=seq.pcfg, mesh=Grid(1, 2, 2), seq_len=18).seq_shards == 1
    with pytest.raises(ValueError, match="seq_len"):
        PCtx(mode="train", pcfg=seq.pcfg, mesh=Grid(1, 2, 2)).seq_shards
    with pytest.raises(ValueError, match="strategy"):
        ParallelConfig(strategy="megatronn")
    with pytest.raises(ValueError, match="residual"):
        ParallelConfig(residual="sequence")
    with pytest.raises(ValueError, match="strategy"):
        shd.axis_info(Grid(1, 2, 2), "megatronn")
    g = Grid(1, 2, 2)
    for lay in ("seq", "replicated"):
        for strat in ("hecaton", "megatron"):
            jax_ax = jshd.axis_info(SimpleNamespace(
                axis_names=("data", "mx", "my") if strat == "hecaton" else ("data", "model"),
                devices=np.empty((1, 2, 2) if strat == "hecaton" else (1, 4))), strat)
            # the batch's token axis is the canonical residual's (JAX's
            # act_canonical) on a sequence the ring divides
            assert specs.seq_axis(g, strat, lay, 16) == jshd.act_canonical(jax_ax, lay)[1]
    args = launch_train.parser().parse_args(["--smoke", "--device", "cpu", "--mx", "2",
                                             "--strategy", "megatron"])
    launch_train._check_grid_args(args)
    with pytest.raises(ValueError, match="strategy"):
        launch_train._check_grid_args(SimpleNamespace(**dict(vars(args), strategy="2d")))
    with pytest.raises(SystemExit):                      # argparse refuses it first
        launch_train.parser().parse_args(["--smoke", "--strategy", "megatronn"])


def test_launcher_megatron_on_cpu():
    """``--strategy megatron`` through the launcher's grid (1x2x2, fused,
    the smoke config): the plain-version grid trained alongside gives
    every step's loss and grad norm and the final parameters, the
    single-device port the first step's loss; every collective on the
    model ring, the exit matmul-RS fused."""
    args = launch_train.parser().parse_args(
        "--smoke --device cpu --steps 2 --batch 4 --seq 16 --microbatches 2 --mx 2 --my 2 "
        "--strategy megatron --overlap fused --timeout 300".split())
    r = launch_train.run_grid(args, log_fn=lambda *a: None, check_plain=True)
    losses = [loss for _, loss in r["history"]]
    checks = r["checks"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    np.testing.assert_allclose(checks["plain_losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(checks["plain_grad_norms"], r["grad_norms"], rtol=1e-5)
    assert abs(checks["single_step0_loss"] - losses[0]) <= 1e-5 * abs(losses[0]), checks
    assert max(checks["param_rel"].values()) <= 1e-4, checks["param_rel"]
    assert {x["axis"] for x in r["routes"]} == {"model"}
    assert any(x["op"] == "matmul_rs" and x["route"] == "fused" for x in r["routes"])
