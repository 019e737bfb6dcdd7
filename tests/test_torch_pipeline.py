"""The port's inter-pod 1F1B pipeline (``repro_torch/parallel/pipeline.py``)
against the JAX package's, on the CPU in fp32.

* **Schedule and partition** (no worlds): every case of
  ``tests/test_pipeline.py`` on both packages — the GRID (p, m) tables
  (the port's ``schedule_1f1b(p, m).ticks`` equal JAX's task for task),
  makespan, bubble and in-flight properties, ``stage_order``'s warm-up,
  steady and cool-down, the degenerate schedules, the config validation
  and ``validate_pipeline``'s five refusals (the same messages),
  ``split_stage_layers``, the ``stage_params``/``merge_stage_grads``
  round trip on JAX-exported parameters, ``stage_writer_map`` on equal
  names; the grid's ``pod`` axis against JAX's ``make_small_mesh(...,
  pods)`` reshape.
* **Numerics** (gloo worlds against ``tests/_jax_pipeline_ref.py``'s JAX
  ``PipelineRunner`` on a fake 8-device mesh, ``tests/_mp/
  check_pipeline.py``'s config): every case of ``_pipeline_cases.CASES``
  — 2x(1x1x1) with two optimizer steps at the launcher's horizon,
  2x(1x2x2) under ``none`` and ``fused``, 4x(1x1x2) at m 4 and 2, and
  megatron 2x(1, 2) in the ``replicated`` residual (the cotangent
  convention) — the loss within 1e-5, every gradient within rtol 2e-4 /
  atol 2e-5 (the check's tolerances), the executed orders and stash
  peaks equal to JAX's.
* **Runtime and checkpoints**: ``check_guard.py``'s B2 and B3 and
  ``check_checkpoint.py --pipeline-quorum`` on a 2x(1x1x2) world and on
  JAX (the same incarnations, restored steps, blocklists, steps and
  writer pinning; the histories within 1e-5; the port's resumed steps and
  state bit-equal to its clean run over the filtered stream); a pipeline
  step directory the world writes is byte-identical to JAX's save of the
  same state (two writers, and three with quorum two); a JAX pipeline
  checkpoint resumes in the port and the port's in JAX, within 1e-5.
* **The launcher**: ``--pods 2 --pod-role pipeline`` on the CPU against
  its plain run and the single-device port, a checkpoint resumed, and
  ``--pod-role data`` refused.

The JAX parts run in subprocesses beside the port's worlds, as
``tests/test_torch_megatron.py`` runs its references.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.manager as JM
import repro.core.theory as JTH
from repro.config import ModelConfig as JModelConfig
from repro.config import ParallelConfig as JParallelConfig
from repro.models import lm as jlm
from repro.optim.adamw import AdamState as JAdamState
from repro.parallel import pipeline as JPP
from repro_torch.bridge import master_params_from_jax
from repro_torch.config import ModelConfig, ParallelConfig, RunConfig
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Grid
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel import pipeline as PP
from repro_torch.train import step as TS

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _jax_pipeline_ref as REF  # noqa: E402
import _pipeline_cases as PC  # noqa: E402
import _torch_world as TW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRID = [(2, 2), (2, 4), (2, 8), (3, 3), (4, 2), (4, 8), (4, 16), (8, 8)]
TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_RTOL = 1e-5


def _ticks(sched):
    return [tuple(None if t is None else (t.kind, t.mb) for t in row) for row in sched.ticks]


# ---------------------------------------------------------------------------
# schedule (no worlds)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,m", GRID)
def test_schedule_table_equals_jax(p, m):
    assert _ticks(PP.schedule_1f1b(p, m)) == _ticks(JPP.schedule_1f1b(p, m))


@pytest.mark.parametrize("p,m", GRID)
def test_makespan_bubble_and_in_flight(p, m):
    s, js = PP.schedule_1f1b(p, m), JPP.schedule_1f1b(p, m)
    assert s.makespan == js.makespan == 2 * (m + p - 1)
    assert abs(s.bubble_fraction - JTH.pipeline_bubble_fraction(p, m)) < 1e-12
    for stage in range(p):
        assert s.bubble_ticks(stage) == js.bubble_ticks(stage) == 2 * (p - 1)
        assert s.peak_in_flight(stage) == js.peak_in_flight(stage) == min(p - stage, m)


@pytest.mark.parametrize("p,m", GRID)
def test_stage_order_warmup_steady_cooldown(p, m):
    for stage in range(p):
        order = PP.stage_order(stage, p, m)
        assert [(t.kind, t.mb) for t in order] == [
            (t.kind, t.mb) for t in JPP.stage_order(stage, p, m)]
        kinds = [t.kind for t in order]
        w = min(p - 1 - stage, m)
        assert kinds[:w] == ["F"] * w
        assert kinds[w:w + 2 * (m - w)] == ["F", "B"] * (m - w)
        assert kinds[w + 2 * (m - w):] == ["B"] * w
        assert [t.mb for t in order if t.kind == "F"] == list(range(m))
        assert [t.mb for t in order if t.kind == "B"] == list(range(m))


@pytest.mark.parametrize("p,m", GRID)
def test_schedule_dependencies(p, m):
    done = {}
    for t, row in enumerate(PP.schedule_1f1b(p, m).ticks):
        for stage, task in enumerate(row):
            if task is None:
                continue
            if task.kind == "F" and stage > 0:
                assert done[("F", stage - 1, task.mb)] < t
            if task.kind == "B" and stage < p - 1:
                assert done[("B", stage + 1, task.mb)] < t
            if task.kind == "B":
                assert done[("F", stage, task.mb)] < t
            done[(task.kind, stage, task.mb)] = t
    assert len(done) == 2 * p * m


def test_schedule_degenerate():
    for p, m in ((1, 3), (1, 1)):
        s = PP.schedule_1f1b(p, m)
        assert _ticks(s) == _ticks(JPP.schedule_1f1b(p, m))
        assert s.makespan == 2 * m and s.bubble_fraction == 0.0


# ---------------------------------------------------------------------------
# configuration, validation and partition
# ---------------------------------------------------------------------------

def test_pipeline_config_validated_as_jax():
    for kw, match in ((dict(pods=1, pod_axis_role="pipeline"), "pods > 1"),
                      (dict(pod_axis_role="bogus"), "pod_axis_role"),
                      (dict(pods=0), "pods"), (dict(microbatches=0), "microbatches")):
        with pytest.raises(ValueError, match=match):
            JParallelConfig(data=1, model=1, mx=1, my=1, **kw)
        with pytest.raises(ValueError, match=match):
            ParallelConfig(**kw)
    p = ParallelConfig(pods=2, pod_axis_role="pipeline")
    assert p.pipeline_enabled and p.pipeline_stages == 2
    d = ParallelConfig(pods=2)
    assert not d.pipeline_enabled and d.pipeline_stages == 1
    assert p.with_(pods=1, pod_axis_role="data") == ParallelConfig()


def test_build_train_step_refuses_pipeline_config():
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=8, num_heads=2,
                      num_kv_heads=2, d_ff=16, vocab_size=32)
    with pytest.raises(ValueError, match="pipeline"):
        TS.build_train_step(cfg, ParallelConfig(pods=2, pod_axis_role="pipeline"),
                            RunConfig("t", "train", 8, 4))


def test_runner_refuses_embed_dropout():
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=8, num_heads=2,
                      num_kv_heads=2, d_ff=16, vocab_size=32, embed_dropout=0.1)
    with pytest.raises(ValueError, match="embed_dropout"):
        PP.PipelineRunner(cfg, ParallelConfig(pods=2, pod_axis_role="pipeline"),
                          RunConfig("t", "train", 8, 4), Grid(1, 1, 1, 0, pods=2))


def _refusal_cases():
    base = dict(name="t", num_layers=4, d_model=8, num_heads=2, num_kv_heads=2, d_ff=16,
                vocab_size=32)
    return {
        "not_enabled": (dict(base, family="dense"), dict(pods=1), "pods > 1"),
        "tied": (dict(base, family="dense", tie_embeddings=True), {}, "tie_embeddings"),
        "ssm": (dict(base, family="ssm"), {}, "attention"),
        "odd": (dict(base, family="dense", num_layers=5), {}, "divide"),
        "vlm": (dict(base, family="vlm"), {}, "token-only"),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_validate_pipeline_refuses_as_jax(case):
    mkw, pkw, match = _refusal_cases()[case]
    pods = pkw.get("pods", 2)
    jextra = {"block_pattern": ("mamba",) * 4} if case == "ssm" else {}
    if case == "vlm":
        jextra = {"frontend_stub_len": 4}
    jp = JParallelConfig(data=1, model=1, mx=1, my=1, pods=pods,
                         pod_axis_role="pipeline" if pods > 1 else "data")
    tp = ParallelConfig(pods=pods, pod_axis_role="pipeline" if pods > 1 else "data")
    with pytest.raises(ValueError, match=match):
        JPP.validate_pipeline(JModelConfig(**mkw, **jextra), jp)
    with pytest.raises(ValueError, match=match):
        PP.validate_pipeline(ModelConfig(**mkw), tp)


def test_split_stage_layers():
    for n, p in ((8, 2), (22, 2), (4, 4)):
        assert PP.split_stage_layers(n, p) == JPP.split_stage_layers(n, p)
    for n, p in ((6, 4), (5, 2)):
        with pytest.raises(ValueError, match="divide"):
            PP.split_stage_layers(n, p)


def test_stage_params_roundtrip_on_jax_parameters():
    cfg_j = JModelConfig(name="t", family="dense", num_layers=4, d_model=16, num_heads=2,
                         num_kv_heads=2, d_ff=32, vocab_size=32)
    cfg = ModelConfig(name="t", family="dense", num_layers=4, d_model=16, num_heads=2,
                      num_kv_heads=2, d_ff=32, vocab_size=32)
    jparams = jax.tree.map(np.asarray, jlm.init_params(cfg_j, jax.random.PRNGKey(0)))
    params = master_params_from_jax(jparams, device="cpu")
    stages = [PP.stage_params(params, cfg, s, 2) for s in range(2)]
    jstages = [JPP.stage_params(jparams, cfg_j, s, 2) for s in range(2)]
    assert "embed" in stages[0] and "embed" not in stages[1]
    assert "lm_head" in stages[1] and "lm_head" not in stages[0]
    assert "final_norm" in stages[1]
    for st, jst in zip(stages, jstages):
        got, want = lm.flatten(st), REF._flat(jst, "")
        assert [".".join(p) for p, _ in got] == [k.replace("/", ".") for k in want]
        for (_, t), w in zip(got, want.values()):
            np.testing.assert_array_equal(t.detach().numpy(), w)
    merged = PP.merge_stage_grads(stages, cfg)
    for (p, a), (q, b) in zip(lm.flatten(params), lm.flatten(merged)):
        assert p == q
        assert torch.equal(a.detach(), b.detach())


def test_stage_writer_map_equals_jax():
    names = ["params/0/blocks/attn/wq", "params/1/lm_head/w", "opt_state/0/.step",
             "opt_state/3/.mu/embed/table", "opt_state/2/.nu/final_norm/scale", "list",
             "a%2Fb", "x/y/z", "params/notint/w", "params/5"]
    for n in (1, 2, 3):
        jm, tm = JPP.stage_writer_map(n), PP.stage_writer_map(n)
        assert [tm(x) for x in names] == [jm(x) for x in names]


@pytest.mark.parametrize("shape", [(2, 1, 1, 1), (2, 1, 2, 2), (4, 1, 1, 2), (2, 2, 1, 2),
                                   (3, 2, 2, 1)], ids=lambda s: "x".join(map(str, s)))
def test_pod_axis_is_the_jax_mesh_reshape(shape):
    """Rank r sits at devs.reshape(pods, data, mx, my)'s place of r
    (``make_small_mesh(..., pods)``); the other axes' groups stay in one
    pod; the pod group links (data, mx, my) across pods; ``pod_grid`` is
    the pod as a one-pod grid; with pods 1 nothing changes."""
    pods, d, mx, my = shape
    devs = np.arange(pods * d * mx * my).reshape(pods, d, mx, my)
    for r in range(devs.size):
        g = Grid(d, mx, my, r, pods=pods)
        s, a, x, y = (int(v[0]) for v in np.nonzero(devs == r))
        assert g.coords == {"pod": s, "data": a, "mx": x, "my": y, "model": x * my + y}
        assert g.axis_ranks("pod") == list(devs[:, a, x, y])
        assert g.axis_ranks("data") == list(devs[s, :, x, y])
        assert g.axis_ranks("mx") == list(devs[s, a, :, y])
        assert g.axis_ranks("my") == list(devs[s, a, x, :])
        assert g.axis_ranks("model") == list(devs[s, a].reshape(-1))
        assert g.pod_grid() == Grid(d, mx, my, r % (d * mx * my))
        one = Grid(d, mx, my, r % (d * mx * my))
        assert one.pods == 1 and one.size("pod") == 1
        assert one.axis_ranks("my") == list(devs[0, a, x, :])


# ---------------------------------------------------------------------------
# numerics, runtime and checkpoints against JAX
# ---------------------------------------------------------------------------

def _jax_state_for_bytes(z):
    """A pipeline state in JAX's form: the rt config's stage trees, random
    moments, step 3, EWMA 0.5."""
    rng = np.random.default_rng(3)
    p0 = REF._tree(z, "rt_init/")
    cfg = REF.rt_cfg()
    sp = [JPP.stage_params(p0, cfg, s, 2) for s in range(2)]
    opt = [JAdamState(jnp.int32(3),
                      jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape),
                                                         jnp.float32), t),
                      jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape), jnp.float32), t),
                      jnp.float32(0.5)) for t in sp]
    return {"params": sp, "opt_state": opt}


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    inputs = d / "inputs.npz"
    z = {}
    for pre, cfg in (("init/", REF.num_cfg()), ("rt_init/", REF.rt_cfg())):
        z.update(REF._flat(jlm.init_params(cfg, jax.random.PRNGKey(0)), pre))
    tok = np.random.default_rng(7).integers(0, PC.NUM["vocab"],
                                            size=(PC.NUM["batch"], PC.NUM["seq"]))
    z["batch/tokens"], z["batch/labels"] = tok.astype(np.int32), np.roll(tok, -1, 1).astype(
        np.int32)
    np.savez(inputs, **z)
    zl = np.load(inputs)
    # JAX's saves of one state, in the two writer layouts
    layouts = {"w2": (2, None), "w3q2": (3, 2)}
    state = _jax_state_for_bytes(zl)
    for tag, (w, q) in layouts.items():
        JM.CheckpointManager(str(d / f"jax_{tag}"), writers=w, quorum=q,
                             writer_map=JPP.stage_writer_map(w)).save(3, state)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_backend_optimization_level=0")
    ref = ROOT / "tests" / "_jax_pipeline_ref.py"

    def start(part, out, arg=None):
        cmd = [sys.executable, str(ref), str(inputs), str(out), part] + (
            [str(arg)] if arg else [])
        return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
    (d / "jax_rt").mkdir()
    parts = {f"num:{k}/3": d / f"jax_num{k}.npz" for k in range(3)}
    parts["rt"] = d / "jax_rt.npz"
    procs = {p: start(p, o, d / "jax_rt" if p == "rt" else None) for p, o in parts.items()}
    ck = start("ckpt", d / "jax_ckpt.npz", d / "jax_ckpt")
    procs["ckpt"] = ck
    # one world per shape; the 2x(1x1x2) world also runs the runtime and
    # checkpoint replays, once JAX's checkpoint is written
    shapes = {}
    for c in PC.CASES:
        shapes.setdefault((c[1], c[2]), []).append(c)
    rt_shape = (2, PC.RT_STAGE)
    try:
        num = {}
        for (pods, shape), cases in shapes.items():
            if (pods, shape) != rt_shape:
                for rank, res in TW.run_pipeline_world(pods, shape, TW.pipeline_num_job,
                                                       (str(inputs), cases)).items():
                    for name, r in res.items():
                        num.setdefault(name, {})[rank] = r
        (d / "port_rt").mkdir()
        byte_dirs = [(str(d / f"jax_{t}"), str(d / f"port_{t}"), w, q)
                     for t, (w, q) in layouts.items()]
        assert ck.wait(timeout=900) == 0, ck.stderr.read()[-4000:]
        rt = TW.run_pipeline_world(
            *rt_shape, TW.pipeline_rt_job,
            (str(inputs), str(d / "port_rt"), shapes[rt_shape],
             (str(d / "jax_ckpt"), str(d / "port_ckpt"), byte_dirs)))
        for rank, res in rt.items():
            for name, r in res["num"].items():
                num.setdefault(name, {})[rank] = r
        procs["resume"] = start("resume", d / "jax_resume.npz", d / "port_ckpt")
        errs = {p: pr.communicate(timeout=900)[1] for p, pr in procs.items()}
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
    for p, pr in procs.items():
        assert pr.returncode == 0, (p, errs[p][-4000:])
    refs = {}
    for o in list(parts.values()) + [d / "jax_ckpt.npz", d / "jax_resume.npz"]:
        refs.update(np.load(o))
    return SimpleNamespace(dir=d, ref=refs, num=num, rt=rt[0]["rt"], ckpt=rt[0]["ckpt"],
                           layouts=layouts)


def _stage_heads(world):
    """{stage: the stage rank 0's result} of a numerics world."""
    return {r["stage"]: r for r in world.values() if r["grads"] is not None}


def _merged(heads, key):
    trees = []
    for s in sorted(heads):
        items = heads[s][key]
        trees.append(lm.unflatten([tuple(k.split(".")) for k in items], list(items.values())))
    return {".".join(p): v for p, v in lm.flatten(PP.merge_stage_grads(trees, None))}


@pytest.mark.parametrize("case", PC.CASES, ids=[c[0] for c in PC.CASES])
def test_pipeline_matches_jax(pipe, case):
    name, pods = case[0], case[1]
    z, world = pipe.ref, pipe.num[name]
    want_loss = float(z[f"{name}/loss"])
    for r in world.values():
        if r["stage"] == pods - 1:
            assert abs(r["loss"] - want_loss) <= LOSS_RTOL * abs(want_loss), (r["loss"], want_loss)
        else:
            assert r["loss"] is None
        want = [("B" if b else "F", mb) for b, mb in z[f"{name}/executed/{r['stage']}"]]
        assert r["executed"] == want
        assert r["max_stash"] == int(z[f"{name}/max_stash"][r["stage"]])
    got = _merged(_stage_heads(world), "grads")
    prefix = f"{name}/grad/"
    names = [k[len(prefix):] for k in z if k.startswith(prefix)]
    assert sorted(n.replace("/", ".") for n in names) == sorted(got)
    for n in names:
        np.testing.assert_allclose(got[n.replace("/", ".")], z[prefix + n],
                                   err_msg=f"{name} grad {n}", **TOL)


def test_two_optimizer_steps_match_jax(pipe):
    z = pipe.ref
    world = pipe.num["steps"]
    rc = RunConfig("pipe", "train", PC.NUM["seq"], PC.NUM["batch"], lr=PC.NUM["lr"],
                   warmup_steps=PC.NUM["warmup"])
    for r in world.values():                     # every rank reports the same values
        np.testing.assert_allclose(r["losses"], z["steps/losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norms"], z["steps/grad_norms"], rtol=1e-4)
        want_lr = [float(adamw.lr_schedule(rc, torch.tensor(i, dtype=torch.int32), 2))
                   for i in range(2)]
        assert r["lrs"] == want_lr
        np.testing.assert_allclose(r["lrs"], z["steps/lrs"], rtol=1e-7)
    got = _merged(_stage_heads(world), "params")
    for n, v in got.items():
        np.testing.assert_allclose(v, z["steps/params/" + n.replace(".", "/")],
                                   err_msg=f"params {n}", **TOL)


def _close_hist(got, want):
    got, want = dict(got), {int(s): x for s, x in want}
    for s, x in want.items():
        assert abs(got[s] - x) <= LOSS_RTOL * abs(x), (s, got[s], x)


@pytest.mark.parametrize("tag", ["B2", "B3"])
def test_rollback_on_the_pipeline_matches_jax(pipe, tag):
    z, r = pipe.ref, pipe.rt[tag]
    assert r["incarnations"] == int(z[f"{tag}/incarnations"]) == 2
    assert r["restored_at"] == z[f"{tag}/restored_at"].tolist() == [6]
    assert r["seen0"] == z[f"{tag}/seen0"].tolist() and 8 not in r["seen0"]
    assert r["blocklist"] == z[f"{tag}/blocklist"].tolist() == list(PC.B_POISON)
    _close_hist(r["history"], z[f"{tag}/history"])
    assert r["resume_bit_equal"] and r["state_bit_equal"]


def test_pipeline_quorum_crash_resume_matches_jax(pipe):
    z, r = pipe.ref, pipe.rt["quorum"]
    assert r["incarnations"] == int(z["quorum/incarnations"]) == 2
    assert r["log"] == z["quorum/log"].tolist() == ["step 4: injected writer 1 death"]
    assert r["seen0"] == z["quorum/seen0"].tolist() == [2]
    assert r["steps"] == z["quorum/steps"].tolist() == [4, 6, 8]
    assert r["writers"] and all(w == int(n.split("/")[1]) for n, w in r["writers"].items())
    _close_hist(r["history"], z["quorum/history"])
    assert r["resume_bit_equal"]


def _files(d):
    out = {}
    for root, _, files in os.walk(d):
        for fn in files:
            p = os.path.join(root, fn)
            out[os.path.relpath(p, d)] = p
    return out


@pytest.mark.parametrize("tag", ["w2", "w3q2"])
def test_pipeline_step_directory_bit_identical_to_jax(pipe, tag):
    a, b = _files(pipe.dir / f"jax_{tag}" / "step_00000003"), _files(
        pipe.dir / f"port_{tag}" / "step_00000003")
    assert sorted(a) == sorted(b) and any(k.startswith("writer_01") for k in a)
    for rel in a:
        assert Path(a[rel]).read_bytes() == Path(b[rel]).read_bytes(), rel


def test_jax_pipeline_checkpoint_resumes_in_the_port(pipe):
    want = pipe.ref["ckpt/losses"][PC.CKPT_STEPS:]
    np.testing.assert_allclose(pipe.ckpt["from_jax"], want, rtol=LOSS_RTOL)


def test_port_pipeline_checkpoint_resumes_in_jax(pipe):
    own = pipe.ckpt["own"]
    np.testing.assert_allclose(own, pipe.ref["ckpt/losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(pipe.ref["resume/losses"], own[PC.CKPT_STEPS:], rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _args(extra):
    return launch_train.parser().parse_args(
        ("--arch paper-tinyllama-1.1b --smoke --device cpu --batch 4 --seq 16 "
         "--microbatches 2 --pods 2 --pod-role pipeline --timeout 300 " + extra).split())


def test_launcher_pipeline_on_cpu(tmp_path):
    """``--pods 2 --pod-role pipeline`` (one-rank stages): every step's loss
    and grad norm equal to the plain pipeline's, the first loss to the
    single-device port's; a run saving at step 2 resumes to step 4 equal to
    the uninterrupted run, its writers one per stage; the pipeline line."""
    lines = []
    r = launch_train.run_grid(_args("--steps 4"), log_fn=lines.append, check_plain=True)
    losses = [x for _, x in r["history"]]
    c = r["checks"]
    np.testing.assert_allclose(c["plain_losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(c["plain_grad_norms"], r["grad_norms"], rtol=1e-5)
    assert abs(c["single_step0_loss"] - losses[0]) <= 1e-5 * abs(losses[0])
    # the lr horizon is the run's length, as in JAX's _train_pipeline
    rc = RunConfig("custom", "train", 16, 4, lr=launch_train.parser().get_default("lr"))
    assert r["lrs"] == [float(adamw.lr_schedule(rc, torch.tensor(i, dtype=torch.int32), 4))
                        for i in range(4)]
    assert r["pipeline"]["stage"] == {0: 0, 1: 1}
    assert r["pipeline"]["max_stash"] == {0: 2, 1: 1}
    assert lines[-1].startswith("pipeline[2 stages x (1x1)] final loss")
    d = str(tmp_path / "ck")
    launch_train.run_grid(_args(f"--steps 2 --ckpt-dir {d} --ckpt-every 2"),
                          log_fn=lambda *a: None)
    resumed = launch_train.run_grid(_args(f"--steps 4 --ckpt-dir {d} --ckpt-every 2"),
                                    log_fn=lines.append)
    assert "restored pipeline checkpoint at step 2" in lines
    assert resumed["history"] == r["history"][2:]
    import json
    with open(os.path.join(d, "step_00000004", "MANIFEST.json")) as f:
        meta = json.load(f)
    assert meta["writers"] == 2
    assert all(v["writer"] == int(k.split("/")[1]) for k, v in meta["manifest"].items())


def test_launcher_refuses_pod_role_data_and_one_pod_pipeline():
    """``--pod-role data`` with two pods is no pipeline: it trains as data
    parallelism over the pods (``tests/test_torch_pod_data.py`` holds it
    against JAX), logging no pipeline line; a one-pod pipeline is refused."""
    lines = []
    run = launch_train.run(_args("--steps 1 --pod-role data"), log_fn=lines.append)
    assert run["world"] == 2 and run["pipeline"]["executed"] == {0: None, 1: None}
    assert not any(line.startswith("pipeline[") for line in lines), lines
    with pytest.raises(ValueError, match="pods > 1"):
        launch_train.run(launch_train.parser().parse_args(
            "--smoke --device cpu --steps 1 --pod-role pipeline".split()))
