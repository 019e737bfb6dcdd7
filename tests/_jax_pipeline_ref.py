"""JAX references for the port's pipeline tests, on fake CPU meshes.

Run as a script in its own process (the device count is fixed when JAX
starts):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_jax_pipeline_ref.py INPUTS.npz OUT.npz PART [DIR]

INPUTS.npz (written by ``tests/test_torch_pipeline.py``) holds the
initial parameters of ``tests/_mp/check_pipeline.py``'s config
(``init/<path>``) and of ``tests/_mp/check_guard.py``'s (``rt_init/...``)
and the numerics batch (``batch/tokens``, ``batch/labels``).  PART is:

* ``num:K/N`` — the cases K, K + N, ... of :data:`CASES`: per case
  ``repro.parallel.pipeline.PipelineRunner``'s loss, merged gradients,
  each stage's executed order and stash peak at the initial parameters;
  the ``steps`` case also two optimizer steps (``total_steps`` 2, the
  launcher's horizon): the losses, grad norms, learning rates and merged
  parameters;
* ``rt`` — ``tests/_mp/check_guard.py``'s scenarios B2 (skip-cap
  rollback) and B3 (loss-spike rollback) and ``check_checkpoint.py
  --pipeline-quorum``'s crash-resume on the 2x(1x1x2) pipeline, with
  DIR as scratch: each run's history, incarnations, restored steps,
  blocklist and (quorum) the steps listed and the injector's log;
* ``ckpt`` — two steps of the 2x(1x1x2) pipeline from ``rt_init``, a
  checkpoint of the pipeline state at step 2 into DIR (two writers,
  ``stage_writer_map``), two more steps: the four losses;
* ``resume`` — the port's checkpoint in DIR restored at step 2 and two
  steps resumed from it: the two losses.

Only the numbers cross: the test holds the port's.
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _pipeline_cases import (B_POISON, B_TOTAL, CASES, CKPT_STEPS, NUM, Q_TOTAL, RT,  # noqa: E402
                             RT_STAGE)


def num_cfg():
    from repro.config import ModelConfig
    return ModelConfig(name="pipe-test", family="dense", num_layers=NUM["layers"],
                       d_model=NUM["d"], num_heads=NUM["heads"], num_kv_heads=NUM["kv"],
                       d_ff=NUM["ff"], vocab_size=NUM["vocab"], qk_norm=True)


def rt_cfg():
    from repro.config import ModelConfig
    return ModelConfig(name="guard-test", family="dense", num_layers=RT["layers"],
                       d_model=RT["d"], num_heads=RT["heads"], num_kv_heads=RT["kv"],
                       d_ff=RT["ff"], vocab_size=RT["vocab"], mlp_kind="swiglu")


def _tree(z, prefix):
    out = {}
    for k in z.files:
        if not k.startswith(prefix):
            continue
        d = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(z[k])
    return out


def _flat(tree, prefix):
    return {prefix + "/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pcfg(pods, stage, strategy, overlap, residual, micro):
    from repro.config import ParallelConfig
    d, mx, my = stage
    return ParallelConfig(strategy=strategy, data=d, model=mx * my, mx=mx, my=my, pods=pods,
                          pod_axis_role="pipeline", overlap=overlap, residual=residual,
                          microbatches=micro, grad_reduce_dtype="fp32", remat="none",
                          zero1=False)


def _mesh(pods, stage, strategy):
    from repro.launch import mesh as M
    return M.make_small_mesh(strategy, stage[0], stage[1], stage[2], pods=pods)


def run_case(case, z):
    from repro.config import RunConfig
    from repro.parallel import pipeline as PP
    name, pods, stage, strategy, overlap, residual, micro = case
    cfg = num_cfg()
    rc = RunConfig("pipe", "train", NUM["seq"], NUM["batch"], lr=NUM["lr"],
                   warmup_steps=NUM["warmup"])
    pcfg = _pcfg(pods, stage, strategy, overlap, residual, micro)
    params = _tree(z, "init/")
    batch = {"tokens": jnp.asarray(z["batch/tokens"]), "labels": jnp.asarray(z["batch/labels"])}
    total = 2 if name == "steps" else 10_000
    runner, step = PP.build_pipeline_train_step(cfg, pcfg, rc, _mesh(pods, stage, strategy),
                                                total_steps=total, compute_dtype=jnp.float32)
    sparams = runner.place_params(params)
    loss, sgrads, _ = runner.loss_and_grads(sparams, batch)
    out = {f"{name}/loss": np.float32(loss)}
    out.update(_flat(PP.merge_stage_grads(sgrads, cfg), f"{name}/grad/"))
    for s in range(pods):
        out[f"{name}/executed/{s}"] = np.asarray([(t.kind == "B", t.mb)
                                                  for t in runner.executed[s]], np.int32)
    out[f"{name}/max_stash"] = np.asarray(runner.max_stash, np.int32)
    if name == "steps":
        sopt = runner.init_opt(sparams)
        losses, gnorms, lrs = [], [], []
        for _ in range(2):
            sparams, sopt, m = step(sparams, sopt, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            lrs.append(float(m["lr"]))
        out[f"{name}/losses"] = np.asarray(losses, np.float32)
        out[f"{name}/grad_norms"] = np.asarray(gnorms, np.float32)
        out[f"{name}/lrs"] = np.asarray(lrs, np.float32)
        out.update(_flat(PP.merge_stage_grads(sparams, cfg), f"{name}/params/"))
    return out


# ---------------------------------------------------------------------------
# runtime and checkpoint scenarios on the 2x(1x1x2) pipeline
# ---------------------------------------------------------------------------

def _rt_setup(z, guard=None):
    from repro.config import RunConfig
    from repro.parallel import pipeline as PP
    cfg = rt_cfg()
    rc = RunConfig("t", "train", RT["seq"], RT["batch"], lr=RT["lr"])
    pcfg = _pcfg(2, RT_STAGE, "hecaton", "none", "seq", RT["micro"])
    runner, pstep = PP.build_pipeline_train_step(cfg, pcfg, rc, _mesh(2, RT_STAGE, "hecaton"),
                                                 compute_dtype=jnp.float32, guard=guard)
    p0 = _tree(z, "rt_init/")

    def fresh():
        sp = runner.place_params(p0)
        return {"params": sp, "opt_state": runner.init_opt(sp)}
    return runner, pstep, fresh


def _rt_batch(i, nan=False):
    from repro.data.synthetic import SyntheticLM
    b = {k: jnp.asarray(v) for k, v in
         SyntheticLM(RT["vocab"], RT["seq"], RT["batch"], seed=RT["seed"]).batch_at(i).items()}
    b["loss_mask"] = jnp.full((RT["batch"], RT["seq"]), jnp.nan if nan else 1.0, jnp.float32)
    return b


def _hist(h):
    return np.asarray([(s, loss) for s, loss in h], np.float64)


def rollback(z, root, tag, gkw, in_graph):
    """check_guard.py's _pipeline_rollback: data B_POISON poisoned, a
    supervised run with a stage-pinned 2-writer checkpoint every 2 steps."""
    from repro.checkpoint.manager import CheckpointManager
    from repro.config import GuardConfig
    from repro.parallel import pipeline as PP
    from repro.runtime import guard as G
    from repro.runtime.fault import run_supervised
    from repro.train import loop as train_loop
    gc = GuardConfig(**gkw)
    _, pstep, fresh = _rt_setup(z, gc if in_graph else None)
    d = os.path.join(root, tag)
    mgr = CheckpointManager(d, keep=5, writers=2, writer_map=PP.stage_writer_map(2))
    restored_at, seen = [], []

    def make_state(_):
        state, start = fresh(), 0
        if mgr.latest_step() is not None:
            seen.append(list(mgr.all_steps()))
            state, start = mgr.restore(state)
            restored_at.append(start)
        return state, start

    def run_steps(state, start, inc):
        bl = G.load_blocklist(d)
        stream = G.blocklisted_stream(lambda i: _rt_batch(i, nan=i in B_POISON), start, bl)
        return train_loop.train(pstep, state, stream, start_step=start, num_steps=B_TOTAL,
                                ckpt=mgr, ckpt_every=2, log_every=1000,
                                guard=G.TrainingGuard(gc),
                                data_index_fn=lambda s: G.data_index(s, bl),
                                log_fn=lambda *a: None)

    state, n = run_supervised(make_state, run_steps, ckpt=mgr, sleep_fn=lambda _: None)
    return {f"{tag}/history": _hist(state["history"]), f"{tag}/incarnations": np.int32(n),
            f"{tag}/restored_at": np.asarray(restored_at, np.int32),
            f"{tag}/seen0": np.asarray(seen[0], np.int32),
            f"{tag}/blocklist": np.asarray(G.load_blocklist(d), np.int32)}


def quorum(z, root):
    """check_checkpoint.py --pipeline-quorum: writer 1 of step 4's save dies."""
    from repro.checkpoint.manager import CheckpointManager
    from repro.parallel import pipeline as PP
    from repro.runtime.fault import FailureInjector, run_supervised
    from repro.train import loop as train_loop
    _, pstep, fresh = _rt_setup(z)
    d = os.path.join(root, "quorum")
    mgr = CheckpointManager(d, writers=2, writer_map=PP.stage_writer_map(2))
    inj = FailureInjector(writer_fail_at={4: 1})
    seen = []

    def make_state(_):
        state, start = fresh(), 0
        if mgr.latest_step() is not None:
            seen.append(list(mgr.all_steps()))
            state, start = mgr.restore(state)
        return state, start

    def run_steps(state, start, inc):
        it = (_rt_batch(s) for s in range(start, Q_TOTAL))
        return train_loop.train(pstep, state, it, start_step=start, num_steps=Q_TOTAL,
                                ckpt=mgr, ckpt_every=2, log_every=1000, injector=inj,
                                log_fn=lambda *a: None)

    state, n = run_supervised(make_state, run_steps, ckpt=mgr, sleep_fn=lambda _: None)
    return {"quorum/history": _hist(state["history"]), "quorum/incarnations": np.int32(n),
            "quorum/seen0": np.asarray(seen[0], np.int32),
            "quorum/steps": np.asarray(mgr.all_steps(), np.int32),
            "quorum/log": np.asarray(inj.log)}


def ckpt(z, d):
    from repro.checkpoint.manager import CheckpointManager
    from repro.parallel import pipeline as PP
    _, pstep, fresh = _rt_setup(z)
    st = fresh()
    p, o = st["params"], st["opt_state"]
    losses = []
    for i in range(2 * CKPT_STEPS):
        if i == CKPT_STEPS:
            CheckpointManager(d, writers=2, writer_map=PP.stage_writer_map(2)).save(
                i, {"params": p, "opt_state": o})
        p, o, m = pstep(p, o, _rt_batch(i))
        losses.append(float(m["loss"]))
    return {"ckpt/losses": np.asarray(losses, np.float64)}


def resume(z, d):
    from repro.checkpoint.manager import CheckpointManager
    from repro.parallel import pipeline as PP
    _, pstep, fresh = _rt_setup(z)
    st, start = CheckpointManager(d, writers=2, writer_map=PP.stage_writer_map(2)).restore(
        fresh(), step=CKPT_STEPS)
    p, o = st["params"], st["opt_state"]
    losses = []
    for i in range(start, 2 * CKPT_STEPS):
        p, o, m = pstep(p, o, _rt_batch(i))
        losses.append(float(m["loss"]))
    return {"resume/losses": np.asarray(losses, np.float64)}


def main():
    z = np.load(sys.argv[1])
    out_path, part = sys.argv[2], sys.argv[3]
    d = sys.argv[4] if len(sys.argv) > 4 else None
    out = {}
    if part.startswith("num"):
        k, n = (int(x) for x in part.split(":")[1].split("/"))
        for case in CASES[k::n]:
            out.update(run_case(case, z))
    elif part == "rt":
        out.update(rollback(z, d, "B2", dict(grad_spike_factor=1e9, skip_cap=2, patience=99),
                            True))
        out.update(rollback(z, d, "B3", dict(loss_spike_factor=2.0, patience=2, skip_cap=999),
                            False))
        out.update(quorum(z, d))
    elif part == "ckpt":
        out.update(ckpt(z, d))
    elif part == "resume":
        out.update(resume(z, d))
    else:
        raise SystemExit(f"unknown part {part!r}")
    np.savez(out_path, **out)


if __name__ == "__main__":
    main()
