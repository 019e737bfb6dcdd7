"""The port's single-device training slice against the JAX package, on the
CPU in fp32.

Parameters come from ``repro.models.lm.init_params`` through
``repro_torch.bridge.master_params_from_jax``, so both packages compute
the same function; batches come from each package's ``SyntheticLM``.

* The loss and every parameter's gradient against
  ``jax.value_and_grad(lm.train_loss)`` under ``PCtx(None, pcfg,
  "train")``, with the fused loss on and off, on the tied qwen3-0.6b smoke
  config (``embed.table`` gets the embedding's and the head's gradient)
  and the untied paper-llama2-7b one.  Tolerance: 1e-5 on the loss and
  1e-4 of each leaf's largest gradient (fp32 through two layers and the
  head, sums in another order than XLA's; measured ~2e-6).
* Five steps of ``build_train_step`` with two microbatches against the
  JAX step: params and both moments after every step.  AdamW divides by
  sqrt(v) + 1e-8, so an element whose gradient is within fp32 noise of
  zero moves by a different fraction of lr.  With fp32 gradient
  reduction params are held to 0.05 lr absolute (measured 0.008 lr) and
  the moments to 2e-4 of the leaf's largest (measured 3.4e-5).  With bf16
  reduction a gradient element within fp32 noise of a bf16 rounding
  boundary also rounds the other way (2^-8 relative): params 0.1 lr
  (measured 0.018 lr), moments 2^-6 of the leaf's largest (measured
  3e-3).
* Remat policies give equal loss and gradients; the guard skips a NaN
  batch bit-cleanly as the JAX step does; the data, dropout and the
  launcher.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import GuardConfig as JGuard
from repro.config import ParallelConfig as JParallel
from repro.config import RunConfig as JRun
from repro.config import get_smoke_config as jax_smoke
from repro.data.synthetic import SyntheticLM as JSynthetic
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.parallel.context import PCtx as JPCtx
from repro.train import step as jstep
from repro_torch.bridge import master_params_from_jax
from repro_torch.config import GuardConfig, ParallelConfig, RunConfig, get_smoke_config
from repro_torch.data.synthetic import Prefetcher, SyntheticLM
from repro_torch.models import layers as L
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw
from repro_torch.parallel.context import PCtx
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-0.6b", "paper-llama2-7b"]
B, S = 4, 16
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jpcfg(**kw):
    return JParallel(strategy="hecaton", data=1, model=1, mx=1, my=1, **kw)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg_j = jax_smoke(request.param)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, params_j, get_smoke_config(request.param)


def _port_params(params_j):
    return master_params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")


def _batch(vocab, step=0, mask=True):
    b = SyntheticLM(vocab, S, B, seed=3).batch_at(step)
    if mask:
        b["loss_mask"] = (np.random.default_rng(step).random((B, S)) > 0.25).astype(np.float32)
    return b


def _leaves(tree):
    return dict(tlm.flatten(jax.tree.map(np.asarray, tree)))


def _assert_tree_close(port, jax_leaves, rel, what):
    for path, t in tlm.flatten(port):
        want = jax_leaves[path]
        got = t.detach().numpy()
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                                   err_msg=f"{what} {'.'.join(path)}")


@pytest.mark.parametrize("fused", [True, False])
def test_loss_and_grads_match_jax(models, fused):
    cfg_j, params_j, cfg_t = models
    batch = _batch(cfg_j.vocab_size)
    jpctx = JPCtx(None, _jpcfg(fused_loss=fused), "train")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["_dtype"] = jnp.float32
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: jlm.train_loss(jpctx, cfg_j, p, jb, remat="fusion"), has_aux=True)(params_j)

    params = _port_params(params_j)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["_dtype"] = torch.float32
    pctx = PCtx(mode="train", pcfg=ParallelConfig(fused_loss=fused))
    loss, metrics = tlm.train_loss(pctx, cfg_t, params, tb, remat="fusion")
    items = tlm.flatten(params)
    grads = torch.autograd.grad(loss, [t for _, t in items])
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    assert float(metrics["aux"]) == 0.0
    gj = _leaves(grads_j)
    paths = [p for p, _ in items]
    assert sorted(paths) == sorted(gj)
    if cfg_t.tie_embeddings:
        assert ("lm_head", "w") not in gj and ("embed", "table") in gj
    _assert_tree_close(tlm.unflatten(paths, grads), gj, 1e-4, "grad")


@pytest.fixture(scope="module")
def qwen():
    cfg_j = jax_smoke("qwen3-0.6b")
    return cfg_j, jlm.init_params(cfg_j, jax.random.PRNGKey(1)), get_smoke_config("qwen3-0.6b")


def test_remat_policies_give_equal_numbers(qwen):
    """none, fusion (the kernels' matmul outputs saved, the rest recomputed)
    and full (only block boundaries saved) give the same loss and
    gradients: remat changes memory, never numbers."""
    cfg_j, params_j, cfg_t = qwen
    params = _port_params(params_j)
    leaves = [t for _, t in tlm.flatten(params)]
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg_j.vocab_size).items()}
    tb["_dtype"] = torch.float32
    out = {}
    for remat in ("none", "fusion", "full"):
        loss, _ = tlm.train_loss(PCtx(mode="train"), cfg_t, params, tb, remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    for remat in ("fusion", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1]))


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def trajectories(request, qwen):
    """5 steps of the JAX step and the port's, microbatches 2; params and
    moments after each step."""
    cfg_j, params_j, cfg_t = qwen
    gdt = request.param
    rc_j = JRun("t", "train", S, B, lr=LR, warmup_steps=2)
    rc_t = RunConfig("t", "train", S, B, lr=LR, warmup_steps=2)
    jstep_fn = jax.jit(jstep.build_train_step(
        cfg_j, _jpcfg(microbatches=2, grad_reduce_dtype=gdt), rc_j, None,
        total_steps=5, compute_dtype=jnp.float32))
    tstep_fn = tstep.build_train_step(
        cfg_t, ParallelConfig(microbatches=2, grad_reduce_dtype=gdt), rc_t,
        total_steps=5, compute_dtype=torch.float32)
    pj, sj = params_j, jadamw.init(params_j)
    pt = _port_params(params_j)
    st = adamw.init(pt)
    out = []
    for i in range(5):
        batch = _batch(cfg_j.vocab_size, step=i)
        pj, sj, mj = jstep_fn(pj, sj, {k: jnp.asarray(v) for k, v in batch.items()})
        pt, st, mt = tstep_fn(pt, st, {k: torch.from_numpy(v) for k, v in batch.items()})
        out.append((_leaves(pj), _leaves(sj.mu), _leaves(sj.nu), jax.device_get(mj),
                    {k: v.detach().clone() for k, v in tlm.flatten(pt)},
                    {k: v.clone() for k, v in tlm.flatten(st.mu)},
                    {k: v.clone() for k, v in tlm.flatten(st.nu)}, mt, int(st.step)))
    return gdt, out


def test_trajectory_matches_jax_step(trajectories):
    gdt, out = trajectories
    for i, (pj, mj, vj, met_j, pt, mt, vt, met_t, step) in enumerate(out):
        assert step == i + 1
        np.testing.assert_allclose(float(met_t["loss"]), float(met_j["loss"]),
                                   rtol=1e-5 if gdt == "fp32" else 1e-4)
        np.testing.assert_allclose(float(met_t["lr"]), float(met_j["lr"]), rtol=1e-6)
        p_tol, m_tol = (0.05 * LR, 2e-4) if gdt == "fp32" else (0.1 * LR, 2 ** -6)
        for path in pj:
            np.testing.assert_allclose(pt[path].numpy(), pj[path], rtol=0, atol=p_tol,
                                       err_msg=f"step {i} param {path}")
            for name, got, want in (("mu", mt[path], mj[path]), ("nu", vt[path], vj[path])):
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=m_tol * (float(np.abs(want).max()) or 1.0),
                                           err_msg=f"step {i} {name} {path}")


def test_guard_skips_a_nan_batch_bit_cleanly(qwen):
    """A batch whose loss mask holds a NaN makes every gradient NaN: the
    guarded step leaves params and optimizer state bit-unchanged and does
    not advance the step, as the JAX step's lax.cond does."""
    cfg_j, params_j, cfg_t = qwen
    rc_j = JRun("t", "train", S, B, lr=LR, warmup_steps=2)
    rc_t = RunConfig("t", "train", S, B, lr=LR, warmup_steps=2)
    good, bad = _batch(cfg_j.vocab_size, 0), _batch(cfg_j.vocab_size, 1)
    bad["loss_mask"][1, 3] = np.nan
    jfn = jax.jit(jstep.build_train_step(cfg_j, _jpcfg(microbatches=2), rc_j, None,
                                         compute_dtype=jnp.float32, guard=JGuard()))
    tfn = tstep.build_train_step(cfg_t, ParallelConfig(microbatches=2), rc_t,
                                 compute_dtype=torch.float32, guard=GuardConfig())
    pj, sj, _ = jfn(params_j, jadamw.init(params_j), {k: jnp.asarray(v) for k, v in
                                                      good.items()})
    pt = _port_params(params_j)
    pt, st, m0 = tfn(pt, adamw.init(pt), {k: torch.from_numpy(v) for k, v in good.items()})
    assert float(m0["update_skipped"]) == 0.0 and int(st.step) == 1
    before = [t.detach().clone() for _, t in tlm.flatten(pt)] + \
        [t.clone() for _, t in tlm.flatten(st.mu)] + [t.clone() for _, t in tlm.flatten(st.nu)]
    ewma = st.gnorm_ewma.clone()
    _, _, mj = jfn(pj, sj, {k: jnp.asarray(v) for k, v in bad.items()})
    pt, st2, m = tfn(pt, st, {k: torch.from_numpy(v) for k, v in bad.items()})
    assert float(mj["update_skipped"]) == 1.0 and float(m["update_skipped"]) == 1.0
    assert float(m["nonfinite"]) == 1.0 and float(mj["nonfinite"]) == 1.0
    after = [t.detach() for _, t in tlm.flatten(pt)] + \
        [t for _, t in tlm.flatten(st2.mu)] + [t for _, t in tlm.flatten(st2.nu)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(st2.step) == 1 and torch.equal(st2.gnorm_ewma, ewma)


def test_synthetic_batches_bit_identical():
    for step in (0, 1, 17):
        a = SyntheticLM(1000, 24, 6, seed=5).batch_at(step)
        b = JSynthetic(1000, 24, 6, seed=5).batch_at(step)
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
    pf = Prefetcher(iter(SyntheticLM(1000, 24, 6, seed=5)), device="cpu")
    try:
        first = next(pf)
    finally:
        pf.close()
    assert np.array_equal(first["tokens"].numpy(),
                          JSynthetic(1000, 24, 6, seed=5).batch_at(0)["tokens"])


def test_dropout():
    """Rate 0 or no generator is the identity (the parity case); otherwise
    inverted dropout: kept values scaled by 1/keep, about rate zeroed."""
    x = torch.randn(64, 256)
    assert L.dropout(x, 0.0, torch.Generator().manual_seed(0)) is x
    assert L.dropout(x, 0.5, None) is x
    y = L.dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    assert 0.7 < kept.float().mean().item() < 0.8
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert PCtx().dropout(x, 0.5, torch.Generator()) is x          # serving: identity
    cfg = get_smoke_config("qwen3-0.6b").scaled(embed_dropout=0.5)
    params = tlm.init_master_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((2, 8), dtype=torch.int64)
    outs = [tlm.forward(PCtx(mode="train"), cfg, params,
                        {"tokens": toks, "_dtype": torch.float32,
                         "dropout_rng": torch.Generator().manual_seed(s)},
                        skip_head=True).hidden for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


def test_launcher_runs_end_to_end():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                        "--device", "cpu", "--steps", "3"], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("final loss") and "nan" not in last
