"""MoE training (granite-moe-3b-a800m, grok-1-314b) in the port against the
JAX package, on the CPU in fp32 at the smoke configs (2 layers, d 64,
granite 8 experts top-2 and swiglu, grok 4 experts top-2 and geglu, cf
1.5), plus granite with a non-gated gelu expert and granite at a cf that
drops assignments.

Parameters come from ``repro.models.lm.init_params`` through
``repro_torch.bridge.master_params_from_jax``, batches from seeded numpy,
so both packages compute the same function.  One JAX fixture, shared by
the module, runs every JAX side once.

* The loss (``loss + aux_loss * aux``), ``aux`` and every gradient leaf
  against ``jax.value_and_grad(repro.models.lm.train_loss)``: the loss
  within 1e-5 relative, each leaf within 1e-4 of its largest |value|
  (fp32 sums in another order than XLA's), as ``test_torch_train.py``
  holds the dense family.
* The aux term's gradient alone (it reaches the routers through the
  softmax) under each remat policy against JAX's; the whole loss's
  gradients equal under ``none``, ``fusion`` and ``full``.
* Three steps of ``build_train_step`` (two microbatches, fp32 gradient
  reduction) against JAX's step, at ``test_torch_train.py``'s fp32
  tolerances.
* The MoE ops' backwards on the CPU (``kernels/ops.py``: the plain
  backwards the card's kernels are held to) against autograd through the
  plain forwards, over a dispatch with drops and empty slots; the
  training route choice.
* A checkpoint round trip of a MoE training state, and the launcher
  training ``--smoke`` on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as JMoE
from repro.config import ParallelConfig as JParallel
from repro.config import RunConfig as JRun
from repro.config import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.parallel.context import PCtx as JPCtx
from repro.train import step as jstep
from repro_torch.bridge import master_params_from_jax
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import MoEConfig, ParallelConfig, RunConfig, get_smoke_config
from repro_torch.kernels import moe as kmoe
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as MLP
from repro_torch.optim import adamw
from repro_torch.parallel.context import PCtx
from repro_torch.train import step as tstep

GRANITE, GROK = "granite-moe-3b-a800m", "grok-1-314b"
# (arch, mlp_kind or None for the arch's own, capacity factor or None for the arch's own)
CASES = {"granite": (GRANITE, None, None), "grok": (GROK, None, None),
         "granite_gelu": (GRANITE, "gelu", None), "granite_drops": (GRANITE, None, 0.5)}
B, S = 4, 16
LR = 1e-2
STEPS = 3
REMATS = ("none", "fusion", "full")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jpcfg(**kw):
    return JParallel(strategy="hecaton", data=1, model=1, mx=1, my=1, **kw)


def _cfgs(arch, kind, cf):
    """JAX's and the port's smoke config of ``arch``, with the expert kind
    and capacity factor replaced where given."""
    j, t = jax_smoke(arch), get_smoke_config(arch)
    if kind is not None:
        j, t = j.scaled(mlp_kind=kind), t.scaled(mlp_kind=kind)
    if cf is not None:
        j = j.scaled(moe=JMoE(num_experts=j.moe.num_experts, top_k=j.moe.top_k,
                              capacity_factor=cf))
        t = t.scaled(moe=MoEConfig(num_experts=t.moe.num_experts, top_k=t.moe.top_k,
                                   capacity_factor=cf))
    return j, t


def _batch(vocab, step=0):
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "loss_mask": (rng.random((B, S)) > 0.25).astype(np.float32)}


def _leaves(tree):
    return dict(tlm.flatten(jax.tree.map(np.asarray, tree)))


def _port_params(params_np):
    return master_params_from_jax(params_np, device="cpu")


def _tb(batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["_dtype"] = torch.float32
    return tb


def _close_leaf(got, want, rel, what):
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale, err_msg=what)


# ---------------------------------------------------------------------------
# the JAX side, run once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jx():
    out = {}
    for name, (arch, kind, cf) in CASES.items():
        cfg, _ = _cfgs(arch, kind, cf)
        params = jlm.init_params(cfg, jax.random.PRNGKey(0))
        batch = _batch(cfg.vocab_size)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb["_dtype"] = jnp.float32
        pctx = JPCtx(None, _jpcfg(), "train")

        def total(p):
            return jlm.train_loss(pctx, cfg, p, jb, remat="fusion")

        def aux(p):
            return jlm.train_loss(pctx, cfg, p, jb, remat="fusion")[1]["aux"]

        (loss, metrics), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
        entry = {"params": jax.tree.map(np.asarray, params), "batch": batch,
                 "loss": float(loss), "ce": float(metrics["loss"]),
                 "aux": float(metrics["aux"]), "grads": _leaves(grads)}
        if name == "granite":
            entry["aux_grads"] = _leaves(jax.jit(jax.grad(aux))(params))
        out[name] = entry

    # three steps of the JAX train step on granite, two microbatches
    cfg, _ = _cfgs(GRANITE, None, None)
    rc = JRun("t", "train", S, B, lr=LR, warmup_steps=2)
    step_fn = jax.jit(jstep.build_train_step(
        cfg, _jpcfg(microbatches=2, grad_reduce_dtype="fp32"), rc, None,
        total_steps=STEPS, compute_dtype=jnp.float32))
    p = jlm.init_params(cfg, jax.random.PRNGKey(1))
    out["traj_params0"] = jax.tree.map(np.asarray, p)
    s, traj = jadamw.init(p), []
    for i in range(STEPS):
        p, s, m = step_fn(p, s, {k: jnp.asarray(v)
                                 for k, v in _batch(cfg.vocab_size, step=i).items()})
        traj.append((_leaves(p), _leaves(s.mu), _leaves(s.nu), float(m["loss"]),
                     float(m["aux"])))
    out["traj"] = traj
    return out


# ---------------------------------------------------------------------------
# loss, aux and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_loss_aux_and_grads_match_jax(jx, case):
    arch, kind, cf = CASES[case]
    _, cfg = _cfgs(arch, kind, cf)
    want = jx[case]
    params = _port_params(want["params"])
    loss, metrics = tlm.train_loss(PCtx(mode="train", pcfg=ParallelConfig()), cfg, params,
                                   _tb(want["batch"]), remat="fusion")
    items = tlm.flatten(params)
    grads = torch.autograd.grad(loss, [t for _, t in items])
    assert abs(loss.item() - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert abs(float(metrics["loss"].detach()) - want["ce"]) <= 1e-5 * abs(want["ce"])
    assert abs(float(metrics["aux"].detach()) - want["aux"]) <= 1e-5 * abs(want["aux"])
    assert want["aux"] > 0
    assert sorted(p for p, _ in items) == sorted(want["grads"])
    for (path, _), g in zip(items, grads):
        _close_leaf(g.numpy(), want["grads"][path], 1e-4, f"{case} grad {'.'.join(path)}")
    # every expert leaf, and the router, receives a gradient
    for path, g in zip((p for p, _ in items), grads):
        if path[-1] in ("router", "we1", "we1b", "we2"):
            assert float(g.abs().max()) > 0, path


def test_drops_case_drops_assignments():
    """cf 0.5 leaves fewer slots than assignments, so the drops case
    exercises the dropped assignments' zero gate gradients."""
    _, cfg = _cfgs(GRANITE, None, 0.5)
    T = B * S
    assert MLP.capacity(cfg, T) * cfg.moe.num_experts < T * cfg.moe.top_k


@pytest.mark.parametrize("remat", REMATS)
def test_aux_gradient_reaches_the_router_under_each_remat(jx, remat):
    """The aux loss leaves each checkpointed layer as an output, so its
    gradient is JAX's under every policy: it reaches every layer's router
    through the softmax (and, through the later layers' router inputs,
    what lies below them)."""
    _, cfg = _cfgs(GRANITE, None, None)
    want = jx["granite"]
    params = _port_params(want["params"])
    items = tlm.flatten(params)
    _, metrics = tlm.train_loss(PCtx(mode="train"), cfg, params, _tb(want["batch"]),
                                remat=remat)
    grads = torch.autograd.grad(metrics["aux"], [t for _, t in items], allow_unused=True)
    for (path, _), g in zip(items, grads):
        got = np.zeros_like(want["aux_grads"][path]) if g is None else g.numpy()
        _close_leaf(got, want["aux_grads"][path], 1e-4, f"{remat} aux grad {'.'.join(path)}")
        if path[-1] == "router":
            assert float(np.abs(got).max()) > 0


def test_remat_policies_give_equal_numbers(jx):
    _, cfg = _cfgs(GRANITE, None, None)
    want = jx["granite"]
    params = _port_params(want["params"])
    leaves = [t for _, t in tlm.flatten(params)]
    out = {}
    for remat in REMATS:
        loss, _ = tlm.train_loss(PCtx(mode="train"), cfg, params, _tb(want["batch"]),
                                 remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    for remat in ("fusion", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1]))


def test_trajectory_matches_jax_step(jx):
    _, cfg = _cfgs(GRANITE, None, None)
    rc = RunConfig("t", "train", S, B, lr=LR, warmup_steps=2)
    step = tstep.build_train_step(cfg, ParallelConfig(microbatches=2, grad_reduce_dtype="fp32"),
                                  rc, total_steps=STEPS, compute_dtype=torch.float32)
    p = _port_params(jx["traj_params0"])
    s = adamw.init(p)
    for i, (pj, mj, vj, loss_j, aux_j) in enumerate(jx["traj"]):
        p, s, m = step(p, s, {k: torch.from_numpy(v)
                              for k, v in _batch(cfg.vocab_size, step=i).items()})
        np.testing.assert_allclose(float(m["loss"]), loss_j, rtol=1e-5)
        np.testing.assert_allclose(float(m["aux"]), aux_j, rtol=1e-5)
        for path, t in tlm.flatten(p):
            np.testing.assert_allclose(t.detach().numpy(), pj[path], rtol=0, atol=0.05 * LR,
                                       err_msg=f"step {i} param {path}")
        for name, tree, want in (("mu", s.mu, mj), ("nu", s.nu, vj)):
            for path, t in tlm.flatten(tree):
                _close_leaf(t.numpy(), want[path], 2e-4, f"step {i} {name} {path}")


# ---------------------------------------------------------------------------
# the ops' backwards (the CPU route: the plain backwards)
# ---------------------------------------------------------------------------

def _dispatch(rng, T, k, E, cap):
    """A real dispatch of T tokens' random top-k choices, with drops and
    empty slots: (tok_of_slot, slot_valid, slot_of [T, k], slot_token)."""
    probs = torch.from_numpy(rng.random((T, E)).astype(np.float32))
    idx = MLP.top_k(probs, k)[1]
    st = MLP._dispatch_indices(idx.reshape(-1), E, 0, cap)
    slot_of = MLP.slot_of_assignments(st, T * k).reshape(T, k)
    return torch.clamp(st // k, max=T - 1).long(), st < T * k, slot_of, st


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _grads_of(fn, inputs, g):
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_grouped_gated_backward_matches_autograd(act):
    rng = np.random.default_rng(1)
    E, C, H, F_ = 3, 5, 16, 8
    xd, w1, w1b = _rand(rng, E, C, H), _rand(rng, E, H, F_), _rand(rng, E, H, F_)
    xd[0, 3:] = 0                                       # an expert's empty slots
    g = _rand(rng, E, C, F_)
    got = _grads_of(lambda a, b, c: ops.moe_grouped_gated(a, b, c, act=act), (xd, w1, w1b), g)
    want = _grads_of(lambda a, b, c: ref.grouped_gated_plain(a, b, c, act=act),
                     (xd, w1, w1b), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["none", "gelu"])
def test_grouped_mm_backward_matches_autograd(act):
    """With a gradient the product is the custom op and the activation
    follows it in PyTorch."""
    rng = np.random.default_rng(2)
    h, w = _rand(rng, 3, 5, 8), _rand(rng, 3, 8, 16)
    g = _rand(rng, 3, 5, 16)
    got = _grads_of(lambda a, b: ops.moe_grouped_mm(a, b, act=act), (h, w), g)
    want = _grads_of(lambda a, b: ref.grouped_mm_plain(a, b, act=act), (h, w), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_grouped_transposed_plains_match_bmm():
    rng = np.random.default_rng(3)
    g, w, x = _rand(rng, 3, 5, 16), _rand(rng, 3, 8, 16), _rand(rng, 3, 5, 8)
    torch.testing.assert_close(ref.grouped_nt_plain(g, w), torch.bmm(g, w.transpose(1, 2)))
    torch.testing.assert_close(ref.grouped_tn_plain(x, g), torch.bmm(x.transpose(1, 2), g))


def test_combine_and_dispatch_backwards_match_autograd():
    """Over a dispatch with drops (cap 2 for 10 x 3 assignments on 4
    experts) and empty slots: the combine's (dyd, dgate), an empty slot's
    row and a dropped assignment's gate gradient zero; the dispatch's dx
    (the combine with unit gates)."""
    rng = np.random.default_rng(4)
    T, k, E, cap, H = 10, 3, 4, 2, 6
    tok, valid, slot_of, st = _dispatch(rng, T, k, E, cap)
    assert (slot_of < 0).any()
    yd, gate, dy = _rand(rng, E, cap, H), torch.rand(T, k), _rand(rng, T, H)
    got = _grads_of(lambda a, b: ops.moe_combine(a, b, slot_of, st), (yd, gate), dy)
    want = _grads_of(lambda a, b: ref.moe_combine_plain(a, b, slot_of), (yd, gate), dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    dyd, dgate = ref.moe_combine_bwd_plain(dy, yd, gate, slot_of)
    assert torch.equal(dyd, got[0]) and torch.equal(dgate[slot_of < 0], torch.zeros(
        int((slot_of < 0).sum())))
    assert not dyd.reshape(-1, H)[(st >= T * k).reshape(-1)].any()

    x, dxd = _rand(rng, T, H), _rand(rng, E, cap, H)
    (got_x,) = _grads_of(lambda a: ops.moe_dispatch(a, tok, valid, slot_of), (x,), dxd)
    (want_x,) = _grads_of(lambda a: ref.moe_dispatch_plain(a, tok, valid), (x,), dxd)
    torch.testing.assert_close(got_x, want_x, rtol=1e-6, atol=1e-6)
    assert torch.equal(got_x, ref.moe_dispatch_bwd_plain(dxd, slot_of))


def test_combine_gradient_needs_the_slots():
    yd = torch.zeros(2, 2, 4, requires_grad=True)
    with pytest.raises(ValueError, match="slot_tok"):
        ops.moe_combine(yd, torch.ones(4, 1), torch.zeros(4, 1, dtype=torch.int32))


def test_training_routes_every_bf16_product_to_wgmma():
    """With a gradient every bf16 grouped product takes wgmma, at any C:
    the gemv route has no kept products and no NT or TN layout."""
    bf = torch.bfloat16
    assert [kmoe.grouped_impl(bf, c, grad=True) for c in (1, 16, 37, 512)] == ["wgmma"] * 4
    assert kmoe.grouped_impl(bf, 16) == "gemv"
    assert kmoe.grouped_impl(torch.float32, 512, grad=True) == "simt"


# ---------------------------------------------------------------------------
# checkpoint and launcher
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_of_a_moe_training_state(jx, tmp_path):
    """One step, then a save and a restore into a fresh state: the 4-D
    expert leaves, the fp32 router and both moments come back bit-equal."""
    _, cfg = _cfgs(GRANITE, None, None)
    rc = RunConfig("t", "train", S, B, lr=LR, warmup_steps=2)
    step = tstep.build_train_step(cfg, ParallelConfig(), rc, total_steps=STEPS,
                                  compute_dtype=torch.float32)
    p = _port_params(jx["traj_params0"])
    s = adamw.init(p)
    p, s, _ = step(p, s, {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size).items()})
    state = {"params": p, "opt_state": s}
    CheckpointManager(str(tmp_path)).save(1, state)
    fresh = _port_params(jx["traj_params0"])
    restored, at = CheckpointManager(str(tmp_path)).restore(
        {"params": fresh, "opt_state": adamw.init(fresh)})
    assert at == 1
    we1 = dict(tlm.flatten(restored["params"]))[("blocks", "mlp", "we1")]
    router = dict(tlm.flatten(restored["params"]))[("blocks", "mlp", "router")]
    assert we1.dim() == 4 and router.dtype == torch.float32
    for a, b in ((restored["params"], p), (restored["opt_state"].mu, s.mu),
                 (restored["opt_state"].nu, s.nu)):
        for (pa, ta), (pb, tb) in zip(tlm.flatten(a), tlm.flatten(b)):
            assert pa == pb and torch.equal(ta.detach(), tb.detach()), pa
    assert int(restored["opt_state"].step) == int(s.step) == 1


@pytest.mark.parametrize("arch", [GRANITE, GROK])
def test_launcher_trains_moe_on_the_cpu(arch):
    r = ttrain.run(ttrain.parser().parse_args(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "16", "--microbatches", "2"]))
    losses = [loss for _, loss in r["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
