"""The MoE family (granite-moe-3b-a800m, grok-1-314b) in the port against
the JAX package, on the CPU in fp32 at the smoke configs (2 layers, d 64,
granite 8 experts top-2 and swiglu, grok 4 experts top-2 and geglu, cf
1.5).

Parameters come from ``repro.models.lm.init_params`` through
``repro_torch.bridge``, inputs from seeded numpy, so both packages
compute the same function.  One JAX fixture, shared by the module, runs
every JAX side once.

* ``_dispatch_indices`` bit for bit against JAX's (drops, an
  ``e_offset``, T k not a multiple of E), and ``top_k`` against
  ``lax.top_k`` on probabilities with exact ties;
* ``_moe_local`` and ``moe_aux_losses`` against JAX's at cf 1.25 and at a
  cf that drops, with swiglu, geglu and (non-gated) gelu experts, on all
  experts and on a slice of them, at 2e-4 of the largest output;
* the three plain versions (``ref.grouped_gated_plain``,
  ``grouped_mm_plain``, ``moe_combine_plain``) against JAX's einsums and
  scatter-add;
* ``lm.forward``'s logits and ``aux`` for both archs against JAX's;
* the greedy engine traces of both archs, 2 slots, prompts of 5 and 9
  tokens, 6 new each, on the paged fp pool and the int8 arena, against
  ``repro.serve.engine.DecodeEngine``;
* the grouped products' route choice, the serving launcher on the CPU,
  the ops' CPU launches (none), and the refusals of the pipeline and the
  grid, each by name (MoE trains on one device:
  ``tests/test_torch_moe_train.py``).
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
from repro.models import mlp as JMLP
from repro.parallel.context import PCtx as JPCtx
from repro.serve import engine as JE
from repro_torch.bridge import params_from_jax
from repro_torch.config import MoEConfig, ParallelConfig, get_config, get_smoke_config
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import moe as kmoe
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import Grid
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as MLP
from repro_torch.parallel import pipeline as PIPE
from repro_torch.parallel.context import PCtx
from repro_torch.serve import cache as TC
from repro_torch.serve import engine as TE
from repro_torch.serve import step as SRV

ARCHS = ("granite-moe-3b-a800m", "grok-1-314b")
JPCFG = JParallel(strategy="hecaton", data=1, model=1, mx=1, my=1)
F32 = torch.float32
TOL = 2e-4                                # fp32 sums in another order, of the largest output
LOGIT_TOL = 1e-4                          # of the largest |logit|
# the engine trace: two prompts on 2 slots, blocks of 4, 6 new tokens each
PROMPTS, GEN, BLOCK = (5, 9), 6, 4
POOL = dict(slots=2, block=BLOCK, num_blocks=9, max_seq=max(PROMPTS) + GEN)
# _moe_local's cases: (mlp_kind, capacity factor, (n_local, e_offset) or None for all)
LOCAL_CASES = (("swiglu", 1.25, None), ("swiglu", 0.5, None), ("geglu", 1.25, None),
               ("gelu", 0.5, None), ("swiglu", 1.25, (3, 2)))
LOCAL_T = 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPTS]


def _local_cfgs(kind, cf):
    """JAX's and the port's granite smoke config with this expert kind and cf."""
    j = jax_smoke(ARCHS[0])
    j = j.scaled(mlp_kind=kind, moe=JMoE(num_experts=j.moe.num_experts, top_k=j.moe.top_k,
                                         capacity_factor=cf))
    t = get_smoke_config(ARCHS[0])
    t = t.scaled(mlp_kind=kind, moe=MoEConfig(num_experts=t.moe.num_experts,
                                              top_k=t.moe.top_k, capacity_factor=cf))
    return j, t


def _jax_engine(cfg, params, quant):
    rc = JRun("serve", "decode", POOL["max_seq"], 1)
    from repro.serve import cache as JC
    eng = JE.DecodeEngine(cfg, JPCFG, rc, params, JC.PoolConfig(**POOL),
                          compute_dtype=jnp.float32, quant_kv=quant)
    eng.warmup(prompt_lens=PROMPTS)
    fin = eng.run([JE.Request(rid=i, prompt=p, max_new=GEN)
                   for i, p in enumerate(_prompts(cfg.vocab_size))])
    return [fin[i].tokens for i in range(len(PROMPTS))], eng.stats["preemptions"]


# ---------------------------------------------------------------------------
# the JAX side, run once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jx():
    out = {}
    for arch in ARCHS:
        cfg = jax_smoke(arch)
        params = jlm.init_params(cfg, jax.random.PRNGKey(0))
        toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
        res = jlm.forward(JPCtx(None, JPCFG), cfg, params,
                          {"tokens": jnp.asarray(toks), "_dtype": jnp.float32})
        out[arch] = {"np": jax.tree.map(np.asarray, params), "tokens": toks,
                     "logits": np.asarray(res.logits), "aux": float(res.aux),
                     "trace": {q: _jax_engine(cfg, params, q) for q in (False, True)}}
    # _moe_local on layer 0 of granite's smoke parameters, per case
    x = np.random.default_rng(3).standard_normal((LOCAL_T, 64)).astype(np.float32)
    out["local_x"], out["local"] = x, {}
    for kind, cf, part in LOCAL_CASES:
        jcfg, _ = _local_cfgs(kind, cf)
        p = jax.tree.map(lambda a: a[0],
                         jlm.init_params(jcfg, jax.random.PRNGKey(1))["blocks"]["mlp"])
        n_loc, off = part or (jcfg.moe.num_experts, 0)
        y, probs = JMLP._moe_local(p, jnp.asarray(x), cfg=jcfg, n_local_experts=n_loc,
                                   e_offset=off, compute_dtype=jnp.float32)
        out["local"][(kind, cf, part)] = (jax.tree.map(np.asarray, p), np.asarray(y),
                                          np.asarray(probs),
                                          float(JMLP.moe_aux_losses(probs)))
    return out


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,k,E,n_local,e_offset,cap", [
    (7, 2, 4, 4, 0, 2),          # drops: 14 assignments, 8 slots
    (13, 3, 5, 5, 0, 1),         # capacity 1, most dropped
    (9, 2, 8, 3, 2, 4),          # experts [2, 5) of 8 on this rank
    (5, 2, 3, 3, 0, 4),          # T k = 10, not a multiple of E = 3; no drop
    (16, 8, 40, 40, 0, 1),       # granite's decode capacity
], ids=["drops", "cap1", "offset", "ragged", "granite_decode"])
def test_dispatch_indices_match_jax_bit_for_bit(T, k, E, n_local, e_offset, cap):
    rng = np.random.default_rng(T * 100 + k)
    expert_of = rng.integers(0, E, size=T * k).astype(np.int32)
    want = np.asarray(JMLP._dispatch_indices(jnp.asarray(expert_of), n_local, e_offset, cap))
    got = MLP._dispatch_indices(torch.from_numpy(expert_of), n_local, e_offset, cap)
    assert got.dtype == torch.int32 and got.shape == (n_local, cap)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal probabilities: the lower expert index first, as ``lax.top_k``."""
    rng = np.random.default_rng(11)
    rows = [np.full(8, 0.125), [0.1, 0.3, 0.3, 0.05, 0.05, 0.1, 0.0, 0.1],
            [0.2, 0.2, 0.1, 0.2, 0.1, 0.1, 0.05, 0.05]]
    rows += list(rng.integers(0, 3, size=(5, 8)) / 10.0)      # many exact ties
    probs = np.asarray(rows, np.float32)
    for k in (1, 2, 3, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = MLP.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("case", LOCAL_CASES,
                         ids=["swiglu", "swiglu_drops", "geglu", "gelu_drops", "swiglu_slice"])
def test_moe_local_and_aux_match_jax(jx, case):
    kind, cf, part = case
    p_np, want_y, want_probs, want_aux = jx["local"][case]
    _, cfg = _local_cfgs(kind, cf)
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_np.items()}
    n_loc, off = part or (cfg.moe.num_experts, 0)
    y, probs = MLP._moe_local(PCtx(), p, torch.from_numpy(jx["local_x"]), cfg=cfg,
                              n_local_experts=n_loc, e_offset=off)
    assert y.dtype == F32 and y.shape == want_y.shape
    _close(y, want_y, TOL, "y")
    _close(probs, want_probs, TOL, "probs")
    assert abs(MLP.moe_aux_losses(probs).item() - want_aux) <= TOL * abs(want_aux)


def test_capacity_matches_jax_expression():
    """``int(k T cf / E)``, floored at 1: granite's 4-slot decode tick has
    C = 1, its prefills of 64 / 256 / 512 tokens 16 / 64 / 128, grok-1's
    512-token prefill 160."""
    g, x = get_config(ARCHS[0]), get_config(ARCHS[1])
    assert [MLP.capacity(g, t) for t in (4, 64, 256, 512)] == [1, 16, 64, 128]
    assert [MLP.capacity(x, t) for t in (4, 512)] == [1, 160]


# ---------------------------------------------------------------------------
# the plain versions against JAX's einsums and scatter-add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_grouped_plain_versions_match_jax_einsums(act):
    rng = np.random.default_rng(5)
    E, C, H, F = 5, 7, 24, 16
    xd = rng.standard_normal((E, C, H)).astype(np.float32)
    w1, w1b = (rng.standard_normal((E, H, F)).astype(np.float32) * H ** -0.5 for _ in range(2))
    w2 = rng.standard_normal((E, F, H)).astype(np.float32) * F ** -0.5
    jact = {"silu": jax.nn.silu, "gelu": jax.nn.gelu}[act]
    ein = lambda s, a, b: jnp.einsum(s, a, b, preferred_element_type=jnp.float32)  # noqa
    h_want = jact(ein("ech,ehf->ecf", xd, w1)) * ein("ech,ehf->ecf", xd, w1b)
    y_want = ein("ecf,efh->ech", h_want, w2)
    t = torch.from_numpy
    h = ref.grouped_gated_plain(t(xd), t(w1), t(w1b), act=act)
    _close(h, h_want, 1e-6, "gated")
    _close(ref.grouped_mm_plain(h, t(w2)), y_want, 1e-6, "down")
    _close(ref.grouped_mm_plain(t(xd), t(w1), act=act), jact(ein("ech,ehf->ecf", xd, w1)), 1e-6,
           "act")


def test_combine_plain_matches_jax_scatter_add():
    """``moe_combine_plain`` on the slots of a dispatch with drops against
    JAX's gate multiply and scatter-add (``mlp.py:127-132``)."""
    rng = np.random.default_rng(6)
    T, k, E, H, cap = 11, 3, 4, 10, 5
    expert_of = rng.integers(0, E, size=T * k).astype(np.int32)
    gate = rng.random((T, k)).astype(np.float32)
    st = np.asarray(JMLP._dispatch_indices(jnp.asarray(expert_of), E, 0, cap))
    valid = st < T * k
    assert valid.sum() < T * k                  # 20 slots for 33 assignments: drops
    yd = rng.standard_normal((E, cap, H)).astype(np.float32)
    tok = np.minimum(st // k, T - 1)
    gd = gate.reshape(-1)[np.minimum(st, T * k - 1).reshape(-1)] * valid.reshape(-1)
    want = jnp.zeros((T + 1, H)).at[jnp.minimum(tok.reshape(-1), T)].add(
        yd.reshape(-1, H) * gd[:, None], mode="drop")[:T]
    slot_of = np.full(T * k, -1, np.int32)
    slot_of[st.reshape(-1)[valid.reshape(-1)]] = np.arange(E * cap)[valid.reshape(-1)]
    got = ref.moe_combine_plain(torch.from_numpy(yd), torch.from_numpy(gate),
                                torch.from_numpy(slot_of.reshape(T, k)))
    _close(got, want, 1e-6, "combine")


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(jx, arch):
    cfg = get_smoke_config(arch)
    params = params_from_jax(jx[arch]["np"], device="cpu", dtype=F32)
    out = tlm.forward(PCtx(), cfg, params, {"tokens": torch.from_numpy(jx[arch]["tokens"]),
                                            "_dtype": F32})
    _close(out.logits, jx[arch]["logits"], LOGIT_TOL, "logits")
    assert abs(out.aux.item() - jx[arch]["aux"]) <= TOL * abs(jx[arch]["aux"])


def test_bridge_keeps_the_router_fp32():
    """The MoE leaves cross the bridge unchanged; serving keeps the router
    fp32 (``lm.FP32_LEAVES``) and casts the experts to the compute dtype."""
    cfg = jax_smoke(ARCHS[0])
    tree = jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(0)))
    p = params_from_jax(tree, device="cpu", dtype=torch.bfloat16)["blocks"]["mlp"]
    assert sorted(p) == ["router", "we1", "we1b", "we2"]
    assert p["router"].dtype == F32 and p["we1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["router"].numpy(), tree["blocks"]["mlp"]["router"])
    assert tuple(p["we1"].shape) == tree["blocks"]["mlp"]["we1"].shape


@pytest.mark.parametrize("quant", [False, True], ids=["paged", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_trace_matches_jax(jx, arch, quant):
    """The greedy engine (warm-up, admission, every slot decoded each tick,
    idle ones included) gives JAX's tokens on both pools."""
    cfg = get_smoke_config(arch)
    params = params_from_jax(jx[arch]["np"], device="cpu", dtype=F32)
    eng = TE.DecodeEngine(cfg, params, TC.PoolConfig(**POOL), device="cpu", compute_dtype=F32,
                          quant_kv=quant)
    assert not eng.exact_prefill                # prompts padded to the block, as JAX's
    eng.warmup(prompt_lens=PROMPTS)
    fin = eng.run([TE.Request(rid=i, prompt=p, max_new=GEN)
                   for i, p in enumerate(_prompts(cfg.vocab_size))])
    want, want_pre = jx[arch]["trace"][quant]
    assert [fin[i].tokens for i in range(len(PROMPTS))] == want
    assert eng.stats["preemptions"] == want_pre == 0


# ---------------------------------------------------------------------------
# routes, launchers, refusals
# ---------------------------------------------------------------------------

def test_grouped_route_choice_and_gemv_plan():
    """gemv for bf16 at C <= 16 (granite's decode tick and 64-token
    prefill), wgmma above, simt for fp32; the decode's experts fill the
    SMs without a K split."""
    bf = torch.bfloat16
    assert [kmoe.grouped_impl(bf, c) for c in (1, 16, 17, 37, 64, 128, 160)] == \
        ["gemv", "gemv", "wgmma", "wgmma", "wgmma", "wgmma", "wgmma"]
    assert kmoe.grouped_impl(F32, 1) == kmoe.grouped_impl(F32, 128) == "simt"
    # granite: up-projection [40, C, 1536] x [40, 1536, 512], down [40, C, 512] x [40, 512, 1536]
    plan = lambda E, C, N, K, gated: kmm.gemv_plan(C, N, K, gated, experts=E)  # noqa: E731
    assert plan(40, 1, 512, 1536, True) == plan(40, 1, 1536, 512, False) == 1
    assert plan(40, 16, 512, 1536, True) == 1
    # grok-1's decode: 8 experts of [6144 -> 32768] and [32768 -> 6144]
    assert plan(8, 1, 32768, 6144, True) == plan(8, 1, 6144, 32768, False) == 1
    # one expert is the plain product's plan
    assert plan(1, 4, 3072, 1024, True) == kmm.gemv_plan(4, 3072, 1024, True)


def test_moe_ops_are_forward_only_and_count_no_cpu_launches():
    """The MoE ops differentiate on the CPU (their plain backwards; the
    training slice, ``tests/test_torch_moe_train.py``, holds the numbers)
    and, with a gradient or without, count no launch there."""
    z = torch.zeros(2, 3, 8, requires_grad=True)
    w = torch.zeros(2, 8, 8, requires_grad=True)
    slot_of = torch.zeros(4, 2, dtype=torch.int32)
    slot_tok = torch.zeros(2, 3, dtype=torch.int32)
    gate = torch.ones(4, 2, requires_grad=True)
    ops.reset_launches()
    outs = (ops.moe_grouped_gated(z, w, w, act="silu"), ops.moe_grouped_mm(z, w),
            ops.moe_combine(z, gate, slot_of, slot_tok),
            ops.moe_dispatch(torch.zeros(4, 8, requires_grad=True), torch.zeros(
                2, 3, dtype=torch.long), torch.ones(2, 3, dtype=torch.bool), slot_of))
    for out in outs:
        assert out.requires_grad
        out.sum().backward()
    assert z.grad is not None and w.grad is not None and gate.grad is not None
    with torch.no_grad():
        ops.moe_grouped_gated(z, w, w, act="silu")
        ops.moe_combine(z, torch.ones(4, 2), slot_of)
    assert all(ops.LAUNCHES[k] == 0 for k in ops.LAUNCHES if k.startswith("moe_"))
    assert all(c == 0 for counts in kmoe.IMPL_LAUNCHES.values() for c in counts.values())


@pytest.mark.parametrize("arch,quant", [(ARCHS[0], False), (ARCHS[0], True), (ARCHS[1], False)],
                         ids=["granite", "granite_int8", "grok"])
def test_serve_launcher_runs_moe(arch, quant):
    argv = ["--arch", arch, "--smoke", "--device", "cpu"] + (["--quant-kv"] if quant else [])
    r = tserve.run(tserve.parser().parse_args(argv))
    assert r["sequences"] == 8 and all(len(f.tokens) == 16 for f in r["finished"].values())


def test_training_refuses_moe_on_grid_and_pipeline_by_name():
    """MoE trains on one device (``tests/test_torch_moe_train.py``); the
    rank grid (EP x TP) and the 1F1B pipeline refuse it by name."""
    cfg = get_smoke_config(ARCHS[0])
    with pytest.raises(NotImplementedError, match=r"MoE .* on the rank grid \(EP x TP\)"):
        ttrain.run(ttrain.parser().parse_args(["--arch", ARCHS[0], "--smoke", "--device",
                                               "cpu", "--steps", "1", "--my", "2"]))
    with pytest.raises(NotImplementedError, match="MoE .* in the 1F1B pipeline"):
        ttrain.run(ttrain.parser().parse_args(["--arch", ARCHS[0], "--smoke", "--device",
                                               "cpu", "--steps", "1", "--pods", "2",
                                               "--pod-role", "pipeline"]))
    with pytest.raises(NotImplementedError, match="MoE .* in the 1F1B pipeline"):
        PIPE.validate_pipeline(cfg, ParallelConfig(pods=2, pod_axis_role="pipeline"))


def test_grid_refuses_moe_by_name():
    cfg = get_smoke_config(ARCHS[0])
    grid = Grid(1, 1, 2)
    with pytest.raises(NotImplementedError, match="MoE"):
        SRV.cache_specs(cfg, ParallelConfig(my=2), grid, 2)
    with pytest.raises(NotImplementedError, match="MoE"):
        tserve.run_grid(tserve.parser().parse_args(["--arch", ARCHS[0], "--smoke", "--device",
                                                    "cpu", "--my", "2"]))
    pctx = PCtx(mode="train", mesh=grid)
    with pytest.raises(NotImplementedError, match="MoE"):
        tlm.forward(pctx, cfg, {}, {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
    with pytest.raises(NotImplementedError, match="MoE"):
        MLP.apply_moe(pctx, cfg, {}, torch.zeros(1, 4, cfg.d_model))
