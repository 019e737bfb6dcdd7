"""Multi-head latent attention (MLA, minicpm3-4b) in the port against the
JAX package, on the CPU in fp32 at the smoke config (2 layers, d 64, 4
heads, q_lora 32, kv_lora 16, dn 8, dr 4, dv 8).

Parameters come from ``repro.models.lm.init_params`` through
``repro_torch.bridge``, inputs from seeded numpy, so both packages compute
the same function.  One JAX fixture, shared by the module, runs every JAX
side once.

* ``ref.mla_decode_plain`` (the absorbed decode kernel's plain version)
  against JAX's einsums (``repro/models/attention.py:511-522``) at 1e-6
  of the largest output (2e-6 at full-width dims), ragged ``kv_len`` and
  an empty row;
* ``apply_mla`` without a cache against JAX's (1e-5), and the model's
  logits at 1e-4 of their largest: a prefill without a cache, then
  prefill and teacher-forced decode through the dense latent cache
  (``MLACache``), the paged pool (``PagedMLACache``) and the int8 pool
  (``QuantPagedMLACache``); the pools' block tables and lengths after
  every tick and the dense caches' lengths equal JAX's;
* the latent arenas' paged and int8 write and gather against JAX's: the
  int8 payload equal, the scales within 1e-7, the 4-wide rope rows kept
  dense (``MIN_QUANT_DIM``) with their scales at 1.0; the pools' layout
  and block bytes (296 / 576 of bf16's at full width);
* JAX's ``test_decode_parity_dense_paged_teacher[minicpm3-4b]``: the
  port's dense, teacher-forced and paged-engine tokens equal JAX's;
* JAX's ``_QUANT_TRACES["minicpm3-4b"]`` evicting trace: the port's int8
  arena gives the tokens of its fp arena and of JAX's int8 run, and both
  of the port's runs preempt;
* ``train_loss`` and every gradient against
  ``jax.value_and_grad(lm.train_loss)`` (1e-5 of each leaf's largest),
  and two AdamW steps of ``build_train_step`` (the loss within 1e-5, each
  leaf within 1e-5 relative in norm);
* both launchers at smoke size on the CPU, and the grid's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig as JParallel
from repro.config import RunConfig as JRun
from repro.config import get_smoke_config as jax_smoke
from repro.models import attention as JATT
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.parallel.context import PCtx as JPCtx
from repro.serve import cache as JC
from repro.serve import engine as JE
from repro.serve import step as JSRV
from repro.train import step as jstep
from repro_torch.bridge import master_params_from_jax, params_from_jax
from repro_torch.config import ParallelConfig, RunConfig, get_config, get_smoke_config
from repro_torch.core import quant as Q
from repro_torch.kernels import ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import Grid
from repro_torch.models import attention as ATT
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw
from repro_torch.parallel.context import PCtx
from repro_torch.serve import cache as TC
from repro_torch.serve import engine as TE
from repro_torch.serve import step as SRV
from repro_torch.train import step as tstep

ARCH = "minicpm3-4b"
JPCFG = JParallel(strategy="hecaton", data=1, model=1, mx=1, my=1)
F32 = torch.float32
MAXSEQ, GEN = 24, 6                       # tests/test_serve.py
LOGIT_TOL = 1e-4                          # of the largest |logit|
# the paged trace: two prompts on 2 slots, blocks of 4, then teacher-forced ticks
POOL = dict(slots=2, block=4, num_blocks=13, max_seq=MAXSEQ)
PAGED_PROMPTS, TICKS = (7, 5), 6
DENSE_B, DENSE_PROMPT = 2, 9
# tests/test_serve.py::_QUANT_TRACES["minicpm3-4b"]
QTRACE = dict(seeds=(46, 29, 37, 17, 3, 10), gen=11, maxseq=32, num_blocks=10)
TRAIN = dict(B=4, S=16, lr=1e-3, microbatches=2, steps=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# the JAX side, run once
# ---------------------------------------------------------------------------

def _teacher_ticks(vocab):
    return np.random.default_rng(5).integers(0, vocab, size=(TICKS, len(PAGED_PROMPTS)))


def _paged_prompts(vocab):
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PAGED_PROMPTS]


def _pad_block(p, block):
    buf = np.zeros(-(-len(p) // block) * block, np.int32)
    buf[:len(p)] = p
    return buf


def _jax_paged(cfg, params, quant):
    """Prefill the two prompts into a JAX pool, then TICKS teacher-forced
    decode ticks: (prefill logits, tick logits, tables, lengths)."""
    pool = JC.CachePool(cfg, JC.PoolConfig(**POOL), dtype=jnp.float32, quant_kv=quant)
    prefill = jax.jit(JSRV.build_prefill_paged(cfg, JPCFG, None, compute_dtype=jnp.float32))
    decode = jax.jit(JSRV.build_decode_step(cfg, JPCFG, None, None, compute_dtype=jnp.float32))
    out = {"prefill": [], "ticks": [], "tables": [], "lengths": []}
    for p in _paged_prompts(cfg.vocab_size):
        slot = pool.admit(len(p))
        last, tree = prefill(params, pool.prefill_tree(slot),
                             jnp.asarray(_pad_block(p, POOL["block"]))[None], len(p))
        # the trees may alias the pool's host table and lengths: finish
        # before the host moves them on (as the engine's sampling does)
        jax.block_until_ready((last, tree))
        pool.absorb_prefill(slot, tree)
        pool.commit_prefill(slot, len(p))
        out["prefill"].append(np.asarray(last))
    for toks in _teacher_ticks(cfg.vocab_size):
        for s in range(POOL["slots"]):
            assert pool.ensure_append(s)
        pos = jnp.asarray(pool.lengths[:, None].copy())
        logits, tree = decode(params, pool.decode_tree(), jnp.asarray(toks[:, None], jnp.int32),
                              pos)
        jax.block_until_ready((logits, tree))
        pool.absorb_decode(tree)
        for s in range(POOL["slots"]):
            pool.advance(s)
        out["ticks"].append(np.asarray(logits))
        out["tables"].append(pool.table.copy())
        out["lengths"].append(pool.lengths.copy())
    return out


def _jax_dense(cfg, params):
    """A batch of DENSE_B prompts prefilled into the dense latent cache,
    then TICKS teacher-forced decode steps: (logits per step, lengths)."""
    rc = JRun("serve", "decode", MAXSEQ, DENSE_B)
    prefill = jax.jit(JSRV.build_prefill(cfg, JPCFG, rc, None, compute_dtype=jnp.float32))
    decode = jax.jit(JSRV.build_decode_step(cfg, JPCFG, rc, None, compute_dtype=jnp.float32))
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(DENSE_B, DENSE_PROMPT))
    logits, caches = prefill(params, {"tokens": jnp.asarray(prompts, jnp.int32)})
    out, lengths = [np.asarray(logits)], [int(caches["attn"].length[0])]
    for i, toks in enumerate(_teacher_ticks(cfg.vocab_size)):
        pos = jnp.full((DENSE_B, 1), DENSE_PROMPT + i, jnp.int32)
        logits, caches = decode(params, caches, jnp.asarray(toks[:DENSE_B, None], jnp.int32), pos)
        out.append(np.asarray(logits))
        lengths.append(int(caches["attn"].length[0]))
    return prompts, out, lengths


def _dense_greedy_jax(cfg, params, prompt, gen, rc):
    prefill = jax.jit(JSRV.build_prefill(cfg, JPCFG, rc, None, compute_dtype=jnp.float32))
    decode = jax.jit(JSRV.build_decode_step(cfg, JPCFG, rc, None, compute_dtype=jnp.float32))
    logits, caches = prefill(params, {"tokens": jnp.asarray(prompt)[None, :]})
    tok = JSRV.greedy_sample(logits)
    toks = [int(tok[0, 0])]
    for i in range(gen - 1):
        pos = jnp.full((1, 1), len(prompt) + i, jnp.int32)
        logits, caches = decode(params, caches, tok, pos)
        tok = JSRV.greedy_sample(logits)
        toks.append(int(tok[0, 0]))
    return toks


def _quant_prompts(vocab):
    prompts = []
    for qs in QTRACE["seeds"]:
        rng = np.random.default_rng(qs)
        n = int(rng.integers(6, 15))
        prompts.append(rng.integers(0, vocab, size=n).astype(np.int32))
    return prompts


def _train_batch(vocab, step):
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, vocab, size=(TRAIN["B"], TRAIN["S"] + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "loss_mask": (rng.random((TRAIN["B"], TRAIN["S"])) > 0.25).astype(np.float32)}


@pytest.fixture(scope="module")
def jx():
    cfg = jax_smoke(ARCH)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    out = {"cfg": cfg, "params": params, "np": _np(params)}

    # the model without a cache
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    out["nocache_tokens"] = toks
    out["nocache_logits"] = np.asarray(jlm.forward(
        JPCtx(None, JPCFG), cfg, params,
        {"tokens": jnp.asarray(toks), "_dtype": jnp.float32}).logits)
    # apply_mla alone, layer 0
    p0 = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    x = np.random.default_rng(3).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    out["mla_x"], out["mla_pos"] = x, pos
    out["mla_y"] = np.asarray(JATT.apply_mla(JPCtx(None, JPCFG), cfg, p0, jnp.asarray(x),
                                             positions=jnp.asarray(pos))[0])

    out["dense"] = _jax_dense(cfg, params)
    out["paged"] = {q: _jax_paged(cfg, params, q) for q in (False, True)}

    # tests/test_serve.py::test_decode_parity_dense_paged_teacher[minicpm3-4b]
    rc = JRun("serve", "decode", MAXSEQ, 1)
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (7,), 0, cfg.vocab_size),
                        np.int32)
    out["parity_prompt"] = prompt
    out["parity_tokens"] = _dense_greedy_jax(cfg, params, prompt, GEN, rc)

    # tests/test_serve.py::_QUANT_TRACES["minicpm3-4b"], the int8 engine
    rc = JRun("serve", "decode", QTRACE["maxseq"], 1)
    prompts = _quant_prompts(cfg.vocab_size)
    pool = JC.PoolConfig(slots=2, block=4, num_blocks=QTRACE["num_blocks"],
                         max_seq=QTRACE["maxseq"])
    eng = JE.DecodeEngine(cfg, JPCFG, rc, params, pool, compute_dtype=jnp.float32,
                          quant_kv=True)
    eng.warmup(prompt_lens=tuple(len(p) for p in prompts))
    fin = eng.run([JE.Request(rid=i, prompt=p, max_new=QTRACE["gen"])
                   for i, p in enumerate(prompts)])
    out["quant_trace"] = ([fin[i].tokens for i in range(len(prompts))],
                          eng.stats["preemptions"])

    # the training loss and gradients, and two steps
    b0 = _train_batch(cfg.vocab_size, 0)
    jb = {k: jnp.asarray(v) for k, v in b0.items()}
    jb["_dtype"] = jnp.float32
    jpctx = JPCtx(None, JPCFG, "train")
    (loss, _), grads = jax.value_and_grad(
        lambda p: jlm.train_loss(jpctx, cfg, p, jb, remat="fusion"), has_aux=True)(params)
    out["loss"], out["grads"] = float(loss), dict(tlm.flatten(_np(grads)))
    rcj = JRun("t", "train", TRAIN["S"], TRAIN["B"], lr=TRAIN["lr"], warmup_steps=2)
    step = jax.jit(jstep.build_train_step(
        cfg, JParallel(strategy="hecaton", data=1, model=1, mx=1, my=1,
                       microbatches=TRAIN["microbatches"]),
        rcj, None, total_steps=10, compute_dtype=jnp.float32))
    pj, sj, steps = params, jadamw.init(params), []
    for i in range(TRAIN["steps"]):
        b = _train_batch(cfg.vocab_size, i)
        pj, sj, mj = step(pj, sj, {k: jnp.asarray(v) for k, v in b.items()})
        steps.append((float(mj["loss"]), dict(tlm.flatten(_np(pj)))))
    out["steps"] = steps
    return out


@pytest.fixture(scope="module")
def port(jx):
    cfg = get_smoke_config(ARCH)
    return cfg, params_from_jax(jx["np"], device="cpu", dtype=F32)


# ---------------------------------------------------------------------------
# the absorbed decode's plain version
# ---------------------------------------------------------------------------

def _jax_absorbed(q_lat, q_rope, c_kv, k_rope, kv_len, scale):
    """``repro/models/attention.py:514-522``, on [B, nh, L] queries."""
    s = (jnp.einsum("bshl,btl->bhst", q_lat[:, None].astype(jnp.float32),
                    c_kv.astype(jnp.float32))
         + jnp.einsum("bshd,btd->bhst", q_rope[:, None].astype(jnp.float32),
                      k_rope.astype(jnp.float32))) * scale
    mask = jnp.arange(c_kv.shape[1])[None, :] < kv_len[:, None]
    s = jnp.where(mask[:, None, None, :], s, JATT.NEG_INF)
    prob = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhst,btl->bshl", prob, c_kv.astype(jnp.float32))[:, 0]


# tolerance: of the largest |o_lat|.  At full width a score sums 288
# products; XLA's and PyTorch's fp32 GEMMs sum them in other orders (both
# within 1.1e-6 of an fp64 reference here), so 2e-6 there, 1e-6 at smoke dims
@pytest.mark.parametrize("B,nh,T,L,R,kv_len,tol", [
    (4, 40, 70, 256, 32, (1, 33, 70, 64), 2e-6),     # full-width dims, ragged rows
    (2, 4, 24, 16, 4, (0, 13), 1e-6),                 # smoke dims, an empty row
], ids=["full-width", "smoke-empty-row"])
def test_mla_decode_plain_matches_jax(B, nh, T, L, R, kv_len, tol):
    rng = np.random.default_rng(B * T)
    q_lat, q_rope, c_kv, k_rope = (rng.standard_normal(s).astype(np.float32) for s in
                                   ((B, nh, L), (B, nh, R), (B, T, L), (B, T, R)))
    kl = np.asarray(kv_len, np.int32)
    scale = 96 ** -0.5
    want = np.asarray(_jax_absorbed(*(jnp.asarray(a) for a in (q_lat, q_rope, c_kv, k_rope,
                                                                 kl)), scale))
    got = ref.mla_decode_plain(*(torch.from_numpy(a) for a in (q_lat, q_rope, c_kv, k_rope,
                                                               kl)), scale)
    assert got.dtype == torch.float32 and got.shape == (B, nh, L)
    _close(got.numpy(), want, tol)


# ---------------------------------------------------------------------------
# apply_mla and the model over every cache
# ---------------------------------------------------------------------------

def test_apply_mla_without_cache_matches_jax(jx, port):
    cfg, params = port
    p0 = {k: v[0] for k, v in params["blocks"]["attn"].items()}
    y, cache = ATT.apply_mla(PCtx(), cfg, p0, torch.from_numpy(jx["mla_x"]),
                             positions=torch.from_numpy(np.ascontiguousarray(jx["mla_pos"])))
    assert cache is None
    _close(y.numpy(), jx["mla_y"], 1e-5)


def test_prefill_logits_without_cache_match_jax(jx, port):
    cfg, params = port
    out = tlm.forward(PCtx(), cfg, params, {"tokens": torch.from_numpy(jx["nocache_tokens"]),
                                            "_dtype": F32})
    assert out.caches is None
    _close(out.logits.numpy(), jx["nocache_logits"], LOGIT_TOL)


def test_dense_latent_cache_prefill_and_decode_match_jax(jx, port):
    cfg, params = port
    prompts, want, want_len = jx["dense"]
    rc = RunConfig("serve", "decode", MAXSEQ, DENSE_B)
    prefill = SRV.build_prefill(cfg, rc=rc, compute_dtype=F32)
    decode = SRV.build_decode_step(cfg, compute_dtype=F32)
    with torch.inference_mode():
        logits, caches = prefill(params, {"tokens": torch.from_numpy(prompts).long()})
        assert isinstance(caches["attn"], ATT.MLACache)
        got, lengths = [logits.numpy()], [int(caches["attn"].length[0])]
        for i, toks in enumerate(_teacher_ticks(cfg.vocab_size)):
            pos = torch.full((DENSE_B, 1), DENSE_PROMPT + i, dtype=torch.int64)
            logits, caches = decode(params, caches, torch.from_numpy(toks[:DENSE_B, None]).long(),
                                    pos)
            got.append(logits.numpy())
            lengths.append(int(caches["attn"].length[0]))
    assert lengths == want_len
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, LOGIT_TOL, f"step {i}")


def _port_paged(cfg, params, quant):
    pool = TC.CachePool(cfg, TC.PoolConfig(**POOL), device="cpu", dtype=F32, quant_kv=quant)
    prefill = SRV.build_prefill_paged(cfg, compute_dtype=F32)
    decode = SRV.build_decode_step(cfg, compute_dtype=F32)
    out = {"prefill": [], "ticks": [], "tables": [], "lengths": [], "pool": pool}
    with torch.inference_mode():
        for p in _paged_prompts(cfg.vocab_size):
            slot = pool.admit(len(p))
            tree = pool.prefill_tree(slot)
            assert isinstance(tree["attn"], ATT.QuantPagedMLACache if quant
                              else ATT.PagedMLACache)
            last, _ = prefill(params, tree,
                              torch.from_numpy(_pad_block(p, POOL["block"])).long()[None], len(p))
            pool.commit_prefill(slot, len(p))
            out["prefill"].append(last.numpy())
        for toks in _teacher_ticks(cfg.vocab_size):
            for s in range(POOL["slots"]):
                assert pool.ensure_append(s)
            pos = torch.from_numpy(pool.lengths.astype(np.int64)[:, None])
            logits, _ = decode(params, pool.decode_tree(), torch.from_numpy(toks[:, None]).long(),
                               pos)
            for s in range(POOL["slots"]):
                pool.advance(s)
            out["ticks"].append(logits.numpy())
            out["tables"].append(pool.table.copy())
            out["lengths"].append(pool.lengths.copy())
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["paged", "int8"])
def test_paged_latent_cache_prefill_and_decode_match_jax(jx, port, quant):
    """Both prompts' prefill logits and TICKS teacher-forced decode ticks
    over both slots through the pool; the tables and lengths after every
    tick equal JAX's pool's."""
    cfg, params = port
    want, got = jx["paged"][quant], _port_paged(cfg, params, quant)
    for i, (g, w) in enumerate(zip(got["prefill"], want["prefill"])):
        _close(g, w, LOGIT_TOL, f"prefill {i}")
    for i in range(TICKS):
        np.testing.assert_array_equal(got["tables"][i], want["tables"][i])
        np.testing.assert_array_equal(got["lengths"][i], want["lengths"][i])
        _close(got["ticks"][i], want["ticks"][i], LOGIT_TOL, f"tick {i}")


# ---------------------------------------------------------------------------
# the latent arenas' write and gather
# ---------------------------------------------------------------------------

def _arena_case(rng, dim):
    vals = rng.standard_normal((2, 5, dim)).astype(np.float32)
    vals[1, 2] = 0.0                               # an all-zero row: scale 1.0
    table = np.array([[2, 5, 0, 0], [1, 3, 4, 0]], np.int32)
    lengths = np.array([3, 9], np.int32)
    return vals, table, lengths


@pytest.mark.parametrize("dim,quant", [(16, True), (4, True), (16, False), (4, False)],
                         ids=["c_kv-int8", "k_rope-degraded", "c_kv-fp", "k_rope-fp"])
def test_latent_arena_write_and_gather_match_jax(dim, quant):
    """The smoke config's latent rows (kv_lora 16) and rope rows (dr 4):
    every leased block equal to JAX's (int8 payloads exactly, scales and
    dequantized rows within 1e-7); below ``MIN_QUANT_DIM`` the int8
    pool's arena keeps fp32 and its scales stay 1.0."""
    vals, table, lengths = _arena_case(np.random.default_rng(dim), dim)
    tt = torch.from_numpy(table).long()
    if quant:
        jdt = JATT._quant_arena_dtype(dim, jnp.float32)
        ja, js = JATT.quant_paged_write(jnp.zeros((6, 4, dim), jdt),
                                        jnp.ones((6, 4, 1), jnp.float32), jnp.asarray(vals),
                                        jnp.asarray(table), jnp.asarray(lengths))
        jg = JATT.quant_paged_gather(ja, js, jnp.asarray(table), jnp.float32)
        ta = torch.zeros((6, 4, dim), dtype=ATT.quant_arena_dtype(dim, F32))
        ts = torch.ones((6, 4, 1), dtype=F32)
        ATT.quant_paged_write(ta, ts, torch.from_numpy(vals), tt, torch.from_numpy(lengths))
        tg = ATT.quant_paged_gather(ta, ts, tt, F32)
        assert (ta.dtype == torch.int8) == (dim >= Q.MIN_QUANT_DIM) == (ja.dtype == jnp.int8)
        np.testing.assert_allclose(ts.numpy()[1:], np.asarray(js)[1:], rtol=1e-7, atol=0)
        if dim < Q.MIN_QUANT_DIM:
            assert (ts == 1.0).all()
    else:
        ja = JATT.paged_write(jnp.zeros((6, 4, dim), jnp.float32), jnp.asarray(vals),
                              jnp.asarray(table), jnp.asarray(lengths))
        jg = JATT.paged_gather(ja, jnp.asarray(table))
        ta = torch.zeros((6, 4, dim), dtype=F32)
        ATT.paged_write(ta, torch.from_numpy(vals), tt, torch.from_numpy(lengths))
        tg = ATT.paged_gather(ta, tt)
    np.testing.assert_array_equal(ta.numpy()[1:], np.asarray(ja)[1:])
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy()[0, :8], jg[0, :8], rtol=1e-7, atol=0)
    np.testing.assert_allclose(tg.numpy()[1], jg[1], rtol=1e-7, atol=0)


def test_latent_pool_layout_and_block_bytes():
    """The MLA pools hold the latent arenas: smoke int8 keeps the 4-wide
    rope rows fp32, full width quantizes both (kv_lora 256, dr 32); one
    full-width int8 block is (256 + 4 + 32 + 4) / 576 of bf16's per token
    and layer; the smoke pool's block bytes equal JAX's."""
    smoke = get_smoke_config(ARCH)
    pc = dict(slots=2, block=4, num_blocks=9, max_seq=MAXSEQ)
    q = TC.CachePool(smoke, TC.PoolConfig(**pc), device="cpu", dtype=F32, quant_kv=True)
    c, cs, r, rs = q.arenas["attn"]
    assert c.dtype == torch.int8 and r.dtype == torch.float32
    assert cs.shape == c.shape[:-1] + (1,) and rs.shape == r.shape[:-1] + (1,)
    assert isinstance(q.decode_tree()["attn"], ATT.QuantPagedMLACache)
    d = TC.CachePool(smoke, TC.PoolConfig(**pc), device="cpu", dtype=F32)
    assert isinstance(d.decode_tree()["attn"], ATT.PagedMLACache)
    for quant, pool in ((True, q), (False, d)):
        jp = JC.CachePool(jax_smoke(ARCH), JC.PoolConfig(**pc), dtype=jnp.float32,
                          quant_kv=quant)
        assert pool.block_bytes == jp.block_bytes
    full = get_config(ARCH)
    pc1 = TC.PoolConfig(slots=1, block=16, num_blocks=2, max_seq=16)
    fq = TC.CachePool(full, pc1, device="meta", dtype=torch.bfloat16, quant_kv=True)
    fb = TC.CachePool(full, pc1, device="meta", dtype=torch.bfloat16)
    assert all(a.dtype == torch.int8 for a in fq.arenas["attn"][::2])
    per_token_layer = 16 * full.num_layers
    assert fq.block_bytes == 296 * per_token_layer and fb.block_bytes == 576 * per_token_layer
    # the dense latent cache: the same 576 B per token and layer, and a length per layer
    assert TC.dense_cache_bytes(full, 1, 16, torch.bfloat16) == \
        576 * per_token_layer + 4 * full.num_layers


# ---------------------------------------------------------------------------
# JAX's token traces
# ---------------------------------------------------------------------------

def test_decode_parity_dense_paged_teacher_matches_jax(jx, port):
    """tests/test_serve.py::test_decode_parity_dense_paged_teacher for
    minicpm3-4b: the port's dense-cache greedy tokens, the teacher-forced
    argmax of one full forward and the paged engine's tokens all equal
    JAX's dense tokens."""
    cfg, params = port
    prompt, want = jx["parity_prompt"], jx["parity_tokens"]
    rc = RunConfig("serve", "decode", MAXSEQ, 1)
    prefill = SRV.build_prefill(cfg, rc=rc, compute_dtype=F32)
    decode = SRV.build_decode_step(cfg, compute_dtype=F32)
    with torch.inference_mode():
        logits, caches = prefill(params, {"tokens": torch.tensor(prompt).long()[None]})
        tok = SRV.greedy_sample(logits)
        dense = [int(tok[0, 0])]
        for i in range(GEN - 1):
            pos = torch.full((1, 1), len(prompt) + i, dtype=torch.int64)
            logits, caches = decode(params, caches, tok.long(), pos)
            tok = SRV.greedy_sample(logits)
            dense.append(int(tok[0, 0]))
        full = np.concatenate([prompt, np.asarray(dense[:-1])]).astype(np.int64)
        out = tlm.forward(PCtx(), cfg, params, {"tokens": torch.from_numpy(full)[None],
                                                "_dtype": F32})
        teacher = out.logits[0, len(prompt) - 1:].argmax(-1).tolist()
    assert dense == want
    assert teacher[:GEN] == want
    pool = TC.PoolConfig(slots=2, block=4, num_blocks=2 * TC.blocks_for(MAXSEQ, 4) + 1,
                         max_seq=MAXSEQ)
    eng = TE.DecodeEngine(cfg, params, pool, device="cpu", compute_dtype=F32)
    eng.warmup()
    fin = eng.run([TE.Request(rid=0, prompt=prompt, max_new=GEN)])
    assert fin[0].tokens == want


@pytest.fixture(scope="module")
def quant_runs(jx, port):
    cfg, params = port
    prompts = _quant_prompts(cfg.vocab_size)
    pool = TC.PoolConfig(slots=2, block=4, num_blocks=QTRACE["num_blocks"],
                         max_seq=QTRACE["maxseq"])
    out = {}
    for quant in (False, True):
        eng = TE.DecodeEngine(cfg, params, pool, device="cpu", compute_dtype=F32, quant_kv=quant)
        eng.warmup(prompt_lens=tuple(len(p) for p in prompts))
        fin = eng.run([TE.Request(rid=i, prompt=p, max_new=QTRACE["gen"])
                       for i, p in enumerate(prompts)])
        out[quant] = ([fin[i].tokens for i in range(len(prompts))], eng.stats["preemptions"])
    return out


def test_quant_trace_preempts(jx, quant_runs):
    """The pool covers one sequence to completion but not two: both of the
    port's runs preempt at least once, as JAX's int8 run does."""
    assert quant_runs[False][1] >= 1 and quant_runs[True][1] >= 1
    assert jx["quant_trace"][1] >= 1
    assert len(QTRACE["seeds"]) * QTRACE["gen"] >= 64


@pytest.mark.parametrize("i", range(len(QTRACE["seeds"])))
def test_quant_trace_tokens_equal_fp_arena_and_jax(jx, quant_runs, i):
    """Sequence i's greedy tokens through the int8 latent arena equal the
    fp arena's and JAX's int8 run's."""
    assert len(quant_runs[False][0][i]) == QTRACE["gen"]
    assert quant_runs[True][0][i] == quant_runs[False][0][i]
    assert quant_runs[True][0][i] == jx["quant_trace"][0][i]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_loss_and_grads_match_jax(jx):
    cfg = get_smoke_config(ARCH)
    params = master_params_from_jax(jx["np"], device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _train_batch(cfg.vocab_size, 0).items()}
    tb["_dtype"] = F32
    loss, metrics = tlm.train_loss(PCtx(mode="train"), cfg, params, tb, remat="fusion")
    items = tlm.flatten(params)
    grads = torch.autograd.grad(loss, [t for _, t in items])
    assert abs(loss.item() - jx["loss"]) <= 1e-5 * abs(jx["loss"])
    assert float(metrics["aux"]) == 0.0
    assert sorted(p for p, _ in items) == sorted(jx["grads"])
    assert ("blocks", "attn", "kv_norm") in jx["grads"]
    for (path, _), g in zip(items, grads):
        _close(g.numpy(), jx["grads"][path], 1e-5, ".".join(path))


def test_two_train_steps_match_jax(jx):
    cfg = get_smoke_config(ARCH)
    params = master_params_from_jax(jx["np"], device="cpu")
    rc = RunConfig("t", "train", TRAIN["S"], TRAIN["B"], lr=TRAIN["lr"], warmup_steps=2)
    step = tstep.build_train_step(cfg, ParallelConfig(microbatches=TRAIN["microbatches"]), rc,
                                  total_steps=10, compute_dtype=F32)
    opt = adamw.init(params)
    for i, (loss_j, pj) in enumerate(jx["steps"]):
        b = {k: torch.from_numpy(v) for k, v in _train_batch(cfg.vocab_size, i).items()}
        params, opt, m = step(params, opt, b)
        assert abs(float(m["loss"]) - loss_j) <= 1e-5 * abs(loss_j), i
        for path, t in tlm.flatten(params):
            assert _rel(t.detach().numpy(), pj[path]) <= 1e-5, (i, path)


# ---------------------------------------------------------------------------
# the launchers and the grid's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["paged", "int8"])
def test_serve_launcher_runs_mla(quant):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu"] + (["--quant-kv"] if quant else [])
    r = tserve.run(tserve.parser().parse_args(argv))
    assert r["sequences"] == 8 and all(len(f.tokens) == 16 for f in r["finished"].values())
    assert isinstance(r["engine"].pool.decode_tree()["attn"],
                      ATT.QuantPagedMLACache if quant else ATT.PagedMLACache)
    if quant:
        assert r["block_bytes"] < r["dense_block_bytes"]


def test_train_launcher_runs_mla():
    r = ttrain.run(ttrain.parser().parse_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "16", "--microbatches", "2"]), log_fn=lambda *a: None)
    losses = [loss for _, loss in r["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("flags", [["--mx", "2"], ["--data", "2"], ["--pods", "2"],
                                   ["--pods", "2", "--pod-role", "pipeline"]],
                         ids=["mx", "data", "pods", "pipeline"])
def test_train_launcher_refuses_mla_on_the_grid(flags):
    args = ttrain.parser().parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                                       "--steps", "1"] + flags)
    with pytest.raises(NotImplementedError, match="MLA"):
        ttrain.run(args)


def test_grid_refuses_mla():
    cfg = get_smoke_config(ARCH)
    grid = Grid(1, 1, 2)
    with pytest.raises(NotImplementedError, match="MLA"):
        SRV.cache_specs(cfg, ParallelConfig(my=2), grid, 2)
    with pytest.raises(NotImplementedError, match="MLA"):
        tserve.run_grid(tserve.parser().parse_args(["--arch", ARCH, "--smoke", "--device",
                                                    "cpu", "--my", "2"]))
    pctx = PCtx(mode="train", mesh=grid)
    with pytest.raises(NotImplementedError, match="MLA"):
        tlm.forward(pctx, cfg, {}, {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
    with pytest.raises(NotImplementedError, match="MLA"):
        pctx.mixer_in(torch.zeros(1, 4, 8), torch.zeros(8, 8), interior=True)
    z = torch.zeros(1, 2, 256)
    with pytest.raises(NotImplementedError, match="MLA"):
        pctx.mla_decode(z, z[..., :32], z, z[..., :32], torch.ones(1, dtype=torch.int32), 1.0)


def test_mla_decode_op_is_forward_only():
    z = torch.zeros(1, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        PCtx().mla_decode(z, z[..., :4], z, z[..., :4], torch.ones(1, dtype=torch.int32), 1.0)


def test_flash_attention_head_dim_padding_rule():
    """The wrapper's (dk, dv) -> kernel rule: MLA's (96, 64) runs natively
    on the tensor cores and pads to (128, 128) on the SIMT path; (64, 64)
    and (128, 128) run as they are; other multiples of 8 up to 128 run on
    the path's least pair that holds both dims; anything else raises
    (before any CUDA call)."""
    from repro_torch.kernels import flash_attention as kfa
    tc = lambda dk, dv: kfa.kernel_dims(dk, dv, "wgmma")  # noqa: E731
    simt = lambda dk, dv: kfa.kernel_dims(dk, dv, "simt")  # noqa: E731
    assert tc(96, 64) == (96, 64) and simt(96, 64) == (128, 128)
    want = [(64, 64), (64, 64), (128, 128), (128, 128), (128, 128)]
    assert [tc(d, d) for d in (8, 64, 72, 96, 128)] == want
    assert [simt(d, d) for d in (8, 64, 72, 96, 128)] == want
    assert [tc(*d) for d in ((80, 40), (96, 32), (40, 64), (64, 96), (128, 64))] == \
        [(96, 64), (96, 64), (64, 64), (128, 128), (128, 128)]
    assert simt(40, 64) == (64, 64) and simt(80, 40) == (128, 128)
    for bad in ((12, 12), (0, 0), (136, 136), (96, 60), (96, 136), (96, 0)):
        with pytest.raises(ValueError, match="multiple of 8"):
            kfa.kernel_dims(*bad)
    with pytest.raises(ValueError, match="multiple of 8"):
        kfa.forward_impl(torch.bfloat16, 1, 40, 40, 64, 528, 96, 60)
    assert kfa.forward_impl(torch.bfloat16, 1, 40, 40, 64, 528, 96) == "wgmma"
    assert kfa.forward_impl(torch.bfloat16, 1, 40, 40, 64, 528, 96, 64) == "wgmma"
    assert kfa.forward_impl(torch.float32, 1, 40, 40, 64, 528, 96, 64) == "simt"
    assert kfa.backward_impl(torch.bfloat16, 4, 40, 40, 512, 512, 96) == "wgmma"
    assert kfa.backward_impl(torch.bfloat16, 4, 40, 40, 512, 512, 96, 64) == "wgmma"
    assert kfa.mla_splits(4, 544) == 17 and kfa.mla_splits(1, 64) == 2


@pytest.mark.parametrize("grad", [False, True], ids=["prefill", "train"])
def test_apply_mla_hands_attention_v_at_dv(port, monkeypatch, grad):
    """``apply_mla`` passes q and k at dk = dn + dr and v at its own dv
    (a view of the up-projection, not a padded copy) to ``PCtx.attention``
    and gets dv back, with and without a gradient."""
    cfg, params = port
    m, seen = cfg.mla, []
    real = PCtx.attention

    def spy(self, q, k, v, **kw):
        o = real(self, q, k, v, **kw)
        seen.append((q.shape, k.shape, v.shape, o.shape, v._base is not None))
        return o

    monkeypatch.setattr(PCtx, "attention", spy)
    p0 = {k: v[0].clone().requires_grad_(grad) for k, v in params["blocks"]["attn"].items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 5, cfg.d_model))
                         .astype(np.float32))
    with torch.set_grad_enabled(grad):
        y, _ = ATT.apply_mla(PCtx(), cfg, p0, x, positions=torch.arange(5)[None].expand(2, 5))
    (qs, ks, vs, os_, view), = seen
    dk, dv, nh = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim, cfg.num_heads
    assert dk != dv
    assert qs == (2, nh, 5, dk) and ks == (2, nh, 5, dk)
    assert vs == (2, nh, 5, dv) and os_ == (2, nh, 5, dv) and view
    assert y.shape == x.shape and y.requires_grad == grad
