"""The port's serving slice against the JAX package, on the CPU in fp32.

Parameters come from ``repro.models.lm.init_params`` through
``repro_torch.bridge.params_from_jax``, so both packages compute the same
function.  Logits are held at 1e-4 (fp32 through two layers and the head,
sums in another order than XLA's); greedy tokens and the pool's block
accounting must be identical.  One JAX engine run per arch is shared by the
module (a fixture)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig, RunConfig, get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.parallel.context import PCtx as JPCtx
from repro.serve import cache as JC
from repro.serve import engine as JE
from repro.serve import step as JS
from repro_torch.bridge import params_from_jax, to_tensor
from repro_torch.config import get_smoke_config
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.parallel.context import PCtx
from repro_torch.serve import cache as TC
from repro_torch.serve import engine as TE
from repro_torch.serve import step as TS

ARCHS = ["qwen3-0.6b", "paper-llama2-7b"]
PCFG = ParallelConfig(strategy="hecaton", data=1, model=1, mx=1, my=1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MAXSEQ, GEN = 24, 8
# 8 leasable blocks of 4 tokens: both 2-slot sequences admit but cannot
# both finish, so the youngest is preempted and replayed
POOL = dict(slots=2, block=4, num_blocks=9, max_seq=MAXSEQ)
PLENS = (14, 11, 5, 9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg_j = jax_smoke(request.param)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu",
                               dtype=torch.float32)
    return cfg_j, params_j, get_smoke_config(request.param), params_t


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PLENS]


def _drive(eng, reqs):
    """Run an engine tick by tick; record the pool's state after each."""
    for r in sorted(reqs, key=lambda r: (r.arrival, r.rid)):
        eng.submit(r)
    ticks = []
    while eng.queue or eng.running:
        eng.step()
        p = eng.pool
        ticks.append((p.table.copy(), p.lengths.copy(), p.peak_blocks_in_use,
                      sorted(p.free)))
    return eng.finished, ticks


@pytest.fixture(scope="module")
def jax_run(models):
    cfg_j, params_j, _, _ = models
    rc = RunConfig("serve", "decode", MAXSEQ, 1)
    eng = JE.DecodeEngine(cfg_j, PCFG, rc, params_j, JC.PoolConfig(**POOL),
                          compute_dtype=jnp.float32)
    eng.warmup(prompt_lens=PLENS)
    reqs = [JE.Request(i, p, GEN, arrival=i // 2)
            for i, p in enumerate(_prompts(cfg_j.vocab_size))]
    fin, ticks = _drive(eng, reqs)
    return fin, ticks, eng.stats["preemptions"]


@pytest.fixture(scope="module")
def torch_run(models):
    _, _, cfg_t, params_t = models
    eng = TE.DecodeEngine(cfg_t, params_t, TC.PoolConfig(**POOL), device="cpu",
                          compute_dtype=torch.float32)
    eng.warmup(prompt_lens=PLENS)
    reqs = [TE.Request(i, p, GEN, arrival=i // 2)
            for i, p in enumerate(_prompts(cfg_t.vocab_size))]
    fin, ticks = _drive(eng, reqs)
    return fin, ticks, eng.stats["preemptions"]


# ---------------------------------------------------------------------------
# logits: paged prefill and one decode step
# ---------------------------------------------------------------------------

def test_paged_prefill_and_decode_logits_match_jax(models):
    cfg_j, params_j, cfg_t, params_t = models
    pc = dict(slots=3, block=4, num_blocks=16, max_seq=MAXSEQ)
    jpool = JC.CachePool(cfg_j, JC.PoolConfig(**pc), dtype=jnp.float32)
    tpool = TC.CachePool(cfg_t, TC.PoolConfig(**pc), device="cpu", dtype=torch.float32)
    jpre = jax.jit(JS.build_prefill_paged(cfg_j, PCFG, None, compute_dtype=jnp.float32))
    tpre = TS.build_prefill_paged(cfg_t, compute_dtype=torch.float32)
    prompts = _prompts(cfg_j.vocab_size)[:2]
    for p in prompts:                            # two live slots, third idle
        js, ts = jpool.admit(len(p)), tpool.admit(len(p))
        assert js == ts
        pad = -(-len(p) // 4) * 4
        buf = np.zeros(pad, np.int32)
        buf[:len(p)] = p
        jl, jtree = jpre(params_j, jpool.prefill_tree(js), jnp.asarray(buf)[None],
                         jnp.int32(len(p)))
        jpool.absorb_prefill(js, jtree)
        tl, _ = tpre(params_t, tpool.prefill_tree(ts),
                     torch.from_numpy(buf.astype(np.int64))[None], len(p))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        jpool.commit_prefill(js, len(p))
        tpool.commit_prefill(ts, len(p))
    for pool in (jpool, tpool):
        for s in range(2):
            assert pool.ensure_append(s)
    tokens = np.array([[3], [5], [0]], np.int32)
    positions = jpool.lengths.astype(np.int32)[:, None]
    jdec = jax.jit(JS.build_decode_step(cfg_j, PCFG, None, None,
                                        compute_dtype=jnp.float32))
    jlog, _ = jdec(params_j, jpool.decode_tree(), jnp.asarray(tokens),
                   jnp.asarray(positions))
    tdec = TS.build_decode_step(cfg_t, compute_dtype=torch.float32)
    tlog, tree = tdec(params_t, tpool.decode_tree(), torch.from_numpy(tokens).long(),
                      torch.from_numpy(positions).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    assert tree["attn"].lengths.tolist() == (tpool.lengths + 1).tolist()


def test_forward_without_cache_matches_jax(models):
    cfg_j, params_j, cfg_t, params_t = models
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab_size, size=(2, 9))
    jout = jlm.forward(JPCtx(None, PCFG), cfg_j, params_j,
                       {"tokens": jnp.asarray(toks, jnp.int32), "_dtype": jnp.float32})
    tout = tlm.forward(PCtx(), cfg_t, params_t,
                       {"tokens": torch.from_numpy(toks), "_dtype": torch.float32})
    assert tout.caches is None
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# engine: over-subscribed trace with eviction
# ---------------------------------------------------------------------------

def test_engine_greedy_tokens_match_jax(jax_run, torch_run):
    jfin, _, jpre = jax_run
    tfin, _, tpre = torch_run
    assert jpre >= 1 and tpre == jpre             # the trace really evicts
    assert sorted(tfin) == sorted(jfin)
    for rid in jfin:
        assert tfin[rid].tokens == jfin[rid].tokens, rid
        assert (tfin[rid].reason, tfin[rid].preemptions) == \
            (jfin[rid].reason, jfin[rid].preemptions)


def test_engine_pool_accounting_matches_jax(jax_run, torch_run):
    """Block table, lengths, peak and free list after every tick."""
    _, jticks, _ = jax_run
    _, tticks, _ = torch_run
    assert len(tticks) == len(jticks)
    for i, (j, t) in enumerate(zip(jticks, tticks)):
        np.testing.assert_array_equal(t[0], j[0], err_msg=f"table, tick {i}")
        np.testing.assert_array_equal(t[1], j[1], err_msg=f"lengths, tick {i}")
        assert t[2:] == j[2:], i


@pytest.mark.parametrize("ops", [
    [("admit", 9), ("admit", 17), ("free", 0), ("admit", 4)],
    [("admit", 4), ("commit", 0, 4), ("append", 0), ("advance", 0), ("append", 0),
     ("admit", 24), ("commit", 1, 20), ("advance", 0), ("advance", 0),
     ("advance", 0), ("append", 0), ("free", 1), ("append", 0)],
])
def test_pool_ops_match_jax(models, ops):
    cfg_j, _, cfg_t, _ = models
    jp = JC.CachePool(cfg_j, JC.PoolConfig(2, 4, 9, MAXSEQ), dtype=jnp.float32)
    tp = TC.CachePool(cfg_t, TC.PoolConfig(2, 4, 9, MAXSEQ), device="cpu")
    for op, *a in ops:
        fn = {"admit": "admit", "commit": "commit_prefill", "append": "ensure_append",
              "advance": "advance", "free": "free_slot"}[op]
        assert getattr(tp, fn)(*a) == getattr(jp, fn)(*a), (op, a)
        np.testing.assert_array_equal(tp.table, jp.table)
        np.testing.assert_array_equal(tp.lengths, jp.lengths)
        assert (tp.blocks_in_use, tp.peak_blocks_in_use) == \
            (jp.blocks_in_use, jp.peak_blocks_in_use)


def test_dense_cache_bytes_and_block_bytes_match_jax(models):
    cfg_j, _, cfg_t, _ = models
    assert TC.dense_cache_bytes(cfg_t, 4, 48, torch.float32) == \
        JC.dense_cache_bytes(cfg_j, 4, 48, jnp.float32)
    jp = JC.CachePool(cfg_j, JC.PoolConfig(2, 4, 9, MAXSEQ), dtype=jnp.float32)
    tp = TC.CachePool(cfg_t, TC.PoolConfig(2, 4, 9, MAXSEQ), device="cpu")
    assert tp.block_bytes == jp.block_bytes


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_top_p_replay_is_deterministic_under_eviction(models):
    """Draws are seeded from (seed, rid, step): a preempted, replayed
    sequence samples exactly what an uninterrupted run samples."""
    _, _, cfg_t, params_t = models
    prompts = _prompts(cfg_t.vocab_size)[:2]
    runs = {}
    for name, nb in (("evicting", 9), ("roomy", 13)):
        eng = TE.DecodeEngine(cfg_t, params_t, TC.PoolConfig(2, 4, nb, MAXSEQ),
                              device="cpu", compute_dtype=torch.float32,
                              method="top_p", top_p=0.9, temperature=1.5, seed=3)
        fin = eng.run([TE.Request(i, p, GEN) for i, p in enumerate(prompts)])
        runs[name] = ([fin[i].tokens for i in range(2)], eng.stats["preemptions"])
    assert runs["evicting"][1] >= 1 and runs["roomy"][1] == 0
    assert runs["evicting"][0] == runs["roomy"][0]
    greedy = TE.DecodeEngine(cfg_t, params_t, TC.PoolConfig(2, 4, 13, MAXSEQ),
                             device="cpu", compute_dtype=torch.float32)
    gfin = greedy.run([TE.Request(i, p, GEN) for i, p in enumerate(prompts)])
    assert [gfin[i].tokens for i in range(2)] != runs["roomy"][0]   # really sampled


def test_engine_eos_early_exit(models):
    """EOS ends a sequence at the step that first samples it.  The EOS is a
    token that first appears at a known step k >= 1 of a greedy run, so
    the run with it must stop there with ``reason == "eos"`` and the
    tokens up to and including it; the unchanged run ends on its budget.
    (The JAX test takes its third token as EOS whether or not it appeared
    earlier.)"""
    _, _, cfg_t, params_t = models
    prompt = _prompts(cfg_t.vocab_size)[0]
    pool = TC.PoolConfig(2, 4, 13, MAXSEQ)

    def run(eos):
        eng = TE.DecodeEngine(cfg_t, params_t, pool, device="cpu",
                              compute_dtype=torch.float32, eos_id=eos)
        return eng.run([TE.Request(0, prompt, GEN)])[0]
    base = run(None)
    assert base.reason == "max_new" and len(base.tokens) == GEN
    k = next(i for i in range(1, GEN) if base.tokens[i] not in base.tokens[:i])
    fin = run(base.tokens[k])
    assert fin.reason == "eos"
    assert fin.tokens == base.tokens[:k + 1]
    missing = next(t for t in range(cfg_t.vocab_size) if t not in base.tokens)
    assert run(missing).tokens == base.tokens


def test_sampling_entry_point():
    lg = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 64)).astype(np.float32))
    assert torch.equal(TS.sample(lg), torch.argmax(lg, -1).int())
    for m in ("temperature", "top_p"):
        a = TS.sample(lg, method=m, generator=torch.Generator().manual_seed(0),
                      temperature=0.7, top_p=0.8)
        b = TS.sample(lg, method=m, generator=torch.Generator().manual_seed(0),
                      temperature=0.7, top_p=0.8)
        assert a.shape == (3,) and a.dtype == torch.int32 and torch.equal(a, b)
        assert ((a >= 0) & (a < 64)).all()
    t = TS.sample(lg, method="top_p", generator=torch.Generator().manual_seed(1),
                  top_p=1e-6)
    assert torch.equal(t, TS.sample(lg))          # a tiny nucleus is the argmax
    one = torch.zeros((1, 16))
    one[0, 3] = 10.0
    for s in range(8):
        g = torch.Generator().manual_seed(s)
        assert int(TS.sample(one, method="top_p", generator=g, top_p=0.5)[0]) == 3
    with pytest.raises(ValueError):
        TS.sample(lg, method="temperature")
    with pytest.raises(ValueError):
        TS.sample(lg, method="beam", generator=torch.Generator())


def test_bridge_carries_bf16_bit_exact(models):
    """bf16 leaves cross through a uint16 view: every bit survives, and the
    port's serving dtype conversion keeps norm scales in fp32."""
    cfg_j, params_j, _, _ = models
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), params_j)
    wq = tree["blocks"]["attn"]["wq"]
    t = to_tensor(wq, "cpu")
    assert t.dtype == torch.bfloat16 and t.shape == wq.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  wq.view(np.uint16))
    p = params_from_jax(tree, device="cpu", dtype=torch.bfloat16)
    assert p["blocks"]["norm1"]["scale"].dtype == torch.float32
    assert p["blocks"]["mlp"]["w1"].dtype == torch.bfloat16
    head = p["lm_head"]["w"] if "lm_head" in p else p["embed"]["table"].t()
    assert torch.equal(p["head"], head) and p["head"].is_contiguous()


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a host without one")
    cfg = get_smoke_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.DecodeEngine(cfg, {}, TC.PoolConfig(1, 4, 4, 8))


def test_submit_rejects_unservable():
    cfg = get_smoke_config("qwen3-0.6b")
    eng = TE.DecodeEngine(cfg, {}, TC.PoolConfig(1, 4, 2, 8), device="cpu")
    with pytest.raises(ValueError):
        eng.submit(TE.Request(0, np.zeros(7, np.int32), max_new=4))   # > max_seq
    with pytest.raises(ValueError):
        eng.submit(TE.Request(1, np.zeros(6, np.int32), max_new=2))   # 2 blocks > 1


def test_serve_launcher_on_cpu(capsys):
    args = ["--smoke", "--device", "cpu", "--requests", "5", "--gen", "6",
            "--block", "4", "--num-blocks", "9", "--slots", "2"]
    tlaunch.main(args)
    out = capsys.readouterr().out
    assert "5 sequences" in out and "tok/s" in out and "preemptions=" in out
    r = tlaunch.run(tlaunch.parser().parse_args(args))
    assert r["preemptions"] >= 1 and r["peak_blocks"] <= r["leasable_blocks"]
    assert all(f.reason == "max_new" and len(f.tokens) == 6 for f in r["finished"].values())
