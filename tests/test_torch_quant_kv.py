"""The int8 paged KV arena (``--quant-kv``, docs/DESIGN.md §11) against the
JAX package, on the CPU in fp32.

* ``quant_paged_write``/``quant_paged_gather`` against JAX's on random
  inputs: the int8 payload equal, the scales within 1e-7 relative, the
  gathered (dequantized) rows within 1e-7 relative, the null-block rule
  and the ``MIN_QUANT_DIM`` degrade rule (a narrow head dim keeps the
  dense dtype and its scales stay 1.0);
* the pool's arena layout (a port of ``tests/test_serve.py::
  test_quant_kv_pool_arena_layout``) and the block bytes the launcher
  prints;
* JAX's ``test_quant_kv_decode_parity_eviction_replay`` for qwen3-0.6b on
  the same trace (seed 11, prompts of 9 and 6 tokens, 64 tokens each,
  ``max_seq`` 80, 21 blocks of 4 on 2 slots): the port's int8 arena gives
  the tokens of the port's fp arena and of JAX's int8 run, and both of
  the port's runs preempt at least once.  One JAX engine run is shared by
  the module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import ParallelConfig, RunConfig, get_smoke_config as jax_smoke
from repro.models import attention as JATT
from repro.models import lm as jlm
from repro.serve import cache as JC
from repro.serve import engine as JE
from repro_torch.bridge import params_from_jax
from repro_torch.config import get_smoke_config
from repro_torch.core import quant as Q
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as ATT
from repro_torch.serve import cache as TC
from repro_torch.serve import engine as TE

ARCH = "qwen3-0.6b"
PCFG = ParallelConfig(strategy="hecaton", data=1, model=1, mx=1, my=1)
# tests/test_serve.py::_QUANT_TRACES["qwen3-0.6b"]
TRACE = dict(seed=11, lens=(9, 6), gen=64, maxseq=80, num_blocks=21)
POOL = dict(slots=2, block=4, num_blocks=TRACE["num_blocks"], max_seq=TRACE["maxseq"])
MAXSEQ = 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# write and gather against JAX's
# ---------------------------------------------------------------------------

def _case(rng, dh):
    """A [6, 4, 2, dh] arena, two rows of 5 new tokens at lengths (3, 9),
    and a table whose row 0 leases blocks 2, 5 (its tail past the lease
    goes to the null block) and row 1 blocks 1, 3, 4."""
    vals = rng.standard_normal((2, 5, 2, dh)).astype(np.float32)
    vals[1, 2] = 0.0                               # an all-zero row: scale 1.0
    table = np.array([[2, 5, 0, 0], [1, 3, 4, 0]], np.int32)
    lengths = np.array([3, 9], np.int32)
    return vals, table, lengths


def _jax_write_gather(dh, vals, table, lengths):
    dt = JATT._quant_arena_dtype(dh, jnp.float32)
    arena = jnp.zeros((6, 4, 2, dh), dt)
    scales = jnp.ones((6, 4, 2, 1), jnp.float32)
    a, s = JATT.quant_paged_write(arena, scales, jnp.asarray(vals), jnp.asarray(table),
                                  jnp.asarray(lengths))
    g = JATT.quant_paged_gather(a, s, jnp.asarray(table), jnp.float32)
    return np.asarray(a), np.asarray(s), np.asarray(g)


def _port_write_gather(dh, vals, table, lengths):
    dt = ATT.quant_arena_dtype(dh, torch.float32)
    arena = torch.zeros((6, 4, 2, dh), dtype=dt)
    scales = torch.ones((6, 4, 2, 1), dtype=torch.float32)
    tt = torch.from_numpy(table).long()
    ATT.quant_paged_write(arena, scales, torch.from_numpy(vals), tt,
                          torch.from_numpy(lengths))
    g = ATT.quant_paged_gather(arena, scales, tt, torch.float32)
    return arena.numpy(), scales.numpy(), g.numpy()


@pytest.mark.parametrize("dh", [32, 16, 8], ids=["int8", "int8-min-dim", "degraded"])
def test_quant_paged_write_and_gather_match_jax(dh):
    """Every leased block (the null block 0 takes duplicate writes in an
    unspecified order, in both packages) equal: int8 payloads exactly, the
    scales and the dequantized gather within 1e-7 relative.  Below
    ``MIN_QUANT_DIM`` the arena keeps fp32 and the scales stay 1.0."""
    vals, table, lengths = _case(np.random.default_rng(dh), dh)
    ja, js, jg = _jax_write_gather(dh, vals, table, lengths)
    ta, ts, tg = _port_write_gather(dh, vals, table, lengths)
    assert (ta.dtype == np.int8) == (dh >= Q.MIN_QUANT_DIM) == (ja.dtype == np.int8)
    np.testing.assert_array_equal(ta[1:], ja[1:])
    np.testing.assert_allclose(ts[1:], js[1:], rtol=1e-7, atol=0)
    if dh < Q.MIN_QUANT_DIM:
        assert (ts == 1.0).all()
    # the rows the slots own: row 0 positions < 8 (its two blocks), row 1 all
    np.testing.assert_allclose(tg[0, :8], jg[0, :8], rtol=1e-7, atol=0)
    np.testing.assert_allclose(tg[1], jg[1], rtol=1e-7, atol=0)


def test_quant_paged_roundtrip_within_half_a_scale():
    """What was written reads back within scale / 2 per element (the
    round-to-nearest bound), and the all-zero row exactly."""
    vals, table, lengths = _case(np.random.default_rng(1), 32)
    _, scales, g = _port_write_gather(32, vals, table, lengths)
    tt = torch.from_numpy(table).long()
    blk, off = ATT._slots(torch.zeros(6, 4), tt, torch.from_numpy(lengths), 5)
    for b in range(2):
        for s in range(5):
            pos = lengths[b] + s
            if b == 0 and pos >= 8:                  # past the lease: the null block
                continue
            sc = scales[blk[b, s], off[b, s]]         # [2, 1]
            assert (np.abs(g[b, pos] - vals[b, s]) <= sc / 2 + 1e-7).all(), (b, s)
    assert (g[1, 11] == 0).all()


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

def test_quant_kv_pool_arena_layout():
    """Quant pool: int8 payload + fp32 trailing-1 scale arenas that start at
    1.0; its tree is a ``QuantPagedKVCache``; the fp pool is the default
    and its tree a ``PagedKVCache``; an int8 block costs less."""
    cfg = get_smoke_config(ARCH)
    pc = TC.PoolConfig(slots=2, block=4, num_blocks=9, max_seq=MAXSEQ)
    q = TC.CachePool(cfg, pc, device="cpu", dtype=torch.float32, quant_kv=True)
    k, ks, v, vs = q.arenas["attn"]
    assert k.dtype == torch.int8 and v.dtype == torch.int8
    assert ks.dtype == torch.float32 and vs.dtype == torch.float32
    assert ks.shape == k.shape[:-1] + (1,) and vs.shape == v.shape[:-1] + (1,)
    assert float(ks.min()) == 1.0 and float(vs.min()) == 1.0
    assert isinstance(q.decode_tree()["attn"], ATT.QuantPagedKVCache)
    d = TC.CachePool(cfg, pc, device="cpu", dtype=torch.float32)
    assert not d.quant_kv
    assert isinstance(d.decode_tree()["attn"], ATT.PagedKVCache)
    assert q.block_bytes < d.block_bytes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_quant_kv_block_bytes_match_jax_and_the_row_rule(dtype):
    """One int8 block pins (dh + 4) / (dh * itemsize) of the compute
    dtype's block (a payload byte per element and a 4-byte scale per row),
    and the int8 pool's block bytes equal the JAX pool's."""
    cfg, cfg_j = get_smoke_config(ARCH), jax_smoke(ARCH)
    pc = dict(slots=2, block=4, num_blocks=9, max_seq=MAXSEQ)
    q = TC.CachePool(cfg, TC.PoolConfig(**pc), device="meta", dtype=dtype, quant_kv=True)
    d = TC.CachePool(cfg, TC.PoolConfig(**pc), device="meta", dtype=dtype)
    dh, elt = cfg.resolved_head_dim, torch.empty((), dtype=dtype).element_size()
    assert q.block_bytes * dh * elt == d.block_bytes * (dh + 4)
    jq = JC.CachePool(cfg_j, JC.PoolConfig(**pc), dtype=jnp.float32, quant_kv=True)
    assert q.block_bytes == jq.block_bytes


def test_quant_kv_launcher_serves_the_trace():
    """``--quant-kv`` serves the launcher's trace and reports the int8
    block beside the compute dtype's."""
    r = tlaunch.run(tlaunch.parser().parse_args(
        ["--smoke", "--device", "cpu", "--quant-kv"]))
    assert r["sequences"] == 8 and all(len(f.tokens) == 16 for f in r["finished"].values())
    assert r["engine"].pool.quant_kv
    dh = get_smoke_config(ARCH).resolved_head_dim
    assert r["block_bytes"] * dh * 4 == r["dense_block_bytes"] * (dh + 4)
    assert r["paged_peak_bytes"] == r["block_bytes"] * r["peak_blocks"]


# ---------------------------------------------------------------------------
# token parity on the evicting trace
# ---------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(TRACE["seed"])
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in TRACE["lens"]]


@pytest.fixture(scope="module")
def runs():
    cfg_j = jax_smoke(ARCH)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    prompts = _prompts(cfg_j.vocab_size)
    plens = tuple(len(p) for p in prompts)
    rc = RunConfig("serve", "decode", TRACE["maxseq"], 1)
    jeng = JE.DecodeEngine(cfg_j, PCFG, rc, params_j, JC.PoolConfig(**POOL),
                           compute_dtype=jnp.float32, quant_kv=True)
    jeng.warmup(prompt_lens=plens)
    jfin = jeng.run([JE.Request(rid=i, prompt=p, max_new=TRACE["gen"])
                     for i, p in enumerate(prompts)])
    cfg_t = get_smoke_config(ARCH)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu",
                               dtype=torch.float32)
    out = {"jax": ([jfin[i].tokens for i in range(len(prompts))],
                   jeng.stats["preemptions"])}
    for quant in (False, True):
        eng = TE.DecodeEngine(cfg_t, params_t, TC.PoolConfig(**POOL), device="cpu",
                              compute_dtype=torch.float32, quant_kv=quant)
        eng.warmup(prompt_lens=plens)
        fin = eng.run([TE.Request(rid=i, prompt=p, max_new=TRACE["gen"])
                       for i, p in enumerate(prompts)])
        out[quant] = ([fin[i].tokens for i in range(len(prompts))],
                      eng.stats["preemptions"])
    return out


def test_quant_kv_trace_preempts(runs):
    """The pool covers one sequence to completion but not both: each of the
    port's runs preempts the youngest at least once, as JAX's does."""
    assert runs[False][1] >= 1 and runs[True][1] >= 1
    assert runs["jax"][1] >= 1
    assert len(TRACE["lens"]) * TRACE["gen"] >= 64


@pytest.mark.parametrize("i", range(len(TRACE["lens"])))
def test_quant_kv_tokens_equal_fp_arena_and_jax(runs, i):
    """Sequence i's 64 greedy tokens through the int8 arena equal the fp
    arena's and JAX's int8 run's."""
    assert len(runs[False][0][i]) == TRACE["gen"]
    assert runs[True][0][i] == runs[False][0][i]
    assert runs[True][0][i] == runs["jax"][0][i]
