"""The SSM serving slice (mamba2-130m) against the JAX package, on the CPU
in fp32.

* ``ref.ssd_plain`` (the plain version of the SSD kernel) against the
  Pallas ``ssd`` in interpret mode and against ``models/ssm.ssd_chunked``
  with a ragged length and an initial state; ``ref.ssd_seq_ref`` against
  the JAX sequential oracle.  5e-4, the bound of
  ``tests/test_kernels.py::test_ssd_kernel_sweep`` (fp32 sums in another
  order, through exps of cumulative sums).
* ``causal_conv``, ``conv_step``, ``ssd_decode_step`` and ``apply_mamba``
  against JAX at 1e-5 (fp32, a few products each).
* The SMOKE model: ``lm.forward`` logits and the paged prefill and
  decode logits at 1e-4 (fp32 through two layers and the head), and the
  greedy engine's tokens and per-tick block accounting identical to the
  JAX ``DecodeEngine`` on a trace with a 1-token prompt, a ragged prompt
  (13 tokens over chunks of 8) and an eviction.

Parameters come from ``repro.models.lm.init_params`` through
``repro_torch.bridge``; one module-scoped fixture holds the JAX model and
its engine run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig, RunConfig, get_smoke_config as jax_smoke
from repro.kernels import ref as JR
from repro.kernels import ssd as JSSD
from repro.models import lm as jlm
from repro.models import ssm as JSSM
from repro.parallel.context import PCtx as JPCtx
from repro.serve import cache as JC
from repro.serve import engine as JE
from repro.serve import step as JS
from repro_torch.bridge import params_from_jax, to_tensor
from repro_torch.config import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as TSSM
from repro_torch.parallel.context import PCtx
from repro_torch.serve import cache as TC
from repro_torch.serve import engine as TE
from repro_torch.serve import step as TS

ARCH = "mamba2-130m"
PCFG = ParallelConfig(strategy="hecaton", data=1, model=1, mx=1, my=1)
SSD_TOL = dict(rtol=5e-4, atol=5e-4)
OP_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MAXSEQ, GEN = 24, 8
# 8 leasable blocks of 4 tokens: the 13-token prompt and its neighbour
# cannot both finish, so the youngest is preempted and replayed
POOL = dict(slots=2, block=4, num_blocks=9, max_seq=MAXSEQ)
PLENS = (13, 9, 1, 5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


def _ssd_inputs(seed, b, S, nh, dh, g, ds, state=False):
    """The inputs of tests/test_kernels.py's SSD tests, from a numpy seed."""
    rng = np.random.default_rng(seed)
    f = np.float32
    out = [rng.standard_normal((b, S, nh, dh)).astype(f),
           np.log1p(np.exp(rng.standard_normal((b, S, nh)))).astype(f),
           (-np.exp(rng.standard_normal(nh) * 0.5)).astype(f),
           rng.standard_normal((b, S, g, ds)).astype(f),
           rng.standard_normal((b, S, g, ds)).astype(f)]
    if state:
        out.append(rng.standard_normal((b, nh, dh, ds)).astype(f))
    return out


@pytest.fixture(scope="module")
def model():
    """The JAX SMOKE model, its port, and the JAX engine's run of the trace."""
    cfg_j = jax_smoke(ARCH)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu",
                               dtype=torch.float32)
    rc = RunConfig("serve", "decode", MAXSEQ, 1)
    eng = JE.DecodeEngine(cfg_j, PCFG, rc, params_j, JC.PoolConfig(**POOL),
                          compute_dtype=jnp.float32)
    eng.warmup(prompt_lens=PLENS)
    fin, ticks = _drive(eng, _requests(JE.Request, cfg_j.vocab_size))
    return dict(cfg_j=cfg_j, params_j=params_j, cfg_t=get_smoke_config(ARCH),
                params_t=params_t, jax_run=(fin, ticks, eng.stats["preemptions"]))


def _requests(klass, vocab):
    rng = np.random.default_rng(7)
    return [klass(i, rng.integers(0, vocab, size=n).astype(np.int32), GEN,
                  arrival=i // 2) for i, n in enumerate(PLENS)]


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


# ---------------------------------------------------------------------------
# the scan: plain version against Pallas and the model's chunked form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,S,nh,dh,g,ds,chunk", [
    (1, 64, 2, 16, 1, 8, 16), (2, 128, 4, 32, 2, 16, 32), (1, 256, 2, 64, 1, 64, 64)])
def test_ssd_plain_vs_pallas(b, S, nh, dh, g, ds, chunk):
    x, dt, A, B, C = _ssd_inputs(0, b, S, nh, dh, g, ds)
    want = JSSD.ssd(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk, interpret=True)
    y, fin = ref.ssd_plain(*map(_t, (x, dt, A, B, C)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **SSD_TOL)
    assert fin.dtype == torch.float32 and fin.shape == (b, nh, dh, ds)


@pytest.mark.parametrize("S,chunk", [(100, 32), (64, 32), (7, 8)])
def test_ssd_plain_vs_ssd_chunked_with_state(S, chunk):
    """Ragged S (dt = 0 padding), an initial state, y and the final state."""
    x, dt, A, B, C, h0 = _ssd_inputs(1, 2, S, 4, 16, 2, 8, state=True)
    yj, fj = JSSM.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
                              init_state=jnp.asarray(h0))
    y, fin = ref.ssd_plain(*map(_t, (x, dt, A, B, C)), chunk=chunk, init_state=_t(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SSD_TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(fj), **SSD_TOL)


def test_ssd_seq_ref_vs_jax_oracle():
    x, dt, A, B, C = _ssd_inputs(2, 2, 40, 4, 8, 2, 8)
    want = JR.ssd_ref(*map(jnp.asarray, (x, dt, A, B, C)))
    got = ref.ssd_seq_ref(*map(_t, (x, dt, A, B, C)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_TOL)
    y, _ = ref.ssd_plain(*map(_t, (x, dt, A, B, C)), chunk=16)
    np.testing.assert_allclose(y.numpy(), got.numpy(), **SSD_TOL)


def test_ssd_plain_bf16_rounds_once():
    """bf16 inputs: fp32 sums, one rounding of y; the state stays fp32."""
    x, dt, A, B, C = _ssd_inputs(3, 1, 50, 2, 16, 1, 8)
    xb, Bb, Cb = (_t(a).to(torch.bfloat16) for a in (x, B, C))
    y, fin = ref.ssd_plain(xb, _t(dt), _t(A), Bb, Cb, chunk=16)
    y32, fin32 = ref.ssd_plain(xb.float(), _t(dt), _t(A), Bb.float(), Cb.float(), chunk=16)
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16)) and torch.equal(fin, fin32)


def test_ops_ssd_takes_plain_on_cpu_and_refuses_grad():
    x, dt, A, B, C = map(_t, _ssd_inputs(4, 1, 20, 2, 16, 1, 8))
    ops.reset_launches()
    y, fin = ops.ssd(x, dt, A, B, C, chunk=8)
    y_p, fin_p = ref.ssd_plain(x, dt, A, B, C, chunk=8)
    assert torch.equal(y, y_p) and torch.equal(fin, fin_p) and ops.LAUNCHES["ssd"] == 0
    y2, _ = PCtx(plain=True).ssd(x, dt, A, B, C, chunk=8)
    assert torch.equal(y2, y_p)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd(x.requires_grad_(), dt, A, B, C, chunk=8)


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import ssd as kssd
    x, dt, A, B, C = map(_t, _ssd_inputs(4, 1, 20, 2, 16, 1, 8))
    with pytest.raises(ValueError, match="CUDA SSD"):
        kssd.ssd(x, dt, A, B, C, chunk=8)


# ---------------------------------------------------------------------------
# the mixer's pieces
# ---------------------------------------------------------------------------

def test_causal_conv_and_conv_step():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    np.testing.assert_allclose(TSSM.causal_conv(_t(x), _t(w)).numpy(),
                               np.asarray(JSSM.causal_conv(jnp.asarray(x), jnp.asarray(w))),
                               **OP_TOL)
    yj, nj = JSSM.conv_step(jnp.asarray(st), jnp.asarray(x[:, 0]), jnp.asarray(w))
    yt, nt = TSSM.conv_step(_t(st), _t(x[:, 0]), _t(w))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **OP_TOL)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def test_ssd_decode_step():
    rng = np.random.default_rng(6)
    b, nh, dh, g, ds = 2, 4, 8, 2, 6
    h = rng.standard_normal((b, nh, dh, ds)).astype(np.float32)
    x = rng.standard_normal((b, nh, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, nh)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh))).astype(np.float32)
    B = rng.standard_normal((b, g, ds)).astype(np.float32)
    C = rng.standard_normal((b, g, ds)).astype(np.float32)
    yj, hj = JSSM.ssd_decode_step(*map(jnp.asarray, (h, x, dt, A, B, C)))
    yt, ht = TSSM.ssd_decode_step(*map(_t, (h, x, dt, A, B, C)))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **OP_TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **OP_TOL)


@pytest.mark.parametrize("S", [1, 13])
def test_apply_mamba_with_state(model, S):
    """S = 1: one decode step; S = 13: a prefill over a ragged chunk that
    starts the scan from a non-zero state."""
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    pj = jax.tree.map(lambda a: a[0], model["params_j"]["blocks"]["mixer"])
    pt = {k: v[0] for k, v in model["params_t"]["blocks"]["mixer"].items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, S, cfg_j.d_model)).astype(np.float32)
    st_j = JSSM.init_ssm_state(cfg_j, 2, jnp.float32)
    st = [rng.standard_normal(a.shape).astype(np.float32) * 0.5 for a in st_j]
    oj, nj = JSSM.apply_mamba(JPCtx(None, PCFG), cfg_j, pj, jnp.asarray(x),
                              state=JSSM.SSMState(*map(jnp.asarray, st)))
    ot, nt = TSSM.apply_mamba(PCtx(), cfg_t, pt, _t(x), state=TSSM.SSMState(*map(_t, st)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **OP_TOL)
    np.testing.assert_allclose(nt.conv.numpy(), np.asarray(nj.conv), **OP_TOL)
    np.testing.assert_allclose(nt.ssm.numpy(), np.asarray(nj.ssm), **SSD_TOL)


def test_init_matches_jax_structure(model):
    """Same leaves, shapes and the deterministic leaves' values; fp32
    serving leaves stay fp32 under a bf16 conversion."""
    tp = tlm.init_master_params(model["cfg_t"], seed=0, device="cpu")
    jp = model["params_j"]
    jl = {".".join(str(k.key) for k in p): a
          for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    tl = {".".join(p): t for p, t in tlm.flatten(tp)}
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert tuple(tl[k].shape) == jl[k].shape, k
    for k in ("blocks.mixer.A_log", "blocks.mixer.D", "blocks.mixer.norm"):
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]), rtol=1e-6)
    served = tlm.prepare_params(tp, torch.bfloat16)
    for leaf in ("dt_bias", "A_log", "D", "norm", "conv_w"):
        assert served["blocks"]["mixer"][leaf].dtype == torch.float32, leaf
    for leaf in ("wz", "wx", "wB", "wC", "wdt", "wo"):
        assert served["blocks"]["mixer"][leaf].dtype == torch.bfloat16, leaf


# ---------------------------------------------------------------------------
# the model and the serving steps
# ---------------------------------------------------------------------------

def test_forward_without_cache_matches_jax(model):
    toks = np.random.default_rng(1).integers(0, model["cfg_j"].vocab_size, size=(2, 11))
    jout = jlm.forward(JPCtx(None, PCFG), model["cfg_j"], model["params_j"],
                       {"tokens": jnp.asarray(toks, jnp.int32), "_dtype": jnp.float32})
    tout = tlm.forward(PCtx(), model["cfg_t"], model["params_t"],
                       {"tokens": torch.from_numpy(toks), "_dtype": torch.float32})
    assert tout.caches is None
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits), **LOGIT_TOL)


def test_paged_prefill_and_decode_logits_match_jax(model):
    cfg_j, params_j, cfg_t, params_t = (model[k] for k in ("cfg_j", "params_j", "cfg_t",
                                                            "params_t"))
    pc = dict(slots=3, block=4, num_blocks=16, max_seq=MAXSEQ)
    jpool = JC.CachePool(cfg_j, JC.PoolConfig(**pc), dtype=jnp.float32)
    tpool = TC.CachePool(cfg_t, TC.PoolConfig(**pc), device="cpu", dtype=torch.float32)
    jpre = jax.jit(JS.build_prefill_paged(cfg_j, PCFG, None, compute_dtype=jnp.float32))
    tpre = TS.build_prefill_paged(cfg_t, compute_dtype=torch.float32)
    rng = np.random.default_rng(7)
    for n in (13, 5):                            # two live slots, the third idle
        p = rng.integers(0, cfg_j.vocab_size, size=n).astype(np.int32)
        js, ts = jpool.admit(n), tpool.admit(n)
        assert js == ts
        jl, jtree = jpre(params_j, jpool.prefill_tree(js), jnp.asarray(p)[None],
                         jnp.int32(n))
        jpool.absorb_prefill(js, jtree)
        tl, ttree = tpre(params_t, tpool.prefill_tree(ts),
                         torch.from_numpy(p.astype(np.int64))[None], n)
        tpool.absorb_prefill(ts, ttree)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        jpool.commit_prefill(js, n)
        tpool.commit_prefill(ts, n)
    for jst, tst in zip(jpool.states["mamba"], tpool.states["mamba"]):
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **SSD_TOL)
    tokens = np.array([[3], [5], [0]], np.int32)
    positions = jpool.lengths.astype(np.int32)[:, None]
    jdec = jax.jit(JS.build_decode_step(cfg_j, PCFG, None, None,
                                        compute_dtype=jnp.float32))
    for _ in range(2):                           # the state carries from tick to tick
        jlog, jtree = jdec(params_j, jpool.decode_tree(), jnp.asarray(tokens),
                           jnp.asarray(positions))
        jpool.absorb_decode(jtree)
        tdec = TS.build_decode_step(cfg_t, compute_dtype=torch.float32)
        tlog, _ = tdec(params_t, tpool.decode_tree(), torch.from_numpy(tokens).long(),
                       torch.from_numpy(positions).long())
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
        positions = positions + 1


@pytest.fixture(scope="module")
def torch_run(model):
    eng = TE.DecodeEngine(model["cfg_t"], model["params_t"], TC.PoolConfig(**POOL),
                          device="cpu", compute_dtype=torch.float32)
    eng.warmup(prompt_lens=PLENS)
    fin, ticks = _drive(eng, _requests(TE.Request, model["cfg_t"].vocab_size))
    return fin, ticks, eng.stats["preemptions"]


@pytest.mark.parametrize("plen", [2, 3, 13])
def test_prefill_then_decode_matches_full_forward(model, plen):
    """A prompt shorter than the conv window (where the JAX apply_mamba
    cannot build its conv state) and a ragged one: a prefill from the
    pool's zero state and then decode steps give the logits of one forward
    over the whole sequence."""
    cfg_t, params_t = model["cfg_t"], model["params_t"]
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg_t.vocab_size, size=plen + 4))[None]
    full = tlm.forward(PCtx(), cfg_t, params_t, {"tokens": toks, "_dtype": torch.float32})
    pool = TC.CachePool(cfg_t, TC.PoolConfig(1, 4, 8, 24), device="cpu")
    slot = pool.admit(plen)
    pre = TS.build_prefill_paged(cfg_t, compute_dtype=torch.float32)
    dec = TS.build_decode_step(cfg_t, compute_dtype=torch.float32)
    last, tree = pre(params_t, pool.prefill_tree(slot), toks[:, :plen], plen)
    pool.absorb_prefill(slot, tree)
    got = [last[0, 0]]
    for i in range(plen, plen + 4):
        logits, _ = dec(params_t, pool.decode_tree(), toks[:, i:i + 1], torch.tensor([[i]]))
        got.append(logits[0, 0])
    np.testing.assert_allclose(torch.stack(got).numpy(), full.logits[0, plen - 1:].numpy(),
                               **LOGIT_TOL)


def test_engine_greedy_tokens_match_jax(model, torch_run):
    jfin, _, jpre = model["jax_run"]
    tfin, _, tpre = torch_run
    assert jpre >= 1 and tpre == jpre             # the trace really evicts
    assert sorted(tfin) == sorted(jfin)
    for rid in jfin:
        assert tfin[rid].tokens == jfin[rid].tokens, rid
        assert (tfin[rid].reason, tfin[rid].preemptions) == \
            (jfin[rid].reason, jfin[rid].preemptions)


def test_engine_pool_accounting_matches_jax(model, torch_run):
    """Block table, lengths, peak and free list after every tick."""
    _, jticks, _ = model["jax_run"]
    _, tticks, _ = torch_run
    assert len(tticks) == len(jticks)
    for i, (j, t) in enumerate(zip(jticks, tticks)):
        np.testing.assert_array_equal(t[0], j[0], err_msg=f"table, tick {i}")
        np.testing.assert_array_equal(t[1], j[1], err_msg=f"lengths, tick {i}")
        assert t[2:] == j[2:], i


def test_pool_bytes_and_prompt_padding_match_jax(model):
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    assert TC.dense_cache_bytes(cfg_t, 4, 48, torch.float32) == \
        JC.dense_cache_bytes(cfg_j, 4, 48, jnp.float32)
    assert TC.dense_cache_bytes(cfg_t, 4, 48, torch.bfloat16) == \
        JC.dense_cache_bytes(cfg_j, 4, 48, jnp.bfloat16)
    jp = JC.CachePool(cfg_j, JC.PoolConfig(2, 4, 9, MAXSEQ), dtype=jnp.float32)
    tp = TC.CachePool(cfg_t, TC.PoolConfig(2, 4, 9, MAXSEQ), device="cpu")
    assert tp.block_bytes == jp.block_bytes == 0
    for jst, tst in zip(jp.states["mamba"], tp.states["mamba"]):
        assert tuple(tst.shape) == jst.shape and str(tst.dtype)[6:] == str(jst.dtype)
    eng = TE.DecodeEngine(cfg_t, model["params_t"], TC.PoolConfig(2, 4, 9, MAXSEQ),
                          device="cpu")
    tokens, plen = eng._pad_prompt(np.arange(5, dtype=np.int32))
    assert tuple(tokens.shape) == (1, 5) and plen == 5        # exact length


def test_serve_launcher_mamba_on_cpu(capsys):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "5", "--gen", "6",
            "--block", "4", "--num-blocks", "9", "--slots", "2", "--prompt-lens", "13,1,8"]
    tlaunch.main(args)
    out = capsys.readouterr().out
    assert "5 sequences" in out and "tok/s" in out and "preemptions=" in out
    r = tlaunch.run(tlaunch.parser().parse_args(args))
    assert r["preemptions"] >= 1 and r["peak_blocks"] <= r["leasable_blocks"]
    assert all(f.reason == "max_new" and len(f.tokens) == 6 for f in r["finished"].values())
