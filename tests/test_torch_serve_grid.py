"""The dense KV cache and serving on the rank grid against the JAX
package, on the CPU in fp32.

* one device: the dense path (``serve/step.build_prefill`` into
  ``serve/cache.init_dense``'s caches, then ``build_decode_step``) gives
  the greedy tokens of JAX's ``_dense_greedy`` (``tests/test_serve.py``)
  and its logits within 1e-4 at every step, for the dense and the ssm
  family; the port's paged engine gives the dense path's tokens; and
  ``init_dense``'s bytes equal JAX's ``dense_cache_bytes``;
* the grid: ``build_prefill`` of a 4 x 8 prompt batch into sharded dense
  caches, then three decode ticks teacher-forced on fixed tokens, on the
  1x1x2 and 2x1x2 grids (``PCtx`` modes ``prefill`` and ``decode``; the
  model ring of two divides the smoke config's 2 kv heads, "heads fully
  sharded") under overlap ``none`` and ``fused``: every rank's logits of
  its rows within 1e-5 of JAX's ``build_prefill``/``build_decode_step``
  on the same fake mesh, its prefilled K/V within 1e-5 of its slice of
  JAX's caches (the heads its decode reads), and the spec tree of
  ``cache_specs`` equal to JAX's.

The JAX grid references run in one subprocess (this file run as a
script, 4 fake CPU devices, LLVM at -O0) beside the port's gloo worlds
(``_torch_world.run_world``).
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as TW  # noqa: E402

ARCH = "qwen3-0.6b"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRID_TOL = dict(rtol=1e-5, atol=1e-5)
MAXSEQ, GEN, PLEN = 24, 6, 7
GRIDS = ((1, 1, 2), (2, 1, 2))
OVERLAPS = ("none", "fused")
SERVE = dict(B=4, S=8, ticks=3, s_max=16)
SPEC_BATCHES = (4, 1)


def _grid_key(shape):
    return "x".join(map(str, shape))


# ---------------------------------------------------------------------------
# the JAX grid side (this file run as a script)
# ---------------------------------------------------------------------------

def _spec_list(spec):
    return [None if e is None else (list(e) if isinstance(e, tuple) else e) for e in spec]


def _jax_main(inp, out):
    import jax
    import jax.numpy as jnp
    from repro.config import ParallelConfig, RunConfig, get_smoke_config
    from repro.launch.mesh import make_small_mesh
    from repro.serve import step as SRV

    z = np.load(inp)
    params = jax.tree.map(jnp.asarray, TW._np_tree(z, "init/"))
    cfg = get_smoke_config(ARCH)
    rc = RunConfig("serve", "decode", SERVE["s_max"], SERVE["B"])
    res = {}
    for shape in GRIDS:
        d, mx, my = shape
        g = _grid_key(shape)
        mesh = make_small_mesh("hecaton", d, mx, my)
        pcfg = ParallelConfig(strategy="hecaton", data=d, model=mx * my, mx=mx, my=my)
        for b in SPEC_BATCHES:
            specs = SRV.cache_specs(cfg, pcfg, mesh, batch=b)["attn"]
            for name, spec in zip(("k", "v", "length"), specs):
                res[f"{g}/specs/{b}/{name}"] = np.asarray(repr(_spec_list(spec)))
        prefill = jax.jit(SRV.build_prefill(cfg, pcfg, rc, mesh, compute_dtype=jnp.float32))
        decode = jax.jit(SRV.build_decode_step(cfg, pcfg, rc, mesh, compute_dtype=jnp.float32))
        logits, caches = prefill(params, {"tokens": jnp.asarray(z["prompt"])})
        res[f"{g}/prefill"] = np.asarray(logits)
        res[f"{g}/k"], res[f"{g}/v"] = np.asarray(caches["attn"].k), np.asarray(caches["attn"].v)
        for i in range(SERVE["ticks"]):
            tok = jnp.asarray(z["teacher"][:, i:i + 1])
            pos = jnp.full((SERVE["B"], 1), SERVE["S"] + i, jnp.int32)
            logits, caches = decode(params, caches, tok, pos)
            res[f"{g}/tick{i}"] = np.asarray(logits)
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# the port's grid side (the rank processes)
# ---------------------------------------------------------------------------

def serve_grid_job(grid, in_path):
    """Prefill this rank's block of the prompts and decode three ticks
    under each overlap mode; returns each step's logits of this rank's
    rows, its prefilled K/V and its cache spec trees."""
    from repro_torch import bridge
    from repro_torch.config import ParallelConfig, RunConfig, get_smoke_config
    from repro_torch.parallel import specs
    from repro_torch.serve import step as SS

    z = np.load(in_path)
    full = bridge.master_params_from_jax(TW._np_tree(z, "init/"), device="cpu")
    cfg = get_smoke_config(ARCH)
    rc = RunConfig("serve", "decode", SERVE["s_max"], SERVE["B"])
    out = {}
    for ov in OVERLAPS:
        pcfg = ParallelConfig(data=grid.data, mx=grid.mx, my=grid.my, overlap=ov)
        params = SS.grid_params(full, grid, pcfg, torch.float32)
        lb = specs.local_batch({"tokens": z["prompt"].astype(np.int64)}, grid)
        teacher = z["teacher"].astype(np.int64)[_rows(grid.coords_of(grid.rank)[0], grid.data)]
        prefill = SS.build_prefill(cfg, pcfg, rc, grid, compute_dtype=torch.float32)
        decode = SS.build_decode_step(cfg, pcfg, rc, grid, compute_dtype=torch.float32)
        with torch.inference_mode():
            logits, caches = prefill(params, {"tokens": torch.from_numpy(lb["tokens"])})
            res = {"prefill": logits.numpy().copy(), "k": caches["attn"].k.numpy().copy(),
                   "v": caches["attn"].v.numpy().copy()}
            b = teacher.shape[0]
            for i in range(SERVE["ticks"]):
                tok = torch.from_numpy(np.ascontiguousarray(teacher[:, i:i + 1]))
                pos = torch.full((b, 1), SERVE["S"] + i, dtype=torch.int64)
                logits, caches = decode(params, caches, tok, pos)
                res[f"tick{i}"] = logits.numpy().copy()
            res["length"] = caches["attn"].length.numpy().copy()
        out[ov] = res
    out["specs"] = {bb: SS.cache_specs(cfg, ParallelConfig(data=grid.data, mx=grid.mx,
                                                           my=grid.my), grid, bb)["attn"]
                    for bb in SPEC_BATCHES}
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid_ref(tmp_path_factory):
    import jax
    from repro.config import get_smoke_config as jax_smoke
    from repro.models import lm as jlm
    d = tmp_path_factory.mktemp("serve_grid")
    inputs, ref_path = d / "inputs.npz", d / "jax.npz"
    cfg = jax_smoke(ARCH)
    params0 = jlm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    z = {"init/" + "/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
         for kp, v in jax.tree_util.tree_flatten_with_path(params0)[0]}
    z["prompt"] = rng.integers(0, cfg.vocab_size, size=(SERVE["B"], SERVE["S"])).astype(np.int32)
    z["teacher"] = rng.integers(0, cfg.vocab_size,
                                size=(SERVE["B"], SERVE["ticks"])).astype(np.int32)
    np.savez(inputs, **z)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_backend_optimization_level=0")
    proc = subprocess.Popen([sys.executable, __file__, str(inputs), str(ref_path)], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        worlds = {shape: TW.run_world(shape, serve_grid_job, (str(inputs),))
                  for shape in GRIDS}
        err = proc.communicate(timeout=900)[1]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    return SimpleNamespace(ref=dict(np.load(ref_path)), worlds=worlds)


@pytest.fixture(scope="module", params=[ARCH, "mamba2-130m"])
def dense_runs(request):
    """JAX's ``_dense_greedy`` with every step's logits, and the port's dense
    path on the same parameters and prompt."""
    import jax
    import jax.numpy as jnp
    from repro.config import ParallelConfig as JPCfg
    from repro.config import RunConfig as JRunConfig
    from repro.config import get_smoke_config as jax_smoke
    from repro.models import lm as jlm
    from repro.serve import step as JS
    from repro_torch.bridge import params_from_jax
    from repro_torch.config import RunConfig, get_smoke_config
    from repro_torch.serve import step as SS
    arch = request.param
    cfg_j = jax_smoke(arch)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (PLEN,), 0,
                                           cfg_j.vocab_size), np.int32)
    pcfg = JPCfg(strategy="hecaton", data=1, model=1, mx=1, my=1)
    jrc = JRunConfig("serve", "decode", MAXSEQ, 1)
    prefill = jax.jit(JS.build_prefill(cfg_j, pcfg, jrc, None, compute_dtype=jnp.float32))
    decode = jax.jit(JS.build_decode_step(cfg_j, pcfg, jrc, None, compute_dtype=jnp.float32))
    logits, caches = prefill(params_j, {"tokens": jnp.asarray(prompt)[None, :]})
    jl, tok = [np.asarray(logits)], JS.greedy_sample(logits)
    jt = [int(tok[0, 0])]
    for i in range(GEN - 1):
        logits, caches = decode(params_j, caches, tok,
                                jnp.full((1, 1), PLEN + i, jnp.int32))
        jl.append(np.asarray(logits))
        tok = JS.greedy_sample(logits)
        jt.append(int(tok[0, 0]))

    cfg_t = get_smoke_config(arch)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu",
                               dtype=torch.float32)
    rc = RunConfig("serve", "decode", MAXSEQ, 1)
    tpre = SS.build_prefill(cfg_t, rc=rc, compute_dtype=torch.float32)
    tdec = SS.build_decode_step(cfg_t, compute_dtype=torch.float32)
    with torch.inference_mode():
        logits, caches = tpre(params_t, {"tokens": torch.from_numpy(prompt.copy()).long()[None]})
        tl, tok = [logits.numpy()], SS.greedy_sample(logits)
        tt = [int(tok[0, 0])]
        for i in range(GEN - 1):
            logits, caches = tdec(params_t, caches, tok.long(),
                                  torch.full((1, 1), PLEN + i, dtype=torch.int64))
            tl.append(logits.numpy())
            tok = SS.greedy_sample(logits)
            tt.append(int(tok[0, 0]))
    return SimpleNamespace(arch=arch, cfg=cfg_t, params=params_t, prompt=prompt, jax_tokens=jt,
                           jax_logits=jl, tokens=tt, logits=tl, caches=caches)


# ---------------------------------------------------------------------------
# one device: the dense path
# ---------------------------------------------------------------------------

def test_dense_greedy_tokens_match_jax(dense_runs):
    assert dense_runs.tokens == dense_runs.jax_tokens, dense_runs.arch


@pytest.mark.parametrize("step", range(GEN))
def test_dense_logits_match_jax(dense_runs, step):
    """Prefill's last-token logits (step 0) and each decode tick's."""
    np.testing.assert_allclose(dense_runs.logits[step], dense_runs.jax_logits[step],
                               err_msg=f"{dense_runs.arch} step {step}", **LOGIT_TOL)


def test_dense_cache_length_advances(dense_runs):
    """The dense attention cache's one length counts every written token
    (the ssm family's states carry no length)."""
    attn = dense_runs.caches.get("attn")
    if attn is None:
        assert dense_runs.arch == "mamba2-130m"
        return
    assert attn.length.tolist() == [PLEN + GEN - 1] * dense_runs.cfg.num_layers


def test_paged_engine_tokens_equal_dense_path(dense_runs):
    """The port's paged engine serves the prompt to the dense path's tokens
    (JAX's ``test_decode_parity_dense_paged_teacher``)."""
    from repro_torch.serve import engine as TE
    from repro_torch.serve.cache import PoolConfig, blocks_for
    pool = PoolConfig(slots=2, block=4, num_blocks=2 * blocks_for(MAXSEQ, 4) + 1,
                      max_seq=MAXSEQ)
    eng = TE.DecodeEngine(dense_runs.cfg, dense_runs.params, pool, device="cpu",
                          compute_dtype=torch.float32)
    eng.warmup()
    fin = eng.run([TE.Request(rid=0, prompt=dense_runs.prompt, max_new=GEN)])
    assert fin[0].tokens == dense_runs.tokens, dense_runs.arch


@pytest.mark.parametrize("arch", [ARCH, "paper-llama2-7b", "mamba2-130m"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_dense_bytes_match_jax(arch, dtype):
    """``init_dense``'s tree (and ``dense_cache_bytes``) pins the bytes of
    JAX's ``dense_cache_bytes``, and its leaves have JAX's shapes."""
    import jax
    import jax.numpy as jnp
    from repro.config import get_smoke_config as jax_smoke
    from repro.serve import cache as JC
    from repro_torch.config import get_smoke_config
    from repro_torch.serve import cache as TC
    want = JC.dense_cache_bytes(jax_smoke(arch), 3, MAXSEQ, getattr(jnp, dtype))
    tree = TC.init_dense(get_smoke_config(arch), 3, MAXSEQ, getattr(torch, dtype), "meta")
    assert TC.tree_bytes(tree) == want
    assert TC.dense_cache_bytes(get_smoke_config(arch), 3, MAXSEQ, getattr(torch, dtype)) == want
    jtree = jax.eval_shape(lambda: JC.init_dense(jax_smoke(arch), 3, MAXSEQ,
                                                 getattr(jnp, dtype)))
    got = [tuple(t.shape) for t in jax.tree.leaves(tuple(tree.values()))]
    assert got == [tuple(t.shape) for t in jax.tree.leaves(tuple(jtree.values()))]


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

GRID_CASES = [(shape, ov) for shape in GRIDS for ov in OVERLAPS]


def _rows(d, n_data):
    """The batch rows of data index ``d`` of ``n_data``."""
    b = SERVE["B"] // n_data
    return slice(d * b, (d + 1) * b)


@pytest.mark.parametrize("shape,ov", GRID_CASES,
                         ids=[f"{_grid_key(s)}-{ov}" for s, ov in GRID_CASES])
@pytest.mark.parametrize("step", ["prefill"] + [f"tick{i}" for i in range(SERVE["ticks"])])
def test_grid_serving_logits_match_jax(grid_ref, shape, ov, step):
    """Every rank's logits of its rows (the whole vocabulary) within 1e-5 of
    JAX's on the same mesh."""
    want = grid_ref.ref[f"{_grid_key(shape)}/{step}"]
    for rank, res in sorted(grid_ref.worlds[shape].items()):
        d = rank // (shape[1] * shape[2])
        np.testing.assert_allclose(res[ov][step], want[_rows(d, shape[0])],
                                   err_msg=f"{shape} {ov} {step} rank {rank}", **GRID_TOL)


@pytest.mark.parametrize("shape,ov", GRID_CASES,
                         ids=[f"{_grid_key(s)}-{ov}" for s, ov in GRID_CASES])
def test_grid_prefill_caches_hold_the_ranks_heads(grid_ref, shape, ov):
    """The K/V a rank's prefill wrote are its slice, under ``cache_specs``,
    of JAX's prefilled caches, and decode advanced every layer's length."""
    from repro_torch.launch.mesh import Grid
    from repro_torch.parallel import specs
    g = _grid_key(shape)
    for rank, res in sorted(grid_ref.worlds[shape].items()):
        grid = Grid(*shape, rank)
        spec = res["specs"][SERVE["B"]]
        for name in ("k", "v"):
            want = specs.local_slice(torch.from_numpy(grid_ref.ref[f"{g}/{name}"]),
                                     getattr(spec, name), grid).numpy()
            got = res[ov][name]
            assert got.shape == want.shape
            np.testing.assert_allclose(got[:, :, :SERVE["S"]], want[:, :, :SERVE["S"]],
                                       err_msg=f"{g} {ov} {name} rank {rank}", **GRID_TOL)
        assert res[ov]["length"].tolist() == [SERVE["S"] + SERVE["ticks"]] * len(
            res[ov]["length"])


@pytest.mark.parametrize("shape", GRIDS, ids=_grid_key)
@pytest.mark.parametrize("batch", SPEC_BATCHES)
def test_cache_specs_match_jax(grid_ref, shape, batch):
    """``cache_specs``' tree (K, V, the lengths) equals JAX's, every rank."""
    for rank, res in sorted(grid_ref.worlds[shape].items()):
        for name, spec in zip(("k", "v", "length"), res["specs"][batch]):
            want = eval(str(grid_ref.ref[f"{_grid_key(shape)}/specs/{batch}/{name}"]))
            assert _spec_list(spec) == want, (shape, batch, name, rank)


def test_pctx_grid_modes():
    """A grid context takes JAX's prefill and decode modes (decode runs the
    1D layout and the replicated residual) and refuses the one-device
    ``serve`` mode."""
    from repro_torch.config import ParallelConfig
    from repro_torch.launch.mesh import Grid
    from repro_torch.parallel.context import PCtx
    grid = Grid(1, 2, 2)
    pcfg = ParallelConfig(mx=2, my=2)
    pre = PCtx(mode="prefill", pcfg=pcfg, mesh=grid)
    dec = PCtx(mode="decode", pcfg=pcfg, mesh=grid)
    assert pre.use_hecaton and not pre.use_megatron
    assert dec.use_megatron and not dec.use_hecaton and dec.residual == "replicated"
    assert dec.ax.model_axes == ("model",) and dec.seq_shards == 1
    with pytest.raises(ValueError, match="prefill"):
        PCtx(mode="serve", pcfg=pcfg, mesh=grid)


def test_cache_specs_refuse_unported_layouts():
    """A model ring that does not divide the kv heads needs a layout other
    than "heads fully sharded" (ROADMAP queue 1 item 5.7): refused."""
    from repro_torch.config import ParallelConfig, get_smoke_config
    from repro_torch.launch.mesh import Grid
    from repro_torch.serve import step as SS
    with pytest.raises(NotImplementedError, match="heads fully sharded"):
        SS.cache_specs(get_smoke_config(ARCH), ParallelConfig(mx=2, my=2), Grid(1, 2, 2), 4)
    assert SS.cache_specs(get_smoke_config(ARCH), ParallelConfig(), None, 4) is None


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
