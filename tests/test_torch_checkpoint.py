"""The port's checkpointing against the JAX package, on the CPU.

* **Same format.** The same state saved by ``repro.checkpoint.manager``
  and by ``repro_torch.checkpoint.manager`` with writers/quorum (1, None),
  (3, None) and (4, 2) gives step directories equal file for file, byte
  for byte, ``MANIFEST.json`` included (bf16, 0-d and NamedTuple leaves
  among them).
* **Round trips on one device** (qwen3-0.6b smoke config, tied, fp32,
  two microbatches, fp32 gradient reduction): a JAX checkpoint after two
  steps restores in the port bit for bit under the same names
  (``opt_state/.step``, ``opt_state/.mu/...``), and two more steps of the
  port match JAX's two more steps within ``tests/test_torch_train.py``'s
  fp32 tolerances (loss 1e-5 relative, params 0.05 lr absolute, moments
  2e-4 of the leaf's largest); a port checkpoint restores in JAX bit for
  bit.
* **Round trips on the grid** (paper-llama2-7b smoke config, untied
  head, fp32): a JAX ``mesh=None`` checkpoint restores into the blocks
  and ZeRO-1 parts of a 1x2x2 gloo world, and two grid steps match two
  JAX steps on a fake (1, 2, 2) mesh restored from the same checkpoint
  within the grid tests' 1e-5 (losses relative; each final parameter by
  relative L2); the grid's own (async) save restores in JAX bit-equal
  to the grid's gathered state.  On 2x1x2 (ZeRO-1 splits the moments
  over data) the restored blocks saved again give the JAX checkpoint's
  step directory file for file.
* **The JAX package's checkpoint cases**, ported (the writer processes'
  in ``tests/test_torch_fleet.py``): async == sync, the snapshot's independence
  from later in-place updates, backpressure, GC, abort and the sticky
  error, quorum, torn windows, corruption named by file, tolerant
  listing; and the launcher's resume, bit-exact against an
  uninterrupted run, with writer processes and a blocklist too.
"""

import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.manager as JM
from repro.checkpoint import wire as jwire
from repro.config import ParallelConfig as JParallel
from repro.config import RunConfig as JRun
from repro.config import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.bridge import master_params_from_jax
from repro_torch.checkpoint import manager as M
from repro_torch.checkpoint import wire
from repro_torch.checkpoint.manager import (MANIFEST, AsyncCheckpointManager,
                                            CheckpointCorruptionError, CheckpointManager,
                                            QuorumError, make_manager, partition_shards)
from repro_torch.config import CheckpointConfig, ParallelConfig, RunConfig, get_smoke_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw
from repro_torch.train import loop as train_loop
from repro_torch.train import step as tstep

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as TW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, LR = 4, 16, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4), "scale": torch.tensor(2.5)},
            "opt_state": [torch.zeros(4, dtype=torch.int32), {"mu": torch.ones(3, 4) * 0.25}]}


def _assert_trees_equal(a, b):
    la, lb = M._leaf_paths(a), M._leaf_paths(b)
    assert sorted(la) == sorted(lb)
    for name in la:
        x, y = torch.as_tensor(la[name]), torch.as_tensor(lb[name])
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x.cpu(), y.cpu()), name


def _files_under(d):
    out = {}
    for root, _, files in os.walk(d):
        for fn in files:
            p = os.path.join(root, fn)
            out[os.path.relpath(p, d)] = p
    return out


def _assert_dirs_identical(d1, d2):
    fa, fb = _files_under(d1), _files_under(d2)
    assert sorted(fa) == sorted(fb)
    for rel in fa:
        assert Path(fa[rel]).read_bytes() == Path(fb[rel]).read_bytes(), rel


def _manifest_of(mgr, step):
    with open(os.path.join(mgr.dir, f"step_{step:08d}", MANIFEST)) as f:
        return json.load(f)


def _gate(monkeypatch):
    """Hold every ``np.save`` until the returned event is set."""
    gate = threading.Event()
    orig = np.save

    def gated(*a, **k):
        gate.wait(timeout=30)
        return orig(*a, **k)
    monkeypatch.setattr(wire.np, "save", gated)
    return gate


# ---------------------------------------------------------------------------
# the same format as the JAX package
# ---------------------------------------------------------------------------

class Opt(NamedTuple):
    step: object
    mu: object
    nu: object
    gnorm_ewma: object


def _numpy_state():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bf = (rng.standard_normal((2, 5)).astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    return {"params": {"w": f(3, 4), "scale": np.float32(2.5), "emb": bf},
            "opt_state": Opt(np.int32(7), {"w": f(3, 4)}, {"w": f(3, 4)}, np.float32(0.5)),
            "list": [np.arange(4, dtype=np.int32), {"nested": np.ones((1,), np.int32)}],
            "a/b": np.float32(3.0)}


def _as_jax(tree):
    emb = tree["params"]["emb"]
    out = jax.tree.map(jnp.asarray, tree)
    out["params"]["emb"] = jax.lax.bitcast_convert_type(jnp.asarray(emb), jnp.bfloat16)
    return out


def _as_torch(tree):
    def conv(name, leaf):
        if name == "params/emb":
            return torch.from_numpy(leaf.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(leaf))
    return M._walk(tree, conv)


@pytest.mark.parametrize("writers,quorum", [(1, None), (3, None), (4, 2)])
def test_step_directory_bit_identical_to_jax(tmp_path, writers, quorum):
    tree = _numpy_state()
    jm = JM.CheckpointManager(str(tmp_path / "jax"), writers=writers, quorum=quorum)
    jm.save(3, _as_jax(tree), extra_meta={"tag": "x"})
    pm = CheckpointManager(str(tmp_path / "port"), writers=writers, quorum=quorum)
    pm.save(3, _as_torch(tree), extra_meta={"tag": "x"})
    _assert_dirs_identical(tmp_path / "jax" / "step_00000003", tmp_path / "port" / "step_00000003")
    meta = _manifest_of(pm, 3)
    assert meta["committed"] == list(range(writers)) and meta["writers"] == writers
    assert meta["manifest"]["params/emb"]["dtype"] == "bfloat16"
    assert meta["manifest"]["params/emb"]["raw"] is True
    assert {"opt_state/.step", "opt_state/.mu/w", "a%2Fb", "list/1/nested"} <= set(
        meta["manifest"])
    _assert_trees_equal(pm.restore(_as_torch(tree))[0], _as_torch(tree))


def test_leaf_wire_matches_jax_and_keeps_zero_dim():
    """A bf16 leaf crossing as its uint16 bits lowers as JAX's ml_dtypes
    leaf does; 0-d leaves stay 0-d; C order is forced."""
    bits = np.arange(6, dtype=np.uint16).reshape(2, 3) + 16256
    wa, info = wire.leaf_wire(bits, "bfloat16")
    ja, jinfo = jwire.leaf_wire(np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(bits),
                                                                        jnp.bfloat16)))
    assert info == jinfo and wa.tobytes() == ja.tobytes() and wa.dtype == ja.dtype
    np.testing.assert_array_equal(wire.lift(wa, info), bits)
    wa, info = wire.leaf_wire(np.float32(2.5))
    assert wa.shape == () and info["shape"] == [] and "raw" not in info
    f_arr = np.asfortranarray(np.arange(12.0, dtype=np.float32).reshape(3, 4))
    wa, info = wire.leaf_wire(f_arr)
    assert wa.flags.c_contiguous and info["shape"] == [3, 4]
    np.testing.assert_array_equal(wa, f_arr)


# ---------------------------------------------------------------------------
# round trips on one device: the one JAX fixture
# ---------------------------------------------------------------------------

def _batch(vocab, i):
    return SyntheticLM(vocab, S, B, seed=3).batch_at(i)


def _jpcfg():
    return JParallel(strategy="hecaton", data=1, model=1, mx=1, my=1, microbatches=2,
                     grad_reduce_dtype="fp32")


def _port_step(cfg_t):
    return tstep.build_train_step(cfg_t, ParallelConfig(microbatches=2, grad_reduce_dtype="fp32"),
                                  RunConfig("t", "train", S, B, lr=LR, warmup_steps=2),
                                  compute_dtype=torch.float32)


def _np_leaves(tree):
    return {k: np.asarray(v) for k, v in JM._leaf_paths(tree).items()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two JAX steps saved at step 2; then JAX restores that checkpoint and
    takes two more steps (their losses and final state)."""
    cfg_j = jax_smoke("qwen3-0.6b")
    params0 = jlm.init_params(cfg_j, jax.random.PRNGKey(1))
    fn = jax.jit(jstep.build_train_step(
        cfg_j, _jpcfg(), JRun("t", "train", S, B, lr=LR, warmup_steps=2), None,
        compute_dtype=jnp.float32))
    p, s = params0, jadamw.init(params0)
    for i in range(2):
        p, s, _ = fn(p, s, {k: jnp.asarray(v) for k, v in _batch(cfg_j.vocab_size, i).items()})
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    JM.CheckpointManager(d).save(2, {"params": p, "opt_state": s})
    saved = _np_leaves({"params": p, "opt_state": s})
    template = {"params": params0, "opt_state": jadamw.init(params0)}
    (state, step) = JM.CheckpointManager(d).restore(template)
    p, s, losses = state["params"], state["opt_state"], []
    for i in (2, 3):
        p, s, m = fn(p, s, {k: jnp.asarray(v) for k, v in _batch(cfg_j.vocab_size, i).items()})
        losses.append(float(m["loss"]))
    return dict(cfg_j=cfg_j, params0=params0, dir=d, step=step, saved=saved, losses=losses,
                final=_np_leaves({"params": p, "opt_state": s}))


def _port_template(params0):
    params = master_params_from_jax(jax.tree.map(np.asarray, params0), device="cpu")
    return {"params": params, "opt_state": adamw.init(params)}


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    cfg_t = get_smoke_config("qwen3-0.6b")
    mgr = CheckpointManager(jax_run["dir"])
    state, step = mgr.restore(_port_template(jax_run["params0"]))
    assert step == jax_run["step"] == 2
    got = M._leaf_paths(state)
    assert sorted(got) == sorted(jax_run["saved"])
    assert {"opt_state/.step", "opt_state/.gnorm_ewma", "opt_state/.mu/embed/table",
            "opt_state/.nu/blocks/mlp/w1"} <= set(got)
    for name, want in jax_run["saved"].items():              # bit for bit
        assert got[name].numpy().dtype == want.dtype and np.array_equal(got[name].numpy(),
                                                                       want), name
    assert int(state["opt_state"].step) == 2
    for t in M._leaf_paths(state["params"]).values():
        t.requires_grad_(True)
    fn = _port_step(cfg_t)
    p, o, losses = state["params"], state["opt_state"], []
    for i in (2, 3):
        p, o, m = fn(p, o, {k: torch.from_numpy(v) for k, v in
                            _batch(cfg_t.vocab_size, i).items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    final = M._leaf_paths({"params": p, "opt_state": o})
    for name, want in jax_run["final"].items():
        got = final[name].detach().numpy()
        if name.startswith("params/"):
            atol = 0.05 * LR
        elif name.startswith(("opt_state/.mu", "opt_state/.nu")):
            atol = 2e-4 * (float(np.abs(want).max()) or 1.0)
        else:
            atol = 1e-5 * abs(float(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


def test_port_checkpoint_restores_in_jax_bit_equal(jax_run, tmp_path):
    cfg_t = get_smoke_config("qwen3-0.6b")
    state = _port_template(jax_run["params0"])
    fn = _port_step(cfg_t)
    p, o = state["params"], state["opt_state"]
    mgr = AsyncCheckpointManager(str(tmp_path), writers=2)
    for i in range(2):
        p, o, _ = fn(p, o, {k: torch.from_numpy(v) for k, v in
                            _batch(cfg_t.vocab_size, i).items()})
    mgr.save_async(2, {"params": p, "opt_state": o})
    mgr.wait_until_finished()
    mgr.close()
    p0 = jax_run["params0"]
    restored, step = JM.CheckpointManager(str(tmp_path)).restore(
        {"params": p0, "opt_state": jadamw.init(p0)})
    assert step == 2
    got = _np_leaves(restored)
    want = {k: v.detach().numpy() for k, v in M._leaf_paths({"params": p, "opt_state": o}).items()}
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name]), name


# ---------------------------------------------------------------------------
# round trips on the grid (untied head)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid_ckpt(tmp_path_factory):
    """The JAX ``ckpt`` reference (a subprocess on a fake 4-device mesh),
    then the two gloo worlds."""
    import subprocess
    tmp = tmp_path_factory.mktemp("grid_ckpt")
    ref, jdir = tmp / "ref.npz", tmp / "jax"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "_jax_grid_ref.py"), "ckpt",
                        str(ref), str(jdir)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    train = TW.run_world((1, 2, 2), TW.ckpt_grid_job, (str(jdir), str(tmp / "grid")))
    resave = TW.run_world((2, 1, 2), TW.ckpt_resave_job, (str(jdir), str(tmp / "resave")))
    return dict(ref=np.load(ref), jax_dir=jdir, grid_dir=tmp / "grid", resave_dir=tmp / "resave",
                train=train, resave=resave)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_grid_resumes_a_jax_checkpoint_untied_head(grid_ckpt):
    z = grid_ckpt["ref"]
    want = z["ckpt/losses"]
    for rank, res in grid_ckpt["train"].items():
        assert res["start"] == int(z["ckpt/start"]) == 1
        assert np.all(np.abs(np.asarray(res["losses"]) - want) <= 1e-5 * np.abs(want)), \
            (rank, res["losses"], want)
    state = grid_ckpt["train"][0]["state"]
    names = [k[len("ckpt/params/"):] for k in z.files if k.startswith("ckpt/params/")]
    assert "lm_head/w" in names
    assert sorted("params/" + n for n in names) == sorted(k for k in state
                                                          if k.startswith("params/"))
    for n in names:
        assert _rel(state["params/" + n], z["ckpt/params/" + n]) <= 1e-5, n


def test_grid_checkpoint_restores_in_jax_bit_equal(grid_ckpt):
    state = grid_ckpt["train"][0]["state"]
    cfg = jax_smoke("paper-llama2-7b")
    p0 = jlm.init_params(cfg, jax.random.PRNGKey(0))
    restored, step = JM.CheckpointManager(str(grid_ckpt["grid_dir"])).restore(
        {"params": p0, "opt_state": jadamw.init(p0)})
    assert step == 3 and int(state["opt_state/.step"]) == 3
    got = _np_leaves(restored)
    assert sorted(got) == sorted(state)
    for name, want in state.items():
        assert got[name].dtype == want.dtype and np.array_equal(got[name], want), name


def test_grid_zero1_parts_resave_as_the_jax_checkpoint(grid_ckpt):
    """On 2x1x2 every moment that ZeRO-1 can split is split over data, and
    the restored blocks and parts, gathered and saved again, give the JAX
    checkpoint's step directory file for file."""
    for rank, res in grid_ckpt["resave"].items():
        assert res["start"] == 1
        split = [n for n, (blk, part) in res["shapes"].items() if blk != part]
        assert "embed/table" in split and "lm_head/w" in split, (rank, res["shapes"])
        for n in split:
            blk, part = res["shapes"][n]
            assert sum(b != q for b, q in zip(blk, part)) == 1 and np.prod(blk) == 2 * np.prod(
                part), n
    _assert_dirs_identical(grid_ckpt["jax_dir"] / "step_00000001",
                           grid_ckpt["resave_dir"] / "step_00000001")


# ---------------------------------------------------------------------------
# the JAX package's checkpoint cases, ported
# ---------------------------------------------------------------------------

def test_async_save_equals_sync_save_bit_for_bit(tmp_path):
    sync = CheckpointManager(str(tmp_path / "sync"))
    asyn = AsyncCheckpointManager(str(tmp_path / "async"))
    sync.save(7, _state(), extra_meta={"tag": "x"})
    asyn.save_async(7, _state(), extra_meta={"tag": "x"})
    asyn.wait_until_finished()
    _assert_dirs_identical(tmp_path / "sync" / "step_00000007",
                           tmp_path / "async" / "step_00000007")
    _assert_trees_equal(asyn.restore(_state())[0], _state())
    asyn.close()


def test_save_async_does_not_block_on_serialization(tmp_path, monkeypatch):
    gate = _gate(monkeypatch)
    mgr = AsyncCheckpointManager(str(tmp_path), max_inflight=1)
    t0 = time.time()
    mgr.save_async(1, _state())
    assert time.time() - t0 < 5           # returned with the writer gated
    assert mgr.all_steps() == []
    gate.set()
    mgr.wait_until_finished()
    assert mgr.all_steps() == [1]
    mgr.close()


def test_save_async_backpressure_bounds_inflight(tmp_path, monkeypatch):
    gate = _gate(monkeypatch)
    mgr = AsyncCheckpointManager(str(tmp_path), max_inflight=1)
    mgr.save_async(1, _state())
    blocked = threading.Event()

    def second():
        mgr.save_async(2, _state())       # must block on the arena slot
        blocked.set()

    t = threading.Thread(target=second, daemon=True)
    t.start()
    assert not blocked.wait(timeout=0.3)
    gate.set()
    assert blocked.wait(timeout=30)
    mgr.wait_until_finished()
    assert mgr.all_steps() == [1, 2]
    mgr.close()


def test_async_snapshot_is_decoupled_from_later_in_place_updates(tmp_path, monkeypatch):
    """The arena owns the bytes: the port's AdamW writes parameters and
    moments in place (``copy_``) right after the boundary save."""
    gate = _gate(monkeypatch)
    params = {"w": torch.arange(8.0, requires_grad=True)}
    opt = adamw.init(params)
    opt.mu["w"].fill_(0.5)
    mgr = AsyncCheckpointManager(str(tmp_path))
    mgr.save_async(1, {"params": params, "opt_state": opt})
    with torch.no_grad():
        params["w"].copy_(torch.full((8,), -1.0))
        opt.mu["w"].copy_(torch.full((8,), -2.0))
        opt.step.copy_(torch.tensor(9, dtype=torch.int32))
    gate.set()
    mgr.wait_until_finished()
    restored, _ = mgr.restore({"params": {"w": torch.zeros(8)},
                               "opt_state": adamw.init({"w": torch.zeros(8)})})
    assert torch.equal(restored["params"]["w"], torch.arange(8.0))
    assert torch.equal(restored["opt_state"].mu["w"], torch.full((8,), 0.5))
    assert int(restored["opt_state"].step) == 0
    mgr.close()


def test_gc_honors_keep_with_inflight_async_saves(tmp_path):
    mgr = AsyncCheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4, 5):
        mgr.save_async(s, _state())
    mgr.wait_until_finished()
    assert mgr.all_steps() == [4, 5]
    assert [w["step"] for w in mgr.writes] == [1, 2, 3, 4, 5]
    mgr.close()


def test_stale_tmp_never_listed_and_swept_on_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _state())
    debris = tmp_path / "step_00000009.tmp"
    debris.mkdir()
    (debris / "leaf_00000.npy").write_bytes(b"garbage")
    assert mgr.all_steps() == [5] and mgr.latest_step() == 5
    mgr2 = CheckpointManager(str(tmp_path))
    assert not debris.exists()
    assert mgr2.all_steps() == [5]


def test_abort_discards_queued_saves_keeps_published(tmp_path, monkeypatch):
    mgr = AsyncCheckpointManager(str(tmp_path), max_inflight=2)
    mgr.save_async(1, _state())
    mgr.wait_until_finished()
    gate = _gate(monkeypatch)
    mgr.save_async(2, _state())           # stuck mid-write
    mgr.save_async(3, _state())           # queued behind it
    threading.Timer(0.2, gate.set).start()
    mgr.abort()
    assert mgr.all_steps() == [1]
    assert not [n for n in os.listdir(str(tmp_path)) if n.endswith(".tmp")]
    monkeypatch.undo()
    mgr.save_async(4, _state())
    mgr.wait_until_finished()
    assert mgr.all_steps() == [1, 4]
    mgr.close()


def _boom(*a, **k):
    raise IOError("disk full")


def test_writer_error_is_sticky_and_abort_clears_it(tmp_path, monkeypatch):
    mgr = AsyncCheckpointManager(str(tmp_path))
    monkeypatch.setattr(wire.np, "save", _boom)
    mgr.save_async(1, _state())
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait_until_finished()
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.save_async(2, _state())       # sticky until fenced
    with pytest.raises(RuntimeError):
        mgr.check_error()
    assert mgr.all_steps() == []
    assert not [n for n in os.listdir(str(tmp_path)) if n.endswith(".tmp")]
    mgr.abort()                           # the fence clears it
    mgr.save_async(3, _state())
    mgr.wait_until_finished()
    assert mgr.all_steps() == [3]
    mgr.close()


def test_roundtrip_tricky_keys_and_dtypes(tmp_path):
    tree = {
        "a__b": torch.tensor(1.0),
        "a": {"b": torch.tensor(2.0), "c%d": torch.arange(3, dtype=torch.int32)},
        "a/b": torch.tensor(3.0),
        "bf16": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
        "f16": torch.tensor([0.5], dtype=torch.float16),
        "bool": torch.tensor([True, False]),
        "step": torch.zeros((), dtype=torch.int32),
        "list": [torch.zeros((2, 2)), {"nested": torch.ones((1,), dtype=torch.int32)}],
        "np": np.arange(3, dtype=np.int64),
    }
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    restored, step = mgr.restore(tree)
    assert step == 1
    _assert_trees_equal(restored, tree)
    assert restored["step"].shape == ()
    meta = _manifest_of(mgr, 1)
    assert meta["complete"] is True and len(meta["manifest"]) == len(M._leaf_paths(tree))
    assert len({v["file"] for v in meta["manifest"].values()}) == len(meta["manifest"])
    for info in meta["manifest"].values():
        assert info["bytes"] > 0 and 0 <= info["crc32"] <= 0xFFFFFFFF


def test_checkpoint_config_validation_and_make_manager(tmp_path):
    ccfg = CheckpointConfig()
    assert ccfg.every == 50 and ccfg.keep == 3 and ccfg.async_
    for bad in (dict(every=0), dict(keep=0), dict(staging="device"), dict(max_inflight=0),
                dict(writers=0), dict(writers=2, quorum=3), dict(writers=2, quorum=0),
                dict(writer_timeout=0), dict(reassign=-1)):
        with pytest.raises(AssertionError):
            CheckpointConfig(**bad)
    m1 = make_manager(str(tmp_path / "a"), CheckpointConfig(async_=False, keep=7))
    assert type(m1) is CheckpointManager and m1.keep == 7
    m2 = make_manager(str(tmp_path / "b"), CheckpointConfig(keep=4))
    assert isinstance(m2, AsyncCheckpointManager) and m2.keep == 4
    assert type(make_manager(str(tmp_path / "c"))) is CheckpointManager
    m4 = make_manager(str(tmp_path / "d"), CheckpointConfig(async_=False, writers=4, quorum=3,
                                                            verify=False))
    assert (m4.writers, m4.quorum, m4.verify) == (4, 3, False)
    m2.close()
    for async_ in (False, True):          # writer processes, with their lease and budget
        m5 = make_manager(str(tmp_path / "e"), CheckpointConfig(
            async_=async_, writer_procs=True, writer_timeout=2.5, reassign=0))
        assert isinstance(m5, AsyncCheckpointManager) == async_
        assert (m5.writer_procs, m5.writer_timeout, m5.reassign) == (True, 2.5, 0)
        m5.close()


def test_staging_sync_degrades_to_blocking_save(tmp_path):
    mgr = AsyncCheckpointManager(str(tmp_path), staging="sync")
    mgr.save_async(3, _state())
    assert mgr.all_steps() == [3]
    mgr.close()


def test_train_loop_uses_async_path_and_drains(tmp_path, monkeypatch):
    calls = []

    class Probe(AsyncCheckpointManager):
        def save_async(self, step, state, extra_meta=None):
            calls.append(step)
            return super().save_async(step, state, extra_meta)

    mgr = Probe(str(tmp_path))
    gate = _gate(monkeypatch)
    threading.Timer(0.2, gate.set).start()

    def ts(params, opt, batch):
        return params, opt, {"loss": torch.tensor(1.0)}

    state = {"params": {"w": torch.zeros(2)}, "opt_state": {}}
    state = train_loop.train(ts, state, iter([{}] * 6), num_steps=6, ckpt=mgr, ckpt_every=2,
                             log_every=100, log_fn=lambda *a: None)
    assert calls == [2, 4, 6] and [s for s, _ in state["save_s"]] == [2, 4, 6]
    assert mgr.all_steps() == [2, 4, 6]   # drained before returning
    mgr.close()


def test_partition_shards_balanced_deterministic_and_pinned():
    sizes = {"a": 100, "b": 90, "c": 10, "d": 10, "e": 5}
    p1 = partition_shards(sizes, 2)
    assert p1 == partition_shards(dict(reversed(list(sizes.items()))), 2)
    assert set(p1) == set(sizes) and set(p1.values()) <= {0, 1}
    loads = [sum(sizes[n] for n, w in p1.items() if w == i) for i in (0, 1)]
    assert max(loads) <= 2 * min(loads)
    assert p1 == JM.partition_shards(sizes, 2)
    pinned = partition_shards(sizes, 3, writer_map=lambda n: 2 if n == "a" else None)
    assert pinned["a"] == 2 and set(pinned.values()) <= {0, 1, 2}


def test_multiwriter_more_writers_than_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), writers=4)
    mgr.save(1, {"w": torch.arange(4.0)})
    assert _manifest_of(mgr, 1)["committed"] == [0, 1, 2, 3]
    _assert_trees_equal(mgr.restore({"w": torch.zeros(4)})[0], {"w": torch.arange(4.0)})


def test_writer_death_in_torn_window_never_publishes(tmp_path):
    def kill_w1(step, writer):
        if writer == 1:
            raise RuntimeError("injected writer death")

    mgr = CheckpointManager(str(tmp_path), writers=2, writer_fault=kill_w1)
    with pytest.raises(QuorumError, match="injected writer death"):
        mgr.save(5, _state())
    assert mgr.all_steps() == [] and os.listdir(str(tmp_path)) == []
    mgr.writer_fault = None
    mgr.save(6, _state())
    assert mgr.all_steps() == [6]
    _assert_trees_equal(mgr.restore(_state())[0], _state())


def test_quorum_tolerates_dead_zero_shard_writer_only(tmp_path):
    state = {"w": torch.arange(4.0)}          # one leaf: writers 1..3 hold none

    def kill(victim):
        def fault(step, writer):
            if writer == victim:
                raise RuntimeError(f"writer {victim} died")
        return fault

    mgr = CheckpointManager(str(tmp_path / "a"), writers=4, quorum=3, writer_fault=kill(3))
    mgr.save(1, state)
    meta = _manifest_of(mgr, 1)
    assert meta["committed"] == [0, 1, 2] and meta["failed_writers"] == [3]
    _assert_trees_equal(mgr.restore(state)[0], state)
    mgr2 = CheckpointManager(str(tmp_path / "b"), writers=4, quorum=3, writer_fault=kill(0))
    with pytest.raises(QuorumError, match="shards uncovered"):
        mgr2.save(1, state)
    assert mgr2.all_steps() == []


def test_async_writer_death_sticky_then_fenced(tmp_path):
    boom = {"on": True}

    def kill(step, writer):
        if boom["on"] and writer == 1:
            raise RuntimeError("injected writer death")

    mgr = AsyncCheckpointManager(str(tmp_path), writers=2, writer_fault=kill)
    mgr.save_async(1, _state())
    with pytest.raises(RuntimeError, match="injected writer death"):
        mgr.wait_until_finished()
    boom["on"] = False
    mgr.abort()
    mgr.save_async(2, _state())
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2]
    mgr.close()


@pytest.mark.parametrize("damage", ["bitflip", "truncate"])
def test_damaged_shard_fails_restore_naming_file(tmp_path, damage):
    mgr = CheckpointManager(str(tmp_path), writers=2)
    mgr.save(1, _state())
    info = _manifest_of(mgr, 1)["manifest"]["params/w"]
    victim = os.path.join(mgr.dir, "step_00000001", info["file"])
    blob = bytearray(Path(victim).read_bytes())
    if damage == "bitflip":
        blob[-1] ^= 0x01
    else:
        blob = blob[:len(blob) // 2]
    Path(victim).write_bytes(bytes(blob))
    with pytest.raises(CheckpointCorruptionError,
                       match="crc32" if damage == "bitflip" else "truncated") as ei:
        mgr.restore(_state())
    assert info["file"] in str(ei.value)
    if damage == "bitflip":                   # verify=False opts out
        CheckpointManager(str(tmp_path), writers=2, verify=False).restore(_state())


def test_torn_or_truncated_manifests_exclude_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    mgr.save(2, _state())
    g2 = os.path.join(mgr.dir, "step_00000002", MANIFEST)
    blob = Path(g2).read_bytes()
    Path(g2).write_bytes(blob[:len(blob) // 3])
    torn = tmp_path / "step_00000007" / "writer_00"
    torn.mkdir(parents=True)
    (torn / "leaf_00000.npy").write_bytes(b"\x93NUMPY...")
    (torn / "manifest.json").write_text('{"writer": 0, "shards": {"x"')
    (tmp_path / "README.txt").write_text("not a checkpoint")
    (tmp_path / "step_junk").mkdir()
    (tmp_path / "step_00000042").write_text("a FILE squatting on the name")
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    restored, step = mgr.restore(_state())
    assert step == 1
    _assert_trees_equal(restored, _state())
    mgr2 = CheckpointManager(str(tmp_path))
    assert mgr2.all_steps() == [1]
    assert not (tmp_path / "step_00000007").exists()
    assert not (tmp_path / "step_00000002").exists()
    assert (tmp_path / "README.txt").exists() and (tmp_path / "step_junk").exists()


def test_gc_survives_foreign_files_and_leaves_no_half_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1)
    (tmp_path / "notes.md").write_text("x")
    for s in (1, 2, 3):
        mgr.save(s, _state())
    assert mgr.all_steps() == [3]
    assert [d for d in os.listdir(str(tmp_path))
            if d.startswith("step_") and not d.endswith(".tmp")] == ["step_00000003"]


@pytest.mark.parametrize("body", ["[1, 2, 3]", '"complete"', "null"])
def test_non_dict_manifests_are_not_steps(tmp_path, body):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    d = tmp_path / "step_00000002"
    d.mkdir()
    (d / MANIFEST).write_text(body)
    assert M.manifest_complete(str(d)) is False
    assert mgr.all_steps() == [1]
    assert mgr.restore(_state())[1] == 1
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore(_state(), step=2)         # explicit step: a typed error
    assert CheckpointManager(str(tmp_path)).all_steps() == [1]
    assert sorted(d for d in os.listdir(str(tmp_path)) if d.startswith("step_")) == \
        ["step_00000001"]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

SMOKE = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16", "--microbatches", "2"]


def _run(argv):
    lines = []
    r = launch_train.run(launch_train.parser().parse_args(SMOKE + argv), log_fn=lines.append)
    return r, lines


def test_launcher_resumes_bit_exact(tmp_path):
    d = str(tmp_path / "ck")
    first, _ = _run(["--steps", "2", "--ckpt-dir", d, "--ckpt-every", "2"])
    assert [s for s, _ in first["ckpt"]["save_s"]] == [2]
    resumed, lines = _run(["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2"])
    assert "restored checkpoint at step 2" in lines
    assert resumed["ckpt"]["start"] == 2 and [s for s, _ in resumed["history"]] == [2, 3]
    whole, _ = _run(["--steps", "4"])
    assert resumed["history"][-1][1] == whole["history"][-1][1]
    assert resumed["history"] == whole["history"][2:]


@pytest.mark.parametrize("refused", ["--ckpt-procs", "--ckpt-writer-timeout", "blocklist"])
def test_launcher_refuses_the_runtime_it_lacks(tmp_path, refused):
    """These three once raised, before the training runtime was ported:
    each now runs and publishes its step; a blocklist moves the data."""
    argv = ["--steps", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    if refused == "blocklist":
        (tmp_path / launch_train.BLOCKLIST).write_text('{"data_indices": [0]}')
    else:
        argv += [refused] + (["5"] if refused == "--ckpt-writer-timeout" else [])
    r, lines = _run(argv)
    assert [d for d in os.listdir(str(tmp_path)) if d.startswith("step_")] == ["step_00000001"]
    assert r["first_data_index"] == (1 if refused == "blocklist" else 0)
    assert r["ckpt"]["handover"] == ("shm" if refused == "--ckpt-procs" else None)
