"""The pod axis as data parallelism (``--pods N --pod-role data``) against
the JAX package, on the CPU in fp32.

The fixture writes the qwen3-0.6b smoke config's initial parameters
(``repro.models.lm.init_params``) to an npz, starts one JAX subprocess
(this file run as a script, on 8 fake CPU devices, LLVM at -O0) and
meanwhile runs the port's gloo world of 2 pods x (1x1x2) ranks.  The
port runs the pod role ``data`` as one pod of pods * data data ranks
(``launch/train._grid_shape``): ranks row-major over (pod, data, mx, my),
as ``make_small_mesh(..., pods=2)`` reshapes its devices, are the ranks
of that grid, and the pod-major index over ``("pod", "data")`` is its
data index.  So:

* one and two fp32 optimizer steps of ``build_train_step`` on the
  ``("pod", "data", "mx", "my")`` mesh (the pod role ``data``: the batch
  over ``("pod", "data")``, ZeRO-1 moments over both) under overlap
  ``none`` and ``fused``: the loss and the grad norm within 1e-5, and
  every parameter after each step within 1e-5 relative in norm
  (``tests/test_torch_grid.py``'s measure: AdamW's first steps divide by
  sqrt(v) + eps, so an element whose gradient is near eps moves with
  the order of the fp32 sums);
* the fused run's state saved by rank 0 through ``checkpoint/grid.py``
  and restored on one device: parameters and AdamW moments within 1e-5
  of JAX's after the same two steps;
* the layouts: each leaf's ZeRO-1 moment spec against
  ``repro.parallel.specs.opt_state_specs`` on a 2x(2x1x2) mesh (JAX's
  ``("pod", "data")`` read as the folded ``data``), and the rows and
  tokens of a batch each rank holds against JAX's ``devices_indices_map``
  for ``batch_specs``; the folded data groups against the device
  reshape; and the launcher's pod-data run.
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

TOL = dict(rtol=1e-5, atol=1e-5)
LEAF_TOL = 1e-5                                # |port - jax| / |jax| per leaf


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
OVERLAPS = ("none", "fused")
TRAIN = dict(B=4, S=16, steps=2, lr=1e-3, microbatches=2)
WORLD = (2, (1, 1, 2))                         # pods, (data, mx, my)
LAYOUT = (2, (2, 1, 2))                        # the specs' grid (no step runs on it)


# ---------------------------------------------------------------------------
# the JAX side (this file run as a script)
# ---------------------------------------------------------------------------

def _jax_pcfg(ov, pods, shape):
    from repro.config import ParallelConfig
    d, mx, my = shape
    return ParallelConfig(strategy="hecaton", data=d, model=mx * my, mx=mx, my=my, pods=pods,
                          pod_axis_role="data", overlap=ov,
                          microbatches=TRAIN["microbatches"], grad_reduce_dtype="fp32",
                          remat="none")


def _spec_list(spec):
    return [None if e is None else (list(e) if isinstance(e, tuple) else e) for e in spec]


def _jax_main(inp, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.config import RunConfig, get_smoke_config
    from repro.data.synthetic import SyntheticLM
    from repro.launch.mesh import make_small_mesh
    from repro.optim import adamw
    from repro.parallel import specs as SP
    from repro.train import step as TS

    z = np.load(inp)
    params0 = jax.tree.map(jnp.asarray, TW._np_tree(z, "init/"))
    cfg = get_smoke_config("qwen3-0.6b")
    rc = RunConfig("t", "train", TRAIN["S"], TRAIN["B"], lr=TRAIN["lr"], warmup_steps=1)
    ds = SyntheticLM(cfg.vocab_size, TRAIN["S"], TRAIN["B"])
    res = {}
    pods, shape = WORLD
    mesh = make_small_mesh("hecaton", *shape, pods=pods)
    for ov in OVERLAPS:
        pcfg = _jax_pcfg(ov, pods, shape)
        pspecs = SP.param_specs(params0, mesh, pcfg)
        params = jax.device_put(params0, SP.sharding_tree(pspecs, mesh))
        opt = jax.device_put(adamw.init(params0), SP.sharding_tree(
            SP.opt_state_specs(pspecs, params0, mesh, pcfg), mesh))
        bspec = SP.sharding_tree(SP.batch_specs(mesh, pcfg, microbatched=False,
                                                seq_len=TRAIN["S"]), mesh)
        step = jax.jit(TS.build_train_step(cfg, pcfg, rc, mesh, compute_dtype=jnp.float32))
        for s in range(TRAIN["steps"]):
            batch = jax.device_put({k: jnp.asarray(v) for k, v in ds.batch_at(s).items()},
                                   bspec)
            params, opt, met = step(params, opt, batch)
            key = f"{ov}/{s}"
            res[f"{key}/loss"] = np.asarray(met["loss"])
            res[f"{key}/grad_norm"] = np.asarray(met["grad_norm"])
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]:
                res[f"{key}/params/" + "/".join(str(getattr(k, "key", k)) for k in kp)] = \
                    np.asarray(v)
        for name, tree in (("mu", opt.mu), ("nu", opt.nu)):
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
                res[f"{ov}/final/{name}/" + "/".join(str(getattr(k, "key", k)) for k in kp)] = \
                    np.asarray(v)
    # the layouts on 2 x (2 x 1 x 2)
    lpods, lshape = LAYOUT
    lmesh = make_small_mesh("hecaton", *lshape, pods=lpods)
    lpcfg = _jax_pcfg("none", lpods, lshape)
    pspecs = SP.param_specs(params0, lmesh, lpcfg)
    mspecs = SP.opt_state_specs(pspecs, params0, lmesh, lpcfg)
    for kp, spec in jax.tree_util.tree_flatten_with_path(
            mspecs.mu, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        res["layout/moment/" + "/".join(str(getattr(k, "key", k)) for k in kp)] = np.asarray(
            repr(_spec_list(spec)))
    bs = SP.batch_specs(lmesh, lpcfg, microbatched=False, seq_len=TRAIN["S"])
    imap = NamedSharding(lmesh, bs["tokens"]).devices_indices_map((8, TRAIN["S"]))
    res["layout/batch"] = np.asarray([[d.id, sl[0].start or 0, sl[0].stop or 8,
                                       sl[1].start or 0, sl[1].stop or TRAIN["S"]]
                                      for d, sl in sorted(imap.items(), key=lambda t: t[0].id)])
    res["layout/devices"] = np.asarray([d.id for d in lmesh.devices.reshape(-1)])
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# the port's side (the rank processes)
# ---------------------------------------------------------------------------

def pod_job(grid, in_path, ckpt_dir):
    """Two steps under each overlap mode on this rank's blocks; the fused
    run's state is then saved by rank 0.  Returns each step's loss and
    grad norm, and (rank 0) the gathered parameters after each step."""
    from repro_torch import bridge
    from repro_torch.checkpoint import grid as CG
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config import ParallelConfig, RunConfig, get_smoke_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.parallel import specs
    from repro_torch.train import step as TS

    tree = TW._np_tree(np.load(in_path), "init/")
    cfg = get_smoke_config("qwen3-0.6b")
    rc = RunConfig("t", "train", TRAIN["S"], TRAIN["B"], lr=TRAIN["lr"], warmup_steps=1)
    ds = SyntheticLM(cfg.vocab_size, TRAIN["S"], TRAIN["B"])
    nm = TRAIN["microbatches"]
    out = {}
    for ov in OVERLAPS:
        pcfg = ParallelConfig(data=grid.data, mx=grid.mx, my=grid.my, overlap=ov,
                              microbatches=nm, grad_reduce_dtype="fp32",
                              remat="none")
        params = bridge.shard_master_params_from_jax(tree, grid, device="cpu")
        opt = TS.init_grid_opt_state(params, grid, pcfg)
        step = TS.build_train_step(cfg, pcfg, rc, compute_dtype=torch.float32, mesh=grid)
        for s in range(TRAIN["steps"]):
            lb = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in specs.local_batch(ds.batch_at(s), grid, nm).items()}
            params, opt, met = step(params, opt, lb)
            full = bridge.gather_master_params(params, grid)
            out[f"{ov}/{s}"] = dict(
                loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                params={"/".join(p): t.numpy().copy() for p, t in lm.flatten(full)}
                if grid.rank == 0 else None)
        if ov == "fused":
            ck = CG.GridCheckpointer(CheckpointManager(ckpt_dir) if grid.rank == 0 else None,
                                     grid, pcfg)
            ck.save_async(TRAIN["steps"], {"params": params, "opt_state": opt})
            ck.wait_until_finished()
            ck.close()
    return out


# ---------------------------------------------------------------------------
# the fixture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    import jax
    from repro.config import get_smoke_config as jax_smoke
    from repro.models import lm as jlm
    d = tmp_path_factory.mktemp("pod_data")
    inputs, ref_path, ckpt_dir = d / "inputs.npz", d / "jax.npz", d / "ckpt"
    params0 = jlm.init_params(jax_smoke("qwen3-0.6b"), jax.random.PRNGKey(0))
    np.savez(inputs, **{"init/" + "/".join(str(getattr(k, "key", k)) for k in kp):
                        np.asarray(v)
                        for kp, v in jax.tree_util.tree_flatten_with_path(params0)[0]})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_backend_optimization_level=0")
    proc = subprocess.Popen([sys.executable, __file__, str(inputs), str(ref_path)], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        world = TW.run_world(_folded(*WORLD), pod_job, (str(inputs), str(ckpt_dir)))
        err = proc.communicate(timeout=900)[1]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    return SimpleNamespace(ref=dict(np.load(ref_path)), world=world, ckpt_dir=str(ckpt_dir),
                           inputs=np.load(inputs))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

CASES = [(ov, s) for ov in OVERLAPS for s in range(TRAIN["steps"])]


@pytest.mark.parametrize("ov,s", CASES, ids=[f"{ov}-step{s + 1}" for ov, s in CASES])
def test_pod_data_step_matches_jax(pod, ov, s):
    """Every rank reports JAX's loss and grad norm within 1e-5; rank 0's
    gathered parameters after the step are within 1e-5 of JAX's (relative,
    per leaf)."""
    key = f"{ov}/{s}"
    for rank, res in sorted(pod.world.items()):
        got = res[key]
        np.testing.assert_allclose(got["loss"], pod.ref[f"{key}/loss"], err_msg=f"rank {rank}",
                                   **TOL)
        np.testing.assert_allclose(got["grad_norm"], pod.ref[f"{key}/grad_norm"],
                                   err_msg=f"rank {rank}", **TOL)
    params = pod.world[0][key]["params"]
    names = sorted(k[len(key) + 8:] for k in pod.ref if k.startswith(f"{key}/params/"))
    assert sorted(params) == names
    for name in names:
        assert _rel(params[name], pod.ref[f"{key}/params/{name}"]) < LEAF_TOL, name


def test_pod_data_ranks_agree(pod):
    """Every rank reports the same loss and grad norm at every step."""
    for key in pod.world[0]:
        vals = {(r[key]["loss"], r[key]["grad_norm"]) for r in pod.world.values()}
        assert len(vals) == 1, (key, vals)


def test_pod_data_checkpoint_restores_on_one_device(pod):
    """The 2x(1x1x2) fused run's checkpoint (rank 0 writes global leaves)
    restores on one device: parameters and both AdamW moments within 1e-5
    relative (per leaf) of JAX's after the same two steps, and the step
    count is 2."""
    from repro_torch import bridge
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    tree = TW._np_tree(pod.inputs, "init/")
    params = bridge.master_params_from_jax(tree, device="cpu")
    state, step = CheckpointManager(pod.ckpt_dir).restore(
        {"params": params, "opt_state": adamw.init(params)})
    assert step == TRAIN["steps"]
    assert int(state["opt_state"].step) == TRAIN["steps"]
    last = f"fused/{TRAIN['steps'] - 1}"
    for path, t in lm.flatten(state["params"]):
        name = "/".join(path)
        assert _rel(t.detach().numpy(), pod.ref[f"{last}/params/{name}"]) < LEAF_TOL, name
    for kind in ("mu", "nu"):
        for path, t in lm.flatten(getattr(state["opt_state"], kind)):
            name = "/".join(path)
            assert _rel(t.numpy(), pod.ref[f"fused/final/{kind}/{name}"]) < LEAF_TOL, \
                (kind, name)


# ---------------------------------------------------------------------------
# the layouts
# ---------------------------------------------------------------------------

def _folded(pods, shape):
    """The (data, mx, my) the launcher gives the ranks of ``pods`` x
    ``shape`` under the pod role ``data``."""
    from repro_torch.launch import train as launch_train
    d, mx, my = shape
    data, one = launch_train._grid_shape(SimpleNamespace(data=d, pods=pods, pod_role="data"))
    assert one == 1
    return data, mx, my


def _layout_grid(rank=0):
    from repro_torch.launch.mesh import Grid
    return Grid(*_folded(*LAYOUT), rank)


def _fold_spec(spec):
    """JAX's spec with the pair ``("pod", "data")`` read as the folded data
    axis."""
    out = []
    for e in spec:
        if isinstance(e, list) and "pod" in e:
            e = [a for a in e if a != "pod"]
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return out


def test_pod_data_moment_specs_match_jax(pod):
    """``zero.state_spec`` over the folded data axis gives each leaf the
    moment spec ``repro.parallel.specs.opt_state_specs`` gives it over
    ``("pod", "data")``, the pair read as that one axis."""
    from repro_torch import bridge
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import specs, zero
    grid = _layout_grid()
    ax = shd.axis_info(grid)
    assert ax.data_axes == ("data",) and ax.n_data == 4
    full = bridge.master_params_from_jax(TW._np_tree(pod.inputs, "init/"), device="cpu")
    names = set()
    for path, t in lm.flatten(full):
        spec = specs.leaf_spec(path, t.dim(), ax)
        got = zero.state_spec(spec, t.shape, ax.data_axes, grid.sizes)
        got = list(got) + [None] * (t.dim() - len(got))
        want = _fold_spec(eval(str(pod.ref["layout/moment/" + "/".join(path)])))
        want = want + [None] * (t.dim() - len(want))
        assert _spec_norm(got) == want, path
        names.add("/".join(path))
    assert names == {k[len("layout/moment/"):] for k in pod.ref if k.startswith("layout/moment/")}


def _spec_norm(spec):
    return [None if e is None else (list(e) if isinstance(e, tuple) else e) for e in spec]


@pytest.mark.parametrize("rank", range(8))
def test_pod_data_batch_block_matches_jax(pod, rank):
    """Rank r's block of a global [8, 16] batch (``specs.local_batch``) is
    the rows and tokens JAX's ``batch_specs`` puts on device r."""
    from repro_torch.parallel import specs
    grid = _layout_grid(rank)
    ids = np.arange(8 * TRAIN["S"]).reshape(8, TRAIN["S"])
    got = specs.local_batch({"tokens": ids}, grid, 1)["tokens"]
    dev, r0, r1, c0, c1 = pod.ref["layout/batch"][rank]
    assert dev == rank
    np.testing.assert_array_equal(got, ids[r0:r1, c0:c1])


@pytest.mark.parametrize("pods,shape", [(2, (1, 1, 2)), (2, (2, 1, 2)), (3, (2, 2, 1)),
                                        (2, (1, 2, 2))])
def test_pod_data_fold_follows_device_reshape(pods, shape):
    """On the folded grid, every rank's data group is the devices that
    share its (mx, my) in ``devs.reshape(pods, data, mx, my)``, pod-major,
    and its data index is ``pod * data + data``: the shard order of JAX's
    ``P(("pod", "data"))``."""
    from repro_torch.launch.mesh import Grid
    d, mx, my = shape
    devs = np.arange(pods * d * mx * my).reshape(pods, d, mx, my)
    for r in range(devs.size):
        g = Grid(*_folded(pods, shape), r)
        p, dd, x, y = (int(i) for i in np.argwhere(devs == r)[0])
        assert g.axis_ranks("data") == devs[:, :, x, y].reshape(-1).tolist()
        assert g.axis_index("data") == p * d + dd
        assert g.size("data") == pods * d


def test_pipeline_role_keeps_the_pods():
    """Only the pod role ``data`` folds: under ``pipeline`` the grid keeps
    its pods (one 1F1B stage each) and its data axis."""
    from repro_torch.launch import train as launch_train
    ns = SimpleNamespace(data=2, pods=3, pod_role="pipeline")
    assert launch_train._grid_shape(ns) == (2, 3)
    assert launch_train._grid_shape(SimpleNamespace(data=2, pods=3, pod_role="data")) == (6, 1)


def test_pod_data_launcher_runs_as_one_pod_of_twice_the_data():
    """``--pods 2 --pod-role data --mx 1 --my 2`` trains (no refusal), and
    its losses equal those of ``--data 2 --mx 1 --my 2``, the same ranks
    dealt the same rows."""
    from repro_torch.launch import train as launch_train
    base = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
            "--mx", "1", "--my", "2", "--microbatches", "2"]
    lines = []
    pod_run = launch_train.run(launch_train.parser().parse_args(
        base + ["--pods", "2", "--pod-role", "data"]), log_fn=lines.append)
    assert any(line.startswith("grid[2x1x1x2] final loss") for line in lines), lines
    data_run = launch_train.run(launch_train.parser().parse_args(base + ["--data", "2"]),
                                log_fn=lambda *_: None)
    assert pod_run["world"] == 4
    assert [h[1] for h in pod_run["history"]] == [h[1] for h in data_run["history"]]


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
