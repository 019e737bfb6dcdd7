"""JAX references for the port's grid tests, on a fake 4-device CPU mesh.

Run as a script in its own process (the device count is fixed when JAX
starts):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_grid_ref.py ring OUT.npz
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_grid_ref.py grid OUT.npz
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_grid_ref.py qhop OUT.npz
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_grid_ref.py ckpt OUT.npz CKPT_DIR

``ring``: the four ring ops of ``repro.kernels.ring_matmul`` under
``shard_map`` on a (1, 2, 2) mesh, fp32, forward and the gradients of
``sum(out * ct)``, at a tile-aligned and a ragged shape on the bf16
wire, and at those and two wide ones on the int8 wire
(``comm_dtype="int8"``, keys ``int8/...``).
``grid``: the hecaton ops of ``repro.core.hecaton`` (forward and
gradients) under each variant (an overlap mode, ``-int8`` for the int8
wire), and two steps of ``repro.train.step.build_train_step`` on the
qwen3-0.6b smoke config in fp32 for the (1, 2, 2) and (2, 1, 2) meshes
under each variant.
``qhop``: one quantized ring hop (``repro.core.quant.ring_hop`` with
``comm_dtype="int8"``) on a ring of two, shift +1 and -1, fp32 and bf16
shards (wide rows, a zero row, a narrow shard that stays full width),
forward and the gradient of ``sum(out * ct)``.
``ckpt``: one fp32 step of the untied paper-llama2-7b smoke config with
``mesh=None``, saved at step 1 into CKPT_DIR by
``repro.checkpoint.manager.CheckpointManager``; then that checkpoint
restored onto the (1, 2, 2) mesh (``shardings`` from the param and ZeRO-1
specs) and two more steps of ``build_train_step`` there (``overlap``
fused): their losses and the final parameters.
Inputs come from numpy with fixed seeds; every array lands in the npz.
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402

# overlap mode, and "-int8" for comm_dtype="int8"
VARIANTS = ("none", "ring", "fused", "bidir", "ring-int8", "bidir-int8", "fused-int8")
WIRES = ("bf16", "int8")
MESHES = ((1, 2, 2), (2, 1, 2))
# ring-op cases: (name, B, T, H, O); T, H, O split over two ranks twice.
# The bf16 wire runs the first two; the int8 wire all four: at the first
# two most hopped shards are narrower than quant.MIN_QUANT_DIM and cross
# full width, at the wide ones every hopped shard crosses as int8
RING_SHAPES = (("aligned", 2, 16, 32, 48), ("ragged", 2, 12, 20, 28),
               ("wide", 2, 16, 64, 96), ("wide_ragged", 2, 12, 36, 68))
BF16_RING_SHAPES = ("aligned", "ragged")


def _mesh(d, mx, my):
    return Mesh(np.array(jax.devices()[:d * mx * my]).reshape(d, mx, my), ("data", "mx", "my"))


def _put(mesh, a, spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))


def _vjp(mesh, f, in_specs, out_specs, args, cts):
    """Forward outputs and the gradients of sum(out * ct) w.r.t. args."""
    g = jax.jit(compat.shard_map(f, mesh, in_specs, out_specs))
    sargs = [_put(mesh, a, s) for a, s in zip(args, in_specs)]
    out, vjp = jax.vjp(g, *sargs)
    outs = out if isinstance(out, tuple) else (out,)
    cts = tuple(jnp.asarray(c) for c in cts)
    grads = vjp(cts if isinstance(out, tuple) else cts[0])
    return [np.asarray(o) for o in outs], [np.asarray(x) for x in grads]


# ring-op cases: the in/out specs give every rank its own block of each
# input and a distinct block of each output
RING_CASES = {
    "ag_matmul": dict(ins=(P(None, "mx", "my"), P("my", "mx")),
                      outs=(P(None, None, ("my", "mx")),), axis="mx"),
    "matmul_rs_tokens": dict(ins=(P(None, "mx", "my"), P("my", "mx")),
                             outs=(P(None, ("mx", "my"), None),), axis="my"),
    "matmul_rs_cols": dict(ins=(P(None, "mx", "my"), P("my", "mx")),
                           outs=(P(None, "mx", "my"),), axis="my"),
    "ag_matmul_contract": dict(ins=(P(None, "mx", "my"), P(None, ("mx", "my"))),
                               outs=(P(None, None, ("mx", "my")),), axis="my"),
    "matmul_rs_pair": dict(ins=(P(None, "mx", "my"), P("my", "mx"), P("my", "mx")),
                           outs=(P(None, ("mx", "my"), None),) * 2, axis="my"),
}


def ring_inputs(name, B, T, H, O, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    w = (rng.standard_normal((H, O)) / np.sqrt(H)).astype(np.float32)
    if name == "ag_matmul_contract":
        w = (rng.standard_normal((H, 2 * O)) / np.sqrt(H)).astype(np.float32)
    args = [x, w]
    if name == "matmul_rs_pair":
        args.append((rng.standard_normal((H, O)) / np.sqrt(H)).astype(np.float32))
    return args


def ring_out_shapes(name, B, T, H, O):
    """Global shapes of the outputs under RING_CASES' out specs."""
    if name == "ag_matmul":
        return [(B, T, 2 * O)]                   # 4 blocks of [B, T, O/2]
    if name == "matmul_rs_tokens":
        return [(B, T, O // 2)]
    if name == "matmul_rs_cols":
        return [(B, T, O // 2)]
    if name == "ag_matmul_contract":
        return [(B, T // 2, 2 * O)]
    return [(B, T, O // 2)] * 2


def variant(v):
    """(overlap, comm_dtype) of a variant name."""
    mode, _, wire = v.partition("-")
    return mode, wire or "bf16"


def run_ring(out_path):
    from repro.kernels import ring_matmul as RM
    mesh = _mesh(1, 2, 2)

    def fns(cd):
        return {
            "ag_matmul": lambda x, w: RM.ag_matmul(x, w, "mx", dim=1, n=2, comm_dtype=cd),
            "matmul_rs_tokens": lambda x, w: RM.matmul_rs(x, w, "my", scatter_dim=1, n=2,
                                                          comm_dtype=cd),
            "matmul_rs_cols": lambda x, w: RM.matmul_rs(x, w, "my", scatter_dim=2, n=2,
                                                        comm_dtype=cd),
            "ag_matmul_contract": lambda x, w: RM.ag_matmul_contract(x, w, "my", n=2,
                                                                     comm_dtype=cd),
            "matmul_rs_pair": lambda x, w1, w1b: RM.matmul_rs_pair(
                x, w1, w1b, "my", scatter_dim=1, n=2, comm_dtype=cd),
        }
    res = {}
    for k, (shape_name, B, T, H, O) in enumerate(RING_SHAPES):
        for j, (name, case) in enumerate(RING_CASES.items()):
            args = ring_inputs(name, B, T, H, O, 100 * k + j)
            rng = np.random.default_rng(1000 + 100 * k + j)
            cts = [rng.standard_normal(s).astype(np.float32)
                   for s in ring_out_shapes(name, B, T, H, O)]
            key = f"{shape_name}/{name}"
            for i, a in enumerate(args):
                res[f"{key}/in{i}"] = a
            for i, c in enumerate(cts):
                res[f"{key}/ct{i}"] = c
            for cd in WIRES:
                if cd == "bf16" and shape_name not in BF16_RING_SHAPES:
                    continue
                outs, grads = _vjp(mesh, fns(cd)[name], case["ins"], case["outs"][0]
                                   if len(case["outs"]) == 1 else case["outs"], args, cts)
                wkey = key if cd == "bf16" else f"int8/{key}"
                for i, o in enumerate(outs):
                    res[f"{wkey}/out{i}"] = o
                for i, g in enumerate(grads):
                    res[f"{wkey}/grad{i}"] = g
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# hecaton ops and training steps
# ---------------------------------------------------------------------------

OP_SHAPE = dict(B=2, T=16, H=32, O=48, V=64)


def op_inputs(seed=7):
    s = OP_SHAPE
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    return dict(x=f(s["B"], s["T"], s["H"]), w=f(s["H"], s["O"], scale=s["H"] ** -0.5),
                w2=f(s["O"], s["H"], scale=s["O"] ** -0.5),
                w1b=f(s["H"], s["O"], scale=s["H"] ** -0.5),
                a=f(s["B"], s["T"], s["O"]),
                wo=f(s["O"], s["H"], scale=s["O"] ** -0.5),
                table=f(s["V"], s["H"], scale=0.5),
                ids=rng.integers(0, s["V"], size=(s["B"], s["T"])).astype(np.int32),
                head=f(s["H"], s["V"], scale=s["H"] ** -0.5),
                labels=rng.integers(0, s["V"], size=(s["B"], s["T"])).astype(np.int32),
                mask=(rng.random((s["B"], s["T"])) > 0.2).astype(np.float32))


def run_ops(res):
    from repro.core import hecaton as H
    mesh = _mesh(1, 2, 2)
    inp = op_inputs()
    rng = np.random.default_rng(11)
    for var in VARIANTS:
        mode, cd = variant(var)
        kw = dict(mesh=mesh, t_ax="mx", h_ax="my", overlap=mode, comm_dtype=cd)
        cases = {
            "linear_seq_scatter": (lambda x, w: H.linear_seq_scatter(x, w, **kw), ("x", "w")),
            "mixer_in": (lambda x, w: H.mixer_in(x, w, **kw), ("x", "w")),
            "mixer_out": (lambda a, wo: H.mixer_out(a, wo, **kw), ("a", "wo")),
            "ffn_block": (lambda x, w, w2, w1b: H.ffn_block(
                x, w, w2, act_fn=jax.nn.silu, w1b=w1b, **kw), ("x", "w", "w2", "w1b")),
            "embed_2d": (lambda table: H.embed_2d(
                jnp.asarray(inp["ids"]), table, compute_dtype=jnp.float32, **kw),
                ("table",)),
            "fused_lm_loss": (lambda x, head: jnp.stack(H.fused_lm_loss(
                x, head, jnp.asarray(inp["labels"]), jnp.asarray(inp["mask"]), **kw)),
                ("x", "head")),
        }
        for name, (fn, names) in cases.items():
            args = [jnp.asarray(inp[k]) for k in names]
            out, vjp = jax.vjp(jax.jit(fn), *args)
            ct = rng.standard_normal(out.shape).astype(np.float32)
            grads = vjp(jnp.asarray(ct))
            res[f"op/{var}/{name}/out"] = np.asarray(out)
            res[f"op/{var}/{name}/ct"] = ct
            for k, g in zip(names, grads):
                res[f"op/{var}/{name}/grad_{k}"] = np.asarray(g)
    for k, v in inp.items():
        res[f"op/in/{k}"] = v


TRAIN = dict(B=4, S=16, steps=2, lr=1e-3, microbatches=2)


def run_train(res):
    from repro.config import ParallelConfig, RunConfig, get_smoke_config
    from repro.data.synthetic import SyntheticLM
    from repro.launch.mesh import make_small_mesh
    from repro.models import lm
    from repro.optim import adamw
    from repro.parallel import specs as SP
    from repro.train import step as TS

    cfg = get_smoke_config("qwen3-0.6b")
    params0 = lm.init_params(cfg, jax.random.PRNGKey(0))
    flat0 = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
             for kp, v in jax.tree_util.tree_flatten_with_path(params0)[0]}
    for k, v in flat0.items():
        res[f"train/init/{k}"] = v
    rc = RunConfig("t", "train", TRAIN["S"], TRAIN["B"], lr=TRAIN["lr"], warmup_steps=1)
    ds = SyntheticLM(cfg.vocab_size, TRAIN["S"], TRAIN["B"])
    for (d, mx, my) in MESHES:
        mesh = make_small_mesh("hecaton", d, mx, my)
        for var in VARIANTS:
            mode, cd = variant(var)
            pcfg = ParallelConfig(strategy="hecaton", data=d, model=mx * my, mx=mx, my=my,
                                  microbatches=TRAIN["microbatches"], overlap=mode,
                                  comm_dtype=cd, grad_reduce_dtype="fp32")
            pspecs = SP.param_specs(params0, mesh, pcfg)
            params = jax.device_put(params0, SP.sharding_tree(pspecs, mesh))
            opt = adamw.init(params0)
            opt = jax.device_put(opt, SP.sharding_tree(
                SP.opt_state_specs(pspecs, params0, mesh, pcfg), mesh))
            bspec = SP.sharding_tree(SP.batch_specs(mesh, pcfg, microbatched=False), mesh)
            step = jax.jit(TS.build_train_step(cfg, pcfg, rc, mesh, compute_dtype=jnp.float32))
            key = f"train/{d}x{mx}x{my}/{var}"
            losses = []
            for s in range(TRAIN["steps"]):
                batch = jax.device_put({k: jnp.asarray(v) for k, v in ds.batch_at(s).items()},
                                       bspec)
                params, opt, m = step(params, opt, batch)
                losses.append(float(m["loss"]))
            res[f"{key}/losses"] = np.asarray(losses)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]:
                name = "/".join(str(getattr(k, "key", k)) for k in kp)
                res[f"{key}/params/{name}"] = np.asarray(v)


# q-hop cases: (name, rows, h, dtype); each rank holds [rows, h]
QHOP_CASES = (("f32", 6, 40, "float32"), ("bf16", 5, 33, "bfloat16"),
              ("narrow", 4, 12, "float32"))


def qhop_inputs(rows, h, dtype, seed):
    """Both ranks' shards [2 rows, h] (bf16-exact for bf16), row 1 zero, and
    the cotangent."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2 * rows, h)) * rng.lognormal(size=(2 * rows, 1))).astype(
        np.float32)
    x[1] = 0.0
    ct = rng.standard_normal((2 * rows, h)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        ct = np.asarray(jnp.asarray(ct, jnp.bfloat16).astype(jnp.float32))
    return x, ct


def run_qhop(out_path):
    from repro.core import quant as Q
    mesh = _mesh(1, 1, 2)
    res = {}
    for k, (name, rows, h, dtype) in enumerate(QHOP_CASES):
        x, ct = qhop_inputs(rows, h, dtype, 500 + k)
        dt = getattr(jnp, dtype)
        for shift in (1, -1):
            f = lambda xl, _s=shift: Q.ring_hop(xl.astype(dt), "my", 2, _s, "int8").astype(
                jnp.float32)
            outs, grads = _vjp(mesh, f, (P("my", None),), P("my", None), [x], [ct])
            key = f"qhop/{name}/{shift}"
            res[f"{key}/out"], res[f"{key}/grad"] = outs[0], grads[0]
        res[f"qhop/{name}/in"], res[f"qhop/{name}/ct"] = x, ct
    np.savez(out_path, **res)


CKPT = dict(arch="paper-llama2-7b", B=4, S=16, lr=1e-3, microbatches=2, steps=2)


def run_ckpt(out_path, ckpt_dir):
    from repro.checkpoint.manager import CheckpointManager
    from repro.config import ParallelConfig, RunConfig, get_smoke_config
    from repro.data.synthetic import SyntheticLM
    from repro.launch.mesh import make_small_mesh
    from repro.models import lm
    from repro.optim import adamw
    from repro.parallel import specs as SP
    from repro.train import step as TS

    cfg = get_smoke_config(CKPT["arch"])
    params0 = lm.init_params(cfg, jax.random.PRNGKey(0))
    rc = RunConfig("t", "train", CKPT["S"], CKPT["B"], lr=CKPT["lr"], warmup_steps=1)
    ds = SyntheticLM(cfg.vocab_size, CKPT["S"], CKPT["B"])
    kw = dict(strategy="hecaton", microbatches=CKPT["microbatches"], grad_reduce_dtype="fp32")
    one = jax.jit(TS.build_train_step(cfg, ParallelConfig(data=1, model=1, mx=1, my=1, **kw),
                                      rc, None, compute_dtype=jnp.float32))
    batch = {k: jnp.asarray(v) for k, v in ds.batch_at(0).items()}
    params, opt, _ = one(params0, adamw.init(params0), batch)
    CheckpointManager(ckpt_dir).save(1, {"params": params, "opt_state": opt})

    mesh = make_small_mesh("hecaton", 1, 2, 2)
    pcfg = ParallelConfig(data=1, model=4, mx=2, my=2, overlap="fused", **kw)
    pspecs = SP.param_specs(params0, mesh, pcfg)
    shardings = {"params": SP.sharding_tree(pspecs, mesh),
                 "opt_state": SP.sharding_tree(SP.opt_state_specs(pspecs, params0, mesh, pcfg),
                                               mesh)}
    state, start = CheckpointManager(ckpt_dir).restore(
        {"params": params0, "opt_state": adamw.init(params0)}, shardings=shardings)
    bspec = SP.sharding_tree(SP.batch_specs(mesh, pcfg, microbatched=False), mesh)
    step = jax.jit(TS.build_train_step(cfg, pcfg, rc, mesh, compute_dtype=jnp.float32))
    params, opt, losses = state["params"], state["opt_state"], []
    for s in range(start, start + CKPT["steps"]):
        batch = jax.device_put({k: jnp.asarray(v) for k, v in ds.batch_at(s).items()}, bspec)
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    res = {"ckpt/losses": np.asarray(losses), "ckpt/start": np.asarray(start)}
    for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        res["ckpt/params/" + "/".join(str(getattr(k, "key", k)) for k in kp)] = np.asarray(v)
    np.savez(out_path, **res)


def main():
    what, out = sys.argv[1], sys.argv[2]
    if what == "ring":
        run_ring(out)
    elif what == "ckpt":
        run_ckpt(out, sys.argv[3])
    elif what == "qhop":
        run_qhop(out)
    else:
        res = {}
        run_ops(res)
        run_train(res)
        np.savez(out, **res)


if __name__ == "__main__":
    main()
