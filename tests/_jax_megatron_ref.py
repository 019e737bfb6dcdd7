"""JAX references for the port's megatron tests, on fake CPU meshes.

Run as a script in its own process (the device count is fixed when JAX
starts):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_megatron_ref.py INPUTS.npz OUT.npz [ops|train][:K/N]

INPUTS.npz (written by ``tests/test_torch_megatron.py``) holds the op
inputs and cotangents (``op/in/<name>``, ``op/ct/...``) and the initial
parameters of the qwen3-0.6b smoke config (``init/<path>``).  The script
writes, for every op variant of :data:`OP_VARIANTS`, the output and the
gradients of ``sum(out * ct)`` of each ``repro.parallel.megatron`` op
(and ``repro.core.hecaton.embed_2d`` with ``t_ax="model"``) on the (1, 4)
``("data", "model")`` mesh; and for every step case of
:data:`TRAIN_CASES`, two fp32 steps of ``repro.train.step.
build_train_step`` under ``--strategy megatron`` (and one hecaton case,
the grid's non-fused head loss on the 1x2x2 mesh): the losses and the
final parameters.  ``ops:K/N`` writes the op variants K, K + N, ...,
``train:K/N`` the step cases (the test runs the parts in processes at
once).  Only the
numbers cross: the test holds the port's.
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# op variants: (residual layout, overlap, wire); "seq-ragged" is the seq
# layout asked of a sequence the ring of four cannot divide (the per-call
# fallback to the replicated path)
OP_VARIANTS = tuple((lay, ov, "bf16") for lay in ("seq", "replicated")
                    for ov in ("none", "ring", "bidir", "fused")) + tuple(
    (lay, ov, "int8") for lay in ("seq", "replicated") for ov in ("ring", "fused")) + (
    ("seq-ragged", "fused", "bf16"),)
# op shapes: T splits over four ranks, the ragged T does not; every
# column extent is at least 16 per rank, so the int8 wire quantizes
OP_SHAPE = dict(B=2, T=16, T_RAGGED=18, H=32, F=64, KV=16, V=64)
# step cases: (mesh (data, model), residual, overlap, wire, fused_loss[,
# strategy]); a hecaton case runs on WORLDS' grid of its ranks.  Ordered so
# that the two halves the test runs at once (every other case) compile in
# about the same time
TRAIN_CASES = (((1, 4), "seq", "fused", "int8", True),
               ((1, 4), "seq", "fused", "bf16", False, "hecaton"),
               ((1, 4), "seq", "fused", "bf16", True),
               ((1, 4), "replicated", "fused", "bf16", True),
               ((1, 4), "seq", "ring", "bf16", False), ((2, 2), "seq", "fused", "bf16", True),
               ((2, 2), "seq", "none", "bf16", True), ((1, 4), "seq", "none", "bf16", True))
WORLDS = {(1, 4): (1, 2, 2), (2, 2): (2, 1, 2)}
# remat "none": the policy moves no number, and the steps compile faster
TRAIN = dict(B=4, S=16, steps=2, lr=1e-3, microbatches=2, remat="none")
OPS = ("col_parallel", "col_parallel_shared", "row_parallel", "ffn", "embed_2d",
       "fused_lm_loss_seq")


def variant_key(v):
    return "-".join(v)


def strategy(c):
    return c[5] if len(c) > 5 else "megatron"


def case_key(c):
    (d, m), lay, ov, wire, fused = c[:5]
    loss = "fused" if fused else "xent"
    if strategy(c) == "hecaton":
        return "hecaton/{}x{}x{}/{}/{}/{}".format(*WORLDS[(d, m)], ov, wire, loss)
    return f"{d}x{m}/{lay}/{ov}/{wire}/{loss}"


def op_names(v):
    """The ops a variant runs: the loss needs the seq layout."""
    return tuple(o for o in OPS if o != "fused_lm_loss_seq" or v[0] == "seq")


def op_args(name):
    """(input names, of the npz's op/in/*) of an op."""
    return {"col_parallel": ("x", "w1"), "col_parallel_shared": ("x", "wq", "wk", "wv"),
            "row_parallel": ("y", "w2"), "ffn": ("x", "w1", "w2", "w1b"),
            "embed_2d": ("table",), "fused_lm_loss_seq": ("x", "head")}[name]


def _pcfg(lay, ov, wire, d=1, m=4, fused=True, strat="megatron", **kw):
    from repro.config import ParallelConfig
    _, mx, my = WORLDS[(d, m)] if strat == "hecaton" else (d, 1, m)
    return ParallelConfig(strategy=strat, data=d, model=m, mx=mx, my=my, overlap=ov,
                          comm_dtype=wire, residual=lay.split("-")[0], fused_loss=fused, **kw)


def run_ops(z, res, variants=OP_VARIANTS):
    from repro.core import hecaton as H
    from repro.launch.mesh import make_small_mesh
    from repro.parallel import megatron as meg
    from repro.parallel import sharding as shd
    from repro.parallel.context import PCtx
    mesh = make_small_mesh("megatron", 1, 1, 4)
    for v in variants:
        lay, ov, wire = v
        pctx = PCtx(mesh, _pcfg(lay, ov, wire), "train")
        sfx = "_r" if lay == "seq-ragged" else ""
        inp = {k[len("op/in/"):]: jnp.asarray(z[k]) for k in z.files if k.startswith("op/in/")}
        ids, labels, mask = inp["ids" + sfx], inp["labels" + sfx], inp["mask" + sfx]
        seq_ok = pctx.residual == "seq" and shd.seq_shardable(pctx.ax, ids.shape[1])
        fns = {
            "col_parallel": lambda x, w: meg.col_parallel(pctx, x, w),
            "col_parallel_shared": lambda x, *ws: jnp.concatenate(
                meg.col_parallel_shared(pctx, x, ws), axis=-1),
            "row_parallel": lambda y, w: meg.row_parallel(pctx, y, w),
            "ffn": lambda x, w1, w2, w1b: meg.ffn(pctx, x, w1, w2, jax.nn.silu, w1b),
            "embed_2d": lambda table: H.embed_2d(
                ids, table, mesh=mesh, t_ax="model", h_ax=None, compute_dtype=jnp.float32,
                seq_sharded=seq_ok, overlap=ov, comm_dtype=wire),
            "fused_lm_loss_seq": lambda x, head: jnp.stack(meg.fused_lm_loss_seq(
                pctx, x, head, labels, mask)),
        }
        names = op_names(v)
        args = {name: [inp[k + (sfx if k in ("x", "y") else "")] for k in op_args(name)]
                for name in names}
        cts = {name: jnp.asarray(z[f"op/ct/{'ragged/' if sfx else ''}{name}"]) for name in names}

        @jax.jit                      # every op's forward and backward in one program
        def fwd_bwd(args, cts):
            outs = {}
            for name in names:
                out, vjp = jax.vjp(fns[name], *args[name])
                outs[name] = (out, vjp(cts[name]))
            return outs
        for name, (out, grads) in fwd_bwd(args, cts).items():
            key = f"op/{variant_key(v)}/{name}"
            res[f"{key}/out"] = np.asarray(out)
            for k, g in zip(op_args(name), grads):
                res[f"{key}/grad_{k}"] = np.asarray(g)
        res[f"gate/{variant_key(v)}/seq_loss_ok"] = np.asarray(
            meg.seq_loss_ok(pctx, ids.shape[1], OP_SHAPE["V"]))


def _tree(z, prefix):
    tree = {}
    for k in z.files:
        if k.startswith(prefix):
            d = tree
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = jnp.asarray(z[k])
    return tree


def run_train(z, res, cases=TRAIN_CASES):
    from repro.config import RunConfig, get_smoke_config
    from repro.data.synthetic import SyntheticLM
    from repro.launch.mesh import make_small_mesh
    from repro.optim import adamw
    from repro.parallel import specs as SP
    from repro.train import step as TS

    cfg = get_smoke_config("qwen3-0.6b")
    params0 = _tree(z, "init/")
    rc = RunConfig("t", "train", TRAIN["S"], TRAIN["B"], lr=TRAIN["lr"], warmup_steps=1)
    ds = SyntheticLM(cfg.vocab_size, TRAIN["S"], TRAIN["B"])
    for c in cases:
        (d, m), lay, ov, wire, fused = c[:5]
        pcfg = _pcfg(lay, ov, wire, d, m, fused, strategy(c),
                     microbatches=TRAIN["microbatches"], grad_reduce_dtype="fp32",
                     remat=TRAIN["remat"])
        mesh = make_small_mesh(pcfg.strategy, d, pcfg.mx, pcfg.my)
        pspecs = SP.param_specs(params0, mesh, pcfg)
        params = jax.device_put(params0, SP.sharding_tree(pspecs, mesh))
        opt = jax.device_put(adamw.init(params0), SP.sharding_tree(
            SP.opt_state_specs(pspecs, params0, mesh, pcfg), mesh))
        bspec = SP.sharding_tree(SP.batch_specs(mesh, pcfg, microbatched=False,
                                                seq_len=TRAIN["S"]), mesh)
        step = jax.jit(TS.build_train_step(cfg, pcfg, rc, mesh, compute_dtype=jnp.float32))
        key = f"train/{case_key(c)}"
        losses = []
        for s in range(TRAIN["steps"]):
            batch = jax.device_put({k: jnp.asarray(v) for k, v in ds.batch_at(s).items()},
                                   bspec)
            params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"]))
        res[f"{key}/losses"] = np.asarray(losses)
        for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            res[f"{key}/params/" + "/".join(str(getattr(k, "key", k)) for k in kp)] = \
                np.asarray(v)


def main():
    z = np.load(sys.argv[1])
    what, part = ((sys.argv[3] if len(sys.argv) > 3 else "all") + ":0/1").split(":")[:2]
    k, n = map(int, part.split("/"))
    res = {}
    if what in ("ops", "all"):
        run_ops(z, res, OP_VARIANTS[k::n])
    if what in ("train", "all"):
        run_train(z, res, TRAIN_CASES[k::n])
    np.savez(sys.argv[2], **res)


if __name__ == "__main__":
    main()
