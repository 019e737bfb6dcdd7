"""Grid worlds for the port's tests: spawn one process per rank on the CPU
(gloo, ``FileStore`` rendezvous in a temporary directory), run a job in
every rank, and collect each rank's result.  Imports torch and the port
only (the rank processes never load JAX).

The jobs read the JAX references that ``tests/_jax_grid_ref.py`` wrote
and return numpy arrays; the test files compare them.
"""

from __future__ import annotations

import numpy as np
import torch

# the ring-op cases of _jax_grid_ref.RING_CASES, with specs as tuples
RING_CASES = {
    "ag_matmul": dict(ins=((None, "mx", "my"), ("my", "mx")),
                      outs=((None, None, ("my", "mx")),)),
    "matmul_rs_tokens": dict(ins=((None, "mx", "my"), ("my", "mx")),
                             outs=((None, ("mx", "my"), None),)),
    "matmul_rs_cols": dict(ins=((None, "mx", "my"), ("my", "mx")),
                           outs=((None, "mx", "my"),)),
    "ag_matmul_contract": dict(ins=((None, "mx", "my"), (None, ("mx", "my"))),
                               outs=((None, None, ("mx", "my")),)),
    "matmul_rs_pair": dict(ins=((None, "mx", "my"), ("my", "mx"), ("my", "mx")),
                           outs=((None, ("mx", "my"), None),) * 2),
}
RING_SHAPES = ("aligned", "ragged")                 # both wires
INT8_RING_SHAPES = RING_SHAPES + ("wide", "wide_ragged")
WIRES = ("bf16", "int8")
# _jax_grid_ref.VARIANTS: an overlap mode, "-int8" for the int8 wire
VARIANTS = ("none", "ring", "fused", "bidir", "ring-int8", "bidir-int8", "fused-int8")


def variant(v):
    """(overlap, comm_dtype) of a variant name."""
    mode, _, wire = v.partition("-")
    return mode, wire or "bf16"


def wire_key(key, comm_dtype):
    """The npz key of a ring case on a wire."""
    return key if comm_dtype == "bf16" else f"int8/{key}"

# the hecaton ops of _jax_grid_ref.run_ops: input names and specs, output spec
OP_CASES = {
    "linear_seq_scatter": dict(ins={"x": ("data", "mx", "my"), "w": ("my", "mx")},
                               out=("data", "my", "mx")),
    "mixer_in": dict(ins={"x": ("data", "mx", "my"), "w": ("my", "mx")},
                     out=("data", None, ("mx", "my"))),
    "mixer_out": dict(ins={"a": ("data", None, ("mx", "my")), "wo": ("mx", "my")},
                      out=("data", "mx", "my")),
    "ffn_block": dict(ins={"x": ("data", "mx", "my"), "w": ("my", "mx"), "w2": ("mx", "my"),
                           "w1b": ("my", "mx")}, out=("data", "mx", "my")),
    "embed_2d": dict(ins={"table": ("mx", "my")}, out=("data", "mx", "my")),
    "fused_lm_loss": dict(ins={"x": ("data", "mx", "my"), "head": (None, "my")}, out=()),
}


def run_world(shape, job, args=(), timeout=600.0, device="cpu"):
    """Run ``job(grid, *args)`` in every rank of a (data, mx, my) world on
    ``device``; returns {rank: result}.  A rank that fails or a world that
    outlives ``timeout`` raises."""
    from repro_torch.parallel import comm
    world = shape[0] * shape[1] * shape[2]
    return comm.run_ranks(_rank_main, world, (shape, job, args, comm.temp_init_file(), device),
                          timeout)


def _rank_main(rank, shape, job, args, init_file, device):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch.mesh import Grid
    from repro_torch.parallel import comm
    grid = Grid(*shape, rank)
    comm.init_world(grid, device=device, init_file=init_file)
    try:
        result = job(grid, *args)
        comm.barrier()
        return result
    finally:
        comm.shutdown()


def _local(a, spec, grid):
    from repro_torch.parallel import specs
    return specs.local_slice(torch.from_numpy(np.asarray(a)), spec, grid)


def _sum_replicated(g, spec, grid):
    from repro_torch.parallel import comm, specs
    for ax in specs.replicated_axes(spec, grid):
        g = comm.raw_psum(g, ax)
    return g


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def ring_job(grid, ref_path):
    """Every ring op at both shapes on both wires: this rank's outputs and
    the gradients of sum(out * ct) w.r.t. its input blocks."""
    from repro_torch.kernels import ring_matmul as RM
    z = np.load(ref_path)

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
    for cd in WIRES:
        for shape_name in (RING_SHAPES if cd == "bf16" else INT8_RING_SHAPES):
            for name, case in RING_CASES.items():
                key = f"{shape_name}/{name}"
                ins = [_local(z[f"{key}/in{i}"], s, grid).requires_grad_(True)
                       for i, s in enumerate(case["ins"])]
                outs = fns(cd)[name](*ins)
                outs = outs if isinstance(outs, tuple) else (outs,)
                cts = [_local(z[f"{key}/ct{i}"], s, grid) for i, s in enumerate(case["outs"])]
                loss = sum(torch.sum(o * c) for o, c in zip(outs, cts))
                grads = torch.autograd.grad(loss, ins)
                res[wire_key(key, cd)] = ([o.detach().numpy() for o in outs],
                                          [g.numpy() for g in grads])
    return res


def grid_job(grid, ref_path, with_ops):
    """The hecaton ops under each variant (``with_ops``), and two training
    steps under each variant from the JAX initial parameters."""
    from repro_torch.core import hecaton as HEC
    from repro_torch.core import overlap as OV
    z = np.load(ref_path)
    res = {}
    if with_ops:
        inp = {k[len("op/in/"):]: z[k] for k in z.files if k.startswith("op/in/")}
        for var in VARIANTS:
            mode, cd = variant(var)
            kw = dict(overlap=mode, comm_dtype=cd)
            fns = {
                "linear_seq_scatter": lambda x, w: HEC.linear_seq_scatter(x, w, **kw),
                "mixer_in": lambda x, w: HEC.mixer_in(x, w, **kw),
                "mixer_out": lambda a, wo: HEC.mixer_out(a, wo, **kw),
                "ffn_block": lambda x, w, w2, w1b: HEC.ffn_block(
                    x, w, w2, act_fn=torch.nn.functional.silu, w1b=w1b, **kw),
                "embed_2d": lambda table: HEC.embed_2d(
                    _local(inp["ids"], ("data", "mx"), grid), table,
                    compute_dtype=torch.float32, **kw),
                "fused_lm_loss": lambda x, head: torch.stack(HEC.fused_lm_loss(
                    x, head, _local(inp["labels"], ("data", "mx"), grid),
                    _local(inp["mask"], ("data", "mx"), grid), mesh=grid, **kw)),
            }
            for name, case in OP_CASES.items():
                key = f"op/{var}/{name}"
                ins = [_local(inp[k], s, grid).requires_grad_(True)
                       for k, s in case["ins"].items()]
                out = fns[name](*ins)
                ct = _local(z[f"{key}/ct"], case["out"], grid)
                if not case["out"]:            # a replicated output: every rank holds it
                    ct = ct / grid.world
                grads = torch.autograd.grad(torch.sum(out * ct), ins)
                grads = [_sum_replicated(g, s, grid).numpy()
                         for g, s in zip(grads, case["ins"].values())]
                res[key] = (out.detach().numpy(), grads)
    res["train"] = train_job(grid, z)
    return res


def train_job(grid, z):
    from repro_torch import bridge
    from repro_torch.config import ParallelConfig, RunConfig, get_smoke_config
    from repro_torch.core import overlap as OV
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.parallel import specs
    from repro_torch.train import step as TS
    tree = {}
    for k in z.files:
        if k.startswith("train/init/"):
            d = tree
            parts = k[len("train/init/"):].split("/")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = z[k]
    cfg = get_smoke_config("qwen3-0.6b")
    B, S, steps, lr, nm = 4, 16, 2, 1e-3, 2
    rc = RunConfig("t", "train", S, B, lr=lr, warmup_steps=1)
    ds = SyntheticLM(cfg.vocab_size, S, B)
    out = {}
    for var in VARIANTS:
        mode, cd = variant(var)
        pcfg = ParallelConfig(data=grid.data, mx=grid.mx, my=grid.my, overlap=mode,
                              comm_dtype=cd, microbatches=nm, grad_reduce_dtype="fp32")
        params = bridge.shard_master_params_from_jax(tree, grid, device="cpu")
        opt = TS.init_grid_opt_state(params, grid, pcfg)
        step = TS.build_train_step(cfg, pcfg, rc, compute_dtype=torch.float32, mesh=grid)
        OV.clear_routes()
        losses = []
        for s in range(steps):
            lb = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in specs.local_batch(ds.batch_at(s), grid, nm).items()}
            params, opt, m = step(params, opt, lb)
            losses.append(float(m["loss"]))
        routes = OV.route_table()
        full = bridge.gather_master_params(params, grid)
        out[var] = dict(losses=losses, routes=routes,
                         params={"/".join(p): t.numpy() for p, t in lm.flatten(full)}
                         if grid.rank == 0 else None)
    return out


# ---------------------------------------------------------------------------
# jobs on the card (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

# (kernel, x, o, scatter_dim): tile-aligned and ragged extents; w is
# [h, o], or [n h, o] for the contracted ring.  The last five have h, o
# (and o / n) off 8 elements, so the backward's tile products store ragged
# rows, on rings of 2 and of 4.
CUDA_RING_CASES = (
    ("ag_matmul", (2, 64, 96), 80, None),
    ("ag_matmul", (3, 50, 40), 24, None),
    ("matmul_rs", (2, 64, 96), 80, 1),
    ("matmul_rs", (2, 64, 96), 96, 2),
    ("matmul_rs", (3, 50, 40), 64, 2),
    ("matmul_rs_pair", (2, 64, 96), 80, 1),
    ("ag_matmul_contract", (2, 64, 96), 80, None),
    ("ag_matmul_contract", (3, 50, 40), 24, None),
    ("ag_matmul", (3, 50, 45), 27, None),
    ("matmul_rs", (3, 52, 45), 27, 1),
    ("matmul_rs", (3, 50, 45), 36, 2),
    ("matmul_rs_pair", (3, 52, 45), 27, 1),
    ("ag_matmul_contract", (3, 50, 45), 27, None),
)


def run_fwd(kernel, x, w, w1b, ax, n, sd):
    """The forward kernel of one CUDA_RING_CASES case on the bf16 wire."""
    from repro_torch.kernels import ring_matmul as RM
    if kernel == "ag_matmul":
        return RM.ag_fwd(x, w, ax, 1, n)
    if kernel == "matmul_rs":
        return RM.rs_fwd(x, w, ax, sd, n)
    if kernel == "matmul_rs_pair":
        return RM.pair_fwd(x, w, w1b, ax, sd, n)
    return RM.contract_fwd(x, w, ax, n)


def cuda_ring_job(grid, ax="my"):
    """Each ring kernel over the ``ax`` ring (forward, and its backward
    through the transposed rings) against the plain route on the same
    inputs, on the bf16 wire (keyed by the case and dtype) and on the int8
    wire (the key and "int8"); on the bf16 wire also the forward's launches
    by route (``ring_matmul.IMPL_LAUNCHES``, keyed "routes" + the key); on a
    ring of two, also the probe's time."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ring_matmul as RM
    dev = torch.device("cuda", torch.cuda.current_device())
    n = grid.size(ax)
    secs = RM.pingpong(ax, 50) if n == 2 else None
    res = {}
    for i, (kernel, xs, o, sd) in enumerate(CUDA_RING_CASES):
        ws = (n * xs[2] if kernel == "ag_matmul_contract" else xs[2], o)
        for dtype, wire in ((d, w) for w in WIRES for d in (torch.float32, torch.bfloat16)):
            g = torch.Generator(device=dev).manual_seed(100 * i + grid.rank)
            x = torch.randn(xs, generator=g, device=dev).to(dtype)
            w = (torch.randn(ws, generator=g, device=dev) / ws[0] ** 0.5).to(dtype)
            w1b = (torch.randn(ws, generator=g, device=dev) / ws[0] ** 0.5).to(dtype)

            def run(plain):
                ins = [t.detach().clone().requires_grad_(True) for t in (x, w, w1b)]
                kw = dict(n=n, comm_dtype=wire, plain=plain)
                if kernel == "ag_matmul":
                    outs = (RM.ag_matmul(ins[0], ins[1], ax, **kw),)
                elif kernel == "matmul_rs":
                    outs = (RM.matmul_rs(ins[0], ins[1], ax, scatter_dim=sd, **kw),)
                elif kernel == "matmul_rs_pair":
                    outs = RM.matmul_rs_pair(*ins, ax, scatter_dim=sd, **kw)
                else:
                    outs = (RM.ag_matmul_contract(ins[0], ins[1], ax, **kw),)
                used = ins if kernel == "matmul_rs_pair" else ins[:2]
                gct = torch.Generator(device=dev).manual_seed(7 + grid.rank)
                cts = [torch.randn(o_.shape, generator=gct, device=dev).to(dtype)
                       for o_ in outs]
                grads = torch.autograd.grad(sum(torch.sum(o_.float() * c.float())
                                                for o_, c in zip(outs, cts)), used)
                return [o_.detach().float().cpu().numpy() for o_ in outs], \
                    [gr.float().cpu().numpy() for gr in grads]
            before = dict(ops.LAUNCHES)
            kern = run(False)
            launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
            key = (kernel, xs, o, sd, str(dtype)) + (("int8",) if wire == "int8" else ())
            res[key] = (kern, run(True), launched)
            if wire == "bf16":            # the forward alone, by route
                was = {k: dict(v) for k, v in RM.IMPL_LAUNCHES.items()}
                with torch.no_grad():
                    run_fwd(kernel, x, w, w1b, ax, n, sd)
                res[("routes",) + key] = {k: {p: RM.IMPL_LAUNCHES[k][p] - was[k][p] for p in v}
                                          for k, v in was.items()}
    torch.cuda.synchronize()
    return dict(probe_s=secs, cases=res)


def cuda_grid_job(grid):
    """Two fp32 steps of the smoke config, widened to the attention
    kernel's head dim (64), on the grid through the kernels (overlap
    fused) and through the plain versions, from one seed."""
    from repro_torch.config import ParallelConfig, RunConfig, get_smoke_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.parallel import specs
    from repro_torch.train import step as TS
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_smoke_config("qwen3-0.6b").scaled(d_model=256, head_dim=64, d_ff=512)
    pcfg = ParallelConfig(data=grid.data, mx=grid.mx, my=grid.my, overlap="fused",
                          microbatches=2, grad_reduce_dtype="fp32")
    rc = RunConfig("t", "train", 16, 4, lr=1e-3, warmup_steps=1)
    ds = SyntheticLM(cfg.vocab_size, 16, 4)
    out = {}
    for plain in (False, True):
        full = lm.init_master_params(cfg, seed=0, device=dev)
        params = specs.shard_tree(full, specs.param_specs(full, grid), grid)
        for _, t in lm.flatten(params):
            t.requires_grad_(True)
        opt = TS.init_grid_opt_state(params, grid, pcfg)
        step = TS.build_train_step(cfg, pcfg, rc, compute_dtype=torch.float32, mesh=grid,
                                   plain=plain)
        ops.reset_launches()
        losses = []
        for s in range(2):
            lb = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in specs.local_batch(ds.batch_at(s), grid, 2).items()}
            params, opt, m = step(params, opt, lb)
            losses.append(float(m["loss"]))
        out[plain] = dict(losses=losses, launches=dict(ops.LAUNCHES),
                          params={"/".join(p): t.detach().cpu().numpy()
                                  for p, t in lm.flatten(params)})
    return out


# ---------------------------------------------------------------------------
# the quantized hop (tests/test_torch_quant.py)
# ---------------------------------------------------------------------------

QHOP_CASES = (("f32", torch.float32), ("bf16", torch.bfloat16), ("narrow", torch.float32))


# the loopback ring's reference against the plain rings: (kernel, x, o,
# scatter_dim, gated pair), every hopped shard 16 wide or more (quant_ok);
# the contracted ring's w has n x h rows
LOOPBACK_REF_CASES = (
    ("ag_matmul", (2, 8, 32), 24, None, False),
    ("matmul_rs", (2, 8, 32), 24, 1, False),
    ("matmul_rs", (2, 8, 32), 64, 2, False),
    ("matmul_rs", (2, 8, 32), 24, 1, True),
    ("ag_matmul_contract", (2, 8, 32), 24, None, False),
)


def loopback_ref_job(grid, axes=("my", "model")):
    """On each ring of ``axes``: every rank makes all n ranks' inputs from
    one seed, computes ``ring_loopback.reference`` for the whole ring, and
    returns its own rank's part beside the plain ring's (``kernels/ref.py``
    over this world) on the same inputs, both wires, fp32 and bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ring_loopback as LB
    out = {}
    for ax in axes:
        n, me = grid.size(ax), grid.axis_index(ax)
        for i, (kernel, xs, o, sd, pair) in enumerate(LOOPBACK_REF_CASES):
            rows = n * xs[2] if kernel == "ag_matmul_contract" else xs[2]
            g = torch.Generator().manual_seed(10 * i + n)
            for dtype in (torch.float32, torch.bfloat16):
                xl = [torch.randn(xs, generator=g).to(dtype) for _ in range(n)]
                wl = [(torch.randn(rows, o, generator=g) / rows ** 0.5).to(dtype)
                      for _ in range(n)]
                w1b = [(torch.randn(rows, o, generator=g) / rows ** 0.5).to(dtype)
                       for _ in range(n)]
                for int8 in (False, True):
                    x, w = xl[me], wl[me]
                    if kernel == "ag_matmul":
                        plain = (ref.ag_matmul_int8_plain if int8 else ref.ag_matmul_plain)(
                            x, w, ax, dim=1)
                        want = LB.reference(kernel, xl, wl, int8=int8)[me]
                    elif kernel == "ag_matmul_contract":
                        plain = (ref.ag_matmul_contract_int8_plain if int8
                                 else ref.ag_matmul_contract_plain)(x, w, ax)
                        want = LB.reference(kernel, xl, wl, int8=int8)[me]
                    elif pair:
                        plain = torch.cat((ref.matmul_rs_pair_int8_plain if int8
                                           else ref.matmul_rs_pair_plain)(
                            x, w, w1b[me], ax, scatter_dim=sd), dim=-1)
                        wc = [torch.cat([a, b], dim=1) for a, b in zip(wl, w1b)]
                        want = LB.reference(kernel, xl, wc, sd, int8=int8,
                                            split=o if int8 else 0)[me]
                    else:
                        plain = (ref.matmul_rs_int8_plain if int8 else ref.matmul_rs_plain)(
                            x, w, ax, scatter_dim=sd)
                        want = LB.reference(kernel, xl, wl, sd, int8=int8)[me]
                    out[(ax, i, str(dtype), int8)] = (want.float().numpy(),
                                                      plain.float().numpy())
    return out


def qhop_job(grid, ref_path):
    """``comm.ring_hop(x, "my", shift, "int8")`` on this rank's rows of each
    case, forward and the gradient of sum(out * ct), shift +1 and -1."""
    from repro_torch.parallel import comm
    z = np.load(ref_path)
    res = {}
    for name, dtype in QHOP_CASES:
        x = _local(z[f"qhop/{name}/in"], ("my", None), grid).to(dtype).requires_grad_(True)
        ct = _local(z[f"qhop/{name}/ct"], ("my", None), grid)
        for shift in (1, -1):
            out = comm.ring_hop(x, "my", shift, "int8").float()
            (g,) = torch.autograd.grad(torch.sum(out * ct), [x])
            res[f"qhop/{name}/{shift}"] = (out.detach().numpy(), g.float().numpy())
    return res


# ---------------------------------------------------------------------------
# bidir's degradation (tests/test_torch_grid.py)
# ---------------------------------------------------------------------------

# (name, an extent that halves, an odd one): the extent is the chunk bidir
# halves (the shard's tokens, the scattered chunk, the contracted h_loc);
# column extents are at least 16 so that the int8 wire quantizes them
BIDIR_CASES = (("ag_matmul", 6, 5), ("matmul_rs_tokens", 4, 3), ("matmul_rs_cols", 18, 17),
               ("ag_matmul_contract", 18, 17), ("matmul_rs_pair", 4, 3),
               ("ring_all_gather", 6, 5), ("ring_reduce_scatter", 4, 3))


def bidir_job(grid):
    """Each case on the ``my`` ring under overlap bidir and ring, and its
    bulk collective: (bidir routes logged, bidir out, ring out, bulk out)."""
    from repro_torch.core import overlap as OV
    from repro_torch.parallel import comm
    n, ax = grid.my, "my"
    g = torch.Generator().manual_seed(5 + grid.rank)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    def case(name, c, mode, wire):
        kw = dict(overlap=mode, comm_dtype=wire)
        bidir = mode == "bidir"
        if name == "ag_matmul":
            x, w = rnd(2, c, 32), rnd(32, 24)
            return (lambda: OV.ag_matmul(x, w, ax, dim=1, n=n, **kw),
                    lambda: comm.raw_all_gather(x, ax, 1) @ w)
        if name in ("matmul_rs_tokens", "matmul_rs_pair", "ring_reduce_scatter"):
            x, w, w1b = rnd(2, n * c, 32), rnd(32, 24), rnd(32, 24)
            if name == "matmul_rs_pair":
                return (lambda: torch.cat(OV.matmul_rs_pair(x, w, w1b, ax, scatter_dim=1, n=n,
                                                            **kw), -1),
                        lambda: comm.raw_psum_scatter(x @ torch.cat([w, w1b], 1), ax, 1))
            if name == "ring_reduce_scatter":
                return (lambda: OV.ring_reduce_scatter(x, ax, dim=1, n=n, bidir=bidir,
                                                       comm_dtype=wire),
                        lambda: comm.raw_psum_scatter(x, ax, 1))
            return (lambda: OV.matmul_rs(x, w, ax, scatter_dim=1, n=n, **kw),
                    lambda: comm.raw_psum_scatter(x @ w, ax, 1))
        if name == "matmul_rs_cols":
            x, w = rnd(2, 4, 32), rnd(32, n * c)
            return (lambda: OV.matmul_rs(x, w, ax, scatter_dim=2, n=n, **kw),
                    lambda: comm.raw_psum_scatter(x @ w, ax, 2))
        if name == "ag_matmul_contract":
            x, w = rnd(2, 4, c), rnd(n * c, 24)
            return (lambda: OV.ag_matmul_contract(x, w, ax, n=n, **kw),
                    lambda: comm.raw_all_gather(x, ax, 2) @ w)
        x = rnd(2, c, 32)
        return (lambda: OV.ring_all_gather(x, ax, dim=1, n=n, bidir=bidir, comm_dtype=wire),
                lambda: comm.raw_all_gather(x, ax, 1))

    out = {}
    for wire in WIRES:
        for name, even, odd in BIDIR_CASES:
            for c in (even, odd):
                state = g.get_state()
                res = []
                for mode in ("bidir", "ring"):
                    g.set_state(state)                 # the same inputs for both modes
                    fn, bulk = case(name, c, mode, wire)
                    OV.clear_routes()
                    y = fn().numpy()
                    res.append(([r["route"] for r in OV.ROUTES], y))
                # the pure rings log no route (None)
                routes = None if name.startswith("ring_") else res[0][0]
                out[(name, c, wire)] = (routes, res[0][1], res[1][1], bulk().numpy())
    return out


# ---------------------------------------------------------------------------
# checkpoints on the grid (tests/test_torch_checkpoint.py)
# ---------------------------------------------------------------------------

def _ckpt_setup(grid):
    """The paper-llama2-7b smoke config (untied head) as the JAX ``ckpt``
    reference trains it, and this rank's initial state."""
    from repro_torch.config import ParallelConfig, RunConfig, get_smoke_config
    from repro_torch.models import lm
    from repro_torch.parallel import specs
    from repro_torch.train import step as TS
    cfg = get_smoke_config("paper-llama2-7b")
    pcfg = ParallelConfig(data=grid.data, mx=grid.mx, my=grid.my, overlap="fused",
                          microbatches=2, grad_reduce_dtype="fp32")
    rc = RunConfig("t", "train", 16, 4, lr=1e-3, warmup_steps=1)
    full = lm.init_master_params(cfg, seed=0, device="cpu")
    params = specs.shard_tree(full, specs.param_specs(full, grid), grid)
    for _, t in lm.flatten(params):
        t.requires_grad_(True)
    return cfg, pcfg, rc, {"params": params, "opt_state": TS.init_grid_opt_state(params, grid,
                                                                                 pcfg)}


def _gathered(state, grid, pcfg):
    """The global state from every rank's blocks and ZeRO-1 parts, each
    moment gathered in one go by its ZeRO-1 spec (not the two stages of
    ``checkpoint/grid.global_leaves``): {name: numpy} named as the
    checkpoint names them."""
    from repro_torch import bridge
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import specs, zero
    params, opt = state["params"], state["opt_state"]
    out = {"params/" + "/".join(p): t.numpy()
           for p, t in lm.flatten(bridge.gather_master_params(params, grid))}
    ax = shd.axis_info(grid)
    for (path, t), (_, m), (_, v) in zip(lm.flatten(params), lm.flatten(opt.mu),
                                         lm.flatten(opt.nu)):
        spec = specs.leaf_spec(path, t.dim(), ax, pcfg.fused_loss)
        full = [d * grid.size(tuple(specs._entry_axes(e))) if e is not None else d
                for d, e in zip(t.shape, tuple(spec) + (None,) * (t.dim() - len(spec)))]
        mspec = zero.state_spec(spec, full, ("data",), grid.sizes)
        for name, part in (("mu", m), ("nu", v)):
            out[f"opt_state/.{name}/" + "/".join(path)] = specs.gather_full(part, mspec).numpy()
    out["opt_state/.step"] = opt.step.numpy()
    out["opt_state/.gnorm_ewma"] = opt.gnorm_ewma.numpy()
    return out


def ckpt_grid_job(grid, jax_dir, port_dir):
    """Restore the JAX ``mesh=None`` checkpoint into this rank's blocks and
    ZeRO-1 parts, train two grid steps, then save through the loop's
    checkpointer (rank 0: an async manager on ``port_dir``).  Returns the
    restored step, the losses and (rank 0) the gathered final state."""
    from repro_torch.checkpoint import grid as CG
    from repro_torch.checkpoint.manager import AsyncCheckpointManager, CheckpointManager
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.parallel import specs
    from repro_torch.train import step as TS
    cfg, pcfg, rc, state = _ckpt_setup(grid)
    reader = CheckpointManager(jax_dir) if grid.rank == 0 else None
    state, start = CG.restore(jax_dir, state, grid, pcfg, reader)
    step = TS.build_train_step(cfg, pcfg, rc, compute_dtype=torch.float32, mesh=grid)
    ds = SyntheticLM(cfg.vocab_size, 16, 4)
    params, opt, losses = state["params"], state["opt_state"], []
    for s in range(start, start + 2):
        lb = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in specs.local_batch(ds.batch_at(s), grid, 2).items()}
        params, opt, m = step(params, opt, lb)
        losses.append(float(m["loss"]))
    state = {"params": params, "opt_state": opt}
    ck = CG.GridCheckpointer(AsyncCheckpointManager(port_dir) if grid.rank == 0 else None,
                             grid, pcfg)
    ck.save_async(start + 2, state)
    ck.wait_until_finished()
    ck.close()
    gathered = _gathered(state, grid, pcfg)
    return dict(start=start, losses=losses, state=gathered if grid.rank == 0 else None)


def ckpt_resave_job(grid, jax_dir, port_dir):
    """Restore the JAX checkpoint into this rank's blocks and ZeRO-1 parts
    and save it again at the same step (rank 0: a blocking manager):
    returns the restored step and each moment's (block shape, part shape)."""
    from repro_torch.checkpoint import grid as CG
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import lm
    _, pcfg, _, state = _ckpt_setup(grid)
    reader = CheckpointManager(jax_dir) if grid.rank == 0 else None
    state, start = CG.restore(jax_dir, state, grid, pcfg, reader)
    ck = CG.GridCheckpointer(CheckpointManager(port_dir) if grid.rank == 0 else None, grid,
                             pcfg)
    ck.save_async(start, state)
    ck.wait_until_finished()
    shapes = {"/".join(p): (tuple(t.shape), tuple(m.shape))
              for (p, t), (_, m) in zip(lm.flatten(state["params"]),
                                        lm.flatten(state["opt_state"].mu))}
    return dict(start=start, shapes=shapes)


# ---------------------------------------------------------------------------
# the megatron baseline (tests/test_torch_megatron.py)
# ---------------------------------------------------------------------------

# _jax_megatron_ref.OP_VARIANTS: (residual layout, overlap, wire)
MEG_OP_VARIANTS = tuple((lay, ov, "bf16") for lay in ("seq", "replicated")
                        for ov in ("none", "ring", "bidir", "fused")) + tuple(
    (lay, ov, "int8") for lay in ("seq", "replicated") for ov in ("ring", "fused")) + (
    ("seq-ragged", "fused", "bf16"),)
MEG_OPS = ("col_parallel", "col_parallel_shared", "row_parallel", "ffn", "embed_2d",
           "fused_lm_loss_seq")
# _jax_megatron_ref.TRAIN_CASES: (mesh (data, model), residual, overlap, wire, fused_loss[,
# strategy]): the hecaton case is its non-fused head loss on the (1, 4) world's 1x2x2 grid
MEG_TRAIN_CASES = (((1, 4), "seq", "fused", "int8", True),
                   ((1, 4), "seq", "fused", "bf16", False, "hecaton"),
                   ((1, 4), "seq", "fused", "bf16", True),
                   ((1, 4), "replicated", "fused", "bf16", True),
                   ((1, 4), "seq", "ring", "bf16", False), ((2, 2), "seq", "fused", "bf16", True),
                   ((2, 2), "seq", "none", "bf16", True), ((1, 4), "seq", "none", "bf16", True))
MEG_WORLDS = {(1, 4): (1, 2, 2), (2, 2): (2, 1, 2)}


def meg_variant_key(v):
    return "-".join(v)


def meg_strategy(c):
    return c[5] if len(c) > 5 else "megatron"


def meg_case_key(c):
    (d, m), lay, ov, wire, fused = c[:5]
    loss = "fused" if fused else "xent"
    if meg_strategy(c) == "hecaton":
        return "hecaton/{}x{}x{}/{}/{}/{}".format(*MEG_WORLDS[(d, m)], ov, wire, loss)
    return f"{d}x{m}/{lay}/{ov}/{wire}/{loss}"


def meg_op_names(v):
    return tuple(o for o in MEG_OPS if o != "fused_lm_loss_seq" or v[0] == "seq")


def meg_op_specs(name, seq):
    """(input names and specs, output specs) of an op in a layout: the
    residual token-sharded over ``model`` (seq) or whole (replicated)."""
    res = ("data", "model", None) if seq else ("data", None, None)
    tok = ("data", "model") if seq else ("data", None)
    col, row, mix = (None, "model"), ("model", None), ("data", None, "model")
    return {"col_parallel": ({"x": res, "w1": col}, (mix,)),
            "col_parallel_shared": ({"x": res, "wq": col, "wk": col, "wv": col}, (mix,) * 3),
            "row_parallel": ({"y": mix, "w2": row}, (res,)),
            "ffn": ({"x": res, "w1": col, "w2": row, "w1b": col}, (res,)),
            "embed_2d": ({"table": row}, (res,)),
            "fused_lm_loss_seq": ({"x": res, "head": col}, ((),))}[name], tok


def meg_copies(spec, grid):
    """How many ranks hold each element of an array of this spec."""
    from repro_torch.parallel import specs
    n = 1
    for a in specs.replicated_axes(spec, grid, "megatron"):
        n *= grid.size(a)
    return n


def megatron_job(grid, in_path, with_ops):
    """The megatron ops under each variant (``with_ops``: on the (1, 4)
    world) and the step cases of this world's mesh: each op's output
    blocks and the gradients of sum(out * ct) (a gradient summed over the
    ranks that hold its input whole, a cotangent split over the ranks
    that hold the output whole), the routes; each step case's losses,
    routes and (rank 0) gathered parameters."""
    from repro_torch.config import ParallelConfig
    from repro_torch.core import hecaton as HEC
    from repro_torch.core import overlap as OV
    from repro_torch.parallel import megatron as MEG
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.context import PCtx
    z = np.load(in_path)
    res = {}
    if with_ops:
        inp = {k[len("op/in/"):]: z[k] for k in z.files if k.startswith("op/in/")}
        for v in MEG_OP_VARIANTS:
            lay, ov, wire = v
            ragged = lay == "seq-ragged"
            sfx = "_r" if ragged else ""
            T = inp["ids" + sfx].shape[1]
            pcfg = ParallelConfig(strategy="megatron", data=grid.data, mx=grid.mx, my=grid.my,
                                  overlap=ov, comm_dtype=wire, residual=lay.split("-")[0])
            pctx = PCtx(mode="train", pcfg=pcfg, mesh=grid, seq_len=T)
            seq = pctx.seq_sharded
            tok = None                        # this op's token spec, set below
            fns = {
                "col_parallel": lambda x, w: (MEG.col_parallel(pctx, x, w),),
                "col_parallel_shared": lambda x, *ws: MEG.col_parallel_shared(pctx, x, ws),
                "row_parallel": lambda y, w: (MEG.row_parallel(pctx, y, w),),
                "ffn": lambda x, w1, w2, w1b: (MEG.ffn(pctx, x, w1, w2, "silu", w1b),),
                "embed_2d": lambda table: (HEC.embed_2d(
                    _local(inp["ids" + sfx], tok, grid), table, t_ax="model",
                    compute_dtype=torch.float32, seq_sharded=seq, overlap=ov,
                    comm_dtype=wire),),
                "fused_lm_loss_seq": lambda x, head: (torch.stack(MEG.fused_lm_loss_seq(
                    pctx, x, head, _local(inp["labels" + sfx], tok, grid),
                    _local(inp["mask" + sfx], tok, grid))),),
            }
            OV.clear_routes()
            for name in meg_op_names(v):
                (ins_spec, outs_spec), tok = meg_op_specs(name, seq)
                ins = [_local(inp[k + (sfx if k in ("x", "y") else "")], s, grid)
                       .requires_grad_(True) for k, s in ins_spec.items()]
                outs = fns[name](*ins)
                ct = z[f"op/ct/{'ragged/' if ragged else ''}{name}"]
                cts = np.split(ct, np.cumsum([inp[k].shape[1] for k in ("wq", "wk")]), -1) \
                    if name == "col_parallel_shared" else [ct]
                loss = sum(torch.sum(o * _local(c, s, grid) / meg_copies(s, grid))
                           for o, c, s in zip(outs, cts, outs_spec))
                grads = torch.autograd.grad(loss, ins)
                grads = [_sum_replicated_meg(g, s, grid).numpy()
                         for g, s in zip(grads, ins_spec.values())]
                res[f"op/{meg_variant_key(v)}/{name}"] = (
                    [o.detach().numpy() for o in outs], grads)
            res[f"routes/{meg_variant_key(v)}"] = OV.route_table()
            res[f"gate/{meg_variant_key(v)}/seq_loss_ok"] = MEG.seq_loss_ok(
                pctx, T, inp["head"].shape[1])
            res[f"gate/{meg_variant_key(v)}/seq_shardable"] = shd.seq_shardable(pctx.ax, T)
    res["train"] = megatron_train_job(grid, z)
    return res


def _sum_replicated_meg(g, spec, grid):
    from repro_torch.parallel import comm, specs
    for ax in specs.replicated_axes(spec, grid, "megatron"):
        g = comm.raw_psum(g, ax)
    return g


def megatron_train_job(grid, z):
    from repro_torch import bridge
    from repro_torch.config import ParallelConfig, RunConfig, get_smoke_config
    from repro_torch.core import overlap as OV
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.parallel import specs
    from repro_torch.train import step as TS
    tree = {}
    for k in z.files:
        if k.startswith("init/"):
            d = tree
            parts = k[len("init/"):].split("/")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = z[k]
    cfg = get_smoke_config("qwen3-0.6b")
    B, S, steps, lr, nm = 4, 16, 2, 1e-3, 2
    rc = RunConfig("t", "train", S, B, lr=lr, warmup_steps=1)
    ds = SyntheticLM(cfg.vocab_size, S, B)
    out = {}
    for c in MEG_TRAIN_CASES:
        (d, m), lay, ov, wire, fused = c[:5]
        strat = meg_strategy(c)
        if (d, m) != (grid.data, grid.mx * grid.my):
            continue
        pcfg = ParallelConfig(strategy=strat, data=grid.data, mx=grid.mx, my=grid.my,
                              overlap=ov, comm_dtype=wire, residual=lay, microbatches=nm,
                              grad_reduce_dtype="fp32", fused_loss=fused, remat="none")
        params = bridge.shard_master_params_from_jax(tree, grid, device="cpu",
                                                     fused_loss=fused, strategy=strat)
        opt = TS.init_grid_opt_state(params, grid, pcfg)
        step = TS.build_train_step(cfg, pcfg, rc, compute_dtype=torch.float32, mesh=grid)
        OV.clear_routes()
        losses = []
        for s in range(steps):
            lb = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in specs.local_batch(ds.batch_at(s), grid, nm, strat,
                                                lay).items()}
            params, opt, met = step(params, opt, lb)
            losses.append(float(met["loss"]))
        full = bridge.gather_master_params(params, grid, fused_loss=fused, strategy=strat)
        out[meg_case_key(c)] = dict(
            losses=losses, routes=OV.route_table(),
            params={"/".join(p): t.numpy() for p, t in lm.flatten(full)}
            if grid.rank == 0 else None)
    return out


# ---------------------------------------------------------------------------
# the 1F1B pipeline (parallel/pipeline.py): worlds of pods x (data, mx, my)
# ---------------------------------------------------------------------------

def run_pipeline_world(pods, shape, job, args=(), timeout=600.0):
    """Run ``job(grid, *args)`` in every rank of a ``pods`` x (data, mx, my)
    world on the CPU; returns {rank: result}."""
    from repro_torch.parallel import comm
    world = pods * shape[0] * shape[1] * shape[2]
    return comm.run_ranks(_pipe_rank_main, world,
                          (pods, shape, job, args, comm.temp_init_file()), timeout)


def _pipe_rank_main(rank, pods, shape, job, args, init_file):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import Grid
    from repro_torch.parallel import comm
    grid = Grid(*shape, rank, pods=pods)
    comm.init_world(grid, device="cpu", init_file=init_file)
    try:
        result = job(grid, *args)
        comm.barrier()
        return result
    finally:
        comm.shutdown()


def _np_tree(z, prefix):
    out = {}
    for k in z.files:
        if k.startswith(prefix):
            d = out
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = z[k]
    return out


def _pipe_cfgs(kind):
    from _pipeline_cases import NUM, RT
    from repro_torch.config import ModelConfig, RunConfig
    if kind == "num":
        return (ModelConfig(name="pipe-test", family="dense", num_layers=NUM["layers"],
                            d_model=NUM["d"], num_heads=NUM["heads"], num_kv_heads=NUM["kv"],
                            d_ff=NUM["ff"], vocab_size=NUM["vocab"], qk_norm=True),
                RunConfig("pipe", "train", NUM["seq"], NUM["batch"], lr=NUM["lr"],
                          warmup_steps=NUM["warmup"]))
    return (ModelConfig(name="guard-test", family="dense", num_layers=RT["layers"],
                        d_model=RT["d"], num_heads=RT["heads"], num_kv_heads=RT["kv"],
                        d_ff=RT["ff"], vocab_size=RT["vocab"], mlp_kind="swiglu"),
            RunConfig("t", "train", RT["seq"], RT["batch"], lr=RT["lr"]))


def _pipe_pcfg(grid, strategy="hecaton", overlap="none", residual="seq", micro=4):
    from repro_torch.config import ParallelConfig
    return ParallelConfig(strategy=strategy, data=grid.data, mx=grid.mx, my=grid.my,
                          overlap=overlap, residual=residual, microbatches=micro,
                          grad_reduce_dtype="fp32", remat="none", pods=grid.pods,
                          pod_axis_role="pipeline")


def _stage_full(runner, tree):
    """A stage tree of this rank's blocks -> the stage's global arrays
    (numpy), on the stage's rank 0; None elsewhere."""
    from repro_torch.models import lm
    from repro_torch.parallel import specs
    sp = runner.param_specs(tree)
    full = {".".join(p): specs.gather_full(t.detach(), specs.spec_of(sp, p)).numpy()
            for p, t in lm.flatten(tree)}
    return full if runner.stage_grid.rank == 0 else None


def pipeline_num_job(grid, in_path, cases):
    """{name: result} of the cases (of ``_pipeline_cases.CASES``) that run
    on this world's shape."""
    return {c[0]: _pipeline_num_case(grid, in_path, c) for c in cases}


def _pipeline_num_case(grid, in_path, case):
    """One case of ``_pipeline_cases.CASES``: the loss, this stage's global
    gradients, the executed order and stash peak at the initial
    parameters; the ``steps`` case also two optimizer steps (horizon 2)."""
    from repro_torch.bridge import master_params_from_jax
    from repro_torch.models import lm
    from repro_torch.parallel import pipeline as PP
    z = np.load(in_path)
    name, pods, _, strategy, overlap, residual, micro = case
    cfg, rc = _pipe_cfgs("num")
    pcfg = _pipe_pcfg(grid, strategy, overlap, residual, micro)
    runner, step = PP.build_pipeline_train_step(
        cfg, pcfg, rc, grid, total_steps=2 if name == "steps" else 10_000,
        compute_dtype=torch.float32)
    sp = runner.place_params(master_params_from_jax(_np_tree(z, "init/"), device="cpu"))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in runner.local_batch(
        {"tokens": z["batch/tokens"], "labels": z["batch/labels"]}).items()}
    loss, grads = runner.loss_and_grads(sp, batch)
    paths = [p for p, _ in lm.flatten(sp)]
    out = {"stage": runner.stage, "loss": None if loss is None else float(loss),
           "executed": [(t.kind, t.mb) for t in runner.executed],
           "max_stash": runner.max_stash,
           "grads": _stage_full(runner, lm.unflatten(paths, grads))}
    if name == "steps":
        opt = runner.init_opt(sp)
        out["losses"], out["grad_norms"], out["lrs"] = [], [], []
        for _ in range(2):
            sp, opt, m = step(sp, opt, batch)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
            out["lrs"].append(float(m["lr"]))
        out["params"] = _stage_full(runner, sp)
    return out


def _rt_world(grid, z, guard=None):
    """The runtime replays' runner, step, fresh-state and batch makers."""
    from _pipeline_cases import RT
    from repro_torch.bridge import master_params_from_jax
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.parallel import pipeline as PP
    cfg, rc = _pipe_cfgs("rt")
    runner, step = PP.build_pipeline_train_step(cfg, _pipe_pcfg(grid, micro=RT["micro"]), rc,
                                                grid, compute_dtype=torch.float32, guard=guard)
    p0 = _np_tree(z, "rt_init/")
    ds = SyntheticLM(RT["vocab"], RT["seq"], RT["batch"], seed=RT["seed"])

    def fresh():
        sp = runner.place_params(master_params_from_jax(p0, device="cpu"))
        return {"params": sp, "opt_state": runner.init_opt(sp)}

    def batch(i, nan=False):
        b = ds.batch_at(i)
        b["loss_mask"] = np.full((RT["batch"], RT["seq"]), np.nan if nan else 1.0, np.float32)
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in runner.local_batch(b).items()}
    return runner, step, fresh, batch


def _state_leaves(state):
    from repro_torch.checkpoint import manager as M
    return [torch.as_tensor(t).detach().clone() for t in M._leaf_paths(
        {"params": state["params"], "opt_state": state["opt_state"]}).values()]


def _clean(step, fresh, batch, total, bl):
    """A run over the blocklist-filtered stream: (history, final leaves)."""
    from repro_torch.runtime import guard as G
    from repro_torch.train import loop as TL
    st = TL.train(step, fresh(), (batch(G.data_index(s, bl)) for s in range(total)),
                  num_steps=total, log_every=1000, log_fn=lambda *a: None)
    return st["history"], _state_leaves(st)


def pipeline_rt_job(grid, in_path, root, cases, ckpt_args):
    """On the 2x(1x1x2) world: the numerics ``cases`` of its shape, the
    runtime replays (:func:`_pipeline_rt`) and the checkpoints
    (:func:`pipeline_ckpt_job` with ``ckpt_args``)."""
    return {"num": pipeline_num_job(grid, in_path, cases), "rt": _pipeline_rt(grid, in_path, root),
            "ckpt": pipeline_ckpt_job(grid, in_path, *ckpt_args)}


def _pipeline_rt(grid, in_path, root):
    """``check_guard.py``'s B2 and B3 and ``check_checkpoint.py
    --pipeline-quorum`` on this world: rank 0 holds the (stage-pinned,
    two-writer) manager, every rank runs ``run_supervised`` and the same
    guard; each run's record, and whether its resumed steps and final
    state equal (bit for bit) the port's clean run over the filtered
    stream."""
    import os
    from _pipeline_cases import B_POISON, B_TOTAL, Q_TOTAL
    from repro_torch.checkpoint import grid as CG
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config import GuardConfig
    from repro_torch.parallel import pipeline as PP
    from repro_torch.runtime import guard as G
    from repro_torch.runtime.fault import FailureInjector, run_supervised
    from repro_torch.train import loop as TL
    z = np.load(in_path)
    out = {}
    for tag, gkw, in_graph in (("B2", dict(grad_spike_factor=1e9, skip_cap=2, patience=99), True),
                               ("B3", dict(loss_spike_factor=2.0, patience=2, skip_cap=999),
                                False)):
        gc = GuardConfig(**gkw)
        runner, step, fresh, batch = _rt_world(grid, z, gc if in_graph else None)
        d = os.path.join(root, tag)
        mgr = (CheckpointManager(d, keep=5, writers=2, writer_map=PP.stage_writer_map(2))
               if grid.rank == 0 else None)
        ck = CG.GridCheckpointer(mgr, grid, runner.pcfg, runner)
        restored_at, seen = [], []

        def make_state(resume):
            state, start = fresh(), 0
            if resume is not None:
                if mgr is not None:
                    seen.append(list(mgr.all_steps()))
                state, start = CG.restore_pipeline(d, state, runner, mgr, step=resume)
                restored_at.append(start)
            return state, start

        def run_steps(state, start, inc):
            bl = G.load_blocklist(d)
            stream = (batch(G.data_index(s, bl), nan=G.data_index(s, bl) in B_POISON)
                      for s in range(start, B_TOTAL))
            return TL.train(step, state, stream, start_step=start, num_steps=B_TOTAL, ckpt=ck,
                            ckpt_every=2, log_every=1000, guard=G.TrainingGuard(gc),
                            data_index_fn=lambda s: G.data_index(s, bl),
                            log_fn=lambda *a: None)

        state, n = run_supervised(make_state, run_steps, ckpt=ck, sleep_fn=lambda _: None)
        bl = G.load_blocklist(d)
        want_hist, want_leaves = _clean(step, fresh, batch, B_TOTAL, bl)
        got = dict(state["history"])
        out[tag] = dict(history=state["history"], incarnations=n, restored_at=restored_at,
                        seen0=seen[0] if seen else None, blocklist=bl,
                        resume_bit_equal=all(got[s] == x for s, x in want_hist
                                             if s >= restored_at[0]),
                        state_bit_equal=all(torch.equal(a, b) for a, b in
                                            zip(_state_leaves(state), want_leaves)))
    # the pipeline-quorum crash-resume: writer 1 of step 4's save dies
    runner, step, fresh, batch = _rt_world(grid, z)
    d = os.path.join(root, "quorum")
    mgr = (CheckpointManager(d, writers=2, writer_map=PP.stage_writer_map(2))
           if grid.rank == 0 else None)
    ck = CG.GridCheckpointer(mgr, grid, runner.pcfg, runner)
    inj = FailureInjector(writer_fail_at={4: 1})
    seen = []

    def make_state(resume):
        state, start = fresh(), 0
        if resume is not None:
            if mgr is not None:
                seen.append(list(mgr.all_steps()))
            state, start = CG.restore_pipeline(d, state, runner, mgr, step=resume)
        return state, start

    def run_q(state, start, inc):
        return TL.train(step, state, (batch(s) for s in range(start, Q_TOTAL)),
                        start_step=start, num_steps=Q_TOTAL, ckpt=ck, ckpt_every=2,
                        log_every=1000, injector=inj, log_fn=lambda *a: None)

    state, n = run_supervised(make_state, run_q, ckpt=ck, sleep_fn=lambda _: None)
    want_hist, _ = _clean(step, fresh, batch, Q_TOTAL, [])
    got = dict(state["history"])
    writers = None
    if mgr is not None:
        import json
        with open(os.path.join(d, "step_00000008", "MANIFEST.json")) as f:
            writers = {k: v["writer"] for k, v in json.load(f)["manifest"].items()}
    out["quorum"] = dict(history=state["history"], incarnations=n, seen0=seen[0] if seen else None,
                         steps=mgr.all_steps() if mgr is not None else None, log=list(inj.log),
                         writers=writers,
                         resume_bit_equal=all(got[s] == x for s, x in want_hist if s >= 4))
    return out


def pipeline_ckpt_job(grid, in_path, jax_dir, port_dir, byte_dirs):
    """The cross-package checkpoints on this world: JAX's pipeline
    checkpoint in ``jax_dir`` restored and resumed; a run from the initial
    parameters saving its own at step CKPT_STEPS into ``port_dir``; and
    each (source, target, writers, quorum) of ``byte_dirs``: JAX's save of a
    state restored and saved again by this world with that writer layout."""
    from _pipeline_cases import CKPT_STEPS
    from repro_torch.checkpoint import grid as CG
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.parallel import pipeline as PP
    z = np.load(in_path)
    runner, step, fresh, batch = _rt_world(grid, z)

    def manager(d, writers=2, quorum=None):
        return (CheckpointManager(d, writers=writers, quorum=quorum,
                                  writer_map=PP.stage_writer_map(writers))
                if grid.rank == 0 else None)

    def fold(state, start, total, save_to=None):
        p, o, losses = state["params"], state["opt_state"], []
        for i in range(start, total):
            if save_to is not None and i == CKPT_STEPS:
                CG.GridCheckpointer(manager(save_to), grid, runner.pcfg, runner).save_async(
                    i, {"params": p, "opt_state": o})
            p, o, m = step(p, o, batch(i))
            losses.append(float(m["loss"]))
        return losses

    st, start = CG.restore_pipeline(jax_dir, fresh(), runner, manager(jax_dir), step=CKPT_STEPS)
    out = {"from_jax": fold(st, start, 2 * CKPT_STEPS),
           "own": fold(fresh(), 0, 2 * CKPT_STEPS, save_to=port_dir)}
    for src, dst, writers, quorum in byte_dirs:
        st, s0 = CG.restore_pipeline(src, fresh(), runner, manager(src), step=None)
        CG.GridCheckpointer(manager(dst, writers, quorum), grid, runner.pcfg, runner).save_async(
            s0, st)
    return out
