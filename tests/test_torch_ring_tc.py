"""AG-matmul and matmul-RS on Hopper's tensor cores (``csrc/ring_matmul.cu``,
namespace ``ringtc``), and the loopback ring that times every ring kernel
on one card (``kernels/ring_loopback.py``).

On the CPU:

* ``ring_impl`` picks the route from the dtype, shapes and strides alone:
  ``wgmma`` for every bf16 block of rows 5 and 6 that the grid step, its
  backward and megatron's ring of four pass (``chip_smoke.RING_CASES``
  and ``MEG_RING_CASES``), ``wmma`` for the off-8 extents and the ragged
  ones TMA cannot address (a token chunk off the 128-row box, a column
  chunk off 16 bytes), ``simt`` for fp32;
* ``comm.ring_desc`` on integer base addresses gives ``comm.ring``'s
  tuple for rings of 2 and 4 on each axis, wrapping left and right, and a
  loopback ring's n descriptors close the ring;
* the loopback's block cap keeps n grids resident;
* an emulation of the wgmma route's arithmetic (fp32 products summed over
  its 64-deep k-blocks in order; matmul-RS's contribution rounded to the
  input dtype before each hop's fp32 add) against the JAX package's
  ``_tile_mm_raw`` (Pallas in interpret mode) composed in ring order, and
  against the port's global result (``ring_loopback.reference``), at 2e-4
  (fp32) and 2e-2 (bf16); matmul-RS over four bf16 hops against the
  global result at (n + 1) 2^-8 of the partials' magnitudes;
* ``ring_loopback.reference`` against the plain rings of ``kernels/ref.py``
  on a 1x2x2 gloo world (the ``my`` ring of two and the ``model`` ring of
  four), both wires.

Marked ``cuda`` (skipped without a card): the loopback ring on both bf16
routes (and fp32) against the fp32 global result, the route counted.  On
the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ring_tc.py
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ring_matmul as JRM
from repro_torch.kernels import ring_loopback as LB
from repro_torch.kernels import ring_matmul as RM
from repro_torch.launch.mesh import RING_AXES, Grid
from repro_torch.parallel import comm

sys.path.insert(0, str(Path(__file__).resolve().parent))

BF = torch.bfloat16
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
BK = 64                                   # the wgmma route's k-block

# (kernel, x [b, t, h], w [h, o], scatter_dim, ring): the bf16 blocks of rows 5
# and 6 at full width (qwen3-0.6b, a microbatch of 4 x 512): the grid step's
# forward and backward on rings of two, megatron's on its ring of four; the
# gated pair is one matmul-RS over [w1 | w1b]
MAIN_BLOCKS = (
    ("ag_matmul", (4, 256, 512), (512, 512), None, 2),
    ("ag_matmul", (4, 256, 1536), (1536, 512), None, 2),
    ("matmul_rs", (4, 512, 512), (512, 1024), 2, 2),
    ("matmul_rs", (4, 512, 512), (512, 3072), 1, 2),
    ("matmul_rs", (4, 512, 512), (512, 512), 1, 2),
    ("matmul_rs", (4, 512, 512), (512, 1536), 1, 2),
    ("matmul_rs", (4, 512, 512), (512, 1024), 1, 4),
    ("matmul_rs", (4, 512, 768), (768, 1024), 1, 4),
    ("ag_matmul", (4, 128, 1024), (1024, 512), None, 4),
    ("ag_matmul", (4, 128, 1024), (1024, 768), None, 4),
    ("matmul_rs", (4, 512, 512), (512, 1024), 2, 4),
)
# the extents the backward passes without a gate that TMA cannot address
OFF_BLOCKS = (
    ("ag_matmul", (3, 50, 45), (45, 27), None, 2),        # rows off 16 bytes
    ("matmul_rs", (3, 52, 45), (45, 27), 1, 2),
    ("matmul_rs", (2, 100, 200), (200, 264), 2, 2),       # a column chunk of 132
    ("matmul_rs", (2, 100, 200), (200, 264), 1, 2),       # a token chunk of 50
)


def _strides(shape):
    return tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))


def _impl(dtype, kernel, xs, ws, sd, n, **kw):
    return RM.ring_impl(dtype, (xs, ws), (_strides(xs), _strides(ws)), n,
                        sd if kernel == "matmul_rs" else None, **kw)


@pytest.mark.parametrize("block", MAIN_BLOCKS, ids=lambda b: f"{b[0]}-{b[1]}-{b[2]}-n{b[4]}")
def test_main_blocks_take_wgmma_and_fp32_simt(block):
    kernel, xs, ws, sd, n = block
    assert _impl(BF, *block[:4], n) == "wgmma"
    assert _impl(torch.float32, *block[:4], n) == "simt"


@pytest.mark.parametrize("block", OFF_BLOCKS, ids=lambda b: f"{b[0]}-{b[1]}-{b[2]}-sd{b[3]}")
def test_off_blocks_take_wmma(block):
    assert _impl(BF, *block[:4], block[4]) == "wmma"
    assert _impl(torch.float32, *block[:4], block[4]) == "simt"


def test_route_needs_dense_aligned_operands():
    """A ragged AG-matmul that TMA addresses (rows on 16 bytes; M, K and N
    off the tiles: the boxes' zero fill and the epilogue's masks) takes
    wgmma; a gap in x's rows, an address off 16 bytes or a w row off 8
    elements does not."""
    xs, ws = (2, 100, 200), (200, 264)
    assert _impl(BF, "ag_matmul", xs, ws, None, 2) == "wgmma"
    assert RM.ring_impl(BF, (xs, ws), ((100 * 208, 208, 1), _strides(ws)), 2) == "wmma"
    assert _impl(BF, "ag_matmul", xs, ws, None, 2, ptr_align=8) == "wmma"
    assert _impl(BF, "ag_matmul", xs, (200, 260), None, 2) == "wmma"
    # a dim of extent 1 may carry any stride
    assert RM.ring_impl(BF, ((1, 128, 64), (64, 64)), ((7, 64, 1), (64, 1)), 2) == "wgmma"
    with pytest.raises(ValueError):
        RM._choose("wgmma", "wmma", BF)
    with pytest.raises(TypeError):
        RM._choose("wmma", "simt", torch.float32)


def _fake_world(shape, rank, bases, hops):
    grid = Grid(*shape, rank)
    w = comm.World(grid=grid, device=torch.device("cpu"))
    w.bases = dict(bases)
    w.hops = dict(hops)
    comm._WORLD = w
    return w


@pytest.mark.parametrize("shape,ax", [((1, 1, 2), "my"), ((1, 1, 4), "my"), ((1, 2, 1), "mx"),
                                      ((1, 4, 1), "mx"), ((2, 1, 1), "data"),
                                      ((4, 1, 1), "data"), ((1, 2, 2), "model"),
                                      ((1, 1, 2), "model")])
def test_ring_desc_is_comm_ring(shape, ax):
    world = shape[0] * shape[1] * shape[2]
    bases = {r: 0x7f0000000000 + r * 0x40000000 for r in range(world)}
    c = RING_AXES.index(ax)
    f, sl, S = 64 * c, comm._slots_offset(c), comm.SLOT_BYTES
    try:
        for rank in range(world):
            w = _fake_world(shape, rank, bases, {a: 5 for a in RING_AXES})
            ranks = w.grid.axis_ranks(ax)
            n, me = len(ranks), w.grid.axis_index(ax)
            got = comm.ring(ax, n, 1024)
            assert w.hops[ax] == 5 + n - 1
            assert got == comm.ring_desc([bases[r] for r in ranks], me, n, c, 5)
            mine, right = bases[ranks[me]], bases[ranks[(me + 1) % n]]
            left = bases[ranks[(me - 1) % n]]
            assert got == (mine + f, right + f, mine + f + 8, left + f + 8, mine + sl,
                           mine + sl + S, right + sl, right + sl + S, 5, n, me)
            with pytest.raises(ValueError):
                comm.ring(ax, n, S + 1)
    finally:
        comm._WORLD = None


@pytest.mark.parametrize("n", [2, 4])
def test_loopback_descriptors_close_the_ring(n):
    bases = [1 << 40 | r << 32 for r in range(n)]
    c = RING_AXES.index("model")
    ds = [comm.ring_desc(bases, r, n, c, 0) for r in range(n)]
    for r in range(n):
        right, left = ds[(r + 1) % n], ds[(r - 1) % n]
        assert ds[r][1] == right[0]            # my right landed is r + 1's own
        assert ds[r][3] == left[2]             # my left credit is r - 1's own
        assert ds[r][6:8] == right[4:6]        # I write r + 1's slots
        assert ds[r][9:] == (n, r)
    assert ds[n - 1][1] == ds[0][0] and ds[0][3] == ds[n - 1][2]      # it wraps


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("per_sm", [1, 3])
def test_block_cap_keeps_n_grids_resident(n, per_sm):
    cap = LB.block_cap(per_sm, 132, n)
    assert 1 <= cap and n * cap <= per_sm * 132 < n * (cap + 1)
    with pytest.raises(ValueError):
        LB.block_cap(1, 3, 4)


# ---------------------------------------------------------------------------
# the wgmma route's arithmetic
# ---------------------------------------------------------------------------

def _kblocks(a, b):
    """a @ b in fp32, summed over the 64-deep k-blocks in order."""
    a, b = a.float(), b.float()
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], BK):
        acc += a[:, k:k + BK] @ b[k:k + BK]
    return acc


def _emulate_ag(xs, ws):
    n, (b, t, h) = len(xs), xs[0].shape
    outs = []
    for me in range(n):
        out = torch.empty(b, n * t, ws[me].shape[1], dtype=xs[0].dtype)
        for s in range(n):
            src = (me - s) % n
            out[:, src * t:(src + 1) * t] = _kblocks(xs[src].reshape(-1, h), ws[me]).reshape(
                b, t, -1).to(xs[0].dtype)
        outs.append(out)
    return outs


def _rs_part(x, w, d, n, sd):
    """This rank's contribution to destination d, rounded to the input dtype."""
    if sd == 1:
        c = x.shape[1] // n
        y = _kblocks(x[:, d * c:(d + 1) * c].reshape(-1, x.shape[2]), w).reshape(
            x.shape[0], c, -1)
    else:
        c = w.shape[1] // n
        y = _kblocks(x.reshape(-1, x.shape[2]), w[:, d * c:(d + 1) * c]).reshape(
            x.shape[0], x.shape[1], c)
    return y.to(x.dtype)


def _emulate_rs(xs, ws, sd):
    """Destination d's accumulator starts at rank d + 1; each later rank adds
    its rounded contribution to the arriving partial in fp32, rounded once."""
    n = len(xs)
    outs = []
    for d in range(n):
        acc = _rs_part(xs[(d + 1) % n], ws[(d + 1) % n], d, n, sd)
        for r in range(d + 2, d + n + 1):
            acc = (acc.float() + _rs_part(xs[r % n], ws[r % n], d, n, sd).float()).to(acc.dtype)
        outs.append(acc)
    return outs


def _jax(t):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16 if t.dtype == BF else jnp.float32)


def _jmm(a, b):
    """JAX's tile loop (Pallas, interpret mode) on torch inputs, output in a's dtype."""
    return torch.from_numpy(np.array(JRM._tile_mm_raw(_jax(a), _jax(b)).astype(jnp.float32))
                            ).to(a.dtype)


def _jax_ag(xs, ws):
    n, (b, t, h) = len(xs), xs[0].shape
    return [torch.cat([_jmm(xs[src].reshape(-1, h), ws[me]).reshape(b, t, -1)
                       for src in range(n)], dim=1) for me in range(n)]


def _jax_rs(xs, ws, sd):
    n = len(xs)

    def part(r, d):
        x, w = xs[r % n], ws[r % n]
        if sd == 1:
            c = x.shape[1] // n
            return _jmm(x[:, d * c:(d + 1) * c].reshape(-1, x.shape[2]), w).reshape(
                x.shape[0], c, -1)
        c = w.shape[1] // n
        return _jmm(x.reshape(-1, x.shape[2]), w[:, d * c:(d + 1) * c]).reshape(
            x.shape[0], x.shape[1], c)
    outs = []
    for d in range(n):
        acc = part(d + 1, d)
        for r in range(d + 2, d + n + 1):
            acc = (acc.float() + part(r, d).float()).to(acc.dtype)
        outs.append(acc)
    return outs


ARITH_CASES = (
    ("ag_matmul", (2, 128, 192), (192, 80), None, 2),
    ("ag_matmul", (2, 64, 160), (160, 48), None, 4),
    ("matmul_rs", (2, 256, 192), (192, 80), 1, 2),
    ("matmul_rs", (2, 128, 160), (160, 64), 2, 4),
    ("matmul_rs", (1, 512, 128), (128, 96), 1, 4),
)


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ARITH_CASES, ids=lambda c: f"{c[0]}-{c[1]}-n{c[4]}")
def test_wgmma_arithmetic_matches_jax_and_global(case, dtype):
    kernel, xs, ws, sd, n = case
    g = torch.Generator().manual_seed(sum(xs) + n)
    xl = [torch.randn(xs, generator=g).to(dtype) for _ in range(n)]
    wl = [(torch.randn(ws, generator=g) / ws[0] ** 0.5).to(dtype) for _ in range(n)]
    if kernel == "ag_matmul":
        emu, jx = _emulate_ag(xl, wl), _jax_ag(xl, wl)
        want = LB.reference(kernel, xl, wl)
    else:
        emu, jx = _emulate_rs(xl, wl, sd), _jax_rs(xl, wl, sd)
        want = LB.reference(kernel, xl, wl, sd)
    tol = TOL[dtype]
    for e, j, w in zip(emu, jx, want):
        assert e.shape == j.shape == w.shape and e.dtype == j.dtype == w.dtype == dtype
        np.testing.assert_allclose(e.float(), j.float(), atol=tol, rtol=tol)
        if kernel == "matmul_rs" and dtype == BF and n > 2:
            continue                           # held to the magnitude bound below
        np.testing.assert_allclose(e.float(), w.float(), atol=tol, rtol=tol)
    if kernel == "matmul_rs" and dtype == BF and n > 2:
        # n roundings of contributions and n - 1 of partial sums, each at most
        # 2^-8 of the value rounded
        for e, w, m in zip(emu, want, LB.partial_magnitudes(xl, wl, sd)):
            assert ((e.float() - w.float()).abs() <= (n + 1) * 2.0 ** -8 * m + 1e-6).all()


# ---------------------------------------------------------------------------
# the loopback's global result against the plain rings over a gloo world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loopback_ref():
    import _torch_world as TW
    return TW, TW.run_world((1, 2, 2), TW.loopback_ref_job, timeout=300)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16wire", "int8wire"])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("ax", ["my", "model"])
def test_loopback_reference_is_the_plain_ring(loopback_ref, ax, dtype, int8):
    """fp32 sums in another order only: 2e-4 (fp32) or 2e-2 (bf16) on the
    bf16 wire; the int8 wire quantizes the same values, so all but 0.1% of
    the elements agree to that bound and the rest within one int8 level
    (the tensor's largest magnitude over 127)."""
    TW, res = loopback_ref
    tol = TOL[torch.float32 if dtype == "torch.float32" else BF]
    for rank, out in res.items():
        for i in range(len(TW.LOOPBACK_REF_CASES)):
            want, plain = out[(ax, i, dtype, int8)]
            assert want.shape == plain.shape
            scale = max(1.0, float(np.abs(plain).max()))
            if not int8:
                np.testing.assert_allclose(want, plain, atol=tol * scale, rtol=tol)
                continue
            off = np.abs(want - plain) > tol * scale + tol * np.abs(plain)
            assert off.mean() <= 1e-3, (rank, i, off.mean())
            np.testing.assert_allclose(want, plain, rtol=tol,
                                       atol=tol * scale + np.abs(plain).max() / 127)


# ---------------------------------------------------------------------------
# on the card: the loopback ring on both routes
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = (
    ("ag_matmul", (2, 256, 192), (192, 136), None, 2),
    ("ag_matmul", (2, 100, 200), (200, 264), None, 2),
    ("matmul_rs", (2, 256, 192), (192, 136), 1, 2),
    ("matmul_rs", (2, 100, 192), (192, 256), 2, 2),
    ("matmul_rs", (2, 512, 192), (192, 136), 1, 4),
    ("ag_matmul", (2, 128, 320), (320, 64), None, 4),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: f"{c[0]}-{c[1]}-n{c[4]}")
def test_loopback_routes_match_global(dev, case, dtype):
    """Every route the operands admit (wgmma and wmma for bf16, simt for
    fp32) against the fp32 global result, over three calls (the first from
    hop 0, the next two carrying the hops on), the launches counted on it."""
    from repro_torch.kernels import ops
    kernel, xs, ws, sd, n = case
    lb = LB.LoopbackRing(n, "model" if n == 4 else "my", dev)
    g = torch.Generator(device=dev).manual_seed(sum(xs) + n)
    xl = [torch.randn(xs, generator=g, device=dev).to(dtype) for _ in range(n)]
    wl = [(torch.randn(ws, generator=g, device=dev) / ws[0] ** 0.5).to(dtype) for _ in range(n)]
    want = LB.reference(kernel, xl, wl, sd)
    chosen = _impl(dtype, kernel, xs, ws, sd, n)
    routes = [chosen] + (["wmma"] if chosen == "wgmma" else [])
    for route in routes:
        ops.reset_launches()
        for reset in (True, False, False):
            outs = (LB.ag_matmul(lb, xl, wl, impl=route, reset=reset) if kernel == "ag_matmul"
                    else LB.matmul_rs(lb, xl, wl, sd, impl=route, reset=reset))
            torch.cuda.synchronize()
            for o, w, m in zip(outs, want, LB.partial_magnitudes(xl, wl, sd)
                               if kernel == "matmul_rs" else want):
                assert o.shape == w.shape and o.dtype == w.dtype
                if kernel == "matmul_rs" and dtype == BF and n > 2:
                    assert ((o.float() - w.float()).abs() <= (n + 1) * 2.0 ** -8 * m
                            + 1e-6).all()
                else:
                    torch.testing.assert_close(o.float(), w.float(), atol=TOL[dtype],
                                               rtol=TOL[dtype])
        assert RM.IMPL_LAUNCHES[kernel][route] == 3 * n, RM.IMPL_LAUNCHES


@pytest.mark.cuda
def test_loopback_int8_and_contract_match_global(dev):
    """The tile loop's other kernels over the loopback (fp32: the simt route,
    named): the contracted ring and the three int8 variants (the int8
    wire's emulated semantics)."""
    n, xs, o = 2, (2, 64, 96), 80
    lb = LB.LoopbackRing(n, "my", dev)
    g = torch.Generator(device=dev).manual_seed(3)
    xl = [torch.randn(xs, generator=g, device=dev) for _ in range(n)]
    wl = [torch.randn(xs[2], o, generator=g, device=dev) / xs[2] ** 0.5 for _ in range(n)]
    wc = [torch.randn(n * xs[2], o, generator=g, device=dev) / (n * xs[2]) ** 0.5
          for _ in range(n)]
    runs = (("ag_matmul_contract", LB.ag_matmul_contract(lb, xl, wc, impl="simt", reset=True),
             wc, None, False),
            ("ag_matmul", LB.ag_matmul(lb, xl, wl, int8=True, impl="simt"), wl, None, True),
            ("matmul_rs", LB.matmul_rs(lb, xl, wl, 1, int8=True, impl="simt"), wl, 1, True),
            ("ag_matmul_contract", LB.ag_matmul_contract(lb, xl, wc, int8=True, impl="simt"), wc,
             None, True))
    torch.cuda.synchronize()
    for kernel, outs, ws, sd, int8 in runs:
        want = LB.reference(kernel, xl, ws, sd, int8=int8)
        for a, b in zip(outs, want):
            err = (a - b).abs()
            assert (err > 2e-4 * (1 + b.abs())).float().mean() <= 1e-3, kernel
            assert float(err.max()) <= 2e-4 * (1 + float(b.abs().max())) + \
                float(b.abs().max()) / 127, kernel
