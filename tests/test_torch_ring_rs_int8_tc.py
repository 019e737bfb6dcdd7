"""The int8 wire's matmul-RS and the bf16 wire's contracted AG-matmul on
Hopper's tensor cores (``csrc/ring_matmul.cu``: ``ringtc::rs_int8_wgmma``
and ``ringtc::contract_wgmma<false>``).

On the CPU:

* ``ring_impl`` picks ``wgmma`` for the int8 matmul-RS (over tokens and
  over columns, and the gated pair with its ``split``) and the bf16
  contracted AG-matmul at the grid step's blocks on the ring of two
  (``chip_smoke.RING_CASES``) and megatron's on the ring of four
  (``MEG_RING_CASES``), ``simt`` for fp32, and the tile loop (``wmma``)
  for a token chunk off the 128-row box, widths off 8 elements, a split
  off 8 columns, a gap in x's rows or an address off 16 bytes;
* an emulation of the routes' arithmetic.  The int8 matmul-RS: each
  step's contribution summed in fp32 over the 64-deep k-blocks and rounded
  to the input dtype, the arriving accumulator (``quant_int8``, per row
  segment for the gated pair) dequantized as bf16(q s) from one fp32
  product, the two added in fp32 and rounded once, then requantized for
  the next hop.  The contracted ring: one fp32 sum carried across the
  steps, rounded once.  Both against the JAX package (``repro.core.quant``
  and ``_tile_mm_raw``, Pallas in interpret mode, composed in ring order),
  against ``ring_loopback.reference`` and, for the matmul-RS, against
  ``ref.matmul_rs_int8_plain`` / ``ref.matmul_rs_pair_int8_plain`` run by
  n threads over a ring of hops emulated in this process, at 2e-4 (fp32)
  and 2e-2 (bf16); on the int8 wire at most 0.1% of the elements may lie
  one int8 level (max |want| / 127) further.

Marked ``cuda`` (skipped without a card): the loopback ring on both bf16
routes, the launches counted on each; the contracted ring under a block
cap of 2 (its sums through the fp32 buffer in device memory); the int8
matmul-RS on a ring of four at a few blocks (step s + 2 folds into the
buffer whose rows step s quantized).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ring_rs_int8_tc.py
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import ref
from repro_torch.kernels import ring_loopback as LB
from repro_torch.kernels import ring_matmul as RM
from repro_torch.parallel import comm

BF = torch.bfloat16
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SHARE = 1e-3                              # elements that may lie one int8 level further
BK = 64                                   # the wgmma route's k-block

# (kernel, x [b, t, h], w, scatter_dim, ring, split): rows 6i and 7 at full width
# (qwen3-0.6b, a microbatch of 4 x 512): the grid step's forward and backward on rings
# of two (chip_smoke.RING_CASES; the gated pair one matmul-RS over [w1 | w1b], each half
# of a row its own scale), megatron's on its ring of four (MEG_RING_CASES)
MAIN_BLOCKS = (
    ("matmul_rs", (4, 512, 512), (512, 1024), 2, 2, 0),
    ("matmul_rs", (4, 512, 512), (512, 3072), 1, 2, 1536),
    ("matmul_rs", (4, 512, 512), (512, 512), 1, 2, 0),
    ("matmul_rs", (4, 512, 512), (512, 1536), 1, 2, 0),
    ("ag_matmul_contract", (4, 512, 512), (1024, 512), None, 2, 0),
    ("matmul_rs", (4, 512, 512), (512, 1024), 1, 4, 0),
    ("matmul_rs", (4, 512, 768), (768, 1024), 1, 4, 0),
    ("matmul_rs", (4, 512, 512), (512, 1024), 2, 4, 0),
    ("ag_matmul_contract", (4, 512, 256), (1024, 512), None, 4, 0),
)
# what the tile loop keeps: a token chunk off 128 rows, widths off 8 elements, a split
# off 8 columns
OFF_BLOCKS = (
    ("matmul_rs", (2, 100, 200), (200, 264), 1, 2, 0),     # a token chunk of 50
    ("matmul_rs", (3, 52, 45), (45, 27), 1, 2, 0),         # h 45, o 27
    ("matmul_rs", (2, 100, 200), (200, 264), 2, 2, 0),     # a column chunk of 132
    ("matmul_rs", (4, 512, 512), (512, 3080), 1, 2, 1540),  # the pair's split
    ("ag_matmul_contract", (3, 50, 45), (90, 27), None, 2, 0),
    ("ag_matmul_contract", (2, 64, 96), (192, 44), None, 2, 0),  # o 44
)


def _strides(shape):
    return tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))


def _impl(dtype, block, strides=None, **kw):
    kernel, xs, ws, sd, n, split = block
    return RM.ring_impl(dtype, (xs, ws), strides or (_strides(xs), _strides(ws)), n, sd,
                        int8=kernel == "matmul_rs", contract=kernel == "ag_matmul_contract",
                        split=split, **kw)


def _ids(b):
    return f"{b[0]}-{b[1]}-{b[2]}-sd{b[3]}-n{b[4]}"


@pytest.mark.parametrize("block", MAIN_BLOCKS, ids=_ids)
def test_main_blocks_take_wgmma_and_fp32_simt(block):
    assert _impl(BF, block) == "wgmma"
    assert _impl(torch.float32, block) == "simt"


@pytest.mark.parametrize("block", OFF_BLOCKS, ids=_ids)
def test_off_blocks_take_the_tile_loop(block):
    assert _impl(BF, block) == "wmma"
    assert _impl(torch.float32, block) == "simt"


@pytest.mark.parametrize("kernel", ["matmul_rs", "ag_matmul_contract"])
def test_gaps_and_addresses_keep_the_tile_loop(kernel):
    """A gap in x's rows or an address off 16 bytes takes the tile loop;
    the int8 matmul-RS's hop rows need no 16 bytes of int8 (h 24 is on
    the bf16 rows' 16 bytes), and both kernels count their routes."""
    ws = (32, 64) if kernel == "matmul_rs" else (64, 64)
    block = (kernel, (2, 256, 32), ws, 1 if kernel == "matmul_rs" else None, 2, 0)
    assert _impl(BF, block) == "wgmma"
    assert _impl(BF, block, ((256 * 48, 48, 1), _strides(ws))) == "wmma"
    assert _impl(BF, block, ptr_align=8) == "wmma"
    if kernel == "matmul_rs":
        assert _impl(BF, (kernel, (2, 256, 24), (24, 64), 1, 2, 0)) == "wgmma"
    assert kernel in RM.ROUTED and kernel + "_int8" in RM.ROUTED
    assert set(RM.ROUTED) == set(RM.IMPL_LAUNCHES) <= set(RM.KERNEL_IDS)


# ---------------------------------------------------------------------------
# the routes' arithmetic
# ---------------------------------------------------------------------------

def _kblocks_into(acc, a, b):
    """acc += a @ b in fp32, summed over the 64-deep k-blocks in order."""
    a, b = a.float(), b.float()
    for k in range(0, a.shape[1], BK):
        acc += a[:, k:k + BK] @ b[k:k + BK]
    return acc


def _part(x, w, d, n, sd):
    """This rank's contribution to destination d in fp32 k-block sums, rounded to
    the input dtype."""
    if sd == 1:
        c = x.shape[1] // n
        a, b = x[:, d * c:(d + 1) * c].reshape(-1, x.shape[2]), w
        shape = (x.shape[0], c, -1)
    else:
        c = w.shape[1] // n
        a, b = x.reshape(-1, x.shape[2]), w[:, d * c:(d + 1) * c]
        shape = (x.shape[0], x.shape[1], -1)
    return _kblocks_into(torch.zeros(a.shape[0], b.shape[1]), a, b).reshape(shape).to(x.dtype)


def _wire(acc, split):
    """The accumulator as the int8 hop delivers it: bf16(q s) (or fp32), per
    row segment ([0, split), [split, N)) when split is given."""
    if split:
        return torch.cat([_wire(acc[..., :split], 0), _wire(acc[..., split:], 0)], dim=-1)
    return Q.dequant_int8(*Q.quant_int8(acc), acc.dtype)


def _emulate_rs_int8(xs, ws, sd, split):
    """Destination d's accumulator starts at rank d + 1 with its rounded
    contribution; each later rank adds its rounded contribution to the
    arriving accumulator, dequantized, in fp32, rounded once."""
    n = len(xs)
    outs = []
    for d in range(n):
        acc = _part(xs[(d + 1) % n], ws[(d + 1) % n], d, n, sd)
        for r in range(d + 2, d + n + 1):
            y = _part(xs[r % n], ws[r % n], d, n, sd)
            acc = (_wire(acc, split).float() + y.float()).to(acc.dtype)
        outs.append(acc)
    return outs


def _emulate_contract(xs, ws, out_dtype):
    n, hl = len(xs), xs[0].shape[2]
    outs = []
    for me in range(n):
        acc = torch.zeros(xs[0].shape[0] * xs[0].shape[1], ws[me].shape[1])
        for s in range(n):                      # one fp32 sum carried across the steps
            src = (me - s) % n
            _kblocks_into(acc, xs[src].reshape(-1, hl), ws[me][src * hl:(src + 1) * hl])
        outs.append(acc.reshape(*xs[0].shape[:2], -1).to(out_dtype))
    return outs


def _jax_case(case, dtype, xl, wl):
    """The JAX package's tile loop and quantization composed in ring order."""
    import jax.numpy as jnp

    from repro.core import quant as JQ
    from repro.kernels import ring_matmul as JRM
    kernel, xs, ws, sd, n, split, out_dtype = case
    jdt = jnp.bfloat16 if dtype == BF else jnp.float32
    jx = [jnp.asarray(x.float().numpy(), dtype=jdt) for x in xl]
    jw = [jnp.asarray(w.float().numpy(), dtype=jdt) for w in wl]
    outs = []
    if kernel == "ag_matmul_contract":
        h = xs[2]
        for me in range(n):
            acc = None
            for s in range(n):
                src = (me - s) % n
                p = JRM._tile_mm_raw(jx[src].reshape(-1, h), jw[me][src * h:(src + 1) * h],
                                     out_dtype=jnp.float32)
                acc = p if acc is None else acc + p
            out = acc.reshape(xs[0], xs[1], -1).astype(jnp.float32 if out_dtype else jdt)
            outs.append(np.asarray(out.astype(jnp.float32)))
        return outs

    def part(r, d):
        x, w = jx[r % n], jw[r % n]
        if sd == 1:
            c = xs[1] // n
            return JRM._tile_mm_raw(x[:, d * c:(d + 1) * c].reshape(-1, xs[2]), w).reshape(
                xs[0], c, -1)
        c = ws[1] // n
        return JRM._tile_mm_raw(x.reshape(-1, xs[2]), w[:, d * c:(d + 1) * c]).reshape(
            xs[0], xs[1], c)

    def wire(a):
        if split:
            return jnp.concatenate([wire_seg(a[..., :split]), wire_seg(a[..., split:])], -1)
        return wire_seg(a)

    def wire_seg(a):
        return JQ.dequant_int8(*JQ.quant_int8(a), jdt)

    for d in range(n):
        acc = part(d + 1, d)
        for r in range(d + 2, d + n + 1):
            acc = (wire(acc).astype(jnp.float32) + part(r, d).astype(jnp.float32)).astype(jdt)
        outs.append(np.asarray(acc.astype(jnp.float32)))
    return outs


def _plain_rs_ring(xl, wl, sd, split):
    """``ref.matmul_rs_int8_plain`` (``_pair_int8_plain`` when ``split``) on
    each of the n ranks' inputs, the n ranks as threads whose quantized hops
    meet at a barrier: each hop hands on the left neighbour's accumulator
    quantized and dequantized as ``comm.raw_q_hop`` does."""
    n = len(xl)
    who, bar, box = threading.local(), threading.Barrier(n, timeout=60), {}

    def hop(x, ax, shift=1, comm_dtype="bf16"):
        assert shift == 1 and Q.hop_int8(comm_dtype, x.shape, x.dtype)
        box[who.rank] = x
        bar.wait()
        got = box[(who.rank - 1) % n]
        bar.wait()                              # every rank has read its neighbour's
        return Q.dequant_int8(*Q.quant_int8(got), got.dtype)

    outs, errs = [None] * n, []

    def rank(r):
        who.rank = r
        try:
            if split:
                w1, w1b = wl[r][:, :split], wl[r][:, split:]
                outs[r] = torch.cat(ref.matmul_rs_pair_int8_plain(
                    xl[r], w1, w1b, "my", scatter_dim=sd), dim=-1)
            else:
                outs[r] = ref.matmul_rs_int8_plain(xl[r], wl[r], "my", scatter_dim=sd)
        except Exception as e:                  # raised below, in the caller's thread
            errs.append(e)
            bar.abort()

    saved = comm.axis_size, comm.axis_index, comm.raw_ring_hop
    comm.axis_size, comm.axis_index = (lambda ax: n), (lambda ax: who.rank)
    comm.raw_ring_hop = hop
    try:
        threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        comm.axis_size, comm.axis_index, comm.raw_ring_hop = saved
    if errs:
        raise errs[0]
    return outs


# (kernel, x [b, t, h], w, scatter_dim, ring, split, out dtype of the contracted ring or
# None): ragged rows and a partial last k-block, both ring sizes, tokens and columns,
# the gated pair.  A ring of four multiplies at the same per-step shapes as its ring of
# two, so JAX's tile loop compiles each shape once.
ARITH_CASES = (
    ("matmul_rs", (2, 256, 96), (96, 64), 1, 2, 0, None),
    ("matmul_rs", (2, 128, 160), (160, 96), 2, 2, 0, None),
    ("matmul_rs", (2, 256, 96), (96, 128), 1, 2, 64, None),
    ("matmul_rs", (2, 512, 96), (96, 64), 1, 4, 0, None),
    ("matmul_rs", (2, 128, 160), (160, 192), 2, 4, 0, None),
    ("ag_matmul_contract", (2, 48, 80), (160, 64), None, 2, 0, None),
    ("ag_matmul_contract", (2, 48, 80), (320, 64), None, 4, 0, None),
    ("ag_matmul_contract", (2, 48, 80), (160, 64), None, 2, 0, torch.float32),
)


def _inputs(case, dtype):
    kernel, xs, ws, sd, n, split, _ = case
    g = np.random.default_rng(sum(xs) + sum(ws) + n)
    xl = [torch.from_numpy(g.standard_normal(xs, dtype=np.float32)).to(dtype) for _ in range(n)]
    wl = [torch.from_numpy(g.standard_normal(ws, dtype=np.float32) / ws[0] ** 0.5).to(dtype)
          for _ in range(n)]
    return xl, wl


@pytest.fixture(scope="module")
def arith():
    """Every arithmetic case's emulation and what it is held against, in fp32
    and bf16: JAX's, the global result, and the plain ring (matmul-RS)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # small ops: thread start-up dominates
    try:
        return _arith_results()
    finally:
        torch.set_num_threads(threads)


def _arith_results():
    res = {}
    for i, case in enumerate(ARITH_CASES):
        kernel, xs, ws, sd, n, split, out_dtype = case
        for dtype in (torch.float32, BF):
            xl, wl = _inputs(case, dtype)
            wants = [_jax_case(case, dtype, xl, wl)]
            if kernel == "matmul_rs":
                emu = _emulate_rs_int8(xl, wl, sd, split)
                wants.append(LB.reference(kernel, xl, wl, sd, int8=True, split=split))
                wants.append(_plain_rs_ring(xl, wl, sd, split))
            else:
                emu = _emulate_contract(xl, wl, out_dtype or dtype)
                wants.append(LB.reference(kernel, xl, wl, out_dtype=out_dtype))
            res[(i, dtype)] = emu, wants
    return res


def _close(got, want, tol, int8):
    """Within tol (absolute over the tensor's scale and relative); on the int8
    wire all but SHARE of the elements, those within one int8 level further."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want)
    bound = tol * scale + tol * np.abs(want)
    if not int8:
        assert (err <= bound).all(), float(err.max())
        return
    assert (err > bound).mean() <= SHARE, (err > bound).mean()
    assert err.max() <= tol * scale + tol * np.abs(want).max() + np.abs(want).max() / 127


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("i", range(len(ARITH_CASES)),
                         ids=[_ids(c) + ("-f32out" if c[6] else "") + (f"-split{c[5]}" if c[5]
                                                                       else "")
                              for c in ARITH_CASES])
def test_wgmma_arithmetic_matches_jax_global_and_plain(arith, i, dtype):
    kernel, out_dtype = ARITH_CASES[i][0], ARITH_CASES[i][6] or dtype
    emu, wants = arith[(i, dtype)]
    for want in wants:
        for e, w in zip(emu, want):
            assert e.dtype == out_dtype
            w = w.float().numpy() if isinstance(w, torch.Tensor) else w
            _close(e.float().numpy(), w, TOL[out_dtype], kernel == "matmul_rs")


def test_rs_emulation_requantizes_every_hop(arith):
    """In fp32 the int8 matmul-RS's emulation fails the fp32 bound against
    the bf16 wire's exact sum, as a kernel that skipped a requantization
    would; and the gated pair's halves each take their own scale."""
    kernel, xs, ws, sd, n, split, _ = ARITH_CASES[0]
    xl, wl = _inputs(ARITH_CASES[0], torch.float32)
    emu = arith[(0, torch.float32)][0]
    with pytest.raises(AssertionError):
        for e, w in zip(emu, LB.reference(kernel, xl, wl, sd)):
            _close(e.numpy(), w.numpy(), TOL[torch.float32], False)
    acc = torch.cat([torch.full((4, 8), 100.0), torch.full((4, 8), 0.3)], dim=1)
    assert torch.equal(_wire(acc, 8), acc)       # each half's max is its own scale's 127
    assert not torch.equal(_wire(acc, 0), acc)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(dev, xs, ws, n, seed, dtype=BF):
    g = torch.Generator(device=dev).manual_seed(seed)
    xl = [torch.randn(xs, generator=g, device=dev).to(dtype) for _ in range(n)]
    wl = [(torch.randn(ws, generator=g, device=dev) / ws[0] ** 0.5).to(dtype) for _ in range(n)]
    return xl, wl


# (kernel, x, w, scatter_dim, ring, split): both scatter dims, the pair, partial tiles
CARD_CASES = (
    ("matmul_rs", (2, 256, 192), (192, 136), 1, 2, 0),
    ("matmul_rs", (2, 100, 208), (208, 272), 2, 2, 0),
    ("matmul_rs", (2, 256, 192), (192, 272), 1, 2, 136),
    ("matmul_rs", (1, 512, 320), (320, 200), 1, 4, 0),
    ("ag_matmul_contract", (2, 256, 192), (384, 136), None, 2, 0),
    ("ag_matmul_contract", (2, 100, 208), (832, 264), None, 4, 0),
)


def _run(lb, kernel, xl, wl, sd, split, **kw):
    if kernel == "matmul_rs":
        return LB.matmul_rs(lb, xl, wl, sd, int8=True, split=split, **kw)
    return LB.ag_matmul_contract(lb, xl, wl, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=_ids)
def test_loopback_routes_match_global(dev, case, dtype):
    """Every route the operands admit (wgmma and wmma for bf16, simt for
    fp32) against the global result, over three calls (the first from hop
    0), the launches counted on the route."""
    from repro_torch.kernels import ops
    kernel, xs, ws, sd, n, split = case
    lb = LB.LoopbackRing(n, "model" if n == 4 else "my", dev)
    xl, wl = _card_inputs(dev, xs, ws, n, sum(xs) + n, dtype)
    int8 = kernel == "matmul_rs"
    want = LB.reference(kernel, xl, wl, sd, int8=int8, split=split)
    chosen = _impl(dtype, case)
    name = kernel + ("_int8" if int8 else "")
    for route in [chosen] + (["wmma"] if chosen == "wgmma" else []):
        ops.reset_launches()
        for reset in (True, False, False):
            outs = _run(lb, kernel, xl, wl, sd, split, impl=route, reset=reset)
            torch.cuda.synchronize()
            for o, w in zip(outs, want):
                assert o.dtype == w.dtype
                _close(o.float().cpu().numpy(), w.float().cpu().numpy(), TOL[dtype], int8)
        assert RM.IMPL_LAUNCHES[name][route] == 3 * n, RM.IMPL_LAUNCHES
        assert ops.LAUNCHES[name] == 3 * n


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [BF, torch.float32], ids=["bf16out", "fp32out"])
@pytest.mark.parametrize("n", [2, 4])
def test_contract_accumulator_in_registers_and_in_memory(dev, n, out_dtype):
    """The bf16 wire's contracted kernel with its sums in registers (every
    block owns at most one tile) and under a block cap of 2 (15 tiles: the
    sums go through the fp32 buffer in device memory)."""
    xs, hl, o = (2, 300, 256), 256, 328
    lb = LB.LoopbackRing(n, "model" if n == 4 else "my", dev)
    xl, wl = _card_inputs(dev, xs, (n * hl, o), n, 41 + n)
    want = LB.reference("ag_matmul_contract", xl, wl, out_dtype=out_dtype)
    cap = lb.cap("ag_matmul_contract", BF, "wgmma", out_dtype)
    for blocks in (cap, 2):
        for reset in (True, False):
            outs = lb.run(lambda r, ring_of, cnt: RM._launch_contract(
                xl[r], wl[r], ring_of, n, out_dtype, False, counters=cnt, blocks=blocks,
                impl="wgmma"), reset)
            torch.cuda.synchronize()
            for a, w in zip(outs, want):
                assert a.dtype == out_dtype
                _close(a.float().cpu().numpy(), w.float().cpu().numpy(), TOL[out_dtype], False)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [0, 3])
def test_rs_int8_ring_of_four_reuses_its_buffers(dev, blocks):
    """The int8 matmul-RS on the ring of four, megatron's O-projection over
    tokens and a gated pair: step s + 2 folds into the buffer whose rows step
    s quantized, at the loopback's cap and at 3 blocks a rank (each block
    loops over many tiles and rows), over three calls."""
    n = 4
    lb = LB.LoopbackRing(n, "model", dev)
    for xs, ws, split in (((4, 512, 512), (512, 1024), 0), ((2, 512, 256), (256, 512), 256)):
        xl, wl = _card_inputs(dev, xs, ws, n, 51 + split)
        want = LB.reference("matmul_rs", xl, wl, 1, int8=True, split=split)
        cap = blocks or lb.cap("matmul_rs_int8", BF, "wgmma")
        for reset in (True, False, False):
            outs = lb.run(lambda r, ring_of, cnt: RM._launch_rs(
                xl[r], wl[r], ring_of, 1, n, True, split, counters=cnt, blocks=cap,
                impl="wgmma"), reset)
            torch.cuda.synchronize()
            for a, w in zip(outs, want):
                _close(a.float().cpu().numpy(), w.float().cpu().numpy(), TOL[BF], True)
