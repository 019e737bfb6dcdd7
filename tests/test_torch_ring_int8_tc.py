"""The int8 wire's AG-matmul and contracted AG-matmul on Hopper's tensor cores
(``csrc/ring_matmul.cu``: ``ringtc::ag_wgmma<true>`` and
``ringtc::contract_int8_wgmma``; the dequantizing stage in ``csrc/wg.cuh``).

On the CPU:

* ``ring_impl(..., int8=True)`` picks the route from the dtype, shapes and
  strides alone: ``wgmma`` for the int8 grid's AG-matmul and contracted
  blocks (``chip_smoke.RING_CASES`` on the ring of two, megatron's on the
  ring of four), ``simt`` for fp32, ``wmma`` for a shard whose int8 rows
  are off 16 bytes or an output off 8 columns (the int8 matmul-RS and the
  bf16 contracted ring: ``tests/test_torch_ring_rs_int8_tc.py``);
* an emulation of the routes' arithmetic: this rank's own shard exact,
  every other one quantized (``quant_int8``) and dequantized as bf16(q s)
  from one fp32 product, summed in fp32 over the 64-deep k-blocks in ring
  order (the contracted ring's sum carried across the steps and rounded
  once), against the JAX package (``repro.core.quant`` and
  ``_tile_mm_raw``, Pallas in interpret mode, composed in ring order) and
  against ``ring_loopback.reference(int8=True)``, at 2e-4 (fp32) and 2e-2
  (bf16), at most 0.1% of the elements one int8 level (max |want| / 127)
  further;
* the pair's quantization rule (one division, half to even) at quotients
  on and next to half-integers, against the JAX package's ``quant_int8``,
  bit for bit.

Marked ``cuda`` (skipped without a card): the loopback ring on both bf16
routes, the launches counted on each; the contracted kernel under a block
cap of 2 (its sums through the fp32 buffer in device memory) beside the
uncapped grid (its sums in registers), bf16 and fp32 out; a bf16 and then
an int8 AG-matmul on one loopback ring at one block (the slot maps are
keyed on the element type); the pair that crossed the last hop against
``quant_int8``, bit for bit.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ring_int8_tc.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import ring_loopback as LB
from repro_torch.kernels import ring_matmul as RM

BF = torch.bfloat16
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SHARE = 1e-3                              # elements that may lie one int8 level further
BK = 64                                   # the wgmma route's k-block

# (kernel, x [b, t, h], w, ring): the bf16 blocks of rows 5i and 7i at full width
# (qwen3-0.6b, a microbatch of 4 x 512) on the int8 wire: the grid step's forward and
# backward on rings of two (chip_smoke.RING_CASES), megatron's on its ring of four
# (MEG_RING_CASES); the backward's AG-matmuls repeat these shapes
MAIN_BLOCKS = (
    ("ag_matmul", (4, 256, 512), (512, 512), 2),
    ("ag_matmul", (4, 256, 1536), (1536, 512), 2),
    ("ag_matmul_contract", (4, 512, 512), (1024, 512), 2),
    ("ag_matmul", (4, 128, 1024), (1024, 512), 4),
    ("ag_matmul", (4, 128, 1024), (1024, 768), 4),
    ("ag_matmul_contract", (4, 512, 256), (1024, 512), 4),
)
# shards whose int8 rows are off 16 bytes, or outputs off 8 columns: the tile loop
OFF_BLOCKS = (
    ("ag_matmul", (2, 100, 200), (200, 264), 2),          # h 200: int8 rows off 16 bytes
    ("ag_matmul", (3, 50, 45), (45, 27), 2),
    ("ag_matmul_contract", (2, 100, 200), (400, 264), 2),  # hl 200
    ("ag_matmul", (2, 64, 128), (128, 60), 2),            # o 60
    ("ag_matmul_contract", (2, 64, 96), (384, 44), 4),    # o 44
)


def _strides(shape):
    return tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))


def _impl(dtype, kernel, xs, ws, n, **kw):
    return RM.ring_impl(dtype, (xs, ws), (_strides(xs), _strides(ws)), n, int8=True,
                        contract=kernel == "ag_matmul_contract", **kw)


@pytest.mark.parametrize("block", MAIN_BLOCKS, ids=lambda b: f"{b[0]}-{b[1]}-{b[2]}-n{b[3]}")
def test_int8_main_blocks_take_wgmma_and_fp32_simt(block):
    kernel, xs, ws, n = block
    assert _impl(BF, kernel, xs, ws, n) == "wgmma"
    assert _impl(torch.float32, kernel, xs, ws, n) == "simt"


@pytest.mark.parametrize("block", OFF_BLOCKS, ids=lambda b: f"{b[0]}-{b[1]}-{b[2]}-n{b[3]}")
def test_int8_off_blocks_take_the_tile_loop(block):
    kernel, xs, ws, n = block
    assert _impl(BF, kernel, xs, ws, n) == "wmma"
    assert _impl(torch.float32, kernel, xs, ws, n) == "simt"


def test_int8_route_needs_sixteen_byte_rows_and_keeps_the_others_on_the_tile_loop():
    """h 24 is on 16 bytes in bf16 but not in int8; a gap in x's rows or an
    address off 16 bytes takes the tile loop; the int8 matmul-RS and the bf16
    contracted ring take wgmma too at a full-width block
    (tests/test_torch_ring_rs_int8_tc.py holds their routes)."""
    xs, ws = (2, 64, 24), (24, 64)
    assert RM.ring_impl(BF, (xs, ws), (_strides(xs), _strides(ws)), 2) == "wgmma"
    assert _impl(BF, "ag_matmul", xs, ws, 2) == "wmma"
    xs = (2, 64, 32)
    assert _impl(BF, "ag_matmul", xs, (32, 64), 2) == "wgmma"
    assert RM.ring_impl(BF, (xs, (32, 64)), ((64 * 48, 48, 1), (64, 1)), 2, int8=True) == "wmma"
    assert _impl(BF, "ag_matmul", xs, (32, 64), 2, ptr_align=8) == "wmma"
    assert RM.ring_impl(BF, ((4, 512, 512), (512, 1024)), ((512 * 512, 512, 1), (1024, 1)), 2,
                        1, int8=True) == "wgmma"
    assert RM.ring_impl(BF, ((4, 512, 512), (1024, 512)), ((512 * 512, 512, 1), (512, 1)), 2,
                        contract=True) == "wgmma"
    assert set(RM.ROUTED) <= set(RM.IMPL_LAUNCHES)
    assert {"ag_matmul_int8", "ag_matmul_contract_int8"} <= set(RM.KERNEL_IDS)


# ---------------------------------------------------------------------------
# the routes' arithmetic
# ---------------------------------------------------------------------------

def _kblocks_into(acc, a, b):
    """acc += a @ b in fp32, summed over the 64-deep k-blocks in order."""
    a, b = a.float(), b.float()
    for k in range(0, a.shape[1], BK):
        acc += a[:, k:k + BK] @ b[k:k + BK]
    return acc


def _wire(x):
    """Another rank's shard as the int8 wire delivers it: bf16(q s) (or fp32)."""
    return Q.dequant_int8(*Q.quant_int8(x), x.dtype)


def _emulate_ag(xs, ws):
    n, (b, t, h) = len(xs), xs[0].shape
    outs = []
    for me in range(n):
        out = torch.empty(b, n * t, ws[me].shape[1], dtype=xs[0].dtype)
        for s in range(n):
            src = (me - s) % n
            a = (xs[src] if s == 0 else _wire(xs[src])).reshape(-1, h)
            acc = _kblocks_into(torch.zeros(a.shape[0], ws[me].shape[1]), a, ws[me])
            out[:, src * t:(src + 1) * t] = acc.reshape(b, t, -1).to(xs[0].dtype)
        outs.append(out)
    return outs


def _emulate_contract(xs, ws, out_dtype):
    n, (b, t, hl) = len(xs), xs[0].shape
    outs = []
    for me in range(n):
        acc = torch.zeros(b * t, ws[me].shape[1])
        for s in range(n):                      # one fp32 sum carried across the steps
            src = (me - s) % n
            a = (xs[src] if s == 0 else _wire(xs[src])).reshape(-1, hl)
            _kblocks_into(acc, a, ws[me][src * hl:(src + 1) * hl])
        outs.append(acc.reshape(b, t, -1).to(out_dtype))
    return outs


# (kernel, x [b, t, h], w, ring, out dtype of the contracted ring or None): ragged rows,
# a partial last k-block, both ring sizes
ARITH_CASES = (
    ("ag_matmul", (2, 96, 160), (160, 80), 2, None),
    ("ag_matmul", (1, 64, 96), (96, 48), 4, None),
    ("ag_matmul_contract", (2, 48, 80), (160, 64), 2, None),
    ("ag_matmul_contract", (1, 40, 48), (192, 40), 4, None),
    ("ag_matmul_contract", (2, 48, 80), (160, 64), 2, torch.float32),
)


def _inputs(case, dtype):
    kernel, xs, ws, n, _ = case
    g = np.random.default_rng(sum(xs) + n)
    xl = [torch.from_numpy(g.standard_normal(xs, dtype=np.float32)).to(dtype) for _ in range(n)]
    wl = [torch.from_numpy(g.standard_normal(ws, dtype=np.float32) / ws[0] ** 0.5).to(dtype)
          for _ in range(n)]
    return xl, wl


def _jax_int8(case, dtype, xl, wl):
    """The JAX package's quantization and tile loop composed in ring order."""
    import jax.numpy as jnp

    from repro.core import quant as JQ
    from repro.kernels import ring_matmul as JRM
    kernel, xs, ws, n, out_dtype = case
    jdt = jnp.bfloat16 if dtype == BF else jnp.float32
    jx = [jnp.asarray(x.float().numpy(), dtype=jdt) for x in xl]
    jw = [jnp.asarray(w.float().numpy(), dtype=jdt) for w in wl]
    wire = [JQ.dequant_int8(*JQ.quant_int8(x), jdt) for x in jx]
    h = xs[2]
    outs = []
    for me in range(n):
        shard = lambda src: (jx[src] if src == me else wire[src]).reshape(-1, h)  # noqa: E731
        if kernel == "ag_matmul":
            parts = [JRM._tile_mm_raw(shard(src), jw[me]).reshape(xs[0], xs[1], -1)
                     for src in range(n)]
            out = jnp.concatenate(parts, axis=1)
        else:
            acc = None
            for s in range(n):
                src = (me - s) % n
                p = JRM._tile_mm_raw(shard(src), jw[me][src * h:(src + 1) * h],
                                     out_dtype=jnp.float32)
                acc = p if acc is None else acc + p
            out = acc.reshape(xs[0], xs[1], -1).astype(jnp.float32 if out_dtype else jdt)
        outs.append(np.asarray(out.astype(jnp.float32)))
    return outs


@pytest.fixture(scope="module")
def arith():
    """Every arithmetic case's inputs, the emulation, JAX's and the global
    result, in fp32 and bf16."""
    res = {}
    for i, case in enumerate(ARITH_CASES):
        kernel, xs, ws, n, out_dtype = case
        for dtype in (torch.float32, BF):
            xl, wl = _inputs(case, dtype)
            if kernel == "ag_matmul":
                emu = _emulate_ag(xl, wl)
            else:
                emu = _emulate_contract(xl, wl, out_dtype or dtype)
            want = LB.reference(kernel, xl, wl, int8=True, out_dtype=out_dtype)
            res[(i, dtype)] = (emu, _jax_int8(case, dtype, xl, wl), want)
    return res


def _close(got, want, tol):
    """Within tol (absolute over the tensor's scale and relative) on all but
    SHARE of the elements, those within one int8 level further."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want)
    off = err > tol * scale + tol * np.abs(want)
    assert off.mean() <= SHARE, off.mean()
    assert err.max() <= tol * scale + tol * np.abs(want).max() + np.abs(want).max() / 127


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("i", range(len(ARITH_CASES)),
                         ids=[f"{c[0]}-{c[1]}-n{c[3]}" + ("-f32out" if c[4] else "")
                              for c in ARITH_CASES])
def test_int8_wgmma_arithmetic_matches_jax_and_global(arith, i, dtype):
    emu, jx, want = arith[(i, dtype)]
    out_dtype = ARITH_CASES[i][4] or dtype
    for e, j, w in zip(emu, jx, want):
        assert e.dtype == w.dtype == out_dtype and e.shape == w.shape == j.shape
        _close(e.float().numpy(), j, TOL[out_dtype])
        _close(e.float().numpy(), w.float().numpy(), TOL[out_dtype])


def test_int8_emulation_is_not_the_bf16_wire(arith):
    """The emulation quantizes the other ranks' shards: in fp32 it fails the
    fp32 bound against the bf16 wire's exact gather, as a kernel that skipped
    the wire's quantization would."""
    kernel, xs, ws, n, _ = ARITH_CASES[0]
    xl, wl = _inputs(ARITH_CASES[0], torch.float32)
    emu = arith[(0, torch.float32)][0]
    exact = LB.reference(kernel, xl, wl)
    with pytest.raises(AssertionError):
        for e, w in zip(emu, exact):
            _close(e.numpy(), w.numpy(), TOL[torch.float32])


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


CARD_CASES = (
    ("ag_matmul", (2, 256, 192), (192, 136), 2),
    ("ag_matmul", (2, 100, 208), (208, 264), 2),           # ragged rows, a partial k-block
    ("ag_matmul", (2, 128, 320), (320, 64), 4),
    ("ag_matmul_contract", (2, 256, 192), (384, 136), 2),
    ("ag_matmul_contract", (2, 100, 208), (832, 264), 4),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: f"{c[0]}-{c[1]}-n{c[3]}")
def test_loopback_int8_routes_match_global(dev, case, dtype):
    """Every route the operands admit (wgmma and wmma for bf16, simt for
    fp32) against the int8 wire's global result, over three calls (the first
    from hop 0), the launches counted on the route."""
    from repro_torch.kernels import ops
    kernel, xs, ws, n = case
    lb = LB.LoopbackRing(n, "model" if n == 4 else "my", dev)
    xl, wl = _card_inputs(dev, xs, ws, n, sum(xs) + n, dtype)
    want = LB.reference(kernel, xl, wl, int8=True)
    chosen = _impl(dtype, kernel, xs, ws, n)
    name = kernel + "_int8"
    for route in [chosen] + (["wmma"] if chosen == "wgmma" else []):
        ops.reset_launches()
        for reset in (True, False, False):
            run = LB.ag_matmul if kernel == "ag_matmul" else LB.ag_matmul_contract
            outs = run(lb, xl, wl, int8=True, impl=route, reset=reset)
            torch.cuda.synchronize()
            for o, w in zip(outs, want):
                assert o.dtype == w.dtype
                _close(o.float().cpu().numpy(), w.float().cpu().numpy(), TOL[dtype])
        assert RM.IMPL_LAUNCHES[name][route] == 3 * n, RM.IMPL_LAUNCHES
        assert ops.LAUNCHES[name] == 3 * n


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [BF, torch.float32], ids=["bf16out", "fp32out"])
@pytest.mark.parametrize("n", [2, 4])
def test_contract_int8_accumulator_in_registers_and_in_memory(dev, n, out_dtype):
    """The contracted kernel with its sums in registers (every block owns at
    most one tile) and under a block cap of 2 (15 tiles: the sums go through
    the fp32 buffer in device memory), both against the global result."""
    xs, hl, o = (2, 300, 256), 256, 328
    lb = LB.LoopbackRing(n, "model" if n == 4 else "my", dev)
    xl, wl = _card_inputs(dev, xs, (n * hl, o), n, 11 + n)
    want = LB.reference("ag_matmul_contract", xl, wl, int8=True, out_dtype=out_dtype)
    cap = lb.cap("ag_matmul_contract_int8", BF, "wgmma", out_dtype)
    for blocks in (cap, 2):
        for reset in (True, False):
            outs = lb.run(lambda r, ring_of, cnt: RM._launch_contract(
                xl[r], wl[r], ring_of, n, out_dtype, True, counters=cnt, blocks=blocks,
                impl="wgmma"), reset)
            torch.cuda.synchronize()
            for a, w in zip(outs, want):
                assert a.dtype == out_dtype
                _close(a.float().cpu().numpy(), w.float().cpu().numpy(), TOL[out_dtype])


@pytest.mark.cuda
def test_bf16_then_int8_on_one_ring_keep_their_slot_maps(dev):
    """The bf16 wire's shard and the int8 wire's pair through the same slots
    of one loopback ring at one block, in turns: each call reads its slot
    through a map of its own element type."""
    n, xs, ws = 2, (4, 128, 512), (512, 256)
    lb = LB.LoopbackRing(n, "my", dev)
    xl, wl = _card_inputs(dev, xs, ws, n, 21)
    for int8 in (False, True, False, True):
        want = LB.reference("ag_matmul", xl, wl, int8=int8)
        outs = LB.ag_matmul(lb, xl, wl, int8=int8, impl="wgmma")
        torch.cuda.synchronize()
        for a, w in zip(outs, want):
            _close(a.float().cpu().numpy(), w.float().cpu().numpy(), TOL[BF])


def test_pair_quantization_at_half_integer_quotients():
    """The rule the pair's quantization follows on every route (one IEEE
    division, half to even; ``quant_rows`` in ``csrc/ring_matmul.cu``, as
    ``core/quant.quant_int8``) against the JAX package's ``quant_int8`` bit
    for bit, on rows of max 127 (scale 1) whose values sit on half-integers
    and next to them: ties go to the even integer."""
    import jax.numpy as jnp
    from repro.core import quant as JQ
    halves = torch.arange(-126, 127, dtype=torch.float32) + 0.5
    rows = torch.stack([torch.cat([torch.full((1,), 127.0), halves + d])
                        for d in (0.0, 2.0 ** -17, -(2.0 ** -17), 1.0 / 4096, -1.0 / 4096)])
    q, s = Q.quant_int8(rows)
    jq, js = JQ.quant_int8(jnp.asarray(rows.numpy()))
    assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(), np.asarray(js))
    assert bool((q[0, 1:].int() % 2 == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kernel", ["ag_matmul", "ag_matmul_contract"])
def test_in_kernel_quantization_is_quant_int8(dev, kernel, n):
    """Each rank's shard is quantized by ``quant_pair``, a kernel of its own
    launched before the ring kernel, on the wgmma route and on the tile loop
    alike: the pair that crossed the last hop equals quant_int8's bit for
    bit, on random rows and on rows whose values sit on half-integer
    quotients."""
    xs = (2, 96, 512)
    lb = LB.LoopbackRing(n, "model" if n == 4 else "my", dev)
    xl, _ = _card_inputs(dev, xs, (xs[2], 8), n, 31 + n)
    halves = (torch.arange(xs[2], device=dev) % 253 - 126 + 0.5).to(BF)
    xl[1][0, :4] = halves                     # quotients k + 0.5: ties to even
    xl[1][0, :4, 0] = 127.0
    ws = [(torch.randn(n * xs[2] if kernel == "ag_matmul_contract" else xs[2], 136,
                       device=dev) / xs[2] ** 0.5).to(BF) for _ in range(n)]
    run = LB.ag_matmul if kernel == "ag_matmul" else LB.ag_matmul_contract
    for impl in ("wgmma", "wmma"):
        run(lb, xl, ws, int8=True, impl=impl, reset=True)
        torch.cuda.synchronize()
        for got, want in LB.hopped_pairs(lb, xl):
            assert torch.equal(got, want), impl
