"""The gated matmul on wgmma (``csrc/matmul.cu``, ``wg::mm_gated``) and the
decode path for M <= 16 (namespace ``gv``): their route, their plans, their
arithmetic, and on the card their kernels.

On the CPU:

* the route of every serving bf16 product with M <= 16 (qwen3-0.6b and
  mamba2-130m, plain and gated) is ``gemv``, of every gate with M > 16
  ``wgmma``; fp32 decode stays on ``skinny``; a path that cannot take the
  operands is refused;
* the gated plan at the main path's gate shapes (M = 2048, 512, 77), and
  the gemv plan's K split at the serving shapes (fills the SMs, fits x's
  rows in shared memory, leaves no split empty);
* an emulation of each new kernel's arithmetic, written from its plan and
  split order (fp32 products over each split's 64-deep k-blocks, the
  partials added in split order, then the epilogue and one rounding):
  the gate with its kept products at M = 77 and a K split, against the
  JAX package's ``gated_matmul`` (Pallas in interpret mode) and
  ``ref.gated_products_plain``; decode at M = 1, 4, 16 with K split 8
  ways, plain and gated, against the JAX ``matmul`` / ``gated_matmul`` in
  interpret mode.  Bounds: bf16 2e-2 (one rounding of the output), fp32
  2e-4 for the kept products.

Marked ``cuda`` (skipped without a card): both gated routes (wgmma, wmma)
against the plain version with ``keep_ab``, M ragged (17-63, 77), silu and
gelu; the decode route against the plain version for M in {1, 4, 7, 16},
plain with bias and each act, gated, ragged N and K, a reduced-vocab head;
two calls ``torch.equal`` on each new kernel; the training op's forward
and gradients counted on the gated wgmma route.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_matmul_gated_decode.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import matmul as MM
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops, ref

BF, F32 = torch.bfloat16, torch.float32
TOL = {F32: 2e-4, BF: 2e-2}

# qwen3-0.6b at full width: d 1024, 16 x 128 q, 8 x 128 kv, d_ff 3072, padded
# vocab 152,064; mamba2-130m: d 768, in-projection 3352 wide, vocab 50,432
D, Q, KV, FF, V = 1024, 2048, 1024, 3072, 152064
DENSE = [(D, Q), (D, KV), (Q, D), (FF, D), (D, V)]
MAMBA = [(768, 3352), (1536, 768), (768, 50432)]
GATE = (D, FF)                          # (K, N) of the gated up-projection
SERVE = DENSE + MAMBA


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # small ops: thread start-up dominates
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the route and the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,N", SERVE, ids=[f"K{k}-N{n}" for k, n in SERVE])
@pytest.mark.parametrize("M", [1, 4, 16])
def test_decode_products_take_gemv(K, N, M):
    """Every served bf16 matmul with M <= 16 (decode) streams on gemv; the
    same product in fp32 stays on the skinny kernel."""
    assert kmm.mm_impl(BF, M, N, K) == "gemv"
    assert kmm.mm_impl(F32, M, N, K) == "skinny"


@pytest.mark.parametrize("M,bf16,fp32", [(1, "gemv", "skinny"), (4, "gemv", "skinny"),
                                         (16, "gemv", "skinny"), (17, "wgmma", "simt"),
                                         (77, "wgmma", "simt"), (512, "wgmma", "simt"),
                                         (2048, "wgmma", "simt")])
def test_gate_route(M, bf16, fp32):
    """The gate: decode on gemv, every bf16 gate with M > 16 (prefill,
    training) on wgmma; fp32 on skinny or simt."""
    K, N = GATE
    assert kmm.gated_impl(BF, M, N, K) == bf16
    assert kmm.gated_impl(F32, M, N, K) == fp32


@pytest.mark.parametrize("impl,dtype,M,err", [
    ("gemv", BF, 17, ValueError),        # decode only
    ("gemv", F32, 4, TypeError),         # bf16 only
    ("wgmma", F32, 77, TypeError),
    ("skinny", BF, 17, ValueError),
])
def test_paths_refuse_what_they_cannot_take(impl, dtype, M, err):
    with pytest.raises(err):
        kmm._choose(impl, kmm.mm_impl(dtype, M, 256, 256), dtype, M, tile=False, tma=True)


def test_tile_matmul_has_no_gemv_path():
    with pytest.raises(ValueError, match="gemv"):
        kmm._choose("gemv", "wgmma", BF, 4, tile=True, tma=True)
    assert "gemv" not in kmm.IMPL_LAUNCHES["tile_matmul"]
    assert set(kmm.IMPL_LAUNCHES["gated_matmul"]) == set(kmm.IMPLS)


@pytest.mark.parametrize("M,want", [(2048, (128, 1)), (512, (128, 1)), (77, (128, 2))])
def test_gated_plan_at_main_path_shapes(M, want):
    """The gate's tiles are 128 wide; the training (2048: 384 tiles) and
    prefill (512: 96 tiles) shapes fill the SMs unsplit; the off-path
    ragged 77 rows (24 tiles) split K in two, as the gate's sweep found
    fastest."""
    K, N = GATE
    assert kmm.wg_plan(M, N, K, gated=True) == want
    assert kmm.plan("wgmma", M, N, K, gated=True) == want


def test_gated_plan_splits_k_where_tiles_are_few():
    """Two tiles over 24 k-blocks: the gate splits K three ways (8 k-blocks
    each), the plain product two ways (10 or more each)."""
    assert kmm.wg_plan(77, 256, 1536, gated=True) == (128, 3)
    assert kmm.wg_plan(77, 256, 1536) == (128, 2)


DECODE_SHAPES = [(k, n, False) for k, n in SERVE] + [(GATE[0], GATE[1], True)]


@pytest.mark.parametrize("K,N,gated", DECODE_SHAPES,
                         ids=[f"K{k}-N{n}" + ("-gated" * g) for k, n, g in DECODE_SHAPES])
@pytest.mark.parametrize("M", [1, 4, 16])
def test_gemv_plan_fills_the_card(K, N, gated, M):
    """Panels x splits make at least one block per SM, or the splits fill
    a cluster; every split has at least one k-block; x's rows of one range
    fit in shared memory beside the ring."""
    splits = kmm.gemv_plan(M, N, K, gated)
    kb, panels = -(-K // kmm.GV_BK), -(-N // kmm.GV_BN)
    assert panels * splits >= kmm.SMS or splits == kmm.GV_MAX_SPLITS
    assert splits <= kmm.GV_MAX_SPLITS
    ranges = kmm.split_ranges(K, splits)
    assert len(ranges) == splits and all(a < b for a, b in ranges) and ranges[-1][1] == kb
    kper = ranges[0][1] - ranges[0][0]
    assert kmm.GV_RING[gated] + M * (kper * kmm.GV_BK + 8) * 2 + 2048 <= kmm.GV_SMEM
    assert kmm.plan("gemv", M, N, K, gated) == (kmm.GV_BN, splits)


@pytest.mark.parametrize("M,N,K,want", [(4, 1024, 1024, 8), (4, 2048, 1024, 8),
                                        (4, 3072, 1024, 8), (4, 152064, 1024, 1),
                                        (4, 1024, 3072, 8), (16, 1024, 3072, 8),
                                        (4, 768, 1536, 8), (4, 3352, 768, 6),
                                        (4, 50432, 768, 1)])
def test_gemv_plan_at_serving_shapes(M, N, K, want):
    """The layer projections split K 6-8 ways, a cluster's worth (their
    6-27 panels alone would leave most SMs idle); the heads' 394 and 1,188
    panels do not split."""
    assert kmm.gemv_plan(M, N, K, gated=N == FF) == want


def test_gemv_plan_splits_k_for_shared_memory():
    """16 rows of a K of 16,384 would take 512 KB: K splits into a cluster's
    ranges, which fit, even where the panels alone fill the SMs; a K no
    cluster's ranges fit is refused."""
    splits = kmm.gemv_plan(16, 64 * 1024, 16384)
    kper = kmm.split_ranges(16384, splits)[0][1] * kmm.GV_BK
    assert splits > 1 and kmm.GV_RING[False] + 16 * (kper + 8) * 2 + 2048 <= kmm.GV_SMEM
    with pytest.raises(ValueError, match="too long"):
        kmm.gemv_plan(16, 1024, 8 * 16384)


# ---------------------------------------------------------------------------
# emulations of the kernels' arithmetic, against JAX
# ---------------------------------------------------------------------------

def _split_sums(x, ws, splits):
    """x @ w for each w as the kernels sum it: fp32 products over each
    split's 64-deep k-blocks (split_ranges), added in split order."""
    K = x.shape[1]
    xf = x.float()
    out = []
    for w in ws:
        wf, acc = w.float(), None
        for a, b in kmm.split_ranges(K, splits):
            ks = slice(a * kmm.WG_BK, b * kmm.WG_BK)
            part = xf[:, ks] @ wf[ks]
            acc = part if acc is None else acc + part
        out.append(acc)
    return out


def emulate_gated(x, w1, w1b, act, impl):
    """(act(a) * b in x's dtype, a, b) as the gated route ``impl`` (wgmma
    or gemv) sums them under its plan."""
    M, K = x.shape
    N = w1.shape[1]
    _, splits = kmm.plan(impl, M, N, K, gated=True)
    a, b = _split_sums(x, (w1, w1b), splits)
    return (ref.EPILOGUE_ACTS[act](a) * b).to(x.dtype), a, b


def emulate_gemv(x, w, bias, act):
    M, K = x.shape
    (acc,) = _split_sums(x, (w,), kmm.gemv_plan(M, w.shape[1], K))
    if bias is not None:
        acc = acc + bias.float()
    return ref.EPILOGUE_ACTS[act](acc).to(x.dtype)


def _pair(a: np.ndarray, dtype: str = "bfloat16"):
    j = jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return j, t


def _assert_close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want.float() if isinstance(want, torch.Tensor)
                                          else want, np.float32), rtol=tol, atol=tol)


# the gate off the main path: M = 77 rows, K = 1536 split three ways
GM, GK, GN = 77, 1536, 256


@pytest.fixture(scope="module", params=["silu", "gelu"])
def gate_case(request):
    """One JAX computation a module: the Pallas gated matmul in interpret
    mode on one set of inputs (numpy, seeded), and the port's inputs."""
    act = request.param
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng.standard_normal((GM, GK)))
    w1j, w1t = _pair(rng.standard_normal((GK, GN)) / np.sqrt(GK))
    wbj, wbt = _pair(rng.standard_normal((GK, GN)) / np.sqrt(GK))
    want = MM.gated_matmul(xj, w1j, wbj, act=act, block_m=128, block_n=128, block_k=512,
                           interpret=True)
    return act, (xt, w1t, wbt), np.asarray(want, np.float32)


def test_emulated_gate_splits_k(gate_case):
    assert kmm.plan("wgmma", GM, GN, GK, gated=True)[1] == 3


def test_emulated_gate_matches_jax(gate_case):
    act, (x, w1, w1b), want = gate_case
    y, _, _ = emulate_gated(x, w1, w1b, act, "wgmma")
    assert y.dtype == BF
    _assert_close(y, want, TOL[BF])


def test_emulated_gate_keeps_products_of_plain(gate_case):
    """y at the bf16 bound, the kept fp32 products at the fp32 bound."""
    act, (x, w1, w1b), _ = gate_case
    got = emulate_gated(x, w1, w1b, act, "wgmma")
    want = ref.gated_products_plain(x, w1, w1b, act=act)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _assert_close(g, w, TOL[w.dtype])


# decode: K = 1024 split 8 ways (a cluster) over two 128-column panels
DK, DN = 1024, 256


@pytest.fixture(scope="module")
def decode_case():
    """The JAX matmul (bias, each act) and gated matmul in interpret mode
    at M = 1, 4, 16, from one set of seeded inputs."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((16, DK))
    w = rng.standard_normal((DK, DN)) / np.sqrt(DK)
    wb = rng.standard_normal((DK, DN)) / np.sqrt(DK)
    bias = rng.standard_normal(DN)
    (wj, wt), (wbj, wbt), (bj, bt) = _pair(w), _pair(wb), _pair(bias)
    out = {}
    for M in (1, 4, 16):
        xj, xt = _pair(x[:M])
        for act in ("none", "gelu", "relu2", "silu"):
            out[M, act] = (xt, np.asarray(MM.matmul(xj, wj, bj, act=act, block_m=16,
                                                    block_n=128, block_k=512, interpret=True),
                                          np.float32))
        out[M, "gated"] = (xt, np.asarray(MM.gated_matmul(xj, wj, wbj, act="silu", block_m=16,
                                                          block_n=128, block_k=512,
                                                          interpret=True), np.float32))
    return out, wt, wbt, bt


@pytest.mark.parametrize("M", [1, 4, 16])
def test_decode_shape_splits_k(M):
    assert kmm.gemv_plan(M, DN, DK) == 8 and kmm.gemv_plan(M, DN, DK, gated=True) == 8


@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("act", ["none", "gelu", "relu2", "silu"])
def test_emulated_gemv_matches_jax(decode_case, M, act):
    out, w, _, bias = decode_case
    x, want = out[M, act]
    got = emulate_gemv(x, w, bias, act)
    _assert_close(got, want, TOL[BF])
    _assert_close(got, ref.matmul_plain(x, w, bias, act=act), TOL[BF])


@pytest.mark.parametrize("M", [1, 4, 16])
def test_emulated_gated_gemv_matches_jax(decode_case, M):
    out, w, wb, _ = decode_case
    x, want = out[M, "gated"]
    y, a, b = emulate_gated(x, w, wb, "silu", "gemv")
    _assert_close(y, want, TOL[BF])
    for g, p in zip((y, a, b), ref.gated_products_plain(x, w, wb, act="silu")):
        _assert_close(g, p, TOL[p.dtype])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _close(a, b):
    torch.cuda.synchronize()
    tol = TOL[a.dtype]
    assert a.dtype == b.dtype and a.shape == b.shape
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


def _gate_inputs(M, K, N, dev, seed):
    return (_randn((M, K), BF, dev, seed), _randn((K, N), BF, dev, seed + 1, K ** -0.5),
            _randn((K, N), BF, dev, seed + 2, K ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["wgmma", "wmma"])
@pytest.mark.parametrize("M,K,N", [(17, 192, 200), (33, 1024, 3072), (63, 200, 136),
                                   (77, 1536, 256), (77, 1024, 3072)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_card_gate_both_routes_keep_products(dev, impl, M, K, N, act):
    x, w1, w1b = _gate_inputs(M, K, N, dev, 1)
    got = kmm.gated_matmul(x, w1, w1b, act=act, keep_ab=True, impl=impl)
    for g, w in zip(got, ref.gated_products_plain(x, w1, w1b, act=act)):
        _close(g, w)
    _close(kmm.gated_matmul(x, w1, w1b, act=act, impl=impl),
           ref.gated_matmul_plain(x, w1, w1b, act=act))


@pytest.mark.cuda
def test_card_gate_training_shape(dev):
    """The training gate 2048 x 1024 x 3072 with its kept products, on the
    default route (wgmma), counted there."""
    x, w1, w1b = _gate_inputs(2048, D, FF, dev, 4)
    ops.reset_launches()
    got = kmm.gated_matmul(x, w1, w1b, keep_ab=True)
    assert kmm.IMPL_LAUNCHES["gated_matmul"]["wgmma"] == 1
    for g, w in zip(got, ref.gated_products_plain(x, w1, w1b)):
        _close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 7, 16])
@pytest.mark.parametrize("K,N", [(1024, 1024), (3072, 1024), (200, 136), (768, 3352)])
@pytest.mark.parametrize("act,bias", [("none", False), ("gelu", True), ("relu2", True),
                                      ("silu", True)])
def test_card_gemv_matches_plain(dev, M, K, N, act, bias):
    x = _randn((M, K), BF, dev, 7)
    w = _randn((K, N), BF, dev, 8, K ** -0.5)
    b = _randn((N,), BF, dev, 9) if bias else None
    assert kmm.mm_impl(BF, M, N, K) == "gemv"
    _close(kmm.matmul(x, w, b, act=act), ref.matmul_plain(x, w, b, act=act))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 7, 16])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_card_gated_gemv_matches_plain(dev, M, act):
    x, w1, w1b = _gate_inputs(M, D, FF, dev, 10)
    _close(kmm.gated_matmul(x, w1, w1b, act=act), ref.gated_matmul_plain(x, w1, w1b, act=act))
    got = kmm.gated_matmul(x, w1, w1b, act=act, keep_ab=True)
    for g, w in zip(got, ref.gated_products_plain(x, w1, w1b, act=act)):
        _close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 16])
def test_card_gemv_reduced_vocab_head(dev, M):
    """The head at full width over a reduced vocab (257 panels: more than
    the SMs, so K does not split), against the plain version and the skinny
    kernel."""
    N = 257 * 128
    x = _randn((M, D), BF, dev, 11)
    table = _randn((D, N), BF, dev, 12, D ** -0.5)
    assert kmm.gemv_plan(M, N, D) == 1
    out = kmm.matmul(x, table)
    _close(out, ref.matmul_plain(x, table))
    _close(out, kmm.matmul(x, table, impl="skinny"))


@pytest.mark.cuda
def test_card_new_kernels_repeat_bit_for_bit(dev):
    """gemv (plain and gated, K split 8 ways over a cluster, summed in rank
    order), and the gated wgmma route with its kept products (K split
    three ways, summed in split order)."""
    x = _randn((4, D), BF, dev, 13)
    w = _randn((D, KV), BF, dev, 14, D ** -0.5)
    wb = _randn((D, KV), BF, dev, 15, D ** -0.5)
    assert kmm.gemv_plan(4, KV, D) == 8
    assert torch.equal(kmm.matmul(x, w), kmm.matmul(x, w))
    assert all(torch.equal(a, b) for a, b in zip(kmm.gated_matmul(x, w, wb, keep_ab=True),
                                                 kmm.gated_matmul(x, w, wb, keep_ab=True)))
    x, w1, w1b = _gate_inputs(77, 1536, 256, dev, 16)
    assert kmm.wg_plan(77, 256, 1536, gated=True)[1] == 3
    assert all(torch.equal(a, b) for a, b in zip(kmm.gated_matmul(x, w1, w1b, keep_ab=True),
                                                 kmm.gated_matmul(x, w1, w1b, keep_ab=True)))


@pytest.mark.cuda
def test_card_gated_gradients_go_through_wgmma(dev):
    """ops.gated_matmul with a gradient: the custom op's forward keeps the
    products on the gated wgmma route, its backward runs the SwiGLU kernel
    and four tile products.  Against the same op's plain versions on CPU
    copies (the kept fp32 products, the SwiGLU backward and the tile
    products in PyTorch, rounding to bf16 where the kernels do): y element
    by element at the bf16 bound; dx, dw1, dw1b by their relative norm at
    the same bound, since both backwards round da and db to bf16 and one
    element's rounding on the other side of a boundary moves a whole row
    of dw by an ulp of da."""
    x0, w10, w1b0 = _gate_inputs(256, 512, 768, dev, 17)
    g = _randn((256, 768), BF, dev, 20)
    ops.reset_launches()
    outs = []
    for where in (dev, torch.device("cpu")):
        leaves = [t.to(where).clone().requires_grad_() for t in (x0, w10, w1b0)]
        y = ops.gated_matmul(*leaves)
        outs.append((y, *torch.autograd.grad(y, leaves, g.to(where))))
    torch.cuda.synchronize()
    assert kmm.IMPL_LAUNCHES["gated_matmul"] == {"wgmma": 1, "wmma": 0, "simt": 0,
                                                 "skinny": 0, "gemv": 0}
    assert ops.LAUNCHES["gated_matmul"] == 1 and ops.LAUNCHES["swiglu_bwd"] == 1
    _close(outs[0][0], outs[1][0].to(dev))
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        b = b.to(dev).float()
        assert float((a.float() - b).norm() / b.norm()) <= TOL[BF]
