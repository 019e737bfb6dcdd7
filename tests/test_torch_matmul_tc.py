"""The bf16 matmuls on Hopper's tensor cores (``csrc/matmul.cu``, namespace
``wg``): their path choice, their tile plan, their arithmetic, and on the
card their kernels.

On the CPU:

* ``mm_impl`` picks the path of every product of the main path from the
  dtype, shapes and strides alone: the training step's 17 bf16 tile
  products and the serving matmuls with M > 16 on ``wgmma``, bf16 decode
  on ``gemv`` (fp32 on ``skinny``), fp32 on ``simt``, operands TMA cannot
  address (a stored row off 8 elements) on ``wmma``;
* ``wg_plan`` gives each training product about one work unit per SM or
  more (K split where the tiles alone are too few), and ``split_ranges``
  covers K exactly once with no split empty;
* an emulation of the wgmma path's arithmetic, written here from the plan
  (fp32 products over each split's k-blocks, the partials summed in split
  order, then bias, act and one rounding), held against the JAX package's
  ``_tile_mm_raw`` and ``matmul`` (Pallas in interpret mode) and the plain
  versions, at the repo's bounds: fp32 2e-4, bf16 2e-2 (one rounding of
  the output).

Marked ``cuda`` (skipped without a card): both tensor-core paths (wgmma,
wmma) against the plain version in NN, NT and TN, with M in 17-63, K off
64, N = 203, bf16 and fp32 outputs and the tied head's layout at a reduced
vocab; ``matmul`` with bias and each act on wgmma; two wgmma calls
``torch.equal`` (split K included); ``ops.tile_matmul``'s forward and
gradients counted on wgmma.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_matmul_tc.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import matmul as MM
from repro.kernels import ring_matmul as RM
from repro_torch.kernels import build
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops, ref

BF = torch.bfloat16
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}

# qwen3-0.6b at full width: d 1024, 16 x 128 q, 8 x 128 kv, d_ff 3072, padded
# vocab 152,064; a training microbatch of 4 x 512 tokens
D, Q, KV, F, V, T = 1024, 2048, 1024, 3072, 152064, 2048


def _train_products():
    """(label, layout, M, K, N) of the training step's 17 bf16 tile products:
    per projection the forward (NN), dx = g w^T (NT) and dw = x^T g (TN);
    the gated pair's dx and dw; the tied head's logits, dx and dw."""
    out = []
    for name, (k, n) in (("q", (D, Q)), ("kv", (D, KV)), ("o", (Q, D)), ("down", (F, D))):
        out += [(f"{name} fwd", "NN", T, k, n), (f"{name} dx", "NT", T, n, k),
                (f"{name} dw", "TN", k, T, n)]
    out += [("gated dx", "NT", T, F, D), ("gated dw", "TN", D, T, F),
            ("head logits", "NT", T, D, V), ("head dx", "NN", T, V, D),
            ("head dw", "TN", D, T, V)]
    return out


TRAIN = _train_products()


def _strides(layout, M, K, N):
    """(ta, tb, lda, ldb) of x [M,K] @ w [K,N] stored as the layout stores them."""
    ta, tb = layout == "TN", layout == "NT"
    return ta, tb, (M if ta else K), (K if tb else N)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # small ops: thread start-up dominates
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the path choice and the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label,layout,M,K,N", TRAIN, ids=[t[0] for t in TRAIN])
def test_training_products_take_wgmma(label, layout, M, K, N):
    ta, tb, lda, ldb = _strides(layout, M, K, N)
    assert kmm.mm_impl(BF, M, N, K, ta, tb, lda, ldb, 256, tile=True) == "wgmma"
    # the same product in fp32 (the checking dtype) stays on the SIMT kernel
    assert kmm.mm_impl(torch.float32, M, N, K, ta, tb, lda, ldb, 256, tile=True) == "simt"


SERVE = [(k, n) for k, n in ((D, Q), (D, KV), (Q, D), (F, D), (D, V))] + \
    [(768, 3352), (1536, 768), (768, 50432)]          # mamba2-130m: in, out, head


@pytest.mark.parametrize("K,N", SERVE, ids=[f"K{k}-N{n}" for k, n in SERVE])
@pytest.mark.parametrize("M,want", [(4, "skinny"), (16, "skinny"), (17, "wgmma"),
                                    (200, "wgmma"), (512, "wgmma")])
def test_serving_matmuls_path(K, N, M, want):
    """Decode (M = 4 slots) streams on a decode path, gemv in bf16 and
    skinny in fp32; prefills (M > 16) take wgmma in bf16 and SIMT in fp32."""
    assert kmm.mm_impl(BF, M, N, K) == ("gemv" if want == "skinny" else want)
    assert kmm.mm_impl(torch.float32, M, N, K) == ("skinny" if M <= 16 else "simt")


@pytest.mark.parametrize("layout,M,K,N,align,want", [
    ("TN", 45, 150, 27, 16, "wmma"),     # the ring backward's ragged dw: rows of 45
    ("NN", 100, 45, 27, 16, "wmma"),     # rows of 45 and 27
    ("NT", 37, 45, 27, 16, "wmma"),
    ("NN", 100, 88, 200, 8, "wmma"),     # an address on 8 bytes only
    ("NN", 100, 88, 200, 16, "wgmma"),
    ("NT", 100, 88, 203, 16, "wgmma"),   # the output's row length is free
    ("TN", 96, 101, 200, 16, "wgmma"),   # so is K along a transposed A's rows
    ("NN", 4, 64, 64, 16, "wgmma"),      # the tile matmul has no skinny path
])
def test_tile_path_follows_what_tma_can_address(layout, M, K, N, align, want):
    ta, tb, lda, ldb = _strides(layout, M, K, N)
    assert kmm.mm_impl(BF, M, N, K, ta, tb, lda, ldb, align, tile=True) == want


def test_shared_align_reads_view_offsets():
    """A view one bf16 element into its storage sits on 2 bytes: the tile
    matmul would hand it to wmma, not to TMA."""
    t = torch.empty(4096, dtype=BF)
    assert kmm.shared_align(t) >= 16 and kmm.shared_align(t, t[8:]) == 16
    assert kmm.shared_align(t, t[1:]) == 2 and kmm.shared_align(t[4:]) == 8


@pytest.mark.parametrize("label,layout,M,K,N", TRAIN, ids=[t[0] for t in TRAIN])
def test_plan_fills_the_card_at_training_shapes(label, layout, M, K, N):
    """Work units (tiles x K splits) fill at least 70% of one wave of the
    132 SMs; K is split only where the tiles cover at most half of them."""
    bn, splits = kmm.wg_plan(M, N, K)
    tiles = -(-M // kmm.WG_BM) * -(-N // bn)
    assert tiles * splits >= 0.7 * kmm.SMS
    assert splits == 1 or tiles <= kmm.SMS // 2


@pytest.mark.parametrize("M,K,N,want", [
    (T, D, V, (256, 1)),         # the head's logits: wide tiles, 72 waves
    (D, T, V, (256, 1)),         # the head's dw
    (T, V, D, (256, 2)),         # the head's dx: 64 wide tiles over K = 152,064, split in two
    (512, D, V, (256, 1)),       # the served prefill's head
    (F, T, D, (256, 1)),         # the FFN-down dw: 96 wide tiles over 32 k-blocks
    (T, D, F, (128, 1)),         # its dx: 384 narrow tiles over 16 k-blocks
    (T, D, D, (128, 1)),
    (512, Q, D, (128, 3)),       # a served prefill's O projection: 32 tiles, K split
    (512, D, D, (128, 1)),       # 16 k-blocks: too short to split
])
def test_plan_at_main_path_products(M, K, N, want):
    assert kmm.wg_plan(M, N, K) == want


@pytest.mark.parametrize("M,N,K", [(1024, 1024, 2048), (512, 1024, 3072), (512, 1024, 2048),
                                   (2048, 1024, 152064), (200, 768, 1536), (40, 56, 2000),
                                   (17, 64, 64 * 33), (64, 128, 64 * 16 * 40 + 5)])
def test_split_ranges_cover_k_once(M, N, K):
    bn, splits = kmm.wg_plan(M, N, K)
    ranges = kmm.split_ranges(K, splits)
    kb = -(-K // kmm.WG_BK)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == kb
    assert all(a < b for a, b in ranges)                          # none empty
    assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))  # contiguous, no overlap
    assert splits == 1 or all(b - a >= kmm.WG_MIN_KPER for a, b in ranges[:-1])
    tiles = -(-M // kmm.WG_BM) * -(-N // bn)
    assert tiles * splits <= kmm.SMS or splits == 1


def test_edited_header_renames_every_library(tmp_path, monkeypatch):
    """The libraries are named by a hash that covers the shared headers
    (``csrc/*.cuh``), so editing ``hopper.cuh`` rebuilds both sources that
    include it."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build._lib_path("a")
    assert build._lib_path("a") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build._lib_path("a") != before


def test_reset_launches_zeroes_the_matmul_path_counts():
    kmm.IMPL_LAUNCHES["matmul"]["wgmma"] = 3
    kmm.IMPL_LAUNCHES["tile_matmul"]["wmma"] = 2
    ops.reset_launches()
    assert all(n == 0 for c in kmm.IMPL_LAUNCHES.values() for n in c.values())
    assert set(kmm.IMPL_LAUNCHES) == {"matmul", "gated_matmul", "tile_matmul"}


# ---------------------------------------------------------------------------
# an emulation of the wgmma path's arithmetic, against JAX
# ---------------------------------------------------------------------------

def emulate_wgmma(x, w, bias=None, act="none", out_dtype=None):
    """x @ w as the wgmma path sums it: fp32 products over each split's
    k-blocks (wg_plan, split_ranges), the partials added in split order,
    then bias and act in fp32 and one rounding to ``out_dtype``."""
    M, K = x.shape
    N = w.shape[1]
    _, splits = kmm.wg_plan(M, N, K)
    xf, wf = x.float(), w.float()
    acc = None
    for a, b in kmm.split_ranges(K, splits):
        part = xf[:, a * kmm.WG_BK:b * kmm.WG_BK] @ wf[a * kmm.WG_BK:b * kmm.WG_BK]
        acc = part if acc is None else acc + part
    if bias is not None:
        acc = acc + bias.float()
    acc = ref.EPILOGUE_ACTS[act](acc)
    return acc.to(out_dtype or x.dtype)


def _pair(a: np.ndarray, dtype: str):
    j = jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return j, t


@pytest.mark.parametrize("layout", ["NN", "NT", "TN"])
@pytest.mark.parametrize("M,K,N", [(40, 2000, 56), (24, 200, 203)])
@pytest.mark.parametrize("dtype,out_dtype", [("bfloat16", "bfloat16"),
                                             ("bfloat16", "float32")])
def test_emulated_tile_matches_jax(layout, M, K, N, dtype, out_dtype):
    """The first shape splits K three ways, the second is ragged in every
    dim with N odd.  The JAX kernel reads x [M,K] and w [K,N]; the port's
    operands are the transposed views the training path hands over."""
    if layout == "TN" and M % 8:
        M += 8 - M % 8
    rng = np.random.default_rng(3)
    xa, wa = rng.standard_normal((M, K)), rng.standard_normal((K, N)) / np.sqrt(K)
    xj, xt = _pair(xa, dtype)
    wj, wt = _pair(wa, dtype)
    if layout == "TN":
        xt = xt.t().contiguous().t()
    if layout == "NT":
        wt = wt.t().contiguous().t()
    od = getattr(torch, out_dtype)
    want = RM._tile_mm_raw(xj, wj, out_dtype=jnp.dtype(out_dtype), interpret=True)
    got = emulate_wgmma(xt, wt, out_dtype=od)
    tol = TOL[od]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got.float(), ref.tile_matmul_plain(xt, wt, out_dtype=od).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("act", ["none", "gelu", "relu2", "silu"])
def test_emulated_matmul_epilogue_matches_jax(act):
    """act(x @ w + b) with K split over two partials (M = 128: one row tile)."""
    M, K, N = 128, 1280, 128
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng.standard_normal((M, K)), "bfloat16")
    wj, wt = _pair(rng.standard_normal((K, N)) / np.sqrt(K), "bfloat16")
    bj, bt = _pair(rng.standard_normal(N), "bfloat16")
    assert kmm.wg_plan(M, N, K)[1] == 2
    want = MM.matmul(xj, wj, bj, act=act, block_m=128, block_n=128, block_k=128,
                     interpret=True)
    got = emulate_wgmma(xt, wt, bt, act)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), ref.matmul_plain(xt, wt, bt, act=act).float(),
                               rtol=2e-2, atol=2e-2)


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


def _stored(t, transposed):
    return t.t().contiguous().t() if transposed else t


def _close(a, b):
    torch.cuda.synchronize()
    tol = TOL[a.dtype]
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


CARD_TILES = [("NN", 512, 1024, 1024), ("NT", 512, 1024, 1024), ("TN", 1024, 512, 1024),
              ("NN", 40, 200, 136), ("NT", 17, 200, 203), ("TN", 64, 63, 200),
              ("NN", 63, 2048, 256), ("TN", 256, 1000, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["wgmma", "wmma"])
@pytest.mark.parametrize("layout,M,K,N", CARD_TILES)
@pytest.mark.parametrize("out_dtype", [BF, torch.float32])
def test_card_tile_both_paths_match_plain(dev, impl, layout, M, K, N, out_dtype):
    x = _stored(_randn((M, K), BF, dev, 1), layout == "TN")
    w = _stored(_randn((K, N), BF, dev, 2, K ** -0.5), layout == "NT")
    out = kmm.tile_matmul(x, w, out_dtype=out_dtype, impl=impl)
    assert out.dtype == out_dtype and out.shape == (M, N)
    _close(out, ref.tile_matmul_plain(x, w, out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["wgmma", "wmma"])
def test_card_tied_head_layout(dev, impl):
    """The head at a reduced width and vocab: fp32 logits x table^T (NT) on
    256-wide tiles (4 x 133 of them: many waves), dx = g table (NN) on
    256-wide tiles with K = vocab split 16 ways, and dw = x^T g (TN)."""
    M, d, vocab = 512, 256, 133 * 256
    assert kmm.wg_plan(M, vocab, d) == (256, 1) and kmm.wg_plan(M, d, vocab) == (256, 16)
    x = _randn((M, d), BF, dev, 3)
    table = _randn((vocab, d), BF, dev, 4, d ** -0.5)
    g = _randn((M, vocab), BF, dev, 5)
    for a, b, od in ((x, table.t(), torch.float32), (g, table, BF), (x.t(), g, BF)):
        _close(kmm.tile_matmul(a, b, out_dtype=od, impl=impl),
               ref.tile_matmul_plain(a, b, out_dtype=od))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(17, 192, 200), (100, 192, 200), (512, 1024, 1024)])
@pytest.mark.parametrize("act,bias", [("none", False), ("gelu", True), ("relu2", True),
                                      ("silu", True)])
def test_card_matmul_epilogue_on_wgmma(dev, M, K, N, act, bias):
    x = _randn((M, K), BF, dev, 6)
    w = _randn((K, N), BF, dev, 7, K ** -0.5)
    b = _randn((N,), BF, dev, 8) if bias else None
    assert kmm.mm_impl(BF, M, N, K) == "wgmma"
    _close(kmm.matmul(x, w, b, act=act), ref.matmul_plain(x, w, b, act=act))
    _close(kmm.matmul(x, w, b, act=act, impl="wmma"), ref.matmul_plain(x, w, b, act=act))


@pytest.mark.cuda
def test_card_wgmma_repeats_bit_for_bit(dev):
    """Split K (a prefill's O projection 512 x 2048 x 1024: three splits;
    the dw layout 1024 x 2048 x 1024: two) and one split (the head's
    logits)."""
    x = _randn((512, 2048), BF, dev, 9)
    w = _randn((2048, 1024), BF, dev, 10, 2048 ** -0.5)
    h = _randn((2048, 1024), BF, dev, 17)
    assert kmm.wg_plan(512, 1024, 2048)[1] > 1 and kmm.wg_plan(1024, 1024, 2048)[1] > 1
    assert torch.equal(kmm.matmul(x, w), kmm.matmul(x, w))
    assert torch.equal(kmm.tile_matmul(h.t(), h), kmm.tile_matmul(h.t(), h))
    x = _randn((512, 1024), BF, dev, 18)
    table = _randn((8448, 1024), BF, dev, 11)
    a = kmm.tile_matmul(x, table.t(), out_dtype=torch.float32)
    assert torch.equal(a, kmm.tile_matmul(x, table.t(), out_dtype=torch.float32))


@pytest.mark.cuda
def test_card_wgmma_refuses_what_tma_cannot_address(dev):
    x = _randn((100, 45), BF, dev, 12)
    w = _randn((45, 27), BF, dev, 13)
    assert kmm.mm_impl(BF, 100, 27, 45, tile=True) == "wmma"
    with pytest.raises(ValueError, match="TMA"):
        kmm.tile_matmul(x, w, impl="wgmma")
    _close(kmm.tile_matmul(x, w), ref.tile_matmul_plain(x, w))


@pytest.mark.cuda
def test_card_tile_gradients_go_through_wgmma(dev):
    """ops.tile_matmul's forward (NT, fp32 out: the head's layout), dx (NN)
    and dw (TN): three launches, all on wgmma, against the plain autograd."""
    x0 = _randn((256, 512), BF, dev, 14)
    w0 = _randn((1000, 512), BF, dev, 15, 512 ** -0.5)
    g = _randn((256, 1000), BF, dev, 16).float()
    ops.reset_launches()
    grads = []
    for fn in (ops.tile_matmul, ref.tile_matmul_plain):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = fn(x, w.t(), out_dtype=torch.float32)
        grads.append(torch.autograd.grad(y, (x, w), g))
    torch.cuda.synchronize()
    assert kmm.IMPL_LAUNCHES["tile_matmul"] == {"wgmma": 3, "wmma": 0, "simt": 0, "skinny": 0}
    assert ops.LAUNCHES["tile_matmul"] == 3
    for a, b in zip(*grads):
        _close(a, b)
