"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips with a reason on a host without an NVIDIA
card (the CPU-only tier-1 run).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the repo's (tests/test_kernels.py::_tol), keyed on the
kernel output's dtype: fp32 2e-4 (fp32 sums in another order), bf16 2e-2
(one bf16 rounding of the output).  The SSD scan holds y to its dtype's
bound and its fp32 final state to 2e-4, on both routes (SIMT, and the
tensor cores for bf16 at mamba2's dh 64 and ds 128).  The training kernels (tile matmul
layouts, the SwiGLU and flash-attention backwards) are held to the same
bounds: each rounds its fp32 sums once, and an fp32 output of bf16 inputs
(the head's logits, the gated kernel's kept products) not at all.  The
ring kernels run in rank processes on the card (``tests/_torch_world.py``:
two ranks for the kernels and their backward rings, four for two grid
training steps), each held against the plain route on the same inputs,
on the bf16 wire and on the int8 wire, and each forward counted on its
route (wgmma, wmma or simt).  MLA's absorbed decode kernel
(fp32 out of fp32 or bf16 inputs: the fp32 bound either way), attention
at MLA's dk 96 / dv 64 (natively on the tensor cores, zero-padded on the
SIMT path) and at head dims off every kernel (zero-padded), and an MLA
model with its latent caches are held against their plain versions too.
The MoE's grouped expert products (each launch counted on its route:
gemv, wgmma, simt) are held to the same bounds, its combine to its
plain version bit for bit, and an MoE model's prefill and decode ticks
against the plain path.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.config import MLAConfig, ModelConfig, MoEConfig, ParallelConfig, SSMConfig
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import moe as kmoe
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as kssd
from repro_torch.kernels import swiglu as ksw
from repro_torch.models import lm
from repro_torch.parallel.context import PCtx
from repro_torch.serve.cache import CachePool, PoolConfig
from repro_torch.serve.engine import DecodeEngine, Request

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


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
    """a (the kernel's output) against b, at the bound of a's dtype: an
    fp32 output of bf16 inputs is held to the fp32 bound."""
    torch.cuda.synchronize()
    tol = TOL[a.dtype]
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("M", [1, 4, 16, 17, 100, 256])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act,bias", [("none", False), ("gelu", True), ("relu2", True),
                                      ("silu", False)])
def test_matmul_kernel(dev, M, dtype, act, bias):
    K, N = 192, 200
    x = _randn((M, K), dtype, dev, 0)
    w = _randn((K, N), dtype, dev, 1, K ** -0.5)
    b = _randn((N,), dtype, dev, 2) if bias else None
    _close(kmm.matmul(x, w, b, act=act), ref.matmul_plain(x, w, b, act=act))


@pytest.mark.parametrize("M", [4, 33, 128])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_matmul_kernel(dev, M, dtype, act):
    K, N = 256, 136
    x = _randn((M, K), dtype, dev, 3)
    w1 = _randn((K, N), dtype, dev, 4, K ** -0.5)
    w1b = _randn((K, N), dtype, dev, 5, K ** -0.5)
    _close(kmm.gated_matmul(x, w1, w1b, act=act),
           ref.gated_matmul_plain(x, w1, w1b, act=act))


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Sk,q_off,kv_len", [
    (1, 40, 80, [0], [40]), (1, 33, 96, [17], [50]), (3, 1, 70, [0, 9, 69], [1, 10, 70]),
    (2, 64, 64, None, None)])
def test_flash_attention_kernel(dev, dh, dtype, B, Sq, Sk, q_off, kv_len):
    nh, nkv = 6, 2
    q = _randn((B, Sq, nh, dh), dtype, dev, 6).transpose(1, 2)
    k = _randn((B, Sk, nkv, dh), dtype, dev, 7).transpose(1, 2)
    v = _randn((B, Sk, nkv, dh), dtype, dev, 8).transpose(1, 2)
    t = lambda a: None if a is None else torch.tensor(a, dtype=torch.int32, device=dev)
    kw = dict(causal=True, q_offset=t(q_off), kv_len=t(kv_len))
    _close(kfa.flash_attention(q, k, v, **kw), ref.attention_plain(q, k, v, **kw))


def test_flash_attention_row_without_keys(dev):
    """kv_len 0 empties every row of a slot: like _sdpa, the kernel gives
    the uniform average of v over all Sk keys (decode and prefill)."""
    nh, nkv, dh = 4, 2, 64
    for Sq, Sk, q_off, kv_len in ((1, 48, [3, 0, 7], [4, 0, 8]),
                                  (16, 40, [0, 0, 5], [16, 0, 21])):
        B = len(q_off)
        q = _randn((B, Sq, nh, dh), torch.float32, dev, 11).transpose(1, 2)
        k = _randn((B, Sk, nkv, dh), torch.float32, dev, 12).transpose(1, 2)
        v = _randn((B, Sk, nkv, dh), torch.float32, dev, 13).transpose(1, 2)
        t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
        kw = dict(causal=True, q_offset=t(q_off), kv_len=t(kv_len))
        out = kfa.flash_attention(q, k, v, **kw)
        _close(out, ref.attention_plain(q, k, v, **kw))
        mean_v = v[1].float().mean(dim=1).repeat_interleave(nh // nkv, dim=0)
        _close(out[1], mean_v[:, None].expand(nh, Sq, dh))


def _layout(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    """t as a row-major tensor, or the transposed view of a row-major one."""
    return t.t().contiguous().t() if transposed else t


# (layout, M, K, N): the dims no operand stores rows along are ragged
TILE_SHAPES = [("NN", 256, 192, 320), ("NN", 100, 88, 200), ("NT", 256, 192, 320),
               ("NT", 100, 88, 203), ("TN", 256, 192, 320), ("TN", 96, 101, 200),
               ("NN", 24, 40, 56), ("NT", 24, 40, 56), ("TN", 24, 40, 56),
               # stored rows off 8 elements (the ring backward's ragged dw products)
               ("NN", 100, 45, 27), ("NT", 37, 45, 27), ("TN", 45, 150, 27)]


@pytest.mark.parametrize("layout,M,K,N", TILE_SHAPES)
@pytest.mark.parametrize("dtype,out_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
def test_tile_matmul_kernel(dev, layout, dtype, out_dtype, M, K, N):
    """x @ w in NN, NT (w read transposed) and TN (x read transposed), at
    ragged shapes, some with stored rows off 8 elements."""
    x = _layout(_randn((M, K), dtype, dev, 14), layout == "TN")
    w = _layout(_randn((K, N), dtype, dev, 15, K ** -0.5), layout == "NT")
    out = kmm.tile_matmul(x, w, out_dtype=out_dtype)
    assert out.dtype == out_dtype and out.shape == (M, N)
    _close(out, ref.tile_matmul_plain(x, w, out_dtype=out_dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_matmul_gradients(dev, dtype):
    """ops.tile_matmul's backward (dx NT, dw TN through the kernel) against
    the plain version's autograd; the head layout (w a transposed view)."""
    for w_t in (False, True):
        x0 = _randn((64, 96), dtype, dev, 16)
        w0 = _randn((136, 96) if w_t else (96, 136), dtype, dev, 17, 96 ** -0.5)
        # bf16-exact: the kernel path rounds g to x's dtype (as _tile_mm_bwd
        # does), the plain path's autograd does not
        g = _randn((64, 136), dtype, dev, 18).float()
        grads = []
        for fn in (ops.tile_matmul, ref.tile_matmul_plain):
            x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            y = fn(x, w.t() if w_t else w, out_dtype=torch.float32)
            grads.append(torch.autograd.grad(y, (x, w), g))
        for a, b in zip(*grads):
            _close(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_swiglu_bwd_kernel(dev, dtype, act):
    M, F = 40, 200
    g = _randn((M, F), dtype, dev, 19)
    a = _randn((M, F), torch.float32, dev, 20, 3.0)
    b = _randn((M, F), torch.float32, dev, 21)
    for got, want in zip(ksw.swiglu_bwd(g, a, b, act=act),
                         ref.swiglu_bwd_plain(g, a, b, act=act)):
        _close(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", [(72, 128, 96), (2048, 128, 2176)])
def test_gated_matmul_keeps_products(dev, dtype, M, K, N):
    """(y, a, b) against the plain version; a and b are fp32.  In bf16 the
    first shape takes the 64x64 tiles, the second (16 x 17 = 272 tiles of
    128x128, two waves on 132 SMs) the 128x128 ones, as the training path's
    2048 x 1024 x 3072 does."""
    x = _randn((M, K), dtype, dev, 22)
    w1 = _randn((K, N), dtype, dev, 23, K ** -0.5)
    w1b = _randn((K, N), dtype, dev, 24, K ** -0.5)
    got = kmm.gated_matmul(x, w1, w1b, act="silu", keep_ab=True)
    assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32]
    for a, b in zip(got, ref.gated_products_plain(x, w1, w1b, act="silu")):
        _close(a, b)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,nh,nkv", [(2, 80, 4, 2), (1, 33, 6, 6)])
def test_flash_attention_bwd_kernel(dev, dh, dtype, causal, B, S, nh, nkv):
    """(dq, dk, dv) and the forward's LSE against the plain version's
    autograd, on [B,S,heads,dh] tensors handed over as transposed views."""
    q = _randn((B, S, nh, dh), dtype, dev, 25).transpose(1, 2)
    k = _randn((B, S, nkv, dh), dtype, dev, 26).transpose(1, 2)
    v = _randn((B, S, nkv, dh), dtype, dev, 27).transpose(1, 2)
    do = _randn((B, S, nh, dh), dtype, dev, 28).transpose(1, 2)
    o, lse = kfa.flash_attention(q, k, v, causal=causal, return_lse=True)
    o_p, lse_p = ref.attention_plain(q, k, v, causal=causal, return_lse=True)
    _close(o, o_p)
    _close(lse, lse_p)
    got = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = ref.attention_bwd_plain(q, k, v, do, causal=causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dtype
        _close(a, b)
    a2 = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(x, y) for x, y in zip(got, a2))       # deterministic


CFG = ModelConfig(name="cuda-test", family="dense", num_layers=2, d_model=128,
                  num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=500, head_dim=64,
                  qk_norm=True, tie_embeddings=True)


def test_forward_kernels_match_plain(dev):
    """fp32 prefill through the kernels vs the plain-op forward."""
    params = lm.init_params(CFG, seed=0, device=dev, dtype=torch.float32)
    pool = CachePool(CFG, PoolConfig(1, 16, 5, 64), device=dev)
    slot = pool.admit(48)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 500, (1, 48))).to(dev)
    batch = {"tokens": toks, "_dtype": torch.float32}
    ops.reset_launches()
    a = lm.forward(PCtx(), CFG, params, batch, caches=pool.prefill_tree(slot))
    assert all(ops.LAUNCHES[k] > 0 for k in ("matmul", "gated_matmul", "flash_attention")), \
        ops.LAUNCHES
    b = lm.forward(PCtx(plain=True), CFG, params, batch,
                   caches=pool.prefill_tree(slot))
    _close(a.logits, b.logits)


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_arena_decode_tick_matches_plain(dev, dtype):
    """One decode tick over the int8 paged arena (``quant_kv``: quantized at
    write, dequantized into the compute dtype at gather) through the
    kernels against the plain versions on the same arenas, at the row 3
    bound of the logits' dtype; the int8 rows both ticks write are at most
    one level apart (a value on a rounding boundary) and their scales
    within the dtype's bound."""
    params = lm.init_params(CFG, seed=3, device=dev, dtype=dtype)
    pool = CachePool(CFG, PoolConfig(2, 16, 9, 64), device=dev, dtype=dtype, quant_kv=True)
    rng = np.random.default_rng(4)
    for n in (40, 23):
        slot = pool.admit(n)
        toks = torch.from_numpy(rng.integers(0, 500, (1, n))).to(dev)
        lm.forward(PCtx(), CFG, params, {"tokens": toks, "_dtype": dtype},
                   caches=pool.prefill_tree(slot))
        pool.commit_prefill(slot, n)
        assert pool.ensure_append(slot)
    snap = [t.clone() for t in pool.arenas["attn"]]
    batch = {"tokens": torch.tensor([[7], [11]], device=dev),
             "positions": torch.from_numpy(pool.lengths.astype(np.int64)[:, None]).to(dev),
             "_dtype": dtype}
    ops.reset_launches()
    with torch.inference_mode():
        a = lm.forward(PCtx(), CFG, params, batch, caches=pool.decode_tree()).logits
    assert ops.LAUNCHES["flash_attention"] > 0 and ops.LAUNCHES["matmul"] > 0
    wrote = [t.clone() for t in pool.arenas["attn"]]
    for t, s0 in zip(pool.arenas["attn"], snap):
        t.copy_(s0)
    with torch.inference_mode():
        b = lm.forward(PCtx(plain=True), CFG, params, batch, caches=pool.decode_tree()).logits
    _close(a, b)
    assert pool.arenas["attn"][0].dtype == torch.int8
    for x, y in zip(wrote, pool.arenas["attn"]):
        if x.dtype == torch.int8:
            assert (x.int() - y.int()).abs().max() <= 1
        else:
            torch.testing.assert_close(x, y, rtol=TOL[dtype], atol=0)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def test_engine_greedy_tokens_card_vs_cpu(dev):
    """fp32 greedy tokens through the kernels equal the CPU plain path's on
    a trace where two slots compete for 4 leasable blocks of 16."""
    params = lm.init_params(CFG, seed=1, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 500, n).astype(np.int32) for n in (20, 9, 33, 14)]
    toks, pre = {}, {}
    for device, p in ((dev, params), ("cpu", _to_cpu(params))):
        eng = DecodeEngine(CFG, p, PoolConfig(2, 16, 5, 48), device=device)
        fin = eng.run([Request(i, q, 12, i // 2) for i, q in enumerate(prompts)])
        toks[str(device)] = [fin[i].tokens for i in range(4)]
        pre[str(device)] = eng.stats["preemptions"]
    assert toks["cuda"] == toks["cpu"] and pre["cuda"] == pre["cpu"]


def test_train_loss_and_grads_kernels_match_plain(dev):
    """fp32 loss and every gradient through the kernels (remat fusion) vs
    the plain-op path's autograd; every kernel of the path launches."""
    params = lm.init_master_params(CFG, seed=2, device=dev)
    leaves = [t.requires_grad_() for _, t in lm.flatten(params)]
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 500, (2, 48))).to(dev),
             "labels": torch.from_numpy(rng.integers(0, 500, (2, 48))).to(dev),
             "_dtype": torch.float32}
    out = {}
    for plain in (False, True):
        ops.reset_launches()
        pctx = PCtx(plain=plain, mode="train", pcfg=ParallelConfig())
        loss, _ = lm.train_loss(pctx, CFG, params, batch, remat="fusion")
        out[plain] = (loss, torch.autograd.grad(loss, leaves))
        if not plain:
            assert all(ops.LAUNCHES[k] > 0 for k in (
                "tile_matmul", "gated_matmul", "flash_attention", "swiglu_bwd",
                "flash_attention_bwd")), ops.LAUNCHES
    _close(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        _close(a, b)


def _ssd_inputs(dev, dtype, b, S, nh, dh, g, ds, seed, state):
    """x, B, C as slices of one conv output [b, S, nh*dh + 2*g*ds], as the
    model hands them over; mamba2's decays A = -(1..nh) and steps dt near
    0.1, so cum falls to about -300 within a chunk of 128."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    di, gs = nh * dh, g * ds
    conv = torch.randn((b, S, di + 2 * gs), generator=gen, device=dev).to(dtype)
    x = conv[..., :di].reshape(b, S, nh, dh)
    B = conv[..., di:di + gs].reshape(b, S, g, ds)
    C = conv[..., di + gs:].reshape(b, S, g, ds)
    dt = F.softplus(torch.randn((b, S, nh), generator=gen, device=dev) - 2.5)
    A = -torch.arange(1, nh + 1, dtype=torch.float32, device=dev)
    h0 = (torch.randn((b, nh, dh, ds), generator=gen, device=dev) if state
          else torch.zeros((b, nh, dh, ds), device=dev))
    return x, dt, A, B, C, h0


SSD_SHAPES = [
    (1, 64, 24, 64, 1, 128, 64), (1, 200, 24, 64, 1, 128, 128), (1, 512, 24, 64, 1, 128, 128),
    (2, 100, 8, 32, 2, 64, 32), (1, 7, 4, 16, 1, 16, 7), (1, 2, 4, 16, 1, 16, 2),
    (3, 45, 6, 128, 3, 24, 16),
    # mamba2's heads off the served shapes: groups at batch 2 over chunks of 32, S under
    # the tile, S = 2, a chunk that does not fill its tile
    (2, 100, 4, 64, 2, 128, 32), (1, 7, 4, 64, 1, 128, 7), (1, 2, 24, 64, 1, 128, 2),
    (1, 300, 24, 64, 1, 128, 100)]
# every case on SIMT, and in bf16 on the tensor cores too where that route takes it
SSD_ROUTES = [(shape, dtype, impl) for shape in SSD_SHAPES for dtype in DTYPES
              for impl in kssd.IMPLS
              if impl == "simt" or kssd.ssd_impl(dtype, shape[3], shape[5], shape[6]) == impl]


@pytest.mark.parametrize("shape,dtype,impl", SSD_ROUTES)
@pytest.mark.parametrize("state", [False, True])
def test_ssd_kernel(dev, shape, dtype, impl, state):
    """Ragged S, groups, an initial state; y and the final state; the
    tensor-core route gives the same bits on a second call."""
    b, S, nh, dh, g, ds, chunk = shape
    x, dt, A, B, C, h0 = _ssd_inputs(dev, dtype, b, S, nh, dh, g, ds, S + b, state)
    y, fin = kssd.ssd(x, dt, A, B, C, chunk=chunk, init_state=h0, impl=impl)
    y_p, fin_p = ref.ssd_plain(x, dt, A, B, C, chunk=chunk, init_state=h0)
    assert y.dtype == dtype and fin.dtype == torch.float32
    _close(y, y_p)
    _close(fin, fin_p)
    y2, fin2 = kssd.ssd(x, dt, A, B, C, chunk=chunk, impl=impl)   # no state: zeros
    _close(y2, ref.ssd_plain(x, dt, A, B, C, chunk=chunk)[0])
    if not state:
        assert torch.equal(y2, y) and torch.equal(fin2, fin)
    if impl == "wgmma":
        y3, fin3 = kssd.ssd(x, dt, A, B, C, chunk=chunk, init_state=h0, impl=impl)
        assert torch.equal(y3, y) and torch.equal(fin3, fin)


def test_ssd_tensor_cores_long_sequence(dev):
    """17 chunks of 128 (more than one cluster of 8: the blocks loop in
    rounds) on the tensor cores against the sequential recurrence, and the
    final state against the chunked plain version."""
    x, dt, A, B, C, _ = _ssd_inputs(dev, torch.bfloat16, 1, 2100, 24, 64, 1, 128, 21, False)
    y, fin = kssd.ssd(x, dt, A, B, C, chunk=128, impl="wgmma")
    _close(y, ref.ssd_seq_ref(x, dt, A, B, C))
    _close(fin, ref.ssd_plain(x, dt, A, B, C, chunk=128)[1])


def test_ssd_routes_refuse_what_they_do_not_take(dev):
    """The tensor-core route takes bf16 at dh 64 and ds 128 only: forcing it
    elsewhere raises rather than running another route."""
    x, dt, A, B, C, _ = _ssd_inputs(dev, torch.bfloat16, 1, 16, 4, 32, 1, 64, 0, False)
    with pytest.raises(ValueError, match="wgmma"):
        kssd.ssd(x, dt, A, B, C, chunk=16, impl="wgmma")
    x, dt, A, B, C, _ = _ssd_inputs(dev, torch.float32, 1, 16, 4, 64, 1, 128, 0, False)
    with pytest.raises(ValueError, match="wgmma"):
        kssd.ssd(x, dt, A, B, C, chunk=16, impl="wgmma")
    with pytest.raises(ValueError, match="route"):
        kssd.ssd(x, dt, A, B, C, chunk=16, impl="tc")


def test_ssd_kernel_matches_sequential_oracle(dev):
    """The chunked kernel against the plain sequential recurrence."""
    x, dt, A, B, C, _ = _ssd_inputs(dev, torch.float32, 1, 300, 8, 32, 1, 64, 9, False)
    y, _ = kssd.ssd(x, dt, A, B, C, chunk=128)
    _close(y, ref.ssd_seq_ref(x, dt, A, B, C))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nh,dh,ds", [(4, 32, 24), (4, 64, 128)])
def test_ssd_kernel_copies_unaligned_operands(dev, dtype, nh, dh, ds):
    """x read through a transposed layout and B, C off their 16-byte rows
    (an odd channel count) are copied once, and give the same result (on
    the tensor cores too for bf16 at dh 64, ds 128)."""
    x, dt, A, B, C, h0 = _ssd_inputs(dev, dtype, 2, 37, nh, dh, 1, ds, 5, True)
    xt = x.transpose(2, 3).contiguous().transpose(2, 3)
    conv = torch.zeros((2, 37, 2 * ds + 1), dtype=dtype, device=dev)
    conv[..., 1:ds + 1], conv[..., ds + 1:] = B[:, :, 0], C[:, :, 0]
    Bo = conv[..., 1:ds + 1].reshape(2, 37, 1, ds)
    Co = conv[..., ds + 1:].reshape(2, 37, 1, ds)
    y, fin = kssd.ssd(xt, dt, A, Bo, Co, chunk=16, init_state=h0)
    y_p, fin_p = ref.ssd_plain(x, dt, A, B, C, chunk=16, init_state=h0)
    _close(y, y_p)
    _close(fin, fin_p)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, dt, A, B, C, _ = _ssd_inputs(dev, torch.float32, 1, 16, 4, 16, 1, 16, 0, False)
    with pytest.raises(ValueError, match="chunk"):
        kssd.ssd(x, dt, A, B, C, chunk=129)
    with pytest.raises(TypeError, match="fp32"):
        kssd.ssd(x, dt.half(), A, B, C, chunk=16)
    with pytest.raises(ValueError, match="multiple of 8"):
        kssd.ssd(x, dt, A, B[..., :12], C[..., :12], chunk=16)


SSM_CFG = ModelConfig(name="cuda-ssm", family="ssm", num_layers=2, d_model=128, num_heads=0,
                      num_kv_heads=0, d_ff=0, vocab_size=500, tie_embeddings=True,
                      ssm=SSMConfig(state_dim=64, head_dim=32, expand=2, n_groups=2,
                                    conv_kernel=4, chunk_size=32))


def test_ssm_forward_kernels_match_plain(dev):
    """fp32 prefill of the ssm family through the kernels (the SSD scan
    and the matmuls) vs the plain-op forward, logits and final states."""
    params = lm.init_params(SSM_CFG, seed=0, device=dev, dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 500, (1, 77))).to(dev)
    batch = {"tokens": toks, "_dtype": torch.float32}
    pool = CachePool(SSM_CFG, PoolConfig(1, 16, 6, 80), device=dev)
    slot = pool.admit(77)
    out = {}
    for plain in (False, True):
        ops.reset_launches()
        tree = pool.prefill_tree(slot)
        out[plain] = lm.forward(PCtx(plain=plain), SSM_CFG, params, batch, caches=tree)
        if not plain:
            assert ops.LAUNCHES["ssd"] == SSM_CFG.num_layers and ops.LAUNCHES["matmul"] > 0
    _close(out[False].logits, out[True].logits)
    for a, b in zip(out[False].caches["mamba"], out[True].caches["mamba"]):
        _close(a, b)


SSM_TC_CFG = ModelConfig(name="cuda-ssm-tc", family="ssm", num_layers=2, d_model=256,
                         num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=500,
                         tie_embeddings=True,
                         ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1,
                                       conv_kernel=4, chunk_size=128))


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.float32, "simt")])
def test_ssm_prefill_scan_routes_are_counted(dev, dtype, route):
    """mamba2's heads (dh 64, ds 128): every bf16 prefill scan of the model
    launches on the tensor cores and every fp32 one on SIMT, at a prompt
    under the chunk and one over it; the logits match the plain path's."""
    params = lm.init_params(SSM_TC_CFG, seed=0, device=dev, dtype=dtype)
    for S in (40, 300):
        toks = torch.from_numpy(np.random.default_rng(S).integers(0, 500, (1, S))).to(dev)
        batch = {"tokens": toks, "_dtype": dtype}
        ops.reset_launches()
        got = lm.forward(PCtx(), SSM_TC_CFG, params, batch).logits
        assert ops.LAUNCHES["ssd"] == SSM_TC_CFG.num_layers
        assert kssd.IMPL_LAUNCHES == {p: SSM_TC_CFG.num_layers * (p == route)
                                      for p in kssd.IMPLS}
        want = lm.forward(PCtx(plain=True), SSM_TC_CFG, params, batch).logits.float()
        # chip_smoke's model bounds: 5e-2 relative in bf16, 1e-4 in fp32
        rel = ((got.float() - want).norm() / want.norm()).item()
        assert rel <= (5e-2 if dtype == torch.bfloat16 else 1e-4)


def test_ssm_engine_greedy_tokens_card_vs_cpu(dev):
    """fp32 greedy tokens of the ssm family through the kernels equal the
    CPU plain path's on an evicting trace with exact-length prompts."""
    params = lm.init_params(SSM_CFG, seed=1, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 500, n).astype(np.int32) for n in (20, 1, 33, 14)]
    toks, pre = {}, {}
    for device, p in ((dev, params), ("cpu", _to_cpu(params))):
        eng = DecodeEngine(SSM_CFG, p, PoolConfig(2, 16, 5, 48), device=device)
        fin = eng.run([Request(i, q, 12, i // 2) for i, q in enumerate(prompts)])
        toks[str(device)] = [fin[i].tokens for i in range(4)]
        pre[str(device)] = eng.stats["preemptions"]
    assert toks["cuda"] == toks["cpu"] and pre["cuda"] == pre["cpu"]


# ---------------------------------------------------------------------------
# the ring kernels, in rank processes sharing the card
# ---------------------------------------------------------------------------

def _world():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import _torch_world
    return _torch_world


@pytest.fixture(scope="module", params=[((1, 1, 2), "my"), ((1, 1, 4), "my"),
                                        ((1, 2, 2), "model")],
                ids=["ring2", "ring4", "model4"])
def ring_cuda(request):
    """Rings of two ranks, and of four, where each slot is reused within
    one call (the credit protocol); the last is megatron's ``model`` ring
    of the 1x2x2 ranks (its own counters and slots)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")
    TW = _world()
    shape, ax = request.param
    return TW.run_world(shape, TW.cuda_ring_job, (ax,), timeout=600, device="cuda")


@pytest.fixture(scope="module")
def grid_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")
    TW = _world()
    return TW.run_world((1, 2, 2), TW.cuda_grid_job, timeout=900, device="cuda")


def test_ring_flag_probe_progresses(ring_cuda):
    if len(ring_cuda) != 2:
        pytest.skip("the probe runs on a ring of two")
    assert all(0 < r["probe_s"] < 60 for r in ring_cuda.values())


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("case", range(13))
def test_ring_kernel_and_backward_match_plain(ring_cuda, case, dtype):
    TW = _world()
    kernel, xs, o, sd = TW.CUDA_RING_CASES[case]
    tol = TOL[torch.float32 if dtype == "torch.float32" else torch.bfloat16]
    for rank, res in ring_cuda.items():
        (k_out, k_grad), (p_out, p_grad), launched = res["cases"][(kernel, xs, o, sd, dtype)]
        name = "matmul_rs" if kernel == "matmul_rs_pair" else kernel
        assert launched[name] >= 1, (rank, launched)
        for a, b in zip(k_out + k_grad, p_out + p_grad):
            scale = max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("case", range(13))
def test_ring_forward_counted_on_its_route(ring_cuda, case, dtype):
    """The forward's launch of AG-matmul, matmul-RS (the gated pair is one
    matmul-RS over [w1 | w1b]) and the contracted AG-matmul counted once on
    ``ring_impl``'s route: wgmma for bf16 blocks TMA can address, wmma for
    the others, simt for fp32."""
    from repro_torch.kernels import ring_matmul as RM
    TW = _world()
    kernel, xs, o, sd = TW.CUDA_RING_CASES[case]
    n = len(ring_cuda)
    dt = torch.float32 if dtype == "torch.float32" else torch.bfloat16
    name = "matmul_rs" if kernel == "matmul_rs_pair" else kernel
    ws = (xs[2], 2 * o if kernel == "matmul_rs_pair" else o)
    for rank, res in ring_cuda.items():
        routes = res["cases"][("routes", kernel, xs, o, sd, dtype)]
        want = RM.ring_impl(dt, (xs, ws), ((xs[1] * xs[2], xs[2], 1), (ws[1], 1)), n,
                            sd if name == "matmul_rs" else None,
                            contract=kernel == "ag_matmul_contract")
        assert routes[name] == {p: int(p == want) for p in RM.IMPLS}, (rank, routes)


def _hopped_shape(kernel, xs, o, sd, n):
    """The shard the forward's hops carry: x, or the RS accumulator."""
    if kernel in ("ag_matmul", "ag_matmul_contract"):
        return xs
    return (xs[0], xs[1] // n, o) if sd == 1 else (xs[0], xs[1], o // n)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("case", range(13))
def test_ring_kernel_int8_and_backward_match_plain(ring_cuda, case, dtype):
    """The int8 wire: the kernel's int8 variant (forward) and the
    transposed rings over it (backward) against the plain int8 route.
    Within the dtype's bound except on at most 0.1% of the elements, which
    may lie one int8 level (the tensor's largest magnitude over 127) apart:
    the kernel quantizes its own fp32 sums, which may sit on the other side
    of a rounding boundary from the plain version's."""
    from repro_torch.core import quant as Q
    TW = _world()
    kernel, xs, o, sd = TW.CUDA_RING_CASES[case]
    tol = TOL[torch.float32 if dtype == "torch.float32" else torch.bfloat16]
    for rank, res in ring_cuda.items():
        n = len(ring_cuda)
        (k_out, k_grad), (p_out, p_grad), launched = \
            res["cases"][(kernel, xs, o, sd, dtype, "int8")]
        name = "matmul_rs" if kernel == "matmul_rs_pair" else kernel
        quantized = Q.quant_ok(_hopped_shape(kernel, xs, o, sd, n), torch.float32)
        assert launched[name + "_int8" if quantized else name] >= 1, (rank, launched)
        for a, b in zip(k_out + k_grad, p_out + p_grad):
            scale = max(1.0, float(np.abs(b).max()))
            off = np.abs(a - b) > tol * scale + tol * np.abs(b)
            assert off.mean() <= 1e-3, (rank, off.mean())
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale + np.abs(b).max() / 127)


def test_grid_steps_through_ring_kernels_match_plain(grid_cuda):
    """fp32: sums in other orders only.  Losses within 1e-5; each gathered
    leaf within 1e-4 relative (L2): AdamW's first step moves an element
    by lr g / (|g| + 1e-8), so an element whose gradient is within fp32
    noise of zero moves by another fraction of lr (worst leaf measured
    1.0e-5, the tied table)."""
    for rank, res in grid_cuda.items():
        kern, plain = res[False], res[True]
        assert all(kern["launches"][k] > 0
                   for k in ("ag_matmul", "matmul_rs", "ag_matmul_contract")), kern["launches"]
        assert all(v == 0 for v in plain["launches"].values())
        np.testing.assert_allclose(kern["losses"], plain["losses"], rtol=1e-5)
        for name, p in plain["params"].items():
            d = np.linalg.norm(kern["params"][name] - p) / np.linalg.norm(p)
            assert d <= 1e-4, (rank, name, d)


# ---------------------------------------------------------------------------
# MLA: the absorbed decode kernel, attention at padded head dims, the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,kv_len", [(1, 64, [64]), (2, 100, [1, 77]),
                                        (4, 545, [64, 300, 545, 2]), (3, 33, [0, 32, 33])],
                         ids=["B1", "B2-off-tile", "B4-serving", "B3-empty-row"])
def test_mla_decode_kernel(dev, dtype, B, T, kv_len):
    """o_lat of the absorbed decode at minicpm3-4b's dims (40 heads, latent
    256, rope 32) against ``ref.mla_decode_plain``: ragged ``kv_len``, T
    off the 32- and 64-key tiles, a row with no key (the uniform average
    of c_kv); c_kv and k_rope are strided views of one [B, T, 288] buffer.
    bf16 launches on the tensor cores (wgmma), fp32 on SIMT.  The output
    is fp32 (both compute from the same inputs in fp32): 2e-4."""
    nh, Ld, R = 40, 256, 32
    q_lat = _randn((B, nh, Ld), dtype, dev, 40)
    q_rope = _randn((B, nh, R), dtype, dev, 41)
    kv = _randn((B, T, Ld + R), dtype, dev, 42)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    args = (q_lat, q_rope, kv[..., :Ld], kv[..., Ld:], kl, 96 ** -0.5)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    before = dict(kfa.IMPL_LAUNCHES["mla_decode"])
    got = kfa.mla_decode(*args)
    assert got.dtype == torch.float32 and got.shape == (B, nh, Ld)
    assert kfa.IMPL_LAUNCHES["mla_decode"] == {r: before[r] + (r == route) for r in before}
    _close(got, ref.mla_decode_plain(*args))
    if kv_len[0] == 0:
        _close(got[0], kv[0, :, :Ld].float().mean(dim=0)[None].expand(nh, Ld))


def test_mla_decode_wrapper_refuses_what_the_kernel_does_not_take(dev):
    z = torch.zeros(1, 4, 16, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="MLA decode takes"):
        kfa.mla_decode(z, z[..., :4], z, z[..., :4], one, 1.0)


@pytest.mark.parametrize("dh", [96, 40])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Sk,q_off,kv_len", [
    (1, 80, 96, [0], [80]), (3, 1, 70, [0, 9, 69], [1, 10, 70]), (2, 64, 64, None, None)])
def test_flash_attention_padded_head_dims(dev, dh, dtype, B, Sq, Sk, q_off, kv_len):
    """dk = dv = 96 (MLA's dims with v padded, as the JAX package runs
    them) and 40, off every kernel pair, run zero-padded to 128 (64) with
    the caller's dh^-0.5 scale: prefill, decode and the training
    mask against the plain version, the output back at dh."""
    nh, nkv = 6, 2
    q = _randn((B, Sq, nh, dh), dtype, dev, 60).transpose(1, 2)
    k = _randn((B, Sk, nkv, dh), dtype, dev, 61).transpose(1, 2)
    v = _randn((B, Sk, nkv, dh), dtype, dev, 62).transpose(1, 2)
    t = lambda a: None if a is None else torch.tensor(a, dtype=torch.int32, device=dev)
    kw = dict(causal=True, q_offset=t(q_off), kv_len=t(kv_len))
    out = kfa.flash_attention(q, k, v, **kw)
    assert out.shape == q.shape
    _close(out, ref.attention_plain(q, k, v, **kw))


@pytest.mark.parametrize("dh", [96, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_bwd_padded_head_dims(dev, dh, dtype):
    """(dq, dk, dv) at a padded head dim against the plain version's
    autograd, each back at dh; deterministic."""
    B, S, nh, nkv = 2, 80, 4, 2
    q = _randn((B, S, nh, dh), dtype, dev, 63).transpose(1, 2)
    k = _randn((B, S, nkv, dh), dtype, dev, 64).transpose(1, 2)
    v = _randn((B, S, nkv, dh), dtype, dev, 65).transpose(1, 2)
    do = _randn((B, S, nh, dh), dtype, dev, 66).transpose(1, 2)
    o, lse = kfa.flash_attention(q, k, v, causal=True, return_lse=True)
    o_p, lse_p = ref.attention_plain(q, k, v, causal=True, return_lse=True)
    _close(o, o_p)
    _close(lse, lse_p)
    got = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for a, b in zip(got, ref.attention_bwd_plain(q, k, v, do, causal=True)):
        assert a.shape == b.shape and a.dtype == dtype
        _close(a, b)
    again = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


# minicpm3-4b's head dims (latent 256, rope 32, dn = dv = 64: attention at
# dk 96 / dv 64), a narrow model around them
MLA_CFG = ModelConfig(name="cuda-mla", family="dense", num_layers=2, d_model=128,
                      num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=500,
                      mla=MLAConfig(q_lora_rank=64, kv_lora_rank=256, qk_nope_head_dim=64,
                                    qk_rope_head_dim=32, v_head_dim=64))


MLA_DIMS = (96, 64)      # minicpm3-4b's attention: dk = dn + dr = 64 + 32, dv 64


def _native(name):
    return kfa.DIM_LAUNCHES[(name, "wgmma", *MLA_DIMS, "native")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,nh,nkv,Sq,Sk,q_off,kv_len", [
    (1, 40, 40, 64, 100, [0], [64]), (2, 6, 2, 80, 130, [17, 40], [97, 120]),
    (2, 8, 8, 130, 130, None, None), (3, 6, 2, 40, 130, [0, 50, 7], [40, 90, 0])],
    ids=["prefill-off-tile", "prefill-g3", "train-mask", "empty-row"])
def test_flash_attention_mla_dims(dev, dtype, B, nh, nkv, Sq, Sk, q_off, kv_len):
    """q and k at dk 96, v at dv 64 (a strided view, as ``apply_mla``
    hands it over): bf16 on the tensor cores runs (96, 64) natively, fp32
    on the SIMT path pads to (128, 128); the output at dv 64 in
    [B, Sq, nh, dv] memory, against the plain version: the prefill mask
    (q_offset, kv_len, Sk off the 64-key tile), the training mask with
    its LSE, and a row with no key (the uniform average of v)."""
    dk, dv = MLA_DIMS
    q = _randn((B, Sq, nh, dk), dtype, dev, 70).transpose(1, 2)
    k = _randn((B, Sk, nkv, dk), dtype, dev, 71).transpose(1, 2)
    v = _randn((B, Sk, nkv, 2 * dv), dtype, dev, 72)[..., dv:].transpose(1, 2)
    t = lambda a: None if a is None else torch.tensor(a, dtype=torch.int32, device=dev)
    kw = dict(causal=True, q_offset=t(q_off), kv_len=t(kv_len))
    impl = kfa.forward_impl(dtype, B, nh, nkv, Sq, Sk, dk, dv)
    ops.reset_launches()
    out, lse = kfa.flash_attention(q, k, v, return_lse=True, **kw)
    want, lse_p = ref.attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert out.shape == (B, nh, Sq, dv) and out.dtype == dtype
    # native: [B, Sq, nh, dv] memory; padded: a view of the [.., 128] output
    assert out.transpose(1, 2).is_contiguous() == (impl == "wgmma")
    route = (impl, *MLA_DIMS, "native") if impl == "wgmma" else (impl, 128, 128, "padded")
    assert kfa.DIM_LAUNCHES == {("flash_attention", *route): 1}
    assert impl == ("wgmma" if dtype == torch.bfloat16 else "simt")
    _close(out, want)
    if kv_len is None:                    # the LSE is the backward's, training's mask
        _close(lse, lse_p)
    elif 0 in kv_len:
        b = kv_len.index(0)
        mean_v = v[b].float().mean(1).repeat_interleave(nh // nkv, 0)
        _close(out[b], mean_v[:, None].expand(nh, Sq, dv))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,nh,nkv,S,causal", [(2, 8, 8, 130, True), (2, 6, 2, 80, True),
                                               (1, 4, 2, 64, False)])
def test_flash_attention_bwd_mla_dims(dev, dtype, B, nh, nkv, S, causal):
    """(dq, dk, dv) at dk 96 / dv 64 against the plain version's autograd:
    dq and dk at 96, dv at 64, each in the input dtype; bf16 natively on
    the tensor cores; two calls agree bit for bit."""
    dk, dv = MLA_DIMS
    q = _randn((B, S, nh, dk), dtype, dev, 73).transpose(1, 2)
    k = _randn((B, S, nkv, dk), dtype, dev, 74).transpose(1, 2)
    v = _randn((B, S, nkv, dv), dtype, dev, 75).transpose(1, 2)
    do = _randn((B, S, nh, dv), dtype, dev, 76).transpose(1, 2)
    o, lse = kfa.flash_attention(q, k, v, causal=causal, return_lse=True)
    ops.reset_launches()
    got = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = ref.attention_bwd_plain(q, k, v, do, causal=causal)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        assert _native("flash_attention_bwd") == 2 and len(kfa.DIM_LAUNCHES) == 1
    for a, b, width in zip(got, want, (dk, dk, dv)):
        assert a.shape == b.shape and a.shape[-1] == width and a.dtype == dtype
        _close(a, b)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_flash_attention_refuses_dims_it_cannot_take(dev):
    """A dv (or dk) off the multiples of 8 up to 128, or a v whose
    [B, nkv, S] differs from k's, raises before any CUDA call."""
    q = torch.zeros(1, 2, 64, 96, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 2, 64, 96, dtype=torch.bfloat16, device=dev)
    ops.reset_launches()
    for v in (torch.zeros(1, 2, 64, 60, dtype=torch.bfloat16, device=dev),
              torch.zeros(1, 2, 64, 136, dtype=torch.bfloat16, device=dev)):
        with pytest.raises(ValueError, match="multiple of 8"):
            kfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match=r"v \[B,nkv,Sk,dv\]"):
        kfa.flash_attention(q, k, torch.zeros(1, 2, 63, 64, dtype=torch.bfloat16, device=dev))
    lse = torch.zeros(1, 2, 64, device=dev)
    v60 = torch.zeros(1, 2, 64, 60, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        kfa.flash_attention_bwd(q, k, v60, v60.expand(1, 2, 64, 60), lse, v60)
    assert not kfa.DIM_LAUNCHES and sum(kfa.IMPL_LAUNCHES["flash_attention"].values()) == 0


def test_mla_bf16_attention_runs_native(dev):
    """The MLA model's bf16 training loss through the kernels: every
    attention forward and backward runs (96, 64) natively on the tensor
    cores, and the loss is within the bf16 bound of the plain path's."""
    params = lm.init_master_params(MLA_CFG, seed=9, device=dev)
    leaves = [t.requires_grad_() for _, t in lm.flatten(params)]
    rng = np.random.default_rng(10)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 500, (2, 128))).to(dev),
             "labels": torch.from_numpy(rng.integers(0, 500, (2, 128))).to(dev),
             "_dtype": torch.bfloat16}
    losses = {}
    for plain in (False, True):
        ops.reset_launches()
        pctx = PCtx(plain=plain, mode="train", pcfg=ParallelConfig())
        loss, _ = lm.train_loss(pctx, MLA_CFG, params, batch, remat="fusion")
        torch.autograd.grad(loss, leaves)
        losses[plain] = float(loss.detach())
        if not plain:
            L = MLA_CFG.num_layers
            assert _native("flash_attention") == ops.LAUNCHES["flash_attention"] >= L
            assert _native("flash_attention_bwd") == ops.LAUNCHES["flash_attention_bwd"] == L
            assert all(key[-1] == "native" for key in kfa.DIM_LAUNCHES), kfa.DIM_LAUNCHES
    assert abs(losses[False] - losses[True]) <= TOL[torch.bfloat16] * abs(losses[True])


@pytest.mark.parametrize("quant", [False, True], ids=["paged", "int8"])
def test_mla_prefill_and_decode_kernels_match_plain(dev, quant):
    """fp32 prefill of two prompts and three decode ticks through the
    kernels (prefill attention at dk 96 / dv 64, padded to 128 on the fp32
    SIMT path; the absorbed decode kernel once a layer and tick) against
    the plain versions, each on its own pool fed the same tokens."""
    params = lm.init_params(MLA_CFG, seed=5, device=dev, dtype=torch.float32)
    logits = {}
    for plain in (False, True):
        pool = CachePool(MLA_CFG, PoolConfig(2, 16, 9, 64), device=dev, quant_kv=quant)
        rng = np.random.default_rng(6)
        ops.reset_launches()
        got = []
        with torch.inference_mode():
            for n in (40, 23):
                slot = pool.admit(n)
                toks = torch.from_numpy(rng.integers(0, 500, (1, n))).to(dev)
                got.append(lm.forward(PCtx(plain=plain), MLA_CFG, params,
                                      {"tokens": toks, "_dtype": torch.float32},
                                      caches=pool.prefill_tree(slot)).logits[:, -1])
                pool.commit_prefill(slot, n)
            for i in range(3):
                for s in range(2):
                    assert pool.ensure_append(s)
                batch = {"tokens": torch.tensor([[7 + i], [11 + i]], device=dev),
                         "positions": torch.from_numpy(
                             pool.lengths.astype(np.int64)[:, None]).to(dev),
                         "_dtype": torch.float32}
                got.append(lm.forward(PCtx(plain=plain), MLA_CFG, params, batch,
                                      caches=pool.decode_tree()).logits[:, 0])
                for s in range(2):
                    pool.advance(s)
        if not plain:
            assert ops.LAUNCHES["mla_decode"] == 3 * MLA_CFG.num_layers, ops.LAUNCHES
            assert ops.LAUNCHES["flash_attention"] == 2 * MLA_CFG.num_layers, ops.LAUNCHES
        logits[plain] = got
    for a, b in zip(logits[False], logits[True]):
        _close(a, b)


def test_mla_train_loss_and_grads_kernels_match_plain(dev):
    """fp32 loss and every gradient of the MLA model through the kernels
    (the flash forward and backward at dk 96 / dv 64, padded to 128 on the
    fp32 SIMT path; the tile matmul) against the plain path's autograd."""
    params = lm.init_master_params(MLA_CFG, seed=7, device=dev)
    leaves = [t.requires_grad_() for _, t in lm.flatten(params)]
    rng = np.random.default_rng(8)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 500, (2, 48))).to(dev),
             "labels": torch.from_numpy(rng.integers(0, 500, (2, 48))).to(dev),
             "_dtype": torch.float32}
    out = {}
    for plain in (False, True):
        ops.reset_launches()
        pctx = PCtx(plain=plain, mode="train", pcfg=ParallelConfig())
        loss, _ = lm.train_loss(pctx, MLA_CFG, params, batch, remat="fusion")
        out[plain] = (loss, torch.autograd.grad(loss, leaves))
        if not plain:
            assert all(ops.LAUNCHES[k] > 0 for k in (
                "tile_matmul", "flash_attention", "flash_attention_bwd")), ops.LAUNCHES
    _close(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        _close(a, b)


# ---------------------------------------------------------------------------
# the MoE's expert kernels (csrc/moe.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [1, 7, 16, 17, 37, 130])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gated,act", [(True, "silu"), (True, "gelu"), (False, "none"),
                                       (False, "relu2")])
def test_moe_grouped_kernel(dev, C, dtype, gated, act):
    """Every expert's product in one launch, on the route its C and dtype
    call for (gemv for bf16 C <= 16, wgmma above, simt for fp32), counted
    there; K (96) and N (136) off the 64- and 128-wide tiles, and the
    second expert's rows all zero (a slot no token took)."""
    E, K, N = 5, 96, 136
    x = _randn((E, C, K), dtype, dev, 1)
    x[1] = 0
    ws = [_randn((E, K, N), dtype, dev, 2 + i, K ** -0.5) for i in range(2 if gated else 1)]
    route = kmoe.grouped_impl(dtype, C)
    ops.reset_launches()
    got = kmoe.grouped(x, *ws, act=act)
    name = "moe_grouped_gated" if gated else "moe_grouped_mm"
    assert kmoe.IMPL_LAUNCHES[name][route] == 1 == sum(kmoe.IMPL_LAUNCHES[name].values())
    want = (ref.grouped_gated_plain(x, *ws, act=act) if gated
            else ref.grouped_mm_plain(x, ws[0], act=act))
    _close(got, want)
    assert torch.equal(got, kmoe.grouped(x, *ws, act=act))      # deterministic


@pytest.mark.parametrize("C", [1, 16])
def test_moe_grouped_wgmma_takes_small_c(dev, C):
    """The wgmma route takes any C (rows past C zero-filled by TMA), so the
    decode shapes can be held against it."""
    E, K, N = 3, 64, 128
    x = _randn((E, C, K), torch.bfloat16, dev, 4)
    w1, w1b = (_randn((E, K, N), torch.bfloat16, dev, 5 + i, K ** -0.5) for i in range(2))
    _close(kmoe.launch(x, w1, w1b, act="silu", impl="wgmma"),
           ref.grouped_gated_plain(x, w1, w1b, act="silu"))


@pytest.mark.parametrize("dtype,C,N", [(torch.bfloat16, 4, 17024), (torch.float32, 37, 136)])
@pytest.mark.parametrize("gated", [False, True])
def test_moe_gemv_and_simt_routes_are_rows_1_2_kernels(dev, dtype, C, N, gated):
    """The grouped gemv and simt routes launch rows 1/2's own kernels
    (``csrc/matmul.cuh``) with the expert in the grid: each expert's rows
    equal that expert's single product bit for bit (the gemv shape leaves
    both plans one K range, so the sums run in one order)."""
    E, K = 2, 512
    x = _randn((E, C, K), dtype, dev, 11)
    ws = [_randn((E, K, N), dtype, dev, 12 + i, K ** -0.5) for i in range(2 if gated else 1)]
    route = kmoe.grouped_impl(dtype, C)
    if route == "gemv":
        assert kmm.gemv_plan(C, N, K, gated, experts=E) == kmm.gemv_plan(C, N, K, gated) == 1
    got = kmoe.grouped(x, *ws, act="silu" if gated else "gelu")
    for e in range(E):
        one = (kmm.gated_matmul(x[e], ws[0][e], ws[1][e], act="silu", impl=route) if gated
               else kmm.matmul(x[e], ws[0][e], act="gelu", impl=route))
        torch.cuda.synchronize()
        assert torch.equal(got[e], one), (route, e)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,k,E,C,H", [(4, 8, 40, 1, 1536), (37, 2, 4, 20, 64),
                                       (1, 3, 2, 2, 6)])
def test_moe_combine_kernel_equals_plain(dev, dtype, T, k, E, C, H):
    """The token-major combine equals its plain version bit for bit (the
    products and sums in fp32 in j order, no FMA), dropped assignments
    included."""
    from repro_torch.models import mlp as MLP
    g = torch.Generator(device=dev).manual_seed(9)
    idx = MLP.top_k(torch.rand((T, E), generator=g, device=dev), k)[1]
    slot_of = MLP.slot_of_assignments(MLP._dispatch_indices(idx.reshape(-1), E, 0, C),
                                      T * k).reshape(T, k)
    gate = torch.rand((T, k), generator=g, device=dev)
    yd = _randn((E, C, H), dtype, dev, 10)
    ops.reset_launches()
    got = kmoe.combine(yd, gate, slot_of)
    assert kmoe.IMPL_LAUNCHES["moe_combine"]["token"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, ref.moe_combine_plain(yd, gate, slot_of))


def test_moe_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = _randn((2, 20, 64), torch.bfloat16, dev, 1)
    w = _randn((2, 64, 64), torch.bfloat16, dev, 2)
    with pytest.raises(ValueError, match="gemv route takes C <= 16"):
        kmoe.launch(x, w, impl="gemv")
    with pytest.raises(TypeError, match="does not take"):
        kmoe.launch(x, w, impl="simt")
    with pytest.raises(TypeError, match="does not take"):
        kmoe.launch(x.float(), w.float(), impl="wgmma")
    with pytest.raises(ValueError, match="contiguous"):
        kmoe.grouped(x.transpose(1, 2).contiguous().transpose(1, 2)[:, :, :64], w)
    with pytest.raises(ValueError, match="multiples of 8"):
        kmoe.grouped(x[..., :60].contiguous(), w[:, :60].contiguous())
    with pytest.raises(TypeError, match="int32"):
        kmoe.combine(x, torch.ones(4, 2, device=dev), torch.zeros(4, 2, device=dev,
                                                                 dtype=torch.int64))


MOE_CFG = ModelConfig(name="cuda-moe", family="moe", num_layers=2, d_model=128,
                      num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=500, head_dim=64,
                      moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25))


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_prefill_and_decode_kernels_match_plain(dev, dtype, monkeypatch):
    """An MoE model's 64-token prefill (C 20: wgmma in bf16) and two decode
    ticks of two slots (C 1: gemv) through the kernels against the plain
    versions, each MoE kernel launched once a layer and step.  The plain
    path runs on the kernel path's routing (each layer's top-k choices
    replayed in call order): in bf16 a near-tie of two experts' router
    probabilities may flip between the paths, and a flipped token's rows
    differ wholly."""
    from repro_torch.models import mlp as MLP
    real_top_k, chosen, replay = MLP.top_k, [], []

    def routing_top_k(probs, k):
        if replay:
            idx = replay.pop(0)
            return probs.gather(-1, idx), idx
        vals, idx = real_top_k(probs, k)
        chosen.append(idx)
        return vals, idx

    monkeypatch.setattr(MLP, "top_k", routing_top_k)
    params = lm.init_params(MOE_CFG, seed=5, device=dev, dtype=dtype)
    logits = {}
    for plain in (False, True):
        replay[:] = chosen if plain else []
        pool = CachePool(MOE_CFG, PoolConfig(2, 16, 11, 80), device=dev, dtype=dtype)
        ops.reset_launches()
        got = []
        rng = np.random.default_rng(6)
        with torch.inference_mode():
            for n in (64, 23):
                slot = pool.admit(n)
                toks = torch.from_numpy(rng.integers(0, 500, (1, n))).to(dev)
                got.append(lm.forward(PCtx(plain=plain), MOE_CFG, params,
                                      {"tokens": toks, "_dtype": dtype},
                                      caches=pool.prefill_tree(slot)).logits[0, -1])
                pool.commit_prefill(slot, n)
            for i in range(2):
                for s in range(2):
                    assert pool.ensure_append(s)
                batch = {"tokens": torch.tensor([[7 + i], [11 + i]], device=dev),
                         "positions": torch.from_numpy(
                             pool.lengths.astype(np.int64)[:, None]).to(dev),
                         "_dtype": dtype}
                got.append(lm.forward(PCtx(plain=plain), MOE_CFG, params, batch,
                                      caches=pool.decode_tree()).logits[:, 0])
                for s in range(2):
                    pool.advance(s)
        if not plain:
            L = MOE_CFG.num_layers
            assert len(chosen) == 4 * L
            assert all(ops.LAUNCHES[k] == 4 * L for k in
                       ("moe_grouped_gated", "moe_grouped_mm", "moe_combine")), ops.LAUNCHES
            if dtype == torch.bfloat16:   # prefills of 64 (C 20) and 23 (C 7), 2 ticks (C 1)
                assert kmoe.IMPL_LAUNCHES["moe_grouped_gated"] == \
                    {"wgmma": L, "gemv": 3 * L, "simt": 0}
        logits[plain] = got
    assert not replay                      # the plain path took every recorded choice
    for a, b in zip(logits[False], logits[True]):
        _close(a, b)
