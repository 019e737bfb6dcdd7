"""MLA's absorbed decode on Hopper's tensor cores (``csrc/mla_decode.cu``:
``mla::decode_wgmma``, the bf16 route of ``flash_attention.mla_decode``).

On the CPU:

* ``mla_impl`` picks the route from the dtype, shapes, strides and
  addresses alone: ``wgmma`` for bf16 at the serving tick (contiguous
  tensors, and c_kv and k_rope as strided views of one [B, T, 288]
  buffer), ``simt`` for fp32 and for latent rows TMA cannot address (a
  broadcast over the batch, a stride of 2^40 bytes, an address off 16
  bytes);
* ``mla_splits`` at the wgmma route's 64-key tiles: every split holds a
  key, the splits cover T, and the serving tick's plan (4 rows over 544
  keys: 9 splits of one tile each); the SIMT route keeps its 32-key plan;
* an emulation of the wgmma route's arithmetic, written here and not in
  the package: 64-key tiles, the online softmax in log2 units, P split
  into two bf16 halves (hi = bf16(p), lo = bf16(p - hi)) each multiplied
  into fp32 sums, each split's state (the max in natural units) merged as
  ``mla::combine`` merges it.  On bf16-representable inputs made with
  numpy from a seed it is held against ``ref.mla_decode_plain`` and
  against the JAX package's einsums (``repro/models/attention.py:511-523``)
  at 2e-4 (the fp32 bound), at ragged kv_len, T off the tile, a row with
  kv_len 0 and B 1 to 4; P in one bf16 half is held to be the larger
  error.

Marked ``cuda`` (skipped without a card): both routes against the plain
version at those shapes, on strided views of one [B, T, 288] buffer and on
two tensors, each launch counted on its route; the broadcast on SIMT,
and the wgmma route refusing it and fp32.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mla_tc.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ref

BF = torch.bfloat16
NH, (LAT, ROPE) = 40, kfa.MLA_DIMS       # minicpm3-4b: 40 heads, latent 256, rope 32
SCALE = 96 ** -0.5                       # (dn + dr)^-0.5
TILE = kfa.MLA_TILE["wgmma"]
TOL = 2e-4                               # fp32 out: the fp32 bound
LOG2E, LN2, NEG_INF = 1.4426950408889634, 0.6931471805599453, -1e30
# (label, B, T, kv_len): the serving tick (4 slots over the pool's 544-row page
# view, one slot at length 1), one row, T off the tile, a row with kv_len 0
CASES = (("tick", 4, 544, (64, 301, 512, 1)), ("one-row", 1, 64, (64,)),
         ("off-tile", 2, 100, (37, 100)), ("empty-row", 3, 256, (256, 0, 129)))
IDS = [c[0] for c in CASES]


def _strides(*shapes):
    """The batch and row strides of contiguous tensors of these shapes."""
    return tuple(st for s in shapes for st in (s[1] * s[2], s[2]))


def _inputs(B, T, seed):
    """bf16-representable q_lat, q_rope, c_kv, k_rope (fp32) from numpy."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF).float()
                 for s in ((B, NH, LAT), (B, NH, ROPE), (B, T, LAT), (B, T, ROPE)))


def _emulate(q_lat, q_rope, c_kv, k_rope, kv_len, scale, split_p=True):
    """The wgmma route's arithmetic in fp32: per (row, split) 64-key tiles,
    S = [q_lat | q_rope] [c_kv | k_rope]^T, the online softmax in log2
    units, O += P V with P as bf16 hi + lo (or hi alone); the splits'
    (acc, max * ln 2, sum) merged as mla::combine does."""
    B, nh, L = q_lat.shape
    T = c_kv.shape[1]
    nsplit = kfa.mla_splits(B, T, "wgmma")
    tiles = -(-T // TILE)
    chunk = -(-tiles // nsplit) * TILE
    K = torch.zeros(B, tiles * TILE, L + k_rope.shape[2])   # TMA zero-fills keys past T
    K[:, :T] = torch.cat([c_kv, k_rope], dim=-1)
    q = torch.cat([q_lat, q_rope], dim=-1)
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    out = torch.empty(B, nh, L)
    for b in range(B):
        klen = min(int(kv_len[b]), T)
        none = klen <= 0
        parts = []
        for sp in range(nsplit):
            kbeg = sp * chunk
            kend = min(T if none else klen, kbeg + chunk)
            m, l, acc = torch.full((nh,), NEG_INF), torch.zeros(nh), torch.zeros(nh, L)
            for k0 in range(kbeg, kend, TILE):
                kt = K[b, k0:k0 + TILE]
                x = torch.zeros(nh, TILE) if none else (q[b] @ kt.T) * sl2
                x[:, torch.arange(k0, k0 + TILE) >= kend] = NEG_INF
                mx = torch.maximum(m, x.max(dim=1).values)
                alpha, m = torch.exp2(m - mx), mx
                p = torch.exp2(x - m[:, None])
                l = l * alpha + p.sum(dim=1)
                hi = p.to(BF).float()
                acc = acc * alpha[:, None] + hi @ kt[:, :L]
                if split_p:
                    acc = acc + (p - hi).to(BF).float() @ kt[:, :L]
            parts.append((acc, m * LN2, l))
        ms = torch.stack([p[1] for p in parts])                  # [nsplit, nh]
        w = torch.exp(ms - ms.max(dim=0).values)
        num = sum(p[0] * w[i][:, None] for i, p in enumerate(parts))
        den = sum(p[2] * w[i] for i, p in enumerate(parts))
        out[b] = torch.where(den[:, None] > 0, num / den[:, None], torch.zeros(()))
    return out


def _close(got, want):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert torch.allclose(got, want, atol=TOL, rtol=TOL), err
    return err


@pytest.fixture(scope="module")
def jx():
    """The JAX package's absorbed decode (``repro/models/attention.py``'s
    einsums, on [B, nh, L] queries) at every case, as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as JATT

    def absorbed(q_lat, q_rope, c_kv, k_rope, kv_len):
        s = (jnp.einsum("bshl,btl->bhst", q_lat[:, None], c_kv)
             + jnp.einsum("bshd,btd->bhst", q_rope[:, None], k_rope)) * SCALE
        mask = jnp.arange(c_kv.shape[1])[None, :] < kv_len[:, None]
        s = jnp.where(mask[:, None, None, :], s, JATT.NEG_INF)
        return jnp.einsum("bhst,btl->bshl", jax.nn.softmax(s, axis=-1), c_kv)[:, 0]

    out = {}
    for i, (label, B, T, kv_len) in enumerate(CASES):
        args = [jnp.asarray(t.numpy()) for t in _inputs(B, T, i)]
        out[label] = np.array(absorbed(*args, jnp.asarray(kv_len, jnp.int32)))
    return out


# ---------------------------------------------------------------------------
# the route and the split plan
# ---------------------------------------------------------------------------

def test_route_at_the_serving_tick():
    B, T = 4, 544
    shapes = ((B, NH, LAT), (B, NH, ROPE), (B, T, LAT), (B, T, ROPE))
    assert kfa.mla_impl(BF, B, NH, T, _strides(*shapes), (0, 1024, 4096, 8192)) == "wgmma"
    # c_kv and k_rope as views of one [B, T, 288] buffer: k_rope 512 bytes in
    views = _strides(*shapes[:2]) + (T * 288, 288, T * 288, 288)
    assert kfa.mla_impl(BF, B, NH, T, views, (0, 1024, 4096, 4096 + 512)) == "wgmma"
    assert kfa.mla_impl(torch.float32, B, NH, T, _strides(*shapes), (0, 1024, 4096, 8192)) \
        == "simt"


@pytest.mark.parametrize("what", ["broadcast", "huge-stride", "address"])
def test_route_where_tma_refuses(what):
    """Latent rows TMA cannot address go to SIMT; the queries (read with
    16-byte loads, not by TMA) do not decide."""
    B, T = 2, 100
    strides = list(_strides((B, NH, LAT), (B, NH, ROPE), (B, T, LAT), (B, T, ROPE)))
    ptrs = [0, 1024, 4096, 8192]
    if what == "broadcast":
        strides[4] = 0                         # one cache expanded over the batch
    elif what == "huge-stride":
        strides[6] = 1 << 39                   # 2^40 bytes
    else:
        ptrs[3] += 8
    assert kfa.mla_impl(BF, B, NH, T, tuple(strides), tuple(ptrs)) == "simt"
    strides = list(_strides((B, NH, LAT), (B, NH, ROPE), (B, T, LAT), (B, T, ROPE)))
    strides[0] = 0                             # a broadcast query is no TMA operand
    assert kfa.mla_impl(BF, B, NH, T, tuple(strides), (0, 1024, 4096, 8192)) == "wgmma"


@pytest.mark.parametrize("B,T", [(4, 544), (1, 64), (2, 100), (3, 256), (1, 1), (1, 65),
                                 (4, 4096), (64, 544), (300, 33)])
def test_splits_at_64_key_tiles(B, T):
    n = kfa.mla_splits(B, T, "wgmma")
    tiles = -(-T // TILE)
    chunk = -(-tiles // n) * TILE
    assert 1 <= n <= tiles
    assert (n - 1) * chunk < T <= n * chunk    # every split holds a key; together they cover T


def test_split_plan_at_the_serving_tick():
    """4 rows over 544 keys: 9 tiles of 64, a split each (36 blocks); the
    longest row (kv_len 512) reads 8 of them.  The SIMT route keeps 17
    splits of 32 keys."""
    assert kfa.mla_splits(4, 544, "wgmma") == 9
    assert -(-544 // TILE) == 9 and -(-512 // TILE) == 8
    assert kfa.mla_splits(4, 544) == kfa.mla_splits(4, 544, "simt") == 17


# ---------------------------------------------------------------------------
# the route's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulation_matches_plain(case):
    _, B, T, kv_len = case
    args = (*_inputs(B, T, CASES.index(case)), torch.tensor(kv_len, dtype=torch.int32))
    got = _emulate(*args, SCALE)
    _close(got, ref.mla_decode_plain(*args, SCALE))
    if 0 in kv_len:                            # kv_len 0: the uniform average of c_kv
        b = kv_len.index(0)
        _close(got[b], args[2][b].mean(dim=0)[None].expand(NH, LAT))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulation_matches_jax(jx, case):
    label, B, T, kv_len = case
    args = (*_inputs(B, T, CASES.index(case)), torch.tensor(kv_len, dtype=torch.int32))
    _close(_emulate(*args, SCALE), jx[label])


def test_p_in_two_bf16_halves():
    """P in one bf16 half is the larger error: the lo half is what keeps
    P V at the fp32 bound."""
    _, B, T, kv_len = CASES[0]
    args = (*_inputs(B, T, 0), torch.tensor(kv_len, dtype=torch.int32))
    want = ref.mla_decode_plain(*args, SCALE)
    split = (_emulate(*args, SCALE) - want).abs().max().item()
    hi_only = (_emulate(*args, SCALE, split_p=False) - want).abs().max().item()
    assert split <= TOL and hi_only > 8 * split, (split, hi_only)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(dev, B, T, seed, dtype, layout):
    """q_lat, q_rope, c_kv, k_rope on the card: c_kv and k_rope views of one
    [B, T, 288] buffer ("views", as the script's check hands them over),
    two tensors ("two", as the paged gather does), or one cache expanded
    over the batch ("broadcast")."""
    q_lat, q_rope, c_kv, k_rope = (t.to(dev, dtype) for t in _inputs(B, T, seed))
    if layout == "views":
        kv = torch.cat([c_kv, k_rope], dim=-1)
        c_kv, k_rope = kv[..., :LAT], kv[..., LAT:]
    elif layout == "broadcast":
        c_kv, k_rope = (t[:1].expand(B, -1, -1) for t in (c_kv, k_rope))
    return q_lat, q_rope, c_kv, k_rope


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["views", "two"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_card_both_routes_against_plain(dev, case, layout):
    _, B, T, kv_len = case
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    for dtype in (BF, torch.float32):
        args = (*_card_inputs(dev, B, T, CASES.index(case), dtype, layout), kl, SCALE)
        want = ref.mla_decode_plain(*args)
        routes = ("wgmma", "simt") if dtype == BF else ("simt",)
        for impl in (None,) + routes:
            kfa.reset_impl_launches()
            got = kfa.mla_decode(*args, impl=impl)
            torch.cuda.synchronize()
            route = impl or routes[0]
            assert kfa.IMPL_LAUNCHES["mla_decode"] == {r: int(r == route) for r in kfa.IMPLS}
            assert got.dtype == torch.float32 and got.shape == (B, NH, LAT)
            _close(got, want)
            if route == "wgmma":                # two calls agree bit for bit
                assert torch.equal(got, kfa.mla_decode(*args, impl="wgmma"))
        if dtype == torch.float32:
            with pytest.raises(TypeError, match="bf16"):
                kfa.mla_decode(*args, impl="wgmma")


@pytest.mark.cuda
def test_card_broadcast_goes_to_simt(dev):
    _, B, T, kv_len = CASES[2]
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    args = (*_card_inputs(dev, B, T, 2, BF, "broadcast"), kl, SCALE)
    kfa.reset_impl_launches()
    _close(kfa.mla_decode(*args), ref.mla_decode_plain(*args))
    assert kfa.IMPL_LAUNCHES["mla_decode"] == {"wgmma": 0, "simt": 1}
    with pytest.raises(ValueError, match="TMA cannot address"):
        kfa.mla_decode(*args, impl="wgmma")
