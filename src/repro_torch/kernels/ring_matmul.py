"""Ring collective matmuls: the fused route of the overlap lattice.

Counterpart of ``repro/kernels/ring_matmul.py``:

* the gates ``pick_block``, ``aligned``, ``fused_ok_ag``, ``fused_ok_rs``
  and ``fused_ok_contract``, with the JAX package's numbers (MXU tiles
  and VMEM budget), so the port sends each collective down the route the
  JAX dispatcher would;
* the public ops ``ag_matmul``, ``matmul_rs``, ``ag_matmul_contract`` and
  ``matmul_rs_pair``, each a ``torch.autograd.Function`` whose backward is
  the transposed ring, exactly as ``_ag_mm_bwd``, ``_mm_rs_bwd``,
  ``_ag_mm_contract_bwd`` and ``_mm_rs_pair_bwd``: the backward calls the
  forward kernels directly (no gate), so they take any extent;
* the helper rings ``_contract_rows_ring``, ``_place_cols_ring`` and
  ``_place_rows_ring`` (backward only; ``_pure_ag`` is
  ``comm.ring_all_gather``), whose per-step products go through the tile
  matmul (``kernels/ops.py``), which takes any extent.

Every op, forward and backward, carries ``comm_dtype``.  Under ``"int8"``
a collective whose hopped shard ``core/quant.quant_ok`` admits (the AG
and contracted rings: x; the RS: the accumulator, of the output's shape)
runs the int8 variant; the helper rings' hops are ``comm.raw_ring_hop``
of the wire dtype, as JAX's are ``quant.ring_hop``.

A tensor on the CUDA card launches the ring kernels of
``csrc/ring_matmul.cu`` (one launch per collective, the whole ring
inside, through the symmetric buffers whose addresses ``comm.ring``
hands each launch) and counts the launch in ``ops.LAUNCHES`` under its
own key (``ag_matmul``, ``matmul_rs``, ``ag_matmul_contract`` and the
int8 variants ``*_int8``).  Each of the six takes one of three routes
(``IMPLS``), which :func:`ring_impl` picks from the dtype, shapes and
strides alone: ``wgmma`` (bf16 on the tensor cores, operands staged by
TMA: wg::mm's main loop; on the int8 wire an arriving shard's A
dequantized in registers between TMA and wgmma, and the matmul-RS's
arriving pair dequantized in its epilogue, its rows requantized after a
grid barrier), ``wmma`` (the bf16 tile loop, for operands TMA cannot
address) and ``simt`` (fp32); ``IMPL_LAUNCHES`` counts each route's
launches.  Every launch takes a block cap (0:
one block an SM at most, the process ring); ``kernels/ring_loopback.py``
runs all n ranks of a ring in one process on n streams with its own
descriptors and counters.  A tensor on the CPU, or ``plain=True``, takes
the plain versions of ``kernels/ref.py`` (bulk collectives and one fp32
matmul; under int8 the shards quantized once, the RS as a ring that
requantizes its accumulator at every hop).  All ops run inside a grid
world, on per-rank blocks, as the JAX ops run inside ``shard_map``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import build, matmul, ops, ref
from repro_torch.parallel import comm

BLOCK_M, BLOCK_N, BLOCK_K = 128, 128, 512
VMEM_BUDGET = 12 * 2 ** 20
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STEPS = 16                     # ring sizes the kernels take (csrc MAX_STEPS)
# seconds a kernel waits for a peer before it traps (a lost rank fails the
# launch instead of hanging the card)
SPIN_TIMEOUT_S = 120.0

check_comm_dtype = Q.check_comm_dtype


# ---------------------------------------------------------------------------
# gates (the JAX package's, unchanged)
# ---------------------------------------------------------------------------

def pick_block(dim: int, pref: int) -> int:
    """Largest tile <= ``pref`` that divides ``dim`` (always succeeds)."""
    if dim <= pref:
        return max(dim, 1)
    if dim % pref == 0:
        return pref
    for b in range(pref - 1, 0, -1):
        if dim % b == 0:
            return b
    return 1


def aligned(dim: int, pref: int) -> bool:
    """Tile-aligned in the fused-kernel sense: one tile, or MXU-tiled."""
    return dim <= pref or dim % pref == 0


def _mk(shape3) -> Tuple[int, int]:
    b, t, h = shape3
    return b * t, h


def _prod(shape) -> int:
    p = 1
    for s in shape:
        p *= s
    return p


def _fits_vmem(*byte_counts) -> bool:
    return sum(byte_counts) <= VMEM_BUDGET


def _tile_bytes(itemsize: int) -> int:
    return (BLOCK_M * BLOCK_N * 4
            + 2 * (BLOCK_M * BLOCK_K + BLOCK_K * BLOCK_N + BLOCK_M * BLOCK_N) * itemsize)


def fused_ok_ag(x_shape, w_shape, n: int, dim: int = 1, itemsize: int = 4) -> bool:
    """Can ``ag_matmul`` run fused for x [b,t,h] (gather ``dim``), w [h,o]?"""
    if n <= 1 or len(x_shape) != 3 or dim != 1:
        return False
    m, k = _mk(x_shape)
    return (x_shape[-1] == w_shape[0] and aligned(m, BLOCK_M)
            and aligned(k, BLOCK_K) and aligned(w_shape[-1], BLOCK_N)
            and _fits_vmem(2 * _prod(x_shape) * itemsize, _tile_bytes(itemsize)))


def fused_ok_rs(x_shape, w_shape, n: int, scatter_dim: int, itemsize: int = 4) -> bool:
    """Can ``matmul_rs`` run fused for x [b,t,h] @ w [h,o], scatter ``dim``?"""
    if n <= 1 or len(x_shape) != 3:
        return False
    last = scatter_dim == len(x_shape) - 1
    scattered = w_shape[-1] if last else x_shape[scatter_dim]
    if scattered % n:
        return False
    chunk = scattered // n
    if last:
        m, k, nn = x_shape[0] * x_shape[1], x_shape[-1], chunk
        out_elts = _prod(x_shape[:-1]) * chunk
    else:
        m, k, nn = x_shape[0] * chunk, x_shape[-1], w_shape[-1]
        out_elts = x_shape[0] * chunk * w_shape[-1]
    return (x_shape[-1] == w_shape[0] and aligned(m, BLOCK_M)
            and aligned(k, BLOCK_K) and aligned(nn, BLOCK_N)
            and _fits_vmem(2 * out_elts * itemsize, _tile_bytes(itemsize)))


def fused_ok_contract(x_shape, w_shape, n: int, itemsize: int = 4) -> bool:
    """Can ``ag_matmul_contract`` run fused (gathered dim contracted)?"""
    if n <= 1 or len(x_shape) != 3 or w_shape[0] != n * x_shape[-1]:
        return False
    m, k = _mk(x_shape)
    return (aligned(m, BLOCK_M) and aligned(k, BLOCK_K)
            and aligned(w_shape[-1], BLOCK_N)
            and _fits_vmem(2 * _prod(x_shape) * itemsize,
                           m * w_shape[-1] * 4, _tile_bytes(itemsize)))


# ---------------------------------------------------------------------------
# the routes of the ring kernels, and their occupancy
# ---------------------------------------------------------------------------

# the routes of every ring kernel on either wire (numbered as
# csrc/ring_matmul.cu's RING_*): the tensor cores through TMA and wgmma, or the
# tile loop on WMMA (bf16) or SIMT (fp32)
IMPLS = ("wgmma", "wmma", "simt")
WG_BM = 128                        # rows of a wgmma tile (a TMA box of A)
# the kernels a launch takes, numbered as hk_ring_occupancy's
KERNEL_IDS = {"ag_matmul": 0, "matmul_rs": 1, "ag_matmul_contract": 2, "ag_matmul_int8": 3,
              "matmul_rs_int8": 4, "ag_matmul_contract_int8": 5}

# the kernels that take a route, by their keys in ops.LAUNCHES
ROUTED = ("ag_matmul", "matmul_rs", "ag_matmul_contract", "ag_matmul_int8", "matmul_rs_int8",
          "ag_matmul_contract_int8")
# launches per route, counted where each wrapper launches its kernel
IMPL_LAUNCHES: Dict[str, Dict[str, int]] = {k: {p: 0 for p in IMPLS} for k in ROUTED}


def reset_impl_launches() -> None:
    """Zero ``IMPL_LAUNCHES``."""
    for counts in IMPL_LAUNCHES.values():
        for route in counts:
            counts[route] = 0


def _dense(shape, strides) -> bool:
    """Row-major with no gaps (dims of extent 1 may carry any stride)."""
    want = 1
    for size, st in zip(reversed(tuple(shape)), reversed(tuple(strides))):
        if size > 1 and st != want:
            return False
        want *= size
    return True


def ring_impl(dtype: torch.dtype, shapes, strides, n: int,
              scatter_dim: Optional[int] = None, ptr_align: int = 16, *, int8: bool = False,
              contract: bool = False, split: int = 0) -> str:
    """The route of one AG-matmul (``scatter_dim`` None) or matmul-RS launch
    of x [b,t,h] @ w [h,o], or (``contract``) contracted AG-matmul of x
    [b,t,h] @ w [n h,o], on a ring of ``n`` on the bf16 wire or (``int8``)
    the int8 wire, from the dtype, ``shapes`` (x's, w's), ``strides`` (x's,
    w's, in elements), ``ptr_align`` (the byte alignment both addresses
    share) and ``split`` (the int8 gated pair's second half's first column)
    alone, as ``matmul.mm_impl``:

    * ``"simt"`` for fp32;
    * ``"wgmma"`` for bf16 that TMA can address: both operands dense, their
      rows (h, o) and addresses on 16 bytes, and on the int8 wire the AG
      rings' hopped payload rows too (h % 16 == 0); for matmul-RS over
      tokens the chunk t / n whole 128-row boxes (a box of A must not cross
      into the next destination's rows), over columns a chunk o / n on 16
      bytes (the hop's rows, stored a 16-byte chunk at a time), and on the
      int8 wire ``split`` on 8 columns (a 16-byte output chunk takes one
      scale);
    * ``"wmma"`` for every other bf16 launch (the backward's ragged and
      off-8 extents)."""
    if dtype != torch.bfloat16:
        return "simt"
    (xs, ws), (xst, wst) = shapes, strides
    b, t, h = xs
    o = ws[-1]
    ok = (min(b, t, h, o) >= 1 and _dense(xs, xst) and _dense(ws, wst)
          and h % (16 if int8 and scatter_dim is None else 8) == 0 and o % 8 == 0
          and ptr_align % 16 == 0 and split % 8 == 0)
    if scatter_dim is not None:
        if scatter_dim % len(xs) == len(xs) - 1:
            ok = ok and o % n == 0 and (o // n) % 8 == 0
        else:
            ok = ok and t % n == 0 and (t // n) % WG_BM == 0
    return "wgmma" if ok else "wmma"


def _choose(impl: Optional[str], chosen: str, dtype: torch.dtype) -> str:
    """``impl`` (or the chosen route) after checking that it takes these
    operands."""
    impl = impl or chosen
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if (impl == "simt") != (dtype == torch.float32):
        raise TypeError(f"the {impl} route does not take {dtype}")
    if impl == "wgmma" and chosen != "wgmma":
        raise ValueError("TMA cannot address these operands: the wgmma route does not take them")
    return impl


def occupancy(kernel: str, dtype: torch.dtype, impl: Optional[str] = None,
              out_dtype: Optional[torch.dtype] = None) -> Tuple[int, int]:
    """(blocks an SM holds at once, SMs) of the kernel that a launch of
    ``kernel`` (a key of ``KERNEL_IDS``) on ``impl`` takes."""
    lib = build.library("ring_matmul")
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    route = IMPLS.index(impl) if impl else IMPLS.index("simt" if dtype == torch.float32
                                                       else "wmma")
    build.check(lib, lib.hk_ring_occupancy(KERNEL_IDS[kernel], DTYPES[dtype],
                                           DTYPES[out_dtype or dtype], route,
                                           ctypes.byref(per_sm), ctypes.byref(sms)),
                "hk_ring_occupancy")
    return per_sm.value, sms.value


# ---------------------------------------------------------------------------
# the CUDA launches: each takes its ring descriptor from ``ring_of(nbytes)``
# (``comm.ring`` for the process ring), the block counters and a block cap
# ---------------------------------------------------------------------------

_COUNTERS = {}


def new_counters(device) -> torch.Tensor:
    """One launch's counters of the kernel's blocks (2 arrival counts per
    ring step, then one grid-barrier count per step)."""
    return torch.zeros(3 * MAX_STEPS, dtype=torch.int32, device=device)


def _counters(device) -> torch.Tensor:
    """The process ring's counters, zeroed on the stream before each launch."""
    if device not in _COUNTERS:
        _COUNTERS[device] = new_counters(device)
    return _COUNTERS[device]


def _ring_args(ring: Tuple[int, ...], counters: torch.Tensor):
    """The kernel's argument array: the descriptor's eight addresses, the
    block counters (zeroed here, on the launch's stream), then hop0, n, me
    and the spin timeout."""
    n = ring[9]
    if not 2 <= n <= MAX_STEPS:
        raise ValueError(f"the ring kernels take rings of 2..{MAX_STEPS}, got {n}")
    counters.zero_()
    vals = list(ring[:8]) + [counters.data_ptr()] + list(ring[8:]) + [
        int(SPIN_TIMEOUT_S * 1e9)]
    return (ctypes.c_ulonglong * len(vals))(*vals)


def _check(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"CUDA ring kernel got a {t.device} tensor")
        if t.dtype not in DTYPES or t.dtype != ts[0].dtype:
            raise TypeError("ring kernels take fp32 or bf16 operands of one dtype")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _align16(v: int) -> int:
    return (v + 15) // 16 * 16


def _qpair_bytes(rows: int, cols: int, nseg: int = 1) -> int:
    """Bytes of one int8 hop of a [rows, cols] shard with ``nseg`` scales a
    row: the payload, then the fp32 scales, each padded to 16 bytes (the
    slot layout of ``csrc/ring_matmul.cu``)."""
    return _align16(rows * cols) + _align16(4 * rows * nseg)


def _pair(rows: int, cols: int, device) -> torch.Tensor:
    """Scratch for the int8 AG kernels' pair: their C entries quantize x into
    it (``quant_pair`` in ``csrc/ring_matmul.cu``), on every route, before
    the ring kernel circulates it."""
    return torch.empty(_qpair_bytes(rows, cols), dtype=torch.uint8, device=device)


def _route(x, w, n: int, scatter_dim: Optional[int], impl: Optional[str], *,
           int8: bool = False, contract: bool = False, split: int = 0) -> str:
    chosen = ring_impl(x.dtype, (tuple(x.shape), tuple(w.shape)), (x.stride(), w.stride()), n,
                       scatter_dim, matmul.shared_align(x, w), int8=int8, contract=contract,
                       split=split)
    return _choose(impl, chosen, x.dtype)


def _launch_ag(x, w, ring_of: Callable, n: int, int8: bool = False, *,
               counters: Optional[torch.Tensor] = None, blocks: int = 0,
               impl: Optional[str] = None) -> torch.Tensor:
    x, w = x.contiguous(), w.contiguous()
    _check(x, w)
    b, t, h = x.shape
    o = w.shape[1]
    counters = _counters(x.device) if counters is None else counters
    out = torch.empty((b, n * t, o), dtype=x.dtype, device=x.device)
    lib = build.library("ring_matmul")
    impl = _route(x, w, n, None, impl, int8=int8)
    if int8:
        pair = _pair(b * t, h, x.device)
        ring = _ring_args(ring_of(pair.numel()), counters)
        build.check(lib, lib.hk_ring_ag_matmul_int8(
            x.data_ptr(), pair.data_ptr(), w.data_ptr(), out.data_ptr(), ring, b, t, h, o,
            DTYPES[x.dtype], IMPLS.index(impl), blocks, _stream(x)), "hk_ring_ag_matmul_int8")
        ops.LAUNCHES["ag_matmul_int8"] += 1
        IMPL_LAUNCHES["ag_matmul_int8"][impl] += 1
        return out
    ring = _ring_args(ring_of(x.numel() * x.element_size()), counters)
    build.check(lib, lib.hk_ring_ag_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(), ring,
                                           b, t, h, o, DTYPES[x.dtype], IMPLS.index(impl),
                                           blocks, _stream(x)),
                "hk_ring_ag_matmul")
    ops.LAUNCHES["ag_matmul"] += 1
    IMPL_LAUNCHES["ag_matmul"][impl] += 1
    return out


def _launch_rs(x, w, ring_of: Callable, scatter_dim: int, n: int, int8: bool = False,
               split: int = 0, *, counters: Optional[torch.Tensor] = None, blocks: int = 0,
               impl: Optional[str] = None) -> torch.Tensor:
    """``split`` (int8, the gated pair): the column where the second half of
    each accumulator row starts; each half crosses with its own scale."""
    x, w = x.contiguous(), w.contiguous()
    _check(x, w)
    b, t, h = x.shape
    o = w.shape[1]
    last = scatter_dim == x.dim() - 1
    if (o if last else t) % n:
        raise ValueError(f"matmul-RS: extent {o if last else t} does not chunk by ring {n}")
    shape = (b, t, o // n) if last else (b, t // n, o)
    counters = _counters(x.device) if counters is None else counters
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    lib = build.library("ring_matmul")
    impl = _route(x, w, n, scatter_dim, impl, int8=int8, split=split)
    if int8:
        rows, cols = out.numel() // shape[-1], shape[-1]
        work = torch.empty_like(out)
        ring = _ring_args(ring_of(_qpair_bytes(rows, cols, 2 if split else 1)), counters)
        build.check(lib, lib.hk_ring_matmul_rs_int8(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), work.data_ptr(), ring, b, t, h, o,
            int(last), split, DTYPES[x.dtype], IMPLS.index(impl), blocks, _stream(x)),
            "hk_ring_matmul_rs_int8")
        ops.LAUNCHES["matmul_rs_int8"] += 1
        IMPL_LAUNCHES["matmul_rs_int8"][impl] += 1
        return out
    ring = _ring_args(ring_of(out.numel() * out.element_size()), counters)
    build.check(lib, lib.hk_ring_matmul_rs(x.data_ptr(), w.data_ptr(), out.data_ptr(), ring,
                                           b, t, h, o, int(last), DTYPES[x.dtype],
                                           IMPLS.index(impl), blocks, _stream(x)),
                "hk_ring_matmul_rs")
    ops.LAUNCHES["matmul_rs"] += 1
    IMPL_LAUNCHES["matmul_rs"][impl] += 1
    return out


def _launch_contract(x, w, ring_of: Callable, n: int, out_dtype, int8: bool = False, *,
                     counters: Optional[torch.Tensor] = None, blocks: int = 0,
                     impl: Optional[str] = None) -> torch.Tensor:
    x, w = x.contiguous(), w.contiguous()
    _check(x, w)
    b, t, hl = x.shape
    o = w.shape[1]
    if w.shape[0] != n * hl:
        raise ValueError(f"contracted ring: w rows {w.shape[0]} != {n} x {hl}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {x.dtype} or float32")
    counters = _counters(x.device) if counters is None else counters
    out = torch.empty((b, t, o), dtype=out_dtype, device=x.device)
    acc = torch.empty((b * t, o), dtype=torch.float32, device=x.device)
    lib = build.library("ring_matmul")
    impl = _route(x, w, n, None, impl, int8=int8, contract=True)
    if int8:
        pair = _pair(b * t, hl, x.device)
        ring = _ring_args(ring_of(pair.numel()), counters)
        build.check(lib, lib.hk_ring_ag_matmul_contract_int8(
            x.data_ptr(), pair.data_ptr(), w.data_ptr(), out.data_ptr(), acc.data_ptr(), ring,
            b * t, hl, o, DTYPES[x.dtype], DTYPES[out_dtype], IMPLS.index(impl), blocks,
            _stream(x)), "hk_ring_ag_matmul_contract_int8")
        ops.LAUNCHES["ag_matmul_contract_int8"] += 1
        IMPL_LAUNCHES["ag_matmul_contract_int8"][impl] += 1
        return out
    ring = _ring_args(ring_of(x.numel() * x.element_size()), counters)
    build.check(lib, lib.hk_ring_ag_matmul_contract(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), acc.data_ptr(), ring, b * t, hl, o,
        DTYPES[x.dtype], DTYPES[out_dtype], IMPLS.index(impl), blocks, _stream(x)),
        "hk_ring_ag_matmul_contract")
    ops.LAUNCHES["ag_matmul_contract"] += 1
    IMPL_LAUNCHES["ag_matmul_contract"][impl] += 1
    return out


def _process_ring(ax: str, n: int) -> Callable:
    """The process ring's descriptor of axis ``ax`` (``comm.ring``)."""
    return lambda nbytes: comm.ring(ax, n, nbytes)


def pingpong(ax: str, rounds: int = 200) -> float:
    """The flag ping-pong probe of ``comm.pingpong`` under this module's
    spin timeout."""
    return comm.pingpong(ax, rounds, SPIN_TIMEOUT_S)


# ---------------------------------------------------------------------------
# forward routes (no autograd): the kernel on the card, else the plain version
# ---------------------------------------------------------------------------

def _plain_route(x, plain: bool) -> bool:
    return plain or ops._on_cpu(x)


def ag_fwd(x, w, ax: str, dim: int, n: int, comm_dtype: str = "bf16", plain: bool = False):
    if n <= 1:
        return ops.tile_mm(x, w, plain=plain)
    if dim != 1:
        raise ValueError("the ring AG-matmul gathers the token dim (1)")
    int8 = Q.hop_int8(comm_dtype, x.shape, x.dtype)
    if _plain_route(x, plain):
        return (ref.ag_matmul_int8_plain if int8 else ref.ag_matmul_plain)(x, w, ax, dim=dim)
    return _launch_ag(x, w, _process_ring(ax, n), n, int8)


def _rs_out_shape(x, o: int, scatter_dim: int, n: int):
    shape = list(x.shape[:-1]) + [o]
    shape[scatter_dim] //= n
    return shape


def rs_fwd(x, w, ax: str, scatter_dim: int, n: int, comm_dtype: str = "bf16",
           plain: bool = False):
    if n <= 1:
        return ops.tile_mm(x, w, plain=plain)
    scatter_dim = scatter_dim % x.dim()
    int8 = Q.hop_int8(comm_dtype, _rs_out_shape(x, w.shape[-1], scatter_dim, n), x.dtype)
    if _plain_route(x, plain):
        return (ref.matmul_rs_int8_plain if int8 else ref.matmul_rs_plain)(
            x, w, ax, scatter_dim=scatter_dim)
    return _launch_rs(x, w, _process_ring(ax, n), scatter_dim, n, int8)


def contract_fwd(x, w, ax: str, n: int, out_dtype=None, comm_dtype: str = "bf16",
                 plain: bool = False):
    dt = out_dtype or x.dtype
    if n <= 1:
        return ops.tile_mm(x, w, out_dtype=dt, plain=plain)
    int8 = Q.hop_int8(comm_dtype, x.shape, x.dtype)
    if _plain_route(x, plain):
        return (ref.ag_matmul_contract_int8_plain if int8 else ref.ag_matmul_contract_plain)(
            x, w, ax, out_dtype=dt)
    return _launch_contract(x, w, _process_ring(ax, n), n, dt, int8)


def pair_fwd(x, w1, w1b, ax: str, scatter_dim: int, n: int, comm_dtype: str = "bf16",
             plain: bool = False):
    """w1 and w1b of one shape (the gated up-projections)."""
    o1 = w1.shape[-1]
    if n <= 1:
        y = ops.tile_mm(x, torch.cat([w1, w1b], dim=1), plain=plain)
        return y[..., :o1], y[..., o1:]
    scatter_dim = scatter_dim % x.dim()
    int8 = Q.hop_int8(comm_dtype, _rs_out_shape(x, o1, scatter_dim, n), x.dtype)
    if _plain_route(x, plain):
        return (ref.matmul_rs_pair_int8_plain if int8 else ref.matmul_rs_pair_plain)(
            x, w1, w1b, ax, scatter_dim=scatter_dim)
    if scatter_dim == x.dim() - 1:
        raise ValueError("the pair variant scatters the token dim")
    # one kernel over the column-concatenated weights: each x tile is read
    # once for both products (the shared-x-tile trick), halves split after;
    # on the int8 wire each half of a row crosses with its own scale
    y = _launch_rs(x, torch.cat([w1, w1b], dim=1), _process_ring(ax, n), scatter_dim, n, int8,
                   split=o1 if int8 else 0)
    return y[..., :o1].contiguous(), y[..., o1:].contiguous()


# ---------------------------------------------------------------------------
# helper rings (backward only), per-step products on the tile matmul
# ---------------------------------------------------------------------------

def _flat(x3: torch.Tensor) -> torch.Tensor:
    return x3.reshape(-1, x3.shape[-1])


def _dw_term(a, b, plain: bool):
    """a^T @ b in fp32 (a [m, h] read transposed in place, b [m, o])."""
    return ops.tile_mm(_flat(a).contiguous().t(), _flat(b).contiguous(),
                       out_dtype=torch.float32, plain=plain)


def _contract_rows_ring(x, dy, ax: str, scatter_dim: int, n: int, w_dtype, comm_dtype: str,
                        plain: bool):
    """dw = sum_d take(x, d chunk)^T @ dy_d: dy circulates, contracted per step."""
    idx = comm.axis_index(ax)
    chunk = x.shape[scatter_dim] // n
    dw, cur = None, dy
    for s in range(n):
        d = (idx - s) % n
        term = _dw_term(x.narrow(scatter_dim, d * chunk, chunk), cur.to(x.dtype), plain)
        dw = term if dw is None else dw + term
        if s < n - 1:
            cur = comm.raw_ring_hop(cur, ax, 1, comm_dtype)
    return dw.to(w_dtype)


def _place_cols_ring(x, dy, ax: str, n: int, w_dtype, comm_dtype: str, plain: bool):
    """dw[:, d chunk] = x^T @ dy_d: dy circulates, column chunks placed."""
    idx = comm.axis_index(ax)
    parts = [None] * n
    cur = dy
    for s in range(n):
        parts[(idx - s) % n] = _dw_term(x, cur.to(x.dtype), plain)
        if s < n - 1:
            cur = comm.raw_ring_hop(cur, ax, 1, comm_dtype)
    return torch.cat(parts, dim=1).to(w_dtype)


def _place_rows_ring(x, dy, ax: str, n: int, w_dtype, comm_dtype: str, plain: bool):
    """dw[d h_loc, :] = x_d^T @ dy: x circulates, row chunks placed."""
    idx = comm.axis_index(ax)
    parts = [None] * n
    dyc = dy.to(x.dtype)
    cur = x
    for s in range(n):
        parts[(idx - s) % n] = _dw_term(cur, dyc, plain)
        if s < n - 1:
            cur = comm.raw_ring_hop(cur, ax, 1, comm_dtype)
    return torch.cat(parts, dim=0).to(w_dtype)


# ---------------------------------------------------------------------------
# public ops: the backward is the transposed ring
# ---------------------------------------------------------------------------

class _AgMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ax, dim, n, comm_dtype, plain):
        ctx.save_for_backward(x, w)
        ctx.cfg = (ax, dim, n, comm_dtype, plain)
        return ag_fwd(x, w, ax, dim, n, comm_dtype, plain)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        ax, dim, n, cd, plain = ctx.cfg
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:      # transpose(AG-matmul) = matmul-RS
            dx = rs_fwd(dy, w.t(), ax, dim, n, cd, plain).to(x.dtype)
        if ctx.needs_input_grad[1]:
            xg = comm.ring_all_gather(x, ax, dim=dim, n=n, comm_dtype=cd)
            dw = _dw_term(xg, dy, plain).to(w.dtype)
        return dx, dw, None, None, None, None, None


class _MatmulRs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ax, scatter_dim, n, comm_dtype, plain):
        ctx.save_for_backward(x, w)
        ctx.cfg = (ax, scatter_dim % x.dim(), n, comm_dtype, plain)
        return rs_fwd(x, w, ax, scatter_dim, n, comm_dtype, plain)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        ax, sd, n, cd, plain = ctx.cfg
        dy = dy.contiguous()
        dx = dw = None
        if sd == x.dim() - 1:            # dx = AG_cols(dy) (x) w^T, contracted
            if ctx.needs_input_grad[0]:
                dx = contract_fwd(dy.to(x.dtype), w.t(), ax, n, x.dtype, cd, plain).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = _place_cols_ring(x, dy, ax, n, w.dtype, cd, plain)
        else:                            # transpose(matmul-RS) = AG-matmul
            if ctx.needs_input_grad[0]:
                dx = ag_fwd(dy.to(x.dtype), w.t(), ax, sd, n, cd, plain)
            if ctx.needs_input_grad[1]:
                dw = _contract_rows_ring(x, dy, ax, sd, n, w.dtype, cd, plain)
        return dx, dw, None, None, None, None, None


class _AgMatmulContract(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ax, n, out_dtype, comm_dtype, plain):
        ctx.save_for_backward(x, w)
        ctx.cfg = (ax, n, comm_dtype, plain)
        return contract_fwd(x, w, ax, n, out_dtype, comm_dtype, plain)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        ax, n, cd, plain = ctx.cfg
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:      # dx is a matmul-RS over w^T's columns
            dx = rs_fwd(dy.to(x.dtype), w.t(), ax, dy.dim() - 1, n, cd, plain).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _place_rows_ring(x, dy, ax, n, w.dtype, cd, plain)
        return dx, dw, None, None, None, None, None


class _MatmulRsPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w1b, ax, scatter_dim, n, comm_dtype, plain):
        ctx.save_for_backward(x, w1, w1b)
        ctx.cfg = (ax, scatter_dim % x.dim(), n, comm_dtype, plain)
        return pair_fwd(x, w1, w1b, ax, scatter_dim, n, comm_dtype, plain)

    @staticmethod
    def backward(ctx, dh, dg):
        x, w1, w1b = ctx.saved_tensors
        ax, sd, n, cd, plain = ctx.cfg
        shape = list(x.shape)
        shape[sd] //= max(n, 1)
        dh = torch.zeros(shape[:-1] + [w1.shape[-1]], dtype=x.dtype, device=x.device) \
            if dh is None else dh.contiguous()
        dg = torch.zeros(shape[:-1] + [w1b.shape[-1]], dtype=x.dtype, device=x.device) \
            if dg is None else dg.contiguous()
        dx = dw1 = dw1b = None
        if ctx.needs_input_grad[0]:
            dx = (ag_fwd(dh.to(x.dtype), w1.t(), ax, sd, n, cd, plain)
                  + ag_fwd(dg.to(x.dtype), w1b.t(), ax, sd, n, cd, plain))
        if ctx.needs_input_grad[1]:
            dw1 = _contract_rows_ring(x, dh, ax, sd, n, w1.dtype, cd, plain)
        if ctx.needs_input_grad[2]:
            dw1b = _contract_rows_ring(x, dg, ax, sd, n, w1b.dtype, cd, plain)
        return dx, dw1, dw1b, None, None, None, None, None


def ag_matmul(x, w, ax: str, *, dim: int = 1, n: int, comm_dtype: str = "bf16",
              plain: bool = False):
    """Fused all-gather + matmul; x [b,t,h] gathered over ``ax`` along
    ``dim`` (tokens), w [h,o]; out [b, n t, o]."""
    return _AgMatmul.apply(x, w, ax, dim, n, check_comm_dtype(comm_dtype), plain)


def matmul_rs(x, w, ax: str, *, scatter_dim: int, n: int, comm_dtype: str = "bf16",
              plain: bool = False):
    """Fused matmul + reduce-scatter over ``ax`` along ``scatter_dim``."""
    return _MatmulRs.apply(x, w, ax, scatter_dim, n, check_comm_dtype(comm_dtype), plain)


def ag_matmul_contract(x, w, ax: str, *, n: int, out_dtype=None, comm_dtype: str = "bf16",
                       plain: bool = False):
    """Fused all-gather + matmul over the contracted (last) dim; w [n h_loc, o]."""
    return _AgMatmulContract.apply(x, w, ax, n, out_dtype, check_comm_dtype(comm_dtype), plain)


def matmul_rs_pair(x, w1, w1b, ax: str, *, scatter_dim: int, n: int, comm_dtype: str = "bf16",
                   plain: bool = False):
    """Gated pair: (x w1, x w1b), both reduce-scattered over tokens; one
    kernel over [w1 | w1b].  The caller applies the gate."""
    return _MatmulRsPair.apply(x, w1, w1b, ax, scatter_dim, n, check_comm_dtype(comm_dtype),
                               plain)
