"""Collectives over the grid's axes: what ``shard_map`` gives the JAX bodies.

The JAX package writes each hecaton op as a ``shard_map`` body that calls
``lax.all_gather``, ``lax.psum_scatter``, ``lax.psum`` and
``lax.ppermute`` over mesh axis names.  The port runs one process per
rank (``launch/mesh.py``), and this module is those four collectives over
the processes of one axis group:

* :func:`all_gather` (tiled, rank order), :func:`psum_scatter` (tiled),
  :func:`psum` over one axis or a tuple of axes, and :func:`ppermute` to
  the neighbour ``shift`` places along one axis;
* the ring hop of the wire dtype, :func:`ring_hop` (``quant.ring_hop``
  of the JAX package): under ``comm_dtype="int8"`` a shard that
  ``core/quant.quant_ok`` admits crosses as :func:`q_hop`, which sends
  the (int8 payload, fp32 row scales) pair and dequantizes on receipt,
  and whose backward is the same quantized hop over the inverse shift;
  every other shard is a plain :func:`ppermute`;
* each is a ``torch.autograd.Function`` whose backward is its transpose
  over the group: all-gather <-> reduce-scatter, ppermute <-> the reverse
  ppermute, psum -> psum.  A rank's gradient is its own contribution
  (the transpose of a collective sums the contributions of every rank),
  so a loss that every rank holds whole is differentiated from ``1 /
  world`` on each rank, and the gradient of a leaf that several ranks
  hold is the sum over those ranks (``train/step.py``).

Two transports, picked by the device the world runs on:

* **CPU**: gloo process groups carry the data.  Rendezvous goes through
  a ``FileStore`` in a temporary directory (several worlds may start at
  once; no fixed TCP port).  gloo has no reduce-scatter, so
  :func:`psum_scatter` is an all-reduce and a slice there.
* **CUDA**: gloo carries control only (barriers and the exchange of
  handles).  Every rank allocates one *symmetric buffer* on its card and
  every peer opens it through its CUDA IPC handle
  (``csrc/ring_matmul.cu``: ``hk_sym_alloc``/``hk_sym_open``).  A bulk
  collective writes this rank's part into its own buffer, synchronises,
  meets its group at a barrier, reads the peers' parts with device
  copies (and sums them in fp32 for a reduction), then meets the group
  again before the buffer is reused.  The fused ring kernels
  (``kernels/ring_matmul.py``) use the same buffers: per axis, two
  receive slots and two counters (``landed``, ``credit``) that the
  kernels set and spin on from inside one launch.

The axes are the grid's ``data``, ``mx`` and ``my`` and megatron's
derived ``model`` (``launch/mesh.RING_AXES``): each of size > 1 gets its
gloo groups, and on CUDA its ring counters at ``64 c`` in the flag
region and its two receive slots (c its index in ``RING_AXES``), so a
ring of any size on any of them has its own hop count and memory.

The pipeline's ``pod`` axis (``launch/mesh.POD``) gets gloo groups only:
:func:`raw_psum` over it (the global norm across stages) goes through
the bulk region like any bulk collective, and :func:`pod_exchange` is
the stage-boundary hop, a point-to-point copy between the ranks of one
``pod`` group (gloo's ``isend``/``irecv`` on the CPU; on CUDA the sender
publishes through its bulk region and the receiver copies out of it
between two barriers of the group), so it needs no ring slots.
"""

from __future__ import annotations

import ctypes
import math
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core import quant as Q
from repro_torch.kernels import build
from repro_torch.launch.mesh import GROUP_AXES, POD, RING_AXES, Grid

# symmetric buffer layout (bytes), the same on every rank
FLAGS_BYTES = 4096                 # per ring axis c: landed at 64c, credit at 64c + 8
PROBE_OFFSET = 2048                # the ping-pong probe's two counters
# a receive slot holds the largest shard a ring kernel circulates (the
# full-width gated pair's fp32 accumulator, [4, 256, 3072], is 12.6 MB)
SLOT_BYTES = 32 * 2 ** 20
BULK_BYTES = 64 * 2 ** 20          # larger bulk collectives go in rounds


def _slots_offset(c: int) -> int:
    return FLAGS_BYTES + c * 2 * SLOT_BYTES


BULK_OFFSET = _slots_offset(len(RING_AXES))
SYM_BYTES = BULK_OFFSET + BULK_BYTES


class _CudaArray:
    """A raw device pointer that ``torch.as_tensor`` can alias (no copy)."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                         "data": (ptr, False), "version": 2}


@dataclass
class World:
    grid: Grid
    device: torch.device
    groups: Dict[str, object] = field(default_factory=dict)
    # CUDA transport: base pointers of every rank's symmetric buffer (this
    # rank's own allocation and the peers' opened handles) and a uint8
    # tensor aliasing each
    bases: Dict[int, int] = field(default_factory=dict)
    views: Dict[int, torch.Tensor] = field(default_factory=dict)
    # fused-kernel hops issued so far on each axis (the same on every rank
    # of a ring: SPMD order)
    hops: Dict[str, int] = field(default_factory=lambda: {a: 0 for a in RING_AXES})
    probes: int = 0                    # ping-pong probes run (their counters grow)
    exchanges: int = 0                 # pod_exchange calls (the gloo tags)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"


_WORLD: Optional[World] = None


def world() -> World:
    if _WORLD is None:
        raise RuntimeError("no grid world: call comm.init_world first")
    return _WORLD


def init_world(grid: Grid, *, device="cpu", init_file: Optional[str] = None,
               timeout_s: float = 600.0) -> World:
    """Join the world of ``grid`` as ``grid.rank``: the gloo process group
    (rendezvous through a ``FileStore`` at ``init_file``, which every rank
    of the world names), one gloo group per line of each axis (megatron's
    ``model`` and the pipeline's ``pod`` included; axes of size 1 open
    none), and on CUDA the symmetric buffers."""
    global _WORLD
    import datetime
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", grid.rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if grid.world > 1:
        if init_file is None:
            raise ValueError("a world of more than one rank needs an init_file")
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=grid.rank,
                                world_size=grid.world,
                                timeout=datetime.timedelta(seconds=timeout_s))
    w = World(grid, dev)
    for ax in GROUP_AXES:
        if grid.size(ax) == 1:
            continue
        seen = set()
        for r in range(grid.world):                   # every rank, the same order
            ranks = tuple(grid.axis_ranks(ax, r))
            if ranks in seen:
                continue
            seen.add(ranks)
            g = dist.new_group(list(ranks), backend="gloo")
            if grid.rank in ranks:
                w.groups[ax] = g
    _WORLD = w
    if w.cuda and grid.world > 1:
        _open_symmetric(w)
    return w


def shutdown() -> None:
    """Leave the world: close the peers' handles, free this rank's buffer,
    destroy the process groups."""
    global _WORLD
    w = _WORLD
    if w is None:
        return
    if w.cuda and w.bases:
        torch.cuda.synchronize(w.device)
        if dist.is_initialized():
            dist.barrier()
        lib = _lib()
        for r, ptr in w.bases.items():
            if r != w.grid.rank:
                lib.hk_sym_close(ctypes.c_void_p(ptr))
        lib.hk_sym_free(ctypes.c_void_p(w.bases[w.grid.rank]))
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None


def temp_init_file() -> str:
    """A fresh path for a ``FileStore`` rendezvous (the file must not exist)."""
    d = tempfile.mkdtemp(prefix="repro_torch_world_")
    return os.path.join(d, "store")


def run_ranks(fn, world: int, args=(), timeout: float = 0.0) -> Dict[int, object]:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (``spawn``) and
    return {rank: result}.  A rank that raises, a process that dies, or a
    run that outlives ``timeout`` seconds (0: none) raises here; every
    process is stopped either way.  ``fn`` and ``args`` are pickled by
    reference, so ``fn`` is a module-level function."""
    import queue as queue_mod
    import time
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    # not daemonic: a rank may start processes of its own (rank 0's
    # checkpoint writer fleet); the finally below stops every rank
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, args, q), daemon=False)
             for r in range(world)]
    for p in procs:
        p.start()
    out, t0 = {}, time.monotonic()
    try:
        while len(out) < world:
            if timeout and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"no result from every rank after {timeout} s")
            try:
                rank, ok, payload = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank process exited with code {dead[0]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=60 if len(out) == world else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return out


def _rank_entry(fn, rank, args, q) -> None:
    import traceback
    try:
        q.put((rank, True, fn(rank, *args)))
    except Exception:
        q.put((rank, False, traceback.format_exc()))


# ---------------------------------------------------------------------------
# the CUDA transport: symmetric buffers
# ---------------------------------------------------------------------------

def _lib():
    return build.library("ring_matmul")


def _open_symmetric(w: World) -> None:
    lib = _lib()
    build.check(lib, lib.hk_set_device(w.device.index or 0), "hk_set_device")
    ptr = ctypes.c_void_p()
    handle = (ctypes.c_uint8 * 64)()
    build.check(lib, lib.hk_sym_alloc(ctypes.c_longlong(SYM_BYTES), ctypes.byref(ptr),
                                      handle), "hk_sym_alloc")
    mine = torch.tensor(list(bytes(handle)), dtype=torch.uint8)
    allh = [torch.empty(64, dtype=torch.uint8) for _ in range(w.grid.world)]
    dist.all_gather(allh, mine)
    w.bases[w.grid.rank] = ptr.value
    for r, h in enumerate(allh):
        if r == w.grid.rank:
            continue
        peer = ctypes.c_void_p()
        raw = (ctypes.c_uint8 * 64)(*h.tolist())
        build.check(lib, lib.hk_sym_open(raw, ctypes.byref(peer)), "hk_sym_open")
        w.bases[r] = peer.value
    for r, base in w.bases.items():
        w.views[r] = torch.as_tensor(_CudaArray(base, SYM_BYTES), device=w.device)
    dist.barrier()


def sym_view(rank: int, offset: int, nbytes: int, dtype: torch.dtype) -> torch.Tensor:
    """Bytes [offset, offset + nbytes) of ``rank``'s symmetric buffer as a
    1-D tensor of ``dtype`` (an alias: writes land in that rank's buffer)."""
    return world().views[rank][offset:offset + nbytes].view(dtype)


def ring(ax: str, n: int, nbytes: int) -> Tuple[int, ...]:
    """One fused-kernel launch's view of the ring on axis ``ax`` for this
    rank, reserving its ``n - 1`` hops: the addresses of this rank's
    ``landed`` counter, the right neighbour's, this rank's ``credit``, the
    left neighbour's, this rank's two receive slots and the right
    neighbour's two, then the first hop's index, ``n`` and this rank's
    index on the axis (the argument order of ``csrc/ring_matmul.cu``).
    ``nbytes`` is the largest shard the launch moves."""
    w = world()
    ranks = w.grid.axis_ranks(ax)
    if len(ranks) != n:
        raise ValueError(f"ring of {n} on axis {ax!r}, whose size is {len(ranks)}")
    if nbytes > SLOT_BYTES:
        raise ValueError(f"a {nbytes}-byte shard exceeds the {SLOT_BYTES}-byte slot "
                         "(comm.SLOT_BYTES)")
    hop0 = w.hops[ax]
    w.hops[ax] = hop0 + n - 1
    return ring_desc([w.bases[r] for r in ranks], w.grid.axis_index(ax), n,
                     RING_AXES.index(ax), hop0)


def ring_desc(bases: Sequence[int], me: int, n: int, c: int, hop0: int) -> Tuple[int, ...]:
    """The ring descriptor of :func:`ring` from addresses alone: ``bases``
    holds the ``n`` ranks' symmetric-buffer addresses in ring order, ``me``
    this rank's place in it, ``c`` the axis's index in ``RING_AXES`` (its
    counters at ``64 c``, its slots at ``_slots_offset(c)``) and ``hop0``
    the launch's first hop."""
    base, right, left = bases[me], bases[(me + 1) % n], bases[(me - 1) % n]
    f, sl = 64 * c, _slots_offset(c)
    return (base + f, right + f, base + f + 8, left + f + 8, base + sl, base + sl + SLOT_BYTES,
            right + sl, right + sl + SLOT_BYTES, hop0, n, me)


def pingpong(ax: str, rounds: int, timeout_s: float) -> float:
    """Flag exchange between the two ranks of axis ``ax`` through their
    symmetric buffers, ``rounds`` round trips inside one launch each;
    returns the seconds the device took (its global timer).  Probes
    whether kernels of two processes that spin on each other's flags make
    progress on this card (time-sliced processes take turns)."""
    w = world()
    ranks = w.grid.axis_ranks(ax)
    if len(ranks) != 2:
        raise ValueError("the probe runs on an axis of two ranks")
    me = w.grid.axis_index(ax)
    base = w.probes * 2 * rounds
    w.probes += 1
    out = torch.zeros(1, dtype=torch.int64, device=w.device)
    lib = _lib()
    barrier(ax)
    build.check(lib, lib.hk_pingpong(w.bases[w.grid.rank] + PROBE_OFFSET,
                                     w.bases[ranks[1 - me]] + PROBE_OFFSET, rounds, me, base,
                                     int(timeout_s * 1e9), out.data_ptr(),
                                     torch.cuda.current_stream(w.device).cuda_stream),
                "hk_pingpong")
    torch.cuda.synchronize(w.device)
    barrier(ax)
    return float(out.item()) / 1e9


# ---------------------------------------------------------------------------
# raw collectives (no autograd)
# ---------------------------------------------------------------------------

def _n(ax) -> int:
    return world().grid.size(ax)


def barrier(ax: Optional[str] = None) -> None:
    w = world()
    if ax is None:
        if w.grid.world > 1:
            dist.barrier()
    elif w.grid.size(ax) > 1:
        dist.barrier(group=w.groups[ax])


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (gloo carries it on both
    transports; a picklable value)."""
    if world().grid.world == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def _sync():
    w = world()
    if w.cuda:
        torch.cuda.current_stream(w.device).synchronize()


def _bulk_rounds(src: Optional[torch.Tensor], ax: str, read, *, numel: int = 0,
                 dtype=None) -> None:
    """CUDA bulk exchange: ``src`` (1-D, contiguous) is published through
    this rank's bulk region in rounds of at most ``BULK_BYTES``; after each
    round's barrier ``read(off, cnt, views)`` gets every group member's
    part as ``views[k]`` (k the axis index).  A rank with nothing to send
    passes ``src=None`` with the ``numel`` and ``dtype`` the others send."""
    w = world()
    ranks = w.grid.axis_ranks(ax)
    if src is not None:
        numel, dtype = src.numel(), src.dtype
    elt = torch.empty((), dtype=dtype).element_size()
    cap = BULK_BYTES // elt
    off = 0
    while True:
        cnt = min(cap, numel - off)
        if src is not None and cnt > 0:
            sym_view(w.grid.rank, BULK_OFFSET, cnt * elt, dtype).copy_(src[off:off + cnt])
        _sync()
        barrier(ax)
        views = [sym_view(r, BULK_OFFSET, cnt * elt, dtype) for r in ranks]
        read(off, cnt, views)
        _sync()
        barrier(ax)
        off += cnt
        if off >= numel:
            break


def raw_all_gather(x: torch.Tensor, ax: str, dim: int) -> torch.Tensor:
    """``lax.all_gather(x, ax, axis=dim, tiled=True)``."""
    n = _n(ax)
    if n == 1:
        return x
    w = world()
    dim = dim % x.dim()
    if not w.cuda:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=w.groups[ax])
        return torch.cat(parts, dim=dim)
    src = x.contiguous().reshape(-1)
    flat = [torch.empty_like(src) for _ in range(n)]

    def read(off, cnt, views):
        for k in range(n):
            flat[k][off:off + cnt].copy_(views[k])
    _bulk_rounds(src, ax, read)
    return torch.cat([f.view(x.shape) for f in flat], dim=dim)


def _sum_parts(views: Sequence[torch.Tensor], dtype) -> torch.Tensor:
    acc = views[0].float()
    for v in views[1:]:
        acc = acc + v.float()
    return acc.to(dtype)


def raw_psum(x: torch.Tensor, ax: str) -> torch.Tensor:
    """``lax.psum(x, ax)`` over one axis."""
    n = _n(ax)
    if n == 1:
        return x
    w = world()
    if not w.cuda:
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, group=w.groups[ax])
        return y
    src = x.contiguous().reshape(-1)
    out = torch.empty_like(src)

    def read(off, cnt, views):
        out[off:off + cnt] = _sum_parts(views, x.dtype)
    _bulk_rounds(src, ax, read)
    return out.view(x.shape)


def raw_psum_scatter(y: torch.Tensor, ax: str, dim: int) -> torch.Tensor:
    """``lax.psum_scatter(y, ax, scatter_dimension=dim, tiled=True)``."""
    n = _n(ax)
    if n == 1:
        return y
    dim = dim % y.dim()
    if y.shape[dim] % n:
        raise ValueError(f"psum_scatter: extent {y.shape[dim]} does not chunk by {n}")
    w = world()
    me = w.grid.axis_index(ax)
    if not w.cuda:
        return raw_psum(y, ax).chunk(n, dim=dim)[me].contiguous()
    # rows = destination chunks; this rank sums row ``me`` of every member
    rows = y.movedim(dim, 0).reshape(n, -1)
    L = rows.shape[1]
    out = torch.empty(L, dtype=y.dtype, device=y.device)
    elt = y.element_size()
    step = max(1, BULK_BYTES // (n * elt))
    for off in range(0, L, step):
        cnt = min(step, L - off)
        part = rows[:, off:off + cnt].contiguous().reshape(-1)

        def read(_o, _c, views, off=off, cnt=cnt):
            out[off:off + cnt] = _sum_parts([v.view(n, cnt)[me] for v in views], y.dtype)
        _bulk_rounds(part, ax, read)
    shape = list(y.movedim(dim, 0).shape)
    shape[0] //= n
    return out.view(shape).movedim(0, dim).contiguous()


def raw_ppermute(x: torch.Tensor, ax: str, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` along ``ax``: rank k's ``x`` lands on rank
    ``(k + shift) % n``; returns what this rank receives."""
    n = _n(ax)
    if n == 1:
        return x
    w = world()
    src_idx = (w.grid.axis_index(ax) - shift) % n
    if not w.cuda:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=w.groups[ax])
        return parts[src_idx]
    src = x.contiguous().reshape(-1)
    out = torch.empty_like(src)

    def read(off, cnt, views):
        out[off:off + cnt].copy_(views[src_idx])
    _bulk_rounds(src, ax, read)
    return out.view(x.shape)


def pod_exchange(out: Optional[torch.Tensor], dst: Optional[int], srcs: Sequence[int],
                 shape, dtype) -> Dict[int, torch.Tensor]:
    """Point-to-point copies along ``pod``: every rank of this rank's
    ``pod`` group calls it together.  This rank sends ``out`` (or
    nothing) to the pod ``dst`` and receives one tensor from each pod in
    ``srcs``; every message of the call has ``shape`` and ``dtype``.
    Returns {source pod: received tensor}."""
    w = world()
    w.exchanges += 1
    if w.cuda:
        numel = math.prod(shape)
        got = {k: torch.empty(numel, dtype=dtype, device=w.device) for k in srcs}

        def read(off, cnt, views):
            for k in srcs:
                got[k][off:off + cnt].copy_(views[k])
        _bulk_rounds(out.contiguous().reshape(-1) if out is not None else None, POD, read,
                     numel=numel, dtype=dtype)
        return {k: t.view(shape) for k, t in got.items()}
    rank_of = lambda k: w.grid.rank_at(**{POD: k})
    got = {k: torch.empty(shape, dtype=dtype) for k in srcs}
    reqs = [dist.irecv(got[k], rank_of(k), tag=w.exchanges) for k in srcs]
    if out is not None:
        reqs.append(dist.isend(out.contiguous(), rank_of(dst), tag=w.exchanges))
    for r in reqs:
        r.wait()
    return got


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return raw_all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return raw_psum_scatter(g.contiguous(), ctx.ax, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return raw_psum_scatter(y, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return raw_all_gather(g.contiguous(), ctx.ax, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return raw_psum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return raw_psum(g.contiguous(), ctx.ax), None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, shift):
        ctx.ax, ctx.shift = ax, shift
        return raw_ppermute(x, ax, shift)

    @staticmethod
    def backward(ctx, g):
        return raw_ppermute(g.contiguous(), ctx.ax, -ctx.shift), None, None


def all_gather(x: torch.Tensor, ax: str, dim: int) -> torch.Tensor:
    if _n(ax) == 1:
        return x
    return _AllGather.apply(x, ax, dim)


def psum_scatter(y: torch.Tensor, ax: str, dim: int) -> torch.Tensor:
    if _n(ax) == 1:
        return y
    return _PsumScatter.apply(y, ax, dim)


def psum(x: torch.Tensor, axes: Union[str, Tuple[str, ...]]) -> torch.Tensor:
    """Sum over one axis or over a tuple of axes (one axis after another)."""
    for ax in ((axes,) if isinstance(axes, str) else tuple(axes)):
        if _n(ax) > 1:
            x = _Psum.apply(x, ax)
    return x


def ppermute(x: torch.Tensor, ax: str, shift: int = 1) -> torch.Tensor:
    if _n(ax) == 1:
        return x
    return _Ppermute.apply(x, ax, shift)


def raw_q_hop(x: torch.Tensor, ax: str, shift: int = 1) -> torch.Tensor:
    """One quantized hop without autograd: x quantized per row, the pair
    sent as one byte buffer (the scales first, then the payload) to the
    rank ``shift`` places along ``ax``; returns what arrives, dequantized
    into x's dtype."""
    q, s = Q.quant_int8(x)
    ns = 4 * s.numel()
    buf = torch.cat([s.reshape(-1).view(torch.uint8), q.reshape(-1).view(torch.uint8)])
    got = raw_ppermute(buf, ax, shift)
    return Q.dequant_int8(got[ns:].view(torch.int8).view(q.shape),
                          got[:ns].view(torch.float32).view(s.shape), x.dtype)


class _QHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, shift):
        ctx.ax, ctx.shift = ax, shift
        return raw_q_hop(x, ax, shift)

    @staticmethod
    def backward(ctx, g):
        # the transpose of a hop is the reverse hop; the cotangent crosses
        # the wire quantized, as the forward's shard did
        return raw_q_hop(g.contiguous(), ctx.ax, -ctx.shift), None, None


def q_hop(x: torch.Tensor, ax: str, shift: int = 1) -> torch.Tensor:
    if _n(ax) == 1:
        return x
    return _QHop.apply(x, ax, shift)


def ring_hop(x: torch.Tensor, ax: str, shift: int = 1, comm_dtype: str = "bf16"):
    """One ring hop of the wire dtype: x lands on rank ``(k + shift) % n``."""
    if Q.hop_int8(comm_dtype, x.shape, x.dtype):
        return q_hop(x, ax, shift)
    return ppermute(x, ax, shift)


def raw_ring_hop(x: torch.Tensor, ax: str, shift: int = 1, comm_dtype: str = "bf16"):
    """:func:`ring_hop` without autograd (the backward's helper rings)."""
    if _n(ax) == 1:
        return x
    if Q.hop_int8(comm_dtype, x.shape, x.dtype):
        return raw_q_hop(x, ax, shift)
    return raw_ppermute(x, ax, shift)


def ring_all_gather(x: torch.Tensor, ax: str, *, dim: int, n: int, comm_dtype: str = "bf16",
                    bidir: bool = False) -> torch.Tensor:
    """== all_gather(x, ax, dim) in rank order, as n - 1 hops to the right
    neighbour (the backward is the reverse ring).  ``bidir``: the two
    halves of the shard circulate in opposite directions, or the whole
    shard one way when its extent is odd."""
    if n <= 1:
        return x
    idx = axis_index(ax)
    chunk = x.shape[dim]
    if bidir and chunk % 2 == 0:
        half = chunk // 2
        fwd, bwd = [None] * n, [None] * n
        curf, curb = x.narrow(dim, 0, half), x.narrow(dim, half, half)
        for s in range(n):
            fwd[(idx - s) % n] = curf
            bwd[(idx + s) % n] = curb
            if s < n - 1:
                curf = ring_hop(curf, ax, 1, comm_dtype)
                curb = ring_hop(curb, ax, -1, comm_dtype)
        return torch.cat([p for k in range(n) for p in (fwd[k], bwd[k])], dim=dim)
    parts = [None] * n
    cur = x
    for s in range(n):
        parts[(idx - s) % n] = cur
        if s < n - 1:
            cur = ring_hop(cur, ax, 1, comm_dtype)
    return torch.cat(parts, dim=dim)


def axis_index(ax) -> int:
    return world().grid.axis_index(ax)


def axis_size(ax) -> int:
    return world().grid.size(ax)
