"""A loopback ring: all n ranks of one ring collective in one process on one
card, each rank's kernel on a CUDA stream of its own.

On one card the process ring (``parallel/comm.py``) runs n rank processes,
which the card time-slices: a rank's kernel spins on its neighbour's flags
until that process gets its next slice, so a launch's time there is the
scheduler's (a few ms), not the kernel's.  The ring descriptor is only a
tuple of addresses (``comm.ring_desc``), so the same kernels run here over
n ordinary allocations laid out as ``comm``'s symmetric buffer (the
counters of axis c at ``64 c``, its two slots at ``comm._slots_offset(c)``,
zeroed), with rank r's right ``landed`` rank r + 1's own.  The n grids are
resident at once (each launch is capped at its share of the card, from
the kernel's occupancy: :func:`block_cap`) and run at the card's pace, so
the time from the first rank's start to the last rank's end is the ring
kernel's own.

A call (:meth:`LoopbackRing.run`) records an event on the caller's stream,
makes each rank's stream wait on it, launches each rank's kernel on its
stream with its own block counters, and makes the caller's stream wait on
every rank's.  ``reset=True`` zeroes the flags on the caller's stream
first and starts from hop 0, so the call repeats exactly and a CUDA graph
can capture and replay it; otherwise hop0 advances by n - 1 a call, as the
process ring's does, and the counters keep growing across calls.

:func:`reference` is the ring's global result computed in fp32 from the n
ranks' inputs (gather, matmul, and for matmul-RS the sum and the scatter),
and on the int8 wire the ring's emulated semantics (``kernels/ref.py``'s
int8 plain versions, written for n ranks at once).  Imports torch and the
port only.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import ring_matmul as RM
from repro_torch.launch.mesh import RING_AXES
from repro_torch.parallel import comm


def block_cap(per_sm: int, sms: int, n: int) -> int:
    """Blocks a rank's grid may use so that the n grids of one ring are
    resident together: floor(per_sm x sms / n) (every block of every rank
    spins on its neighbours, so none may wait for another to finish)."""
    cap = per_sm * sms // n
    if cap < 1:
        raise ValueError(f"{n} grids of a kernel with {per_sm} blocks an SM do not fit "
                         f"{sms} SMs at once")
    return cap


class LoopbackRing:
    """n ranks of a ring on axis ``ax``'s layout, on ``device``."""

    def __init__(self, n: int, ax: str = "my", device=None):
        if not 2 <= n <= RM.MAX_STEPS:
            raise ValueError(f"the ring kernels take rings of 2..{RM.MAX_STEPS}, got {n}")
        self.n, self.c = n, RING_AXES.index(ax)
        self.device = torch.device(device or "cuda")
        size = comm._slots_offset(self.c) + 2 * comm.SLOT_BYTES
        self.bufs = [torch.zeros(size, dtype=torch.uint8, device=self.device) for _ in range(n)]
        self.bases = [b.data_ptr() for b in self.bufs]
        self.counters = [RM.new_counters(self.device) for _ in range(n)]
        self.streams = [torch.cuda.Stream(self.device) for _ in range(n)]
        self.hop0 = 0
        self._caps: Dict[tuple, int] = {}

    def ring_of(self, rank: int) -> Callable[[int], Tuple[int, ...]]:
        """Rank ``rank``'s descriptor for this call (a launcher's ``ring_of``)."""
        def desc(nbytes: int) -> Tuple[int, ...]:
            if nbytes > comm.SLOT_BYTES:
                raise ValueError(f"a {nbytes}-byte shard exceeds the {comm.SLOT_BYTES}-byte slot")
            return comm.ring_desc(self.bases, rank, self.n, self.c, self.hop0)
        return desc

    def cap(self, kernel: str, dtype: torch.dtype, impl: Optional[str] = None,
            out_dtype: Optional[torch.dtype] = None) -> int:
        """The block cap of a launch of ``kernel`` on ``impl`` (cached)."""
        key = (kernel, dtype, impl, out_dtype)
        if key not in self._caps:
            self._caps[key] = block_cap(*RM.occupancy(kernel, dtype, impl, out_dtype), self.n)
        return self._caps[key]

    def slot(self, rank: int, parity: int, nbytes: int) -> torch.Tensor:
        """The first ``nbytes`` of rank ``rank``'s receive slot ``parity``."""
        off = comm._slots_offset(self.c) + parity * comm.SLOT_BYTES
        return self.bufs[rank][off:off + nbytes]

    def run(self, launch: Callable, reset: bool = False) -> List:
        """``launch(rank, ring_of, counters)`` for every rank, each on its own
        stream between one event of the caller's stream and the caller's
        wait on every rank; returns the ranks' results."""
        root = torch.cuda.current_stream(self.device)
        if reset:
            f = 64 * self.c
            for b in self.bufs:
                b[f:f + 16].zero_()
            self.hop0 = 0
        start = torch.cuda.Event()
        start.record(root)
        outs = []
        for r, st in enumerate(self.streams):
            st.wait_event(start)
            with torch.cuda.stream(st):
                outs.append(launch(r, self.ring_of(r), self.counters[r]))
        for st in self.streams:
            root.wait_stream(st)
        for out in outs:                 # the caller's stream reads them next
            for t in (out if isinstance(out, tuple) else (out,)):
                t.record_stream(root)
        self.hop0 += self.n - 1
        return outs


# ---------------------------------------------------------------------------
# the ring ops over a loopback ring: lists of the n ranks' inputs and outputs
# ---------------------------------------------------------------------------

def ag_matmul(lb: LoopbackRing, xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor], *,
              int8: bool = False, impl: Optional[str] = None, reset: bool = False):
    """Each rank's all_gather(x over the ring, tokens) @ its w."""
    n = lb.n
    impl = RM._route(xs[0], ws[0], n, None, impl, int8=int8)
    blocks = lb.cap("ag_matmul_int8" if int8 else "ag_matmul", xs[0].dtype, impl)
    return lb.run(lambda r, ring_of, cnt: RM._launch_ag(
        xs[r], ws[r], ring_of, n, int8, counters=cnt, blocks=blocks, impl=impl), reset)


def matmul_rs(lb: LoopbackRing, xs, ws, scatter_dim: int, *, int8: bool = False,
              split: int = 0, impl: Optional[str] = None, reset: bool = False):
    """Each rank's chunk of sum_r x_r @ w_r, scattered over ``scatter_dim``
    (``split``: the int8 gated pair's second half's first column)."""
    n = lb.n
    impl = RM._route(xs[0], ws[0], n, scatter_dim, impl, int8=int8, split=split)
    blocks = lb.cap("matmul_rs_int8" if int8 else "matmul_rs", xs[0].dtype, impl)
    return lb.run(lambda r, ring_of, cnt: RM._launch_rs(
        xs[r], ws[r], ring_of, scatter_dim, n, int8, split, counters=cnt, blocks=blocks,
        impl=impl), reset)


def ag_matmul_contract(lb: LoopbackRing, xs, ws, *, out_dtype=None, int8: bool = False,
                       impl: Optional[str] = None, reset: bool = False):
    """Each rank's all_gather(x over the ring, its last dim) @ its w."""
    n, dt = lb.n, out_dtype or xs[0].dtype
    impl = RM._route(xs[0], ws[0], n, None, impl, int8=int8, contract=True)
    blocks = lb.cap("ag_matmul_contract_int8" if int8 else "ag_matmul_contract", xs[0].dtype,
                    impl, dt)
    return lb.run(lambda r, ring_of, cnt: RM._launch_contract(
        xs[r], ws[r], ring_of, n, dt, int8, counters=cnt, blocks=blocks, impl=impl), reset)


def hopped_pairs(lb: LoopbackRing, xs) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """After a ``reset=True`` call of an int8 AG-matmul or contracted
    AG-matmul: for each rank d, the int8 pair its slot of the call's last
    hop holds (that of rank d + 1, the step n - 2 of rank d - 1), and
    ``quant_int8`` of that rank's shard in the slot's layout; the payload
    and the scales only, not the padding."""
    n = lb.n
    out = []
    for d in range(n):
        x2 = xs[(d + 1) % n].reshape(-1, xs[0].shape[-1])
        rows, cols = x2.shape
        q, s = Q.quant_int8(x2)
        want = torch.cat([q.reshape(-1).view(torch.uint8), s.reshape(-1).view(torch.uint8)])
        got = lb.slot(d, (n - 2) % 2, RM._qpair_bytes(rows, cols))
        off = RM._align16(rows * cols)
        out.append((torch.cat([got[:rows * cols], got[off:off + 4 * rows]]), want))
    return out


# ---------------------------------------------------------------------------
# the global result, in fp32 from every rank's inputs
# ---------------------------------------------------------------------------

def _gathered(xs, dim: int, int8: bool, me: int) -> torch.Tensor:
    """The shards as rank ``me`` sees them gathered along ``dim``: on the
    int8 wire every other rank's quantized once per row, its own exact."""
    parts = []
    for r, x in enumerate(xs):
        if int8 and r != me:
            q, s = Q.quant_int8(x)
            x = Q.dequant_int8(q, s, x.dtype)
        parts.append(x)
    return torch.cat(parts, dim=dim)


def _rs_int8_ring(ys: Sequence[torch.Tensor], scatter_dim: int) -> List[torch.Tensor]:
    """The int8 wire's matmul-RS from each rank's contribution y_r (in the
    input dtype): the accumulator of destination d starts at rank d + 1 with
    its chunk d, and at each later rank crosses the hop quantized, is
    dequantized into the input dtype and gains that rank's chunk d, in the
    input dtype (``ref.matmul_rs_int8_plain``)."""
    n = len(ys)
    chunk = ys[0].shape[scatter_dim] // n
    outs = []
    for d in range(n):
        part = lambda r: ys[r % n].narrow(scatter_dim, d * chunk, chunk)  # noqa: E731
        acc = part(d + 1)
        for r in range(d + 2, d + n + 1):
            q, s = Q.quant_int8(acc)
            acc = Q.dequant_int8(q, s, acc.dtype) + part(r)
        outs.append(acc.contiguous())
    return outs


def reference(kernel: str, xs, ws, scatter_dim: Optional[int] = None, *, int8: bool = False,
              split: int = 0, out_dtype=None) -> List[torch.Tensor]:
    """Every rank's output of ``kernel`` ("ag_matmul", "matmul_rs",
    "ag_matmul_contract") computed in fp32 from all n ranks' inputs and
    stored in the output dtype; on the int8 wire the ring's emulated
    semantics (``split``: the gated pair's halves, each its own ring)."""
    n, dt = len(xs), xs[0].dtype
    if kernel == "ag_matmul":
        return [(_gathered(xs, 1, int8, r).float() @ ws[r].float()).to(dt) for r in range(n)]
    if kernel == "ag_matmul_contract":
        return [(_gathered(xs, xs[0].dim() - 1, int8, r).float() @ ws[r].float())
                .to(out_dtype or dt) for r in range(n)]
    ys = [x.float() @ w.float() for x, w in zip(xs, ws)]
    if not int8:
        total = torch.stack(ys).sum(0)
        return list(t.contiguous().to(dt) for t in total.chunk(n, dim=scatter_dim))
    ys = [y.to(dt) for y in ys]
    if not split:
        return _rs_int8_ring(ys, scatter_dim)
    halves = [_rs_int8_ring([y[..., :split] for y in ys], scatter_dim),
              _rs_int8_ring([y[..., split:] for y in ys], scatter_dim)]
    return [torch.cat([a, b], dim=-1) for a, b in zip(*halves)]


def partial_magnitudes(xs, ws, scatter_dim: int) -> List[torch.Tensor]:
    """Each rank's chunk of sum_r |x_r @ w_r| (fp32): the scale of matmul-RS's
    roundings, one per contribution and per hop."""
    total = torch.stack([(x.float() @ w.float()).abs() for x, w in zip(xs, ws)]).sum(0)
    return list(total.chunk(len(xs), dim=scatter_dim))
