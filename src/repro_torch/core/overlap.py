"""Ring-decomposed collective matmuls and the overlap lattice.

Counterpart of ``repro/core/overlap.py`` for every ``overlap`` mode
(``none``, ``ring``, ``bidir``, ``fused``) and both wire dtypes.
Everything runs on per-rank blocks inside a grid world:

* the pure rings ``ring_all_gather`` and ``ring_reduce_scatter`` and the
  collective matmuls ``ring_ag_matmul``, ``ring_ag_matmul_contract`` and
  ``ring_matmul_rs``: every hop is a ``comm.ring_hop`` (differentiable:
  its backward is the reverse hop, so the backward of a ring is the
  transposed ring), every per-step product the tile matmul.  ``bidir``
  splits each shard in half and circulates the halves with shifts +1
  and -1; a collective whose chunk (the contracted ring: ``h_loc``) is
  odd runs as ``ring``.  ``comm_dtype="int8"`` sends the shards that
  ``core/quant.quant_ok`` admits as (int8, fp32 row scale) pairs, their
  cotangents too;
* the dispatchers ``ag_matmul``, ``matmul_rs``, ``ag_matmul_contract``
  and ``matmul_rs_pair``, the only places the route is decided:
  ``overlap="fused"`` and a tile-aligned shape (the ``fused_ok_*`` gates
  of ``kernels/ring_matmul.py``, given x's own itemsize whatever the
  wire) take the single-launch ring kernel, anything else the ppermute
  ring; ``fuse_side`` and ``ring_linear`` compose the two sides of a
  linear.  The fused -> bidir/ring -> bulk lattice is the JAX package's
  routing rule, kept exactly.

Every decision is appended to :data:`ROUTES` (op, collective, route,
axis, ring size, shapes, itemsize and wire dtype; a ``bidir`` collective
that ran as a ring logs ``ring``), which ``chip_smoke.py`` prints and the
tests hold against the JAX gates.  ``plain=True`` (the reference path)
sends the per-step products and the fused ops to their plain versions;
the routes are decided the same way.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.config import OVERLAP_MODES as MODES
from repro_torch.core import quant as Q
from repro_torch.kernels import ops
from repro_torch.kernels import ring_matmul as RM
from repro_torch.parallel import comm

ROUTES: List[dict] = []


def check_mode(overlap: str) -> str:
    """Validate an overlap mode string (a typo must not silently mean ring)."""
    if overlap not in MODES:
        raise ValueError(f"overlap={overlap!r} not in {MODES}")
    return overlap


def rs_ok(extent: int, n: int) -> bool:
    """Can a ring reduce-scatter over an ``n``-ring chunk ``extent``?"""
    return n > 1 and extent % n == 0


def log_route(op: str, collective: str, route: str, ax: str, n: int, x, w=None,
              comm_dtype: str = "bf16", chunk=None) -> None:
    ROUTES.append(dict(op=op, collective=collective, route=route, axis=ax, n=n,
                       x=tuple(x.shape), w=None if w is None else tuple(w.shape),
                       itemsize=x.element_size(), float=x.is_floating_point(),
                       comm_dtype=comm_dtype, chunk=chunk))


def log_ring(op: str, collective: str, overlap: str, chunk: int, ax: str, n: int, x, w=None,
             comm_dtype: str = "bf16") -> None:
    """Log a ring collective whose halvable extent (the shard's, or the
    scattered chunk's) is ``chunk``: ``bidir`` when it halves, else ``ring``."""
    route = "bidir" if overlap == "bidir" and chunk % 2 == 0 else "ring"
    log_route(op, collective, route, ax, n, x, w, comm_dtype, chunk)


def clear_routes() -> None:
    ROUTES.clear()


def route_table():
    """Distinct decisions with their counts, in first-seen order."""
    seen = {}
    for r in ROUTES:
        key = tuple(sorted((k, v) for k, v in r.items()))
        seen[key] = seen.get(key, 0) + 1
    return [dict(dict(k), count=c) for k, c in seen.items()]


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def nop_bytes(r) -> float:
    """Bytes one rank receives for one logged collective (a ``ROUTES``
    record): an all-gather (x its shard) n - 1 shards, a reduce-scatter
    (x the whole partial sum; a matmul-RS's is x's rows by w's columns,
    twice for the pair) (n - 1) / n of it, an all-reduce twice that, a
    ``ppermute`` ring n - 1 hops of x (the loss's: w).  A ring on the int8
    wire moves one byte an element and an fp32 scale a row where the
    whole tensor's last dim admits it (``quant.quant_ok``; a hop of a
    column chunk may not, so this is an estimate there); the bulk path
    and integer shards their own width."""
    n, coll = r["n"], r["collective"]
    shape = tuple(r["x"])
    if r["op"] in ("matmul_rs", "matmul_rs_pair"):
        shape = shape[:-1] + (r["w"][-1] * (2 if r["op"] == "matmul_rs_pair" else 1),)
    elif r["op"] == "fused_lm_loss_seq":
        shape = tuple(r["w"]) if r["w"] else shape
    elts = _numel(shape)
    rows = elts // max(shape[-1], 1)
    wire = (elts + 4 * rows if r["route"] != "bulk" and r["comm_dtype"] == "int8"
            and r["float"] and shape[-1] >= Q.MIN_QUANT_DIM else elts * r["itemsize"])
    if coll in ("all_gather", "ppermute"):
        return float((n - 1) * wire)
    if coll == "reduce_scatter":
        return (n - 1) / n * wire
    if coll == "all_reduce":
        return 2 * (n - 1) / n * wire
    raise KeyError(coll)


def route_bytes(table) -> dict:
    """Bytes a rank receives over the collectives of a ``route_table()``
    (each record times its count), by route and in all."""
    out = {}
    for r in table:
        b = nop_bytes(r) * r["count"]
        out[r["route"]] = out.get(r["route"], 0.0) + b
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# pure rings
# ---------------------------------------------------------------------------

ring_all_gather = comm.ring_all_gather      # == all_gather(x, ax, dim), rank order


def ring_reduce_scatter(y, ax: str, *, dim: int, n: int, bidir: bool = False,
                        comm_dtype: str = "bf16"):
    """== psum_scatter(y, ax, dim): a per-destination accumulator circulates;
    the one held at rank i after s hops is destined for (i + n-1 - s) % n."""
    if n <= 1:
        return y
    if y.shape[dim] % n:
        raise ValueError(f"ring RS: extent {y.shape[dim]} does not chunk by ring size {n}")
    idx = comm.axis_index(ax)
    chunk = y.shape[dim] // n
    if bidir and chunk % 2 == 0:
        half = chunk // 2
        accf = y.narrow(dim, ((idx - 1) % n) * chunk, half)
        accb = y.narrow(dim, ((idx + 1) % n) * chunk + half, half)
        for s in range(1, n):
            accf = comm.ring_hop(accf, ax, 1, comm_dtype)
            accb = comm.ring_hop(accb, ax, -1, comm_dtype)
            accf = accf + y.narrow(dim, ((idx + n - 1 - s) % n) * chunk, half)
            accb = accb + y.narrow(dim, ((idx - (n - 1) + s) % n) * chunk + half, half)
        return torch.cat([accf, accb], dim=dim)
    acc = y.narrow(dim, ((idx - 1) % n) * chunk, chunk)
    for s in range(1, n):
        acc = comm.ring_hop(acc, ax, 1, comm_dtype)
        acc = acc + y.narrow(dim, ((idx + n - 1 - s) % n) * chunk, chunk)
    return acc


# ---------------------------------------------------------------------------
# ring collective matmuls
# ---------------------------------------------------------------------------

def ring_ag_matmul(x, w, ax: str, *, dim: int, n: int, bidir: bool = False,
                   comm_dtype: str = "bf16", plain: bool = False):
    """== tile_mm(ring_all_gather(x, dim), w), one product per arriving shard."""
    if n <= 1:
        return ops.tile_mm(x, w, plain=plain)
    idx = comm.axis_index(ax)
    chunk = x.shape[dim]
    if bidir and chunk % 2 == 0:
        half = chunk // 2
        fwd, bwd = [None] * n, [None] * n
        curf, curb = x.narrow(dim, 0, half), x.narrow(dim, half, half)
        for s in range(n):
            fwd[(idx - s) % n] = ops.tile_mm(curf, w, plain=plain)
            bwd[(idx + s) % n] = ops.tile_mm(curb, w, plain=plain)
            if s < n - 1:
                curf = comm.ring_hop(curf, ax, 1, comm_dtype)
                curb = comm.ring_hop(curb, ax, -1, comm_dtype)
        return torch.cat([p for k in range(n) for p in (fwd[k], bwd[k])], dim=dim)
    parts = [None] * n
    cur = x
    for s in range(n):
        parts[(idx - s) % n] = ops.tile_mm(cur, w, plain=plain)
        if s < n - 1:
            cur = comm.ring_hop(cur, ax, 1, comm_dtype)
    return torch.cat(parts, dim=dim)


def ring_ag_matmul_contract(x, w, ax: str, *, n: int, bidir: bool = False, out_dtype=None,
                            comm_dtype: str = "bf16", plain: bool = False):
    """== mm(all_gather(x, last dim), w): per-step fp32 partial products."""
    dt = out_dtype or x.dtype
    if n <= 1:
        return ops.tile_mm(x, w, out_dtype=torch.float32, plain=plain).to(dt)
    idx = comm.axis_index(ax)
    h_loc = x.shape[-1]

    def part(cur, row0):
        return ops.tile_mm(cur, w.narrow(0, row0, cur.shape[-1]), out_dtype=torch.float32,
                           plain=plain)
    acc = None
    if bidir and h_loc % 2 == 0:
        half = h_loc // 2
        curf, curb = x.narrow(-1, 0, half), x.narrow(-1, half, half)
        for s in range(n):
            for p in (part(curf, ((idx - s) % n) * h_loc),
                      part(curb, ((idx + s) % n) * h_loc + half)):
                acc = p if acc is None else acc + p
            if s < n - 1:
                curf = comm.ring_hop(curf, ax, 1, comm_dtype)
                curb = comm.ring_hop(curb, ax, -1, comm_dtype)
        return acc.to(dt)
    cur = x
    for s in range(n):
        p = part(cur, ((idx - s) % n) * h_loc)
        acc = p if acc is None else acc + p
        if s < n - 1:
            cur = comm.ring_hop(cur, ax, 1, comm_dtype)
    return acc.to(dt)


def ring_matmul_rs(x, w, ax: str, *, scatter_dim: int, n: int, bidir: bool = False,
                   comm_dtype: str = "bf16", plain: bool = False):
    """== psum_scatter(tile_mm(x, w), scatter_dim): the per-destination tile is
    produced by a chunked product right before it is folded in."""
    if n <= 1:
        return ops.tile_mm(x, w, plain=plain)
    idx = comm.axis_index(ax)
    last = scatter_dim % x.dim() == x.dim() - 1
    scattered = w.shape[-1] if last else x.shape[scatter_dim]
    if scattered % n:
        raise ValueError(f"ring matmul-RS: extent {scattered} does not chunk by ring size {n}")
    chunk = scattered // n
    if last:
        def contrib(d, off=0, size=chunk):
            return ops.tile_mm(x, w.narrow(1, d * chunk + off, size), plain=plain)
    else:
        def contrib(d, off=0, size=chunk):
            return ops.tile_mm(x.narrow(scatter_dim, d * chunk + off, size), w, plain=plain)
    if bidir and chunk % 2 == 0:
        half = chunk // 2
        accf = contrib((idx - 1) % n, 0, half)
        accb = contrib((idx + 1) % n, half, half)
        for s in range(1, n):
            accf = comm.ring_hop(accf, ax, 1, comm_dtype)
            accb = comm.ring_hop(accb, ax, -1, comm_dtype)
            accf = accf + contrib((idx + n - 1 - s) % n, 0, half)
            accb = accb + contrib((idx - (n - 1) + s) % n, half, half)
        return torch.cat([accf, accb], dim=scatter_dim)
    acc = contrib((idx - 1) % n)
    for s in range(1, n):
        acc = comm.ring_hop(acc, ax, 1, comm_dtype)
        acc = acc + contrib((idx + n - 1 - s) % n)
    return acc


# ---------------------------------------------------------------------------
# dispatchers: fused when overlap="fused" and tile-aligned, else the ring
# ---------------------------------------------------------------------------

def ag_matmul(x, w, ax: str, *, dim: int, n: int, overlap: str, comm_dtype: str = "bf16",
              plain: bool = False):
    """AG + matmul (gathered dim is a batch dim) under the given mode."""
    if overlap == "fused" and RM.fused_ok_ag(x.shape, w.shape, n, dim, x.element_size()):
        log_route("ag_matmul", "all_gather", "fused", ax, n, x, w, comm_dtype)
        return RM.ag_matmul(x, w, ax, dim=dim, n=n, comm_dtype=comm_dtype, plain=plain)
    log_ring("ag_matmul", "all_gather", overlap, x.shape[dim], ax, n, x, w, comm_dtype)
    return ring_ag_matmul(x, w, ax, dim=dim, n=n, bidir=overlap == "bidir",
                          comm_dtype=comm_dtype, plain=plain)


def _scattered_chunk(x, w, scatter_dim: int, n: int) -> int:
    last = scatter_dim % x.dim() == x.dim() - 1
    return (w.shape[-1] if last else x.shape[scatter_dim]) // max(n, 1)


def matmul_rs(x, w, ax: str, *, scatter_dim: int, n: int, overlap: str,
              comm_dtype: str = "bf16", plain: bool = False):
    """matmul + RS under the given mode."""
    if overlap == "fused" and RM.fused_ok_rs(x.shape, w.shape, n, scatter_dim,
                                             x.element_size()):
        log_route("matmul_rs", "reduce_scatter", "fused", ax, n, x, w, comm_dtype)
        return RM.matmul_rs(x, w, ax, scatter_dim=scatter_dim, n=n, comm_dtype=comm_dtype,
                            plain=plain)
    log_ring("matmul_rs", "reduce_scatter", overlap, _scattered_chunk(x, w, scatter_dim, n), ax,
             n, x, w, comm_dtype)
    return ring_matmul_rs(x, w, ax, scatter_dim=scatter_dim, n=n, bidir=overlap == "bidir",
                          comm_dtype=comm_dtype, plain=plain)


def ag_matmul_contract(x, w, ax: str, *, n: int, overlap: str, out_dtype=None,
                       comm_dtype: str = "bf16", plain: bool = False):
    """AG + matmul over the contracted dim under the given mode."""
    if overlap == "fused" and RM.fused_ok_contract(x.shape, w.shape, n, x.element_size()):
        log_route("ag_matmul_contract", "all_gather", "fused", ax, n, x, w, comm_dtype)
        return RM.ag_matmul_contract(x, w, ax, n=n, out_dtype=out_dtype,
                                     comm_dtype=comm_dtype, plain=plain)
    log_ring("ag_matmul_contract", "all_gather", overlap, x.shape[-1], ax, n, x, w, comm_dtype)
    return ring_ag_matmul_contract(x, w, ax, n=n, bidir=overlap == "bidir",
                                   out_dtype=out_dtype, comm_dtype=comm_dtype, plain=plain)


def matmul_rs_pair(x, w1, w1b, ax: str, *, scatter_dim: int, n: int, overlap: str,
                   comm_dtype: str = "bf16", plain: bool = False):
    """Gated pair: (x w1, x w1b) reduce-scattered, sharing the gathered x."""
    isz = x.element_size()
    if (overlap == "fused" and scatter_dim % x.dim() != x.dim() - 1
            and RM.fused_ok_rs(x.shape, w1.shape, n, scatter_dim, isz)
            and RM.fused_ok_rs(x.shape, w1b.shape, n, scatter_dim, isz)):
        log_route("matmul_rs_pair", "reduce_scatter", "fused", ax, n, x, w1, comm_dtype)
        return RM.matmul_rs_pair(x, w1, w1b, ax, scatter_dim=scatter_dim, n=n,
                                 comm_dtype=comm_dtype, plain=plain)
    log_ring("matmul_rs_pair", "reduce_scatter", overlap, _scattered_chunk(x, w1, scatter_dim, n),
             ax, n, x, w1, comm_dtype)
    kw = dict(scatter_dim=scatter_dim, n=n, bidir=overlap == "bidir", comm_dtype=comm_dtype,
              plain=plain)
    return ring_matmul_rs(x, w1, ax, **kw), ring_matmul_rs(x, w1b, ax, **kw)


def fuse_side(h_loc: int, o_loc: int) -> str:
    """Which collective the single matmul fuses into: the heavier side
    (ties go to the AG)."""
    return "rs" if o_loc > h_loc else "ag"


def ring_linear(x, w, *, g_ax: str, n_g: int, s_ax: str, n_s: int, gather_dim: int = 1,
                scatter_dim: int = 1, overlap: str, comm_dtype: str = "bf16",
                plain: bool = False):
    """Overlapped y = RS_{s_ax}(AG_{g_ax}(x, gather_dim) @ w, scatter_dim)."""
    check_mode(overlap)
    bidir = overlap == "bidir"
    scattered = (x.shape[gather_dim] * n_g if scatter_dim == gather_dim else w.shape[-1])
    if fuse_side(x.shape[-1], w.shape[-1]) == "rs" and rs_ok(scattered, n_s):
        log_ring("ring_linear", "all_gather", overlap, x.shape[gather_dim], g_ax, n_g, x,
                 comm_dtype=comm_dtype)
        xg = ring_all_gather(x, g_ax, dim=gather_dim, n=n_g, bidir=bidir, comm_dtype=comm_dtype)
        return matmul_rs(xg, w, s_ax, scatter_dim=scatter_dim, n=n_s, overlap=overlap,
                         comm_dtype=comm_dtype, plain=plain)
    yp = ag_matmul(x, w, g_ax, dim=gather_dim, n=n_g, overlap=overlap, comm_dtype=comm_dtype,
                   plain=plain)
    if not rs_ok(scattered, n_s):
        log_route("ring_linear", "reduce_scatter", "bulk", s_ax, n_s, yp, comm_dtype=comm_dtype)
        return comm.psum_scatter(yp, s_ax, scatter_dim)
    log_ring("ring_linear", "reduce_scatter", overlap, scattered // n_s, s_ax, n_s, yp,
             comm_dtype=comm_dtype)
    return ring_reduce_scatter(yp, s_ax, dim=scatter_dim, n=n_s, bidir=bidir,
                               comm_dtype=comm_dtype)
