"""Ring-decomposed collective matmuls and the overlap lattice.

Counterpart of ``repro/core/overlap.py`` for ``overlap`` in ``none``,
``ring`` and ``fused`` (``bidir`` and the int8 wire raise; ROADMAP
queue 1).  Everything runs on per-rank blocks inside a grid world:

* the pure rings ``ring_all_gather`` and ``ring_reduce_scatter`` and the
  collective matmuls ``ring_ag_matmul``, ``ring_ag_matmul_contract`` and
  ``ring_matmul_rs``: every hop is a ``comm.ppermute`` (differentiable:
  its backward is the reverse hop, so the backward of a ring is the
  transposed ring), every per-step product the tile matmul;
* the dispatchers ``ag_matmul``, ``matmul_rs``, ``ag_matmul_contract``
  and ``matmul_rs_pair``, the only places the route is decided:
  ``overlap="fused"`` and a tile-aligned shape (the ``fused_ok_*`` gates
  of ``kernels/ring_matmul.py``) take the single-launch ring kernel,
  anything else the ppermute ring; ``fuse_side`` and ``ring_linear``
  compose the two sides of a linear.  The fused -> ring -> bulk lattice
  is the JAX package's routing rule, kept exactly.

Every decision is appended to :data:`ROUTES` (op, collective, route,
axis, ring size, shapes and itemsize), which ``chip_smoke.py`` prints
and the tests hold against the JAX gates.  ``plain=True`` (the reference
path) sends the per-step products and the fused ops to their plain
versions; the routes are decided the same way.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ring_matmul as RM
from repro_torch.parallel import comm

MODES = ("none", "ring", "bidir", "fused")
ROUTES: List[dict] = []


def check_mode(overlap: str) -> str:
    """Validate an overlap mode string (a typo must not silently mean ring)."""
    if overlap not in MODES:
        raise ValueError(f"overlap={overlap!r} not in {MODES}")
    if overlap == "bidir":
        raise NotImplementedError("overlap='bidir' is not ported yet (ROADMAP queue 1)")
    return overlap


def rs_ok(extent: int, n: int) -> bool:
    """Can a ring reduce-scatter over an ``n``-ring chunk ``extent``?"""
    return n > 1 and extent % n == 0


def log_route(op: str, collective: str, route: str, ax: str, n: int, x, w=None) -> None:
    ROUTES.append(dict(op=op, collective=collective, route=route, axis=ax, n=n,
                       x=tuple(x.shape), w=None if w is None else tuple(w.shape),
                       itemsize=x.element_size()))


def clear_routes() -> None:
    ROUTES.clear()


def route_table():
    """Distinct decisions with their counts, in first-seen order."""
    seen = {}
    for r in ROUTES:
        key = tuple(sorted((k, v) for k, v in r.items()))
        seen[key] = seen.get(key, 0) + 1
    return [dict(dict(k), count=c) for k, c in seen.items()]


def _hop(x, ax):
    return comm.ppermute(x, ax, 1)


# ---------------------------------------------------------------------------
# pure rings
# ---------------------------------------------------------------------------

ring_all_gather = comm.ring_all_gather      # == all_gather(x, ax, dim), rank order


def ring_reduce_scatter(y, ax: str, *, dim: int, n: int):
    """== psum_scatter(y, ax, dim): a per-destination accumulator circulates."""
    if n <= 1:
        return y
    if y.shape[dim] % n:
        raise ValueError(f"ring RS: extent {y.shape[dim]} does not chunk by ring size {n}")
    idx = comm.axis_index(ax)
    chunk = y.shape[dim] // n
    acc = y.narrow(dim, ((idx - 1) % n) * chunk, chunk)
    for s in range(1, n):
        acc = _hop(acc, ax)
        acc = acc + y.narrow(dim, ((idx + n - 1 - s) % n) * chunk, chunk)
    return acc


# ---------------------------------------------------------------------------
# ring collective matmuls
# ---------------------------------------------------------------------------

def ring_ag_matmul(x, w, ax: str, *, dim: int, n: int, plain: bool = False):
    """== tile_mm(ring_all_gather(x, dim), w), one product per arriving shard."""
    if n <= 1:
        return ops.tile_mm(x, w, plain=plain)
    idx = comm.axis_index(ax)
    parts = [None] * n
    cur = x
    for s in range(n):
        parts[(idx - s) % n] = ops.tile_mm(cur, w, plain=plain)
        if s < n - 1:
            cur = _hop(cur, ax)
    return torch.cat(parts, dim=dim)


def ring_ag_matmul_contract(x, w, ax: str, *, n: int, out_dtype=None, plain: bool = False):
    """== mm(all_gather(x, last dim), w): per-step fp32 partial products."""
    dt = out_dtype or x.dtype
    if n <= 1:
        return ops.tile_mm(x, w, out_dtype=torch.float32, plain=plain).to(dt)
    idx = comm.axis_index(ax)
    h_loc = x.shape[-1]
    acc = None
    cur = x
    for s in range(n):
        part = ops.tile_mm(cur, w.narrow(0, ((idx - s) % n) * h_loc, h_loc),
                           out_dtype=torch.float32, plain=plain)
        acc = part if acc is None else acc + part
        if s < n - 1:
            cur = _hop(cur, ax)
    return acc.to(dt)


def ring_matmul_rs(x, w, ax: str, *, scatter_dim: int, n: int, plain: bool = False):
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
        def contrib(d):
            return ops.tile_mm(x, w.narrow(1, d * chunk, chunk), plain=plain)
    else:
        def contrib(d):
            return ops.tile_mm(x.narrow(scatter_dim, d * chunk, chunk), w, plain=plain)
    acc = contrib((idx - 1) % n)
    for s in range(1, n):
        acc = _hop(acc, ax)
        acc = acc + contrib((idx + n - 1 - s) % n)
    return acc


# ---------------------------------------------------------------------------
# dispatchers: fused when overlap="fused" and tile-aligned, else the ring
# ---------------------------------------------------------------------------

def ag_matmul(x, w, ax: str, *, dim: int, n: int, overlap: str, plain: bool = False):
    """AG + matmul (gathered dim is a batch dim) under the given mode."""
    if overlap == "fused" and RM.fused_ok_ag(x.shape, w.shape, n, dim, x.element_size()):
        log_route("ag_matmul", "all_gather", "fused", ax, n, x, w)
        return RM.ag_matmul(x, w, ax, dim=dim, n=n, plain=plain)
    log_route("ag_matmul", "all_gather", "ring", ax, n, x, w)
    return ring_ag_matmul(x, w, ax, dim=dim, n=n, plain=plain)


def matmul_rs(x, w, ax: str, *, scatter_dim: int, n: int, overlap: str, plain: bool = False):
    """matmul + RS under the given mode."""
    if overlap == "fused" and RM.fused_ok_rs(x.shape, w.shape, n, scatter_dim,
                                             x.element_size()):
        log_route("matmul_rs", "reduce_scatter", "fused", ax, n, x, w)
        return RM.matmul_rs(x, w, ax, scatter_dim=scatter_dim, n=n, plain=plain)
    log_route("matmul_rs", "reduce_scatter", "ring", ax, n, x, w)
    return ring_matmul_rs(x, w, ax, scatter_dim=scatter_dim, n=n, plain=plain)


def ag_matmul_contract(x, w, ax: str, *, n: int, overlap: str, out_dtype=None,
                       plain: bool = False):
    """AG + matmul over the contracted dim under the given mode."""
    if overlap == "fused" and RM.fused_ok_contract(x.shape, w.shape, n, x.element_size()):
        log_route("ag_matmul_contract", "all_gather", "fused", ax, n, x, w)
        return RM.ag_matmul_contract(x, w, ax, n=n, out_dtype=out_dtype, plain=plain)
    log_route("ag_matmul_contract", "all_gather", "ring", ax, n, x, w)
    return ring_ag_matmul_contract(x, w, ax, n=n, out_dtype=out_dtype, plain=plain)


def matmul_rs_pair(x, w1, w1b, ax: str, *, scatter_dim: int, n: int, overlap: str,
                   plain: bool = False):
    """Gated pair: (x w1, x w1b) reduce-scattered, sharing the gathered x."""
    isz = x.element_size()
    if (overlap == "fused" and scatter_dim % x.dim() != x.dim() - 1
            and RM.fused_ok_rs(x.shape, w1.shape, n, scatter_dim, isz)
            and RM.fused_ok_rs(x.shape, w1b.shape, n, scatter_dim, isz)):
        log_route("matmul_rs_pair", "reduce_scatter", "fused", ax, n, x, w1)
        return RM.matmul_rs_pair(x, w1, w1b, ax, scatter_dim=scatter_dim, n=n, plain=plain)
    log_route("matmul_rs_pair", "reduce_scatter", "ring", ax, n, x, w1)
    return (ring_matmul_rs(x, w1, ax, scatter_dim=scatter_dim, n=n, plain=plain),
            ring_matmul_rs(x, w1b, ax, scatter_dim=scatter_dim, n=n, plain=plain))


def fuse_side(h_loc: int, o_loc: int) -> str:
    """Which collective the single matmul fuses into: the heavier side
    (ties go to the AG)."""
    return "rs" if o_loc > h_loc else "ag"


def ring_linear(x, w, *, g_ax: str, n_g: int, s_ax: str, n_s: int, gather_dim: int = 1,
                scatter_dim: int = 1, overlap: str, plain: bool = False):
    """Overlapped y = RS_{s_ax}(AG_{g_ax}(x, gather_dim) @ w, scatter_dim)."""
    check_mode(overlap)
    scattered = (x.shape[gather_dim] * n_g if scatter_dim == gather_dim else w.shape[-1])
    if fuse_side(x.shape[-1], w.shape[-1]) == "rs" and rs_ok(scattered, n_s):
        log_route("ring_linear", "all_gather", "ring", g_ax, n_g, x)
        xg = ring_all_gather(x, g_ax, dim=gather_dim, n=n_g)
        return matmul_rs(xg, w, s_ax, scatter_dim=scatter_dim, n=n_s, overlap=overlap,
                         plain=plain)
    yp = ag_matmul(x, w, g_ax, dim=gather_dim, n=n_g, overlap=overlap, plain=plain)
    if not rs_ok(scattered, n_s):
        log_route("ring_linear", "reduce_scatter", "bulk", s_ax, n_s, yp)
        return comm.psum_scatter(yp, s_ax, scatter_dim)
    log_route("ring_linear", "reduce_scatter", "ring", s_ax, n_s, yp)
    return ring_reduce_scatter(yp, s_ax, dim=scatter_dim, n=n_s)
