"""Which slice of each full array a rank of the grid holds.

Counterpart of ``repro/parallel/specs.py`` for both strategies:
``_leaf_spec``/``param_specs`` (hecaton's weight tiling: ``W[H, O]``
consumed from the canonical layout is ``(h_ax, t_ax)``, the second fused
layer ``(t_ax, h_ax)``, the table ``(t_ax, h_ax)``; megatron's 1D
tiling: ``W_IN`` column-parallel ``(None, model)``, ``W_OUT`` row-parallel
``(model, None)``, the table ``(model, None)``; norms replicated).
Where the JAX package hands a spec to ``NamedSharding``, the port cuts
the full array itself: :func:`local_slice` is the block that rank
``grid.rank`` holds, :func:`gather_full` (the inverse, with collectives)
rebuilds the full array on every rank, and :func:`local_batch` is a
rank's block of a batch (``batch_specs``: batch over data; tokens over
mx, or over megatron's model axis when the seq residual applies).  The
moments' ZeRO-1 specs (``opt_state_specs``) are worked out per leaf in
``train/step.py`` from ``zero.state_spec``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import Grid
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd

W_IN = {"wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wkv_b", "wz", "wx", "w1", "w1b", "w"}
W_OUT = {"wo", "w2"}
REPL = {"scale", "bias", "norm", "q_norm", "k_norm", "kv_norm", "A_log", "D",
        "dt_bias", "conv_w", "wB", "wC", "wdt", "router"}


def leaf_spec(path: Tuple[str, ...], rank: int, ax: shd.AxisInfo,
              fused_loss: bool = True) -> shd.Spec:
    """``_leaf_spec`` (no MoE leaves); the strategy is ``ax``'s (megatron
    has no token axis)."""
    name = path[-1]
    lead = rank - 2
    if name == "table":
        return shd.vocab_spec(ax)
    if name in REPL:
        return ()
    if ax.t_ax is None:                                    # megatron 1D
        m = ax.model_axes[0]
        if name in W_IN:
            return (None,) * lead + (None, m)
        if name in W_OUT:
            return (None,) * lead + (m, None)
        return ()
    t, h = ax.t_ax, ax.h_ax
    if fused_loss and len(path) >= 2 and path[-2] == "lm_head":
        return (None, h)
    if name in W_IN:
        return (None,) * lead + (h, t)
    if name in W_OUT:
        return (None,) * lead + (t, h)
    return ()


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params, grid: Grid, fused_loss: bool = True, strategy: str = "hecaton"):
    """Spec tree of a (full or local) parameter tree."""
    ax = shd.axis_info(grid, strategy)
    return _map(params, lambda p, t: leaf_spec(p, t.dim(), ax, fused_loss))


def _entry_axes(e) -> Tuple[str, ...]:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, tuple) else (e,)


def spec_axes(spec: shd.Spec) -> Tuple[str, ...]:
    out = []
    for e in spec:
        out.extend(_entry_axes(e))
    return tuple(out)


def grid_axes(strategy: str = "hecaton") -> Tuple[str, ...]:
    """The axes a strategy lays its ranks out on, each rank once: data
    then the model axes."""
    ax = shd.axis_info(Grid(1, 1, 1), strategy)
    return ax.data_axes + ax.model_axes


def replicated_axes(spec: shd.Spec, grid: Grid, strategy: str = "hecaton") -> Tuple[str, ...]:
    """The axes (of size > 1) over which a leaf of this spec is held whole
    by several ranks: its gradient is summed over them."""
    used = set(spec_axes(spec))
    return tuple(a for a in grid_axes(strategy) if a not in used and grid.size(a) > 1)


def local_slice(full: torch.Tensor, spec: shd.Spec, grid: Grid) -> torch.Tensor:
    """The block of ``full`` that ``grid.rank`` holds under ``spec`` (a
    copy of its own, also where the spec splits nothing).  Every sharded
    extent must divide."""
    out = full
    for dim, e in enumerate(spec):
        axes = _entry_axes(e)
        if not axes:
            continue
        n, idx = grid.size(axes), grid.axis_index(axes)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split over {axes}")
        c = out.shape[dim] // n
        out = out.narrow(dim, idx * c, c)
    return out.clone(memory_format=torch.contiguous_format)


def gather_full(local: torch.Tensor, spec: shd.Spec) -> torch.Tensor:
    """Inverse of :func:`local_slice`, with all-gathers over the grid (no
    autograd): every rank gets the full array."""
    out = local
    for dim, e in enumerate(spec):
        for a in reversed(_entry_axes(e)):        # inner axis first
            out = comm.raw_all_gather(out, a, dim)
    return out


def shard_tree(tree, specs, grid: Grid):
    """:func:`local_slice` over a tree of full tensors."""
    def f(path, t):
        spec = specs
        for k in path:
            spec = spec[k]
        return local_slice(t, spec, grid)
    return _map(tree, f)


def seq_axis(grid: Grid, strategy: str, residual: str, seq_len: int) -> Optional[str]:
    """The axis a batch's tokens are cut over (``batch_specs``): hecaton's
    ``mx``; megatron's ``model`` under the seq residual when the model ring
    divides ``seq_len``, else none."""
    ax = shd.axis_info(grid, strategy)
    if ax.t_ax is not None:
        return ax.t_ax
    if residual == "seq" and shd.seq_shardable(ax, seq_len):
        return ax.model_axes[0]
    return None


def local_batch(batch: Dict[str, Any], grid: Grid, n_micro: int = 1,
                strategy: str = "hecaton", residual: str = "seq"):
    """This rank's block of a global batch ([B, S] numpy or torch arrays).

    Tokens are cut over :func:`seq_axis` (hecaton's ``mx``; megatron's
    ``model`` when the seq residual shards this sequence, else not at
    all).  Rows are dealt so that local microbatch m is global microbatch
    m's block over ``data``, as the JAX step's ``microbatch_split`` of the
    global batch followed by its data sharding: global [B, S] -> [n_micro,
    data, B / (n_micro data), S], then this rank's data index."""
    out = {}
    d, nd = grid.axis_index("data"), grid.size("data")
    for k, v in batch.items():
        B, S = v.shape[:2]
        sax = seq_axis(grid, strategy, residual, S)
        t, nt = (grid.axis_index(sax), grid.size(sax)) if sax else (0, 1)
        if B % (n_micro * nd) or S % nt:
            raise ValueError(f"batch {tuple(v.shape)} does not split over "
                             f"{n_micro} microbatches x {nd} data x {nt} {sax}")
        b = B // (n_micro * nd)
        v = v.reshape(n_micro, nd, b, *v.shape[1:])[:, d].reshape(n_micro * b, *v.shape[1:])
        c = S // nt
        out[k] = v[:, t * c:(t + 1) * c]
    return out


def spec_of(specs, path: Tuple[str, ...]) -> Optional[shd.Spec]:
    s = specs
    for k in path:
        s = s[k]
    return s
