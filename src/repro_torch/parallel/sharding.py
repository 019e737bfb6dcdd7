"""Layout rules of the grid's two strategies and the attention layout solver.

A copy of what the grid steps read from ``repro/parallel/sharding.py``:
``AxisInfo``/``axis_info`` (hecaton: tokens over ``mx``, hidden over
``my``; megatron: the 1D ``model`` axis), ``AttnLayout``/
``solve_attn_layout``, ``vocab_spec`` and ``seq_shardable`` (may the
megatron residual cut a sequence).  A spec here is a tuple with one entry
per array dim: ``None``, an axis name, or a tuple of axis names (the JAX
package's ``PartitionSpec`` entries); ``parallel/specs.py`` turns one
into the slice a rank holds.  The activation specs (``act_canonical``,
``act_mixer``) have no counterpart, as the port writes no sharding
constraint: each grid op takes and returns its blocks in those layouts
by construction (``core/hecaton.py``, ``parallel/megatron.py``), and
``config.ParallelConfig`` validates the residual layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.launch.mesh import MODEL, Grid

Spec = Tuple                           # entries: None | axis | tuple of axes


def divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _prod(it):
    r = 1
    for v in it:
        r *= v
    return r


@dataclass(frozen=True)
class AxisInfo:
    """Grid axis bookkeeping for one strategy."""
    data_axes: Tuple[str, ...]
    t_ax: Optional[str]
    h_ax: Optional[str]
    model_axes: Tuple[str, ...]
    sizes: Dict[str, int]

    @property
    def n_data(self) -> int:
        return int(_prod(self.sizes[a] for a in self.data_axes))

    @property
    def n_model(self) -> int:
        return int(_prod(self.sizes[a] for a in self.model_axes))

    def size(self, ax) -> int:
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            return int(_prod(self.sizes[a] for a in ax))
        return self.sizes[ax]


def axis_info(grid: Optional[Grid], strategy: str = "hecaton") -> Optional[AxisInfo]:
    """The axes of ``strategy`` over ``grid``: hecaton's (mx, my), or
    megatron's one ``model`` axis (no token or hidden axis)."""
    if grid is None:
        return None
    if strategy == "hecaton":
        return AxisInfo(("data",), "mx", "my", ("mx", "my"), grid.sizes)
    if strategy == "megatron":
        return AxisInfo(("data",), None, None, (MODEL,), grid.sizes)
    raise ValueError(f"strategy={strategy!r} not in ('hecaton', 'megatron')")


@dataclass(frozen=True)
class AttnLayout:
    """How [B, S, n_heads, head_dim] is sharded inside the mixer."""
    batch_axes: Tuple[str, ...]
    head_axes: Tuple[str, ...]
    note: str = ""

    def q_spec(self) -> Spec:
        b = self.batch_axes if len(self.batch_axes) != 1 else self.batch_axes[0]
        h = self.head_axes if len(self.head_axes) != 1 else (
            self.head_axes[0] if self.head_axes else None)
        return (b if self.batch_axes else None, None, h if self.head_axes else None, None)


def solve_attn_layout(ax: AxisInfo, n_heads: int, batch_per_data: int) -> AttnLayout:
    """The JAX package's solver with ``prefer="auto"``: heads over all
    model axes first, then the batch-absorbing layouts, then replication."""
    m_axes, sz = ax.model_axes, ax.size
    if divides(n_heads, ax.n_model):
        return AttnLayout(ax.data_axes, m_axes, "heads fully sharded")
    if ax.t_ax is not None:
        if (divides(n_heads, sz(ax.h_ax))
                and divides(batch_per_data, sz(ax.t_ax))):
            return AttnLayout(ax.data_axes + (ax.t_ax,), (ax.h_ax,),
                              "heads on my, batch on mx")
        if (divides(n_heads, sz(ax.t_ax))
                and divides(batch_per_data, sz(ax.h_ax))):
            return AttnLayout(ax.data_axes + (ax.h_ax,), (ax.t_ax,),
                              "heads on mx, batch on my")
        if divides(n_heads, sz(ax.h_ax)):
            return AttnLayout(ax.data_axes, (ax.h_ax,),
                              f"heads on my only; {ax.t_ax} replicated "
                              f"(compute x{sz(ax.t_ax)})")
    if divides(batch_per_data, ax.n_model):
        return AttnLayout(ax.data_axes + m_axes, (),
                          "batch over model axes, heads replicated-per-shard")
    return AttnLayout(ax.data_axes, (), "WARNING: attention replicated over model axes")


def one(axes):
    """A spec entry of a tuple of axes: None, the axis, or the tuple
    (``sharding._one`` of the JAX package)."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def seq_shardable(ax: Optional[AxisInfo], seq_len: int) -> bool:
    """Can a megatron residual of this (global) sequence extent shard over
    the model axis?  One model axis of size > 1 that divides the sequence;
    anything else (hecaton, decode's S = 1) is not, and the caller keeps
    the replicated residual."""
    if ax is None or ax.t_ax is not None:
        return False
    if len(ax.model_axes) != 1:
        return False
    n = ax.size(ax.model_axes[0])
    return n > 1 and seq_len > 1 and seq_len % n == 0


def vocab_spec(ax: Optional[AxisInfo]) -> Optional[Spec]:
    """Embedding table [V, H]."""
    if ax is None:
        return None
    if ax.t_ax is not None:
        return (ax.t_ax, ax.h_ax)
    return (MODEL, None)
