"""Layout rules of the hecaton grid and the attention layout solver.

A copy of what the grid step reads from ``repro/parallel/sharding.py``:
``AxisInfo``/``axis_info``, ``AttnLayout``/``solve_attn_layout`` and
``vocab_spec``.  A spec here is a tuple with one entry per array dim:
``None``, an axis name, or a tuple of axis names (the JAX package's
``PartitionSpec`` entries); ``parallel/specs.py`` turns one into the
slice a rank holds.  The activation specs (``act_canonical``,
``act_mixer``) have no counterpart: each grid op takes and returns its
blocks in those layouts by construction (``core/hecaton.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.launch.mesh import Grid

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
    if grid is None:
        return None
    if strategy != "hecaton":
        raise NotImplementedError(f"strategy {strategy!r} is not ported (ROADMAP queue 1)")
    return AxisInfo(("data",), "mx", "my", ("mx", "my"), grid.sizes)


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


def vocab_spec(ax: Optional[AxisInfo]) -> Optional[Spec]:
    """Embedding table [V, H]."""
    if ax is None:
        return None
    if ax.t_ax is not None:
        return (ax.t_ax, ax.h_ax)
    return ("model", None)
