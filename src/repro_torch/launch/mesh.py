"""The data x mx x my grid of ranks.

Counterpart of ``repro/launch/mesh.py::make_small_mesh`` for the hecaton
strategy: where the JAX package reshapes devices into a ``Mesh`` with
axes ``("data", "mx", "my")``, the port runs one process per rank and a
:class:`Grid` gives each its coordinates.  Ranks are laid out as the
JAX package reshapes its device list, row-major over (data, mx, my), so
rank r holds the block that device r of ``make_small_mesh`` holds.
Rank r runs on card ``r % torch.cuda.device_count()``: on a one-card
machine every rank shares card 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

AXES = ("data", "mx", "my")


@dataclass(frozen=True)
class Grid:
    data: int
    mx: int
    my: int
    rank: int = 0

    def __post_init__(self):
        for a in AXES:
            if getattr(self, a) < 1:
                raise ValueError(f"grid axis {a} must be >= 1, got {getattr(self, a)}")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of {self.world}")

    @property
    def world(self) -> int:
        return self.data * self.mx * self.my

    @property
    def sizes(self) -> Dict[str, int]:
        return {"data": self.data, "mx": self.mx, "my": self.my}

    def size(self, ax) -> int:
        """Size of one axis, or the product over a tuple of axes."""
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            n = 1
            for a in ax:
                n *= self.sizes[a]
            return n
        return self.sizes[ax]

    def coords_of(self, rank: int) -> Tuple[int, int, int]:
        return rank // (self.mx * self.my), (rank // self.my) % self.mx, rank % self.my

    @property
    def coords(self) -> Dict[str, int]:
        return dict(zip(AXES, self.coords_of(self.rank)))

    def axis_index(self, ax) -> int:
        """This rank's index along an axis, or along a tuple of axes taken
        row-major (the order a ``PartitionSpec`` entry ``(mx, my)`` uses)."""
        if isinstance(ax, tuple):
            idx = 0
            for a in ax:
                idx = idx * self.sizes[a] + self.coords[a]
            return idx
        return self.coords[ax]

    def rank_at(self, **coords) -> int:
        c = dict(self.coords, **coords)
        return (c["data"] * self.mx + c["mx"]) * self.my + c["my"]

    def axis_ranks(self, ax: str, rank: int = None):
        """The ranks of ``rank``'s group along ``ax``, in axis-index order."""
        base = self.coords if rank is None else dict(zip(AXES, self.coords_of(rank)))
        return [self.rank_at(**dict(base, **{ax: k})) for k in range(self.sizes[ax])]
