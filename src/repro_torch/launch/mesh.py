"""The (pod x) data x mx x my grid of ranks.

Counterpart of ``repro/launch/mesh.py::make_small_mesh``: where the JAX
package reshapes devices into a ``Mesh`` with axes ``("data", "mx",
"my")`` (hecaton) or ``("data", "model")`` (megatron), the port runs one
process per rank and a :class:`Grid` gives each its coordinates.  Ranks
are laid out as the JAX package reshapes its device list, row-major over
(data, mx, my), so rank r holds the block that device r of
``make_small_mesh`` holds.  Rank r runs on card ``r %
torch.cuda.device_count()``: on a one-card machine every rank shares
card 0.

The megatron axis ``model`` is derived, not a fourth dimension: it is
the (mx, my) ranks of one data index taken row-major, so its index is
``axis_index(("mx", "my"))`` and equals the rank's index in JAX's
``devs.reshape(data, mx * my)``.  :data:`AXES` stays the three axes that
place a rank; :data:`RING_AXES` adds ``model``, and the collectives
(``parallel/comm.py``) give each of the four its group, counters and
slots.  A hecaton step never names ``model``, a megatron step never
names ``mx`` or ``my``.

``pods`` (default 1) prepends the inter-package axis ``pod``, as
``make_small_mesh(..., pods=p)`` prepends it to the JAX mesh: rank r is
laid out row-major over (pod, data, mx, my), so a pod is a contiguous
block of ``pod_world`` ranks.  The other axes' groups stay inside one
pod, and the ``pod`` group links the ranks that share (data, mx, my)
across pods (the pipeline's stage boundary, ``parallel/pipeline.py``).
:meth:`Grid.pod_grid` is this rank's pod seen as a single-pod grid, the
counterpart of ``pod_submeshes``: inside a stage the world looks exactly
like a one-pod run.  ``pod`` is no ring axis: :data:`GROUP_AXES` adds it
to :data:`RING_AXES` for the groups only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

AXES = ("data", "mx", "my")
MODEL = "model"                        # megatron's 1D axis: (mx, my) row-major
RING_AXES = AXES + (MODEL,)
POD = "pod"                            # the inter-package axis (pipeline stages)
GROUP_AXES = RING_AXES + (POD,)


@dataclass(frozen=True)
class Grid:
    data: int
    mx: int
    my: int
    rank: int = 0
    pods: int = 1

    def __post_init__(self):
        for a in AXES + ("pods",):
            if getattr(self, a) < 1:
                raise ValueError(f"grid axis {a} must be >= 1, got {getattr(self, a)}")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of {self.world}")

    @property
    def pod_world(self) -> int:
        """Ranks in one pod."""
        return self.data * self.mx * self.my

    @property
    def world(self) -> int:
        return self.pods * self.pod_world

    @property
    def sizes(self) -> Dict[str, int]:
        return {"data": self.data, "mx": self.mx, "my": self.my, MODEL: self.mx * self.my,
                POD: self.pods}

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
        """(data, mx, my) of ``rank`` inside its pod."""
        rank %= self.pod_world
        return rank // (self.mx * self.my), (rank // self.my) % self.mx, rank % self.my

    def _coords(self, rank: int) -> Dict[str, int]:
        c = dict(zip(AXES, self.coords_of(rank)))
        c[MODEL] = c["mx"] * self.my + c["my"]
        c[POD] = rank // self.pod_world
        return c

    def pod_grid(self) -> "Grid":
        """This rank's pod as a one-pod grid (the same coordinates)."""
        return Grid(self.data, self.mx, self.my, self.rank % self.pod_world)

    @property
    def coords(self) -> Dict[str, int]:
        return self._coords(self.rank)

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
        """The rank at these coordinates (the others this rank's); a
        ``model`` index stands for its (mx, my) pair."""
        mine = self._coords(self.rank)
        c = dict({a: mine[a] for a in AXES + (POD,)}, **coords)
        if MODEL in coords:
            c["mx"], c["my"] = divmod(coords[MODEL], self.my)
        return c[POD] * self.pod_world + (c["data"] * self.mx + c["mx"]) * self.my + c["my"]

    def axis_ranks(self, ax: str, rank: int = None):
        """The ranks of ``rank``'s group along ``ax``, in axis-index order."""
        c = self._coords(self.rank if rank is None else rank)
        base = {a: c[a] for a in AXES + (POD,)}
        return [self.rank_at(**dict(base, **{ax: k})) for k in range(self.sizes[ax])]
