"""The N-dimensional spatial ``Domain`` (port of ``repro/core/domain.py``).

A :class:`Domain` is the single source of spatial truth: dimensionality
(2 or 3, from ``interior``), per-axis interior cell counts and device-mesh
shape, per-axis boundary conditions (``"closed"`` | ``"toroidal"``), the
NSG cell size, the per-cell slot capacity and the partitioning-box factor.
:class:`Partition` carries per-axis cut positions for uneven ownership.
Both are frozen and validated exactly as in the reference.  The partition
is rectilinear, so along axis ``a`` a device's owned width depends only on
its mesh coordinate along ``a`` (:attr:`Domain.axis_widths`): the virtual
mesh's exchanges and migration index each mesh row by it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

# Axis naming shared by the halo edge keys ("xm"/"xp"/.../"zp") and the
# spatial mesh axis names ("sx", "sy", "sz").
AXIS_CHARS = "xyz"

BOUNDARIES = ("closed", "toroidal")


def spatial_axis_names(ndim: int) -> Tuple[str, ...]:
    """Device-mesh axis names for an ``ndim``-dimensional spatial mesh."""
    return tuple("s" + AXIS_CHARS[a] for a in range(ndim))


def _as_int_tuple(x) -> Tuple[int, ...]:
    if isinstance(x, int):
        return (x,)
    return tuple(int(v) for v in x)


def normalize_boundary(boundary: Union[str, Sequence[str]],
                       ndim: int) -> Tuple[str, ...]:
    """Broadcast/validate a boundary spec to a per-axis tuple."""
    if isinstance(boundary, str):
        boundary = (boundary,) * ndim
    b = tuple(str(v) for v in boundary)
    if len(b) != ndim:
        raise ValueError(
            f"boundary {b} has {len(b)} entries for a {ndim}-D domain")
    for v in b:
        if v not in BOUNDARIES:
            raise ValueError(
                f"unknown boundary {v!r}; expected one of {BOUNDARIES} "
                "(per axis, or one string broadcast to all axes)")
    return b


@dataclasses.dataclass(frozen=True)
class Partition:
    """Per-axis box-granular cut positions: the device at mesh coordinate
    ``c`` owns the global cell slab ``[cuts[a][c], cuts[a][c+1])`` along
    every axis ``a``."""

    cuts: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        cuts = tuple(tuple(int(v) for v in c) for c in self.cuts)
        if len(cuts) not in (2, 3):
            raise ValueError(
                f"Partition supports 2-D and 3-D spaces; got {len(cuts)} "
                "cut axes")
        for a, c in enumerate(cuts):
            if len(c) < 2 or c[0] != 0:
                raise ValueError(
                    f"axis {a} cuts {c} must start at 0 and contain at "
                    "least one slab")
            if any(hi <= lo for lo, hi in zip(c, c[1:])):
                raise ValueError(
                    f"axis {a} cuts {c} must be strictly increasing "
                    "(every device owns at least one cell per axis)")
        object.__setattr__(self, "cuts", cuts)

    @staticmethod
    def equal(global_cells: Sequence[int],
              mesh_shape: Sequence[int]) -> "Partition":
        """The equal-split partition."""
        g = _as_int_tuple(global_cells)
        m = _as_int_tuple(mesh_shape)
        if len(g) != len(m) or any(gc % mm for gc, mm in zip(g, m)):
            raise ValueError(
                f"mesh {m} does not divide the global cell grid {g}")
        return Partition(cuts=tuple(
            tuple(i * (gc // mm) for i in range(mm + 1))
            for gc, mm in zip(g, m)))

    @staticmethod
    def from_widths(widths: Sequence[Sequence[int]]) -> "Partition":
        """Build from per-axis slab widths (cells)."""
        cuts = []
        for w in widths:
            c, acc = [0], 0
            for v in w:
                acc += int(v)
                c.append(acc)
            cuts.append(tuple(c))
        return Partition(cuts=tuple(cuts))

    @property
    def ndim(self) -> int:
        return len(self.cuts)

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        return tuple(len(c) - 1 for c in self.cuts)

    @property
    def global_cells(self) -> Tuple[int, ...]:
        return tuple(c[-1] for c in self.cuts)

    @property
    def widths(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-axis slab widths in cells."""
        return tuple(tuple(hi - lo for lo, hi in zip(c, c[1:]))
                     for c in self.cuts)

    @property
    def max_widths(self) -> Tuple[int, ...]:
        """Per-axis padded slab width (the per-device grid allocation)."""
        return tuple(max(w) for w in self.widths)

    @property
    def is_equal(self) -> bool:
        return all(len(set(w)) == 1 for w in self.widths)

    def scale(self, factor: int) -> "Partition":
        """Cuts in a coarser unit (boxes) -> cuts in cells."""
        return Partition(cuts=tuple(
            tuple(v * int(factor) for v in c) for c in self.cuts))

    def pad_fraction(self) -> float:
        """Padding memory overhead: allocated padded cells / owned cells."""
        alloc = math.prod(self.max_widths) * math.prod(self.mesh_shape)
        owned = math.prod(self.global_cells)
        return alloc / owned - 1.0


@dataclasses.dataclass(frozen=True)
class Domain:
    """Static N-D spatial specification of one run's partitioning + NSG.

    Attributes:
      cell_size: NSG cell edge length (>= max interaction radius).
      interior: per-axis interior cell counts per device, length ``ndim``.
      mesh_shape: per-axis spatial device mesh (``None`` or an all-ones
        tuple of any length defaults to a single device).
      cap: per-cell slot capacity K.
      boundary: per-axis ``"closed"`` | ``"toroidal"``; a plain string is
        broadcast to every axis.
      box_factor: partitioning-box length as a multiple of the NSG cell.
      partition: optional uneven :class:`Partition` (an equal one
        normalizes to ``None``).
    """

    cell_size: float
    interior: Tuple[int, ...]
    mesh_shape: Tuple[int, ...] = None
    cap: int = 24
    boundary: Union[str, Tuple[str, ...]] = "closed"
    box_factor: int = 1
    partition: "Partition" = None

    def __post_init__(self):
        interior = _as_int_tuple(self.interior)
        nd = len(interior)
        if nd not in (2, 3):
            raise ValueError(
                f"Domain supports 2-D and 3-D spaces; got interior "
                f"{interior} ({nd}-D)")
        mesh = self.mesh_shape
        if mesh is None:
            mesh = (1,) * nd
        mesh = _as_int_tuple(mesh)
        if len(mesh) != nd and all(m == 1 for m in mesh):
            mesh = (1,) * nd
        if len(mesh) != nd:
            raise ValueError(
                f"mesh_shape {mesh} has {len(mesh)} axes for a {nd}-D "
                f"domain (interior {interior})")
        if any(i < 1 for i in interior) or any(m < 1 for m in mesh):
            raise ValueError(
                f"interior {interior} and mesh_shape {mesh} must be >= 1 "
                "per axis")
        part = self.partition
        if part is not None:
            if not isinstance(part, Partition):
                part = Partition(cuts=tuple(part))
            if part.mesh_shape != mesh:
                raise ValueError(
                    f"partition mesh {part.mesh_shape} does not match "
                    f"mesh_shape {mesh}")
            if part.max_widths != interior:
                raise ValueError(
                    f"interior {interior} must equal the partition's "
                    f"per-axis max slab widths {part.max_widths} (the "
                    "padded per-device grid); build via Domain.repartition")
            if self.box_factor > 1 and any(
                    v % self.box_factor for c in part.cuts for v in c):
                raise ValueError(
                    f"partition cuts {part.cuts} are not aligned to "
                    f"box_factor {self.box_factor} - cut positions must "
                    "lie on partitioning-box boundaries")
            if part.is_equal:
                part = None
        object.__setattr__(self, "interior", interior)
        object.__setattr__(self, "mesh_shape", mesh)
        object.__setattr__(self, "partition", part)
        object.__setattr__(self, "boundary",
                           normalize_boundary(self.boundary, nd))

    # ------------------------------------------------------------------
    # Derived geometry
    # ------------------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.interior)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """Per-device cell grid including the one-cell halo ring."""
        return tuple(i + 2 for i in self.interior)

    @property
    def uneven(self) -> bool:
        return self.partition is not None

    @property
    def global_cells(self) -> Tuple[int, ...]:
        if self.partition is not None:
            return self.partition.global_cells
        return tuple(i * m for i, m in zip(self.interior, self.mesh_shape))

    @property
    def domain_size(self) -> Tuple[float, ...]:
        return tuple(g * self.cell_size for g in self.global_cells)

    @property
    def n_devices(self) -> int:
        return math.prod(self.mesh_shape)

    @property
    def toroidal(self) -> Tuple[bool, ...]:
        """Per-axis toroidal flags."""
        return tuple(b == "toroidal" for b in self.boundary)

    @property
    def box_grid(self) -> Tuple[int, ...]:
        """Global partitioning-box grid, ``box_factor`` cells per box edge."""
        g = self.global_cells
        if any(gc % self.box_factor for gc in g):
            raise ValueError(
                f"box_factor {self.box_factor} must divide the global cell "
                f"grid {g}")
        return tuple(gc // self.box_factor for gc in g)

    # ------------------------------------------------------------------
    # Transformations
    # ------------------------------------------------------------------
    def with_mesh_shape(self, mesh_shape: Sequence[int]) -> "Domain":
        """Same global domain re-partitioned equally over another mesh."""
        g = self.global_cells
        mesh = _as_int_tuple(mesh_shape)
        if len(mesh) != self.ndim:
            raise ValueError(
                f"mesh {mesh} has {len(mesh)} axes for a {self.ndim}-D "
                "domain")
        if any(gc % m for gc, m in zip(g, mesh)):
            raise ValueError(
                f"mesh {mesh} does not divide the global cell grid {g}")
        return dataclasses.replace(
            self, mesh_shape=mesh, partition=None,
            interior=tuple(gc // m for gc, m in zip(g, mesh)))

    def repartition(self, partition: "Partition") -> "Domain":
        """Same global domain re-cut along a :class:`Partition`."""
        if partition.global_cells != self.global_cells:
            raise ValueError(
                f"partition covers {partition.global_cells} cells; this "
                f"domain has {self.global_cells}")
        return dataclasses.replace(
            self, mesh_shape=partition.mesh_shape,
            interior=partition.max_widths,
            partition=partition)

    def device_origin(self, coords: Tuple[int, ...],
                      device: torch.device) -> torch.Tensor:
        """World-space origin (float32 tensor) of the device's owned region
        from its integer mesh coordinates."""
        if self.partition is not None:
            starts = [np.asarray(c[:-1], np.float64) * self.cell_size
                      for c in self.partition.cuts]
            vals = [s[int(c)] for s, c in zip(starts, coords)]
        else:
            vals = [int(c) * (i * self.cell_size)
                    for c, i in zip(coords, self.interior)]
        return torch.tensor(np.asarray(vals, np.float32), device=device)

    def device_ends(self, device: torch.device) -> torch.Tensor:
        """World-space end of every device's owned region along each axis
        (the next device's origin; L at the last), ``mesh_shape +
        (ndim,)`` float32, rounded from float64 as :meth:`device_origin`
        rounds the origins."""
        if self.partition is not None:
            ends = [np.asarray(c[1:], np.float64) * self.cell_size
                    for c in self.partition.cuts]
        else:
            ends = [(np.arange(m, dtype=np.float64) + 1) * (i * self.cell_size)
                    for m, i in zip(self.mesh_shape, self.interior)]
        grid = np.stack(np.meshgrid(*ends, indexing="ij"), axis=-1)
        return torch.from_numpy(grid.astype(np.float32)).to(device)

    def device_origins(self, device: torch.device) -> torch.Tensor:
        """:meth:`device_origin` of every device of the mesh, stacked as
        ``mesh_shape + (ndim,)`` (float32)."""
        return torch.stack([self.device_origin(c, device)
                            for c in np.ndindex(*self.mesh_shape)]
                           ).reshape(self.mesh_shape + (self.ndim,))

    @property
    def axis_widths(self) -> Tuple[Tuple[int, ...], ...]:
        """Per axis ``a``, the owned width of the devices at each mesh
        coordinate along ``a`` (host ints; ``interior[a]`` everywhere on
        an equal split)."""
        if self.partition is not None:
            return self.partition.widths
        return tuple((i,) * m for i, m in zip(self.interior, self.mesh_shape))

    def owned_widths(self, coords: Tuple[int, ...]
                     ) -> Optional[Tuple[int, ...]]:
        """Per-axis owned slab widths of the device at ``coords``; ``None``
        on an equal split."""
        if self.partition is None:
            return None
        return tuple(w[int(c)]
                     for w, c in zip(self.partition.widths, coords))
