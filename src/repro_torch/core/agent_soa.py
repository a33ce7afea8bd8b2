"""Structure-of-Arrays agent container (port of ``repro/core/agent_soa.py``).

Agents live in dense, fixed-schema cell-slot slabs: every attribute is a
tensor of shape ``(*grid, K, *attr_shape)`` where ``grid`` is the local
neighbour-search grid including its one-cell halo ring and ``K`` the
per-cell slot capacity.  A bool ``valid`` tensor marks occupied slots.
Global agent identifiers are the paper's ``<rank, counter>`` pair, two
int32 columns.  The layout and dtypes are the JAX package's, so a state
crosses between the two packages as plain numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

# Reserved attribute names every AgentSoA carries.
POS = "pos"              # (..., ndim) float32 absolute position
GID_RANK = "gid_rank"    # int32 - rank that created the agent
GID_COUNT = "gid_count"  # int32 - strictly increasing per-rank counter

RESERVED = (POS, GID_RANK, GID_COUNT)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (host-side conversions)."""
    return torch.empty((), dtype=dtype).numpy().dtype


@dataclasses.dataclass(frozen=True)
class AgentSchema:
    """Static schema: user attribute name -> (trailing shape, torch dtype)."""

    fields: Tuple[Tuple[str, Tuple[int, ...], Any], ...]

    @staticmethod
    def create(spec: Mapping[str, Tuple[Tuple[int, ...], Any]]
               ) -> "AgentSchema":
        items = []
        for name, (shape, dtype) in sorted(spec.items()):
            if name in RESERVED or name == "valid":
                raise ValueError(f"attribute name {name!r} is reserved")
            if not isinstance(dtype, torch.dtype):
                raise TypeError(
                    f"attribute {name!r}: dtype must be a torch.dtype, got "
                    f"{dtype!r}")
            items.append((name, tuple(shape), dtype))
        return AgentSchema(fields=tuple(items))

    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _, _ in self.fields)

    def all_specs(self, ndim: int = 2
                  ) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
        """Schema including the reserved columns; ``ndim`` sets the spatial
        dimensionality of the ``pos`` column."""
        out: Dict[str, Tuple[Tuple[int, ...], Any]] = {
            POS: ((ndim,), torch.float32),
            GID_RANK: ((), torch.int32),
            GID_COUNT: ((), torch.int32),
        }
        for name, shape, dtype in self.fields:
            out[name] = (shape, dtype)
        return out


@dataclasses.dataclass
class AgentSoA:
    """Agents stored in NSG cell-slot layout: tensors of shape (*grid, K, ...)."""

    attrs: Dict[str, torch.Tensor]   # each (*grid, K, *trailing)
    valid: torch.Tensor              # (*grid, K) bool

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return tuple(self.valid.shape[:-1])

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[-1])

    @property
    def pos(self) -> torch.Tensor:
        return self.attrs[POS]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    def replace(self, **kw) -> "AgentSoA":
        return dataclasses.replace(self, **kw)

    def map_attrs(self, fn: Callable[[str, torch.Tensor], torch.Tensor]
                  ) -> "AgentSoA":
        return self.replace(attrs={k: fn(k, v) for k, v in self.attrs.items()})

    @staticmethod
    def empty(schema: AgentSchema, grid_shape: Tuple[int, ...], cap: int,
              device: torch.device) -> "AgentSoA":
        grid_shape = tuple(grid_shape)
        attrs = {}
        for name, (shape, dtype) in schema.all_specs(len(grid_shape)).items():
            attrs[name] = torch.zeros(grid_shape + (cap,) + shape,
                                      dtype=dtype, device=device)
        valid = torch.zeros(grid_shape + (cap,), dtype=torch.bool,
                            device=device)
        return AgentSoA(attrs=attrs, valid=valid)


def flat_view(soa: AgentSoA
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Flatten (*grid, K, ...) -> (N, ...) for sorting/packing passes."""
    nd = soa.valid.dim()          # grid axes + the slot axis
    n = soa.valid.numel()
    attrs = {name: a.reshape((n,) + tuple(a.shape[nd:]))
             for name, a in soa.attrs.items()}
    return attrs, soa.valid.reshape((n,))


def concat_flat(
    a: Tuple[Dict[str, torch.Tensor], torch.Tensor],
    b: Tuple[Dict[str, torch.Tensor], torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Concatenate two flat agent sets (used for spawn + received migrants)."""
    attrs = {k: torch.cat([a[0][k], b[0][k]], dim=0) for k in a[0]}
    return attrs, torch.cat([a[1], b[1]], dim=0)
