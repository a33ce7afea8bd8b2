"""Aura-exchange payload codec (port of part of ``repro/core/delta.py``).

This slice ports the full-refresh path only: a payload is the raw slab and
the new reference is the slab itself.  The int8/int16 delta codec and the
migration position codec come with the multi-device slice (ROADMAP A7),
so ``DeltaConfig(enabled=True)`` raises for now.

Bytes on the wire are static and exact: ``payload_bytes`` sums
``itemsize * numel`` over the payload's tensors, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

# A "slab" is a dict of tensors: the unit of halo exchange.
Slab = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DeltaConfig:
    enabled: bool = True
    qdtype: Any = torch.int8      # int8 or int16 quantized delta payload
    refresh_interval: int = 16    # full f32 send every R iterations
    scale: Any = None             # fixed quantization scale (None: adaptive)
    migration: Any = None         # migration position codec dtype

    def __post_init__(self):
        if self.enabled:
            raise NotImplementedError(
                "delta-encoded aura exchange is not ported yet (ROADMAP "
                "A7); use DeltaConfig(enabled=False) (full refresh)")


def encode_full(slab: Slab) -> Tuple[Slab, Slab]:
    """Full refresh: payload is the raw slab; new reference = slab."""
    return slab, slab


def decode_full(payload: Slab) -> Tuple[Slab, Slab]:
    return payload, payload


def payload_bytes(payload: Slab) -> int:
    """Exact static wire bytes of a payload."""
    return sum(t.element_size() * t.numel() for t in payload.values())
