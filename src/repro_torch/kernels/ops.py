"""Public wrappers around the delta-codec kernels (port of the delta part
of ``repro/kernels/ops.py``): one ``(N, L)`` float32 slab, one scalar
scale, the TPU kernel's int8 range of ``+-127``.

The engine does not go through these; it calls ``core.delta``, which
runs the same kernels over the stacked slabs of every device."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import delta_codec


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(1, -1)


def delta_encode(x: torch.Tensor, ref: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(N, L)`` float32 slab -> ``(q int8, scale f32)``.  The adaptive
    scale is derived from max ``|x - ref|``, so nothing saturates (the
    kernel's overflow count is identically zero and dropped here)."""
    q, s, _, _ = delta_codec.delta_encode(
        _rows(x), _rows(ref), qdtype=torch.int8, symmetric=True,
        with_ref=False)
    return q.reshape(x.shape), s.reshape(())


def delta_encode_fixed(x: torch.Tensor, ref: torch.Tensor, scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(N, L)`` float32 slab at a caller-fixed scale -> ``(q int8,
    overflow int32)``; ``overflow`` counts the deltas that saturated at
    ``+-127``."""
    q, _, oflow, _ = delta_codec.delta_encode(
        _rows(x), _rows(ref), qdtype=torch.int8, scale=float(scale),
        symmetric=True, with_ref=False)
    return q.reshape(x.shape), oflow.reshape(())


def delta_decode(q: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor
                 ) -> torch.Tensor:
    """``ref + q * scale`` of an ``(N, L)`` slab."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    return delta_codec.delta_decode(
        _rows(q), _rows(ref), scale.reshape(1)).reshape(ref.shape)
