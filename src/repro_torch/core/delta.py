"""Delta encoding of iterative exchanges (port of ``repro/core/delta.py``,
paper section 2.3).

Sender and receiver of each directed aura edge keep a shared reference
slab; float attributes cross the wire as int8/int16 quantized deltas
against it with one float32 scale a slab (``name + "/scale"``), and both
sides set ``ref <- ref + q * scale`` (the closed loop).  Emigrant
positions can cross as int16 offsets from the sender's box centre
(``pos + "/center"``).  Bytes on the wire are static and exact.

Every function takes ``lead``: the number of leading device-mesh dims the
slab's tensors carry (0 for one device's slab, as the reference; the
mesh's ``ndim`` for the stacked slabs of the virtual mesh).  The quantize
and dequantize run on the hand-written kernels of
``kernels/delta_codec.py``, one launch per float attribute for all
devices, with the semantics of this module's reference: the clip range
``[iinfo.min, iinfo.max]``, and migration overflow counted on live rows
only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import delta_codec

# A "slab" is a dict of tensors: the unit of halo exchange.
Slab = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DeltaConfig:
    enabled: bool = True
    qdtype: Any = torch.int8      # int8 or int16 quantized delta payload
    refresh_interval: int = 16    # full f32 send every R iterations
    # Fixed quantization scale (units per quantum).  None: derived per slab
    # from max |delta| (never clips); a float can saturate, and the drivers
    # then force a full refresh (see Engine.drive).
    scale: Any = None
    # Migration position codec dtype (torch.int16), or None: raw float32.
    migration: Any = None


def _lead_rows(x: torch.Tensor, lead: int) -> Tuple[Tuple[int, ...], int]:
    shape = tuple(x.shape[:lead])
    return shape, math.prod(shape)


def encode_full(slab: Slab) -> Tuple[Slab, Slab]:
    """Full refresh: payload is the raw slab; new reference = slab."""
    return slab, slab


def decode_full(payload: Slab) -> Tuple[Slab, Slab]:
    return payload, payload


def encode_delta(slab: Slab, ref: Slab, cfg: DeltaConfig, lead: int = 0
                 ) -> Tuple[Slab, Slab, torch.Tensor]:
    """Quantized-delta encode of the float attributes; the rest pass
    through.  Returns ``(payload, new_reference, overflow)``: the new
    reference equals the receiver's reconstruction, and ``overflow``
    (int32, shaped like the ``lead`` dims) counts the elements that
    saturated the quantized range before clipping (always 0 under the
    adaptive scale)."""
    payload: Slab = {}
    new_ref: Slab = {}
    overflow = None
    for name, x in slab.items():
        if not x.is_floating_point():
            payload[name] = x
            new_ref[name] = x
            continue
        lshape, b = _lead_rows(x, lead)
        q, s, oflow, nr = delta_codec.delta_encode(
            x.reshape(b, -1), ref[name].reshape(b, -1), qdtype=cfg.qdtype,
            scale=cfg.scale)
        payload[name] = q.reshape(x.shape)
        payload[name + "/scale"] = s.reshape(lshape)
        new_ref[name] = nr.reshape(x.shape)
        oflow = oflow.reshape(lshape)
        overflow = oflow if overflow is None else overflow + oflow
    if overflow is None:
        first = next(iter(slab.values()))
        overflow = torch.zeros(first.shape[:lead], dtype=torch.int32,
                               device=first.device)
    return payload, new_ref, overflow


def decode_delta(payload: Slab, ref: Slab, cfg: DeltaConfig, lead: int = 0
                 ) -> Tuple[Slab, Slab]:
    """Receiver-side inverse of :func:`encode_delta`."""
    out: Slab = {}
    for name, q in payload.items():
        if name.endswith("/scale"):
            continue
        if name + "/scale" in payload:
            r = ref[name]
            _, b = _lead_rows(r, lead)
            out[name] = delta_codec.delta_decode(
                q.reshape(b, -1), r.reshape(b, -1),
                payload[name + "/scale"].reshape(b)).reshape(r.shape)
        else:
            out[name] = q
    return out, dict(out)


def payload_bytes(payload: Slab, lead: int = 0) -> int:
    """Exact static wire bytes of one device's payload (the ``lead``
    device dims are not part of it)."""
    return sum(t.element_size() * math.prod(t.shape[lead:])
               for t in payload.values())


def migration_scale(half_range, qdtype) -> np.ndarray:
    """Per-axis quantum ``half_range / iinfo.max`` in float32."""
    return (np.asarray(half_range, np.float32)
            / np.float32(torch.iinfo(qdtype).max))


def _pos_rows(p: torch.Tensor, lead: int) -> torch.Tensor:
    _, b = _lead_rows(p, lead)
    return p.reshape(b, -1, p.shape[-1])


def encode_migration(slab: Slab, pos_name: str, center: torch.Tensor,
                     half_range, cfg: DeltaConfig, lsz=None, toroidal=(),
                     lead: int = 0) -> Tuple[Slab, torch.Tensor]:
    """Quantize the position entry of a migration payload as offsets from
    the sender's ``center`` (shaped ``lead dims + (D,)``), which rides the
    payload under ``pos_name + "/center"``; the minimum image with period
    ``lsz`` on toroidal axes first.  Returns ``(payload, overflow)``:
    coordinates of live slots that saturated the int16 range."""
    if cfg.migration != torch.int16:
        raise TypeError(f"migration codec dtype {cfg.migration}; the "
                        "kernel is int16")
    p = slab[pos_name]
    lshape, b = _lead_rows(p, lead)
    valid = slab.get("valid")
    q, oflow = delta_codec.migration_pos_encode(
        _pos_rows(p, lead), center.reshape(b, -1),
        migration_scale(half_range, cfg.migration),
        valid=None if valid is None else valid.reshape(b, -1),
        lsz=lsz, toroidal=toroidal, dead="mask")
    out = dict(slab)
    out[pos_name] = q.reshape(p.shape)
    out[pos_name + "/center"] = center
    return out, oflow.reshape(lshape)


def decode_migration(payload: Slab, pos_name: str, half_range,
                     cfg: DeltaConfig, lsz=None, toroidal=(),
                     lead: int = 0, at_l=None) -> Slab:
    """Receiver-side inverse of :func:`encode_migration`: positions in the
    sender's frame, wrapped into the domain on toroidal axes.  ``at_l``
    (D floats) replaces a wrapped coordinate equal to L, in the same
    launch (the engine's seam repair; None leaves it, as the reference)."""
    out = dict(payload)
    center = out.pop(pos_name + "/center")
    q = out[pos_name]
    _, b = _lead_rows(q, lead)
    out[pos_name] = delta_codec.migration_pos_decode(
        _pos_rows(q, lead), center.reshape(b, -1),
        migration_scale(half_range, cfg.migration), lsz=lsz,
        toroidal=toroidal, at_l=at_l).reshape(q.shape)
    return out


def zeros_like_slab(slab_spec: Slab) -> Slab:
    return {k: torch.zeros_like(v) for k, v in slab_spec.items()}
