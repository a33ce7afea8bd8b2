"""Public wrappers around the port's kernels (port of
``repro/kernels/ops.py``): attention of ``(B, H, S, hd)`` heads with GQA,
the legacy soft-sphere force sweep, the pair sweep of any law on gathered
neighbourhood slabs, and the delta codec on one ``(N, L)`` float32 slab
with one scalar scale and the TPU kernel's int8 range of ``+-127``.

The engine does not go through the codec wrappers; it calls
``core.delta``, which runs the same kernels over the stacked slabs of
every device."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import delta_codec, flash_attention, \
    neighbor_interaction


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q (B, H, Sq, hd); k/v (B, Hkv, Skv, hd).  GQA handled by repeating KV
    head groups, as the reference does."""
    b, h, sq, hd = q.shape
    hkv = k.shape[1]
    if hkv != h:
        rep = h // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    qf = q.reshape(b * h, sq, hd).contiguous()
    kf = k.reshape(b * h, k.shape[2], hd).contiguous()
    vf = v.reshape(b * h, v.shape[2], v.shape[3]).contiguous()
    out = flash_attention.flash_attention(qf, kf, vf, causal=causal)
    return out.reshape(b, h, sq, v.shape[3])


def neighbor_force(pos_i, diam_i, type_i, valid_i, gid_i,
                   pos_j, diam_j, type_j, valid_j, gid_j,
                   *, radius, repulsion, adhesion, same_type_only=True):
    """Soft-sphere force of ``(C, K)`` self slots against ``(C, NK)``
    neighbourhood slots -> ``(C, K, 2)`` float32."""
    return neighbor_interaction.neighbor_force(
        pos_i, diam_i, type_i, valid_i, gid_i,
        pos_j, diam_j, type_j, valid_j, gid_j,
        radius=radius, repulsion=repulsion, adhesion=adhesion,
        same_type_only=same_type_only)


def neighborhood_pair_sweep(
    attrs_i: Dict[str, torch.Tensor],
    attrs_j: Dict[str, torch.Tensor],
    valid_i: torch.Tensor,
    valid_j: torch.Tensor,
    *,
    pair_fn: Callable,
    radius: float,
    params: dict,
    box: Optional[Sequence[Optional[float]]] = None,
    block_cells: Optional[int] = None,
    interpret: Optional[bool] = None,
) -> Dict[str, torch.Tensor]:
    """The generic fused neighbourhood sweep on gathered slabs: self slots
    ``(C, K)`` against neighbourhood slots ``(C, NK)`` (``core.neighbors.
    gather_neighborhood``), ``pair_fn`` summed over the valid pairs of
    distinct agents within ``radius`` (minimum image on ``box``'s
    non-None axes); a dict of ``(C, K, *t)`` sums.  On the card a
    ``pair_fn`` without a device law raises ``NotImplementedError``
    (ROADMAP B1); on the CPU any ``pair_fn`` runs.  ``block_cells`` and
    ``interpret`` are the TPU kernel's knobs, taken and ignored."""
    del block_cells, interpret
    return neighbor_interaction.neighborhood_pair_sweep(
        attrs_i, attrs_j, valid_i, valid_j, pair_fn=pair_fn,
        radius=radius, params=params, box=box)


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
