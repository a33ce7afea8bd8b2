"""Agent behaviours - the user-facing modelling API (port of part of
``repro/core/behaviors.py``).

A :class:`Behavior` is a pair-interaction kernel plus a pointwise update.
This slice ports the mechanics shared by the biology-flavoured sims
(:func:`soft_repulsion_adhesion`, :func:`displacement_update`).
``compose`` comes with the ``sir_mechanics`` slice and the spawn path with
the RNG slice (ROADMAP A5): the engine raises on ``can_spawn=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.agent_soa import AgentSchema, POS
from repro_torch.core.neighbors import PairFn

# update(attrs, valid, acc, key, params, dt) ->
#   (new_attrs, alive_mask, spawn_mask, child_attrs_or_None)
UpdateFn = Callable[..., Tuple[Dict[str, torch.Tensor], torch.Tensor,
                               torch.Tensor,
                               Optional[Dict[str, torch.Tensor]]]]


@dataclasses.dataclass(frozen=True, eq=False)
class Behavior:
    """A full agent behaviour: local interaction + pointwise update."""

    schema: AgentSchema
    pair_fn: PairFn                      # neighbour contribution kernel
    pair_attrs: Tuple[str, ...]          # attrs the pair kernel reads
    update_fn: UpdateFn                  # pointwise state transition
    radius: float                        # max interaction distance
    params: dict = dataclasses.field(default_factory=dict)
    can_spawn: bool = False              # statically enables the spawn path
    acc_spec: Dict[str, Tuple[Tuple[int, ...], object]] = dataclasses.field(
        default_factory=dict)
    max_displacement: Optional[float] = None
    children: Tuple["Behavior", ...] = ()


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device (as JAX's weakly typed Python
    floats become float32 in float32 arithmetic)."""
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def soft_repulsion_adhesion(attrs_i, attrs_j, disp, dist2, params):
    """BioDynaMo-style mechanical force: short-range soft-sphere repulsion
    plus type-aware adhesion within the interaction radius.

    Expects attrs to carry ``diameter`` (float) and ``ctype`` (int32).
    ``params``: repulsion, adhesion, same_type_only (0/1).  The CUDA
    ``pair_sweep`` kernel has this law as a device function.
    """
    dist = torch.sqrt(dist2 + _f32(1e-6, dist2))
    unit = disp / dist[..., None]
    r_sum = _f32(0.5, dist2) * (attrs_i["diameter"] + attrs_j["diameter"])
    overlap = r_sum - dist
    zero = _f32(0.0, dist2)
    rep = torch.where(overlap > 0, _f32(params["repulsion"], dist2) * overlap,
                      zero)
    same = (attrs_i["ctype"] == attrs_j["ctype"]).to(torch.float32)
    gate = same if float(params.get("same_type_only", 1.0)) > 0 \
        else torch.ones_like(same)
    adh = torch.where(overlap <= 0, _f32(params["adhesion"], dist2) * gate,
                      zero)
    force = (rep - adh)[..., None] * unit  # + pushes apart, - pulls together
    return {"force": -force}  # force ON i points from j towards i


def displacement_update(attrs, valid, acc, key, params, dt):
    """Overdamped dynamics: dx = F * dt, speed-clamped to < one NSG cell.
    Draws no random numbers (``key`` is unused)."""
    f = acc["force"]
    norm = torch.sqrt((f * f).sum(dim=-1, keepdim=True) + _f32(1e-12, f))
    step = f * torch.minimum(_f32(params["max_step"], f) / norm, _f32(dt, f))
    new = dict(attrs)
    new[POS] = attrs[POS] + torch.where(valid[..., None], step,
                                        _f32(0.0, f))
    alive = valid
    spawn = torch.zeros_like(valid)
    return new, alive, spawn, None
