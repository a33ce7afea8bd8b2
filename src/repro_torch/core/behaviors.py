"""Agent behaviours - the user-facing modelling API (port of part of
``repro/core/behaviors.py``).

A :class:`Behavior` is a pair-interaction kernel plus a pointwise update,
and behaviours form a composition algebra: :func:`compose` (alias
``Behavior.stack``) merges several into one - schemas unioned, every pair
kernel over the same neighbourhood (each gated to its own radius),
accumulators namespaced ``b{i}.``, updates chained in order.
``compose(b)`` of one behaviour is bit-exact with ``b``.  The mechanics
shared by the biology-flavoured sims (:func:`soft_repulsion_adhesion`,
:func:`displacement_update`) are here too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import prng
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


def _merge_schemas(behaviors: Tuple[Behavior, ...]) -> AgentSchema:
    spec: Dict[str, Tuple[Tuple[int, ...], object]] = {}
    for b in behaviors:
        for name, shape, dtype in b.schema.fields:
            if name in spec and spec[name] != (shape, dtype):
                raise ValueError(
                    f"compose: attribute {name!r} declared with conflicting "
                    f"specs {spec[name]} vs {(shape, dtype)}")
            spec[name] = (shape, dtype)
    return AgentSchema.create(spec)


def _broadcast_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    while mask.dim() < like.dim():
        mask = mask[..., None]
    return mask


def compose(*behaviors: Behavior) -> Behavior:
    """Merge several behaviours into one (BioDynaMo's per-agent behaviour
    list), with the reference's semantics:

    * schema: the union of the sub-schemas (conflicting specs raise);
    * pair kernels: all over one neighbourhood at the largest radius; a
      narrower one's contributions are gated to ``dist2 <=
      float32(radius**2)``; accumulators are namespaced ``b{i}.{name}``
      and un-namespaced before each update;
    * updates: chained in order, update ``i`` seeing the attribute writes
      of updates ``< i``; alive masks AND together, spawn masks OR, a
      later child winning a contested slot, and a child completed to the
      union schema from the parent's current attributes; behaviour 0
      gets the step key unchanged, behaviour ``i > 0`` ``fold_in(key,
      i)``;
    * params: each sub-kernel closes over its own; the merged dict
      (namespaced the same way) is for introspection.

    The merged pair function carries its parts, ``(pair_fn, radius,
    params)`` of each behaviour, as ``pair.parts`` and the gathered radius
    as ``pair.radius``: the ``pair_sweep`` kernel runs a stack as one
    sweep from them.
    """
    behs = tuple(behaviors)
    if not behs:
        raise ValueError("compose() needs at least one Behavior")
    for b in behs:
        if not isinstance(b, Behavior):
            raise TypeError(f"compose() takes Behaviors, got {type(b)!r}")

    schema = _merge_schemas(behs)
    radius = max(float(b.radius) for b in behs)
    pair_attrs = tuple(sorted({a for b in behs for a in b.pair_attrs}))
    can_spawn = any(b.can_spawn for b in behs)
    params = {f"b{i}.{k}": v
              for i, b in enumerate(behs) for k, v in b.params.items()}
    acc_spec = {f"b{i}.{k}": v
                for i, b in enumerate(behs) for k, v in b.acc_spec.items()}

    def pair(attrs_i, attrs_j, disp, dist2, _params):
        out: Dict[str, torch.Tensor] = {}
        for i, b in enumerate(behs):
            sub = b.pair_fn(attrs_i, attrs_j, disp, dist2, b.params)
            gate = None
            if float(b.radius) < radius:
                gate = dist2 <= _f32(float(b.radius) ** 2, dist2)
            for k, v in sub.items():
                if gate is not None:
                    v = torch.where(_broadcast_mask(gate, v), v,
                                    torch.zeros_like(v))
                out[f"b{i}.{k}"] = v
        return out

    pair.parts = tuple((b.pair_fn, float(b.radius), b.params) for b in behs)
    pair.radius = radius

    def update(attrs, valid, acc, key, _params, dt):
        cur = dict(attrs)
        alive = valid
        spawn = torch.zeros_like(valid)
        child: Optional[Dict[str, torch.Tensor]] = None
        for i, b in enumerate(behs):
            pfx = f"b{i}."
            acc_i = {k[len(pfx):]: v for k, v in acc.items()
                     if k.startswith(pfx)}
            ki = key if i == 0 else prng.fold_in(key, i)
            cur, alive_i, spawn_i, child_i = b.update_fn(
                cur, valid, acc_i, ki, b.params, dt)
            cur = dict(cur)
            alive = alive & alive_i
            if b.can_spawn and child_i is not None:
                child_i = {**cur, **child_i}
                if child is None:
                    child, spawn = child_i, spawn_i
                else:
                    child = {k: torch.where(
                        _broadcast_mask(spawn_i, child_i[k]),
                        child_i[k], child[k]) for k in child}
                    spawn = spawn | spawn_i
        return cur, alive, spawn, child

    return Behavior(
        schema=schema, pair_fn=pair, pair_attrs=pair_attrs,
        update_fn=update, radius=radius, params=params,
        can_spawn=can_spawn, acc_spec=acc_spec, children=behs)


Behavior.stack = staticmethod(compose)


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
    gate = torch.where(_f32(params.get("same_type_only", 1.0), dist2) > 0,
                       same, torch.ones_like(same))
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
