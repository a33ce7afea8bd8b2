"""Mixture-of-Experts FFN with grouped, capacity-bounded token-choice
routing (port of ``repro/models/moe.py``, its single-device path).

Dispatch is grouped (GShard-style): each batch row is a group that routes
its S tokens independently with per-group capacity
C = ceil(k * S / E * cf).  Tokens pick their top-k experts (weights
renormalised); each expert serves at most C tokens a group, chosen by
router weight, and the overflow is dropped (Switch/GShard behaviour).

:func:`moe_apply_ep` is the reference's expert-parallel path over the LM
mesh (``distributed/collectives.py``): each rank routes its own tokens
(batch over the data axes, sequence over ``model``) with a capacity a
local token set, sends them to the experts' owners with one
``all_to_all`` over ``model`` and takes the results back with another
(:func:`_moe_shard_body`); where the sequence does not split over
``model`` (a decode step), each rank runs its local experts densely over
its tokens and the gated partials are summed over ``model``
(:func:`_moe_dense_decode_body`).  Outside an ``activation_sharding``
context, or where ``model`` does not divide the experts, it is
:func:`moe_apply`, as in the reference.  The expert products are
``einsum``s outside any Pallas kernel in the reference, and ``mm`` here.

Two choices keep the result independent of the device's scheduling:

* both top-k picks are a stable descending sort, so equal weights go to
  the lower index, as ``jax.lax.top_k`` does (``torch.topk`` promises no
  order among ties on CUDA).  The capacity pick ties on every zero of the
  gate, and among positive weights at the capacity edge the tie decides
  which token is dropped;
* the combine adds each token's contributions in increasing expert order,
  one bf16 (or float32) add at a time from zero, the order of the
  reference's scatter-add, instead of an atomic ``index_add_``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import mm
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor


def moe_spec(cfg: ArchConfig):
    d = cfg.d_model
    m = cfg.moe
    e, f = m.n_experts, m.expert_d_ff
    return {
        "router": ParamSpec((d, e), ("embed", "experts"), torch.float32),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_down": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed")),
    }


def capacity(cfg: ArchConfig, group_tokens: int) -> int:
    m = cfg.moe
    c = int(math.ceil(
        m.top_k * group_tokens / m.n_experts * m.capacity_factor))
    return max(1, min(max(c, 4), group_tokens))


def top_k(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The ``k`` largest along the last axis, largest first, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, cfg: ArchConfig, x: Tensor):
    """The router's float32 probabilities ``(B, S, E)``, each token's
    chosen experts ``(B, S, k)`` and the gate ``(B, S, E)``: their
    renormalised weights at the chosen experts, 0 elsewhere."""
    logits = mm("bsd,de->bse", x.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_i = top_k(probs, cfg.moe.top_k)
    topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)
    gate = torch.zeros_like(probs).scatter_(-1, topk_i, topk_p)
    return probs, topk_i, gate


def moe_apply(params, cfg: ArchConfig, x: Tensor) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  Groups = batch rows."""
    b, s, _ = x.shape
    dev = x.device

    probs, topk_i, gate = route(params, cfg, x)

    c = capacity(cfg, s)
    # per group, per expert: top-C tokens by gate weight
    w_ec, idx_ec = top_k(gate.transpose(1, 2), c)            # (B, E, C)
    live = w_ec > 0.0

    rows = torch.arange(b, device=dev)[:, None, None]
    xe = x[rows, idx_ec]                                     # (B, E, C, D)
    g = mm("becd,edf->becf", xe, params["w_gate"])
    u = mm("becd,edf->becf", xe, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    ye = mm("becf,efd->becd", h, params["w_down"])           # (B, E, C, D)
    ye = ye * (w_ec * live.float())[..., None].to(ye.dtype)

    return _combine(ye, idx_ec, live, topk_i), _aux(cfg, probs, topk_i)


def _combine(ye: Tensor, idx_ec: Tensor, live: Tensor, topk_i: Tensor
             ) -> Tensor:
    """The weighted expert outputs ``ye (B, E, C, D)`` of the slots
    ``idx_ec (B, E, C)`` (``live`` where kept) added back to token order
    ``(B, S, D)``: each token's kept slots in increasing expert order, one
    add at a time from zero.  A token holds at most one slot an expert
    (the C picks of an expert are distinct tokens)."""
    b, e, c, d = ye.shape
    s = topk_i.shape[1]
    dev = ye.device
    # slot[b, e, s]: the token's slot at expert e, or -1
    slot = torch.full((b, e, s), -1, dtype=torch.long, device=dev)
    slot.scatter_(2, idx_ec, torch.where(
        live, torch.arange(c, device=dev), -1))
    experts, _ = torch.sort(topk_i, dim=-1)                  # (B, S, k)
    kept = slot.transpose(1, 2).gather(-1, experts)          # (B, S, k)
    flat = ye.reshape(b, e * c, d)
    y = torch.zeros((b, s, d), dtype=ye.dtype, device=dev)
    for j in range(topk_i.shape[-1]):
        at = experts[..., j] * c + kept[..., j].clamp(min=0)
        part = flat.gather(1, at[..., None].expand(b, s, d))
        y = y + torch.where(kept[..., j, None] >= 0, part, 0)
    return y


def _aux(cfg: ArchConfig, probs: Tensor, topk_i: Tensor) -> Tensor:
    """The Switch-style load-balancing auxiliary loss over the tokens of
    ``probs (B, S, E)``."""
    m = cfg.moe
    e = m.n_experts
    me = probs.mean(dim=(0, 1))                              # (E,)
    assigned = torch.zeros(probs.shape, dtype=torch.float32,
                           device=probs.device)
    assigned.scatter_(-1, topk_i, 1.0)
    fe = assigned.mean(dim=(0, 1))
    return m.router_aux_weight * e * torch.sum(me * fe)


def _experts(xa: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor
             ) -> Tensor:
    """The SwiGLU experts over their tokens: ``xa (e, T, D)`` through
    ``w_* (e, D, F)`` / ``(e, F, D)``."""
    g = mm("ecd,edf->ecf", xa, w_gate)
    u = mm("ecd,edf->ecf", xa, w_up)
    h = F.silu(g.float()).to(xa.dtype) * u
    return mm("ecf,efd->ecd", h, w_down)


# ---------------------------------------------------------------------------
# Expert-parallel dispatch over the mesh (the reference's production path)
# ---------------------------------------------------------------------------

def _route_local(router: Tensor, cfg: ArchConfig, xt: Tensor):
    """Routing of one rank's tokens ``xt (T, D)`` as one group: the
    probabilities, top-k picks and gate ``(1, T, ...)`` of :func:`route`."""
    return route({"router": router}, cfg, xt[None])


def _moe_shard_body(x, router, w_gate, w_up, w_down, *, cfg: ArchConfig,
                    ep: int, fsdp_axes, model_axis: str, mesh):
    """One rank's part of :func:`moe_apply_ep`.

    x: ``(B_loc, S/ep, D)``, this rank's disjoint token slice (its batch
    block, its sequence block over ``model``); router ``(D, E)`` whole;
    ``w_*``: ``(E/ep, D, F)``, the rank's expert blocks.  The tokens are
    routed locally with capacity ``capacity(cfg, B_loc * S/ep)``, sent to
    their experts' owners by one ``all_to_all`` over ``model_axis`` and
    brought back by another; the aux loss is ``pmean``'d over
    ``model_axis`` and the data axes."""
    from repro_torch.distributed import collectives as col

    m = cfg.moe
    b, s, d = x.shape
    e = m.n_experts
    e_loc = e // ep
    t = b * s
    xt = x.reshape(t, d)
    probs, topk_i, gate = _route_local(router, cfg, xt)

    c = capacity(cfg, t)
    w_ec, idx_ec = top_k(gate.transpose(1, 2), c)            # (1, E, C)
    live = w_ec > 0.0
    xe = xt[idx_ec[0]]                                       # (E, C, D)
    xe = xe * live[0, ..., None].to(xe.dtype)

    # dispatch: (E, C, D) -> (ep, e_loc, C, D) --a2a--> (peer, e_loc, C, D)
    xa = col.all_to_all(xe.reshape(ep, e_loc, c, d), model_axis, mesh)
    xa = xa.transpose(0, 1).reshape(e_loc, ep * c, d)
    ya = _experts(xa, w_gate, w_up, w_down)                  # (e_loc, ep*C, D)

    # return: the inverse all_to_all -> (E, C, D) at the tokens' rank
    ya = ya.reshape(e_loc, ep, c, d).transpose(0, 1)
    ye = col.all_to_all(ya, model_axis, mesh).reshape(1, e, c, d)
    ye = ye * (w_ec * live.float())[..., None].to(ye.dtype)
    y = _combine(ye, idx_ec, live, topk_i)[0]

    aux = col.pmean(_aux(cfg, probs, topk_i),
                    (model_axis,) + tuple(fsdp_axes), mesh)
    return y.reshape(b, s, d), aux


def _moe_dense_decode_body(x, router, w_gate, w_up, w_down, *,
                           cfg: ArchConfig, ep: int, model_axis: str,
                           mesh, fsdp_axes=()):
    """The tiny-token path (decode): each rank runs its ``E/ep`` local
    experts densely over all of its tokens ``x (B_loc, S, D)`` and the
    gated partials are summed over ``model_axis`` in float32; no token is
    dropped."""
    from repro_torch.distributed import collectives as col

    m = cfg.moe
    b, s, d = x.shape
    e = m.n_experts
    e_loc = e // ep
    t = b * s
    xt = x.reshape(t, d)
    probs, topk_i, gate = _route_local(router, cfg, xt)
    lo = mesh.axis_index(model_axis) * e_loc
    gate_loc = gate[0, :, lo:lo + e_loc]                     # (T, e_loc)

    g = mm("td,edf->tef", xt, w_gate)
    u = mm("td,edf->tef", xt, w_up)
    h = F.silu(g.float()).to(xt.dtype) * u
    ye = mm("tef,efd->ted", h, w_down)                       # (T, e_loc, D)
    y = mm("ted,te->td", ye.float(), gate_loc)
    y = col.psum(y, model_axis, mesh).to(x.dtype)

    aux = col.pmean(_aux(cfg, probs, topk_i),
                    (model_axis,) + tuple(fsdp_axes), mesh)
    return y.reshape(b, s, d), aux


def moe_apply_ep(params, cfg: ArchConfig, x: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """Expert-parallel MoE over the active ``activation_sharding`` mesh;
    :func:`moe_apply` without one, or where the mesh's ``model`` axis is
    absent or does not divide the experts (the reference's fallbacks).

    On the mesh, ``x (B_loc, S, D)`` is this rank's batch block, whole
    along the sequence and the same on every ``model`` rank; the router
    is whole and the expert weights are this rank's ``(E/ep, D, F)``
    blocks.  Where ``S % ep == 0`` each rank takes its sequence block
    through :func:`_moe_shard_body` and the results are gathered over
    ``model``; otherwise :func:`_moe_dense_decode_body` runs on the whole
    block.  Returns the same ``(B_loc, S, D)`` on every ``model`` rank,
    and the aux loss averaged over the mesh."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shlib

    active = shlib.active()
    if active is None:
        return moe_apply(params, cfg, x)
    mesh, _ = active
    if "model" not in mesh.shape or cfg.moe.n_experts % mesh.shape["model"]:
        return moe_apply(params, cfg, x)

    ep = mesh.shape["model"]
    fsdp_axes = shlib.data_axes(mesh)
    s = x.shape[1]
    e_loc = cfg.moe.n_experts // ep
    w = [params[k] for k in ("w_gate", "w_up", "w_down")]
    if any(t.shape[0] != e_loc for t in w):
        raise ValueError(f"moe_apply_ep: expert blocks of "
                         f"{[tuple(t.shape) for t in w]}; the mesh's model "
                         f"axis of {ep} gives {e_loc} experts a rank")
    # the router sees disjoint tokens on each model rank: its gradient is
    # their sum over model
    router = col.grad_psum(params["router"], "model", mesh)
    if s % ep != 0:
        # decode / tiny sequences: dense local experts + psum; the
        # replicated tokens' gradient is the sum of the ranks' partials
        xin = col.grad_psum(x, "model", mesh)
        return _moe_dense_decode_body(
            xin, router, *w, cfg=cfg, ep=ep, model_axis="model", mesh=mesh,
            fsdp_axes=fsdp_axes)
    # tokens: batch over the data axes (this rank's block already),
    # sequence over model
    xs = col.scatter(x, "model", mesh, dim=1)
    y, aux = _moe_shard_body(xs, router, *w, cfg=cfg, ep=ep,
                             fsdp_axes=fsdp_axes, model_axis="model",
                             mesh=mesh)
    return col.all_gather(y, "model", mesh, dim=1), aux


def dropped_share(params, cfg: ArchConfig, x: Tensor) -> float:
    """The share of (token, expert) assignments that capacity drops over
    the batch: those ``moe_apply`` routes and does not serve."""
    _, _, gate = route(params, cfg, x)
    w_ec, _ = top_k(gate.transpose(1, 2), capacity(cfg, x.shape[1]))
    return 1.0 - int((w_ec > 0).sum()) / int((gate > 0).sum())
