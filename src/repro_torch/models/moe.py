"""Mixture-of-Experts FFN with grouped, capacity-bounded token-choice
routing (port of ``repro/models/moe.py``, its single-device path).

Dispatch is grouped (GShard-style): each batch row is a group that routes
its S tokens independently with per-group capacity
C = ceil(k * S / E * cf).  Tokens pick their top-k experts (weights
renormalised); each expert serves at most C tokens a group, chosen by
router weight, and the overflow is dropped (Switch/GShard behaviour).

The reference's ``moe_apply_ep`` returns ``moe_apply`` when no sharding
context is active, which is always the case on one device; its
expert-parallel ``shard_map``/``all_to_all`` path waits for the LM mesh
(ROADMAP A12).  The expert products are ``einsum``s outside any Pallas
kernel in the reference, and ``mm`` here.

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
    m = cfg.moe
    b, s, d = x.shape
    e = m.n_experts
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

    # combine: each token's kept slots, in increasing expert order.  A
    # token holds at most one slot an expert (the C picks of an expert are
    # distinct tokens); slot[b, e, s] is that slot, or -1.
    slot = torch.full((b, e, s), -1, dtype=torch.long, device=dev)
    slot.scatter_(2, idx_ec, torch.where(
        live, torch.arange(c, device=dev), -1))
    experts, _ = torch.sort(topk_i, dim=-1)                  # (B, S, k)
    kept = slot.transpose(1, 2).gather(-1, experts)          # (B, S, k)
    flat = ye.reshape(b, e * c, d)
    y = torch.zeros((b, s, d), dtype=ye.dtype, device=dev)
    for j in range(m.top_k):
        at = experts[..., j] * c + kept[..., j].clamp(min=0)
        part = flat.gather(1, at[..., None].expand(b, s, d))
        y = y + torch.where(kept[..., j, None] >= 0, part, 0)

    # Switch-style load-balancing auxiliary loss.
    me = probs.mean(dim=(0, 1))                              # (E,)
    assigned = torch.zeros((b, s, e), dtype=torch.float32, device=dev)
    assigned.scatter_(-1, topk_i, 1.0)
    fe = assigned.mean(dim=(0, 1))
    aux = m.router_aux_weight * e * torch.sum(me * fe)
    return y, aux


def dropped_share(params, cfg: ArchConfig, x: Tensor) -> float:
    """The share of (token, expert) assignments that capacity drops over
    the batch: those ``moe_apply`` routes and does not serve."""
    _, _, gate = route(params, cfg, x)
    w_ec, _ = top_k(gate.transpose(1, 2), capacity(cfg, x.shape[1]))
    return 1.0 - int((w_ec > 0).sum()) / int((gate > 0).sum())
