"""GQA attention: the chunked online softmax, decode, and the projections
with rope and the KV cache (port of ``repro/models/attention.py``).

Two execution paths share one math definition:

* ``chunked`` (the default): a loop over KV blocks with online softmax,
  plain PyTorch, as the reference's ``lax.scan``;
* ``kernel``: ``kernels.flash_attention``, the hand-written CUDA kernel
  that replaces the reference's Pallas one (its ``backend="pallas"``).

Decode (one query token against the cache) is a single-shot softmax.  The
casts mirror the reference's, on which bfloat16 parity depends: ``q`` is
scaled in its own type, scores are float32 after a product in the input
type, and ``p`` is cast to ``v``'s type before the PV product.  The
reference's ``constrain`` calls are sharding hints, a no-op on one device,
and have no counterpart here.  MLA comes with ROADMAP A12.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import mm, rope
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor

NEG_INF = -1e30
BACKENDS = ("chunked", "kernel")


# ---------------------------------------------------------------------------
# Core scaled-dot-product with GQA head grouping
# ---------------------------------------------------------------------------

def _group_heads(q: Tensor, n_kv: int) -> Tensor:
    """(B, Hq, S, hd) -> (B, Hkv, G, S, hd)."""
    b, hq, s, hd = q.shape
    return q.reshape(b, n_kv, hq // n_kv, s, hd)


def _scaled(q: Tensor, scale: float) -> Tensor:
    """``q * jnp.asarray(scale, q.dtype)``: the scale rounded to q's type
    (on the host: a device scalar would cost a copy and a wait)."""
    return q * float(torch.tensor(scale, dtype=q.dtype))


def sdpa_chunked(
    q: Tensor,           # (B, Hq, Sq, hd)
    k: Tensor,           # (B, Hkv, Skv, hd)
    v: Tensor,           # (B, Hkv, Skv, hdv)
    causal: bool,
    q_offset: int = 0,
    chunk: int = 512,
    scale: Optional[float] = None,
) -> Tensor:
    """Online-softmax attention, looping over KV in blocks (flash-style)."""
    b, hq, sq, hd = q.shape
    _, hkv, skv, _ = k.shape
    hdv = v.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5

    chunk = min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"Skv={skv} not divisible by chunk={chunk}")

    dev = q.device
    qg = _scaled(_group_heads(q, hkv), scale)
    q_pos = q_offset + torch.arange(sq, device=dev)

    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, hdv), dtype=torch.float32, device=dev)
    for start in range(0, skv, chunk):
        kc = k[:, :, start:start + chunk]
        vc = v[:, :, start:start + chunk]
        s = mm("bhgqd,bhkd->bhgqk", qg, kc).float()
        if causal:
            k_pos = start + torch.arange(chunk, device=dev)
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + mm(
            "bhgqk,bhkd->bhgqd", p.to(v.dtype), vc).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, hdv).to(q.dtype)


def sdpa_decode(
    q: Tensor,            # (B, Hq, 1, hd)
    k: Tensor,            # (B, Hkv, S, hd)
    v: Tensor,            # (B, Hkv, S, hdv)
    length_mask: Tensor,  # (B, S) bool: valid cache positions
    scale: Optional[float] = None,
) -> Tensor:
    """Single-shot decode attention."""
    b, hq, _, hd = q.shape
    hkv = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    qg = _scaled(_group_heads(q, hkv), scale)
    s = mm("bhgqd,bhkd->bhgqk", qg, k).float()
    s = s.masked_fill(~length_mask[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = mm("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)
    return out.reshape(b, hq, 1, v.shape[-1])


# ---------------------------------------------------------------------------
# GQA attention block (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------

def gqa_spec(cfg: ArchConfig):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamSpec((d, hq, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((hq, hd, d), ("heads", "head_dim", "embed")),
    }


def gqa_apply(
    params,
    cfg: ArchConfig,
    x: Tensor,                     # (B, S, D)
    positions: Tensor,             # (S,) or (B, S)
    cache: Optional[Tuple[Tensor, Tensor]] = None,  # (k, v): (B, Hkv, T, hd)
    cache_index: Optional[int] = None,              # write offset
    length_mask: Optional[Tensor] = None,           # (B, T) for decode
    backend: str = "chunked",
    chunk: int = 512,
):
    """Returns ``(y, cache)``.  A cache is written in place (the reference
    returns an updated copy, ``dynamic_update_slice``); the tensors
    returned are the ones passed in."""
    if backend not in BACKENDS:
        raise ValueError(f"attention backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    q = mm("bsd,dhk->bhsk", x, params["wq"])
    k = mm("bsd,dhk->bhsk", x, params["wk"])
    v = mm("bsd,dhk->bhsk", x, params["wv"])
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        ck, cv = cache
        s = x.shape[1]
        ck[:, :, cache_index:cache_index + s] = k.to(ck.dtype)
        cv[:, :, cache_index:cache_index + s] = v.to(cv.dtype)
        new_cache = (ck, cv)
        if s == 1:  # decode
            out = sdpa_decode(q, ck, cv, length_mask)
        else:       # prefill into cache
            out = sdpa_chunked(q, k, v, cfg.causal, q_offset=0, chunk=chunk)
    elif backend == "kernel":
        out = kernel_ops.flash_attention_bhsd(q, k, v, causal=cfg.causal)
    else:
        out = sdpa_chunked(q, k, v, cfg.causal, chunk=chunk)
    y = mm("bhsk,hkd->bsd", out, params["wo"])
    return y, new_cache


def mla_spec(cfg: ArchConfig):
    raise NotImplementedError(
        "MLA attention is not ported yet (ROADMAP A12)")


def mla_apply(*args, **kwargs):
    raise NotImplementedError(
        "MLA attention is not ported yet (ROADMAP A12)")
