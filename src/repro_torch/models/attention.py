"""GQA attention: the chunked online softmax, decode, and the projections
with rope and the KV cache; and MLA (port of ``repro/models/attention.py``).

Two execution paths share one math definition:

* ``chunked`` (the default): a loop over KV blocks with online softmax,
  plain PyTorch, as the reference's ``lax.scan``;
* ``kernel``: ``kernels.flash_attention``, the hand-written CUDA kernel
  that replaces the reference's Pallas one (its ``backend="pallas"``).

Decode (one query token against the cache) is a single-shot softmax.  The
casts mirror the reference's, on which bfloat16 parity depends: ``q`` is
scaled in its own type, scores are float32 after a product in the input
type, and ``p`` is cast to ``v``'s type before the PV product.  The
reference's ``constrain`` calls are sharding hints that change no value
(``distributed.sharding.constrain`` is the identity: over an LM mesh the
port places activations itself) and have no call here.  MLA (:func:`mla_apply`) runs on the plain
paths only, as in the reference.
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
    returned are the ones passed in.  A prefill into the cache (``S > 1``
    from index 0) attends over the prompt as the reference does, through
    the kernel where ``backend="kernel"`` (the reference's prefill always
    runs the chunked path; the two compute the same causal attention)."""
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
        elif backend == "kernel":   # prefill into cache on the kernel
            if cache_index != 0:
                raise ValueError("a prefill on the kernel starts at cache "
                                 f"index 0, not {cache_index}")
            out = kernel_ops.flash_attention_bhsd(q, k, v, causal=cfg.causal)
        else:       # prefill into cache
            out = sdpa_chunked(q, k, v, cfg.causal, q_offset=0, chunk=chunk)
    elif backend == "kernel":
        out = kernel_ops.flash_attention_bhsd(q, k, v, causal=cfg.causal)
    else:
        out = sdpa_chunked(q, k, v, cfg.causal, chunk=chunk)
    y = mm("bhsk,hkd->bsd", out, params["wo"])
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA: Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

def mla_spec(cfg: ArchConfig):
    d, h = cfg.d_model, cfg.n_heads
    m = cfg.mla
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_down": ParamSpec((d, m.q_lora_rank), ("embed", "lora")),
        "wq_up": ParamSpec((m.q_lora_rank, h, qk_hd),
                           ("lora", "heads", "head_dim")),
        "wkv_down": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                              ("embed", "lora")),
        "wk_up": ParamSpec((m.kv_lora_rank, h, m.qk_nope_head_dim),
                           ("lora", "heads", "head_dim")),
        "wv_up": ParamSpec((m.kv_lora_rank, h, m.v_head_dim),
                           ("lora", "heads", "head_dim")),
        "wo": ParamSpec((h, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


def mla_apply(
    params,
    cfg: ArchConfig,
    x: Tensor,                              # (B, S, D)
    positions: Tensor,
    cache: Optional[Tensor] = None,         # latent cache (B, T, r + rope)
    cache_index: Optional[int] = None,
    length_mask: Optional[Tensor] = None,   # (B, T) for decode
    backend: str = "chunked",
    chunk: int = 512,
):
    """MLA: the cache holds only the compressed latent and the rope keys,
    written in place, up-projected per use.  Returns ``(y, cache)``.

    With a cache, one query token (``s == 1``) takes the absorbed decode:
    ``wk_up`` folded into the query and ``wv_up`` into the output, so the
    scores and the context are taken against the latent cache itself.
    Everything else up-projects K and V and runs ``sdpa_chunked`` (a
    prefill attends over the whole cache, causally); as in the reference,
    ``backend`` selects nothing here: no kernel runs MLA."""
    if backend not in BACKENDS:
        raise ValueError(f"attention backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    r = m.kv_lora_rank

    cq = mm("bsd,dr->bsr", x, params["wq_down"])
    q = mm("bsr,rhk->bhsk", cq, params["wq_up"])
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    ckv = mm("bsd,dr->bsr", x, params["wkv_down"])          # (B, S, r+rope)
    latent, k_rope_flat = ckv[..., :r], ckv[..., r:]
    k_rope = rope(k_rope_flat[:, None], positions, cfg.rope_theta)

    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    if cache is not None:
        packed = torch.cat([latent, k_rope[:, 0]], dim=-1)  # (B, S, r+rope)
        cache[:, cache_index:cache_index + s] = packed.to(cache.dtype)
        latent_all = cache[..., :r].to(x.dtype)
        k_rope_all = cache[:, None, :, r:].to(x.dtype)
    else:
        latent_all, k_rope_all = latent, k_rope
    t = latent_all.shape[1]

    if s == 1 and cache is not None:
        # the absorbed decode: K and V are never materialized
        q_abs = mm("bhsk,rhk->bhsr", q_nope, params["wk_up"])
        s_nope = mm("bhsr,btr->bhst", q_abs, latent_all)
        s_rope = mm("bhsk,btk->bhst", q_rope, k_rope_all[:, 0])
        logits = (s_nope + s_rope).float() * scale
        lm = length_mask if length_mask is not None else torch.ones(
            (b, t), dtype=torch.bool, device=x.device)
        logits = logits.masked_fill(~lm[:, None, None, :], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = mm("bhst,btr->bhsr", probs, latent_all)
        out = mm("bhsr,rhk->bhsk", ctx, params["wv_up"])
        return mm("bhsk,hkd->bsd", out, params["wo"]), cache

    k_nope = mm("btr,rhk->bhtk", latent_all, params["wk_up"])
    vv = mm("btr,rhk->bhtk", latent_all, params["wv_up"])
    k_full = torch.cat([k_nope, k_rope_all.expand(b, h, t,
                                                  m.qk_rope_head_dim)],
                       dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = sdpa_chunked(q_full, k_full, vv, cfg.causal, chunk=chunk,
                       scale=scale)
    return mm("bhsk,hkd->bsd", out, params["wo"]), cache
