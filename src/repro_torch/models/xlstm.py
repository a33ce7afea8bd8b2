"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, a sequential recurrence), following arXiv:2405.04517
(port of ``repro/models/xlstm.py``).

mLSTM is exponential-gated linear attention: a state C (P x P a head), a
normalizer n and a running log-stabilizer m.  The stabilized chunkwise
form keeps the gates, the state and the stabilizers in float32
(``m0 = -1e30``) and masks ``rel`` to ``-1e30`` above the diagonal before
its ``exp``; the chunk products take bfloat16-rounded operands and
accumulate in float32, the reference's accelerator branch (on XLA:CPU the
reference accumulates in bfloat16; with float32 weights the two agree to
~2e-7).  One token with a state takes the recurrence.

sLSTM keeps a scalar memory a channel with a block-diagonal recurrence and
is looped over time here.  When training over ``S % 64 == 0`` and ``S >
64`` steps, the loop runs as the reference's 64-step segments, each under
``torch.utils.checkpoint``: the backward keeps only the segments'
boundary states and outputs and recomputes a segment's steps (without
them it would hold ~20 (B, d) float32 tensors a step, ~8 GB a model at 4
x 2048).  The segments give the same values; a forward without grad runs
the plain loop.  No Pallas kernel of the reference covers either block.

xlstm-1.3b assembles 48 blocks, every ``slstm_every``-th an sLSTM and the
rest mLSTM (the published 7:1 mixing).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import mm, rmsnorm
from repro_torch.models.mamba2 import _conv as _causal_conv
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor

M0 = -1e30   # the stabilizer before any input, and the masked ``rel``


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    c: Tensor     # (B, H, P, P)
    n: Tensor     # (B, H, P)
    m: Tensor     # (B, H)
    conv: Tensor  # (B, dc-1, di)


def _mdims(cfg: ArchConfig):
    di = int(cfg.d_model * cfg.xlstm.proj_factor)
    h = cfg.n_heads
    p = di // h
    return di, h, p, cfg.xlstm.conv_kernel


def mlstm_spec(cfg: ArchConfig):
    d = cfg.d_model
    di, h, p, dc = _mdims(cfg)
    return {
        "w_up": ParamSpec((d, 2 * di), ("embed", "mlp")),
        "conv_w": ParamSpec((dc, di), ("conv", "mlp"), torch.float32,
                            "scaled"),
        "conv_b": ParamSpec((di,), ("mlp",), torch.float32, "zeros"),
        # block-diagonal per-head projections (xLSTM's BlockDiagonal)
        "wq": ParamSpec((h, p, p), ("heads", "head_dim", None)),
        "wk": ParamSpec((h, p, p), ("heads", "head_dim", None)),
        "wv": ParamSpec((h, p, p), ("heads", "head_dim", None)),
        "w_if": ParamSpec((di, 2 * h), ("mlp", "heads"), torch.float32),
        "b_if": ParamSpec((2 * h,), ("heads",), torch.float32, "zeros"),
        "lskip": ParamSpec((di,), ("mlp",), torch.float32, "ones"),
        "norm_scale": ParamSpec((di,), ("mlp",), torch.float32, "ones"),
        "w_down": ParamSpec((di, d), ("mlp", "embed")),
    }


def _bf16_mm(eq: str, a: Tensor, b: Tensor) -> Tensor:
    """``jnp.einsum(eq, a, b, preferred_element_type=float32)`` on operands
    rounded to bfloat16 where the reference rounds them: the products of
    bfloat16 values are exact in float32, so widening first and summing in
    float32 is the accelerator's result up to summation order."""
    return torch.einsum(eq, a.float(), b.float())


def _mlstm_chunk(carry, qc, kc, vc, lic, lfc, tri):
    """One chunk of the stabilized chunkwise mLSTM.  ``qc``, ``kc``, ``vc``
    in the input's type, the gates float32; returns the carried
    ``(c, n, m)`` and the chunk's output, bfloat16 ``(B, L, H, P)``."""
    c, n, m = carry
    f32, bf16 = torch.float32, torch.bfloat16
    cum = torch.cumsum(lfc, dim=1)                       # (B, L, H)
    total = cum[:, -1]                                   # (B, H)
    # log survival of j's write at the chunk's end
    w_end = total[:, None] - cum + lic                   # (B, L, H)
    m_c = torch.amax(w_end, dim=1)                       # (B, H)
    m_new = torch.maximum(m + total, m_c)
    sc_old = torch.exp(m + total - m_new)
    wj = torch.exp(w_end - m_new[:, None])               # (B, L, H)
    kwj = kc.to(f32) * wj[..., None]
    c_new = c * sc_old[..., None, None] + _bf16_mm(
        "blhp,blhq->bhpq", kwj.to(bf16), vc)
    n_new = n * sc_old[..., None] + kwj.sum(dim=1)
    # per-position stabilizers
    rel = cum[:, :, None, :] - cum[:, None, :, :] + lic[:, None]
    rel = rel.masked_fill(~tri[None, :, :, None], M0)
    m_i = torch.maximum(torch.amax(rel, dim=2), m[:, None] + cum)
    # intra-chunk
    sc_rel = torch.exp(rel - m_i[:, :, None])            # (B, L, L, H)
    scores = _bf16_mm("blhp,bjhp->bljh", qc, kc)
    weighted = scores * sc_rel
    num_intra = _bf16_mm("bljh,bjhq->blhq", weighted.to(bf16), vc)
    den_intra = weighted.sum(dim=2)
    # inter-chunk (the carried state)
    sc_i = torch.exp(m[:, None] + cum - m_i)             # (B, L, H)
    num_inter = _bf16_mm("blhp,bhpq->blhq", qc,
                         c.to(bf16)) * sc_i[..., None]
    den_inter = torch.einsum("blhp,bhp->blh", qc.to(f32), n) * sc_i
    num = num_intra + num_inter
    den = torch.maximum(torch.abs(den_intra + den_inter), torch.exp(-m_i))
    return (c_new, n_new, m_new), (num / den[..., None]).to(bf16)


def mlstm_apply(
    params,
    cfg: ArchConfig,
    xin: Tensor,                    # (B, S, D)
    state: Optional[MLSTMState] = None,
    chunk: int = 256,
) -> Tuple[Tensor, Optional[MLSTMState]]:
    """Returns ``(out, state)``: a new state when one was given, else
    None."""
    di, h, p, dc = _mdims(cfg)
    b, s, d = xin.shape

    up = mm("bsd,de->bse", xin, params["w_up"])
    xi, gate = up[..., :di], up[..., di:]
    xc, new_tail = _causal_conv(params, xi,
                                state.conv if state is not None else None)

    xch = xc.reshape(b, s, h, p)
    xih = xi.reshape(b, s, h, p)
    # ``* p ** -0.5`` with the scale in q's type, as JAX's weak typing
    q = mm("bshp,hpq->bshq", xch, params["wq"])
    q = q * float(torch.tensor(p ** -0.5, dtype=q.dtype))
    k = mm("bshp,hpq->bshq", xch, params["wk"])
    v = mm("bshp,hpq->bshq", xih, params["wv"])
    gates = mm("bse,eg->bsg", xc.float(), params["w_if"]) + params["b_if"]
    li = gates[..., :h]                                  # input gate (log)
    lf = F.logsigmoid(gates[..., h:])                    # forget gate (log)

    if s == 1 and state is not None:
        qf, kf, vf = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
        m_new = torch.maximum(state.m + lf[:, 0], li[:, 0])     # (B, H)
        decay = torch.exp(state.m + lf[:, 0] - m_new)
        w_in = torch.exp(li[:, 0] - m_new)
        c_new = state.c * decay[..., None, None] + torch.einsum(
            "bhp,bhq->bhpq", kf * w_in[..., None], vf)
        n_new = state.n * decay[..., None] + kf * w_in[..., None]
        num = torch.einsum("bhp,bhpq->bhq", qf, c_new)
        den = torch.abs(torch.einsum("bhp,bhp->bh", qf, n_new))
        den = torch.maximum(den, torch.exp(-m_new))[..., None]
        y = (num / den).reshape(b, 1, di)
        new_state = MLSTMState(c=c_new, n=n_new, m=m_new, conv=new_tail)
    else:
        l = min(chunk, s)
        assert s % l == 0, f"S={s} %% chunk {l}"
        dev = xin.device
        carry = (
            state.c if state is not None
            else torch.zeros((b, h, p, p), dtype=torch.float32, device=dev),
            state.n if state is not None
            else torch.zeros((b, h, p), dtype=torch.float32, device=dev),
            state.m if state is not None
            else torch.full((b, h), M0, dtype=torch.float32, device=dev),
        )
        tri = torch.ones((l, l), dtype=torch.bool, device=dev).tril()
        ys = []
        for c0 in range(0, s, l):
            sl = slice(c0, c0 + l)
            carry, y_c = _mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl],
                                      li[:, sl], lf[:, sl], tri)
            ys.append(y_c)
        y = torch.cat(ys, dim=1).reshape(b, s, di)
        new_state = (MLSTMState(*carry, conv=new_tail)
                     if state is not None else None)

    y = y.to(xin.dtype) + params["lskip"].to(xin.dtype) * xc
    y = y * F.silu(gate.float()).to(y.dtype)
    y = rmsnorm({"scale": params["norm_scale"]}, y)
    out = mm("bse,ed->bsd", y, params["w_down"])
    return out, new_state


def mlstm_init_state(cfg: ArchConfig, batch: int, device) -> MLSTMState:
    di, h, p, dc = _mdims(cfg)
    return MLSTMState(
        c=torch.zeros((batch, h, p, p), dtype=torch.float32, device=device),
        n=torch.zeros((batch, h, p), dtype=torch.float32, device=device),
        m=torch.full((batch, h), M0, dtype=torch.float32, device=device),
        conv=torch.zeros((batch, dc - 1, di), dtype=torch.bfloat16,
                         device=device),
    )


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: Tensor   # (B, d)
    n: Tensor   # (B, d)
    h: Tensor   # (B, d)
    m: Tensor   # (B, d)


def slstm_spec(cfg: ArchConfig):
    d = cfg.d_model
    h = cfg.n_heads
    p = d // h
    return {
        "w_gates": ParamSpec((d, 4 * d), ("embed", "mlp")),
        "r_gates": ParamSpec((h, p, 4 * p), ("heads", "head_dim", None),
                             torch.float32, "scaled"),
        "b_gates": ParamSpec((4 * d,), ("mlp",), torch.float32, "zeros"),
        "norm_scale": ParamSpec((d,), ("embed",), torch.float32, "ones"),
        "w_mlp_in": ParamSpec((d, 2 * d), ("embed", "mlp")),
        "w_mlp_out": ParamSpec((d, d), ("mlp", "embed")),
    }


def _slstm_step(st: SLSTMState, g_t: Tensor, r: Tensor) -> SLSTMState:
    """One time step: ``g_t`` (B, 4d) the input's gate pre-activations.
    The reference's operations, each once (``lf + m`` is formed once and
    used twice), with the recurrent product's four (B, H, P) splits added
    to the input's gates in one pass: a step is ~20 launches on the card,
    and the loop is host-bound."""
    b, d = st.h.shape
    h, p = r.shape[0], r.shape[1]
    gr = torch.matmul(st.h.view(b, h, p).transpose(0, 1), r)  # (H, B, 4P)
    # gate k, channel (h, p): g_t[b, k*d + h*P + p] + gr[h, b, k*P + p]
    pre = (g_t.view(b, 4, h, p)
           + gr.view(h, b, 4, p).permute(1, 2, 0, 3)).reshape(b, 4, d)
    z = torch.tanh(pre[:, 0])
    li = pre[:, 1]                                       # log input gate
    lf_m = F.logsigmoid(pre[:, 2]) + st.m                # log forget + m
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(lf_m, li)
    ig = torch.exp(li - m_new)
    fg = torch.exp(lf_m - m_new)
    c_new = fg * st.c + ig * z
    n_new = fg * st.n + ig
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return SLSTMState(c=c_new, n=n_new, h=h_new, m=m_new)


SLSTM_SEGMENT = 64   # steps a checkpointed segment when training


def _slstm_scan(st: SLSTMState, gx: Tensor, r: Tensor):
    """The recurrence over time (the reference's ``lax.scan``): the final
    state and every step's ``h``, (B, S, d); in checkpointed segments of
    :data:`SLSTM_SEGMENT` steps when training (module docstring)."""
    s, seg = gx.shape[1], SLSTM_SEGMENT
    training = torch.is_grad_enabled() and (
        gx.requires_grad or r.requires_grad
        or any(a.requires_grad for a in st))
    if not (training and s % seg == 0 and s > seg):
        return _slstm_steps(st, gx, r)
    hs = []
    for t0 in range(0, s, seg):
        st, h = checkpoint(_slstm_steps, st, gx[:, t0:t0 + seg], r,
                           use_reentrant=False)
        hs.append(h)
    return st, torch.cat(hs, dim=1)


def _slstm_steps(st: SLSTMState, gx: Tensor, r: Tensor):
    """The time loop over ``gx``'s steps."""
    hs = []
    for t in range(gx.shape[1]):
        st = _slstm_step(st, gx[:, t], r)
        hs.append(st.h)
    return st, torch.stack(hs, dim=1)


def slstm_apply(
    params,
    cfg: ArchConfig,
    xin: Tensor,
    state: Optional[SLSTMState] = None,
) -> Tuple[Tensor, Optional[SLSTMState]]:
    """Returns ``(out, state)``: a new state when one was given, else
    None.  The recurrence is a Python loop over time (ROADMAP item 11: a
    fused recurrence is a later speed item)."""
    b, s, d = xin.shape
    gx = mm("bsd,dg->bsg", xin.float(), params["w_gates"].float()
            ) + params["b_gates"]
    st = state if state is not None else slstm_init_state(cfg, b,
                                                          xin.device)
    st, hs = _slstm_scan(st, gx, params["r_gates"])
    y = hs.to(xin.dtype)                                 # (B, S, d)
    y = rmsnorm({"scale": params["norm_scale"]}, y)
    u = mm("bsd,de->bse", y, params["w_mlp_in"])
    u1, u2 = u.chunk(2, dim=-1)                          # GeGLU halves
    z = F.gelu(u1.float(), approximate="tanh").to(u2.dtype) * u2
    out = mm("bsd,de->bse", z, params["w_mlp_out"])
    return out, (st if state is not None else None)


def slstm_init_state(cfg: ArchConfig, batch: int, device) -> SLSTMState:
    d = cfg.d_model

    def zeros():
        return torch.zeros((batch, d), dtype=torch.float32, device=device)

    return SLSTMState(c=zeros(), n=zeros(), h=zeros(),
                      m=torch.full((batch, d), M0, dtype=torch.float32,
                                   device=device))
