"""Mamba2 (State-Space Duality) block: the chunked-parallel scoring and
prefill path and a one-token recurrence for decode (port of
``repro/models/mamba2.py``).

The block: an in-projection to (z, x, B, C, dt), a short causal depthwise
conv on (x, B, C), SSD state-space mixing with a scalar decay A per head,
and a gated (SiLU(z)) RMS-normed out-projection.  The chunked scan carries
the (H, P, N) state over chunks of the sequence.

The casts are the reference's: the conv sums its taps in the input's type,
in order, and applies SiLU in float32; the scan runs in float32; the output
is cast back before the gate, the norm and ``w_out``.

One difference, on purpose (ROADMAP §C 11).  The reference forms the
intra-chunk decay as ``exp(cum_i - cum_j) * tril``.  Above the diagonal
``cum_i - cum_j`` is positive and, at a chunk of 256 with the zero-init
``dt_bias`` and ``a_log``, overflows ``exp`` to ``inf``; ``inf * 0`` is NaN.
The port masks first: ``exp`` of ``cum_i - cum_j`` where ``i >= j``, 0
elsewhere.  Where the reference's values are finite the two are the same
products.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import mm, rmsnorm
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor


class Mamba2State(NamedTuple):
    ssm: Tensor    # (B, H, P, N) carried SSD state, float32
    conv: Tensor   # (B, d_conv-1, d_inner + 2*N) conv tail cache


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = s.n_heads
    p = d_inner // n_heads
    return d_inner, n_heads, p, s.d_state, s.d_conv, s.chunk


def mamba2_spec(cfg: ArchConfig):
    d = cfg.d_model
    di, h, p, n, dc, _ = _dims(cfg)
    conv_ch = di + 2 * n
    return {
        "w_in": ParamSpec((d, 2 * di + 2 * n + h), ("embed", "mlp")),
        "conv_w": ParamSpec((dc, conv_ch), ("conv", "mlp"), torch.float32,
                            "scaled"),
        "conv_b": ParamSpec((conv_ch,), ("mlp",), torch.float32, "zeros"),
        "a_log": ParamSpec((h,), ("heads",), torch.float32, "zeros"),
        "dt_bias": ParamSpec((h,), ("heads",), torch.float32, "zeros"),
        "d_skip": ParamSpec((h,), ("heads",), torch.float32, "ones"),
        "norm_scale": ParamSpec((di,), ("mlp",), torch.float32, "ones"),
        "w_out": ParamSpec((di, d), ("mlp", "embed")),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: Tensor):
    di, h, p, n, _, _ = _dims(cfg)
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    bb = zxbcdt[..., 2 * di:2 * di + n]
    cc = zxbcdt[..., 2 * di + n:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, x, bb, cc, dt


def _conv(params, u: Tensor, tail: Optional[Tensor]) -> Tuple[Tensor,
                                                              Tensor]:
    """Causal depthwise conv over (B, S, C) with a cached tail for decode.
    A tail of another type is promoted with ``u`` as ``jnp.concatenate``
    does (a bfloat16 cache after float32 inputs becomes float32), and the
    new tail keeps that type; the output has ``u``'s.  mLSTM's
    ``_causal_conv`` is this function (the reference has two equal
    copies)."""
    dc = params["conv_w"].shape[0]
    if tail is None:
        tail = torch.zeros((u.shape[0], dc - 1, u.shape[-1]), dtype=u.dtype,
                           device=u.device)
    t = torch.promote_types(tail.dtype, u.dtype)
    ext = torch.cat([tail.to(t), u.to(t)], dim=1)           # (B, S+dc-1, C)
    w = params["conv_w"].to(u.dtype).to(t)                  # (dc, C)
    s = u.shape[1]
    out = ext[:, 0:s] * w[0]                 # the taps summed in order
    for i in range(1, dc):
        out = out + ext[:, i:i + s] * w[i]
    out = out + params["conv_b"].to(u.dtype).to(t)
    new_tail = ext[:, ext.shape[1] - (dc - 1):].clone()   # not a view of ext
    return F.silu(out.float()).to(u.dtype), new_tail


def _ssd_chunk(ssm, dac, dtc, xc, bc, ccc, tri):
    """One chunk of the SSD scan (float32): returns the carried state and
    the chunk's output ``(B, L, H, P)``."""
    cum = torch.cumsum(dac, dim=1)                          # (B, L, H)
    # intra-chunk "attention": decay(i <- j) = exp(cum_i - cum_j), i >= j
    rel = cum[:, :, None, :] - cum[:, None, :, :]           # (B, L, L, H)
    seg = torch.exp(rel.masked_fill(~tri[None, :, :, None], -torch.inf))
    scores = torch.einsum("bin,bjn->bij", ccc, bc)          # (B, L, L)
    w = scores[..., None] * seg * dtc[:, None]              # (B, L, L, H)
    y_intra = torch.einsum("bijh,bjhp->bihp", w, xc)
    # inter-chunk: the carried state's contribution
    y_inter = torch.einsum("bin,bhpn,bih->bihp", ccc, ssm, torch.exp(cum))
    # state update: decay the whole chunk, inject its outer products
    tail_decay = torch.exp(cum[:, -1:, :] - cum)            # (B, L, H)
    inject = torch.einsum("blh,blhp,bln->bhpn", dtc * tail_decay, xc, bc)
    ssm_new = ssm * torch.exp(cum[:, -1])[..., None, None] + inject
    return ssm_new, y_intra + y_inter


def mamba2_apply(
    params,
    cfg: ArchConfig,
    xin: Tensor,                     # (B, S, D)
    state: Optional[Mamba2State] = None,
) -> Tuple[Tensor, Optional[Mamba2State]]:
    """Returns ``(out, state)``: the new state when one was given (a new
    object; nothing is written in place), else None."""
    di, h, p, n, dc, chunk = _dims(cfg)
    b, s, d = xin.shape

    zxbcdt = mm("bsd,de->bse", xin, params["w_in"])
    z, _, _, _, dt_raw = _split_proj(cfg, zxbcdt)
    conv_in = zxbcdt[..., di:2 * di + 2 * n]                # x ++ B ++ C
    conv_out, new_tail = _conv(params, conv_in,
                               state.conv if state is not None else None)
    x = conv_out[..., :di]
    bb = conv_out[..., di:di + n]
    cc = conv_out[..., di + n:]

    dt = F.softplus(dt_raw.float() + params["dt_bias"])     # (B, S, H)
    a = -torch.exp(params["a_log"])                         # (H,) negative
    da = dt * a                                             # log-decay
    xh = x.reshape(b, s, h, p)

    if s == 1 and state is not None:
        # -- decode recurrence ----------------------------------------
        dta = torch.exp(da[:, 0])                           # (B, H)
        dbx = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xh[:, 0].float(),
                           bb[:, 0].float())
        ssm = state.ssm * dta[..., None, None] + dbx
        y = torch.einsum("bhpn,bn->bhp", ssm, cc[:, 0].float())
        y = y + params["d_skip"][None, :, None] * xh[:, 0].float()
        y = y.reshape(b, 1, di).to(xin.dtype)
        new_state = Mamba2State(ssm=ssm, conv=new_tail)
    else:
        # -- chunked SSD scan ------------------------------------------
        l = min(chunk, s)
        assert s % l == 0, f"S={s} not divisible by chunk={l}"
        xf, bf, cf = xh.float(), bb.float(), cc.float()
        tri = torch.ones((l, l), dtype=torch.bool,
                         device=xin.device).tril()
        ssm = (state.ssm if state is not None
               else torch.zeros((b, h, p, n), dtype=torch.float32,
                                device=xin.device))
        ys = []
        for c0 in range(0, s, l):
            c1 = c0 + l
            ssm, y_c = _ssd_chunk(ssm, da[:, c0:c1], dt[:, c0:c1],
                                  xf[:, c0:c1], bf[:, c0:c1], cf[:, c0:c1],
                                  tri)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)                            # (B, S, H, P)
        y = y + params["d_skip"][None, None, :, None] * xf
        y = y.reshape(b, s, di).to(xin.dtype)
        new_state = (Mamba2State(ssm=ssm, conv=new_tail)
                     if state is not None else None)

    # gated output
    y = y * F.silu(z.float()).to(y.dtype)
    y = rmsnorm({"scale": params["norm_scale"]}, y)
    out = mm("bse,ed->bsd", y, params["w_out"])
    return out, new_state


def init_state(cfg: ArchConfig, batch: int, device) -> Mamba2State:
    di, h, p, n, dc, _ = _dims(cfg)
    return Mamba2State(
        ssm=torch.zeros((batch, h, p, n), dtype=torch.float32,
                        device=device),
        conv=torch.zeros((batch, dc - 1, di + 2 * n), dtype=torch.bfloat16,
                         device=device),
    )
