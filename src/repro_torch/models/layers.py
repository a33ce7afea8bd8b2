"""Shared neural layers: norms, rotary embeddings, MLPs (port of
``repro/models/layers.py``).

The casts follow the reference: norms compute in float32 and cast back to
the input's type, ``rope`` builds its angles in float32, and the MLP
activations run in float32 on the product's rounded value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor


def mm(eq: str, a: Tensor, b: Tensor) -> Tensor:
    """``torch.einsum`` with the reference's type promotion: ``jnp.einsum``
    of bfloat16 and float32 computes in float32, where ``torch.einsum``
    refuses mixed types."""
    t = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(t), b.to(t))


# -- Norms -------------------------------------------------------------

def rmsnorm_spec(d: int):
    return {"scale": ParamSpec((d,), ("embed",), torch.float32, "ones")}


def rmsnorm(params, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


def layernorm_spec(d: int):
    return {
        "scale": ParamSpec((d,), ("embed",), torch.float32, "ones"),
        "bias": ParamSpec((d,), ("embed",), torch.float32, "zeros"),
    }


def _normalize(x: Tensor, eps: float) -> Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)  # jnp.var
    return (xf - mu) * torch.rsqrt(var + eps)


def layernorm(params, x: Tensor, eps: float = 1e-5) -> Tensor:
    y = _normalize(x, eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def nonparametric_ln(params, x: Tensor, eps: float = 1e-5) -> Tensor:
    """OLMo-style LayerNorm without scale/bias (non-parametric)."""
    del params
    return _normalize(x, eps).to(x.dtype)


NORM_SPECS = {
    "rmsnorm": rmsnorm_spec,
    "layernorm": layernorm_spec,
    "nonparametric_ln": lambda d: {},
}
NORM_FNS = {
    "rmsnorm": rmsnorm,
    "layernorm": layernorm,
    "nonparametric_ln": nonparametric_ln,
}


# -- Rotary ------------------------------------------------------------

def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Apply rotary embedding.  x: (..., S, hd), positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=x.device) / half
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), exps)
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    # broadcast over head axis: x (..., H, S, hd) vs ang (..., S, half)
    while cos.dim() < x.dim() - 1:
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLPs --------------------------------------------------------------

def swiglu_spec(d: int, f: int):
    return {
        "w_gate": ParamSpec((d, f), ("embed", "mlp")),
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }


def swiglu(params, x: Tensor) -> Tensor:
    g = mm("...d,df->...f", x, params["w_gate"])
    u = mm("...d,df->...f", x, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return mm("...f,fd->...d", h, params["w_down"])


def gelu_mlp_spec(d: int, f: int):
    return {
        "w_in": ParamSpec((d, f), ("embed", "mlp")),
        "b_in": ParamSpec((f,), ("mlp",), torch.float32, "zeros"),
        "w_out": ParamSpec((f, d), ("mlp", "embed")),
        "b_out": ParamSpec((d,), ("embed",), torch.float32, "zeros"),
    }


def gelu_mlp(params, x: Tensor) -> Tensor:
    h = mm("...d,df->...f", x, params["w_in"]) + params["b_in"].to(x.dtype)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return mm("...f,fd->...d", h, params["w_out"]) + params["b_out"].to(
        x.dtype)
