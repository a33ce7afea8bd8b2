"""Model assembly (port of ``repro/models/model.py``): every family of
the reference.

  dense  - [GQA|MLA attention + SwiGLU MLP] x L
  moe    - [GQA attention + MoE FFN] x L (``models/moe.py``)
  ssm    - xLSTM: segments of (slstm_every - 1) mLSTM blocks + 1 sLSTM
           block (``models/xlstm.py``)
  hybrid - zamba2: Mamba2 blocks (``models/mamba2.py``) with one *shared*
           attention block applied after every ``shared_attn_every`` of
           them (one set of weights), and a tail of the remaining Mamba2
           blocks
  audio  - hubert: an encoder, bidirectional attention + GeLU MLP over
           precomputed frame embeddings (the conv frontend is a stub, as in
           the reference); no cache
  vlm    - llava: a Mistral decoder over [projected patch embeddings ++
           tokens] (the vision tower is a stub, as in the reference)

The layers' parameters are stacked along leading axes as in the reference
(ssm: ``(n_seg, slstm_every - 1, ...)`` mLSTM stacks; hybrid: ``(n_full,
k, ...)`` Mamba2 groups) and applied by Python loops (the reference's
``lax.scan``; without autograd there is no remat to choose).

The parameter tree is a nested dict of tensors keyed as the reference's
(``embed.w``, ``blocks.attn.wq``, ``blocks.ln1.scale``, ...).  ``Model`` is
an ``nn.Module``: :meth:`Model.load_params` registers a tree under those
same paths, so ``model.state_dict()`` is keyed by the reference's dotted
paths and carrying weights across (``repro_torch.bridge``) renames
nothing.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import NORM_FNS, NORM_SPECS, gelu_mlp, \
    gelu_mlp_spec, mm, swiglu, swiglu_spec
from repro_torch.models.params import ParamSpec, tree_map

Tensor = torch.Tensor

_BLOCKS = ("dense", "moe", "audio", "vlm")    # one stack of ``blocks``
_FAMILIES = _BLOCKS + ("ssm", "hybrid")
_CACHED = ("dense", "moe", "vlm", "ssm", "hybrid")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(cfg.family)      # as the reference's build_model


def _stack_specs(spec_tree, n: int):
    """Add a leading stacked-layers dim to every ParamSpec leaf."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",)
                                        + s.logical, s.dtype, s.init,
                                        s.scale), spec_tree)


def _layer(tree, *idx: int):
    """Layer ``idx`` of a stacked parameter tree (views, no copies): one
    index per stacked axis."""
    return tree_map(lambda a: a[idx], tree)


def _state_at(state, *idx: int):
    """One layer's recurrent state of a stacked state (a NamedTuple)."""
    return type(state)(*(a[idx] for a in state))


def _stack_states(states):
    """Per-layer states (NamedTuples, in nested lists) stacked leaf-wise
    along new leading axes: new tensors, so a leaf keeps the type its layer
    gave it (a float32 conv tail after float32 inputs, as in JAX)."""
    if isinstance(states[0], list):
        states = [_stack_states(s) for s in states]
    return type(states[0])(*(torch.stack(leaves)
                             for leaves in zip(*states)))


# ---------------------------------------------------------------------------
# Decoder/encoder transformer block (dense / moe / audio / vlm)
# ---------------------------------------------------------------------------

def _block_spec(cfg: ArchConfig):
    spec: Dict[str, Any] = {
        "ln1": NORM_SPECS[cfg.norm](cfg.d_model),
        "ln2": NORM_SPECS[cfg.norm](cfg.d_model),
    }
    if cfg.attention == "gqa":
        spec["attn"] = attn_mod.gqa_spec(cfg)
    elif cfg.attention == "mla":
        spec["attn"] = attn_mod.mla_spec(cfg)
    if cfg.moe is not None:
        spec["ffn"] = moe_mod.moe_spec(cfg)
    elif cfg.family == "audio":
        spec["ffn"] = gelu_mlp_spec(cfg.d_model, cfg.d_ff)
    else:
        spec["ffn"] = swiglu_spec(cfg.d_model, cfg.d_ff)
    return spec


def _block_apply(params, cfg: ArchConfig, x, positions, cache=None,
                 cache_index=None, length_mask=None, backend="chunked"):
    """Returns ``(x, cache, aux)``: the MoE auxiliary loss, else 0."""
    norm = NORM_FNS[cfg.norm]
    attn_fn = (attn_mod.gqa_apply if cfg.attention == "gqa"
               else attn_mod.mla_apply)
    h, new_cache = attn_fn(
        params["attn"], cfg, norm(params["ln1"], x), positions,
        cache=cache, cache_index=cache_index, length_mask=length_mask,
        backend=backend,
    )
    x = x + h
    z = norm(params["ln2"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe is not None:
        f, aux = moe_mod.moe_apply(params["ffn"], cfg, z)
    elif cfg.family == "audio":
        f = gelu_mlp(params["ffn"], z)
    else:
        f = swiglu(params["ffn"], z)
    return x + f, new_cache, aux


# ---------------------------------------------------------------------------
# Model spec + apply
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """An LM: its configuration, its spec tree and, once
    :meth:`load_params` has run, its parameters as registered tensors.
    The forward functions take the parameter tree explicitly, as the
    reference's do."""

    def __init__(self, cfg: ArchConfig, spec: Any):
        super().__init__()
        self.cfg = cfg
        self.spec = spec

    # logits over the full input sequence (scoring / prefill without cache)
    def logits(self, params, batch: Dict[str, Tensor],
               backend: str = "chunked") -> Tensor:
        return _forward(params, self.cfg, batch, backend)

    def prefill(self, params, batch, cache):
        return _prefill(params, self.cfg, batch, cache)

    def decode_step(self, params, tokens, cache, index, length_mask):
        return _decode(params, self.cfg, tokens, cache, index, length_mask)

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = "cuda"):
        return _init_cache(self.cfg, batch, max_len, device)

    def load_params(self, params) -> "Model":
        """Register every tensor of ``params`` (a tree of :attr:`spec`'s
        shape) under its path, without copying: ``self.state_dict()`` is
        then keyed ``embed.w``, ``blocks.attn.wq``, ...  Returns self."""
        def register(module: nn.Module, spec, tree, path: str):
            # a subtree without leaves (a non-parametric norm's {}) may be
            # absent: a dict of dotted paths cannot hold it
            need = {n for n, sub in spec.items() if sub != {}}
            if not need <= set(tree) <= set(spec):
                raise KeyError(f"{path or 'params'}: keys {sorted(tree)} "
                               f"!= spec's {sorted(spec)}")
            for name, sub in spec.items():
                where = f"{path}.{name}" if path else name
                if isinstance(sub, dict):
                    child = nn.Module()
                    module.add_module(name, child)
                    register(child, sub, tree.get(name, {}), where)
                    continue
                t = tree[name]
                if tuple(t.shape) != sub.shape:
                    raise ValueError(f"{where}: shape {tuple(t.shape)} != "
                                     f"spec's {sub.shape}")
                module.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))

        for name in list(self._modules):
            del self._modules[name]
        register(self, self.spec, params, "")
        return self

    @property
    def params(self):
        """The registered parameters as the nested dict the forward
        functions take."""
        def tree(module: nn.Module):
            out = {n: p.data for n, p in module._parameters.items()}
            out.update({n: tree(m) for n, m in module._modules.items()})
            return out

        return tree(self)


def build_model(cfg: ArchConfig) -> Model:
    _check_family(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    frontend = {"w": ParamSpec((cfg.frontend_dim, d), ("frontend", "embed"))}
    spec: Dict[str, Any] = {}
    if cfg.family == "audio":
        spec["frontend"] = frontend
    spec["embed"] = {"w": ParamSpec((v, d), ("vocab", "embed"))}
    if cfg.family == "vlm":
        spec["frontend"] = frontend
    norm = NORM_SPECS[cfg.norm]
    if cfg.family in _BLOCKS:
        spec["blocks"] = _stack_specs(_block_spec(cfg), cfg.n_layers)
    elif cfg.family == "ssm":      # xLSTM
        n_seg, per = _segments(cfg)
        spec["mlstm"] = _stack_specs(
            _stack_specs(xl.mlstm_spec(cfg), per), n_seg)
        spec["slstm"] = _stack_specs(xl.slstm_spec(cfg), n_seg)
        spec["ln_m"] = _stack_specs(_stack_specs(norm(d), per), n_seg)
        spec["ln_s"] = _stack_specs(norm(d), n_seg)
    else:                          # hybrid: zamba2
        n_full, k, rem = _groups(cfg)
        spec["mamba"] = _stack_specs(
            _stack_specs(m2.mamba2_spec(cfg), k), n_full)
        spec["ln_mamba"] = _stack_specs(_stack_specs(norm(d), k), n_full)
        if rem:
            spec["mamba_tail"] = _stack_specs(m2.mamba2_spec(cfg), rem)
            spec["ln_tail"] = _stack_specs(norm(d), rem)
        spec["shared_attn"] = _block_spec(cfg)  # ONE set of weights, reused
    spec["ln_f"] = norm(d)
    if not cfg.tie_embeddings:
        spec["head"] = {"w": ParamSpec((d, v), ("embed", "vocab"))}
    return Model(cfg=cfg, spec=spec)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg: ArchConfig, batch) -> Tensor:
    if cfg.family == "audio":
        return mm("bsf,fd->bsd", batch["frames"], params["frontend"]["w"])
    x = params["embed"]["w"][batch["tokens"].long()]
    if cfg.family == "vlm":
        p = mm("bnf,fd->bnd", batch["patches"], params["frontend"]["w"])
        t = torch.promote_types(p.dtype, x.dtype)
        x = torch.cat([p.to(t), x.to(t)], dim=1)
    return x


def _head(params, cfg: ArchConfig, x: Tensor) -> Tensor:
    x = NORM_FNS[cfg.norm](params["ln_f"], x)
    if cfg.tie_embeddings:
        logits = mm("bsd,vd->bsv", x, params["embed"]["w"])
    else:
        logits = mm("bsd,dv->bsv", x, params["head"]["w"])
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _n_layers(params) -> int:
    return params["blocks"]["attn"]["wo"].shape[0]


def _segments(cfg: ArchConfig):
    """ssm: (segments, mLSTM blocks a segment)."""
    return (cfg.n_layers // cfg.xlstm.slstm_every,
            cfg.xlstm.slstm_every - 1)


def _groups(cfg: ArchConfig):
    """hybrid: (full groups, Mamba2 blocks a group, tail blocks)."""
    k = cfg.shared_attn_every
    return cfg.n_layers // k, k, cfg.n_layers % k


def _run_ssm(params, cfg: ArchConfig, x, cache=None):
    """xLSTM's segments over ``x``; with a cache, returns the new one (new
    stacked states: the reference's scan outputs)."""
    norm = NORM_FNS[cfg.norm]
    n_seg, per = _segments(cfg)
    m_states, s_states = [], []
    for g in range(n_seg):
        seg = []
        for j in range(per):
            st = None if cache is None else _state_at(cache["mlstm"], g, j)
            h, st = xl.mlstm_apply(_layer(params["mlstm"], g, j), cfg,
                                   norm(_layer(params["ln_m"], g, j), x),
                                   state=st)
            x = x + h
            seg.append(st)
        m_states.append(seg)
        st = None if cache is None else _state_at(cache["slstm"], g)
        h, st = xl.slstm_apply(_layer(params["slstm"], g), cfg,
                               norm(_layer(params["ln_s"], g), x), state=st)
        x = x + h
        s_states.append(st)
    if cache is None:
        return x, None
    return x, {"mlstm": _stack_states(m_states),
               "slstm": _stack_states(s_states)}


def _run_hybrid(params, cfg: ArchConfig, x, positions, cache=None,
                index=None, length_mask=None, backend="chunked"):
    """zamba2's groups, each followed by the shared attention block, then
    the tail; with a cache, the attention's KV cache is written in place
    and the Mamba2 states come back as new stacked states."""
    norm = NORM_FNS[cfg.norm]
    n_full, k, rem = _groups(cfg)

    def mamba(blk, ln, c, st):
        h, st = m2.mamba2_apply(blk, cfg, norm(ln, c), state=st)
        return c + h, st

    groups = []
    for g in range(n_full):
        group = []
        for j in range(k):
            x, st = mamba(_layer(params["mamba"], g, j),
                          _layer(params["ln_mamba"], g, j), x,
                          None if cache is None
                          else _state_at(cache["mamba"], g, j))
            group.append(st)
        groups.append(group)
        kv = None if cache is None else (cache["attn"][0][g],
                                         cache["attn"][1][g])
        x, _, _ = _block_apply(params["shared_attn"], cfg, x, positions,
                               cache=kv, cache_index=index,
                               length_mask=length_mask, backend=backend)
    tail = []
    for j in range(rem):
        x, st = mamba(_layer(params["mamba_tail"], j),
                      _layer(params["ln_tail"], j), x,
                      None if cache is None
                      else _state_at(cache["mamba_tail"], j))
        tail.append(st)
    if cache is None:
        return x, None
    new_cache = {"mamba": _stack_states(groups), "attn": cache["attn"]}
    if rem:
        new_cache["mamba_tail"] = _stack_states(tail)
    return x, new_cache


def _forward(params, cfg: ArchConfig, batch, backend: str) -> Tensor:
    _check_family(cfg)
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "ssm":
        x, _ = _run_ssm(params, cfg, x)
    elif cfg.family == "hybrid":
        x, _ = _run_hybrid(params, cfg, x, positions, backend=backend)
    else:
        for i in range(_n_layers(params)):
            x, _, _ = _block_apply(_layer(params["blocks"], i), cfg, x,
                                   positions, backend=backend)
    return _head(params, cfg, x)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _init_cache(cfg: ArchConfig, batch: int, max_len: int,
                device: DeviceLike = "cuda"):
    """bfloat16: GQA's ``(L, B, Hkv, T, hd)`` key and value caches, or
    MLA's latent cache ``(L, B, T, kv_lora_rank + qk_rope_head_dim)``.
    ssm: ``{"mlstm": MLSTMState, "slstm": SLSTMState}`` stacked
    ``(n_seg, slstm_every - 1, ...)`` and ``(n_seg, ...)``; hybrid:
    ``{"mamba": Mamba2State (n_full, k, ...), "attn": (k, v) (n_full, B,
    Hkv, T, hd), "mamba_tail": Mamba2State (rem, ...)}``: the reference's
    trees, each state as its ``init_state`` makes it.  An encoder (audio)
    has none and raises ``ValueError``, as the reference does."""
    _check_family(cfg)
    if cfg.family not in _CACHED:
        raise ValueError(f"no cache for family {cfg.family}")
    dev = resolve_device(device)

    def stacked(state, *lead):
        return type(state)(*(a.expand(*lead, *a.shape).clone()
                             for a in state))

    if cfg.family == "ssm":
        n_seg, per = _segments(cfg)
        return {"mlstm": stacked(xl.mlstm_init_state(cfg, batch, dev),
                                 n_seg, per),
                "slstm": stacked(xl.slstm_init_state(cfg, batch, dev),
                                 n_seg)}
    if cfg.family == "hybrid":
        n_full, k, rem = _groups(cfg)
        ms = m2.init_state(cfg, batch, dev)
        shape = (n_full, batch, cfg.n_kv_heads, max_len, cfg.hd)
        out = {"mamba": stacked(ms, n_full, k),
               "attn": (torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                        torch.zeros(shape, dtype=torch.bfloat16,
                                    device=dev))}
        if rem:
            out["mamba_tail"] = stacked(ms, rem)
        return out
    if cfg.attention == "mla":
        m = cfg.mla
        return torch.zeros((cfg.n_layers, batch, max_len,
                            m.kv_lora_rank + m.qk_rope_head_dim),
                           dtype=torch.bfloat16, device=dev)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return (torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            torch.zeros(shape, dtype=torch.bfloat16, device=dev))


def _layer_cache(cfg: ArchConfig, cache, i: int):
    if cfg.attention == "mla":
        return cache[i]
    return cache[0][i], cache[1][i]


def _run_cached(params, cfg, x, positions, cache, index, length_mask):
    for i in range(_n_layers(params)):
        x, _, _ = _block_apply(_layer(params["blocks"], i), cfg, x,
                               positions, cache=_layer_cache(cfg, cache, i),
                               cache_index=index, length_mask=length_mask)
    return x


def _prefill(params, cfg: ArchConfig, batch, cache):
    """Run the full prompt, filling the cache; returns ``(last_logits,
    cache)``.  KV and latent caches are written in place; the recurrent
    states of ssm and hybrid come back as new tensors, so use the cache
    returned."""
    _check_family(cfg)
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "ssm":
        x, cache = _run_ssm(params, cfg, x, cache)
    elif cfg.family == "hybrid":
        x, cache = _run_hybrid(params, cfg, x, positions, cache, 0)
    else:
        x = _run_cached(params, cfg, x, positions, cache, 0, None)
    return _head(params, cfg, x[:, -1:]), cache


def _decode(params, cfg: ArchConfig, tokens, cache, index: int,
            length_mask):
    """One autoregressive step.  tokens: (B, 1); index: the write offset.
    Returns ``(logits, cache)`` as :func:`_prefill` does.  A vlm's decode
    embeds the tokens only (the patches were the prefill's prefix)."""
    _check_family(cfg)
    x = params["embed"]["w"][tokens.long()]
    positions = torch.full((1,), index, device=x.device)
    if cfg.family == "ssm":
        x, cache = _run_ssm(params, cfg, x, cache)
    elif cfg.family == "hybrid":
        x, cache = _run_hybrid(params, cfg, x, positions, cache, index,
                               length_mask)
    else:
        x = _run_cached(params, cfg, x, positions, cache, index,
                        length_mask)
    return _head(params, cfg, x), cache
