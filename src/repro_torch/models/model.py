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
``lax.scan``).

Each stacked leaf is split into its layers by one ``unbind`` (views; its
backward is one stack, where indexing a layer at a time would build a
full-size zero gradient a layer).  Training (grad enabled and a parameter
requiring grad) changes one thing and no value: each layer body the
reference wraps in ``_remat`` runs under ``torch.utils.checkpoint``
(non-reentrant) with the reference's policy: ``"none"`` saves every
activation; ``"dots"`` saves the products with no batch dimension (the
weight einsums: ``torch.einsum`` computes them as a ``bmm`` of batch 1)
and recomputes the rest, the attention's batched products included;
``"dots+moe"`` also saves a MoE block's output; ``"full"`` saves the
layer's inputs only.  As in the reference, the dense, moe, vlm and audio
blocks, xLSTM's mLSTM blocks and zamba2's Mamba2 blocks are rematerialized;
the sLSTM block (which checkpoints its own 64-step segments,
``models/xlstm.py``) and zamba2's shared attention block are not.
Without grad nothing of this runs: scoring and serving are unchanged.

Every forward differentiates as written, with the reference's gradients
(``tests/test_torch_train.py``): Mamba2 masks before its ``exp`` (no
``inf * 0`` in the backward, ROADMAP §C 11), the MoE's ``scatter_``s
write into fresh tensors, and the stabilisers (online softmax, mLSTM,
sLSTM) are ``torch.maximum`` as the reference's ``jnp.maximum``, which
splits a tie's gradient in half.  The floors taken with ``clamp`` where
the reference takes ``maximum`` with a constant (the attention's running
sum, the sLSTM's normaliser, the MoE renormaliser) never tie: the first
two are at least 1, the third a sum of top-k probabilities.

Over an LM mesh (inside ``distributed.sharding.activation_sharding``)
the parameters passed are this rank's blocks (``sharding.tree_specs`` of
the model's spec) and the batch is this rank's block of the global batch.
Each leaf is gathered before use, a layer's leaves inside its layer (the
reference's ZeRO-3 over the fsdp axes; under remat the gathers are
recomputed), the top-level ones (embedding, head, final norm) once a
forward; the ssm and hybrid families gather their whole tree up front.
The MoE's expert weights stay sharded over ``model``: the block
dispatches to ``moe.moe_apply_ep`` (``model.py:111`` of the reference).
The dense compute (embedding, attention, dense MLP, head) runs on the
rank's batch block and is repeated across ``model``; a gather over
``model`` hands back this rank's block of the gradient (the weight's
gradient taken once), a gather over the data axes sums the ranks'
(``distributed/collectives.py``).  Sharding heads and MLP over ``model``
would change no result and is later speed work.  A leaf already whole
(:meth:`Model.gather`, as serving keeps it) is used as it is.

The parameter tree is a nested dict of tensors keyed as the reference's
(``embed.w``, ``blocks.attn.wq``, ``blocks.ln1.scale``, ...).  ``Model`` is
an ``nn.Module``: :meth:`Model.load_params` registers a tree under those
same paths, so ``model.state_dict()`` is keyed by the reference's dotted
paths and carrying weights across (``repro_torch.bridge``) renames
nothing.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shlib
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import NORM_FNS, NORM_SPECS, gelu_mlp, \
    gelu_mlp_spec, mm, swiglu, swiglu_spec
from repro_torch.models.params import ParamSpec, tree_leaves, tree_map

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


def _layers_of(tree, depth: int):
    """``(*idx) -> layer tree`` of a stacked tree: every leaf split along
    its ``depth`` leading axes by one ``unbind`` (views, no copies), one
    index per stacked axis."""
    def split(a, d):
        parts = a.unbind(0)
        return list(parts) if d == 1 else [split(p, d - 1) for p in parts]

    parts = tree_map(lambda a: split(a, depth), tree)

    def pick(*idx):
        def get(p):
            for i in idx:
                p = p[i]
            return p

        return tree_map(get, parts)

    return pick


def _training(params) -> bool:
    """Grad mode on and some parameter requires grad."""
    return torch.is_grad_enabled() and any(
        a.requires_grad for a in tree_leaves(params))


# ---------------------------------------------------------------------------
# Rematerialization (the reference's ``_remat``)
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("none", "dots", "dots+moe", "full")
_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.mm.default)


def _no_batch_dot(op, args) -> bool:
    """A product with no batch dimension: ``torch.einsum`` lowers one to a
    ``bmm`` of batch 1 (or an ``mm``).  A batched product whose batch is 1
    (one sequence of one KV head) is saved too: that costs memory only."""
    if op is torch.ops.aten.mm.default:
        return True
    return op is torch.ops.aten.bmm.default and args[0].shape[0] == 1


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS and _no_batch_dot(op, args):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_moe_policy(mark, ctx, op, *args, **kwargs):
    """``"dots"``, and the copy :func:`_moe_out` makes while ``mark[0]``
    is on."""
    if mark[0] and op is torch.ops.aten.clone.default:
        return CheckpointPolicy.MUST_SAVE
    return _dots_policy(ctx, op, *args, **kwargs)


def _moe_out(f: Tensor, mark) -> Tensor:
    """The reference's ``checkpoint_name(f, "moe_out")``: a copy of the
    MoE block's output, made with ``mark[0]`` on so that the
    ``"dots+moe"`` policy saves it."""
    mark[0] = True
    try:
        return f.clone()
    finally:
        mark[0] = False


def _remat(fn, policy: str, training: bool, mark=None):
    """``fn`` under the reference's remat ``policy`` when training, else
    ``fn`` itself; ``mark`` is the flag the layer's :func:`_moe_out`
    raises (``"dots+moe"``)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r}; expected one of "
                         f"{REMAT_POLICIES}")
    if policy == "none" or not training:
        return fn
    kw = {}
    if policy != "full":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            _dots_policy if policy == "dots" else functools.partial(
                _dots_moe_policy, [False] if mark is None else mark))
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


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
# Over an LM mesh: this rank's blocks gathered before use
# ---------------------------------------------------------------------------

def _mesh_specs(cfg: ArchConfig):
    """``(mesh, tree)`` of the active ``activation_sharding``, the tree's
    leaves ``(whole shape, spec)`` of each parameter; or None."""
    active = shlib.active()
    if active is None:
        return None
    mesh, rules = active
    return mesh, tree_map(
        lambda p: (p.shape, shlib.spec_for(p.shape, p.logical, mesh, rules)),
        build_model(cfg).spec)


def _gathered(tree, specs, mesh, lead: int = 0, moe: bool = False,
              experts: bool = False):
    """A tree of this rank's blocks with each leaf gathered whole over the
    mesh, but a MoE's expert weights (under ``ffn``, not the router) over
    ``model``; ``lead``: stacked dims the leaves have lost (one layer of a
    stacked tree).  A leaf already of the gathered shape is kept."""
    if isinstance(tree, dict):
        return {k: _gathered(v, specs[k], mesh, lead, moe,
                             (moe and k == "ffn")
                             or (experts and k != "router"))
                for k, v in tree.items()}
    shape, spec = specs
    if any(e is not None for e in spec[:lead]):
        raise NotImplementedError(f"a stacked dim is sharded: spec {spec}")
    shape, spec = shape[lead:], spec[lead:]
    keep = ("model",) if experts else ()
    target = shlib.block_shape(shape, tuple(
        e if set(shlib.entry_axes(e)) & set(keep) else None for e in spec),
        mesh)
    if tuple(tree.shape) == target:
        return tree
    if tuple(tree.shape) != shlib.block_shape(shape, spec, mesh):
        raise ValueError(f"a parameter of shape {tuple(tree.shape)}: "
                         f"neither this rank's block of {shape} (spec "
                         f"{spec}) nor gathered {target}")
    return shlib.gather_block(tree, spec, mesh, keep=keep)


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
                 cache_index=None, length_mask=None, backend="chunked",
                 moe_mark=None):
    """Returns ``(x, cache, aux)``: the MoE auxiliary loss, else 0.
    ``moe_mark``: the ``"dots+moe"`` policy's flag, to mark the MoE
    output with (:func:`_moe_out`)."""
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
        f, aux = moe_mod.moe_apply_ep(params["ffn"], cfg, z)
        if moe_mark is not None:
            f = _moe_out(f, moe_mark)
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
               backend: str = "chunked", remat: str = "dots") -> Tensor:
        """``remat`` takes effect only when training (module docstring)."""
        return _forward(params, self.cfg, batch, backend, remat)

    def prefill(self, params, batch, cache, backend: str = "chunked"):
        return _prefill(params, self.cfg, batch, cache, backend)

    def decode_step(self, params, tokens, cache, index, length_mask):
        return _decode(params, self.cfg, tokens, cache, index, length_mask)

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = "cuda"):
        return _init_cache(self.cfg, batch, max_len, device)

    def gather(self, params):
        """Inside ``activation_sharding``: this rank's blocks ``params``
        gathered whole, but the MoE's expert weights over ``model`` (no
        autograd), the layout a forward gathers to; a server gathers once
        instead of at every step."""
        ms = _mesh_specs(self.cfg)
        if ms is None:
            raise RuntimeError("Model.gather needs an active "
                               "activation_sharding")
        with torch.no_grad():
            return _gathered(params, ms[1], ms[0],
                             moe=self.cfg.moe is not None)

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


def _run_ssm(params, cfg: ArchConfig, x, cache=None, remat="none"):
    """xLSTM's segments over ``x``; with a cache, returns the new one (new
    stacked states: the reference's scan outputs).  ``remat``: the mLSTM
    blocks' policy when training (and no cache)."""
    norm = NORM_FNS[cfg.norm]
    n_seg, per = _segments(cfg)
    training = cache is None and _training(params)
    mlstm = _layers_of(params["mlstm"], 2)
    ln_m = _layers_of(params["ln_m"], 2)
    slstm = _layers_of(params["slstm"], 1)
    ln_s = _layers_of(params["ln_s"], 1)

    def m_body(c, blk, ln):
        h, _ = xl.mlstm_apply(blk, cfg, norm(ln, c))
        return c + h

    m_step = _remat(m_body, remat, training)
    m_states, s_states = [], []
    for g in range(n_seg):
        seg = []
        for j in range(per):
            if cache is None:
                x = m_step(x, mlstm(g, j), ln_m(g, j))
                continue
            h, st = xl.mlstm_apply(mlstm(g, j), cfg, norm(ln_m(g, j), x),
                                   state=_state_at(cache["mlstm"], g, j))
            x = x + h
            seg.append(st)
        m_states.append(seg)
        st = None if cache is None else _state_at(cache["slstm"], g)
        h, st = xl.slstm_apply(slstm(g), cfg, norm(ln_s(g), x), state=st)
        x = x + h
        s_states.append(st)
    if cache is None:
        return x, None
    return x, {"mlstm": _stack_states(m_states),
               "slstm": _stack_states(s_states)}


def _run_hybrid(params, cfg: ArchConfig, x, positions, cache=None,
                index=None, length_mask=None, backend="chunked",
                remat="none"):
    """zamba2's groups, each followed by the shared attention block, then
    the tail; with a cache, the attention's KV cache is written in place
    and the Mamba2 states come back as new stacked states.  ``remat``: the
    Mamba2 blocks' policy when training (and no cache)."""
    norm = NORM_FNS[cfg.norm]
    n_full, k, rem = _groups(cfg)
    training = cache is None and _training(params)
    blocks = _layers_of(params["mamba"], 2)
    lns = _layers_of(params["ln_mamba"], 2)

    def mamba(blk, ln, c, st):
        h, st = m2.mamba2_apply(blk, cfg, norm(ln, c), state=st)
        return c + h, st

    def m_body(c, blk, ln):
        return mamba(blk, ln, c, None)[0]

    m_step = _remat(m_body, remat, training)
    groups = []
    for g in range(n_full):
        group = []
        for j in range(k):
            if cache is None:
                x = m_step(x, blocks(g, j), lns(g, j))
                continue
            x, st = mamba(blocks(g, j), lns(g, j), x,
                          _state_at(cache["mamba"], g, j))
            group.append(st)
        groups.append(group)
        kv = None if cache is None else (cache["attn"][0][g],
                                         cache["attn"][1][g])
        x, _, _ = _block_apply(params["shared_attn"], cfg, x, positions,
                               cache=kv, cache_index=index,
                               length_mask=length_mask, backend=backend)
    tail = []
    if rem:
        t_blocks = _layers_of(params["mamba_tail"], 1)
        t_lns = _layers_of(params["ln_tail"], 1)
    for j in range(rem):
        if cache is None:
            x = m_step(x, t_blocks(j), t_lns(j))
            continue
        x, st = mamba(t_blocks(j), t_lns(j), x,
                      _state_at(cache["mamba_tail"], j))
        tail.append(st)
    if cache is None:
        return x, None
    new_cache = {"mamba": _stack_states(groups), "attn": cache["attn"]}
    if rem:
        new_cache["mamba_tail"] = _stack_states(tail)
    return x, new_cache


def _on_mesh(params, cfg: ArchConfig):
    """``(params, layer)`` to run on: outside a mesh ``params`` and the
    identity; over one, the top-level leaves gathered and ``layer``
    gathering one layer of ``blocks`` (the ssm and hybrid families: the
    whole tree gathered, ``layer`` the identity)."""
    ms = _mesh_specs(cfg)
    if ms is None:
        return params, lambda lp: lp
    mesh, specs = ms
    moe = cfg.moe is not None
    if cfg.family not in _BLOCKS:
        return _gathered(params, specs, mesh, moe=moe), lambda lp: lp
    top = {k: _gathered(v, specs[k], mesh, moe=moe)
           for k, v in params.items() if k != "blocks"}
    top["blocks"] = params["blocks"]
    return top, lambda lp: _gathered(lp, specs["blocks"], mesh, lead=1,
                                     moe=moe)


def _forward(params, cfg: ArchConfig, batch, backend: str,
             remat: str = "none") -> Tensor:
    _check_family(cfg)
    params, use = _on_mesh(params, cfg)
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "ssm":
        x, _ = _run_ssm(params, cfg, x, remat=remat)
    elif cfg.family == "hybrid":
        x, _ = _run_hybrid(params, cfg, x, positions, backend=backend,
                           remat=remat)
    else:
        training = _training(params)
        layer = _layers_of(params["blocks"], 1)
        mark = ([False] if training and remat == "dots+moe"
                and cfg.moe is not None else None)

        def body(c, lp):
            return _block_apply(use(lp), cfg, c, positions, backend=backend,
                                moe_mark=mark)[0]

        step = _remat(body, remat, training, mark)
        for i in range(_n_layers(params)):
            x = step(x, layer(i))
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


def _run_cached(params, cfg, x, positions, cache, index, length_mask,
                backend="chunked", use=lambda lp: lp):
    layer = _layers_of(params["blocks"], 1)
    for i in range(_n_layers(params)):
        x, _, _ = _block_apply(use(layer(i)), cfg, x,
                               positions, cache=_layer_cache(cfg, cache, i),
                               cache_index=index, length_mask=length_mask,
                               backend=backend)
    return x


def _prefill(params, cfg: ArchConfig, batch, cache,
             backend: str = "chunked"):
    """Run the full prompt, filling the cache; returns ``(last_logits,
    cache)``.  KV and latent caches are written in place; the recurrent
    states of ssm and hybrid come back as new tensors, so use the cache
    returned.  ``backend="kernel"`` runs the prompt's attention on the
    kernel (the reference's prefill runs the chunked path)."""
    _check_family(cfg)
    params, use = _on_mesh(params, cfg)
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "ssm":
        x, cache = _run_ssm(params, cfg, x, cache)
    elif cfg.family == "hybrid":
        x, cache = _run_hybrid(params, cfg, x, positions, cache, 0,
                               backend=backend)
    else:
        x = _run_cached(params, cfg, x, positions, cache, 0, None, backend,
                        use)
    return _head(params, cfg, x[:, -1:]), cache


def _decode(params, cfg: ArchConfig, tokens, cache, index: int,
            length_mask):
    """One autoregressive step.  tokens: (B, 1); index: the write offset.
    Returns ``(logits, cache)`` as :func:`_prefill` does.  A vlm's decode
    embeds the tokens only (the patches were the prefill's prefix)."""
    _check_family(cfg)
    params, use = _on_mesh(params, cfg)
    x = params["embed"]["w"][tokens.long()]
    positions = torch.full((1,), index, device=x.device)
    if cfg.family == "ssm":
        x, cache = _run_ssm(params, cfg, x, cache)
    elif cfg.family == "hybrid":
        x, cache = _run_hybrid(params, cfg, x, positions, cache, index,
                               length_mask)
    else:
        x = _run_cached(params, cfg, x, positions, cache, index,
                        length_mask, use=use)
    return _head(params, cfg, x), cache
