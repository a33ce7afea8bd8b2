"""Train, scoring and serving step functions (port of
``repro/training/steps.py``).

``make_train_step`` builds ``(params, opt_state, batch[, grad_ctx]) ->
(params, opt_state, metrics[, grad_ctx])``, functional as the
reference's: the gradients come from ``torch.autograd.grad`` over aliases
of the parameters made to require grad (``detach().requires_grad_()``:
no copy), with optional gradient accumulation (the batch split into
``accum_steps`` contiguous row groups, the loss and the gradients summed
in float32, then scaled by ``1 / accum_steps``) and an optional
``grad_transform`` between the backward and the optimizer
(``distributed.grad_compress.DeltaEFCompressor``).  Training runs the
``"chunked"`` attention backend, as the reference's does: the attention
kernel has no backward and raises under autograd (ROADMAP B5 b).

Over an LM mesh (``make_train_step(..., mesh=)``) the step runs inside
``activation_sharding``: the parameters, the optimizer state and the
gradients are this rank's blocks (``sharding.tree_specs`` of the model's
spec), the batch is this rank's block of the global batch, split over the
data axes (``SyntheticLM(mesh=)``).  Each rank backpropagates its share
of the global mean loss (its tokens' loss summed over the global token
count), so the gathers' backward (``distributed/collectives.py``) sums
the data ranks' gradients and takes a weight's gradient once over
``model``; a leaf the data axes do not shard has its gradient summed over
them.  ``loss`` is the global mean, ``grad_norm`` the norm of the global
gradient (each leaf's block sum of squares summed over the axes that
shard it), and AdamW updates each rank's blocks.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.training.optimizer import AdamW, AdamWState

Tensor = torch.Tensor


def _token_nll(logits: Tensor, labels: Tensor) -> Tensor:
    """Each token's negative log-likelihood in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def cross_entropy(logits: Tensor, labels: Tensor,
                  mask: Optional[Tensor] = None) -> Tensor:
    """Mean token cross-entropy in f32; logits (B, S, V), labels (B, S)."""
    nll = _token_nll(logits, labels)
    if mask is not None:
        m = mask.float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


def loss_fn(model: Model, params, batch: Dict[str, Tensor],
            backend: str = "chunked", remat: str = "dots") -> Tensor:
    """The mean token loss; ``remat`` takes effect only under autograd
    (``models/model.py``)."""
    return cross_entropy(_text_logits(model, params, batch, backend, remat),
                         batch["labels"], batch.get("loss_mask"))


def _text_logits(model: Model, params, batch, backend: str, remat: str
                 ) -> Tensor:
    cfg = model.cfg
    logits = model.logits(params, batch, backend=backend, remat=remat)
    if cfg.family == "vlm":
        # loss only on the text span (logits cover patches ++ text)
        logits = logits[:, cfg.n_patches:]
    return logits


def _mesh_loss_share(model: Model, params, batch: Dict[str, Tensor],
                     backend: str, remat: str, mesh) -> Tensor:
    """This rank's share of the global mean token loss: its tokens'
    cross-entropy summed over the global (masked) token count.  The
    shares summed over the data axes are the global batch's mean."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import data_axes

    nll = _token_nll(_text_logits(model, params, batch, backend, remat),
                     batch["labels"])
    mask = batch.get("loss_mask")
    m = (torch.ones_like(nll) if mask is None else mask.float())
    count = col.psum_raw(m.sum().detach(), data_axes(mesh), mesh)
    return torch.sum(nll * m) / torch.clamp(count, min=1.0)


def value_and_grad(model: Model, params, batch: Dict[str, Tensor],
                   backend: str = "chunked", remat: str = "dots",
                   mesh=None):
    """``(loss, grads)`` of :func:`loss_fn`, as ``jax.value_and_grad``:
    the gradients a tree of the parameters' shape and types (zeros where a
    parameter does not reach the loss).  With ``mesh`` (inside its
    ``activation_sharding``), the loss is this rank's share of the global
    mean and the gradients are this rank's blocks of that share's
    gradient, summed over the data ranks where a gather sums them."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        tree = tree_unflatten(params, live)
        loss = (loss_fn(model, tree, batch, backend, remat) if mesh is None
                else _mesh_loss_share(model, tree, batch, backend, remat,
                                      mesh))
        grads = torch.autograd.grad(loss, live, materialize_grads=True)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(
    model: Model,
    opt: AdamW,
    accum_steps: int = 1,
    backend: str = "chunked",
    remat: str = "dots",
    grad_transform: Optional[Callable] = None,
    mesh=None,
    rules=None,
    donate: bool = False,
):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``; with ``grad_transform(grads, ctx) -> (grads, ctx)`` (e.g.
    gradient compression) ``train_step(params, opt_state, batch, ctx) ->
    (params, opt, metrics, ctx)``.  ``metrics``: the loss, the norm of the
    (transformed) gradients and the new step's learning rate, 0-d float32
    tensors on the parameters' device (nothing is read back).  With
    ``mesh`` (and its sharding ``rules``) the step runs over the LM mesh
    (module docstring); accumulation then splits each rank's rows.
    ``donate``: AdamW updates the parameters and the state in place (the
    reference's launcher donates them), so the step returns the tensors it
    was given, holding the new values."""
    if mesh is not None and grad_transform is not None:
        raise NotImplementedError(
            "a grad_transform over the LM mesh: the compressor's scales "
            "would need a max over every leaf's blocks")
    specs = None
    if mesh is not None:
        from repro_torch.distributed import sharding as shlib
        specs = tree_leaves(shlib.tree_specs(model.spec, mesh, rules))

    def grads_of(params, batch):
        if mesh is None:
            return value_and_grad(model, params, batch, backend, remat)
        with shlib.activation_sharding(mesh, rules):
            return value_and_grad(model, params, batch, backend, remat,
                                  mesh)

    def compute_grads(params, batch):
        if accum_steps == 1:
            return grads_of(params, batch)
        loss = None
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        for i in range(accum_steps):
            mb = {k: _rows(v, accum_steps, i) for k, v in batch.items()}
            l, g = grads_of(params, mb)
            loss = l.float() if loss is None else loss + l
            for a, gi in zip(acc, tree_leaves(g)):
                a.add_(gi)
        inv = 1.0 / accum_steps
        return loss * inv, tree_unflatten(params, [a * inv for a in acc])

    def train_step(params, opt_state: AdamWState, batch, grad_ctx=None):
        loss, grads = compute_grads(params, batch)
        if mesh is not None:
            loss, grads, gnorm = _mesh_reduce(loss, grads, specs, mesh)
        if grad_transform is not None:
            grads, grad_ctx = grad_transform(grads, grad_ctx)
        new_params, new_opt = opt.update(grads, opt_state, params,
                                         inplace=donate)
        if mesh is None:
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in tree_leaves(grads)))
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": opt.schedule(new_opt.step)}
        if grad_transform is not None:
            return new_params, new_opt, metrics, grad_ctx
        return new_params, new_opt, metrics

    return train_step


@torch.no_grad()
def _mesh_reduce(share: Tensor, grads, specs, mesh):
    """The global loss (the shares summed over the data axes), the
    gradients with each leaf summed over the data axes that do not shard
    it, and the global gradient's norm."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import data_axes, spec_axes

    data = data_axes(mesh)
    loss = col.psum_raw(share, data, mesh)
    out, squares = [], {}
    for g, spec in zip(tree_leaves(grads), specs):
        axes = spec_axes(spec)
        rest = tuple(a for a in data if a not in axes)
        if rest:
            g = col.psum_raw(g, rest, mesh)
        out.append(g)
        key = tuple(a for a in mesh.axis_names if a in axes)
        sq = torch.sum(g.float() ** 2)
        squares[key] = sq if key not in squares else squares[key] + sq
    total = None
    for key in sorted(squares):
        part = col.psum_raw(squares[key], key, mesh) if key else squares[key]
        total = part if total is None else total + part
    return loss, tree_unflatten(grads, out), torch.sqrt(total)


def _rows(x: Tensor, n: int, i: int) -> Tensor:
    """The ``i``-th of ``n`` contiguous row groups of ``x``."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} rows does not split into "
                         f"{n} accumulation steps")
    return x.reshape((n, b // n) + tuple(x.shape[1:]))[i]


def make_serve_decode_step(model: Model):
    """decode_step(params, cache, tokens, index) -> (logits, cache): KV
    caches are updated in place, recurrent states (ssm, hybrid) returned
    new, so pass the cache returned to the next step."""

    def step(params, cache, tokens: Tensor, index: int):
        b = tokens.shape[0]
        max_len = _cache_len(model.cfg, cache)
        length_mask = (torch.arange(max_len, device=tokens.device)[None, :]
                       <= index).expand(b, max_len)
        return model.decode_step(params, tokens, cache, index, length_mask)

    return step


def _cache_len(cfg: ArchConfig, cache) -> int:
    if cfg.family in ("dense", "moe", "vlm"):
        if cfg.attention == "mla":
            return cache.shape[2]
        return cache[0].shape[3]
    if cfg.family == "hybrid":
        return cache["attn"][0].shape[3]
    if cfg.family == "ssm":
        return 1    # no attention: the length mask is not read
    raise ValueError(cfg.family)


def make_prefill_step(model: Model):
    def step(params, batch, cache):
        return model.prefill(params, batch, cache)

    return step
