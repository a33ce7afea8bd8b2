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
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.training.optimizer import AdamW, AdamWState

Tensor = torch.Tensor


def cross_entropy(logits: Tensor, labels: Tensor,
                  mask: Optional[Tensor] = None) -> Tensor:
    """Mean token cross-entropy in f32; logits (B, S, V), labels (B, S)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


def loss_fn(model: Model, params, batch: Dict[str, Tensor],
            backend: str = "chunked", remat: str = "dots") -> Tensor:
    """The mean token loss; ``remat`` takes effect only under autograd
    (``models/model.py``)."""
    cfg = model.cfg
    logits = model.logits(params, batch, backend=backend, remat=remat)
    if cfg.family == "vlm":
        # loss only on the text span (logits cover patches ++ text)
        logits = logits[:, cfg.n_patches:]
    return cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


def value_and_grad(model: Model, params, batch: Dict[str, Tensor],
                   backend: str = "chunked", remat: str = "dots"):
    """``(loss, grads)`` of :func:`loss_fn`, as ``jax.value_and_grad``:
    the gradients a tree of the parameters' shape and types (zeros where a
    parameter does not reach the loss)."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(model, tree_unflatten(params, live), batch, backend,
                       remat)
        grads = torch.autograd.grad(loss, live, materialize_grads=True)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(
    model: Model,
    opt: AdamW,
    accum_steps: int = 1,
    backend: str = "chunked",
    remat: str = "dots",
    grad_transform: Optional[Callable] = None,
):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``; with ``grad_transform(grads, ctx) -> (grads, ctx)`` (e.g.
    gradient compression) ``train_step(params, opt_state, batch, ctx) ->
    (params, opt, metrics, ctx)``.  ``metrics``: the loss, the norm of the
    (transformed) gradients and the new step's learning rate, 0-d float32
    tensors on the parameters' device (nothing is read back)."""

    def compute_grads(params, batch):
        if accum_steps == 1:
            return value_and_grad(model, params, batch, backend, remat)
        loss = None
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        for i in range(accum_steps):
            mb = {k: _rows(v, accum_steps, i) for k, v in batch.items()}
            l, g = value_and_grad(model, params, mb, backend, remat)
            loss = l.float() if loss is None else loss + l
            for a, gi in zip(acc, tree_leaves(g)):
                a.add_(gi)
        inv = 1.0 / accum_steps
        return loss * inv, tree_unflatten(params, [a * inv for a in acc])

    def train_step(params, opt_state: AdamWState, batch, grad_ctx=None):
        loss, grads = compute_grads(params, batch)
        if grad_transform is not None:
            grads, grad_ctx = grad_transform(grads, grad_ctx)
        new_params, new_opt = opt.update(grads, opt_state, params)
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                               for g in tree_leaves(grads)))
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": opt.schedule(new_opt.step)}
        if grad_transform is not None:
            return new_params, new_opt, metrics, grad_ctx
        return new_params, new_opt, metrics

    return train_step


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
