"""Scoring and serving step functions (port of ``repro/training/steps.py``).

``loss_fn`` is the forward only: ``make_train_step``, its optimizer and a
backward through the attention kernel wait for the training slice (ROADMAP
A12).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Model

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
            backend: str = "chunked") -> Tensor:
    cfg = model.cfg
    logits = model.logits(params, batch, backend=backend)
    if cfg.family == "vlm":
        # loss only on the text span (logits cover patches ++ text)
        logits = logits[:, cfg.n_patches:]
    return cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


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
