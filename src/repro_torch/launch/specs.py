"""Abstract parameter and optimizer specs (port of
``repro/launch/specs.py``: ``params_specs``, ``opt_specs`` and
``rules_for``).  The rest of that module (the dry run's inputs, batches
and caches of every cell) comes with the dry run.

A spec here is a ``meta``-device tensor of the leaf's shape and dtype
carrying its ``sharding`` (``distributed.sharding.NamedSharding``) on a
mesh, as the reference's ``ShapeDtypeStruct`` leaves carry theirs.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import abstract, abstract_sharded, tree_map


def params_specs(model, mesh, rules=None):
    """The model's parameters as abstract tensors, sharded over ``mesh``
    (none without one)."""
    if mesh is None:
        return abstract(model.spec)
    return abstract_sharded(model.spec, mesh, rules)


def opt_specs(params_abs, mesh=None):
    """AdamW's state mirrors the parameter tree in float32 (master, m, v,
    each leaf with its parameter's sharding) plus a scalar int32 step."""
    from repro_torch.training.optimizer import AdamWState

    def f32_like(p):
        t = torch.empty(p.shape, dtype=torch.float32, device="meta")
        sharding = getattr(p, "sharding", None)
        if sharding is not None:
            t.sharding = sharding
        return t

    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      master=tree_map(f32_like, params_abs),
                      m=tree_map(f32_like, params_abs),
                      v=tree_map(f32_like, params_abs))


# Per-family sharding-rule overrides: none, as in the reference.
FAMILY_RULES: Dict[str, Dict] = {}


def rules_for(cfg: ArchConfig, rules=None):
    fam = FAMILY_RULES.get(cfg.family, {})
    return {**fam, **(rules or {})} if (fam or rules) else None
