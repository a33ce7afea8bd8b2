"""Parameter specification trees: shape + dtype + logical axis names + init
(port of ``repro/models/params.py``).

Models declare their parameters as a nested dict of ``ParamSpec``; ``init``
turns the tree into tensors on one device.  The dry run's ``abstract`` and
``abstract_sharded`` come with the launchers (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"        # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict (a ``ParamSpec`` or a tensor)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def init(spec_tree, generator: torch.Generator,
         device: DeviceLike = "cuda"):
    """Tensors for every spec of ``spec_tree`` on ``device``, drawn from
    ``generator`` (which must live on that device) leaf by leaf in the
    tree's order: normal draws in float32 times the scale, then cast, as
    the reference does.  The numbers differ from ``jax.random``'s: tests
    carry the reference's weights through ``repro_torch.bridge``."""
    dev = resolve_device(device)

    def one(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        fan_in = s.shape[0] if len(s.shape) > 1 else max(s.shape[-1], 1)
        scale = s.scale if s.init == "normal" else 1.0 / math.sqrt(fan_in)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w * scale).to(s.dtype)

    return tree_map(one, spec_tree)


def count_params(spec_tree) -> int:
    """Exact parameter count from a spec tree."""
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree))
