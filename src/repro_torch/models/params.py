"""Parameter specification trees: shape + dtype + logical axis names + init
(port of ``repro/models/params.py``).

Models declare their parameters as a nested dict of ``ParamSpec``; ``init``
turns the tree into tensors on one device, or with ``mesh=`` each leaf's
block of an LM mesh.  ``abstract`` turns the tree into ``meta``-device
tensors of its shapes and types (no allocation), and
``abstract_sharded`` gives them the sharding of a mesh: each carries a
``sharding`` attribute (``distributed.sharding.NamedSharding``), as the
reference's ``ShapeDtypeStruct`` leaves carry theirs.
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
    """The leaves of a nested dict, keys sorted (``jax.tree_util``'s
    order, so trees built in any key order line up)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A nested dict of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves`' order)."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        return next(it)

    return rec(like)


def abstract(spec_tree):
    """``meta`` tensors of every spec's shape and dtype."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), spec_tree)


def abstract_sharded(spec_tree, mesh, rules=None):
    """:func:`abstract`, each tensor carrying ``.sharding``: its spec on
    ``mesh`` (the whole shape; ``sharding.block_shape`` gives a rank's)."""
    from repro_torch.distributed.sharding import sharding_for

    def one(s: ParamSpec):
        t = torch.empty(s.shape, dtype=s.dtype, device="meta")
        t.sharding = sharding_for(s.shape, s.logical, mesh, rules)
        return t

    return tree_map(one, spec_tree)


_WHOLE_DRAW = 2 ** 30    # elements: a larger leaf is drawn a slice at a time


def init(spec_tree, generator: torch.Generator,
         device: DeviceLike = "cuda", mesh=None, rules=None):
    """Tensors for every spec of ``spec_tree`` on ``device``, drawn from
    ``generator`` (which must live on that device) leaf by leaf in the
    tree's order: normal draws in float32 times the scale, then cast, as
    the reference does.  A leaf of more than ``2**30`` elements (a stack of
    a MoE model's expert weights) is drawn one slice of its leading axis
    at a time, so the float32 draw never holds the whole leaf.  The numbers
    differ from ``jax.random``'s: tests carry the reference's weights
    through ``repro_torch.bridge``.  With an LM ``mesh`` every rank draws
    each whole leaf in turn (the same generator state on every rank) and
    keeps its block (``sharding.tree_specs`` under ``rules``)."""
    dev = resolve_device(device)

    def draw(shape, scale, dtype):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w * scale).to(dtype)

    def one(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        fan_in = s.shape[0] if len(s.shape) > 1 else max(s.shape[-1], 1)
        scale = s.scale if s.init == "normal" else 1.0 / math.sqrt(fan_in)
        if math.prod(s.shape) <= _WHOLE_DRAW:
            return draw(s.shape, scale, s.dtype)
        out = torch.empty(s.shape, dtype=s.dtype, device=dev)
        for i in range(s.shape[0]):
            out[i] = draw(s.shape[1:], scale, s.dtype)
        return out

    if mesh is None:
        return tree_map(one, spec_tree)
    from repro_torch.distributed.sharding import block_of, spec_for

    return tree_map(lambda s: block_of(one(s), spec_for(
        s.shape, s.logical, mesh, rules), mesh).clone(), spec_tree)


def count_params(spec_tree) -> int:
    """Exact parameter count from a spec tree."""
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree))
