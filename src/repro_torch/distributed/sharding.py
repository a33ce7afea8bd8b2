"""Logical-axis sharding rules with divisibility-aware fallback (port of
``repro/distributed/sharding.py``).

Every parameter and activation dimension carries a logical name; rules
map each logical name to an ordered list of mesh-axis candidates.  A
candidate is taken only if (a) none of its axes is used by another dim of
the same array and (b) its size divides the dim; otherwise the next is
tried, and the dim is replicated when none fits.

A spec is the reference's ``PartitionSpec`` as a tuple, entry for entry:
``None``, an axis name or a tuple of axis names, trailing ``None`` entries
dropped.  :func:`spec_for` reads only ``mesh.shape`` (an ordered mapping
of axis name to size), so a layout-only mesh
(:class:`~repro_torch.distributed.collectives.Mesh` without processes)
gives the specs of any device count.

On a process mesh a rank holds one block of each sharded tensor:
:func:`block_of` cuts it from the whole tensor, :func:`assemble` puts
the whole tensor back together from every rank's block, and
:func:`gather_block` (under autograd) gathers a rank's block over the
mesh, as the reference's ZeRO-3 weights are gathered before use.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

# logical name -> ordered candidate mesh axes (tuples = combined axes)
Rules = Dict[str, Tuple[object, ...]]
Spec = Tuple[object, ...]

# The reference's default rules.  "fsdp" composes data (+pod): the
# weights' embed dim is sharded over the data axes, ZeRO-3 style.
DEFAULT_RULES: Rules = {
    "batch": (("pod", "data"), "data"),
    "seq": ("model",),            # sequence parallelism for long decode
    "vocab": ("model",),
    "embed": ("fsdp",),           # resolved to ("pod","data") or ("data",)
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "layers": (),
    "state": (),
    "conv": (),
    "lora": (),
    "frontend": (),
    "patches": (),
    # activation dims
    "seq_act": (),
    "embed_act": (),
    "vocab_act": ("model",),
    "heads_act": ("model",),
    "mlp_act": ("model",),
    # attention fallback: when heads don't divide the model axis, shard
    # the query sequence dim instead (sequence-parallel attention)
    "qseq_act": ("model",),
    "val_act": ("model",),
    # MoE dispatch: experts over model (EP), capacity over data
    "capacity": ("fsdp",),
}


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _resolve(axis, mesh):
    """Map virtual axes to concrete mesh axes."""
    if axis == "fsdp":
        return ("pod", "data") if "pod" in mesh.shape else ("data",)
    if isinstance(axis, tuple):
        out = [a for a in axis if a in mesh.shape]
        return tuple(out) if out else None
    return axis if axis in mesh.shape else None


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]], mesh,
             rules: Optional[Rules] = None) -> Spec:
    """The spec of an array of ``shape`` whose dims are named ``logical``
    (the reference's ``PartitionSpec``, as a tuple)."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        chosen = None
        if name is not None and name in rules:
            for cand in rules[name]:
                cand = _resolve(cand, mesh)
                if cand is None:
                    continue
                axes = cand if isinstance(cand, tuple) else (cand,)
                if any(a in used for a in axes):
                    continue
                size = math.prod(mesh.shape[a] for a in axes)
                if size > 1 and dim % size == 0:
                    # PartitionSpec writes a one-axis tuple as its name
                    chosen = axes[0] if len(axes) == 1 else cand
                    used.update(axes)
                    break
        parts.append(chosen)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def data_axes(mesh) -> Tuple[str, ...]:
    """The axes the batch splits over (the reference's fsdp axes): ``pod``
    and ``data``, those the mesh has."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``()`` for a replicated dim)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over, in the spec's order."""
    return tuple(a for e in spec for a in entry_axes(e))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``x``."""
        return block_of(x, self.spec, self.mesh)


def sharding_for(shape, logical, mesh, rules=None) -> NamedSharding:
    return NamedSharding(mesh, spec_for(shape, logical, mesh, rules))


def tree_specs(spec_tree, mesh, rules: Optional[Rules] = None):
    """Map a nested dict of ``ParamSpec`` leaves to their specs."""
    from repro_torch.models.params import ParamSpec, tree_map

    def one(leaf):
        if isinstance(leaf, ParamSpec):
            return spec_for(leaf.shape, leaf.logical, mesh, rules)
        raise TypeError(f"unexpected spec leaf {leaf!r}")

    return tree_map(one, spec_tree)


# ---------------------------------------------------------------------------
# Blocks of a sharded tensor
# ---------------------------------------------------------------------------

def _entry_index(entry, mesh, coords) -> Tuple[int, int]:
    """(index of this rank's block, number of blocks) along a dim sharded
    over ``entry``: row-major over the entry's axes, as JAX lays out a
    dim sharded over a tuple of axes."""
    idx, n = 0, 1
    for a in entry_axes(entry):
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return idx, n


def block_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    out = list(shape)
    for d, e in enumerate(spec):
        n = _axis_size(mesh, entry_axes(e)) if e is not None else 1
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"into {n} blocks (spec {spec})")
        out[d] //= n
    return tuple(out)


def block_of(x: torch.Tensor, spec: Spec, mesh,
             coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The block of the whole tensor ``x`` at ``coords`` (default: this
    rank's), a view."""
    coords = mesh.coords if coords is None else coords
    for d, e in enumerate(spec):
        if e is None:
            continue
        i, n = _entry_index(e, mesh, coords)
        size = x.shape[d] // n
        x = x.narrow(d, i * size, size)
    return x


def assemble(blocks: Dict[Tuple[int, ...], torch.Tensor], spec: Spec,
             mesh) -> torch.Tensor:
    """The whole tensor from the blocks of every device, keyed by mesh
    coordinates (a tuple in ``mesh.axis_names`` order).  Devices that
    hold the same block (it is replicated over their axes) must agree on
    it; the first one's is used."""
    first = next(iter(blocks.values()))
    full = list(first.shape)
    for d, e in enumerate(spec):
        if e is not None:
            full[d] *= _axis_size(mesh, entry_axes(e))
    out = torch.empty(full, dtype=first.dtype, device=first.device)
    for key, blk in blocks.items():
        coords = dict(zip(mesh.axis_names, key))
        block_of(out, spec, mesh, coords).copy_(blk)
    return out


def gather_block(x: torch.Tensor, spec: Spec, mesh,
                 keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """This rank's block ``x`` of a tensor of ``spec`` gathered over every
    axis of the spec but those in ``keep``, dim by dim (under autograd:
    ``collectives.all_gather``, whose backward sums over the axes that
    shard the batch and takes this rank's block over the others)."""
    from repro_torch.distributed import collectives as col

    for d, e in enumerate(spec):
        axes = tuple(a for a in entry_axes(e) if a not in keep)
        if not axes:
            continue
        if axes != entry_axes(e):
            raise NotImplementedError(
                f"gathering dim {d} over {axes} of its axes {entry_axes(e)}")
        x = col.all_gather(x, axes, mesh, dim=d)
    return x


# ---------------------------------------------------------------------------
# Activation sharding (the reference's MaxText-style constraints)
# ---------------------------------------------------------------------------

# The active (mesh, rules), process-wide: a remat recompute runs in the
# backward, which autograd runs on a device thread of its own, so a
# thread-local context (the reference's) would not be seen there.
_ACTIVE = [None]


@contextlib.contextmanager
def activation_sharding(mesh, rules: Optional[Rules] = None):
    """While active, the model runs over ``mesh``: its parameters are this
    rank's blocks (gathered before use), the batch is this rank's block
    of the global batch, and the MoE runs expert-parallel
    (``models.moe.moe_apply_ep``).  Outside it everything runs on one
    device, as the reference's ``constrain`` is a no-op there."""
    old = _ACTIVE[0]
    _ACTIVE[0] = (mesh, rules)
    try:
        yield
    finally:
        _ACTIVE[0] = old


def active():
    """``(mesh, rules)`` of the active :func:`activation_sharding`, or
    None."""
    return _ACTIVE[0]


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """Identity on values.  In the reference it pins an activation's
    sharding (``with_sharding_constraint``), a placement hint to XLA that
    changes no value; the port places activations itself (each rank
    holds its batch block, the expert-parallel MoE moves its tokens
    explicitly), so there is nothing to pin."""
    return x
