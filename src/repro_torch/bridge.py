"""Carry a simulation state, and a language model's parameters, between
the JAX package and the port as plain numpy arrays.

The dict is keyed by ``SimState`` field paths: ``soa.attrs.<name>``,
``soa.valid``, ``refs.<edge>.<field>``, ``it``, ``key``, ``gid_counter``,
``dropped``, ``halo_bytes``, ``codec_overflow``, ``health``, in the
reference's global layout: the agent SoA block-concatenated over the
device mesh, ``(M0*h0, M1*h1[, M2*h2], K, ...)``, every other field with
the mesh dims leading.  The port keeps the SoA as ``mesh_shape +
local_shape + (K, ...)`` (see ``core.engine``); the two conversions below
only reorder axes, so they are exact (the RNG ``key`` included: it is
carried unchanged, uint32).  This module imports no JAX: a caller that
holds a JAX state builds the dict with ``np.asarray`` on each leaf.
Behaviour ``params`` are plain Python floats on both sides and need no
bridge.  An ensemble's state (:func:`ensemble_to_arrays`,
:func:`ensemble_from_arrays`) carries the same paths with a leading lane
axis, each lane in that global layout, plus ``params.<name>`` (the
``(R,)`` float32 points, host tensors in the port) and ``active``: the
leaves of the reference's ``EnsembleState``.

A process mesh (one process a device, ``core.halo.ProcessMeshComm``)
holds one device's block a rank, with all-ones leading mesh dims:
:func:`rank_arrays` writes a rank's state as numpy in the port's layout,
:func:`assemble_ranks` puts the ranks' blocks together into the virtual
mesh's ``SimState``, and :func:`rank_state` takes one device's block out
of a virtual-mesh state as the state its process would hold.

LM parameters (:func:`lm_params_from_arrays`, :func:`lm_params_to_arrays`)
are keyed by the reference tree's dotted paths (``embed.w``,
``blocks.attn.wq``, ...), the paths the port's ``models.model.Model``
keeps, so nothing is renamed.  An optimizer state
(:func:`adamw_state_to_arrays`, :func:`adamw_state_from_arrays`) is keyed
``step``, ``master.<path>``, ``m.<path>``, ``v.<path>`` (the fields of
``AdamWState``), and a gradient compressor's context
(:func:`grad_ctx_to_arrays`, :func:`grad_ctx_from_arrays`) ``step``,
``ref.<path>``, ``residual.<path>``: a JAX tree of either carries across
with the same helpers applied to its leaves.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.agent_soa import AgentSoA
from repro_torch.core.engine import SimState
from repro_torch.core.ensemble import (
    EnsembleState, replica_state, stack_states,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.training.optimizer import AdamWState

_SCALARS = ("it", "key", "gid_counter", "dropped", "halo_bytes",
            "codec_overflow", "health")


def mesh_to_global(a: np.ndarray, nd: int) -> np.ndarray:
    """``mesh + local + rest`` (``nd`` axes each) -> the block-concatenated
    ``(M0*h0, ..., rest)``."""
    perm = [ax for pair in zip(range(nd), range(nd, 2 * nd)) for ax in pair]
    perm += list(range(2 * nd, a.ndim))
    glob = tuple(a.shape[i] * a.shape[nd + i] for i in range(nd))
    return a.transpose(perm).reshape(glob + a.shape[2 * nd:])


def global_to_mesh(a: np.ndarray, mesh: Sequence[int]) -> np.ndarray:
    """The inverse of :func:`mesh_to_global`."""
    nd = len(mesh)
    local = [g // m for g, m in zip(a.shape[:nd], mesh)]
    split = [v for m, h in zip(mesh, local) for v in (m, h)]
    b = a.reshape(tuple(split) + a.shape[nd:])
    perm = ([2 * i for i in range(nd)] + [2 * i + 1 for i in range(nd)]
            + list(range(2 * nd, b.ndim)))
    return b.transpose(perm)


def state_to_arrays(state: SimState) -> Dict[str, np.ndarray]:
    """Every leaf of ``state`` as a numpy array in the reference's global
    layout, keyed by field path."""
    nd = state.it.dim()
    return {k: mesh_to_global(v, nd) if k.startswith("soa.") else v
            for k, v in rank_arrays(state).items()}


def state_from_arrays(arrays: Dict[str, np.ndarray],
                      device: DeviceLike = "cuda") -> SimState:
    """The inverse of :func:`state_to_arrays`, on ``device``."""
    dev = resolve_device(device)
    mesh = np.shape(arrays["it"])

    def t(path, a):
        if path.startswith("soa."):
            a = global_to_mesh(np.asarray(a), mesh)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return _from_leaves({k: t(k, a) for k, a in arrays.items()})


def _leaves(state: SimState) -> Dict[str, torch.Tensor]:
    """Every leaf of ``state`` in the port's layout, keyed by field path."""
    out = {f"soa.attrs.{n}": a for n, a in state.soa.attrs.items()}
    out["soa.valid"] = state.soa.valid
    for edge, slab in state.refs.items():
        for field, a in slab.items():
            out[f"refs.{edge}.{field}"] = a
    for name in _SCALARS:
        out[name] = getattr(state, name)
    return out


def _from_leaves(leaves: Mapping[str, torch.Tensor]) -> SimState:
    """The inverse of :func:`_leaves`."""
    attrs, refs = {}, {}
    for path, a in leaves.items():
        head, _, rest = path.partition(".")
        if path.startswith("soa.attrs."):
            attrs[path[len("soa.attrs."):]] = a
        elif head == "refs":
            edge, _, field = rest.partition(".")
            refs.setdefault(edge, {})[field] = a
        elif path != "soa.valid" and path not in _SCALARS:
            raise KeyError(f"unknown SimState field path {path!r}")
    return SimState(soa=AgentSoA(attrs=attrs, valid=leaves["soa.valid"]),
                    refs=refs, **{n: leaves[n] for n in _SCALARS})


def rank_arrays(state: SimState) -> Dict[str, np.ndarray]:
    """One process's state of a process mesh (its device's block, every
    leaf behind all-ones leading mesh dims) as numpy arrays keyed by field
    path, in the port's layout."""
    return {k: v.cpu().numpy() for k, v in _leaves(state).items()}


def assemble_ranks(blocks: Mapping[Tuple[int, ...], Dict[str, np.ndarray]],
                   device: DeviceLike = "cuda") -> SimState:
    """The virtual mesh's ``SimState`` (``mesh_shape`` leading dims) from
    every rank's :func:`rank_arrays`, keyed by its device's mesh
    coordinates."""
    dev = resolve_device(device)
    coords = sorted(blocks)
    nd = len(coords[0])
    mesh = tuple(max(c[a] for c in coords) + 1 for a in range(nd))
    if len(coords) != math.prod(mesh):
        raise ValueError(f"{len(coords)} blocks for a mesh of {mesh}")
    one = (0,) * nd
    first = blocks[coords[0]]
    leaves = {}
    for path, a in first.items():
        out = np.empty(mesh + a.shape[nd:], dtype=a.dtype)
        for c in coords:
            out[c] = blocks[c][path][one]
        leaves[path] = torch.from_numpy(out).to(dev)
    return _from_leaves(leaves)


def rank_state(state: SimState, coords: Tuple[int, ...]) -> SimState:
    """Device ``coords``' block of a virtual-mesh state as the state its
    process holds on a process mesh (all-ones leading dims; a copy)."""
    nd = len(coords)
    coords = tuple(int(c) for c in coords)
    return _from_leaves({
        k: v[coords].reshape((1,) * nd + tuple(v.shape[nd:])).clone()
        for k, v in _leaves(state).items()})


def ensemble_to_arrays(estate: EnsembleState) -> Dict[str, np.ndarray]:
    """Every leaf of an ensemble state as numpy: the lanes' state paths
    (leading lane axis), ``params.<name>`` and ``active``."""
    lanes = [state_to_arrays(replica_state(estate.state, r))
             for r in range(estate.replicas)]
    out = {k: np.stack([lane[k] for lane in lanes]) for k in lanes[0]}
    for name, v in estate.params.items():
        out[f"params.{name}"] = v.cpu().numpy()
    out["active"] = np.array(estate.active, dtype=bool)
    return out


def ensemble_from_arrays(arrays: Dict[str, np.ndarray],
                         device: DeviceLike = "cuda") -> EnsembleState:
    """The inverse of :func:`ensemble_to_arrays`, on ``device``."""
    dev = resolve_device(device)
    active = np.array(arrays["active"], dtype=bool)
    paths = {k: np.asarray(a) for k, a in arrays.items()
             if k != "active" and not k.startswith("params.")}
    lanes = [state_from_arrays({k: a[r] for k, a in paths.items()}, dev)
             for r in range(active.shape[0])]
    params = {k[len("params."):]: torch.from_numpy(
                  np.array(a, dtype=np.float32))
              for k, a in arrays.items() if k.startswith("params.")}
    return EnsembleState(state=stack_states(lanes), params=params,
                         active=active)


def _bf16_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy bfloat16 array (ml_dtypes' type, which ``torch.from_numpy``
    refuses) carried as its 16 bits."""
    bits = np.ascontiguousarray(a).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def lm_params_from_arrays(arrays: Mapping[str, np.ndarray],
                          device: DeviceLike = "cuda"):
    """``{dotted path: array}`` -> the nested parameter tree on ``device``,
    each array's type kept (bfloat16 included) and its values exact."""
    dev = resolve_device(device)
    tree: Dict = {}
    for path, a in arrays.items():
        a = np.asarray(a)
        t = (_bf16_tensor(a) if a.dtype.name == "bfloat16"
             else torch.from_numpy(np.array(a, copy=True)))
        *heads, leaf = path.split(".")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = t.to(dev)
    return tree


def lm_params_to_arrays(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """The inverse of :func:`lm_params_from_arrays`, keyed by dotted path.
    numpy has no bfloat16 of its own, so a bfloat16 tensor comes back as
    float32 holding the same values exactly."""
    out: Dict[str, np.ndarray] = {}
    for name, v in params.items():
        path = f"{prefix}{name}"
        if isinstance(v, dict):
            out.update(lm_params_to_arrays(v, prefix=f"{path}."))
        else:
            v = v.detach().cpu()
            out[path] = (v.float() if v.dtype == torch.bfloat16
                         else v).numpy()
    return out


def _trees_to_arrays(step, trees: Mapping[str, object]
                     ) -> Dict[str, np.ndarray]:
    out = {"step": np.asarray(step.detach().cpu().numpy(), dtype=np.int32)}
    for name, tree in trees.items():
        out.update(lm_params_to_arrays(tree, prefix=f"{name}."))
    return out


def _trees_from_arrays(arrays: Mapping[str, np.ndarray], names,
                       device: DeviceLike):
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(arrays["step"])), dtype=torch.int32,
                        device=dev)
    trees = {name: lm_params_from_arrays(
        {k[len(name) + 1:]: a for k, a in arrays.items()
         if k.startswith(name + ".")}, dev) for name in names}
    return step, trees


def adamw_state_to_arrays(state: AdamWState) -> Dict[str, np.ndarray]:
    """An ``AdamWState`` as ``{"step", "master.<path>", "m.<path>",
    "v.<path>"}`` numpy arrays (float32 moments and master, int32 step)."""
    return _trees_to_arrays(state.step, {"master": state.master,
                                         "m": state.m, "v": state.v})


def adamw_state_from_arrays(arrays: Mapping[str, np.ndarray],
                            device: DeviceLike = "cuda") -> AdamWState:
    """The inverse of :func:`adamw_state_to_arrays`, on ``device``."""
    step, trees = _trees_from_arrays(arrays, ("master", "m", "v"), device)
    return AdamWState(step=step, **trees)


def grad_ctx_to_arrays(ctx) -> Dict[str, np.ndarray]:
    """A ``DeltaEFCompressor`` context as ``{"step", "ref.<path>",
    "residual.<path>"}`` numpy arrays."""
    return _trees_to_arrays(ctx["step"], {"ref": ctx["ref"],
                                          "residual": ctx["residual"]})


def grad_ctx_from_arrays(arrays: Mapping[str, np.ndarray],
                         device: DeviceLike = "cuda"):
    """The inverse of :func:`grad_ctx_to_arrays`, on ``device``."""
    step, trees = _trees_from_arrays(arrays, ("ref", "residual"), device)
    return dict(trees, step=step)
