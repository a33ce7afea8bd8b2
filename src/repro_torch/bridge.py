"""Carry a simulation state between the JAX package and the port as plain
numpy arrays.

The dict is keyed by ``SimState`` field paths: ``soa.attrs.<name>``,
``soa.valid``, ``refs.<edge>.<field>``, ``it``, ``key``, ``gid_counter``,
``dropped``, ``halo_bytes``, ``codec_overflow``, ``health``.  The layouts
and dtypes are the same on both sides, so the conversion is exact (the RNG
``key`` included: it is carried unchanged, uint32).  This module imports no
JAX: a caller that holds a JAX state builds the dict with ``np.asarray`` on
each leaf.  Behaviour ``params`` are plain Python floats on both sides and
need no bridge.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.agent_soa import AgentSoA
from repro_torch.core.engine import SimState
from repro_torch.device import DeviceLike, resolve_device

_SCALARS = ("it", "key", "gid_counter", "dropped", "halo_bytes",
            "codec_overflow", "health")


def state_to_arrays(state: SimState) -> Dict[str, np.ndarray]:
    """Every leaf of ``state`` as a numpy array, keyed by field path."""
    out: Dict[str, np.ndarray] = {}
    for name, a in state.soa.attrs.items():
        out[f"soa.attrs.{name}"] = a.cpu().numpy()
    out["soa.valid"] = state.soa.valid.cpu().numpy()
    for edge, slab in state.refs.items():
        for field, a in slab.items():
            out[f"refs.{edge}.{field}"] = a.cpu().numpy()
    for name in _SCALARS:
        out[name] = getattr(state, name).cpu().numpy()
    return out


def state_from_arrays(arrays: Dict[str, np.ndarray],
                      device: DeviceLike = "cuda") -> SimState:
    """The inverse of :func:`state_to_arrays`, on ``device``."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    attrs, refs = {}, {}
    for path, a in arrays.items():
        head, _, rest = path.partition(".")
        if path.startswith("soa.attrs."):
            attrs[path[len("soa.attrs."):]] = t(a)
        elif head == "refs":
            edge, _, field = rest.partition(".")
            refs.setdefault(edge, {})[field] = t(a)
        elif path != "soa.valid" and path not in _SCALARS:
            raise KeyError(f"unknown SimState field path {path!r}")
    return SimState(
        soa=AgentSoA(attrs=attrs, valid=t(arrays["soa.valid"])),
        refs=refs, **{name: t(arrays[name]) for name in _SCALARS})
