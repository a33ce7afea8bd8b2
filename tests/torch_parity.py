"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: the same
numpy inputs go through the JAX package and through its PyTorch port, and
the outputs are compared as numpy arrays.

Tolerances (the reference's own cross-backend ones, tests/test_sweep.py):
integers, bools, gids, ``valid``, the slot layout, ``dropped`` and
``halo_bytes`` exactly; float accumulators and positions to 1e-5 absolute
and relative; count-valued accumulators exactly.
"""

from __future__ import annotations

from typing import Dict

import jax
import numpy as np
import torch

FLOAT_TOL = 1e-5

# torch 2.13's CPU build now and then computes the first multithreaded
# ``torch.sqrt`` of a process wrongly (errors up to ~2e-2 on large
# tensors; every later call is right): its vectorized kernel is set up
# lazily, racing its own threads.  One small call first sets it up.
torch.sqrt(torch.ones(8))


def jax_state_arrays(state) -> Dict[str, np.ndarray]:
    """A JAX ``SimState`` as the field-path dict of ``repro_torch.bridge``."""
    out: Dict[str, np.ndarray] = {}
    for name, a in state.soa.attrs.items():
        out[f"soa.attrs.{name}"] = np.asarray(a)
    out["soa.valid"] = np.asarray(state.soa.valid)
    for edge, slab in state.refs.items():
        for field, a in slab.items():
            out[f"refs.{edge}.{field}"] = np.asarray(a)
    for name in ("it", "key", "gid_counter", "dropped", "halo_bytes",
                 "codec_overflow", "health"):
        out[name] = np.asarray(getattr(state, name))
    return out


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(jax.device_get(x))


def assert_close(got, want, name: str = "", exact: bool = False) -> None:
    """Exact for non-float arrays (and when ``exact``), else FLOAT_TOL."""
    g, w = to_numpy(got), to_numpy(want)
    assert g.shape == w.shape, f"{name}: shape {g.shape} != {w.shape}"
    assert g.dtype == w.dtype, f"{name}: dtype {g.dtype} != {w.dtype}"
    if exact or not np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(g, w, err_msg=name)
    else:
        np.testing.assert_allclose(g, w, atol=FLOAT_TOL, rtol=FLOAT_TOL,
                                   err_msg=name)


def assert_dicts_close(got: Dict, want: Dict, exact_keys=(),
                       skip=()) -> None:
    keys = set(want) - set(skip)
    assert set(got) - set(skip) == keys, sorted(set(got) ^ set(want))
    for k in sorted(keys):
        assert_close(got[k], want[k], name=k, exact=k in exact_keys)


def assert_states_match(port_state, jax_state, skip=()) -> None:
    """Every field of the two states, the RNG ``key`` included (the port's
    threefry keys are JAX's bit for bit)."""
    from repro_torch.bridge import state_to_arrays

    assert_dicts_close(state_to_arrays(port_state),
                       jax_state_arrays(jax_state), skip=skip)


def soa_inputs(n: int, ndim: int, size, seed: int = 0):
    """Seeded numpy positions inside ``size`` and cell_clustering attrs."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.5, np.asarray(size) - 0.5,
                      (n, ndim)).astype(np.float32)
    attrs = {
        "diameter": rng.uniform(0.6, 1.4, n).astype(np.float32),
        "ctype": rng.integers(0, 2, n).astype(np.int32),
    }
    return pos, attrs
