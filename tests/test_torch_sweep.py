"""Parity of the port's interaction sweep with the JAX package.

Each port backend is held against its JAX counterpart on the same state,
for both pair laws of the cell-clustering slice and both boundaries:
``pair_accumulate`` vs JAX ``reference``, ``pair_accumulate_tiled`` vs
``tiled``, and the kernel's plain version ``pair_sweep_plain`` (the
``kernel`` backend on a CPU tensor) vs ``pallas`` (the Pallas kernel in
interpret mode, as tests/test_sweep.py runs it).  Float accumulators to
1e-5, count accumulators (same, cnt) exactly.

The legacy soft-sphere entry point ``ops.neighbor_force`` (the plain
version of its kernel on a CPU tensor) is held against JAX
``ops.neighbor_force`` (the Pallas kernel in interpret mode) to 1e-5, the
reference's own tolerance (tests/test_kernels.py).

The laws of the other bundled sims - ``epidemiology._pair`` (an
infected-neighbour count), ``oncology._pair`` (the force plus a neighbour
count) - and ``compose()`` stacks - sir_mechanics' force + SIR stack, the
SIR part gated to its own radius, and ``compose(b)`` of one law - are
held the same way on a sir_mechanics state, counts exactly.

The CUDA kernels themselves are held against their plain versions in
tests/test_torch_kernel.py.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import Domain as JDomain
from repro.core import Engine as JEngine
from repro.core.grid import clear_ring
from repro.core.halo import LocalComm, halo_exchange
from repro.core.neighbors import sweep_accumulate as j_sweep
from repro.kernels import ops as j_ops
from repro.core.behaviors import compose as j_compose
from repro.sims import cell_clustering as j_cc
from repro.sims import epidemiology as j_ep
from repro.sims import oncology as j_onc
from repro.sims import sir_mechanics as j_sm
from repro_torch.bridge import state_from_arrays
from repro_torch.core import Domain
from repro_torch.core.engine import device_block
from repro_torch.core.neighbors import (
    pair_accumulate,
    pair_accumulate_kernel,
    pair_accumulate_tiled,
    resolve_sweep_backend,
    sweep_accumulate,
)
from repro_torch.kernels import neighbor_interaction as ni
from repro_torch.kernels import ops
from repro_torch.core.behaviors import compose
from repro_torch.sims import cell_clustering as cc
from repro_torch.sims import epidemiology as ep
from repro_torch.sims import oncology as onc
from repro_torch.sims import sir_mechanics as sm
from torch_parity import (
    assert_dicts_close, jax_state_arrays, soa_inputs, torch_threads,
)


# Small-tensor loops: one torch thread (beside busy test workers torch's
# thread pool slows them many times over).
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


COUNT_KEYS = ("same", "cnt")

# law -> (JAX pair_fn, port pair_fn, pair_attrs, params)
LAWS = {
    "soft_repulsion_adhesion": (
        j_cc.behavior().pair_fn, cc.behavior().pair_fn,
        ("diameter", "ctype"), dict(cc.behavior().params)),
    "same_type": (j_cc._same_type_pair, cc._same_type_pair, ("ctype",), {}),
}

PORT = {
    "reference": pair_accumulate,
    "tiled": pair_accumulate_tiled,
    "pallas": pair_accumulate_kernel,    # the kernel's plain version on CPU
}


@functools.lru_cache(maxsize=None)
def _case(boundary, interior=(6, 6), n=260, seed=0):
    """A post-exchange JAX state (ring filled) and its port twin."""
    kw = dict(cell_size=2.0, interior=interior, cap=16, boundary=boundary)
    geom_j = JDomain(**kw)
    pos, attrs = soa_inputs(n, len(interior), geom_j.domain_size, seed)
    eng = JEngine(geom=geom_j, behavior=j_cc.behavior(), dt=0.1)
    st = eng.init_state(pos, attrs, seed=seed)
    # one step so the SoA is a mid-run one, then refill the ring so the
    # sweep sees neighbours across the boundary as the engine's sweep does
    st = eng.make_local_step()(st)
    refs = {d: {f: v[(0,) * len(interior)] for f, v in s.items()}
            for d, s in st.refs.items()}
    soa_j, _, _, _ = halo_exchange(
        geom_j, clear_ring(st.soa), LocalComm(toroidal=geom_j.toroidal),
        refs, eng.delta_cfg, True)
    st_t = state_from_arrays(
        jax_state_arrays(dataclasses.replace(st, soa=soa_j)), device="cpu")
    return (geom_j, Domain(**kw), soa_j,
            device_block(st_t.soa, (0,) * len(interior)))


@functools.lru_cache(maxsize=None)
def _jax_sweep(law, boundary, backend, interior=(6, 6)):
    geom_j, _, soa_j, _ = _case(boundary, interior)
    pair_j, _, pattrs, params = LAWS[law]
    fn = jax.jit(lambda soa: j_sweep(geom_j, soa, pair_j, pattrs, 2.0,
                                     params, backend=backend))
    return {k: np.asarray(v) for k, v in fn(soa_j).items()}


@pytest.mark.parametrize("backend", ["reference", "tiled", "pallas"])
@pytest.mark.parametrize("boundary", ["closed", "toroidal"])
@pytest.mark.parametrize("law", sorted(LAWS))
def test_port_sweep_matches_jax(law, boundary, backend):
    want = _jax_sweep(law, boundary, backend)
    _, geom_t, _, soa_t = _case(boundary)
    _, pair_t, pattrs, params = LAWS[law]
    got = PORT[backend](geom_t, soa_t, pair_t, pattrs, 2.0, params)
    assert_dicts_close(got, want, exact_keys=COUNT_KEYS)
    if law == "same_type":
        assert float(got["cnt"].sum()) > 0


# law -> (JAX pair_fn, port pair_fn, pair_attrs, params, count outputs)
ABM_LAWS = {
    "epidemiology": (j_ep._pair, ep._pair, ("state",), {}, ("n_inf",)),
    "oncology": (j_onc._pair, onc._pair, ("diameter", "ctype"),
                 dict(onc.behavior().params), ("crowd",)),
    "stack": (j_sm.behavior().pair_fn, sm.behavior().pair_fn,
              sm.behavior().pair_attrs, sm.behavior().params,
              ("b1.n_inf",)),
    "compose_one": (j_compose(j_cc.behavior()).pair_fn,
                    compose(cc.behavior()).pair_fn, ("diameter", "ctype"),
                    compose(cc.behavior()).params, ()),
}


@functools.lru_cache(maxsize=None)
def _abm_case(boundary, n=320, seed=0):
    """A sir_mechanics state (diameters, types, S/I/R) with its ring
    filled, in JAX and as the port's twin."""
    kw = dict(cell_size=2.0, interior=(6, 6), cap=24, boundary=boundary)
    geom_j = JDomain(**kw)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.5, 11.5, (n, 2)).astype(np.float32)
    attrs = {"diameter": rng.uniform(0.6, 1.4, n).astype(np.float32),
             "ctype": rng.integers(0, 2, n).astype(np.int32),
             "state": rng.integers(0, 3, n).astype(np.int32)}
    eng = JEngine(geom=geom_j, behavior=j_sm.behavior(), dt=1.0)
    st = eng.init_state(pos, attrs, seed=seed)
    refs = {d: {f: v[0, 0] for f, v in s.items()}
            for d, s in st.refs.items()}
    soa_j, _, _, _ = halo_exchange(
        geom_j, clear_ring(st.soa), LocalComm(toroidal=geom_j.toroidal),
        refs, eng.delta_cfg, True)
    st_t = state_from_arrays(
        jax_state_arrays(dataclasses.replace(st, soa=soa_j)), device="cpu")
    return geom_j, Domain(**kw), soa_j, device_block(st_t.soa, (0, 0))


@pytest.mark.parametrize("backend", ["reference", "tiled", "pallas"])
@pytest.mark.parametrize("boundary", ["closed", "toroidal"])
@pytest.mark.parametrize("law", sorted(ABM_LAWS))
def test_port_abm_law_sweep_matches_jax(law, boundary, backend):
    """Laws 2 and 3 and the stacks: the port's backends (the kernel's
    plain version for "pallas") against JAX's, the Pallas kernel in
    interpret mode included."""
    geom_j, geom_t, soa_j, soa_t = _abm_case(boundary)
    pair_j, pair_t, pattrs, params, counts = ABM_LAWS[law]
    fn = jax.jit(lambda soa: j_sweep(geom_j, soa, pair_j, pattrs, 2.0,
                                     params, backend=backend))
    want = {k: np.asarray(v) for k, v in fn(soa_j).items()}
    got = PORT[backend](geom_t, soa_t, pair_t, pattrs, 2.0, params)
    assert_dicts_close(got, want, exact_keys=counts)
    for c in counts:
        assert float(got[c].sum()) > 0


@pytest.mark.parametrize("backend", ["reference", "tiled", "kernel"])
def test_port_sweep_3d_matches_jax_tiled(backend):
    """The 3-D (27-offset) stencil on the CPU paths, against JAX tiled."""
    interior = (4, 4, 3)
    want = _jax_sweep("soft_repulsion_adhesion", "toroidal", "tiled",
                      interior)
    _, geom_t, _, soa_t = _case("toroidal", interior)
    _, pair_t, pattrs, params = LAWS["soft_repulsion_adhesion"]
    got = sweep_accumulate(geom_t, soa_t, pair_t, pattrs, 2.0, params,
                           backend=backend)
    assert_dicts_close(got, want)


def test_resolve_sweep_backend():
    assert resolve_sweep_backend("auto", torch.device("cpu")) == "tiled"
    assert resolve_sweep_backend("auto", torch.device("cuda")) == "kernel"
    assert resolve_sweep_backend("kernel", torch.device("cpu")) == "kernel"
    with pytest.raises(ValueError):
        resolve_sweep_backend("pallas", torch.device("cpu"))


def test_unregistered_pair_law_raises():
    def other_pair(ai, aj, disp, dist2, params):
        return {"n": torch.ones_like(dist2)}

    with pytest.raises(NotImplementedError, match="ROADMAP B1"):
        ni.law_for(other_pair)
    assert ni.law_for(cc._same_type_pair).name == "same_type"
    # the registered laws of the other bundled sims
    assert ni.law_for(ep._pair).name == "epidemiology"
    assert ni.law_for(onc._pair).outputs == (("force", True),
                                             ("crowd", False))
    # a stack resolves part by part; one with an unregistered part raises
    assert ni.law_for(sm.behavior().pair_fn).parts == (
        "soft_repulsion_adhesion", "epidemiology")
    other = dataclasses.replace(cc.behavior(), pair_fn=other_pair)
    with pytest.raises(NotImplementedError, match="ROADMAP B1"):
        ni.law_for(compose(cc.behavior(), other).pair_fn)
    with pytest.raises(NotImplementedError, match="ROADMAP B1 a"):
        ni.law_for(compose(ep.behavior(), cc.behavior()).pair_fn)


def _random_cells(rng, c, k):
    """Gathered (C, K) slabs: pos, diameter, type, valid, gid (numpy)."""
    return (rng.uniform(0, 10, (c, k, 2)).astype(np.float32),
            rng.uniform(0.5, 1.5, (c, k)).astype(np.float32),
            rng.integers(0, 2, (c, k)).astype(np.int32),
            rng.random((c, k)) < 0.8,
            rng.integers(0, 10_000, (c, k)).astype(np.int32))


@pytest.mark.parametrize("same_type_only", [True, False])
@pytest.mark.parametrize("c,k", [(8, 8), (16, 16), (4, 32)])
def test_neighbor_force_matches_jax(c, k, same_type_only):
    rng = np.random.default_rng(c * k)
    args = _random_cells(rng, c, k) + _random_cells(rng, c, 9 * k)
    # a neighbourhood slot that is the self slot itself: same gid, excluded
    for a in (0, 1, 2, 4):
        args[5 + a][:, 4] = args[a][:, 0]
    kw = dict(radius=2.0, repulsion=2.0, adhesion=0.4,
              same_type_only=same_type_only)
    want = np.asarray(j_ops.neighbor_force(*map(jax.numpy.asarray, args),
                                           **kw))
    before = dict(ni.LAUNCHES)
    got = ops.neighbor_force(*map(torch.from_numpy, args), **kw)
    assert ni.LAUNCHES == before          # a CPU tensor never counts
    assert got.dtype == torch.float32 and got.shape == (c, k, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.abs(want).max() > 0
