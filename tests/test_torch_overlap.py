"""The port's uneven-ownership helpers and its overlapped interior/boundary
sweep against the JAX package, in process (no ``shard_map``, no
subprocess), on single blocks built from the same numpy inputs.

* ``cell_of``/``bin_agents`` with ``owned`` (the clamp at the owned
  extent), ``owned_mask``, ``mask_unowned`` and a one-device
  ``halo_exchange(..., owned)`` equal JAX's exactly.
* ``sweep_accumulate_overlapped`` equals JAX's on the same pre- and
  post-exchange blocks, with ``owned=None`` and with an uneven ``owned``,
  in 2-D (the soft-sphere force, float sums) and 3-D (the spheroid's
  force + crowd stack): the port's ``reference`` and ``tiled`` against
  JAX's ``reference`` (the parity oracle), and in 2-D the kernel's plain
  version against the Pallas kernel in interpret mode (in 3-D against
  JAX's ``reference`` too).  Floats to 1e-5, counts exactly.
* The port's split equals its own monolithic sweep of the post-exchange
  block bit for bit at every owned cell, per backend, as the reference
  pins its own (tests/test_sweep.py).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import DeltaConfig as JDeltaConfig
from repro.core import Domain as JDomain
from repro.core import Engine as JEngine
from repro.core.grid import bin_agents_jit as j_bin_agents
from repro.core.grid import clear_ring as j_clear_ring
from repro.core.grid import mask_unowned as j_mask_unowned
from repro.core.grid import owned_mask as j_owned_mask
from repro.core.halo import LocalComm as JLocalComm
from repro.core.halo import halo_exchange as j_halo_exchange
from repro.core.neighbors import (
    sweep_accumulate_overlapped as j_overlapped,
)
from repro.sims import cell_clustering as j_cc
from repro.sims import tumor_spheroid as j_ts
from repro_torch.bridge import state_from_arrays
from repro_torch.core import DeltaConfig, Domain
from repro_torch.core.agent_soa import AgentSoA
from repro_torch.core.engine import device_block
from repro_torch.core.grid import (
    bin_agents, clear_ring, mask_unowned, mesh_owned_mask, owned_mask,
    take_plane,
)
from repro_torch.core.halo import LocalComm, halo_exchange
from repro_torch.core.neighbors import (
    sweep_accumulate, sweep_accumulate_overlapped,
)
from repro_torch.sims import cell_clustering as cc
from repro_torch.sims import tumor_spheroid as ts
from torch_parity import (
    assert_close, assert_dicts_close, jax_state_arrays, torch_threads,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


# name -> (interior, boundary, owned, JAX behaviour, port behaviour).  An
# uneven case's blocks are those of the device at UNEVEN[name][1] of a
# virtual mesh cut by the widths UNEVEN[name][0]: its ring filled by its
# neighbours, its owned widths ``owned``.
CASES = {
    "2d": ((7, 6), "toroidal", None, j_cc.behavior(), cc.behavior()),
    "2d_uneven": ((7, 6), "toroidal", (5, 4), j_cc.behavior(),
                  cc.behavior()),
    "3d": ((4, 5, 3), ("toroidal", "closed", "toroidal"), None,
           j_ts.behavior(), ts.behavior()),
    "3d_uneven": ((4, 5, 3), ("toroidal", "closed", "toroidal"), (3, 4, 2),
                  j_ts.behavior(), ts.behavior()),
}
UNEVEN = {"2d_uneven": (((5, 7), (6, 4)), (0, 1)),
          "3d_uneven": (((3, 4), (4, 5), (2, 3)), (0, 0, 0))}
# port backend -> JAX backend (in 2-D; in 3-D JAX's reference for all)
BACKENDS = {"reference": "reference", "tiled": "reference",
            "kernel": "pallas"}
COUNTS = ("same", "cnt", "b1.crowd")


def _attrs(rng, n, ndim):
    attrs = {"diameter": rng.uniform(0.6, 1.4, n).astype(np.float32),
             "ctype": rng.integers(0, 2, n).astype(np.int32)}
    if ndim == 3:
        attrs["nutrient"] = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return attrs


def _positions(rng, extent, density=3.2):
    """Uniform positions over ``extent`` cells (cell size 2)."""
    n = int(density * np.prod(extent))
    hi = np.asarray(extent, np.float32) * 2.0 - 0.5
    return rng.uniform(0.5, hi, (n, len(extent))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _local(name, seed=3):
    """JAX's pre- and post-exchange blocks of one one-device state (agents
    inside the owned region), and the port's, built by each package's own
    ``clear_ring``/``mask_unowned`` and one-device ``halo_exchange``."""
    interior, boundary, owned, beh_j, _ = CASES[name]
    nd = len(interior)
    kw = dict(cell_size=2.0, interior=interior, cap=12, boundary=boundary)
    geom_j = JDomain(**kw)
    rng = np.random.default_rng(seed)
    pos = _positions(rng, owned or interior)
    eng = JEngine(geom=geom_j, behavior=beh_j, dt=0.1)
    st = eng.init_state(pos, _attrs(rng, len(pos), nd), seed=seed)
    lead = (0,) * nd
    refs_j = {d: {f: v[lead] for f, v in s.items()}
              for d, s in st.refs.items()}
    pre_j = j_clear_ring(st.soa) if owned is None \
        else j_mask_unowned(st.soa, geom_j, owned)
    post_j = j_halo_exchange(
        geom_j, pre_j, JLocalComm(toroidal=geom_j.toroidal), refs_j,
        JDeltaConfig(enabled=False), True, owned)[0]
    st_t = state_from_arrays(jax_state_arrays(st), device="cpu")
    geom_t = Domain(**kw)
    soa_t = device_block(st_t.soa, lead)
    refs_t = {d: {f: v[lead] for f, v in s.items()}
              for d, s in st_t.refs.items()}
    pre_t = clear_ring(soa_t) if owned is None \
        else mask_unowned(soa_t, geom_t, owned)
    post_t = halo_exchange(geom_t, pre_t, LocalComm(toroidal=geom_t.toroidal),
                           refs_t, DeltaConfig(enabled=False), True,
                           owned=owned)[0]
    return geom_j, geom_t, (pre_j, post_j), (pre_t, post_t)


def _to_jax(soa: AgentSoA):
    from repro.core.agent_soa import AgentSoA as JAgentSoA
    return JAgentSoA(attrs={n: jax.numpy.asarray(a.numpy())
                            for n, a in soa.attrs.items()},
                     valid=jax.numpy.asarray(soa.valid.numpy()))


@functools.lru_cache(maxsize=None)
def _case(name, seed=3):
    """The blocks the sweeps are held on: ``_local``'s on an equal case;
    on an uneven one, one device's pre- and post-exchange blocks of the
    port's virtual mesh (the exchange held to JAX's sharded engine in
    tests/test_torch_partition.py), given to both packages."""
    if name not in UNEVEN:
        return _local(name, seed)
    from repro.core.domain import Partition as JPartition
    from repro_torch.core import Engine
    from repro_torch.core.domain import Partition

    interior, boundary, owned, beh_j, beh_t = CASES[name]
    widths, coords = UNEVEN[name]
    part = Partition.from_widths(widths)
    kw = dict(cell_size=2.0, interior=interior, mesh_shape=part.mesh_shape,
              cap=12, boundary=boundary)
    geom_t = Domain(**kw, partition=part)
    geom_j = JDomain(**kw, partition=JPartition(cuts=part.cuts))
    assert geom_t.owned_widths(coords) == owned
    rng = np.random.default_rng(seed)
    pos = _positions(rng, geom_t.global_cells)
    eng = Engine(geom=geom_t, behavior=beh_t, dt=0.1, device="cpu")
    st = eng.init_state(pos, _attrs(rng, len(pos), len(interior)), seed=seed)
    post, _, _, _, pre, _ = dataclasses.replace(eng, overlap="on")._aura(
        st, eng._comm(), True)
    pre_t, post_t = device_block(pre, coords), device_block(post, coords)
    return geom_j, geom_t, (_to_jax(pre_t), _to_jax(post_t)), (pre_t, post_t)


def _soa_close(got: AgentSoA, want) -> None:
    assert_close(got.valid, want.valid, "valid")
    for n, a in want.attrs.items():
        assert_close(got.attrs[n], a, n, exact=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pre_and_post_exchange_blocks_match_jax(name):
    """clear_ring / mask_unowned and the one-device exchange with
    ``owned`` (the high face sent from ``owned[a]``, received at
    ``owned[a] + 1``) give JAX's blocks bit for bit."""
    _, _, (pre_j, post_j), (pre_t, post_t) = _local(name)
    _soa_close(pre_t, pre_j)
    _soa_close(post_t, post_j)
    assert int(post_t.valid.sum()) > int(pre_t.valid.sum()) > 0


def _jax_backend(name, backend):
    """JAX's counterpart of a port backend: :data:`BACKENDS` in 2-D; JAX's
    reference sweep for all three in 3-D (the cheapest of JAX's to build
    there; the port's backends agree to 1e-5 and each with itself bit for
    bit)."""
    return BACKENDS[backend] if len(CASES[name][0]) == 2 else "reference"


@functools.lru_cache(maxsize=None)
def _jax_overlapped(name, backend):
    geom_j, _, (pre_j, post_j), _ = _case(name)
    beh = CASES[name][3]
    owned = CASES[name][2]
    @jax.jit
    def fn(pre, post):
        return j_overlapped(geom_j, pre, post, beh.pair_fn, beh.pair_attrs,
                            beh.radius, beh.params, backend=backend,
                            owned=owned)

    return {k: np.asarray(v) for k, v in fn(pre_j, post_j).items()}


def _owned_region(name):
    interior, _, owned, _, _ = CASES[name]
    return tuple(slice(0, w) for w in (owned or interior))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_overlapped_sweep_matches_jax_and_monolithic(name, backend):
    """The split against JAX's split (1e-5, counts exactly), and against
    the port's own monolithic sweep of the post-exchange block: bit for
    bit at every owned cell."""
    _, geom_t, _, (pre_t, post_t) = _case(name)
    owned, beh = CASES[name][2], CASES[name][4]
    with torch.inference_mode():
        got = sweep_accumulate_overlapped(
            geom_t, pre_t, post_t, beh.pair_fn, beh.pair_attrs, beh.radius,
            beh.params, backend=backend, owned=owned)
        mono = sweep_accumulate(geom_t, post_t, beh.pair_fn, beh.pair_attrs,
                                beh.radius, beh.params, backend=backend)
    want = _jax_overlapped(name, _jax_backend(name, backend))
    assert_dicts_close(got, want, exact_keys=COUNTS)
    region = _owned_region(name)
    for k, m in mono.items():
        assert torch.equal(got[k][region], m[region]), k
    # the faces did change something: the interior pass alone (no ring)
    # differs from the monolithic sweep at the ring-adjacent cells
    pre_only = sweep_accumulate(geom_t, pre_t, beh.pair_fn, beh.pair_attrs,
                                beh.radius, beh.params, backend=backend)
    assert any(not torch.equal(pre_only[k][region], m[region])
               for k, m in mono.items())


@pytest.mark.parametrize("owned", [None, (3, 5)])
def test_owned_binning_matches_jax(owned):
    """bin_agents with ``owned``: agents beyond the owned extent clamp to
    the migration ring at ``owned[a] + 1``; padding cells stay empty."""
    kw = dict(cell_size=2.0, interior=(6, 7), cap=6)
    geom_j, geom_t = JDomain(**kw), Domain(**kw)
    rng = np.random.default_rng(1)
    n = 120
    pos = rng.uniform(-1.5, 15.5, (n, 2)).astype(np.float32)
    attrs = {"pos": pos, "diameter": rng.uniform(0.5, 1.5, n).astype(
        np.float32)}
    valid = rng.random(n) < 0.9
    origin = np.asarray([0.0, 0.0], np.float32)
    soa_j, d_j = j_bin_agents(geom_j, attrs, valid, origin, owned)
    soa_t, d_t = bin_agents(
        geom_t, {k: torch.from_numpy(v) for k, v in attrs.items()},
        torch.from_numpy(valid), torch.from_numpy(origin), owned)
    _soa_close(soa_t, soa_j)
    assert int(d_t) == int(d_j)
    if owned is not None:
        assert_close(owned_mask(geom_t, owned), j_owned_mask(geom_j, owned),
                     "owned_mask")
        beyond = soa_t.valid[owned[0] + 2:].sum() + \
            soa_t.valid[:, owned[1] + 2:].sum()
        assert int(beyond) == 0
        assert int(take_plane(soa_t.valid, 0, owned[0] + 1).sum()) > 0


def test_mesh_owned_mask_and_per_device_planes():
    """On a mesh-layout tensor the owned mask is each device's own, and a
    plane index of one int a device along a mesh axis takes and puts each
    device's own plane."""
    from repro_torch.core.domain import Partition
    from repro_torch.core.grid import set_plane

    part = Partition.from_widths([(3, 5), (4, 4)])
    geom = Domain(cell_size=2.0, interior=part.max_widths,
                  mesh_shape=part.mesh_shape, cap=2, partition=part)
    assert geom.axis_widths == ((3, 5), (4, 4))
    m = mesh_owned_mask(geom)
    assert m.shape == (2, 2, 7, 6)
    for c in np.ndindex(2, 2):
        assert torch.equal(m[c], owned_mask(geom, geom.owned_widths(c)))
    t = torch.arange(2 * 2 * 7 * 6).reshape(2, 2, 7, 6)
    plane = take_plane(t, 0, (4, 6), lead=2)
    assert plane.shape == (2, 2, 6)
    assert torch.equal(plane[0], t[0, :, 4]) and \
        torch.equal(plane[1], t[1, :, 6])
    set_plane(t, 0, (4, 6), -plane, lead=2)
    assert torch.equal(t[0, :, 4], -plane[0]) and \
        torch.equal(t[1, :, 6], -plane[1])
    # an index that agrees on every device is a plain (view) index
    assert take_plane(t, 1, (2, 2), lead=2).data_ptr() == \
        t[:, :, :, 2].data_ptr()
