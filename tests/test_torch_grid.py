"""Parity of the port's spatial layer (``repro_torch.core.grid`` and
``core.halo``) with the JAX package on the same numpy inputs: binning
(slot layout, invalid slots, a forced cell overflow), ring clearing, and
the aura exchange on ``LocalComm`` in closed and toroidal boundaries.
Everything here must match exactly except float slabs (1e-5, see
torch_parity.py; in practice these are copies and match bit for bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Domain as JDomain
from repro.core import Engine as JEngine
from repro.core.delta import DeltaConfig as JDeltaConfig
from repro.core.grid import bin_agents_jit as j_bin_agents
from repro.core.grid import clear_ring as j_clear_ring
from repro.core.halo import LocalComm as JLocalComm
from repro.core.halo import clear_slab_at as j_clear_slab_at
from repro.core.halo import halo_exchange as j_halo_exchange
from repro.sims import cell_clustering as j_cc
from repro_torch.core import Domain, Engine
from repro_torch.core.delta import DeltaConfig
from repro_torch.core.engine import device_block
from repro_torch.core.grid import (
    bin_agents, cell_of, clear_ring, ravel_cells, running_max,
)
from repro_torch.core.halo import LocalComm, clear_slab_at, halo_exchange, \
    payload_bytes, take_slab
from repro_torch.sims import cell_clustering as cc
from torch_parity import assert_close, assert_dicts_close, soa_inputs

def _flat_agents(ndim, n=300, seed=0, cap=16):
    """Flat agent columns with invalid slots, out-of-domain positions (they
    clamp into ring cells) and 2 * cap agents crammed into one cell."""
    interior = (6, 6) if ndim == 2 else (4, 4, 3)
    kw = dict(cell_size=2.0, interior=interior, cap=cap)
    geom_j, geom_t = JDomain(**kw), Domain(**kw)
    pos, attrs = soa_inputs(n, ndim, geom_t.domain_size, seed)
    rng = np.random.default_rng(seed + 1)
    pos[:2 * cap] = np.float32(3.0) + rng.uniform(
        0.0, 0.9, (2 * cap, ndim)).astype(np.float32)     # one crowded cell
    pos[2 * cap:2 * cap + 5] = -1.5                       # low ring cells
    pos[2 * cap + 5:2 * cap + 10] = np.float32(geom_t.domain_size[0] + 0.7)
    flat = dict(attrs, pos=pos,
                gid_rank=np.zeros(n, np.int32),
                gid_count=np.arange(n, dtype=np.int32))
    valid = rng.uniform(size=n) > 0.15
    valid[:2 * cap] = True
    return geom_j, geom_t, flat, valid


@pytest.mark.parametrize("ndim", [2, 3])
def test_bin_agents_matches_jax(ndim):
    geom_j, geom_t, flat, valid = _flat_agents(ndim)
    origin = np.zeros(ndim, np.float32)
    soa_j, dropped_j = j_bin_agents(
        geom_j, {k: jnp.asarray(v) for k, v in flat.items()},
        jnp.asarray(valid), jnp.asarray(origin))
    soa_t, dropped_t = bin_agents(
        geom_t, {k: torch.from_numpy(v) for k, v in flat.items()},
        torch.from_numpy(valid), torch.from_numpy(origin))
    assert int(dropped_j) >= geom_t.cap      # the forced overflow
    assert_close(dropped_t, dropped_j, "dropped")
    assert_close(soa_t.valid, soa_j.valid, "valid")
    assert_dicts_close(soa_t.attrs, soa_j.attrs, exact_keys=set(flat))


def test_cell_of_and_ravel_cover_the_ring():
    geom_j, geom_t, flat, _ = _flat_agents(2)
    pos = torch.from_numpy(flat["pos"])
    cells = cell_of(geom_t, pos, torch.zeros(2))
    assert cells.dtype == torch.int32
    assert int(cells.min()) == 0
    assert int(cells.max()) == geom_t.local_shape[0] - 1
    cid = ravel_cells(geom_t, cells)
    assert int(cid.max()) < np.prod(geom_t.local_shape)


def _states(boundary, n=260, seed=0):
    """The same cell_clustering state built by both packages; the port's
    SoA is given as its one device's block (the reference's per-device
    layout)."""
    kw = dict(cell_size=2.0, interior=(6, 6), cap=16, boundary=boundary)
    geom_j, geom_t = JDomain(**kw), Domain(**kw)
    pos, attrs = soa_inputs(n, 2, geom_t.domain_size, seed)
    st_j = JEngine(geom=geom_j, behavior=j_cc.behavior(), dt=0.1
                   ).init_state(pos, attrs, seed=seed)
    st_t = Engine(geom=geom_t, behavior=cc.behavior(), dt=0.1, device="cpu"
                  ).init_state(pos, attrs, seed=seed)
    st_t.soa = device_block(st_t.soa, (0, 0))
    return geom_j, geom_t, st_j, st_t


def test_clear_ring_matches_jax():
    _, _, st_j, st_t = _states("closed")
    # fill the ring first so clearing has something to clear
    soa_t = st_t.soa.replace(valid=torch.ones_like(st_t.soa.valid))
    soa_j = st_j.soa.replace(valid=jnp.ones_like(st_j.soa.valid))
    got = clear_ring(soa_t).valid
    assert_close(got, j_clear_ring(soa_j).valid, "valid")
    assert bool(soa_t.valid.all())          # the input is untouched
    assert int(got.sum()) == 6 * 6 * 16


@pytest.mark.parametrize("axis,index", [(0, 1), (1, 3), (0, -2)])
def test_clear_slab_at_matches_jax(axis, index):
    _, _, st_j, st_t = _states("closed")
    got = clear_slab_at(st_t.soa, axis, index).valid
    assert_close(got, j_clear_slab_at(st_j.soa, axis, index).valid, "valid")
    assert int(got.sum()) < int(st_t.soa.valid.sum())   # it cleared some


@pytest.mark.parametrize("boundary", ["closed", "toroidal"])
def test_halo_exchange_matches_jax(boundary):
    geom_j, geom_t, st_j, st_t = _states(boundary)
    tor = geom_t.toroidal
    refs_j = {d: {f: v[0, 0] for f, v in s.items()}
              for d, s in st_j.refs.items()}
    refs_t = {d: {f: v[0, 0] for f, v in s.items()}
              for d, s in st_t.refs.items()}
    soa_j, new_refs_j, nbytes_j, _ = j_halo_exchange(
        geom_j, j_clear_ring(st_j.soa), JLocalComm(toroidal=tor), refs_j,
        JDeltaConfig(enabled=False), True)
    pre = clear_ring(st_t.soa)
    pre_valid = pre.valid.clone()
    soa_t, new_refs_t, nbytes_t, oflow = halo_exchange(
        geom_t, pre, LocalComm(toroidal=tor), refs_t,
        DeltaConfig(enabled=False), True)
    assert nbytes_t == int(nbytes_j) and oflow == 0
    assert torch.equal(pre.valid, pre_valid)     # input left as it was
    assert_close(soa_t.valid, soa_j.valid, "valid")
    assert_dicts_close(soa_t.attrs, soa_j.attrs)
    assert set(new_refs_t) == set(new_refs_j)
    for d in new_refs_j:
        assert_dicts_close(new_refs_t[d], new_refs_j[d])
    ring_valid = int(soa_t.valid.sum()) - int(pre.valid.sum())
    assert (ring_valid > 0) == (boundary == "toroidal")


def test_payload_bytes_is_static():
    _, geom_t, _, st_t = _states("closed")
    slab = take_slab(st_t.soa, 0, 1)
    # pos 8 + gids 8 + diameter 4 + ctype 4 + valid 1 bytes a slot
    assert payload_bytes(slab) == geom_t.local_shape[1] * 16 * 25


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 5000])
def test_running_max_matches_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-1, 10_000, n).astype(np.int32)
    got = running_max(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.maximum.accumulate(x))
