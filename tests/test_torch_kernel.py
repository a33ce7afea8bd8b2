"""The CUDA kernels (``pair_sweep`` with every pair law and ``compose()``
stack it has, the legacy ``neighbor_force``, the four delta-codec kernels
and ``flash_attention``, head dims it pads included) against their plain
PyTorch versions, and the threefry RNG on the card against the CPU.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernel.py

The tests marked ``cuda`` need an NVIDIA GPU and skip (from inside the
test) elsewhere; the others check, on the CPU, the pieces of the wrapper
that the kernel relies on.  Forces to 1e-5 (abs and rel), counts exactly;
the codec kernels bit for bit (they do their plain versions' float32
operations one by one); attention to 2e-5 in float32 and 2e-2 in bfloat16
(the reference's kernel-vs-oracle tolerances, tests/test_kernels.py): the
kernel's online softmax sums in another order than the plain softmax.  The
bf16 tensor-core kernel is also held element by element to one bf16 ulp
(of the larger output) + 1e-5: both versions round a float32 result to
bf16, and those float32 results differ by summation order and by the
~16 bits that p keeps.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.behaviors import compose
from repro_torch.core.engine import device_block
from repro_torch.core.grid import clear_ring
from repro_torch.core.halo import LocalComm, halo_exchange
from repro_torch.core.neighbors import minimum_image_box
from repro_torch.kernels import delta_codec as dc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import neighbor_interaction as ni
from repro_torch.kernels import ops
from repro_torch.sims import cell_clustering as cc
from repro_torch.sims import epidemiology as ep
from repro_torch.sims import oncology as onc
from repro_torch.sims import sir_mechanics as sm
from repro_torch.sims import tumor_spheroid as ts
from repro_torch.sims.common import make_sim

LAWS = {
    "soft_repulsion_adhesion": (cc.behavior().pair_fn,
                                cc.behavior().pair_attrs,
                                dict(cc.behavior().params)),
    "same_type": (cc._same_type_pair, ("ctype",), {}),
}
COUNTS = ("same", "cnt")


def _soa(device, boundary, interior=(12, 12), cap=24, per_cell=6, seed=0,
         sweep_backend="auto"):
    """A mid-run SoA with its aura filled, as the engine's sweep sees it."""
    sim = make_sim(cc.behavior(), interior=interior, cap=cap,
                   boundary=boundary, device=device,
                   sweep_backend=sweep_backend)
    n = per_cell * int(torch.tensor(interior).prod())
    cc.init(sim, n, seed=seed)
    sim.run(1)
    refs = {d: {f: v[(0,) * len(interior)] for f, v in s.items()}
            for d, s in sim.state.refs.items()}
    soa, _, _, _ = halo_exchange(
        sim.geom, clear_ring(device_block(sim.state.soa,
                                          (0,) * len(interior))),
        LocalComm(toroidal=sim.geom.toroidal), refs, sim.engine.delta_cfg,
        True)
    return soa, minimum_image_box(sim.geom)


def _plain(soa, law, box, rows=None):
    pair_fn, pattrs, params = LAWS[law]
    ai, aj, vi, vj = ni.neighborhood_slabs(soa.attrs, soa.valid, pattrs,
                                           rows=rows)
    return ni.pair_sweep_plain(ai, aj, vi, vj, pair_fn=pair_fn, radius=2.0,
                               params=params, box=box)


def _wrapper(soa, law, box, face=False):
    pair_fn, pattrs, params = LAWS[law]
    return ni.pair_sweep(soa.attrs, soa.valid, pair_fn=pair_fn,
                         pair_attrs=pattrs, radius=2.0, params=params,
                         box=box, face=face)


def _assert_match(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].cpu()
        w = w.reshape(g.shape).cpu()
        if name in COUNTS:
            assert torch.equal(g, w), name
        else:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("law", sorted(LAWS))
def test_row_chunks_cover_the_grid(law):
    soa, box = _soa("cpu", "toroidal")
    whole = _plain(soa, law, box)
    parts = [_plain(soa, law, box, rows=(r, min(12, r + 5)))
             for r in range(0, 12, 5)]
    for name, w in whole.items():
        assert torch.equal(torch.cat([p[name] for p in parts]), w)


def test_wrapper_input_checks():
    t = torch.zeros((4, 4, 3), dtype=torch.float32)
    cpu = torch.device("cpu")
    ni._check("x", t, torch.float32, (4, 4, 3), cpu)
    with pytest.raises(TypeError):
        ni._check("x", t, torch.int32, (4, 4, 3), cpu)
    with pytest.raises(ValueError, match="shape"):
        ni._check("x", t, torch.float32, (4, 4, 2), cpu)
    with pytest.raises(ValueError, match="contiguous"):
        ni._check("x", t.transpose(0, 1), torch.float32, (4, 4, 3), cpu)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [24, 40])
@pytest.mark.parametrize("boundary", ["closed", "toroidal"])
@pytest.mark.parametrize("law", sorted(LAWS))
def test_kernel_matches_plain_on_cuda(cuda, law, boundary, cap):
    soa, box = _soa(cuda, boundary, cap=cap)
    before = ni.LAUNCHES[ni.law_for(LAWS[law][0]).name]
    got = _wrapper(soa, law, box)
    torch.cuda.synchronize()
    assert ni.LAUNCHES[ni.law_for(LAWS[law][0]).name] == before + 1
    _assert_match(got, _plain(soa, law, box))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [24, 48])
@pytest.mark.parametrize("boundary", ["closed", "toroidal"])
@pytest.mark.parametrize("law", sorted(LAWS))
def test_kernel_strips_match_plain_on_cuda(cuda, law, boundary, cap):
    """37 cells along the last axis: the kernel's strips of 32 cells leave
    a shorter strip at every row's end, whose last cell takes its right
    neighbours from the halo ring."""
    soa, box = _soa(cuda, boundary, interior=(5, 37), cap=cap)
    got = _wrapper(soa, law, box)
    torch.cuda.synchronize()
    _assert_match(got, _plain(soa, law, box))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,per_cell", [(24, 12), (48, 20)])
@pytest.mark.parametrize("boundary", ["closed", "toroidal"])
@pytest.mark.parametrize("law", sorted(LAWS))
def test_kernel_crowded_strips_match_plain_on_cuda(cuda, law, boundary, cap,
                                                   per_cell):
    """Crowded enough that a strip's staged slots (3 x 34 cells) pass the
    1024 a block holds, so the kernel sweeps each strip in parts."""
    soa, box = _soa(cuda, boundary, interior=(4, 40), cap=cap,
                    per_cell=per_cell)
    assert int(soa.valid[1:4, :34].sum()) > 1024   # interior row 1, strip 0
    got = _wrapper(soa, law, box)
    torch.cuda.synchronize()
    _assert_match(got, _plain(soa, law, box))


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("law", sorted(LAWS))
def test_face_band_launches_match_plain_and_full_block_on_cuda(cuda, law,
                                                                ndim):
    """The overlapped sweep's face bands: a 3-plane band of a larger SoA
    around a face along each axis (past axis 0 a strided view, which the
    wrapper refuses; the overlapped sweep copies its columns), one launch
    each, counted as a face band's, against the plain version on the band
    (counts exactly, forces to 1e-5) and bit-equal to the same cells of a
    full-block launch: each cell's sum runs over the same stencil in the
    same order."""
    interior = (9, 37) if ndim == 2 else (5, 6, 37)
    soa, box = _soa(cuda, "toroidal", interior=interior, cap=24)
    whole = _wrapper(soa, law, box)
    name = ni.law_for(LAWS[law][0]).name
    for axis in range(ndim):
        # the low face, an owned extent inside the block, the high face
        for face in (1, interior[axis] // 2, interior[axis]):
            band_attrs = {n: a.narrow(axis, face - 1, 3)
                          for n, a in soa.attrs.items()}
            band = dataclasses.replace(
                soa, attrs=band_attrs,
                valid=soa.valid.narrow(axis, face - 1, 3))
            assert band.valid.is_contiguous() == (axis == 0)
            if axis:
                with pytest.raises(ValueError, match="not contiguous"):
                    _wrapper(band, law, box, face=True)
            band = dataclasses.replace(
                band, attrs={n: a.contiguous()
                             for n, a in band.attrs.items()},
                valid=band.valid.contiguous())
            before = dict(ni.LAUNCHES)
            got = _wrapper(band, law, box, face=True)
            torch.cuda.synchronize()
            assert ni.LAUNCHES[name + ni.FACE] == before[name + ni.FACE] + 1
            assert ni.LAUNCHES[name] == before[name]
            _assert_match(got, _plain(band, law, box))
            for n, g in got.items():
                assert torch.equal(g, whole[n].narrow(axis, face - 1, 1)), \
                    (axis, face, n)


# The laws and stacks of the other bundled sims, on a SoA carrying every
# column they read (diameter, ctype, state), each with the counts it
# sums: exact.
def _abm_laws():
    mech = cc.behavior()
    return {
        "epidemiology": (ep._pair, ("state",), {}, ("n_inf",)),
        "oncology": (onc._pair, ("diameter", "ctype"),
                     dict(onc.behavior().params), ("crowd",)),
        "stack": (sm.behavior().pair_fn, sm.behavior().pair_attrs,
                  sm.behavior().params, ("b1.n_inf",)),
        "compose_one": (compose(mech).pair_fn, mech.pair_attrs,
                        compose(mech).params, ()),
        "crowd": (ts._crowd_pair, (), {}, ("crowd",)),
        "spheroid_stack": (ts.behavior().pair_fn, ts.behavior().pair_attrs,
                           ts.behavior().params, ("b1.crowd",)),
    }


def _abm_soa(device, boundary, interior=(12, 12), cap=32, per_cell=6,
             seed=0):
    """An initial sir_mechanics SoA (diameters 0.6-1.4, random types and
    SIR states; 2-D or 3-D as ``interior``) with its aura filled, as the
    engine's sweep sees it."""
    sim = make_sim(sm.behavior(), interior=interior, cap=cap,
                   boundary=boundary, device=device)
    n = per_cell * int(torch.tensor(interior).prod())
    g = torch.Generator().manual_seed(seed)
    size = torch.tensor(sim.geom.domain_size)
    pos = (0.5 + torch.rand((n, len(interior)), generator=g)
           * (size - 1.0)).numpy()
    attrs = {"diameter": (0.6 + 0.8 * torch.rand(n, generator=g)).numpy(),
             "ctype": torch.randint(0, 2, (n,), generator=g,
                                    dtype=torch.int32).numpy(),
             "state": torch.randint(0, 3, (n,), generator=g,
                                    dtype=torch.int32).numpy()}
    sim.init(pos, attrs, seed=seed)
    lead = (0,) * len(interior)
    refs = {d: {f: v[lead] for f, v in s.items()}
            for d, s in sim.state.refs.items()}
    soa, _, _, _ = halo_exchange(
        sim.geom, clear_ring(device_block(sim.state.soa, lead)),
        LocalComm(toroidal=sim.geom.toroidal), refs, sim.engine.delta_cfg,
        True)
    return soa, minimum_image_box(sim.geom)


def _abm_match(soa, box, law):
    pair_fn, pattrs, params, counts = _abm_laws()[law]
    name = ni.law_for(pair_fn).name
    before = ni.LAUNCHES[name]
    got = ni.pair_sweep(soa.attrs, soa.valid, pair_fn=pair_fn,
                        pair_attrs=pattrs, radius=2.0, params=params,
                        box=box)
    torch.cuda.synchronize()
    assert ni.LAUNCHES[name] == before + 1
    ai, aj, vi, vj = ni.neighborhood_slabs(soa.attrs, soa.valid, pattrs)
    want = ni.pair_sweep_plain(ai, aj, vi, vj, pair_fn=pair_fn, radius=2.0,
                               params=params, box=box)
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n].cpu()
        w = w.reshape(g.shape).cpu()
        if n in counts:
            assert torch.equal(g, w), n
        else:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("cap,per_cell", [(32, 6), (48, 20)])
@pytest.mark.parametrize("boundary", ["closed", "toroidal"])
@pytest.mark.parametrize("law", sorted(_abm_laws()))
def test_abm_laws_match_plain_on_cuda(cuda, law, boundary, cap, per_cell):
    """Laws 2 (epidemiology) and 3 (oncology: outputs of width D and 1),
    the mechanics + SIR stack (the SIR part gated to 1.5 under the sweep's
    2.0) and compose(b) of one law, on 12 x 12 cells, and crowded enough
    at 20 a cell that strips are swept in parts."""
    soa, box = _abm_soa(cuda, boundary, cap=cap, per_cell=per_cell)
    _abm_match(soa, box, law)


@pytest.mark.cuda
@pytest.mark.parametrize("law", sorted(_abm_laws()))
def test_abm_laws_strips_match_plain_on_cuda(cuda, law):
    """37 cells along the last axis: a shorter strip at each row's end."""
    soa, box = _abm_soa(cuda, "toroidal", interior=(5, 37))
    _abm_match(soa, box, law)


# Every law and stack at D = 3, with the clustering laws beside them.
def _laws_3d():
    mech = cc.behavior()
    return dict(_abm_laws(), **{
        "soft_repulsion_adhesion": (mech.pair_fn, mech.pair_attrs,
                                    dict(mech.params), ()),
        "same_type": (cc._same_type_pair, ("ctype",), {}, ("same", "cnt"))})


def _match_3d(soa, box, law):
    pair_fn, pattrs, params, counts = _laws_3d()[law]
    name = ni.law_for(pair_fn).name
    before = ni.LAUNCHES[name]
    got = ni.pair_sweep(soa.attrs, soa.valid, pair_fn=pair_fn,
                        pair_attrs=pattrs, radius=2.0, params=params,
                        box=box)
    torch.cuda.synchronize()
    assert ni.LAUNCHES[name] == before + 1
    ai, aj, vi, vj = ni.neighborhood_slabs(soa.attrs, soa.valid, pattrs)
    want = ni.pair_sweep_plain(ai, aj, vi, vj, pair_fn=pair_fn, radius=2.0,
                               params=params, box=box)
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n].cpu()
        w = w.reshape(g.shape).cpu()
        if n in counts:
            assert torch.equal(g, w), n
        else:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("interior,cap,per_cell", [
    ((4, 4, 5), 32, 8),       # K a multiple of 16: flags as 16-byte vectors
    ((3, 3, 37), 20, 6),      # K not one (words), a short strip at 37
    ((3, 2, 12), 18, 8),      # K not a multiple of 4 (bytes)
    ((3, 2, 40), 48, 20),     # crowded: each strip swept in parts
], ids=["k32", "k20_strips", "k18", "crowded"])
@pytest.mark.parametrize("boundary", ["closed", "toroidal"])
@pytest.mark.parametrize("law", sorted(_laws_3d()))
def test_kernel_3d_matches_plain_on_cuda(cuda, law, boundary, interior, cap,
                                         per_cell):
    """The D = 3 instantiation (9 staged rows of a strip, 27 cells a
    neighbourhood) of every law and stack against the plain version."""
    soa, box = _abm_soa(cuda, boundary, interior=interior, cap=cap,
                        per_cell=per_cell)
    if law == "same_type" and interior == (3, 2, 40):
        # interior line (1, 1): its 9 x 34 staged cells pass the 27 x 48
        # slots a block holds, so its first strip is swept in parts
        assert int(soa.valid[1:4, 1:4, :34].sum()) > 27 * 48
    _match_3d(soa, box, law)


@pytest.mark.cuda
def test_stack_gate_and_namespaces_on_cuda(cuda):
    """The stack's SIR part counts only neighbours within its own radius
    (1.5): at the full radius 2.0 it would count more."""
    soa, box = _abm_soa(cuda, "toroidal")
    got = _abm_match(soa, box, "stack")
    assert set(got) == {"b0.force", "b1.n_inf"}
    wide = ni.pair_sweep(soa.attrs, soa.valid, pair_fn=ep._pair,
                         pair_attrs=("state",), radius=2.0, params={},
                         box=box)["n_inf"]
    assert float(got["b1.n_inf"].sum()) < float(wide.sum())


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    soa, box = _soa(cuda, "closed")

    def other_pair(ai, aj, disp, dist2, params):
        return {"n": torch.ones_like(dist2)}

    with pytest.raises(NotImplementedError, match="ROADMAP B1"):
        ni.pair_sweep(soa.attrs, soa.valid, pair_fn=other_pair,
                      pair_attrs=(), radius=2.0, params={}, box=box)
    # a stack with a part that has no device law (as sir_mechanics'
    # ensemble _gated_sir_pair) raises at D = 3 as at D = 2, and so does a
    # stack of device laws that is not instantiated
    soa3, box3 = _abm_soa(cuda, "closed", interior=(4, 4, 3))
    mech = cc.behavior()
    other = dataclasses.replace(mech, pair_fn=other_pair, pair_attrs=())
    for stack, match in ((compose(mech, other), "ROADMAP B1"),
                         (compose(ep.behavior(), mech), "ROADMAP B1 a")):
        with pytest.raises(NotImplementedError, match=match):
            ni.pair_sweep(soa3.attrs, soa3.valid, pair_fn=stack.pair_fn,
                          pair_attrs=stack.pair_attrs, radius=2.0,
                          params=stack.params, box=box3)
    bad = dict(soa.attrs, ctype=soa.attrs["ctype"].to(torch.int64))
    with pytest.raises(TypeError):
        ni.pair_sweep(bad, soa.valid, pair_fn=cc._same_type_pair,
                      pair_attrs=("ctype",), radius=2.0, params={}, box=box)


# Every law and stack of the kernel on gathered slabs
# (ops.neighborhood_pair_sweep): the resident sweep's, law 5 and the
# ensemble family's stack 18 too.
def _slab_laws():
    ens = sm.ensemble_behavior(sm.ensemble_defaults())
    return dict(_laws_3d(), **{
        "gated_epidemiology": (sm._gated_sir_pair, ("state",),
                               {"sir_radius": 1.2}, ("n_inf",)),
        "ensemble_stack": (ens.pair_fn, ens.pair_attrs, ens.params,
                           ("b1.n_inf",))})


@pytest.mark.cuda
@pytest.mark.parametrize("interior", [(12, 12), (4, 4, 3)])
@pytest.mark.parametrize("boundary", ["closed", "toroidal"])
@pytest.mark.parametrize("law", sorted(_slab_laws()))
def test_neighborhood_pair_sweep_kernel_matches_plain_on_cuda(
        cuda, law, boundary, interior):
    """The gathered-slab kernel against its plain version on slabs of an
    initial sir_mechanics SoA, D = 2 and 3, the self slab as strided
    views: counts exactly, forces to 1e-5; one launch a call."""
    soa, box = _abm_soa(cuda, boundary, interior=interior)
    pair_fn, pattrs, params, counts = _slab_laws()[law]
    ai, aj, vi, vj = ni.neighborhood_slabs(soa.attrs, soa.valid, pattrs)
    # the self slab as strided views of the same values
    ai = {n: torch.stack([a, a], dim=-1)[..., 0] for n, a in ai.items()}
    vi = torch.stack([vi, vi], dim=-1)[..., 0]
    assert not vi.is_contiguous() and not ai["pos"].is_contiguous()
    before = ni.LAUNCHES["neighborhood_pair_sweep"]
    got = ops.neighborhood_pair_sweep(ai, aj, vi, vj, pair_fn=pair_fn,
                                      radius=2.0, params=params, box=box)
    torch.cuda.synchronize()
    assert ni.LAUNCHES["neighborhood_pair_sweep"] == before + 1
    want = ni.pair_sweep_plain(ai, aj, vi, vj, pair_fn=pair_fn, radius=2.0,
                               params=params, box=box)
    assert set(got) == set(want)
    for n, w in want.items():
        if n in counts:
            assert torch.equal(got[n], w), n
        else:
            torch.testing.assert_close(got[n], w, atol=1e-5, rtol=1e-5)
        assert float(w.abs().sum()) > 0, n


@pytest.mark.cuda
def test_neighborhood_pair_sweep_refuses_an_unknown_law_on_cuda(cuda):
    soa, box = _abm_soa(cuda, "closed")
    ai, aj, vi, vj = ni.neighborhood_slabs(soa.attrs, soa.valid, ())

    def near(attrs_i, attrs_j, disp, dist2, params):
        return {"near": torch.ones_like(dist2)}

    with pytest.raises(NotImplementedError, match="ROADMAP B1"):
        ops.neighborhood_pair_sweep(ai, aj, vi, vj, pair_fn=near,
                                    radius=2.0, params={}, box=box)


# ---------------------------------------------------------------------------
# Lane launches (B1 d): B lanes in one launch, read in place from a stacked
# mesh state, each lane at its own params from the device table
# ---------------------------------------------------------------------------

# Each law or stack with three lane points (pair function, params), and the
# counts it sums: the lanes differ in every param the law reads.
def _lane_laws():
    mech = cc.behavior()

    def soft(rep, adh, same):
        return dict(mech.params, repulsion=rep, adhesion=adh,
                    same_type_only=same)

    def ens(**kw):
        b = sm.ensemble_behavior({**sm.ensemble_defaults(), **kw})
        return b.pair_fn, b.params

    plain = {
        "same_type": (cc._same_type_pair, ("ctype",), {}, ("same", "cnt")),
        "epidemiology": (ep._pair, ("state",), {}, ("n_inf",)),
        "crowd": (ts._crowd_pair, (), {}, ("crowd",)),
        "stack16": (sm.behavior().pair_fn, sm.behavior().pair_attrs,
                    sm.behavior().params, ("b1.n_inf",)),
        "stack17": (ts.behavior().pair_fn, ts.behavior().pair_attrs,
                    ts.behavior().params, ("b1.crowd",)),
    }
    out = {name: (pattrs, [(fn, params)] * 8, counts)
           for name, (fn, pattrs, params, counts) in plain.items()}
    points = [(2.0, 0.5, 1.0), (3.0, 0.2, 0.0), (1.0, 0.9, 1.0),
              (2.5, 0.1, 0.0), (0.5, 0.6, 1.0), (4.0, 0.3, 1.0),
              (1.5, 0.0, 0.0), (2.2, 0.7, 1.0)]
    out["soft_repulsion_adhesion"] = (
        mech.pair_attrs, [(mech.pair_fn, soft(*q)) for q in points], ())
    out["oncology"] = (
        ("diameter", "ctype"), [(onc._pair, soft(*q)) for q in points],
        ("crowd",))
    radii = (0.5, 1.0, 1.1, 1.5, 2.0, 0.75, 1.25, 1.9)
    out["gated_epidemiology"] = (
        ("state",), [(sm._gated_sir_pair, {"sir_radius": r})
                     for r in radii], ("n_inf",))
    out["stack18"] = (
        sm.behavior().pair_attrs,
        [ens(sir_radius=r, repulsion=q[0], adhesion=q[1])
         for r, q in zip(radii, points)], ("b1.n_inf",))
    return out


def _mesh_lanes(device, interior, lanes, cap=32, per_cell=6):
    """``lanes`` aura-filled sir_mechanics SoAs (seeds 0..), stacked as
    device (1, 0) of an (R, 2, 2, *local, K, ...) mesh tensor: each lane's
    columns a strided view, lanes 4 blocks apart.  Returns the lane views,
    the lanes' own blocks and the box."""
    blocks = []
    for seed in range(lanes):
        soa, box = _abm_soa(device, "toroidal", interior=interior, cap=cap,
                            per_cell=per_cell, seed=seed)
        blocks.append(soa)

    def stacked(get):
        t = torch.stack([get(b) for b in blocks])
        mesh = torch.zeros((lanes, 2, 2) + tuple(t.shape[1:]),
                           dtype=t.dtype, device=t.device)
        mesh[:, 1, 0] = t
        return mesh[:, 1, 0]

    attrs = {n: stacked(lambda b, n=n: b.attrs[n]) for n in blocks[0].attrs}
    return attrs, stacked(lambda b: b.valid), blocks, box


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("interior", [(12, 12), (3, 3, 5)], ids=["d2", "d3"])
@pytest.mark.parametrize("law", sorted(_lane_laws()))
def test_lane_kernel_matches_plain_on_cuda(cuda, law, interior, lanes):
    """One launch over ``lanes`` lanes read in place (strided) from a
    stacked 2x2 mesh tensor: each lane against the plain version at its own
    params (forces 1e-5, counts exactly), and bit-equal to a solo (B = 1,
    host params) launch of its own block."""
    pattrs, points, counts = _lane_laws()[law]
    points = points[:lanes]
    fns = [fn for fn, _ in points]
    params = [p for _, p in points]
    attrs, valid, blocks, box = _mesh_lanes(cuda, interior, lanes)
    if lanes > 1:
        assert not valid.is_contiguous()
        assert valid.stride(0) == 4 * valid[0].numel()
    name = ni.law_for(fns[0]).name
    before = ni.LAUNCHES[name]
    got = ni.pair_sweep_lanes(attrs, valid, pair_fns=fns, pair_attrs=pattrs,
                              radius=2.0, params=params, box=box)
    torch.cuda.synchronize()
    assert ni.LAUNCHES[name] == before + 1
    for b, blk in enumerate(blocks):
        ai, aj, vi, vj = ni.neighborhood_slabs(blk.attrs, blk.valid, pattrs)
        want = ni.pair_sweep_plain(ai, aj, vi, vj, pair_fn=fns[b],
                                   radius=2.0, params=params[b], box=box)
        solo = ni.pair_sweep(blk.attrs, blk.valid, pair_fn=fns[b],
                             pair_attrs=pattrs, radius=2.0,
                             params=params[b], box=box)
        assert set(got) == set(want) == set(solo)
        for n, w in want.items():
            g = got[n][b]
            assert torch.equal(g, solo[n]), (b, n)
            w = w.reshape(g.shape)
            if n in counts:
                assert torch.equal(g, w), (b, n)
            else:
                torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def _edge_pair_soa(device, r):
    """Two agents on a 6 x 6-cell toroidal grid, the second infected, at
    dist2 == fl32(r) * fl32(r) exactly (x 0.5 and 0.5 + fl32(r), both
    below 2, so their float32 difference is fl32(r))."""
    sim = make_sim(sm.behavior(), interior=(6, 6), cap=8,
                   boundary="toroidal", device=device)
    x1 = np.float32(0.5) + np.float32(r)
    pos = np.array([[0.5, 5.0], [x1, 5.0]], np.float32)
    sim.init(pos, {"diameter": np.ones(2, np.float32),
                   "ctype": np.zeros(2, np.int32),
                   "state": np.array([0, 1], np.int32)})
    lead = (0, 0)
    refs = {d: {f: v[lead] for f, v in s.items()}
            for d, s in sim.state.refs.items()}
    soa, _, _, _ = halo_exchange(
        sim.geom, clear_ring(device_block(sim.state.soa, lead)),
        LocalComm(toroidal=sim.geom.toroidal), refs, sim.engine.delta_cfg,
        True)
    return soa, minimum_image_box(sim.geom)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1.1, 0.75, 1.5, 2.0])
def test_lane_gate_at_its_edge_and_above_the_stack_gate_on_cuda(cuda, r):
    """A pair at exactly dist2 == fl32(r) * fl32(r) counts under law 5 at
    sir_radius r (the square taken in float32 on the card) and not at the
    next float32 below r; in stack 18 a lane with sir_radius above the
    structural 1.5 is still cut at 1.5."""
    soa, box = _edge_pair_soa(cuda, r)
    lanes = {n: a.unsqueeze(0).expand((3,) + a.shape)
             for n, a in soa.attrs.items()}
    valid = soa.valid.unsqueeze(0).expand((3,) + soa.valid.shape)
    below = float(np.nextafter(np.float32(r), np.float32(0)))
    radii = [r, below, 2.0]
    got = ni.pair_sweep_lanes(
        lanes, valid, pair_fns=[sm._gated_sir_pair] * 3,
        pair_attrs=("state",), radius=2.0,
        params=[{"sir_radius": x} for x in radii], box=box)["n_inf"]
    stack = [sm.ensemble_behavior({**sm.ensemble_defaults(),
                                   "sir_radius": x}) for x in radii]
    got18 = ni.pair_sweep_lanes(
        lanes, valid, pair_fns=[b.pair_fn for b in stack],
        pair_attrs=stack[0].pair_attrs, radius=2.0,
        params=[b.params for b in stack], box=box)["b1.n_inf"]
    torch.cuda.synchronize()
    assert [float(got[b].sum()) for b in range(3)] == [1.0, 0.0, 1.0]
    within = 1.0 if r <= sm.SIR_RADIUS_MAX else 0.0
    assert [float(got18[b].sum()) for b in range(3)] == [within, 0.0, within]


@pytest.mark.cuda
def test_lane_launch_refuses_what_it_does_not_take(cuda):
    attrs, valid, blocks, box = _mesh_lanes(cuda, (6, 6), 2)
    b = sm.ensemble_behavior(sm.ensemble_defaults())
    kw = dict(pair_attrs=b.pair_attrs, radius=2.0, box=box)
    with pytest.raises(ValueError, match="one law"):
        ni.pair_sweep_lanes(attrs, valid, pair_fns=[b.pair_fn, ep._pair],
                            params=[b.params, {}], **kw)
    with pytest.raises(ValueError, match="strides"):
        bad = dict(attrs, pos=attrs["pos"].contiguous())
        ni.pair_sweep_lanes(bad, valid, pair_fns=[b.pair_fn] * 2,
                            params=[b.params] * 2, **kw)
    with pytest.raises(ValueError, match="lane table"):
        ni.pair_sweep_lanes(attrs, valid, pair_fns=[b.pair_fn] * 2,
                            params=[b.params] * 2,
                            table=torch.zeros((3, 12), device=cuda), **kw)


# ---------------------------------------------------------------------------
# The delta-codec kernels (csrc/delta_codec.cu) against their plain versions
# ---------------------------------------------------------------------------

def _codec_inputs(device, b, n, seed=0, eps=0.01):
    """Half the slots changed by about ``eps``, the rest unchanged (a zero
    delta, of either sign in row 0), and the last row unchanged throughout
    when there are two or more (the adaptive scale's 1e-30 floor)."""
    g = torch.Generator().manual_seed(seed)
    ref = torch.randn((b, n), generator=g)
    x = ref + torch.randn((b, n), generator=g) * eps
    x = torch.where(torch.rand((b, n), generator=g) < 0.5, ref, x)
    if n >= 2:
        x[0, :2] = -0.0
        ref[0, 0], ref[0, 1] = 0.0, -0.0
    if b > 1:
        x[-1] = ref[-1]
    return x.to(device), ref.to(device)


def _encode_both(x, ref, **kw):
    got = dc.delta_encode(x, ref, **kw)
    want = dc.delta_encode_plain(x, ref, **kw)
    return got, want


def _assert_codec_equal(got, want):
    """Quantized values, scales, counts and float outputs bit for bit: the
    kernel does the plain version's float32 operations one by one."""
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_codec_plain_counts_clipped_deltas():
    x = torch.zeros((2, 8))
    x[0, :3] = 10.0
    x[1, 5] = -9.0
    ref = torch.zeros_like(x)
    q, s, oflow, nref = dc.delta_encode(x, ref, scale=0.05)
    assert oflow.tolist() == [3, 1]
    assert int(q.max()) == 127 and int(q.min()) == -128
    q, s, oflow, _ = dc.delta_encode(x, ref, scale=0.05, symmetric=True)
    assert int(q.min()) == -127 and oflow.tolist() == [3, 1]
    q, s, oflow, nref = dc.delta_encode(x, ref)        # adaptive
    assert oflow.tolist() == [0, 0]
    assert torch.equal(s, torch.tensor([10.0, 9.0]) / torch.tensor(127.0))
    assert torch.equal(dc.delta_decode(q, ref, s), nref)


# (B, N) calls: empty rows, a row of 3, rows with and without 16-byte
# vectors, and two past any register tile (a row gets at most the 132 * 8
# blocks an H100 holds of 256 threads, shared by its B rows, and a block
# 4096 elements: the second phase reads the rest again).  The decode's
# 16-byte q vectors (16 int8, 8 int16): rows of N % 16 in {0, 4, 8, 12}
# start at every offset within a vector, so heads and tails go scalar.
CODEC_SHAPES = [(4, 0), (4, 3), (4, 4000), (4, 4 * 1000 + 3), (1, 4000),
                (8, 4003), (64, 4000), (64, 3), (1, 4_500_000),
                (8, 600_004), (4, 4004), (4, 4008), (4, 4012), (3, 4016)]


def _codec_view(t, offset):
    """``t`` as is, or as a contiguous view one element into a buffer (no
    longer 16-byte aligned)."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("b, n", CODEC_SHAPES)
@pytest.mark.parametrize("scale", [None, 1e-4], ids=["adaptive", "fixed"])
@pytest.mark.parametrize("qdtype", [torch.int8, torch.int16])
def test_delta_codec_kernels_match_plain_on_cuda(cuda, qdtype, scale, b, n,
                                                 offset):
    x, ref = _codec_inputs(cuda, b, n)
    x, ref = _codec_view(x, offset), _codec_view(ref, offset)
    for symmetric in (False, True):
        before = dict(dc.LAUNCHES)
        got, want = _encode_both(x, ref, qdtype=qdtype, scale=scale,
                                 symmetric=symmetric)
        torch.cuda.synchronize()
        assert dc.LAUNCHES["delta_encode"] == before["delta_encode"] + 1
        _assert_codec_equal(got, want)
        if scale is not None and qdtype == torch.int8 and n >= 4000:
            assert int(got[2].sum()) > 0           # the fixed scale clips
        q, s = got[0], got[1]
        out = dc.delta_decode(q, ref, s)
        torch.cuda.synchronize()
        assert dc.LAUNCHES["delta_decode"] == before["delta_decode"] + 1
        assert torch.equal(out, dc.delta_decode_plain(q, ref, s))
        assert torch.equal(out, got[3])          # the closed loop


TOROIDAL = {"mixed": (True, False, True), "closed": (False, False, False)}


def _mig_case(device, b, r, d, live, seed=1):
    """(B, R, D) positions in a box of sides 64, 48, 32, a centre a row,
    and the per-axis scale of a +-(L/2 + 4) range; ``live`` "mixed" (70 %,
    with a stale far-out dead row and a live row out of range on axis 1,
    which is closed in both patterns), "dead" or "live"."""
    g = torch.Generator().manual_seed(seed)
    lsz = (64.0, 48.0, 32.0)[:d]
    pos = torch.rand((b, r, d), generator=g) * torch.tensor(lsz)
    valid = {"mixed": torch.rand((b, r), generator=g) < 0.7,
             "dead": torch.zeros((b, r), dtype=torch.bool),
             "live": torch.ones((b, r), dtype=torch.bool)}[live]
    if live == "mixed" and r > 2:
        pos[:, 1] = 1e4                # stale, far out, on a dead row
        valid[:, 1] = False
        pos[:, 2, min(1, d - 1)] = 400.0   # live and out of range
        valid[:, 2] = True
    center = torch.tensor(lsz) / 2 + torch.arange(b, dtype=torch.float32
                                                  )[:, None] % 3
    scale = ((torch.tensor(lsz) / 2 + 4) / torch.tensor(32767.0)).numpy()
    return pos.to(device), valid.to(device), center.to(device), scale, lsz


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("live", ["mixed", "dead", "live"])
@pytest.mark.parametrize("dead", ["mask", "zero"])
@pytest.mark.parametrize("toroidal", ["mixed", "closed"])
@pytest.mark.parametrize("r", [0, 5000, 5001, 5002, 5003])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_migration_codec_kernels_match_plain_on_cuda(cuda, d, r, toroidal,
                                                     dead, live, offset):
    """Every R % 4 (rows before a row's first aligned chunk, and the tail,
    go scalar), D = 1, 2, 3, a misaligned stack (all scalar)."""
    pos, valid, center, scale, lsz = _mig_case(cuda, 4, r, d, live)
    pos, valid = _codec_view(pos, offset), _codec_view(valid, offset)
    tor = TOROIDAL[toroidal][:d]
    kw = dict(valid=valid, lsz=lsz, toroidal=tor, dead=dead)
    before = dict(dc.LAUNCHES)
    q, oflow = dc.migration_pos_encode(pos, center, scale, **kw)
    torch.cuda.synchronize()
    assert dc.LAUNCHES["migration_pos_encode"] == \
        before["migration_pos_encode"] + 1
    q_p, oflow_p = dc.migration_pos_encode_plain(pos, center, scale, **kw)
    assert torch.equal(q, q_p) and torch.equal(oflow, oflow_p)
    if live == "mixed" and r > 2 and not tor[min(1, d - 1)]:
        assert (oflow >= 1).all()
    if live == "dead":
        assert not oflow.any()
    p = dc.migration_pos_decode(q, center, scale, lsz=lsz, toroidal=tor)
    torch.cuda.synchronize()
    assert dc.LAUNCHES["migration_pos_decode"] == \
        before["migration_pos_decode"] + 1
    assert torch.equal(p, dc.migration_pos_decode_plain(
        q, center, scale, lsz=lsz, toroidal=tor))
    # the seam: row 3 steps a hair below 0 on axis 0, which wraps to L on
    # a toroidal axis; at_l writes it as the largest float32 below L
    q, center = _seam_step(q, center, scale)
    at_l = [float(np.nextafter(np.float32(lsz[0]), np.float32(0)))] + \
        [0.0] * (d - 1)
    p = dc.migration_pos_decode(q, center, scale, lsz=lsz, toroidal=tor,
                                at_l=at_l)
    torch.cuda.synchronize()
    assert dc.LAUNCHES["migration_pos_decode"] == \
        before["migration_pos_decode"] + 2
    assert _bits(p) == _bits(dc.migration_pos_decode_plain(
        q, center, scale, lsz=lsz, toroidal=tor, at_l=at_l))
    if r > 3 and tor[0]:
        assert (dc.migration_pos_decode_plain(
            q, center, scale, lsz=lsz, toroidal=tor)[:, 3, 0] == lsz[0]).all()
        assert (p[:, 3, 0] == at_l[0]).all()


def _bits(t):
    """The float32 tensor's bits (a signed zero, a NaN told apart)."""
    return t.view(torch.int32).cpu().numpy().tobytes()


def _seam_step(q, center, scale, k=20000):
    """``(q, center)`` with row 3 of every stack row at -1 ulp of its
    centre on axis 0: ``center - fl(k * s)`` with the centre one float
    below ``fl(k * s)`` (22.0 at ``_mig_case``'s scale, whose ulp is a
    quarter of L = 64's), which ``mod L`` rounds to exactly L."""
    q, center = q.clone(), center.clone()
    c0 = np.nextafter(np.float32(k) * np.float32(scale[0]), np.float32(0))
    center[:, 0] = float(c0)
    if q.shape[1] > 3:
        q[:, 3, 0] = -k
    return q, center


@pytest.mark.cuda
@pytest.mark.parametrize("b, n", [(4, 4003), (8, 600_004)])
def test_encoders_repeat_bit_for_bit_on_cuda(cuda, b, n):
    """Three launches of each encoder, and of each decoder on their
    outputs, on the same inputs give the same bits: no state outlives a
    call (the scratch is fresh and written before it is read)."""
    x, ref = _codec_inputs(cuda, b, n)
    pos, valid, center, scale, lsz = _mig_case(cuda, b, n // 2, 2, "mixed")
    tor = (True, False)
    q8, s8, _, _ = dc.delta_encode(x, ref)
    qm, _ = dc.migration_pos_encode(pos, center, scale, valid=valid,
                                    lsz=lsz, toroidal=tor)
    qs, cs = _seam_step(qm, center, scale)
    runs = [(dc.delta_encode(x, ref, qdtype=torch.int16),
             dc.delta_encode(x, ref, scale=1e-4),
             dc.migration_pos_encode(pos, center, scale, valid=valid,
                                     lsz=lsz, toroidal=tor),
             (dc.delta_decode(q8, ref, s8),),
             (dc.migration_pos_decode(qs, cs, scale, lsz=lsz, toroidal=tor,
                                      at_l=(0.0, 0.0)),))
            for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for got, first in zip(run, runs[0]):
            _assert_codec_equal(got, first)


# ---------------------------------------------------------------------------
# The legacy neighbor_force kernel (csrc/pair_sweep.cu) on gathered slabs
# ---------------------------------------------------------------------------

def _force_slabs(device, c, k, nk, seed=0):
    g = torch.Generator().manual_seed(seed)

    def side(n):
        return (torch.rand((c, n, 2), generator=g) * 10,
                0.5 + torch.rand((c, n), generator=g),
                torch.randint(0, 2, (c, n), generator=g, dtype=torch.int32),
                torch.rand((c, n), generator=g) < 0.8,
                torch.randint(0, 10_000, (c, n), generator=g,
                              dtype=torch.int32))

    i, j = side(k), side(nk)
    # j slot 4 carries self slot 0's gid half a unit away (as an aura copy
    # would): the gid test, not the distance, must exclude it
    for a in range(5):
        j[a][:, 4] = i[a][:, 0]
    j[0][:, 4, 0] += 0.5
    i[3][:, 0] = j[3][:, 4] = True
    return [t.to(device) for t in i + j]


def test_neighbor_force_plain_excludes_self_and_far_pairs():
    args = _force_slabs("cpu", 4, 8, 72)
    kw = dict(radius=2.0, repulsion=2.0, adhesion=0.4)
    full = ni.neighbor_force_plain(*args, **kw)
    args[9] = args[9].clone()
    args[9][:, 4] += 1                       # no longer the same agent
    assert not torch.equal(ni.neighbor_force_plain(*args, **kw)[:, 0],
                           full[:, 0])
    far = ni.neighbor_force_plain(*args, **dict(kw, radius=0.0))
    assert torch.equal(far, torch.zeros_like(far))


@pytest.mark.cuda
@pytest.mark.parametrize("same_type_only", [True, False])
@pytest.mark.parametrize("c,k", [(8, 8), (16, 16), (4, 32), (64, 48)])
def test_neighbor_force_kernel_matches_plain_on_cuda(cuda, c, k,
                                                     same_type_only):
    args = _force_slabs(cuda, c, k, 9 * k)
    kw = dict(radius=2.0, repulsion=2.0, adhesion=0.4,
              same_type_only=same_type_only)
    before = ni.LAUNCHES["neighbor_force"]
    got = ops.neighbor_force(*args, **kw)
    torch.cuda.synchronize()
    assert ni.LAUNCHES["neighbor_force"] == before + 1
    want = ni.neighbor_force_plain(*args, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert float(want.abs().max()) > 0


def _force_masked(device, c, k, nk, mode, seed=0):
    """Slabs of ``_force_slabs`` with the valid masks of ``mode``: "all"
    (every row, the worst case), "none", "one" (a single valid neighbour
    row a cell, at a random place), "random" (a random, not front-packed
    mask), "crowded" (9 in 10 rows valid: a block's cells far past the
    kernel's staging room of 2048 neighbour rows and 256 self slots)."""
    args = [t.cpu() for t in _force_slabs("cpu", c, k, nk, seed)]
    g = torch.Generator().manual_seed(seed + 1)
    vi, vj = args[3], args[8]
    if mode == "all":
        vi, vj = torch.ones_like(vi), torch.ones_like(vj)
    elif mode == "none":
        vi, vj = torch.zeros_like(vi), torch.zeros_like(vj)
    elif mode == "one":
        vj = torch.zeros_like(vj)
        vj[torch.arange(c), torch.randint(0, nk, (c,), generator=g)] = True
    elif mode == "random":
        vi = torch.rand(vi.shape, generator=g) < 0.3
        vj = torch.rand(vj.shape, generator=g) < 0.3
    elif mode == "crowded":
        vi = torch.rand(vi.shape, generator=g) < 0.9
        vj = torch.rand(vj.shape, generator=g) < 0.9
    args[3], args[8] = vi.contiguous(), vj.contiguous()
    return [t.to(device) for t in args]


@pytest.mark.cuda
@pytest.mark.parametrize("same_type_only", [True, False])
@pytest.mark.parametrize("mode", ["all", "none", "one", "random",
                                  "crowded"])
def test_neighbor_force_kernel_masks_on_cuda(cuda, mode, same_type_only):
    """Any valid mask at phase 11's K 48, NK 432, on 53 cells (a block of
    48 and one of 5): the kernel stages only valid rows, in windows past
    its room, and still equals the plain version."""
    args = _force_masked(cuda, 53, 48, 432, mode)
    # neighbours within reach: positions in a 4 x 4 box, radius 2
    args[0], args[5] = args[0] * 0.4, args[5] * 0.4
    kw = dict(radius=2.0, repulsion=2.0, adhesion=0.4,
              same_type_only=same_type_only)
    before = ni.LAUNCHES["neighbor_force"]
    got = ops.neighbor_force(*args, **kw)
    torch.cuda.synchronize()
    assert ni.LAUNCHES["neighbor_force"] == before + 1
    want = ni.neighbor_force_plain(*args, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got[~args[3]], torch.zeros_like(got[~args[3]]))
    if mode in ("all", "random", "crowded"):
        assert float(want.abs().max()) > 0


@pytest.mark.cuda
def test_neighbor_force_kernel_refuses_what_it_does_not_take(cuda):
    args = _force_slabs(cuda, 4, 8, 72)
    kw = dict(radius=2.0, repulsion=2.0, adhesion=0.4)
    bad = list(args)
    bad[2] = bad[2].long()
    with pytest.raises(TypeError):
        ni.neighbor_force(*bad, **kw)
    bad = list(args)
    bad[5] = bad[5].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ni.neighbor_force(*bad, **kw)


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes into its storage."""
    flat = torch.empty(t.numel() * t.element_size() + 4, dtype=torch.uint8,
                       device=t.device)
    view = flat[4:].view(t.dtype).view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 8 == 4
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 5], ids=["pos_i", "pos_j"])
def test_neighbor_force_kernel_refuses_misaligned_positions(cuda, which):
    """The kernel reads (x, y) as one 8-byte float2: a contiguous view 4
    bytes into its storage is refused before the launch, not faulted on."""
    args = list(_force_slabs(cuda, 4, 8, 72))
    args[which] = _misaligned(args[which])
    before = ni.LAUNCHES["neighbor_force"]
    with pytest.raises(ValueError, match="8-byte aligned"):
        ni.neighbor_force(*args, radius=2.0, repulsion=2.0, adhesion=0.4)
    assert ni.LAUNCHES["neighbor_force"] == before


# ---------------------------------------------------------------------------
# The flash-attention kernel (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(device, bh, sq, skv, hd, hdv, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).to(device)
            for shape in ((bh, sq, hd), (bh, skv, hd), (bh, skv, hdv))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,skv,hd,hdv", [
    (2, 128, 128, 64, 64),
    (1, 256, 256, 128, 128),
    (3, 128, 256, 32, 32),
    (2, 128, 128, 16, 16),       # the olmo-1b smoke head dim
    (4, 64, 64, 8, 8),           # internlm2-20b smoke; one partial tile
    (2, 100, 100, 64, 32),       # ragged 64-row tiles, hdv != hd
])
def test_flash_kernel_matches_plain_on_cuda(cuda, bh, sq, skv, hd, hdv,
                                            causal, dtype):
    q, k, v = _qkv(cuda, bh, sq, skv, hd, hdv, dtype)
    name = fa.kernel_for(dtype, hd, hdv)
    before = fa.LAUNCHES[name]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[name] == before + 1
    assert got.dtype == dtype and got.shape == (bh, sq, hdv)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hdv", fa.HEAD_DIMS)
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_flash_f32_every_head_dim_on_cuda(cuda, hd, hdv, causal):
    """The float32 tensor-core kernel at every (hd, hdv) it is built for,
    with Sq != Skv (128 query rows against 256 keys)."""
    q, k, v = _qkv(cuda, 2, 128, 256, hd, hdv, torch.float32, seed=hd + hdv)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def attention_f64(q, k, v, causal):
    """The function in float64: the reference both float32 versions are
    held to where their own rounding is larger than the gate (also used
    by tests/test_torch_flash_tf32.py)."""
    q, k, v = q.double(), k.double(), v.double()
    sq, skv = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q, k) * q.shape[2] ** -0.5
    if causal:
        above = (torch.arange(sq, device=q.device)[:, None]
                 < torch.arange(skv, device=q.device)[None, :])
        s = s.masked_fill(above[None], -1e30)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1), v)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_as_close_to_float64_as_plain_on_cuda(cuda, causal):
    """mma.sync truncates its sums: chained through all of S and O, they
    put the kernel ~4x further from float64 than the plain version at
    olmo-1b's scoring shape; summed in short runs from zero, no further.
    16 of its 64 heads here."""
    q, k, v = _qkv(cuda, 16, 2048, 2048, 128, 128, torch.float32, seed=3)
    want = attention_f64(q, k, v, causal)
    err = float((fa.flash_attention(q, k, v, causal=causal).double()
                 - want).abs().max())
    plain_err = float((fa.flash_attention_plain(q, k, v, causal=causal)
                       .double() - want).abs().max())
    assert err <= 1.5 * plain_err, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_raise_under_autograd_on_cuda(cuda, dtype):
    """ROADMAP B5 b: neither kernel has a backward, so a call that
    autograd would differentiate raises before any launch (the CPU's
    plain version raises alike, tests/test_torch_train.py); under
    ``no_grad`` the same call launches."""
    q, k, v = _qkv(cuda, 2, 128, 128, 64, 64, dtype)
    name = fa.kernel_for(dtype, 64, 64)
    before = fa.LAUNCHES[name]
    with pytest.raises(NotImplementedError, match="B5 b"):
        fa.flash_attention(q.requires_grad_(), k, v)
    assert fa.LAUNCHES[name] == before
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
    assert fa.LAUNCHES[name] == before + 1 and out.grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_refuse_misaligned_views(cuda, dtype):
    """Both attention kernels load 16-byte chunks (cp.async, TMA): a
    contiguous view that does not start on 16 bytes is refused."""
    q, k, v = _qkv(cuda, 2, 128, 128, 64, 64, dtype)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(q, _misaligned(k), v)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_scaled_inputs_on_cuda(cuda, causal):
    """Inputs x8 stress the TF32 split: scores x64, a peaked softmax.
    float32 itself is then ~5e-4 from the float64 function (the CPU
    emulation in tests/test_torch_flash_tf32.py shows it), so the kernel
    is held to float64 within 2x of the plain version's own error."""
    q, k, v = (t * 8 for t in _qkv(cuda, 4, 256, 256, 128, 128,
                                   torch.float32, seed=8))
    want = attention_f64(q, k, v, causal)
    got = fa.flash_attention(q, k, v, causal=causal)
    plain = fa.flash_attention_plain(q, k, v, causal=causal)
    err = float((got.double() - want).abs().max())
    plain_err = float((plain.double() - want).abs().max())
    assert err <= 2 * plain_err, (err, plain_err)


def _assert_within_bf16_ulp(got, want):
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    bound = torch.ldexp(torch.ones_like(g), e - 8) + 1e-5
    over = (g - w).abs() > bound
    assert not over.any(), (
        f"{int(over.sum())} outputs beyond one bf16 ulp + 1e-5; max abs "
        f"diff {float((g - w).abs().max())}")


@pytest.mark.parametrize("dtype,hd,hdv,name", [
    (torch.bfloat16, 128, 128, "flash_attention_wgmma"),
    (torch.bfloat16, 64, 64, "flash_attention_wgmma"),
    (torch.bfloat16, 8, 8, "flash_attention"),
    (torch.bfloat16, 64, 32, "flash_attention"),
    (torch.float32, 128, 128, "flash_attention"),
    (torch.float32, 64, 64, "flash_attention"),
])
def test_flash_kernel_choice(dtype, hd, hdv, name):
    assert fa.kernel_for(dtype, hd, hdv) == name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd", [
    (1, 128, 128),          # one tile
    (1, 128, 64),
    (2, 64, 128),           # a tile longer than the sequence
    (3, 384, 128),          # three tiles, the diagonal on each
    (2, 256, 64),
    (64, 2048, 128),        # olmo-1b's scoring shape (4 x 16 heads)
])
def test_flash_wgmma_matches_plain_on_cuda(cuda, bh, s, hd, causal):
    q, k, v = _qkv(cuda, bh, s, s, hd, hd, torch.bfloat16, seed=bh + s)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"] + 1
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"]
    assert got.dtype == torch.bfloat16 and got.shape == (bh, s, hd)
    _assert_within_bf16_ulp(got, fa.flash_attention_plain(q, k, v,
                                                          causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd,hdv", [
    (2, 256, 80, 80),        # hubert-xlarge's head dim
    (16, 1024, 80, 80),
    (2, 128, 80, 48),
    (2, 128, 24, 100),
])
def test_flash_padded_head_dims_on_cuda(cuda, bh, s, hd, hdv, causal,
                                        dtype):
    """Head dims the kernels are not built for run zero-padded: bf16 at
    hd = hdv = 80 on the wgmma kernel at 128, the rest on the float32 /
    mma.sync kernel; float32 to 2e-5, bf16 to 2e-2 and within one bf16
    ulp + 1e-5."""
    q, k, v = _qkv(cuda, bh, s, s, hd, hdv, dtype, seed=hd + hdv)
    name = fa.kernel_for(dtype, fa.built_head_dim(hd),
                         fa.built_head_dim(hdv))
    if dtype == torch.bfloat16 and hd == hdv == 80:
        assert name == "flash_attention_wgmma"
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[name] == before[name] + 1
    assert sum(fa.LAUNCHES.values()) == sum(before.values()) + 1
    assert got.shape == (bh, s, hdv) and got.is_contiguous()
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        _assert_within_bf16_ulp(got, want)


@pytest.mark.cuda
def test_flash_bhsd_gqa_on_cuda(cuda):
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 8, 128, 64), generator=g).to(cuda)
    k = torch.randn((2, 2, 128, 64), generator=g).to(cuda)
    v = torch.randn((2, 2, 128, 64), generator=g).to(cuda)
    got = ops.flash_attention_bhsd(q, k, v, causal=True)
    kr = k.repeat_interleave(4, dim=1).reshape(16, 128, 64)
    vr = v.repeat_interleave(4, dim=1).reshape(16, 128, 64)
    want = fa.flash_attention_plain(q.reshape(16, 128, 64), kr, vr)
    torch.testing.assert_close(got, want.reshape(2, 8, 128, 64), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.cuda
def test_flash_bhsd_gqa_bf16_on_cuda(cuda):
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16).to(cuda)
               for shape in ((2, 8, 256, 128), (2, 2, 256, 128),
                             (2, 2, 256, 128)))
    before = fa.LAUNCHES["flash_attention_wgmma"]
    got = ops.flash_attention_bhsd(q, k, v, causal=True)
    assert fa.LAUNCHES["flash_attention_wgmma"] == before + 1
    kr = k.repeat_interleave(4, dim=1).reshape(16, 256, 128)
    vr = v.repeat_interleave(4, dim=1).reshape(16, 256, 128)
    want = fa.flash_attention_plain(q.reshape(16, 256, 128), kr, vr)
    _assert_within_bf16_ulp(got, want.reshape(2, 8, 256, 128))


@pytest.mark.cuda
def test_flash_wgmma_at_zamba2_shared_attention_on_cuda(cuda):
    """zamba2-1.2b's shared attention block as a scoring forward gives it
    to the kernel: 32 heads of hd 64 on 4 sequences of 2048 tokens, GQA
    without grouping (32 KV heads), causal, bf16, through
    ``ops.flash_attention_bhsd``: one launch, within one bf16 ulp + 1e-5
    of the plain version."""
    g = torch.Generator().manual_seed(28)
    q, k, v = (torch.randn((4, 32, 2048, 64), generator=g).to(
        torch.bfloat16).to(cuda) for _ in range(3))
    before = dict(fa.LAUNCHES)
    got = ops.flash_attention_bhsd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"] + 1
    assert sum(fa.LAUNCHES.values()) == sum(before.values()) + 1
    assert got.shape == (4, 32, 2048, 64) and got.dtype == torch.bfloat16
    want = fa.flash_attention_plain(q.reshape(128, 2048, 64),
                                    k.reshape(128, 2048, 64),
                                    v.reshape(128, 2048, 64), causal=True)
    _assert_within_bf16_ulp(got, want.reshape(4, 32, 2048, 64))


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 128, 128, 64, 64, torch.float32)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(*_qkv(cuda, 1, 128, 128, 160, 160, torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)


# ---------------------------------------------------------------------------
# The threefry RNG (plain PyTorch, no kernel of its own) on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5,), (7, 3, 2), (4099,), (300, 24, 2)])
def test_prng_on_cuda_equals_cpu(cuda, shape):
    """Keys, bits and uniforms bit for bit as on the CPU (where they equal
    jax.random's, tests/test_torch_prng.py); normals within 2 float32 ulp
    (the card's log1p and sqrt may round differently)."""
    from repro_torch.core import prng

    for seed in (0, 7, 2**31 - 1):
        kc = prng.PRNGKey(seed)
        kg = prng.PRNGKey(seed, device=cuda)
        assert torch.equal(prng.split(kg, 5).cpu(), prng.split(kc, 5))
        kc, kg = prng.fold_in(kc, 2**31 + 3), prng.fold_in(kg, 2**31 + 3)
        assert torch.equal(kg.cpu(), kc)
        assert torch.equal(prng.random_bits(kg, shape).cpu(),
                           prng.random_bits(kc, shape))
        assert torch.equal(prng.uniform(kg, shape).cpu(),
                           prng.uniform(kc, shape))
        ng, nc = prng.normal(kg, shape).cpu(), prng.normal(kc, shape)
        ulp = (ng.view(torch.int32).long() - nc.view(torch.int32).long())
        assert int(ulp.abs().max()) <= 2


# ---------------------------------------------------------------------------
# The process mesh's wire: a packed edge buffer staged through pinned host
# memory (gloo takes no CUDA tensor) on the card and back
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_process_mesh_staged_buffer_on_cuda(cuda, tmp_path):
    """Two ranks on the card (a 2x1 torus over gloo) swap a payload of
    every slab dtype both ways, twice (the pinned buffers reused): each
    receives the other's bit for bit, on the card, as views into one
    receive buffer."""
    import json

    import process_mesh_ranks as pmr
    from repro_torch.launch.mesh import spawn_ranks

    spawn_ranks(pmr.staged_round_trip, 2, str(tmp_path / "store"),
                args=("cuda", str(tmp_path)), timeout_s=180.0)
    for r in range(2):
        res = json.loads((tmp_path / f"r{r}.json").read_text())
        assert res == {"+1": True, "-1": True, "pinned": True}, (r, res)
