"""Parity of the port's delta codec and migration position codec with the
JAX package on the same numpy inputs, on the CPU (the kernels' plain
versions).

Two JAX definitions are held: ``core/delta.py`` (the engine's path: clip
to ``[iinfo.min, iinfo.max]``, migration overflow counted on live rows,
dead rows quantized as they are) and the Pallas kernels of
``kernels/delta_codec.py`` run in interpret mode as ``tests/test_kernels.py``
runs them, with their oracles ``kernels/ref.delta_*_ref`` (clip to
``+-127``, dead rows zeroed).  Quantized values, scales and overflow counts
exactly; floats within 1e-5 (``torch_parity.FLOAT_TOL``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta as jd
from repro.kernels import delta_codec as jk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import delta as td
from repro_torch.kernels import delta_codec as tk
from repro_torch.kernels import ops as tops
from torch_parity import assert_close, torch_threads


# Small-tensor loops: one torch thread (beside busy test workers torch's
# thread pool slows them many times over).
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


QDTYPES = {"int8": (jnp.int8, torch.int8), "int16": (jnp.int16, torch.int16)}
MESH = (2, 2)


def _slab(rng, lead=(), face=5, k=6, amp=1.0):
    """A halo slab of the clustering schema with ``lead`` device dims."""
    shape = tuple(lead) + (face, k)
    return {
        "pos": (rng.normal(size=shape + (2,)) * amp).astype(np.float32),
        "diameter": (rng.uniform(0.5, 1.5, shape) * amp).astype(np.float32),
        "ctype": rng.integers(0, 2, shape).astype(np.int32),
        "valid": rng.random(shape) < 0.7,
    }


def _near(slab, rng, eps):
    """``slab`` with its float attributes moved by about ``eps``."""
    return {k: (v + rng.normal(size=v.shape).astype(np.float32) * eps
                if v.dtype == np.float32 else v) for k, v in slab.items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _cfgs(q, scale, **kw):
    jq, tq = QDTYPES[q]
    return (jd.DeltaConfig(qdtype=jq, scale=scale, **kw),
            td.DeltaConfig(qdtype=tq, scale=scale, **kw))


def _per_device(lead):
    return list(np.ndindex(*lead)) if lead else [()]


@pytest.mark.parametrize("lead", [(), MESH], ids=["one", "mesh"])
@pytest.mark.parametrize("scale", [None, 2e-7], ids=["adaptive", "fixed"])
@pytest.mark.parametrize("q", list(QDTYPES))
def test_encode_decode_delta_match_jax(q, scale, lead):
    """The fixed scale is small enough that int8 clips (and int16 too on
    the larger deltas): the overflow counts are pinned exactly."""
    rng = np.random.default_rng(1)
    ref = _slab(rng, lead)
    x = _near(ref, rng, 0.01)
    cfg_j, cfg_t = _cfgs(q, scale)
    lead_n = len(lead)
    pay_t, nref_t, of_t = td.encode_delta(_t(x), _t(ref), cfg_t, lead_n)
    out_t, _ = td.decode_delta(pay_t, _t(ref), cfg_t, lead_n)
    total = 0
    for c in _per_device(lead):
        xj = {k: v[c] for k, v in x.items()}
        rj = {k: v[c] for k, v in ref.items()}
        pay_j, nref_j, of_j = jd.encode_delta(_j(xj), _j(rj), cfg_j)
        assert set(pay_t) == set(pay_j)
        for k in pay_j:
            assert_close(pay_t[k][c], pay_j[k], f"payload {k}", exact=True)
        for k in nref_j:
            assert_close(nref_t[k][c], nref_j[k], f"new_ref {k}")
        assert int(of_t[c]) == int(of_j)
        total += int(of_j)
        out_j, _ = jd.decode_delta(pay_j, _j(rj), cfg_j)
        for k in out_j:
            assert_close(out_t[k][c], out_j[k], f"decoded {k}")
            # the closed loop: receiver reconstruction == sender's new ref
            assert torch.equal(out_t[k][c], nref_t[k][c])
    assert (total > 0) == (scale is not None)
    assert td.payload_bytes(pay_t, lead_n) == jd.payload_bytes(pay_j)


def test_zero_payload_leaves_the_reference_as_jax_does():
    """A closed-boundary device receives an all-zero payload, scale
    included: its reconstruction is ``ref + 0 * 0`` (-0.0 becomes +0.0)."""
    rng = np.random.default_rng(2)
    ref = _slab(rng)
    ref["pos"][0, 0, 0] = -0.0
    cfg_j, cfg_t = _cfgs("int8", None)
    pay_j, _, _ = jd.encode_delta(_j(ref), _j(ref), cfg_j)
    zero_j = {k: jnp.zeros_like(v) for k, v in pay_j.items()}
    zero_t = {k: torch.zeros(v.shape, dtype=getattr(torch, str(v.dtype)))
              for k, v in pay_j.items()}
    out_j, _ = jd.decode_delta(zero_j, _j(ref), cfg_j)
    out_t, _ = td.decode_delta(zero_t, _t(ref), cfg_t)
    for k in out_j:
        got, want = out_t[k].numpy(), np.asarray(out_j[k])
        assert got.tobytes() == want.tobytes(), k


def _mig_inputs(rng, lead=(), rows=40, toroidal=(True, False)):
    lsz = np.asarray([32.0, 24.0], np.float32)
    center = np.asarray([16.0, 12.0], np.float32)
    half_rng = np.asarray([18.0, 14.0], np.float32)
    pos = rng.uniform([0, 0], lsz, tuple(lead) + (rows, 2)).astype(
        np.float32)
    valid = rng.random(tuple(lead) + (rows,)) < 0.7
    # stale coordinates far out on dead rows, and one live row past the
    # range: only the live one may count as overflow
    pos[..., 1, :] = 1e4
    valid[..., 1] = False
    pos[..., 2, 1] = 70.0
    valid[..., 2] = True
    centers = np.broadcast_to(center, tuple(lead) + (2,)).copy()
    if lead:
        centers += np.arange(np.prod(lead), dtype=np.float32).reshape(
            tuple(lead) + (1,))
    return pos, valid, centers, half_rng, lsz, toroidal


@pytest.mark.parametrize("lead", [(), MESH], ids=["one", "mesh"])
@pytest.mark.parametrize("toroidal", [(True, False), (False, False)],
                         ids=["toroidal", "closed"])
def test_encode_decode_migration_match_jax(toroidal, lead):
    rng = np.random.default_rng(3)
    pos, valid, centers, half_rng, lsz, tor = _mig_inputs(
        rng, lead, toroidal=toroidal)
    cfg_j = jd.DeltaConfig(migration=jnp.int16)
    cfg_t = td.DeltaConfig(migration=torch.int16)
    slab = {"pos": pos, "valid": valid}
    lead_n = len(lead)
    enc_t, of_t = td.encode_migration(
        _t(slab), "pos", torch.from_numpy(centers), half_rng, cfg_t,
        lsz=lsz, toroidal=tor, lead=lead_n)
    dec_t = td.decode_migration(enc_t, "pos", half_rng, cfg_t, lsz=lsz,
                                toroidal=tor, lead=lead_n)
    for c in _per_device(lead):
        sj = {k: jnp.asarray(v[c]) for k, v in slab.items()}
        enc_j, of_j = jd.encode_migration(
            sj, "pos", jnp.asarray(centers[c]), half_rng, cfg_j, lsz=lsz,
            toroidal=tor)
        for k in enc_j:
            assert_close(enc_t[k][c], enc_j[k], f"payload {k}", exact=True)
        assert int(of_t[c]) == int(of_j) >= 1
        dec_j = jd.decode_migration(dict(enc_j), "pos", half_rng, cfg_j,
                                    lsz=lsz, toroidal=tor)
        assert set(dec_t) == set(dec_j)
        for k in dec_j:
            assert_close(dec_t[k][c], dec_j[k], f"decoded {k}")


# ---------------------------------------------------------------------------
# Against the Pallas kernels (interpret mode) and their oracles
# ---------------------------------------------------------------------------

def _xr(seed, n=64, l=32, eps=0.01):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, l)).astype(np.float32)
    x = (r + rng.normal(size=(n, l)) * eps).astype(np.float32)
    return x, r


def test_ops_match_pallas_and_ref():
    x, r = _xr(4)
    q_j, s_j = jops.delta_encode(jnp.asarray(x), jnp.asarray(r))
    q_t, s_t = tops.delta_encode(torch.from_numpy(x), torch.from_numpy(r))
    assert_close(q_t, q_j, "q", exact=True)
    assert_close(s_t, s_j, "scale", exact=True)
    assert_close(q_t, jref.delta_encode_ref(jnp.asarray(x), jnp.asarray(r),
                                            s_j), "q vs ref", exact=True)
    out_j = jops.delta_decode(q_j, jnp.asarray(r), s_j)
    out_t = tops.delta_decode(q_t, torch.from_numpy(r), s_t)
    assert_close(out_t, out_j, "decoded")
    assert_close(out_t, jref.delta_decode_ref(q_j, jnp.asarray(r), s_j),
                 "decoded vs ref")


@pytest.mark.parametrize("scale", [0.05, 10.0 / 127.0, 1e-3])
def test_fixed_scale_saturation_matches_pallas(scale):
    """The TPU kernel's +-127 range: saturating elements counted before
    clipping, as ``tests/test_kernels.py`` pins them."""
    r = np.zeros((64, 4), np.float32)
    x = r.copy()
    x[:3, 0] = 10.0
    x[5, 1] = -9.0
    x[7:, 2] = 1.0
    q_j, of_j = jk.delta_encode_kernel(jnp.asarray(x), jnp.asarray(r),
                                       scale, interpret=True)
    q_t, of_t = tops.delta_encode_fixed(torch.from_numpy(x),
                                        torch.from_numpy(r), scale)
    assert_close(q_t, q_j, "q", exact=True)
    assert int(of_t) == int(of_j)
    j_ops_q, j_ops_of = jops.delta_encode_fixed(jnp.asarray(x),
                                                jnp.asarray(r), scale)
    assert_close(q_t, j_ops_q, "q vs ops", exact=True)
    assert int(of_t) == int(j_ops_of)


@pytest.mark.parametrize("toroidal", [(True, False), (False, False)],
                         ids=["toroidal", "closed"])
def test_migration_kernels_match_pallas(toroidal):
    """The TPU wrapper's mode: dead rows zeroed, clip to +-32767."""
    rng = np.random.default_rng(5)
    pos, valid, centers, half_rng, lsz, tor = _mig_inputs(
        rng, toroidal=toroidal, rows=96)
    scale = np.asarray(half_rng, np.float32) / np.float32(32767.0)
    q_j, of_j = jk.migration_pos_encode_kernel(
        jnp.asarray(pos), jnp.asarray(centers), jnp.asarray(scale),
        valid=jnp.asarray(valid), lsz=lsz, toroidal=tor, interpret=True)
    q_t, of_t = tk.migration_pos_encode(
        torch.from_numpy(pos)[None], torch.from_numpy(centers)[None], scale,
        valid=torch.from_numpy(valid)[None], lsz=lsz, toroidal=tor,
        dead="zero", symmetric=True)
    assert_close(q_t[0], q_j, "q", exact=True)
    assert int(of_t[0]) == int(of_j) == 1
    p_j = jk.migration_pos_decode_kernel(q_j, jnp.asarray(centers),
                                         jnp.asarray(scale), lsz=lsz,
                                         toroidal=tor, interpret=True)
    p_t = tk.migration_pos_decode(q_t, torch.from_numpy(centers)[None],
                                  scale, lsz=lsz, toroidal=tor)
    assert_close(p_t[0], p_j, "decoded")


def test_cpu_codec_calls_count_no_launch():
    before = dict(tk.LAUNCHES)
    x, r = _xr(6)
    q, s = tops.delta_encode(torch.from_numpy(x), torch.from_numpy(r))
    tops.delta_decode(q, torch.from_numpy(r), s)
    assert tk.LAUNCHES == before


# ---------------------------------------------------------------------------
# Edge shapes: empty rows, rows that are no multiple of four, D = 3 with a
# toroidal axis, all-dead and all-live rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 3, 4 * 5 + 3])
@pytest.mark.parametrize("q", list(QDTYPES))
def test_delta_encode_edge_rows_match_jax(q, n):
    """(4, n) rows against ``core/delta.encode_delta`` a device at a time;
    n = 0 at a fixed scale only (JAX's max of an empty slab raises)."""
    rng = np.random.default_rng(7)
    ref = rng.normal(size=(4, n)).astype(np.float32)
    x = (ref + rng.normal(size=(4, n)) * 0.01).astype(np.float32)
    jq, tq = QDTYPES[q]
    for scale in ([2e-4] if n == 0 else [None, 2e-4]):
        q_t, s_t, of_t, nref_t = tk.delta_encode_plain(
            torch.from_numpy(x), torch.from_numpy(ref), qdtype=tq,
            scale=scale)
        cfg = jd.DeltaConfig(qdtype=jq, scale=scale)
        for b in range(4):
            pay, nref, of = jd.encode_delta({"a": jnp.asarray(x[b])},
                                            {"a": jnp.asarray(ref[b])}, cfg)
            assert_close(q_t[b], pay["a"], "q", exact=True)
            assert_close(s_t[b], pay["a/scale"], "scale", exact=True)
            assert int(of_t[b]) == int(of)
            assert_close(nref_t[b], nref["a"], "new_ref")


# (D, R, live rows): every R % 4, D = 2 and 3
MIG_EDGES = [(2, 41, "mixed"), (2, 42, "dead"), (2, 43, "live"),
             (3, 40, "mixed"), (3, 41, "dead"), (3, 42, "live"),
             (3, 43, "mixed")]


def _mig_edge(d, rows, live, lead=MESH, seed=8):
    """Positions in a box of sides 32, 24, 16 with a centre a device, the
    first and last axes toroidal; ``live`` "mixed" (a stale far-out dead
    row, a live row out of range on the closed axis 1), "dead" or
    "live"."""
    rng = np.random.default_rng(seed)
    lsz = np.asarray([32.0, 24.0, 16.0][:d], np.float32)
    tor = (True, False, True)[:d]
    pos = rng.uniform(0, lsz, tuple(lead) + (rows, d)).astype(np.float32)
    valid = {"mixed": rng.random(tuple(lead) + (rows,)) < 0.6,
             "dead": np.zeros(tuple(lead) + (rows,), bool),
             "live": np.ones(tuple(lead) + (rows,), bool)}[live]
    if live == "mixed":
        pos[..., 0, :] = 1e4
        valid[..., 0] = False
        pos[..., 1, 1] = 90.0
        valid[..., 1] = True
    centers = np.broadcast_to(lsz / 2, tuple(lead) + (d,)).copy()
    centers += (np.arange(np.prod(lead), dtype=np.float32) % 3).reshape(
        tuple(lead) + (1,))
    return pos, valid, centers, lsz / 2 + 4, lsz, tor


@pytest.mark.parametrize("d, rows, live", MIG_EDGES)
def test_migration_edge_shapes_match_jax(d, rows, live):
    pos, valid, centers, half_rng, lsz, tor = _mig_edge(d, rows, live)
    cfg_j = jd.DeltaConfig(migration=jnp.int16)
    cfg_t = td.DeltaConfig(migration=torch.int16)
    slab = {"pos": pos, "valid": valid}
    enc_t, of_t = td.encode_migration(
        _t(slab), "pos", torch.from_numpy(centers), half_rng, cfg_t,
        lsz=lsz, toroidal=tor, lead=len(MESH))
    for c in _per_device(MESH):
        enc_j, of_j = jd.encode_migration(
            {k: jnp.asarray(v[c]) for k, v in slab.items()}, "pos",
            jnp.asarray(centers[c]), half_rng, cfg_j, lsz=lsz, toroidal=tor)
        assert_close(enc_t["pos"][c], enc_j["pos"], "payload", exact=True)
        assert int(of_t[c]) == int(of_j) == (live == "mixed")


@pytest.mark.parametrize("d, rows, live", MIG_EDGES)
def test_migration_edge_shapes_match_pallas(d, rows, live):
    """The TPU wrapper's mode (dead rows zeroed, +-32767) on one device."""
    pos, valid, centers, half_rng, lsz, tor = _mig_edge(d, rows, live,
                                                        lead=())
    scale = np.asarray(half_rng, np.float32) / np.float32(32767.0)
    q_j, of_j = jk.migration_pos_encode_kernel(
        jnp.asarray(pos), jnp.asarray(centers), jnp.asarray(scale),
        valid=jnp.asarray(valid), lsz=lsz, toroidal=tor, interpret=True)
    q_t, of_t = tk.migration_pos_encode(
        torch.from_numpy(pos)[None], torch.from_numpy(centers)[None], scale,
        valid=torch.from_numpy(valid)[None], lsz=lsz, toroidal=tor,
        dead="zero", symmetric=True)
    assert_close(q_t[0], q_j, "q", exact=True)
    assert int(of_t[0]) == int(of_j) == (live == "mixed")


# ---------------------------------------------------------------------------
# Launch planning of the encoders (pure Python: it runs on the CPU as on the
# card, there with the card's own occupancy)
# ---------------------------------------------------------------------------

# chip_smoke.py phase 7's recorded calls: the 2x2 mesh's (int8 aura codec,
# 1026 x 48 slots a face; migration payloads of one and three faces) and
# the 2x2x2 mesh's (int16, 66^2 x 32 slots a face; one, three, nine faces)
DELTA_2D = [(4, 49248), (4, 98496)]
DELTA_3D = [(8, 139392), (8, 418176)]
MIG_2D = [(4, 49248), (4, 147744)]
MIG_3D = [(8, 139392), (8, 418176), (8, 1254528)]
# Blocks of 256 threads an H100's SM holds, as the occupancy API gave them
# on the card: 2 of the adaptive delta encode, 3 or 4 of the position
# encode (by D).
DELTA_OCC = tk.Occupancy(sms=132, per_sm=2)
MIG_OCCS = [tk.Occupancy(sms=132, per_sm=3), tk.Occupancy(sms=132, per_sm=4)]


def _tile(p, per_thread):
    """Elements (positions) of a row its blocks take at once."""
    return p.grid_x * tk.THREADS * per_thread


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4, 8])
@pytest.mark.parametrize(
    "rows, elems, per_thread",
    [(b, n, tk.TILE_ELEMS) for b, n in DELTA_2D + DELTA_3D
     + [(1, 0), (4, 3), (64, 4003), (1, 4_500_000), (1000, 8)]]
    + [(b, r, 4 * tk.MIG_CHUNKS) for b, r in MIG_2D + MIG_3D + [(4, 5003)]])
def test_plan_fits_the_card(rows, elems, per_thread, per_sm):
    """The grid never exceeds the co-resident blocks, its rounds cover the
    rows with none left empty, and no block is without a vector of work."""
    occ = tk.Occupancy(132, per_sm)
    p = tk.plan(rows, elems, per_thread, occ)
    assert p.grid_x * p.grid_y <= occ.sms * occ.per_sm
    assert p.grid_y * (p.rounds - 1) < rows <= p.grid_y * p.rounds
    assert (p.grid_x - 1) * tk.THREADS * 4 < max(elems, 1)


def test_delta_plan_at_the_mesh_shapes():
    """At the delta encode's two blocks an SM: every 2-D call in one pass
    (the register tile holds the row) on at least one block an SM; both
    3-D calls past the tile (the rest read again from L2) on every
    co-resident block; one round each."""
    for b, n in DELTA_2D:
        p = tk.plan(b, n, tk.TILE_ELEMS, DELTA_OCC)
        assert _tile(p, tk.TILE_ELEMS) >= n and p.grid_x * b >= 132
        assert p.rounds == 1
    for b, n in DELTA_3D:
        p = tk.plan(b, n, tk.TILE_ELEMS, DELTA_OCC)
        assert _tile(p, tk.TILE_ELEMS) < n and p.grid_x * b == 2 * 132
        assert p.rounds == 1
    assert tk.plan(1000, 8, tk.TILE_ELEMS, DELTA_OCC) == (1, 264, 4)


@pytest.mark.parametrize("occ", MIG_OCCS, ids=["3_per_sm", "4_per_sm"])
def test_migration_plan_at_the_mesh_shapes(occ):
    """The position encode: one round, at least one block an SM, on every
    call of both meshes."""
    for b, r in MIG_2D + MIG_3D:
        p = tk.plan(b, r, 4 * tk.MIG_CHUNKS, occ)
        assert p.rounds == 1 and p.grid_x * b >= occ.sms
        assert p.grid_x * b <= occ.sms * occ.per_sm


def test_vector_path_choice():
    """16-byte vectors where every row starts on four elements; a view one
    element in, or a row length no multiple of four, takes the scalar
    path.  The position encode needs only aligned starts (any R)."""
    x = torch.zeros((4, 16))
    view = torch.zeros(4 * 16 + 1)[1:].view(4, 16)
    assert tk._vec(16, x, x) == 1
    assert tk._vec(15, x[:, :15].contiguous(), x[:, :15].contiguous()) == 0
    assert tk._vec(16, x, view) == 0
    pos, q = torch.zeros((4, 5, 3)), torch.zeros((4, 5, 3), dtype=torch.int16)
    valid = torch.zeros(4 * 5 + 1, dtype=torch.bool)
    assert tk._aligned(pos, q, valid[:-1].view(4, 5))
    assert not tk._aligned(pos, q, valid[1:].view(4, 5))
    assert not tk._aligned(torch.zeros(4 * 5 * 3 + 1)[1:], q)


# ---------------------------------------------------------------------------
# The position decode's seam (the engine's repair, folded into the decode)
# and the decoders' launch planning
# ---------------------------------------------------------------------------

SEAM_Q = 20000       # |q| of a step that lands a hair below 0


def _seam_case(d, rows=12, lead=(1,), seed=9):
    """(B, R, D) int16 offsets in a box of sides 32, 24, 16 (axes 0 and 2
    toroidal, 1 closed), centres a row, and a per-axis scale.  Row 1 steps
    to -1 ulp of its centre on axis 0 (and row 2 on axis 2), which jnp.mod
    rounds to exactly L; row 3 sits at exactly L on the closed axis 1."""
    rng = np.random.default_rng(seed)
    lsz = np.asarray([32.0, 24.0, 16.0][:d], np.float32)
    tor = (True, False, True)[:d]
    scale = ((lsz / 2 + 4) / np.float32(32767.0)).astype(np.float32)
    b = int(np.prod(lead))
    q = rng.integers(-32767, 32768, (b, rows, d)).astype(np.int16)
    centers = np.broadcast_to(lsz / 2, (b, d)).copy()
    for a in [a for a in (0, 2) if a < d]:
        # centre - fl(SEAM_Q * s) is -1 ulp of the centre (in [8, 16): below
        # a quarter ulp of L), and jnp.mod(., L) rounds it to L
        centers[:, a] = np.nextafter(np.float32(SEAM_Q) * scale[a],
                                     np.float32(0))
        q[:, 1 + a // 2, a] = -SEAM_Q
    centers[:, 1] = lsz[1] if d > 1 else centers[:, 1]
    if d > 1:
        q[:, 3, 1] = 0
    return (q.reshape(tuple(lead) + (rows, d)),
            centers.reshape(tuple(lead) + (d,)), scale, lsz, tor)


def _seam_at_l(lsz, several):
    """0 on a one-device axis, the largest float32 below L on an axis of
    several devices (the engine's ``at_l_pos``), axis 0 as ``several``
    says and axis 2 the other way."""
    kinds = [several, False, not several][:len(lsz)]
    return np.asarray([np.nextafter(n, np.float32(0)) if k else 0.0
                       for k, n in zip(kinds, lsz)], np.float32)


def _numpy_seam(p, lsz, tor, at_l):
    return np.where(np.asarray(tor) & (p == lsz), at_l, p).astype(np.float32)


@pytest.mark.parametrize("several", [False, True], ids=["one", "several"])
@pytest.mark.parametrize("d", [2, 3])
def test_migration_decode_seam_matches_pallas(d, several):
    """``migration_pos_decode_plain(..., at_l)`` against JAX's Pallas
    decode (interpret mode) followed by the seam in numpy; without
    ``at_l`` the port leaves L as the TPU kernel does."""
    q, centers, scale, lsz, tor = _seam_case(d)
    at_l = _seam_at_l(lsz, several)
    p_j = np.asarray(jk.migration_pos_decode_kernel(
        jnp.asarray(q[0]), jnp.asarray(centers[0]), jnp.asarray(scale),
        lsz=lsz, toroidal=tor, interpret=True))
    assert p_j[1, 0] == lsz[0] and (d < 3 or p_j[2, 2] == lsz[2])
    if d > 1:
        assert p_j[3, 1] == lsz[1]               # closed: L stays L
    args = (torch.from_numpy(q), torch.from_numpy(centers), scale)
    got = tk.migration_pos_decode(*args, lsz=lsz, toroidal=tor, at_l=at_l)
    assert_close(got[0], _numpy_seam(p_j, lsz, tor, at_l), "decoded")
    assert got[0, 1, 0] == at_l[0] and (d < 3 or got[0, 2, 2] == at_l[2])
    assert d < 2 or got[0, 3, 1] == lsz[1]
    # without at_l the port's decode is the TPU kernel's, L included, and
    # at_l changes nothing but the seam's coordinates, bit for bit
    plain = tk.migration_pos_decode(*args, lsz=lsz, toroidal=tor)
    assert_close(plain[0], p_j, "decoded without at_l")
    assert plain[0, 1, 0] == lsz[0]
    assert got.numpy().tobytes() == _numpy_seam(
        plain.numpy(), lsz, tor, at_l).tobytes()


@pytest.mark.parametrize("d", [2, 3])
def test_decode_migration_at_l_matches_decode_then_seam(d):
    """``core/delta.decode_migration`` with ``at_l`` equals the decode
    followed by the seam as the engine ran it before it was folded in
    (``p == lsz`` on the toroidal axes, then ``torch.where``), bit for
    bit, on a 2x2 stack."""
    q, centers, scale, lsz, tor = _seam_case(d, rows=41, lead=MESH)
    half_rng = lsz / 2 + 4
    cfg = td.DeltaConfig(migration=torch.int16)
    at_l = _seam_at_l(lsz, True)
    pay = {"pos": torch.from_numpy(q),
           "pos/center": torch.from_numpy(centers),
           "valid": torch.ones(q.shape[:-1], dtype=torch.bool)}
    kw = dict(lsz=lsz, toroidal=tor, lead=len(MESH))
    got = td.decode_migration(dict(pay), "pos", half_rng, cfg, at_l=at_l,
                              **kw)
    before = td.decode_migration(dict(pay), "pos", half_rng, cfg, **kw)
    p = before["pos"]
    hit = (p == torch.from_numpy(lsz)) & torch.tensor(tor)
    seamed = torch.where(hit, torch.from_numpy(at_l), p)
    assert int(hit.sum()) == 4 * (1 + (d == 3))
    assert got["pos"].numpy().tobytes() == seamed.numpy().tobytes()
    assert set(got) == set(before) == {"pos", "valid"}


# The decoders' calls at those shapes: the delta decode's are the delta
# encode's, the position decode's the position encode's (R x D coordinates
# a row).  Blocks of 256 threads an H100's SM holds of a decoder (at most
# 61 registers, no shared memory): 8 or 4.
DECODE_OCCS = [tk.Occupancy(sms=132, per_sm=8), tk.Occupancy(sms=132, per_sm=4)]


def _decode_plans(occ):
    """(plan, rows, elements a row) of every recorded decoder call."""
    calls = DELTA_2D + DELTA_3D + [(b, 2 * r) for b, r in MIG_2D] + \
        [(b, 3 * r) for b, r in MIG_3D]
    return [(tk.plan(b, n, 4 * tk.DECODE_UNITS, occ), b, n)
            for b, n in calls]


@pytest.mark.parametrize("occ", DECODE_OCCS, ids=["8_per_sm", "4_per_sm"])
def test_decode_plan_at_the_mesh_shapes(occ):
    """Every recorded decoder call: one round, at most the blocks the card
    holds at once, every block with a unit of four to do, at least one
    block an SM, and each thread's DECODE_UNITS units in one pass of the
    grid-stride loop unless the grid holds every block the card holds
    (the larger calls)."""
    full = occ.sms * occ.per_sm
    multi = []
    for p, b, n in _decode_plans(occ):
        assert p.rounds == 1 and p.grid_y == b
        assert occ.sms <= p.grid_x * b <= full
        assert (p.grid_x - 1) * tk.THREADS * 4 < n
        passes = -(-n // (p.grid_x * tk.THREADS * 4 * tk.DECODE_UNITS))
        assert passes == 1 or p.grid_x * b == full
        if passes > 1:
            multi.append(n)
    # 8 an SM: the 3-D delta decode of 418,176 elements and the 3-D
    # position decodes; 4: also the 139,392-element delta decode and the
    # 2-D position decode of 147,744 rows
    assert multi == ([418176, 139392 * 3, 418176 * 3, 1254528 * 3]
                     if occ.per_sm == 8 else
                     [139392, 418176, 147744 * 2, 139392 * 3, 418176 * 3,
                      1254528 * 3])


def test_decoder_vector_path_choice():
    """The decoders' units of four: q on four of its elements and ref,
    out and pos on 16 bytes (any row length and any D; a row's elements
    before its first unit and after its last go scalar)."""
    q8 = torch.zeros(4 * 15 + 8, dtype=torch.int8)
    x = torch.zeros((4, 15))
    assert tk._aligned(q8[:60].view(4, 15), x, x)
    assert not tk._aligned(q8[2:62].view(4, 15), x, x)
    q16 = torch.zeros(4 * 5 * 3 + 8, dtype=torch.int16)
    pos = torch.zeros((4, 5, 3))
    assert tk._aligned(q16[4:64].view(4, 5, 3), pos)
    assert not tk._aligned(q16[2:62].view(4, 5, 3), pos)
