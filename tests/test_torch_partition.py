"""Uneven partitions on the port's virtual mesh.

* Against the JAX package: ``cell_clustering`` (closed) and
  ``epidemiology`` (toroidal) on the uneven 2x2 cut ``from_widths([(3, 5),
  (4, 4)])``, with the codec off and with ``int16+mig``.  The init state
  (agents routed by the cuts) against JAX's, then each step from JAX's
  state before it against JAX's sharded per-step engine after it (one
  subprocess with four XLA host devices for the file): integers,
  ``valid``, gids and the slot layout exactly, floats to 1e-5.
* In the port alone, bit for bit: a count-driven behaviour with spawns
  (the reference's property test, tests/test_partition.py) on one device,
  on the equal 2x2 split and on two uneven splits, the overlapped sweep on
  one of them; and the ``sir_mechanics`` ensemble on an uneven partition,
  each lane against its solo run on the same partition.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.bridge import state_to_arrays
from repro_torch.core import AgentSchema, Behavior, Domain, Engine, Partition
from repro_torch.core.ensemble import replica_state
from repro_torch.sims import sir_mechanics as sm
from torch_parity import (
    check_steps_like_oracle, run_mesh_oracle, torch_threads,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = ((3, 5), (4, 4))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


CASES = {}
for codec in ("off", "int16+mig"):
    CASES[f"cell_clustering-{codec}"] = dict(
        sim="cell_clustering", codec=codec, init=(200, 0), steps=4,
        make=dict(widths=WIDTHS, cap=16))
    CASES[f"epidemiology-{codec}"] = dict(
        sim="epidemiology", codec=codec, init=(200, 20, 0), steps=4,
        make=dict(widths=WIDTHS, cap=24, boundary="toroidal", dt=1.0))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("partition_oracle") / "oracle.npz")
    return run_mesh_oracle(CASES, path, ROOT)


@pytest.mark.parametrize("name", sorted(CASES))
def test_uneven_steps_match_jax_sharded(oracle, name):
    with torch.inference_mode():
        counts = check_steps_like_oracle(oracle, name, CASES[name])
    assert counts == [200] * CASES[name]["steps"]


# ---------------------------------------------------------------------------
# Bit-exact across partitions, in the port
# ---------------------------------------------------------------------------

SCHEMA = AgentSchema.create({"diameter": ((), torch.float32),
                             "ctype": ((), torch.int32)})


def _count_pair(ai, aj, disp, dist2, params):
    return {"cnt": torch.ones_like(dist2)}


def _det_update(attrs, valid, acc, key, params, dt):
    """The reference property test's update: a drift driven by the count
    (under one cell a step), and a child where the count is 3."""
    new = dict(attrs)
    step = torch.tensor([1.25, -0.75]) * (
        1.0 + 0.0625 * torch.clamp(acc["cnt"], max=8.0)[..., None])
    new["pos"] = attrs["pos"] + torch.where(valid[..., None], step,
                                            torch.zeros(()))
    spawn = valid & (acc["cnt"] == 3.0) & (attrs["ctype"] == 1)
    child = dict(new)
    child["pos"] = new["pos"] + torch.tensor([0.1, 0.05])
    child["ctype"] = torch.zeros_like(attrs["ctype"])
    return new, valid, spawn, child


COUNT_BEHAVIOR = Behavior(schema=SCHEMA, pair_fn=_count_pair,
                          pair_attrs=("ctype",), update_fn=_det_update,
                          radius=2.0, params={}, can_spawn=True)
GX, GY = 16, 12
BOUNDARY = ("toroidal", "closed")


def _fingerprint(state):
    """Live agents' (pos, ctype, diameter), sorted: gids are issued by
    device rank, so they differ from one partition to another."""
    v = state.soa.valid.reshape(-1)
    p = state.soa.pos.reshape(-1, 2)[v].numpy()
    c = state.soa.attrs["ctype"].reshape(-1)[v].numpy()
    d = state.soa.attrs["diameter"].reshape(-1)[v].numpy()
    o = np.lexsort((d, c, p[:, 1], p[:, 0]))
    return p[o], c[o], d[o]


def _count_run(part, overlap="auto", steps=10):
    # the fullest cell holds 13 agents at most; no drop is asserted below
    kw = dict(cell_size=2.0, cap=16, boundary=BOUNDARY)
    geom = Domain(interior=(GX, GY), **kw) if part is None else Domain(
        interior=part.max_widths, mesh_shape=part.mesh_shape,
        partition=part, **kw)
    eng = Engine(geom=geom, behavior=COUNT_BEHAVIOR, dt=1.0, overlap=overlap,
                 device="cpu")
    rng = np.random.default_rng(11)
    n = 220
    pos = rng.uniform(0.5, [2 * GX - 0.5, 2 * GY - 0.5], (n, 2)
                      ).astype(np.float32)
    attrs = {"diameter": np.full((n,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, n).astype(np.int32)}
    state = eng.init_state(pos, attrs, seed=0)
    _, state, _ = eng.drive(state, steps)
    assert int(state.dropped.sum()) == 0
    return state


def test_partitions_are_bit_exact_with_one_device():
    """One device, the equal 2x2 split and two uneven splits (one with the
    overlapped sweep): the same agents, bit for bit, after 10 steps of a
    count-driven drift with spawns."""
    want = _fingerprint(_count_run(None))
    assert len(want[0]) > 220                 # the spawn path fired
    for part, overlap in (
            (Partition.equal((GX, GY), (2, 2)), "auto"),
            (Partition.from_widths([(5, 11), (7, 5)]), "auto"),
            (Partition.from_widths([(9, 7), (4, 8)]), "on")):
        got = _fingerprint(_count_run(part, overlap))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=str(part.cuts))


def test_uneven_ensemble_lanes_equal_solo_runs():
    """sir_mechanics' ensemble on an uneven 2x2 partition: every lane bit
    for bit its solo run on the same partition (the reference pins this in
    tests/test_ensemble.py)."""
    part = Partition.from_widths([(3, 5), (5, 3)])
    ens = sm.ensemble_family(partition=part, device="cpu")
    assert ens.geom.uneven and ens.geom.interior == (5, 5)
    points = [{"beta": 0.3, "sir_radius": 1.5},
              {"beta": 0.6, "sir_radius": 1.0, "repulsion": 3.0},
              {"beta": 0.45, "gamma": 0.2, "sir_radius": 1.25}]
    est = sm.ensemble_init(ens, points, n_agents=200, initial_infected=10)
    out, _ = ens.run(est, 6)
    for r, p in enumerate(points):
        solo = ens.solo_engine({**sm.ensemble_defaults(), **p})
        s = solo.make_segment_runner()(replica_state(est.state, r), 6)
        got, want = state_to_arrays(replica_state(out.state, r)), \
            state_to_arrays(s)
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), (r, k)
        assert int(s.soa.valid.sum()) == 200


# ---------------------------------------------------------------------------
# The position codec's back-crossing (ROADMAP C)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("widths,boundary", [
    (((6, 6), (8,)), "closed"),        # the equal split
    (((6, 10), (8,)), "closed"),       # an uneven cut
    (((6, 10), (8,)), "toroidal"),     # and across the seam
])
def test_migration_codec_back_crossing_keeps_the_agents(widths, boundary):
    """Agents stepping 2e-4 down across a cut (and, on the torus, up across
    the seam), in steps of 2e-5 around it: the int16 position codec rounds
    some of them back across it, as JAX's codec does (checked in process
    below), and the reference bins them into the receiver's ring, where
    the next aura rebuild deletes them uncounted.  The port moves them onto
    the receiver's slab: all agents kept, inside the domain."""
    import jax.numpy as jnp

    from repro.core.delta import DeltaConfig as JDeltaConfig
    from repro.core.delta import decode_migration, encode_migration
    from repro_torch.sims.common import resolve_delta

    part = Partition.from_widths(widths)
    geom = Domain(cell_size=2.0, interior=part.max_widths,
                  mesh_shape=part.mesh_shape, cap=16, boundary=boundary,
                  partition=part)
    cut = 2.0 * widths[0][0]
    L = geom.domain_size[0]
    k = np.arange(1, 10, dtype=np.float32)
    down = np.float32(cut + 2e-4) - np.float32(2e-5) * k     # -> below cut
    up = np.float32(L - 2e-4) + np.float32(2e-5) * k          # -> past L
    x0 = np.concatenate([down, up if boundary == "toroidal" else []])
    n = len(x0)
    pos = np.stack([x0, 1.0 + (np.arange(n) % 7) * 2.0], 1).astype(
        np.float32)
    steps = np.where(x0 > cut, np.float32(-2e-4), np.float32(2e-4))

    def update(attrs, valid, acc, key, params, dt):
        drift = torch.where(attrs["pos"][..., :1] > cut,
                            torch.tensor([-2e-4, 0.0]),
                            torch.tensor([2e-4, 0.0]))
        return ({**attrs, "pos": attrs["pos"] + drift}, valid,
                torch.zeros_like(valid), None)

    beh = Behavior(schema=AgentSchema.create({}), pair_fn=_count_pair,
                   pair_attrs=(), update_fn=update, radius=1.0)
    eng = Engine(geom=geom, behavior=beh, delta_cfg=resolve_delta(
        "int16+mig", 2), dt=1.0, device="cpu")
    st = eng.init_state(pos, {}, seed=0)
    step = eng.make_local_step()
    for _ in range(3):
        st = step(st)
        assert int(st.soa.valid.sum()) == n and int(st.dropped.sum()) == 0
    p = st.soa.pos[st.soa.valid]
    assert bool(((p[:, 0] >= 0) & (p[:, 0] < L)).all())

    # JAX's codec on the agents leaving the device above the cut, in that
    # device's frame (origin + half its padded extent, range two cells
    # more): some decode on the wrong side of the cut they crossed
    half = np.float32(part.max_widths[0] * 2.0 / 2.0)
    half_rng = np.asarray([half + 4.0, 8.0 + 4.0], np.float32)
    center = jnp.asarray([cut + half, 8.0], jnp.float32)
    x1 = (down + steps[:len(down)]).astype(np.float32)
    slab = {"pos": jnp.asarray(np.stack([x1, np.ones_like(x1)], 1))}
    cfg = JDeltaConfig(enabled=True, migration=jnp.int16)
    enc, _ = encode_migration(slab, "pos", center, half_rng, cfg)
    back = np.asarray(decode_migration(enc, "pos", half_rng, cfg)["pos"])
    assert (x1 < cut).all() and (back[:, 0] >= cut).any()
