"""Dynamic load balancing (``repro_torch.core.load_balance``,
``core.reshard``, the facade's ``Rebalance`` and the CLI's
``--rebalance``) against the JAX package on the CPU.

JAX runs in this process: its planners, histograms, host re-shard and
``Rebalancer`` need no device mesh (a JAX state here is the port's state
carried over by ``repro_torch.bridge``, so both sides start bit-equal).
Integers, gids, ``valid`` and slots match exactly; floats (the planners'
imbalances, the histograms, positions) match exactly too, within the
suite's 1e-5.  The port's device transport is held to its host path bit
for bit and must never call ``flatten_state``.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.core import Engine as JEngine
from repro.core import load_balance as jlb
from repro.core import reshard as jrs
from repro.core.domain import Partition as JPartition
from repro.core.reshard import Rebalancer as JRebalancer
from repro.sims import cell_clustering as j_cc
from repro_torch.bridge import state_to_arrays
from repro_torch.core import Domain, Engine, Partition, total_agents
from repro_torch.core import load_balance as lb
from repro_torch.core import reshard as rs
from repro_torch.core.delta import DeltaConfig
from repro_torch.core.reshard import Rebalancer
from repro_torch.core.simulation import Rebalance, Simulation
from repro_torch.sims import cell_clustering as cc
from repro_torch.sims.common import resolve_delta
from torch_parity import (
    SKEWED_CENTERS, assert_dicts_close, clustered, geoms, jax_state_arrays,
    jax_state_from_arrays, torch_threads,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


# ---------------------------------------------------------------------------
# Planners
# ---------------------------------------------------------------------------

def _histogram(ndim: int, kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (16, 12) if ndim == 2 else (8, 8, 6)
    if kind == "random":
        return rng.integers(0, 9, shape).astype(np.float64)
    w = np.zeros(shape)
    for _ in range(3):
        c = [rng.uniform(0, s) for s in shape]
        grid = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
        d2 = sum((g - ci) ** 2 for g, ci in zip(grid, c))
        w += rng.uniform(20, 60) * np.exp(-d2 / 6.0)
    return np.floor(w)


@pytest.mark.parametrize("ndim,kind,n,ownership", [
    (d, k, n, o) for d in (2, 3) for k in ("random", "clustered")
    for n in (4, 8) for o in ("equal", "rcb")])
def test_planners_equal_jax(ndim, kind, n, ownership):
    w = _histogram(ndim, kind, seed=10 * ndim + n)
    got = lb.choose_partition(w, n, ownership=ownership)
    want = jlb.choose_partition(w, n, ownership=ownership)
    assert got.mesh_shape == want.mesh_shape
    assert got.partition.cuts == want.partition.cuts
    assert got.imbalance == want.imbalance
    # every factorization: the rectilinear cut, its loads and imbalance
    for mesh in jlb._factorizations(n, ndim):
        assert tuple(lb._factorizations(n, ndim)) == tuple(
            jlb._factorizations(n, ndim))
        if all(b % m == 0 for b, m in zip(w.shape, mesh)):
            np.testing.assert_array_equal(lb.equal_split_loads(w, mesh),
                                          jlb.equal_split_loads(w, mesh))
        if any(m > b for m, b in zip(mesh, w.shape)):
            continue
        p = lb.plan_rectilinear(w, mesh)
        q = jlb.plan_rectilinear(w, mesh)
        assert p.cuts == q.cuts, mesh
        lp = lb.partition_loads(w, p)
        np.testing.assert_array_equal(lp, jlb.partition_loads(w, q))
        assert lb.imbalance(lp) == jlb.imbalance(lp)
    if n & (n - 1) == 0:
        np.testing.assert_array_equal(lb.plan_rcb(w, n), jlb.plan_rcb(w, n))
    col = w.sum(axis=tuple(range(1, ndim)))
    widths = np.full((4,), col.size // 4, np.int64)
    rt = np.asarray([3.0, 1.0, 2.0, 2.5])
    new = lb.plan_diffusive(widths, col, rt)
    np.testing.assert_array_equal(new, jlb.plan_diffusive(widths, col, rt))
    np.testing.assert_array_equal(lb.widths_to_ownership(new),
                                  jlb.widths_to_ownership(new))
    with pytest.warns(DeprecationWarning, match="choose_partition"):
        shape = lb.choose_mesh_shape(w, n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert shape == jlb.choose_mesh_shape(w, n)


# ---------------------------------------------------------------------------
# States on both sides
# ---------------------------------------------------------------------------

def pair(start: str = "2x2", steps: int = 0, n: int = 400, seed: int = 0,
         codec: str = "int8+mig"):
    """``(port engine, port state, JAX engine, JAX state)``: the port's
    state after ``steps`` steps, carried to JAX."""
    g, jg = geoms(start)
    cfg = resolve_delta(codec, g.n_devices) or None
    eng = Engine(geom=g, behavior=cc.behavior(adhesion=0.4), dt=0.1,
                 device="cpu", **({"delta_cfg": cfg} if cfg else {}))
    pos, attrs = clustered(n, seed)
    st = eng.init_state(pos, attrs, seed=seed)
    if steps:
        _, st, _ = eng.drive(st, steps)
    jeng = JEngine(geom=jg, behavior=j_cc.behavior(adhesion=0.4), dt=0.1)
    return eng, st, jeng, jax_state_from_arrays(state_to_arrays(st))


def gid_set(state) -> set:
    v = state.soa.valid.reshape(-1)
    r = state.soa.attrs["gid_rank"].reshape(-1)[v].tolist()
    c = state.soa.attrs["gid_count"].reshape(-1)[v].tolist()
    return set(zip(r, c))


def assert_bit_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# Histograms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", ["2x2", "uneven", "1x1"])
def test_histograms_equal_jax(start):
    eng, st, jeng, jst = pair(start, steps=2)
    g, jg = eng.geom, jeng.geom
    np.testing.assert_array_equal(rs.occupancy_histogram(g, st),
                                  jrs.occupancy_histogram(jg, jst))
    rt = np.asarray([[1.0, 2.5], [0.7, 3.1]])[:g.mesh_shape[0],
                                               :g.mesh_shape[1]]
    np.testing.assert_array_equal(rs.occupancy_histogram(g, st, rt),
                                  jrs.occupancy_histogram(jg, jst, rt))
    np.testing.assert_array_equal(
        rs.estimate_device_runtimes(g, st, 0.25),
        jrs.estimate_device_runtimes(jg, jst, 0.25))
    assert rs.current_imbalance(g, st) == jrs.current_imbalance(jg, jst)
    h = rs.occupancy_histogram(g, st)
    np.testing.assert_array_equal(rs.realized_loads(g, h),
                                  jrs.realized_loads(jg, h))
    p, q = rs.plan_reshard(h, g), jrs.plan_reshard(h, jg)
    assert (p.mesh_shape, p.imbalance, p.current, p.rcb_bound,
            p.diffusive_bound, p.partition_imbalance) == (
        q.mesh_shape, q.imbalance, q.current, q.rcb_bound,
        q.diffusive_bound, q.partition_imbalance)
    assert p.partition.cuts == q.partition.cuts


# ---------------------------------------------------------------------------
# The two transports
# ---------------------------------------------------------------------------

def _target(eng, st, target):
    """``reshard_state`` keywords for the port and for JAX."""
    if target == "4x1":
        return dict(mesh_shape=(4, 1)), dict(mesh_shape=(4, 1))
    if target == "1x1":
        return dict(mesh_shape=(1, 1)), dict(mesh_shape=(1, 1))
    plan = rs.plan_reshard(rs.occupancy_histogram(eng.geom, st), eng.geom)
    cuts = plan.partition.cuts
    assert not plan.partition.is_equal
    return (dict(partition=Partition(cuts=cuts)),
            dict(partition=JPartition(cuts=cuts)))


@pytest.mark.parametrize("steps", [0, 3])
@pytest.mark.parametrize("target", ["4x1", "planned", "1x1"])
def test_host_reshard_equals_jax(target, steps):
    eng, st, jeng, jst = pair("2x2", steps=steps)
    mine, theirs = _target(eng, st, target)
    e2, s2 = rs.reshard_state(eng, st, transport="host", **mine)
    j2, js2 = jrs.reshard_state(jeng, jst, transport="host", **theirs)
    assert e2.geom.mesh_shape == j2.geom.mesh_shape
    assert e2.geom.interior == j2.geom.interior
    assert (e2.geom.partition is None) == (j2.geom.partition is None)
    assert_dicts_close(state_to_arrays(s2), jax_state_arrays(js2))
    assert total_agents(s2) == total_agents(st) == 400


@pytest.mark.parametrize("start,target", [
    ("2x2", "4x1"), ("2x2", "planned"), ("uneven", "4x1"),
    ("uneven", "planned")])
def test_device_transport_equals_host_path(start, target, monkeypatch):
    eng, st, _, _ = pair(start, steps=3)
    st.dropped[1, 0] += 3          # the cumulative drops move to device 0
    mine, _ = _target(eng, st, target)
    e1, s1 = rs.reshard_state(eng, st, transport="host", **mine)

    def refuse(*a, **k):
        raise AssertionError("the device transport called flatten_state")

    monkeypatch.setattr(rs, "flatten_state", refuse)
    e2, s2 = rs.reshard_state(eng, st, transport="device", **mine)
    assert e2.geom == e1.geom
    assert_bit_equal(state_to_arrays(s2), state_to_arrays(s1))
    assert int(s2.dropped[0, 0]) == int(s2.dropped.sum()) == 3
    # "auto" takes the device path on an unchanged count above one
    e3, s3 = rs.reshard_state(eng, st, transport="auto", **mine)
    assert_bit_equal(state_to_arrays(s3), state_to_arrays(s1))


def test_device_transport_3d_equals_host_path(monkeypatch):
    from repro_torch.sims import tumor_spheroid as ts

    g = Domain(cell_size=2.0, interior=(4, 4, 3), mesh_shape=(1, 2, 2),
               cap=16)
    eng = Engine(geom=g, behavior=ts.behavior(), dt=0.1, device="cpu")
    rng = np.random.default_rng(4)
    n = 150
    pos = rng.uniform(0.5, np.asarray(g.domain_size) - 0.5,
                      (n, 3)).astype(np.float32)
    names = eng.behavior.schema.all_specs(3)
    attrs = {k: np.zeros((n,) + shape, np.float32 if dt.is_floating_point
                         else np.int32)
             for k, (shape, dt) in names.items()
             if k not in ("pos", "gid_rank", "gid_count")}
    st = eng.init_state(pos, attrs, seed=4)
    part = Partition(cuts=((0, 4), (0, 3, 8), (0, 5, 6)))
    e1, s1 = rs.reshard_state(eng, st, partition=part, transport="host")
    monkeypatch.setattr(rs, "flatten_state", None)
    e2, s2 = rs.reshard_state(eng, st, partition=part, transport="device")
    assert_bit_equal(state_to_arrays(s2), state_to_arrays(s1))
    assert total_agents(s2) == n


# ---------------------------------------------------------------------------
# The reference's other re-shard tests, mirrored
# ---------------------------------------------------------------------------

def test_gid_floors_survive_mesh_downsize():
    g = Domain(cell_size=2.0, interior=(8, 16), mesh_shape=(2, 1), cap=32)
    eng = Engine(geom=g, behavior=cc.behavior(), dt=0.1, device="cpu")
    rng = np.random.default_rng(0)
    n = 20
    attrs = {"diameter": np.full((n,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, n).astype(np.int32),
             "gid_rank": np.zeros(n, np.int32),
             "gid_count": np.arange(n, dtype=np.int32)}
    pos = rng.uniform(0.5, 31.5, (n, 2)).astype(np.float32)
    # floors from an earlier 4-rank mesh; its rank 3 issued up to id 38
    st = eng.init_state(pos, attrs, gid_counters=np.asarray([5, 5, 5, 39]))
    assert (st.gid_counter >= 39).all()
    assert gid_set(st) == {(0, i) for i in range(n)}
    with pytest.raises(ValueError, match="carried gid_rank"):
        eng.init_state(pos, {k: attrs[k] for k in ("diameter", "ctype")},
                       gid_counters=np.asarray([5]))


@pytest.mark.parametrize("transport", ["host", "device"])
def test_reshard_spawn_counters_never_reissue_gids(transport):
    eng, st, _, _ = pair("2x2")
    gids = gid_set(st)
    e2, s2 = rs.reshard_state(eng, st, (4, 1), transport=transport)
    assert gid_set(s2) == gids
    counters = s2.gid_counter.reshape(-1).tolist()
    ranks = s2.soa.attrs["gid_rank"][s2.soa.valid]
    counts = s2.soa.attrs["gid_count"][s2.soa.valid]
    for r, c in enumerate(counters):
        mine = counts[ranks == r]
        if mine.numel():
            assert c > int(mine.max())
    assert int(s2.it.max()) == int(st.it.max())


def test_reshard_transport_validation():
    eng, st, _, _ = pair("2x2")
    with pytest.raises(ValueError, match="transport"):
        rs.reshard_state(eng, st, (1, 4), transport="carrier-pigeon")
    with pytest.raises(ValueError, match="exactly one"):
        rs.reshard_state(eng, st)
    # an unrealizable device transport refuses, never falls back
    with pytest.raises(ValueError, match="use the host path"):
        rs.reshard_state(eng, st, (1, 1), transport="device")
    one, st1, _, _ = pair("1x1")
    with pytest.raises(ValueError, match="use the host path"):
        rs.reshard_state(one, st1, (1, 1), transport="device")
    with pytest.raises(ValueError, match="ownership"):
        Rebalancer(ownership="diagonal")
    with pytest.raises(ValueError, match="transport"):
        Rebalancer(transport="carrier-pigeon")


def test_auto_transport_takes_the_host_path_when_unrealizable(monkeypatch):
    eng, st, _, _ = pair("2x2", steps=2)
    gids = gid_set(st)

    def refuse(*a, **k):
        raise AssertionError("auto took the device path")

    monkeypatch.setattr(rs, "reshard_state_device", refuse)
    e2, s2 = rs.reshard_state(eng, st, (1, 1), transport="auto")
    assert e2.geom.mesh_shape == (1, 1) and gid_set(s2) == gids
    one, st1, _, _ = pair("1x1")
    e3, s3 = rs.reshard_state(one, st1, (1, 1), transport="auto")
    assert gid_set(s3) == gid_set(st1)


# ---------------------------------------------------------------------------
# Rebalancer decisions
# ---------------------------------------------------------------------------

def _records(history):
    return [{k: v for k, v in h.items() if k != "migration_s"}
            for h in history]


def _uniform_pair():
    g, jg = geoms("2x2")
    eng = Engine(geom=g, behavior=cc.behavior(), dt=0.1, device="cpu")
    rng = np.random.default_rng(1)
    n = 400
    pos = rng.uniform(0.5, 31.5, (n, 2)).astype(np.float32)
    attrs = {"diameter": np.full((n,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, n).astype(np.int32)}
    st = eng.init_state(pos, attrs)
    jeng = JEngine(geom=jg, behavior=j_cc.behavior(), dt=0.1)
    return eng, st, jeng, jax_state_from_arrays(state_to_arrays(st))


@pytest.mark.parametrize("case", [
    "equal-applied", "rcb-applied", "below-threshold", "no-gain",
    "deferred"])
def test_rebalancer_history_equals_jax(case):
    if case == "below-threshold":
        eng, st, jeng, jst = _uniform_pair()
    else:
        eng, st, jeng, jst = pair("2x2", steps=2)
    kw = dict(every=1, threshold=0.2)
    if case == "rcb-applied":
        kw.update(ownership="rcb", min_gain=1.05)
    elif case == "below-threshold":
        kw.update(threshold=0.5)
    elif case == "no-gain":
        kw.update(threshold=0.0, min_gain=1e9)
    elif case == "deferred":
        kw.update(ownership="rcb", min_gain=1.05, defer=True)
    rb, jrb = Rebalancer(**kw), JRebalancer(**kw)
    calls = 2 if case == "deferred" else 1
    for _ in range(calls):
        e2, s2, done = rb.maybe_reshard(eng, st)
        j2, js2, jdone = jrb.maybe_reshard(jeng, jst)
        assert done == jdone
    assert _records(rb.history) == _records(jrb.history)
    applied = case.endswith("applied") or case == "deferred"
    assert done is applied and len(rb.history) == 1
    if case == "deferred":
        assert rb.history[0]["deferred"] and not rb.pending
    if applied:
        assert e2.geom.mesh_shape == j2.geom.mesh_shape
        assert_dicts_close(state_to_arrays(s2), jax_state_arrays(js2))
        assert rb.engine is e2
    else:
        assert e2 is eng and s2 is st


def test_deferred_drive_lands_one_step_later(monkeypatch):
    """defer=True through ``Engine.drive``: each decision lands one step
    after its every-4 snapshot, migrations ride the device transport
    (``flatten_state`` never runs), and the agents are conserved."""
    eng, st, _, _ = pair("2x2", codec="off")
    calls = []
    monkeypatch.setattr(rs, "flatten_state",
                        lambda *a, **k: calls.append(1))
    rb = Rebalancer(every=4, threshold=0.2, min_gain=1.05, ownership="rcb",
                    defer=True)
    e2, s2, _ = eng.drive(st, 12, rebalancer=rb)
    applied = [h for h in rb.history if h["applied"]]
    assert applied, rb.history
    assert all(h["it"] % 4 == 1 for h in rb.history), rb.history
    assert all(h.get("deferred") for h in rb.history)
    assert all(h["transport"] == "device" for h in applied)
    assert not calls
    assert e2.geom.uneven and rb.engine is e2
    assert total_agents(s2) + int(s2.dropped.sum()) == 400


def test_engine_rebalance_every_builds_its_own_rebalancer():
    eng, st, _, _ = pair("2x2", codec="off")
    eng = Engine(geom=eng.geom, behavior=eng.behavior, dt=0.1,
                 device="cpu", rebalance_every=2, imbalance_threshold=0.2)
    e2, s2, _ = eng.drive(st, 4)
    assert e2 is not eng and e2.geom.mesh_shape != (2, 2)
    assert e2.rebalance_every == 2
    assert total_agents(s2) + int(s2.dropped.sum()) == 400
    assert int(s2.it.max()) == 4


def test_reshard_forces_a_full_refresh_under_int16_mig():
    """The re-shard zeroes the delta references: the step after it is a
    full aura refresh (``Engine.drive`` with a per-step ``step_fn``), the
    others follow the refresh schedule."""
    g, _ = geoms("2x2")
    eng = Engine(geom=g, behavior=cc.behavior(adhesion=0.4), dt=0.1,
                 device="cpu", delta_cfg=DeltaConfig(
                     enabled=True, qdtype=torch.int16, refresh_interval=8,
                     migration=torch.int16))
    st = eng.init_state(*clustered(400, 0), seed=0)
    fulls = []

    def wrap(step):
        def f(state, full_halo=True):
            fulls.append(full_halo)
            return step(state, full_halo=full_halo)
        return f

    rb = Rebalancer(every=3, threshold=0.3,
                    make_step=lambda e: wrap(e.make_local_step()))
    e2, s2, _ = eng.drive(st, 9, step_fn=wrap(eng.make_local_step()),
                          rebalancer=rb)
    applied = [h["it"] for h in rb.history if h["applied"]]
    assert applied, rb.history
    want = [i % 8 == 0 or i in applied for i in range(9)]
    assert fulls == want
    assert total_agents(s2) == 400
    assert torch.isfinite(s2.soa.pos[s2.soa.valid]).all()


def test_facade_rcb_rebalance_lands_uneven_and_conserves():
    sim = Simulation(dict(interior=(8, 8), mesh_shape=(2, 2), cap=64),
                     cc.behavior(adhesion=0.3), dt=0.1, device="cpu",
                     rebalance=Rebalance(every=4, threshold=0.3,
                                         ownership="rcb"))
    rng = np.random.default_rng(0)
    n = 500
    centers = np.asarray(SKEWED_CENTERS)
    pos = np.clip(centers[rng.integers(0, 2, n)]
                  + rng.normal(0, 3.0, (n, 2)), 0.5, 31.5).astype(np.float32)
    attrs = {"diameter": np.full((n,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, n).astype(np.int32)}
    sim.init(pos, attrs, seed=0)
    before = rs.current_imbalance(sim.geom, sim.state)
    sim.run(10)
    applied = [r for r in sim.rebalancer.history if r["applied"]]
    assert applied, sim.rebalancer.history
    assert sim.engine.geom.uneven
    after = rs.current_imbalance(sim.geom, sim.state)
    assert sim.n_agents() == n and int(sim.state.dropped.sum()) == 0
    assert after < before / 2, (before, after)
    rec = applied[0]
    assert rec["partition_imbalance"] <= rec["rcb_bound"] * 1.1 + 1e-9
    sim.run(4)
    assert sim.n_agents() == n and sim.iteration == 14


def test_weighted_facade_check_waits_for_a_measurement():
    sim = Simulation(dict(interior=(8, 8), mesh_shape=(2, 2), cap=64),
                     cc.behavior(adhesion=0.3), dt=0.1, device="cpu",
                     rebalance=Rebalance(every=3, threshold=0.2,
                                         weighted=True))
    sim.init(*clustered(300, 2), seed=0)
    sim.run(7)
    its = [h["it"] for h in sim.rebalancer.history]
    assert its == [3, 6], its
    assert sim.n_agents() == 300


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_rebalance_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.simulate", "--sim",
            "cell_clustering", "--device", "cpu", "--mesh", "2x2",
            "--agents", "300", "--steps", "4"]
    out = subprocess.run(base + ["--rebalance", "2", "--imbalance", "0.01",
                                 "--ownership", "rcb"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("sim=cell_clustering devices=4 agents=300 ")
    assert "dropped=0 codec_overflow=0" in lines[1]
    bad = subprocess.run(base + ["--ownership", "rcb"], capture_output=True,
                         text=True, env=env, timeout=300)
    assert bad.returncode != 0 and "--rebalance" in bad.stderr
