"""The port's resilience stack - runtime guards (``core.guards``), fault
plans (``distributed.chaos``) and supervised runs (``launch.supervise``) -
against the JAX package's.

* Guard words: from JAX's guarded state with a NaN position, an
  out-of-domain and an out-of-slab agent and a duplicated gid planted
  (``resilience_cases.plant``), one step of the port equals one step of
  JAX's, every field, the per-device health word exactly; and
  ``check_health``'s report (the duplicate count included) equals JAX's.
  One device in process; the 2x2 mesh on an equal and an uneven cut,
  ``overlap`` off and on, against JAX's sharded per-step engine (one
  subprocess with four XLA host devices for the file); the ensemble's
  per-lane words against JAX's ``tiled`` ensemble.
* Fault plans corrupt the same slots as JAX's ``_corrupt``, bit for bit
  (``nan_attrs`` on positions and on another float attribute,
  ``halo_slab`` along each axis; one device, the equal and the uneven
  2x2), fire once, and ``maybe_tear`` truncates the same file.
* Supervisor logs (kinds, steps, ``rolled_back_to``, devices, replays)
  equal JAX's for the same plans: tests/test_resilience.py's local plans
  in process, its sharded ones (a halo fault on 2x1, the overlapped sweep's
  held to the same log, and the device-loss degrade from 2x2 to 2
  devices) in the subprocess.
  Recovery is bit-exact, by gid, against an uninterrupted resume; retry
  exhaustion raises; ``check_supervision`` gates unguarded runs.
* The conservation divergence of ROADMAP C 2 and C 6: where the reference
  loses an agent (the toroidal seam; the position codec's back-crossing,
  in the subprocess), its conservation guard trips and the port's, which
  keeps the agent, does not.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import resilience_cases as rc
from repro.core import guards as jg
from repro.distributed import chaos as jchaos
from repro.launch import supervise as jsup
from repro.sims import cell_clustering as jcc
from repro.sims import sir_mechanics as jsm
from repro.sims.common import make_sim as j_make_sim
from repro_torch.bridge import (
    ensemble_from_arrays, ensemble_to_arrays, state_from_arrays,
    state_to_arrays,
)
from repro_torch.core import Partition
from repro_torch.core import guards as tg
from repro_torch.core.ensemble import ensemble_health_counts
from repro_torch.core.simulation import Simulation
from repro_torch.distributed import chaos as tchaos
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.launch import supervise as tsup
from repro_torch.sims import cell_clustering as cc
from repro_torch.sims import sir_mechanics as sm
from repro_torch.sims.common import make_sim
from torch_parity import (
    assert_dicts_close, jax_state_arrays, jax_state_from_arrays,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_kw(make: dict, partition_cls) -> dict:
    kw = dict(make)
    widths = kw.pop("widths", None)
    if widths is not None:
        kw["partition"] = partition_cls.from_widths(widths)
    return kw


def port_sim(make=None, guards="error", **kw):
    """The reference resilience tests' sim in the port (16 x 16 cells of
    2.0, cap 24, dt 0.5, 300 agents unless ``make`` says otherwise)."""
    make = dict(make or {})
    make.setdefault("interior", (16, 16)) if "widths" not in make else None
    sim = make_sim(cc.behavior(adhesion=rc.ADHESION), cap=24, dt=0.5,
                   guards=guards, device="cpu",
                   **_make_kw(make, Partition), **kw)
    sim.init(*rc.init_data())
    return sim


def jax_sim(make=None, guards="error", **kw):
    from repro.core import Partition as JPartition
    make = dict(make or {})
    make.setdefault("interior", (16, 16)) if "widths" not in make else None
    sim = j_make_sim(jcc.behavior(adhesion=rc.ADHESION), cap=24, dt=0.5,
                     guards=guards, **_make_kw(make, JPartition), **kw)
    sim.init(*rc.init_data())
    return sim


def by_gid(state):
    """Live agents' (positions, gid_rank, gid_count), gid-sorted."""
    a = state_to_arrays(state)
    v = a["soa.valid"].ravel()
    p = a["soa.attrs.pos"].reshape(-1, 2)[v]
    gr = a["soa.attrs.gid_rank"].ravel()[v]
    gc = a["soa.attrs.gid_count"].ravel()[v]
    o = np.lexsort((gc, gr))
    return p[o], gr[o], gc[o]


def _report(check, guards, state, **kw):
    """check_health from a zero mark under "warn": the report's fields."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, rep = check(guards, state, np.zeros(5, np.int64), **kw)
    return None if rep is None else (rep.counts.tolist(), rep.new.tolist(),
                                     rep.iteration, rep.format())


# ---------------------------------------------------------------------------
# The JAX oracle subprocess (four XLA host devices), one a file
# ---------------------------------------------------------------------------

ORACLE = """
import json, os, sys
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
import resilience_cases as rc
from torch_parity import jax_state_arrays, jax_state_from_arrays
from repro.core import Partition, Behavior, AgentSchema, Domain, Engine
from repro.core import guards as G
from repro.core.domain import spatial_axis_names
from repro.distributed.chaos import Fault, FaultPlan
from repro.launch.mesh import make_abm_mesh
from repro.launch.supervise import Supervised, Supervisor
from repro.sims import cell_clustering as cc
from repro.sims.common import make_sim, resolve_delta

OUT = {out!r}


def kw_of(make):
    kw = dict(make)
    w = kw.pop("widths", None)
    if w is not None:
        kw["partition"] = Partition.from_widths(w)
    return kw


def guard_case(name):
    make, overlap = rc.MESH_GUARD_CASES[name]
    sim = make_sim(cc.behavior(adhesion=rc.ADHESION), cap=24, dt=0.5,
                   guards="warn", sweep_backend="reference",
                   overlap=overlap, **kw_of(make))
    n, seed = rc.MESH_GUARD_AGENTS
    cc.init(sim, n, seed=seed)
    mesh = sim.mesh
    sh = NamedSharding(mesh, P(*spatial_axis_names(2)))
    step = sim.engine.make_sharded_step(mesh)
    s = jax.device_put(sim.state, sh)
    for _ in range(2):
        s = step(s, full_halo=True)
    pre = rc.plant(jax_state_arrays(s), rc.MESH_DOMAIN_X)
    post = step(jax.device_put(jax_state_from_arrays(pre), sh),
                full_halo=True)
    out = {{f"{{name}}/pre/{{k}}": v for k, v in pre.items()}}
    out.update({{f"{{name}}/post/{{k}}": v
                for k, v in jax_state_arrays(post).items()}})
    facts = dict(counts=G.health_counts(post).tolist(),
                 dups=G.gid_duplicate_count(post))
    return out, {{name: facts}}


def plan_case(name):
    make, faults, seed, sup, steps = rc.MESH_PLANS[name]
    sim = make_sim(cc.behavior(adhesion=rc.ADHESION), cap=24, dt=0.5,
                   guards="error", **kw_of(make))
    sim.init(*rc.init_data())
    n0 = sim.n_agents()
    plan = FaultPlan(tuple(Fault(**f) for f in faults), seed=seed)
    sv = Supervisor(sim, Supervised(dir=os.path.join(OUT, name), **sup),
                    fault_plan=plan)
    sv.run(steps, fused=False)     # the same log, fewer compiles
    return {{}}, {{name: dict(log=rc.log_view(sv.log), n0=n0,
                            n=sim.n_agents(), iteration=sim.iteration,
                            mesh=list(sim.engine.geom.mesh_shape),
                            health=G.health_counts(sim.state).tolist())}}


def back_crossing(name):
    # ROADMAP C 6 on the uneven cut (6, 10): agents stepping 2e-4 down
    # across the cut at 12 from 12.0002 - k 2e-5; the reference loses
    # those its position codec rounds back across
    widths = ((6, 10), (8,))
    part = Partition.from_widths(widths)
    geom = Domain(cell_size=2.0, interior=part.max_widths,
                  mesh_shape=part.mesh_shape, cap=16, boundary="closed",
                  partition=part)
    cut = np.float32(12.0)
    k = np.arange(1, 10, dtype=np.float32)
    x0 = np.float32(cut + 2e-4) - np.float32(2e-5) * k
    pos = np.stack([x0, 1.0 + (np.arange(9) % 7) * 2.0], 1).astype(
        np.float32)

    def update(attrs, valid, acc, key, params, dt):
        drift = jnp.where(attrs["pos"][..., :1] > cut,
                          jnp.asarray([-2e-4, 0.0], jnp.float32),
                          jnp.asarray([2e-4, 0.0], jnp.float32))
        return ({{**attrs, "pos": attrs["pos"] + drift}}, valid,
                jnp.zeros_like(valid), None)

    def count(ai, aj, disp, dist2, params):
        return {{"cnt": jnp.ones_like(dist2)}}

    beh = Behavior(schema=AgentSchema.create({{}}), pair_fn=count,
                   pair_attrs=(), update_fn=update, radius=1.0)
    eng = Engine(geom=geom, behavior=beh,
                 delta_cfg=resolve_delta("int16+mig", 2), dt=1.0,
                 guards=G.GuardConfig(policy="warn"))
    st = eng.init_state(pos, {{}}, seed=0)
    mesh = make_abm_mesh(geom.mesh_shape)
    step = eng.make_sharded_step(mesh)
    st = jax.device_put(st, NamedSharding(mesh,
                                          P(*spatial_axis_names(2))))
    for _ in range(3):
        st = step(st, full_halo=False)
    return {{}}, {{name: dict(counts=G.health_counts(st).tolist(),
                            n=int(np.asarray(st.soa.valid).sum()),
                            dropped=int(np.asarray(st.dropped).sum()))}}


jobs = [(guard_case, n) for n in rc.MESH_GUARD_CASES]
jobs += [(plan_case, n) for n in sorted(set(rc.JAX_MESH_PLAN.values()))]
jobs += [(back_crossing, "back_crossing")]
arrays, facts = {{}}, {{}}
with ThreadPoolExecutor(4) as pool:
    for a, f in pool.map(lambda j: j[0](j[1]), jobs):
        arrays.update(a)
        facts.update(f)
np.savez(os.path.join(OUT, "arrays.npz"), **arrays)
with open(os.path.join(OUT, "facts.json"), "w") as fh:
    json.dump(facts, fh)
print("OK")
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("resilience_oracle"))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    code = ORACLE.format(tests=os.path.join(ROOT, "tests"), out=out)
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=900, env=env)
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    with np.load(os.path.join(out, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(out, "facts.json")) as fh:
        facts = json.load(fh)
    return arrays, facts


def _sub(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Guard configuration
# ---------------------------------------------------------------------------

def test_guard_config_validation():
    with pytest.raises(ValueError):
        tg.GuardConfig(policy="loud")
    assert not tg.GuardConfig().enabled
    assert tg.GuardConfig(policy="warn").enabled
    assert tg.as_guard_config(None) == tg.GuardConfig()
    assert tg.as_guard_config("error").policy == "error"
    with pytest.raises(TypeError):
        tg.as_guard_config(42)
    assert tg.GUARD_NAMES == jg.GUARD_NAMES
    assert tg.NUM_GUARDS == jg.NUM_GUARDS


# ---------------------------------------------------------------------------
# Guard words against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_one_device():
    """JAX's guarded sim after 2 steps, as arrays."""
    sim = jax_sim(guards="warn")
    sim.run(2)
    return sim, jax_state_arrays(sim.state)


KINDS = {"nan": ("nan",), "domain": ("domain",), "dup": ("dup",),
         "all": ("nan", "domain", "slab", "dup")}


@pytest.mark.parametrize("kinds", sorted(KINDS))
def test_guard_words_equal_jax_one_device(jax_one_device, kinds):
    sim_j, arrays = jax_one_device
    pre = rc.plant(arrays, 32.0, KINDS[kinds])
    post_j = sim_j.engine.make_local_step()(jax_state_from_arrays(pre))
    sim_t = port_sim(guards="warn")
    post_t = sim_t.engine.make_local_step()(state_from_arrays(pre, "cpu"))
    assert_dicts_close(state_to_arrays(post_t), jax_state_arrays(post_j))
    np.testing.assert_array_equal(post_t.health.numpy(),
                                  np.asarray(post_j.health))
    assert tg.health_counts(post_t).tolist() == \
        jg.health_counts(post_j).tolist()
    assert tg.gid_duplicate_count(post_t) == jg.gid_duplicate_count(post_j)
    assert _report(tg.check_health, sim_t.engine.guards, post_t) == \
        _report(jg.check_health, sim_j.engine.guards, post_j)
    if kinds != "dup":
        assert post_t.health.sum() > 0


@pytest.mark.parametrize("name", sorted(rc.MESH_GUARD_CASES))
def test_guard_words_equal_jax_on_the_2x2(oracle, name):
    """One step of the port from JAX's planted 2x2 state (an equal or an
    uneven cut, the overlapped sweep off or on) against JAX's sharded
    step: every field, the per-device health words exactly."""
    arrays, facts = oracle
    make, overlap = rc.MESH_GUARD_CASES[name]
    sim = make_sim(cc.behavior(adhesion=rc.ADHESION), cap=24, dt=0.5,
                   guards="warn", overlap=overlap, sweep_backend="kernel",
                   device="cpu", **_make_kw(make, Partition))
    pre = _sub(arrays, f"{name}/pre/")
    want = _sub(arrays, f"{name}/post/")
    got = sim.engine.make_local_step()(state_from_arrays(pre, "cpu"),
                                       full_halo=True)
    assert_dicts_close(state_to_arrays(got), want)
    np.testing.assert_array_equal(got.health.numpy(), want["health"])
    assert tg.health_counts(got).tolist() == facts[name]["counts"]
    assert tg.gid_duplicate_count(got) == facts[name]["dups"] == 1
    for i in (tg.GUARD_NAN, tg.GUARD_DOMAIN, tg.GUARD_SLAB):
        assert facts[name]["counts"][i] > 0, facts[name]


def test_ensemble_lane_words_equal_jax():
    """A NaN planted in lane 1 of a 3-lane guarded ensemble: after one
    step every lane's word equals JAX's ``tiled`` ensemble's, lanes 0 and
    2 clean (lanes independent)."""
    points = [{"beta": 0.02}, {"beta": 0.08, "sigma": 0.5},
              {"gamma": 0.3, "sir_radius": 1.0}]
    ens_j = jsm.ensemble_family(interior=(8, 8), sweep_backend="tiled",
                                guards=jg.GuardConfig(policy="warn"))
    est_j = jsm.ensemble_init(ens_j, points, n_agents=200,
                              initial_infected=10)
    arrays = {k: np.array(v) for k, v in
              jax_state_arrays(est_j.state).items()}
    v = arrays["soa.valid"][1]
    first = tuple(int(c) for c in np.argwhere(v)[0])
    arrays["soa.attrs.pos"][(1,) + first] = np.nan
    est_j = dataclasses.replace(est_j, state=jax_state_from_arrays(arrays))
    arrays.update({f"params.{n}": np.asarray(p)
                   for n, p in est_j.params.items()})
    arrays["active"] = np.asarray(est_j.active)
    ens_t = sm.ensemble_family(interior=(8, 8), guards="warn", device="cpu")
    got, _ = ens_t.run(ensemble_from_arrays(arrays, "cpu"), 1)
    want, _ = ens_j.run(est_j, 1)
    from repro.core.ensemble import ensemble_health_counts as j_counts
    words = ensemble_health_counts(got)
    assert words.tolist() == j_counts(want).tolist()
    assert words[1, tg.GUARD_NAN] > 0
    assert not words[0].any() and not words[2].any()
    got_a = ensemble_to_arrays(got)
    want_a = jax_state_arrays(want.state)
    assert_dicts_close({k: got_a[k] for k in want_a}, want_a)


def test_healthy_guarded_run_is_bit_equal_to_an_unguarded_one():
    """policy "off" and a healthy guarded run give the same state, every
    field (the guards add to the health word only, and here it stays 0);
    the guarded 2x2 run with the int8 codec trips nothing."""
    a = port_sim(guards=None)
    b = port_sim(guards="error")
    a.run(6)
    b.run(6)
    A, B = state_to_arrays(a.state), state_to_arrays(b.state)
    assert all(A[k].tobytes() == B[k].tobytes() for k in A)
    m = port_sim(dict(interior=(8, 8), mesh_shape=(2, 2)), guards="error",
                 delta="int8")
    m.run(16)
    assert tg.health_counts(m.state).tolist() == [0, 0, 0, 0, 0]
    assert m.n_agents() == 300


def test_nan_guard_error_warn_and_engine_drive():
    sim = port_sim()
    sim.run(3)
    arrays = rc.plant(state_to_arrays(sim.state), 32.0, ("nan",))
    sim.state = state_from_arrays(arrays, "cpu")
    with pytest.raises(tg.HealthError) as ei:
        sim.run(2)
    assert "nan_inf" in str(ei.value)
    assert ei.value.report.new[tg.GUARD_NAN] > 0
    warn = port_sim(guards="warn")
    warn.state = state_from_arrays(arrays, "cpu")
    with pytest.warns(UserWarning, match="nan_inf"):
        warn.run(2)
    assert tg.health_counts(warn.state)[tg.GUARD_NAN] > 0
    off = port_sim(guards=None)
    off.state = state_from_arrays(arrays, "cpu")
    off.run(2)
    assert tg.health_counts(off.state).tolist() == [0, 0, 0, 0, 0]
    drive = port_sim()
    with pytest.raises(tg.HealthError):
        drive.engine.drive(state_from_arrays(arrays, "cpu"), 2)


def test_engine_drive_fires_a_fault_plan_at_its_step():
    sim = port_sim(guards=None)
    plan = tchaos.FaultPlan((tchaos.Fault(step=5, kind="raise"),))
    with pytest.raises(tchaos.ChaosError):
        sim.run(10, fault_plan=plan)
    assert sim.iteration == 5      # the segment broke at the fault step
    eng = sim.engine
    plan = tchaos.FaultPlan((tchaos.Fault(step=7, kind="raise"),))
    with pytest.raises(tchaos.ChaosError):
        eng.drive(sim.state, 6, fault_plan=plan)
    plan = tchaos.FaultPlan((tchaos.Fault(step=6, kind="nan_attrs"),))
    guarded = port_sim()
    guarded.run(5)
    with pytest.raises(tg.HealthError):
        guarded.engine.drive(guarded.state, 3, fault_plan=plan)


# ---------------------------------------------------------------------------
# Fault plans against JAX's
# ---------------------------------------------------------------------------

CHAOS_GEOMS = {"one": dict(), "2x2": dict(interior=(8, 8), mesh_shape=(2, 2)),
               "uneven": dict(widths=((6, 10), (9, 7)))}
CHAOS_FAULTS = {
    "nan_pos": dict(kind="nan_attrs", frac=0.1),
    "nan_diameter": dict(kind="nan_attrs", frac=0.2, attr="diameter"),
    "halo_axis0": dict(kind="halo_slab", axis=0),
    "halo_axis1": dict(kind="halo_slab", axis=1),
}


@pytest.mark.parametrize("fault", sorted(CHAOS_FAULTS))
@pytest.mark.parametrize("geom", sorted(CHAOS_GEOMS))
def test_fault_plan_corrupts_the_slots_jax_corrupts(geom, fault):
    """The port's state after 2 steps, through each package's plan (JAX's
    on the bridged arrays): the corrupted attribute bit for bit."""
    sim = port_sim(CHAOS_GEOMS[geom], guards=None)
    sim.run(2)
    j_eng = jax_sim(CHAOS_GEOMS[geom], guards=None).engine
    arrays = state_to_arrays(sim.state)
    kw = CHAOS_FAULTS[fault]
    name = "soa.attrs." + kw.get("attr", "pos")
    for it in (2, 5):
        f = dict(kw, step=it)
        tp = tchaos.FaultPlan((tchaos.Fault(**f),), seed=7)
        jp = jchaos.FaultPlan((jchaos.Fault(**f),), seed=7)
        got, fired_t = tp.fire(sim.engine, sim.state, it)
        want, fired_j = jp.fire(j_eng, jax_state_from_arrays(arrays), it)
        assert fired_t and fired_j
        g = state_to_arrays(got)[name]
        w = np.asarray(want.soa.attrs[name.split(".")[-1]])
        assert g.tobytes() == w.tobytes()
        assert np.isnan(g).any()
        # fire once: the same step never corrupts twice
        again, fired = tp.fire(sim.engine, got, it)
        assert not fired and again is got
        assert tp.next_step(after=0) is None


def test_fault_plan_validation_and_raising_kinds():
    with pytest.raises(ValueError):
        tchaos.Fault(step=3, kind="meteor")
    with pytest.raises(ValueError):
        tchaos.Fault(step=-1, kind="raise")
    plan = tchaos.FaultPlan((tchaos.Fault(step=4, kind="raise"),
                             tchaos.Fault(step=9, kind="raise"),
                             tchaos.Fault(step=2, kind="torn_checkpoint")))
    assert plan.next_step(after=0) == 4
    assert plan.next_step(after=4) == 9
    sim = port_sim(dict(interior=(8, 8), mesh_shape=(2, 2)), guards=None)
    plan = tchaos.FaultPlan((tchaos.Fault(step=0, kind="device_loss"),))
    with pytest.raises(tchaos.DeviceLost) as e:
        plan.fire(sim.engine, sim.state, 0)
    assert e.value.survivors == 3
    bad = tchaos.FaultPlan((tchaos.Fault(step=0, kind="nan_attrs",
                                         attr="ctype"),))
    jbad = jchaos.FaultPlan((jchaos.Fault(step=0, kind="nan_attrs",
                                          attr="ctype"),))
    with pytest.raises(ValueError) as et:
        bad.fire(sim.engine, sim.state, 0)
    j_eng = jax_sim(dict(interior=(8, 8), mesh_shape=(2, 2)),
                    guards=None).engine
    with pytest.raises(ValueError) as ej:
        jbad.fire(j_eng, jax_state_from_arrays(state_to_arrays(sim.state)),
                  0)
    assert str(et.value) == str(ej.value)


def test_maybe_tear_truncates_the_file_jax_truncates(tmp_path):
    for side in ("port", "jax"):
        for step in (5, 10):
            tckpt.save(str(tmp_path / side), step,
                       {"x": np.arange(100), "y": np.ones(7)})
    tp = tchaos.FaultPlan((tchaos.Fault(step=8, kind="torn_checkpoint"),))
    jp = jchaos.FaultPlan((jchaos.Fault(step=8, kind="torn_checkpoint"),))
    assert tp.maybe_tear(str(tmp_path / "port"), 7) is None   # not due
    got = tp.maybe_tear(str(tmp_path / "port"), 10)
    want = jp.maybe_tear(str(tmp_path / "jax"), 10)
    assert os.path.basename(got) == os.path.basename(want)
    for f in sorted(os.listdir(got)):
        assert open(os.path.join(got, f), "rb").read() == \
            open(os.path.join(want, f), "rb").read(), f
    assert tp.maybe_tear(str(tmp_path / "port"), 12) is None  # fired
    with pytest.warns(UserWarning, match="step_0000000010"):
        step, _, _ = tckpt.restore(str(tmp_path / "port"))
    assert step == 5


# ---------------------------------------------------------------------------
# Supervised runs
# ---------------------------------------------------------------------------

def _plans(faults, seed, mod):
    return mod.FaultPlan(tuple(mod.Fault(**f) for f in faults), seed=seed)


def _supervise(side, tmp_path, name, make, faults, seed, sup, steps,
               fused=True):
    """Run one plan on ``side`` ("port" | "jax"); returns (sim,
    supervisor, raised error or None)."""
    t = side == "port"
    sim = port_sim(make) if t else jax_sim(make)
    plan = _plans(faults, seed, tchaos if t else jchaos)
    mod = tsup if t else jsup
    sv = mod.Supervisor(sim, mod.Supervised(
        dir=str(tmp_path / side / name), **sup), fault_plan=plan)
    err = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            sv.run(steps, fused=fused)
        except Exception as e:  # noqa: BLE001 - compared below
            err = e
    return sim, sv, err


@pytest.mark.parametrize("name", sorted(rc.LOCAL_PLANS))
def test_supervisor_log_equals_jax_local(tmp_path, name):
    make, faults, seed, sup, steps = rc.LOCAL_PLANS[name]
    sim_t, sv_t, err_t = _supervise("port", tmp_path, name, make, faults,
                                    seed, sup, steps)
    sim_j, sv_j, err_j = _supervise("jax", tmp_path, name, make, faults,
                                    seed, sup, steps)
    assert rc.log_view(sv_t.log) == rc.log_view(sv_j.log)
    assert type(err_t).__name__ == type(err_j).__name__
    assert sim_t.iteration == sim_j.iteration
    if err_t is None:
        assert sv_t.events("completed")
        assert sim_t.n_agents() == 300
        assert tg.health_counts(sim_t.state).tolist() == [0, 0, 0, 0, 0]
    if name == "retry_exhaustion":
        assert isinstance(err_t, tchaos.ChaosError)
        assert sv_t.events("giving_up")
        assert len(sv_t.events("recovered")) == 2
    if name == "torn_checkpoint":
        assert sv_t.events("torn_checkpoint")
        assert [e["rolled_back_to"] for e in sv_t.events("recovered")] \
            == [5]


def test_supervised_recovery_is_bit_exact_local(tmp_path):
    ck = str(tmp_path / "ck")
    sim = port_sim()
    plan = tchaos.FaultPlan((tchaos.Fault(step=7, kind="nan_attrs",
                                          frac=0.1),), seed=42)
    sv = tsup.Supervisor(sim, tsup.Supervised(dir=ck, every=5, keep=9),
                         fault_plan=plan)
    sv.run(12)
    rec = sv.events("recovered")
    assert len(rec) == 1 and rec[0]["rolled_back_to"] == 5
    assert rec[0]["error_type"] == "HealthError"
    ctl = Simulation.restore(ck, cc.behavior(adhesion=rc.ADHESION), step=5,
                             guards="error", device="cpu")
    ctl.run(12 - 5)
    for a, b in zip(by_gid(sim.state), by_gid(ctl.state)):
        assert a.tobytes() == b.tobytes()


def test_supervised_run_via_the_facade_and_its_refusals(tmp_path):
    ck = str(tmp_path / "ck")
    sim = port_sim()
    plan = tchaos.FaultPlan((tchaos.Fault(step=4, kind="raise"),))
    sim.run(8, supervised=tsup.Supervised(dir=ck, every=4, keep=9),
            fault_plan=plan)
    assert sim.iteration == 8
    assert tckpt.latest_step(ck) == 8
    with pytest.raises(ValueError, match="collect"):
        sim.run(2, supervised=ck, collect=lambda s: 0)
    from repro_torch.analysis import ContractError
    off = port_sim(guards=None)
    with pytest.raises(ContractError, match="guard policy 'off'"):
        off.run(10, supervised=str(tmp_path / "ck2"))
    no_degrade = port_sim(dict(interior=(8, 8), mesh_shape=(2, 2)))
    plan = tchaos.FaultPlan((tchaos.Fault(step=2, kind="device_loss"),))
    sv = tsup.Supervisor(no_degrade, tsup.Supervised(
        dir=str(tmp_path / "ck3"), every=2, keep=3, degrade=False),
        fault_plan=plan)
    with pytest.raises(tchaos.DeviceLost):
        sv.run(4)
    assert sv.events("giving_up")[0]["reason"] == "degrade disabled"


@pytest.mark.parametrize("name", sorted(rc.MESH_PLANS))
def test_supervisor_log_equals_jax_on_a_mesh(oracle, tmp_path, name):
    """tests/test_resilience.py's sharded plans on the virtual mesh: the
    log as JAX's sharded run's (the overlapped halo fault's as the
    monolithic sweep's, caught at the same step); recovery bit-exact
    against an
    uninterrupted resume from the rollback checkpoint onto the devices
    the run recovered onto (the device loss: 2 of 4)."""
    _, facts = oracle
    make, faults, seed, sup, steps = rc.MESH_PLANS[name]
    # per step, as the oracle ran it (a fused segment reads the guards at
    # its end: the fault event's iteration is the segment's)
    sim, sv, err = _supervise("port", tmp_path, name, make, faults, seed,
                              sup, steps, fused=False)
    assert err is None, err
    want = facts[rc.JAX_MESH_PLAN[name]]
    assert rc.log_view(sv.log) == want["log"]
    assert sim.iteration == want["iteration"] == steps
    assert list(sim.engine.geom.mesh_shape) == want["mesh"]
    assert sim.n_agents() == want["n"] == want["n0"]
    assert tg.health_counts(sim.state).tolist() == want["health"] \
        == [0, 0, 0, 0, 0]
    rec = sv.events("recovered")[-1]
    # (the overlapped sweep is bit-equal to the monolithic one)
    ctl = Simulation.restore(
        str(tmp_path / "port" / name), cc.behavior(adhesion=rc.ADHESION),
        step=rec["rolled_back_to"], n_devices=rec["devices"],
        guards="error", device="cpu")
    ctl.run(steps - rec["rolled_back_to"])
    for a, b in zip(by_gid(sim.state), by_gid(ctl.state)):
        assert a.tobytes() == b.tobytes()
    p = sim.state.soa.pos[sim.state.soa.valid]
    assert bool(torch.isfinite(p).all())


# ---------------------------------------------------------------------------
# ROADMAP C 2 / C 6: the reference's conservation guard trips where it
# loses an agent; the port keeps the agent and its guard stays at 0
# ---------------------------------------------------------------------------

def test_seam_conservation_guard_trips_in_jax_only():
    from repro.core import AgentSchema as JSchema
    from repro.core import Behavior as JBehavior
    from repro.core import Domain as JDomain
    from repro.core import Engine as JEngine
    from repro_torch.core import AgentSchema, Behavior, Domain
    from repro_torch.core.engine import Engine

    shift = np.float32(3e-7)        # 1e-7 - 3e-7 mod 16 rounds to 16

    def j_update(attrs, valid, acc, key, params, dt):
        return ({**attrs, "pos": attrs["pos"] - shift}, valid,
                jnp.zeros_like(valid), None)

    def t_update(attrs, valid, acc, key, params, dt):
        return ({**attrs, "pos": attrs["pos"] - torch.tensor(shift)}, valid,
                torch.zeros_like(valid), None)

    def j_pair(ai, aj, disp, dist2, params):
        return {"n": jnp.ones_like(dist2)}

    def t_pair(ai, aj, disp, dist2, params):
        return {"n": torch.ones_like(dist2)}

    kw = dict(cell_size=2.0, interior=(8, 8), cap=8, boundary="toroidal")
    eng_j = JEngine(geom=JDomain(**kw), behavior=JBehavior(
        schema=JSchema.create({}), pair_fn=j_pair, pair_attrs=(),
        update_fn=j_update, radius=1.0), dt=1.0,
        guards=jg.GuardConfig(policy="warn"))
    eng_t = Engine(geom=Domain(**kw), behavior=Behavior(
        schema=AgentSchema.create({}), pair_fn=t_pair, pair_attrs=(),
        update_fn=t_update, radius=1.0), dt=1.0, guards="warn",
        device="cpu")
    pos = np.array([[1e-7, 5.0], [7.0, 7.0]], np.float32)
    st_j = eng_j.init_state(pos, {}, seed=0)
    st_t = eng_t.init_state(pos, {}, seed=0)
    for _ in range(2):
        st_j = eng_j.make_local_step()(st_j)
        st_t = eng_t.make_local_step()(st_t)
    # the reference loses the agent, uncounted, and its guard says so
    assert int(np.asarray(st_j.soa.valid).sum()) == 1
    assert jg.health_counts(st_j)[jg.GUARD_CONSERVATION] > 0
    # the port keeps it, and its guard stays at 0
    assert int(st_t.soa.valid.sum()) == 2
    assert tg.health_counts(st_t).tolist() == [0, 0, 0, 0, 0]


def test_back_crossing_conservation_guard_trips_in_jax_only(oracle):
    from repro_torch.core import AgentSchema, Behavior, Domain
    from repro_torch.core.engine import Engine
    from repro_torch.sims.common import resolve_delta

    _, facts = oracle
    want = facts["back_crossing"]
    assert want["n"] < 9 and want["dropped"] == 0     # lost, uncounted
    assert want["counts"][jg.GUARD_CONSERVATION] > 0

    part = Partition.from_widths(((6, 10), (8,)))
    geom = Domain(cell_size=2.0, interior=part.max_widths,
                  mesh_shape=part.mesh_shape, cap=16, boundary="closed",
                  partition=part)
    cut = 12.0
    k = np.arange(1, 10, dtype=np.float32)
    x0 = np.float32(cut + 2e-4) - np.float32(2e-5) * k
    pos = np.stack([x0, 1.0 + (np.arange(9) % 7) * 2.0], 1).astype(
        np.float32)

    def update(attrs, valid, acc, key, params, dt):
        drift = torch.where(attrs["pos"][..., :1] > cut,
                            torch.tensor([-2e-4, 0.0]),
                            torch.tensor([2e-4, 0.0]))
        return ({**attrs, "pos": attrs["pos"] + drift}, valid,
                torch.zeros_like(valid), None)

    def count(ai, aj, disp, dist2, params):
        return {"cnt": torch.ones_like(dist2)}

    eng = Engine(geom=geom, behavior=Behavior(
        schema=AgentSchema.create({}), pair_fn=count, pair_attrs=(),
        update_fn=update, radius=1.0),
        delta_cfg=resolve_delta("int16+mig", 2), dt=1.0, guards="warn",
        device="cpu")
    st = eng.init_state(pos, {}, seed=0)
    step = eng.make_local_step()
    for _ in range(3):
        st = step(st, full_halo=False)
    assert int(st.soa.valid.sum()) == 9
    assert tg.health_counts(st).tolist() == [0, 0, 0, 0, 0]
