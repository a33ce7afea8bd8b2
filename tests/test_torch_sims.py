"""Parity of the port's bundled sims - ``epidemiology``, ``sir_mechanics``,
``cell_proliferation`` and ``oncology`` - with the JAX package on the same
numpy inputs, at the sims' small default sizes on one device: every field
of the state after every step (the RNG key, the slot layout, ``valid``,
gids, ``state``, ``gid_counter`` and ``dropped`` exactly; positions and
diameters to 1e-5) and the scheduled S/I/R and agent-count series
exactly.  The JAX side sweeps with its ``tiled`` backend, the port with
its kernel's plain version.  The draws are the reference's bit for bit
(``repro_torch.core.prng``), so infections, recoveries and divisions match
exactly.

``sir_mechanics`` runs at dt = 1.0 with forces: float sums taken in
another order (XLA's reduction against PyTorch's) differ in the last bit,
and its dynamics amplify that - JAX's own ``tiled`` and ``reference``
backends end 2.8e-3 apart in positions after 10 steps.  So its steps are
held to 1e-5 each from the reference's state (bridged into the port), and
its free run is held exactly on everything but positions.

Epidemiology also runs on a 2x2 mesh against the JAX sharded per-step
engine (one subprocess with four XLA host devices), which exercises each
device's rank in its step key.  And ``compose(b)`` is bit-exact with
``b`` in the port, spawning behaviours included.
"""

import importlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.bridge import state_from_arrays, state_to_arrays
from repro_torch.core import DeltaConfig, Domain, Engine
from repro_torch.core.behaviors import compose
from repro_torch.core.simulation import Simulation
from repro_torch.sims import cell_clustering as cc
from repro_torch.sims import cell_proliferation as cp
from repro_torch.sims import epidemiology as ep
from repro_torch.sims import oncology as onc
from repro_torch.sims import sir_mechanics as sm
from repro_torch.sims.common import uniform_positions
from torch_parity import (
    assert_dicts_close, jax_state_arrays, torch_threads,
)


# Small-tensor loops: one torch thread (beside busy test workers torch's
# thread pool slows them many times over).
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# sim -> steps (cell_proliferation's first division comes at step 10)
FREE_RUNS = {"epidemiology": 10, "cell_proliferation": 16, "oncology": 10}


def _pair(name):
    jm = importlib.import_module(f"repro.sims.{name}")
    tm = importlib.import_module(f"repro_torch.sims.{name}")
    return (jm.simulation(sweep_backend="tiled"),
            tm.simulation(sweep_backend="kernel", device="cpu"))


def _series(sim):
    return {k: list(v) for k, v in sim.series.items()}


@pytest.mark.parametrize("name", sorted(FREE_RUNS))
def test_sim_runs_like_jax(name):
    sim_j, sim_t = _pair(name)
    assert_dicts_close(state_to_arrays(sim_t.state),
                       jax_state_arrays(sim_j.state))
    n0 = sim_t.n_agents()
    for _ in range(FREE_RUNS[name]):
        sim_j.run(1)
        sim_t.run(1)
        assert_dicts_close(state_to_arrays(sim_t.state),
                           jax_state_arrays(sim_j.state))
        assert _series(sim_t) == _series(sim_j)
    if name == "epidemiology":
        s, i, r = sim_t.series["sir"][-1]
        assert s + i + r == n0 and r > 0 and s < n0 - 30
        assert ep.sir_counts(sim_t.state) == (s, i, r)
    else:                       # the spawn path ran
        assert sim_t.n_agents() > n0
        assert int(sim_t.state.gid_counter.sum()) == sim_t.n_agents()


def test_sir_mechanics_steps_like_jax():
    """Each of 10 steps from the reference's state, to 1e-5."""
    sim_j, sim_t = _pair("sir_mechanics")
    step_t = sim_t.engine.make_local_step()
    for _ in range(10):
        arrays = jax_state_arrays(sim_j.state)
        got = step_t(state_from_arrays(arrays, device="cpu"))
        sim_j.run(1)
        assert_dicts_close(state_to_arrays(got),
                           jax_state_arrays(sim_j.state))


def test_sir_mechanics_free_run_like_jax():
    """10 free steps: the S/I/R series and every field but positions
    exactly (positions drift apart by float summation order, see above)."""
    sim_j, sim_t = _pair("sir_mechanics")
    for _ in range(10):
        sim_j.run(1)
        sim_t.run(1)
        assert _series(sim_t) == _series(sim_j)
        got = state_to_arrays(sim_t.state)
        want = jax_state_arrays(sim_j.state)
        skip = [k for k in want
                if k.endswith(".pos") or k.startswith("refs.")]
        assert_dicts_close(got, want, exact_keys=set(want), skip=skip)
    s, i, r = sim_t.series["sir"][-1]
    assert s + i + r == 400 and r > 0


def _run(beh, init, steps, boundary="closed", dt=0.1, cap=32):
    sim = Simulation(dict(interior=(8, 8), cap=cap, boundary=boundary),
                     beh, dt=dt, device="cpu")
    init(sim)
    sim.run(steps)
    return state_to_arrays(sim.state)


@pytest.mark.parametrize("name", ["cell_clustering", "epidemiology",
                                  "cell_proliferation"])
def test_compose_of_one_is_bit_exact(name):
    """``compose(b)`` steps exactly as ``b``: its sweep's ``b0.``
    accumulators, the step key passed on unchanged, the spawn path."""
    if name == "cell_clustering":
        beh, init = cc.behavior(), (lambda s: cc.init(s, 200, seed=1))
    elif name == "epidemiology":
        beh, init = ep.behavior(), (lambda s: ep.init(s, 200, 20, seed=1))
    else:
        beh, init = cp.behavior(), (lambda s: cp.init(s, 40, seed=1))
    steps = 14 if name == "cell_proliferation" else 6
    want = _run(beh, init, steps)
    got = _run(compose(beh), init, steps)
    assert_dicts_close(got, want, exact_keys=set(want))
    if name == "cell_proliferation":
        assert int(got["soa.valid"].sum()) > 40


def test_behavior_stack_is_compose():
    mech, sir = cc.behavior(), ep.behavior(radius=1.5)
    st = type(mech).stack(mech, sir)
    assert st.radius == 2.0 and st.children == (mech, sir)
    assert st.schema.names() == ("ctype", "diameter", "state")
    assert st.pair_fn.parts[1][1] == 1.5
    assert set(st.params) == {"b0.repulsion", "b0.adhesion",
                              "b0.same_type_only", "b0.max_step",
                              "b1.beta", "b1.gamma", "b1.sigma"}
    with pytest.raises(ValueError):
        compose()


def test_tumor_diameter_and_sir_ode():
    sim = onc.simulation(device="cpu")
    d0 = onc.tumor_diameter(sim.state)
    assert 0.0 < d0 <= 2 * 1.2
    ode = ep.sir_ode(600, 30, 0.5, 0.25, 1.0, 20)
    assert ode.shape == (21, 3)
    np.testing.assert_allclose(ode.sum(axis=1), 600.0)


# ---------------------------------------------------------------------------
# Epidemiology on a 2x2 mesh against the JAX sharded per-step engine
# ---------------------------------------------------------------------------

MESH_STEPS = 8

ORACLE = """
import sys
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import DeltaConfig, Domain, Engine
from repro.core.domain import spatial_axis_names
from repro.launch.mesh import make_abm_mesh
from repro.sims import epidemiology as ep
from repro.sims.common import uniform_positions
sys.path.insert(0, {tests!r})
from torch_parity import jax_state_arrays

geom = Domain(cell_size=2.0, interior=(5, 5), mesh_shape=(2, 2), cap=24,
              boundary="toroidal")
eng = Engine(geom=geom, behavior=ep.behavior(),
             delta_cfg=DeltaConfig(enabled=False), dt=1.0)
rng = np.random.default_rng(0)
pos = uniform_positions(rng, 600, geom)
st = np.zeros((600,), np.int32)
st[rng.choice(600, 30, replace=False)] = ep.I
s = eng.init_state(pos, {{"state": st}}, seed=0)
out = {{}}
for k, v in jax_state_arrays(s).items():
    out[f"0/{{k}}"] = v
mesh = make_abm_mesh((2, 2))
s = jax.device_put(s, NamedSharding(mesh, P(*spatial_axis_names(2))))
step = eng.make_sharded_step(mesh)
for i in range({steps}):
    s = step(s, full_halo=True)
    for k, v in jax_state_arrays(s).items():
        out[f"{{i + 1}}/{{k}}"] = v
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def mesh_oracle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sims_oracle") / "oracle.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    code = ORACLE.format(tests=os.path.join(ROOT, "tests"), path=path,
                         steps=MESH_STEPS)
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_epidemiology_mesh_matches_jax_sharded(mesh_oracle):
    geom = Domain(cell_size=2.0, interior=(5, 5), mesh_shape=(2, 2), cap=24,
                  boundary="toroidal")
    eng = Engine(geom=geom, behavior=ep.behavior(),
                 delta_cfg=DeltaConfig(enabled=False), dt=1.0, device="cpu")
    rng = np.random.default_rng(0)
    pos = uniform_positions(rng, 600, geom)
    st = np.zeros((600,), np.int32)
    st[rng.choice(600, 30, replace=False)] = ep.I
    state = eng.init_state(pos, {"state": st}, seed=0)
    step = eng.make_local_step()
    for i in range(MESH_STEPS + 1):
        if i:
            state = step(state, full_halo=True)
        pre = f"{i}/"
        want = {k[len(pre):]: v for k, v in mesh_oracle.items()
                if k.startswith(pre)}
        assert_dicts_close(state_to_arrays(state), want)
    assert len({tuple(k) for k in state.key.reshape(4, 2).tolist()}) == 4
    counts = ep.sir_counts(state)
    assert sum(counts) == 600 and counts[2] > 0


def test_epidemiology_mesh_segment_matches_jax_sharded(mesh_oracle):
    """The segment runner derives a whole segment's step keys at once; its
    state after the segment is the per-step reference's."""
    geom = Domain(cell_size=2.0, interior=(5, 5), mesh_shape=(2, 2), cap=24,
                  boundary="toroidal")
    eng = Engine(geom=geom, behavior=ep.behavior(),
                 delta_cfg=DeltaConfig(enabled=False), dt=1.0, device="cpu")
    rng = np.random.default_rng(0)
    pos = uniform_positions(rng, 600, geom)
    st = np.zeros((600,), np.int32)
    st[rng.choice(600, 30, replace=False)] = ep.I
    state = eng.init_state(pos, {"state": st}, seed=0)
    state = eng.make_segment_runner()(state, MESH_STEPS)
    pre = f"{MESH_STEPS}/"
    want = {k[len(pre):]: v for k, v in mesh_oracle.items()
            if k.startswith(pre)}
    assert_dicts_close(state_to_arrays(state), want)


def test_toroidal_seam_keeps_an_agent_the_reference_loses():
    """An agent stepping to within half an ulp of L below 0 wraps (mod L,
    in float32) to exactly L, bins into the halo ring and is destroyed,
    uncounted, by the next aura rebuild in the reference; the port puts
    it at 0 and keeps it (ROADMAP C).  At 16.7M random walkers this costs
    the reference about one agent a step; everything else is unchanged."""
    import jax.numpy as jnp

    from repro.core import AgentSchema as JSchema
    from repro.core import Behavior as JBehavior
    from repro.core import Domain as JDomain
    from repro.core import Engine as JEngine
    from repro_torch.core import AgentSchema, Behavior

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
        update_fn=j_update, radius=1.0), dt=1.0)
    eng_t = Engine(geom=Domain(**kw), behavior=Behavior(
        schema=AgentSchema.create({}), pair_fn=t_pair, pair_attrs=(),
        update_fn=t_update, radius=1.0), dt=1.0, device="cpu")
    pos = np.array([[1e-7, 5.0], [7.0, 7.0]], np.float32)
    st_j = eng_j.init_state(pos, {}, seed=0)
    st_t = eng_t.init_state(pos, {}, seed=0)
    for _ in range(2):
        st_j = eng_j.make_local_step()(st_j)
        st_t = eng_t.make_local_step()(st_t)
    assert int(np.asarray(st_j.soa.valid).sum()) == 1      # the reference
    assert int(np.asarray(st_j.dropped).sum()) == 0        # loses it
    assert int(st_t.soa.valid.sum()) == 2 and int(st_t.dropped.sum()) == 0
    v = st_t.soa.valid
    assert float(st_t.soa.pos[v][:, 0].max()) < 16.0


def test_operations_reducers_match_jax():
    """The reducers the sims schedule (``core.operations``) on the same
    state: counts and sums exactly, the mean to float rounding."""
    from repro.core import operations as j_ops
    from repro_torch.core import operations as t_ops

    sim_j, sim_t = _pair("epidemiology")
    sim_j.run(3)
    sim_t.run(3)
    assert t_ops.agent_count(sim_t) == j_ops.agent_count(sim_j)
    for make in (lambda m: m.attr_counts("state", (0, 1, 2)),
                 lambda m: m.attr_sum("state")):
        assert make(t_ops)(sim_t) == make(j_ops)(sim_j)
    assert t_ops.attr_mean("state")(sim_t) == pytest.approx(
        j_ops.attr_mean("state")(sim_j), rel=1e-12)
    assert t_ops.attr_counts("state", (1,)).__name__ == "counts_state"


@pytest.mark.parametrize("delta", ["off", "int16+mig"])
@pytest.mark.parametrize("mesh", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_toroidal_seam_keeps_agents_on_a_mesh(mesh, delta):
    """The seam repair on a mesh: an agent stepping down across 0 to within
    half an ulp of L is shipped to the last device along that axis, which
    owns [L - L/M, L); put at 0 it would sit in that device's halo ring and
    be destroyed uncounted by the next aura rebuild.  Across x, across y
    and across the corner, with and without the position codec, every
    agent is kept inside the domain."""
    from repro_torch.core import AgentSchema, Behavior
    from repro_torch.sims.common import resolve_delta

    shift = torch.tensor(np.float32(3e-7))    # 1e-7 - 3e-7 mod 16 -> 16

    def update(attrs, valid, acc, key, params, dt):
        return ({**attrs, "pos": attrs["pos"] - shift}, valid,
                torch.zeros_like(valid), None)

    def pair(ai, aj, disp, dist2, params):
        return {"n": torch.ones_like(dist2)}

    interior = tuple(8 // m for m in mesh)
    eng = Engine(geom=Domain(cell_size=2.0, interior=interior,
                             mesh_shape=mesh, cap=8, boundary="toroidal"),
                 behavior=Behavior(schema=AgentSchema.create({}),
                                   pair_fn=pair, pair_attrs=(),
                                   update_fn=update, radius=1.0),
                 delta_cfg=resolve_delta(delta, 4) or DeltaConfig(
                     enabled=False), dt=1.0, device="cpu")
    pos = np.array([[1e-7, 5.0], [5.0, 1e-7], [1e-7, 1e-7], [7.0, 7.0]],
                   np.float32)
    st = eng.init_state(pos, {}, seed=0)
    step = eng.make_local_step()
    for _ in range(3):
        st = step(st)
        assert int(st.soa.valid.sum()) == 4 and int(st.dropped.sum()) == 0
    p = st.soa.pos[st.soa.valid]
    assert bool(((p >= 0) & (p < 16.0)).all())
