"""Parity of the port's 3-D path - ``tumor_spheroid``, the D = 3 pair
sweep with the crowd law and its stack, and the 2x2x2 virtual mesh - with
the JAX package on the same numpy inputs.

* ``tumor_spheroid`` on one device at its defaults (interior (6, 6, 6),
  40 agents, cap 32), 15 steps: each step from the reference's state
  (bridged into the port) holds every field - ``valid``, the slot layout,
  gids, the spawn count (``gid_counter``) and ``dropped`` exactly;
  positions, diameters and nutrient to 1e-5 - and the spheroid diameter
  to 1e-5.  The free run is held exactly on everything but positions:
  forces summed in PyTorch's order drift from XLA's by float rounding
  (4.8e-7 after one step, ~4e-4 after 15), as ``sir_mechanics`` does
  (tests/test_torch_sims.py).
* The D = 3 sweep (27 offsets) of law 0, law 1, the spheroid's stack
  (force + crowd) and ``sir_mechanics``' stack (force + SIR gated to 1.5),
  closed and toroidal: the port's plain ``pair_sweep`` (the ``kernel``
  backend on a CPU tensor) against JAX's ``pallas`` backend, the Pallas
  kernel in interpret mode, on the same state; forces to 1e-5, counts
  exactly.
* ``tumor_spheroid`` on a 2x2x2 mesh (4^3 cells a device; the seed ball
  sits on the corner all eight devices share) against the JAX sharded
  per-step engine, run once for the file in a subprocess with eight XLA
  host devices: ``delta="off"`` and ``int16+mig`` (refresh interval 4),
  each step from the reference's state: every field, the quantized
  references included, ints exactly and floats to 1e-5.  Both free runs:
  the wire, codec, drop, spawn and agent counters of every step exactly,
  and every field but positions and references at the end.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.core import Domain as JDomain
from repro.core import Engine as JEngine
from repro.core.grid import clear_ring
from repro.core.halo import LocalComm, halo_exchange
from repro.core.neighbors import sweep_accumulate as j_sweep
from repro.sims import cell_clustering as j_cc
from repro.sims import sir_mechanics as j_sm
from repro.sims import tumor_spheroid as j_ts
from repro_torch.bridge import state_from_arrays, state_to_arrays
from repro_torch.core import Domain
from repro_torch.core.engine import device_block, total_agents
from repro_torch.core.neighbors import pair_accumulate_kernel
from repro_torch.kernels import neighbor_interaction as ni
from repro_torch.sims import cell_clustering as cc
from repro_torch.sims import sir_mechanics as sm
from repro_torch.sims import tumor_spheroid as ts
from repro_torch.sims.common import resolve_delta
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
STEPS = 15


def _skip_floats(arrays, also=()):
    return [k for k in arrays
            if k.endswith(".pos") or k.startswith("refs.") or k in also]


# ---------------------------------------------------------------------------
# tumor_spheroid on one device
# ---------------------------------------------------------------------------

def _pair():
    # JAX's reference sweep: its parity oracle, and the cheapest of its
    # 3-D sweeps to compile (a gather, where tiled unrolls 27 offsets)
    return (j_ts.simulation(sweep_backend="reference"),
            ts.simulation(sweep_backend="kernel", device="cpu"))


def test_spheroid_init_matches_jax():
    sim_j, sim_t = _pair()
    assert_dicts_close(state_to_arrays(sim_t.state),
                       jax_state_arrays(sim_j.state),
                       exact_keys=set(jax_state_arrays(sim_j.state)))
    assert ts.NDIM == 3 and sim_t.geom.ndim == 3
    assert ts.spheroid_diameter(sim_t.state) == pytest.approx(
        j_ts.spheroid_diameter(sim_j.state), abs=0.0)


def test_spheroid_steps_like_jax():
    """Each of 15 steps from the reference's state: every field (ints
    exactly, floats to 1e-5) and the spheroid diameter to 1e-5; the sim
    spawns on the way."""
    sim_j, sim_t = _pair()
    step_t = sim_t.engine.make_local_step()
    n0 = int(np.asarray(sim_j.state.soa.valid).sum())
    for _ in range(STEPS):
        got = step_t(state_from_arrays(jax_state_arrays(sim_j.state),
                                       device="cpu"))
        sim_j.run(1)
        assert_dicts_close(state_to_arrays(got),
                           jax_state_arrays(sim_j.state))
        assert ts.spheroid_diameter(got) == pytest.approx(
            j_ts.spheroid_diameter(sim_j.state), abs=1e-5)
    assert total_agents(got) > n0
    assert int(got.gid_counter.sum()) == total_agents(got)


def test_spheroid_free_run_like_jax():
    """15 free steps: every field but positions exactly (valid, slots,
    gids, diameters, nutrient, spawn counts, drops), and the run's
    agent-count series."""
    sim_j, sim_t = _pair()
    for _ in range(STEPS):
        sim_j.run(1)
        sim_t.run(1)
        want = jax_state_arrays(sim_j.state)
        assert_dicts_close(state_to_arrays(sim_t.state), want,
                           exact_keys=set(want), skip=_skip_floats(want))
    assert sim_t.n_agents() > 40 and int(sim_t.state.dropped.sum()) == 0


def test_spheroid_run_entry_point_on_cpu():
    state, metrics = ts.run(steps=8, device="cpu")
    series = metrics["series"]
    assert len(series) == 8 and series[-1][0] == total_agents(state)
    assert 0.0 < metrics["diam_initial"] <= 2 * 1.5
    assert all(np.isfinite(d) for _, d in series)


# ---------------------------------------------------------------------------
# The D = 3 sweep: the plain pair_sweep against JAX's Pallas kernel
# ---------------------------------------------------------------------------

# law -> (JAX pair_fn, port pair_fn, pair_attrs, params, count outputs)
LAWS = {
    "soft_repulsion_adhesion": (
        j_cc.behavior().pair_fn, cc.behavior().pair_fn,
        ("diameter", "ctype"), dict(cc.behavior().params), ()),
    "same_type": (j_cc._same_type_pair, cc._same_type_pair, ("ctype",), {},
                  ("same", "cnt")),
    "spheroid_stack": (j_ts.behavior().pair_fn, ts.behavior().pair_fn,
                       ts.behavior().pair_attrs, ts.behavior().params,
                       ("b1.crowd",)),
    "sir_stack": (j_sm.behavior().pair_fn, sm.behavior().pair_fn,
                  sm.behavior().pair_attrs, sm.behavior().params,
                  ("b1.n_inf",)),
}


@functools.lru_cache(maxsize=None)
def _case3(boundary, interior=(4, 4, 3), n=380, seed=0):
    """A 3-D state carrying diameter, ctype and SIR state, its ring
    filled, in JAX and as the port's twin."""
    kw = dict(cell_size=2.0, interior=interior, cap=24, boundary=boundary)
    geom_j = JDomain(**kw)
    rng = np.random.default_rng(seed)
    size = np.asarray(geom_j.domain_size)
    pos = rng.uniform(0.5, size - 0.5, (n, 3)).astype(np.float32)
    attrs = {"diameter": rng.uniform(0.6, 1.4, n).astype(np.float32),
             "ctype": rng.integers(0, 2, n).astype(np.int32),
             "state": rng.integers(0, 3, n).astype(np.int32)}
    eng = JEngine(geom=geom_j, behavior=j_sm.behavior(), dt=1.0)
    st = eng.init_state(pos, attrs, seed=seed)
    refs = {d: {f: v[0, 0, 0] for f, v in s.items()}
            for d, s in st.refs.items()}
    soa_j, _, _, _ = halo_exchange(
        geom_j, clear_ring(st.soa), LocalComm(toroidal=geom_j.toroidal),
        refs, eng.delta_cfg, True)
    st_t = state_from_arrays(
        jax_state_arrays(dataclasses.replace(st, soa=soa_j)), device="cpu")
    return geom_j, Domain(**kw), soa_j, device_block(st_t.soa, (0, 0, 0))


@pytest.mark.parametrize("boundary", ["closed", "toroidal"])
@pytest.mark.parametrize("law", sorted(LAWS))
def test_port_3d_sweep_matches_jax_pallas(law, boundary):
    geom_j, geom_t, soa_j, soa_t = _case3(boundary)
    pair_j, pair_t, pattrs, params, counts = LAWS[law]
    fn = jax.jit(lambda soa: j_sweep(geom_j, soa, pair_j, pattrs, 2.0,
                                     params, backend="pallas"))
    want = {k: np.asarray(v) for k, v in fn(soa_j).items()}
    before = dict(ni.LAUNCHES)
    got = pair_accumulate_kernel(geom_t, soa_t, pair_t, pattrs, 2.0, params)
    assert ni.LAUNCHES == before          # a CPU tensor never counts
    assert_dicts_close(got, want, exact_keys=counts)
    for c in counts:
        assert float(got[c].sum()) > 0


def test_crowd_law_and_stack_are_registered():
    """The crowd law reads no column; the spheroid's stack is law 0 and
    the crowd count, outputs ``b0.force`` (D) and ``b1.crowd`` (1);
    ``compose(growth)`` alone runs the crowd law."""
    law = ni.law_for(ts._crowd_pair)
    assert (law.law_id, law.float_cols, law.int_cols) == (4, (), ())
    stack = ni.law_for(ts.behavior().pair_fn)
    assert stack.parts == ("soft_repulsion_adhesion", "crowd")
    assert stack.outputs == (("b0.force", True), ("b1.crowd", False))
    assert stack.name in ni.LAUNCHES
    vals, gates = ni._law_args(stack, ts.behavior().pair_fn,
                               ts.behavior().params)
    assert vals == [4.0, 0.4, 0.0] and gates == [float("inf")] * 2
    growth = ts.behavior().children[1]
    one = ni.law_for(type(growth).stack(growth).pair_fn)
    assert one.law_id == 4 and one.outputs == (("b0.crowd", False),)


# ---------------------------------------------------------------------------
# tumor_spheroid on a 2x2x2 mesh against the JAX sharded per-step engine
# ---------------------------------------------------------------------------

MESH = (2, 2, 2)
MESH_INTERIOR = (4, 4, 4)
# name -> (codec, refresh interval, steps)
MESH_CASES = {"off": ("off", 16, 8), "int16+mig": ("int16+mig", 4, 8)}

ORACLE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import DeltaConfig
from repro.core.domain import spatial_axis_names
from repro.launch.mesh import make_abm_mesh
from repro.sims import tumor_spheroid as ts
sys.path.insert(0, {tests!r})
from torch_parity import jax_state_arrays

mesh = make_abm_mesh({mesh!r})
out = {{}}
for name, (codec, refresh, steps) in {cases!r}.items():
    cfg = DeltaConfig(enabled=codec != "off", qdtype=jnp.int16,
                      refresh_interval=refresh,
                      migration=jnp.int16 if codec != "off" else None)
    sim = ts.simulation(mesh_shape={mesh!r}, interior={interior!r},
                        delta=cfg, sweep_backend="reference")
    eng, s = sim.engine, sim.state
    for k, v in jax_state_arrays(s).items():
        out[f"{{name}}/0/{{k}}"] = v
    s = jax.device_put(s, NamedSharding(mesh, P(*spatial_axis_names(3))))
    step = eng.make_sharded_step(mesh)
    for i in range(steps):
        s = step(s, full_halo=(codec == "off") or i % refresh == 0)
        for k, v in jax_state_arrays(s).items():
            out[f"{{name}}/{{i + 1}}/{{k}}"] = v
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def mesh_oracle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spheroid_oracle") / "oracle.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    code = ORACLE.format(tests=os.path.join(ROOT, "tests"), mesh=MESH,
                         interior=MESH_INTERIOR, cases=MESH_CASES, path=path)
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _want(oracle, name, step):
    pre = f"{name}/{step}/"
    return {k[len(pre):]: v for k, v in oracle.items() if k.startswith(pre)}


def _mesh_sim(name):
    codec, refresh, _ = MESH_CASES[name]
    cfg = resolve_delta(codec, 8)
    cfg = dataclasses.replace(cfg, refresh_interval=refresh)
    return ts.simulation(mesh_shape=MESH, interior=MESH_INTERIOR, delta=cfg,
                         sweep_backend="kernel", device="cpu")


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_spheroid_mesh_steps_match_jax_sharded(mesh_oracle, name):
    """Each step from the reference's state (bridged into the port's mesh
    layout): the aura exchange over the 6 directed edges (12 delta
    references), the per-device sweeps and spawns with each device's step
    key, corner migrants forwarded across all three axes in one pass, and
    the block assembly."""
    sim = _mesh_sim(name)
    codec, refresh, steps = MESH_CASES[name]
    assert_dicts_close(state_to_arrays(sim.state), _want(mesh_oracle, name,
                                                         0))
    step = sim.engine.make_local_step()
    for i in range(steps):
        state = state_from_arrays(_want(mesh_oracle, name, i), device="cpu")
        got = step(state, full_halo=(codec == "off") or i % refresh == 0)
        assert_dicts_close(state_to_arrays(got),
                           _want(mesh_oracle, name, i + 1))
    n0 = int(_want(mesh_oracle, name, 0)["soa.valid"].sum())
    assert total_agents(got) > n0                 # the mesh spawned
    assert len(np.unique(got.gid_counter.numpy())) > 1   # on many devices


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_spheroid_mesh_free_run_matches_jax_sharded(mesh_oracle, name):
    """The free run: halo bytes, codec overflow, drops and live agents of
    every step exactly, and every field but positions and references
    exactly at the end."""
    sim = _mesh_sim(name)
    codec, refresh, steps = MESH_CASES[name]
    step = sim.engine.make_local_step()
    state = sim.state
    for i in range(steps):
        state = step(state, full_halo=(codec == "off") or i % refresh == 0)
        want = _want(mesh_oracle, name, i + 1)
        for k in ("halo_bytes", "codec_overflow", "dropped", "gid_counter"):
            np.testing.assert_array_equal(
                state_to_arrays(state)[k], want[k], err_msg=f"{k} step {i}")
        assert total_agents(state) == int(want["soa.valid"].sum())
    got = state_to_arrays(state)
    assert_dicts_close(got, want, exact_keys=set(want),
                       skip=_skip_floats(want))
    assert int(state.codec_overflow.max()) == 0
