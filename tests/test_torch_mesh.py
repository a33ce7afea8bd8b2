"""Parity of the port's virtual-mesh engine with the JAX package's sharded
engine on the same numpy inputs: 2x2 closed and 2x1 toroidal meshes of
cell clustering, full refresh and the int8 delta codec with and without
the int16 migration codec.

The JAX oracle is the reference's per-step ``make_sharded_step`` (its
segment runner is not bit-exact, ROADMAP section C), run once for the
whole file in a subprocess with four XLA host devices, as
``tests/test_distributed_abm.py`` runs it; it writes an npz that every
test reads.  Tolerances:

* ``delta="off"``: the repository's convention (``torch_parity``): ints,
  bools, gids, the slot layout, ``halo_bytes`` exactly; floats to 1e-5.
* ``int8`` and ``int8+mig``, after the first delta step: the same.
* 12 steps across a refresh at 8: ``halo_bytes``, ``codec_overflow``,
  ``dropped`` and the agent count each step exactly; positions matched
  by gid within 1e-3.  Float noise of one ulp in a delta can move a
  rounding tie by one quantum, and a quantum feeds the next step's forces,
  so positions are no longer held to 1e-5 there.
"""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.bridge import state_from_arrays, state_to_arrays
from repro_torch.core import DeltaConfig, Domain, Engine
from repro_torch.core.engine import total_agents
from repro_torch.core.halo import VirtualMeshComm
from repro_torch.kernels import delta_codec
from repro_torch.sims import cell_clustering as cc
from repro_torch.sims.common import make_sim, resolve_delta
from torch_parity import assert_dicts_close, torch_threads


# Small-tensor loops: one torch thread (beside busy test workers torch's
# thread pool slows them many times over).
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_AGENTS = 300

# name -> (mesh, boundary, codec, refresh interval, steps, recorded steps)
CASES = {
    "off": ((2, 2), "closed", "off", 16, 3, (1, 3)),
    "int8": ((2, 2), "closed", "int8", 16, 2, (2,)),
    "mig": ((2, 2), "closed", "int8+mig", 8, 12, (2, 12)),
    "torus_mig": ((2, 1), "toroidal", "int8+mig", 16, 3, (1, 3)),
}

ORACLE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import DeltaConfig, Domain, Engine
from repro.core.domain import spatial_axis_names
from repro.launch.mesh import make_abm_mesh
from repro.sims import cell_clustering as cc
sys.path.insert(0, {tests!r})
from torch_parity import jax_state_arrays

CASES = {cases!r}
out = {{}}
for name, (mesh_shape, boundary, codec, refresh, steps, rec) in CASES.items():
    geom = Domain(cell_size=2.0, interior=(8, 8), mesh_shape=mesh_shape,
                  cap=16, boundary=boundary)
    base, _, mig = codec.partition("+")
    cfg = DeltaConfig(enabled=codec != "off", qdtype=jnp.int8,
                      refresh_interval=refresh,
                      migration=jnp.int16 if mig else None)
    eng = Engine(geom=geom, behavior=cc.behavior(), delta_cfg=cfg, dt=0.1,
                 sweep_backend="reference")
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.5, np.asarray(geom.domain_size) - 0.5,
                      ({n}, 2)).astype(np.float32)
    attrs = {{"diameter": np.full(({n},), 1.0, np.float32),
              "ctype": rng.integers(0, 2, {n}).astype(np.int32)}}
    s = eng.init_state(pos, attrs, seed=0)
    for k, v in jax_state_arrays(s).items():
        out[f"{{name}}/0/{{k}}"] = v
    mesh = make_abm_mesh(mesh_shape)
    # commit the state to the step's sharding, so each step variant
    # compiles once
    s = jax.device_put(s, NamedSharding(mesh, P(*spatial_axis_names(2))))
    step = eng.make_sharded_step(mesh)
    series = []
    for i in range(steps):
        s = step(s, full_halo=(codec == "off") or i % refresh == 0)
        series.append([int(s.halo_bytes.ravel()[0]),
                       int(np.max(np.asarray(s.codec_overflow))),
                       int(np.sum(np.asarray(s.dropped))),
                       int(np.sum(np.asarray(s.soa.valid)))])
        if i + 1 in rec:
            for k, v in jax_state_arrays(s).items():
                out[f"{{name}}/{{i + 1}}/{{k}}"] = v
    out[f"{{name}}/series"] = np.asarray(series, np.int64)
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_oracle") / "oracle.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    code = ORACLE.format(tests=os.path.join(ROOT, "tests"), cases=CASES,
                         n=N_AGENTS, path=path)
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _want(oracle, name, step):
    pre = f"{name}/{step}/"
    return {k[len(pre):]: v for k, v in oracle.items() if k.startswith(pre)}


def _cfg(codec: str, refresh: int) -> DeltaConfig:
    cfg = resolve_delta(codec, 4)
    return DeltaConfig(enabled=cfg.enabled, qdtype=cfg.qdtype,
                       refresh_interval=refresh, migration=cfg.migration)


def _engine(name):
    mesh, boundary, codec, refresh, _, _ = CASES[name]
    geom = Domain(cell_size=2.0, interior=(8, 8), mesh_shape=mesh, cap=16,
                  boundary=boundary)
    return Engine(geom=geom, behavior=cc.behavior(),
                  delta_cfg=_cfg(codec, refresh), dt=0.1, device="cpu")


def _init(eng):
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.5, np.asarray(eng.geom.domain_size) - 0.5,
                      (N_AGENTS, 2)).astype(np.float32)
    attrs = {"diameter": np.full((N_AGENTS,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, N_AGENTS).astype(np.int32)}
    return eng.init_state(pos, attrs, seed=0)


@functools.lru_cache(maxsize=None)
def _port_run(name):
    """(recorded states as arrays, per-step series) of the port."""
    eng = _engine(name)
    _, _, codec, refresh, steps, rec = CASES[name]
    state = _init(eng)
    got = {0: state_to_arrays(state)}
    step = eng.make_local_step()
    series = []
    for i in range(steps):
        state = step(state, full_halo=(codec == "off") or i % refresh == 0)
        series.append([int(state.halo_bytes.reshape(-1)[0]),
                       int(state.codec_overflow.max()),
                       int(state.dropped.sum()), total_agents(state)])
        if i + 1 in rec:
            got[i + 1] = state_to_arrays(state)
    return got, np.asarray(series, np.int64)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_init_state_matches_jax(oracle, name):
    got, _ = _port_run(name)
    assert_dicts_close(got[0], _want(oracle, name, 0))


@pytest.mark.parametrize("name,step", [("off", 1), ("off", 3),
                                       ("torus_mig", 1)])
def test_mesh_full_refresh_matches_jax(oracle, name, step):
    """Full-refresh steps (on the torus, the first step of the
    ``int8+mig`` run: its aura is full, its migrants cross the seam through
    the position codec)."""
    got, _ = _port_run(name)
    assert_dicts_close(got[step], _want(oracle, name, step))


@pytest.mark.parametrize("name,step", [("int8", 2), ("mig", 2),
                                       ("torus_mig", 3)])
def test_mesh_delta_steps_match_jax(oracle, name, step):
    """After the first delta steps: every field, the quantized references
    included, ints exactly and floats to 1e-5."""
    got, _ = _port_run(name)
    want = _want(oracle, name, step)
    assert_dicts_close(got[step], want)
    assert int(want["halo_bytes"].ravel()[0]) < int(
        _port_run("off")[1][0][0])     # a delta step sends fewer bytes


def _by_gid(arrays):
    v = arrays["soa.valid"].ravel()
    pos = arrays["soa.attrs.pos"].reshape(-1, 2)[v]
    gid = (arrays["soa.attrs.gid_rank"].ravel()[v].astype(np.int64) << 32) \
        + arrays["soa.attrs.gid_count"].ravel()[v]
    order = np.argsort(gid)
    return gid[order], pos[order]


def test_mesh_twelve_steps_across_a_refresh(oracle):
    """int8+mig with refresh_interval 8 over 12 steps: the wire, codec and
    drop counters and the agent count per step exactly, positions by gid
    within 1e-3."""
    got, series = _port_run("mig")
    want_series = oracle["mig/series"]
    np.testing.assert_array_equal(series, want_series)
    assert series[0, 0] > series[1, 0] == series[7, 0] < series[8, 0]
    assert (series[:, 1] == 0).all() and (series[:, 3] == N_AGENTS).all()
    gid_t, pos_t = _by_gid(got[12])
    gid_j, pos_j = _by_gid(_want(oracle, "mig", 12))
    np.testing.assert_array_equal(gid_t, gid_j)
    err = float(np.abs(pos_t - pos_j).max())
    print(f"max |pos_port - pos_jax| after 12 steps: {err:.3g}")
    assert err < 1e-3


def test_closed_loop_references_are_bit_equal():
    """After a delta step, each device's ``xp_out`` equals its +x
    neighbour's ``xm_in`` bit for bit (and ``yp_out``/``ym_in`` along y)."""
    eng = _engine("mig")
    step = eng.make_local_step()
    state = step(_init(eng), full_halo=True)
    state = step(state, full_halo=False)
    for a, c in enumerate("xy"):
        for f, out in state.refs[c + "p_out"].items():
            inn = state.refs[c + "m_in"][f]
            sent = out.narrow(a, 0, 1)
            recv = inn.narrow(a, 1, 1)
            assert sent.numpy().tobytes() == recv.numpy().tobytes(), (c, f)


def test_facade_mesh_run_matches_per_step_engine():
    """``make_sim(mesh_shape=(2, 2), delta="int8+mig")`` through the facade
    (segment runner, refresh schedule) gives the per-step engine's state."""
    sim = make_sim(cc.behavior(), interior=(8, 8), mesh_shape=(2, 2),
                   cap=16, delta=_cfg("int8+mig", 8), dt=0.1, device="cpu")
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.5, np.asarray(sim.geom.domain_size) - 0.5,
                      (N_AGENTS, 2)).astype(np.float32)
    attrs = {"diameter": np.full((N_AGENTS,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, N_AGENTS).astype(np.int32)}
    sim.init(pos, attrs)
    sim.run(12)
    got, _ = _port_run("mig")
    assert_dicts_close(state_to_arrays(sim.state), got[12],
                       exact_keys=set(got[12]))
    frac = cc.same_type_fraction(sim.state, sim.engine)
    assert 0.0 < frac < 1.0


def test_mesh_bridge_round_trip_is_exact(oracle):
    """The JAX package's block-concatenated arrays -> the port's
    ``mesh + local`` layout -> back, exactly; the port steps the bridged
    state as it steps its own."""
    want = _want(oracle, "mig", 2)
    state = state_from_arrays(want, device="cpu")
    assert tuple(state.soa.valid.shape) == (2, 2, 10, 10, 16)
    back = state_to_arrays(state)
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_cpu_mesh_run_counts_no_codec_launch():
    before = dict(delta_codec.LAUNCHES)
    sim = cc.simulation(n_agents=120, interior=(6, 6), mesh_shape=(2, 2),
                        delta="int8+mig", device="cpu")
    sim.run(2)
    assert delta_codec.LAUNCHES == before
    assert sim.n_agents() == 120 and not torch.any(sim.state.dropped)


@pytest.mark.parametrize("toroidal", [(False, False), (True, False)],
                         ids=["closed", "torus_x"])
def test_virtual_mesh_comm_shift_coords_and_sums(toroidal):
    """``shift`` gives device i the payload of device i - direction, and
    zeros - every entry, ``/scale`` included - where there is no source
    (as ``ppermute``); a size-1 axis is the identity when toroidal and
    zeros when closed.  ``coords``/``linear_rank`` are row-major and
    ``sum_over_all_ranks`` reaches every device."""
    comm = VirtualMeshComm(mesh_shape=(2, 1), toroidal=toroidal)
    pay = {"q": torch.tensor([[[1, 2]], [[3, 4]]], dtype=torch.int8),
           "q/scale": torch.tensor([[0.5], [0.25]]),
           "valid": torch.tensor([[True], [False]])}
    up = comm.shift(pay, 0, +1)
    down = comm.shift(pay, 0, -1)
    if toroidal[0]:
        assert up["q"].tolist() == [[[3, 4]], [[1, 2]]]
        assert down["q"].tolist() == [[[3, 4]], [[1, 2]]]
    else:
        assert up["q"].tolist() == [[[0, 0]], [[1, 2]]]
        assert up["q/scale"].tolist() == [[0.0], [0.5]]
        assert up["valid"].tolist() == [[False], [True]]
        assert down["q/scale"].tolist() == [[0.25], [0.0]]
    same = comm.shift(pay, 1, +1)             # the size-1 axis
    for k, v in pay.items():
        want = v if toroidal[1] else torch.zeros_like(v)
        assert torch.equal(same[k], want), k
    mesh = VirtualMeshComm(mesh_shape=(2, 2), toroidal=toroidal)
    cx, cy = mesh.coords()
    assert cx.tolist() == [[0, 0], [1, 1]] and cy.tolist() == [[0, 1],
                                                                [0, 1]]
    assert mesh.linear_rank().tolist() == [[0, 1], [2, 3]]
    total = mesh.sum_over_all_ranks(mesh.linear_rank())
    assert total.tolist() == [[6, 6], [6, 6]]
