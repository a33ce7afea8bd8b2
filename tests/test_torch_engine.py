"""Parity of the port's engine, facade and cell-clustering sim with the JAX
package on the same numpy inputs: ``init_state`` (every field, the RNG
``key`` included), one ``local_step``, 8 steps of ``cell_clustering`` through
``Simulation.run`` (fused and per-step, closed and toroidal), the
clustering metric, and a JAX state bridged into the port and stepped
there.  Positions and float slabs to 1e-5, everything else exactly (see
torch_parity.py)."""

import functools

import numpy as np
import pytest
import torch

from repro.core import Domain as JDomain
from repro.core import Engine as JEngine
from repro.sims import cell_clustering as j_cc
from repro.sims.common import make_sim as j_make_sim
from repro_torch.bridge import state_from_arrays, state_to_arrays
from repro_torch.core import Domain, Engine, Partition
from repro_torch.core.engine import total_agents
from repro_torch.core.simulation import ContractError, Simulation
from repro_torch.sims import cell_clustering as cc
from repro_torch.sims.common import make_sim
from torch_parity import (
    assert_dicts_close, assert_states_match, jax_state_arrays, soa_inputs,
    torch_threads,
)


# Small-tensor loops: one torch thread (beside busy test workers torch's
# thread pool slows them many times over).
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


BOUNDARIES = ["closed", "toroidal"]


def _engines(boundary, interior=(6, 6), cap=16):
    kw = dict(cell_size=2.0, interior=interior, cap=cap, boundary=boundary)
    return (JEngine(geom=JDomain(**kw), behavior=j_cc.behavior(), dt=0.1),
            Engine(geom=Domain(**kw), behavior=cc.behavior(), dt=0.1,
                   device="cpu"))


def _init(boundary, interior=(6, 6), n=260, seed=0):
    eng_j, eng_t = _engines(boundary, interior)
    pos, attrs = soa_inputs(n, len(interior), eng_t.geom.domain_size, seed)
    return (eng_j, eng_t, eng_j.init_state(pos, attrs, seed=seed),
            eng_t.init_state(pos, attrs, seed=seed))


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_init_state_matches_jax(boundary):
    _, _, st_j, st_t = _init(boundary)
    assert_states_match(st_t, st_j)
    assert st_t.key.dtype == torch.uint32 and st_t.key.any()


@pytest.mark.parametrize("interior", [(6, 6), (4, 4, 3)],
                         ids=["2d", "3d"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_local_step_matches_jax(boundary, interior):
    eng_j, eng_t, st_j, st_t = _init(boundary, interior)
    step_j, step_t = eng_j.make_local_step(), eng_t.make_local_step()
    for _ in range(2):
        st_j, st_t = step_j(st_j), step_t(st_t)
    assert_states_match(st_t, st_j)
    assert total_agents(st_t) + int(st_t.dropped.sum()) == 260


@functools.lru_cache(maxsize=None)
def _jax_run(boundary, steps=8, n=300):
    sim = j_make_sim(j_cc.behavior(), interior=(8, 8), boundary=boundary)
    j_cc.init(sim, n, seed=3)
    f0 = j_cc.same_type_fraction(sim.state, sim.engine)
    sim.run(steps)
    f1 = j_cc.same_type_fraction(sim.state, sim.engine)
    return jax_state_arrays(sim.state), (f0, f1)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_step"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_cell_clustering_run_matches_jax(boundary, fused):
    want, (f0_j, f1_j) = _jax_run(boundary)
    sim = make_sim(cc.behavior(), interior=(8, 8), boundary=boundary,
                   device="cpu")
    cc.init(sim, 300, seed=3)
    f0 = cc.same_type_fraction(sim.state, sim.engine)
    sim.run(8, fused=fused)
    f1 = cc.same_type_fraction(sim.state, sim.engine)
    assert sim.iteration == 8 and sim.n_agents() == 300
    assert_dicts_close(state_to_arrays(sim.state), want)
    assert (f0, f1) == (f0_j, f1_j)       # sums of exact counts


def test_run_entry_point_matches_jax():
    state_j, metrics_j = j_cc.run(n_agents=200, steps=3, interior=(6, 6))
    state_t, metrics_t = cc.run(n_agents=200, steps=3, interior=(6, 6),
                                device="cpu")
    assert metrics_t == metrics_j
    assert_states_match(state_t, state_j)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_bridged_jax_state_steps_like_jax(boundary):
    """A JAX state three steps in, carried across and stepped by the port,
    matches JAX's own next step - the RNG key included, since it is
    carried through unchanged."""
    eng_j, eng_t, st_j, _ = _init(boundary, seed=5)
    step_j = eng_j.make_local_step()
    for _ in range(3):
        st_j = step_j(st_j)
    arrays = jax_state_arrays(st_j)
    st_t = state_from_arrays(arrays, device="cpu")
    assert_dicts_close(state_to_arrays(st_t), arrays, exact_keys=set(arrays))
    st_t = eng_t.make_local_step()(st_t)
    assert_states_match(st_t, step_j(st_j), skip=())


def test_facade_scheduled_ops_and_series():
    sim = make_sim(cc.behavior(), interior=(6, 6), device="cpu")
    cc.init(sim, 150, seed=1)
    sim.every(2, lambda s: s.iteration, name="it")
    sim.every(3, lambda s: s.n_agents(), name="pre", pre=True)
    sim.run(6)
    assert sim.series["it"] == [2, 4, 6]
    assert sim.series["pre"] == [150, 150]
    sim.step()
    assert sim.iteration == 7


def test_unported_options_raise():
    beh = cc.behavior()
    # guards= is ported (tests/test_torch_resilience.py): it builds, and
    # supervision of an unguarded run is refused by its contract
    sim = Simulation(dict(interior=(6, 6)), beh, device="cpu",
                     guards="warn")
    assert sim.engine.guards.policy == "warn"
    assert not Simulation(dict(interior=(6, 6)), beh,
                          device="cpu").engine.guards.enabled
    # rebalance= and checkpoint= are ported (tests/test_torch_reshard.py,
    # tests/test_torch_checkpoint.py): they build
    sim = Simulation(dict(interior=(6, 6)), beh, device="cpu", rebalance=5,
                     checkpoint="ckpt")
    assert sim.rebalancer.every == 5
    assert [op.name for op in sim._ops] == ["rebalance", "checkpoint"]
    # an explicit mesh= is ported (one process a device; its runs are in
    # tests/test_torch_process_mesh.py): it must be a DeviceMesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        Simulation(dict(interior=(6, 6)), beh, device="cpu", mesh=object())
    # the overlapped sweep and uneven partitions are ported: these build
    # and step, the overlapped run bit-equal to the monolithic one
    uneven = Domain(cell_size=2.0, interior=(5, 4), mesh_shape=(2, 1),
                    partition=Partition.from_widths([(3, 5), (4,)]))
    runs = []
    for overlap in ("on", "off"):
        sim = make_sim(beh, domain=uneven, overlap=overlap, device="cpu")
        cc.init(sim, 60, seed=2)
        sim.run(3)
        assert sim.n_agents() == 60 and sim.iteration == 3
        runs.append(state_to_arrays(sim.state))
    assert all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])
    on = Simulation(dict(interior=(6, 6)), beh, device="cpu", overlap="on")
    cc.init(on, 50, seed=2)
    on.run(2)
    assert on.n_agents() == 50
    # meshes and the delta codec are ported: these build
    make_sim(beh, interior=(4, 4), mesh_shape=(2, 1), device="cpu")
    make_sim(beh, delta="int8", device="cpu")
    # a list of behaviours composes, as in the reference
    stacked = Simulation(dict(interior=(6, 6)), [beh, beh], device="cpu")
    assert stacked.behavior.children == (beh, beh)
    assert stacked.behavior.pair_fn.parts[1][0] is beh.pair_fn


def test_stencil_soundness_contract():
    wide = cc.behavior(radius=3.0)
    with pytest.raises(ContractError, match="stencil-soundness"):
        Simulation(dict(interior=(6, 6)), wide, device="cpu")
    with pytest.warns(UserWarning, match="stencil-soundness"):
        Simulation(dict(interior=(6, 6)), wide, device="cpu", check="warn")
    Simulation(dict(interior=(6, 6)), wide, device="cpu", check="off")


def test_init_rejects_out_of_domain_and_overflow():
    _, eng_t = _engines("closed", interior=(4, 4), cap=4)
    attrs = {"diameter": np.ones(3, np.float32),
             "ctype": np.zeros(3, np.int32)}
    with pytest.raises(ValueError, match="outside the domain"):
        eng_t.init_state(np.array([[-1.0, 1.0]] * 3, np.float32), attrs)
    crowd = np.full((5, 2), 1.0, np.float32)
    with pytest.raises(ValueError, match="capacity overflow"):
        eng_t.init_state(crowd, {k: np.resize(v, 5)
                                 for k, v in attrs.items()})
