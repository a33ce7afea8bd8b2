"""The eight ABM examples of the port (``examples_torch/``) and
``serve_lm`` (minicpm3-4b's smoke size, MLA) on the CPU at small sizes,
each through its ``main(...)``.

``quickstart``, ``sir_mechanics_demo`` and ``epidemic_distributed`` are
held against the JAX package's facade run at the same size and seed:
agent counts and S/I/R counts exactly, the same-type fractions to 1e-5
(the 2x2 epidemic in one subprocess with four XLA host devices, as the
reference's example forces them).  ``supervised_run --device-loss`` must
log the virtual mesh's degrade onto two devices; the others run their
own assertions (a re-shard applied, no agent dropped, growth).
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from torch_parity import torch_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (agents, infected, steps) of the two SIR examples
EPIDEMIC = dict(n_agents=200, initial_infected=10, steps=8)
SIR_MECH = dict(n_agents=120, initial_infected=10, steps=8, interior=(4, 4))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(ROOT, "examples_torch",
                                               f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_jax():
    import jax.numpy as jnp

    from repro.core import AgentSchema, Behavior, Simulation, operations
    from repro.core.behaviors import (
        displacement_update, soft_repulsion_adhesion,
    )
    from repro.sims.cell_clustering import same_type_fraction

    got = example("quickstart").main(device="cpu", n_agents=120, steps=12,
                                     interior=(4, 4), seed=1)
    beh = Behavior(
        schema=AgentSchema.create({"diameter": ((), jnp.float32),
                                   "ctype": ((), jnp.int32)}),
        pair_fn=soft_repulsion_adhesion, pair_attrs=("diameter", "ctype"),
        update_fn=displacement_update, radius=2.0,
        params={"repulsion": 2.0, "adhesion": 0.6, "same_type_only": 1.0,
                "max_step": 0.5})
    sim = Simulation(dict(cell_size=2.0, interior=(4, 4), cap=64), beh,
                     dt=0.1)
    rng = np.random.default_rng(1)
    pos = rng.uniform(0.5, 7.5, size=(120, 2)).astype(np.float32)
    sim.init(pos, {"diameter": np.full((120,), 1.0, np.float32),
                   "ctype": rng.integers(0, 2, 120).astype(np.int32)},
             seed=1)
    sim.every(10, operations.agent_count)
    sim.run(12)
    assert got["n_agents"] == sim.n_agents() == 120
    assert got["iteration"] == sim.iteration == 12
    assert got["dropped"] == int(sim.state.dropped.sum()) == 0
    assert got["counts"] == [int(c) for c in sim.series["agent_count"]]
    # what the dynamics move: the neighbour pairs of equal type at the end
    want = same_type_fraction(sim.state, sim.engine)
    np.testing.assert_allclose(got["same_type"], want, rtol=1e-5, atol=1e-5)


def test_sir_mechanics_demo_matches_jax():
    from repro.sims import sir_mechanics
    from repro.sims.cell_clustering import same_type_fraction

    got = example("sir_mechanics_demo").main(device="cpu", **SIR_MECH)
    sim = sir_mechanics.simulation(
        n_agents=SIR_MECH["n_agents"],
        initial_infected=SIR_MECH["initial_infected"], seed=0,
        interior=SIR_MECH["interior"])
    f0 = same_type_fraction(sim.state, sim.engine)
    sim.run(SIR_MECH["steps"])
    f1 = same_type_fraction(sim.state, sim.engine)
    want = np.asarray(sim.series["sir"]).tolist()
    assert got["sir"] == want
    assert got["n_agents"] == sim.n_agents()
    np.testing.assert_allclose(got["same_type"], (f0, f1), rtol=1e-5,
                               atol=1e-5)
    assert want[-1][2] > 0           # the infection ran its course


JAX_EPIDEMIC = """
import json
import jax.numpy as jnp
import numpy as np
from repro.core import DeltaConfig
from repro.sims import epidemiology
sim = epidemiology.simulation(
    n_agents={n_agents}, initial_infected={initial_infected},
    mesh_shape=(2, 2), interior=(5, 5),
    delta=DeltaConfig(enabled=True, qdtype=jnp.int16, refresh_interval=8))
sim.run({steps})
print(json.dumps(dict(sir=np.asarray(sim.series["sir"]).tolist(),
                      n_agents=sim.n_agents())))
"""


def test_epidemic_distributed_matches_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    p = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_EPIDEMIC.format(
            **EPIDEMIC))], capture_output=True, text=True, timeout=600,
        env=env)
    assert p.returncode == 0, p.stderr
    want = json.loads(p.stdout.strip().splitlines()[-1])
    got = example("epidemic_distributed").main(device="cpu", **EPIDEMIC)
    assert got["sir"] == want["sir"]
    assert got["n_agents"] == want["n_agents"] == EPIDEMIC["n_agents"]
    assert want["sir"][-1][2] > 0


def test_supervised_run_degrades_onto_two_devices():
    got = example("supervised_run").main(device="cpu", device_loss=True,
                                         steps=14, n_agents=100,
                                         interior=(4, 4))
    kinds = [e["kind"] for e in got["log"]]
    recs = [e for e in got["log"] if e["kind"] == "recovered"]
    assert [e["error_type"] for e in recs] == ["HealthError", "DeviceLost"]
    assert [e["devices"] for e in recs] == [4, 2]
    assert got["n_devices"] == 2 and got["n_agents"] == 100
    assert kinds[-1] == "completed"


@pytest.mark.parametrize("name,kwargs", [
    ("spheroid_3d", dict(n_agents=30, steps=10)),
    ("rebalance_demo", dict(n_agents=300, steps=8)),
    ("overlap_demo", dict(n_agents=300, steps=6)),
    ("param_sweep", dict(n_agents=60, steps=6, slot=4, grid_points=4,
                         rounds=1)),
    ("serve_lm", dict(batch=2, prompt_len=8, gen_len=4)),
])
def test_example_runs_on_the_cpu(name, kwargs):
    out = example(name).main(device="cpu", **kwargs)
    if name == "spheroid_3d":
        assert out["n1"] > out["n0"] and out["mesh"] == (1, 1, 2)
    elif name == "rebalance_demo":
        assert out["applied"] >= 1 and out["dropped"] == 0
        assert out["n_agents"] == 300
    elif name == "overlap_demo":
        assert out["applied"] >= 1 and out["n_agents"] == 300
    elif name == "serve_lm":
        # minicpm3-4b smoke: 2 layers, a 16 + 8-dim latent cache a token
        assert out["cache_shape"] == (2, 2, 12, 24)
        assert len(out["tokens"]) == 2 and all(
            len(t) == 4 and all(0 <= v < 256 for v in t)
            for t in out["tokens"])
    else:
        assert len(out["sweep"]) == 4 and out["batches"] >= 2
        assert out["runner_cache"]["hits"] >= 1


def test_examples_refuse_without_a_gpu():
    """No fallback: the default device is the card."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(Exception, match="(?i)cuda|gpu"):
        example("quickstart").main()
