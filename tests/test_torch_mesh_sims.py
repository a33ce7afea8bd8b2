"""The 2-D mesh paths of the spawn sims and of the mechanics + SIR stack
against the JAX package: ``cell_proliferation`` (4x4 cells a device, 50
agents, its first divisions at step 10), ``oncology`` (5x5, 30 agents)
and ``sir_mechanics`` (toroidal, 4x4, 400 agents) on a 2x2 mesh at cap
32, each with the codec off, ``int16+mig`` and ``int8``.

The init state against JAX's, then each step from JAX's state before it
against JAX's sharded per-step engine after it (one subprocess with four
XLA host devices for the file): integers exactly - the slot layout,
``valid``, the gids of children spawned on every device, ``state``,
``gid_counter``, ``dropped`` - and floats to 1e-5.  Stepping from JAX's
state keeps the check per step: free runs drift as the one-device
``sir_mechanics`` run does (float sums in another order, amplified by its
dt of 1.0, and a codec quantum that flips).
"""

import os

import pytest
import torch

from torch_parity import (
    check_steps_like_oracle, run_mesh_oracle, torch_threads,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODECS = ("off", "int16+mig", "int8")

# sim -> (make_sim keywords, init arguments, steps)
SIMS = {
    "cell_proliferation": (dict(interior=(4, 4), cap=32), (50, 0), 14),
    "oncology": (dict(interior=(5, 5), cap=32), (30, 0), 8),
    "sir_mechanics": (dict(interior=(4, 4), cap=32, boundary="toroidal",
                           dt=1.0), (400, 20, 0), 6),
}
CASES = {f"{sim}-{codec}": dict(sim=sim, codec=codec, init=init,
                                steps=steps,
                                make=dict(make, mesh_shape=(2, 2)))
         for sim, (make, init, steps) in SIMS.items() for codec in CODECS}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_sims_oracle") / "oracle.npz")
    return run_mesh_oracle(CASES, path, ROOT)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_steps_match_jax_sharded(oracle, name):
    case = CASES[name]
    with torch.inference_mode():
        counts = check_steps_like_oracle(oracle, name, case)
    n0 = case["init"][0]
    if case["sim"] == "sir_mechanics":
        assert counts == [n0] * case["steps"]
    else:                                   # the spawn path ran
        assert counts[-1] > n0
