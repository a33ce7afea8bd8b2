"""SIR-with-mechanics: a composed-behaviour sim (port of
``repro/sims/sir_mechanics.py``, without the ensemble family, which waits
for ROADMAP A10).

The epidemic behaviour of :mod:`repro_torch.sims.epidemiology` is stacked
on the soft-sphere mechanics of :mod:`repro_torch.sims.cell_clustering`
with :func:`~repro_torch.core.behaviors.compose`: the two pair kernels run
over one neighbourhood (the infection kernel gated to its own smaller
radius), and the two updates chain (displacement first, then the random
walk and the compartment transitions).  On the card the stack runs as one
``pair_sweep`` launch a step.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.core import operations
from repro_torch.core.behaviors import compose
from repro_torch.core.simulation import Simulation
from repro_torch.sims import cell_clustering, epidemiology
from repro_torch.sims.common import init_agents, make_sim, uniform_positions

S, I, R = epidemiology.S, epidemiology.I, epidemiology.R


@functools.lru_cache(maxsize=32)
def behavior(repulsion=2.0, adhesion=0.5, mech_radius=2.0, max_step=0.3,
             beta=0.05, gamma=0.1, sigma=0.3, sir_radius=1.5):
    """``compose(mechanics, sir)``: union schema {diameter, ctype, state},
    the mechanics' radius, the infection gated to its smaller one."""
    mech = cell_clustering.behavior(
        repulsion=repulsion, adhesion=adhesion, radius=mech_radius,
        max_step=max_step)
    sir = epidemiology.behavior(
        beta=beta, gamma=gamma, sigma=sigma, radius=sir_radius)
    return compose(mech, sir)


def init(sim: Simulation, n_agents: int, initial_infected: int,
         seed: int = 0) -> Simulation:
    rng = np.random.default_rng(seed)
    pos = uniform_positions(rng, n_agents, sim.geom)
    st = np.zeros((n_agents,), np.int32)
    st[rng.choice(n_agents, initial_infected, replace=False)] = I
    attrs = {
        "diameter": np.full((n_agents,), 1.0, np.float32),
        "ctype": rng.integers(0, 2, n_agents).astype(np.int32),
        "state": st,
    }
    return init_agents(sim, pos, attrs, seed=seed)


def simulation(n_agents=400, initial_infected=20, seed=0, mesh=None,
               mesh_shape=(1, 1), interior=(8, 8), delta=None,
               rebalance=None, sweep_backend="auto", device="cuda",
               **bparams) -> Simulation:
    sim = make_sim(behavior(**bparams), interior=interior,
                   mesh_shape=mesh_shape, cap=32, boundary="toroidal",
                   dt=1.0, delta=delta, mesh=mesh, rebalance=rebalance,
                   sweep_backend=sweep_backend, device=device)
    init(sim, n_agents, initial_infected, seed)
    sim.every(1, operations.attr_counts("state", (S, I, R)), name="sir")
    return sim


def run(n_agents=400, steps=40, initial_infected=20, seed=0, mesh=None,
        mesh_shape=(1, 1), interior=(8, 8), delta=None, rebalance=None,
        sweep_backend="auto", device="cuda", **bparams):
    sim = simulation(n_agents=n_agents, initial_infected=initial_infected,
                     seed=seed, mesh=mesh, mesh_shape=mesh_shape,
                     interior=interior, delta=delta, rebalance=rebalance,
                     sweep_backend=sweep_backend, device=device,
                     **bparams)
    f0 = cell_clustering.same_type_fraction(sim.state, sim.engine)
    sim.run(steps)
    f1 = cell_clustering.same_type_fraction(sim.state, sim.engine)
    return sim.state, {"series": np.array(sim.series["sir"]),
                       "same_frac_initial": f0, "same_frac_final": f1}
