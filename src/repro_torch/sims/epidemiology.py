"""Epidemiology use case (paper section 3.1, Figure 5): a spatial SIR
model (port of ``repro/sims/epidemiology.py``).

Agents random-walk and infect susceptible neighbours within the
interaction radius; infected agents recover at rate gamma.  With high
mobility the spatial model converges to the classic Kermack-McKendrick
ODE (:func:`sir_ode`).  The draws are the reference's, bit for bit
(:mod:`repro_torch.core.prng`), so infections and recoveries match it
exactly.  The pair law ``_pair`` runs on the ``pair_sweep`` CUDA kernel on
the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.agent_soa import AgentSchema, POS
from repro_torch.core.behaviors import Behavior, _f32
from repro_torch.core import operations
from repro_torch.core.simulation import Simulation
from repro_torch.sims.common import init_agents, make_sim, uniform_positions

S, I, R = 0, 1, 2

SCHEMA = AgentSchema.create({
    "state": ((), torch.int32),
})


def _pair(ai, aj, disp, dist2, params):
    # count infected neighbours
    return {"n_inf": (aj["state"] == I).to(torch.float32)}


def _update(attrs, valid, acc, key, params, dt):
    k1, k2, k3 = prng.split(key, 3)
    # Brownian walk (high mobility -> well-mixed limit)
    step = _f32(params["sigma"], valid) * prng.normal(k1, attrs[POS].shape)
    new = dict(attrs)
    new[POS] = attrs[POS] + torch.where(valid[..., None], step,
                                        _f32(0.0, step))
    st = attrs["state"]
    # infection: P = 1 - (1-beta)^n_infected_neighbours; the constants are
    # taken in double, then float32, as JAX's weakly typed Python floats
    p_inf = _f32(1.0, step) - torch.pow(_f32(1.0 - params["beta"], step),
                                        acc["n_inf"])
    u1 = prng.uniform(k2, st.shape)
    becomes_i = (st == S) & (u1 < p_inf)
    u2 = prng.uniform(k3, st.shape)
    recovers = (st == I) & (u2 < _f32(params["gamma"] * dt, step))
    st = torch.where(becomes_i, I, st)
    st = torch.where(recovers, R, st)
    new["state"] = st.to(torch.int32)
    spawn = torch.zeros_like(valid)
    return new, valid, spawn, None


# Cached on the parameter tuple: repeated builds return the same Behavior.
@functools.lru_cache(maxsize=32)
def behavior(beta=0.03, gamma=0.25, sigma=1.2, radius=2.0) -> Behavior:
    return Behavior(
        schema=SCHEMA,
        pair_fn=_pair,
        pair_attrs=("state",),
        update_fn=_update,
        radius=radius,
        params={"beta": beta, "gamma": gamma, "sigma": sigma},
    )


def init(sim: Simulation, n_agents: int, initial_infected: int,
         seed: int = 0) -> Simulation:
    """Uniform positions and ``initial_infected`` infected agents from a
    numpy generator seeded with ``seed`` (the reference's draws)."""
    rng = np.random.default_rng(seed)
    pos = uniform_positions(rng, n_agents, sim.geom)
    st = np.zeros((n_agents,), np.int32)
    st[rng.choice(n_agents, initial_infected, replace=False)] = I
    return init_agents(sim, pos, {"state": st}, seed=seed)


def sir_counts(state) -> tuple:
    """(S, I, R) over every live agent."""
    st = state.soa.attrs["state"]
    v = state.soa.valid
    return tuple(int(((st == c) & v).sum()) for c in (S, I, R))


def sir_ode(n, i0, beta_eff, gamma, dt, steps):
    """RK4 Kermack-McKendrick reference."""
    s, i, r = float(n - i0), float(i0), 0.0
    out = [(s, i, r)]

    def f(y):
        s, i, r = y
        return np.array([-beta_eff * s * i / n,
                         beta_eff * s * i / n - gamma * i,
                         gamma * i])

    y = np.array([s, i, r])
    for _ in range(steps):
        k1 = f(y)
        k2 = f(y + 0.5 * dt * k1)
        k3 = f(y + 0.5 * dt * k2)
        k4 = f(y + dt * k3)
        y = y + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(tuple(y))
    return np.array(out)


def simulation(n_agents=600, initial_infected=30, seed=0, mesh=None,
               mesh_shape=(1, 1), interior=(10, 10), delta=None,
               rebalance=None, sweep_backend="auto", device="cuda",
               **bparams) -> Simulation:
    """The SIR sim on the facade, with the S/I/R compartment reducer
    scheduled every step."""
    sim = make_sim(behavior(**bparams), interior=interior,
                   mesh_shape=mesh_shape, boundary="toroidal", dt=1.0,
                   delta=delta, mesh=mesh, rebalance=rebalance,
                   sweep_backend=sweep_backend, device=device)
    init(sim, n_agents, initial_infected, seed)
    sim.every(1, operations.attr_counts("state", (S, I, R)), name="sir")
    return sim


def run(n_agents=600, steps=60, initial_infected=30, seed=0, mesh=None,
        mesh_shape=(1, 1), interior=(10, 10), delta=None, rebalance=None,
        sweep_backend="auto", device="cuda", **bparams):
    sim = simulation(n_agents=n_agents, initial_infected=initial_infected,
                     seed=seed, mesh=mesh, mesh_shape=mesh_shape,
                     interior=interior, delta=delta, rebalance=rebalance,
                     sweep_backend=sweep_backend, device=device, **bparams)
    sim.run(steps)
    return sim.state, {"series": np.array(sim.series["sir"])}
