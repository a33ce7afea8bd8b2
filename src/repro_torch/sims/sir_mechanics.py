"""SIR-with-mechanics: a composed-behaviour sim (port of
``repro/sims/sir_mechanics.py``).

The epidemic behaviour of :mod:`repro_torch.sims.epidemiology` is stacked
on the soft-sphere mechanics of :mod:`repro_torch.sims.cell_clustering`
with :func:`~repro_torch.core.behaviors.compose`: the two pair kernels run
over one neighbourhood (the infection kernel gated to its own smaller
radius), and the two updates chain (displacement first, then the random
walk and the compartment transitions).  On the card the stack runs as one
``pair_sweep`` launch a step.

The ensemble family (:func:`ensemble_family`) is the same model with its
numeric knobs per lane of a :class:`~repro_torch.core.ensemble.Ensemble`:
R parameter points step together, their sweep one lane launch of the
kernel's stack 18 (the force, and the infected count behind each lane's
own ``sir_radius`` gate) a step.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import operations
from repro_torch.core.behaviors import _f32, compose
from repro_torch.core.domain import Domain
from repro_torch.core.ensemble import Ensemble
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


# ---------------------------------------------------------------------------
# Ensemble family (core.ensemble): the same composed model with its numeric
# knobs per lane, so R parameter points step together, their sweep one lane
# launch a step (the serving layer's sir_mechanics family).
# ---------------------------------------------------------------------------

# Structural interaction radii of the family.  Radii shape the neighbour
# sweep and compose()'s static gating, so they are shared by every lane;
# the *effective* infection radius still varies per lane through the
# `sir_radius` gate below (always within this structural bound).
MECH_RADIUS = 2.0
SIR_RADIUS_MAX = 1.5

ENSEMBLE_PARAMS = ("adhesion", "beta", "gamma", "max_step", "repulsion",
                   "sigma", "sir_radius")


def ensemble_defaults() -> dict:
    """Solo-model parameter point (matches ``behavior()``'s defaults)."""
    return {"repulsion": 2.0, "adhesion": 0.5, "max_step": 0.3,
            "beta": 0.05, "gamma": 0.1, "sigma": 0.3,
            "sir_radius": SIR_RADIUS_MAX}


def _gated_sir_pair(ai, aj, disp, dist2, params):
    """Epidemiology pair kernel behind a per-lane radius gate:
    contributions beyond ``sir_radius`` vanish, the square taken in
    float32, so the infection radius varies per lane under the static
    structural radius.  The ``pair_sweep`` kernel's law 5."""
    out = epidemiology._pair(ai, aj, disp, dist2, params)
    r = _f32(params["sir_radius"], dist2)
    gate = dist2 <= r * r
    return {k: torch.where(gate, v, torch.zeros_like(v))
            for k, v in out.items()}


def ensemble_behavior(params):
    """Family behaviour factory.  Structure is fixed - schemas, radii,
    kernels - only the numbers in ``params`` vary; it neither branches on
    them nor converts them (``check_ensemble`` probes it with two-lane
    tensors)."""
    mech = dataclasses.replace(
        cell_clustering.behavior(radius=MECH_RADIUS),
        params={"repulsion": params["repulsion"],
                "adhesion": params["adhesion"],
                "same_type_only": 1.0,
                "max_step": params["max_step"]})
    sir = dataclasses.replace(
        epidemiology.behavior(radius=SIR_RADIUS_MAX),
        pair_fn=_gated_sir_pair,
        params={"beta": params["beta"], "gamma": params["gamma"],
                "sigma": params["sigma"],
                "sir_radius": params["sir_radius"]})
    return compose(mech, sir)


def ensemble_family(interior=(8, 8), mesh_shape=(1, 1), cap=32,
                    partition=None, delta=None, sweep_backend="auto",
                    guards=None, device="cuda") -> Ensemble:
    """The sir_mechanics compatibility family on a given geometry (the
    codec off unless ``delta`` is given): ``interior`` x ``mesh_shape``,
    or an uneven :class:`~repro_torch.core.domain.Partition` (which then
    sets both); ``guards`` runs every lane's guarded step
    (``core.guards``)."""
    from repro_torch.core.delta import DeltaConfig
    if partition is not None:
        geom = Domain(cell_size=2.0, interior=partition.max_widths,
                      mesh_shape=partition.mesh_shape, cap=cap,
                      boundary="toroidal", partition=partition)
    else:
        geom = Domain(cell_size=2.0, interior=tuple(interior),
                      mesh_shape=tuple(mesh_shape), cap=cap,
                      boundary="toroidal")
    return Ensemble(
        geom=geom, behavior_fn=ensemble_behavior,
        param_names=ENSEMBLE_PARAMS, dt=1.0,
        delta_cfg=delta if delta is not None else DeltaConfig(enabled=False),
        sweep_backend=sweep_backend, guards=guards, family="sir_mechanics",
        device=device)


def ensemble_point_state(ens: Ensemble, seed: int = 0, n_agents=400,
                         initial_infected=20, mesh=None):
    """Solo :class:`SimState` for one lane of the family (placement and
    RNG stream keyed by ``seed``) - the unit the scenario server stacks;
    with a process ``mesh``, this rank's block of it."""
    eng = ens.proto_engine()
    rng = np.random.default_rng(seed)
    pos = uniform_positions(rng, n_agents, ens.geom)
    st = np.zeros((n_agents,), np.int32)
    st[rng.choice(n_agents, initial_infected, replace=False)] = I
    attrs = {
        "diameter": np.full((n_agents,), 1.0, np.float32),
        "ctype": rng.integers(0, 2, n_agents).astype(np.int32),
        "state": st,
    }
    return eng.init_state(pos, attrs, seed=seed, mesh=mesh)


def ensemble_init(ens: Ensemble, points, n_agents=400,
                  initial_infected=20, mesh=None):
    """Stacked :class:`EnsembleState` for R parameter points.  Each point
    dict holds the family's knobs plus an optional host-side ``seed``
    (default: the lane index) controlling initial placement and the
    lane's RNG stream.  With a process ``mesh``, this rank's blocks
    (``Ensemble.run(..., mesh=mesh)`` steps them)."""
    states, pts = [], []
    for r, p in enumerate(points):
        p = dict(p)
        seed = int(p.pop("seed", r))
        states.append(ensemble_point_state(
            ens, seed=seed, n_agents=n_agents,
            initial_infected=initial_infected, mesh=mesh))
        pts.append({**ensemble_defaults(), **p})
    return ens.init(states, pts)
