"""Composable behavior stacks on the PyTorch port: SIR epidemic on top of
cell mechanics (the port of ``examples/sir_mechanics_demo.py``).  The
clustering mechanics and the SIR dynamics, merged with ``compose()``,
share one neighbourhood sweep: one launch of the ``pair_sweep`` kernel's
stack a step on the card.

    PYTHONPATH=src python examples_torch/sir_mechanics_demo.py \
        [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.sims import sir_mechanics
from repro_torch.sims.cell_clustering import same_type_fraction


def main(device="cuda", n_agents=400, initial_infected=20, steps=40,
         interior=(8, 8), seed=0) -> dict:
    sim = sir_mechanics.simulation(
        n_agents=n_agents, initial_infected=initial_infected, seed=seed,
        interior=tuple(interior), device=device)
    f0 = same_type_fraction(sim.state, sim.engine)
    sim.run(steps)
    f1 = same_type_fraction(sim.state, sim.engine)

    ser = np.array(sim.series["sir"])
    print("   t     S     I     R")
    for t in range(0, len(ser), 8):
        s, i, r = ser[t]
        print(f"{t:4d} {s:5d} {i:5d} {r:5d}")
    print(f"\nattack rate: {ser[-1, 2] / ser[0].sum():.1%}, "
          f"same-type contact fraction {f0:.2f} -> {f1:.2f}")
    print("compose(mechanics, sir): one neighborhood sweep, two behaviors, "
          "zero fused-kernel code.")
    return dict(sir=ser.tolist(), same_type=(f0, f1),
                n_agents=sim.n_agents())


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
