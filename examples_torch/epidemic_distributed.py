"""Distributed epidemiology with the delta-encoded aura exchange on the
PyTorch port (the port of ``examples/epidemic_distributed.py``): the model
definition is the one-device one, only the mesh shape changes.  The
reference forces four XLA host devices; here the 2x2 mesh is the virtual
mesh, four devices held on the one card (a leading tensor dim).

    PYTHONPATH=src python examples_torch/epidemic_distributed.py \
        [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import DeltaConfig
from repro_torch.sims import epidemiology


def main(device="cuda", n_agents=800, initial_infected=20, steps=60,
         interior=(5, 5), mesh_shape=(2, 2), seed=0) -> dict:
    delta = DeltaConfig(enabled=True, qdtype=torch.int16,
                        refresh_interval=8)
    # identical model code as one device: only mesh_shape differs
    sim = epidemiology.simulation(
        n_agents=n_agents, initial_infected=initial_infected, seed=seed,
        mesh_shape=tuple(mesh_shape), interior=tuple(interior), delta=delta,
        device=device)
    sim.run(steps)
    ser = np.array(sim.series["sir"])
    print("   t     S     I     R")
    for t in range(0, len(ser), 10):
        s, i, r = ser[t]
        print(f"{t:4d} {s:5d} {i:5d} {r:5d}")
    wire = int(sim.state.halo_bytes.reshape(-1)[0])
    print(f"\nfinal attack rate: {ser[-1, 2] / ser[0].sum():.1%} "
          f"(aura wire bytes/iter: {wire})")
    print(f"{np.prod(sim.engine.geom.mesh_shape)} devices, delta-encoded "
          "aura exchange, identical model code.")
    return dict(sir=ser.tolist(), n_agents=sim.n_agents(), halo_bytes=wire)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
