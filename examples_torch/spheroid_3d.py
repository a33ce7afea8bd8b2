"""3-D tumor spheroid on a sharded spatial mesh on the PyTorch port (the
port of ``examples/spheroid_3d.py``): making the model 3-D and
distributed is the geometry argument only, a 3-axis ``interior`` and a
``(1, 1, 2)`` mesh sharding the tissue along z (the virtual mesh, two
devices on the one card; the reference forces two XLA host devices).

With ``--ownership rcb`` the spheroid seeds off-centre and the dynamic
load balancer re-cuts the z axis into uneven slabs.

    PYTHONPATH=src python examples_torch/spheroid_3d.py \
        [--ownership rcb] [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import DeltaConfig, Rebalance
from repro_torch.sims import tumor_spheroid


def main(device="cuda", ownership="equal", n_agents=40, steps=15,
         interior=(6, 6, 3), mesh_shape=(1, 1, 2), seed=0) -> dict:
    delta = DeltaConfig(enabled=True, qdtype=torch.int16,
                        refresh_interval=8)
    rebalance = None
    center_frac = None
    if ownership == "rcb":
        # off-centre on every axis: no equal split can balance, only an
        # uneven cut through the ball
        center_frac = (0.3, 0.3, 0.3)
        rebalance = Rebalance(every=5, threshold=0.3, ownership="rcb")
    # the off-centre ball packs the proliferating tissue into a few
    # cells: a generous cap keeps the densest cell from overflowing
    sim = tumor_spheroid.simulation(
        n_agents=n_agents, seed=seed, mesh_shape=tuple(mesh_shape),
        interior=tuple(interior), delta=delta, rebalance=rebalance,
        center_frac=center_frac, cap=64 if ownership == "rcb" else 32,
        device=device)
    n0 = sim.n_agents()
    d0 = tumor_spheroid.spheroid_diameter(sim.state)
    sim.run(steps, collect=lambda s: (
        int(s.soa.valid.sum()), tumor_spheroid.spheroid_diameter(s)))
    series = sim.series["collect"]
    print("   t  cells  spheroid_diam")
    for t in range(0, len(series), 5):
        n, d = series[t]
        print(f"{t:4d} {n:6d} {d:14.2f}")
    n1, d1 = series[-1]
    dropped = int(sim.state.dropped.sum())
    print(f"\ncells {n0} -> {n1}, bounding-box diameter "
          f"{d0:.2f} -> {d1:.2f}")
    print(f"{np.prod(sim.engine.geom.mesh_shape)} devices over mesh "
          f"{sim.engine.geom.mesh_shape}, 6-edge delta-encoded aura "
          f"exchange ({int(sim.state.halo_bytes.reshape(-1)[0])} wire "
          f"bytes/iter), zero drops: {dropped}")
    if ownership == "rcb":
        applied = [r for r in sim.rebalancer.history if r["applied"]]
        assert applied and sim.engine.geom.uneven, sim.rebalancer.history
        print(f"uneven re-cut at it {applied[0]['it']}: z slab widths "
              f"{sim.engine.geom.partition.widths[2]} (cells), imbalance "
              f"{applied[0]['imbalance_before']:.2f} -> "
              f"{applied[0]['imbalance_after']:.2f}")
    assert n1 > n0 and dropped == 0
    return dict(n0=n0, n1=n1, uneven=sim.engine.geom.uneven,
                mesh=tuple(sim.engine.geom.mesh_shape))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ownership", default="equal", choices=["equal", "rcb"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(device=args.device, ownership=args.ownership)
