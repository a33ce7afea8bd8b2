"""Dynamic load balancing on the PyTorch port (paper section 2.4.5; the
port of ``examples/rebalance_demo.py``): a clustered population starts on
a pathological static 2x2 partition; the facade's scheduled rebalance
detects the imbalance mid-run, pays one mass migration to a better mesh
and keeps simulating.  The 2x2 mesh is the virtual mesh on the one card
(the reference forces four XLA host devices).

With ``--ownership rcb`` the re-shard realizes an uneven rectilinear
partition (padded per-device grids + masked halo exchange).

    PYTHONPATH=src python examples_torch/rebalance_demo.py \
        [--ownership rcb] [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import Rebalance, Simulation
from repro_torch.core.reshard import current_imbalance
from repro_torch.sims import cell_clustering


def clustered(n: int, side: float, seed: int):
    """Two diagonal Gaussian clusters: half the devices own almost
    nothing."""
    rng = np.random.default_rng(seed)
    centers = np.asarray([(side / 4, side / 4), (3 * side / 4, 3 * side / 4)])
    pos = centers[rng.integers(0, 2, n)] + rng.normal(0, 3.0, (n, 2))
    pos = np.clip(pos, 0.5, side - 0.5).astype(np.float32)
    attrs = {"diameter": np.full((n,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, n).astype(np.int32)}
    return pos, attrs


def main(device="cuda", ownership="equal", n_agents=600, steps=20,
         interior=(8, 8), seed=0) -> dict:
    # adhesion gentle and cap generous so the condensing clusters never
    # overflow a cell's slot capacity over the demo horizon
    sim = Simulation(
        dict(interior=tuple(interior), mesh_shape=(2, 2), cap=64),
        cell_clustering.behavior(adhesion=0.3), dt=0.1,
        rebalance=Rebalance(every=5, threshold=0.3, weighted=True,
                            ownership=ownership), device=device)
    sim.init(*clustered(n_agents, 4.0 * interior[0], seed), seed=seed)
    before = current_imbalance(sim.geom, sim.state)
    print(f"static 2x2 split: imbalance = {before:.2f}  (0 = perfect)")

    sim.run(steps)

    for rec in sim.rebalancer.history:
        if rec["applied"]:
            print(f"it {rec['it']}: re-shard {rec['mesh_from']} -> "
                  f"{rec['mesh_to']}  imbalance "
                  f"{rec['imbalance_before']:.2f} -> "
                  f"{rec['imbalance_after']:.2f}  "
                  f"(RCB bound {rec['rcb_bound']:.2f}, "
                  f"migration {rec['migration_s'] * 1e3:.0f} ms)")
            if rec.get("partition_widths") is not None \
                    and sim.engine.geom.uneven:
                print(f"  uneven slab widths (cells): "
                      f"{rec['partition_widths']}  padded-grid overhead "
                      f"{rec['pad_fraction'] * 100:.0f}%")
    after = current_imbalance(sim.geom, sim.state)
    dropped = int(sim.state.dropped.sum())
    print(f"final mesh {sim.engine.geom.mesh_shape} "
          f"({'uneven rcb' if sim.engine.geom.uneven else 'equal'} "
          f"ownership), imbalance = {after:.2f}, "
          f"agents {sim.n_agents()}/{n_agents} "
          f"(capacity drops: {dropped})")
    if ownership == "rcb":
        assert sim.engine.geom.uneven, "rcb run should land uneven"
    return dict(before=before, after=after, n_agents=sim.n_agents(),
                dropped=dropped, mesh=tuple(sim.engine.geom.mesh_shape),
                uneven=sim.engine.geom.uneven,
                applied=sum(r["applied"] for r in sim.rebalancer.history))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ownership", default="equal", choices=["equal", "rcb"],
                    help="what the re-shard may realize: equal-split "
                         "meshes or uneven RCB partitions")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(device=args.device, ownership=args.ownership)
