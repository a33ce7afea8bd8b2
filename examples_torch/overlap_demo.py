"""Communication-budget smoke on the PyTorch port (the port of
``examples/overlap_demo.py``): the three layers that keep the wire off the
critical path, end to end on a 2x2 mesh (the virtual mesh on the one
card; the reference forces four XLA host devices).

* **Overlap** - ``overlap="on"`` splits every sweep into an interior pass
  and the boundary bands that read the received ring, bit-equal to the
  monolithic sweep.
* **Delta by default** - ``make_sim`` resolves multi-device sims to the
  int8 delta-encoded aura exchange (paper section 2.3).
* **Device-to-device re-shard** - a skewed two-cluster density triggers
  one mid-run rebalance onto an uneven RCB partition, migrated on the
  device (``transport="device"``) with a deferred plan: no agent through
  the host, asserted by trapping ``flatten_state``.

    PYTHONPATH=src python examples_torch/overlap_demo.py [--device cpu]
"""

import argparse

import numpy as np

import repro_torch.core.reshard as reshard_mod
from repro_torch.core import Rebalance
from repro_torch.core.reshard import current_imbalance
from repro_torch.sims import cell_clustering
from repro_torch.sims.common import make_sim


def main(device="cuda", n_agents=600, steps=20, interior=(8, 8), seed=0
         ) -> dict:
    sim = make_sim(
        cell_clustering.behavior(adhesion=0.3),
        interior=tuple(interior), mesh_shape=(2, 2), cap=64, dt=0.1,
        overlap="on",
        rebalance=Rebalance(every=6, threshold=0.3, ownership="rcb",
                            transport="device", defer=True), device=device)
    assert sim.engine.delta_cfg.enabled, "multi-device sims default to delta"
    print(f"aura exchange: int8 delta, refresh_interval="
          f"{sim.engine.delta_cfg.refresh_interval}; overlap=on")
    # two diagonal Gaussian clusters: half the devices own almost nothing
    rng = np.random.default_rng(seed)
    side = 4.0 * interior[0]
    centers = np.asarray([(side / 4, side / 4), (3 * side / 4, 3 * side / 4)])
    pos = centers[rng.integers(0, 2, n_agents)] + rng.normal(
        0, 3.0, (n_agents, 2))
    pos = np.clip(pos, 0.5, side - 0.5).astype(np.float32)
    sim.init(pos, {"diameter": np.full((n_agents,), 1.0, np.float32),
                   "ctype": rng.integers(0, 2, n_agents).astype(np.int32)},
             seed=seed)
    print(f"static 2x2 split: imbalance = "
          f"{current_imbalance(sim.geom, sim.state):.2f}")

    # any call into the host-path flattener during the run is a regression
    calls = []
    orig = reshard_mod.flatten_state

    def trap(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    reshard_mod.flatten_state = trap
    try:
        sim.run(steps)
    finally:
        reshard_mod.flatten_state = orig

    applied = [r for r in sim.rebalancer.history if r["applied"]]
    assert applied, sim.rebalancer.history
    for rec in applied:
        assert rec["transport"] == "device", rec
        assert rec.get("deferred"), rec
        print(f"it {rec['it']}: deferred device-to-device re-shard "
              f"{rec['mesh_from']} -> {rec['mesh_to']}  imbalance "
              f"{rec['imbalance_before']:.2f} -> "
              f"{rec['imbalance_after']:.2f}  "
              f"(migration {rec['migration_s'] * 1e3:.0f} ms)")
    assert not calls, "device re-shard must not touch flatten_state"
    assert sim.engine.geom.uneven, "rcb re-shard should land uneven"

    dropped = int(sim.state.dropped.sum())
    assert sim.n_agents() + dropped == n_agents, (sim.n_agents(), dropped)
    print(f"final mesh {sim.engine.geom.mesh_shape} (uneven rcb), "
          f"imbalance = {current_imbalance(sim.geom, sim.state):.2f}, "
          f"agents {sim.n_agents()}/{n_agents} (drops: {dropped}), "
          f"zero host bytes moved")
    return dict(n_agents=sim.n_agents(), dropped=dropped,
                applied=len(applied), mesh=tuple(sim.engine.geom.mesh_shape))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
