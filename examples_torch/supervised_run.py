"""Supervised run on the PyTorch port (the port of
``examples/supervised_run.py``): health guards, deterministic fault
injection and automatic checkpoint-rollback recovery.

A 4-device run (the 2x2 virtual mesh on the one card; the reference
forces four XLA host devices) has a NaN burst scripted at step 7 (caught
by the NaN/Inf guard at the next control point) and, with
``--device-loss``, the loss of two devices at step 13 (recovered by
degrading onto the two survivors through the elastic restore).  The
supervisor rolls back to the newest verified checkpoint each time and
replays; the final state is bit-exact with an uninterrupted run resumed
from the same checkpoint (asserted below).

    PYTHONPATH=src python examples_torch/supervised_run.py \
        [--device-loss] [--steps 20] [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from repro_torch.core import Simulation
from repro_torch.distributed.chaos import Fault, FaultPlan
from repro_torch.launch.supervise import Supervised, Supervisor
from repro_torch.sims import cell_clustering
from repro_torch.sims.common import make_sim


def state_key(state):
    """Live (positions, gids) in gid order - the bit-exactness currency."""
    v = state.soa.valid.reshape(-1)
    nd = state.soa.attrs["pos"].shape[-1]
    p = state.soa.attrs["pos"].reshape(-1, nd)[v].cpu().numpy()
    gr = state.soa.attrs["gid_rank"].reshape(-1)[v].cpu().numpy()
    gc = state.soa.attrs["gid_count"].reshape(-1)[v].cpu().numpy()
    o = np.lexsort((gc, gr))
    return p[o], gr[o], gc[o]


def main(device="cuda", device_loss=False, steps=20, n_agents=400,
         interior=(8, 8), seed=0) -> dict:
    beh = cell_clustering.behavior(adhesion=0.3)
    sim = make_sim(beh, interior=tuple(interior), mesh_shape=(2, 2), cap=48,
                   dt=0.1, guards="error", device=device)
    rng = np.random.default_rng(seed)
    side = 4.0 * interior[0]
    pos = rng.uniform(0.5, side - 0.5, size=(n_agents, 2)).astype(np.float32)
    attrs = {"diameter": np.full((n_agents,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, n_agents).astype(np.int32)}
    sim.init(pos, attrs, seed=seed)

    faults = [Fault(step=7, kind="nan_attrs", frac=0.1,
                    note="silent corruption burst")]
    if device_loss:
        faults.append(Fault(step=13, kind="device_loss", survivors=2,
                            note="half the mesh walks away"))
    plan = FaultPlan(tuple(faults), seed=42)

    with tempfile.TemporaryDirectory() as ck:
        sv = Supervisor(sim, Supervised(dir=ck, every=5, keep=9),
                        fault_plan=plan)
        sv.run(steps)

        for e in sv.log:
            extra = {k: v for k, v in e.items()
                     if k not in ("kind", "wall_time")}
            print(f"  [{e['kind']}] {extra}")

        recs = sv.events("recovered")
        assert recs, "the scripted faults should have forced a recovery"
        assert sim.iteration == steps, sim.iteration
        assert sv.events("completed"), "supervised run should complete"
        if device_loss:
            assert sim.engine.geom.n_devices == 2, \
                "device loss should degrade onto the 2 survivors"

        # bit-exactness: replay == uninterrupted resume from the same
        # checkpoint the (last) recovery rolled back to
        rb = recs[-1]["rolled_back_to"]
        ctl = Simulation.restore(
            ck, beh, step=rb, guards="error",
            n_devices=sim.engine.geom.n_devices, device=device)
        ctl.run(steps - rb)
        for a, b in zip(state_key(sim.state), state_key(ctl.state)):
            np.testing.assert_array_equal(a, b)

    print(f"recovered {len(recs)} fault(s); final it {sim.iteration}, "
          f"{sim.n_agents()}/{n_agents} agents on "
          f"{sim.engine.geom.n_devices} device(s) - "
          f"bit-exact with uninterrupted resume from step {rb}")
    return dict(log=sv.log, n_agents=sim.n_agents(),
                n_devices=sim.engine.geom.n_devices,
                recoveries=[e["seconds"] for e in recs])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device-loss", action="store_true",
                    help="also lose 2 of 4 devices mid-run and degrade")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(device=args.device, device_loss=args.device_loss, steps=args.steps)
