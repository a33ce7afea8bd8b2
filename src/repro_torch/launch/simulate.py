"""ABM simulation launcher of the port (port of ``repro/launch/simulate.py``).

    PYTHONPATH=src python -m repro_torch.launch.simulate \
        --sim cell_clustering --agents 4000 --steps 50 --device cuda

Ported: ``--sim cell_clustering`` on one device.  The other sims (ROADMAP
A5), ``--mesh`` other than 1x1 and ``--delta`` (A7) and ``--rebalance``
(A8) raise ``NotImplementedError``.  Prints the reference's two summary
lines plus the ``pair_sweep`` kernel's launch count.
"""

from __future__ import annotations

import argparse
import time

SIMS = ["cell_clustering", "cell_proliferation", "epidemiology",
        "oncology", "sir_mechanics", "tumor_spheroid"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sim", required=True, choices=SIMS)
    ap.add_argument("--agents", type=int, default=400)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--mesh", default="1x1",
                    help="spatial device mesh; only 1x1 is ported")
    ap.add_argument("--delta", default="off",
                    choices=["off", "int8", "int16"])
    ap.add_argument("--interior", type=int, default=16,
                    help="global NSG cells per axis")
    ap.add_argument("--rebalance", type=int, default=0, metavar="N")
    ap.add_argument("--sweep-backend", default="auto",
                    choices=["auto", "reference", "tiled", "kernel"],
                    help="auto = the CUDA kernel on the card, tiled on CPU")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.sim != "cell_clustering":
        raise NotImplementedError(
            f"--sim {args.sim} is not ported yet (ROADMAP A5)")
    mesh_shape = tuple(int(v) for v in args.mesh.split("x"))
    if any(m != 1 for m in mesh_shape):
        raise NotImplementedError(
            f"--mesh {args.mesh}: multi-device runs are not ported yet "
            "(ROADMAP A7)")
    if args.delta != "off":
        raise NotImplementedError(
            f"--delta {args.delta} is not ported yet (ROADMAP A7)")
    if args.rebalance > 0:
        raise NotImplementedError(
            "--rebalance is not ported yet (ROADMAP A8)")

    import torch

    from repro_torch.core.engine import total_agents
    from repro_torch.kernels.neighbor_interaction import LAUNCHES, \
        reset_launches
    from repro_torch.sims import cell_clustering as mod

    reset_launches()
    t0 = time.time()
    state, metrics = mod.run(
        n_agents=args.agents, steps=args.steps,
        interior=(args.interior, args.interior),
        sweep_backend=args.sweep_backend, device=args.device)
    if state.soa.valid.is_cuda:
        torch.cuda.synchronize()
    dt = time.time() - t0
    n = total_agents(state)
    print(f"sim={args.sim} devices=1 agents={n} steps={args.steps} "
          f"wall={dt:.2f}s ({n*args.steps/dt:.0f} agent_updates/s)")
    print(f"aura bytes/iter={int(state.halo_bytes.reshape(-1)[0])} "
          f"dropped={int(state.dropped.sum())}")
    for k, v in metrics.items():
        print(f"  {k}: {v}")
    print(f"pair_sweep kernel launches={sum(LAUNCHES.values())} "
          f"({', '.join(f'{k}={v}' for k, v in LAUNCHES.items())})")


if __name__ == "__main__":
    main()
