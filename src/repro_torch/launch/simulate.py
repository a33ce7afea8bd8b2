"""ABM simulation launcher of the port (port of ``repro/launch/simulate.py``).

    PYTHONPATH=src python -m repro_torch.launch.simulate \
        --sim cell_clustering --agents 4000 --steps 50 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.simulate \
        --sim cell_clustering --mesh 2x2 --delta int8+mig
    PYTHONPATH=src python -m repro_torch.launch.simulate \
        --sim tumor_spheroid --mesh 2x2x2 --interior 8 --device cpu

Every bundled sim is ported: the 2-D ``cell_clustering``,
``epidemiology``, ``sir_mechanics``, ``cell_proliferation`` and
``oncology``, and the 3-D ``tumor_spheroid``, on one device or on a
virtual device mesh (``--mesh 2x2``, ``--mesh 2x2x2``: the whole mesh on
one card), with the aura exchange delta-encoded (``--delta``).  A sim's
``NDIM`` (3-D sims only) sets the mesh's axis count; an all-ones
``--mesh`` broadcasts to it.  ``--delta auto`` (default) is int8 on a mesh
and a full refresh on one device; ``off`` forces a full refresh.
``--rebalance`` (A8) raises ``NotImplementedError``.
Prints the reference's two summary lines plus the kernels' launch
counts.
"""

from __future__ import annotations

import argparse
import time

SIMS = ["cell_clustering", "cell_proliferation", "epidemiology",
        "oncology", "sir_mechanics", "tumor_spheroid"]
DELTAS = ["auto", "off", "int8", "int16", "int8+mig", "int16+mig"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sim", required=True, choices=SIMS)
    ap.add_argument("--agents", type=int, default=400)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--mesh", default="1x1",
                    help="spatial device mesh, e.g. 2x2 (a virtual mesh on "
                         "one card)")
    ap.add_argument("--delta", default="auto", choices=DELTAS,
                    help="aura codec; auto = int8 on a mesh, full refresh "
                         "on one device")
    ap.add_argument("--interior", type=int, default=16,
                    help="global NSG cells per axis")
    ap.add_argument("--rebalance", type=int, default=0, metavar="N")
    ap.add_argument("--sweep-backend", default="auto",
                    choices=["auto", "reference", "tiled", "kernel"],
                    help="auto = the CUDA kernel on the card, tiled on CPU")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.rebalance > 0:
        raise NotImplementedError(
            "--rebalance is not ported yet (ROADMAP A8)")

    import importlib

    import torch

    from repro_torch.core.engine import total_agents
    from repro_torch.kernels import delta_codec
    from repro_torch.kernels import neighbor_interaction as ni

    mod = importlib.import_module(f"repro_torch.sims.{args.sim}")
    # a sim declares its dimensionality with a module-level NDIM (3-D sims
    # only; 2-D is the default); an all-ones --mesh broadcasts to it, and a
    # real mesh must match the sim's axis count
    sim_ndim = getattr(mod, "NDIM", 2)
    mesh_shape = tuple(int(v) for v in args.mesh.split("x"))
    if len(mesh_shape) != sim_ndim:
        if all(m == 1 for m in mesh_shape):
            mesh_shape = (1,) * sim_ndim
        else:
            ap.error(f"--mesh {args.mesh} has {len(mesh_shape)} axes but "
                     f"{args.sim} is {sim_ndim}-D")

    n_dev = 1
    for m in mesh_shape:
        n_dev *= m
    interior = tuple(args.interior // m for m in mesh_shape)
    ni.reset_launches()
    delta_codec.reset_launches()
    t0 = time.time()
    state, metrics = mod.run(
        n_agents=args.agents, steps=args.steps, mesh_shape=mesh_shape,
        interior=interior, delta=None if args.delta == "auto" else args.delta,
        sweep_backend=args.sweep_backend, device=args.device)
    if state.soa.valid.is_cuda:
        torch.cuda.synchronize()
    dt = time.time() - t0
    n = total_agents(state)
    print(f"sim={args.sim} devices={n_dev} agents={n} steps={args.steps} "
          f"wall={dt:.2f}s ({n*args.steps/dt:.0f} agent_updates/s)")
    print(f"aura bytes/iter={int(state.halo_bytes.reshape(-1)[0])} "
          f"dropped={int(state.dropped.sum())} "
          f"codec_overflow={int(state.codec_overflow.max())}")
    for k, v in metrics.items():
        if hasattr(v, "__len__") and len(str(v)) >= 120:
            # a long series (S/I/R, agent counts): its length and last value
            print(f"  {k}: {len(v)} values, last {v[-1]}")
        else:
            print(f"  {k}: {v}")
    launches = {**ni.LAUNCHES, **delta_codec.LAUNCHES}
    print("kernel launches: "
          + ", ".join(f"{k}={v}" for k, v in launches.items()))


if __name__ == "__main__":
    main()
