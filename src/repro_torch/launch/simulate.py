"""ABM simulation launcher of the port (port of ``repro/launch/simulate.py``).

    PYTHONPATH=src python -m repro_torch.launch.simulate \
        --sim cell_clustering --agents 4000 --steps 50 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.simulate \
        --sim cell_clustering --mesh 2x2 --delta int8+mig
    PYTHONPATH=src python -m repro_torch.launch.simulate \
        --sim tumor_spheroid --mesh 2x2x2 --interior 8 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m \
        repro_torch.launch.simulate --sim cell_clustering --mesh 2x2 \
        --device cpu --agents 300 --steps 4

Every bundled sim is ported: the 2-D ``cell_clustering``,
``epidemiology``, ``sir_mechanics``, ``cell_proliferation`` and
``oncology``, and the 3-D ``tumor_spheroid``, on one device or on a
virtual device mesh (``--mesh 2x2``, ``--mesh 2x2x2``: the whole mesh on
one card), with the aura exchange delta-encoded (``--delta``).  A sim's
``NDIM`` (3-D sims only) sets the mesh's axis count; an all-ones
``--mesh`` broadcasts to it.  ``--delta auto`` (default) is int8 on a mesh
and a full refresh on one device; ``off`` forces a full refresh.
``--rebalance N`` arms the dynamic load balancer (paper section 2.4.5):
every N iterations the occupancy imbalance is checked and past
``--imbalance`` the state is re-sharded (``--ownership rcb``: onto an
uneven cut; ``--weighted``: boxes weighted by the measured step time);
the facade keeps its engine and state consistent across it, on a process
mesh too.
Prints the reference's two summary lines plus the kernels' launch
counts.

Under ``torchrun`` (``WORLD_SIZE`` set) with a ``--mesh`` of as many
devices as the world has ranks, the mesh runs one process a device
(:func:`repro_torch.launch.mesh.make_abm_mesh`, a gloo group; on the card
every rank uses device 0 and the wire goes through host memory).  Every
rank prints its own line (its device, agents, launches and metrics, which
are its block's); rank 0 also prints the global agent count and the
summary lines.  Otherwise the mesh is virtual, as without ``torchrun``.
"""

from __future__ import annotations

import argparse
import os
import time

SIMS = ["cell_clustering", "cell_proliferation", "epidemiology",
        "oncology", "sir_mechanics", "tumor_spheroid"]
DELTAS = ["auto", "off", "int8", "int16", "int8+mig", "int16+mig"]


def cli_delta(value: str, n_devices: int):
    """``--delta``'s value as the facade's ``DeltaConfig`` (or None) on a
    mesh of ``n_devices``: ``auto`` is the reference's default
    (``resolve_delta(None, n)``: int8 on a mesh, a full refresh on one
    device); ``off`` is a full refresh on any mesh (ROADMAP C 4: the
    reference's ``--delta off`` passes None, so it runs the codec on a
    mesh)."""
    from repro_torch.sims.common import resolve_delta
    return resolve_delta(None if value == "auto" else value, n_devices)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sim", required=True, choices=SIMS)
    ap.add_argument("--agents", type=int, default=400)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--mesh", default="1x1",
                    help="spatial device mesh, e.g. 2x2 (a virtual mesh on "
                         "one card; one process a device under torchrun "
                         "with as many ranks)")
    ap.add_argument("--delta", default="auto", choices=DELTAS,
                    help="aura codec; auto = int8 on a mesh, full refresh "
                         "on one device")
    ap.add_argument("--interior", type=int, default=16,
                    help="global NSG cells per axis")
    ap.add_argument("--rebalance", type=int, default=0, metavar="N",
                    help="check occupancy imbalance every N iterations "
                         "and re-shard past --imbalance")
    ap.add_argument("--imbalance", type=float, default=0.5,
                    help="re-shard threshold for --rebalance")
    ap.add_argument("--weighted", action="store_true",
                    help="weight the rebalance histogram by measured "
                         "per-device step times")
    ap.add_argument("--ownership", default="equal",
                    choices=["equal", "rcb"],
                    help="what a triggered re-shard may realize: equal-"
                         "split meshes, or box-granular uneven partitions")
    ap.add_argument("--sweep-backend", default="auto",
                    choices=["auto", "reference", "tiled", "kernel"],
                    help="auto = the CUDA kernel on the card, tiled on CPU")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)

    import importlib

    import torch

    from repro_torch.core.engine import total_agents
    from repro_torch.core.simulation import Rebalance

    rebalance = None
    if args.rebalance > 0:
        rebalance = Rebalance(every=args.rebalance, threshold=args.imbalance,
                              weighted=args.weighted,
                              ownership=args.ownership)
    elif args.ownership != "equal":
        ap.error("--ownership rcb needs --rebalance N (the re-shard "
                 "runtime is what realizes uneven partitions)")
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

    from repro_torch.launch.mesh import (
        close_process_mesh, init_process_mesh, make_abm_mesh,
    )
    mesh = None
    if n_dev > 1 and int(os.environ.get("WORLD_SIZE", "0")) == n_dev:
        init_process_mesh("gloo")
        mesh = make_abm_mesh(mesh_shape, device_type=args.device)

    ni.reset_launches()
    delta_codec.reset_launches()
    t0 = time.time()
    state, metrics = mod.run(
        n_agents=args.agents, steps=args.steps, mesh_shape=mesh_shape,
        interior=interior, delta=cli_delta(args.delta, n_dev),
        rebalance=rebalance, sweep_backend=args.sweep_backend,
        device=args.device, mesh=mesh)
    if state.soa.valid.is_cuda:
        torch.cuda.synchronize()
    dt = time.time() - t0
    n = total_agents(state)
    dropped = int(state.dropped.sum())
    overflow = int(state.codec_overflow.max())
    launches = {**ni.LAUNCHES, **delta_codec.LAUNCHES}
    if mesh is not None:
        import torch.distributed as dist
        rank = dist.get_rank()
        print(f"rank={rank} device={tuple(mesh.get_coordinate())} "
              f"agents={n} aura bytes/iter="
              f"{int(state.halo_bytes.reshape(-1)[0])} launches "
              f"{ {k: v for k, v in launches.items() if v} }"
              + "".join(f" {k}={v}" for k, v in metrics.items()
                        if len(str(v)) < 120), flush=True)
        tot = torch.tensor([n, dropped], dtype=torch.int64)
        dist.all_reduce(tot)
        top = torch.tensor([overflow], dtype=torch.int64)
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
        n, dropped, overflow = int(tot[0]), int(tot[1]), int(top[0])
        dist.barrier()
        close_process_mesh()
        if rank != 0:
            return
    print(f"sim={args.sim} devices={n_dev} agents={n} steps={args.steps} "
          f"wall={dt:.2f}s ({n*args.steps/dt:.0f} agent_updates/s)"
          + (f" ranks={n_dev}" if mesh is not None else ""))
    print(f"aura bytes/iter={int(state.halo_bytes.reshape(-1)[0])} "
          f"dropped={dropped} codec_overflow={overflow}")
    if mesh is not None:
        return        # the metrics and launches are the rank lines' own
    for k, v in metrics.items():
        if hasattr(v, "__len__") and len(str(v)) >= 120:
            # a long series (S/I/R, agent counts): its length and last value
            print(f"  {k}: {len(v)} values, last {v[-1]}")
        else:
            print(f"  {k}: {v}")
    print("kernel launches: "
          + ", ".join(f"{k}={v}" for k, v in launches.items()))


if __name__ == "__main__":
    main()
