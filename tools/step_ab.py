"""Step times of the cell_clustering paths, compared between source trees
on one card.

For each tree given, in the order given (for an A/B: parent, change,
change, parent), a process of its own imports that tree's ``repro_torch``,
builds its ``pair_sweep`` and ``delta_codec`` libraries and times, by CUDA
events over steps 2-10, the two paths of ``chip_smoke.py``'s phases 4 and
6: 16,777,216 agents on 2048 x 2048 cells at cap 48 on one device, and
the same agents on the 2x2 virtual mesh with the int8+mig codec.  For
each path it also takes one more step under ``torch.profiler`` and sums
its device-side events (kernels, copies, memsets): the step's time less
that sum is the time the card waited.  Where the tree derives RNG step
keys (``Engine.step_keys``), the host time of one derivation is taken
too.  It prints one line a run and, last, a JSON object with every run's
numbers beside the card's name and power limit.  It needs a CUDA card and
nvcc:

    python3 tools/step_ab.py PARENT_ROOT . . PARENT_ROOT

A tree is a checkout's root (the directory holding ``src/``), for example
the parent commit unpacked by ``git archive`` into a gitignored directory.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

STEPS = 10
INTERIOR = (2048, 2048)
MESH_SHAPE, MESH_INTERIOR, MESH_DELTA = (2, 2), (1024, 1024), "int8+mig"
CAP = 48


def kernel_ms(torch, fn) -> float:
    """The device-side time of one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us += (getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0))
    return us / 1e3


def one(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.sims import cell_clustering as cc
    from repro_torch.sims.common import make_sim

    _build.load_all(["pair_sweep", "delta_codec"])
    out = {"root": str(root)}
    n_agents = 4 * math.prod(INTERIOR)
    for label, kw in (("main", dict(interior=INTERIOR)),
                      ("mesh", dict(interior=MESH_INTERIOR,
                                    mesh_shape=MESH_SHAPE,
                                    delta=MESH_DELTA))):
        sim = make_sim(cc.behavior(), cap=CAP, sweep_backend="auto",
                       device="cuda", **kw)
        cc.init(sim, n_agents, seed=0)
        sim.run(1)                                   # step 1: warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        sim.run(STEPS - 1)
        end.record()
        end.synchronize()
        out[f"{label}_ms"] = start.elapsed_time(end) / (STEPS - 1)
        out[f"{label}_host_ms"] = 1e3 * (time.perf_counter() - t0) / (
            STEPS - 1)
        out[f"{label}_kernel_ms"] = kernel_ms(torch, lambda: sim.run(1))
        if hasattr(sim.engine, "step_keys"):
            sim.engine.step_keys(sim.state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                sim.engine.step_keys(sim.state)
            torch.cuda.synchronize()
            out[f"{label}_keys_host_ms"] = 1e3 * (
                time.perf_counter() - t0) / 20
        del sim
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(Path(argv[1]).resolve())))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    runs = []
    for root in argv:
        p = subprocess.run([sys.executable, __file__, "--one", root],
                           capture_output=True, text=True)
        if p.returncode != 0:
            print(p.stdout + p.stderr, file=sys.stderr)
            return 1
        run = json.loads(p.stdout.strip().splitlines()[-1])
        print(f"[step_ab] {run['root']}: " + "; ".join(
            f"{path} {run[path + '_ms']:.3f} ms/step, "
            f"{run[path + '_kernel_ms']:.3f} of device events, keys "
            f"{run.get(path + '_keys_host_ms', float('nan')):.3f} ms on the "
            f"host" for path in ("main", "mesh")), flush=True)
        runs.append(run)
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
