#!/usr/bin/env python3
"""tumor_spheroid at several seed densities on one NVIDIA GPU: the agents
each density drops at the sim's cap of 32, at init and over 20 steps.

    python3 tools/spheroid_density.py [--steps 20] [--seed 0]

The grid is ``chip_smoke.py`` phase 13's, (128, 128, 128) cells of 2.0
(L = 256), the ball the reference's ``init`` seeds (radius L/8 at the
centre, diameter 0.8, ctype 1, nutrient 1.0), from the reference's own
density (40 agents in a ball of radius 1.5, 2.83 a unit^3) down by
halves.  A density whose seed overflows a cell at init is reported as
such (``init_state`` refuses it).  Prints one line a density: agents
seeded, then live / spawned / dropped / fullest cell at steps 4, 8, ...,
and the spheroid diameter at the start and the end.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.engine import total_agents  # noqa: E402
from repro_torch.sims import tumor_spheroid as ts  # noqa: E402
from repro_torch.sims.common import (  # noqa: E402
    ball_positions, init_agents, make_sim)

INTERIOR = (128, 128, 128)
DENSITIES = (40 / (4.0 / 3.0 * math.pi * 1.5 ** 3), 2.0, 1.0, 0.5, 0.25,
             0.125, 0.0625, 0.03125)


def run(density: float, steps: int, seed: int) -> None:
    sim = make_sim(ts.behavior(), interior=INTERIOR, cap=32, device="cuda")
    size = sim.geom.domain_size
    radius = min(size) / 8
    n0 = int(density * 4.0 / 3.0 * math.pi * radius ** 3)
    pos = ball_positions(np.random.default_rng(seed), n0,
                         tuple(s / 2 for s in size), radius)
    try:
        init_agents(sim, pos, {"diameter": np.full((n0,), 0.8, np.float32),
                               "ctype": np.ones((n0,), np.int32),
                               "nutrient": np.ones((n0,), np.float32)},
                    seed=seed)
    except ValueError as e:
        print(f"density {density:.5f}: {n0} agents; init refused: {e}",
              flush=True)
        return
    d0 = ts.spheroid_diameter(sim.state)
    t0 = time.perf_counter()
    marks = []
    for step in range(1, steps + 1):
        sim.run(1)
        if step % 4 == 0 or step == steps:
            st = sim.state
            marks.append(
                f"{step}: {total_agents(st)}/"
                f"{int(st.gid_counter.sum()) - n0}/{int(st.dropped.sum())}/"
                f"{int(st.soa.valid.sum(-1).max())}")
    torch.cuda.synchronize()
    print(f"density {density:.5f}: {n0} agents; step: live/spawned/dropped/"
          f"fullest {'; '.join(marks)}; diameter {d0:.4f} -> "
          f"{ts.spheroid_diameter(sim.state):.4f}; "
          f"{time.perf_counter() - t0:.2f}s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spheroid_density: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}", flush=True)
    for density in DENSITIES:
        run(density, args.steps, args.seed)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
