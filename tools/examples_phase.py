"""The eight ABM examples of ``examples_torch/`` on the card, each through
its ``main(device="cuda")`` at the reference's sizes and flags (the
``--ownership rcb`` and ``--device-loss`` variants too): wall seconds and
peak device memory of each, with the card's name and power limit, as
``chip_smoke.py``'s phase 21 measures its two.  It needs a CUDA card and
nvcc:

    python3 tools/examples_phase.py
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

RUNS = [("quickstart", {}), ("epidemic_distributed", {}),
        ("sir_mechanics_demo", {}), ("spheroid_3d", {}),
        ("spheroid_3d", {"ownership": "rcb"}), ("rebalance_demo", {}),
        ("rebalance_demo", {"ownership": "rcb"}), ("overlap_demo", {}),
        ("supervised_run", {}), ("supervised_run", {"device_loss": True}),
        ("param_sweep", {})]


def main() -> int:
    if not cs.torch.cuda.is_available():
        print("examples_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    cs._build.load_all(["pair_sweep", "delta_codec"])
    print(f"[build] pair_sweep, delta_codec in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    rows = []
    for name, kw in RUNS:
        _, r = cs.run_example(name, **kw)
        rows.append(dict(example=name, flags=kw, **r))
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
