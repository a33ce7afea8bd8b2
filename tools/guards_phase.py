"""``chip_smoke.py``'s phase 18 (runtime guards, fault plans, supervised
runs, and the scenario server over a process mesh) alone, with its gates.

It builds the ``pair_sweep`` and ``delta_codec`` libraries, prints the
card's name and power limit, runs phase 18 - the 16.7M-agent main path
with guards off and on, each guard tripped on the 2x2 virtual mesh, a
supervised run with a halo fault, a torn checkpoint and a device loss,
and four ranks of a process mesh (the server and a guarded run) - and
prints its numbers as one JSON line.  It needs a CUDA card and nvcc:

    python3 tools/guards_phase.py [--seed 0]
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# importable by name: the process mesh's spawned ranks load it again
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not cs.torch.cuda.is_available():
        print("guards_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    cs._build.load_all(["pair_sweep", "delta_codec"])
    print(f"[build] pair_sweep, delta_codec in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    out = cs.phase_guards(args.seed)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
