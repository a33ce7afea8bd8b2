"""``chip_smoke.py``'s phase 19 (the simcheck suite on the card) alone,
with its gates.

It builds the ``pair_sweep`` and ``delta_codec`` libraries, prints the
card's name and power limit, runs phase 19 - the bare ``simcheck
--strict``, ``validate()`` of the 16.7M-agent main sim and of the 2x2
``int8+mig`` mesh, the engine's own host syncs of three steps, two planted
faults - and prints its numbers as one JSON line.  It needs a CUDA card
and nvcc:

    python3 tools/simcheck_phase.py [--seed 0]
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not cs.torch.cuda.is_available():
        print("simcheck_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    cs._build.load_all(["pair_sweep", "delta_codec"])
    print(f"[build] pair_sweep, delta_codec in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    out = cs.phase_simcheck(args.seed)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
