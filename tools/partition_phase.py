"""``chip_smoke.py``'s phase 15 (uneven partitions and the overlapped
sweep on the 2x2 virtual mesh) alone, with its gates.

It builds the ``pair_sweep`` and ``delta_codec`` libraries, prints the
card's name and power limit, runs phase 15 - the 16.7M-agent uneven cut
with the overlapped sweep off and on, the face bands' launches against
the plain version and the full block, the count-driven parity run and the
uneven ensemble - and prints its numbers as one JSON line.  It needs a
CUDA card and nvcc:

    python3 tools/partition_phase.py [--seed 0]
"""

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not cs.torch.cuda.is_available():
        print("partition_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    cs._build.load_all(["pair_sweep", "delta_codec"])
    print(f"[build] pair_sweep, delta_codec in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    out = cs.phase_partition(args.seed)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
