"""Phase 24 of ``chip_smoke.py`` alone: LM training on the card (olmo-1b
at full width and depth: the train step, its spans, the compressed step,
the remat policies' peaks, the card against the CPU, accumulation; a
resume; every smoke config; ``examples_torch/train_lm.py``), every number
beside the card's name and power limit.  It needs a CUDA card (no kernel
is built: training runs the chunked attention):

    python3 tools/train_phase.py
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not cs.torch.cuda.is_available():
        print("train_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    cs.torch.backends.cuda.matmul.allow_tf32 = False
    cs.torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    out = cs.phase_train(args.seed)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
