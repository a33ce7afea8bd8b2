"""Phase 23 of ``chip_smoke.py`` alone: the ssm and hybrid families of the
LM stack (zamba2-1.2b: Mamba2 blocks and one shared attention block;
xlstm-1.3b: mLSTM and sLSTM blocks) at full width and depth on the card,
scoring on the attention kernel, the card against the CPU on float32
weights, and serving; every number beside the card's name and power
limit.  It needs a CUDA card and nvcc:

    python3 tools/ssm_phase.py
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not cs.torch.cuda.is_available():
        print("ssm_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    cs.torch.backends.cuda.matmul.allow_tf32 = False
    cs.torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    cs._build.load_all(["flash_attention"])
    print(f"[build] flash_attention in {time.perf_counter() - t0:.1f}s",
          flush=True)
    out = cs.phase_ssm(args.seed)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
