"""Phase 22 of ``chip_smoke.py`` alone: the transformer-block families of
the LM stack (minicpm-2b, minicpm3-4b, qwen3-moe, phi3.5-moe, llava,
hubert) at full width on the card, scoring on the attention kernel and
serving, then ``examples_torch/serve_lm.py``; every number beside the
card's name and power limit.  It needs a CUDA card and nvcc:

    python3 tools/families_phase.py
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
        print("families_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    cs.torch.backends.cuda.matmul.allow_tf32 = False
    cs.torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    cs._build.load_all(["flash_attention"])
    print(f"[build] flash_attention in {time.perf_counter() - t0:.1f}s",
          flush=True)
    out = cs.phase_families(args.seed)
    _, out["serve_lm"] = cs.run_example("serve_lm")
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
