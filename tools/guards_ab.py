"""The guarded main step against the unguarded one, compared between
source trees on one card.

For each tree given, in the order given (for an A/B: A, B, B, A), a
process of its own imports that tree's ``repro_torch``, builds its
``pair_sweep`` library and times, by CUDA events over steps 2-10,
``chip_smoke.py``'s phase 4 path (16,777,216 ``cell_clustering`` agents
on 2048 x 2048 cells at cap 48, one device) with guards off and with
``guards="error"``, then one more guarded step under ``torch.profiler``
(its device time by kernel name, the ten largest), and the control
point's device duplicate check (host clock, synchronised, best of 3).  It
prints one line a run and, last, a JSON object with every run's numbers
beside the card's name and power limit.  It needs a CUDA card and nvcc:

    python3 tools/guards_ab.py TREE_A . . TREE_A

A tree is a checkout's root (the directory holding ``src/``), for example
another version unpacked into a gitignored directory.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

STEPS = 10
INTERIOR = (2048, 2048)
CAP = 48


def one(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import guards
    from repro_torch.kernels import _build
    from repro_torch.sims import cell_clustering as cc
    from repro_torch.sims.common import make_sim

    _build.load_all(["pair_sweep"])
    out = {"root": str(root)}
    for label, g in (("off", None), ("guarded", "error")):
        sim = make_sim(cc.behavior(), interior=INTERIOR, cap=CAP,
                       sweep_backend="auto", device="cuda", guards=g)
        cc.init(sim, 4 * math.prod(INTERIOR), seed=0)
        sim.run(1)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sim.run(STEPS - 1)
        end.record()
        end.synchronize()
        out[f"{label}_ms"] = start.elapsed_time(end) / (STEPS - 1)
        if g is not None:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                sim.run(1)
                torch.cuda.synchronize()
            rows = []
            for e in prof.key_averages():
                if str(getattr(e, "device_type", "")).endswith("CUDA"):
                    us = (getattr(e, "self_device_time_total", None)
                          or getattr(e, "self_cuda_time_total", 0))
                    rows.append((us / 1e3, e.count, e.key[:60]))
            rows.sort(reverse=True)
            out["profile_ms"] = sum(r[0] for r in rows)
            out["top"] = rows[:10]
            best = math.inf
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                guards.gid_duplicate_count(sim.state)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            out["dup_check_ms"] = 1e3 * best
        del sim
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print("RESULT" + json.dumps(one(Path(sys.argv[2]).resolve())),
              flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    runs = []
    for tree in sys.argv[1:]:
        p = subprocess.run([sys.executable, __file__, "--one", tree],
                           capture_output=True, text=True)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("RESULT")]
        if p.returncode or not line:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(line[-1][6:])
        runs.append(r)
        print(f"{tree}: off {r['off_ms']:.3f} ms/step, guarded "
              f"{r['guarded_ms']:.3f} (+{r['guarded_ms'] - r['off_ms']:.3f});"
              f" duplicate check {r['dup_check_ms']:.3f} ms; profiled "
              f"guarded step {r['profile_ms']:.3f} ms, top "
              f"{[(round(a, 3), b, c) for a, b, c in r['top'][:6]]}",
              flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
