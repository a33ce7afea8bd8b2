"""``chip_smoke.py``'s phase 14 (the ``sir_mechanics`` ensembles and the
scenario server) alone, then the stack-18 sweep of its 8 lanes three ways.

It builds the ``pair_sweep`` library (printing each kernel's registers and
spills from nvcc's ptxas report), runs phase 14 with its gates, and on
step 1's aura-filled SoA of the 8 lanes times, by CUDA events over 5
calls, one lane launch over all 8 lanes, 8 one-lane launches of the lane
kernel (each with its row of the table) and 8 solo launches (the solo
kernel, the host's params): the lane kernel against the solo one at the
same work.  It needs a CUDA card and nvcc:

    python3 tools/ensemble_phase.py
"""

import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ni = cs.ni
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    cs._build.load_all(["pair_sweep"])
    built = cs._build.BUILDS["pair_sweep"]
    print(f"[build] pair_sweep in {time.perf_counter() - t0:.1f}s",
          flush=True)
    name = None
    for line in built.log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        if "registers" in line or "spill" in line:
            print(f"[build] {name} | {line.strip()}")
    rows, stats = cs.phase_ensembles(0)
    print(json.dumps({"rows": rows, "stats": stats}, default=str),
          flush=True)

    ens = cs.ens_family()
    aura, lanes = cs.lane_aura(ens, cs.ens_init(ens, cs.ENS_POINTS, 0))
    at = (slice(None), 0, 0)
    attrs = {n: a[at] for n, a in aura.attrs.items()}
    valid = aura.valid[at]
    fns = [e.behavior.pair_fn for e in lanes.engines]
    params = [e.behavior.params for e in lanes.engines]
    kw = dict(pair_attrs=lanes.engines[0].behavior.pair_attrs, radius=2.0,
              box=cs.minimum_image_box(ens.geom))
    count = len(fns)

    def all_lanes():
        return ni.pair_sweep_lanes(attrs, valid, pair_fns=fns, params=params,
                                   table=lanes.table, **kw)

    def one_lane_each():
        return [ni.pair_sweep_lanes(
            {n: a[r:r + 1] for n, a in attrs.items()}, valid[r:r + 1],
            pair_fns=fns[r:r + 1], params=params[r:r + 1],
            table=lanes.table[r:r + 1], **kw) for r in range(count)]

    def solo_each():
        return [ni.pair_sweep({n: a[r] for n, a in attrs.items()}, valid[r],
                              pair_fn=fns[r], params=params[r], **kw)
                for r in range(count)]

    for _ in range(2):
        print(f"[lanes] stack 18 over {count} lanes: one lane launch "
              f"{cs.cuda_ms(all_lanes, 5):.4f} ms, {count} one-lane "
              f"launches {cs.cuda_ms(one_lane_each, 5):.4f} ms, {count} solo "
              f"launches {cs.cuda_ms(solo_each, 5):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
