"""Kernel times of every ``pair_sweep`` law, compared between source trees
on one card.

For each tree given, in the order given (for an A/B: parent, change,
change, parent), a process of its own imports that tree's ``repro_torch``
and ``chip_smoke.py``, builds its ``pair_sweep`` library (printing each
sweep kernel's registers and spills from nvcc's ptxas report) and times,
by CUDA events over 20 launches after a warm-up, the tree's solo
``pair_sweep`` of every law of its ``chip_smoke.LAW_ARGS`` on three SoAs:
phase 4's (16,777,216 ``cell_clustering`` agents on 2048 x 2048 cells,
cap 48) and phase 13 a's (16,777,216 agents uniform on 128^3 cells, cap
32), each with a ``state`` column added (S, I, R uniform from a seed)
for the laws that read one, and phase 12 a's (16,777,216
``epidemiology`` agents, 5 % infected, cap 24, one step in) for the laws
whose columns it has; each aura-filled as a step's sweep sees it.  Laws
a tree does not have are left out of its run.  It prints one line a law a
run and, last, a JSON object with every run's times beside the card's
name and power limit.  It needs a CUDA card and nvcc:

    python3 tools/sweep_ab.py PARENT_ROOT . . PARENT_ROOT

A tree is a checkout's root (the directory holding ``src/`` and
``chip_smoke.py``), for example the parent commit unpacked by
``git archive`` into a gitignored directory.
"""

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

REPS = 20


def registers(log: str):
    """(kernel, registers, spill stores) of each sweep kernel in a ptxas
    report."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], 0
        elif name and "pair_sweep" in name and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "pair_sweep" in name and "Used" in line:
            out.append((name, int(line.split("Used")[1].split()[0]), spill))
    return out


def soas(cs, torch):
    """(label, aura-filled SoA, geometry) of each grid, one at a time."""
    for label, interior, cap, n_agents in (
            ("d2", cs.MAIN_INTERIOR, cs.MAIN_CAP,
             4 * math.prod(cs.MAIN_INTERIOR)),
            ("d3", cs.SPH_INTERIOR, cs.SPH_CAP, cs.SPH_UNIFORM_AGENTS)):
        sim = cs.make_sim(cs.cc.behavior(), interior=interior, cap=cap,
                          device="cuda")
        cs.cc.init(sim, n_agents, seed=0)
        soa, geom = cs.aura_block(sim), sim.geom
        del sim
        gen = torch.Generator(device="cuda").manual_seed(1)
        state = torch.randint(0, 3, tuple(soa.valid.shape), generator=gen,
                              device="cuda", dtype=torch.int32)
        yield label, SimpleNamespace(attrs=dict(soa.attrs, state=state),
                                     valid=soa.valid), geom
    sim = cs.make_sim(cs.ep.behavior(), interior=cs.MAIN_INTERIOR,
                      cap=cs.EPI_CAP, boundary="toroidal", dt=1.0,
                      sweep_backend="auto", device="cuda")
    cs.ep.init(sim, cs.SIM_AGENTS, cs.SIM_INFECTED, seed=0)
    sim.run(1)
    soa, geom = cs.aura_block(sim), sim.geom
    del sim
    yield "epi", soa, geom


def one(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch = cs.torch
    cs._build.load_all(["pair_sweep"])
    out = {"root": str(root), "ms": {},
           "registers": registers(cs._build.BUILDS["pair_sweep"].log)}
    for label, soa, geom in soas(cs, torch):
        for law, (_, pattrs, _) in cs.LAW_ARGS.items():
            if not set(pattrs) <= set(soa.attrs):
                continue
            ms = cs.cuda_ms(lambda: cs.kernel_call(soa, geom, law), REPS)
            out["ms"][f"{law}@{label}"] = ms
            print(f"[sweep_ab] {root.name or root}: {law}@{label} "
                  f"{ms:.4f} ms", file=sys.stderr, flush=True)
        del soa
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(Path(argv[1]).resolve())))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    runs, failed = [], []
    for root in argv:
        p = subprocess.run([sys.executable, __file__, "--one", root],
                           capture_output=True, text=True)
        if p.returncode != 0:
            print(f"[sweep_ab] {root} failed:\n{p.stdout}{p.stderr}",
                  file=sys.stderr)
            failed.append(root)
            continue
        run = json.loads(p.stdout.strip().splitlines()[-1])
        for name, regs, spill in run["registers"]:
            print(f"[registers] {run['root']}: {regs} ({spill} B spilled) "
                  f"{name}")
        for law, ms in run["ms"].items():
            print(f"[sweep_ab] {run['root']}: {law} {ms:.4f} ms",
                  flush=True)
        runs.append(run)
    print(card)
    print(json.dumps({"card": card, "reps": REPS, "runs": runs,
                      "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
