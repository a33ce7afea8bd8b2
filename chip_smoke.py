#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run it from the repository root; it imports ``repro_torch``, ``torch`` and
``numpy`` only.  Phases, each printing its own lines:

1. card: torch/CUDA versions, the card's name and power limit;
2. build: compile the ``pair_sweep`` kernel from ``csrc/`` (timed);
3. kernel against its plain version on a (128, 128) grid, cap 24, ~6
   agents a cell, both pair laws, closed and toroidal: forces to 1e-5,
   counts exactly;
4. main path: ``cell_clustering`` through ``Simulation`` on the card at
   (2048, 2048) cells, cap 48, 16,777,216 agents, 10 steps, with the
   clustering metric before and after; first the kernel against its plain
   version (and both timed) on the main path's own SoA, then the counts
   are zeroed and the path is driven; agents conserved, nothing dropped,
   finite positions, 10 + 2 kernel launches; then device time by
   kernel over one more step (``torch.profiler``);
5. end-to-end parity on the card, (16, 16) cells, 1000 agents, 8 steps,
   ``sweep_backend="kernel"`` against ``"tiled"``.

The last three lines are the card (``nvidia-smi``), one JSON line per
kernel and the result line.  Exits nonzero without a result line when
there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.engine import total_agents  # noqa: E402
from repro_torch.core.grid import clear_ring  # noqa: E402
from repro_torch.core.halo import LocalComm, halo_exchange  # noqa: E402
from repro_torch.core.neighbors import minimum_image_box  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import neighbor_interaction as ni  # noqa: E402
from repro_torch.sims import cell_clustering as cc  # noqa: E402
from repro_torch.sims.common import make_sim  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Float operations the kernel does per pair (see csrc/pair_sweep.cu): the
# distance test on every pair of occupied, distinct slots (2 subtractions,
# 2 multiplies, 2 adds, 1 compare), then the law on pairs within radius.
OPS_DISTANCE_TEST = 7
OPS_LAW = {"soft_repulsion_adhesion": 20, "same_type": 3}

LAW_ARGS = {   # law -> (pair_fn, pair_attrs, params)
    "soft_repulsion_adhesion": (
        cc.behavior().pair_fn, cc.behavior().pair_attrs,
        dict(cc.behavior().params)),
    "same_type": (cc._same_type_pair, ("ctype",), {}),
}
COUNT_OUTPUTS = ("same", "cnt")

SMALL_INTERIOR = (128, 128)   # phase 3 grid, ~6 agents a cell
MAIN_INTERIOR = (2048, 2048)  # phase 4 grid, 4 agents a cell
# Slot capacity of the main path.  The sims' default of 24 overflows here:
# ten steps of clustering squeeze the fullest of the 4.2M cells past 24,
# and past 32, agents (runs on an H100 dropped 2738 agents at cap 24 and
# 24 at cap 32; the JAX reference has the same physics), and the
# repository treats any drop as a mis-sized grid.
MAIN_CAP = 48
MAIN_STEPS = 10


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events),
    after one warm-up call unless ``warmup`` is False."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_call(soa, geom, law):
    pair_fn, pattrs, params = LAW_ARGS[law]
    return ni.pair_sweep(soa.attrs, soa.valid, pair_fn=pair_fn,
                         pair_attrs=pattrs, radius=2.0, params=params,
                         box=minimum_image_box(geom))


def plain_call(soa, geom, law, rows_per_chunk: int):
    """The plain version over the whole grid, ``rows_per_chunk`` interior
    rows at a time (its (C, K, 3^D K) temporaries would not fit at once)."""
    pair_fn, pattrs, params = LAW_ARGS[law]
    n0 = geom.interior[0]
    parts = []
    for r0 in range(0, n0, rows_per_chunk):
        ai, aj, vi, vj = ni.neighborhood_slabs(
            soa.attrs, soa.valid, pattrs,
            rows=(r0, min(n0, r0 + rows_per_chunk)))
        parts.append(ni.pair_sweep_plain(
            ai, aj, vi, vj, pair_fn=pair_fn, radius=2.0, params=params,
            box=minimum_image_box(geom)))
    k = geom.cap
    return {n: torch.cat([p[n] for p in parts]).reshape(
        geom.interior + (k,) + tuple(parts[0][n].shape[2:]))
        for n in parts[0]}


def occupied_pairs(soa, geom) -> int:
    """Pairs of distinct occupied slots over every interior cell and its
    3^D neighbourhood: what the kernel's distance test runs on."""
    occ = soa.valid.sum(dim=-1, dtype=torch.int64)
    shape = geom.local_shape
    inner = tuple(slice(1, h - 1) for h in shape)
    nbr = torch.zeros_like(occ[inner])
    for off in np.ndindex(*(3,) * geom.ndim):
        nbr += occ[tuple(slice(o, h - 2 + o) for o, h in zip(off, shape))]
    return int((occ[inner] * nbr).sum() - occ[inner].sum())


def bound(soa, geom, law, in_radius_pairs: int):
    """(bound_ms, bound_by, bytes, ops) of one sweep on this SoA, counting
    what this data needs: every slot's valid flag, the law's columns of the
    occupied slots (each read once), every interior output written once,
    and the float operations on the occupied pairs."""
    pl = ni.law_for(LAW_ARGS[law][0])
    cols = 4 * geom.ndim + 4 + 4      # pos, gid_rank, gid_count
    cols += 4 * ((pl.float_col is not None) + (pl.int_col is not None))
    out_floats = sum(geom.ndim if per_axis else 1
                     for _, per_axis in pl.outputs)
    nbytes = (soa.valid.numel() + int(soa.valid.sum()) * cols
              + math.prod(geom.interior) * geom.cap * out_floats * 4)
    ops = OPS_DISTANCE_TEST * occupied_pairs(soa, geom) \
        + OPS_LAW[law] * in_radius_pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def compare(got, want, label):
    """Max abs error; forces within 1e-5 (abs and rel), counts exact."""
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape:
            fail(f"{label} {name}: shape {tuple(g.shape)} != "
                 f"{tuple(w.shape)}")
        err = float((g - w).abs().max()) if g.numel() else 0.0
        worst = max(worst, err)
        if name in COUNT_OUTPUTS:
            if not torch.equal(g, w):
                fail(f"{label} {name}: counts differ (max {err})")
        elif not torch.allclose(g, w, atol=1e-5, rtol=1e-5):
            fail(f"{label} {name}: max abs error {err} > 1e-5")
    return worst


def check_kernel(soa, geom, law, rows_per_chunk, reps, label):
    """Kernel vs plain version on ``soa``; both timed (the plain version
    once, the kernel over ``reps`` launches after a warm-up)."""
    before = sum(ni.LAUNCHES.values())
    got = kernel_call(soa, geom, law)
    torch.cuda.synchronize()
    if sum(ni.LAUNCHES.values()) != before + 1:
        fail(f"{label}: the launch counter did not move")
    want = {}
    plain_ms = cuda_ms(
        lambda: want.update(plain_call(soa, geom, law, rows_per_chunk)), 1,
        warmup=False)
    err = compare(got, want, f"{label} {law}")
    in_radius = (int(want["cnt"].sum(dtype=torch.float64))
                 if "cnt" in want else None)
    ms = cuda_ms(lambda: kernel_call(soa, geom, law), reps)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms), in_radius


def law_rows(soa, geom, rows_per_chunk, reps, label):
    """Both laws checked and timed on ``soa`` with their bounds."""
    res_same, in_radius = check_kernel(soa, geom, "same_type",
                                       rows_per_chunk, reps, label)
    res_soft, _ = check_kernel(soa, geom, "soft_repulsion_adhesion",
                               rows_per_chunk, reps, label)
    rows = {}
    for law, res in (("soft_repulsion_adhesion", res_soft),
                     ("same_type", res_same)):
        b_ms, b_by, nbytes, ops = bound(soa, geom, law, in_radius)
        rows[law] = dict(res, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         ops=ops)
        print(f"[{label}] {law}: max_abs_err={res['max_abs_err']:.3g} "
              f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}; {nbytes} B, {ops} ops)",
              flush=True)
    return rows


def phase_small(seed: int):
    """Phase 3: (128, 128) cells, cap 24, ~6 agents a cell."""
    rows = {}
    for boundary in ("closed", "toroidal"):
        sim = make_sim(cc.behavior(), interior=SMALL_INTERIOR,
                       boundary=boundary, device="cuda")
        cc.init(sim, 6 * math.prod(SMALL_INTERIOR), seed=seed)
        sim.run(1)        # a mid-run SoA, then its aura as the step sees it
        refs = {d: {f: v[0, 0] for f, v in s.items()}
                for d, s in sim.state.refs.items()}
        soa, _, _, _ = halo_exchange(
            sim.geom, clear_ring(sim.state.soa),
            LocalComm(toroidal=sim.geom.toroidal), refs,
            sim.engine.delta_cfg, True)
        rows[boundary] = law_rows(soa, sim.geom, rows_per_chunk=32,
                                  reps=20, label=f"small {boundary}")
    return rows


def phase_main(seed: int):
    """Phase 4: the main path at full size."""
    steps = MAIN_STEPS
    n_agents = 4 * math.prod(MAIN_INTERIOR)
    t0 = time.perf_counter()
    sim = make_sim(cc.behavior(), interior=MAIN_INTERIOR, cap=MAIN_CAP,
                   sweep_backend="auto", device="cuda")
    cc.init(sim, n_agents, seed=seed)
    torch.cuda.synchronize()
    print(f"[main] init {n_agents} agents on {sim.geom.local_shape} x "
          f"{sim.geom.cap} slots: {time.perf_counter() - t0:.2f}s",
          flush=True)
    if sim.engine.sweep_backend != "auto":
        fail("main path is not on sweep_backend='auto'")

    rows = law_rows(sim.state.soa, sim.geom, rows_per_chunk=8, reps=10,
                    label="main")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ni.reset_launches()
    f0 = cc.same_type_fraction(sim.state, sim.engine)
    sim.run(1)                                   # step 1: warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    sim.run(steps - 1)
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t0
    f1 = cc.same_type_fraction(sim.state, sim.engine)
    launches = dict(ni.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    step_ms = start.elapsed_time(end) / (steps - 1)
    n = total_agents(sim.state)
    dropped = int(sim.state.dropped.sum())
    finite = bool(torch.isfinite(sim.state.soa.pos).all())
    fullest = int(sim.state.soa.valid.sum(dim=-1).max())
    print(f"[main] steps 2-{steps}: {step_ms:.3f} ms/step (CUDA events), "
          f"host {1e3 * host_s / (steps - 1):.3f} ms/step; "
          f"{n / (step_ms / 1e3):.4g} agent-updates/s", flush=True)
    soft_ms = rows["soft_repulsion_adhesion"]["ms"]
    print(f"[main] pair_sweep kernel (timed alone at this shape) "
          f"{soft_ms:.3f} ms = {100 * soft_ms / step_ms:.1f}% of a step; "
          f"peak device memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"[main] same_type_fraction {f0:.6f} -> {f1:.6f}; agents {n}; "
          f"dropped {dropped}; fullest cell {fullest}/{sim.geom.cap}; "
          f"launches {launches}", flush=True)
    if n != n_agents:
        fail(f"agents not conserved: {n} != {n_agents}")
    if dropped != 0:
        fail(f"{dropped} agents dropped")
    if not finite:
        fail("non-finite positions")
    expected = {"soft_repulsion_adhesion": steps, "same_type": 2}
    if launches != expected:
        fail(f"kernel launches {launches} != {expected}")
    if not 0.0 < f0 < 1.0 or not 0.0 < f1 < 1.0:
        fail(f"same_type_fraction out of range: {f0}, {f1}")
    profile_step(sim)
    return rows, launches, dict(step_ms=step_ms, peak_bytes=peak)


def profile_step(sim) -> None:
    """Device time by kernel over one more step (torch.profiler): only the
    device-side entries, so no time is counted twice."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run(1)
        torch.cuda.synchronize()

    def self_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and self_us(e) > 0]
    total = sum(self_us(e) for e in kernels)
    if total <= 0:
        print("[profile] no device time recorded: not measured", flush=True)
        return
    print(f"[profile] one step, {total / 1e3:.3f} ms of device kernels "
          f"({len(kernels)} kinds):", flush=True)
    for e in sorted(kernels, key=lambda e: -self_us(e))[:12]:
        print(f"[profile]   {self_us(e) / 1e3:9.3f} ms "
              f"{100 * self_us(e) / total:5.1f}% x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)


def phase_parity(seed: int):
    """Phase 5: kernel vs tiled end to end on the card."""
    sims = {b: cc.simulation(n_agents=1000, seed=seed, interior=(16, 16),
                             sweep_backend=b, device="cuda")
            for b in ("kernel", "tiled")}
    errs = {}
    for steps, tol in ((1, 1e-5), (7, 1e-4)):
        for s in sims.values():
            s.run(steps)
        it = sims["kernel"].iteration
        a, b = sims["kernel"].state, sims["tiled"].state
        if not torch.equal(a.soa.valid, b.soa.valid):
            fail(f"parity: valid differs after {it} steps")
        for name in ("gid_rank", "gid_count", "ctype", "diameter"):
            if not torch.equal(a.soa.attrs[name], b.soa.attrs[name]):
                fail(f"parity: {name} differs after {it} steps")
        err = float((a.soa.pos - b.soa.pos).abs().max())
        errs[it] = err
        print(f"[parity] after {it} steps: slot layout, valid, gids equal; "
              f"max |pos_kernel - pos_tiled| = {err:.3g} (limit {tol:g})",
              flush=True)
        if err > tol:
            fail(f"parity: positions differ by {err} > {tol}")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    card = card_line()
    print(f"[card] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {card}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load("pair_sweep")
    built = _build.BUILDS["pair_sweep"]
    print(f"[build] pair_sweep: {built.path.name} in "
          f"{time.perf_counter() - t0:.2f}s (nvcc {built.seconds:.2f}s)",
          flush=True)
    for line in built.log.splitlines():
        if "ptxas" in line:
            print(f"[build]   {line.strip()}", flush=True)

    small = phase_small(args.seed)
    rows, launches, main_stats = phase_main(args.seed)
    parity = phase_parity(args.seed)

    soft, same = rows["soft_repulsion_adhesion"], rows["same_type"]
    kernel = {
        "name": "pair_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pair_sweep.cu",
        "replaces": "src/repro/kernels/neighbor_interaction.py:92",
        "tpu": "repro/kernels/neighbor_interaction.py:pair_sweep_kernel",
        "launches": sum(launches.values()),
        "max_abs_err": max(soft["max_abs_err"], same["max_abs_err"]),
        "max_err": max(soft["max_abs_err"], same["max_abs_err"]),
        # the per-step law at the main-path shape; both laws under "laws"
        "law": "soft_repulsion_adhesion",
        "ms": soft["ms"], "plain_ms": soft["plain_ms"],
        "bound_ms": soft["bound_ms"], "bound_by": soft["bound_by"],
        "library_ms": None,
        "laws": {law: dict(r, launches=launches[law])
                 for law, r in rows.items()},
        "small_128x128": small,
        "step_ms": main_stats["step_ms"],
        "peak_device_bytes": main_stats["peak_bytes"],
        "parity_pos_err": parity,
    }
    print(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
