"""Device times of the delta codec's four kernels, compared between source
trees on one card, on the calls the engine really makes.

First, in a process of its own, this checkout's ``chip_smoke.py`` drives
the two mesh paths whose calls its phase 7 checks - the 2x2 mesh of
16,777,216 ``cell_clustering`` agents (int8 aura codec, int16 migration
codec) and ``tumor_spheroid``'s 2x2x2 mesh (int16 and int16) - from the
same seed to the same delta step, records the inputs of every codec call
of that step (both encoders, both decoders) and saves them under
``build/codec_ab/`` (gitignored); and drives phase 8's 2x1 toroidal mesh
to its last step and records that step's position decode calls, whose
toroidal wrap takes the seam's ``at_l``.  It prints what the calls hold:
the share of zero deltas (unchanged slots) in the delta encode's slabs and
the share of live rows in the position encode's payloads.

Then, for each tree given, in the order given (for an A/B: parent,
change, change, parent), a process of its own imports that tree's
``repro_torch``, builds its ``delta_codec`` library (each codec kernel's
registers and spills from nvcc's ptxas report are printed) and replays
those calls a mesh at a time:

* ``delta_encode`` as recorded (the adaptive scale);
* ``delta_encode`` on the same slabs at a fixed scale, the largest scale
  the recorded calls chose (the engine's path never fixes it; a user may,
  through ``DeltaConfig.scale``);
* ``migration_pos_encode``, ``delta_decode`` and ``migration_pos_decode``
  as recorded;
* on the torus, ``migration_pos_decode`` with ``at_l``, or, in a tree
  whose decode takes no ``at_l``, the decode followed by the engine's
  seam repair as that tree ran it (``p == L``, ``torch.where``).

Each step's calls are timed by torch.profiler's device time (every kernel
and memset they enqueue, and their count) over TRACES traces of one
step's calls, of which only those holding the most events are used (the
profiler drops events now and then, never adds one), and by CUDA events
around REPS steps back to back, both given a call.  After the trees, the
floor of a launch: empty kernels of 256 threads with 0, 1 and 2
``cg::this_grid().sync()`` and a plain launch, at 4 to 528 blocks (source
inline, built with nvcc into ``build/codec_ab/``).  Last it prints a JSON
object with what the calls hold, every run's times and the floor beside
the card's name and power limit.  It needs a CUDA card and nvcc:

    python3 tools/codec_ab.py PARENT_ROOT . . PARENT_ROOT

A tree is a checkout's root (the directory holding ``src/``), for example
the parent commit unpacked by ``git archive`` into a gitignored directory.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = ROOT / "build" / "codec_ab"
MESHES = ("2d", "3d")
ENCODERS = ("delta_encode", "migration_pos_encode")
CODEC = ("delta_encode", "delta_decode", "migration_pos_encode",
         "migration_pos_decode")
SEED = 0
REPS = 50
# Profiler traces of one step's calls, and how many of them must hold
# every event for a time to be given.
TRACES = 30
MIN_COMPLETE = 10


def chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (it imports this
    checkout's ``repro_torch``: never in a process that replays a tree)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def record(out_dir: Path) -> dict:
    """Drives this checkout's two mesh paths to phase 7's recorded step and
    saves the codec calls of that step, ``calls_<mesh>.pt``: per wrapper a
    list of ``(args, kwargs)``, and the fixed scale of the replay; and the
    torus's last step's position decode calls, ``calls_torus.pt``.
    Returns what the calls hold."""
    cs = chip_smoke()
    torch = cs.torch
    cs._build.load_all(["pair_sweep", "delta_codec"])
    out_dir.mkdir(parents=True, exist_ok=True)

    def mesh_2d():
        sim = cs.make_sim(cs.cc.behavior(), interior=cs.MESH_INTERIOR,
                          mesh_shape=cs.MESH_SHAPE, cap=cs.MAIN_CAP,
                          delta=cs.MESH_DELTA, sweep_backend="auto",
                          device="cuda")
        cs.cc.init(sim, 4 * cs.math.prod(cs.MAIN_INTERIOR), seed=SEED)
        sim.run(cs.MAIN_STEPS + 1)      # phase 6's steps and its profile
        return sim

    def mesh_3d():
        interior = tuple(n // m for n, m in zip(cs.SPH_INTERIOR,
                                                cs.SPH_MESH))
        sim = cs.make_sim(cs.ts.behavior(), interior=interior,
                          mesh_shape=cs.SPH_MESH, cap=cs.SPH_CAP,
                          delta=cs.SPH_MESH_DELTA, sweep_backend="auto",
                          device="cuda")
        cs.seed_spheroid(sim, SEED)
        sim.run(cs.SPH_MESH_STEPS)      # phase 13 c's steps
        return sim

    held = {}
    for mesh, build in (("2d", mesh_2d), ("3d", mesh_3d)):
        sim = build()
        if sim.iteration % sim.engine.delta_cfg.refresh_interval == 0:
            raise SystemExit(f"codec_ab: the {mesh} step would be a full "
                             "refresh")
        with cs.Capture(cs.dc, CODEC) as cap:
            sim.run(1)
            torch.cuda.synchronize()
        del sim
        held[mesh] = dict(cs.codec_traffic(n, cap.calls[n])
                          for n in ENCODERS)
        held[mesh]["calls"] = {n: len(cap.calls[n]) for n in CODEC}
        fixed = max(float(out[1].max()) for _, _, out in
                    cap.calls["delta_encode"])
        held[mesh]["fixed_scale"] = fixed
        torch.save({"fixed_scale": fixed,
                    **{n: [(a, kw) for a, kw, _ in cap.calls[n]]
                       for n in CODEC}}, out_dir / f"calls_{mesh}.pt")
        del cap
        cs.gc.collect()
        torch.cuda.empty_cache()
    sim = cs.torus_sim(SEED)
    sim.run(cs.TORUS_STEPS - 1)
    with cs.Capture(cs.dc, ["migration_pos_decode"]) as cap:
        sim.run(1)
        torch.cuda.synchronize()
    rec = [(a, kw) for a, kw, _ in cap.calls["migration_pos_decode"]]
    held["torus"] = {"calls": {"migration_pos_decode": len(rec)}}
    torch.save({"migration_pos_decode": rec}, out_dir / "calls_torus.pt")
    return held


def profiled(torch, fn, k):
    """(device ms a call, device operations a call, complete traces) of
    ``fn`` - k calls - from the TRACES traces of one ``fn()`` that hold the
    most device events; (None, None, n) when fewer than MIN_COMPLETE do."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    traces = []
    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and getattr(e, "self_device_time_total", 0) > 0]
        traces.append((sum(e.count for e in events),
                       sum(e.self_device_time_total for e in events)))
    full = max(n for n, _ in traces)
    times = [us for n, us in traces if n == full]
    if full == 0 or len(times) < MIN_COMPLETE:
        return None, None, len(times)
    return sum(times) / len(times) / 1e3 / k, full / k, len(times)


def event_ms(torch, fn, reps):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def pos_decode_calls(torch, dc, recorded):
    """One callable a recorded position decode call, as the tree runs it:
    as recorded, or, where the tree's decode takes no ``at_l``, without it
    on a call with no toroidal axis (where it changes nothing) and
    otherwise the decode followed by that tree's engine's seam repair (its
    device tensors made here, outside the timed calls, as the engine made
    them once a migration)."""
    import inspect

    import numpy as np

    takes = "at_l" in inspect.signature(dc.migration_pos_decode).parameters
    calls = []
    for a, kw in recorded:
        rest = {k: v for k, v in kw.items() if k != "at_l"}
        tor = tuple(kw.get("toroidal", ()))
        if takes or not any(tor) or kw.get("at_l") is None:
            calls.append(lambda a=a, kw=(kw if takes else rest):
                         dc.migration_pos_decode(*a, **kw))
            continue
        dev = a[0].device
        lsz = torch.as_tensor(np.asarray(kw["lsz"], np.float32), device=dev)
        tor_t = None if all(tor) else torch.tensor(tor, device=dev)
        at = torch.as_tensor(np.asarray(kw["at_l"], np.float32), device=dev)

        def call(a=a, rest=rest, lsz=lsz, tor_t=tor_t, at=at):
            p = dc.migration_pos_decode(*a, **rest)
            hit = p == lsz
            if tor_t is not None:
                hit &= tor_t
            return torch.where(hit, at, p)

        calls.append(call)
    return calls


def one(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import delta_codec as dc

    _build.load_all(["delta_codec"])
    out = {"root": str(root), "steps": [],
           "ptxas": _build.BUILDS["delta_codec"].log}

    def as_called(wrapper, recorded, **extra):
        return [lambda a=a, kw=kw: wrapper(*a, **dict(kw, **extra))
                for a, kw in recorded]

    for mesh in MESHES + ("torus",):
        calls = torch.load(CALLS / f"calls_{mesh}.pt", map_location="cuda",
                           weights_only=False)
        pos_decode = ("migration_pos_decode", pos_decode_calls(
            torch, dc, calls["migration_pos_decode"]))
        if mesh == "torus":
            cases = (pos_decode,)
        else:
            cases = (("delta_encode", as_called(dc.delta_encode,
                                                calls["delta_encode"])),
                     ("delta_encode:fixed", as_called(
                         dc.delta_encode, calls["delta_encode"],
                         scale=calls["fixed_scale"])),
                     *((n, as_called(getattr(dc, n), calls[n]))
                       for n in CODEC[1:3]),
                     pos_decode)
        for label, fns in cases:
            def fn(fns=fns):
                return [f() for f in fns]

            k = len(fns)
            dev_ms, ops, complete = profiled(torch, fn, k)
            row = dict(kernel=label, mesh=mesh, calls=k, device_ms=dev_ms,
                       device_ops=ops, complete_traces=complete,
                       event_ms=event_ms(torch, fn, REPS) / k)
            out["steps"].append(row)
            print(f"[codec_ab] {root.name or root}: {row}", file=sys.stderr,
                  flush=True)
        del calls, cases
        torch.cuda.empty_cache()
    return out


FLOOR_SRC = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
template <int S> __global__ void syncs(int* out) {
  for (int i = 0; i < S; ++i) cg::this_grid().sync();
  if (out != nullptr) out[0] = 1;
}
extern "C" int floor_launch(int s, int blocks, void* stream) {
  int* out = nullptr;
  void* args[] = {&out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 0) {
    syncs<0><<<blocks, 256, 0, st>>>(out);
    return cudaGetLastError();
  }
  const void* k = s == 0 ? (const void*)syncs<0>
                : s == 1 ? (const void*)syncs<1> : (const void*)syncs<2>;
  return cudaLaunchCooperativeKernel(k, dim3(blocks), dim3(256), args, 0, st);
}
"""
FLOOR_BLOCKS = (4, 132, 264, 528)
FLOOR_LAUNCHES = 20                  # launches a trace


def floor(root: Path) -> dict:
    """Device ms of an empty kernel: a plain launch (-1) and cooperative
    launches with 0, 1 and 2 grid syncs, at FLOOR_BLOCKS blocks."""
    import ctypes

    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import _build

    out_dir = CALLS
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "floor.cu").write_text(FLOOR_SRC)
    subprocess.run([_build.tool("nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(out_dir / "floor.so"),
                    str(out_dir / "floor.cu")], check=True)
    lib = ctypes.CDLL(str(out_dir / "floor.so"))
    lib.floor_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream

    def launch(s, blocks):
        if lib.floor_launch(s, blocks, stream) != 0:
            raise RuntimeError(f"floor kernel ({s} syncs, {blocks} blocks) "
                               "was refused")

    ms = {}
    for blocks in FLOOR_BLOCKS:
        for s in (-1, 0, 1, 2):
            ms[f"{s}@{blocks}"] = profiled(
                torch, lambda: [launch(s, blocks)
                                for _ in range(FLOOR_LAUNCHES)],
                FLOOR_LAUNCHES)[0]
    return ms


def main(argv) -> int:
    if len(argv) == 2 and argv[0] in ("--one", "--floor"):
        fn = one if argv[0] == "--one" else floor
        print(json.dumps(fn(Path(argv[1]).resolve())))
        return 0
    if argv == ["--record"]:
        print(json.dumps(record(CALLS)))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    p = subprocess.run([sys.executable, __file__, "--record"],
                       capture_output=True, text=True)
    if p.returncode != 0:
        print(f"[codec_ab] recording failed:\n{p.stdout}{p.stderr}",
              file=sys.stderr)
        return 1
    held = json.loads(p.stdout.strip().splitlines()[-1])
    for mesh, h in held.items():
        shares = "" if mesh == "torus" else (
            f"; zero deltas {h['zero_delta_share']!r} of the delta "
            f"encode's elements, live rows {h['live_row_share']!r} of the "
            f"position encode's; fixed scale {h['fixed_scale']!r}")
        print(f"[calls] {mesh}, one step: {h['calls']} calls{shares}",
              flush=True)
    registers = chip_smoke().codec_registers
    runs, failed = [], []
    for root in argv:
        p = subprocess.run([sys.executable, __file__, "--one", root],
                           capture_output=True, text=True)
        if p.returncode != 0:
            print(f"[codec_ab] {root} failed:\n{p.stdout}{p.stderr}",
                  file=sys.stderr)
            failed.append(root)
            continue
        run = json.loads(p.stdout.strip().splitlines()[-1])
        run["registers"] = registers(run.pop("ptxas"))
        for name, regs, spill in run["registers"]:
            print(f"[registers] {run['root']}: {regs} ({spill} B spilled) "
                  f"{name}")
        for r in run["steps"]:
            print(f"[codec_ab] {run['root']}: {r['kernel']} {r['mesh']}, "
                  f"a call of one step ({r['calls']} calls): "
                  f"device {r['device_ms']} ms, {r['device_ops']} device "
                  f"operations ({r['complete_traces']} of {TRACES} traces "
                  f"complete); events {r['event_ms']:.5f} ms", flush=True)
        runs.append(run)
    p = subprocess.run([sys.executable, __file__, "--floor", argv[-1]],
                       capture_output=True, text=True)
    if p.returncode != 0:
        print(f"[codec_ab] floor failed:\n{p.stdout}{p.stderr}",
              file=sys.stderr)
        failed.append("floor")
        floor_ms = None
    else:
        floor_ms = json.loads(p.stdout.strip().splitlines()[-1])
        for key, ms in floor_ms.items():
            syncs, blocks = key.split("@")
            kind = "plain launch" if syncs == "-1" else \
                f"cooperative, {syncs} grid syncs"
            print(f"[floor] empty kernel, {blocks} blocks, {kind}: {ms} ms")
    print(card)
    print(json.dumps({"card": card, "calls": held, "traces": TRACES,
                      "reps": REPS, "runs": runs, "floor": floor_ms,
                      "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
