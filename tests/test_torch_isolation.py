"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, nothing falls back from the card to the
CPU, a CPU tensor never counts as a kernel launch, and the CLI runs on the
CPU when asked to."""

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    # One OpenMP thread: beside busy test workers, torch's spinning thread
    # pool slowed the small CLI runs here a hundredfold.
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run(args, cwd=ROOT, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_and_chip_smoke_imports_leave_jax_and_repro_out():
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {str(SMOKE)!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("BAD", bad)
        print("N", len([n for n in sys.modules
                        if n.startswith("repro_torch.")]))
    """)
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("N ")[1].split()[0])
    assert n >= 34                    # every module of the slices imported


def test_no_jax_or_repro_import_in_the_port_sources():
    files = sorted(PORT.rglob("*.py")) + [SMOKE]
    assert len(files) > 30
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.core import Simulation
    from repro_torch.sims import cell_clustering as cc

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulation(dict(interior=(6, 6)), cc.behavior())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cc.simulation(n_agents=50, interior=(6, 6))
    from repro_torch.configs import get
    from repro_torch.models import params as P
    from repro_torch.models.model import build_model

    model = build_model(get("olmo-1b").smoke)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.init(model.spec, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(2, 16)
    out = _run(["-m", "repro_torch.launch.simulate", "--sim",
                "cell_clustering", "--agents", "50", "--steps", "1"])
    assert out.returncode != 0 and "agent_updates" not in out.stdout


def test_cpu_tensor_never_counts_as_a_launch():
    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import neighbor_interaction as ni
    from repro_torch.kernels import ops
    from repro_torch.models import params as P
    from repro_torch.models.model import build_model
    from repro_torch.sims import cell_clustering as cc
    from repro_torch.training.steps import loss_fn

    before = {**ni.LAUNCHES, **fa.LAUNCHES}
    sim = cc.simulation(n_agents=120, interior=(6, 6), device="cpu",
                        sweep_backend="kernel")
    sim.run(2)
    frac = cc.same_type_fraction(sim.state, sim.engine)
    assert 0.0 < frac < 1.0
    g = torch.Generator().manual_seed(0)
    c, k = 4, 8
    slabs = [torch.rand((c, n, 2), generator=g) for n in (k, 9 * k)]
    side = {n: (torch.rand((c, n), generator=g) + 0.5,
                torch.zeros((c, n), dtype=torch.int32),
                torch.ones((c, n), dtype=torch.bool),
                torch.arange(c * n, dtype=torch.int32).reshape(c, n))
            for n in (k, 9 * k)}
    force = ops.neighbor_force(slabs[0], *side[k], slabs[1], *side[9 * k],
                               radius=2.0, repulsion=2.0, adhesion=0.4)
    assert force.shape == (c, k, 2) and bool(torch.isfinite(force).all())
    model = build_model(get("olmo-1b").smoke)
    params = P.init(model.spec, g, device="cpu")
    tokens = torch.randint(0, 256, (2, 128), generator=g)
    loss = loss_fn(model, params, {"tokens": tokens, "labels": tokens},
                   backend="kernel")
    assert bool(torch.isfinite(loss))
    assert {**ni.LAUNCHES, **fa.LAUNCHES} == before


def test_cli_smoke_on_cpu():
    out = _run(["-m", "repro_torch.launch.simulate", "--sim",
                "cell_clustering", "--device", "cpu", "--agents", "300",
                "--steps", "4"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("sim=cell_clustering devices=1 agents=300 "
                               "steps=4")
    assert lines[1].startswith("aura bytes/iter=") and "dropped=0" in lines[1]
    assert lines[-1].startswith("kernel launches: ")
    laws = ("soft_repulsion_adhesion", "same_type", "epidemiology",
            "oncology", "crowd", "gated_epidemiology",
            "stack(soft_repulsion_adhesion,epidemiology)",
            "stack(soft_repulsion_adhesion,crowd)",
            "stack(soft_repulsion_adhesion,gated_epidemiology)")
    # each law's full-block launches and its face bands' (the overlapped
    # sweep's), apart
    assert set(lines[-1].split(": ")[1].split(", ")) == {
        f"{law}{tag}=0" for law in laws for tag in ("", "@face")} | {
        "neighbor_force=0", "neighborhood_pair_sweep=0", "delta_encode=0",
        "delta_decode=0", "migration_pos_encode=0",
        "migration_pos_decode=0"}
    mesh = _run(["-m", "repro_torch.launch.simulate", "--sim",
                 "cell_clustering", "--device", "cpu", "--agents", "300",
                 "--steps", "3", "--mesh", "2x2", "--delta", "int8+mig"])
    assert mesh.returncode == 0, mesh.stderr
    lines = mesh.stdout.splitlines()
    assert lines[0].startswith("sim=cell_clustering devices=4 agents=300 ")
    assert "dropped=0 codec_overflow=0" in lines[1]
    # --rebalance is ported (tests/test_torch_reshard.py runs it on a
    # mesh): on one device every check finds nothing to balance
    one = _run(["-m", "repro_torch.launch.simulate", "--sim",
                "cell_clustering", "--device", "cpu", "--agents", "100",
                "--steps", "3", "--rebalance", "2"])
    assert one.returncode == 0, one.stderr
    assert one.stdout.startswith("sim=cell_clustering devices=1 agents=100 ")
    # a mesh must have the sim's axis count (an all-ones one broadcasts)
    bad = _run(["-m", "repro_torch.launch.simulate", "--sim",
                "tumor_spheroid", "--device", "cpu", "--mesh", "2x2"])
    assert bad.returncode != 0 and "is 3-D" in bad.stderr


@pytest.mark.parametrize("mesh", ["1x1", "2x2x2"])
def test_cli_runs_tumor_spheroid_on_cpu(mesh):
    """The 3-D sim through the CLI: on one device (``--mesh 1x1``
    broadcasts to three axes) and on the 2x2x2 virtual mesh."""
    out = _run(["-m", "repro_torch.launch.simulate", "--sim",
                "tumor_spheroid", "--device", "cpu", "--agents", "40",
                "--steps", "3", "--interior", "8", "--mesh", mesh])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    n_dev = 8 if mesh == "2x2x2" else 1
    assert lines[0].startswith(f"sim=tumor_spheroid devices={n_dev} ")
    assert "dropped=0 codec_overflow=0" in lines[1]
    assert lines[-1].startswith("kernel launches: ")


@pytest.mark.parametrize("sim", ["epidemiology", "sir_mechanics",
                                 "cell_proliferation", "oncology"])
def test_cli_runs_the_rng_sims_on_cpu(sim):
    out = _run(["-m", "repro_torch.launch.simulate", "--sim", sim,
                "--device", "cpu", "--agents", "60", "--steps", "3"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"sim={sim} devices=1 agents=")
    assert "dropped=0" in lines[1]
    assert lines[-1].startswith("kernel launches: ")


# The reference's serve smoke (python -m repro.launch.serve --smoke) prints
# these frames: three sir_mechanics requests of 200 agents, seeds 0-2.
SERVE_SMOKE_FRAMES = [
    "  req 0 beta=0.02: t=4:[174, 18, 8] t=8:[170, 13, 17] "
    "t=12:[161, 16, 23]",
    "  req 1 beta=0.05: t=4:[150, 38, 12] t=8:[117, 52, 31] "
    "t=12:[89, 63, 48]",
    "  req 2 beta=0.08: t=4:[122, 65, 13] t=8:[60, 86, 54] "
    "t=12:[37, 68, 95]",
]


def test_serve_smoke_on_cpu_prints_the_reference_lines():
    out = _run(["-m", "repro_torch.launch.serve", "--smoke", "--device",
                "cpu"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "rejected incompatible request with diagnostic:"
    assert lines[1].startswith("  error: ensemble-factory-static [")
    assert lines[2:5] == SERVE_SMOKE_FRAMES
    assert lines[5] == ("serve smoke OK: 1 batch at occupancy 0.75, runner "
                        "cache 2h/1m")


def test_serve_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    out = _run(["-m", "repro_torch.launch.serve", "--smoke"])
    assert out.returncode != 0 and "device='cpu'" in out.stderr
    assert "serve smoke OK" not in out.stdout


def test_ensemble_modules_leave_jax_and_repro_out():
    mods = ["repro_torch.core.compile_cache", "repro_torch.core.ensemble",
            "repro_torch.analysis", "repro_torch.launch.serve",
            "repro_torch.sims.sir_mechanics", "repro_torch.bridge"]
    code = "import sys\n" + "".join(f"import {m}\n" for m in mods) + (
        "print(sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _result_line(stdout: str):
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def test_chip_smoke_fails_without_a_gpu_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = _run([str(SMOKE)])
    assert out.returncode != 0 and _result_line(out.stdout) is None
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and _result_line(out.stdout) is None


def test_bridge_round_trip_is_exact():
    from repro_torch.bridge import state_from_arrays, state_to_arrays
    from repro_torch.sims import cell_clustering as cc

    sim = cc.simulation(n_agents=100, interior=(6, 6), device="cpu")
    sim.run(1)
    arrays = state_to_arrays(sim.state)
    arrays["key"] = np.array([[[7, 2**32 - 1]]], np.uint32)
    back = state_to_arrays(state_from_arrays(arrays, device="cpu"))
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
