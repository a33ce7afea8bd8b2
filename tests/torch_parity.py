"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: the same
numpy inputs go through the JAX package and through its PyTorch port, and
the outputs are compared as numpy arrays.

Tolerances (the reference's own cross-backend ones, tests/test_sweep.py):
integers, bools, gids, ``valid``, the slot layout, ``dropped`` and
``halo_bytes`` exactly; float accumulators and positions to 1e-5 absolute
and relative; count-valued accumulators exactly.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import jax
import numpy as np
import torch

FLOAT_TOL = 1e-5

# torch 2.13's CPU build now and then computes the first multithreaded
# ``torch.sqrt`` of a process wrongly (errors up to ~2e-2 on large
# tensors; every later call is right): its vectorized kernel is set up
# lazily, racing its own threads.  One small call first sets it up.
torch.sqrt(torch.ones(8))


@contextlib.contextmanager
def torch_threads(n: int):
    """``n`` intra-op threads inside the block.  The port's per-device and
    per-lane loops run many ops on small tensors, and beside busy test
    workers torch's thread pool slows them a hundredfold."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def jax_state_arrays(state) -> Dict[str, np.ndarray]:
    """A JAX ``SimState`` as the field-path dict of ``repro_torch.bridge``."""
    out: Dict[str, np.ndarray] = {}
    for name, a in state.soa.attrs.items():
        out[f"soa.attrs.{name}"] = np.asarray(a)
    out["soa.valid"] = np.asarray(state.soa.valid)
    for edge, slab in state.refs.items():
        for field, a in slab.items():
            out[f"refs.{edge}.{field}"] = np.asarray(a)
    for name in ("it", "key", "gid_counter", "dropped", "halo_bytes",
                 "codec_overflow", "health"):
        out[name] = np.asarray(getattr(state, name))
    return out


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(jax.device_get(x))


def assert_close(got, want, name: str = "", exact: bool = False) -> None:
    """Exact for non-float arrays (and when ``exact``), else FLOAT_TOL."""
    g, w = to_numpy(got), to_numpy(want)
    assert g.shape == w.shape, f"{name}: shape {g.shape} != {w.shape}"
    assert g.dtype == w.dtype, f"{name}: dtype {g.dtype} != {w.dtype}"
    if exact or not np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(g, w, err_msg=name)
    else:
        np.testing.assert_allclose(g, w, atol=FLOAT_TOL, rtol=FLOAT_TOL,
                                   err_msg=name)


def assert_dicts_close(got: Dict, want: Dict, exact_keys=(),
                       skip=()) -> None:
    keys = set(want) - set(skip)
    assert set(got) - set(skip) == keys, sorted(set(got) ^ set(want))
    for k in sorted(keys):
        assert_close(got[k], want[k], name=k, exact=k in exact_keys)


def assert_states_match(port_state, jax_state, skip=()) -> None:
    """Every field of the two states, the RNG ``key`` included (the port's
    threefry keys are JAX's bit for bit)."""
    from repro_torch.bridge import state_to_arrays

    assert_dicts_close(state_to_arrays(port_state),
                       jax_state_arrays(jax_state), skip=skip)


def soa_inputs(n: int, ndim: int, size, seed: int = 0):
    """Seeded numpy positions inside ``size`` and cell_clustering attrs."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.5, np.asarray(size) - 0.5,
                      (n, ndim)).astype(np.float32)
    attrs = {
        "diameter": rng.uniform(0.6, 1.4, n).astype(np.float32),
        "ctype": rng.integers(0, 2, n).astype(np.int32),
    }
    return pos, attrs


# ---------------------------------------------------------------------------
# Bundled sims on a mesh against JAX's sharded per-step engine
# ---------------------------------------------------------------------------

# One subprocess with four XLA host devices records, for every case, JAX's
# state after each of its steps (``make_sharded_step``, never the fused
# runner: its sharded segments are not bit-exact under jax 0.9.0).  A case
# is a dict: ``sim`` (a module of ``sims``), ``make`` (``make_sim``
# keywords; ``widths`` becomes an uneven ``Partition``), ``codec`` (the
# ``delta`` shorthand), ``init`` (the sim's ``init`` arguments after the
# facade) and ``steps``.  With the codec off every step is a full aura
# refresh; with it on every step is a delta step, the first one from the
# init state's zero references.  A codec case so compiles one step, not
# two (a full refresh through the codec is the codec-off exchange), and
# the compiles are most of the subprocess's time: JAX's reference sweep
# (its parity oracle) compiles faster than its tiled one.
MESH_ORACLE = """
import importlib
import sys
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import Partition
from repro.core.domain import spatial_axis_names
from repro.sims.common import make_sim
sys.path.insert(0, {tests!r})
from torch_parity import jax_state_arrays, make_kwargs


def run(name, case):
    out = {{}}
    mod = importlib.import_module("repro.sims." + case["sim"])
    sim = make_sim(mod.behavior(), sweep_backend="reference",
                   **make_kwargs(case, Partition))
    mod.init(sim, *case["init"])
    s = sim.state
    for k, v in jax_state_arrays(s).items():
        out[f"{{name}}/0/{{k}}"] = v
    mesh = sim.mesh
    s = jax.device_put(s, NamedSharding(mesh, P(*spatial_axis_names(2))))
    step = sim.engine.make_sharded_step(mesh)
    for i in range(case["steps"]):
        s = step(s, full_halo=case["codec"] == "off")
        for k, v in jax_state_arrays(s).items():
            out[f"{{name}}/{{i + 1}}/{{k}}"] = v
    return out


# the cases compile concurrently (XLA releases the GIL while it compiles)
cases = {cases!r}
out = {{}}
with ThreadPoolExecutor({threads}) as pool:
    for part in pool.map(run, cases, cases.values()):
        out.update(part)
np.savez({path!r}, **out)
print("OK")
"""


def make_kwargs(case: dict, partition_cls) -> dict:
    """``make_sim`` keywords of a mesh case (either package's, with that
    package's ``Partition``)."""
    kw = dict(case["make"], delta=case["codec"])
    widths = kw.pop("widths", None)
    if widths is not None:
        kw["partition"] = partition_cls.from_widths(widths)
    return kw


def run_mesh_oracle(cases: dict, path: str, root: str, threads: int = 4
                    ) -> dict:
    """Run :data:`MESH_ORACLE` on ``cases`` in one subprocess (four XLA
    host devices, ``threads`` cases at a time); returns
    ``{"<case>/<step>/<field>": array}``."""
    import os
    import subprocess
    import sys
    import textwrap

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(root, "src")
    code = MESH_ORACLE.format(tests=os.path.join(root, "tests"),
                              cases=cases, path=path, threads=threads)
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=900, env=env)
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def oracle_state(oracle: dict, name: str, step: int) -> Dict[str, np.ndarray]:
    pre = f"{name}/{step}/"
    return {k[len(pre):]: v for k, v in oracle.items() if k.startswith(pre)}


def check_steps_like_oracle(oracle: dict, name: str, case: dict) -> list:
    """The port's facade on the case (its ``init`` state against JAX's),
    then each step from JAX's state before it against JAX's after it:
    integers, ``valid``, gids and the slot layout exactly, floats to
    ``FLOAT_TOL``.  Returns the live agent count after each step."""
    import importlib

    from repro_torch.bridge import state_from_arrays, state_to_arrays
    from repro_torch.core import Partition
    from repro_torch.sims.common import make_sim

    mod = importlib.import_module("repro_torch.sims." + case["sim"])
    sim = make_sim(mod.behavior(), sweep_backend="kernel", device="cpu",
                   **make_kwargs(case, Partition))
    mod.init(sim, *case["init"])
    assert_dicts_close(state_to_arrays(sim.state),
                       oracle_state(oracle, name, 0))
    step = sim.engine.make_local_step()
    counts = []
    for i in range(case["steps"]):
        got = step(state_from_arrays(oracle_state(oracle, name, i),
                                     device="cpu"),
                   full_halo=case["codec"] == "off")
        assert_dicts_close(state_to_arrays(got),
                           oracle_state(oracle, name, i + 1))
        counts.append(int(got.soa.valid.sum()))
    return counts


def jax_state_from_arrays(arrays: Dict[str, np.ndarray]):
    """The inverse of :func:`jax_state_arrays`: a JAX ``SimState`` from the
    field-path dict (e.g. ``repro_torch.bridge.state_to_arrays`` of a port
    state), every leaf a ``jnp`` array."""
    import jax.numpy as jnp
    from repro.core.agent_soa import AgentSoA as JSoA
    from repro.core.engine import SimState as JState

    attrs, refs = {}, {}
    for k, v in arrays.items():
        if k.startswith("soa.attrs."):
            attrs[k[len("soa.attrs."):]] = jnp.asarray(v)
        elif k.startswith("refs."):
            edge, field = k[len("refs."):].split(".", 1)
            refs.setdefault(edge, {})[field] = jnp.asarray(v)
    return JState(
        soa=JSoA(attrs=attrs, valid=jnp.asarray(arrays["soa.valid"])),
        refs=refs, **{n: jnp.asarray(arrays[n]) for n in (
            "it", "key", "gid_counter", "dropped", "halo_bytes",
            "codec_overflow", "health")})


# ---------------------------------------------------------------------------
# Re-shard and checkpoint cases: a clustered density on 16 x 16 cells
# ---------------------------------------------------------------------------

SKEWED_CENTERS = [(8.0, 8.0), (24.0, 24.0)]
UNEVEN = ((5, 11), (7, 9))


def clustered(n: int, seed: int):
    rng = np.random.default_rng(seed)
    c = np.asarray(SKEWED_CENTERS)[rng.integers(0, 2, n)]
    pos = np.clip(c + rng.normal(0.0, 3.0, (n, 2)), 0.5,
                  31.5).astype(np.float32)
    attrs = {"diameter": np.full((n,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, n).astype(np.int32)}
    return pos, attrs


def geoms(start: str, cap: int = 32):
    """The port's and JAX's Domain of a 16 x 16-cell start geometry."""
    from repro.core import Domain as JDomain
    from repro.core.domain import Partition as JPartition
    from repro_torch.core import Domain, Partition

    if start == "uneven":
        return (Domain(cell_size=2.0, interior=(11, 9), mesh_shape=(2, 2),
                       cap=cap, partition=Partition.from_widths(UNEVEN)),
                JDomain(cell_size=2.0, interior=(11, 9), mesh_shape=(2, 2),
                        cap=cap, partition=JPartition.from_widths(UNEVEN)))
    mesh = {"2x2": (2, 2), "1x1": (1, 1)}[start]
    kw = dict(cell_size=2.0, interior=(16 // mesh[0], 16 // mesh[1]),
              mesh_shape=mesh, cap=cap)
    return Domain(**kw), JDomain(**kw)
