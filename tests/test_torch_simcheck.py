"""The port's simcheck suite (``repro_torch.analysis``: the lint, the step
audit, ``Report``; ``Simulation.validate``; ``launch.simcheck``) against
the JAX package's (``repro.analysis``, ``repro.launch.simcheck``), on the
CPU and on one torch thread.

* tests/test_analysis.py's lint, audit, ``validate`` and CLI tests,
  mirrored on the port: the planted ``ppermute`` edge lists go to the
  port's edge checker (``step_audit.check_edges``), whose verdicts equal
  JAX's ``audit_fn`` on the same lists; the module lint equals JAX's
  field for field.
* Every shipped sim with its two virtual variants, and the
  ``sir_mechanics`` ensemble family: the multiset of (severity, contract,
  context) the port's bare ``simcheck --device cpu --strict`` reports
  equals JAX's ``check_sim_module`` / ``check_ensemble_module`` (computed
  once in a module fixture), less JAX's device-count notes (this process
  has one XLA device; the port's virtual mesh lacks none).  A context is
  a location less its ``file:line`` and whatever follows a step label.
* Planted faults - ``.item()``, a branch on a tensor, ``np`` and float64
  in an ``update_fn``, int16 arithmetic, a branch on a parameter and a
  host callback in an ensemble family - flagged under the same contracts
  by both packages (JAX's float64 case under ``jax.enable_x64``).
* ``hash(engine) == hash(dataclasses.replace(engine))``; ``validate``
  leaving the state and the launch counters bit-equal, on the virtual
  mesh and on four ranks of a process mesh; the probe's shifts covering
  every mesh axis and direction with the edges ``shift`` moves along.
* ROADMAP C 4: ``--delta off`` and ``--delta auto`` of the port's CLI on a
  2x2 mesh beside the reference's ``resolve_delta(None, 4)``.
* The deprecated ``make_engine`` / ``run_sim`` shims: the reference's
  warning text, and ``run_sim(mesh=)`` on a process mesh equal to the
  virtual mesh.
"""

import collections
import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import process_mesh_ranks as pmr
from repro import analysis as ja
from repro.core import AgentSchema as JSchema
from repro.core import Behavior as JBehavior
from repro.core import Domain as JDomain
from repro.core import Engine as JEngine
from repro.core import Simulation as JSimulation
from repro.core.behaviors import displacement_update as j_update
from repro.core.behaviors import soft_repulsion_adhesion as j_pair
from repro.core.ensemble import Ensemble as JEnsemble
from repro.launch import simcheck as jsimcheck
from repro.sims import common as jcommon
from repro_torch import analysis as ta
from repro_torch.analysis import step_audit
from repro_torch.bridge import assemble_ranks, state_to_arrays
from repro_torch.core import AgentSchema, Behavior, Domain, Partition
from repro_torch.core import Simulation
from repro_torch.core.behaviors import displacement_update as t_update
from repro_torch.core.behaviors import soft_repulsion_adhesion as t_pair
from repro_torch.core.engine import Engine
from repro_torch.core.ensemble import Ensemble
from repro_torch.core.halo import ring_edges
from repro_torch.kernels import delta_codec
from repro_torch.kernels import neighbor_interaction as ni
from repro_torch.launch import simcheck as tsimcheck
from repro_torch.launch import simulate as tsimulate
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.sims import cell_clustering as cc
from repro_torch.sims import common as tcommon
from torch_parity import torch_threads

SPAWN_TIMEOUT_S = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


# ---------------------------------------------------------------------------
# Both packages' objects
# ---------------------------------------------------------------------------

PARAMS = {"repulsion": 2.0, "adhesion": 0.4, "same_type_only": 1.0,
          "max_step": 0.5}


def mech(update=None, extra=None, params=None):
    """tests/test_analysis.py's mechanics behaviour in both packages, the
    port's update replaced by ``update[0]`` and JAX's by ``update[1]``;
    ``extra`` adds (name, shape, dtype name) schema fields."""
    spec_t = {"diameter": ((), torch.float32), "ctype": ((), torch.int32)}
    spec_j = {"diameter": ((), jnp.float32), "ctype": ((), jnp.int32)}
    for name, shape, dtype in extra or ():
        spec_t[name] = (shape, getattr(torch, dtype))
        spec_j[name] = (shape, getattr(jnp, dtype))
    p = dict(PARAMS if params is None else params)
    t = Behavior(schema=AgentSchema.create(spec_t), pair_fn=t_pair,
                 pair_attrs=("diameter", "ctype"),
                 update_fn=update[0] if update else t_update, radius=2.0,
                 params=p)
    j = JBehavior(schema=JSchema.create(spec_j), pair_fn=j_pair,
                  pair_attrs=("diameter", "ctype"),
                  update_fn=update[1] if update else j_update, radius=2.0,
                  params=p)
    return t, j


def contracts_of(diags):
    return {d.contract for d in diags}


def jax_mapped(diags):
    """JAX's findings less its device-count note (this process has one
    XLA device; the port's virtual mesh lacks none)."""
    return [d for d in diags if not (
        d.contract == "partition-validity" and d.severity == "info"
        and "devices but this host exposes" in d.message)]


_FILE_LINE = re.compile(r" \([^()]*\.py:\d+\)")
_STEP = re.compile(r"step\[\w+\]")


def context(location: str) -> str:
    """A location less its ``file:line`` parts and whatever follows a step
    label (the op: an aten op in the port, a primitive in JAX)."""
    loc = _FILE_LINE.sub("", location)
    m = _STEP.search(loc)
    return loc[:m.end()] if m else loc


def keys(diags):
    return collections.Counter(
        (d.severity, d.contract, context(d.location)) for d in diags)


# ---------------------------------------------------------------------------
# tests/test_analysis.py, section 4: planted edge lists
# ---------------------------------------------------------------------------

def _jax_ppermute(perm, axis="sx", size=2):
    x = jnp.zeros((4,), jnp.float32)
    return ja.audit_fn(lambda v: jax.lax.ppermute(v, axis, perm), x,
                       axis_env=(("sx", size),), context="planted")


def _reasons(diags):
    return [(d.severity, d.contract, d.message.rsplit(": ", 1)[-1])
            for d in diags]


@pytest.mark.parametrize("perm,size,reason", [
    ([(0, 1), (0, 0)], 2, "duplicate sources"),
    ([(0, 1), (1, 1)], 2, "duplicate destinations"),
    ([(0, 3)], 2, "indices outside [0, 2)"),
])
def test_edge_checker_flags_what_jax_flags(perm, size, reason):
    got = step_audit.check_edges(perm, "sx", {"sx": size}, "planted")
    assert len(got) == 1 and got[0].severity == "error"
    assert got[0].contract == step_audit.CONTRACT_COLLECTIVE
    assert reason in got[0].message
    assert _reasons(got) == _reasons(_jax_ppermute(perm, size=size))


def test_edge_checker_flags_a_dead_axis():
    got = step_audit.check_edges([(0, 1)], "zz", {"sx": 2})
    assert contracts_of(got) == {step_audit.CONTRACT_COLLECTIVE}
    assert "'zz'" in got[0].message
    want = _jax_ppermute([(0, 1)], axis="zz")
    assert contracts_of(want) == contracts_of(got)
    # a logged shift along an axis index off the mesh is a dead axis too
    got = step_audit.audit_edges([(2, 1, ((0, 1),))], (2, 2), "step")
    assert [d.severity for d in got] == ["error"]
    assert "'axis2'" in got[0].message


def test_edge_checker_accepts_partial_ring_permutation():
    # the open halo chain: 0->1, 1->2 (no wrap) - partial is legal
    assert not step_audit.check_edges([(0, 1), (1, 2)], "sx", {"sx": 3})
    assert not _jax_ppermute([(0, 1), (1, 2)], size=3)
    for size in (1, 2, 3):
        for tor in (False, True):
            for d in (-1, 1):
                assert not step_audit.check_edges(
                    ring_edges(size, d, tor), "sx", {"sx": size})


# ---------------------------------------------------------------------------
# Section 5: hidden host syncs in hot functions
# ---------------------------------------------------------------------------

def _item_update(attrs, valid, acc, key, params, dt):
    drift = attrs["diameter"].sum().item()   # a device->host read
    new = dict(attrs)
    new["diameter"] = attrs["diameter"] + drift
    return new, valid, torch.zeros_like(valid), None


def _j_item_update(attrs, valid, acc, key, params, dt):
    drift = attrs["diameter"].sum().item()   # traced -> host escape
    new = dict(attrs)
    new["diameter"] = attrs["diameter"] + drift
    return new, valid, jnp.zeros_like(valid), None


def _branch_update(attrs, valid, acc, key, params, dt):
    if valid.sum() > 0:   # a branch on a tensor
        return attrs, valid, torch.zeros_like(valid), None
    return attrs, valid, valid, None


def _j_branch_update(attrs, valid, acc, key, params, dt):
    if valid.sum() > 0:   # tracer branch
        return attrs, valid, jnp.zeros_like(valid), None
    return attrs, valid, valid, None


def _np_update(attrs, valid, acc, key, params, dt):
    new = dict(attrs)
    new["diameter"] = attrs["diameter"] + np.float32(1.0)
    return new, valid, torch.zeros_like(valid), None


def _j_np_update(attrs, valid, acc, key, params, dt):
    new = dict(attrs)
    new["diameter"] = attrs["diameter"] + np.float32(1.0)
    return new, valid, jnp.zeros_like(valid), None


def _f64_update(attrs, valid, acc, key, params, dt):
    new = dict(attrs)
    new["diameter"] = (attrs["diameter"].double() * 2.0).float()
    return new, valid, torch.zeros_like(valid), None


def _j_f64_update(attrs, valid, acc, key, params, dt):
    new = dict(attrs)
    new["diameter"] = (attrs["diameter"].astype(jnp.float64)
                       * 2.0).astype(jnp.float32)
    return new, valid, jnp.zeros_like(valid), None


def _i16_update(attrs, valid, acc, key, params, dt):
    new = dict(attrs)
    new["age"] = attrs["age"] + attrs["age"]
    return new, valid, torch.zeros_like(valid), None


def _j_i16_update(attrs, valid, acc, key, params, dt):
    new = dict(attrs)
    new["age"] = attrs["age"] + attrs["age"]
    return new, valid, jnp.zeros_like(valid), None


def test_lint_flags_planted_item_in_update_fn():
    beh, jbeh = mech((_item_update, _j_item_update))
    diags = ta.lint_behavior(beh)
    hits = [d for d in diags if d.contract == "hot-host-sync"]
    assert hits and all(d.severity == "error" for d in hits)
    assert any("update_fn" in d.location
               and "test_torch_simcheck.py" in d.location for d in hits)
    assert keys(diags) == keys(ja.lint_behavior(jbeh))


def test_audit_fn_converts_item_to_diagnostic():
    diags = ta.audit_fn(lambda v: v * v.sum().item(),
                        torch.ones((3,), dtype=torch.float32),
                        context="planted")
    assert [d.contract for d in diags] == ["host-sync"]
    assert diags[0].severity == "error"
    want = ja.audit_fn(lambda v: v * v.sum().item(),
                       jnp.ones((3,), jnp.float32), context="planted")
    assert keys(diags) == keys(want)


def test_lint_flags_python_branch_on_agent_data():
    diags = ta.lint_hot_fn(_branch_update, label="branchy")
    assert any(d.contract == "hot-python-branch" and d.severity == "error"
               for d in diags)
    assert keys(diags) == keys(ja.lint_hot_fn(_j_branch_update,
                                              label="branchy"))


def test_lint_allows_static_branches_and_none_checks():
    def fine(attrs, valid, acc, key, params, dt):
        if params["mode"] > 0:     # params are static
            scale = 2.0
        else:
            scale = 1.0
        if acc is None:            # None-checks are shape-static
            return attrs, valid, torch.zeros_like(valid), None
        new = dict(attrs)
        new["diameter"] = attrs["diameter"] * scale
        return new, valid, torch.zeros_like(valid), None

    assert not ta.lint_hot_fn(fine, label="fine")


def test_lint_flags_numpy_in_hot_fn():
    diags = ta.lint_hot_fn(_np_update, label="uses_np")
    assert contracts_of(diags) == {"hot-numpy"}
    assert keys(diags) == keys(ja.lint_hot_fn(_j_np_update,
                                              label="uses_np"))


# ---------------------------------------------------------------------------
# The module lint: framework-neutral, JAX's field for field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,want", [
    ("import os\nimport sys  # noqa\nprint(1)\n", ["lint-unused-import"]),
    ("import json\ndef f(x, acc=[]):\n    acc.append(x)\n    return acc\n"
     "json = 'oops'\n", ["lint-mutable-default", "lint-shadowed-import"]),
    ("import os\nos.environ['XLA_FLAGS'] = 'x'\n", []),
    ("def f(:\n", ["lint-syntax"]),
])
def test_module_lint_equals_jax(src, want):
    got = ta.lint_source(src, "mod.py")
    assert sorted(d.contract for d in got) == sorted(want)
    assert [d.to_dict() for d in got] == \
        [d.to_dict() for d in ja.lint_source(src, "mod.py")]


def test_lint_paths_of_the_port_is_clean():
    root = os.path.dirname(os.path.dirname(tsimcheck.__file__))
    assert os.path.basename(root) == "repro_torch"
    assert ta.lint_paths([root]) == []


# ---------------------------------------------------------------------------
# The step audit on real engines, validate, the CLI
# ---------------------------------------------------------------------------

def test_audit_engine_clean_on_healthy_sharded_engine():
    geom = Domain(cell_size=2.0, interior=(4, 4), mesh_shape=(2, 2), cap=8,
                  boundary="toroidal")
    beh, jbeh = mech()
    diags = ta.audit_engine(Engine(geom=geom, behavior=beh, device="cpu"))
    assert not [d for d in diags if d.severity != "info"]
    jgeom = JDomain(cell_size=2.0, interior=(4, 4), mesh_shape=(2, 2),
                    cap=8, boundary="toroidal")
    assert keys(diags) == keys(ja.audit_engine(JEngine(geom=jgeom,
                                                       behavior=jbeh)))


def test_audit_engine_flags_item_behavior():
    geom = Domain(cell_size=2.0, interior=(4, 4), mesh_shape=(1, 1), cap=8)
    beh, _ = mech((_item_update, _j_item_update))
    diags = ta.audit_engine(Engine(geom=geom, behavior=beh, device="cpu"))
    assert any(d.contract == "host-sync" and d.severity == "error"
               and "update_fn" in d.location for d in diags)


def test_simulation_validate_returns_clean_report():
    beh, jbeh = mech()
    sim = Simulation(dict(interior=(6, 6), cap=12), beh, dt=0.1,
                     device="cpu")
    rep = sim.validate()
    assert isinstance(rep, ta.Report)
    assert rep.exit_code(strict=True) == 0
    jrep = JSimulation(dict(interior=(6, 6), cap=12), jbeh,
                       dt=0.1).validate()
    assert keys(rep) == keys(jrep)
    assert len(sim.validate(jaxpr=False)) == 0


def test_report_formats_equal_jax():
    diags = [ta.Diagnostic("warning", "lint-unused-import", "m", "h", "a"),
             ta.Diagnostic("error", "host-sync", "m2", location="b"),
             ta.Diagnostic("info", "partition-validity", "m3")]
    jdiags = [ja.Diagnostic(**d.to_dict()) for d in diags]
    rep, jrep = ta.Report(diags), ja.Report(jdiags)
    assert rep.format_text() == jrep.format_text()
    assert rep.format_json() == jrep.format_json()
    assert rep.summary() == jrep.summary()
    for strict in (False, True):
        assert rep.exit_code(strict) == jrep.exit_code(strict) == 1
    warn = ta.Report(diags[:1])
    assert (warn.exit_code(), warn.exit_code(strict=True)) == (0, 1)
    got = ta.with_context(diags, "ctx")
    assert [d.location for d in got] == \
        [d.location for d in ja.with_context(jdiags, "ctx")]


def test_simcheck_cli_shipped_sims_pass_strict(capsys):
    assert tsimcheck.main(["--sim", "tumor_spheroid", "--strict",
                           "--device", "cpu"]) == 0
    assert tsimcheck.main(["--sim", "epidemiology", "--strict",
                           "--format", "json", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"diagnostics"' in out


def test_simcheck_cli_lint_failure_exit_code(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\n\n\ndef f(x=[]):\n    return x\n")
    # unused-import / mutable-default are warnings: clean exit by default,
    # failure under --strict - the reference's exit codes
    for main in (tsimcheck.main, jsimcheck.main):
        assert main(["--lint", str(bad)]) == 0
        assert main(["--lint", str(bad), "--strict"]) == 1


def test_simcheck_virtual_variants_cover_uneven_cuts():
    beh, jbeh = mech()
    geom = Domain(cell_size=2.0, interior=(10, 10), mesh_shape=(1, 1),
                  cap=12)
    eng = Engine(geom=geom, behavior=beh, device="cpu")
    labels = [lbl for lbl, _ in tsimcheck.virtual_variants(eng)]
    assert any(lbl.startswith("mesh=") for lbl in labels)
    assert any(lbl.startswith("rcb=") for lbl in labels)
    jgeom = JDomain(cell_size=2.0, interior=(10, 10), mesh_shape=(1, 1),
                    cap=12)
    want = [lbl for lbl, _ in jsimcheck.virtual_variants(
        JEngine(geom=jgeom, behavior=jbeh))]
    assert labels == want
    # distributed engines are their own coverage
    sharded = Engine(geom=geom.with_mesh_shape((2, 1)), behavior=beh,
                     device="cpu")
    assert tsimcheck.virtual_variants(sharded) == []


# ---------------------------------------------------------------------------
# Every shipped sim and the ensemble family: the bare CLI vs JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_reports():
    """JAX's reports of every shipped sim (with its variants and the jaxpr
    audit) and of every ensemble family, computed once."""
    sims = {n: list(jsimcheck.check_sim_module(n)) for n in jsimcheck.SIMS}
    ens = {n: list(jsimcheck.check_ensemble_module(n))
           for n in jsimcheck.ensemble_families()}
    return sims, ens


@pytest.fixture(scope="module")
def port_cli():
    """The port's bare ``simcheck --device cpu --strict`` (every sim,
    every ensemble family, the lint of ``repro_torch``): its exit code and
    its JSON findings."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tsimcheck.main(["--device", "cpu", "--strict",
                             "--format", "json"])
    doc = json.loads(buf.getvalue())
    return rc, [ta.Diagnostic(**d) for d in doc["diagnostics"]]


def test_bare_simcheck_passes_strict_on_the_cpu(port_cli):
    rc, diags = port_cli
    assert rc == 0, ta.Report(diags).format_text()
    assert {d.severity for d in diags} <= {"info"}


@pytest.mark.parametrize("name", tsimcheck.SIMS)
def test_sim_findings_equal_jax(port_cli, jax_reports, name):
    _, diags = port_cli
    got = [d for d in diags if d.location.startswith(f"sims.{name}:")]
    want = jax_mapped(jax_reports[0][name])
    assert keys(got) == keys(want)
    # both virtual variants were built and checked in both packages
    sim = __import__(f"repro_torch.sims.{name}",
                     fromlist=["simulation"]).simulation(device="cpu")
    labels = [lbl for lbl, _ in tsimcheck.virtual_variants(sim.engine)]
    assert len(labels) == 2


def test_ensemble_findings_equal_jax(port_cli, jax_reports):
    _, diags = port_cli
    assert tsimcheck.ensemble_families() == jsimcheck.ensemble_families() \
        == ["sir_mechanics"]
    got = [d for d in diags if d.location.startswith("ensemble.")]
    assert keys(got) == keys(jax_mapped(jax_reports[1]["sir_mechanics"]))


# ---------------------------------------------------------------------------
# Planted faults: the same contracts in both packages
# ---------------------------------------------------------------------------

PLANTED = {
    "item": ((_item_update, _j_item_update), None, False,
             {("error", "hot-host-sync"), ("error", "host-sync")}),
    "branch": ((_branch_update, _j_branch_update), None, False,
               {("error", "hot-python-branch"), ("error", "host-sync")}),
    "numpy": ((_np_update, _j_np_update), None, False,
              {("warning", "hot-numpy")}),
    "float64": ((_f64_update, _j_f64_update), None, True,
                {("warning", "dtype-drift")}),
    "int16": ((_i16_update, _j_i16_update), [("age", (), "int16")], False,
              {("warning", "int8-overflow")}),
}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_planted_fault_flagged_as_jax_flags_it(name):
    upd, extra, x64, want = PLANTED[name]
    beh, jbeh = mech(upd, extra)
    kw = dict(interior=(4, 4), cap=8)
    rep = Simulation(kw, beh, dt=0.1, device="cpu").validate()
    jsim = JSimulation(kw, jbeh, dt=0.1)
    with jax.enable_x64(x64):
        jrep = jsim.validate()
    got = {(d.severity, d.contract) for d in rep}
    assert got == want
    assert set(keys(rep)) == set(keys(jrep))
    audit = [d for d in rep if d.contract in ("host-sync", "dtype-drift",
                                              "int8-overflow")]
    for d in audit:   # located at the behaviour's line, as the lint does
        assert d.location.startswith("step[full]: behavior.update_fn (")
        assert "test_torch_simcheck.py:" in d.location


def _family(update, jupdate):
    """A mechanics ensemble family in both packages over (repulsion,
    adhesion, max_step), its update replaced."""
    names = ("repulsion", "adhesion", "max_step")

    def fn(params):
        return dataclasses.replace(
            mech((update, jupdate))[0],
            params={**PARAMS, **{n: params[n] for n in names}})

    def jfn(params):
        return dataclasses.replace(
            mech((update, jupdate))[1],
            params={**PARAMS, **{n: params[n] for n in names}})

    geom = dict(cell_size=2.0, interior=(8, 8), cap=16, boundary="toroidal")
    return (Ensemble(geom=Domain(**geom), behavior_fn=fn, param_names=names,
                     device="cpu"),
            JEnsemble(geom=JDomain(**geom), behavior_fn=jfn,
                      param_names=names))


def _param_branch_update(attrs, valid, acc, key, params, dt):
    if params["max_step"] > 0.4:   # a branch on a per-lane parameter
        attrs = dict(attrs)
    return attrs, valid, torch.zeros_like(valid), None


def _j_param_branch_update(attrs, valid, acc, key, params, dt):
    if params["max_step"] > 0.4:   # a branch on a per-replica tracer
        attrs = dict(attrs)
    return attrs, valid, jnp.zeros_like(valid), None


def _callback_update(attrs, valid, acc, key, params, dt):
    host = attrs["diameter"].cpu()          # a host read per lane
    new = dict(attrs)
    new["diameter"] = host.to(attrs["diameter"].device)
    return new, valid, torch.zeros_like(valid), None


def _j_callback_update(attrs, valid, acc, key, params, dt):
    d = attrs["diameter"]
    host = jax.pure_callback(lambda v: v, jax.ShapeDtypeStruct(d.shape,
                                                               d.dtype), d)
    new = dict(attrs)
    new["diameter"] = host
    return new, valid, jnp.zeros_like(valid), None


@pytest.mark.parametrize("upd", [
    (_param_branch_update, _j_param_branch_update),
    (_callback_update, _j_callback_update)], ids=["branch", "callback"])
def test_ensemble_pass_four_flags_what_jax_flags(upd):
    fam, jfam = _family(*upd)
    got, want = ta.check_ensemble(fam), ja.check_ensemble(jfam)
    assert {(d.severity, d.contract) for d in got} == {
        ("error", "ensemble-batch-safe")}
    assert keys(got) == keys(want)
    assert all(context(d.location) == "ensemble.update_fn" for d in got)


# ---------------------------------------------------------------------------
# The cache key, the caller's state, the probe's edges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["one", "codec", "uneven", "guarded"])
def test_engine_hash_is_stable_across_replace(kind):
    kw = dict(device="cpu")
    if kind == "codec":
        kw.update(mesh_shape=(2, 2), delta="int8+mig")
    elif kind == "uneven":
        kw.update(partition=Partition.from_widths([(3, 5), (4, 4)]),
                  overlap="on")
    elif kind == "guarded":
        kw.update(guards="warn")
    eng = tcommon.make_sim(cc.behavior(), **kw).engine
    twin = dataclasses.replace(eng)
    assert hash(eng) == hash(twin) and eng == twin
    assert eng != dataclasses.replace(eng, dt=eng.dt * 2)
    assert not ta.audit_cache_key(eng)


def _state_bytes(state):
    return {k: v.tobytes() for k, v in state_to_arrays(state).items()}


def test_validate_leaves_the_state_and_the_counters_bit_equal():
    case = pmr.SIMCHECK_CASE
    sim, twin = pmr.build_sim(case), pmr.build_sim(case)
    sim.run(case["steps"])
    twin.run(case["steps"])
    before = _state_bytes(sim.state)
    counters = (dict(ni.LAUNCHES), dict(delta_codec.LAUNCHES))
    rep = sim.validate()
    assert rep.exit_code(strict=True) == 0, rep.format_text()
    assert _state_bytes(sim.state) == before
    assert (dict(ni.LAUNCHES), dict(delta_codec.LAUNCHES)) == counters
    sim.run(1)
    twin.run(1)
    assert _state_bytes(sim.state) == _state_bytes(twin.state)


@pytest.mark.parametrize("mesh_shape,delta,boundary", [
    ((2, 2), "int8+mig", "closed"), ((2, 1), "int16", "toroidal"),
    ((2, 2, 2), "int8+mig", "closed")])
def test_probe_shifts_cover_every_axis_and_direction(mesh_shape, delta,
                                                     boundary):
    from repro_torch.sims import tumor_spheroid as sph
    beh = sph.behavior() if len(mesh_shape) == 3 else cc.behavior()
    interior = (3,) * 3 if len(mesh_shape) == 3 else (4, 4)
    eng = tcommon.make_sim(beh, interior=interior, mesh_shape=mesh_shape,
                           delta=delta, boundary=boundary,
                           device="cpu").engine
    audit = ta.audit_step(eng)
    assert set(audit.edges) == {"step[full]", "step[delta]"}
    nd = len(mesh_shape)
    for ctx, log in audit.edges.items():
        assert {(a, d) for a, d, _ in log} == {
            (a, d) for a in range(nd) for d in (-1, 1)}
        for a, d, edges in log:
            assert edges == ring_edges(mesh_shape[a], d,
                                       eng.geom.toroidal[a])
        # the halo exchange and the migration: two shifts an edge each
        assert len(log) == 2 * 2 * nd
    assert not [d for d in audit.diagnostics if d.severity != "info"]
    assert audit.n_ops["step[delta]"] > 0


# ---------------------------------------------------------------------------
# Four ranks of a process mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("simcheck_ranks"))
    spawn_ranks(pmr.simcheck_ranks, 4, os.path.join(out, "store"),
                args=(out,), timeout_s=SPAWN_TIMEOUT_S)
    return out


def _assembled(path: str, world: int):
    blocks = {}
    for r in range(world):
        with np.load(f"{path}/r{r}.npz") as z:
            blocks[tuple(int(c) for c in z["coords"])] = {
                k: z[k] for k in z.files if k != "coords"}
    return state_to_arrays(assemble_ranks(blocks, device="cpu"))


def _bit_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_validate_on_a_process_mesh(ranks):
    case = pmr.SIMCHECK_CASE
    virt = pmr.build_sim(case)
    virt.run(case["steps"] + 1)
    _bit_equal(_assembled(f"{ranks}/simcheck/validated", 4),
               state_to_arrays(virt.state))
    for r in range(4):
        with open(f"{ranks}/simcheck/r{r}.json") as f:
            facts = json.load(f)
        assert facts["state_kept"] and facts["counters_kept"]
        assert not [d for d in facts["diagnostics"]
                    if d["severity"] != "info"]
        me = facts["coords"]
        for ctx, log in facts["edges"].items():
            assert {(a, d) for a, d, _ in log} == {
                (a, d) for a in (0, 1) for d in (-1, 1)}
            for a, d, edges in log:
                # the rank's own isend/irecv pairs of the closed chain
                want = [list(e) for e in ring_edges(2, d, False)
                        if me[a] in e]
                assert edges == want


def test_deprecated_shims(ranks):
    beh, jbeh = mech()
    with pytest.warns(DeprecationWarning) as got:
        eng = tcommon.make_engine(cc.behavior(), interior=(4, 4),
                                  mesh_shape=(2, 2), cap=24,
                                  delta=tcommon.resolve_delta("int8+mig", 4),
                                  device="cpu")
    with pytest.warns(DeprecationWarning) as want:
        jcommon.make_engine(jbeh)
    assert str(got[0].message) == str(want[0].message)
    pos, attrs = pmr.shim_population()
    state = eng.init_state(pos, attrs, seed=3)
    with pytest.warns(DeprecationWarning) as got:
        state, _ = tcommon.run_sim(eng, state, 3)
    jeng = JEngine(geom=JDomain(cell_size=2.0, interior=(4, 4), cap=8),
                   behavior=jbeh)
    jstate = jeng.init_state(np.zeros((0, 2), np.float32),
                             {"diameter": np.zeros((0,), np.float32),
                              "ctype": np.zeros((0,), np.int32)})
    with pytest.warns(DeprecationWarning) as want:
        jcommon.run_sim(jeng, jstate, 0)
    assert str(got[0].message) == str(want[0].message)
    # run_sim(mesh=) on four ranks: their blocks are the virtual run's
    _bit_equal(_assembled(f"{ranks}/simcheck/run_sim", 4),
               state_to_arrays(state))


# ---------------------------------------------------------------------------
# ROADMAP C 4: the CLIs' --delta off
# ---------------------------------------------------------------------------

def test_cli_delta_off_and_auto_on_a_mesh():
    ap = tsimulate.parser()
    want = jcommon.resolve_delta(None, 4)     # the reference's --delta off
    for value in ("off", "auto"):
        args = ap.parse_args(["--sim", "cell_clustering", "--mesh", "2x2",
                              "--delta", value, "--device", "cpu"])
        got = tsimulate.cli_delta(args.delta, 4)
        if value == "off":
            # the port's off is off; the reference's runs the codec
            assert got.enabled is False and want.enabled is True
        else:
            # auto is the reference's default, field for field
            assert (got.enabled, str(got.qdtype).split(".")[-1],
                    got.scale, got.refresh_interval, got.migration) == (
                want.enabled, jnp.dtype(want.qdtype).name, want.scale,
                want.refresh_interval, want.migration)
    args = ap.parse_args(["--sim", "cell_clustering"])
    assert args.delta == "auto" and tsimulate.cli_delta(args.delta, 1) \
        is None is jcommon.resolve_delta(None, 1)
