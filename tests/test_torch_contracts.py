"""The port's static contract checker (``repro_torch.analysis.contracts``)
against the JAX package's (``repro.analysis.contracts``).

* A table of geometries, behaviours, codecs and ``dt``s that mirrors
  tests/test_analysis.py's contract cases: on each, the port's
  diagnostics equal JAX's field for field (severity, contract, message,
  hint, location).  The one mapped finding is the device count: JAX run
  here sees one XLA device and notes that a multi-device geometry needs
  more; the port's virtual mesh holds every device on one card, so the
  port emits no such finding and it is left out of JAX's list.
* ``Simulation`` raises ``ContractError`` on exactly the configurations
  where JAX's facade does, with the same error findings; ``"warn"`` warns
  and ``"off"`` passes in both; the supervision contract matches.
* tests/test_analysis.py's two hypothesis properties as seeded draws: the
  stencil check accepts iff the port's sweep drops no pair, and the
  one-hop check flags iff a numpy slab-crossing search finds a two-cut
  hop - each also equal to JAX's checker.
* A ``Rebalance`` onto a too-narrow RCB slab is re-gated after the
  re-shard in both packages (JAX's in one subprocess with two XLA host
  devices), with the same findings.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import analysis as ja
from repro.core import AgentSchema as JSchema
from repro.core import Behavior as JBehavior
from repro.core import DeltaConfig as JDelta
from repro.core import Domain as JDomain
from repro.core import Partition as JPartition
from repro.core import Simulation as JSimulation
from repro.core import compose as jcompose
from repro.core.behaviors import displacement_update as j_update
from repro.core.behaviors import soft_repulsion_adhesion as j_pair
from repro_torch import analysis as ta
from repro_torch.core import AgentSchema, Behavior, DeltaConfig, Domain
from repro_torch.core import Partition, Simulation, compose
from repro_torch.core.behaviors import displacement_update as t_update
from repro_torch.core.behaviors import soft_repulsion_adhesion as t_pair
from repro_torch.core.engine import Engine, device_block
from repro_torch.core.neighbors import sweep_accumulate
from repro_torch.core.simulation import ContractError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Both packages' objects from one spec
# ---------------------------------------------------------------------------

def _schemas():
    return (AgentSchema.create({"diameter": ((), torch.float32),
                                "ctype": ((), torch.int32)}),
            JSchema.create({"diameter": ((), jnp.float32),
                            "ctype": ((), jnp.int32)}))


def mech(radius=2.0, max_step=0.5, params=None, spawn=False,
         declared=None):
    """The reference tests' mechanics behaviour in both packages:
    ``params`` replaces the default parameter dict when given."""
    p = {"repulsion": 2.0, "adhesion": 0.4, "same_type_only": 1.0,
         "max_step": max_step} if params is None else dict(params)
    ts, js = _schemas()
    t = Behavior(schema=ts, pair_fn=t_pair, pair_attrs=("diameter", "ctype"),
                 update_fn=t_update, radius=radius, params=p,
                 can_spawn=spawn, max_displacement=declared)
    j = JBehavior(schema=js, pair_fn=j_pair, pair_attrs=("diameter", "ctype"),
                  update_fn=j_update, radius=radius, params=p,
                  can_spawn=spawn, max_displacement=declared)
    return t, j


def stack(*pairs):
    return (compose(*[p[0] for p in pairs]),
            jcompose(*[p[1] for p in pairs]))


def geoms(cell_size=2.0, interior=(6, 6), mesh_shape=(1, 1), cap=8,
          widths=None, boundary="closed"):
    kw = dict(cell_size=cell_size, interior=interior, mesh_shape=mesh_shape,
              cap=cap, boundary=boundary)
    if widths is not None:
        t = Partition.from_widths(widths)
        j = JPartition.from_widths(widths)
        kw.update(interior=t.max_widths, mesh_shape=t.mesh_shape)
        return Domain(partition=t, **kw), JDomain(partition=j, **kw)
    return Domain(**kw), JDomain(**kw)


def deltas(qdtype="int8", scale=None, enabled=True):
    return (DeltaConfig(enabled=enabled, qdtype=getattr(torch, qdtype),
                        scale=scale),
            JDelta(enabled=enabled, qdtype=getattr(jnp, qdtype),
                   scale=scale))


def fields(diags):
    return [dataclasses.asdict(d) for d in diags]


def jax_mapped(diags):
    """JAX's findings less its device-count note (this process has one
    XLA device; the port's virtual mesh lacks none)."""
    return [d for d in diags if not (
        d.contract == ja.contracts.CONTRACT_PARTITION and d.severity == "info"
        and "devices but this host exposes" in d.message)]


# name -> (geometry kwargs, behaviour factory, codec kwargs or None, dt)
CASES = {
    "stencil_radius_over_cell": (dict(), lambda: mech(radius=3.0), None, 1.0),
    "stencil_radius_equal_cell": (dict(), lambda: mech(radius=2.0), None,
                                  1.0),
    "stencil_sharded_adds_aura": (dict(mesh_shape=(2, 1)),
                                  lambda: mech(radius=2.5), None, 1.0),
    "stencil_composed_leaf": (dict(), lambda: stack(mech(radius=2.0),
                                                    mech(radius=5.0)),
                              None, 1.0),
    "one_hop_hard_error": (dict(interior=(4, 4), mesh_shape=(2, 1)),
                           lambda: mech(max_step=8.0), None, 1.0),
    "one_hop_hard_clean": (dict(interior=(4, 4), mesh_shape=(2, 1)),
                           lambda: mech(max_step=7.5), None, 1.0),
    "one_hop_unsharded": (dict(interior=(4, 4)),
                          lambda: mech(max_step=50.0), None, 1.0),
    "one_hop_both_axes": (dict(interior=(4, 3), mesh_shape=(2, 2)),
                          lambda: mech(max_step=6.5), None, 0.5),
    "one_hop_stochastic": (dict(interior=(4, 4), mesh_shape=(2, 1)),
                           lambda: mech(params={"sigma": 2.5}), None, 1.0),
    "one_hop_unverifiable": (dict(interior=(4, 4), mesh_shape=(2, 1)),
                             lambda: mech(params={}), None, 1.0),
    "one_hop_declared": (dict(interior=(4, 4), mesh_shape=(2, 1)),
                         lambda: mech(max_step=50.0, declared=0.5), None,
                         1.0),
    "one_hop_spawn_undeclared": (dict(interior=(4, 4), mesh_shape=(2, 1)),
                                 lambda: mech(spawn=True), None, 1.0),
    "one_hop_spawn_offset": (dict(interior=(4, 4), mesh_shape=(2, 1)),
                             lambda: mech(params={"max_step": 0.5,
                                                  "div_offset": 2.0},
                                          spawn=True), None, 1.0),
    "one_hop_stack_sums": (dict(interior=(4, 4), mesh_shape=(1, 2)),
                           lambda: stack(mech(max_step=4.0),
                                         mech(params={"sigma": 1.0})),
                           None, 1.0),
    "rcb_narrow_slab": (dict(interior=(8, 8), widths=((2, 6), (8,))),
                        lambda: mech(max_step=5.0), None, 1.0),
    "rcb_equal_split": (dict(interior=(4, 8), mesh_shape=(2, 1)),
                        lambda: mech(max_step=5.0), None, 1.0),
    "rcb_pad_info": (dict(widths=((1, 1, 14), (8,))),
                     lambda: mech(max_step=0.5), None, 1.0),
    "headroom_error": (dict(), lambda: mech(max_step=0.5),
                       dict(scale=1e-3), 1.0),
    "headroom_warning": (dict(), lambda: mech(max_step=0.5),
                         dict(scale=0.005), 0.1),
    "headroom_roomy": (dict(), lambda: mech(max_step=0.5),
                       dict(scale=0.01), 1.0),
    "headroom_adaptive": (dict(), lambda: mech(max_step=0.5), dict(), 1.0),
    "headroom_int16_error": (dict(), lambda: mech(max_step=0.5),
                             dict(qdtype="int16", scale=1e-5), 1.0),
    "headroom_codec_off": (dict(), lambda: mech(max_step=0.5),
                           dict(scale=1e-3, enabled=False), 1.0),
    "headroom_unverifiable": (dict(), lambda: mech(params={}),
                              dict(scale=1e-3), 1.0),
    "partition_cell_size": (dict(cell_size=-1.0, interior=(4, 4)),
                            lambda: mech(), None, 1.0),
    "mesh_clean": (dict(interior=(4, 4), mesh_shape=(2, 2),
                        boundary="toroidal"), lambda: mech(), None, 1.0),
}


def _build(case):
    gkw, beh, dkw, dt = CASES[case]
    gt, gj = geoms(**gkw)
    bt, bj = beh()
    dt_, dj = deltas(**dkw) if dkw is not None else (None, None)
    return (gt, bt, dt_), (gj, bj, dj), dt


@pytest.mark.parametrize("case", sorted(CASES))
def test_diagnostics_equal_jax_field_for_field(case):
    (gt, bt, dt_), (gj, bj, dj), dt = _build(case)
    got = ta.check_contracts(gt, bt, dt_, dt)
    want = jax_mapped(ja.check_contracts(gj, bj, dj, dt))
    assert fields(got) == fields(want)
    # the pieces too
    tb, jb = ta.displacement_bound(bt, dt), ja.displacement_bound(bj, dt)
    assert (tb.value, tb.kind, tb.detail) == (jb.value, jb.kind, jb.detail)
    for a in range(gt.ndim):
        assert ta.min_slab_width_cells(gt, a) == \
            ja.min_slab_width_cells(gj, a)
    assert [p for p, _ in ta.leaf_behaviors(bt)] == \
        [p for p, _ in ja.contracts.leaf_behaviors(bj)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulation_gate_equals_jax(case):
    """Construction raises in exactly the cases JAX's facade raises, with
    the same error findings; "warn" warns and "off" passes in both."""
    (gt, bt, dt_), (gj, bj, dj), dt = _build(case)
    if gt.cell_size <= 0:
        # neither package can build an engine on it: the gate's finding
        # stands on the checker alone (test above)
        return

    def outcome(make, err_cls):
        try:
            make("error")
        except err_cls as e:
            return fields(e.diagnostics)
        return None

    got = outcome(lambda m: Simulation(gt, bt, delta=dt_, dt=dt, check=m,
                                       device="cpu"), ContractError)
    want = outcome(lambda m: JSimulation(gj, bj, delta=dj, dt=dt, check=m),
                   ja.ContractError)
    assert got == want
    for m in ("warn", "off"):
        with warnings.catch_warnings(record=True) as wt:
            warnings.simplefilter("always")
            Simulation(gt, bt, delta=dt_, dt=dt, check=m, device="cpu")
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            JSimulation(gj, bj, delta=dj, dt=dt, check=m)
        pick = [str(w.message) for w in wt if "simcheck" in str(w.message)]
        want_w = [str(w.message) for w in wj if "simcheck" in str(w.message)]
        assert pick == want_w
    with pytest.raises(ValueError, match="check mode"):
        Simulation(gt, bt, delta=dt_, dt=dt, check="loose", device="cpu")


def test_contract_error_text_and_enforce_diagnostics():
    (gt, bt, _), (gj, bj, _), _ = _build("one_hop_hard_error")
    errs_t = [d for d in ta.check_contracts(gt, bt) if d.severity == "error"]
    errs_j = [d for d in ja.check_contracts(gj, bj) if d.severity == "error"]
    assert str(ta.ContractError(errs_t)) == str(ja.ContractError(errs_j))
    for mode in ("off", "warn"):
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            assert fields(ta.enforce_diagnostics(errs_t, mode)) == fields(
                ja.contracts.enforce_diagnostics(errs_j, mode))
    with pytest.raises(ta.ContractError):
        ta.enforce_diagnostics(errs_t, "error")
    with pytest.raises(ValueError, match="check mode"):
        ta.enforce_diagnostics(errs_t, "loud")
    # the port's engine gate and its check_engine
    eng = Engine(geom=gt, behavior=bt, device="cpu")
    assert fields(ta.check_engine(eng)) == fields(ta.check_contracts(gt, bt))
    with pytest.raises(ContractError, match="one-hop-migration"):
        ta.enforce(eng)


@pytest.mark.parametrize("policy,keep,every", [
    ("off", 5, 10), ("warn", 1, 10), ("error", 1, 0), ("error", 3, 4)])
def test_supervision_contract_equals_jax(policy, keep, every):
    from repro.core import Engine as JEngine
    from repro.core.guards import GuardConfig as JGuards
    from repro.launch.supervise import Supervised as JSupervised
    from repro_torch.core.guards import GuardConfig
    from repro_torch.launch.supervise import Supervised

    (gt, bt, _), (gj, bj, _), _ = _build("mesh_clean")
    eng_t = Engine(geom=gt, behavior=bt, guards=GuardConfig(policy),
                   device="cpu")
    eng_j = JEngine(geom=gj, behavior=bj, guards=JGuards(policy))
    got = ta.check_supervision(eng_t, Supervised(dir="x", keep=keep,
                                                 every=every))
    want = ja.check_supervision(eng_j, JSupervised(dir="x", keep=keep,
                                                   every=every))
    assert fields(got) == fields(want)


def test_check_ensemble_runs_the_solo_contracts():
    """Pass 1 of the ensemble contract: a family whose solo engine breaks
    a contract is refused, with the solo finding."""
    from repro_torch.core.ensemble import Ensemble
    from repro_torch.sims import sir_mechanics as sm

    assert ta.check_ensemble(sm.ensemble_family(
        interior=(4, 4), mesh_shape=(2, 2), device="cpu")) == []
    ens = sm.ensemble_family(device="cpu")
    narrow = Ensemble(
        geom=Domain(cell_size=1.0, interior=(8, 8), cap=32,
                    boundary="toroidal"),
        behavior_fn=ens.behavior_fn, param_names=ens.param_names,
        device="cpu")
    got = ta.check_ensemble(narrow)
    assert {(d.severity, d.contract) for d in got} == {
        ("error", "stencil-soundness")}


# ---------------------------------------------------------------------------
# tests/test_analysis.py's properties, as seeded draws
# ---------------------------------------------------------------------------

def _count_behaviors(radius):
    def t_count(ai, aj, disp, dist2, params):
        return {"nbr": torch.ones_like(dist2)}

    def j_count(ai, aj, disp, dist2, params):
        return {"nbr": jnp.ones_like(dist2)}

    def t_idle(attrs, valid, acc, key, params, dt):
        return dict(attrs), valid, torch.zeros_like(valid), None

    def j_idle(attrs, valid, acc, key, params, dt):
        return dict(attrs), valid, jnp.zeros_like(valid), None

    # a finding's location names the update function
    t_idle.__name__ = j_idle.__name__ = "idle"
    t = Behavior(schema=AgentSchema.create({"diameter": ((), torch.float32)}),
                 pair_fn=t_count, pair_attrs=("diameter",), update_fn=t_idle,
                 radius=radius, params={"max_step": 0.0})
    j = JBehavior(schema=JSchema.create({"diameter": ((), jnp.float32)}),
                  pair_fn=j_count, pair_attrs=("diameter",), update_fn=j_idle,
                  radius=radius, params={"max_step": 0.0})
    return t, j


def _port_pair_count(geom, beh, pos):
    eng = Engine(geom=geom, behavior=beh, device="cpu")
    st = eng.init_state(pos, {"diameter": np.ones((len(pos),), np.float32)})
    acc = sweep_accumulate(geom, device_block(st.soa, (0, 0)), beh.pair_fn,
                           beh.pair_attrs, beh.radius, beh.params,
                           backend="tiled")
    return float(acc["nbr"].sum())


def _brute_pair_count(pos, radius):
    p = pos.astype(np.float32)
    d = p[None, :, :] - p[:, None, :]
    dist2 = (d * d).sum(-1)
    return float((dist2 <= np.float32(radius * radius)).sum() - len(p))


def _stencil_draws(n=10, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cs = float(rng.choice([1.0, 1.5, 2.0, 3.0]))
        ratio = float(rng.uniform(0.3, 2.0))
        if abs(ratio - 1.0) < 0.05:
            ratio = 1.2                   # skirt the exact boundary
        out.append((cs, ratio, int(rng.integers(0, 2**31 - 1))))
    return out


@pytest.mark.parametrize("cell_size,ratio,seed", _stencil_draws())
def test_stencil_checker_accepts_iff_sweep_drops_no_pair(cell_size, ratio,
                                                         seed):
    radius = cell_size * ratio
    gt, gj = geoms(cell_size=cell_size, interior=(6, 6), cap=24)
    bt, bj = _count_behaviors(radius)
    flagged = "stencil-soundness" in {
        d.contract for d in ta.check_contracts(gt, bt)}
    assert flagged == (ratio > 1.0)
    assert fields(ta.check_contracts(gt, bt)) == fields(
        ja.check_contracts(gj, bj))
    if not flagged:
        rng = np.random.default_rng(seed)
        lo, hi = 0.1 * cell_size, 6 * cell_size - 0.1 * cell_size
        pos = rng.uniform(lo, hi, (40, 2)).astype(np.float32)
        assert _port_pair_count(gt, bt, pos) == _brute_pair_count(pos,
                                                                  radius)
    else:
        eps = cell_size * min(0.02, (ratio - 1.0) / 4.0)
        y = 3.0 * cell_size
        pos = np.array([[cell_size - eps, y],
                        [2.0 * cell_size + eps, y]], np.float32)
        assert _brute_pair_count(pos, radius) == 2.0
        assert _port_pair_count(gt, bt, pos) == 0.0


def _one_hop_draws(n=25, seed=1):
    rng = np.random.default_rng(seed)
    return [(tuple(int(w) for w in rng.integers(1, 7, rng.integers(2, 5))),
             int(rng.integers(1, 41))) for _ in range(n)]


@pytest.mark.parametrize("widths,quarter", _one_hop_draws())
def test_one_hop_checker_matches_bruteforce_slab_crossing(widths, quarter):
    d = quarter * 0.25 + 0.125   # never ties with an integer slab width
    L = sum(widths)
    gt, gj = geoms(cell_size=1.0, interior=(L, 4), cap=4,
                   widths=(tuple(widths), (4,)), boundary="toroidal")
    bt, bj = _count_behaviors(1.0)
    bt = dataclasses.replace(bt, params={"max_step": d})
    bj = dataclasses.replace(bj, params={"max_step": d})
    got = ta.check_contracts(gt, bt)
    assert fields(got) == fields(jax_mapped(ja.check_contracts(gj, bj)))
    flagged = "one-hop-migration" in {x.contract for x in got}
    cuts = np.cumsum(widths).astype(np.float64)
    periods = int(d // L) + 2
    bounds = np.sort(np.concatenate([cuts + m * L for m in range(periods)]))
    xs = np.arange(0.0, L, 1 / 16.0) + 1 / 32.0
    crossed = (np.searchsorted(bounds, xs + d, side="right")
               - np.searchsorted(bounds, xs, side="right"))
    assert flagged == bool((crossed >= 2).any())


# ---------------------------------------------------------------------------
# The re-gate after a re-shard onto a too-narrow RCB slab
# ---------------------------------------------------------------------------

# Every agent in the corner square of 1.5 x 1.5 cells of 16 x 16: the RCB
# plan cuts a slab of a cell or two, which the max_step of 4.5 crosses;
# the equal 2x1 split (8 cells a device) passes the gate at construction.
REGATE = dict(max_step=4.5, n=120, seed=4)

REGATE_ORACLE = """
import dataclasses, json
import numpy as np, jax.numpy as jnp
from repro import analysis as ja
from repro.core import AgentSchema, Behavior, Simulation
from repro.core.behaviors import displacement_update, soft_repulsion_adhesion
from repro.core.simulation import Rebalance
schema = AgentSchema.create({{"diameter": ((), jnp.float32),
                             "ctype": ((), jnp.int32)}})
beh = Behavior(schema=schema, pair_fn=soft_repulsion_adhesion,
               pair_attrs=("diameter", "ctype"),
               update_fn=displacement_update, radius=2.0,
               params={{"repulsion": 2.0, "adhesion": 0.4,
                       "same_type_only": 1.0, "max_step": {max_step}}})
rng = np.random.default_rng({seed})
n = {n}
pos = np.stack([rng.uniform(0.2, 3.0, n), rng.uniform(0.2, 3.0, n)],
               1).astype(np.float32)
attrs = {{"diameter": np.full((n,), 1.0, np.float32),
         "ctype": rng.integers(0, 2, n).astype(np.int32)}}
sim = Simulation(dict(cell_size=2.0, interior=(8, 8), mesh_shape=(2, 1),
                      cap=64), beh, dt=0.1,
                 rebalance=Rebalance(every=1, threshold=0.1,
                                     ownership="rcb", transport="host"))
sim.init(pos, attrs)
try:
    sim.run(2)
    out = None
except ja.ContractError as e:
    out = [dataclasses.asdict(d) for d in e.diagnostics]
print("JSON" + json.dumps(dict(diags=out, iteration=sim.iteration,
                               widths=[list(w) for w in
                                       sim.engine.geom.partition.widths]
                               if sim.engine.geom.partition else None)))
"""


def _regate_oracle():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    p = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REGATE_ORACLE.format(
            **REGATE))], capture_output=True, text=True, timeout=600,
        env=env)
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


def test_rebalance_onto_a_narrow_rcb_slab_is_regated_in_both():
    from repro_torch.core.simulation import Rebalance

    want = _regate_oracle()
    bt, _ = mech(max_step=REGATE["max_step"])
    rng = np.random.default_rng(REGATE["seed"])
    n = REGATE["n"]
    pos = np.stack([rng.uniform(0.2, 3.0, n), rng.uniform(0.2, 3.0, n)],
                   1).astype(np.float32)
    attrs = {"diameter": np.full((n,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, n).astype(np.int32)}
    sim = Simulation(dict(cell_size=2.0, interior=(8, 8), mesh_shape=(2, 1),
                          cap=64), bt, dt=0.1, device="cpu",
                     rebalance=Rebalance(every=1, threshold=0.1,
                                         ownership="rcb", transport="host"))
    sim.init(pos, attrs)
    with pytest.raises(ContractError) as e:
        sim.run(2)
    assert want["diags"] is not None, want
    assert fields(e.value.diagnostics) == want["diags"]
    assert {d.contract for d in e.value.diagnostics} == {"one-hop-migration"}
    assert sim.iteration == want["iteration"]
    assert [list(w) for w in sim.engine.geom.partition.widths] == \
        want["widths"]
    # the same run with the gate off re-shards and steps on
    sim = Simulation(dict(cell_size=2.0, interior=(8, 8), mesh_shape=(2, 1),
                          cap=64), bt, dt=0.1, device="cpu", check="off",
                     rebalance=Rebalance(every=1, threshold=0.1,
                                         ownership="rcb", transport="host"))
    sim.init(pos, attrs)
    sim.run(2)
    assert sim.iteration == 2 and sim.n_agents() == n
