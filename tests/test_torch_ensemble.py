"""The port's ensembles and scenario server against the JAX package, and
their lanes against the port's solo runs.

* The lane sweep of ``sir_mechanics``' ensemble stack (the force, and the
  infected count behind each lane's ``sir_radius`` gate: the kernel's
  stack 18) and of the gated law alone (law 5): the port's plain version,
  lane by lane, against the JAX ``pair_sweep_kernel`` in interpret mode at
  each lane's Python-float params, and against ``jax.vmap`` of the JAX
  ``tiled`` sweep with ``(R,)`` params.  (The JAX Pallas kernel cannot
  run a vmapped ensemble: with traced params it captures constants and
  raises, ROADMAP C.)  Each lane holds a pair at exactly dist2 ==
  fl32(r) * fl32(r).  Forces to 1e-5, counts exactly.
* The one-device ``Ensemble`` against JAX's (``tiled``), 3 points, from
  the bridged stacked state: each step within 1e-5 of the reference's
  state, then a free run exact on everything but positions (dt 1.0 with
  forces amplifies a last-bit difference of float sums, as
  ``tests/test_torch_sims.py`` says).
* Each lane bit-equal to the port's solo engine at its point: one device,
  the 2x2 virtual mesh, and the int16 delta codec on the refresh-segment
  schedule.  Padding is inert; the runner cache hits on a rebuilt family.
* The per-lane reducers, ``check_ensemble``, the scenario server (its
  S/I/R frames exactly the JAX server's) and the ensemble bridge.

Everything runs on the CPU; the CUDA lane kernel is held against the plain
version in tests/test_torch_kernel.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Domain as JDomain
from repro.core import Engine as JEngine
from repro.core.grid import clear_ring as j_clear_ring
from repro.core.halo import LocalComm as JLocalComm
from repro.core.halo import halo_exchange as j_halo_exchange
from repro.core.neighbors import sweep_accumulate as j_sweep
from repro.kernels.neighbor_interaction import pair_sweep_kernel
from repro.sims import sir_mechanics as j_sm
from repro_torch.analysis import check_ensemble
from repro_torch.bridge import (
    ensemble_from_arrays, ensemble_to_arrays, state_from_arrays,
    state_to_arrays,
)
from repro_torch.core import DeltaConfig, Domain
from repro_torch.core import operations as t_ops
from repro_torch.core.engine import device_block
from repro_torch.core.ensemble import (
    _RUNNER_CACHE, Ensemble, replica_state, stack_states,
)
from repro_torch.core.neighbors import sweep_accumulate_lanes
from repro_torch.kernels import neighbor_interaction as ni
from repro_torch.sims import cell_clustering as cc
from repro_torch.sims import sir_mechanics as sm
from torch_parity import assert_dicts_close, jax_state_arrays

POINTS = [{"beta": 0.02}, {"beta": 0.08, "sigma": 0.5},
          {"gamma": 0.3, "sir_radius": 1.0}]
# Lane points of the sweep tests: sir_radius over and under the
# structural 1.5, the mechanics differing.
LANES = [dict(sir_radius=0.5, repulsion=2.0, adhesion=0.5),
         dict(sir_radius=1.0, repulsion=3.0, adhesion=0.2),
         dict(sir_radius=1.5, repulsion=1.0, adhesion=0.8),
         dict(sir_radius=2.0, repulsion=2.5, adhesion=0.0)]
SIR = (sm.S, sm.I, sm.R)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its per-lane loops run many ops
    on small tensors, and beside busy test workers torch's thread pool
    slowed them a hundredfold (the lanes-vs-solo case took 498 s under
    six pytest-xdist workers on 8 cores, against ~4 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _point(p):
    return {**sm.ensemble_defaults(), **p}


def _f32_point(p):
    """A lane point as the lanes see it: every value rounded to float32,
    as Python floats (the Pallas kernel takes them as literals)."""
    return {k: float(np.float32(v)) for k, v in _point(p).items()}


# ---------------------------------------------------------------------------
# The lane sweep (B1 a, d) against the JAX kernel and the vmapped sweep
# ---------------------------------------------------------------------------

def _lane_soa(seed, r):
    """A sir_mechanics aura-filled SoA on 8 x 8 toroidal cells (JAX's and
    the port's, from the same numpy inputs) with an edge pair: agents at x
    0.5 and 0.5 + fl32(r) (float32 difference exactly fl32(r)), the
    second infected."""
    rng = np.random.default_rng(seed)
    kw = dict(cell_size=2.0, interior=(8, 8), mesh_shape=(1, 1), cap=32,
              boundary="toroidal")
    geom_j = JDomain(**kw)
    n = 240
    pos = rng.uniform(0.5, 15.5, (n, 2)).astype(np.float32)
    pos[0] = (0.5, 9.0)
    pos[1] = (np.float32(0.5) + np.float32(r), 9.0)
    attrs = {"diameter": rng.uniform(0.6, 1.4, n).astype(np.float32),
             "ctype": rng.integers(0, 2, n).astype(np.int32),
             "state": rng.integers(0, 3, n).astype(np.int32)}
    attrs["state"][:2] = (0, 1)
    eng = JEngine(geom=geom_j, behavior=j_sm.behavior(), dt=1.0)
    st = eng.init_state(pos, attrs, seed=seed)
    refs = {d: {f: v[0, 0] for f, v in s.items()}
            for d, s in st.refs.items()}
    soa_j, _, _, _ = j_halo_exchange(
        geom_j, j_clear_ring(st.soa), JLocalComm(toroidal=geom_j.toroidal),
        refs, eng.delta_cfg, True)
    st_t = state_from_arrays(
        jax_state_arrays(dataclasses.replace(st, soa=soa_j)), device="cpu")
    return geom_j, Domain(**kw), soa_j, device_block(st_t.soa, (0, 0))


@pytest.fixture(scope="module")
def lane_cases():
    return [_lane_soa(seed, p["sir_radius"]) for seed, p in enumerate(LANES)]


def _stacked(blocks):
    return type(blocks[0])(
        attrs={n: torch.stack([b.attrs[n] for b in blocks])
               for n in blocks[0].attrs},
        valid=torch.stack([b.valid for b in blocks]))


def _lane_fns(which, radii=None):
    """Per lane (port pair_fn, port params, JAX pair_fn, JAX params), at
    the lanes' float32 points (``radii`` in place of their sir_radius)."""
    out = []
    for b, p in enumerate(LANES):
        pt = _f32_point(p if radii is None
                        else dict(p, sir_radius=radii[b]))
        if which == "stack18":
            bt, bj = sm.ensemble_behavior(pt), j_sm.ensemble_behavior(pt)
            out.append((bt.pair_fn, bt.params, bj.pair_fn, bj.params))
        else:
            r = {"sir_radius": pt["sir_radius"]}
            out.append((sm._gated_sir_pair, r, j_sm._gated_sir_pair, r))
    return out


PATTRS = {"stack18": ("ctype", "diameter", "state"), "law5": ("state",)}
COUNTS = {"stack18": ("b1.n_inf",), "law5": ("n_inf",)}


@pytest.mark.parametrize("which", ["stack18", "law5"])
def test_lane_sweep_matches_jax_pallas_kernel(lane_cases, which):
    """Lane by lane: the port's lane sweep (plain on the CPU) against the
    JAX Pallas kernel in interpret mode at the lane's float32 point as
    Python floats; the edge pair counts at r and not at the next float32
    below."""
    fns = _lane_fns(which)
    geom_t = lane_cases[0][1]
    box = tuple(geom_t.domain_size)
    soa = _stacked([c[3] for c in lane_cases])
    got = ni.pair_sweep_lanes(
        soa.attrs, soa.valid, pair_fns=[f[0] for f in fns],
        pair_attrs=PATTRS[which], radius=2.0, params=[f[1] for f in fns],
        box=box)
    for b, ((_, _, soa_j, blk), (_, _, fj, pj)) in enumerate(
            zip(lane_cases, fns)):
        ai, aj, vi, vj = ni.neighborhood_slabs(blk.attrs, blk.valid,
                                               PATTRS[which])
        want = pair_sweep_kernel(
            {n: jnp.asarray(a.numpy()) for n, a in ai.items()},
            {n: jnp.asarray(a.numpy()) for n, a in aj.items()},
            jnp.asarray(vi.numpy()), jnp.asarray(vj.numpy()), pair_fn=fj,
            radius=2.0, params=pj, box=box, interpret=True)
        mine = {n: g[b].reshape(want[n].shape) for n, g in got.items()}
        assert_dicts_close(mine, {n: np.asarray(w) for n, w in want.items()},
                           exact_keys=COUNTS[which])
    # the edge pair (agent 0 at x 0.5, gid <0, 0>) sits on each lane's
    # gate: it counts at r and not at the next float32 below r
    count = COUNTS[which][0]
    below = _lane_fns(which, radii=[float(np.nextafter(
        np.float32(p["sir_radius"]), np.float32(0))) for p in LANES])
    low = ni.pair_sweep_lanes(
        soa.attrs, soa.valid, pair_fns=[f[0] for f in below],
        pair_attrs=PATTRS[which], radius=2.0, params=[f[1] for f in below],
        box=box)[count]
    for b, p in enumerate(LANES):
        me = ((soa.attrs["gid_count"][b] == 0) & soa.valid[b]
              & (soa.attrs["gid_rank"][b] == 0))[1:-1, 1:-1]
        inside = which == "law5" or p["sir_radius"] <= sm.SIR_RADIUS_MAX
        d = float(got[count][b][me].sum() - low[b][me].sum())
        assert d == (1.0 if inside else 0.0), (b, p)


@pytest.mark.parametrize("which", ["stack18", "law5"])
def test_lane_sweep_matches_jax_vmapped_tiled_sweep(lane_cases, which):
    """All lanes at once: the port's lane sweep (kernel backend's plain
    version) against ``jax.vmap`` of the JAX ``tiled`` sweep over the
    stacked SoA with ``(R,)`` float32 params."""
    geom_j, geom_t = lane_cases[0][0], lane_cases[0][1]
    fns = _lane_fns(which)
    soa_j = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                   *[c[2] for c in lane_cases])
    names = tuple(sorted(_point({})))
    params = {n: jnp.asarray([_f32_point(p)[n] for p in LANES], jnp.float32)
              for n in names}

    def one(soa, p):
        beh = j_sm.ensemble_behavior(p)
        if which == "stack18":
            fn, prm, pattrs = beh.pair_fn, beh.params, beh.pair_attrs
        else:
            fn, prm = j_sm._gated_sir_pair, {"sir_radius": p["sir_radius"]}
            pattrs = ("state",)
        return j_sweep(geom_j, soa, fn, pattrs, 2.0, prm, backend="tiled")

    want = jax.jit(jax.vmap(one))(soa_j, params)
    got = sweep_accumulate_lanes(
        geom_t, _stacked([c[3] for c in lane_cases]), [f[0] for f in fns],
        PATTRS[which], 2.0, [f[1] for f in fns], backend="kernel")
    assert_dicts_close(got, {n: np.asarray(w) for n, w in want.items()},
                       exact_keys=COUNTS[which])


# ---------------------------------------------------------------------------
# The one-device Ensemble against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ensemble():
    """JAX's family (``tiled``) and its stacked initial state, 3 points,
    200 agents on 8 x 8 cells."""
    ens = j_sm.ensemble_family(interior=(8, 8), sweep_backend="tiled")
    return ens, j_sm.ensemble_init(ens, POINTS, n_agents=200,
                                   initial_infected=10)


def _jax_arrays(estate):
    out = jax_state_arrays(estate.state)
    out.update({f"params.{n}": np.asarray(v)
                for n, v in estate.params.items()})
    out["active"] = np.asarray(estate.active)
    return out


def test_ensemble_steps_like_jax(jax_ensemble):
    """Each of 4 steps from the reference's state (bridged), to 1e-5."""
    ens_j, est_j = jax_ensemble
    ens_t = sm.ensemble_family(interior=(8, 8), device="cpu")
    for _ in range(4):
        got, _ = ens_t.run(ensemble_from_arrays(_jax_arrays(est_j), "cpu"),
                           1)
        est_j, _ = ens_j.run(est_j, 1)
        assert_dicts_close(ensemble_to_arrays(got), _jax_arrays(est_j))


def test_ensemble_free_run_like_jax(jax_ensemble):
    """10 free steps from the bridged state (the horizon of
    tests/test_torch_sims.py's free run): S/I/R, valid, slots, gids,
    dropped and every other field but positions exactly.  Further on the
    float-order drift of positions crosses a cell: here lane 1's pair at
    the 2.0 cutoff flips at step 10 and an agent bins elsewhere at 12."""
    ens_j, est_j = jax_ensemble
    ens_t = sm.ensemble_family(interior=(8, 8), device="cpu")
    est_t = ensemble_from_arrays(_jax_arrays(est_j), "cpu")
    counts = t_ops.batch_attr_counts("state", SIR)
    for _ in range(5):
        est_t, _ = ens_t.run(est_t, 2)
        est_j, _ = ens_j.run(est_j, 2)
        want = _jax_arrays(est_j)
        skip = [k for k in want if k.endswith(".pos") or
                k.startswith("refs.")]
        assert_dicts_close(ensemble_to_arrays(est_t), want,
                           exact_keys=set(want), skip=skip)
        assert (counts(est_t.state).sum(axis=1) == 200).all()


def test_batch_reducers_match_jax(jax_ensemble):
    from repro.core import operations as j_ops

    ens_j, est_j = jax_ensemble
    est_j, _ = ens_j.run(est_j, 3)
    est_t = ensemble_from_arrays(_jax_arrays(est_j), "cpu")
    st_j, st_t = est_j.state, est_t.state
    assert np.array_equal(t_ops.batch_agent_count(st_t),
                          j_ops.batch_agent_count(st_j))
    assert np.array_equal(t_ops.batch_attr_counts("state", SIR)(st_t),
                          j_ops.batch_attr_counts("state", SIR)(st_j))
    assert np.array_equal(t_ops.batch_attr_sum("state")(st_t),
                          j_ops.batch_attr_sum("state")(st_j))
    assert t_ops.batch_attr_counts("state", SIR).__name__ == \
        "batch_counts_state"


def test_ensemble_bridge_round_trip_is_exact(jax_ensemble):
    arrays = _jax_arrays(jax_ensemble[1])
    est = ensemble_from_arrays(arrays, "cpu")
    assert est.replicas == 3 and est.n_active == 3
    back = ensemble_to_arrays(est)
    assert set(back) == set(arrays)
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and np.array_equal(back[k], a), k
    again = ensemble_to_arrays(ensemble_from_arrays(back, "cpu"))
    assert all(np.array_equal(again[k], back[k]) for k in back)


# ---------------------------------------------------------------------------
# Lanes against solo runs, padding, the runner cache
# ---------------------------------------------------------------------------

def _solo(ens, p, s0, n_steps):
    """The solo engine at point ``p`` on the refresh-segment schedule
    Ensemble.run uses."""
    seg = ens.solo_engine(_point(p)).make_segment_runner()
    chunk = n_steps if not ens.delta_cfg.enabled \
        else ens.delta_cfg.refresh_interval
    done, s = 0, s0
    while done < n_steps:
        n = min(chunk, n_steps - done)
        s = seg(s, n, True)
        done += n
    return s


def _assert_states_equal(a, b):
    A, B = state_to_arrays(a), state_to_arrays(b)
    assert set(A) == set(B)
    for k in A:
        assert np.array_equal(A[k], B[k]), k


@pytest.mark.parametrize("case", ["one_device", "mesh_2x2", "delta_int16"])
def test_lanes_equal_solo_runs(case):
    kw = {"one_device": dict(interior=(8, 8)),
          "mesh_2x2": dict(interior=(5, 5), mesh_shape=(2, 2)),
          "delta_int16": dict(interior=(8, 8), delta=DeltaConfig(
              enabled=True, qdtype=torch.int16, refresh_interval=4))}[case]
    ens = sm.ensemble_family(device="cpu", **kw)
    est = sm.ensemble_init(ens, POINTS, n_agents=200, initial_infected=10)
    out, frames = ens.run(est, 10, collect=lambda e: int(
        e.state.it.reshape(3, -1)[0, 0]))
    assert frames == ([4, 8, 10] if case == "delta_int16" else [10])
    for r, p in enumerate(POINTS):
        _assert_states_equal(
            replica_state(out.state, r),
            _solo(ens, p, replica_state(est.state, r), 10))


def test_padding_is_inert():
    ens = sm.ensemble_family(interior=(8, 8), device="cpu")
    est = sm.ensemble_init(ens, POINTS, n_agents=120, initial_infected=6)
    out, _ = ens.run(est, 6)
    padded = ens.pad_to(est, 5)
    assert padded.replicas == 5 and padded.n_active == 3
    assert list(padded.active) == [True] * 3 + [False] * 2
    assert padded.params["beta"].tolist()[3:] == [padded.params[
        "beta"].tolist()[0]] * 2
    out_p, _ = ens.run(padded, 6)
    for r in range(len(POINTS)):
        _assert_states_equal(replica_state(out.state, r),
                             replica_state(out_p.state, r))
    with pytest.raises(ValueError):
        ens.pad_to(est, 2)


def test_runner_cache_hits_on_a_rebuilt_family():
    ens = sm.ensemble_family(interior=(6, 6), device="cpu")
    est = sm.ensemble_init(ens, POINTS[:2], n_agents=60, initial_infected=3)
    ens.run(est, 1)
    s1 = _RUNNER_CACHE.stats()
    ens.run(est, 1)
    ens2 = sm.ensemble_family(interior=(6, 6), device="cpu")
    assert ens2.fingerprint == ens.fingerprint and ens2 is not ens
    ens2.run(est, 1)
    s2 = _RUNNER_CACHE.stats()
    assert s2.misses == s1.misses
    assert s2.hits == s1.hits + 2


def test_stack_and_replica_state_round_trip():
    ens = sm.ensemble_family(interior=(6, 6), device="cpu")
    est = sm.ensemble_init(ens, POINTS, n_agents=60, initial_infected=3)
    again = stack_states([replica_state(est.state, r) for r in range(3)])
    _assert_states_equal(replica_state(again, 2),
                         replica_state(est.state, 2))
    # guards= is ported (A9; tests/test_torch_resilience.py): it builds
    guarded = sm.ensemble_family(guards="warn", device="cpu")
    assert guarded.guards.policy == "warn"
    assert guarded.proto_engine().guards == guarded.guards
    with pytest.raises(TypeError, match="DeviceMesh"):   # ported (A7)
        ens.run(est, 1, mesh=object())


# ---------------------------------------------------------------------------
# check_ensemble
# ---------------------------------------------------------------------------

def _family(fn, names):
    return Ensemble(geom=Domain(cell_size=2.0, interior=(8, 8),
                                mesh_shape=(1, 1), cap=24,
                                boundary="toroidal"),
                    behavior_fn=fn, param_names=names, device="cpu")


def _concretizing(params):
    return dataclasses.replace(cc.behavior(), radius=float(params["radius"]))


def _branching(params):
    gain = 2.0 if params["gain"] > 1.0 else 1.0   # legal solo, not batched
    return dataclasses.replace(cc.behavior(), params={
        "repulsion": 2.0 * gain, "adhesion": 0.6, "same_type_only": 1.0,
        "max_step": 0.5})


def _drifting(params):
    """Passes the two-lane probe, but builds another radius at 0.75."""
    x = params["x"]
    wide = isinstance(x, float) and x > 0.5
    return dataclasses.replace(cc.behavior(), radius=1.0 if wide else 2.0)


def test_check_ensemble_accepts_the_shipped_family():
    assert check_ensemble(sm.ensemble_family(device="cpu")) == []


@pytest.mark.parametrize("fn,names", [
    (_concretizing, ("radius",)), (_branching, ("gain",)),
    (_drifting, ("x",))], ids=["concretizes", "branches", "drifts"])
def test_check_ensemble_rejects_a_factory_that_cannot_batch(fn, names):
    diags = check_ensemble(_family(fn, names))
    assert [(d.severity, d.contract) for d in diags] == [
        ("error", "ensemble-factory-static")]
    assert ("structure varies" in diags[0].message) == (fn is _drifting)
    assert "error: ensemble-factory-static" in diags[0].format()


# ---------------------------------------------------------------------------
# The scenario server
# ---------------------------------------------------------------------------

def _servers(slot=4, n_agents=120):
    from repro.launch import serve as j_serve
    from repro_torch.launch import serve as t_serve

    return (t_serve.ScenarioServer([t_serve.sir_mechanics_family(
                n_agents=n_agents, device="cpu")], slot_size=slot),
            j_serve.ScenarioServer([j_serve.sir_mechanics_family(
                n_agents=n_agents)], slot_size=slot))


def test_serve_frames_match_the_jax_server():
    """Mixed budgets and cadences share a batch; every request's frames
    come at its cadence, sum to N, and equal the JAX server's."""
    from repro_torch.launch.serve import ScenarioRequest as TReq
    from repro.launch.serve import ScenarioRequest as JReq

    reqs = [dict(family="sir_mechanics", params={"beta": 0.02}, steps=9,
                 stream_every=3, seed=0),
            dict(family="sir_mechanics", params={"beta": 0.06, "seed": 5},
                 steps=4),
            dict(family="sir_mechanics", params={"sir_radius": 1.0},
                 steps=10, stream_every=4, seed=2)]
    port, ref = _servers()
    rids = [port.submit(TReq(**r)) for r in reqs]
    jrids = [ref.submit(JReq(**r)) for r in reqs]
    assert port.queue_depth() == 3
    assert port.drain() == 3 and ref.drain() == 3
    marks = ([3, 6, 9], [4], [4, 8, 10])
    for rid, jrid, m in zip(rids, jrids, marks):
        h, hj = port.handle(rid), ref.handle(jrid)
        assert h.status == "done" and h.latency_s > 0
        assert [s for s, _ in h.frames] == m
        for (s, f), (sj, fj) in zip(h.frames, hj.frames):
            assert f.shape == (3,) and int(f.sum()) == 120
            assert s == sj and f.tolist() == np.asarray(fj).tolist()
    st = port.stats()
    assert st["batches"] == 1 and st["mean_occupancy"] == 0.75
    assert st["requests"]["done"] == 3 and st["queue_depth"] == 0


def test_serve_rejections_and_the_runner_cache():
    from repro_torch.launch.serve import (
        ScenarioFamily, ScenarioRequest, ScenarioServer,
        sir_mechanics_family)

    server = ScenarioServer([sir_mechanics_family(n_agents=60,
                                                  interior=(6, 6),
                                                  device="cpu")],
                            slot_size=2)
    diags = server.register(ScenarioFamily(
        name="bad", ensemble=_family(_concretizing, ("radius",)),
        init_point=lambda e, seed: None,
        metric=lambda s: np.zeros((1, 1))))
    assert [d.severity for d in diags] == ["error"]
    with pytest.raises(ValueError, match="already registered"):
        server.register(ScenarioFamily(
            name="bad", ensemble=_family(_concretizing, ("radius",)),
            init_point=None, metric=None))
    cases = [("nope", {}, 4, "serve-unknown-family"),
             ("sir_mechanics", {"not_a_knob": 1.0}, 4, "serve-unknown-param"),
             ("sir_mechanics", {}, 0, "serve-bad-request"),
             ("bad", {"radius": 1.0}, 2, "ensemble-factory-static")]
    for fam, params, steps, contract in cases:
        h = server.handle(server.submit(ScenarioRequest(
            family=fam, params=params, steps=steps)))
        assert h.status == "rejected"
        assert h.diagnostics[0].contract == contract
    assert "not_a_knob" in server.handle(1).diagnostics[0].message
    assert server.queue_depth() == 0
    server.submit(ScenarioRequest(family="sir_mechanics", params={},
                                  steps=2))
    server.drain()
    s1 = _RUNNER_CACHE.stats()
    server.submit(ScenarioRequest(family="sir_mechanics",
                                  params={"beta": 0.09}, steps=2))
    server.drain()
    s2 = _RUNNER_CACHE.stats()
    assert s2.misses == s1.misses and s2.hits > s1.hits
    st = server.stats()
    assert st["caches"]["ensemble.runner"]["hits"] == s2.hits
    assert st["requests"]["rejected"] == 4 and st["batches"] == 2
    assert server.pump() == 0
