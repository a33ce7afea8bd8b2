"""The ranks' side of ``tests/test_torch_process_mesh.py``: functions run
by :func:`repro_torch.launch.mesh.spawn_ranks` in each process of a CPU
process mesh (gloo).  Each writes what it holds under ``out`` as npz or
json for the test to assemble; nothing here imports JAX, so a rank starts
in seconds."""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import torch

from repro_torch.bridge import rank_arrays, rank_state, state_from_arrays
from repro_torch.core import DeltaConfig, Partition
from repro_torch.core.engine import codec_overflow_count, total_agents
from repro_torch.core.halo import ProcessMeshComm
from repro_torch.launch.mesh import close_process_mesh, make_abm_mesh
from repro_torch.sims.common import make_sim, resolve_delta


def sim_kwargs(case: dict) -> dict:
    """``make_sim`` keywords of a case: its ``make`` dict, its codec (with
    the case's ``refresh`` interval where it names one), its uneven cut
    (``widths``) and its ``overlap``."""
    kw = dict(case["make"])
    widths = kw.pop("widths", None)
    if widths is not None:
        kw["partition"] = Partition.from_widths(widths)
    delta = case["codec"]
    if "refresh" in case:
        cfg = resolve_delta(delta, 4)
        delta = DeltaConfig(enabled=cfg.enabled, qdtype=cfg.qdtype,
                            refresh_interval=case["refresh"],
                            migration=cfg.migration)
    kw["delta"] = delta
    kw["overlap"] = case.get("overlap", "auto")
    return kw


def build_sim(case: dict, mesh=None):
    """The case's sim on the CPU, initialised from its seed: on the
    virtual mesh, or this rank's device of a process ``mesh``."""
    mod = importlib.import_module("repro_torch.sims." + case["sim"])
    sim = make_sim(mod.behavior(), device="cpu", mesh=mesh,
                   **sim_kwargs(case))
    mod.init(sim, *case["init"])
    return sim


def mesh_shape(case: dict):
    widths = case["make"].get("widths")
    if widths is not None:
        return tuple(len(w) for w in widths)
    return tuple(case["make"]["mesh_shape"])


def _save(path: str, comm: ProcessMeshComm, arrays: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, coords=np.asarray(comm.coords()), **arrays)


def run_cases(rank: int, world: int, cases: dict, out: str) -> None:
    """Each case through the facade (``Simulation(mesh=)``, the segment
    runner and the refresh schedule): the rank's init and final state, and
    the global readings each rank gets."""
    torch.set_num_threads(1)
    for name, case in cases.items():
        mesh = make_abm_mesh(mesh_shape(case), device_type="cpu")
        sim = build_sim(case, mesh)
        comm = sim.engine._comm(mesh)
        _save(f"{out}/{name}/0/r{rank}.npz", comm, rank_arrays(sim.state))
        sim.run(case["steps"])
        _save(f"{out}/{name}/final/r{rank}.npz", comm,
              rank_arrays(sim.state))
        facts = dict(
            n_agents=sim.n_agents(),
            total_agents=total_agents(sim.state, comm),
            local_agents=total_agents(sim.state),
            overflow=codec_overflow_count(sim.state, comm),
            local_overflow=codec_overflow_count(sim.state),
            stats=dict(comm.stats))
        with open(f"{out}/{name}/final/r{rank}.json", "w") as f:
            json.dump(facts, f)


def steps_from_oracle(rank: int, world: int, name: str, case: dict,
                      oracle: str, out: str) -> None:
    """Each step of the case from the JAX state before it (``oracle``, the
    npz of ``torch_parity.run_mesh_oracle``), this rank's block of it
    stepped once through the process comm with the codec on."""
    torch.set_num_threads(1)
    mesh = make_abm_mesh(mesh_shape(case), device_type="cpu")
    sim = build_sim(case, mesh)
    comm = sim.engine._comm(mesh)
    step = sim.engine.make_local_step(mesh)
    with np.load(oracle) as z:
        data = {k: z[k] for k in z.files}
    for i in range(case["steps"]):
        pre = f"{name}/{i}/"
        arrays = {k[len(pre):]: v for k, v in data.items()
                  if k.startswith(pre)}
        state = rank_state(state_from_arrays(arrays, device="cpu"),
                           comm.coords())
        got = step(state, full_halo=case["codec"] == "off")
        _save(f"{out}/{name}/{i + 1}/r{rank}.npz", comm, rank_arrays(got))


def extras(rank: int, world: int, out: str) -> None:
    """On a 2x2 process mesh: ``operations``' reducers, a Simulation whose
    Domain's mesh is not the DeviceMesh's, the sir_mechanics ensemble on
    the process mesh, and ``shift``'s rules (a closed 2x2 mesh)."""
    from repro_torch.core import operations
    from repro_torch.core.ensemble import replica_state
    from repro_torch.core.simulation import Simulation
    from repro_torch.sims import cell_clustering as cc
    from repro_torch.sims import sir_mechanics as sm

    torch.set_num_threads(1)
    mesh = make_abm_mesh((2, 2), device_type="cpu")
    res = {}
    sim = make_sim(cc.behavior(), interior=(6, 6), mesh_shape=(2, 2),
                   cap=16, device="cpu", mesh=mesh)
    cc.init(sim, 200, seed=3)
    sim.run(2)
    res["agent_count"] = operations.agent_count(sim)
    res["attr_sum"] = operations.attr_sum("diameter")(sim)
    res["attr_mean"] = operations.attr_mean("diameter")(sim)
    res["attr_counts"] = list(operations.attr_counts("ctype", (0, 1))(sim))
    res["pos_sum"] = float(sim.sum_over_all_ranks(
        torch.where(sim.state.soa.valid[..., None], sim.state.soa.pos,
                    torch.zeros_like(sim.state.soa.pos)).sum()))
    try:
        Simulation(dict(interior=(6, 6), mesh_shape=(4, 1)), cc.behavior(),
                   device="cpu", mesh=mesh)
        res["refused"] = ""
    except ValueError as e:
        res["refused"] = str(e)

    eng, state = drive_case(mesh)
    _, state, _ = eng.drive(state, DRIVE_STEPS, mesh=mesh)
    _save(f"{out}/drive/r{rank}.npz", eng._comm(mesh), rank_arrays(state))

    ens = sm.ensemble_family(interior=(4, 4), mesh_shape=(2, 2),
                             delta=DeltaConfig(enabled=True), device="cpu")
    est = sm.ensemble_init(ens, ENSEMBLE_POINTS, n_agents=120,
                           initial_infected=6, mesh=mesh)
    est, _ = ens.run(est, ENSEMBLE_STEPS, mesh=mesh)
    comm = ens.proto_engine()._comm(mesh)
    for r in range(est.replicas):
        _save(f"{out}/ensemble/{r}/r{rank}.npz", comm,
              rank_arrays(replica_state(est.state, r)))

    comm = ProcessMeshComm.from_mesh(mesh, (False, False))
    x, y = comm.coords()
    pay = {"q": torch.full((1, 1, 3), 10 * x + y, dtype=torch.int8),
           "q/scale": torch.full((1, 1), 0.5 + rank, dtype=torch.float32),
           "valid": torch.full((1, 1, 3), bool(rank % 2))}
    for axis in (0, 1):
        for d in (1, -1):
            got = comm.shift(pay, axis, d)
            res[f"shift{axis}{d:+d}"] = {k: v.flatten().tolist()
                                         for k, v in got.items()}
    os.makedirs(f"{out}/extras", exist_ok=True)
    with open(f"{out}/extras/r{rank}.json", "w") as f:
        json.dump(dict(res, coords=list(comm.coords())), f)


DRIVE_STEPS = 6


def drive_case(mesh=None):
    """``(engine, state)`` for ``Engine.drive``: cell_clustering on a 2x2
    mesh with a fixed int8 codec scale small enough to clip, so
    ``Engine.drive`` forces full refreshes from ``codec_overflow_count``."""
    from repro_torch.core import Engine
    from repro_torch.sims import cell_clustering as cc

    sim = make_sim(cc.behavior(), interior=(6, 6), mesh_shape=(2, 2),
                   cap=16, device="cpu")
    cfg = DeltaConfig(enabled=True, qdtype=torch.int8, scale=2e-4,
                      migration=torch.int16)
    eng = Engine(geom=sim.geom, behavior=sim.behavior, delta_cfg=cfg,
                 dt=0.1, device="cpu")
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.5, np.asarray(eng.geom.domain_size) - 0.5,
                      (150, 2)).astype(np.float32)
    attrs = {"diameter": np.full((150,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, 150).astype(np.int32)}
    return eng, eng.init_state(pos, attrs, seed=5, mesh=mesh)


ENSEMBLE_POINTS = [dict(beta=0.1, seed=0), dict(beta=0.3, seed=1)]
ENSEMBLE_STEPS = 3


def torus_shift(rank: int, world: int, out: str) -> None:
    """``shift``'s rules on a 2x1 mesh, toroidal along the size-2 axis
    (both neighbours are the other rank: the +1 and -1 messages must not
    cross) and closed along the size-1 axis (zeros, no message)."""
    mesh = make_abm_mesh((2, 1), device_type="cpu")
    res = {}
    for tor1 in (False, True):
        comm = ProcessMeshComm.from_mesh(mesh, (True, tor1))
        pay = {"a": torch.tensor([[[rank, 7]]], dtype=torch.int32),
               "b": torch.tensor([[1.5 + rank]], dtype=torch.float32)}
        res[str(tor1)] = {
            f"{axis}{d:+d}": {k: v.flatten().tolist()
                              for k, v in comm.shift(pay, axis, d).items()}
            for axis in (0, 1) for d in (1, -1)}
        res[str(tor1)]["messages"] = comm.stats["messages"]
    os.makedirs(f"{out}/torus_shift", exist_ok=True)
    with open(f"{out}/torus_shift/r{rank}.json", "w") as f:
        json.dump(res, f)


def four_ranks(rank: int, world: int, cases: dict, jax_name: str,
               jax_case: dict, oracle: str, out: str) -> None:
    """Everything the test file runs on four ranks, in one spawn."""
    run_cases(rank, world, cases, out)
    steps_from_oracle(rank, world, jax_name, jax_case, oracle, out)
    extras(rank, world, out)


def two_ranks(rank: int, world: int, cases: dict, out: str) -> None:
    """Everything the test file runs on two ranks, in one spawn."""
    run_cases(rank, world, cases, out)
    torus_shift(rank, world, out)


def hang(rank: int, world: int) -> None:
    """Rank 0 returns; every other rank sleeps past any test's timeout."""
    if rank:
        import time
        time.sleep(3600)


def staged_payload(rank: int, device) -> dict:
    """A payload of every dtype a slab carries, seeded by ``rank``."""
    g = torch.Generator().manual_seed(rank)
    tree = {
        "pos": torch.randn((1, 1, 33, 5, 2), generator=g),
        "gid_rank": torch.randint(-2**31, 2**31 - 1, (1, 1, 33, 5),
                                  generator=g, dtype=torch.int32),
        "q8": torch.randint(-128, 127, (1, 1, 33, 5), generator=g,
                            dtype=torch.int8),
        "q16": torch.randint(-2**15, 2**15 - 1, (1, 1, 33, 5, 2),
                             generator=g, dtype=torch.int16),
        "pos/scale": torch.rand((1, 1), generator=g),
        "valid": torch.rand((1, 1, 33, 5), generator=g) > 0.5,
    }
    return {k: v.to(device) for k, v in tree.items()}


def staged_round_trip(rank: int, world: int, device: str, out: str) -> None:
    """Two ranks on a 2x1 torus exchange :func:`staged_payload` both ways
    through ``ProcessMeshComm.shift`` (on the card: packed on the device,
    staged through pinned host buffers, unpacked on the device); each
    writes whether what it received is the other rank's payload bit for
    bit, on its device, as views into one buffer."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    mesh = make_abm_mesh((2, 1), device_type=dev.type)
    comm = ProcessMeshComm.from_mesh(mesh, (True, False))
    want = staged_payload(1 - rank, dev)
    ok = {}
    for d in (1, -1):
        bad = []
        for _ in range(2):                # the second reuses the buffers
            got = comm.shift(staged_payload(rank, dev), 0, d)
            if len({v.untyped_storage().data_ptr()
                    for v in got.values()}) != 1:
                bad.append("not one buffer")
            bad += [k for k, v in want.items()
                    if got[k].device.type != dev.type
                    or got[k].dtype != v.dtype or got[k].shape != v.shape
                    or got[k].cpu().numpy().tobytes()
                    != v.cpu().numpy().tobytes()]
        ok[f"{d:+d}"] = bad or True
    ok["pinned"] = all(b.is_pinned() for k, b in comm._buffers.items()
                       if b.device.type == "cpu") if dev.type == "cuda" \
        else True
    with open(f"{out}/r{rank}.json", "w") as f:
        json.dump(ok, f)


# ---------------------------------------------------------------------------
# Dynamic load balancing and checkpoints on the process mesh
# ---------------------------------------------------------------------------

REBALANCE_STEPS = 6


def rebalance_sim(mesh=None):
    """cell_clustering on a 2x2 mesh of 16 x 16 cells (int8+mig) seeded
    with two diagonal clusters, rebalanced onto an uneven cut at tick 0
    (``Rebalance(every=3, threshold=0.1, ownership="rcb")``)."""
    from repro_torch.core.simulation import Rebalance
    from repro_torch.sims import cell_clustering as cc

    sim = make_sim(cc.behavior(adhesion=0.4), interior=(8, 8),
                   mesh_shape=(2, 2), cap=32, delta="int8+mig",
                   device="cpu", mesh=mesh,
                   rebalance=Rebalance(every=3, threshold=0.1,
                                       ownership="rcb", min_gain=1.05))
    rng = np.random.default_rng(7)
    n = 400
    c = np.asarray([(8.0, 8.0), (24.0, 24.0)])[rng.integers(0, 2, n)]
    pos = np.clip(c + rng.normal(0.0, 3.0, (n, 2)), 0.5,
                  31.5).astype(np.float32)
    sim.init(pos, {"diameter": np.full((n,), 1.0, np.float32),
                   "ctype": rng.integers(0, 2, n).astype(np.int32)}, seed=7)
    return sim


def rebalance_ranks(rank: int, world: int, out: str) -> None:
    """On four ranks: the rebalanced run, its history and final block; a
    checkpoint of it (gathered to rank 0); then a re-shard onto a 4x1 mesh
    (a new ``DeviceMesh``) by each transport, each rank's block kept."""
    from repro_torch.core.reshard import process_mesh, reshard_state

    torch.set_num_threads(1)
    mesh = make_abm_mesh((2, 2), device_type="cpu")
    sim = rebalance_sim(mesh)
    sim.run(REBALANCE_STEPS)
    comm = sim.engine._comm(sim.mesh)
    _save(f"{out}/final/r{rank}.npz", comm, rank_arrays(sim.state))
    hist = [{k: v for k, v in h.items() if k != "migration_s"}
            for h in sim.rebalancer.history]
    with open(f"{out}/final/r{rank}.json", "w") as f:
        json.dump(dict(history=repr(hist), n_agents=sim.n_agents(),
                       mesh=list(sim.mesh.mesh.shape)), f)
    sim.save(f"{out}/ckpt")
    # the elastic restore onto this 2x2 process mesh: each rank bins its
    # own block of the plan (an uneven cut may change the mesh's shape)
    from repro_torch.core.simulation import Simulation
    back = Simulation.restore(f"{out}/ckpt", sim.behavior, mesh=mesh,
                              device="cpu")
    _save(f"{out}/restored/r{rank}.npz", back.engine._comm(back.mesh),
          rank_arrays(back.state))
    for transport in ("device", "host"):
        eng, st = reshard_state(sim.engine, sim.state, mesh_shape=(4, 1),
                                transport=transport, mesh=sim.mesh)
        new = process_mesh((4, 1), sim.mesh)
        _save(f"{out}/{transport}/r{rank}.npz", eng._comm(new),
              rank_arrays(st))


# ---------------------------------------------------------------------------
# The scenario server, guards, fault plans and supervision on the process
# mesh
# ---------------------------------------------------------------------------

# (family keywords, requests as (params, steps, stream_every, seed))
SERVE_REQUESTS = [({"beta": 0.05}, 8, 4, 0), ({"beta": 0.2}, 12, 4, 1),
                  ({"gamma": 0.3, "sir_radius": 1.0}, 12, 0, 2)]
SERVE_FAMILY = {(2, 2): dict(n_agents=120, interior=(4, 4),
                             mesh_shape=(2, 2)),
                (2, 1): dict(n_agents=120, interior=(4, 8),
                             mesh_shape=(2, 1))}


def serve_frames(mesh_shape, mesh=None) -> dict:
    """Every request's frames of the sir_mechanics server on the family's
    mesh (a process ``mesh``, or the virtual one), keyed by rid."""
    from repro_torch.launch.serve import (
        ScenarioRequest, ScenarioServer, sir_mechanics_family)

    server = ScenarioServer([sir_mechanics_family(
        device="cpu", **SERVE_FAMILY[tuple(mesh_shape)])], slot_size=4,
        mesh=mesh)
    rids = [server.submit(ScenarioRequest(
        family="sir_mechanics", params=p, steps=n, stream_every=e, seed=s))
        for p, n, e, s in SERVE_REQUESTS]
    server.drain()
    return {str(r): [(int(t), np.asarray(f).tolist())
                     for t, f in server.handle(r).frames] for r in rids}


def serve_ranks(rank: int, world: int, out: str) -> None:
    """The server over a process mesh of ``world`` ranks (2x2 or 2x1)."""
    torch.set_num_threads(1)
    shape = (2, 2) if world == 4 else (2, 1)
    mesh = make_abm_mesh(shape, device_type="cpu")
    os.makedirs(f"{out}/serve", exist_ok=True)
    with open(f"{out}/serve/r{rank}.json", "w") as f:
        json.dump(serve_frames(shape, mesh), f)


GUARD_PLAN = [dict(step=2, kind="nan_attrs", frac=0.05),
              dict(step=3, kind="halo_slab", axis=1)]
GUARD_STEPS = 4
SUPERVISED_PLAN = [dict(step=6, kind="halo_slab", axis=0),
                   dict(step=8, kind="torn_checkpoint"),
                   dict(step=9, kind="raise")]
SUPERVISED_STEPS = 12


def a9_sim(guards, mesh=None):
    from repro_torch.sims import cell_clustering as cc
    sim = make_sim(cc.behavior(adhesion=0.4), interior=(6, 6),
                   mesh_shape=(2, 2), cap=16, dt=0.5, guards=guards,
                   device="cpu", mesh=mesh)
    cc.init(sim, 200, seed=3)
    return sim


def guarded_run(mesh=None):
    """A guarded run with a fault plan (a NaN burst, a corrupted halo
    slab), then a duplicate gid planted across devices: the run's sim,
    its global health counts, and the duplicate count."""
    import warnings

    from repro_torch.core import guards as g
    from repro_torch.distributed.chaos import Fault, FaultPlan

    sim = a9_sim("warn", mesh)
    plan = FaultPlan(tuple(Fault(**f) for f in GUARD_PLAN), seed=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim.run(GUARD_STEPS, fault_plan=plan)
    comm = sim._comm
    counts = g.health_counts(sim.state, comm).tolist()
    # the device (1, 1)'s first live agent takes gid (0, 0)
    st = sim.state
    at = (1, 1) if comm is None else (0, 0)
    if comm is None or tuple(comm.coords()) == (1, 1):
        v = st.soa.valid[at].reshape(-1)
        i = int(torch.nonzero(v)[0])
        for name in ("gid_rank", "gid_count"):
            st.soa.attrs[name][at].reshape(-1)[i] = 0
    return sim, counts, g.gid_duplicate_count(st, comm)


def supervised_run(ckpt_dir: str, mesh=None):
    """A supervised recovery: a corrupted halo slab, a torn checkpoint
    and an injected raise; the run's sim and its log."""
    import warnings

    from repro_torch.distributed.chaos import Fault, FaultPlan
    from repro_torch.launch.supervise import Supervised, Supervisor

    sim = a9_sim("error", mesh)
    plan = FaultPlan(tuple(Fault(**f) for f in SUPERVISED_PLAN), seed=3)
    sv = Supervisor(sim, Supervised(dir=ckpt_dir, every=4, keep=9),
                    fault_plan=plan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sv.run(SUPERVISED_STEPS)
    return sim, sv


# A device lost at step 6 of a supervised run, checkpoints every 4 steps
# (the virtual mesh's device_loss_2x2 plan); survivors None: the default,
# one device fewer.
DEGRADE_STEPS = 10
DEGRADE_SURVIVORS = {"degrade2": 2, "degrade3": None}
LOG_KEYS = ("kind", "step", "iteration", "error_type", "rolled_back_to",
            "devices", "replay_steps", "left")


def log_view(log) -> list:
    return [{k: e[k] for k in LOG_KEYS if k in e} for e in log]


def degrade_run(ckpt_dir: str, survivors, mesh=None):
    """A supervised 2x2 run that loses devices at step 6 and degrades
    onto the survivors; the run's sim and its supervisor."""
    from repro_torch.distributed.chaos import Fault, FaultPlan
    from repro_torch.launch.supervise import Supervised, Supervisor

    sim = a9_sim("error", mesh)
    plan = FaultPlan((Fault(step=6, kind="device_loss",
                            survivors=survivors),))
    sv = Supervisor(sim, Supervised(dir=ckpt_dir, every=4, keep=9),
                    fault_plan=plan)
    sv.run(DEGRADE_STEPS)
    return sim, sv


def a9_ranks(rank: int, world: int, out: str) -> None:
    """On four ranks: the server, a guarded run with faults, a supervised
    recovery onto the four ranks, and two device losses degraded onto two
    and three survivors."""
    serve_ranks(rank, world, out)
    torch.set_num_threads(1)
    mesh = make_abm_mesh((2, 2), device_type="cpu")
    sim, counts, dups = guarded_run(mesh)
    comm = sim.engine._comm(mesh)
    _save(f"{out}/guarded/r{rank}.npz", comm, rank_arrays(sim.state))
    sim, sv = supervised_run(f"{out}/ckpt", mesh)
    _save(f"{out}/supervised/r{rank}.npz", sim.engine._comm(sim.mesh),
          rank_arrays(sim.state))
    log = [{k: e[k] for k in ("kind", "step", "iteration", "error_type",
                              "rolled_back_to", "devices", "replay_steps")
            if k in e} for e in sv.log]
    facts = dict(counts=counts, dups=dups, log=log,
                 n_agents=sim.n_agents(), mesh=list(sim.geom.mesh_shape))
    for key, survivors in DEGRADE_SURVIVORS.items():
        sim, sv = degrade_run(f"{out}/ckpt_{key}", survivors, mesh)
        if not sv.left:
            _save(f"{out}/{key}/r{rank}.npz", sim.engine._comm(sim.mesh),
                  rank_arrays(sim.state))
        facts[key] = dict(
            log=log_view(sv.log), left=sv.left, iteration=sim.iteration,
            n_agents=None if sv.left else sim.n_agents(),
            mesh=list(sim.geom.mesh_shape))
    with open(f"{out}/a9_r{rank}.json", "w") as f:
        json.dump(facts, f)


SIMCHECK_CASE = dict(sim="cell_clustering",
                     make=dict(interior=(4, 4), mesh_shape=(2, 2), cap=24),
                     codec="int8+mig", init=(200, 3), steps=2)


def simcheck_ranks(rank: int, world: int, out: str) -> None:
    """On four ranks of a 2x2 process mesh: ``Simulation.validate`` of
    :data:`SIMCHECK_CASE` after two steps (its report, the rank's state and
    comm counters before and after, the block after one more step), the
    rank's own audit (its logged edges and host syncs), and the
    deprecated ``make_engine`` / ``run_sim`` pair driving the same mesh."""
    import warnings

    from repro_torch.analysis import audit_step
    from repro_torch.kernels import delta_codec
    from repro_torch.kernels import neighbor_interaction as ni
    from repro_torch.sims import cell_clustering as cc
    from repro_torch.sims.common import make_engine, run_sim

    torch.set_num_threads(1)
    case = SIMCHECK_CASE
    mesh = make_abm_mesh(mesh_shape(case), device_type="cpu")
    sim = build_sim(case, mesh)
    comm = sim.engine._comm(mesh)
    sim.run(case["steps"])
    before = rank_arrays(sim.state)
    counters = (dict(ni.LAUNCHES), dict(delta_codec.LAUNCHES),
                dict(comm.stats))
    rep = sim.validate()
    after = rank_arrays(sim.state)
    same = all(np.array_equal(before[k], after[k]) for k in before)
    kept = counters == (dict(ni.LAUNCHES), dict(delta_codec.LAUNCHES),
                        dict(comm.stats))
    audit = audit_step(sim.engine, mesh)
    sim.run(1)
    _save(f"{out}/simcheck/validated/r{rank}.npz", comm,
          rank_arrays(sim.state))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = make_engine(cc.behavior(), interior=(4, 4), mesh_shape=(2, 2),
                          cap=24, delta=resolve_delta("int8+mig", 4),
                          device="cpu")
    pos, attrs = shim_population()
    state = eng.init_state(pos, attrs, seed=3, mesh=mesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        state, _ = run_sim(eng, state, 3, mesh=mesh)
    _save(f"{out}/simcheck/run_sim/r{rank}.npz", eng._comm(mesh),
          rank_arrays(state))
    os.makedirs(f"{out}/simcheck", exist_ok=True)
    with open(f"{out}/simcheck/r{rank}.json", "w") as f:
        json.dump(dict(
            diagnostics=[d.to_dict() for d in rep],
            state_kept=same, counters_kept=kept,
            edges={ctx: [[a, d, [list(e) for e in es]]
                         for a, d, es in log]
                   for ctx, log in audit.edges.items()},
            syncs={ctx: sum(c.values()) for ctx, c in audit.syncs.items()},
            coords=list(comm.coords())), f)


def shim_population():
    """``(positions, attrs)`` of the ``run_sim`` shim's run: 200 agents of
    cell_clustering on the 8 x 8 cells of :data:`SIMCHECK_CASE`."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.5, 15.5, (200, 2)).astype(np.float32)
    return pos, {"diameter": np.full((200,), 1.0, np.float32),
                 "ctype": rng.integers(0, 2, 200).astype(np.int32)}


_HELD = []     # a DeviceMesh kept alive to the rank's end, as a sim keeps it


def gloo_threads() -> list:
    """The names of this process's gloo threads, from ``/proc``."""
    names = []
    for t in sorted(os.listdir("/proc/self/task")):
        try:
            with open(f"/proc/self/task/{t}/comm") as f:
                names.append(f.read().strip())
        except OSError:          # a thread that ended meanwhile
            pass
    return [n for n in names if "gloo" in n]


def teardown_ranks(rank: int, world: int, out: str) -> None:
    """A rank that keeps a 2x1 mesh alive to its end and drops a
    survivors' mesh of rank 0 (a group of its own): its gloo threads
    before and after :func:`close_process_mesh`."""
    _HELD.append(make_abm_mesh((2, 1), device_type="cpu"))
    sub = make_abm_mesh((1, 1), device_type="cpu", ranks=[0])
    before = gloo_threads()
    del sub
    close_process_mesh()
    with open(f"{out}/r{rank}.json", "w") as f:
        json.dump(dict(before=before, after=gloo_threads()), f)
