"""The process mesh (one process a device, ``core.halo.ProcessMeshComm``
over gloo) on the CPU, against the port's virtual mesh and the JAX
package's sharded engine.

Two spawns of ranks (``launch.mesh.spawn_ranks``; ``process_mesh_ranks``
holds their side), each on a file store under the test's temporary
directory, every rank on one torch thread, each spawn with a hard
timeout that kills its ranks:

* four ranks on 2x2 meshes: (a) ``cell_clustering`` closed, the codec off
  and ``int8+mig`` across a refresh; (c) ``cell_proliferation`` with its
  spawns (``gid_counter``, ``gid_rank`` per rank); (d) the uneven cut
  ``from_widths([(3, 5), (4, 4)])`` with ``overlap="on"``; case (a)
  ``int8+mig`` step by step from JAX's states; the reducers of
  ``operations``, a mesh of the wrong shape, ``Engine.drive`` with a
  clipping codec, the ``sir_mechanics`` ensemble, and ``shift``'s rules;
* two ranks: (b) ``epidemiology`` on a 2x1 torus (per-rank RNG keys; the
  size-2 torus, whose two directions go to one rank); (e)
  ``tumor_spheroid`` on a 1x1x2 mesh (D = 3); ``shift`` on the torus.

A spawn of four ranks (``a9``) runs the scenario server, a guarded run
with faults, a supervised recovery, and two supervised runs that lose
devices and degrade onto two and three survivors (each survivor's block
and log against the virtual mesh's degraded run; the ranks that left
stop at the fault); a spawn of two (``serve2``) runs the server on a 2x1
mesh.  Each server case requests only its own spawn.

Against the virtual mesh every field is bit-equal: integers, ``valid``,
the gids and the slot layout, and the floats' bytes (each device runs the
same operations in the same order in either layout).  Against JAX, the
repository's convention: integers exactly, floats to 1e-5.  The float
sums of ``operations`` differ from the virtual mesh's one reduction only
in their order across ranks: 1e-6 relative.
"""

import json
import os

import numpy as np
import pytest
import torch

import process_mesh_ranks as pmr
from repro_torch.bridge import assemble_ranks, state_to_arrays
from repro_torch.core import operations
from repro_torch.core.ensemble import replica_state
from repro_torch.core.halo import pack, pack_layout, unpack
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.sims import cell_clustering as cc
from repro_torch.sims import sir_mechanics as sm
from repro_torch.sims.common import make_sim
from torch_parity import (
    assert_dicts_close, oracle_state, run_mesh_oracle, torch_threads,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240.0

CLUSTER = dict(interior=(8, 8), mesh_shape=(2, 2), cap=16)
CASES4 = {
    "a-off": dict(sim="cell_clustering", codec="off", init=(300, 0),
                  steps=3, make=CLUSTER),
    "a-int8+mig": dict(sim="cell_clustering", codec="int8+mig",
                       init=(300, 0), steps=12, refresh=8, make=CLUSTER),
    "c-proliferation": dict(sim="cell_proliferation", codec="int16+mig",
                            init=(50, 0), steps=14,
                            make=dict(interior=(4, 4), mesh_shape=(2, 2),
                                      cap=32)),
    "d-uneven-overlap": dict(sim="cell_clustering", codec="int16+mig",
                             init=(200, 0), steps=4, overlap="on",
                             make=dict(widths=((3, 5), (4, 4)), cap=16)),
}
CASES2 = {
    "b-epidemiology-torus": dict(
        sim="epidemiology", codec="int8+mig", init=(200, 20, 0), steps=6,
        make=dict(interior=(5, 5), mesh_shape=(2, 1), cap=24,
                  boundary="toroidal", dt=1.0)),
    "e-spheroid": dict(sim="tumor_spheroid", codec="int16+mig",
                       init=(40, 0), steps=6,
                       make=dict(interior=(4, 4, 3), mesh_shape=(1, 1, 2),
                                 cap=32)),
}
# (a) int8+mig, each step from JAX's sharded engine's state before it
JAX_NAME = "a-jax"
JAX_CASE = dict(sim="cell_clustering", codec="int8+mig", init=(300, 0),
                steps=3, make=CLUSTER)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def oracle_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pm_oracle") / "oracle.npz")
    run_mesh_oracle({JAX_NAME: JAX_CASE}, path, ROOT, threads=1)
    return path


@pytest.fixture(scope="module")
def four(tmp_path_factory, oracle_path):
    out = str(tmp_path_factory.mktemp("pm_four"))
    spawn_ranks(pmr.four_ranks, 4, os.path.join(out, "store"),
                args=(CASES4, JAX_NAME, JAX_CASE, oracle_path, out),
                timeout_s=SPAWN_TIMEOUT_S)
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pm_two"))
    spawn_ranks(pmr.two_ranks, 2, os.path.join(out, "store"),
                args=(CASES2, out), timeout_s=SPAWN_TIMEOUT_S)
    return out


def _assembled(path: str, world: int):
    blocks = {}
    for r in range(world):
        with np.load(f"{path}/r{r}.npz") as z:
            blocks[tuple(int(c) for c in z["coords"])] = {
                k: z[k] for k in z.files if k != "coords"}
    return state_to_arrays(assemble_ranks(blocks, device="cpu"))


def _facts(path: str, world: int):
    out = []
    for r in range(world):
        with open(f"{path}/r{r}.json") as f:
            out.append(json.load(f))
    return out


def assert_bit_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k


def _virtual(case: dict):
    """(init arrays, final arrays, agents, codec overflow) of the case on
    the virtual mesh, through the same facade calls as the ranks."""
    sim = pmr.build_sim(case)
    init = state_to_arrays(sim.state)
    sim.run(case["steps"])
    return (init, state_to_arrays(sim.state), sim.n_agents(),
            int(sim.state.codec_overflow.max()))


def _check_case(out: str, name: str, case: dict, world: int):
    init, final, n, overflow = _virtual(case)
    assert_bit_equal(_assembled(f"{out}/{name}/0", world), init)
    assert_bit_equal(_assembled(f"{out}/{name}/final", world), final)
    facts = _facts(f"{out}/{name}/final", world)
    for f in facts:          # every rank reads the global values
        assert f["n_agents"] == f["total_agents"] == n
        assert f["overflow"] == overflow
    assert sum(f["local_agents"] for f in facts) == n
    assert max(f["local_overflow"] for f in facts) == overflow
    return final, facts


@pytest.mark.parametrize("name", sorted(CASES4))
def test_four_ranks_match_virtual_mesh(four, name):
    case = CASES4[name]
    final, facts = _check_case(four, name, case, 4)
    n0 = case["init"][0]
    if case["sim"] == "cell_proliferation":       # the spawn path ran
        assert int(final["soa.valid"].sum()) > n0
        assert (final["gid_counter"] > 0).all()
    else:
        assert int(final["soa.valid"].sum()) == n0
    if case["make"].get("mesh_shape") == (2, 2):
        # closed 2x2: one neighbour along each axis, one aura and one
        # migration message to it a step
        for f in facts:
            assert f["stats"]["messages"] == 4 * case["steps"]


@pytest.mark.parametrize("name", sorted(CASES2))
def test_two_ranks_match_virtual_mesh(two, name):
    final, _ = _check_case(two, name, CASES2[name], 2)
    assert int(final["soa.valid"].sum()) == CASES2[name]["init"][0]


@pytest.mark.parametrize("step", range(1, JAX_CASE["steps"] + 1))
def test_int8_mig_steps_match_jax_sharded(four, oracle_path, step):
    with np.load(oracle_path) as z:
        oracle = {k: z[k] for k in z.files}
    got = _assembled(f"{four}/{JAX_NAME}/{step}", 4)
    assert_dicts_close(got, oracle_state(oracle, JAX_NAME, step))


def test_reducers_are_global_and_wrong_mesh_is_refused(four):
    facts = _facts(f"{four}/extras", 4)
    sim = make_sim(cc.behavior(), interior=(6, 6), mesh_shape=(2, 2),
                   cap=16, device="cpu")
    cc.init(sim, 200, seed=3)
    sim.run(2)
    want_sum = operations.attr_sum("diameter")(sim)
    want_mean = operations.attr_mean("diameter")(sim)
    soa = sim.state.soa
    want_pos = float(torch.where(soa.valid[..., None], soa.pos,
                                 torch.zeros_like(soa.pos)).sum())
    for f in facts:
        assert f["agent_count"] == operations.agent_count(sim) == 200
        assert f["attr_counts"] == list(
            operations.attr_counts("ctype", (0, 1))(sim))
        assert f["attr_sum"] == pytest.approx(want_sum, rel=1e-6)
        assert f["attr_mean"] == pytest.approx(want_mean, rel=1e-6)
        assert f["pos_sum"] == pytest.approx(want_pos, rel=1e-6)
        assert "mesh of shape (2, 2)" in f["refused"]
        assert "(4, 1)" in f["refused"]


def test_engine_drive_on_process_mesh_matches_virtual(four):
    """``Engine.drive(..., mesh=)`` with a clipping fixed-scale codec: the
    forced refreshes follow every rank's overflow count (an all-reduce),
    and the final state is the virtual mesh's bit for bit."""
    eng, state = pmr.drive_case()
    _, state, _ = eng.drive(state, pmr.DRIVE_STEPS)
    assert int(state.codec_overflow.max()) > 0       # the codec clipped
    assert_bit_equal(_assembled(f"{four}/drive", 4), state_to_arrays(state))


def test_ensemble_on_process_mesh_matches_virtual(four):
    ens = sm.ensemble_family(interior=(4, 4), mesh_shape=(2, 2),
                             delta=pmr.DeltaConfig(enabled=True),
                             device="cpu")
    est = sm.ensemble_init(ens, pmr.ENSEMBLE_POINTS, n_agents=120,
                           initial_infected=6)
    est, _ = ens.run(est, pmr.ENSEMBLE_STEPS)
    for r in range(est.replicas):
        assert_bit_equal(_assembled(f"{four}/ensemble/{r}", 4),
                         state_to_arrays(replica_state(est.state, r)))


def test_shift_rules_on_a_closed_2x2_mesh(four):
    """Device (x, y) gets the payload of (x, y) - direction along the axis
    and zeros in every entry - ``/scale`` included - where there is none."""
    by_coords = {tuple(f["coords"]): f for f in _facts(f"{four}/extras", 4)}
    rank = {c: 2 * c[0] + c[1] for c in by_coords}
    for c, f in by_coords.items():
        for axis in (0, 1):
            for d in (1, -1):
                src = list(c)
                src[axis] -= d
                got = f[f"shift{axis}{d:+d}"]
                if 0 <= src[axis] < 2:
                    s = tuple(src)
                    assert got["q"] == [10 * s[0] + s[1]] * 3
                    assert got["q/scale"] == [0.5 + rank[s]]
                    assert got["valid"] == [bool(rank[s] % 2)] * 3
                else:
                    assert got == {"q": [0] * 3, "q/scale": [0.0],
                                   "valid": [False] * 3}


def test_shift_on_a_size_two_torus(two):
    """Both neighbours along the size-2 toroidal axis are the other rank:
    each direction gets its own message; the size-1 axis is zeros when
    closed and the identity when toroidal, with no message."""
    facts = _facts(f"{two}/torus_shift", 2)
    for rank, f in enumerate(facts):
        other = 1 - rank
        for tor1, res in f.items():
            for d in ("+1", "-1"):
                assert res["0" + d] == {"a": [other, 7], "b": [1.5 + other]}
                want = {"a": [rank, 7], "b": [1.5 + rank]} \
                    if tor1 == "True" else {"a": [0, 0], "b": [0.0]}
                assert res["1" + d] == want
            assert res["messages"] == 2


def test_packed_edge_buffer_round_trips_with_views():
    """Every dtype a payload carries packs into one byte buffer and comes
    back exactly, each entry a view into the buffer (no copy), at offsets
    aligned to ``PACK_ALIGN``."""
    g = torch.Generator().manual_seed(0)
    tree = {
        "pos": torch.randn((1, 1, 10, 3, 2), generator=g),
        "diameter": torch.randn((1, 1, 10, 3), generator=g),
        "gid_rank": torch.randint(-9, 9, (1, 1, 10, 3), generator=g,
                                  dtype=torch.int32),
        "q8": torch.randint(-128, 127, (1, 1, 7), generator=g,
                            dtype=torch.int8),
        "q16": torch.randint(-3000, 3000, (1, 1, 5, 2), generator=g,
                             dtype=torch.int16),
        "pos/scale": torch.tensor([[0.25]]),
        "valid": torch.rand((1, 1, 10, 3), generator=g) > 0.5,
        "empty": torch.zeros((1, 1, 0), dtype=torch.float32),
    }
    layout, nbytes = pack_layout(tree)
    buf = pack(tree, layout, torch.empty(nbytes, dtype=torch.uint8))
    back = unpack(buf, layout)
    base = buf.untyped_storage().data_ptr()
    for name, t in tree.items():
        got = back[name]
        assert got.dtype == t.dtype and got.shape == t.shape, name
        assert torch.equal(got, t), name
        assert got.untyped_storage().data_ptr() == base, name
    assert all(off % 16 == 0 for _, _, _, off, _ in layout)
    assert nbytes == sum(-(-n // 16) * 16 for *_, n in layout)


def test_spawn_kills_ranks_past_its_timeout(tmp_path):
    with pytest.raises(TimeoutError):
        spawn_ranks(pmr.hang, 2, str(tmp_path / "store"), timeout_s=8.0)


# ---------------------------------------------------------------------------
# Dynamic load balancing and checkpoints on the process mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rebalanced(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pm_rebalance"))
    spawn_ranks(pmr.rebalance_ranks, 4, os.path.join(out, "store"),
                args=(out,), timeout_s=SPAWN_TIMEOUT_S)
    return out


# A rank of the CLI under torchrun's environment, with its gloo threads
# written after ``simulate.main`` returns.
TORCHRUN_RANK = """
import json, os, sys
import process_mesh_ranks as pmr
from repro_torch.launch import simulate
simulate.main(["--sim", "cell_clustering", "--mesh", "2x1", "--device",
               "cpu", "--agents", "100", "--steps", "2"])
with open(os.path.join(sys.argv[1], "r%s.json" % os.environ["RANK"]),
          "w") as f:
    json.dump(dict(after=pmr.gloo_threads()), f)
"""


def _torchrun_ranks(out: str, world: int = 2) -> None:
    """``world`` processes of ``TORCHRUN_RANK`` joined as torchrun joins
    them (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]),
        WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo",
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", TORCHRUN_RANK, out],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        for r, p in enumerate(procs):
            log = p.communicate(timeout=SPAWN_TIMEOUT_S)[0]
            assert p.returncode == 0, f"rank {r}: {p.returncode}\n{log}"
    finally:
        for p in procs:
            p.kill()


@pytest.mark.parametrize("entry", ["spawn_ranks", "torchrun"])
def test_closing_a_process_mesh_joins_its_gloo_threads(entry, tmp_path):
    """ROADMAP C 10: a gloo group's threads are joined only when its last
    reference goes, and one left to the interpreter's teardown could
    abort a finished rank.  ``close_process_mesh`` (the end of every rank
    of ``spawn_ranks`` and of the CLI under torchrun) leaves no gloo
    thread running, with a mesh still held and after a survivors' mesh
    of a group of its own, and every rank ends with code 0."""
    out = str(tmp_path)
    if entry == "spawn_ranks":
        spawn_ranks(pmr.teardown_ranks, 2, os.path.join(out, "store"),
                    args=(out,), timeout_s=SPAWN_TIMEOUT_S)
    else:
        _torchrun_ranks(out)
    for r in range(2):
        with open(os.path.join(out, f"r{r}.json")) as f:
            threads = json.load(f)
        if entry == "spawn_ranks":
            assert "gloo_tcp_loop" in threads["before"], threads
        assert threads["after"] == [], threads


def test_rebalanced_run_matches_virtual_mesh(rebalanced, tmp_path):
    """The rebalanced run on four ranks (the histogram all-reduced, the
    agents moved by ``all_to_all_single``): every rank's block bit-equal
    to the virtual mesh's run, the same decisions, then a re-shard onto a
    4x1 mesh (a new DeviceMesh) by each transport bit-equal to the
    virtual mesh's; its checkpoint restores on the virtual mesh with the
    same agents by gid, and equals the virtual run's checkpoint."""
    from repro_torch.core.reshard import reshard_state
    from repro_torch.core.simulation import Simulation
    from repro_torch.distributed import checkpoint as ckpt_lib

    sim = pmr.rebalance_sim()
    sim.run(pmr.REBALANCE_STEPS)
    applied = [h for h in sim.rebalancer.history if h["applied"]]
    assert applied and sim.geom.uneven, sim.rebalancer.history
    assert_bit_equal(_assembled(f"{rebalanced}/final", 4),
                     state_to_arrays(sim.state))
    hist = [{k: v for k, v in h.items() if k != "migration_s"}
            for h in sim.rebalancer.history]
    for f in _facts(f"{rebalanced}/final", 4):
        assert f["history"] == repr(hist)
        assert f["n_agents"] == sim.n_agents() == 400
        assert tuple(f["mesh"]) == sim.geom.mesh_shape
    for transport in ("device", "host"):
        _, want = reshard_state(sim.engine, sim.state, mesh_shape=(4, 1),
                                transport=transport)
        assert_bit_equal(_assembled(f"{rebalanced}/{transport}", 4),
                         state_to_arrays(want))
    # the checkpoint: the virtual run's, leaf for leaf
    mine = sim.save(str(tmp_path / "virtual"))
    theirs = os.path.join(rebalanced, "ckpt", os.path.basename(mine))
    with open(os.path.join(mine, "manifest.json")) as a, \
            open(os.path.join(theirs, "manifest.json")) as b:
        assert json.load(a) == json.load(b)
    back = Simulation.restore(os.path.join(rebalanced, "ckpt"),
                              sim.behavior, n_devices=4, device="cpu")
    # each rank's restore onto the process mesh is its block of this one
    assert_bit_equal(_assembled(f"{rebalanced}/restored", 4),
                     state_to_arrays(back.state))

    def by_gid(state):
        v = state.soa.valid
        a = state.soa.attrs
        key = (a["gid_rank"][v].long() << 32) + a["gid_count"][v].long()
        order = torch.argsort(key)
        return {n: t[v][order] for n, t in a.items()}

    got, want = by_gid(back.state), by_gid(sim.state)
    assert set(got) == set(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    assert back.iteration == sim.iteration
    assert ckpt_lib.latest_step(os.path.join(rebalanced, "ckpt")) == 6


# ---------------------------------------------------------------------------
# The scenario server (A7), guards, fault plans and supervision (A9)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def a9(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pm_a9"))
    spawn_ranks(pmr.a9_ranks, 4, os.path.join(out, "store"), args=(out,),
                timeout_s=SPAWN_TIMEOUT_S)
    return out


@pytest.fixture(scope="module")
def serve2(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pm_serve2"))
    spawn_ranks(pmr.serve_ranks, 2, os.path.join(out, "store"),
                args=(out,), timeout_s=SPAWN_TIMEOUT_S)
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_server_over_a_process_mesh_matches_virtual(world, request):
    """Every rank builds the same server and submits the same requests;
    each streams the virtual-mesh server's frames, bit for bit (budgets 8
    and 12, streaming every 4 steps and at the end).  Each case requests
    only its own spawn: two ranks ``serve2``, four ``a9``."""
    out = request.getfixturevalue("a9" if world == 4 else "serve2")
    shape = (2, 2) if world == 4 else (2, 1)
    want = json.loads(json.dumps(pmr.serve_frames(shape)))
    assert [t for t, _ in want["0"]] == [4, 8]
    assert [t for t, _ in want["1"]] == [4, 8, 12]
    for r in range(world):
        with open(f"{out}/serve/r{r}.json") as f:
            assert json.load(f) == want
    for frames in want.values():
        assert all(sum(f) == 120 for _, f in frames)


def test_guarded_run_with_faults_matches_virtual(a9):
    """A NaN burst and a corrupted halo slab on four ranks: every rank's
    global health counts equal the virtual mesh's, its block is the
    virtual mesh's bit for bit; a gid duplicated across ranks is counted
    once (the keys routed to a rank by hash)."""
    sim, counts, dups = pmr.guarded_run()
    assert counts[0] > 0 and dups == 1
    assert_bit_equal(_assembled(f"{a9}/guarded", 4),
                     state_to_arrays(sim.state))
    for f in _facts_a9(a9):
        assert f["counts"] == counts
        assert f["dups"] == dups


def _facts_a9(out):
    res = []
    for r in range(4):
        with open(f"{out}/a9_r{r}.json") as f:
            res.append(json.load(f))
    return res


def test_supervised_recovery_on_four_ranks_matches_virtual(a9, tmp_path):
    """A supervised run on four ranks (a halo fault rolled back to 4, a
    torn checkpoint skipped by the next recovery): the log and every
    rank's final block equal the virtual mesh's supervised run; the
    recovery stays on the four ranks."""
    sim, sv = pmr.supervised_run(str(tmp_path / "ck"))
    keys = ("kind", "step", "iteration", "error_type", "rolled_back_to",
            "devices", "replay_steps")
    log = [{k: e[k] for k in keys if k in e} for e in sv.log]
    assert [e["rolled_back_to"] for e in sv.events("recovered")] == [4, 4]
    assert sv.events("torn_checkpoint")
    assert_bit_equal(_assembled(f"{a9}/supervised", 4),
                     state_to_arrays(sim.state))
    for f in _facts_a9(a9):
        assert f["log"] == log
        assert f["n_agents"] == sim.n_agents() == 200
        assert f["mesh"] == list(sim.geom.mesh_shape)


@pytest.mark.parametrize("key", sorted(pmr.DEGRADE_SURVIVORS))
def test_device_loss_degrades_a_process_mesh_onto_survivors(a9, key,
                                                             tmp_path):
    """A supervised four-rank run that loses devices at step 6 restores
    onto the survivors (two, and the default three): each survivor's
    block is the virtual mesh's degraded run's bit for bit, its log that
    run's; the ranks that left log the same recovery, ``left``, and
    stopped at the fault."""
    sim, sv = pmr.degrade_run(str(tmp_path / "ck"),
                              pmr.DEGRADE_SURVIVORS[key])
    n = sim.geom.n_devices
    assert n == (2 if key == "degrade2" else 3)
    log = pmr.log_view(sv.log)
    (rec,) = [e for e in log if e["kind"] == "recovered"]
    assert rec["devices"] == n and not sv.left
    assert_bit_equal(_assembled(f"{a9}/{key}", n),
                     state_to_arrays(sim.state))
    cut = log.index(rec) + 1
    for rank, f in enumerate(_facts_a9(a9)):
        got = f[key]
        if rank < n:
            assert not got["left"]
            assert got["log"] == log
            assert got["n_agents"] == sim.n_agents() == 200
            assert got["mesh"] == list(sim.geom.mesh_shape)
            assert got["iteration"] == sim.iteration == pmr.DEGRADE_STEPS
        else:
            assert got["left"]
            assert got["log"] == log[:cut - 1] + [dict(rec, left=True)]
            assert got["iteration"] == log[cut - 2]["iteration"]
