"""Logical checkpoints and the elastic restore
(``repro_torch.distributed.checkpoint``, ``distributed.elastic``, the
facade's ``Checkpoint``, ``save`` and ``restore``) against the JAX
package on the CPU, in this process.

The checkpoint tests of ``tests/test_resilience.py`` are mirrored on the
port's module.  The on-disk layout is the reference's: the same state
checkpointed by both packages gives the same manifest (leaf keys and
order, file names, shapes, dtypes, crc32s and the ``abm`` extras) and the
same leaf bytes, and a checkpoint either package writes restores in the
other onto 1 and 4 devices, equal field by field to that package's own
restore, the ownership mode kept.
"""

import json
import os
import pathlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DeltaConfig as JDeltaConfig, Engine as JEngine
from repro.distributed import checkpoint as jck
from repro.distributed.elastic import elastic_restore_abm as j_restore
from repro.sims import cell_clustering as j_cc
from repro_torch.bridge import state_to_arrays
from repro_torch.core import Engine, total_agents
from repro_torch.core import reshard as rs
from repro_torch.core.delta import DeltaConfig
from repro_torch.core.simulation import Checkpoint, Rebalance, Simulation
from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.distributed import elastic
from repro_torch.distributed.elastic import elastic_restore_abm
from repro_torch.sims import cell_clustering as cc
from torch_parity import (
    assert_dicts_close, clustered, geoms, jax_state_arrays,
    jax_state_from_arrays, torch_threads,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


# ---------------------------------------------------------------------------
# test_resilience.py's checkpoint tests, mirrored
# ---------------------------------------------------------------------------

def test_async_checkpointer_reraises_background_error(tmp_path):
    blocker = tmp_path / "ckpts"
    blocker.write_text("not a directory")
    ck = ckpt_lib.AsyncCheckpointer(str(blocker))
    ck.save(1, {"x": np.arange(4)})
    with pytest.raises(FileExistsError):
        ck.wait()
    # the error is consumed: a later wait() is clean
    assert ck.wait() is None


def test_async_checkpointer_sweeps_stale_tmp(tmp_path):
    stale = tmp_path / ".tmp_step_0000000003_999999999"
    stale.mkdir(parents=True)
    (stale / "leaf_00000.npy").write_bytes(b"junk")
    live = tmp_path / f".tmp_step_0000000004_{os.getpid()}"
    live.mkdir()
    ck = ckpt_lib.AsyncCheckpointer(str(tmp_path))
    assert not stale.exists()
    assert live.exists()  # this process's pid: a concurrent writer
    assert str(stale) in ck.swept


def test_latest_step_skips_manifestless_dir(tmp_path):
    ckpt_lib.save(str(tmp_path), 5, {"x": np.arange(3)})
    (tmp_path / "step_0000000009").mkdir()
    with pytest.warns(UserWarning, match="step_0000000009"):
        assert ckpt_lib.latest_step(str(tmp_path)) == 5


def test_restore_skips_checksum_corrupt_checkpoint(tmp_path):
    ckpt_lib.save(str(tmp_path), 5, {"x": np.arange(3)})
    ckpt_lib.save(str(tmp_path), 10, {"x": np.arange(3) + 10})
    np.save(tmp_path / "step_0000000010" / "leaf_00000.npy",
            np.arange(3) + 99)
    with pytest.warns(UserWarning, match="step_0000000010"):
        step, flat, _ = ckpt_lib.restore(str(tmp_path))
    assert step == 5
    np.testing.assert_array_equal(flat["x"], np.arange(3))
    with pytest.raises(ckpt_lib.CheckpointCorrupt, match="checksum"):
        ckpt_lib.restore(str(tmp_path), step=10)


def test_restore_skips_torn_leaf(tmp_path):
    ckpt_lib.save(str(tmp_path), 5, {"x": np.arange(100)})
    ckpt_lib.save(str(tmp_path), 10, {"x": np.arange(100)})
    leaf = tmp_path / "step_0000000010" / "leaf_00000.npy"
    with open(leaf, "r+b") as fh:
        fh.truncate(leaf.stat().st_size // 2)
    with pytest.warns(UserWarning, match="step_0000000010"):
        step, _, _ = ckpt_lib.restore(str(tmp_path))
    assert step == 5


def test_restore_all_corrupt_raises(tmp_path):
    ckpt_lib.save(str(tmp_path), 5, {"x": np.arange(3)})
    (pathlib.Path(tmp_path) / "step_0000000005" / "manifest.json"
     ).write_text("{broken")
    with pytest.warns(UserWarning):
        with pytest.raises(FileNotFoundError, match="no usable"):
            ckpt_lib.restore(str(tmp_path))


def test_save_manifest_carries_crc32(tmp_path):
    ckpt_lib.save(str(tmp_path), 3, {"x": np.arange(7, dtype=np.int32)})
    man = json.loads(
        (tmp_path / "step_0000000003" / "manifest.json").read_text())
    leaf = man["leaves"][0]
    assert leaf["crc32"] == zlib.crc32(np.arange(7, dtype=np.int32).tobytes())


# ---------------------------------------------------------------------------
# Generic trees: the reference's layout, torch leaves, bf16, keep
# ---------------------------------------------------------------------------

def test_generic_tree_layout_equals_jax_and_round_trips(tmp_path):
    tree = {"w": {"b": np.arange(3, dtype=np.float32),
                  "a": np.ones((2, 2), np.int64)},
            "step": np.asarray(4, np.int32), "list": [np.zeros(2)]}
    mine = ckpt_lib.save(str(tmp_path / "port"), 7, tree, extras={"k": 1})
    theirs = jck.save(str(tmp_path / "jax"), 7, tree, extras={"k": 1})
    man = json.loads((pathlib.Path(mine) / "manifest.json").read_text())
    assert man == json.loads(
        (pathlib.Path(theirs) / "manifest.json").read_text())
    assert [leaf["key"] for leaf in man["leaves"]] == [
        "list/0", "step", "w/a", "w/b"]
    # torch leaves (bf16 widened, its dtype recorded) restore into `like`
    like = {"a": torch.arange(5, dtype=torch.bfloat16),
            "b": torch.full((2,), 3, dtype=torch.int16)}
    ckpt_lib.save(str(tmp_path / "bf16"), 1, like)
    man = json.loads((tmp_path / "bf16" / "step_0000000001" /
                      "manifest.json").read_text())
    assert [leaf["dtype"] for leaf in man["leaves"]] == ["bfloat16", "int16"]
    step, back, _ = ckpt_lib.restore(str(tmp_path / "bf16"), like=like)
    assert step == 1 and back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"], like["a"]) and torch.equal(back["b"],
                                                             like["b"])
    for s in range(2, 7):
        ckpt_lib.save(str(tmp_path / "bf16"), s, like, keep=2)
    assert ckpt_lib.latest_step(str(tmp_path / "bf16")) == 6
    assert len(list((tmp_path / "bf16").glob("step_*"))) == 2


def test_lm_half_of_elastic_raises_naming_a12(tmp_path):
    """The LM half raised, naming ROADMAP A12, until the LM mesh came; now
    it runs: ``choose_lm_mesh`` is the reference's, and one process
    restores a checkpoint onto its one-device mesh exactly (the four-rank
    restore of a JAX checkpoint is in ``tests/test_torch_lm_mesh.py``).
    Asking for more devices than processes still raises."""
    from repro_torch.configs import get
    from repro_torch.models import params as P
    from repro_torch.models.model import build_model

    assert elastic.choose_lm_mesh(8) == ((1, 8), ("data", "model"))
    assert elastic.choose_lm_mesh(48) == ((3, 16), ("data", "model"))
    model = build_model(get("olmo-1b").smoke)
    params = P.init(model.spec, torch.Generator().manual_seed(0), "cpu")
    ckpt_lib.save(str(tmp_path), 5, params)
    step, restored, mesh, _ = elastic.elastic_restore(
        str(tmp_path), model, device="cpu")
    assert step == 5 and mesh.shape == {"data": 1, "model": 1}
    for a, b in zip(P.tree_leaves(params), P.tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="one process a device"):
        elastic.elastic_restore(str(tmp_path), model, n_devices=8,
                                device="cpu")


# ---------------------------------------------------------------------------
# ABM checkpoints: the layout and cross-restore against JAX
# ---------------------------------------------------------------------------

def abm_pair(start: str, steps: int = 3):
    """A cell_clustering run on ``start`` (int8 codec + int16 migration),
    ``steps`` steps in: the port's engine and state and JAX's of the same
    state."""
    g, jg = geoms(start)
    cfg = DeltaConfig(enabled=True, qdtype=torch.int8,
                      migration=torch.int16)
    eng = Engine(geom=g, behavior=cc.behavior(adhesion=0.4), dt=0.1,
                 delta_cfg=cfg, device="cpu")
    st = eng.init_state(*clustered(400, 0), seed=0)
    _, st, _ = eng.drive(st, steps)
    st.dropped[0, 1] += 2
    jeng = JEngine(geom=jg, behavior=j_cc.behavior(adhesion=0.4), dt=0.1,
                   delta_cfg=JDeltaConfig(enabled=True, qdtype=jnp.int8,
                                          migration=jnp.int16))
    return eng, st, jeng, jax_state_from_arrays(state_to_arrays(st))


@pytest.mark.parametrize("start", ["2x2", "uneven"])
def test_save_abm_layout_equals_jax(start, tmp_path):
    eng, st, jeng, jst = abm_pair(start)
    mine = pathlib.Path(ckpt_lib.save_abm(str(tmp_path / "p"), 3, eng, st))
    theirs = pathlib.Path(jck.save_abm(str(tmp_path / "j"), 3, jeng, jst))
    assert mine.name == theirs.name == "step_0000000003"
    man = json.loads((mine / "manifest.json").read_text())
    assert man == json.loads((theirs / "manifest.json").read_text())
    assert [leaf["key"] for leaf in man["leaves"]] == [
        "attrs/ctype", "attrs/diameter", "attrs/gid_count",
        "attrs/gid_rank", "base_key", "gid_counters", "histogram",
        "positions"]
    meta = man["extras"]["abm"]
    assert meta["ownership"] == ("rcb" if start == "uneven" else "equal")
    assert meta["delta"]["qdtype"] == "int8" and meta["dropped_total"] == 2
    for leaf in man["leaves"]:
        assert (mine / leaf["file"]).read_bytes() == (
            theirs / leaf["file"]).read_bytes(), leaf["key"]


@pytest.mark.parametrize("n_devices", [1, 4])
@pytest.mark.parametrize("start", ["2x2", "uneven"])
def test_checkpoints_cross_restore(start, n_devices, tmp_path):
    eng, st, jeng, jst = abm_pair(start)
    jck.save_abm(str(tmp_path / "j"), 3, jeng, jst)
    ckpt_lib.save_abm(str(tmp_path / "p"), 3, eng, st)
    want_e, want_s, _ = j_restore(str(tmp_path / "j"), j_cc.behavior(
        adhesion=0.4), n_devices=n_devices)
    for src in ("j", "p"):
        # the port restores a JAX checkpoint and its own alike
        e, s, step = elastic_restore_abm(
            str(tmp_path / src), cc.behavior(adhesion=0.4),
            n_devices=n_devices, device="cpu")
        assert step == 3
        assert e.geom.mesh_shape == want_e.geom.mesh_shape
        assert e.geom.uneven == want_e.geom.uneven == (
            start == "uneven" and n_devices > 1)
        if e.geom.uneven:
            assert e.geom.partition.cuts == want_e.geom.partition.cuts
        assert e.dt == want_e.dt and e.delta_cfg.qdtype == torch.int8
        # the stored codec has no migration key in either package: a
        # "+mig" run restores with raw float32 migration (ROADMAP C 7)
        assert e.delta_cfg.migration is None
        assert want_e.delta_cfg.migration is None
        assert_dicts_close(state_to_arrays(s), jax_state_arrays(want_s))
        assert total_agents(s) == 400 and int(s.dropped.sum()) == 2
    # JAX restores the port's checkpoint as its own
    je, js, _ = j_restore(str(tmp_path / "p"), j_cc.behavior(adhesion=0.4),
                          n_devices=n_devices)
    assert je.geom == want_e.geom
    assert_dicts_close(jax_state_arrays(js), jax_state_arrays(want_s))


def test_restore_is_a_host_reshard_of_the_saved_state(tmp_path):
    """``Simulation.save`` then ``Simulation.restore`` gives the state a
    host re-shard of the live state onto the restored geometry gives, bit
    for bit (the carry included), and steps on."""
    sim = Simulation(dict(interior=(8, 8), mesh_shape=(2, 2), cap=32),
                     cc.behavior(), dt=0.1, device="cpu")
    sim.init(*clustered(300, 3), seed=3)
    sim.run(3)
    path = sim.save(str(tmp_path))
    assert path.endswith("step_0000000003")
    for n in (1, 4):
        back = Simulation.restore(str(tmp_path), cc.behavior(), n_devices=n,
                                  device="cpu")
        assert back.iteration == 3 and back.engine.delta_cfg == \
            sim.engine.delta_cfg
        _, want = rs.reshard_state(sim.engine, sim.state,
                                   mesh_shape=back.geom.mesh_shape,
                                   transport="host")
        a, b = state_to_arrays(back.state), state_to_arrays(want)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a), [
            k for k in a if a[k].tobytes() != b[k].tobytes()]
        back.run(2)
        assert back.n_agents() == 300 and back.iteration == 5


def test_scheduled_checkpoints_and_restore_keep_ownership(tmp_path):
    sim = Simulation(dict(interior=(8, 8), mesh_shape=(2, 2), cap=64),
                     cc.behavior(adhesion=0.3), dt=0.1, device="cpu",
                     rebalance=Rebalance(every=4, threshold=0.3,
                                         ownership="rcb"),
                     checkpoint=Checkpoint(str(tmp_path), every=3, keep=2))
    sim.init(*clustered(500, 0), seed=0)
    sim.run(9)
    assert sim.geom.uneven
    assert ckpt_lib.latest_step(str(tmp_path)) == 9
    assert len(list(tmp_path.glob("step_*"))) == 2
    for n in (1, 4):
        back = Simulation.restore(str(tmp_path), cc.behavior(adhesion=0.3),
                                  n_devices=n, device="cpu")
        assert back.iteration == 9 and back.n_agents() == 500
        assert back.geom.uneven == (n > 1)
        back.run(1)
        assert back.n_agents() == 500
    # guards= is ported (A9; tests/test_torch_resilience.py): the
    # restored facade and its engine carry them
    guarded = Simulation.restore(str(tmp_path), cc.behavior(adhesion=0.3),
                                 device="cpu", guards="warn")
    assert guarded.engine.guards.policy == "warn"
    ack = ckpt_lib.AsyncCheckpointer(str(tmp_path / "async"))
    ack.save_abm(sim.iteration, sim.engine, sim.state)
    assert ack.wait().endswith("step_0000000009")
