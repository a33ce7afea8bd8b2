"""The ranks' side of ``tests/test_torch_lm_mesh.py``: one function run by
:func:`repro_torch.launch.mesh.spawn_ranks` in each of four gloo
processes on the CPU.  It reads the numpy inputs the test wrote, runs the
port's LM mesh on them (``compressed_psum``, ``moe_apply_ep`` on two
meshes and both bodies, two sharded train steps of two configs, the
elastic restore of a JAX-written checkpoint) and writes what this rank
holds as npz for the test to assemble; nothing here imports JAX."""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import checkpoint as ck
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.elastic import elastic_restore
from repro_torch.distributed.grad_compress import compressed_psum
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models import params as P
from repro_torch.models.params import abstract_sharded
from repro_torch.models.model import build_model
from repro_torch.training import optimizer, steps

MOE = "phi3.5-moe-42b-a6.6b"
TRAIN = ("olmo-1b", MOE)
SCHED = dict(warmup_steps=2, stable_steps=3, decay_steps=2)
SEQ, BATCH, STEPS = 32, 4, 2
MOE_MESHES = ((2, 2), (1, 4))
MOE_SEQS = (8, 3)               # 8: the shard body; 3 % ep != 0: decode
# the other families: a (2, 2) step against the port's one-device step
FAMILIES = ("minicpm3-4b", "llava-next-mistral-7b", "hubert-xlarge",
            "zamba2-1.2b", "xlstm-1.3b")


def family_step(name: str, mesh=None):
    """One step of ``name``'s smoke model from ``params.init`` (seed 5),
    float32, over ``mesh`` (this rank's blocks) or on one device."""
    cfg = get(name).smoke
    model = build_model(cfg)
    params = P.init(model.spec, torch.Generator().manual_seed(5), "cpu",
                    mesh=mesh)
    params = P.tree_map(lambda a: a.float(), params)
    opt = optimizer.AdamW(schedule=optimizer.WSDSchedule(**SCHED))
    step = steps.make_train_step(model, opt, mesh=mesh)
    seq = SEQ + (cfg.n_patches if cfg.family == "vlm" else 0)
    pipe = SyntheticLM(cfg, seq_len=seq, global_batch=BATCH, device="cpu",
                       mesh=mesh)
    _, state, m = step(params, opt.init(params), pipe.batch_for_step(0))
    return m, state.master


def weights(inp, name: str, device="cpu"):
    """The test's float32 weights of ``name`` as the port's tree."""
    pre = f"w/{name}/"
    return bridge.lm_params_from_arrays(
        {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)},
        device)


def _blocks(tree, mesh, specs):
    """This rank's block of every leaf of a whole tree, in the spec
    tree's structure (a leafless subtree, a non-parametric norm's, kept)."""
    return {k: _blocks(tree.get(k, {}), mesh, v) if isinstance(v, dict)
            else shlib.block_of(tree[k], v, mesh).clone()
            for k, v in specs.items()}


def _flat(tree, prefix: str):
    return {f"{prefix}{k}": v
            for k, v in bridge.lm_params_to_arrays(tree).items()}


def lm_ranks(rank: int, world: int, out: str) -> None:
    torch.set_num_threads(1)
    inp = np.load(os.path.join(out, "inputs.npz"))
    res = {}

    # compressed_psum over a 1-D mesh of four
    mesh = make_mesh((4,), ("d",), device="cpu")
    col.reset_stats()
    x = torch.from_numpy(inp["cp/x"][rank])
    res["cp/y"] = compressed_psum(x, "d", axis_size=4, mesh=mesh).numpy()
    for op in ("all_to_all", "all_gather"):
        for dt, nb in col.STATS[op]["dtypes"].items():
            res[f"cp/{op}/{dt}"] = np.int64(nb)

    # the expert-parallel MoE, both bodies, two meshes
    cfg = get(MOE).smoke
    ffn = {k: v[0] for k, v in weights(inp, MOE)["blocks"]["ffn"].items()}
    for shape in MOE_MESHES:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        tag = "x".join(map(str, shape))
        blk = dict(ffn)
        for k in ("w_gate", "w_up", "w_down"):
            blk[k] = shlib.block_of(ffn[k], ("model",), mesh).clone()
        for s in MOE_SEQS:
            x = shlib.block_of(torch.from_numpy(inp[f"moe/x{s}"]),
                               ("data",), mesh)
            with shlib.activation_sharding(mesh):
                y, aux = moe.moe_apply_ep(blk, cfg, x)
            res[f"moe/{tag}/{s}/y"] = y.numpy()
            res[f"moe/{tag}/{s}/aux"] = aux.numpy()

    # two sharded train steps of each config on (2, 2)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    res["key"] = np.asarray(mesh.key())
    for name in TRAIN:
        cfg = get(name).smoke
        model = build_model(cfg)
        params = _blocks(weights(inp, name), mesh,
                         shlib.tree_specs(model.spec, mesh))
        opt = optimizer.AdamW(schedule=optimizer.WSDSchedule(**SCHED))
        state = opt.init(params)
        step = steps.make_train_step(model, opt, mesh=mesh)
        pipe = SyntheticLM(cfg, seq_len=SEQ, global_batch=BATCH,
                           device="cpu", mesh=mesh)
        for i in range(STEPS):
            params, state, m = step(params, state, pipe.batch_for_step(i))
            res[f"train/{name}/{i}/loss"] = m["loss"].numpy()
            res[f"train/{name}/{i}/grad_norm"] = m["grad_norm"].numpy()
        res.update(_flat(state.master, f"train/{name}/master/"))
        # a checkpoint from the mesh holds the logical arrays
        sh = P.tree_map(lambda p: p.sharding,
                        abstract_sharded(model.spec, mesh))
        ck.save(os.path.join(out, f"mesh_ckpt_{name}"), STEPS,
                state.master, shardings=sh)

    for name in FAMILIES:
        m, master = family_step(name, mesh)
        res[f"family/{name}/loss"] = m["loss"].numpy()
        res[f"family/{name}/grad_norm"] = m["grad_norm"].numpy()
        res.update(_flat(master, f"family/{name}/master/"))

    # the elastic restore of a JAX-written checkpoint onto the four ranks
    model = build_model(get("olmo-1b").smoke)
    step_, params, mesh, _ = elastic_restore(
        os.path.join(out, "ckpt"), model, device="cpu")
    res["elastic/step"] = np.int64(step_)
    res["elastic/key"] = np.asarray(mesh.key())
    res["elastic/shape"] = np.asarray(mesh.devices_shape)
    res.update(_flat(params, "elastic/p/"))
    res["out"] = np.asarray(out)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
