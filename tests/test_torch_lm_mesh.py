"""The port's LM mesh against the JAX package on the CPU: ``spec_for``,
``choose_lm_mesh``, ``compressed_psum``, ``moe_apply_ep`` (both bodies),
two sharded train steps of two configs, the elastic restore of a
JAX-written checkpoint, and ``SyntheticLM``'s blocks.

One JAX subprocess with four forced host devices computes every oracle
(``shard_map`` and ``jit`` under ``activation_sharding``); one
``spawn_ranks`` of four gloo ranks (``lm_mesh_ranks.lm_ranks``) computes
the port's side.  Inputs are numpy draws from fixed seeds (float32
weights, activations, the compressor's vector); the batches are
``SyntheticLM``'s, bit-equal in both packages.  Tolerances:

* ``spec_for``, ``choose_lm_mesh``, the batch blocks and the restored
  blocks exactly;
* ``compressed_psum``: every element within one quantum of its chunk
  (``max |reduced chunk| / 127``: a sum that lands on a rounding edge may
  round apart), and both wire phases carry int8 of the payload's size;
* ``moe_apply_ep``: output and aux to 1e-5;
* the train steps on float32 weights: loss and grad norm to 1e-5
  relative, the new master to 1e-6 absolute but at most one element in a
  thousand, each within twice the learning rates so far
  (``tests/test_torch_train.py``'s limits for a step whose gradients may
  round apart: the sharded sums add in another order, and AdamW's
  normalised step amplifies that where a gradient element is near zero).
"""

import os
import pathlib
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro.configs.base import get as j_get
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.distributed import checkpoint as j_ck
from repro.distributed import elastic as j_elastic
from repro.distributed import sharding as j_sharding
from repro.models import params as j_P
from repro.models.model import build_model as j_build
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import collectives as col
from repro_torch.distributed import elastic, sharding
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.model import build_model
from repro_torch.training import optimizer

import lm_mesh_ranks as lmr

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = [((1, 4), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 1), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]

ORACLE = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map_compat
from repro.configs.base import get
from repro.data.pipeline import SyntheticLM
from repro.distributed.grad_compress import compressed_psum
from repro.distributed.sharding import activation_sharding
from repro.launch.mesh import make_mesh
from repro.models import moe
from repro.models.model import build_model
from repro.training import optimizer as O, steps as S

inp = np.load({inp!r})
out = {{}}

def tree(name):
    pre = "w/" + name + "/"
    t = {{}}
    for k in inp.files:
        if k.startswith(pre):
            *heads, leaf = k[len(pre):].split(".")
            node = t
            for h in heads:
                node = node.setdefault(h, {{}})
            node[leaf] = jnp.asarray(inp[k])

    def fill(node, spec):       # leafless subtrees (a non-parametric norm)
        for k, v in spec.items():
            if isinstance(v, dict):
                fill(node.setdefault(k, {{}}), v)

    fill(t, build_model(get(name).smoke).spec)
    return t

def flat(t, prefix):
    leaves, _ = jax.tree_util.tree_flatten_with_path(t)
    return {{prefix + ".".join(p.key for p in path): np.asarray(v)
             for path, v in leaves}}

mesh = make_mesh((4,), ("d",))
f = jax.jit(shard_map_compat(
    lambda x: compressed_psum(x[0], "d", axis_size=4)[None], mesh=mesh,
    in_specs=P("d"), out_specs=P("d")))
out["cp/y"] = np.asarray(f(jnp.asarray(inp["cp/x"])))

cfg = get({moe_name!r}).smoke
ffn = jax.tree_util.tree_map(lambda a: a[0], tree({moe_name!r})["blocks"]["ffn"])
for shape in {moe_meshes!r}:
    mesh = make_mesh(shape, ("data", "model"))
    tag = "x".join(map(str, shape))
    for s in {moe_seqs!r}:
        with activation_sharding(mesh):
            y, aux = jax.jit(lambda p, x: moe.moe_apply_ep(p, cfg, x))(
                ffn, jnp.asarray(inp["moe/x%d" % s]))
        out["moe/%s/%d/y" % (tag, s)] = np.asarray(y)
        out["moe/%s/%d/aux" % (tag, s)] = np.asarray(aux)

mesh = make_mesh((2, 2), ("data", "model"))
opt = O.AdamW(schedule=O.WSDSchedule(**{sched!r}))
for name in {train!r}:
    cfg = get(name).smoke
    jm = build_model(cfg)
    p = tree(name)
    st = opt.init(p)
    step = jax.jit(S.make_train_step(jm, opt))
    pipe = SyntheticLM(cfg, seq_len={seq}, global_batch={batch})
    for i in range({steps}):
        with activation_sharding(mesh):
            p, st, m = step(p, st, pipe.batch_for_step(i))
        out["train/%s/%d/loss" % (name, i)] = np.asarray(m["loss"])
        out["train/%s/%d/grad_norm" % (name, i)] = np.asarray(m["grad_norm"])
    out.update(flat(st.master, "train/%s/master/" % name))
np.savez({path!r}, **out)
print("OK")
"""


def _weights(name: str, seed: int) -> dict:
    """Float32 weights of the smoke config from a numpy seed: ones and
    zeros where the spec says so, else normal draws times 0.02."""
    from repro_torch.models.params import tree_leaves

    rng = np.random.default_rng(seed)
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
            return
        if node.init == "ones":
            a = np.ones(node.shape, np.float32)
        elif node.init == "zeros":
            a = np.zeros(node.shape, np.float32)
        else:
            a = (rng.standard_normal(node.shape) * 0.02).astype(np.float32)
        out[f"w/{name}/" + ".".join(path)] = a

    walk(build_model(get(name).smoke).spec, ())
    assert len(out) == len(tree_leaves(build_model(get(name).smoke).spec))
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """``(oracle, ranks)``: the JAX subprocess's arrays and each rank's."""
    out = str(tmp_path_factory.mktemp("lm_mesh"))
    rng = np.random.default_rng(7)
    cfg = get(lmr.MOE).smoke
    inp = {"cp/x": rng.standard_normal((4, 256)).astype(np.float32)}
    for s in lmr.MOE_SEQS:
        inp[f"moe/x{s}"] = rng.standard_normal(
            (4, s, cfg.d_model)).astype(np.float32)
    for i, name in enumerate(lmr.TRAIN):
        inp.update(_weights(name, 11 + i))
    np.savez(os.path.join(out, "inputs.npz"), **inp)
    # a JAX-written checkpoint of the reference's own bf16 weights
    jm = j_build(j_get("olmo-1b").smoke)
    import jax
    jp = j_P.init(jm.spec, jax.random.PRNGKey(3))
    j_ck.save(os.path.join(out, "ckpt"), 5, jp)
    want = {k: np.asarray(v.astype("float32")) for k, v in
            _dotted(jp).items()}

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = str(ROOT / "src")
    path = os.path.join(out, "oracle.npz")
    code = ORACLE.format(
        inp=os.path.join(out, "inputs.npz"), path=path, moe_name=lmr.MOE,
        moe_meshes=lmr.MOE_MESHES, moe_seqs=lmr.MOE_SEQS, sched=lmr.SCHED,
        train=lmr.TRAIN, seq=lmr.SEQ, batch=lmr.BATCH, steps=lmr.STEPS)
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        spawn_ranks(lmr.lm_ranks, 4, os.path.join(out, "store"),
                    args=(out,), timeout_s=240.0)
    finally:
        so, se = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
    with np.load(path) as z:
        oracle = {k: z[k] for k in z.files}
    ranks = []
    for r in range(4):
        with np.load(os.path.join(out, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    return oracle, ranks, want


def _dotted(tree):
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(p.key for p in path): v for path, v in leaves}


def _assemble(ranks, prefix, specs, mesh_shape, axes, key="key"):
    """The whole arrays under ``prefix`` from every rank's block."""
    mesh = col.Mesh(axes, mesh_shape)
    out = {}
    names = [k[len(prefix):] for k in ranks[0] if k.startswith(prefix)]
    for name in names:
        spec = specs[name]
        blocks = {tuple(int(c) for c in r[key]):
                  torch.from_numpy(r[prefix + name]) for r in ranks}
        out[name] = sharding.assemble(blocks, spec, mesh).numpy()
    return out


def _dotted_specs(name, mesh):
    specs = sharding.tree_specs(build_model(get(name).smoke).spec, mesh)
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat[".".join(path)] = node

    walk(specs, ())
    return flat


# ---------------------------------------------------------------------------
# spec_for and choose_lm_mesh (no subprocess: they read only mesh.shape)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["1x4", "2x2", "4x1", "2x2x2"])
def test_spec_for_matches_jax(shape, axes):
    jmesh = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    mesh = col.Mesh(axes, shape)
    names = list(sharding.DEFAULT_RULES) + [None, "unknown"]
    assert set(sharding.DEFAULT_RULES) == set(j_sharding.DEFAULT_RULES)
    rng = np.random.default_rng(0)
    checked = 0
    for a in names:
        for b in names:
            for dims in ((8, 12), (6, 4), (16, 3), (2, 1), (32, 64),
                         tuple(int(d) for d in rng.integers(1, 20, 2))):
                for rules in (None, {"embed": ("model", "fsdp")}):
                    want = tuple(j_sharding.spec_for(
                        dims, (a, b), jmesh, rules))
                    got = sharding.spec_for(dims, (a, b), mesh, rules)
                    assert got == want, (dims, a, b, rules, got, want)
                    checked += 1
    # every leaf of every registered config's spec tree
    for name in ("olmo-1b", lmr.MOE, "minicpm3-4b", "zamba2-1.2b"):
        from repro_torch.models.params import tree_leaves

        spec = build_model(get(name).full).spec
        jspec = j_build(j_get(name).full).spec
        import jax

        jl = jax.tree_util.tree_leaves(
            j_sharding.tree_specs(jspec, jmesh),
            is_leaf=lambda x: isinstance(x, type(
                j_sharding.spec_for((1,), (None,), jmesh))))
        got = tree_leaves(sharding.tree_specs(spec, mesh))
        assert [tuple(p) for p in jl] == got, name
    assert checked > 1000


def test_choose_lm_mesh_matches_jax():
    for n in range(1, 1025):
        assert elastic.choose_lm_mesh(n) == j_elastic.choose_lm_mesh(n), n
    assert elastic.choose_lm_mesh(4) == ((1, 4), ("data", "model"))


@pytest.mark.parametrize("shape,axes", MESHES[:3],
                         ids=["1x4", "2x2", "4x1"])
def test_synthetic_blocks_are_slices_of_the_global_batch(shape, axes):
    for name in ("olmo-1b", "llava-next-mistral-7b"):
        cfg = get(name).smoke
        seq = 32 + (cfg.n_patches if cfg.family == "vlm" else 0)
        whole = JSyntheticLM(j_get(name).smoke, seq_len=seq,
                             global_batch=8).batch_for_step(3)
        for r in range(4):
            mesh = col.Mesh(axes, shape, rank=r)
            got = SyntheticLM(cfg, seq_len=seq, global_batch=8,
                              device="cpu", mesh=mesh).batch_for_step(3)
            i = mesh.axis_index(("data",))
            rows = 8 // mesh.shape["data"]
            for k, v in got.items():
                want = np.asarray(whole[k].astype("float32"))
                np.testing.assert_array_equal(
                    v.float().numpy(), want[i * rows:(i + 1) * rows])


# ---------------------------------------------------------------------------
# The mesh: one JAX subprocess, one spawn of four ranks
# ---------------------------------------------------------------------------

def test_compressed_psum_matches_jax(mesh_run):
    oracle, ranks, _ = mesh_run
    want = oracle["cp/y"]                       # (4, 256), every row equal
    total = want[0]
    chunks = np.abs(total.reshape(4, -1)).max(axis=1) / 127.0
    quantum = np.repeat(chunks, 64) * 1.01
    for r, got in enumerate(ranks):
        d = np.abs(got["cp/y"] - want[r])
        assert (d <= quantum).all(), (r, float(d.max()))
        # both wire phases carry int8: the (4, 64) payload of phase 1, the
        # 64-element reduced chunk of phase 2
        assert int(got["cp/all_to_all/int8"]) == 256
        assert int(got["cp/all_gather/int8"]) == 64


@pytest.mark.parametrize("shape", lmr.MOE_MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("seq", lmr.MOE_SEQS, ids=["shard", "decode"])
def test_moe_apply_ep_matches_jax(mesh_run, shape, seq):
    oracle, ranks, _ = mesh_run
    tag = "x".join(map(str, shape))
    want = oracle[f"moe/{tag}/{seq}/y"]
    rows = want.shape[0] // shape[0]
    for r, got in enumerate(ranks):
        d = r // shape[1]
        np.testing.assert_allclose(got[f"moe/{tag}/{seq}/y"],
                                   want[d * rows:(d + 1) * rows],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[f"moe/{tag}/{seq}/aux"],
                                   oracle[f"moe/{tag}/{seq}/aux"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", lmr.TRAIN)
def test_sharded_train_steps_match_jax(mesh_run, name):
    oracle, ranks, _ = mesh_run
    for i in range(lmr.STEPS):
        for key in ("loss", "grad_norm"):
            want = float(oracle[f"train/{name}/{i}/{key}"])
            for r in ranks:
                np.testing.assert_allclose(
                    float(r[f"train/{name}/{i}/{key}"]), want, rtol=1e-5,
                    err_msg=f"{key}@{i}")
    specs = _dotted_specs(name, col.Mesh(("data", "model"), (2, 2)))
    got = _assemble(ranks, f"train/{name}/master/", specs, (2, 2),
                    ("data", "model"))
    pre = f"train/{name}/master/"
    want = {k[len(pre):]: v for k, v in oracle.items() if k.startswith(pre)}
    _assert_masters(got, want, name)


def _assert_masters(got, want, label, steps=lmr.STEPS):
    """The master after ``steps`` steps to 1e-6, but at most one element
    in a thousand, each within twice the learning rates so far: AdamW's
    first steps move an element by lr * g / (|g| + eps), so where a
    gradient element is near zero (its terms cancel) another order of the
    sharded sums moves its step by up to 2 lr."""
    sched = optimizer.WSDSchedule(**lmr.SCHED)
    lr_sum = sum(float(sched(torch.tensor(i + 1))) for i in range(steps))
    assert sorted(got) == sorted(want), label
    n = off = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        n += d.size
        off += int((d > 1e-6).sum())
        assert d.max() <= 2 * lr_sum, (label, k, float(d.max()))
    assert off <= n // 1000, (label, off, n)


@pytest.mark.parametrize("name", lmr.FAMILIES)
def test_every_family_steps_on_the_mesh_as_on_one_device(mesh_run, name):
    """The families the JAX comparison above does not run (MLA, vlm,
    audio, hybrid, ssm): a (2, 2) step of the smoke model against the
    port's own one-device step (held to JAX's by
    ``tests/test_torch_train.py``)."""
    _, ranks, _ = mesh_run
    m, master = lmr.family_step(name)
    for r in ranks:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(r[f"family/{name}/{key}"]),
                                       float(m[key]), rtol=1e-5,
                                       err_msg=key)
    specs = _dotted_specs(name, col.Mesh(("data", "model"), (2, 2)))
    got = _assemble(ranks, f"family/{name}/master/", specs, (2, 2),
                    ("data", "model"))
    from repro_torch.bridge import lm_params_to_arrays

    _assert_masters(got, lm_params_to_arrays(master), name, steps=1)


@pytest.mark.parametrize("name", lmr.TRAIN)
def test_a_mesh_checkpoint_restores_in_jax_byte_for_byte(mesh_run, name,
                                                         tmp_path_factory):
    """``checkpoint.save(shardings=)`` on the (2, 2) mesh writes the
    logical arrays: the reference's ``restore`` reads the assembled
    blocks back exactly."""
    _, ranks, _ = mesh_run
    specs = _dotted_specs(name, col.Mesh(("data", "model"), (2, 2)))
    got = _assemble(ranks, f"train/{name}/master/", specs, (2, 2),
                    ("data", "model"))
    out = pathlib.Path(ranks[0]["out"].item())
    step, flat, _ = j_ck.restore(str(out / f"mesh_ckpt_{name}"))
    assert step == lmr.STEPS
    assert sorted(flat) == sorted(k.replace(".", "/") for k in got)
    for k, v in got.items():
        a = np.asarray(flat[k.replace(".", "/")])
        assert a.dtype == v.dtype and np.array_equal(a, v), k


def test_production_mesh_and_abstract_specs():
    """The H100 production layouts, and ``abstract_sharded`` /
    ``opt_specs`` on them: meta tensors carrying the specs ``tree_specs``
    gives, equal to JAX's ``spec_for`` on the same shape."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import opt_specs, params_specs, rules_for
    from repro_torch.models.params import tree_leaves

    mesh = make_production_mesh()
    assert mesh.shape == {"data": 32, "model": 8} and mesh.rank is None
    pod = make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 32, "model": 8}
    model = build_model(get(lmr.MOE).full)
    for m in (mesh, pod):
        jmesh = types.SimpleNamespace(shape=m.shape)
        abs_ = params_specs(model, m, rules_for(model.cfg))
        opt = opt_specs(abs_, m)
        for leaf, spec, o in zip(tree_leaves(abs_), tree_leaves(
                model.spec), tree_leaves(opt.master)):
            assert leaf.device.type == "meta" and tuple(
                leaf.shape) == spec.shape and leaf.dtype == spec.dtype
            want = tuple(j_sharding.spec_for(spec.shape, spec.logical,
                                             jmesh))
            assert leaf.sharding.spec == want
            assert o.dtype == torch.float32 and o.sharding == leaf.sharding
        assert opt.step.dtype == torch.int32
    with pytest.raises(RuntimeError, match="layout-only"):
        col.gather_raw(torch.zeros(2), "model", mesh)
    assert rules_for(model.cfg) is None


def test_elastic_restore_of_a_jax_checkpoint(mesh_run):
    _, ranks, want = mesh_run
    for r in ranks:
        assert int(r["elastic/step"]) == 5
        assert tuple(r["elastic/shape"]) == (1, 4)
    specs = _dotted_specs("olmo-1b", col.Mesh(("data", "model"), (1, 4)))
    got = _assemble(ranks, "elastic/p/", specs, (1, 4), ("data", "model"),
                    key="elastic/key")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
