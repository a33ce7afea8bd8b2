"""Parity of the port's LM training path with the JAX package on the CPU:
the WSD schedule and AdamW, ``loss_fn``'s value and gradients for one
config of each family, remat, the train step (accumulation, gradient
compression), the synthetic batches and their RNG, checkpoints of a
train state (resume, and across the two packages), the launcher and the
example, and two repairs of the port: the attention kernel's wrapper
raises under autograd (ROADMAP B5 b) and checkpoints hold NamedTuples.

The same numpy inputs, and the reference's own ``P.init`` weights carried
by ``repro_torch.bridge``, go through both packages.  Tolerances:

* the schedule bit for bit; AdamW's master, m and v to 1e-6 relative (XLA
  fuses ``b1 * m + (1 - b1) * g`` into a multiply-add, torch rounds twice),
  bf16 parameters within one bf16 ulp;
* ``jax.value_and_grad(loss_fn)`` on float32 weights at ``remat="none"``:
  the loss to 1e-5, every gradient leaf to 1e-4 of its largest element.
  xLSTM's mLSTM rounds its chunk products' operands to bf16 on float32
  weights too (the reference's design), so its mLSTM leaves are held to
  2e-3 (a one-ulp flip of a bf16 operand is 2^-9 of it; JAX's own compiled
  and op-by-op gradients there differ by up to 6.5e-4), against the
  reference's accelerator branch (``jax.default_backend()`` reads
  ``"gpu"`` while tracing: on XLA:CPU the reference rounds its chunk
  products to bf16 as well, which the port, written for the card, does
  not; its float32 dots run on the CPU either way);
* bf16 weights: the loss to 2e-4, every leaf to 3e-2 of its max, for the
  dense, MLA, vlm, audio and hybrid configs.  A bf16 MoE router flips an
  expert on one ulp of its input and a bf16 sLSTM amplifies rounding ~10x
  a step (ROADMAP §C), so qwen3-moe and xlstm-1.3b are compared on float32
  weights only;
* the four remat policies give bit-equal gradients, and so do the sLSTM's
  segmented and unsegmented backward;
* the train step on float32 weights: loss and gradient norm to 1e-5
  relative, the new master to 1e-6 absolute; with the compressor its
  transmitted gradients to one quantum of its scale (a delta that lands
  on a rounding edge may round apart) and the master to 1e-6 but at such
  elements (at most one in a thousand, within twice the learning rates
  so far); the compressor alone on identical inputs bit for bit;
* batches, ``randint`` and the bf16 ``normal`` bit for bit.
"""

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get as j_get, names as j_names
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.distributed import checkpoint as j_ck
from repro.distributed.grad_compress import DeltaEFCompressor as JComp
from repro.models import mamba2 as j_m2
from repro.models import params as j_P
from repro.models.model import build_model as j_build
from repro.training import optimizer as j_opt
from repro.training import steps as j_steps
from repro_torch import bridge
from repro_torch.configs import get
from repro_torch.core import prng
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import checkpoint as ck
from repro_torch.distributed.grad_compress import DeltaEFCompressor
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import mamba2 as m2
from repro_torch.models import params as P
from repro_torch.models import xlstm as xl
from repro_torch.models.model import build_model
from repro_torch.training import optimizer, steps

from torch_parity import torch_threads

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("olmo-1b", "minicpm3-4b", "qwen3-moe-235b-a22b",
            "llava-next-mistral-7b", "hubert-xlarge", "xlstm-1.3b",
            "zamba2-1.2b")
BF16_FAMILIES = ("olmo-1b", "minicpm3-4b", "llava-next-mistral-7b",
                 "hubert-xlarge", "zamba2-1.2b")
SEQ, BATCH = 64, 2
F32_LOSS, F32_GRAD, MLSTM_GRAD = 1e-5, 1e-4, 2e-3
BF16_LOSS, BF16_GRAD = 2e-4, 3e-2


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the other test workers, torch's default
    pool oversubscribes the cores (test_torch_engine's rule)."""
    with torch_threads(1):
        yield


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _arrays(tree):
    """A JAX tree of dicts as ``{dotted path: numpy}`` (bf16 kept)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def _port_arrays(tree):
    return {k: v.astype(np.float32)
            for k, v in bridge.lm_params_to_arrays(tree).items()}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    jm = j_build(j_get(name).smoke)
    return jm, jax.jit(lambda key: j_P.init(jm.spec, key))(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _models(name, dtype):
    """The JAX model and weights (bf16 as ``P.init`` makes them, or float32
    copies) and the port's model holding the same weights."""
    jm, jp = _jax_model(name)
    if dtype == "f32":
        jp = _f32(jp)
    model = build_model(get(name).smoke)
    model.load_params(bridge.lm_params_from_arrays(_arrays(jp), "cpu"))
    return jm, jp, model, model.params


def _batches(name, step=0, seq=SEQ, batch=BATCH):
    jb = JSyntheticLM(j_get(name).smoke, seq_len=seq,
                      global_batch=batch).batch_for_step(step)
    tb = SyntheticLM(get(name).smoke, seq_len=seq, global_batch=batch,
                     device="cpu").batch_for_step(step)
    return jb, tb


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name):
    jm, _ = _jax_model(name)
    return jax.jit(jax.value_and_grad(
        lambda p, b: j_steps.loss_fn(jm, p, b, remat="none")))


@pytest.fixture
def accelerator_branch(monkeypatch):
    """The reference's xLSTM takes its accelerator branch (float32
    accumulation of its bf16-operand chunk products) while tracing."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _assert_grads(got, want, tol, label, mlstm_tol=None):
    got, want = _port_arrays(got), {k: _np(v) for k, v in
                                    _arrays(want).items()}
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        t = mlstm_tol if (mlstm_tol and k.startswith("mlstm.")) else tol
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max()) / scale
        assert np.isfinite(got[k]).all(), (label, k)
        assert err <= t, (label, k, err)


# ---------------------------------------------------------------------------
# The schedule and the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, dict(peak_lr=1e-3, warmup_steps=7, stable_steps=13, decay_steps=5,
             final_frac=0.05), dict(warmup_steps=0, decay_steps=0)])
def test_wsd_schedule_is_jax_float32(kw):
    """Warmup, stable, decay and past the end: every step's learning rate
    equal to JAX's float32 value."""
    js, ts = j_opt.WSDSchedule(**kw), optimizer.WSDSchedule(**kw)
    end = ts.warmup_steps + ts.stable_steps + ts.decay_steps + 20
    steps_ = np.arange(0, end, dtype=np.int32)
    want = np.asarray(jax.vmap(js)(jnp.asarray(steps_)))
    got = ts(torch.from_numpy(steps_)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_update_matches_jax(dtype):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (4, 4)}}

    def tree(fn, sh=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in sh.items()}

    jp = tree(lambda s: jnp.asarray(rng.standard_normal(s)).astype(jd))
    tp = bridge.lm_params_from_arrays(_arrays(jp), "cpu")
    sched = dict(warmup_steps=2, stable_steps=2, decay_steps=2)
    jo = j_opt.AdamW(schedule=j_opt.WSDSchedule(**sched))
    to = optimizer.AdamW(schedule=optimizer.WSDSchedule(**sched))
    js_, ts_ = jo.init(jp), to.init(tp)
    upd = jax.jit(jo.update)
    for _ in range(7):
        jg = tree(lambda s: jnp.asarray(rng.standard_normal(s)).astype(jd))
        tg = bridge.lm_params_from_arrays(_arrays(jg), "cpu")
        jp, js_ = upd(jg, js_, jp)
        tp2, ts_ = to.update(tg, ts_, tp)
        assert all(a.dtype == b.dtype for a, b in zip(
            P.tree_leaves(tp2), P.tree_leaves(tp)))
        tp = tp2
        assert int(ts_.step) == int(js_.step)
        for field in ("master", "m", "v"):
            got = _port_arrays(getattr(ts_, field))
            for k, w in _arrays(getattr(js_, field)).items():
                np.testing.assert_allclose(got[k], w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max(),
                                           err_msg=f"{field}.{k}")
        got = _port_arrays(tp)
        for k, w in _arrays(jp).items():
            w = _np(w)
            ulp = np.spacing(np.abs(w).astype(np.float32)) * (
                2 ** 16 if dtype == "bf16" else 1)
            assert (np.abs(got[k] - w) <= ulp).all(), k


def test_adamw_update_leaves_its_arguments():
    opt = optimizer.AdamW()
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    st = opt.init(p)
    before = [t.clone() for t in (st.step, st.master["w"], p["w"])]
    opt.update({"w": torch.full((3,), 0.5)}, st, p)
    for a, b in zip(before, (st.step, st.master["w"], p["w"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# loss_fn's value and gradients, one config of each family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_value_and_grad_matches_jax_f32(name, accelerator_branch):
    jm, jp, model, tp = _models(name, "f32")
    jb, tb = _batches(name)
    jl, jg = _jax_value_and_grad(name)(jp, jb)
    tl, tg = steps.value_and_grad(model, tp, tb, remat="none")
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_LOSS,
                               atol=F32_LOSS)
    _assert_grads(tg, jg, F32_GRAD, name,
                  MLSTM_GRAD if name == "xlstm-1.3b" else None)
    # the parameters are left as they were and require no grad
    assert not any(p.requires_grad for p in P.tree_leaves(tp))


@pytest.mark.parametrize("name", BF16_FAMILIES)
def test_value_and_grad_matches_jax_bf16(name):
    jm, jp, model, tp = _models(name, "bf16")
    jb, tb = _batches(name)
    jl, jg = _jax_value_and_grad(name)(jp, jb)
    tl, tg = steps.value_and_grad(model, tp, tb, remat="none")
    for a, b in zip(P.tree_leaves(tg), P.tree_leaves(tp)):
        assert a.dtype == b.dtype       # JAX's gradients keep the types
    np.testing.assert_allclose(float(tl), float(jl), rtol=BF16_LOSS,
                               atol=BF16_LOSS)
    _assert_grads(tg, jg, BF16_GRAD, name)


@pytest.mark.parametrize("name", ["olmo-1b", "qwen3-moe-235b-a22b",
                                  "xlstm-1.3b", "zamba2-1.2b"])
def test_remat_policies_give_bit_equal_grads(name):
    """none / dots / dots+moe / full: the same loss and gradients bit for
    bit (remat recomputes, it changes no value)."""
    _, _, model, tp = _models(name, "bf16")
    _, tb = _batches(name, seq=32)
    want_l, want_g = steps.value_and_grad(model, tp, tb, remat="none")
    for policy in ("dots", "dots+moe", "full"):
        l, g = steps.value_and_grad(model, tp, tb, remat=policy)
        assert torch.equal(l, want_l), policy
        for a, b in zip(P.tree_leaves(g), P.tree_leaves(want_g)):
            assert torch.equal(a, b), policy
    with pytest.raises(ValueError, match="remat policy"):
        steps.value_and_grad(model, tp, tb, remat="some")


@pytest.mark.parametrize("name,policy,moe", [
    ("olmo-1b", "dots", False), ("qwen3-moe-235b-a22b", "dots+moe", True),
    ("qwen3-moe-235b-a22b", "dots", False)])
def test_remat_policy_saves_the_weight_products(name, policy, moe,
                                                monkeypatch):
    """The selective policy's forward decisions: it saves exactly the
    products with no batch dimension (each layer's weight einsums, a
    ``bmm`` of batch 1) and, under "dots+moe", each MoE block's output;
    everything else, the attention's batched products included, is
    recomputed."""
    from repro_torch.models import model as model_mod
    _, _, model, tp = _models(name, "bf16")
    _, tb = _batches(name)
    seen = []
    policy_fn = (model_mod._dots_moe_policy if moe
                 else model_mod._dots_policy)

    def spy(*args, **kw):
        out = policy_fn(*args, **kw)
        ctx, op, *rest = args[1:] if moe else args    # moe: (mark, ...)
        if not ctx.is_recompute:
            seen.append((op, out, rest[0].shape[0] if op in
                         model_mod._DOTS else None))
        return out

    monkeypatch.setattr(model_mod, "_dots_moe_policy" if moe
                        else "_dots_policy", spy)
    steps.value_and_grad(model, tp, tb, remat=policy)
    cfg = model.cfg
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    saved = [(op, b) for op, d, b in seen if d == save]
    # wq wk wv wo, then the FFN's: w_gate w_up w_down (dense) or the
    # router (MoE: the expert products carry the expert dimension)
    per_layer = 4 + (1 if cfg.moe is not None else 3)
    dots = [b for op, b in saved if op in model_mod._DOTS]
    assert dots == [1] * (per_layer * cfg.n_layers), dots
    clones = [op for op, _ in saved if op is torch.ops.aten.clone.default]
    assert len(clones) == (cfg.n_layers if moe else 0)
    batched = [b for op, d, b in seen if op in model_mod._DOTS and d != save]
    assert batched and all(b > 1 for b in batched)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slstm_segments_give_bit_equal_grads(dtype):
    """S = 128: two checkpointed 64-step segments against the plain loop
    (``SLSTM_SEGMENT`` past S), the same loss and gradients bit for bit."""
    td = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    cfg = get("xlstm-1.3b").smoke
    gen = torch.Generator().manual_seed(5)
    p = P.init(xl.slstm_spec(cfg), gen, device="cpu")
    x = torch.randn((1, 128, cfg.d_model), generator=gen).to(td)

    def grads():
        live = {k: v.detach().requires_grad_() for k, v in p.items()}
        xr = x.detach().requires_grad_()
        y, _ = xl.slstm_apply(live, cfg, xr)
        out = torch.autograd.grad(y.float().square().mean(),
                                  [xr] + list(live.values()))
        return y, out

    y_seg, g_seg = grads()
    plain = xl.SLSTM_SEGMENT
    try:
        xl.SLSTM_SEGMENT = 1024
        y_flat, g_flat = grads()
    finally:
        xl.SLSTM_SEGMENT = plain
    assert torch.equal(y_seg, y_flat)
    for a, b in zip(g_seg, g_flat):
        assert torch.equal(a, b)


def test_zamba2_grads_finite_at_chunk_256():
    """ROADMAP §C 11 under autograd: one smoke-width Mamba2 block at the
    published chunk of 256 over S 256 (test_torch_ssm.py's inputs), where
    the reference's forward is already NaN: the port's output and every
    gradient are finite."""
    ssm = dataclasses.replace(get("zamba2-1.2b").smoke.ssm, chunk=256)
    jcfg = dataclasses.replace(j_get("zamba2-1.2b").smoke, ssm=ssm)
    cfg = dataclasses.replace(get("zamba2-1.2b").smoke, ssm=ssm)
    jp = _f32(j_P.init(j_m2.mamba2_spec(jcfg), jax.random.PRNGKey(15)))
    x = np.random.default_rng(15).standard_normal(
        (2, 256, cfg.d_model)).astype(np.float32)
    yj, _ = j_m2.mamba2_apply(jp, jcfg, jnp.asarray(x))
    assert np.isnan(np.asarray(yj)).mean() > 0.1
    tp = {k: v.requires_grad_() for k, v in
          bridge.lm_params_from_arrays(_arrays(jp), "cpu").items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = m2.mamba2_apply(tp, cfg, xt)
    assert bool(torch.isfinite(y).all())
    grads = torch.autograd.grad(y.square().mean(), [xt] + list(tp.values()))
    for name, g in zip(["x"] + list(tp), grads):
        assert bool(torch.isfinite(g).all()), name


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

SCHED = dict(warmup_steps=2, stable_steps=3, decay_steps=2)


@functools.lru_cache(maxsize=None)
def _jax_train_step(accum, compress):
    jm, _ = _jax_model("olmo-1b")
    opt = j_opt.AdamW(schedule=j_opt.WSDSchedule(**SCHED))
    comp = JComp() if compress else None
    return opt, comp, jax.jit(j_steps.make_train_step(
        jm, opt, accum_steps=accum, remat="none", grad_transform=comp))


def _assert_tree(got, want, atol, label):
    got = _port_arrays(got)
    for k, w in _arrays(want).items():
        np.testing.assert_allclose(got[k], _np(w), rtol=0, atol=atol,
                                   err_msg=f"{label}.{k}")


@pytest.mark.parametrize("accum,compress", [(1, False), (2, False),
                                            (1, True)])
def test_train_step_matches_jax(accum, compress, tmp_path):
    """Three steps of olmo-1b's smoke model on float32 weights, both sides
    from the same optimizer state (and compressor context) carried by the
    bridge; batches of 4 rows (two row groups of 2 when accumulating).
    With the compressor: step 0 a full-precision refresh, 1 and 2
    quantized to int8."""
    jm, jp, model, tp = _models("olmo-1b", "f32")
    jopt, jcomp, jstep = _jax_train_step(accum, compress)
    opt = optimizer.AdamW(schedule=optimizer.WSDSchedule(**SCHED))
    step = steps.make_train_step(
        model, opt, accum_steps=accum, remat="dots",
        grad_transform=DeltaEFCompressor() if compress else None)
    js_ = jopt.init(jp)
    ts_ = bridge.adamw_state_from_arrays(
        {k: np.asarray(v) for k, v in _adamw_arrays(js_).items()}, "cpu")
    jctx = jcomp.init(jp) if compress else None
    tctx = (bridge.grad_ctx_from_arrays(_ctx_arrays(jctx), "cpu")
            if compress else None)
    lr_sum = 0.0
    for i in range(3):
        jb, tb = _batches("olmo-1b", i, batch=4)
        if compress:
            jp, js_, jm_, jctx = jstep(jp, js_, jb, jctx)
            tp, ts_, tm, tctx = step(tp, ts_, tb, tctx)
        else:
            jp, js_, jm_ = jstep(jp, js_, jb)
            tp, ts_, tm = step(tp, ts_, tb)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm_[key]),
                                       rtol=1e-5, err_msg=key)
        assert float(tm["lr"]) == float(jm_["lr"])
        assert int(ts_.step) == int(js_.step) == i + 1
        if not compress:
            _assert_tree(ts_.master, js_.master, 1e-6, f"master@{i}")
        else:
            lr_sum += float(jm_["lr"])
            _assert_master_flips(ts_.master, js_.master, lr_sum, i)
        if compress:
            assert int(tctx["step"]) == int(jctx["step"]) == i + 1
            # one quantum of the step's scale: max |delta| / 127
            _assert_tree(tctx["ref"], jctx["ref"], 1.01 * _quantum(jctx),
                         f"ref@{i}")
    # the bridge carries the port's state back under the same keys
    back, want = bridge.adamw_state_to_arrays(ts_), _adamw_arrays(js_)
    assert sorted(back) == sorted(want) and back["step"] == want["step"]
    if compress:
        assert sorted(bridge.grad_ctx_to_arrays(tctx)) == sorted(
            _ctx_arrays(jctx))


def _assert_master_flips(got, want, lr_sum, i):
    """With the compressor: the master to 1e-6 but where a quantized
    gradient element rounded apart (one quantum), which moves that
    element's AdamW step by at most 2 lr a step: at most one element in a
    thousand, each within twice the learning rates so far."""
    got = _port_arrays(got)
    n = off = 0
    for k, w in _arrays(want).items():
        d = np.abs(got[k] - _np(w))
        n += d.size
        off += int((d > 1e-6).sum())
        assert d.max() <= 2 * lr_sum, (i, k, float(d.max()))
    assert off <= n // 1000, (i, off, n)


def _adamw_arrays(state):
    out = {"step": np.asarray(state.step)}
    for field in ("master", "m", "v"):
        out.update({f"{field}.{k}": v for k, v in
                    _arrays(getattr(state, field)).items()})
    return out


def _ctx_arrays(ctx):
    out = {"step": np.asarray(ctx["step"])}
    for field in ("ref", "residual"):
        out.update({f"{field}.{k}": v for k, v in
                    _arrays(ctx[field]).items()})
    return out


def _quantum(ctx):
    return max(float(jnp.max(jnp.abs(r))) for r in
               jax.tree_util.tree_leaves(ctx["ref"])) * 2 / 127


@pytest.mark.parametrize("qdtype", ["int8", "int16"])
def test_compressor_alone_is_bit_exact(qdtype):
    """Identical gradients and contexts: the transmitted gradients, the
    references and the residuals bit for bit over a refresh and three
    quantized steps (refresh every 4; a leaf of zeros and a leaf of
    exact halves, the rounding's ties)."""
    rng = np.random.default_rng(7)
    jc = JComp(qdtype=getattr(jnp, qdtype), refresh_interval=4)
    tc = DeltaEFCompressor(qdtype=getattr(torch, qdtype), refresh_interval=4)
    shapes = {"a": (6, 5), "b": {"c": (9,), "z": (4,)}}
    jctx = jc.init({"a": jnp.zeros((6, 5)), "b": {"c": jnp.zeros(9),
                                                   "z": jnp.zeros(4)}})
    tctx = bridge.grad_ctx_from_arrays(_ctx_arrays(jctx), "cpu")
    for i in range(5):
        g = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
             "b": {"c": (rng.integers(-8, 8, 9) / 2).astype(np.float32),
                   "z": np.zeros(4, np.float32)}}
        jg, jctx = jc(jax.tree_util.tree_map(jnp.asarray, g), jctx)
        tg, tctx = tc(bridge.lm_params_from_arrays(
            {"a": g["a"], "b.c": g["b"]["c"], "b.z": g["b"]["z"]}, "cpu"),
            tctx)
        for got, want in ((tg, jg), (tctx["residual"], jctx["residual"]),
                          (tctx["ref"], jctx["ref"])):
            g_a = _port_arrays(got)
            for k, w in _arrays(want).items():
                np.testing.assert_array_equal(g_a[k], np.asarray(w),
                                              err_msg=f"{i}.{k}")
    assert tc.wire_bytes(tg, full=False) == jc.wire_bytes(jg, full=False)
    assert tc.wire_bytes(tg, full=True) == jc.wire_bytes(jg, full=True)


@pytest.mark.parametrize("name", j_names())
def test_train_step_finite_loss(name):
    """tests/test_archs_smoke.py's test on the port: two steps of every
    smoke config, a finite loss and gradient norm, the parameters moved."""
    cfg = get(name).smoke
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    prm = model.load_params(P.init(model.spec, gen, device="cpu")).params
    opt = optimizer.AdamW(schedule=optimizer.WSDSchedule(
        warmup_steps=2, stable_steps=5, decay_steps=2))
    opt_state = opt.init(prm)
    pipe = SyntheticLM(cfg, seq_len=64, global_batch=2, device="cpu")
    step = steps.make_train_step(model, opt, remat="none")
    p = prm
    for i in range(2):
        p, opt_state, metrics = step(p, opt_state, pipe.batch_for_step(i))
        assert np.isfinite(float(metrics["loss"]))
        assert np.isfinite(float(metrics["grad_norm"]))
    delta = max(float((a.float() - b.float()).abs().max()) for a, b in
                zip(P.tree_leaves(p), P.tree_leaves(prm)))
    assert delta > 0


# ---------------------------------------------------------------------------
# Batches and their RNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_randint_and_bf16_normal_are_bit_exact(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for lo, hi in ((0, 256), (0, 50280), (-5, 1000003), (3, 3),
                   (-(2 ** 31), 2 ** 31 - 1)):
        want = np.asarray(jax.random.randint(key, (3, 700), lo, hi))
        got = prng.randint(tkey, (3, 700), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    want = _np(jax.random.normal(key, (5, 4000), jnp.bfloat16))
    got = prng.normal(tkey, (5, 4000), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)
    # every one of the 128 values a bf16 normal takes
    assert len(np.unique(want)) == 128


@pytest.mark.parametrize("name", ["olmo-1b", "llava-next-mistral-7b",
                                  "hubert-xlarge"])
def test_synthetic_batches_are_bit_exact(name):
    seq = 64 + (j_get(name).smoke.n_patches
                if get(name).smoke.family == "vlm" else 0)
    pipe = SyntheticLM(get(name).smoke, seq_len=seq, global_batch=3,
                       seed=11, device="cpu")
    jpipe = JSyntheticLM(j_get(name).smoke, seq_len=seq, global_batch=3,
                         seed=11)
    for step in (0, 7):
        want, got = jpipe.batch_for_step(step), pipe.batch_for_step(step)
        assert set(got) == set(want)
        for k in want:
            assert str(got[k].dtype).split(".")[-1] == \
                jnp.dtype(want[k].dtype).name, k
            np.testing.assert_array_equal(_np(got[k]), _np(want[k]),
                                          err_msg=k)
    meta = pipe.abstract_batch()
    for k, s in jpipe.abstract_batch().items():
        assert meta[k].device.type == "meta"
        assert tuple(meta[k].shape) == s.shape
        assert str(meta[k].dtype).split(".")[-1] == jnp.dtype(s.dtype).name


# ---------------------------------------------------------------------------
# Checkpoints of a train state
# ---------------------------------------------------------------------------

def test_checkpoint_holds_an_optimizer_state(tmp_path):
    """Repair (b): an ``{"params", "opt": AdamWState}`` tree round-trips,
    keyed by field name as JAX keys it (``opt/step``, ``opt/m/...``)."""
    _, _, model, tp = _models("olmo-1b", "bf16")
    opt = optimizer.AdamW()
    tree = {"params": tp, "opt": opt.init(tp)}
    ck.save(str(tmp_path), 3, tree)
    step, flat, _ = ck.restore(str(tmp_path))
    assert step == 3 and "opt/step" in flat and "opt/master/embed/w" in flat
    assert not any(k.startswith("opt/0") for k in flat)
    _, back, _ = ck.restore(str(tmp_path), like=tree)
    assert isinstance(back["opt"], optimizer.AdamWState)
    for a, b in zip(ck._flatten_with_paths(back),
                    ck._flatten_with_paths(tree)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert torch.equal(a[1], b[1])
    # and the async path snapshots it
    ac = ck.AsyncCheckpointer(str(tmp_path))
    ac.save(4, tree)
    ac.wait()
    assert ck.latest_step(str(tmp_path)) == 4


def test_train_resume_is_bit_identical(tmp_path):
    """tests/test_distributed_runtime.py's resume test on the port: 4
    steps, a checkpoint at 2, steps 3-4 again from the restore: equal bit
    for bit."""
    cfg = get("olmo-1b").smoke
    model = build_model(cfg)
    opt = optimizer.AdamW()
    pipe = SyntheticLM(cfg, seq_len=32, global_batch=2, device="cpu")
    step_fn = steps.make_train_step(model, opt, remat="dots")
    gen = torch.Generator().manual_seed(0)
    params = model.load_params(P.init(model.spec, gen, device="cpu")).params
    opt_state = opt.init(params)
    for i in range(2):
        params, opt_state, _ = step_fn(params, opt_state,
                                       pipe.batch_for_step(i))
    ck.save(str(tmp_path), 2, {"params": params, "opt": opt_state})
    pa, oa = params, opt_state
    for i in range(2, 4):
        pa, oa, _ = step_fn(pa, oa, pipe.batch_for_step(i))
    _, restored, _ = ck.restore(str(tmp_path),
                                like={"params": params, "opt": opt_state})
    pb, ob = restored["params"], restored["opt"]
    for i in range(2, 4):
        pb, ob, _ = step_fn(pb, ob, pipe.batch_for_step(i))
    for (ka, a), (kb, b) in zip(ck._flatten_with_paths((pa, oa)),
                                ck._flatten_with_paths((pb, ob))):
        assert ka == kb and torch.equal(a, b), ka


def test_train_checkpoints_cross_restore(tmp_path):
    """A JAX-written ``{"params", "opt"}`` checkpoint restores in the port
    with the same keys and values, and the reverse."""
    jm, jp, model, tp = _models("olmo-1b", "bf16")
    jopt, _, jstep = _jax_train_step(1, False)
    js_ = jopt.init(jp)
    jb, _ = _batches("olmo-1b", 0, batch=4)
    jp, js_, _ = jstep(jp, js_, jb)
    j_ck.save(str(tmp_path / "jax"), 1, {"params": jp, "opt": js_})
    opt = optimizer.AdamW()
    like = {"params": tp, "opt": opt.init(tp)}
    step, back, _ = ck.restore(str(tmp_path / "jax"), like=like)
    assert step == 1 and isinstance(back["opt"], optimizer.AdamWState)
    jflat = dict(j_ck._flatten_with_paths({"params": jp, "opt": js_})[0])
    tflat = dict(ck._flatten_with_paths(back))
    assert list(jflat) == list(tflat)
    for k, w in jflat.items():
        np.testing.assert_array_equal(_np(tflat[k]), _np(w), err_msg=k)
    # the port's write, restored by the reference
    ck.save(str(tmp_path / "port"), 1, back)
    _, jback, _ = j_ck.restore(str(tmp_path / "port"),
                               like={"params": jp, "opt": js_})
    for (k, a), (_, b) in zip(
            j_ck._flatten_with_paths(jback)[0],
            j_ck._flatten_with_paths({"params": jp, "opt": js_})[0]):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=k)


# ---------------------------------------------------------------------------
# Repair (a): the attention kernel's wrapper under autograd
# ---------------------------------------------------------------------------

def test_flash_attention_raises_under_autograd_on_the_cpu():
    """ROADMAP B5 b: no backward, on the CPU as on the card (the plain
    version would differentiate; the kernel could not)."""
    q = torch.randn(2, 4, 128, 16, requires_grad=True)
    k, v = torch.randn(2, 4, 128, 16), torch.randn(2, 4, 128, 16)
    with pytest.raises(NotImplementedError, match="B5 b"):
        ops.flash_attention_bhsd(q, k, v)
    with torch.no_grad():                    # scoring is unaffected
        out = ops.flash_attention_bhsd(q, k, v)
    assert out.shape == (2, 4, 128, 16) and out.grad_fn is None
    out = fa.flash_attention(q.detach()[0], k[0], v[0])   # no grad needed
    assert out.shape == (4, 128, 16)
    _, _, model, tp = _models("olmo-1b", "bf16")
    _, tb = _batches("olmo-1b")
    with pytest.raises(NotImplementedError, match="B5 b"):
        steps.value_and_grad(model, tp, tb, backend="kernel")


# ---------------------------------------------------------------------------
# The launcher and the example
# ---------------------------------------------------------------------------

def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--seq",
            "32", "--batch", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    out = launch_train.main(args + ["--steps", "2"])
    assert out["start"] == 0 and ck.latest_step(str(tmp_path)) == 2
    assert np.isfinite(out["log"][-1]["loss"])
    again = launch_train.main(args + ["--steps", "4", "--grad-compress",
                                      "--accum", "2", "--remat", "full"])
    assert again["start"] == 2 and ck.latest_step(str(tmp_path)) == 4
    assert int(again["grad_ctx"]["step"]) == 2
    text = capsys.readouterr().out
    assert "resumed from step 2" in text and "step     4  loss" in text


def test_launcher_and_example_refuse_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--arch", "olmo-1b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        _example().main(steps=1)


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_example", ROOT / "examples_torch" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_trains_checkpoints_and_resumes(tmp_path):
    ex = _example()
    first = ex.main(device="cpu", steps=6, ckpt_dir=str(tmp_path),
                    ckpt_every=3, seq=16, batch=2)
    assert first["start"] == 0 and first["latest"] == 6
    assert first["params"] == P.count_params(build_model(ex.config()).spec)
    assert np.isfinite(first["final_loss"])
    more = ex.main(device="cpu", steps=8, ckpt_dir=str(tmp_path),
                   ckpt_every=4, seq=16, batch=2)
    assert more["start"] == 6 and more["latest"] == 8
    assert np.isfinite(more["final_loss"])
