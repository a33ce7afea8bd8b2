"""Parity of the port's transformer-block families with the JAX package on
the CPU: minicpm-2b (dense, head dim 16 at smoke size), minicpm3-4b (MLA),
qwen3-moe and phi3.5-moe (MoE), llava-next-mistral-7b (vlm) and
hubert-xlarge (audio), and the MoE and MLA units.

The same numpy inputs, and the reference's own ``P.init`` weights carried
by ``repro_torch.bridge``, go through both packages.  The JAX side reaches
the Pallas flash-attention kernel in interpret mode (``backend="pallas"``);
the port's ``"kernel"`` backend runs the kernel's plain version on a CPU
tensor.  Tolerances (tests/test_torch_lm.py's): float32 weights 1e-5 (abs
and rel) for logits, losses and the units; bfloat16 weights 2e-2 for
logits and the units; prefill and decode 0.06 absolute / 0.05 relative
(tests/test_archs_smoke.py's decode-vs-forward tolerances).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get as j_get
from repro.models import attention as j_attn
from repro.models import moe as j_moe
from repro.models import model as j_model
from repro.models import params as j_P
from repro.models.model import build_model as j_build
from repro.training import steps as j_steps
from repro_torch.bridge import lm_params_from_arrays
from repro_torch.configs import get
from repro_torch.models import attention as attn
from repro_torch.models import model as model_mod
from repro_torch.models import moe
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.training import steps

CONFIGS = ("hubert-xlarge", "llava-next-mistral-7b", "minicpm-2b",
           "minicpm3-4b", "phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")
GQA = tuple(n for n in CONFIGS if get(n).smoke.attention == "gqa")
CACHED = tuple(n for n in CONFIGS if get(n).smoke.family != "audio")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2e-2}


def _np(x) -> np.ndarray:
    """float32 numpy of a tensor or JAX array (bfloat16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=name)


def _both(a: np.ndarray, dtype: str):
    """A float32 numpy array in both packages' ``dtype``, equal bit for
    bit; integer arrays as they are."""
    if a.dtype.kind in "iu":
        return jnp.asarray(a), torch.from_numpy(a)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(np.array(a)).to(td)


def _arrays(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def _tree(tree):
    """A JAX parameter tree as the port's, through the bridge."""
    return lm_params_from_arrays(_arrays(tree), device="cpu")


# ---------------------------------------------------------------------------
# The six configs at their smoke sizes, on the reference's weights
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The reference's ``P.init`` weights of a smoke model, drawn in one
    compiled call (leaf by leaf outside ``jit`` it takes ~8 s a model)."""
    jm = j_build(j_get(name).smoke)
    return jm, jax.jit(lambda key: j_P.init(jm.spec, key))(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _models(name, dtype):
    jm, jp = _jax_init(name)
    if dtype == "f32":
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    model = build_model(get(name).smoke)
    model.load_params(_tree(jp))
    return jm, jp, model, model.params


def _batch(cfg, dtype, b=2, s=128, seed=0):
    """The inputs of one family for both packages: tokens (a vlm's after
    its ``n_patches`` patch embeddings, ``s`` in all), or ``s`` audio
    frames; labels and a loss mask over the text (or frame) span."""
    rng = np.random.default_rng(seed)
    arrays = {}
    s_text = s - cfg.n_patches if cfg.family == "vlm" else s
    if cfg.family == "audio":
        arrays["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
        arrays["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(
            np.int32)
    else:
        tok = rng.integers(0, cfg.vocab, (b, s_text + 1)).astype(np.int32)
        arrays["tokens"], arrays["labels"] = tok[:, :-1], tok[:, 1:]
        if cfg.family == "vlm":
            arrays["patches"] = rng.standard_normal(
                (b, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    arrays["loss_mask"] = rng.random((b, s_text)) < 0.7
    pairs = {k: _both(np.ascontiguousarray(a), dtype) if a.dtype != bool
             else (jnp.asarray(a), torch.from_numpy(a))
             for k, a in arrays.items()}
    return ({k: v[0] for k, v in pairs.items()},
            {k: v[1] for k, v in pairs.items()})


def _inputs(batch):
    return {k: v for k, v in batch.items()
            if k not in ("labels", "loss_mask")}


@functools.lru_cache(maxsize=None)
def _jax_logits(name, dtype, backend):
    jm, jp, _, _ = _models(name, dtype)
    jb, _ = _batch(jm.cfg, dtype)
    return _np(jm.logits(jp, _inputs(jb), backend=backend, remat="none"))


def _blockwise(name, backend):
    """A bf16 MoE model held block by block: each block of the port, and
    then its head, from JAX's input to that block, against JAX's block run
    op by op (``jax.disable_jit``: each op rounded to bf16, as the port
    rounds it), to 2e-2.  A router near a tie flips on one ulp of its
    input, an ulp two correct implementations need not share, and the
    flip moves a token's logits by more than 2e-2: on qwen3-moe's smoke
    logits JAX's own compiled and op-by-op forwards differ by 0.0419 at one
    token, and on phi3.5-moe's the port lies 0.0254 from the op-by-op
    forward at one token after a one-ulp difference in block 0."""
    jm, jp, model, tp = _models(name, "bf16")
    jb, _ = _batch(jm.cfg, "bf16")
    cfg = jm.cfg
    jax_backend = "pallas" if backend == "kernel" else backend
    with jax.disable_jit():
        x = j_model._embed_inputs(jp, cfg, _inputs(jb))
        pos = np.arange(x.shape[1], dtype=np.int32)
        for i in range(cfg.n_layers):
            lj = jax.tree_util.tree_map(lambda a: a[i], jp["blocks"])
            want, _, aux_j = j_model._block_apply(
                lj, cfg, x, jnp.asarray(pos), backend=jax_backend)
            got, _, aux_t = model_mod._block_apply(
                model_mod._layers_of(tp["blocks"], 1)(i), model.cfg,
                _both(_np(x), "bf16")[1], torch.from_numpy(pos),
                backend=backend)
            _close(got, want, TOL["bf16"], f"block {i}")
            _close(aux_t, aux_j, 1e-5, f"block {i} aux")
            x = want
        want = j_model._head(jp, cfg, x)
    got = model_mod._head(tp, model.cfg, _both(_np(x), "bf16")[1])
    _close(got, want, TOL["bf16"], "head")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", CONFIGS)
def test_chunked_logits_match_jax(name, dtype):
    jm, _, model, tp = _models(name, dtype)
    _, tb = _batch(jm.cfg, dtype)
    got = model.logits(tp, _inputs(tb))
    assert got.dtype == DTYPES[dtype][1]
    assert got.shape == (2, 128, jm.cfg.padded_vocab)
    if dtype == "bf16" and jm.cfg.moe is not None:
        _blockwise(name, "chunked")
    else:
        _close(got, _jax_logits(name, dtype, "chunked"), TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", GQA)
def test_kernel_logits_match_jax_pallas(name, dtype):
    jm, _, model, tp = _models(name, dtype)
    _, tb = _batch(jm.cfg, dtype)
    if dtype == "bf16" and jm.cfg.moe is not None:
        _blockwise(name, "kernel")
        return
    got = model.logits(tp, _inputs(tb), backend="kernel")
    _close(got, _jax_logits(name, dtype, "pallas"), TOL[dtype])


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_matches_jax(name):
    """float32 weights; a vlm's loss covers its text span only."""
    jm, jp, model, tp = _models(name, "f32")
    jb, tb = _batch(jm.cfg, "f32")
    plain = {k: v for k, v in jb.items() if k != "loss_mask"}
    want = j_steps.loss_fn(jm, jp, plain, backend="chunked", remat="none")
    got = steps.loss_fn(model, tp, {k: v for k, v in tb.items()
                                    if k != "loss_mask"}, backend="kernel")
    _close(got, want, 1e-5)
    _close(steps.loss_fn(model, tp, tb),
           j_steps.loss_fn(jm, jp, jb, remat="none"), 1e-5, "masked")


@pytest.mark.parametrize("name", CACHED)
def test_prefill_and_decode_match_jax(name):
    """Prefill 16 tokens (after a vlm's patches), then 3 greedy decode
    steps on JAX's tokens, both packages on bfloat16 weights and caches."""
    jm, jp, model, tp = _models(name, "bf16")
    cfg = jm.cfg
    jb, tb = _batch(cfg, "bf16", s=32 + cfg.n_patches, seed=1)
    pre = 16 + cfg.n_patches
    keep = ("tokens", "patches")
    jpre = {k: v[:, :16] if k == "tokens" else v for k, v in jb.items()
            if k in keep}
    tpre = {k: v[:, :16] if k == "tokens" else v for k, v in tb.items()
            if k in keep}
    cache_j = jm.init_cache(2, pre + 8)
    cache_t = model.init_cache(2, pre + 8, device="cpu")
    lj, cache_j = jm.prefill(jp, jpre, cache_j)
    lt, cache_t = steps.make_prefill_step(model)(tp, tpre, cache_t)
    np.testing.assert_allclose(_np(lt), _np(lj), atol=0.06, rtol=0.05)
    for got, want in zip(jax.tree_util.tree_leaves(cache_t),
                         jax.tree_util.tree_leaves(cache_j)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), atol=0.06,
                                   rtol=0.05)
    dec_j = jax.jit(j_steps.make_serve_decode_step(jm))
    dec_t = steps.make_serve_decode_step(model)
    tok = np.asarray(jnp.argmax(lj[:, -1], axis=-1)).astype(np.int32)[:, None]
    for idx in range(pre, pre + 3):
        lj, cache_j = dec_j(jp, cache_j, jnp.asarray(tok), jnp.int32(idx))
        lt, cache_t = dec_t(tp, cache_t, torch.from_numpy(tok), idx)
        assert lt.shape == (2, 1, cfg.padded_vocab)
        np.testing.assert_allclose(_np(lt), _np(lj), atol=0.06, rtol=0.05)
        tok = np.asarray(jnp.argmax(lj[:, -1], axis=-1)).astype(
            np.int32)[:, None]


def test_an_encoder_has_no_cache():
    jm, _, model, _ = _models("hubert-xlarge", "bf16")
    with pytest.raises(ValueError, match="audio"):
        jm.init_cache(2, 16)
    with pytest.raises(ValueError, match="audio"):
        model.init_cache(2, 16, device="cpu")


@pytest.mark.parametrize("name", ["hubert-xlarge", "phi3.5-moe-42b-a6.6b"])
def test_bridge_keeps_float32_leaves(name):
    """The bf16 tree's float32 leaves (the MoE router, the GeLU MLP's
    biases, the norms) cross as float32, bit for bit."""
    _, jp, _, tp = _models(name, "bf16")
    want = _arrays(jp)
    f32 = {p for p, a in want.items() if a.dtype == np.float32}
    assert f32 and f32 >= {p for p in want if p.split(".")[-1] in (
        "router", "b_in", "b_out")}
    for path, a in want.items():
        got = tp
        for key in path.split("."):
            got = got[key]
        assert got.dtype == (torch.float32 if path in f32
                             else torch.bfloat16), path
        np.testing.assert_array_equal(_np(got), a.astype(np.float32),
                                      err_msg=path)


# ---------------------------------------------------------------------------
# MoE units
# ---------------------------------------------------------------------------

def _moe_case(dtype, seed, capacity_factor=None, b=2, s=64):
    cfg = j_get("qwen3-moe-235b-a22b").smoke
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    jp = j_P.init(j_moe.moe_spec(cfg), jax.random.PRNGKey(seed))
    if dtype == "f32":
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return cfg, jp, _tree(jp), x


def _moe_both(cfg, jp, tp, x, dtype):
    xj, xt = _both(x, dtype)
    tcfg = dataclasses.replace(get(cfg.name).smoke, moe=cfg.moe)
    return j_moe.moe_apply(jp, cfg, xj), moe.moe_apply(tp, tcfg, xt), tcfg


def _jax_drop_share(jp, cfg, x):
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x, jnp.float32),
                        jp["router"].astype(jnp.float32))
    p, i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe.top_k)
    p = p / jnp.sum(p, -1, keepdims=True)
    gate = np.zeros(logits.shape, np.float32)
    np.put_along_axis(gate, np.asarray(i), np.asarray(p), axis=-1)
    w, _ = jax.lax.top_k(jnp.asarray(gate).swapaxes(1, 2),
                         j_moe.capacity(cfg, x.shape[1]))
    return 1.0 - float((w > 0).sum()) / float((gate > 0).sum())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_apply_matches_jax(dtype):
    cfg, jp, tp, x = _moe_case(dtype, 3)
    (yj, auxj), (yt, auxt), _ = _moe_both(cfg, jp, tp, x, dtype)
    assert yt.dtype == DTYPES[dtype][1] and auxt.dtype == torch.float32
    _close(yt, yj, TOL[dtype], "y")
    _close(auxt, auxj, 1e-5, "aux")
    assert float(auxt) > 0


def test_moe_capacity_drops_tokens():
    """At capacity factor 0.5 (C = 8 of 64 tokens, 2 of 8 experts each)
    capacity drops at least half of the assignments: the same ones on both
    sides, and the output is the served ones' alone."""
    cfg, jp, tp, x = _moe_case("f32", 4, capacity_factor=0.5)
    assert j_moe.capacity(cfg, 64) == 8
    (yj, auxj), (yt, auxt), tcfg = _moe_both(cfg, jp, tp, x, "f32")
    share = moe.dropped_share(tp, tcfg, torch.from_numpy(x))
    assert share >= 0.5
    assert share == pytest.approx(_jax_drop_share(jp, cfg, x), abs=1e-12)
    _close(yt, yj, 1e-5, "y")
    _close(auxt, auxj, 1e-5, "aux")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_positive_tie_at_the_capacity_edge(dtype):
    """Sixteen equal tokens route to the same two experts with equal
    positive weights; C = 5, so the capacity edge falls among equal
    weights.  The lower indices are served, as ``jax.lax.top_k`` picks:
    tokens 0-4 get both experts' output, the other eleven are dropped (0),
    on both sides."""
    cfg, jp, tp, x = _moe_case(dtype, 5, b=1, s=16)
    x[:, :] = x[:, :1]
    assert j_moe.capacity(cfg, 16) == 5
    (yj, _), (yt, _), tcfg = _moe_both(cfg, jp, tp, x, dtype)
    _close(yt, yj, TOL[dtype])
    served = _np(yt)[0]
    assert (served[:5] != 0).any(axis=-1).all()
    assert np.array_equal(served[:5], np.repeat(served[:1], 5, axis=0))
    assert not served[5:].any() and not _np(yj)[0, 5:].any()
    assert moe.dropped_share(tp, tcfg, _both(x, dtype)[1]) == 1 - 10 / 32


def test_moe_top_k_takes_the_lower_index_on_a_tie():
    x = torch.tensor([[0.5, 0.25, 0.5, 0.0, 0.5, 0.25]])
    vals, idx = moe.top_k(x, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 2, 4, 1]]
    assert vals.tolist() == np.asarray(jv).tolist()


# ---------------------------------------------------------------------------
# MLA units: no cache, a prefill into the latent cache, the absorbed decode
# ---------------------------------------------------------------------------

def _mla_case(dtype, seed=6, b=2, s=32, t=48):
    cfg = j_get("minicpm3-4b").smoke
    jp = j_P.init(j_attn.mla_spec(cfg), jax.random.PRNGKey(seed))
    if dtype == "f32":
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    x = np.random.default_rng(seed).standard_normal(
        (b, s + 1, cfg.d_model)).astype(np.float32)
    m = cfg.mla
    width = m.kv_lora_rank + m.qk_rope_head_dim
    return (cfg, get("minicpm3-4b").smoke, jp, _tree(jp), x,
            jnp.zeros((b, t, width), jnp.bfloat16),
            torch.zeros((b, t, width), dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_without_cache_matches_jax(dtype):
    jcfg, cfg, jp, tp, x, _, _ = _mla_case(dtype)
    xj, xt = _both(x[:, :32], dtype)
    pos = np.arange(32, dtype=np.int32)
    yj, cj = j_attn.mla_apply(jp, jcfg, xj, jnp.asarray(pos))
    yt, ct = attn.mla_apply(tp, cfg, xt, torch.from_numpy(pos))
    assert cj is None and ct is None
    assert yt.shape == (2, 32, cfg.d_model)
    _close(yt, yj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_prefill_and_absorbed_decode_match_jax(dtype):
    """A 32-token prefill into a 48-slot latent cache (attending over the
    whole cache, causally), then one token at index 32 on the absorbed
    decode: outputs and the bf16 cache, written in place, against JAX."""
    jcfg, cfg, jp, tp, x, cache_j, cache_t = _mla_case(dtype)
    xj, xt = _both(x, dtype)
    pos = np.arange(32, dtype=np.int32)
    yj, cache_j = j_attn.mla_apply(jp, jcfg, xj[:, :32], jnp.asarray(pos),
                                   cache=cache_j, cache_index=0)
    yt, back = attn.mla_apply(tp, cfg, xt[:, :32], torch.from_numpy(pos),
                              cache=cache_t, cache_index=0)
    assert back is cache_t
    _close(yt, yj, TOL[dtype], "prefill")
    _close(cache_t, cache_j, TOL[dtype], "prefill cache")
    assert not cache_t[:, 32:].any()
    lm = np.broadcast_to(np.arange(48) <= 32, (2, 48))
    one = np.array([32], np.int32)
    yj, cache_j = j_attn.mla_apply(jp, jcfg, xj[:, 32:], jnp.asarray(one),
                                   cache=cache_j, cache_index=32,
                                   length_mask=jnp.asarray(lm))
    yt, _ = attn.mla_apply(tp, cfg, xt[:, 32:], torch.from_numpy(one),
                           cache=cache_t, cache_index=32,
                           length_mask=torch.from_numpy(lm.copy()))
    _close(yt, yj, TOL[dtype], "absorbed decode")
    _close(cache_t, cache_j, TOL[dtype], "decode cache")


def test_init_draws_a_large_leaf_a_slice_at_a_time(monkeypatch):
    """A leaf above ``params._WHOLE_DRAW`` elements (a full-width MoE
    model's stacked experts) is drawn one leading slice at a time: the
    slices are the draws of their shape in turn, scaled and cast."""
    monkeypatch.setattr(P, "_WHOLE_DRAW", 4096)
    spec = {"w": P.ParamSpec((4, 64, 64), ("layers", "embed", "mlp")),
            "b": P.ParamSpec((64,), ("mlp",), torch.float32, "zeros")}
    got = P.init(spec, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(0)
    want = torch.stack([(torch.randn((64, 64), generator=gen) * 0.02).to(
        torch.bfloat16) for _ in range(4)])
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], want)
    assert torch.equal(got["b"], torch.zeros(64))
