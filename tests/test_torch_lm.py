"""Parity of the port's LM slice (olmo-1b and internlm2-20b, the dense GQA
family; the registry and specs of every ported config) with the JAX
package, on the CPU.

The same numpy inputs, and the reference's own ``P.init`` weights carried
by ``repro_torch.bridge``, go through both packages.  The JAX side reaches
the Pallas flash-attention kernel in interpret mode (``backend="pallas"``,
as tests/test_kernels.py runs it); the port's ``"kernel"`` backend runs
the kernel's plain version on a CPU tensor.  Tolerances: layers in float32
1e-6; attention float32 2e-5 and bfloat16 2e-2 (tests/test_kernels.py's);
whole-model logits and the loss 1e-5 with float32 weights, 2e-2 with
bfloat16 ones; prefill and decode 0.06 absolute / 0.05 relative
(tests/test_archs_smoke.py's decode-vs-forward tolerances).

The CUDA kernel itself is held against its plain version in
tests/test_torch_kernel.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get as j_get
from repro.kernels import ops as j_ops
from repro.kernels.flash_attention import flash_attention_kernel
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import params as j_P
from repro.models.model import build_model as j_build
from repro.training import steps as j_steps
from repro_torch.bridge import lm_params_from_arrays, lm_params_to_arrays
from repro_torch.configs import get, names
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import model as model_mod
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.training import steps

CONFIGS = ("internlm2-20b", "olmo-1b")
# every registered config: the dense GQA two above, the transformer-block
# families of tests/test_torch_lm_families.py and the ssm and hybrid ones
# of tests/test_torch_ssm.py
REGISTERED = ("hubert-xlarge", "internlm2-20b", "llava-next-mistral-7b",
              "minicpm-2b", "minicpm3-4b", "olmo-1b", "phi3.5-moe-42b-a6.6b",
              "qwen3-moe-235b-a22b", "xlstm-1.3b", "zamba2-1.2b")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, dtype=None):
    """A numpy (or JAX) array as a CPU tensor, bfloat16 via float32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _np(x) -> np.ndarray:
    """float32 numpy of a tensor or JAX array (bfloat16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=name)


def _normal(seed, shape, dtype="f32"):
    """Seeded normals in both packages' ``dtype``, equal bit for bit."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _jax_paths(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.key for k in path): leaf for path, leaf in leaves}


# ---------------------------------------------------------------------------
# Configs and parameter specs
# ---------------------------------------------------------------------------

def test_registry_has_the_dense_gqa_configs():
    assert names() == REGISTERED
    assert set(CONFIGS) <= set(names())


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("name", REGISTERED)
def test_config_and_spec_match_reference(name, size):
    cfg, jcfg = getattr(get(name), size), getattr(j_get(name), size)
    # field by field, nested MLAConfig / MoEConfig too (their types are
    # each package's own)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.model_flops_per_token() == jcfg.model_flops_per_token()
    spec, jspec = build_model(cfg).spec, j_build(jcfg).spec
    assert P.count_params(spec) == j_P.count_params(jspec)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jspec,
                                                      is_leaf=j_P.is_spec)
    flat = {".".join(k.key for k in p): s for p, s in leaves}
    ours = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                ours[f"{prefix}{k}"] = v
    walk(spec, "")
    assert set(ours) == set(flat)
    for path, s in ours.items():
        js = flat[path]
        assert (s.shape, s.logical, s.init, s.scale) == (
            js.shape, js.logical, js.init, js.scale), path
        assert str(s.dtype).split(".")[-1] == jnp.dtype(js.dtype).name


def test_init_draws_every_leaf_on_the_asked_device():
    cfg = get("olmo-1b").smoke
    spec = build_model(cfg).spec
    a = P.init(spec, torch.Generator().manual_seed(0), device="cpu")
    b = P.init(spec, torch.Generator().manual_seed(0), device="cpu")
    w = a["blocks"]["attn"]["wq"]
    assert w.dtype == torch.bfloat16 and w.shape == (2, 64, 4, 16)
    assert torch.equal(w, b["blocks"]["attn"]["wq"])
    std = float(a["embed"]["w"].float().std())
    assert 0.018 < std < 0.022                # normal x 0.02, as the spec
    r = P.init(build_model(get("internlm2-20b").smoke).spec,
               torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(r["ln_f"]["scale"], torch.ones(64))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norms_match(norm):
    xj, xt = _normal(0, (2, 5, 64))
    rng = np.random.default_rng(1)
    prm = {"scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
           "bias": rng.standard_normal(64).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in prm.items()}
    tp = {k: torch.from_numpy(v) for k, v in prm.items()}
    _close(layers.NORM_FNS[norm](tp, xt), j_layers.NORM_FNS[norm](jp, xj),
           1e-6, norm)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches(theta):
    xj, xt = _normal(2, (2, 4, 96, 16))
    pos = np.arange(96, dtype=np.int32)
    _close(layers.rope(xt, torch.from_numpy(pos), theta),
           j_layers.rope(xj, jnp.asarray(pos), theta), 1e-6)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu_mlp"])
def test_mlps_match(mlp):
    xj, xt = _normal(3, (2, 7, 32))
    spec = getattr(j_layers, mlp + "_spec")(32, 48)
    jp = jax.tree_util.tree_map(
        lambda s: s.astype(jnp.float32),
        j_P.init(spec, jax.random.PRNGKey(1)))
    jp = {k: v + 0.1 if k.startswith("b_") else v for k, v in jp.items()}
    tp = {k: _t(v) for k, v in jp.items()}
    _close(getattr(layers, mlp)(tp, xt), getattr(j_layers, mlp)(jp, xj),
           1e-6)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

TOL = {"f32": 2e-5, "bf16": 2e-2}


@pytest.mark.parametrize("bh,sq,skv,hd", [
    (2, 128, 128, 64),
    (1, 256, 256, 128),
    (3, 128, 256, 32),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_matches_jax_kernel(bh, sq, skv, hd, causal, dtype):
    (qj, qt), (kj, kt), (vj, vt) = (
        _normal(s, (bh, n, hd), dtype)
        for s, n in ((10, sq), (11, skv), (12, skv)))
    want = flash_attention_kernel(qj, kj, vj, causal=causal, interpret=True)
    for got in (fa.flash_attention_plain(qt, kt, vt, causal=causal),
                fa.flash_attention(qt, kt, vt, causal=causal)):
        assert got.dtype == DTYPES[dtype][1]
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_bhsd_gqa_matches_jax(dtype):
    (qj, qt) = _normal(20, (2, 8, 128, 64), dtype)
    (kj, kt) = _normal(21, (2, 2, 128, 64), dtype)
    (vj, vt) = _normal(22, (2, 2, 128, 64), dtype)
    _close(ops.flash_attention_bhsd(qt, kt, vt, causal=True),
           j_ops.flash_attention_bhsd(qj, kj, vj, causal=True), TOL[dtype])


@pytest.mark.parametrize("hd,hdv", [(80, 80), (80, 48), (24, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_head_dim_padding_on_cpu(hd, hdv, causal, dtype):
    """What the wrapper does on the card for a head dim the kernels are not
    built for: zero-pad q, k along hd and v along hdv to built dims, run at
    the true ``hd ** -0.5``, cut the output back.  Here the padded call
    runs the plain version, against the plain version unpadded (float32 to
    1e-6: the zero terms change only the order of the dot products' sums)
    and the JAX kernel at hd 80 in interpret mode (its own tolerance)."""
    qj, qt = _normal(30, (2, 128, hd), dtype)
    kj, kt = _normal(31, (2, 128, hd), dtype)
    vj, vt = _normal(32, (2, 128, hdv), dtype)
    qp, kp, vp = fa.pad_head_dims(qt, kt, vt)
    assert qp.shape[-1] == fa.built_head_dim(hd) > hd
    assert vp.shape[-1] == fa.built_head_dim(hdv)
    got = fa.flash_attention_plain(qp, kp, vp, causal=causal,
                                   scale=hd ** -0.5)[..., :hdv]
    want = fa.flash_attention_plain(qt, kt, vt, causal=causal)
    _close(got, want, 1e-6 if dtype == "f32" else 1e-2)
    _close(got, flash_attention_kernel(qj, kj, vj, causal=causal,
                                       interpret=True), TOL[dtype])
    with pytest.raises(ValueError, match="head dim"):
        fa.built_head_dim(129)


def test_flash_wrapper_refuses_what_the_tpu_kernel_refuses():
    q = torch.zeros((1, 192, 16))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, q, q)             # 192 % 128
    before = dict(fa.LAUNCHES)
    fa.flash_attention(q[:, :64], q[:, :64], q[:, :64])
    assert fa.LAUNCHES == before                # a CPU tensor never counts


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hkv", [4, 1])
def test_sdpa_chunked_and_decode_match(hkv, dtype):
    (qj, qt) = _normal(30, (2, 4, 64, 16), dtype)
    (kj, kt) = _normal(31, (2, hkv, 64, 16), dtype)
    (vj, vt) = _normal(32, (2, hkv, 64, 16), dtype)
    for causal, off in ((True, 0), (False, 0), (True, 16)):
        _close(attn.sdpa_chunked(qt, kt, vt, causal, q_offset=off, chunk=16),
               j_attn.sdpa_chunked(qj, kj, vj, causal, q_offset=off,
                                   chunk=16), TOL[dtype])
    lm = np.arange(64)[None, :] <= np.array([[40], [63]])
    _close(attn.sdpa_decode(qt[:, :, :1], kt, vt, torch.from_numpy(lm)),
           j_attn.sdpa_decode(qj[:, :, :1], kj, vj, jnp.asarray(lm)),
           TOL[dtype])


def test_unported_attention_and_backends_raise():
    cfg = get("olmo-1b").smoke
    with pytest.raises(ValueError, match="backend"):
        attn.gqa_apply({}, cfg, torch.zeros(1, 4, 64), torch.arange(4),
                       backend="pallas")


# ---------------------------------------------------------------------------
# The whole slice at the smoke sizes, on the reference's weights
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(name, dtype):
    jcfg = j_get(name).smoke
    jm = j_build(jcfg)
    jp = j_P.init(jm.spec, jax.random.PRNGKey(0))
    if dtype == "f32":
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    arrays = {k: np.asarray(v) for k, v in _jax_paths(jp).items()}
    model = build_model(get(name).smoke)
    model.load_params(lm_params_from_arrays(arrays, device="cpu"))
    return jm, jp, model, model.params


def _batch(cfg, b=2, s=128, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(tok[:, :-1]),
             "labels": jnp.asarray(tok[:, 1:])},
            {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])})


@functools.lru_cache(maxsize=None)
def _jax_logits(name, dtype):
    jm, jp, _, _ = _models(name, dtype)
    jb, _ = _batch(jm.cfg)
    return np.asarray(jm.logits(jp, jb, backend="pallas",
                                remat="none").astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", CONFIGS)
def test_kernel_backend_logits_match_jax_pallas(name, dtype):
    jm, jp, model, tp = _models(name, dtype)
    _, tb = _batch(jm.cfg)
    got = model.logits(tp, tb, backend="kernel")
    assert got.dtype == DTYPES[dtype][1]
    assert got.shape == (2, 128, jm.cfg.padded_vocab)
    tol = 1e-5 if dtype == "f32" else 2e-2
    _close(got, _jax_logits(name, dtype), tol)
    _close(model.logits(tp, tb), _jax_logits(name, dtype), tol, "chunked")


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_matches_jax(name):
    jm, jp, model, tp = _models(name, "f32")
    jb, tb = _batch(jm.cfg)
    want = j_steps.loss_fn(jm, jp, jb, backend="chunked", remat="none")
    got = steps.loss_fn(model, tp, tb, backend="kernel")
    _close(got, want, 1e-5)
    mask = np.random.default_rng(5).random((2, 128)) < 0.7
    jb["loss_mask"], tb["loss_mask"] = jnp.asarray(mask), torch.from_numpy(
        mask)
    _close(steps.loss_fn(model, tp, tb),
           j_steps.loss_fn(jm, jp, jb, remat="none"), 1e-5, "masked")


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_jax(name):
    """Prefill 16 tokens, then 3 greedy decode steps on JAX's tokens, both
    packages on bfloat16 weights and caches."""
    jm, jp, model, tp = _models(name, "bf16")
    jb, tb = _batch(jm.cfg, s=32, seed=1)
    cache_j = jm.init_cache(2, 24)
    cache_t = model.init_cache(2, 24, device="cpu")
    lj, cache_j = jm.prefill(jp, {"tokens": jb["tokens"][:, :16]}, cache_j)
    prefill = steps.make_prefill_step(model)
    lt, cache_t = prefill(tp, {"tokens": tb["tokens"][:, :16]}, cache_t)
    _close(lt, lj, 0.06)
    np.testing.assert_allclose(_np(cache_t[0]), _np(cache_j[0]), atol=0.06,
                               rtol=0.05)
    dec_j = jax.jit(j_steps.make_serve_decode_step(jm))
    dec_t = steps.make_serve_decode_step(model)
    tok = np.asarray(jnp.argmax(lj[:, -1], axis=-1)).astype(np.int32)[:, None]
    for idx in range(16, 19):
        lj, cache_j = dec_j(jp, cache_j, jnp.asarray(tok), jnp.int32(idx))
        lt, cache_t = dec_t(tp, cache_t, torch.from_numpy(tok), idx)
        assert lt.shape == (2, 1, jm.cfg.padded_vocab)
        np.testing.assert_allclose(_np(lt), _np(lj), atol=0.06, rtol=0.05)
        tok = np.asarray(jnp.argmax(lj[:, -1], axis=-1)).astype(
            np.int32)[:, None]


def test_bridge_round_trip_is_exact_in_bf16():
    jm, jp, model, tp = _models("olmo-1b", "bf16")
    want = _jax_paths(jp)
    back = lm_params_to_arrays(tp)
    assert set(back) == set(want)
    for path, a in want.items():
        got = tp
        for key in path.split("."):
            got = got[key]
        assert got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(back[path], _np(a), err_msg=path)
    model.load_params(tp)
    assert set(model.state_dict()) == set(want)
    assert model.params["blocks"]["attn"]["wq"].data_ptr() == \
        tp["blocks"]["attn"]["wq"].data_ptr()
    with pytest.raises(KeyError):
        model.load_params({"embed": tp["embed"]})


@pytest.mark.parametrize("change", [dict(family="ssm"),
                                    dict(family="hybrid")])
def test_unported_families_raise(change):
    """Every family of the reference is ported: ssm and hybrid build (their
    configs' smoke sizes), and a family the reference does not know raises
    its ``ValueError``, in ``build_model`` as in the forward."""
    name = {"ssm": "xlstm-1.3b", "hybrid": "zamba2-1.2b"}[change["family"]]
    assert get(name).smoke.family == change["family"]
    build_model(get(name).smoke)
    cfg = dataclasses.replace(get("olmo-1b").smoke, family="unknown")
    with pytest.raises(ValueError, match="unknown"):
        build_model(cfg)
    with pytest.raises(ValueError, match="unknown"):
        model_mod._forward({}, cfg, {}, "chunked")
