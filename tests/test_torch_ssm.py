"""Parity of the port's ssm and hybrid families with the JAX package on the
CPU: xlstm-1.3b (mLSTM and sLSTM blocks) and zamba2-1.2b (Mamba2 blocks and
one shared attention block), their blocks, caches and parameter trees.

The same numpy inputs, and the reference's own ``P.init`` weights carried
by ``repro_torch.bridge``, go through both packages.  zamba2's shared
attention reaches the Pallas flash-attention kernel in interpret mode on
the JAX side (``backend="pallas"``); the port's ``"kernel"`` backend runs
the kernel's plain version on a CPU tensor.  Tolerances
(tests/test_torch_lm_families.py's): float32 weights 1e-5 (abs and rel)
for blocks, states, logits and losses; bfloat16 weights 2e-2; prefill and
decode 0.06 absolute / 0.05 relative (tests/test_archs_smoke.py's).

One case holds the port where the reference is wrong (ROADMAP §C 11): at a
chunk of 256 the reference's Mamba2 scan overflows ``exp`` above the
diagonal and returns NaN; the port's scan is finite there and equals the
reference's own one-token recurrence run token by token.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get as j_get
from repro.models import mamba2 as j_m2
from repro.models import params as j_P
from repro.models import xlstm as j_xl
from repro.models.model import build_model as j_build
from repro.training import steps as j_steps
from repro_torch.bridge import lm_params_from_arrays, lm_params_to_arrays
from repro_torch.configs import get
from repro_torch.models import mamba2 as m2
from repro_torch.models import params as P
from repro_torch.models import xlstm as xl
from repro_torch.models.model import build_model
from repro_torch.training import steps

CONFIGS = ("xlstm-1.3b", "zamba2-1.2b")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2e-2}
SERVE_ATOL, SERVE_RTOL = 0.06, 0.05
# the published FULL parameter counts of the two configs' spec trees
FULL_PARAMS = {"xlstm-1.3b": 1_996_185_936, "zamba2-1.2b": 1_167_979_840}


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
    bit."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(np.array(a)).to(td)


def _arrays(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def _tree(tree):
    """A JAX parameter tree as the port's, through the bridge."""
    return lm_params_from_arrays(_arrays(tree), device="cpu")


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


def _leaves(tree):
    """The leaves of a port cache in JAX's flattening order: dict keys
    sorted, tuples (NamedTuples too) in field order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _assert_states(got, want, tol, name):
    assert type(got).__name__ == type(want).__name__
    for field, g, w in zip(want._fields, got, want):
        assert tuple(g.shape) == w.shape, (name, field)
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, (
            name, field, g.dtype, w.dtype)
        _close(g, w, tol, f"{name}.{field}")


# ---------------------------------------------------------------------------
# The blocks: Mamba2, mLSTM, sLSTM
# ---------------------------------------------------------------------------

def _block(spec_fn, name, dtype, seed, **cfg_change):
    """One block's JAX weights (``P.init``) and the port's copy, the two
    packages' smoke configs, both changed by ``cfg_change``."""
    jcfg = dataclasses.replace(j_get(name).smoke, **cfg_change)
    cfg = dataclasses.replace(get(name).smoke, **cfg_change)
    jp = j_P.init(spec_fn(jcfg), jax.random.PRNGKey(seed))
    if dtype == "f32":
        jp = _f32(jp)
    return jcfg, cfg, jp, _tree(jp)


def _x(cfg, b, s, seed, dtype):
    return _both(np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba2_chunked_scan_and_decode_match_jax(dtype):
    """The chunked scan over two chunks (chunk 32, S 64) from an initial
    state, its final state, then one decode step from that state."""
    jcfg, cfg, jp, tp = _block(j_m2.mamba2_spec, "zamba2-1.2b", dtype, 11)
    assert cfg.ssm.chunk == 32
    xj, xt = _x(cfg, 2, 65, 11, dtype)
    yj, sj = j_m2.mamba2_apply(jp, jcfg, xj[:, :64],
                               j_m2.init_state(jcfg, 2))
    yt, st = m2.mamba2_apply(tp, cfg, xt[:, :64],
                             m2.init_state(cfg, 2, "cpu"))
    assert yt.dtype == DTYPES[dtype][1] and yt.shape == (2, 64, 64)
    _close(yt, yj, TOL[dtype], "scan")
    _assert_states(st, sj, TOL[dtype], "scan state")
    # no state: the same output, no state back
    y0, none = m2.mamba2_apply(tp, cfg, xt[:, :64])
    assert none is None
    _close(y0, yj, TOL[dtype], "stateless scan")
    yj, sj = j_m2.mamba2_apply(jp, jcfg, xj[:, 64:], sj)
    yt, st = m2.mamba2_apply(tp, cfg, xt[:, 64:], st)
    _close(yt, yj, TOL[dtype], "decode")
    _assert_states(st, sj, TOL[dtype], "decode state")


def test_mamba2_asserts_whole_chunks():
    _, cfg, _, tp = _block(j_m2.mamba2_spec, "zamba2-1.2b", "f32", 12)
    with pytest.raises(AssertionError, match="not divisible"):
        m2.mamba2_apply(tp, cfg, torch.zeros((1, 48, cfg.d_model)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlstm_chunked_and_decode_match_jax(dtype):
    """``chunk=16`` over S 64 (four chunks) from an initial state, its
    final state, then one decode step from that state."""
    jcfg, cfg, jp, tp = _block(j_xl.mlstm_spec, "xlstm-1.3b", dtype, 13)
    xj, xt = _x(cfg, 2, 65, 13, dtype)
    yj, sj = j_xl.mlstm_apply(jp, jcfg, xj[:, :64],
                              j_xl.mlstm_init_state(jcfg, 2), chunk=16)
    yt, st = xl.mlstm_apply(tp, cfg, xt[:, :64],
                            xl.mlstm_init_state(cfg, 2, "cpu"), chunk=16)
    assert yt.dtype == DTYPES[dtype][1] and yt.shape == (2, 64, 64)
    _close(yt, yj, TOL[dtype], "chunked")
    _assert_states(st, sj, TOL[dtype], "chunked state")
    yj, sj = j_xl.mlstm_apply(jp, jcfg, xj[:, 64:], sj)
    yt, st = xl.mlstm_apply(tp, cfg, xt[:, 64:], st)
    _close(yt, yj, TOL[dtype], "decode")
    _assert_states(st, sj, TOL[dtype], "decode state")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s", [64, 128])
def test_slstm_matches_jax(s, dtype):
    """S 64 takes the reference's flat scan, S 128 its two 64-step
    checkpointed segments: the same forward, looped over time here."""
    jcfg, cfg, jp, tp = _block(j_xl.slstm_spec, "xlstm-1.3b", dtype, 14)
    xj, xt = _x(cfg, 2, s, 14, dtype)
    yj, sj = j_xl.slstm_apply(jp, jcfg, xj, j_xl.slstm_init_state(jcfg, 2))
    yt, st = xl.slstm_apply(tp, cfg, xt, xl.slstm_init_state(cfg, 2, "cpu"))
    assert yt.dtype == DTYPES[dtype][1] and yt.shape == (2, s, 64)
    _close(yt, yj, TOL[dtype], "out")
    _assert_states(st, sj, TOL[dtype], "state")


def test_mamba2_chunk_256_is_finite_where_the_reference_overflows():
    """ROADMAP §C 11.  One Mamba2 block at the published chunk of 256 over
    S 256 on float32 weights (zero-init ``dt_bias`` and ``a_log``: dt ~0.7,
    A = -1, so ``cum_i - cum_j`` above the diagonal reaches ~180 and
    ``exp`` overflows).  The reference's chunked output holds NaN; the
    port's is finite and equals the reference's own one-token recurrence
    (``mamba2_apply`` with S = 1 and a state, which has no overflow) run
    token by token, to 1e-4 abs and rel: the scan's decays are exp of
    differences of cumulative sums, the recurrence's their running
    products, which differ by float32 rounding over 256 steps."""
    ssm = dataclasses.replace(get("zamba2-1.2b").smoke.ssm, chunk=256)
    jcfg, cfg, jp, tp = _block(j_m2.mamba2_spec, "zamba2-1.2b", "f32", 15,
                               ssm=ssm)
    xj, xt = _x(cfg, 2, 256, 15, "f32")
    yj, _ = j_m2.mamba2_apply(jp, jcfg, xj)
    nan_share = float(np.isnan(_np(yj)).mean())
    print(f"the reference's chunked output: NaN in {100 * nan_share:.1f} % "
          "of its elements")
    assert nan_share > 0.1, nan_share
    yt, _ = m2.mamba2_apply(tp, cfg, xt)
    assert bool(torch.isfinite(yt).all())
    step = jax.jit(lambda p, x, st: j_m2.mamba2_apply(p, jcfg, x, st))
    st = j_m2.init_state(jcfg, 2)
    rows = []
    for t in range(256):
        y, st = step(jp, xj[:, t:t + 1], st)
        rows.append(np.asarray(y))
    want = np.concatenate(rows, axis=1)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(_np(yt), want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The two models at their smoke sizes, on the reference's weights
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_init(name):
    jm = j_build(j_get(name).smoke)
    return jm, jax.jit(lambda key: j_P.init(jm.spec, key))(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _models(name, dtype):
    jm, jp = _jax_init(name)
    if dtype == "f32":
        jp = _f32(jp)
    model = build_model(get(name).smoke)
    model.load_params(_tree(jp))
    return jm, jp, model, model.params


def _batch(cfg, dtype, b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    mask = rng.random((b, s)) < 0.7
    jb = {"tokens": jnp.asarray(tok[:, :-1]),
          "labels": jnp.asarray(tok[:, 1:]), "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": torch.from_numpy(tok[:, :-1].copy()),
          "labels": torch.from_numpy(tok[:, 1:].copy()),
          "loss_mask": torch.from_numpy(mask)}
    return jb, tb


@functools.lru_cache(maxsize=None)
def _jax_logits(name, dtype, backend):
    jm, jp, _, _ = _models(name, dtype)
    jb, _ = _batch(jm.cfg, dtype)
    fn = jax.jit(lambda p, t: jm.logits(p, {"tokens": t}, backend=backend,
                                        remat="none"))
    return _np(fn(jp, jb["tokens"]))


@pytest.mark.parametrize("backend", ["chunked", "kernel"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", CONFIGS)
def test_logits_match_jax(name, dtype, backend):
    """zamba2's two groups each run the shared attention block once: on
    ``"kernel"`` against JAX's Pallas kernel in interpret mode.  xLSTM has
    no attention; both backends run the same blocks."""
    jm, _, model, tp = _models(name, dtype)
    _, tb = _batch(jm.cfg, dtype)
    got = model.logits(tp, {"tokens": tb["tokens"]}, backend=backend)
    assert got.dtype == DTYPES[dtype][1]
    assert got.shape == (2, 64, jm.cfg.padded_vocab)
    jax_backend = "pallas" if backend == "kernel" else backend
    _close(got, _jax_logits(name, dtype, jax_backend), TOL[dtype])


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_matches_jax(name):
    """float32 weights, with and without a loss mask."""
    jm, jp, model, tp = _models(name, "f32")
    jb, tb = _batch(jm.cfg, "f32")
    fn = jax.jit(lambda p, b: j_steps.loss_fn(jm, p, b, remat="none"))
    plain = {k: v for k, v in jb.items() if k != "loss_mask"}
    _close(steps.loss_fn(model, tp, {k: v for k, v in tb.items()
                                     if k != "loss_mask"},
                         backend="kernel"), fn(jp, plain), 1e-5)
    _close(steps.loss_fn(model, tp, tb), fn(jp, jb), 1e-5, "masked")


def _cache_like_jax(cache_t, cache_j, tol, name):
    got, want = _leaves(cache_t), jax.tree_util.tree_leaves(cache_j)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, (name, i)
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, (
            name, i, g.dtype, w.dtype)
        if tol is not None:
            _close(g, w, tol, f"{name} leaf {i}")


def _cache_values(cache_t, cache_j, tol, name):
    """Shapes and types as JAX's, values to ``tol`` (abs, rel); a bfloat16
    leaf (zamba2's KV cache, bfloat16 whatever the weights) to the bf16
    tolerance: an input one float32 ulp apart may round to the next bf16
    value."""
    _cache_like_jax(cache_t, cache_j, None, name)
    for i, (g, w) in enumerate(zip(_leaves(cache_t),
                                   jax.tree_util.tree_leaves(cache_j))):
        t = (TOL["bf16"],) * 2 if g.dtype == torch.bfloat16 else tol
        np.testing.assert_allclose(_np(g), _np(w), atol=t[0], rtol=t[1],
                                   err_msg=f"{name} leaf {i}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_jax(name, dtype):
    """Prefill 16 tokens, then 3 decode steps on JAX's greedy tokens: the
    logits and every cache leaf (shapes, types, values) against JAX's
    prefill and decode, and the logits against the port's own forward
    over the 19 tokens.  float32 weights hold to 1e-5: a conv tail rounded
    back to the bfloat16 of ``init_state`` would not (JAX's concatenate
    promotes it to float32)."""
    jm, jp, model, tp = _models(name, dtype)
    cfg = jm.cfg
    jb, tb = _batch(cfg, dtype, s=32, seed=1)
    tol = (TOL["f32"], TOL["f32"]) if dtype == "f32" else (SERVE_ATOL,
                                                           SERVE_RTOL)
    cache_j = jm.init_cache(2, 24)
    cache_t = model.init_cache(2, 24, device="cpu")
    _cache_like_jax(cache_t, cache_j, 0.0, "init")
    lj, cache_j = jax.jit(jm.prefill)(jp, {"tokens": jb["tokens"][:, :16]},
                                      cache_j)
    lt, cache_t = steps.make_prefill_step(model)(
        tp, {"tokens": tb["tokens"][:, :16]}, cache_t)
    np.testing.assert_allclose(_np(lt), _np(lj), atol=tol[0], rtol=tol[1])
    _cache_values(cache_t, cache_j, tol, "prefill")
    dec_j = jax.jit(j_steps.make_serve_decode_step(jm))
    dec_t = steps.make_serve_decode_step(model)
    rows = [lt[:, -1]]
    tok = np.asarray(jnp.argmax(lj[:, -1], axis=-1)).astype(np.int32)[:, None]
    seq = [tb["tokens"][:, :16]]
    for idx in range(16, 19):
        seq.append(torch.from_numpy(tok))
        lj, cache_j = dec_j(jp, cache_j, jnp.asarray(tok), jnp.int32(idx))
        lt, cache_t = dec_t(tp, cache_t, torch.from_numpy(tok), idx)
        assert lt.shape == (2, 1, cfg.padded_vocab)
        np.testing.assert_allclose(_np(lt), _np(lj), atol=tol[0],
                                   rtol=tol[1])
        rows.append(lt[:, 0])
        tok = np.asarray(jnp.argmax(lj[:, -1], axis=-1)).astype(
            np.int32)[:, None]
    _cache_values(cache_t, cache_j, tol, "decode")
    # the port's serving against its own forward over the 19 tokens
    fwd = model.logits(tp, {"tokens": torch.cat(seq, dim=1)})[:, 15:19]
    np.testing.assert_allclose(_np(torch.stack(rows, dim=1)), _np(fwd),
                               atol=SERVE_ATOL, rtol=SERVE_RTOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_init_cache_needs_a_device_or_a_gpu(name):
    """Without a GPU the default ``device="cuda"`` raises; ``"cpu"`` is
    asked for explicitly."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    _, _, model, _ = _models(name, "bf16")
    with pytest.raises(Exception, match="(?i)cuda|gpu"):
        model.init_cache(2, 8)


@pytest.mark.parametrize("name", CONFIGS)
def test_full_parameter_count_matches_the_reference_spec(name):
    full = get(name).full
    assert P.count_params(build_model(full).spec) == FULL_PARAMS[name] == \
        j_P.count_params(j_build(j_get(name).full).spec)


@pytest.mark.parametrize("name", CONFIGS)
def test_bridge_round_trip_of_the_nested_stacks(name):
    """The nested stacked trees ((segments, blocks, ...) and (groups,
    blocks, ...)) cross both ways exactly, each leaf's type kept, and
    ``load_params`` registers them under the reference's dotted paths."""
    _, jp, model, tp = _models(name, "bf16")
    want = _arrays(jp)
    back = lm_params_to_arrays(tp)
    assert set(back) == set(want) == set(model.state_dict())
    nested = {"xlstm-1.3b": "mlstm.w_up", "zamba2-1.2b": "mamba.w_in"}[name]
    cfg = get(name).smoke
    lead = ((cfg.n_layers // cfg.xlstm.slstm_every, cfg.xlstm.slstm_every - 1)
            if cfg.family == "ssm" else
            (cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every))
    assert back[nested].shape[:2] == lead
    for path, a in want.items():
        got = tp
        for key in path.split("."):
            got = got[key]
        assert got.dtype == (torch.float32 if a.dtype == np.float32
                             else torch.bfloat16), path
        np.testing.assert_array_equal(back[path], a.astype(np.float32),
                                      err_msg=path)
    assert model.state_dict()[nested].data_ptr() == \
        tp[nested.split(".")[0]][nested.split(".")[1]].data_ptr()


def test_slstm_recurrence_amplifies_rounding_at_the_published_width():
    """A property of the reference, not a fault (ROADMAP §C, properties):
    at xlstm-1.3b's width the sLSTM recurrence amplifies a rounding
    difference ~10x a step.  ``r_gates``' "scaled" init takes its fan-in
    from the heads axis (4) where the product sums 512 terms, so its
    weights have std 0.5.  On the reference's weights and one input, the
    reference and the port (float32 both) agree after one step and part
    by more than 0.1 in ``h`` within 32, as the port's float32 and
    float64 runs do: two correct runs whose sums round differently cannot
    agree over a long sequence."""
    jcfg, cfg = j_get("xlstm-1.3b").full, get("xlstm-1.3b").full
    jp = _f32(jax.jit(lambda k: j_P.init(j_xl.slstm_spec(jcfg), k))(
        jax.random.PRNGKey(16)))
    tp = _tree(jp)
    assert abs(float(tp["r_gates"].std()) - 0.5) < 0.01
    xj, xt = _x(cfg, 1, 32, 16, "f32")
    sj = j_xl.slstm_init_state(jcfg, 1)
    st32 = xl.slstm_init_state(cfg, 1, "cpu")
    st64 = xl.SLSTMState(*(a.double() for a in st32))
    gx = torch.einsum("bsd,dg->bsg", xt, tp["w_gates"]) + tp["b_gates"]
    step = jax.jit(lambda p, x, s: j_xl.slstm_apply(p, jcfg, x, s))
    apart = {}
    for t in range(32):
        _, sj = step(jp, xj[:, t:t + 1], sj)
        st32 = xl._slstm_step(st32, gx[:, t], tp["r_gates"])
        st64 = xl._slstm_step(st64, gx[:, t].double(),
                              tp["r_gates"].double())
        apart[t + 1] = (float(np.abs(_np(st32.h) - _np(sj.h)).max()),
                        float((st32.h.double() - st64.h).abs().max()))
    assert apart[1][0] < 1e-5 and apart[1][1] < 1e-5, apart[1]
    assert apart[32][0] > 0.1 and apart[32][1] > 0.1, apart[32]
