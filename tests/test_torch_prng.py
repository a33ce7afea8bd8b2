"""The port's threefry RNG (``repro_torch.core.prng``) against ``jax.random``
with this JAX's defaults (threefry2x32, ``jax_threefry_partitionable``),
on the same uint32 keys: ``PRNGKey``, ``split``, ``fold_in``, the random
bits and ``uniform`` bit for bit; ``normal`` within 2 float32 ulp and
bit-equal on all but a few in 10^4 (the share is asserted: XLA's CPU
``log``/``log1p`` and the port's copy of them may round a last bit
differently).  Also the engine's key lineage: ``init_state``'s keys equal
the reference's on one device and on meshes, from a seed and from a
``base_key``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Domain as JDomain
from repro.core import Engine as JEngine
from repro.sims import cell_clustering as j_cc
from repro_torch.core import Domain, Engine, prng
from repro_torch.sims import cell_clustering as cc
from torch_parity import soa_inputs, torch_threads


# Small-tensor loops: one torch thread (beside busy test workers torch's
# thread pool slows them many times over).
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


SEEDS = [0, 1, 42, 2**31 - 1, 12345]
SHAPES = [(), (5,), (7, 3, 2), (1001,), (3, 337)]
DATA = [0, 1, 7, 2**31 - 1, 2**31, 3_000_000_000, 2**32 - 1]


def _t(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64)).to(
        torch.uint32)


def _n(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def test_jax_defaults_are_the_ported_ones():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_and_fold_in_are_bit_exact(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_n(kt), np.asarray(kj))
    for num in (1, 2, 3, 7, (2, 3)):
        np.testing.assert_array_equal(_n(prng.split(kt, num)),
                                      np.asarray(jax.random.split(kj, num)))
    for d in DATA:
        want = np.asarray(jax.random.fold_in(kj, np.uint32(d)))
        np.testing.assert_array_equal(_n(prng.fold_in(kt, d)), want)
        as_tensor = torch.tensor(d, dtype=torch.int64)
        np.testing.assert_array_equal(_n(prng.fold_in(kt, as_tensor)), want)
    # an int32 tensor (the engine's iteration counter) folds its bits
    np.testing.assert_array_equal(
        _n(prng.fold_in(kt, torch.tensor(9, dtype=torch.int32))),
        np.asarray(jax.random.fold_in(kj, jnp.int32(9))))


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_fold_in_is_vmapped_fold_in(seed):
    """A batch of keys folded with a tensor of data (the engine's per-device
    step keys: the iteration counter, then the rank) is JAX's
    ``vmap(fold_in)``."""
    keys_j = jax.random.split(jax.random.PRNGKey(seed), 6).reshape(2, 3, 2)
    it = np.array([[0, 1, 2], [2**31 - 1, 5, 7]], np.int32)
    ranks = np.arange(6, dtype=np.int32).reshape(2, 3)
    fold = jax.vmap(jax.vmap(jax.random.fold_in))
    want = fold(fold(keys_j, jnp.asarray(it)), jnp.asarray(ranks))
    kt = _t(np.asarray(keys_j))
    got = prng.fold_in(prng.fold_in(kt, torch.from_numpy(it)),
                       torch.from_numpy(ranks))
    np.testing.assert_array_equal(_n(got), np.asarray(want))
    # a Python int folds every key of the batch
    np.testing.assert_array_equal(
        _n(prng.fold_in(kt, 3)),
        np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.fold_in(k, 3)))(
            keys_j)))


def test_keys_with_high_bits_set():
    """Keys whose words are >= 2**31 (their int32 views negative)."""
    raw = np.array([0xDEADBEEF, 0x80000001], np.uint32)
    kj, kt = jnp.asarray(raw), _t(raw)
    np.testing.assert_array_equal(_n(prng.split(kt, 4)),
                                  np.asarray(jax.random.split(kj, 4)))
    np.testing.assert_array_equal(_n(prng.fold_in(kt, 2**32 - 1)),
                                  np.asarray(jax.random.fold_in(kj, 2**32 - 1)))
    np.testing.assert_array_equal(
        prng.random_bits(kt, (9, 4)).numpy().view(np.uint32),
        np.asarray(jax.random.bits(kj, (9, 4))))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_are_bit_exact(seed, shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    kt = prng.fold_in(prng.PRNGKey(seed), 3)
    np.testing.assert_array_equal(
        prng.random_bits(kt, shape).numpy().view(np.uint32),
        np.asarray(jax.random.bits(kj, shape)))
    for lo, hi in ((0.0, 1.0), (-2.5, 3.0), (0.25, 0.5)):
        got = prng.uniform(kt, shape, minval=lo, maxval=hi)
        want = np.asarray(jax.random.uniform(kj, shape, minval=lo,
                                             maxval=hi))
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("shape", [(), (5,), (7, 3, 2), (200_001,)], ids=str)
@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_normal_within_two_ulp(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    got = prng.normal(kt, shape).numpy()
    want = np.asarray(jax.random.normal(kj, shape))
    assert got.shape == want.shape and got.dtype == np.float32
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max(initial=0) <= 2
    if got.size > 1000:
        # 99.99 % bit-equal measured on these draws
        assert (ulp == 0).mean() >= 0.999


def test_erfinv_polynomial_against_jax():
    """XLA's float32 ErfInv (with its log1p) over [nextafter(-1, 0), 1)."""
    x = np.linspace(-0.9999999, 0.9999999, 100_003).astype(np.float32)
    got = prng.erfinv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 2 and (ulp == 0).mean() >= 0.999


def test_key_type_is_checked():
    with pytest.raises(TypeError):
        prng.split(torch.zeros(2, dtype=torch.int64))
    with pytest.raises(OverflowError):
        prng.fold_in(prng.PRNGKey(0), -1)


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2), (2, 1)])
@pytest.mark.parametrize("seed", [0, 17])
def test_init_state_keys_match_jax(mesh, seed):
    """``split(PRNGKey(seed), n_devices)`` in mesh shape, and from
    ``fold_in(base_key, it0)`` when a base key is given."""
    kw = dict(cell_size=2.0, interior=(4, 4), mesh_shape=mesh, cap=16)
    eng_j = JEngine(geom=JDomain(**kw), behavior=j_cc.behavior())
    eng_t = Engine(geom=Domain(**kw), behavior=cc.behavior(), device="cpu")
    pos, attrs = soa_inputs(60, 2, eng_t.geom.domain_size, seed)
    st_j = eng_j.init_state(pos, attrs, seed=seed)
    st_t = eng_t.init_state(pos, attrs, seed=seed)
    assert st_t.key.shape == mesh + (2,)
    np.testing.assert_array_equal(_n(st_t.key), np.asarray(st_j.key))
    base = np.array([123, 2**32 - 5], np.uint32)
    st_j = eng_j.init_state(pos, attrs, seed=seed, it0=6, base_key=base)
    st_t = eng_t.init_state(pos, attrs, seed=seed, it0=6, base_key=base)
    np.testing.assert_array_equal(_n(st_t.key), np.asarray(st_j.key))
    assert int(st_t.it.max()) == int(np.asarray(st_j.it).max()) == 6
