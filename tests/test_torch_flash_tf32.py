"""The arithmetic of the float32 tensor-core attention kernel, checked on the CPU.

``flash_attention_kernel`` (src/repro_torch/kernels/csrc/flash_attention.cu)
runs every attention that is not bf16 at hd = hdv in {64, 128}: float32
q, k, v, the other head dims and hd != hdv.  It computes its products on
the tensor cores in TF32 (10-bit mantissas) and keeps float32's accuracy by
splitting each float32 operand x into big = rna(x) and small = rna(x - big)
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero).  What it
computes differently from the TPU kernel is that rounding, and a plain
emulation shows it here:

* S = Qs Kb + Qb Ks + Qb Kb (small terms first; small x small dropped),
  float32 sums, the scale applied to the float32 S in log2 units;
* 64-key tiles, the online softmax updated once a tile through exp2, keys
  past Skv and (causal) after the row masked to -1e30;
* O += Ps Vb + Pb Vs + Pb Vb, then acc / max(l, 1e-30);
* bf16 operands are exact in TF32: their S is one product, PV two (the
  split of p alone).

The emulation is held against the port's plain version and against the
JAX package's Pallas kernel in interpret mode (as tests/test_kernels.py
runs it) at the float32 gate the card's kernel meets in chip_smoke.py,
2e-5 absolute and relative.  One TF32 product of unsplit operands misses
that gate, which is why the kernel splits them.

``mma.sync`` itself rounds its sums differently: it truncates them toward
zero.  :func:`mma_sum` models that, and the last tests show that chaining
every product of S and of O into one accumulator costs the accuracy that
exp2 and the dropped small x small term do not, and that the kernel's
short runs from zero (``kSSteps`` k-steps of S, a tile of P V) keep it.
Run as a script, the file prints those readings:

    PYTHONPATH=src python tests/test_torch_flash_tf32.py
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels import flash_attention as fa
from test_torch_kernel import attention_f64

TILE = 64           # key rows a tile, as the kernel's
NEG_INF = -1e30
TOL = 2e-5          # chip_smoke.py's float32 attention gate (abs and rel)
LOG2E = np.float32(1.4426950408889634)
# k-steps of S the kernel sums from zero before adding them to S
S_STEPS = int(re.search(
    r"constexpr int kSSteps = (\d+);",
    (Path(fa.__file__).parent / "csrc" / "flash_attention.cu").read_text(),
).group(1))
KERNEL_MMA = (S_STEPS, False)     # mma_sum's model of the kernel
CHAINED_MMA = (None, True)        # S and O each one chain of mma


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` with its low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def terms(a, b, n):
    """The (a, b) pairs of TF32 products the kernel sums for a b, each
    contracted over its last dim: 3 the split (small terms first), 4 the
    split with small x small too, 1 one product of unsplit operands, 0
    ``a`` and ``b`` as they are (exact in TF32 already: bf16 operands)."""
    if n == 0:
        return [(a, b)]
    ab, as_ = split(a)
    bb, bs = split(b)
    return {1: [(ab, bb)], 3: [(as_, bb), (ab, bs), (ab, bb)],
            4: [(as_, bs), (as_, bb), (ab, bs), (ab, bb)]}[n]


def rn_sum(pairs, eq):
    """The products of ``pairs``, each a float32 einsum, added in turn."""
    out = torch.einsum(eq, *pairs[0])
    for a, b in pairs[1:]:
        out = out + torch.einsum(eq, a, b)
    return out


def toward_zero(x):
    """float64 ``x`` rounded to float32 toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def mma_sum(acc, pairs, eq, steps):
    """``acc`` plus the products of ``pairs`` as a chain of ``mma.sync``
    m16n8k8 computes them, as modelled here: k-steps of 8, every pair in
    turn within a step, each adding its eight products to the accumulator
    exactly and truncating the sum to float32.  ``steps`` k-steps at a
    time run from zero and are then added to ``acc`` in float32 (round to
    nearest); ``steps=None`` chains every step into ``acc`` itself."""
    n = pairs[0][0].shape[-1]
    group = n if steps is None else 8 * steps
    for g0 in range(0, n, group):
        part = acc if steps is None else torch.zeros_like(acc)
        for k in range(g0, min(g0 + group, n), 8):
            for a, b in pairs:
                part = toward_zero(part.double() + torch.einsum(
                    eq, a[..., k:k + 8].double(), b[..., k:k + 8].double()))
        acc = part if steps is None else acc + part
    return acc


def tf32_emulation(q, k, v, *, causal, single=False, n_terms=3,
                   natural_exp=False, mma=None):
    """The kernel's arithmetic on ``(BH, S, hd)`` q, k, v of one dtype;
    float32 before the output's cast.  ``single``: one TF32 product of
    unsplit operands for S and PV instead of the split; ``n_terms`` 4: the
    split with small x small added back; ``natural_exp``: scores in
    natural units through exp instead of log2 units through exp2.
    ``mma``: ``None`` sums the products in float32 (round to nearest);
    ``(s_steps, pv_chained)`` models ``mma.sync``'s truncating sums
    (:func:`mma_sum`): S from zero ``s_steps`` k-steps at a time, and the
    tile's P V from zero (the kernel) or, ``pv_chained``, chained into O
    across tiles."""
    bh, sq, hd = q.shape
    skv = k.shape[1]
    exact = q.dtype == torch.bfloat16
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = np.float32(hd ** -0.5)
    scale2 = float(scale if natural_exp else scale * LOG2E)
    exp = torch.exp if natural_exp else torch.exp2
    m = torch.full((bh, sq), NEG_INF)
    l = torch.zeros((bh, sq))
    acc = torch.zeros((bh, sq, v.shape[2]))
    qpos = torch.arange(sq)[:, None]
    kv_end = min(skv, sq) if causal else skv
    for kv0 in range(0, kv_end, TILE):
        kt = kf[:, kv0:kv0 + TILE]
        vt = vf[:, kv0:kv0 + TILE].transpose(1, 2)      # (BH, hdv, keys)
        s_pairs = terms(qf, kt, 1 if single else (0 if exact else n_terms))
        if mma is None:
            s = rn_sum(s_pairs, "bqd,bkd->bqk")
        else:
            s = mma_sum(torch.zeros((bh, sq, kt.shape[1])), s_pairs,
                        "bqd,bkd->bqk", mma[0])
        s = s * scale2
        if causal:
            kpos = torch.arange(kv0, kv0 + kt.shape[1])[None, :]
            s = s.masked_fill((kpos > qpos)[None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = exp(m - m_new)
        p = exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        if single:
            pv_pairs = terms(p, vt, 1)
        elif exact:      # p split, v exact: Ps V + Pb V
            pb, ps = split(p)
            pv_pairs = [(ps, vt), (pb, vt)]
        else:
            pv_pairs = terms(p, vt, n_terms)
        acc = acc * corr[..., None]
        if mma is None:
            acc = acc + rn_sum(pv_pairs, "bqk,bdk->bqd")
        else:
            acc = mma_sum(acc, pv_pairs, "bqk,bdk->bqd",
                          None if mma[1] else TILE // 8)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def _qkv(bh, sq, skv, hd, hdv, dtype, seed, mult=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                             * np.float32(mult)).to(dtype)
            for shape in ((bh, sq, hd), (bh, skv, hd), (bh, skv, hdv))]


def _assert_close(got, want):
    err = float((got - want).abs().max())
    assert torch.allclose(got, want, atol=TOL, rtol=TOL), err


SHAPES = [                     # bh, sq, skv, hd, hdv
    (2, 128, 128, 8, 8),
    (2, 128, 128, 16, 16),
    (2, 128, 128, 32, 32),
    (2, 192, 192, 64, 64),     # three tiles, the diagonal inside each
    (1, 256, 256, 128, 128),
    (2, 100, 100, 64, 32),     # ragged tiles, hdv != hd
    (1, 128, 256, 32, 64),     # Sq != Skv
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("bh,sq,skv,hd,hdv", SHAPES)
def test_emulation_matches_plain(bh, sq, skv, hd, hdv, causal, dtype):
    q, k, v = _qkv(bh, sq, skv, hd, hdv, dtype, seed=sq + hd + hdv)
    got = tf32_emulation(q, k, v, causal=causal)
    # the plain version on the same values in float32, before any cast
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal)
    _assert_close(got, want)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_emulation_of_scaled_inputs_is_as_accurate_as_float32(causal):
    """Inputs x8: scores x64 and a peaked softmax, the split under stress.
    There float32 itself misses 2e-5 (the plain version is ~5e-4 from the
    float64 function: a score's rounding moves its weight), so both are
    held to float64, the split within 2x of the plain version's error and
    a single TF32 product hundreds of times beyond it."""
    q, k, v = _qkv(2, 128, 128, 128, 128, torch.float32, seed=8, mult=8.0)
    want = attention_f64(q, k, v, causal=causal)
    plain_err = float((fa.flash_attention_plain(q, k, v, causal=causal)
                       - want).abs().max())
    split_err = float((tf32_emulation(q, k, v, causal=causal)
                       - want).abs().max())
    single_err = float((tf32_emulation(q, k, v, causal=causal, single=True)
                        - want).abs().max())
    assert split_err <= 2 * plain_err, (split_err, plain_err)
    assert single_err > 100 * plain_err, (single_err, plain_err)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("bh,sq,skv,hd,hdv", [
    (2, 128, 128, 64, 64), (1, 256, 256, 128, 128), (2, 100, 100, 64, 32)])
def test_emulation_matches_jax_kernel(bh, sq, skv, hd, hdv, causal):
    q, k, v = _qkv(bh, sq, skv, hd, hdv, torch.float32, seed=7 + sq + hd)
    want = flash_attention_kernel(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                  causal=causal, interpret=True)
    _assert_close(tf32_emulation(q, k, v, causal=causal),
                  torch.from_numpy(np.array(want)))


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10          # a TF32 value: unchanged
    half = 2.0 ** -11               # half a TF32 ulp at 1
    x = torch.tensor([one, 1.0 + half, -(1.0 + half), 1.0 + half / 2,
                      1.0 + 3 * half], dtype=torch.float32)
    want = torch.tensor([one, one, -one, 1.0, 1.0 + 2 ** -9],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    big, small = split(torch.tensor([np.pi], dtype=torch.float32))
    assert abs(float(big) + float(small) - np.float32(np.pi)) \
        <= 2.0 ** -22 * np.pi


@pytest.mark.parametrize("hd", [64, 128])
def test_single_tf32_product_misses_the_gate(hd):
    """Unsplit TF32 operands round each by up to 2^-11: the scores and the
    weighted sum then miss 2e-5, which the split meets."""
    q, k, v = _qkv(2, 256, 256, hd, hd, torch.float32, seed=hd)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    split_err = float((tf32_emulation(q, k, v, causal=True)
                       - want).abs().max())
    single = tf32_emulation(q, k, v, causal=True, single=True)
    single_err = float((single - want).abs().max())
    assert split_err <= TOL
    assert not torch.allclose(single, want, atol=TOL, rtol=TOL)
    assert single_err > 10 * split_err, (split_err, single_err)


def _f64_errors(bh, s, seed, mult, variants):
    """max |x - float64 attention| of the plain version and of each
    emulation variant (``{name: tf32_emulation kwargs}``), causal, hd 128."""
    q, k, v = _qkv(bh, s, s, 128, 128, torch.float32, seed=seed, mult=mult)
    want = attention_f64(q, k, v, True)
    errs = {"plain": float((fa.flash_attention_plain(q, k, v, causal=True)
                            .double() - want).abs().max())}
    for name, kw in variants.items():
        got = tf32_emulation(q, k, v, causal=True, **kw)
        errs[name] = float((got.double() - want).abs().max())
    return errs


VARIANTS = {
    "float32 sums": {},
    "float32 sums, expf": dict(natural_exp=True),
    "float32 sums, small x small added": dict(n_terms=4),
    "mma chained (S and O)": dict(mma=CHAINED_MMA),
    "mma, O a tile from zero": dict(mma=(None, False)),
    "mma as the kernel": dict(mma=KERNEL_MMA),
}


def test_exp2_and_the_dropped_term_cost_no_accuracy():
    """Neither exp2 of log2-e-prescaled scores nor dropping small x small
    moves the emulation away from float64 beyond the plain version."""
    errs = _f64_errors(1, 512, 0, 1.0, {
        n: VARIANTS[n] for n in ("float32 sums", "float32 sums, expf",
                                 "float32 sums, small x small added")})
    assert max(errs.values()) <= 2 * errs["plain"], errs


def test_truncating_mma_chains_cost_accuracy():
    """With mma.sync's sums truncated, chaining all of S and O into one
    accumulator each lands several times further from float64 than the
    plain version; the kernel's short runs from zero do not."""
    errs = _f64_errors(1, 512, 0, 1.0, {
        n: VARIANTS[n] for n in ("mma chained (S and O)",
                                 "mma as the kernel")})
    assert errs["mma chained (S and O)"] >= 3 * errs["plain"], errs
    assert errs["mma as the kernel"] <= 2 * errs["plain"], errs
    assert 3 * errs["mma as the kernel"] <= errs["mma chained (S and O)"], \
        errs


if __name__ == "__main__":
    torch.set_num_threads(4)
    print(f"kernel: kSSteps = {S_STEPS}; max |x - float64 attention|, "
          "(2, 1024, 128) causal, seed 0")
    for mult in (1.0, 8.0):
        for name, err in _f64_errors(2, 1024, 0, mult, VARIANTS).items():
            print(f"  inputs x{mult:g}  {name:36s} {err:.4e}")
