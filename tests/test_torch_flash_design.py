"""The rounding of the bf16 tensor-core attention kernel, checked on the CPU.

``flash_wgmma_kernel`` (src/repro_torch/kernels/csrc/flash_attention.cu)
runs only on the card.  What it computes differently from the TPU kernel
is its rounding, and that a plain emulation can show here:

* S = q k^T from bf16 q and k: the products are exact, the sum float32,
  and the scale is applied to the float32 S;
* 128-key tiles with the online softmax updated once a tile, in float32,
  on scores pre-scaled by log2(e) through exp2;
* P V as two bf16 products, p_hi = bf16(p) and p_lo = bf16(p - p_hi),
  against v (exact in bf16), summed in float32;
* the output acc / max(l, 1e-30) rounded to bf16.

The emulation is held against the port's plain version
(``flash_attention_plain``) and against the JAX package's Pallas kernel in
interpret mode (as tests/test_kernels.py runs it), at small shapes, to the
gate the card's kernel meets in chip_smoke.py: each output within one bf16
ulp of the larger of the two, plus 1e-5.  Both round a float32 result to
bf16, and those results differ only by summation order and the ~16 bits
that p keeps.  A single bf16 p (one product) misses that gate, which is
why the kernel splits p.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels import flash_attention as fa

TILE = 128          # key rows a tile, as the kernel's
NEG_INF = -1e30
ATOL = 1e-5         # beside one bf16 ulp: outputs near 0


def wgmma_emulation(q, k, v, *, causal, p_terms=2):
    """The kernel's arithmetic on bf16 ``(BH, S, hd)`` q, k, v."""
    _, sq, hd = q.shape
    skv = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()     # exact
    scale2 = np.float32(hd ** -0.5) * np.float32(np.log2(np.e))
    m = torch.full(q.shape[:2], NEG_INF)
    l = torch.zeros(q.shape[:2])
    acc = torch.zeros(q.shape[:2] + (v.shape[2],))
    qpos = torch.arange(sq)[:, None]
    for kv0 in range(0, skv, TILE):
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, kv0:kv0 + TILE]) \
            * float(scale2)
        if causal:
            kpos = torch.arange(kv0, min(kv0 + TILE, skv))[None, :]
            s = s.masked_fill((kpos > qpos)[None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        p_hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bqk,bkd->bqd", p_hi, vf[:, kv0:kv0 + TILE])
        if p_terms == 2:
            p_lo = (p - p_hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bqk,bkd->bqd", p_lo,
                                   vf[:, kv0:kv0 + TILE])
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


def _qkv(bh, s, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, s, hd),
                                                 dtype=np.float32))
            .to(torch.bfloat16) for _ in range(3)]


def _beyond_ulp(got, want):
    """(outputs beyond one bf16 ulp + ATOL, max abs difference)."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    bound = torch.ldexp(torch.ones_like(g), e - 8) + ATOL
    diff = (g - w).abs()
    return int((diff > bound).sum()), float(diff.max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd", [
    (2, 128, 64), (2, 128, 128), (3, 256, 64), (4, 256, 128)])
def test_emulation_within_one_ulp_of_plain(bh, s, hd, causal):
    q, k, v = _qkv(bh, s, hd, seed=bh * s + hd)
    got = wgmma_emulation(q, k, v, causal=causal)
    over, err = _beyond_ulp(got, fa.flash_attention_plain(q, k, v,
                                                          causal=causal))
    assert over == 0, f"{over} outputs beyond one bf16 ulp (max {err})"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd", [(2, 128, 64), (2, 256, 128)])
def test_emulation_within_one_ulp_of_jax_kernel(bh, s, hd, causal):
    q, k, v = _qkv(bh, s, hd, seed=7 + s + hd)
    qj, kj, vj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    want = flash_attention_kernel(qj, kj, vj, causal=causal, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    over, err = _beyond_ulp(wgmma_emulation(q, k, v, causal=causal), want)
    assert over == 0, f"{over} outputs beyond one bf16 ulp (max {err})"


@pytest.mark.parametrize("hd", [64, 128])
def test_single_bf16_p_misses_the_gate(hd):
    """p_hi alone rounds every weight by up to 2^-9: beside the split's
    error, the single product's is larger and breaks the one-ulp gate."""
    q, k, v = _qkv(2, 256, hd, seed=hd)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    split_over, split_err = _beyond_ulp(
        wgmma_emulation(q, k, v, causal=True), want)
    single_over, single_err = _beyond_ulp(
        wgmma_emulation(q, k, v, causal=True, p_terms=1), want)
    assert split_over == 0
    assert single_over > 0 and single_err > split_err, (
        split_err, single_err, single_over)
