"""Counter-based random numbers, bit-equal to ``jax.random``'s defaults
(threefry2x32 with ``jax_threefry_partitionable=True``), in plain PyTorch
on the key's device.

A key is a ``(2,)`` ``torch.uint32`` tensor, the raw key data of
``jax.random.PRNGKey``.  The functions are those the reference draws
with: :func:`PRNGKey`, :func:`split`, :func:`fold_in`,
:func:`random_bits`, :func:`uniform` and :func:`normal`.

* threefry2x32 is 20 rounds in five groups of four, with the key schedule
  injected after each group (Salmon et al., SC'11; JAX's
  ``_threefry2x32_lowering``).
* ``split(key, n)`` and ``random_bits(key, shape)`` hash the 64-bit
  row-major index of every element, split into its (hi, lo) words; a
  split key is the hash's two words, the 32 random bits are their xor.
* ``fold_in(key, d)`` hashes the count pair ``(0, d)``.
* ``uniform`` puts the top 23 bits under the exponent of 1.0
  (``(bits >> 9) | 0x3F800000``), subtracts 1, scales and clips below at
  ``minval``; ``normal`` is ``sqrt(2) * erfinv(u)`` for ``u`` uniform on
  ``[nextafter(-1, 0), 1)``, with XLA's float32 ``ErfInv`` (Giles'
  polynomial in ``-log1p(-x^2)``) and XLA's CPU ``log1p`` and ``log``
  (Cephes) written out, their multiply-adds fused as XLA fuses them.  So
  normals agree with JAX on the CPU to an ulp, and are bit-equal on all
  but a few in 10^4.
* a bfloat16 ``normal`` draws 8-bit words (jax's ``rng_bits = 8`` for a
  type with fewer than 8 mantissa bits: the low byte of the 32 random
  bits), so it takes one of 128 values, those of :func:`_bf16_normals`;
* ``randint`` (int32) draws two words a value from the two halves of
  ``split(key)`` and folds them into ``[minval, maxval)`` with jax's
  uint32 modular arithmetic, wraps included.

``torch.uint32`` has no ``+``, ``<<`` or ``>>`` on the CPU, so the words
are held as ``int32`` with two's-complement wrap: additions wrap as
uint32 ones do, and each arithmetic right shift is masked to a logical
one.  The key tensors stay ``uint32`` (their bits are viewed).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# XLA's float32 ErfInv (Giles 2010): coefficients for w < 5 and w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's CPU log and log1p (Cephes): log's polynomial and ln 2 in two parts,
# log1p's rational approximation near 0.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)

Shape = Union[int, Sequence[int]]


def _i32(v: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _words(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if key.shape != (2,) or key.dtype != torch.uint32:
        raise TypeError(f"a key is a (2,) uint32 tensor; got "
                        f"{tuple(key.shape)} {key.dtype}")
    w = key.view(torch.int32)
    return w[0], w[1]


def _key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.stack([hi, lo], dim=-1).view(torch.uint32)


def _rotl_(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate the int32 words of ``x`` left by ``r`` bits, in place."""
    t = torch.bitwise_right_shift(x, 32 - r)
    t.bitwise_and_((1 << r) - 1)
    x.bitwise_left_shift_(r)
    return x.bitwise_or_(t)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the count pairs ``(x0, x1)`` under key
    words ``(k0, k1)``; all int32 (uint32 bits), broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _i32(_PARITY))
    shape = torch.broadcast_shapes(k0.shape, x0.shape, x1.shape)
    x0 = (x0 + ks[0]).expand(shape).contiguous()
    x1 = (x1 + ks[1]).expand(shape).contiguous()
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0.add_(x1)
            _rotl_(x1, r)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(group + 1) % 3])
        x1.add_(ks[(group + 2) % 3]).add_(group + 1)
    return x0, x1


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def _iota_2x32(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) words of the 64-bit counts 0 .. n - 1, as int32."""
    if n <= 1 << 31:
        lo = torch.arange(n, dtype=torch.int32, device=device)
        return torch.zeros((), dtype=torch.int32, device=device), lo
    c = torch.arange(n, dtype=torch.int64, device=device)
    lo = (c & 0xFFFFFFFF).to(torch.int32)    # wraps to the same bits
    return (c >> 32).to(torch.int32), lo


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit seeds, as JAX without x64:
    the high word is 0, the low word the seed's low 32 bits)."""
    return torch.tensor([0, int(seed) & 0xFFFFFFFF], dtype=torch.int64,
                        device=device).to(torch.uint32)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``num`` (an int or a shape) new
    keys, shaped ``(*num, 2)``."""
    shape = _shape(num)
    k0, k1 = _words(key)
    hi, lo = _iota_2x32(math.prod(shape), key.device)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return _key(b0, b1).reshape(shape + (2,))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data`` (a Python
    int in ``[0, 2**32)`` or an integer tensor, taken as its low 32 bits).

    ``key`` may also be a batch of keys, shaped ``(..., 2)``; a tensor
    ``data`` then broadcasts against the batch and each key is folded with
    its own datum, in one hash (``vmap(fold_in)``)."""
    if key.dim() < 1 or key.shape[-1] != 2 or key.dtype != torch.uint32:
        raise TypeError(f"keys are (..., 2) uint32 tensors; got "
                        f"{tuple(key.shape)} {key.dtype}")
    w = key.view(torch.int32)
    k0, k1 = w[..., 0], w[..., 1]
    if isinstance(data, torch.Tensor):
        if data.is_floating_point():
            raise TypeError("fold_in data must be an integer tensor")
        d = (data.to(device=key.device, dtype=torch.int64)
             & 0xFFFFFFFF).to(torch.int32)      # wraps to the same bits
    else:
        if not 0 <= int(data) < 1 << 32:
            raise OverflowError(f"fold_in data {data} out of uint32 range")
        # A fill, not a copy from the host: no wait on the device.
        d = torch.full((), _i32(int(data)), dtype=torch.int32,
                       device=key.device)
    zero = torch.zeros((), dtype=torch.int32, device=key.device)
    b0, b1 = threefry2x32(k0, k1, zero, d)
    return _key(b0, b1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32 bits) as int32 words."""
    shape = _shape(shape)
    k0, k1 = _words(key)
    hi, lo = _iota_2x32(math.prod(shape), key.device)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return b0.bitwise_xor_(b1).reshape(shape)


def _unit(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Floats in [0, 1): the top 23 random bits under 1.0's exponent,
    minus 1."""
    b = random_bits(key, shape)
    b = torch.bitwise_right_shift(b, 9).bitwise_and_(0x7FFFFF)
    return b.bitwise_or_(0x3F800000).view(torch.float32).sub_(1.0)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.

    XLA fuses ``u * (maxval - minval) + minval`` into one fused
    multiply-add; here the product (exact in float64) and the sum are
    taken in float64 and rounded once more to float32, which equals the
    fused result unless the float64 sum lands on a float32 tie (the tests
    have met none).  On ``[0, 1)`` the scaling is exact either way."""
    shape = _shape(shape)
    dev = key.device
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    u = _unit(key, shape)
    if lo == 0.0 and span == 1.0:
        return u
    v = (u.double() * float(span) + float(lo)).float()
    return torch.maximum(torch.tensor(lo, device=dev), v)


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (XLA's CPU code fuses these):
    the product of two float32 values is exact in float64, so only the
    sum rounds twice, float64 then float32."""
    return (a.double() * b.double() + c.double()).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` on the CPU (Cephes' ``logf``, as Eigen's
    ``plog``): the mantissa in ``[sqrt(1/2), sqrt(2))``, a degree-9
    polynomial, the exponent's ``ln 2`` in two parts.  Defined for the
    positive normal inputs the RNG gives it."""
    dev = x.device
    x = torch.maximum(x, _f32(1.17549435e-38, dev))
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0x1FF).sub_(0x7F).float().add_(1.0)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _f32(0.707106781186547524, dev)
    e = e - small.float()
    x = (m - 1.0) + torch.where(small, m, _f32(0.0, dev))
    x2 = x * x
    x3 = x2 * x
    c = [_f32(v, dev) for v in _LOG_P]
    y = _fma(_fma(c[0], x, c[1]), x, c[2])
    y1 = _fma(_fma(c[3], x, c[4]), x, c[5])
    y2 = _fma(_fma(c[6], x, c[7]), x, c[8])
    y = _fma(_fma(y, x3, y1), x3, y2) * x3
    y = _fma(e, _f32(_LOG_Q1, dev), y)
    x = _fma(-x2, _f32(0.5, dev), x) + y
    return _fma(e, _f32(_LOG_Q2, dev), x)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: Cephes' rational approximation where
    ``|x| < sqrt(2) - 1``, ``log(1 + x)`` elsewhere."""
    dev = x.device

    def poly(cs):
        r = torch.zeros_like(x)
        for v in cs:
            r = _fma(r, x, _f32(v, dev))
        return r

    x2 = x * x
    small = x + (_f32(-0.5, dev) * x2
                 + (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)))
    return torch.where(x.abs() < _f32(0.41421356237309504880, dev), small,
                       _log(x + 1.0))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv``: Giles' single-precision polynomial in
    ``w = -log1p(-x^2)``, ``+-inf`` at ``+-1``."""
    dev = x.device
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, _f32(_ERFINV_LT5[i], dev),
                           _f32(_ERFINV_GE5[i], dev))

    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coeff(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Shape = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``, float32 or bfloat16."""
    if dtype == torch.bfloat16:
        low = random_bits(key, _shape(shape)).bitwise_and_(0xFF)
        return _bf16_normals(key.device)[low.bitwise_right_shift_(1).long()]
    if dtype != torch.float32:
        raise TypeError(f"normal: float32 or bfloat16, not {dtype}")
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, minval=float(lo), maxval=1.0)
    return torch.tensor(np.float32(np.sqrt(2)), device=key.device) \
        * erfinv(u)


def _bf16_normals(device) -> torch.Tensor:
    """The 128 values of a bfloat16 normal, indexed by the 7 random bits
    jax keeps (the byte shifted right by one).  jax's bfloat16 uniform is
    ``k / 128`` (exact), times ``hi - lo`` rounded to bfloat16 (2.0: lo is
    ``nextafter(-1, 0) = -255/256``), plus lo: ``(4k - 255) / 256``, exact
    in bfloat16; XLA's CPU code takes its ``ErfInv`` in float32, rounds it
    to bfloat16, and multiplies by ``sqrt(2)`` rounded to bfloat16, one
    more rounding.  (Checked against jax 0.9.0 on all 128 values.)"""
    k = torch.arange(128, dtype=torch.float32, device=device)
    u = (4.0 * k - 255.0) / 256.0
    e = erfinv(u).to(torch.bfloat16)
    return e * torch.tensor(np.sqrt(2), dtype=torch.bfloat16, device=device)


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, bounds
    in int32's range, as jax takes them without x64)."""
    lo32, hi32 = -(1 << 31), (1 << 31) - 1
    if not (lo32 <= minval <= hi32 and lo32 <= maxval <= hi32):
        raise OverflowError(f"randint: [{minval}, {maxval}) is outside "
                            "int32")
    shape = _shape(shape)
    k1, k2 = split(key)
    mask = 0xFFFFFFFF
    higher = random_bits(k1, shape).long() & mask
    lower = random_bits(k2, shape).long() & mask
    span = maxval - minval if maxval > minval else 1
    # uint32 products and sums wrap, as jax's do (its multiplier wraps to
    # 0 past a span of 2**16)
    mult = (((1 << 16) % span) ** 2 & mask) % span
    offset = ((((higher % span) * mult) & mask) + lower % span) & mask
    return (minval + offset % span).to(torch.int32)
