"""The aura-exchange delta codec and the migration position codec: four
hand-written Hopper kernels (``csrc/delta_codec.cu``), each beside its plain
PyTorch version.

Ports of the TPU kernels of ``src/repro/kernels/delta_codec.py``:

=========================  ==========================================  ======
wrapper                    replaces                                    bound
=========================  ==========================================  ======
:func:`delta_encode`       ``delta_encode_kernel`` (:44) + the max      bytes
                           reduction of ``ops.delta_encode``
:func:`delta_decode`       ``delta_decode_kernel`` (:78)                bytes
:func:`migration_pos_encode`  ``migration_pos_encode_kernel`` (:126)    bytes
:func:`migration_pos_decode`  ``migration_pos_decode_kernel`` (:165)    bytes
=========================  ==========================================  ======

Every array is a stack of ``B`` rows, one per device of the virtual mesh:
the delta codec takes ``(B, N)`` float32 slabs with one scale a row, the
position codec ``(B, R, D)`` positions with one centre a row and one scale
an axis.  The source note of ``csrc/delta_codec.cu`` gives each kernel's
bound and design.

Two JAX definitions of the same codec disagree, and the kernels take the
difference as arguments:

* the clip range: ``core/delta.py`` clips to ``[iinfo.min, iinfo.max]``
  and counts values outside it (the engine's path, ``symmetric=False``);
  the TPU kernels clip to ``+-iinfo.max`` (``symmetric=True``);
* dead rows of a migration payload: ``core/delta.encode_migration``
  quantizes their stale coordinates and leaves them out of the overflow
  count (``dead="mask"``); the TPU wrapper zeroes them first
  (``dead="zero"``).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.  Each launch adds one to
``LAUNCHES[name]`` and nothing else touches the counts.  Each encoder is
one cooperative launch and nothing else on the card: no memset, and no
atomic but those of the grid-wide sync.  Its grid is planned here
(:func:`plan`) from the blocks the card holds at once, asked of the
occupancy API once per kernel and device, and its cross-block scratch
(one int32 slot a block and row for the overflow count, one more for an
adaptive encode's max) comes from ``torch.empty``: the kernel writes
every slot before it reads one.  A fixed scale takes the same kernel
with one grid sync, for its count (ROADMAP B3 gives its cost).  Each
decoder is one plain launch on a grid :func:`plan` sizes to the card the
same way, with a grid-stride loop; the position decode also does the
engine's seam repair (``at_l``) in that launch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

QDTYPES = {torch.int8: 8, torch.int16: 16}

# The kernels' launch shape, as csrc/delta_codec.cu has it: threads a
# block (kThreads), elements of x - ref a delta-encode thread keeps in
# registers (kTileElems), chunks of four rows a position-encode thread
# loads at once (kChunks), units of four elements a decoder thread loads at
# once (kUnits).
THREADS = 256
TILE_ELEMS = 16
MIG_CHUNKS = 2
DECODE_UNITS = 2

LAUNCHES: Dict[str, int] = {
    "delta_encode": 0, "delta_decode": 0,
    "migration_pos_encode": 0, "migration_pos_decode": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def clip_range(qdtype: torch.dtype, symmetric: bool) -> Tuple[float, float]:
    """``(lo, hi)`` of the quantized range as floats."""
    if qdtype not in QDTYPES:
        raise TypeError(f"quantized dtype {qdtype} is not int8 or int16")
    info = torch.iinfo(qdtype)
    return (-float(info.max) if symmetric else float(info.min),
            float(info.max))


def _f32(v) -> torch.Tensor:
    return torch.tensor(np.float32(v))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def delta_encode_plain(x: torch.Tensor, ref: torch.Tensor, *,
                       qdtype: torch.dtype = torch.int8,
                       scale: Optional[float] = None,
                       symmetric: bool = False, with_ref: bool = True):
    """``(q, scale (B,), overflow (B,) int32, new_ref or None)`` of
    ``(B, N)`` float32 ``x`` against ``ref``.  ``scale=None`` derives each
    row's scale from its max ``|x - ref|``."""
    lo, hi = clip_range(qdtype, symmetric)
    dev = x.device
    d = x - ref
    if scale is None:
        amax = d.abs().amax(dim=1) if d.shape[1] else \
            torch.zeros(d.shape[0], device=dev)
        s = torch.maximum(amax, _f32(1e-30).to(dev)) / _f32(hi).to(dev)
    else:
        s = _f32(scale).to(dev).expand(x.shape[0]).clone()
    qf = torch.round(d / s[:, None])
    oflow = ((qf > hi) | (qf < lo)).sum(dim=1, dtype=torch.int32)
    qc = qf.clamp(lo, hi)
    new_ref = ref + qc * s[:, None] if with_ref else None
    return qc.to(qdtype), s, oflow, new_ref


def delta_decode_plain(q: torch.Tensor, ref: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """``ref + q * scale[b]`` over ``(B, N)`` rows."""
    return ref + q.to(torch.float32) * scale[:, None]


def _frame(d: int, scale, lsz, toroidal):
    scale = np.asarray(scale, np.float32).reshape(-1)
    tor = tuple(bool(t) for t in toroidal) if toroidal else (False,) * d
    if scale.shape != (d,) or len(tor) != d:
        raise ValueError(f"scale {scale.shape} / toroidal {tor} do not "
                         f"match {d} axes")
    lens = (np.asarray(lsz, np.float32).reshape(-1) if any(tor)
            else np.zeros(d, np.float32))
    return scale, lens, tor


def migration_pos_encode_plain(pos: torch.Tensor, center: torch.Tensor,
                               scale: Sequence[float], *,
                               valid: Optional[torch.Tensor] = None,
                               lsz=None, toroidal=(),
                               dead: str = "mask",
                               symmetric: bool = False):
    """``(q (B, R, D) int16, overflow (B,) int32)`` of ``(B, R, D)``
    positions as offsets from each row's ``center (B, D)``."""
    b, r, d = pos.shape
    scale, lens, tor = _frame(d, scale, lsz, toroidal)
    lo, hi = clip_range(torch.int16, symmetric)
    dev = pos.device
    off = pos - center[:, None, :]
    if any(tor):
        L = torch.from_numpy(lens).to(dev)
        wrapped = off - L * torch.round(off / L)
        off = torch.where(torch.tensor(tor, device=dev), wrapped, off)
    live = None if valid is None else valid[..., None]
    if dead == "zero" and live is not None:
        off = torch.where(live, off, torch.zeros((), device=dev))
    elif dead != "mask":
        raise ValueError(f"dead={dead!r}; expected 'mask' or 'zero'")
    qf = torch.round(off / torch.from_numpy(scale).to(dev))
    oob = (qf > hi) | (qf < lo)
    if live is not None:
        oob = oob & live
    return (qf.clamp(lo, hi).to(torch.int16),
            oob.reshape(b, -1).sum(dim=1, dtype=torch.int32))


def _at_l(d: int, at_l) -> Optional[np.ndarray]:
    if at_l is None:
        return None
    at_l = np.asarray(at_l, np.float32).reshape(-1)
    if at_l.shape != (d,):
        raise ValueError(f"at_l {at_l.shape} does not match {d} axes")
    return at_l


def migration_pos_decode_plain(q: torch.Tensor, center: torch.Tensor,
                               scale: Sequence[float], *, lsz=None,
                               toroidal=(), at_l=None) -> torch.Tensor:
    """``center[b] + q * scale``, then ``jnp.mod(., L)`` on toroidal
    axes; with ``at_l`` (D floats), a wrapped coordinate equal to L is
    ``at_l[a]`` (the engine's seam repair)."""
    d = q.shape[-1]
    scale, lens, tor = _frame(d, scale, lsz, toroidal)
    at_l = _at_l(d, at_l)
    dev = q.device
    p = center[:, None, :] + q.to(torch.float32) * torch.from_numpy(
        scale).to(dev)
    if any(tor):
        L = torch.from_numpy(lens).to(dev)
        wrap = torch.tensor(tor, device=dev)
        r = torch.fmod(p, L)
        r = torch.where((r != 0) & ((r < 0) != (L < 0)), r + L, r)
        p = torch.where(wrap, r, p)
        if at_l is not None:
            p = torch.where(wrap & (p == L), torch.from_numpy(at_l).to(dev),
                            p)
    return p


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "delta_encode_coresident": [_I, _I, _I, _I, _IP, _IP],
    "migration_pos_encode_coresident": [_I, _I, _I, _IP, _IP],
    "delta_encode_launch": [_I, _I, _P, _P, _L, _L, _I, _I, _F, _F, _F,
                            _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "delta_decode_occupancy": [_I, _I, _I, _IP, _IP],
    "migration_pos_decode_occupancy": [_I, _I, _I, _IP, _IP],
    "delta_decode_launch": [_I, _I, _P, _P, _P, _L, _L, _I, _I, _I, _I,
                            _P, _P],
    "migration_pos_encode_launch": [_I, _P, _P, _P, _L, _L, _I] + [_F] * 6
    + [_I] * 4 + [_F, _F] + [_I] * 4 + [_P, _P, _P, _P],
    "migration_pos_decode_launch": [_I, _P, _P, _L, _L, _I] + [_F] * 6
    + [_I] * 4 + [_F] * 3 + [_I] * 4 + [_P, _P],
}


def _library() -> ctypes.CDLL:
    lib = _build.load("delta_codec")
    if lib.delta_codec_error_string.restype is not ctypes.c_char_p:
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.delta_codec_error_string.argtypes = [ctypes.c_int]
        lib.delta_codec_error_string.restype = ctypes.c_char_p
    return lib


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def _check(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} has dtype {t.dtype}, the kernel "
                        f"takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")


def _aligned(*tensors: torch.Tensor) -> bool:
    """Every tensor starts at a multiple of four of its elements."""
    return all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)


def _vec(n: int, *tensors: torch.Tensor) -> int:
    """1 when rows of ``n`` elements allow 16-byte vectors of four: every
    row start then sits at a multiple of four elements."""
    return int(n % 4 == 0 and _aligned(*tensors))


class Occupancy(NamedTuple):
    """SMs of the card and the blocks of one codec kernel an SM holds."""
    sms: int
    per_sm: int


class Plan(NamedTuple):
    """A codec launch: ``grid_x`` blocks a row, ``grid_y`` rows a round,
    ``rounds`` rounds.  A row's blocks take ``grid_x * THREADS *
    per_thread`` of its elements at once: for the delta encode the
    register tile (elements past it are read a second time), for a
    decoder one turn of its grid-stride loop."""
    grid_x: int
    grid_y: int
    rounds: int


def plan(rows: int, elems: int, per_thread: int, occ: Occupancy) -> Plan:
    """Grid of a codec kernel over ``rows`` rows of ``elems`` elements, a
    thread taking ``per_thread`` of a row at once.  The grid never exceeds
    the blocks the card holds at once (a grid-wide sync needs every block
    resident; a decoder has none, and more blocks would only wait for a
    second wave); within that, a row gets the blocks that cover it in one
    pass, but at least its share of one block an SM while each thread
    still has a vector of four to do."""
    total = occ.sms * occ.per_sm
    if total < 1:
        raise RuntimeError(f"the card holds {total} blocks of the codec "
                           "kernel at once")
    grid_y = min(rows, total)
    rounds = -(-rows // grid_y)
    per_row = max(1, total // grid_y)
    need = -(-elems // (THREADS * per_thread))
    spread = min(-(-occ.sms // grid_y), -(-elems // (THREADS * 4)))
    grid_x = max(1, min(per_row, max(need, spread)))
    return Plan(grid_x, grid_y, rounds)


_OCCUPANCY: Dict[tuple, Occupancy] = {}


def _occupancy(lib, fn: str, key: tuple, dev: torch.device) -> Occupancy:
    """The occupancy of codec kernel ``fn(*key)`` on ``dev``, asked of
    the card on first use."""
    k = (fn, key, dev.index)
    if k not in _OCCUPANCY:
        sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        err = getattr(lib, fn)(*key, dev.index, ctypes.byref(sms),
                               ctypes.byref(per_sm))
        _raise(lib, fn, err)
        _OCCUPANCY[k] = Occupancy(sms.value, per_sm.value)
    return _OCCUPANCY[k]


def _raise(lib, fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{fn} kernel launch failed: cudaError {err} "
            f"({lib.delta_codec_error_string(err).decode()})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def delta_encode(x: torch.Tensor, ref: torch.Tensor, *,
                 qdtype: torch.dtype = torch.int8,
                 scale: Optional[float] = None, symmetric: bool = False,
                 with_ref: bool = True):
    """Quantized delta of ``(B, N)`` float32 ``x`` against ``ref``.

    Returns ``(q (B, N) qdtype, scale (B,) f32, overflow (B,) int32,
    new_ref (B, N) f32 or None)``.  ``scale=None`` is the adaptive scale
    ``max(max |x - ref|, 1e-30) / iinfo.max`` of each row; a float fixes
    one scale for all.  ``new_ref = ref + q * scale`` is the receiver's
    reconstruction (the closed loop)."""
    if _on_cpu("delta_encode", x):
        return delta_encode_plain(x, ref, qdtype=qdtype, scale=scale,
                                  symmetric=symmetric, with_ref=with_ref)
    lo, hi = clip_range(qdtype, symmetric)
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"delta_encode: x has shape {tuple(x.shape)}, "
                         "expected (B, N)")
    b, n = x.shape
    _check("delta_encode", "x", x, torch.float32, (b, n), dev)
    _check("delta_encode", "ref", ref, torch.float32, (b, n), dev)
    q = torch.empty((b, n), dtype=qdtype, device=dev)
    new_ref = torch.empty_like(x) if with_ref else None
    s = torch.empty((b,), dtype=torch.float32, device=dev)
    oflow = torch.empty((b,), dtype=torch.int32, device=dev)
    vec = _vec(n, x, ref, q, *([new_ref] if with_ref else []))
    adaptive = int(scale is None)
    lib = _library()
    p = plan(b, n, TILE_ELEMS, _occupancy(
        lib, "delta_encode_coresident", (QDTYPES[qdtype], vec, adaptive),
        dev))
    part = torch.empty((2, b, p.grid_x), dtype=torch.int32, device=dev)
    err = lib.delta_encode_launch(
        QDTYPES[qdtype], dev.index, x.data_ptr(), ref.data_ptr(), b, n, vec,
        adaptive, float(np.float32(scale or 0.0)), lo, hi, p.grid_x,
        p.grid_y, p.rounds, part.data_ptr(), q.data_ptr(),
        None if new_ref is None else new_ref.data_ptr(), s.data_ptr(),
        oflow.data_ptr(), _stream(dev))
    _raise(lib, "delta_encode", err)
    LAUNCHES["delta_encode"] += 1
    return q, s, oflow, new_ref


def delta_decode(q: torch.Tensor, ref: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``ref + q * scale[b]`` of ``(B, N)`` quantized rows."""
    if _on_cpu("delta_decode", q):
        return delta_decode_plain(q, ref, scale)
    dev = q.device
    if q.dim() != 2 or q.dtype not in QDTYPES:
        raise ValueError(f"delta_decode: q is {q.dtype} {tuple(q.shape)}, "
                         "expected int8/int16 (B, N)")
    b, n = q.shape
    _check("delta_decode", "q", q, q.dtype, (b, n), dev)
    _check("delta_decode", "ref", ref, torch.float32, (b, n), dev)
    _check("delta_decode", "scale", scale, torch.float32, (b,), dev)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    qbits, vec = QDTYPES[q.dtype], int(_aligned(q, ref, out))
    lib = _library()
    p = plan(b, n, 4 * DECODE_UNITS, _occupancy(
        lib, "delta_decode_occupancy", (qbits, vec), dev))
    err = lib.delta_decode_launch(
        qbits, dev.index, q.data_ptr(), ref.data_ptr(), scale.data_ptr(), b,
        n, vec, p.grid_x, p.grid_y, p.rounds, out.data_ptr(), _stream(dev))
    _raise(lib, "delta_decode", err)
    LAUNCHES["delta_decode"] += 1
    return out


def _frame_args(d: int, scale, lsz, toroidal):
    scale, lens, tor = _frame(d, scale, lsz, toroidal)
    pad = 3 - d
    return ([float(v) for v in scale] + [0.0] * pad
            + [float(v) for v in lens] + [0.0] * pad
            + [int(t) for t in tor] + [0] * pad)


def migration_pos_encode(pos: torch.Tensor, center: torch.Tensor,
                         scale: Sequence[float], *,
                         valid: Optional[torch.Tensor] = None,
                         lsz=None, toroidal=(), dead: str = "mask",
                         symmetric: bool = False):
    """Fixed-point offsets of ``(B, R, D)`` float32 positions from each
    row's ``center (B, D)``, ``scale`` a float32 quantum per axis; the
    minimum image on ``toroidal`` axes (period ``lsz``) first.  Returns
    ``(q (B, R, D) int16, overflow (B,) int32)``; overflow counts the live
    rows' coordinates outside the int16 range (``valid (B, R)`` bool, or
    every row)."""
    if _on_cpu("migration_pos_encode", pos):
        return migration_pos_encode_plain(
            pos, center, scale, valid=valid, lsz=lsz, toroidal=toroidal,
            dead=dead, symmetric=symmetric)
    if dead not in ("mask", "zero"):
        raise ValueError(f"dead={dead!r}; expected 'mask' or 'zero'")
    lo, hi = clip_range(torch.int16, symmetric)
    dev = pos.device
    if pos.dim() != 3:
        raise ValueError(f"migration_pos_encode: pos has shape "
                         f"{tuple(pos.shape)}, expected (B, R, D)")
    b, r, d = pos.shape
    _check("migration_pos_encode", "pos", pos, torch.float32, (b, r, d), dev)
    _check("migration_pos_encode", "center", center, torch.float32, (b, d),
           dev)
    if valid is not None:
        _check("migration_pos_encode", "valid", valid, torch.bool, (b, r),
               dev)
    q = torch.empty((b, r, d), dtype=torch.int16, device=dev)
    oflow = torch.empty((b,), dtype=torch.int32, device=dev)
    vec = int(_aligned(pos, q, *([] if valid is None else [valid])))
    lib = _library()
    p = plan(b, r, 4 * MIG_CHUNKS, _occupancy(
        lib, "migration_pos_encode_coresident", (d, vec), dev))
    part = torch.empty((b, p.grid_x), dtype=torch.int32, device=dev)
    err = lib.migration_pos_encode_launch(
        dev.index, pos.data_ptr(), center.data_ptr(),
        None if valid is None else valid.data_ptr(), b, r, d,
        *_frame_args(d, scale, lsz, toroidal), int(dead == "zero"), lo, hi,
        vec, p.grid_x, p.grid_y, p.rounds, part.data_ptr(), q.data_ptr(),
        oflow.data_ptr(), _stream(dev))
    _raise(lib, "migration_pos_encode", err)
    LAUNCHES["migration_pos_encode"] += 1
    return q, oflow


def _seam_args(d: int, at_l):
    at_l = _at_l(d, at_l)
    if at_l is None:
        return [0, 0.0, 0.0, 0.0]
    return [1] + [float(v) for v in at_l] + [0.0] * (3 - d)


def migration_pos_decode(q: torch.Tensor, center: torch.Tensor,
                         scale: Sequence[float], *, lsz=None,
                         toroidal=(), at_l=None) -> torch.Tensor:
    """``(B, R, D)`` float32 positions ``center[b] + q * scale``, wrapped
    into ``[0, L)`` on toroidal axes: a step a hair below 0 rounds to
    exactly L, which ``at_l`` (D floats, the engine's seam) replaces; with
    ``at_l=None`` it stays L, as the TPU kernel's ``jnp.mod`` leaves it."""
    if _on_cpu("migration_pos_decode", q):
        return migration_pos_decode_plain(q, center, scale, lsz=lsz,
                                          toroidal=toroidal, at_l=at_l)
    dev = q.device
    if q.dim() != 3:
        raise ValueError(f"migration_pos_decode: q has shape "
                         f"{tuple(q.shape)}, expected (B, R, D)")
    b, r, d = q.shape
    _check("migration_pos_decode", "q", q, torch.int16, (b, r, d), dev)
    _check("migration_pos_decode", "center", center, torch.float32, (b, d),
           dev)
    pos = torch.empty((b, r, d), dtype=torch.float32, device=dev)
    vec = int(_aligned(q, pos))
    lib = _library()
    p = plan(b, r * d, 4 * DECODE_UNITS, _occupancy(
        lib, "migration_pos_decode_occupancy", (d, vec), dev))
    err = lib.migration_pos_decode_launch(
        dev.index, q.data_ptr(), center.data_ptr(), b, r, d,
        *_frame_args(d, scale, lsz, toroidal), *_seam_args(d, at_l), vec,
        p.grid_x, p.grid_y, p.rounds, pos.data_ptr(), _stream(dev))
    _raise(lib, "migration_pos_decode", err)
    LAUNCHES["migration_pos_decode"] += 1
    return pos
