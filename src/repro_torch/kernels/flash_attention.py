"""Blocked (flash) attention: a hand-written Hopper kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

This is the port of the TPU kernel ``flash_attention_kernel``
(``src/repro/kernels/flash_attention.py:75``): for each of BH heads,
``softmax(q k^T * scale [causal]) v`` with an online softmax in float32,
q ``(BH, Sq, hd)``, k ``(BH, Skv, hd)``, v ``(BH, Skv, hdv)``, float32 or
bfloat16, the output in q's type.

* :func:`flash_attention` is the wrapper.  On a CUDA tensor it launches
  one of the two kernels of ``csrc/flash_attention.cu`` or raises; on a
  CPU tensor it runs :func:`flash_attention_plain`.  There is no fallback
  between them.  bf16 q, k, v with ``hd == hdv`` in :data:`WGMMA_HEAD_DIMS`
  go to ``flash_wgmma_kernel`` (TMA and ``wgmma`` on the tensor cores,
  ``p`` split into two bf16 terms); everything else the kernel takes
  (float32, the other head dims, ``hdv != hd``) goes to
  ``flash_attention_kernel`` (``mma.sync`` on the tensor cores in
  3xTF32: each float32 operand split into two TF32 terms, so the products
  keep float32's accuracy).  The choice is made from the dtype and head
  dims alone (:func:`kernel_for`).  A head dim the kernels are not built
  for is zero-padded to the next one that is (:func:`pad_head_dims`; at
  most 128): zero columns of q and k add nothing to ``q k^T``, zero
  columns of v give zero columns of the output, which are cut off, and
  the scale stays the true ``hd ** -0.5``.  At hd = hdv = 80 the kernel
  does 128 columns of work for 80 useful ones.
* :func:`flash_attention_plain` is the port of the reference's oracle
  ``kernels/ref.flash_attention_ref``: float32 scores, the mask, a softmax,
  then the cast.

Neither has a backward (the reference's Pallas kernel has no VJP either,
ROADMAP B5 b): :func:`flash_attention` raises ``NotImplementedError``
when grad mode is on and q, k or v requires grad, on the card and on the
CPU alike, where the kernel would hand back an output without a
``grad_fn`` and the plain version one that autograd differentiates.
Training runs ``backend="chunked"``, as the reference's does.

Each launch adds one to the count of the kernel it launched,
``LAUNCHES["flash_attention"]`` (float32 kernel) or
``LAUNCHES["flash_attention_wgmma"]``; nothing else touches the counts.
"""

from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)     # head dims the kernels are built for
WGMMA_HEAD_DIMS = (64, 128)          # bf16, hd == hdv: the tensor-core kernel

LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_for(dtype: torch.dtype, hd: int, hdv: int) -> str:
    """The kernel (its ``LAUNCHES`` key) that takes inputs of this dtype
    and these head dims."""
    if dtype == torch.bfloat16 and hd == hdv and hd in WGMMA_HEAD_DIMS:
        return "flash_attention_wgmma"
    return "flash_attention"


def built_head_dim(d: int) -> int:
    """The smallest head dim the kernels are built for that is >= ``d``;
    raises past the largest."""
    for h in HEAD_DIMS:
        if h >= d:
            return h
    raise ValueError(f"flash_attention: head dim {d}; the kernel is built "
                     f"for {HEAD_DIMS} and pads smaller ones up to them")


def pad_head_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q and k zero-padded along hd, v along hdv, to built head dims
    (the tensors themselves where they are built already)."""
    hd, hdv = q.shape[-1], v.shape[-1]
    hd_p, hdv_p = built_head_dim(hd), built_head_dim(hdv)
    if hd_p != hd:
        q = torch.nn.functional.pad(q, (0, hd_p - hd))
        k = torch.nn.functional.pad(k, (0, hd_p - hd))
    if hdv_p != hdv:
        v = torch.nn.functional.pad(v, (0, hdv_p - hdv))
    return q, k, v


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: float = None) -> torch.Tensor:
    """q (BH, Sq, hd), k (BH, Skv, hd), v (BH, Skv, hdv) -> (BH, Sq, hdv);
    ``scale`` defaults to ``hd ** -0.5``."""
    _, sq, hd = q.shape
    skv = k.shape[1]
    if scale is None:
        scale = hd ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        above = (torch.arange(sq, device=q.device)[:, None]
                 < torch.arange(skv, device=q.device)[None, :])
        s = s.masked_fill(above[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _check_blocks(sq: int, skv: int) -> None:
    """The TPU kernel's shape contract (``flash_attention.py:88-90``): its
    128-row blocks, or the whole sequence where it is shorter, must tile
    Sq and Skv.  The CUDA kernels take 128 query rows a block and K and V
    tiles of 64 rows (``flash_attention_kernel``) or 128 (the bf16
    ``flash_wgmma_kernel``), mask the ragged tile, and take the same
    shapes."""
    bq, bk = min(128, sq), min(128, skv)
    if sq % bq or skv % bk:
        raise ValueError(f"flash_attention: Sq={sq} must be a multiple of "
                         f"{bq} and Skv={skv} of {bk}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention of ``(BH, S, hd)`` heads, scaled by ``hd ** -0.5``."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: q, k, v must be (BH, S, d)")
    bh, sq, hd = q.shape
    _, skv, hdv = v.shape
    if k.shape != (bh, skv, hd) or v.shape[0] != bh:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    _check_blocks(sq, skv)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward (ROADMAP B5 b, as the "
            "reference's Pallas kernel has no VJP): train on "
            "backend='chunked', or call it under torch.no_grad()")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    qp, kp, vp = pad_head_dims(q, k, v)
    out = _launch(qp, kp, vp, causal, hd ** -0.5)
    return out if vp is v else out[..., :hdv].contiguous()


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_wgmma_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.flash_attention_wgmma_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, causal: bool, scale: float,
            p_terms: int = 2) -> torch.Tensor:
    """Launch the kernel :func:`kernel_for` picks.  ``p_terms`` (the bf16
    kernel only): 2 runs PV on ``p_hi`` and ``p_lo``, as the wrapper
    does; 1 on ``bf16(p)`` alone, which exists to measure the split."""
    bh, sq, hd = q.shape
    skv, hdv = v.shape[1], v.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise TypeError(f"flash_attention: {name} has dtype {t.dtype}; "
                            "the kernel takes q, k, v all float32 or all "
                            "bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    if hd not in HEAD_DIMS or hdv not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims hd={hd}, hdv={hdv}; "
                         f"the kernel is built for {HEAD_DIMS}")
    name = kernel_for(q.dtype, hd, hdv)
    out = torch.empty((bh, sq, hdv), dtype=q.dtype, device=q.device)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for t_name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {t_name} is not 16-byte "
                             "aligned (the TMA and cp.async loads need it)")
    if name == "flash_attention_wgmma":
        err = lib.flash_attention_wgmma_launch(
            q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), bh, sq, skv, hd, float(scale), int(causal),
            int(p_terms), stream)
    else:
        err = lib.flash_attention_launch(
            q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), bh, sq, skv, hd, hdv, float(scale), int(causal),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"({lib.flash_attention_error_string(err).decode()})")
    LAUNCHES[name] += 1
    return out
