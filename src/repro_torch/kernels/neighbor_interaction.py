"""The neighbour pair sweep: a hand-written Hopper kernel
(``csrc/pair_sweep.cu``) and its plain PyTorch version.

This is the port of the TPU kernel ``pair_sweep_kernel``
(``src/repro/kernels/neighbor_interaction.py:92``).  For every interior
cell, each of its K slots is paired with the ``3^D K`` slots of its ``3^D``
cell neighbourhood; pairs of valid slots with different
``<gid_rank, gid_count>`` and ``dist2 <= radius^2`` (minimum image on
toroidal axes) contribute the behaviour's ``pair_fn`` to per-agent sums.

* :func:`pair_sweep` is the wrapper.  On a CUDA tensor it launches the
  kernel, which reads the resident ``(*local_grid, K, ...)`` SoA tensors
  directly, or raises; on a CPU tensor it runs :func:`pair_sweep_plain`.
  There is no fallback between the two.
* :func:`pair_sweep_plain` is the reference ``pair_accumulate`` math in
  PyTorch over flattened ``(C, K)`` x ``(C, 3^D K)`` slabs, built by
  :func:`neighborhood_slabs`.  It runs any ``pair_fn``.
* The kernel runs the pair laws registered in :data:`LAWS`, one device
  function each, and the ``compose()`` stacks of :data:`STACKS` (a
  stack's parts over one neighbourhood, each gated to its own radius).
  A ``pair_fn`` with no device law, or a stack with such a part, raises
  ``NotImplementedError`` on a CUDA tensor.
* :func:`pair_sweep_lanes` sweeps B lanes in one launch (the reference's
  ``jax.vmap`` of the kernel over an ensemble's replicas): lane ``b`` is
  index ``b`` of ``(B, *local_grid, K, ...)`` tensors, which may be views
  with any lane stride (one device's block of a stacked mesh state is read
  in place), each lane with its own pair function's params, from a
  float32 device table (:func:`lane_table`) built once by the caller.  On
  a CPU tensor it runs the plain version lane by lane.

The legacy soft-sphere entry point is here too: :func:`neighbor_force`,
the port of ``neighbor_force_kernel`` (``neighbor_interaction.py:201``),
sums the soft-sphere law over already gathered ``(C, K)`` x ``(C, NK)``
slabs on its own kernel in the same source, with
:func:`neighbor_force_plain` (the port of ``ref.neighbor_force_ref``)
beside it.

The public op's entry point is here too:
:func:`neighborhood_pair_sweep`, the port of the reference's
``ops.neighborhood_pair_sweep`` (``pair_sweep_kernel`` on slabs the caller
gathered), runs every law of :data:`LAWS` and :data:`STACKS` on ``(C,
K)`` x ``(C, NK)`` slabs on a third kernel of the same source, with
:func:`pair_sweep_plain` as its plain version.

Each launch adds one to ``LAUNCHES[law]`` (``LAUNCHES["neighbor_force"]``
for the legacy kernel, ``LAUNCHES["neighborhood_pair_sweep"]`` for the
gathered-slab one), whatever its lanes, or, for a face band of the
overlapped sweep (``pair_sweep(..., face=True)``), to
``LAUNCHES[law + FACE]``; nothing else touches the counts, so a run can
show that it went through the kernel, and on which blocks.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

# Reserved column names (the port's core.agent_soa names; string literals
# keep the kernels package free of the core layer).
_POS = "pos"
_GID_RANK = "gid_rank"
_GID_COUNT = "gid_count"

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PairLaw:
    """One device pair law of the kernel, or a stack of them.

    ``law_id`` selects the device function; ``float_cols``/``int_cols``
    name the SoA columns it reads besides pos and gids, in the kernel's
    column slots (at most one float column and two int ones); ``params``
    lists its float parameters in kernel order as ``(name, default)``
    (``None``: the behaviour must supply it); ``outputs`` lists ``(name,
    per_axis)`` where ``per_axis`` outputs carry a trailing ``(D,)`` dim.
    A stack (``parts``: its laws' names) takes each part's params from
    that part, in order, and namespaces the parts' outputs ``b{i}.``.
    """

    name: str
    law_id: int
    float_cols: Tuple[str, ...]
    int_cols: Tuple[str, ...]
    params: Tuple[Tuple[str, Optional[float]], ...]
    outputs: Tuple[Tuple[str, bool], ...]
    parts: Tuple[str, ...] = ()


_SOFT = PairLaw(
    name="soft_repulsion_adhesion", law_id=0, float_cols=("diameter",),
    int_cols=("ctype",),
    params=(("repulsion", None), ("adhesion", None), ("same_type_only", 1.0)),
    outputs=(("force", True),))

# Port pair functions (by qualified name) -> device law.
LAWS: Dict[str, PairLaw] = {
    "repro_torch.core.behaviors.soft_repulsion_adhesion": _SOFT,
    "repro_torch.sims.cell_clustering._same_type_pair": PairLaw(
        name="same_type", law_id=1, float_cols=(), int_cols=("ctype",),
        params=(), outputs=(("same", False), ("cnt", False))),
    "repro_torch.sims.epidemiology._pair": PairLaw(
        name="epidemiology", law_id=2, float_cols=(), int_cols=("state",),
        params=(), outputs=(("n_inf", False),)),
    "repro_torch.sims.oncology._pair": PairLaw(
        name="oncology", law_id=3, float_cols=("diameter",),
        int_cols=("ctype",), params=_SOFT.params,
        outputs=(("force", True), ("crowd", False))),
    "repro_torch.sims.tumor_spheroid._crowd_pair": PairLaw(
        name="crowd", law_id=4, float_cols=(), int_cols=(), params=(),
        outputs=(("crowd", False),)),
    "repro_torch.sims.sir_mechanics._gated_sir_pair": PairLaw(
        name="gated_epidemiology", law_id=5, float_cols=(),
        int_cols=("state",), params=(("sir_radius", None),),
        outputs=(("n_inf", False),)),
}

# compose() stacks the kernel instantiates, by their parts' law names.
STACKS: Dict[Tuple[str, ...], PairLaw] = {
    ("soft_repulsion_adhesion", "epidemiology"): PairLaw(
        name="stack(soft_repulsion_adhesion,epidemiology)", law_id=16,
        float_cols=("diameter",), int_cols=("ctype", "state"),
        params=_SOFT.params,
        outputs=(("b0.force", True), ("b1.n_inf", False)),
        parts=("soft_repulsion_adhesion", "epidemiology")),
    ("soft_repulsion_adhesion", "crowd"): PairLaw(
        name="stack(soft_repulsion_adhesion,crowd)", law_id=17,
        float_cols=("diameter",), int_cols=("ctype",), params=_SOFT.params,
        outputs=(("b0.force", True), ("b1.crowd", False)),
        parts=("soft_repulsion_adhesion", "crowd")),
    ("soft_repulsion_adhesion", "gated_epidemiology"): PairLaw(
        name="stack(soft_repulsion_adhesion,gated_epidemiology)", law_id=18,
        float_cols=("diameter",), int_cols=("ctype", "state"),
        params=_SOFT.params + (("sir_radius", None),),
        outputs=(("b0.force", True), ("b1.n_inf", False)),
        parts=("soft_repulsion_adhesion", "gated_epidemiology")),
}

# Floats of a lane's row in a lane table: the kernel's 8 params, then its 4
# gates (csrc/pair_sweep.cu kMaxParams, kMaxParts).
_MAX_PARAMS, _MAX_GATES = 8, 4

# Kernel launches per law since the last reset_launches() (a face band's
# under the law's name + FACE), of the legacy neighbor_force kernel and of
# the gathered-slab sweep.
FACE = "@face"
LAUNCHES: Dict[str, int] = {
    law.name + tag: 0 for law in (*LAWS.values(), *STACKS.values())
    for tag in ("", FACE)}
LAUNCHES["neighbor_force"] = 0
LAUNCHES["neighborhood_pair_sweep"] = 0


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _base_law(pair_fn: Callable) -> PairLaw:
    key = f"{pair_fn.__module__}.{pair_fn.__qualname__}"
    law = LAWS.get(key)
    if law is None:
        raise NotImplementedError(
            f"pair function {key} has no device law in the pair_sweep "
            f"kernel (laws: {sorted(LAWS)}); a new law is one line of LAWS "
            "and one device function of csrc/pair_sweep.cu (ROADMAP B1) - "
            "run this behaviour on the CPU")
    return law


def law_for(pair_fn: Callable) -> PairLaw:
    """The device law of a port pair function, or of a ``compose()`` stack
    (a pair function with ``parts``); raises ``NotImplementedError`` for
    one the kernel does not have, a stack with such a part included."""
    parts = getattr(pair_fn, "parts", None)
    if parts is None:
        return _base_law(pair_fn)
    laws = tuple(_base_law(fn) for fn, _, _ in parts)
    if len(laws) == 1:       # compose(b): b's law, outputs namespaced
        law = laws[0]
        return dataclasses.replace(
            law, outputs=tuple((f"b0.{n}", ax) for n, ax in law.outputs),
            parts=(law.name,))
    names = tuple(law.name for law in laws)
    stack = STACKS.get(names)
    if stack is None:
        raise NotImplementedError(
            f"the pair_sweep kernel has no instantiation of the stack "
            f"{names} (stacks: {sorted(STACKS)}); a stack of bundled laws "
            "is one line of STACKS and one case of csrc/pair_sweep.cu "
            "(ROADMAP B1 a)")
    return stack


def _law_args(law: PairLaw, pair_fn: Callable, params: dict
              ) -> Tuple[list, list]:
    """The kernel's float params and, for a stack, each part's r^2 gate
    (+inf for a part at the sweep's radius)."""
    def values(spec, p):
        return [float(p[n]) if d is None else float(p.get(n, d))
                for n, d in spec]

    parts = getattr(pair_fn, "parts", None)
    if parts is None:
        return values(law.params, params), []
    vals, gates = [], []
    for fn, r, p in parts:
        vals += values(_base_law(fn).params, p)
        gates.append(float(np.float32(r * r)) if r < pair_fn.radius
                     else math.inf)
    return vals, gates


def lane_table(pair_fns: Sequence[Callable], params: Sequence[dict],
               device) -> torch.Tensor:
    """The per-lane table of a lane launch: ``(B, 12)`` float32 on
    ``device``, row ``b`` lane ``b``'s kernel params (zero-padded to 8),
    then its gates (+inf-padded to 4).  Every lane must run one law; build
    it once and pass it to every :func:`pair_sweep_lanes` of the lanes.
    The copy to the card is made from pinned memory without waiting."""
    laws = [law_for(fn) for fn in pair_fns]
    if not laws or any(law != laws[0] for law in laws):
        raise ValueError(
            f"lane_table: the lanes of one launch run one law, got "
            f"{sorted({law.name for law in laws})}")
    rows = []
    for law, fn, p in zip(laws, pair_fns, params):
        vals, gates = _law_args(law, fn, p)
        rows.append(vals + [0.0] * (_MAX_PARAMS - len(vals))
                    + gates + [math.inf] * (_MAX_GATES - len(gates)))
    table = torch.tensor(rows, dtype=torch.float32)
    if torch.device(device).type == "cuda":
        return table.pin_memory().to(device, non_blocking=True)
    return table


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def neighborhood_slabs(
    attrs: Tensors, valid: torch.Tensor, names: Sequence[str],
    rows: Optional[Tuple[int, int]] = None,
) -> Tuple[Tensors, Tensors, torch.Tensor, torch.Tensor]:
    """Flatten the interior cells of resident ``(*local_grid, K, ...)``
    tensors into ``(C, K, ...)`` self slabs and ``(C, 3^D K, ...)``
    neighbourhood slabs, offsets in row-major order over ``(-1, 0, 1)^D``
    (the order of ``core.neighbors.offsets_for``).  ``rows=(r0, r1)``
    restricts the cells to interior rows ``[r0, r1)`` along axis 0.

    Returns ``(attrs_i, attrs_j, valid_i, valid_j)``; the columns are
    ``names`` plus pos and the two gid columns.
    """
    nd = valid.dim() - 1
    local = tuple(valid.shape[:nd])
    k = valid.shape[nd]
    r0, r1 = (0, local[0] - 2) if rows is None else rows
    offs = list(itertools.product((-1, 0, 1), repeat=nd))

    def cells(off):
        return ((slice(1 + r0 + off[0], 1 + r1 + off[0]),)
                + tuple(slice(1 + o, h - 1 + o)
                        for o, h in zip(off[1:], local[1:])))

    c = (r1 - r0) * math.prod(h - 2 for h in local[1:])
    centre = cells((0,) * nd)

    def flat_i(a):
        return a[centre].reshape((c, k) + tuple(a.shape[nd + 1:]))

    def flat_j(a):
        stacked = torch.stack([a[cells(o)] for o in offs], dim=nd)
        return stacked.reshape((c, len(offs) * k) + tuple(a.shape[nd + 1:]))

    need = sorted(set(names) | {_POS, _GID_RANK, _GID_COUNT})
    return ({n: flat_i(attrs[n]) for n in need},
            {n: flat_j(attrs[n]) for n in need},
            flat_i(valid), flat_j(valid))


def pair_sweep_plain(
    attrs_i: Tensors, attrs_j: Tensors,
    valid_i: torch.Tensor, valid_j: torch.Tensor,
    *, pair_fn: Callable, radius: float, params: dict,
    box: Optional[Sequence[Optional[float]]] = None,
) -> Tensors:
    """The reference pair math over flattened slabs: ``attrs_i`` values are
    ``(C, K, *t)``, ``attrs_j`` values ``(C, NK, *t)``; returns a dict of
    ``(C, K, *t)`` sums over the NK axis.  ``box`` holds per-axis minimum-
    image lengths, ``None`` for a closed axis (or ``None`` for all)."""
    ai = {n: a.unsqueeze(2) for n, a in attrs_i.items()}   # (C, K, 1, t)
    aj = {n: a.unsqueeze(1) for n, a in attrs_j.items()}   # (C, 1, NK, t)
    dev = valid_i.device

    disp = aj[_POS] - ai[_POS]                               # (C, K, NK, D)
    if box is not None and any(b is not None for b in box):
        comps = []
        for axis in range(disp.shape[-1]):
            d = disp[..., axis]
            if box[axis] is None:
                comps.append(d)
            else:
                b = torch.tensor(box[axis], dtype=torch.float32, device=dev)
                comps.append(d - b * torch.round(d / b))
        disp = torch.stack(comps, dim=-1)
    dist2 = disp[..., 0] * disp[..., 0]                      # (C, K, NK)
    for axis in range(1, disp.shape[-1]):   # the kernel's order, axis by axis
        dist2 = dist2 + disp[..., axis] * disp[..., axis]

    same = (ai[_GID_RANK] == aj[_GID_RANK]) & (
        ai[_GID_COUNT] == aj[_GID_COUNT])
    r2 = torch.tensor(np.float32(radius * radius), device=dev)
    mask = (valid_i[:, :, None] & valid_j[:, None, :] & ~same
            & (dist2 <= r2))

    contribs = pair_fn(ai, aj, disp, dist2, params)
    out: Tensors = {}
    for name, c in contribs.items():
        m = mask
        while m.dim() < c.dim():
            m = m[..., None]
        out[name] = torch.where(m, c, torch.zeros((), dtype=c.dtype,
                                                  device=dev)).sum(dim=2)
    return out


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def pair_sweep(
    attrs: Tensors, valid: torch.Tensor, *, pair_fn: Callable,
    pair_attrs: Sequence[str], radius: float, params: dict,
    box: Optional[Sequence[Optional[float]]] = None, face: bool = False,
) -> Tensors:
    """Per-agent pair sums over the resident SoA.

    ``attrs``/``valid`` are the resident ``(*local_grid, K, ...)`` tensors
    (interior plus the filled halo ring), each contiguous.  Returns a dict
    of ``(*interior, K, *t)`` float32 sums.  On a CUDA tensor this launches
    the ``pair_sweep`` kernel (or raises); on a CPU tensor it runs the
    plain version.  ``face`` counts the launch as a face band's of the
    overlapped sweep (``LAUNCHES[law + FACE]``).
    """
    nd = valid.dim() - 1
    interior = tuple(h - 2 for h in valid.shape[:nd])
    k = valid.shape[nd]
    if valid.device.type == "cpu":
        ai, aj, vi, vj = neighborhood_slabs(attrs, valid, pair_attrs)
        acc = pair_sweep_plain(ai, aj, vi, vj, pair_fn=pair_fn,
                               radius=radius, params=params, box=box)
        return {n: a.reshape(interior + (k,) + tuple(a.shape[2:]))
                for n, a in acc.items()}
    if valid.device.type != "cuda":
        raise ValueError(f"pair_sweep: unsupported device {valid.device}")
    law = law_for(pair_fn)
    vals, gates = _law_args(law, pair_fn, params)
    one = {n: a.unsqueeze(0) for n, a in attrs.items()}
    outs = _launch(law, one, valid.unsqueeze(0), radius, vals, gates, box,
                   face=face)
    return {n: o[0] for n, o in outs.items()}


def pair_sweep_lanes(
    attrs: Tensors, valid: torch.Tensor, *, pair_fns: Sequence[Callable],
    pair_attrs: Sequence[str], radius: float, params: Sequence[dict],
    box: Optional[Sequence[Optional[float]]] = None,
    table: Optional[torch.Tensor] = None,
) -> Tensors:
    """Per-agent pair sums of B lanes in one launch.

    ``attrs``/``valid`` are ``(B, *local_grid, K, ...)``: lane ``b``'s
    resident SoA is index ``b``, each lane's block contiguous, the lanes
    any common stride apart.  Lane ``b`` runs ``pair_fns[b]`` with
    ``params[b]`` (one law for all lanes, params per lane).  Returns a dict
    of ``(B, *interior, K, *t)`` float32 sums.  On a CUDA tensor this
    launches the ``pair_sweep`` kernel once (or raises), its per-lane
    params from ``table`` (:func:`lane_table`; built here when not given);
    on a CPU tensor it runs the plain version lane by lane.
    """
    lanes = valid.shape[0]
    if len(pair_fns) != lanes or len(params) != lanes:
        raise ValueError(
            f"pair_sweep_lanes: {lanes} lanes, {len(pair_fns)} pair "
            f"functions, {len(params)} params")
    if valid.device.type == "cpu":
        per = [pair_sweep({n: a[b] for n, a in attrs.items()}, valid[b],
                          pair_fn=pair_fns[b], pair_attrs=pair_attrs,
                          radius=radius, params=params[b], box=box)
               for b in range(lanes)]
        return {n: torch.stack([p[n] for p in per]) for n in per[0]}
    if valid.device.type != "cuda":
        raise ValueError(
            f"pair_sweep_lanes: unsupported device {valid.device}")
    if table is None:
        table = lane_table(pair_fns, params, valid.device)
    if tuple(table.shape) != (lanes, _MAX_PARAMS + _MAX_GATES) or \
            table.dtype != torch.float32 or table.device != valid.device \
            or not table.is_contiguous():
        raise ValueError(
            f"pair_sweep_lanes: the lane table is {table.dtype} "
            f"{tuple(table.shape)} on {table.device}; expected a contiguous "
            f"float32 ({lanes}, {_MAX_PARAMS + _MAX_GATES}) on "
            f"{valid.device}")
    return _launch(law_for(pair_fns[0]), attrs, valid, radius, [], [], box,
                   table=table)


_ARGTYPES = (
    [ctypes.c_int] * 3                       # law, ndim, device
    + [ctypes.c_void_p] * 7                  # pos, gids, valid, columns
    + [ctypes.c_int] * 4                     # n0, n1, n2, k
    + [ctypes.c_float] * 4                   # r2, box lengths
    + [ctypes.c_int] * 3                     # wrap flags
    + [ctypes.c_void_p, ctypes.c_int] * 2    # params, gates (host arrays)
    + [ctypes.c_void_p, ctypes.c_int]        # outputs (host array)
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]   # lanes, strides
    + [ctypes.c_void_p]                      # lane table (device), or null
    + [ctypes.c_void_p]                      # stream
)


def _library() -> ctypes.CDLL:
    lib = _build.load("pair_sweep")
    if lib.pair_sweep_launch.argtypes is None:
        lib.pair_sweep_launch.argtypes = _ARGTYPES
        lib.pair_sweep_launch.restype = ctypes.c_int
        lib.pair_sweep_error_string.argtypes = [ctypes.c_int]
        lib.pair_sweep_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"pair_sweep: {name} is on {t.device}, "
                         f"valid on {device}")
    if t.dtype != dtype:
        raise TypeError(f"pair_sweep: {name} has dtype {t.dtype}, the "
                        f"kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"pair_sweep: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"pair_sweep: {name} is not contiguous")


def _launch(law: PairLaw, attrs: Tensors, valid: torch.Tensor,
            radius: float, params: list, gates: list,
            box: Optional[Sequence[Optional[float]]],
            table: Optional[torch.Tensor] = None, face: bool = False
            ) -> Tensors:
    """One launch over the lanes of ``(B, *local_grid, K, ...)`` columns
    (a solo sweep is one lane with ``params``/``gates`` from the host;
    with ``table``, each lane's from its row), counted under ``law`` or,
    with ``face``, ``law + FACE``.  Returns ``(B, *interior, K, *t)``
    outputs."""
    nd = valid.dim() - 2
    if nd not in (2, 3):
        raise ValueError(f"pair_sweep: a {nd}-D grid; the kernel takes "
                         "2-D and 3-D domains")
    dev = valid.device
    lanes = valid.shape[0]
    grid = tuple(valid.shape[1:])
    interior = tuple(h - 2 for h in grid[:nd])
    k = grid[nd]
    strides = {}

    def lane_col(name, t, dtype, trailing=()):
        shape = (lanes,) + grid + trailing
        if tuple(t.shape) != shape:
            raise ValueError(f"pair_sweep: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        _check(name, t[0], dtype, grid + trailing, dev)
        if lanes > 1:
            width = math.prod(trailing)
            if t.stride(0) % width:
                raise ValueError(
                    f"pair_sweep: the lanes of {name} are {t.stride(0)} "
                    f"elements apart, not a whole number of slots")
            strides[name] = t.stride(0) // width
        return t.data_ptr()

    ptrs = [lane_col("valid", valid, torch.bool),
            lane_col(_POS, attrs[_POS], torch.float32, (nd,)),
            lane_col(_GID_RANK, attrs[_GID_RANK], torch.int32),
            lane_col(_GID_COUNT, attrs[_GID_COUNT], torch.int32)]
    cols = []
    for names, dtype, slots in ((law.float_cols, torch.float32, 1),
                                (law.int_cols, torch.int32, 2)):
        cols += [lane_col(n, attrs[n], dtype) for n in names]
        cols += [None] * (slots - len(names))
    lane_stride = 0
    if lanes > 1:
        if len(set(strides.values())) != 1:
            raise ValueError(
                f"pair_sweep: the columns' lanes lie at different strides "
                f"(in slots: {strides})")
        lane_stride = next(iter(strides.values()))

    n = list(interior) + [1] * (3 - nd)
    outs = {name: torch.empty((lanes,) + interior + (k,)
                              + ((nd,) if per_axis else ()),
                              dtype=torch.float32, device=dev)
            for name, per_axis in law.outputs}

    lib = _library()
    err = lib.pair_sweep_launch(
        law.law_id, nd, dev.index, ptrs[1], ptrs[2], ptrs[3], ptrs[0], *cols,
        *n, k, *_c_args(radius, box, nd, params, gates, outs),
        lanes, lane_stride, math.prod(interior) * k,
        None if table is None else table.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"pair_sweep kernel launch failed: cudaError {err} "
            f"({lib.pair_sweep_error_string(err).decode()})")
    LAUNCHES[law.name + (FACE if face else "")] += 1
    return outs


def _c_args(radius: float, box, nd: int, params: list, gates: list,
            outs: Tensors) -> list:
    """The launch arguments both sweep launches share, in their order:
    r^2, the three box lengths and wrap flags (``box``: per axis, None
    on a closed one), then params, gates and the output pointers as
    (host array, count) pairs."""
    box = tuple(box) if box is not None else (None,) * nd
    lens = [0.0 if b is None else float(b) for b in box] + [0.0] * (3 - nd)
    wraps = [0 if b is None else 1 for b in box] + [0] * (3 - nd)
    c_params = (ctypes.c_float * max(len(params), 1))(*params)
    c_gates = (ctypes.c_float * max(len(gates), 1))(*gates)
    c_outs = (ctypes.c_void_p * len(outs))(
        *[o.data_ptr() for o in outs.values()])
    return [float(np.float32(radius * radius)), *lens, *wraps,
            ctypes.cast(c_params, ctypes.c_void_p), len(params),
            ctypes.cast(c_gates, ctypes.c_void_p), len(gates),
            ctypes.cast(c_outs, ctypes.c_void_p), len(outs)]


# ---------------------------------------------------------------------------
# The legacy soft-sphere force on gathered slabs (neighbor_force_kernel)
# ---------------------------------------------------------------------------

def neighbor_force_plain(pos_i, diam_i, type_i, valid_i, gid_i,
                         pos_j, diam_j, type_j, valid_j, gid_j,
                         *, radius, repulsion, adhesion,
                         same_type_only=True) -> torch.Tensor:
    """Per-cell pairwise force: i ``(C, K, ...)`` own agents, j
    ``(C, NK, ...)`` neighbourhood agents -> force ``(C, K, 2)``; no
    minimum image.  The reference oracle's arithmetic op for op."""
    dev = pos_i.device
    disp = pos_j[:, None, :, :] - pos_i[:, :, None, :]       # (C,K,NK,2)
    dist2 = torch.sum(disp * disp, dim=-1)
    dist = torch.sqrt(dist2 + torch.tensor(1e-6, dtype=torch.float32,
                                           device=dev))
    unit = disp / dist[..., None]
    r_sum = 0.5 * (diam_i[:, :, None] + diam_j[:, None, :])
    overlap = r_sum - dist
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    rep = torch.where(overlap > 0, repulsion * overlap, zero)
    same = (type_i[:, :, None] == type_j[:, None, :]).float()
    gate = same if same_type_only else torch.ones_like(same)
    adh = torch.where(overlap <= 0, adhesion * gate, zero)
    f = -(rep - adh)[..., None] * unit
    r2 = torch.tensor(np.float32(radius * radius), device=dev)
    mask = (valid_i[:, :, None] & valid_j[:, None, :]
            & (gid_i[:, :, None] != gid_j[:, None, :])
            & (dist2 <= r2))
    return torch.sum(torch.where(mask[..., None], f, zero), dim=2)


def neighbor_force(pos_i, diam_i, type_i, valid_i, gid_i,
                   pos_j, diam_j, type_j, valid_j, gid_j,
                   *, radius, repulsion, adhesion,
                   same_type_only=True) -> torch.Tensor:
    """Soft-sphere force sweep on gathered slabs (the legacy single-law
    entry point).  On a CUDA tensor this launches the ``neighbor_force``
    kernel (or raises); on a CPU tensor it runs the plain version."""
    args = (pos_i, diam_i, type_i, valid_i, gid_i,
            pos_j, diam_j, type_j, valid_j, gid_j)
    kw = dict(radius=radius, repulsion=repulsion, adhesion=adhesion,
              same_type_only=same_type_only)
    if pos_i.device.type == "cpu":
        return neighbor_force_plain(*args, **kw)
    if pos_i.device.type != "cuda":
        raise ValueError(f"neighbor_force: unsupported device "
                         f"{pos_i.device}")
    return _launch_force(*args, **kw)


def _force_library() -> ctypes.CDLL:
    lib = _library()
    if lib.neighbor_force_launch.argtypes is None:
        lib.neighbor_force_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
            + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 2)
        lib.neighbor_force_launch.restype = ctypes.c_int
    return lib


def _launch_force(pos_i, diam_i, type_i, valid_i, gid_i,
                  pos_j, diam_j, type_j, valid_j, gid_j,
                  *, radius, repulsion, adhesion, same_type_only):
    dev = pos_i.device
    c, k = valid_i.shape[:2]
    nk = valid_j.shape[1]
    for side, n, (pos, diam, ctype, valid, gid) in (
            ("i", k, (pos_i, diam_i, type_i, valid_i, gid_i)),
            ("j", nk, (pos_j, diam_j, type_j, valid_j, gid_j))):
        _check(f"pos_{side}", pos, torch.float32, (c, n, 2), dev)
        _check(f"diam_{side}", diam, torch.float32, (c, n), dev)
        _check(f"type_{side}", ctype, torch.int32, (c, n), dev)
        _check(f"valid_{side}", valid, torch.bool, (c, n), dev)
        _check(f"gid_{side}", gid, torch.int32, (c, n), dev)
        if pos.data_ptr() % 8:
            raise ValueError(f"neighbor_force: pos_{side} is not 8-byte "
                             "aligned (the kernel reads (x, y) as float2)")
    out = torch.empty((c, k, 2), dtype=torch.float32, device=dev)
    lib = _force_library()
    err = lib.neighbor_force_launch(
        dev.index, pos_i.data_ptr(), diam_i.data_ptr(), type_i.data_ptr(),
        valid_i.data_ptr(), gid_i.data_ptr(), pos_j.data_ptr(),
        diam_j.data_ptr(), type_j.data_ptr(), valid_j.data_ptr(),
        gid_j.data_ptr(), c, k, nk, float(np.float32(radius * radius)),
        float(repulsion), float(adhesion), 1.0 if same_type_only else 0.0,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"neighbor_force kernel launch failed: cudaError {err} "
            f"({lib.pair_sweep_error_string(err).decode()})")
    LAUNCHES["neighbor_force"] += 1
    return out


# ---------------------------------------------------------------------------
# Every law on gathered slabs (ops.neighborhood_pair_sweep)
# ---------------------------------------------------------------------------

def neighborhood_pair_sweep(
    attrs_i: Tensors, attrs_j: Tensors,
    valid_i: torch.Tensor, valid_j: torch.Tensor,
    *, pair_fn: Callable, radius: float, params: dict,
    box: Optional[Sequence[Optional[float]]] = None,
) -> Tensors:
    """Per-agent pair sums on gathered slabs: ``attrs_i`` values ``(C, K,
    *t)``, ``attrs_j`` values ``(C, NK, *t)`` (holding pos, the gid
    columns and the law's own), ``valid_i`` ``(C, K)``, ``valid_j`` ``(C,
    NK)``; returns a dict of ``(C, K, *t)`` float32 sums.  On a CUDA
    tensor this launches the ``neighborhood_pair_sweep`` kernel, which
    runs the laws and stacks of :func:`law_for` (or raises); on a CPU
    tensor it runs :func:`pair_sweep_plain`."""
    if valid_i.device.type == "cpu":
        return pair_sweep_plain(attrs_i, attrs_j, valid_i, valid_j,
                                pair_fn=pair_fn, radius=radius,
                                params=params, box=box)
    if valid_i.device.type != "cuda":
        raise ValueError(f"neighborhood_pair_sweep: unsupported device "
                         f"{valid_i.device}")
    law = law_for(pair_fn)
    vals, gates = _law_args(law, pair_fn, params)
    return _launch_slabs(law, attrs_i, attrs_j, valid_i, valid_j, radius,
                         vals, gates, box)


def _slabs_library() -> ctypes.CDLL:
    lib = _library()
    if lib.neighborhood_pair_sweep_launch.argtypes is None:
        lib.neighborhood_pair_sweep_launch.argtypes = (
            [ctypes.c_int] * 3                       # law, ndim, device
            + [ctypes.c_void_p] * 2                  # column arrays
            + [ctypes.c_longlong] + [ctypes.c_int] * 2   # c, k, nk
            + [ctypes.c_float] * 4                   # r2, box lengths
            + [ctypes.c_int] * 3                     # wrap flags
            + [ctypes.c_void_p, ctypes.c_int] * 3    # params, gates, outs
            + [ctypes.c_void_p])                     # stream
        lib.neighborhood_pair_sweep_launch.restype = ctypes.c_int
    return lib


def _launch_slabs(law: PairLaw, attrs_i: Tensors, attrs_j: Tensors,
                  valid_i: torch.Tensor, valid_j: torch.Tensor,
                  radius: float, params: list, gates: list,
                  box: Optional[Sequence[Optional[float]]]) -> Tensors:
    dev = valid_i.device
    c, k = valid_i.shape
    nk = valid_j.shape[1]
    nd = attrs_i[_POS].shape[-1]
    if nd not in (2, 3):
        raise ValueError(f"neighborhood_pair_sweep: {nd}-D positions; the "
                         "kernel takes 2-D and 3-D")
    # the kernel reads each column as a dense array: a view is copied
    names = (_POS, _GID_RANK, _GID_COUNT) + law.float_cols + law.int_cols
    attrs_i = {n: attrs_i[n].contiguous() for n in names}
    attrs_j = {n: attrs_j[n].contiguous() for n in names}
    valid_i, valid_j = valid_i.contiguous(), valid_j.contiguous()

    def columns(side, attrs, valid, n):
        _check(f"valid_{side}", valid, torch.bool, (c, n), dev)
        _check(f"{_POS}_{side}", attrs[_POS], torch.float32, (c, n, nd), dev)
        ptrs = [attrs[_POS].data_ptr()]
        for name in (_GID_RANK, _GID_COUNT):
            _check(f"{name}_{side}", attrs[name], torch.int32, (c, n), dev)
            ptrs.append(attrs[name].data_ptr())
        ptrs.append(valid.data_ptr())
        for names, dtype, slots in ((law.float_cols, torch.float32, 1),
                                    (law.int_cols, torch.int32, 2)):
            for name in names:
                _check(f"{name}_{side}", attrs[name], dtype, (c, n), dev)
                ptrs.append(attrs[name].data_ptr())
            ptrs += [None] * (slots - len(names))
        return (ctypes.c_void_p * 7)(*ptrs)

    cols_i = columns("i", attrs_i, valid_i, k)
    cols_j = columns("j", attrs_j, valid_j, nk)
    outs = {name: torch.empty((c, k) + ((nd,) if per_axis else ()),
                              dtype=torch.float32, device=dev)
            for name, per_axis in law.outputs}
    lib = _slabs_library()
    err = lib.neighborhood_pair_sweep_launch(
        law.law_id, nd, dev.index, ctypes.cast(cols_i, ctypes.c_void_p),
        ctypes.cast(cols_j, ctypes.c_void_p), c, k, nk,
        *_c_args(radius, box, nd, params, gates, outs),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"neighborhood_pair_sweep kernel launch failed: cudaError {err} "
            f"({lib.pair_sweep_error_string(err).decode()})")
    LAUNCHES["neighborhood_pair_sweep"] += 1
    return outs
