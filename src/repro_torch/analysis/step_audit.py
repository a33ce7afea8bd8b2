"""Step audit: run one step of the engine under a recording dispatch mode
and flag hazards (the port's counterpart of ``repro/analysis/
jaxpr_audit.py``).

The reference traces its step with ``jax.make_jaxpr`` and walks the
equations without running them.  An eager engine has no trace to walk, so
the audit *runs* the step, on the engine's own device, and records what
it did:

* **Recording.** Every aten op of one step is seen by a
  ``TorchDispatchMode``; every ``shift`` of the comm is logged with the
  edges it moves data along (``Comm.edges``: the same method ``shift``
  itself uses, so what is checked is what runs).  The probe state
  (:func:`probe_state`) is a seeded population built by
  ``Engine.init_state`` - two agents in every owned cell - not zeros, so
  the step takes the branches a real run takes: emigration across every
  cut, the spawn path, the codec.  ``step[full]`` is a full aura refresh;
  with the codec on, ``step[delta]`` is the delta step after it.
* **What is a host sync.** An op is classified by what it means, not by
  what it costs on the device at hand: ``aten::_local_scalar_dense``
  (``.item()``, ``int()``, ``float()`` and ``bool()`` of a tensor, so any
  Python ``if`` on one), ``nonzero``, ``masked_select``, boolean-mask
  ``index`` / ``index_put``, ``unique``, ``bincount``, ``equal``,
  ``repeat_interleave`` of a tensor of repeats without ``output_size``,
  and a copy from the card to the CPU.  On the CPU they cost nothing, but
  they are flagged all the same: each stalls the card's queue, and none
  can sit in a captured CUDA graph.
* **What sees no op on the CPU.** Some host reads dispatch nothing (or
  only a ``detach``) on a CPU tensor: ``.numpy()``, ``np.asarray``,
  ``.tolist()``, ``.cpu()`` and ``.to("cpu")``.  On the card the last
  three are a device->host copy and are flagged there; ``.numpy()`` and
  ``np.asarray`` of a card tensor raise.  In a behaviour the lint's
  ``hot-numpy`` covers them on any device.  Host->device copies (not
  syncs, but no captured graph holds a copy from pageable memory either)
  are recorded on the card only: a ``_to_copy``/``copy_`` from the CPU,
  and ``torch.tensor``/``torch.as_tensor`` of host data onto the device,
  which copies inside its constructor and is seen as a torch function
  call (a ``TorchFunctionMode``), not as an aten op.
* **Behaviour findings.** Each leaf ``pair_fn`` and ``update_fn`` is called
  directly, under the same mode, on probe tensors of the schema's shapes
  cut from the probe population: on the card a known pair law runs inside
  the ``pair_sweep`` kernel and never calls the Python ``pair_fn``.  A
  host sync there is a ``host-sync`` error, a float64/complex128 output a
  ``dtype-drift`` warning, an ``add``/``sub``/``mul``/``matmul`` carried
  out in int8/int16 an ``int8-overflow`` warning - each located at the
  behaviour's ``file:line`` as the lint locates it, under every audited
  step context (the reference's trace of each step fails on its own).
* **The engine's own syncs are not findings.** The reference's engine is
  one jitted program and has none; the port's come from its Python step
  loop (the per-device loop, the binning's counts).  :func:`audit_step`
  returns them apart, counted by op and by innermost ``repro_torch``
  frame, beside the host->device copies the card records.  Float64 in
  ``core/prng.py`` is deliberate - it reproduces XLA's fused multiply-adds
  (``prng._fma``, ``prng._uniform``) - and is not drift; float64 in any
  other frame is, in the engine or in a behaviour.  Integer arithmetic in
  int8/int16 anywhere in the step is an ``int8-overflow`` finding.
* **collective-matching.** Each logged ``shift``'s edge list is checked
  with the reference's ``ppermute`` rules: unique sources, unique
  destinations, indices in range, and a live mesh axis; partial chains
  (the open halo chains) are legal.  A process of a process mesh logs the
  edges that hold its own device: its ``isend``/``irecv`` peers.
* **cache-key.** ``hash(engine)`` must work and equal
  ``hash(dataclasses.replace(engine))``.

The audit changes nothing of its caller: the probe state is its own, the
kernels' ``LAUNCHES`` counters and a process comm's ``stats`` are restored
afterwards (the probe's launches are reported in
:attr:`StepAudit.launches`).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.contracts import leaf_behaviors
from repro_torch.analysis.diagnostics import Diagnostic

CONTRACT_COLLECTIVE = "collective-matching"
CONTRACT_HOST_SYNC = "host-sync"
CONTRACT_DTYPE = "dtype-drift"
CONTRACT_INT8 = "int8-overflow"
CONTRACT_CACHE = "cache-key"

# Ops that read device memory on the host, whatever the device at hand.
_SYNC_OPS = {
    "aten::_local_scalar_dense":
        "a tensor read as a Python number (.item(), int(), float(), "
        "bool(), a Python `if` on a tensor)",
    "aten::nonzero": "nonzero (its output size is read on the host)",
    "aten::masked_select": "masked_select (its output size is read on "
                           "the host)",
    "aten::_unique": "unique (its output size is read on the host)",
    "aten::_unique2": "unique (its output size is read on the host)",
    "aten::unique_dim": "unique (its output size is read on the host)",
    "aten::unique_consecutive": "unique_consecutive (its output size is "
                                "read on the host)",
    "aten::unique_dim_consecutive": "unique_consecutive (its output size "
                                    "is read on the host)",
    "aten::bincount": "bincount (its length is read on the host)",
    "aten::equal": "torch.equal (a Python bool)",
}
_MASK_INDEX_OPS = {"aten::index", "aten::index_put", "aten::index_put_",
                   "aten::_index_put_impl_"}

# Integer arithmetic that wraps around silently in narrow dtypes (aten
# base names; in-place and out forms included).
_NARROW_ARITH = {"add", "sub", "rsub", "mul", "matmul", "mm", "bmm",
                 "addmm", "dot", "mv"}
_NARROW_DTYPES = (torch.int8, torch.int16)
_WIDE_DTYPES = (torch.float64, torch.complex128)

# Port files whose float64 is deliberate (see the module docstring).
DELIBERATE_WIDE = ("repro_torch/core/prng.py",)

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT_ROOT = os.path.dirname(_PORT_DIR) + os.sep
_SELF = os.path.abspath(__file__)


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------

def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _copy_devices(name: str, args, out):
    """``(source, destination)`` device types of a copy op, else None."""
    if name not in ("aten::_to_copy", "aten::copy_"):
        return None
    src = args[1] if name == "aten::copy_" else args[0]
    dst = args[0] if name == "aten::copy_" else out
    if isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor):
        return src.device.type, dst.device.type
    return None


def _sync_reason(name: str, overload: str, args, kwargs,
                 out) -> Optional[str]:
    if name in _SYNC_OPS:
        return _SYNC_OPS[name]
    if name in _MASK_INDEX_OPS:
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if any(t.dtype in (torch.bool, torch.uint8) for t in _tensors(idx)):
            return "boolean-mask indexing (the mask's count is read on " \
                   "the host)"
    elif name == "aten::repeat_interleave":
        if overload in ("Tensor", "self_Tensor") \
                and kwargs.get("output_size") is None:
            return "repeat_interleave without output_size (its length is " \
                   "read on the host)"
    else:
        ends = _copy_devices(name, args, out)
        if ends is not None and ends[0] != "cpu" and ends[1] == "cpu":
            return "a copy from the device to the CPU"
    return None


def _classify(func, args, kwargs, out) -> List[Tuple[str, str, str]]:
    """``(kind, detail, dtype)`` of each hazard of one op: kind
    ``"sync"``, ``"upload"``, ``"wide"`` or ``"narrow"``."""
    name = func._schema.name
    found = []
    reason = _sync_reason(name, func._overloadname, args, kwargs, out)
    if reason is not None:
        found.append(("sync", reason, ""))
    else:
        ends = _copy_devices(name, args, out)
        if ends is not None and ends[0] == "cpu" and ends[1] != "cpu":
            # not a sync, but no captured graph holds a pageable copy
            found.append(("upload", "a copy from the CPU to the device", ""))
    outs = _tensors(out)
    for t in outs:
        if t.dtype in _WIDE_DTYPES:
            found.append(("wide", "", str(t.dtype).replace("torch.", "")))
            break
    base = name.split("::")[-1].rstrip("_")
    if base in _NARROW_ARITH and outs and outs[0].dtype in _NARROW_DTYPES:
        found.append(("narrow", "", str(outs[0].dtype).replace("torch.", "")))
    return found


def _rel(path: str) -> str:
    return path[len(_PORT_ROOT):] if path.startswith(_PORT_ROOT) else path


@dataclasses.dataclass(frozen=True)
class OpEvent:
    """One hazardous op: ``kind`` (``"sync"``, ``"upload"``, ``"wide"``,
    ``"narrow"``), the aten op, why, the dtype, the innermost frame of the
    code that issued it (``site``, outside torch), the innermost
    ``repro_torch`` frame (``port``) and, where a behaviour's code is on
    the stack, that frame (``behavior``: its function's code and line)."""

    kind: str
    op: str
    detail: str
    dtype: str
    site: Tuple[str, int, str]
    port: Optional[Tuple[str, int, str]]
    behavior: Optional[Tuple[object, int]]

    @property
    def frame(self) -> str:
        """The innermost ``repro_torch`` frame as ``file:line (function)``
        (the issuing site when no port frame is on the stack)."""
        f = self.port or self.site
        return f"{_rel(f[0])}:{f[1]} ({f[2]})"

    @property
    def deliberate(self) -> bool:
        return self.site is not None and _rel(self.site[0]) in \
            DELIBERATE_WIDE


def _where(frame, codes):
    site = port = beh = None
    while frame is not None:
        code = frame.f_code
        if beh is None and code in codes:
            beh = (code, frame.f_lineno)
        fn = os.path.abspath(code.co_filename)
        if not fn.startswith(_TORCH_DIR) and fn != _SELF:
            here = (fn, frame.f_lineno, code.co_name)
            if site is None:
                site = here
            if port is None and fn.startswith(_PORT_DIR + os.sep):
                port = here
        frame = frame.f_back
    return site, port, beh


class _HostData(TorchFunctionMode):
    """``torch.tensor`` / ``torch.as_tensor`` of host data onto a device:
    a host->device copy made inside the constructor, which dispatches no
    aten op the dispatch mode could see."""

    def __init__(self, rec: "_Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.tensor or func is torch.as_tensor:
            data = args[0] if args else kwargs.get("data")
            dev = kwargs.get("device")
            if (dev is not None and torch.device(dev).type != "cpu"
                    and not isinstance(data, torch.Tensor)):
                site, port, beh = _where(sys._getframe(1), self.rec.codes)
                self.rec.events.append(OpEvent(
                    kind="upload", op=f"torch.{func.__name__}",
                    detail="host data copied to the device", dtype="",
                    site=site, port=port, behavior=beh))
        return func(*args, **kwargs)


class _Recorder(TorchDispatchMode):
    """Counts every aten op and keeps the hazardous ones (:class:`OpEvent`),
    with where each was issued from; ``codes`` are the behaviour
    functions' code objects whose frames mark an op as a behaviour's.
    Entering it also enters :class:`_HostData`."""

    def __init__(self, codes=frozenset()):
        super().__init__()
        self.codes = frozenset(codes)
        self.n_ops = 0
        self.events: List[OpEvent] = []
        self._host_data = _HostData(self)

    def __enter__(self):
        self._host_data.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._host_data.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        found = _classify(func, args, kwargs, out)
        if found:
            site, port, beh = _where(sys._getframe(1), self.codes)
            for kind, detail, dtype in found:
                self.events.append(OpEvent(
                    kind=kind, op=func._schema.name, detail=detail,
                    dtype=dtype, site=site, port=port, behavior=beh))
        return out


class _EdgeLog:
    """Logs ``(axis, direction, edges)`` of every ``shift`` of ``comm``
    while entered: an instance attribute wraps the class's ``shift``; a
    process comm logs the pairs that hold its own device."""

    def __init__(self, comm):
        self.comm = comm
        self.log: List[Tuple[int, int, Tuple[Tuple[int, int], ...]]] = []

    def __enter__(self):
        comm, log = self.comm, self.log
        shift = type(comm).shift
        own = getattr(comm, "mesh_coords", None)

        def logged(tree, axis, direction):
            edges = tuple(comm.edges(axis, direction))
            if own is not None:
                me = own[axis]
                edges = tuple(e for e in edges if me in e)
            log.append((axis, direction, edges))
            return shift(comm, tree, axis, direction)

        object.__setattr__(comm, "shift", logged)
        return self

    def __exit__(self, *exc):
        object.__delattr__(self.comm, "shift")
        return False


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

def check_edges(edges, axis, axis_sizes: Dict[str, int],
                context: str = "step") -> List[Diagnostic]:
    """The reference's ``ppermute`` rules on one shift's edge list: the
    axis (a name or a tuple of names) must be live in ``axis_sizes``, and
    ``edges`` a partial permutation over its devices (unique sources,
    unique destinations, all in range)."""
    out = []
    names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    size = 1
    for nm in names:
        if nm not in axis_sizes:
            out.append(Diagnostic(
                severity="error", contract=CONTRACT_COLLECTIVE,
                message=(f"shift over axis {nm!r} which is not a live "
                         f"mesh axis (live: {sorted(axis_sizes) or 'none'})"),
                hint="collectives must name an axis of the spatial mesh "
                     "the step runs under",
                location=f"{context}: shift"))
            return out
        size *= axis_sizes[nm]
    perm = tuple(tuple(e) for e in edges)
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    bad = []
    if len(set(srcs)) != len(srcs):
        bad.append("duplicate sources")
    if len(set(dsts)) != len(dsts):
        bad.append("duplicate destinations")
    if any(not (0 <= v < size) for v in srcs + dsts):
        bad.append(f"indices outside [0, {size})")
    if bad:
        out.append(Diagnostic(
            severity="error", contract=CONTRACT_COLLECTIVE,
            message=(f"shift edge list {perm} over axis "
                     f"{'x'.join(names)} (size {size}) is not a "
                     f"permutation: {', '.join(bad)}"),
            hint="each device may send to at most one destination and "
                 "receive from at most one source",
            location=f"{context}: shift"))
    return out


def audit_edges(log, mesh_shape: Sequence[int],
                context: str = "step") -> List[Diagnostic]:
    """:func:`check_edges` over a logged step's shifts (``(axis index,
    direction, edges)``), the axes named as the reference names them
    (``sx``, ``sy``, ``sz``); an axis index off the mesh is a dead axis."""
    from repro_torch.core.domain import spatial_axis_names

    names = spatial_axis_names(len(mesh_shape))
    sizes = dict(zip(names, (int(m) for m in mesh_shape)))
    out, seen = [], set()
    for axis, direction, edges in log:
        key = (axis, direction, edges)
        if key in seen:
            continue
        seen.add(key)
        name = names[axis] if 0 <= axis < len(names) else f"axis{axis}"
        out.extend(check_edges(edges, name, sizes, context))
    return out


def _diag(ev: OpEvent, location: str) -> Diagnostic:
    if ev.kind == "sync":
        return Diagnostic(
            severity="error", contract=CONTRACT_HOST_SYNC,
            message=(f"`{ev.op}` in the step: {ev.detail} - a device->host "
                     "read on every iteration, stalling the card's queue "
                     "(and no CUDA graph can capture it)"),
            hint="replace host conversions with torch ops (torch.where "
                 "instead of if; keep reductions as tensors)",
            location=location)
    if ev.kind == "wide":
        return Diagnostic(
            severity="warning", contract=CONTRACT_DTYPE,
            message=(f"{ev.op} produces {ev.dtype}: a silent x64 upcast "
                     "doubles memory and wire traffic on this path"),
            hint="pin float32 (check torch.float64 / .double() and "
                 "float64 numpy constants)",
            location=location)
    return Diagnostic(
        severity="warning", contract=CONTRACT_INT8,
        message=(f"{ev.op} computed in {ev.dtype}: narrow integer "
                 "arithmetic wraps around silently (codec deltas must "
                 "accumulate in float32)"),
        hint="widen with .float() before arithmetic, narrow only for the "
             "wire payload",
        location=location)


def _findings(events, locate) -> List[Diagnostic]:
    """Diagnostics of the hazardous events (not deliberate float64, no
    uploads), one per (kind, op, dtype, location)."""
    out, seen = [], set()
    for ev in events:
        if ev.kind == "upload" or (ev.kind == "wide" and ev.deliberate):
            continue
        loc = locate(ev)
        key = (ev.kind, ev.op, ev.dtype, loc)
        if key not in seen:
            seen.add(key)
            out.append(_diag(ev, loc))
    return out


def audit_fn(fn, *example_args, context: str = "fn") -> List[Diagnostic]:
    """Audit an arbitrary function by running it on example arguments
    under the recording mode: its host syncs, float64 outputs and narrow
    integer arithmetic."""
    rec = _Recorder()
    with rec:
        fn(*example_args)
    return _findings(rec.events, lambda ev: context)


def audit_cache_key(engine) -> List[Diagnostic]:
    out = []
    try:
        h0 = hash(engine)
        h1 = hash(dataclasses.replace(engine))
    except TypeError as e:
        return [Diagnostic(
            severity="error", contract=CONTRACT_CACHE,
            message=(f"engine is not hashable ({e}): the built-artifact "
                     "caches (core.compile_cache, CUDA graphs) cannot key "
                     "on it, so every Simulation rebuild rebuilds"),
            hint="Engine fields must be hashable (frozen dataclasses, "
                 "tuples, scalars; Behavior hashes by identity)",
            location="engine")]
    if h0 != h1:
        out.append(Diagnostic(
            severity="error", contract=CONTRACT_CACHE,
            message="hash(engine) is unstable across structurally equal "
                    "copies: built-artifact caches churn one build per "
                    "rebuild",
            hint="check custom __hash__/__eq__ on engine fields",
            location="engine"))
    return out


# ---------------------------------------------------------------------------
# The probe
# ---------------------------------------------------------------------------

PROBE_AGENTS_PER_CELL = 2
PROBE_ROWS = 8      # agents cut from the population for the behaviour probe


def _probe_population(geom, schema, seed: int = 0):
    """``(positions, attrs)`` of the probe: ``min(2, cap)`` agents at
    seeded uniform places inside every cell of the global grid, attrs
    drawn per dtype (floats in [0.5, 1.5), integers and bools in {0, 1})."""
    from repro_torch.core.agent_soa import GID_COUNT, GID_RANK, POS
    from repro_torch.core.agent_soa import numpy_dtype

    rng = np.random.default_rng(seed)
    g = tuple(int(c) for c in geom.global_cells)
    k = max(1, min(PROBE_AGENTS_PER_CELL, int(geom.cap)))
    cells = np.indices(g, dtype=np.float64).reshape(len(g), -1).T
    cells = np.repeat(cells, k, axis=0)
    cs = float(geom.cell_size)
    pos = (cells + rng.uniform(0.05, 0.95, cells.shape)) * cs
    top = np.asarray([np.nextafter(np.float32(s), np.float32(0))
                      for s in geom.domain_size], np.float32)
    pos = np.minimum(pos.astype(np.float32), top)
    n = pos.shape[0]
    attrs = {}
    for name, (shape, dtype) in schema.all_specs(geom.ndim).items():
        if name in (POS, GID_RANK, GID_COUNT):
            continue
        nd = numpy_dtype(dtype)
        size = (n,) + tuple(shape)
        if np.issubdtype(nd, np.floating):
            attrs[name] = rng.uniform(0.5, 1.5, size).astype(nd)
        else:
            attrs[name] = rng.integers(0, 2, size).astype(nd)
    return pos, attrs


def probe_state(engine, mesh=None, seed: int = 0):
    """The audit's seeded population (:func:`_probe_population`) as a
    ``SimState`` built by ``Engine.init_state`` on the engine's device (on
    a process ``mesh``, this rank's block)."""
    pos, attrs = _probe_population(engine.geom, engine.behavior.schema,
                                   seed)
    return engine.init_state(pos, attrs, seed=seed, mesh=mesh)


def _probe_rows(engine, state, comm):
    """Up to :data:`PROBE_ROWS` agents of the comm's first device block,
    live ones first, as flat ``(n, *trailing)`` tensors."""
    from repro_torch.core.engine import device_block

    (c, _), = comm.blocks()[:1]
    blk = device_block(state.soa, c)
    valid = blk.valid.reshape(-1)
    order = torch.argsort((~valid).to(torch.int8), stable=True)[:PROBE_ROWS]
    nd = engine.geom.ndim
    rows = {}
    for name, a in blk.attrs.items():
        flat = a.reshape((-1,) + tuple(a.shape[nd + 1:]))
        rows[name] = flat[order]
    return rows


def _behavior_events(engine, state, comm):
    """Run every leaf ``pair_fn`` and ``update_fn`` on probe tensors under
    the recorder: ``[(path, leaf, events)]``."""
    from repro_torch.core.agent_soa import POS

    nd = engine.geom.ndim
    rows = _probe_rows(engine, state, comm)
    n = next(iter(rows.values())).shape[0]
    lead = (1,) * nd
    attrs_i = {k: v.unsqueeze(1) for k, v in rows.items()}
    attrs_j = {k: v.unsqueeze(0) for k, v in rows.items()}
    disp = attrs_j[POS] - attrs_i[POS]
    dist2 = (disp * disp).sum(dim=-1)
    cells = {k: v.reshape(lead + tuple(v.shape)) for k, v in rows.items()}
    valid = torch.ones(lead + (n,), dtype=torch.bool, device=dist2.device)
    key = state.key.reshape(-1, 2)[0]
    out = []
    for path, leaf in leaf_behaviors(engine.behavior):
        codes = {f.__code__ for f in (leaf.pair_fn, leaf.update_fn)
                 if hasattr(f, "__code__")}
        rec = _Recorder(codes)
        with rec:
            contrib = leaf.pair_fn(dict(attrs_i), dict(attrs_j), disp, dist2,
                                   leaf.params)
        acc = {}
        for name, c in contrib.items():
            extra = max(c.dim() - 2, 0)
            full = torch.broadcast_shapes(c.shape,
                                          dist2.shape + (1,) * extra)
            s = c.expand(full).sum(dim=1)
            acc[name] = s.reshape(lead + tuple(s.shape))
        with rec:
            leaf.update_fn(dict(cells), valid, acc, key, leaf.params,
                           engine.dt)
        out.append((path, leaf, rec.events))
    return out


def _behavior_findings(engine, state, comm) -> List[Diagnostic]:
    """The behaviour probe's findings, located as the lint locates them:
    ``<path>.<fn> (<file>:<line>)`` at the behaviour function's line that
    issued the op."""
    out = []
    for path, leaf, events in _behavior_events(engine, state, comm):
        names = {getattr(leaf.pair_fn, "__code__", None): "pair_fn",
                 getattr(leaf.update_fn, "__code__", None): "update_fn"}

        def locate(ev, path=path, names=names):
            if ev.behavior is None:
                return f"{path} ({ev.frame})"
            code, line = ev.behavior
            return f"{path}.{names[code]} ({code.co_filename}:{line})"

        out.extend(_findings(events, locate))
    return out


# ---------------------------------------------------------------------------
# The engine audit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepAudit:
    """One audit of an engine: its findings, and per step context the
    engine's own host syncs and host->device copies (``Counter``s keyed by
    ``(aten op, innermost repro_torch frame)``), the logged shifts, the
    ops run, the probe steps' kernel launches and the audit's seconds."""

    diagnostics: List[Diagnostic]
    syncs: Dict[str, collections.Counter]
    uploads: Dict[str, collections.Counter]
    edges: Dict[str, list]
    n_ops: Dict[str, int]
    launches: Dict[str, int]
    seconds: float

    def format_syncs(self, context: Optional[str] = None) -> str:
        """The engine's own host syncs and host->device copies of every
        step context (or of ``context``), one line per (op, frame)."""
        lines = []
        for ctx, cnt in self.syncs.items():
            if context is not None and ctx != context:
                continue
            lines.append(f"{ctx}: {sum(cnt.values())} host sync(s), "
                         f"{sum(self.uploads[ctx].values())} host->device "
                         f"copies, {self.n_ops[ctx]} ops")
            for (op, frame), k in sorted(cnt.items(),
                                         key=lambda kv: kv[0][1]):
                lines.append(f"  {k:4d} x {op} at {frame}")
            for (op, frame), k in sorted(self.uploads[ctx].items(),
                                         key=lambda kv: kv[0][1]):
                lines.append(f"  {k:4d} x {op} (host->device) at {frame}")
        return "\n".join(lines)


def _launch_counters():
    from repro_torch.kernels import delta_codec, neighbor_interaction
    return (neighbor_interaction.LAUNCHES, delta_codec.LAUNCHES)


def audit_step(engine, mesh=None, seed: int = 0) -> StepAudit:
    """Run the audit of ``engine`` (on a process ``mesh``, this rank's
    step: every rank calls it): the cache key, one full-refresh step of
    the probe state and, with the codec on, one delta step after it.
    Raises whatever the step raises."""
    t0 = time.perf_counter()
    diags = audit_cache_key(engine)
    counters = _launch_counters()
    saved = [dict(c) for c in counters]
    comm = engine._comm(mesh)
    stats = dict(comm.stats) if hasattr(comm, "stats") else None
    codes = {getattr(f, "__code__", None)
             for _, leaf in leaf_behaviors(engine.behavior)
             for f in (leaf.pair_fn, leaf.update_fn)} - {None}
    variants = [(True, "step[full]")]
    if engine.delta_cfg.enabled:
        variants.append((False, "step[delta]"))
    syncs, uploads, edges, n_ops = {}, {}, {}, {}
    try:
        state = probe_state(engine, mesh, seed)
        beh = _behavior_findings(engine, state, comm)
        for full, context in variants:
            rec = _Recorder(codes)
            with _EdgeLog(comm) as log, rec:
                state = engine.local_step(state, comm, full)
            own = [ev for ev in rec.events if ev.behavior is None]
            syncs[context] = collections.Counter(
                (ev.op, ev.frame) for ev in own if ev.kind == "sync")
            uploads[context] = collections.Counter(
                (ev.op, ev.frame) for ev in own if ev.kind == "upload")
            edges[context] = log.log
            n_ops[context] = rec.n_ops
            diags.extend(audit_edges(log.log, engine.geom.mesh_shape,
                                     context))
            diags.extend(_findings(
                [ev for ev in own if ev.kind in ("wide", "narrow")],
                lambda ev, c=context: f"{c}: {ev.op} ({ev.frame})"))
            diags.extend(dataclasses.replace(
                d, location=f"{context}: {d.location}") for d in beh)
        del state
        launches = {}
        for c, s in zip(counters, saved):
            launches.update({k: v - s.get(k, 0) for k, v in c.items()
                             if v != s.get(k, 0)})
    finally:
        for c, s in zip(counters, saved):
            c.clear()
            c.update(s)
        if stats is not None:
            comm.stats.clear()
            comm.stats.update(stats)
    return StepAudit(diagnostics=diags, syncs=syncs, uploads=uploads,
                     edges=edges, n_ops=n_ops, launches=launches,
                     seconds=time.perf_counter() - t0)


def audit_engine(engine, mesh=None) -> List[Diagnostic]:
    """The step audit's findings (:func:`audit_step`): the cache key, the
    full-refresh step and, when the codec is on, the delta step."""
    return audit_step(engine, mesh).diagnostics
