"""The static contract checker (port of ``repro/analysis/contracts.py``):
Domain x Partition x behaviour-stack invariants the engine's distributed
correctness rests on.

* **stencil-soundness** - every ``Behavior.radius`` must be <= the
  Domain's ``cell_size``: the ``3**ndim`` sweep only visits adjacent cells.
* **aura-sufficiency** - on a multi-device mesh the same bound keeps every
  remote neighbour inside the one-cell aura ring.
* **one-hop-migration** - per-step displacement must stay under
  ``min_slab_width_cells(axis) * cell_size`` on every sharded axis (narrow
  RCB slabs tighten it).
* **codec-headroom** - a *fixed* delta-codec scale must represent the
  worst-case per-step displacement (``scale * qmax``).
* **partition-validity** - positive cell size, cut coverage, padded-grid
  overhead, devices available.
* **supervised-recovery** - guard policy and checkpoint cadence of a
  supervised run (:func:`check_supervision`).

Displacement bounds come from the behaviour's parameters, per leaf and
summed over a composed stack: a declared ``max_displacement`` (hard),
``params["max_step"]`` (hard), ``params["sigma"]`` and a spawning
behaviour's ``params["div_offset"]`` (stochastic, at 4 sigma).  A bound
with an unrecognised term is *unknown* and gives an info finding.

The diagnostics are the reference's word for word, with one mapping of
the device count (:func:`check_partition`): the virtual mesh holds every
device of the Domain on one card, so it never lacks one; a process mesh
(one process a device) compares the Domain's device count with the
``torch.distributed`` world size.

:func:`check_ensemble` is the ensemble family's batch-safety contract,
which the scenario server runs at admission, all four of the reference's
passes.  ``Simulation.validate`` and ``launch.simcheck`` run
:func:`check_engine` beside the lint (``analysis.lint``) and the step
audit (``analysis.step_audit``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Tuple

import torch

from repro_torch.analysis.diagnostics import Diagnostic

CONTRACT_STENCIL = "stencil-soundness"
CONTRACT_AURA = "aura-sufficiency"
CONTRACT_ONE_HOP = "one-hop-migration"
CONTRACT_HEADROOM = "codec-headroom"
CONTRACT_PARTITION = "partition-validity"
CONTRACT_SUPERVISION = "supervised-recovery"
CONTRACT_ENSEMBLE = "ensemble-batch-safe"
CONTRACT_ENSEMBLE_FACTORY = "ensemble-factory-static"

# severity ordering for displacement-bound kinds
_KIND_RANK = {"hard": 0, "stochastic": 1, "unknown": 2}

# Gaussian tail quantile used to bound stochastic per-step displacements.
SIGMA_QUANTILE = 4.0


@dataclasses.dataclass(frozen=True)
class DisplacementBound:
    """Worst-case per-step, per-component displacement of a behaviour
    stack: ``kind`` is "hard" (a provable clamp), "stochastic" (a
    ``SIGMA_QUANTILE`` tail bound) or "unknown" (a term is unverifiable;
    ``value`` then sums the known terms only)."""

    value: float
    kind: str
    detail: str


def _leaf_bound(behavior) -> DisplacementBound:
    declared = getattr(behavior, "max_displacement", None)
    if declared is not None:
        return DisplacementBound(float(declared), "hard",
                                 "declared max_displacement")
    params = behavior.params
    terms: List[Tuple[float, str, str]] = []  # (value, kind, label)
    if "max_step" in params:
        terms.append((float(params["max_step"]), "hard", "max_step"))
    if "sigma" in params:
        v = SIGMA_QUANTILE * float(params["sigma"])
        terms.append((v, "stochastic", f"{SIGMA_QUANTILE:g}*sigma"))
    unknown = []
    if behavior.can_spawn:
        if "div_offset" in params:
            v = SIGMA_QUANTILE * float(params["div_offset"])
            terms.append((v, "stochastic", f"{SIGMA_QUANTILE:g}*div_offset"))
        else:
            unknown.append("spawn offset not declared "
                           "(no div_offset param)")
    if not terms and not unknown:
        unknown.append("no recognized displacement params "
                       "(max_step / sigma / div_offset)")
    value = sum(v for v, _, _ in terms)
    detail = " + ".join(f"{lbl}={v:g}" for v, _, lbl in terms) or "0"
    if unknown:
        return DisplacementBound(value, "unknown",
                                 detail + "; " + "; ".join(unknown))
    kind = max((k for _, k, _ in terms), key=_KIND_RANK.__getitem__)
    return DisplacementBound(value, kind, detail)


def displacement_bound(behavior, dt: float = 1.0) -> DisplacementBound:
    """Worst-case per-step displacement of a (possibly composed)
    behaviour: a stack sums its children's bounds (updates chain within a
    step), its kind the weakest child's.  ``dt`` is accepted for symmetry
    with the engine: the recognised parameters are per-step quantities."""
    children = tuple(getattr(behavior, "children", ()) or ())
    if not children:
        return _leaf_bound(behavior)
    bounds = [displacement_bound(c, dt) for c in children]
    value = sum(b.value for b in bounds)
    kind = max((b.kind for b in bounds), key=_KIND_RANK.__getitem__)
    detail = " + ".join(f"b{i}({b.detail})" for i, b in enumerate(bounds))
    return DisplacementBound(value, kind, detail)


def leaf_behaviors(behavior, path: str = "behavior"):
    """Yield ``(path, leaf)`` for every leaf of a composed behaviour."""
    children = tuple(getattr(behavior, "children", ()) or ())
    if not children:
        yield path, behavior
        return
    for i, child in enumerate(children):
        yield from leaf_behaviors(child, f"{path}.b{i}")


def min_slab_width_cells(geom, axis: int) -> int:
    """Narrowest owned slab along ``axis``, in cells."""
    if geom.partition is not None:
        return min(geom.partition.widths[axis])
    return geom.interior[axis]


def _behavior_label(behavior, path: str) -> str:
    fn = getattr(behavior, "update_fn", None)
    name = getattr(fn, "__name__", None)
    return f"{path} ({name})" if name else path


# ---------------------------------------------------------------------------
# The contract checks
# ---------------------------------------------------------------------------

def check_stencil(geom, behavior) -> List[Diagnostic]:
    """radius <= cell_size per leaf behaviour, plus the multi-device aura
    framing of the same bound."""
    out = []
    sharded = geom.n_devices > 1
    for path, leaf in leaf_behaviors(behavior):
        r = float(leaf.radius)
        if r > float(geom.cell_size):
            loc = _behavior_label(leaf, path)
            out.append(Diagnostic(
                severity="error", contract=CONTRACT_STENCIL,
                message=(f"interaction radius {r:g} exceeds cell_size "
                         f"{geom.cell_size:g}: the {3 ** geom.ndim}-cell "
                         "neighborhood sweep only sees adjacent cells, so "
                         "pairs between non-adjacent cells are silently "
                         "dropped"),
                hint=(f"raise cell_size to >= {r:g} (one cell must cover "
                      "the interaction radius) or reduce the behavior's "
                      "radius"),
                location=loc))
            if sharded:
                out.append(Diagnostic(
                    severity="error", contract=CONTRACT_AURA,
                    message=(f"radius {r:g} does not fit the one-cell aura "
                             f"ring ({geom.cell_size:g} world units): "
                             "remote neighbors beyond the ring are never "
                             "exchanged, so cross-device pairs past "
                             "cell_size are invisible"),
                    hint=("the aura ring is one cell wide by construction; "
                          f"raise cell_size to >= {r:g}"),
                    location=loc))
    return out


def check_one_hop(geom, behavior, dt: float = 1.0) -> List[Diagnostic]:
    """Per-step displacement vs the narrowest owned slab, per sharded
    axis."""
    out = []
    constrained = [a for a in range(geom.ndim) if geom.mesh_shape[a] > 1]
    if not constrained:
        return out
    bound = displacement_bound(behavior, dt)
    if bound.kind == "unknown":
        out.append(Diagnostic(
            severity="info", contract=CONTRACT_ONE_HOP,
            message=("per-step displacement bound is unverifiable "
                     f"({bound.detail}); the one-hop migration contract "
                     "cannot be checked statically"),
            hint=("declare Behavior(max_displacement=...) with the "
                  "worst-case per-step displacement, or carry max_step / "
                  "sigma / div_offset in params"),
            location=_behavior_label(behavior, "behavior")))
        return out
    severity = "error" if bound.kind == "hard" else "warning"
    for a in constrained:
        width = min_slab_width_cells(geom, a)
        limit = width * float(geom.cell_size)
        if bound.value >= limit:
            what = ("hard displacement bound" if bound.kind == "hard" else
                    f"{SIGMA_QUANTILE:g}-sigma displacement bound")
            out.append(Diagnostic(
                severity=severity, contract=CONTRACT_ONE_HOP,
                message=(f"axis {a}: {what} {bound.value:g} "
                         f"({bound.detail}) reaches the narrowest owned "
                         f"slab ({width} cells = {limit:g} world units); "
                         "an agent crossing a whole slab in one step "
                         "skips the intermediate device, lands in the "
                         "receiver's migration ring, and is destroyed by "
                         "the next aura rebuild"),
                hint=("reduce the per-step displacement (max_step / sigma "
                      "/ dt), widen the narrowest partition slab, or use "
                      f"fewer devices along axis {a}"),
                location=_behavior_label(behavior, "behavior")))
    return out


def _iinfo(qdtype) -> torch.iinfo:
    """The integer range of a codec dtype (a torch dtype, or a numpy
    dtype or its name)."""
    if not isinstance(qdtype, torch.dtype):
        import numpy as np
        qdtype = getattr(torch, np.dtype(qdtype).name)
    return torch.iinfo(qdtype)


def check_codec_headroom(geom, behavior, delta_cfg,
                         dt: float = 1.0) -> List[Diagnostic]:
    """Fixed quantization scale vs the worst-case per-step delta."""
    out = []
    if delta_cfg is None or not delta_cfg.enabled:
        return out
    scale = getattr(delta_cfg, "scale", None)
    if scale is None:
        return out  # adaptive per-slab scale: clipping impossible
    info = _iinfo(delta_cfg.qdtype)
    qmax = float(info.max)
    representable = float(scale) * qmax
    bound = displacement_bound(behavior, dt)
    if bound.kind == "unknown":
        out.append(Diagnostic(
            severity="info", contract=CONTRACT_HEADROOM,
            message=(f"fixed delta scale {scale:g} (representable delta "
                     f"{representable:g}) cannot be checked: per-step "
                     f"displacement bound is unverifiable ({bound.detail})"),
            hint="declare Behavior(max_displacement=...)",
            location="delta_cfg"))
        return out
    if bound.value <= 0:
        return out
    headroom = representable / bound.value
    if headroom < 1.0:
        out.append(Diagnostic(
            severity="error", contract=CONTRACT_HEADROOM,
            message=(f"fixed delta scale {scale:g} represents at most "
                     f"+/-{representable:g} per step, but the worst-case "
                     f"per-step displacement is {bound.value:g} "
                     f"({bound.detail}): headroom {headroom:.2f} < 1.0, "
                     "the int"
                     f"{info.bits} encode will "
                     "clip deltas silently"),
            hint=(f"raise scale to >= {bound.value / qmax:g}, or drop "
                  "scale=None to use the adaptive per-slab scale"),
            location="delta_cfg"))
    elif headroom < 1.5:
        out.append(Diagnostic(
            severity="warning", contract=CONTRACT_HEADROOM,
            message=(f"fixed delta scale {scale:g}: headroom "
                     f"{headroom:.2f} over the worst-case per-step "
                     f"displacement {bound.value:g} leaves little margin "
                     "before the quantizer clips"),
            hint=f"consider scale >= {1.5 * bound.value / qmax:g}",
            location="delta_cfg"))
    return out


def check_partition(geom, mesh=None) -> List[Diagnostic]:
    """Geometry / partition sanity.  Devices: the virtual mesh (``mesh``
    None) holds the whole Domain on one card and never lacks one; a
    process ``mesh`` needs one rank a device of the world group."""
    out = []
    if float(geom.cell_size) <= 0:
        out.append(Diagnostic(
            severity="error", contract=CONTRACT_PARTITION,
            message=f"cell_size {geom.cell_size!r} must be positive",
            hint="set cell_size to at least the max interaction radius",
            location="geom"))
        return out
    part = geom.partition
    if part is not None:
        for a, cuts in enumerate(part.cuts):
            if cuts[-1] != geom.global_cells[a]:
                out.append(Diagnostic(
                    severity="error", contract=CONTRACT_PARTITION,
                    message=(f"axis {a} cuts {cuts} end at {cuts[-1]} but "
                             f"the global grid has "
                             f"{geom.global_cells[a]} cells"),
                    hint="partition cuts must cover the global cell grid",
                    location="geom.partition"))
        pad = part.pad_fraction()
        if pad > 1.0:
            out.append(Diagnostic(
                severity="info", contract=CONTRACT_PARTITION,
                message=(f"padded per-device grids allocate "
                         f"{pad:.0%} more cells than are owned "
                         "(docs/load_balancing.md memory model)"),
                hint=("prefer cuts with less width spread, or a larger "
                      "box_factor"),
                location="geom.partition"))
    n_dev = geom.n_devices
    if n_dev > 1 and mesh is not None:
        import torch.distributed as dist
        have = dist.get_world_size() if dist.is_initialized() else 1
        if have < n_dev:
            out.append(Diagnostic(
                severity="info", contract=CONTRACT_PARTITION,
                message=(f"geometry spans {n_dev} devices but the process "
                         f"group holds {have} ranks; a process mesh runs "
                         "one rank a device"),
                hint="static checks still apply; only execution needs "
                     "the ranks",
                location="geom"))
    return out


def check_supervision(engine, supervised) -> List[Diagnostic]:
    """Guard policy vs checkpoint cadence of a supervised run
    (``launch.supervise``): rollback triggers only on something raising,
    so supervising an unguarded run is an error."""
    out = []
    policy = getattr(getattr(engine, "guards", None), "policy", "off")
    if policy == "off":
        out.append(Diagnostic(
            severity="error", contract=CONTRACT_SUPERVISION,
            message=("supervised run with guard policy 'off': silent "
                     "corruption (NaN burst, lost or corrupted halo "
                     "slab, conservation break) is never detected, so "
                     "periodic checkpoints can capture corrupted state "
                     "and rollback restores the corruption"),
            hint=("construct the Simulation with guards=\"error\" (or a "
                  "GuardConfig with policy=\"error\") so guard trips "
                  "raise HealthError at the next host control point"),
            location="supervised"))
    elif policy == "warn":
        out.append(Diagnostic(
            severity="warning", contract=CONTRACT_SUPERVISION,
            message=("supervised run with guard policy 'warn': trips are "
                     "logged but never raise, so the supervisor only "
                     "rolls back on hard exceptions (device loss, "
                     "injected raises) — guard-detected corruption "
                     "passes through into the next checkpoint"),
            hint="use guards=\"error\" for rollback on guard trips",
            location="supervised"))
    keep = int(getattr(supervised, "keep", 0) or 0)
    if keep < 2:
        out.append(Diagnostic(
            severity="warning", contract=CONTRACT_SUPERVISION,
            message=(f"checkpoint retention keep={keep}: a single torn "
                     "or corrupted write leaves no verified checkpoint "
                     "to roll back to"),
            hint="keep at least 2 checkpoints on a supervised run",
            location="supervised"))
    every = int(getattr(supervised, "every", 0) or 0)
    if every < 1:
        out.append(Diagnostic(
            severity="error", contract=CONTRACT_SUPERVISION,
            message=f"checkpoint cadence every={every} must be >= 1",
            hint="set Supervised(every=N) with N >= 1",
            location="supervised"))
    return out


def _check_mode(mode: str) -> None:
    if mode not in ("off", "warn", "error"):
        raise ValueError(
            f"check mode {mode!r} not in ('off', 'warn', 'error')")


def enforce_diagnostics(diagnostics: List[Diagnostic],
                        mode: str = "error") -> List[Diagnostic]:
    """Gate a diagnostic list as :func:`enforce` gates the engine's:
    error findings raise (``mode="error"``) or warn (``"warn"``);
    warnings and infos never gate.  Returns the errors."""
    _check_mode(mode)
    if mode == "off":
        return []
    errors = [d for d in diagnostics if d.severity == "error"]
    if not errors:
        return []
    if mode == "error":
        raise ContractError(errors)
    for d in errors:
        warnings.warn(f"simcheck contract: {d.format()}", stacklevel=3)
    return errors


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def check_contracts(geom, behavior, delta_cfg=None, dt: float = 1.0,
                    mesh=None) -> List[Diagnostic]:
    """Every static contract over a (geom, behaviour, delta) triple;
    ``mesh`` is the run's process mesh, or None for the virtual mesh."""
    out: List[Diagnostic] = []
    out.extend(check_partition(geom, mesh))
    out.extend(check_stencil(geom, behavior))
    out.extend(check_one_hop(geom, behavior, dt))
    out.extend(check_codec_headroom(geom, behavior, delta_cfg, dt))
    return out


def check_engine(engine, mesh=None) -> List[Diagnostic]:
    """Contract pass over an :class:`~repro_torch.core.engine.Engine`
    (duck-typed)."""
    return check_contracts(engine.geom, engine.behavior, engine.delta_cfg,
                           engine.dt, mesh)


class ContractError(ValueError):
    """Raised by :func:`enforce` when error-severity contracts fail; the
    findings are in ``self.diagnostics``."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        lines = [d.format() for d in self.diagnostics]
        super().__init__(
            "simulation contracts violated "
            "(pass check=\"warn\" or check=\"off\" to bypass):\n"
            + "\n".join(lines))


def enforce(engine, mode: str = "error", mesh=None) -> List[Diagnostic]:
    """Construction-time gate: raise (or warn) on error-severity findings
    of :func:`check_engine`.  Only definite hazards gate; warnings and
    infos never do."""
    _check_mode(mode)
    if mode == "off":
        return []
    return enforce_diagnostics(check_engine(engine, mesh), mode)


# ---------------------------------------------------------------------------
# Ensemble batch-safety (core.ensemble / launch.serve)
# ---------------------------------------------------------------------------

def _fn_label(fn) -> str:
    mod = getattr(fn, "__module__", "")
    name = getattr(fn, "__qualname__", getattr(fn, "__name__", repr(fn)))
    return f"{mod}.{name}" if mod else name


# What plays the part of the reference's host callbacks (``pure_callback``,
# ``io_callback``, ``host_callback``, ``callback``, ``debug_callback``:
# Python run on the host with an array's values) in a torch behaviour: the
# calls that bring a tensor's values to the host for Python to use -
# ``.cpu()``, ``.numpy()`` and ``.tolist()``.  Inside an ensemble step
# each fires once per lane per step and stalls the card's queue.
_HOST_CALLBACK_NAMES = {"cpu", "numpy", "tolist"}


def _scan_host_callbacks(behavior, name: str) -> List[Diagnostic]:
    import ast
    import inspect
    import textwrap

    out: List[Diagnostic] = []

    def scan_fn(fn, label):
        try:
            src = textwrap.dedent(inspect.getsource(fn))
            tree = ast.parse(src)
        except (OSError, TypeError, SyntaxError):
            return
        code = getattr(fn, "__code__", None)
        filename = code.co_filename if code else "<source>"
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            attr = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None)
            if attr in _HOST_CALLBACK_NAMES:
                out.append(Diagnostic(
                    severity="error", contract=CONTRACT_ENSEMBLE,
                    message=(f"host callback `{attr}` in a behavior "
                             "kernel: under the ensemble runner it copies "
                             "every lane's values to the host on every "
                             "step"),
                    hint="compute on-device with torch ops; read metrics "
                         "through per-replica reducers "
                         "(operations.batch_*) at segment boundaries",
                    location=f"{label} ({filename}:{node.lineno})"))

    for path, leaf in leaf_behaviors(behavior, name):
        scan_fn(leaf.pair_fn, f"{path}.pair_fn")
        scan_fn(leaf.update_fn, f"{path}.update_fn")
    return out


def check_ensemble(ensemble) -> List[Diagnostic]:
    """Batch-safety contract of one ensemble family (duck-typed: needs
    ``behavior_fn``, ``param_names`` and ``proto_engine()``); the
    reference's four passes:

    1. the solo engine contracts over the family's proto engine;
    2. a probe of the behaviour factory with every parameter a *two-lane*
       float32 tensor - torch's counterpart of the reference's abstract
       tracer: ``float()`` or an ``if`` on a two-element tensor raises, so
       a factory that concretizes or branches on a parameter is caught;
    3. structural stability: the behaviour built at 0.25 and at 0.75 must
       agree on schema, radius, pair attrs, accumulators and spawn;
    4. the hot-path lint re-run with ``params`` holding agent data (the
       ensemble's lanes hold parameters as per-lane tensors,
       ``core.ensemble``, so a Python branch on one reads every lane to
       the host), every finding escalated to an ``ensemble-batch-safe``
       error, and the scan for host callbacks (:data:`_HOST_CALLBACK_NAMES`).
    """
    label = _fn_label(ensemble.behavior_fn)
    try:
        proto = ensemble.proto_engine()
    except Exception as e:  # noqa: BLE001 - any factory failure is a finding
        return [Diagnostic(
            severity="error", contract=CONTRACT_ENSEMBLE_FACTORY,
            message=f"behavior factory failed at the zero parameter "
                    f"point: {type(e).__name__}: {e}",
            hint="the factory must build at any parameter value - "
                 "structure may not depend on the point",
            location=label)]
    out: List[Diagnostic] = list(check_engine(proto))

    names = tuple(ensemble.param_names)
    probe = {n: torch.tensor([0.25, 0.75]) for n in names}
    try:
        ensemble.behavior_fn(probe)
    except Exception as e:  # noqa: BLE001
        msg = str(e).splitlines()[0] if str(e) else type(e).__name__
        out.append(Diagnostic(
            severity="error", contract=CONTRACT_ENSEMBLE_FACTORY,
            message=(f"behavior factory concretizes a per-replica "
                     f"parameter ({type(e).__name__}: {msg})"),
            hint="parameters are per-lane values under the ensemble "
                 "runner: no float()/if on them; keep radii and shapes "
                 "static and gate numerically inside the kernel",
            location=label))
        return out  # the remaining probe needs a working factory

    lo = ensemble.behavior_fn({n: 0.25 for n in names})
    hi = ensemble.behavior_fn({n: 0.75 for n in names})
    drift = []
    if lo.schema != hi.schema:
        drift.append("schema")
    if float(lo.radius) != float(hi.radius):
        drift.append("radius")
    if tuple(lo.pair_attrs) != tuple(hi.pair_attrs):
        drift.append("pair_attrs")
    if sorted(lo.acc_spec) != sorted(hi.acc_spec):
        drift.append("accumulators")
    if bool(lo.can_spawn) != bool(hi.can_spawn):
        drift.append("can_spawn")
    if drift:
        out.append(Diagnostic(
            severity="error", contract=CONTRACT_ENSEMBLE_FACTORY,
            message=("behavior structure varies with the parameter "
                     f"point ({', '.join(drift)}): replicas of one "
                     "family must share one structure"),
            hint="move structural choices (schema, radii, accumulator "
                 "specs) out of the swept parameters",
            location=label))

    from repro_torch.analysis.lint import lint_behavior
    for d in lint_behavior(lo, "ensemble",
                           static_args={"dt", "self", "cls"}):
        out.append(Diagnostic(
            severity="error", contract=CONTRACT_ENSEMBLE,
            message=f"[{d.contract}] {d.message} (params are per-lane "
                    "tensors under the ensemble runner)",
            hint=d.hint, location=d.location))

    out.extend(_scan_host_callbacks(lo, "ensemble"))
    return out
