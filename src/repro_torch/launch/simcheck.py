"""simcheck - the distributed-correctness audit of simulations and of the
repo (port of ``repro/launch/simcheck.py``).

    PYTHONPATH=src python -m repro_torch.launch.simcheck --strict
    PYTHONPATH=src python -m repro_torch.launch.simcheck \
        --sim tumor_spheroid --strict --device cpu
    PYTHONPATH=src python -m repro_torch.launch.simcheck \
        --lint src/repro_torch --format json

Three passes, the reference's:

* **contracts** - stencil soundness, one-hop migration, aura sufficiency,
  codec headroom, partition validity, over each sim's geometry +
  behaviour stack - including *virtual* multi-device variants (an equal
  split and an uneven RCB cut of the same global domain), which run on
  the virtual mesh of the one device, so a sim that ships a
  single-device default still gets its distributed contracts checked.
* **step audit** (``analysis.step_audit``; ``--no-jaxpr`` skips it, the
  reference's flag) - one full-refresh step, and with the codec on one
  delta step, of a seeded probe population on ``--device``, recorded op
  by op: shift edge lists, host syncs, dtype drift, int8 arithmetic,
  cache-key stability.
* **lint** - AST checks over source files and behaviour hot functions.

A bare invocation checks every sim and every ensemble family and lints
the installed ``repro_torch`` package.  Exit code 0 when clean; 1 on any
error (or, with ``--strict``, warning).  ``--device`` is ``cuda`` unless
``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import pathlib
import sys
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis import (
    ContractError,
    Diagnostic,
    Report,
    audit_engine,
    check_engine,
    check_ensemble,
    lint_behavior,
    lint_paths,
    with_context,
)

SIMS = ["cell_clustering", "cell_proliferation", "epidemiology",
        "oncology", "sir_mechanics", "tumor_spheroid"]


def virtual_variants(engine) -> List[Tuple[str, object]]:
    """Multi-device variants of a single-device engine's geometry - an
    equal split and an uneven RCB-style cut over the same global domain,
    each on the virtual mesh of the engine's device."""
    geom = engine.geom
    if geom.n_devices > 1 or geom.partition is not None:
        return []  # already distributed: the base engine covers it
    out: List[Tuple[str, object]] = []
    g = geom.global_cells
    mesh2 = tuple(2 if gc >= 2 and gc % 2 == 0 else 1 for gc in g)
    if any(m > 1 for m in mesh2):
        label = "mesh=" + "x".join(str(m) for m in mesh2)
        out.append((label, dataclasses.replace(
            engine, geom=geom.with_mesh_shape(mesh2))))
    # Uneven two-slab cut per axis with enough cells: the narrower slab
    # tightens the one-hop bound the way a real RCB plan would.
    widths = []
    for gc in g:
        if gc >= 4:
            lo = gc // 2 - 1
            widths.append((lo, gc - lo))
        elif gc >= 3:
            widths.append((1, gc - 1))
        else:
            widths.append((gc,))
    from repro_torch.core import Partition
    part = Partition.from_widths(widths)
    if any(len(w) > 1 for w in widths) and not part.is_equal:
        out.append(("rcb=" + "/".join(
            "+".join(str(v) for v in w) for w in widths),
            dataclasses.replace(engine, geom=geom.repartition(part))))
    return out


def check_simulation(sim, *, jaxpr: bool = True,
                     variants: bool = True) -> Report:
    """Full simcheck over a built :class:`repro_torch.core.Simulation`: the
    base engine plus (optionally) its virtual distributed variants."""
    rep = Report()
    rep.extend(check_engine(sim.engine, sim.mesh))
    rep.extend(lint_behavior(sim.behavior))
    if jaxpr:
        rep.extend(audit_engine(sim.engine, sim.mesh))
    if variants:
        for label, eng in virtual_variants(sim.engine):
            diags = check_engine(eng)
            if jaxpr:
                diags = diags + audit_engine(eng)
            rep.extend(with_context(diags, label))
    return rep


def check_sim_module(name: str, *, jaxpr: bool = True,
                     variants: bool = True, device="cuda") -> Report:
    """Build ``repro_torch.sims.<name>.simulation(device=device)`` and
    simcheck it.  A construction-time :class:`ContractError` (the facade's
    own gate) becomes the report's findings instead of a stack trace."""
    mod = importlib.import_module(f"repro_torch.sims.{name}")
    try:
        sim = mod.simulation(device=device)
    except ContractError as e:
        rep = Report()
        rep.extend(with_context(e.diagnostics, f"sims.{name}"))
        return rep
    rep = check_simulation(sim, jaxpr=jaxpr, variants=variants)
    rep.diagnostics = with_context(rep.diagnostics, f"sims.{name}")
    return rep


def ensemble_families() -> List[str]:
    """Sims that publish an ensemble compatibility family (a module-level
    ``ensemble_family()`` factory, see core.ensemble)."""
    out = []
    for name in SIMS:
        mod = importlib.import_module(f"repro_torch.sims.{name}")
        if hasattr(mod, "ensemble_family"):
            out.append(name)
    return out


def check_ensemble_module(name: str, device="cuda") -> Report:
    """Batch-safety contract over a sim's published ensemble family - the
    same :func:`repro_torch.analysis.check_ensemble` pass the scenario
    server runs before admitting a family's requests."""
    rep = Report()
    mod = importlib.import_module(f"repro_torch.sims.{name}")
    fam = getattr(mod, "ensemble_family", None)
    if fam is None:
        rep.add(Diagnostic(
            severity="info", contract="ensemble-batch-safe",
            message=f"sims.{name} publishes no ensemble family "
                    "(no ensemble_family() factory)",
            location=f"sims.{name}"))
        return rep
    rep.extend(with_context(check_ensemble(fam(device=device)),
                            f"ensemble.{name}"))
    return rep


def _default_lint_root() -> str:
    import repro_torch
    return str(pathlib.Path(repro_torch.__file__).parent)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.simcheck",
        description="static contract checker, step auditor, and repo "
                    "lint")
    ap.add_argument("--sim", action="append", default=[],
                    choices=SIMS + ["all"], metavar="SIM",
                    help="sim to check (repeatable; 'all' checks every "
                         f"shipped sim: {', '.join(SIMS)})")
    ap.add_argument("--lint", nargs="*", metavar="PATH",
                    help="lint source paths (flag alone lints the "
                         "installed repro_torch package)")
    ap.add_argument("--ensemble", action="append", default=[],
                    choices=SIMS + ["all"], metavar="SIM",
                    help="check a sim's ensemble family for batch "
                         "safety ('all' checks every published family)")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail (errors always do)")
    ap.add_argument("--format", default="text", choices=["text", "json"])
    ap.add_argument("--no-jaxpr", action="store_true",
                    help="skip the step audit (the reference's name for "
                         "its jaxpr audit; faster)")
    ap.add_argument("--no-variants", action="store_true",
                    help="skip the virtual multi-device variants")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the sims are built and the step audit "
                         "runs")
    args = ap.parse_args(argv)

    sims = list(args.sim)
    if "all" in sims:
        sims = SIMS
    ensembles = list(args.ensemble)
    if "all" in ensembles:
        ensembles = ensemble_families()
    if not sims and args.lint is None and not ensembles:
        # bare invocation: audit everything
        sims = SIMS
        ensembles = ensemble_families()
        args.lint = []

    rep = Report()
    if args.lint is not None:
        paths = list(args.lint) or [_default_lint_root()]
        rep.extend(lint_paths(paths))
    for name in sims:
        rep.extend(check_sim_module(
            name, jaxpr=not args.no_jaxpr,
            variants=not args.no_variants, device=args.device))
    for name in ensembles:
        rep.extend(check_ensemble_module(name, device=args.device))

    out = rep.format_json() if args.format == "json" else rep.format_text()
    print(out)
    return rep.exit_code(strict=args.strict)


if __name__ == "__main__":
    sys.exit(main())
