"""Scenario server: simulation-as-a-service over the ensemble runner
(port of ``repro/launch/serve.py``).

The batching loop that serves an LM (collect requests, batch compatible
ones, run one step, stream tokens back) applies to simulations - the
"token" is a per-step metric frame and the "model" is an ensemble runner.
This module is that loop for agent-based scenarios:

* clients :meth:`~ScenarioServer.submit` scenario requests - a *family*
  name, a parameter point, a step budget, and a streaming cadence;
* the server groups queued requests of one compatibility family into an
  ensemble **slot** (up to ``slot_size`` lanes, partial slots padded with
  inert lanes so one runner covers every fill level);
* each batch runs through the family's cached runner
  (:mod:`repro_torch.core.ensemble`: on the card, one ``pair_sweep``
  launch over every lane a step) in segments whose boundaries are the
  union of every member's streaming points, so a request streams its
  frames while batch-mates with different budgets ride the same steps;
* per-request metric frames come from per-lane reducers
  (``operations.batch_*``, one host read a frame) - lane ``r``'s frame is
  untouched by its batch neighbours;
* incompatible requests - unknown family, unknown parameter, or a family
  whose :func:`repro_torch.analysis.check_ensemble` contract fails - are
  **rejected at submit time with the diagnostics**, never with an error
  mid-batch;
* :meth:`~ScenarioServer.stats` reports queue depth, batch occupancy,
  and the hit/miss counters of every cache
  (:mod:`repro_torch.core.compile_cache`).

The server is in-process and synchronous - ``pump()`` runs one batch,
``drain()`` runs until the queue is empty.  Over a process mesh
(``ScenarioServer(mesh=)``, one process a device) every rank builds the
same server and submits the same requests: each rank steps its own
device's block of every lane, and each frame is its per-lane metric
summed over the ranks (``sum_over_all_ranks``), so every rank streams the
same frames; a family's metric must then add over devices (counts,
sums).  ``--smoke`` exercises the
whole loop: three compatible requests batched into one padded slot plus
one incompatible request rejected with its diagnostic.  It runs on the
card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import Diagnostic, check_ensemble
from repro_torch.core import operations
from repro_torch.core.compile_cache import cache_stats
from repro_torch.core.ensemble import Ensemble


# ---------------------------------------------------------------------------
# Families, requests, results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScenarioFamily:
    """One servable compatibility family.

    ``init_point(ensemble, seed)`` builds the solo :class:`SimState` of a
    single request (structure - agent count, schema, geometry - is fixed
    per family; only the parameter point and seed vary); a server over a
    process mesh calls ``init_point(ensemble, seed, mesh=mesh)`` for this
    rank's block.  ``metric`` reduces a *stacked* state to per-lane
    frames, ``(R, ...)``: lane ``r``'s row is request ``r``'s frame.
    """

    name: str
    ensemble: Ensemble
    init_point: Callable[[Ensemble, int], Any]
    metric: Callable[[Any], np.ndarray]
    defaults: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ScenarioRequest:
    family: str
    params: Dict[str, float]
    steps: int
    stream_every: int = 0        # 0: final frame only
    seed: int = 0


@dataclasses.dataclass
class RequestHandle:
    """Server-side record of one request's life."""

    rid: int
    request: ScenarioRequest
    status: str = "queued"       # queued | running | done | rejected
    frames: List[Any] = dataclasses.field(default_factory=list)
    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    finished_at: float = 0.0

    @property
    def latency_s(self) -> float:
        if self.finished_at <= 0:
            return 0.0
        return self.finished_at - self.submitted_at


def sir_mechanics_family(n_agents: int = 400, initial_infected: int = 20,
                         interior=(8, 8), mesh_shape=(1, 1),
                         name: str = "sir_mechanics",
                         device="cuda") -> ScenarioFamily:
    """The shipped SIR-with-mechanics family: sweeps infection and
    mechanics knobs, streams per-lane S/I/R compartment counts."""
    from repro_torch.sims import sir_mechanics as sm

    ens = sm.ensemble_family(interior=interior, mesh_shape=mesh_shape,
                             device=device)
    return ScenarioFamily(
        name=name, ensemble=ens,
        init_point=lambda e, seed, mesh=None: sm.ensemble_point_state(
            e, seed=seed, n_agents=n_agents,
            initial_infected=initial_infected, mesh=mesh),
        metric=operations.batch_attr_counts("state", (sm.S, sm.I, sm.R)),
        defaults=sm.ensemble_defaults())


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

class ScenarioServer:
    """Batching scenario server over registered ensemble families."""

    def __init__(self, families: Sequence[ScenarioFamily] = (),
                 slot_size: int = 8, mesh=None):
        # mesh: a process mesh (one process a device, shaped like every
        # family's Domain mesh); the family's own virtual mesh needs none
        if slot_size < 1:
            raise ValueError(f"slot_size must be >= 1, got {slot_size}")
        self.slot_size = int(slot_size)
        self.mesh = mesh
        self._families: Dict[str, ScenarioFamily] = {}
        self._admission: Dict[str, List[Diagnostic]] = {}
        self._queues: Dict[str, deque] = {}
        self._handles: Dict[int, RequestHandle] = {}
        self._next_rid = 0
        self._batches = 0
        self._occupancy_sum = 0.0
        for f in families:
            self.register(f)

    # -- registration / admission -------------------------------------

    def register(self, family: ScenarioFamily) -> List[Diagnostic]:
        """Register a family; its batch-safety contract
        (:func:`check_ensemble`) runs ONCE here and gates every later
        submit.  Returns the findings (errors make the family
        unservable, not unregistered - submits get the diagnostics)."""
        if family.name in self._families:
            raise ValueError(f"family {family.name!r} already registered")
        diags = check_ensemble(family.ensemble)
        self._families[family.name] = family
        self._admission[family.name] = diags
        self._queues[family.name] = deque()
        return diags

    def admission_report(self, name: str) -> List[Diagnostic]:
        return list(self._admission.get(name, ()))

    # -- submission ----------------------------------------------------

    def submit(self, request: ScenarioRequest) -> int:
        """Queue a request; returns its rid.  Incompatible requests are
        rejected immediately - ``handle(rid).status == "rejected"`` with
        the diagnostics attached - so a bad request can never poison the
        batch it would have joined."""
        rid = self._next_rid
        self._next_rid += 1
        h = RequestHandle(rid=rid, request=request,
                          submitted_at=time.monotonic())
        self._handles[rid] = h

        fam = self._families.get(request.family)
        if fam is None:
            h.status = "rejected"
            h.diagnostics = [Diagnostic(
                severity="error", contract="serve-unknown-family",
                message=f"no registered family {request.family!r}",
                hint=f"registered: {sorted(self._families)}")]
            h.finished_at = time.monotonic()
            return rid
        errors = [d for d in self._admission[request.family]
                  if d.severity == "error"]
        if errors:
            h.status = "rejected"
            h.diagnostics = errors
            h.finished_at = time.monotonic()
            return rid
        known = set(fam.ensemble.param_names) | {"seed"}
        unknown = set(request.params) - known
        if unknown:
            h.status = "rejected"
            h.diagnostics = [Diagnostic(
                severity="error", contract="serve-unknown-param",
                message=f"unknown parameter(s) {sorted(unknown)} for "
                        f"family {request.family!r}",
                hint=f"family sweeps {list(fam.ensemble.param_names)}")]
            h.finished_at = time.monotonic()
            return rid
        if request.steps < 1:
            h.status = "rejected"
            h.diagnostics = [Diagnostic(
                severity="error", contract="serve-bad-request",
                message=f"steps must be >= 1, got {request.steps}")]
            h.finished_at = time.monotonic()
            return rid
        self._queues[request.family].append(rid)
        return rid

    def handle(self, rid: int) -> RequestHandle:
        return self._handles[rid]

    # -- batching loop -------------------------------------------------

    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def pump(self) -> int:
        """Run ONE batch: pop up to ``slot_size`` queued requests of the
        family with the deepest queue, pad the slot, and run it to
        completion (streaming frames at every member's cadence).
        Returns the number of requests completed (0 if idle)."""
        name = max((n for n, q in self._queues.items() if q),
                   key=lambda n: len(self._queues[n]), default=None)
        if name is None:
            return 0
        fam = self._families[name]
        q = self._queues[name]
        rids = [q.popleft() for _ in range(min(self.slot_size, len(q)))]
        handles = [self._handles[r] for r in rids]
        for h in handles:
            h.status = "running"

        ens = fam.ensemble
        # on a process mesh: this rank's blocks, and the frames summed
        # over the ranks
        kw = {} if self.mesh is None else dict(mesh=self.mesh)
        comm = None if self.mesh is None \
            else ens.proto_engine()._comm(self.mesh)
        points, states = [], []
        for h in handles:
            p = {**fam.defaults, **h.request.params}
            seed = int(p.pop("seed", h.request.seed))
            points.append({k: p[k] for k in ens.param_names})
            states.append(fam.init_point(ens, seed, **kw))
        estate = ens.init(states, points)
        estate = ens.pad_to(estate, self.slot_size)
        self._batches += 1
        self._occupancy_sum += len(handles) / self.slot_size

        # Segment boundaries: the union of every member's streaming
        # points and completion steps - each member reads its frames at
        # its own cadence out of the shared steps.
        marks = set()
        for h in handles:
            r = h.request
            if r.stream_every > 0:
                marks.update(range(r.stream_every, r.steps,
                                   r.stream_every))
            marks.add(r.steps)
        horizon = max(h.request.steps for h in handles)

        done = 0
        for mark in sorted(marks):
            estate, _ = ens.run(estate, mark - done, mesh=self.mesh)
            done = mark
            frame = fam.metric(estate.state)
            if comm is not None:
                frame = comm.sum_over_all_ranks(
                    torch.from_numpy(np.asarray(frame))).numpy()
            for lane, h in enumerate(handles):
                r = h.request
                due = (r.stream_every > 0 and done <= r.steps
                       and done % r.stream_every == 0)
                if due or done == r.steps:
                    h.frames.append((done, np.asarray(frame[lane])))
                if done == r.steps:
                    h.status = "done"
                    h.finished_at = time.monotonic()
        assert done == horizon
        return len(handles)

    def drain(self) -> int:
        """Pump until every queue is empty; returns requests completed."""
        total = 0
        while self.queue_depth():
            total += self.pump()
        return total

    # -- telemetry -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        states = [h.status for h in self._handles.values()]
        return {
            "queue_depth": self.queue_depth(),
            "queues": {n: len(q) for n, q in self._queues.items()},
            "slot_size": self.slot_size,
            "batches": self._batches,
            "mean_occupancy": (self._occupancy_sum / self._batches
                               if self._batches else 0.0),
            "requests": {s: states.count(s)
                         for s in ("queued", "running", "done",
                                   "rejected")},
            "caches": cache_stats(),
        }


# ---------------------------------------------------------------------------
# Smoke (the CI serve step)
# ---------------------------------------------------------------------------

def _smoke(device="cuda") -> int:
    server = ScenarioServer(
        [sir_mechanics_family(n_agents=200, device=device)], slot_size=4)

    # A family that cannot batch: its factory concretizes a parameter.
    from repro_torch.core import Domain
    from repro_torch.sims import cell_clustering as cc

    def bad_factory(params):
        return dataclasses.replace(cc.behavior(),
                                   radius=float(params["radius"]))

    server.register(ScenarioFamily(
        name="bad_radius_sweep",
        ensemble=Ensemble(geom=Domain(cell_size=2.0, interior=(8, 8),
                                      mesh_shape=(1, 1), cap=24,
                                      boundary="toroidal"),
                          behavior_fn=bad_factory, param_names=("radius",),
                          family="bad_radius_sweep", device=device),
        init_point=lambda e, seed: None,
        metric=lambda s: np.zeros((1, 1))))

    rids = [server.submit(ScenarioRequest(
                family="sir_mechanics", params={"beta": b}, steps=12,
                stream_every=4, seed=i))
            for i, b in enumerate((0.02, 0.05, 0.08))]
    bad = server.submit(ScenarioRequest(
        family="bad_radius_sweep", params={"radius": 1.0}, steps=4))

    bad_h = server.handle(bad)
    assert bad_h.status == "rejected", bad_h.status
    assert any(d.contract == "ensemble-factory-static"
               for d in bad_h.diagnostics), bad_h.diagnostics
    print("rejected incompatible request with diagnostic:")
    print("  " + bad_h.diagnostics[0].format().splitlines()[0])

    server.drain()
    for rid in rids:
        h = server.handle(rid)
        assert h.status == "done", (rid, h.status)
        steps = [s for s, _ in h.frames]
        assert steps == [4, 8, 12], steps
        for _, f in h.frames:
            assert f.shape == (3,) and int(f.sum()) == 200, f
        print(f"  req {rid} beta={h.request.params['beta']}: "
              + " ".join(f"t={s}:{list(map(int, f))}"
                         for s, f in h.frames))

    st = server.stats()
    assert st["requests"]["done"] == 3 and st["requests"]["rejected"] == 1
    assert st["batches"] == 1 and st["mean_occupancy"] == 0.75
    assert st["caches"]["ensemble.runner"]["misses"] >= 1
    print(f"serve smoke OK: {st['batches']} batch at occupancy "
          f"{st['mean_occupancy']:.2f}, runner cache "
          f"{st['caches']['ensemble.runner']['hits']}h/"
          f"{st['caches']['ensemble.runner']['misses']}m")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="batching scenario server over ensemble families")
    ap.add_argument("--smoke", action="store_true",
                    help="in-process end-to-end smoke: 3 compatible "
                         "requests batched into one padded slot + 1 "
                         "incompatible rejected")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args.device)
    ap.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
