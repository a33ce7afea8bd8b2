#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run it from the repository root; it imports ``repro_torch``, ``torch`` and
``numpy`` only.  Phases, each printing its own lines:

1. card: torch/CUDA versions, the card's name and power limit;
2. build: compile the ``pair_sweep`` (with ``neighbor_force``),
   ``delta_codec`` and ``flash_attention`` (both attention kernels)
   libraries from ``csrc/``, one nvcc each, started together (timed, with
   ptxas' registers and spills of every kernel), and count the HGMMA
   instructions of the
   attention library's machine code (none fails);
3. ``pair_sweep`` against its plain version on a (128, 128) grid, cap 24,
   ~6 agents a cell, both pair laws, closed and toroidal: forces to 1e-5,
   counts exactly;
4. single-device main path: ``cell_clustering`` through ``Simulation`` on
   the card at (2048, 2048) cells, cap 48, 16,777,216 agents, 10 steps,
   with the clustering metric before and after; first the kernel against
   its plain version (and both timed) on the main path's own SoA, then the
   counts are zeroed and the path is driven; agents conserved, nothing
   dropped, finite positions, 10 + 2 kernel launches; then device time by
   kernel over one more step (``torch.profiler``);
5. kernel vs ``tiled`` end to end on the card, (16, 16) cells, 1000
   agents, 8 steps;
6. mesh main path: the same 16,777,216 agents on a 2x2 virtual device mesh
   on the one card (1024 x 1024 cells a device, cap 48), the aura exchange
   delta-encoded (int8) and emigrant positions through the int16 codec
   (``delta="int8+mig"``), 10 steps; the counts are zeroed and the path is
   driven; agents conserved, nothing dropped, no codec overflow, every
   kernel launched the count the configuration implies, ``halo_bytes`` on
   a full and a delta step; then a profile of one delta step, and the
   inputs of every codec call of one more delta step recorded;
7. codec, in a process of its own on the saved calls: each of the four
   codec kernels against its plain version on those recorded main-path
   inputs, and the position decode on phase 8's toroidal calls (with the
   seam's ``at_l``), every output bit for bit, timed with its bound, its
   plain version and one PyTorch call where one computes the same
   function; each call enqueues exactly one device operation, its kernel
   (no memset), counted from the profiler's traces of one call each, from
   which its time is taken; the share of zero deltas and of live rows in
   the calls; ptxas' registers and spills of the codec kernels (the same
   on phase 13 c's recorded 3-D calls);
8. mesh parity on the card, (16, 16) cells a device: 2x2 with a full
   refresh against one device, the int8+mig codec against a full refresh
   (drift and wire bytes), the closed-loop references bit-equal, and a 2x1
   toroidal mesh whose agents cross the seam, all 300 kept with x in
   [0, L); the position decode calls of its last step recorded for 7;
9. ``flash_attention`` against its plain version: the main shape (4 x 16
   heads, 2048 tokens, head dim 128), causal and not, in float32 on the
   3xTF32 tensor-core kernel (2e-5) and bf16 on the wgmma kernel (2e-2,
   and one bf16 ulp + 1e-5 element by element), float32 at (2 x 8, 512,
   64) and bf16 GQA through ``ops.flash_attention_bhsd`` with 2 KV heads;
   head dim 80 (hubert-xlarge's, zero-padded to 128 by the wrapper),
   causal and full, float32 and bf16, at the same tolerances;
   kernel, plain, ``scaled_dot_product_attention`` and bound times of each
   kernel at the main shape (and at head dim 80), causal (float32: both
   bounds, three TF32 products and float32 FMA, the device kernels SDPA
   runs in float32, and the kernel's and the plain version's distance
   from a float64 attention); the bf16 kernel on bf16(p) alone instead of p_hi + p_lo
   (error and time, reported);
10. the LM main path: olmo-1b at full width and depth (16 layers, d_model
   2048, bf16, random weights from ``params.init`` and ``--seed``).
   (a) scoring: ``loss_fn`` forward, batch 4 x 2048, backend ``"kernel"``,
   with the counts zeroed before and read after: exactly 16 launches of
   the bf16 tensor-core attention kernel, a finite loss, finite logits
   with the padded columns masked; each of the 16 attention launches of
   one more forward against the plain version on that launch's inputs (as
   in phase 9); on float32 copies of the weights the ``"kernel"`` backend
   (16 launches of the float32 kernel, counted) and ``"chunked"`` agree to
   1e-3, and in bf16, at every position, the kernel backend's largest distance
   from that float32 forward is at most 2x the chunked backend's; ms a
   forward, tokens/s, peak memory.  (b) greedy serving: 4 prompts of 480
   tokens, ``make_prefill_step`` into a 512-slot cache, 32 decode steps of
   ``make_serve_decode_step`` (bf16, timed; no kernel launch); the
   prefill's logits against a bf16 chunked forward over the 512 tokens
   (0.06 abs, 0.05 rel) and every step's held to the float32 forward as
   scoring is; then, on float32 weights and cache, the prefill's and
   decode steps' logits at 479..511 against a ``"kernel"`` forward over
   the 512 tokens (1e-3); prefill ms, ms a decode step, decode tokens/s,
   peak memory;
11. the legacy ``ops.neighbor_force`` (its own kernel) on the gathered
   slabs of a (1024, 1024)-cell, cap-48 clustering SoA (4,194,304 agents),
   driven once with the counts zeroed, then against its plain version in
   chunks of cells (1e-5), and on the reference test's (C, K) cases; kernel
   and plain times, and two bounds: the bytes a valid-first read needs
   (``bound_ms``) and those of reading every slab row;
12. the other bundled sims through ``Simulation`` on the card, each driven
   with the counts zeroed just before and read just after, then its pair
   law's kernel against the plain version on a mid-run SoA (forces to
   1e-5, counts exactly), timed with its bound: (a) ``epidemiology`` at
   (2048, 2048) cells, 16,777,216 agents (838,861 infected), cap 24,
   toroidal, 10 steps: S+I+R = N at every step, nothing dropped, law 2
   once a step; per-step ms, agent-updates/s, peak memory, a profiled
   step and the RNG's share of it (its draws timed alone); (b)
   ``sir_mechanics`` on the same grid and agents at cap 32 (48 if 32
   drops, with the drops at 32 printed): the stack's one launch a step,
   S+I+R = N, nothing dropped; (c) ``cell_proliferation`` (20 steps) and
   ``oncology`` (10) on the full grid at cap 32, seeded as the reference
   does as a disk of radius L/8 at the centre, at 8 and 4 agents a cell:
   at every step live agents = initial + spawned - dropped, gids unique
   at the end, one launch a step (law 0, law 3);
13. the 3-D path: (a) the D = 3 ``pair_sweep`` kernel of law 0, law 1 and
   the spheroid's stack (force + crowd) on a uniform (128, 128, 128)-cell
   SoA, cap 32, 8 agents a cell (16,777,216), against the plain version
   in blocks of 2 x 32 x 128 cells (forces to 1e-5, counts exactly), timed
   with its bound; (b) ``tumor_spheroid`` through ``Simulation`` on the
   card on that grid, seeded as the reference's ``init`` seeds it (a ball
   of radius L/8 at the centre) at 1/32 agent a unit^3 (4,289 agents), 20
   steps with the counts zeroed just before and read after: live =
   initial + spawned - dropped at every step, nothing dropped, unique
   gids, finite positions, the spheroid diameter growing, the stack's one
   launch a step; the stack against plain on the path's SoA, a profiled
   step and the RNG's share of it; (c) the same grid and seed on a 2x2x2
   virtual mesh (64^3 cells a device), int16 aura codec (refresh 8) and
   int16 migration codec, 10 steps: the same gates, no codec overflow,
   ``halo_bytes`` on a full and a delta step, every kernel's launches as
   the configuration implies; then the inputs of every codec call of one
   more delta step recorded, and phase 7 on them; (d) the spheroid's
   mechanics on a 2x2x2 mesh of 8^3 cells with a full refresh against one
   device (1e-4);
14. the ensemble path: ``sir_mechanics``' ensemble family (cap 32,
   toroidal, dt 1.0) on (512, 512) cells, 8 lanes of 1,048,576 agents
   (5 % infected, each lane seeded from ``--seed`` and its index) at 8
   parameter points, every knob varying, ``sir_radius`` in {0.75, 1.0,
   1.25, 1.5}.  (b) ``Ensemble.run`` on one device, 10 steps with the
   counts zeroed before and read after: S+I+R = N in every lane at every
   step, nothing dropped, finite positions, exactly 10 launches of stack
   18 (the force and the per-lane gated SIR count) and none of any other
   law, the lanes' I-curves not all equal, every lane bit-equal (every
   column) to the solo engine at its point; ms a step, agent-updates/s,
   peak memory, a profiled step, and the 8 solo runs' ms a step summed;
   (a) on step 1's aura-filled SoA of the 8 lanes, one lane launch of
   stack 18 and of law 5 alone against the plain version lane by lane
   (forces 1e-5, counts exactly) and bit-equal to 8 B = 1 launches, timed
   against them, the plain version and the bound; (c) the first 4 points
   on the 2x2 virtual mesh (the same domain, codec off), 10 steps: one
   lane launch a device a step (40), every lane bit-equal to its solo
   mesh run; (d) the scenario server at that size (cap 48), slot 8: 12
   requests (budgets 8, 12, 16; streaming every 0 or 4 steps) and three
   rejected at submit (unknown family, unknown parameter, a factory that
   concretizes a parameter), drained in 2 batches at occupancy 0.75, the
   second a runner-cache hit, every frame at its cadence summing to N
   and equal to the request's solo run; requests/s, latencies;
15. uneven partitions and the overlapped sweep on the virtual mesh: (a)
   the main path's 16,777,216 ``cell_clustering`` agents on the uneven
   2x2 cut ``from_widths([(896, 1152), (1152, 896)])`` (1154^2 cells a
   device with the ring, cap 48), ``int8+mig``, placed a quarter in each
   device's slab (a piecewise-constant density the cut balances: each
   device holds a quarter within 1 %), 10 steps with ``overlap="off"``
   and again with ``"on"``, the counts zeroed before and read after each:
   agents conserved, nothing dropped, no codec overflow at every step,
   one full-block ``pair_sweep`` launch a device a step (on: the interior
   pass) and, on, four face-band launches, each kind gated on its own
   count, the codec's launches, the two final states bit-equal in every
   field; ms a step and agent-updates/s of each, peak memory; (b) on the
   densest device's aura: the interior pass's launch and each face band's
   (a 3-plane band; along axis 1 a strided view, whose columns the
   overlapped sweep copies) against the plain version on the band
   and bit-equal to the same cells of a full-block launch, timed with the
   band's bound and the copy's cost; (c) a count-driven drift with spawns
   (the same-type law's pair count, tests/test_partition.py's update) on
   (32, 24) cells, on one device, on the equal 2x2 split and on an uneven
   one with the overlapped sweep: bit-equal; (d) 14 c's ensemble (4
   lanes) on the cut ``from_widths([(224, 288), (288, 224)])``: one lane
   launch a device a step, each lane bit-equal to its solo run;
16. the process mesh: phase 6's configuration (16,777,216 agents, 2x2,
   cap 48, ``int8+mig``, 10 steps) through ``Simulation(mesh=
   make_abm_mesh((2, 2)))``, one process a device: four ranks spawned on
   the one card, joined by a gloo group over a file store under
   ``build/`` (the wire goes through pinned host memory), with a timeout
   on the group and on the join.  Each rank's counts are zeroed before
   the driven run and read after it: ``pair_sweep`` a quarter of phase
   6's, each codec kernel phase 6's count (a virtual-mesh launch encodes
   the four devices' rows, a rank's its own); agents conserved, nothing
   dropped, no codec overflow (global), ``halo_bytes`` phase 6's, and
   each rank's final block bit-equal (sha256 of every field) to its
   device's block of phase 6's run.  Then phase 8's 2x1 toroidal drift
   (two ranks, the size-2 torus) against its virtual-mesh run, gated the
   same way.  Each rank prints its ms a step (CUDA events and the host
   clock between barriers, steps 2-10), its wire bytes a step (the packed
   buffers and ``halo_bytes``), its milliseconds a step in the comm
   (packing, staging and gloo) and its peak device memory; the parent
   the slowest rank's agent-updates/s beside phase 6's step.
17. dynamic load balancing and logical checkpoints (after phase 16, its
   memory freed; its own seconds printed): (a) phase 15's seeding (a
   quarter of the 16,777,216 agents uniform in each slab of the cut
   ``PART_WIDTHS``) on the equal 2x2 virtual mesh (1024^2 cells a device,
   cap 48, ``int8+mig``) through ``Simulation(rebalance=Rebalance(every=5,
   threshold=0.1, ownership="rcb"))`` for 10 steps, the counts zeroed
   before and read after: the imbalance before in [0.22, 0.25], exactly
   one re-shard applied (the cut's widths printed) and the imbalance
   after at most 0.01, agents conserved at every step, nothing dropped,
   no codec overflow, gids unique, the step after the re-shard a full
   refresh (its ``halo_bytes`` a full aura's), ``pair_sweep`` and the
   codec kernels launched as the new geometry implies; the histogram and
   plan ms, the equal split's step ms before and the cut's after, peak
   memory; (b) on that seeding ``reshard_state`` by the host and by the
   device transport onto the planned cut, every field bit-equal, both
   timed; (c) (a)'s final state through ``save_abm`` under ``build/``,
   ``Simulation.restore`` onto one device and onto the 2x2 (the ownership
   kept): agents by gid bit for bit in every column, the carry, one step
   each with its launches counted; save and restore seconds and the
   bytes on disk; then the directory is removed; (d) the same path at
   128^2 cells on four ranks of a process mesh (gloo, the card shared):
   each rank's block (sha256 of every field) equal to the virtual mesh's
   device block after the re-shard and the steps.
18. runtime guards, fault plans and supervised runs, and the scenario
   server over a process mesh (its own seconds printed; or
   ``tools/guards_phase.py`` alone): (a) phase 4's 16,777,216 agents
   (cap 48) for 10 steps with ``guards="error"`` and with guards off:
   every health word 0, the final states bit-equal in every field
   (compared on the card), the same ``pair_sweep`` launches; ms a step of
   each (CUDA events, steps 2-10) and, at a control point,
   ``health_counts``, the device duplicate check and ``check_health``
   timed; the card's float-to-int conversion of NaN and infinities as the
   CPU's binning spells it out (XLA's); (b) on phase 6's 2x2 virtual mesh
   (``int8+mig``) under ``"warn"``, one step each from a ``halo_slab``
   fault and a ``nan_attrs`` fault at 1e-6 (``nan_inf`` equal to the NaN
   slots of the aura-filled SoA, counted apart), a gid of device (0, 0)
   given to device (1, 1)'s first agent (``gid_duplicate`` 1) and an
   agent moved one device along x (``out_of_slab`` 1), each report
   printed; (c) a supervised run on that mesh, ``Supervised(every=4,
   keep=3)`` under ``build/`` (removed after), 12 steps, the plan a
   ``halo_slab`` fault at 6, a torn checkpoint at 8 and a device loss to 2
   survivors at 9: the log's kinds, steps, ``rolled_back_to``, devices and
   replays as the plan implies, agents conserved and health 0 after
   recovery, the replay bit-equal by gid to an uninterrupted resume from
   the rollback checkpoint onto the same devices; each save's and
   recovery's seconds; (d) four gloo ranks on the card: the
   ``sir_mechanics`` ``ScenarioServer(mesh=)`` on a 2x2 family (131,072
   agents, 256^2 cells; budgets 8 and 12, streaming every 4) with every
   rank's frames equal to the one-process virtual-mesh server's, and
   phase 16's configuration guarded with a ``nan_attrs`` fault, every
   rank's ``health_counts`` equal to the virtual mesh's; (e) on the same
   four ranks a supervised 2x2 run (1,048,576 agents, ``int8+mig``,
   ``guards="error"``) that loses two devices at step 6: ranks 0-1 restore
   onto the survivors' mesh, each block (sha256 of every field) and the
   log equal to the virtual mesh's degraded run, ranks 2-3 log the same
   recovery (``left``) and stop at the fault; the recovery seconds on a
   line of their own.
19. the simcheck suite on the card (its own seconds printed; or
   ``tools/simcheck_phase.py`` alone): (a) the bare ``simcheck --strict``
   in process (every sim with its virtual variants, the ensemble family,
   the lint of ``repro_torch``), exit code 0; (b) ``validate()`` of phase
   4's main sim and of phase 6's 2x2 ``int8+mig`` mesh, each after one
   step: clean under strict, every field of ``sim.state`` bit-equal
   (sha256) and every launch counter as before, its seconds and peak
   memory; (c) the engine's own host syncs and host->device copies, by
   aten op and innermost ``repro_torch`` frame, of a main step, a mesh
   delta step and a guarded main step (``analysis.audit_step``); (d) a
   planted ``.item()`` update and a planted float64 update, flagged on
   the card exactly as on the CPU; (e) the probe steps' ``pair_sweep``
   and codec launches, gated and written as each kernel's
   ``simcheck_path``.
20. ``ops.neighborhood_pair_sweep`` (the gathered-slab kernel): slabs of
   interior rows 0-63 of phase 4's SoA after one step (131,072 cells, K
   48, NK 432; a SIR state 0-2 a slot drawn from the seed, which the
   clustering SoA lacks), every law and stack (0-5, 16-18) once through
   the entry point (one launch, nothing else), then against its plain
   version (counts exactly, floats to 1e-5), timed (CUDA events) with
   its bound (the slab columns it reads and its outputs); every law on
   random D = 3 slabs, closed and toroidal.  No driven path launches it.
21. the examples: ``examples_torch/quickstart.py``,
   ``supervised_run.py --device-loss`` and ``serve_lm.py`` (minicpm3-4b's
   smoke size, MLA) through their ``main``s at the reference's sizes (each
   fails on its own assertions), with wall seconds and peak device memory
   (``tools/examples_phase.py`` runs the eight ABM ones);
22. the transformer-block families of the LM stack at full width, random
   bf16 weights from ``params.init`` and ``--seed``: minicpm-2b (40
   layers, head dim 64), minicpm3-4b (62, MLA), qwen3-moe (8 of 94 layers,
   64 query heads on 4 KV heads), phi3.5-moe (16 of 32), llava (32, 1152
   patches + 896 tokens) and hubert (48, frames, non-causal, head dim 80
   zero-padded to 128); each depth cut printed with the sizes that force
   it.  Scoring: ``loss_fn`` on 4 x 2048 positions, backend ``"kernel"``,
   counted alone: ``n_layers`` launches of the bf16 attention kernel for
   each GQA config, none for MLA (``sdpa_chunked``), a finite loss, finite
   logits with the padded columns masked; the first and last layer's
   attention launches against the plain version on their inputs (as phase
   10), the kernel at that shape timed against the plain version and SDPA
   with its bound; ms a forward, tokens/s, peak memory.  MoE: capacity C,
   the share of (token, expert) assignments dropped a layer, two
   forwards' logits bit-equal.  hubert: 4 layers on float32 weights, the
   float32 kernel (4 launches) against ``"chunked"`` to 1e-3.  Serving
   (all but hubert): 4 prompts of 480 tokens (llava: 1152 patches + 384
   tokens) + 32 greedy tokens into a 512-slot cache (llava 1568), no
   kernel launch; the prefill's last logits against a chunked forward
   over the prompt (0.06 abs, 0.05 rel); prefill ms, ms a decode step,
   peak memory; the phase's seconds.
23. the ssm and hybrid families at full width and depth, random bf16
   weights from ``params.init`` and ``--seed``: zamba2-1.2b (38 Mamba2
   blocks: 6 groups of 6, each followed by the one shared attention
   block, then a 2-block tail; chunk 256) and xlstm-1.3b (48 blocks: 6
   segments of 7 mLSTM + 1 sLSTM).  Scoring: ``loss_fn`` on 4 x 2048
   positions, backend ``"kernel"``, counted alone: 6 launches of the bf16
   attention kernel for zamba2 (hd 64, 32 heads), none for xLSTM; a
   finite loss, finite logits (zamba2's at the published chunk of 256:
   the gate of ROADMAP §C 11) with the padded columns masked; zamba2's
   first and last shared-attention launches against the plain version on
   their inputs, the kernel at that shape timed against the plain version
   and SDPA with its bound; ms a forward, tokens/s, peak memory, and the
   device and host shares of the SSD chunk scan, the mLSTM chunk scan and
   the sLSTM time loop (profiler ranges around each).  Cross-device: a
   7-layer zamba2 (a group and a tail block) and an 8-layer xLSTM (one
   segment) on float32 copies of the weights over 1 x 512 tokens, the
   card's logits against the port's own CPU run to 1e-3.  Serving: 4
   prompts of 512 tokens (a multiple of both chunks) + 32 greedy tokens
   (zamba2's KV cache 544 slots), no kernel launch; as phase 10: the
   prefill's last logits against a chunked forward over the prompt (0.06
   abs, 0.05 rel), every bf16 step's distance from the float32 forward
   over the same tokens at most 2x the bf16 forward's; on float32 weights
   and cache, every step (the first decode step within 0.06 / 0.05)
   against a forward over the prompt and the generated tokens (padded to
   1024, whole chunks; causal, so the padding changes nothing before it)
   to 1e-3; prefill ms, ms a decode step, its idle share, peak memory;
   the phase's seconds.
24. LM training (``tools/train_phase.py`` alone): olmo-1b at full width
   and depth, random bf16 weights from ``params.init`` and ``--seed``,
   AdamW + WSD (warmup 1), ``SyntheticLM`` 4 x 2048 on the card, backend
   ``"chunked"`` as the reference trains.  (a) 8 steps of
   ``make_train_step`` (remat ``"dots"``) on one repeated batch: loss and
   grad norm finite at every step, the loss falling, no kernel launched;
   ms a step (CUDA events, steps 2-8), train tokens/s, host ms a step,
   peak memory; one more step with CUDA-event spans of the forward
   (``loss_fn``), the backward (``torch.autograd.grad``, the recompute
   included) and the optimizer (``AdamW.update``), and one profiled: the
   card's idle share and the matrix products' share of its kernel time;
   (b) two steps with the int8 ``DeltaEFCompressor`` (a refresh, a
   quantized step): ms and peak;
   (c) ``value_and_grad`` under remat ``none``, ``dots`` and ``full``:
   peak memory and ms of each, the losses and gradients bit-equal (or
   every leaf within 2^-7 of its max, reported), a policy out of memory at
   4 x 2048 reported and the three compared at 2 x 2048 too; (d) 2 layers
   at full width on float32 copies of the weights, 1 x 512 tokens: the
   loss (1e-5 relative) and every gradient (1e-4 of its leaf's max)
   against the port on the CPU, one AdamW step on the same gradients
   (masters to 1e-6); (e) ``accum_steps=2`` against 1 on the same 2 x 512
   rows (loss and gradients to 1e-5); (f) the smoke model's 4 steps with a
   checkpoint at 2 under ``build/``, steps 3-4 from the restore
   bit-identical, save and restore seconds; (g) every config's smoke size
   2 steps on the card (finite, parameters moved) and its float32 loss and
   gradients against the CPU's (mLSTM leaves 2e-3: bf16-rounded chunk
   operands); (h) ``backend="kernel"`` under autograd raises
   ``NotImplementedError`` (ROADMAP B5 b) before any launch;
   ``examples_torch/train_lm.py`` (200 steps) wall seconds and peak
   memory; the phase's seconds.
25. the LM mesh (``tools/lm_mesh_phase.py``, also alone): four ranks on
   the one card (a gloo group, CUDA tensors staged through pinned host
   buffers) run phi3.5-moe at full width cut to 2 layers: (a) the
   launcher's ``(1, 4)`` path (``choose_lm_mesh(4)``), 2 steps of 4 x 256,
   then 3 steps of that mesh timed one by one;
   (b) a ``(2, 2)`` step against the same step emulated rank by rank in
   this process (collectives as index moves: the loss to 1e-3,
   the grad norm to 2e-2, sampled masters within 1e-6 but at most 1 % of
   them, those within 2 lr); (c) olmo-1b (full width, 2 layers) one
   ``(2, 2)`` step against one device's, the same limits; (d) serving on
   ``(1, 4)``: weights gathered once, a 4 x 256 prefill (the shard body,
   attention on B5, every launch against its plain version) and 8 greedy
   decode steps (the dense decode body), the logits against the
   emulation's on the same tokens (0.06), the ranks' tokens equal; each
   rank's step ms, share in the staged collectives and peak memory, the
   prefill's and a decode step's ms, B5 at the prefill's shape against
   the plain version and SDPA with its bound.

The last three lines are the card (``nvidia-smi``), one JSON line with
every kernel and the result line.  Exits nonzero without a result line
when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.agent_soa import AgentSoA  # noqa: E402
from repro_torch.core.behaviors import Behavior  # noqa: E402
from repro_torch.core.delta import DeltaConfig  # noqa: E402
from repro_torch.core.engine import device_block, total_agents  # noqa: E402
from repro_torch.core.ensemble import replica_state  # noqa: E402
from repro_torch.core.grid import clear_ring  # noqa: E402
from repro_torch.core.halo import LocalComm, halo_exchange  # noqa: E402
from repro_torch.core.neighbors import minimum_image_box  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.configs import get as get_config  # noqa: E402
from repro_torch.kernels import delta_codec as dc  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import neighbor_interaction as ni  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import mamba2 as m2_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import xlstm as xl_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.layers import NORM_FNS  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.core import operations, prng  # noqa: E402
from repro_torch.sims import cell_clustering as cc  # noqa: E402
from repro_torch.sims import cell_proliferation as cp  # noqa: E402
from repro_torch.sims import epidemiology as ep  # noqa: E402
from repro_torch.sims import oncology as onc  # noqa: E402
from repro_torch.sims import sir_mechanics as sm  # noqa: E402
from repro_torch.sims import tumor_spheroid as ts  # noqa: E402
from repro_torch.sims.common import (  # noqa: E402
    ball_positions, disk_positions, init_agents, make_sim, uniform_positions)
from repro_torch.core import reshard as rs  # noqa: E402
from repro_torch.core.simulation import Rebalance, Simulation  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.training import steps as lm_steps  # noqa: E402
from repro_torch.training import optimizer as optim_mod  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed.grad_compress import (  # noqa: E402
    DeltaEFCompressor)

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12          # dense, tensor cores
TF32_OPS_PER_S = 495e12          # dense, tensor cores
PROFILE_TRIES = 3        # empty profiler traces before device_ms uses events
# A codec kernel's time is taken from traces of one recorded call each,
# the calls in turn, until every call has ONE_OPERATION_REPS traces that
# hold its launch, within ONE_OPERATION_ROUNDS rounds: the profiler may
# drop a kernel's event (see phase_codec_apart), never adds one.
ONE_OPERATION_REPS = 5
ONE_OPERATION_ROUNDS = 30

# Float operations the kernel does per pair (see csrc/pair_sweep.cu): the
# distance test on every pair of occupied, distinct slots (D subtractions,
# D multiplies, D adds, 1 compare: 3 D + 1), then the law on pairs within
# radius.  The law's own operations on a pair within the radius: the
# soft-sphere force ~20; a count a compare and an add; oncology the force
# and a count; the mechanics + SIR stack the force, the SIR count and two
# gate tests; the spheroid's stack the force, the crowd count and two gate
# tests.
OPS_DISTANCE_TEST = 3 * 2 + 1      # at D = 2 (phase 11's slabs)
STACK = "stack(soft_repulsion_adhesion,epidemiology)"
SPH_STACK = "stack(soft_repulsion_adhesion,crowd)"
PROLIF_LAW = "soft_repulsion_adhesion@cell_proliferation"
ENS_STACK = "stack(soft_repulsion_adhesion,gated_epidemiology)"
ENS_LAW5 = "gated_epidemiology"
# law 5: the lane's r * r, the gate test, the state test and the add; stack
# 18: the force, law 5 and the structural gate test
OPS_LAW = {"soft_repulsion_adhesion": 20, "same_type": 3, "epidemiology": 2,
           "oncology": 21, STACK: 24, PROLIF_LAW: 20, SPH_STACK: 23,
           ENS_LAW5: 4, ENS_STACK: 25, "crowd": 2}

ENS_BEHAVIOR = sm.ensemble_behavior(sm.ensemble_defaults())
LAW_ARGS = {   # law -> (pair_fn, pair_attrs, params)
    "soft_repulsion_adhesion": (
        cc.behavior().pair_fn, cc.behavior().pair_attrs,
        dict(cc.behavior().params)),
    "same_type": (cc._same_type_pair, ("ctype",), {}),
    "epidemiology": (ep._pair, ("state",), {}),
    "oncology": (onc._pair, onc.behavior().pair_attrs,
                 dict(onc.behavior().params)),
    STACK: (sm.behavior().pair_fn, sm.behavior().pair_attrs,
            sm.behavior().params),
    PROLIF_LAW: (cp.behavior().pair_fn, cp.behavior().pair_attrs,
                 dict(cp.behavior().params)),
    SPH_STACK: (ts.behavior().pair_fn, ts.behavior().pair_attrs,
                ts.behavior().params),
    ENS_LAW5: (sm._gated_sir_pair, ("state",), {"sir_radius": 1.5}),
    ENS_STACK: (ENS_BEHAVIOR.pair_fn, ENS_BEHAVIOR.pair_attrs,
                ENS_BEHAVIOR.params),
    "crowd": (ts._crowd_pair, (), {}),
}
COUNT_OUTPUTS = ("same", "cnt", "n_inf", "crowd", "b1.n_inf", "b1.crowd")

SMALL_INTERIOR = (128, 128)   # phase 3 grid, ~6 agents a cell
MAIN_INTERIOR = (2048, 2048)  # phase 4 grid, 4 agents a cell
# Slot capacity of the main path.  The sims' default of 24 overflows here:
# ten steps of clustering squeeze the fullest of the 4.2M cells past 24,
# and past 32, agents (runs on an H100 dropped 2738 agents at cap 24 and
# 24 at cap 32; the JAX reference has the same physics), and the
# repository treats any drop as a mis-sized grid.
MAIN_CAP = 48
MAIN_STEPS = 10

# Phase 6: the same agents on a 2x2 virtual mesh of the one card.
MESH_SHAPE = (2, 2)
MESH_INTERIOR = (1024, 1024)
MESH_DELTA = "int8+mig"
SOURCE_CODEC = "src/repro_torch/kernels/csrc/delta_codec.cu"
TPU_CODEC = "src/repro/kernels/delta_codec.py"
CODEC_REPLACES = {          # wrapper -> line of the TPU kernel it replaces
    "delta_encode": 44, "delta_decode": 78,
    "migration_pos_encode": 126, "migration_pos_decode": 165,
}
# Device kernels of csrc/delta_codec.cu, as the profiler names them.
CODEC_DEVICE_NAMES = ("delta_encode_kernel", "delta_decode_kernel",
                      "migration_pos_encode_kernel",
                      "migration_pos_decode_kernel")
# Float operations a codec kernel does per element (per coordinate for the
# position codec): encode - subtract, divide, round, two compares, clamp,
# multiply, add; decode - multiply, add; position encode - subtract,
# divide, round, two compares, clamp (+4 for the minimum image); position
# decode - multiply, add (+3 for the mod, +1 for the seam's compare).
CODEC_OPS = {"delta_encode": 8, "delta_decode": 2,
             "migration_pos_encode": 6, "migration_pos_decode": 2}
# Phase 8's toroidal position decode calls, gated and timed in phase 7
# beside the mesh path's: ``wrapper@label`` names a wrapper's calls of
# another path.
TORUS_DECODE = "migration_pos_decode@torus"
TORUS_STEPS = 30         # 30 * 1.5 = 45 > the domain's 32: a full wrap


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events),
    after one warm-up call unless ``warmup`` is False."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_call(soa, geom, law):
    pair_fn, pattrs, params = LAW_ARGS[law]
    return ni.pair_sweep(soa.attrs, soa.valid, pair_fn=pair_fn,
                         pair_attrs=pattrs, radius=2.0, params=params,
                         box=minimum_image_box(geom))


def plain_call(soa, geom, law, rows_per_chunk: int, cols_per_chunk=None):
    """The plain version over the whole grid, ``rows_per_chunk`` interior
    rows at a time (its (C, K, 3^D K) temporaries would not fit at once);
    with ``cols_per_chunk``, also that many interior cells of axis 1 at a
    time (a 3-D grid's rows), each block cut from the local grid with its
    ring of neighbour cells."""
    pair_fn, pattrs, params = LAW_ARGS[law]
    n = geom.interior
    k = geom.cap
    step1 = n[1] if cols_per_chunk is None else cols_per_chunk
    out = None
    for r0 in range(0, n[0], rows_per_chunk):
        r1 = min(n[0], r0 + rows_per_chunk)
        for q0 in range(0, n[1], step1):
            q1 = min(n[1], q0 + step1)
            blk = (slice(r0, r1 + 2), slice(q0, q1 + 2))
            ai, aj, vi, vj = ni.neighborhood_slabs(
                {a: t[blk] for a, t in soa.attrs.items()}, soa.valid[blk],
                pattrs)
            part = ni.pair_sweep_plain(
                ai, aj, vi, vj, pair_fn=pair_fn, radius=2.0, params=params,
                box=minimum_image_box(geom))
            if out is None:
                out = {a: torch.empty(n + (k,) + tuple(t.shape[2:]),
                                      dtype=t.dtype, device=t.device)
                       for a, t in part.items()}
            sub = (r1 - r0, q1 - q0) + tuple(n[2:]) + (k,)
            for a, t in part.items():
                out[a][r0:r1, q0:q1] = t.reshape(sub + tuple(t.shape[2:]))
            del ai, aj, vi, vj, part
    return out


def occupied_pairs(soa, geom) -> int:
    """Pairs of distinct occupied slots over every interior cell and its
    3^D neighbourhood: what the kernel's distance test runs on."""
    occ = soa.valid.sum(dim=-1, dtype=torch.int64)
    shape = geom.local_shape
    inner = tuple(slice(1, h - 1) for h in shape)
    nbr = torch.zeros_like(occ[inner])
    for off in np.ndindex(*(3,) * geom.ndim):
        nbr += occ[tuple(slice(o, h - 2 + o) for o, h in zip(off, shape))]
    return int((occ[inner] * nbr).sum() - occ[inner].sum())


def bound(soa, geom, law, in_radius_pairs: int):
    """(bound_ms, bound_by, bytes, ops) of one sweep on this SoA, counting
    what this data needs: every slot's valid flag, the law's columns of the
    occupied slots (each read once), every interior output written once,
    and the float operations on the occupied pairs."""
    pl = ni.law_for(LAW_ARGS[law][0])
    cols = 4 * geom.ndim + 4 + 4      # pos, gid_rank, gid_count
    cols += 4 * (len(pl.float_cols) + len(pl.int_cols))
    out_floats = sum(geom.ndim if per_axis else 1
                     for _, per_axis in pl.outputs)
    nbytes = (soa.valid.numel() + int(soa.valid.sum()) * cols
              + math.prod(geom.interior) * geom.cap * out_floats * 4)
    ops = (3 * geom.ndim + 1) * occupied_pairs(soa, geom) \
        + OPS_LAW[law] * in_radius_pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def compare(got, want, label):
    """Max abs error; forces within 1e-5 (abs and rel), counts exact."""
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape:
            fail(f"{label} {name}: shape {tuple(g.shape)} != "
                 f"{tuple(w.shape)}")
        err = float((g - w).abs().max()) if g.numel() else 0.0
        worst = max(worst, err)
        if name in COUNT_OUTPUTS:
            if not torch.equal(g, w):
                fail(f"{label} {name}: counts differ (max {err})")
        elif not torch.allclose(g, w, atol=1e-5, rtol=1e-5):
            fail(f"{label} {name}: max abs error {err} > 1e-5")
    return worst


def check_kernel(soa, geom, law, rows_per_chunk, reps, label,
                 cols_per_chunk=None):
    """Kernel vs plain version on ``soa``; both timed (the plain version
    once, the kernel over ``reps`` launches after a warm-up)."""
    before = sum(ni.LAUNCHES.values())
    got = kernel_call(soa, geom, law)
    torch.cuda.synchronize()
    if sum(ni.LAUNCHES.values()) != before + 1:
        fail(f"{label}: the launch counter did not move")
    want = {}
    plain_ms = cuda_ms(
        lambda: want.update(plain_call(soa, geom, law, rows_per_chunk,
                                       cols_per_chunk)), 1, warmup=False)
    err = compare(got, want, f"{label} {law}")
    in_radius = next((int(want[c].sum(dtype=torch.float64))
                      for c in ("cnt", "crowd", "b1.crowd") if c in want),
                     None)
    ms = cuda_ms(lambda: kernel_call(soa, geom, law), reps)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms), in_radius


def count_pair(ai, aj, disp, dist2, params):
    """Counts the pairs within the radius (for the bound's operations)."""
    return {"n": torch.ones_like(dist2)}


def in_radius_pairs(soa, geom, rows_per_chunk: int) -> int:
    n0 = geom.interior[0]
    total = 0
    for r0 in range(0, n0, rows_per_chunk):
        ai, aj, vi, vj = ni.neighborhood_slabs(
            soa.attrs, soa.valid, (), rows=(r0, min(n0, r0 + rows_per_chunk)))
        total += int(ni.pair_sweep_plain(
            ai, aj, vi, vj, pair_fn=count_pair, radius=2.0, params={},
            box=minimum_image_box(geom))["n"].sum(dtype=torch.float64))
    return total


def aura_block(sim):
    """The block of a one-device sim with its aura filled, as the step's
    sweep sees it."""
    lead = (0,) * sim.geom.ndim
    refs = {d: {f: v[lead] for f, v in s.items()}
            for d, s in sim.state.refs.items()}
    soa, _, _, _ = halo_exchange(
        sim.geom, clear_ring(device_block(sim.state.soa, lead)),
        LocalComm(toroidal=sim.geom.toroidal), refs, sim.engine.delta_cfg,
        True)
    return soa


def law_row(soa, geom, law, rows_per_chunk, reps, label, in_radius=None,
            cols_per_chunk=None):
    """``law``'s kernel against its plain version on ``soa``, both timed,
    with its bound; the pairs within the radius come from the law's own
    count output, else ``in_radius``, else a counting pass."""
    res, counted = check_kernel(soa, geom, law, rows_per_chunk, reps, label,
                                cols_per_chunk)
    if counted is not None:
        in_radius = counted
    elif in_radius is None:
        in_radius = in_radius_pairs(soa, geom, rows_per_chunk)
    b_ms, b_by, nbytes, ops = bound(soa, geom, law, in_radius)
    print(f"[{label}] {law}: max_abs_err={res['max_abs_err']:.3g} "
          f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}; {nbytes} B, {ops} ops)",
          flush=True)
    return dict(res, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops,
                in_radius_pairs=in_radius)


def law_rows(soa, geom, rows_per_chunk, reps, label):
    """Both clustering laws checked and timed on ``soa`` with their
    bounds (the same-type law counts the pairs in range for both)."""
    same = law_row(soa, geom, "same_type", rows_per_chunk, reps, label)
    soft = law_row(soa, geom, "soft_repulsion_adhesion", rows_per_chunk,
                   reps, label, in_radius=same["in_radius_pairs"])
    return {"soft_repulsion_adhesion": soft, "same_type": same}


def phase_small(seed: int):
    """Phase 3: (128, 128) cells, cap 24, ~6 agents a cell."""
    rows = {}
    for boundary in ("closed", "toroidal"):
        sim = make_sim(cc.behavior(), interior=SMALL_INTERIOR,
                       boundary=boundary, device="cuda")
        cc.init(sim, 6 * math.prod(SMALL_INTERIOR), seed=seed)
        sim.run(1)        # a mid-run SoA, then its aura as the step sees it
        rows[boundary] = law_rows(aura_block(sim), sim.geom,
                                  rows_per_chunk=32, reps=20,
                                  label=f"small {boundary}")
    return rows


def phase_main(seed: int):
    """Phase 4: the main path at full size."""
    steps = MAIN_STEPS
    n_agents = 4 * math.prod(MAIN_INTERIOR)
    t0 = time.perf_counter()
    sim = make_sim(cc.behavior(), interior=MAIN_INTERIOR, cap=MAIN_CAP,
                   sweep_backend="auto", device="cuda")
    cc.init(sim, n_agents, seed=seed)
    torch.cuda.synchronize()
    print(f"[main] init {n_agents} agents on {sim.geom.local_shape} x "
          f"{sim.geom.cap} slots: {time.perf_counter() - t0:.2f}s",
          flush=True)
    if sim.engine.sweep_backend != "auto":
        fail("main path is not on sweep_backend='auto'")

    rows = law_rows(device_block(sim.state.soa, (0, 0)), sim.geom,
                    rows_per_chunk=8, reps=10, label="main")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ni.reset_launches()
    f0 = cc.same_type_fraction(sim.state, sim.engine)
    sim.run(1)                                   # step 1: warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    sim.run(steps - 1)
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t0
    f1 = cc.same_type_fraction(sim.state, sim.engine)
    launches = dict(ni.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    step_ms = start.elapsed_time(end) / (steps - 1)
    n = total_agents(sim.state)
    dropped = int(sim.state.dropped.sum())
    finite = bool(torch.isfinite(sim.state.soa.pos).all())
    fullest = int(sim.state.soa.valid.sum(dim=-1).max())
    print(f"[main] steps 2-{steps}: {step_ms:.3f} ms/step (CUDA events), "
          f"host {1e3 * host_s / (steps - 1):.3f} ms/step; "
          f"{n / (step_ms / 1e3):.4g} agent-updates/s", flush=True)
    soft_ms = rows["soft_repulsion_adhesion"]["ms"]
    print(f"[main] pair_sweep kernel (timed alone at this shape) "
          f"{soft_ms:.3f} ms = {100 * soft_ms / step_ms:.1f}% of a step; "
          f"peak device memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"[main] same_type_fraction {f0:.6f} -> {f1:.6f}; agents {n}; "
          f"dropped {dropped}; fullest cell {fullest}/{sim.geom.cap}; "
          f"launches {launches}", flush=True)
    if n != n_agents:
        fail(f"agents not conserved: {n} != {n_agents}")
    if dropped != 0:
        fail(f"{dropped} agents dropped")
    if not finite:
        fail("non-finite positions")
    expected = dict({n: 0 for n in launches},
                    soft_repulsion_adhesion=steps, same_type=2)
    if launches != expected:
        fail(f"kernel launches {launches} != {expected}")
    if not 0.0 < f0 < 1.0 or not 0.0 < f1 < 1.0:
        fail(f"same_type_fraction out of range: {f0}, {f1}")
    profile(lambda: sim.run(1), "profile", "one step")
    return rows, launches, dict(step_ms=step_ms, peak_bytes=peak)


def self_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


def device_events(prof):
    """The device-side entries of a profile (kernels, copies, memsets)."""
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and self_us(e) > 0]


def device_ms(fn, reps: int):
    """Mean device time of ``fn()`` - every kernel, copy and memset it
    enqueues - over ``reps`` calls after a warm-up, from torch.profiler.
    Unlike CUDA events around back-to-back calls, this does not count the
    gaps in which the card waits for the host.  The profiler now and then
    records no device event at all; it is then asked again, and after
    ``PROFILE_TRIES`` empty traces the time is taken with CUDA events
    instead, and the line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(self_us(e) for e in device_events(prof))
        if total > 0:
            return total / 1e3 / reps
    print(f"[timing] the profiler recorded no device time {PROFILE_TRIES} "
          "times: this time is by CUDA events", flush=True)
    return cuda_ms(fn, reps, warmup=False)


def profile(fn, label: str, what: str, counts=None):
    """Device time by kernel over one call of ``fn`` (torch.profiler), e.g.
    one more step: only the device-side entries, so no time is counted
    twice.  Returns ``{kernel name: device us}`` ({} when nothing was
    recorded); ``counts``, a dict, receives each kernel's event count."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    kernels = device_events(prof)
    if counts is not None:
        counts.update({e.key: e.count for e in kernels})
    total = sum(self_us(e) for e in kernels)
    if total <= 0:
        print(f"[{label}] no device time recorded: not measured",
              flush=True)
        return {}
    print(f"[{label}] {what}, {total / 1e3:.3f} ms of device kernels "
          f"({len(kernels)} kinds):", flush=True)
    for e in sorted(kernels, key=lambda e: -self_us(e))[:12]:
        print(f"[{label}]   {self_us(e) / 1e3:9.3f} ms "
              f"{100 * self_us(e) / total:5.1f}% x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)
    return {e.key: self_us(e) for e in kernels}


def phase_parity(seed: int):
    """Phase 5: kernel vs tiled end to end on the card."""
    sims = {b: cc.simulation(n_agents=1000, seed=seed, interior=(16, 16),
                             sweep_backend=b, device="cuda")
            for b in ("kernel", "tiled")}
    errs = {}
    for steps, tol in ((1, 1e-5), (7, 1e-4)):
        for s in sims.values():
            s.run(steps)
        it = sims["kernel"].iteration
        a, b = sims["kernel"].state, sims["tiled"].state
        if not torch.equal(a.soa.valid, b.soa.valid):
            fail(f"parity: valid differs after {it} steps")
        for name in ("gid_rank", "gid_count", "ctype", "diameter"):
            if not torch.equal(a.soa.attrs[name], b.soa.attrs[name]):
                fail(f"parity: {name} differs after {it} steps")
        err = float((a.soa.pos - b.soa.pos).abs().max())
        errs[it] = err
        print(f"[parity] after {it} steps: slot layout, valid, gids equal; "
              f"max |pos_kernel - pos_tiled| = {err:.3g} (limit {tol:g})",
              flush=True)
        if err > tol:
            fail(f"parity: positions differ by {err} > {tol}")
    return errs


def codec_launches(sim, steps: int):
    """Codec kernel launches a mesh configuration implies over ``steps``
    steps from tick 0: one encode and one decode a float attribute a
    directed edge on a delta step, one position encode and decode an edge
    a step with the migration codec."""
    geom, cfg = sim.geom, sim.engine.delta_cfg
    nd = geom.ndim
    n_float = sum(1 for _, (_, dt) in sim.behavior.schema.all_specs(nd).items()
                  if dt.is_floating_point)
    r = max(int(cfg.refresh_interval), 1)
    delta_steps = sum(1 for t in range(steps) if t % r != 0)
    halo = delta_steps * 2 * nd * n_float if cfg.enabled else 0
    mig = steps * 2 * nd if cfg.enabled and cfg.migration is not None \
        else 0
    return dict(delta_encode=halo, delta_decode=halo,
                migration_pos_encode=mig, migration_pos_decode=mig)


def expected_mesh_launches(sim, steps: int, calls_metric: int):
    """Kernel launches the mesh configuration implies over ``steps`` steps
    from tick 0 with ``calls_metric`` calls of the clustering metric."""
    n_dev = sim.geom.n_devices
    return dict({n: 0 for n in all_launches()},
                soft_repulsion_adhesion=steps * n_dev,
                same_type=calls_metric * n_dev, **codec_launches(sim, steps))


def all_launches():
    return {**ni.LAUNCHES, **dc.LAUNCHES, **fa.LAUNCHES}


def reset_all_launches():
    ni.reset_launches()
    dc.reset_launches()
    fa.reset_launches()


class Capture:
    """Records a copy of the inputs and the output of every call of the
    wrappers ``names`` of ``module`` while it is active (the wrappers still
    run): ``calls[name]`` is a list of ``(args, kwargs, output)``.  With
    ``keep``, only the calls of those indices (0 the first) are recorded;
    ``seen[name]`` counts every call."""

    def __init__(self, module, names, keep=None):
        self.module = module
        self.calls = {name: [] for name in names}
        self.seen = {name: 0 for name in names}
        self.keep = keep
        self._orig = {}

    def __enter__(self):
        def copy(v):
            if isinstance(v, tuple):
                return tuple(copy(a) for a in v)
            return v.clone() if isinstance(v, torch.Tensor) else v

        for name in self.calls:
            fn = getattr(self.module, name)
            self._orig[name] = fn

            def rec(*args, _name=name, _fn=fn, **kw):
                out = _fn(*args, **kw)
                if self.keep is None or self.seen[_name] in self.keep:
                    self.calls[_name].append(
                        (copy(args), {k: copy(v) for k, v in kw.items()},
                         copy(out)))
                self.seen[_name] += 1
                return out

            setattr(self.module, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.module, name, fn)
        return False


def phase_mesh(seed: int):
    """Phase 6: the 2x2 virtual-mesh main path with int8+mig."""
    steps = MAIN_STEPS
    n_agents = 4 * math.prod(MAIN_INTERIOR)
    t0 = time.perf_counter()
    sim = make_sim(cc.behavior(), interior=MESH_INTERIOR,
                   mesh_shape=MESH_SHAPE, cap=MAIN_CAP, delta=MESH_DELTA,
                   sweep_backend="auto", device="cuda")
    cc.init(sim, n_agents, seed=seed)
    torch.cuda.synchronize()
    cfg = sim.engine.delta_cfg
    print(f"[mesh] init {n_agents} agents on mesh {MESH_SHAPE} x "
          f"{sim.geom.local_shape} x {sim.geom.cap} slots: "
          f"{time.perf_counter() - t0:.2f}s; codec {cfg}", flush=True)
    if not (cfg.enabled and cfg.qdtype == torch.int8
            and cfg.migration == torch.int16):
        fail(f"mesh path codec is {cfg}, not int8 + int16 migration")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    f0 = cc.same_type_fraction(sim.state, sim.engine)
    sim.run(1)                                   # step 1: full refresh
    bytes_full = int(sim.state.halo_bytes[0, 0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    sim.run(steps - 1)                           # steps 2-10: delta
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t0
    f1 = cc.same_type_fraction(sim.state, sim.engine)
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()

    st = sim.state
    bytes_delta = int(st.halo_bytes[0, 0])
    step_ms = start.elapsed_time(end) / (steps - 1)
    n = total_agents(st)
    dropped = int(st.dropped.sum())
    overflow = int(st.codec_overflow.max())
    finite = bool(torch.isfinite(st.soa.pos).all())
    fullest = int(st.soa.valid.sum(dim=-1).max())
    print(f"[mesh] steps 2-{steps}: {step_ms:.3f} ms/step (CUDA events), "
          f"host {1e3 * host_s / (steps - 1):.3f} ms/step; "
          f"{n / (step_ms / 1e3):.4g} agent-updates/s; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"[mesh] halo_bytes a device: full step {bytes_full}, delta step "
          f"{bytes_delta}, ratio {bytes_full / bytes_delta:.4f} "
          f"(25/16 = {25 / 16:.4f})", flush=True)
    print(f"[mesh] same_type_fraction {f0:.6f} -> {f1:.6f}; agents {n}; "
          f"dropped {dropped}; codec_overflow {overflow}; fullest cell "
          f"{fullest}/{sim.geom.cap}; launches {launches}", flush=True)
    if n != n_agents:
        fail(f"mesh: agents not conserved: {n} != {n_agents}")
    if dropped != 0:
        fail(f"mesh: {dropped} agents dropped")
    if overflow != 0:
        fail(f"mesh: codec overflow {overflow}")
    if not finite:
        fail("mesh: non-finite positions")
    expected = expected_mesh_launches(sim, steps, calls_metric=2)
    if launches != expected:
        fail(f"mesh: kernel launches {launches} != {expected}")
    if not bytes_full > bytes_delta > 0:
        fail(f"mesh: halo bytes full {bytes_full} / delta {bytes_delta}")
    if not 0.0 < f0 < 1.0 or not 0.0 < f1 < 1.0:
        fail(f"mesh: same_type_fraction out of range: {f0}, {f1}")
    # each device's final block, for phase 16's ranks
    t0 = time.perf_counter()
    block_sha = {c: state_sha(st, c) for c in np.ndindex(*MESH_SHAPE)}
    print(f"[mesh] sha256 of each device's block: "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    if sim.iteration % cfg.refresh_interval == 0:
        fail("mesh: the profiled step would be a full refresh")
    before, counts = sum(dc.LAUNCHES.values()), {}
    times = profile(lambda: sim.run(1), "mesh profile", "one step", counts)
    codec_calls = sum(dc.LAUNCHES.values()) - before
    codec_events = sum(c for k, c in counts.items()
                       if any(n in k for n in CODEC_DEVICE_NAMES))
    if times and codec_events == codec_calls:
        codec_us = sum(us for k, us in times.items()
                       if any(c in k for c in CODEC_DEVICE_NAMES))
        total = sum(times.values())
        print(f"[mesh profile] codec kernels ({codec_calls} launches) "
              f"{codec_us / 1e3:.3f} ms = {100 * codec_us / total:.2f}% of "
              "the delta step's device time", flush=True)
    elif times:
        print(f"[mesh profile] codec kernels: the trace holds "
              f"{codec_events} of the step's {codec_calls} codec launches; "
              "their share is not measured", flush=True)
    with Capture(dc, CODEC_REPLACES) as cap:
        sim.run(1)                               # one more delta step
        torch.cuda.synchronize()
    stats = dict(step_ms=step_ms, peak_bytes=peak, bytes_full=bytes_full,
                 bytes_delta=bytes_delta, host_ms=1e3 * host_s / (steps - 1),
                 block_sha=block_sha)
    return launches, cap.calls, stats


def _outputs(res):
    return res if isinstance(res, tuple) else (res,)


def _codec_equal(name, got, want):
    """Every output bit for bit: the kernels do their plain versions'
    float32 operations one by one (IEEE division, half-to-even rounding,
    no fused multiply-add).  Returns max |got - want| (0.0)."""
    worst = 0.0
    for g, w in zip(_outputs(got), _outputs(want)):
        if g is None and w is None:
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"codec {name}: {g.dtype} {tuple(g.shape)} != "
                 f"{w.dtype} {tuple(w.shape)}")
        if w.dtype == torch.float32:
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
            err = float((g - w).abs().max()) if g.numel() else 0.0
        else:
            same = torch.equal(g, w)
            err = 0.0 if same else float((g.double() - w.double()).abs().max())
        worst = max(worst, err)
        if not same:
            fail(f"codec {name}: outputs differ from the plain version's "
                 f"bits (max |diff| {err})")
    return worst


def _codec_bytes_ops(name, args, kw, out):
    """(bytes, ops) one call needs: each input read once, each output
    written once; float operations per element (per coordinate)."""
    outs = [o for o in _outputs(out) if o is not None]
    tensors = [a for a in list(args) + list(kw.values())
               if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors + outs)
    wrap = any(kw.get("toroidal", ()))
    per = CODEC_OPS[name]
    if name == "migration_pos_encode" and wrap:
        per += 4
    elif name == "migration_pos_decode" and wrap:
        per += 3 + (kw.get("at_l") is not None)
    return nbytes, per * args[0].numel()


def _library(name, args, kw):
    """One PyTorch call computing the same function, or None.  Decoding is
    ``addcmul``; the engine's position decode runs on a closed domain, so
    no ``mod`` follows it there.  No single call quantizes and counts."""
    if name == "delta_decode":
        q, ref, scale = args
        s2 = scale[:, None]
        return lambda: torch.addcmul(ref, q, s2)
    if name == "migration_pos_decode" and not any(kw.get("toroidal", ())):
        q, center, scale = args
        c3 = center[:, None, :]
        st = torch.as_tensor(np.asarray(scale), device=q.device)
        return lambda: torch.addcmul(c3, q, st)
    return None


def codec_traffic(name, recorded):
    """``(key, share)`` of what an encoder's recorded calls hold: for the
    delta encode the share of elements whose delta ``x - ref`` is zero
    (unchanged slots, which skip the division), for the position encode
    the share of live rows; None for a decoder."""
    if name == "delta_encode":
        zero = sum(int(((a[0] - a[1]) == 0).sum()) for a, _, _ in recorded)
        return "zero_delta_share", zero / max(
            sum(a[0].numel() for a, _, _ in recorded), 1)
    if name == "migration_pos_encode":
        rows = live = 0
        for a, kw, _ in recorded:
            valid = kw.get("valid")
            rows += a[0].shape[0] * a[0].shape[1]
            live += (a[0].shape[0] * a[0].shape[1] if valid is None
                     else int(valid.sum()))
        return "live_row_share", live / max(rows, 1)
    return None


def one_operation_ms(label, name, calls):
    """Device ms a call of wrapper ``name`` over its recorded ``calls``
    (``(args, kwargs)``), from the profiler's traces of one call each.
    Fails unless every trace holds only the wrapper's own kernel, at most
    once: a memset or a second kernel fails at once.  A trace without it
    (the profiler dropping the event) is not used; fails unless each call
    has ONE_OPERATION_REPS traces that hold it within ONE_OPERATION_ROUNDS
    rounds of the calls in turn."""
    from torch.profiler import ProfilerActivity, profile

    wrapper = getattr(dc, name)
    own, empty = f"{name}_kernel", 0
    times = [[] for _ in calls]
    for a, kw in calls:
        wrapper(*a, **kw)
    torch.cuda.synchronize()
    for _ in range(ONE_OPERATION_ROUNDS):
        for (a, kw), t in zip(calls, times):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wrapper(*a, **kw)
                torch.cuda.synchronize()
            events = device_events(prof)
            ops = {e.key: e.count for e in events}
            if any(own not in op for op in ops) or sum(ops.values()) > 1:
                fail(f"{label} {name}: a call enqueued {ops}, not one "
                     f"{own}")
            if ops:
                t.append(sum(self_us(e) for e in events))
            else:
                empty += 1
        if min(len(t) for t in times) >= ONE_OPERATION_REPS:
            print(f"[{label}] {name}: each of {len(calls)} calls enqueues "
                  f"one device operation, {own} ({sum(map(len, times))} "
                  f"traces hold it, {empty} hold nothing)", flush=True)
            return sum(sum(t) / len(t) for t in times) / 1e3 / len(calls)
    fail(f"{label} {name}: traces holding each call's kernel "
         f"{[len(t) for t in times]} after {ONE_OPERATION_ROUNDS} rounds, "
         f"fewer than {ONE_OPERATION_REPS}; {empty} held nothing")


def codec_registers(log: str):
    """(kernel, registers, spill stores) of each codec kernel in a ptxas
    report (``-Xptxas -v``), by mangled name."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], 0
        elif name and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in line and any(k in name
                                             for k in CODEC_DEVICE_NAMES):
            out.append((name, int(line.split("Used")[1].split()[0]), spill))
    return out


def phase_codec(calls, label="codec"):
    """Phase 7: every recorded main-path codec call, kernel vs plain; times
    per call.  Every call must enqueue one device operation, its kernel
    (an encoder's one cooperative launch, a decoder's one plain launch),
    and ``ms`` is its device time from traces that hold it
    (``one_operation_ms``); ``plain_ms`` and ``library_ms`` are device time
    from the profiler over all recorded calls; ``event_ms`` is the
    CUDA-event time of the same calls back to back, which at these sizes
    is the wrapper's host time (the card waits between launches).  A key
    ``wrapper@label`` holds that wrapper's calls of another path."""
    _build.load("delta_codec")
    for kernel, regs, spill in codec_registers(
            _build.BUILDS["delta_codec"].log):
        if "decode" in kernel:
            print(f"[{label}] ptxas: {regs} registers, {spill} B spilled: "
                  f"{kernel}", flush=True)
    rows = {}
    for key, recorded in calls.items():
        name = key.split("@")[0]
        if not recorded:
            fail(f"{label}: no {key} call was recorded")
        kernel = getattr(dc, name)
        plain = getattr(dc, name + "_plain")
        k = len(recorded)
        err = 0.0
        bound_s = 0.0
        nbytes_all = ops_all = 0
        libs = []
        for args, kw, _ in recorded:
            got = kernel(*args, **kw)
            torch.cuda.synchronize()
            want = plain(*args, **kw)
            err = max(err, _codec_equal(name, got, want))
            nbytes, ops = _codec_bytes_ops(name, args, kw, got)
            nbytes_all += nbytes
            ops_all += ops
            bound_s += max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
            libs.append(_library(name, args, kw))

        def run(fn):
            return lambda: [fn(*a, **kw) for a, kw, _ in recorded]

        ms = one_operation_ms(label, name, [(a, kw) for a, kw, _ in recorded])
        plain_ms = device_ms(run(plain), 5) / k
        lib_ms = None
        if all(lib is not None for lib in libs):
            lib_ms = device_ms(lambda: [f() for f in libs], 20) / k
        event_ms = cuda_ms(run(kernel), 20) / k
        t_bytes = nbytes_all / HBM_BYTES_PER_S
        t_ops = ops_all / FP32_OPS_PER_S
        shapes = sorted({tuple(a[0].shape) for a, _, _ in recorded})
        rows[key] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=1e3 * bound_s / k,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib_ms, event_ms=event_ms, calls_checked=k,
            bytes_per_call=nbytes_all / k, shapes=[list(s) for s in shapes])
        traffic = codec_traffic(name, recorded)
        if traffic is not None:
            rows[key][traffic[0]] = traffic[1]
            print(f"[{label}] {key}: {traffic[0]} {traffic[1]!r} over the "
                  f"{k} recorded calls", flush=True)
        lib_txt = f"{lib_ms:.5f}" if lib_ms is not None else "none"
        print(f"[{label}] {key}: {k} recorded calls, shapes {shapes}; "
              f"max_abs_err={err:.3g} kernel_ms={ms:.5f} (device; "
              f"{event_ms:.5f} by events back to back) "
              f"plain_ms={plain_ms:.5f} library_ms={lib_txt} "
              f"bound_ms={rows[key]['bound_ms']:.5f} "
              f"({rows[key]['bound_by']}; {nbytes_all / k:.0f} B a call)",
              flush=True)
    return rows


def phase_codec_apart(calls, label="codec"):
    """Phase 7 (``phase_codec``) in a process of its own, on the recorded
    calls saved under ``build/`` for it; returns its rows.  The profiler of
    this long-running process drops kernel events: on an H100, at phase
    13 c, traces of the 18 recorded 3-D delta-encode calls held 7 of them
    in 63 of 80 tries, and traces of one call held nothing in 479 of 540
    (also with the window held open 20 ms before and after), while a
    process that ran only the codec kept every event."""
    path = ROOT / "build" / f"{label.replace(' ', '_')}_calls.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({name: [(a, kw) for a, kw, _ in rec]
                for name, rec in calls.items()}, path)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--codec-calls", str(path), "--codec-label",
                            label], capture_output=True, text=True)
    finally:
        path.unlink(missing_ok=True)
    lines = p.stdout.strip().splitlines()
    for line in lines[:-1] if p.returncode == 0 else lines:
        print(line, flush=True)
    if p.returncode != 0:
        fail(f"{label}: its process exited {p.returncode}: "
             f"{p.stderr.strip()[-2000:]}")
    return json.loads(lines[-1])


def _by_gid(state):
    """(gids, positions) of the live agents, ordered by gid."""
    v = state.soa.valid.reshape(-1)
    gid = ((state.soa.attrs["gid_rank"].reshape(-1)[v].to(torch.int64)
            << 32) + state.soa.attrs["gid_count"].reshape(-1)[v])
    order = torch.argsort(gid)
    return (gid[order].cpu().numpy(),
            state.soa.pos.reshape(-1, 2)[v][order].cpu().numpy())


def _sorted_positions(state):
    v = state.soa.valid.reshape(-1)
    p = state.soa.pos.reshape(-1, 2)[v].cpu().numpy()
    return p[np.lexsort(p.T)]


def _drift_update(attrs, valid, acc, key, params, dt):
    """Every agent moves +1.5 along x a step (the seam test's update)."""
    new = dict(attrs)
    new["pos"] = attrs["pos"] + torch.where(
        valid[..., None], torch.tensor([1.5, 0.0], device=valid.device),
        torch.zeros((), device=valid.device))
    return new, valid, torch.zeros_like(valid), None


def phase_mesh_parity(seed: int):
    """Phase 8: small mesh runs on the card against their references."""
    n = 1000
    out = {}
    one = cc.simulation(n_agents=n, seed=seed, interior=(32, 32),
                        device="cuda")
    off = cc.simulation(n_agents=n, seed=seed, interior=(16, 16),
                        mesh_shape=(2, 2), delta="off", device="cuda")
    one.run(8)
    off.run(8)
    if not one.n_agents() == off.n_agents() == n:
        fail(f"mesh parity: agents {one.n_agents()} / {off.n_agents()}")
    err = float(np.abs(_sorted_positions(one.state)
                       - _sorted_positions(off.state)).max())
    out["off_vs_one_device"] = err
    print(f"[mesh parity] 2x2 full refresh vs one device, 8 steps: max "
          f"|sorted pos| diff {err:.3g} (limit 1e-4)", flush=True)
    if err > 1e-4:
        fail(f"mesh parity: 2x2 vs 1x1 positions differ by {err}")

    # The JAX package's own drift test (tests/test_distributed_abm.py:80)
    # bounds an int16 codec; an int8 one quantizes absolute positions of
    # re-binned slots with a scale set by the largest change (an empty slot
    # that fills), so it drifts further - in the reference exactly as here
    # (tests/test_torch_mesh.py) - and is reported, not bounded.
    sims = {}
    for name, delta in (
            ("off", "off"),
            ("int16+mig", DeltaConfig(enabled=True, qdtype=torch.int16,
                                      refresh_interval=4,
                                      migration=torch.int16)),
            ("int8+mig", DeltaConfig(enabled=True, qdtype=torch.int8,
                                     refresh_interval=4,
                                     migration=torch.int16))):
        sims[name] = make_sim(cc.behavior(), interior=(16, 16),
                              mesh_shape=(2, 2), delta=delta, dt=0.1,
                              device="cuda")
        cc.init(sims[name], n, seed=seed)
        sims[name].run(12)
    ref_gid, ref_pos = _by_gid(sims["off"].state)
    full_bytes = int(sims["off"].state.halo_bytes[0, 0])
    for name in ("int16+mig", "int8+mig"):
        st = sims[name].state
        gid, pos = _by_gid(st)
        if total_agents(st) != n or not np.array_equal(gid, ref_gid):
            fail(f"mesh parity: agents lost or renamed under {name}")
        drift = float(np.abs(pos - ref_pos).max())
        ratio = full_bytes / int(st.halo_bytes[0, 0])
        out[name] = dict(drift=drift, byte_ratio=ratio)
        bounded = name == "int16+mig"
        print(f"[mesh parity] {name} (refresh 4) vs full refresh, 12 steps: "
              f"drift by gid {drift:.4g}"
              f"{' (limit 0.05)' if bounded else ' (reported)'}, wire byte "
              f"ratio {ratio:.4f} (> 1.2), codec_overflow "
              f"{int(st.codec_overflow.max())}", flush=True)
        if not ratio > 1.2 or (bounded and not drift < 0.05):
            fail(f"mesh parity: {name} drift {drift} / byte ratio {ratio}")
    b = sims["int8+mig"].state
    for axis, c in enumerate("xy"):
        for f, sent in b.refs[c + "p_out"].items():
            recv = b.refs[c + "m_in"][f]
            s_bytes = sent.narrow(axis, 0, 1).cpu().numpy().tobytes()
            r_bytes = recv.narrow(axis, 1, 1).cpu().numpy().tobytes()
            if s_bytes != r_bytes:
                fail(f"mesh parity: {c}p_out and the +{c} neighbour's "
                     f"{c}m_in differ in bits ({f})")
    print("[mesh parity] closed loop: every device's xp_out/yp_out equals "
          "its +x/+y neighbour's xm_in/ym_in bit for bit", flush=True)

    torus = torus_sim(seed)
    torus.run(TORUS_STEPS - 1)
    with Capture(dc, ["migration_pos_decode"]) as cap:
        torus.run(1)
        torch.cuda.synchronize()
    st = torus.state
    p = st.soa.pos.reshape(-1, 2)[st.soa.valid.reshape(-1)]
    lx = torus.geom.domain_size[0]
    inside = bool(((p[:, 0] >= 0) & (p[:, 0] < lx)).all())
    out.update(torus_agents=total_agents(st),
               torus_dropped=int(st.dropped.sum()))
    print(f"[mesh parity] 2x1 toroidal, int8+mig, {TORUS_STEPS} steps of "
          f"+1.5 in x: agents {total_agents(st)}/300, dropped "
          f"{int(st.dropped.sum())}, codec_overflow "
          f"{int(st.codec_overflow.max())}, x in [0, {lx}): {inside}",
          flush=True)
    if total_agents(st) != 300 or int(st.dropped.sum()) or not inside:
        fail("mesh parity: agents lost or out of the domain at the seam")
    return out, cap.calls["migration_pos_decode"]


def torus_sim(seed: int, mesh=None):
    """Phase 8's 2x1 toroidal mesh (8 x 8 cells a device, cap 16,
    int8+mig): 300 agents that drift +1.5 in x a step, seeded (on a
    process ``mesh``: this rank's device)."""
    base = cc.behavior()
    drift_beh = Behavior(schema=base.schema, pair_fn=base.pair_fn,
                         pair_attrs=base.pair_attrs,
                         update_fn=_drift_update, radius=base.radius,
                         params=base.params)
    torus = make_sim(drift_beh, interior=(8, 8), mesh_shape=(2, 1), cap=16,
                     boundary="toroidal", delta=MESH_DELTA, dt=1.0,
                     device="cuda", mesh=mesh)
    rng = np.random.default_rng(seed)
    pos = rng.uniform([0.5, 0.5], [31.5, 15.5], (300, 2)).astype(np.float32)
    attrs = {"diameter": np.full((300,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, 300).astype(np.int32)}
    torus.init(pos, attrs)
    return torus


# ---------------------------------------------------------------------------
# Phases 9-10: flash attention and the LM main path
# ---------------------------------------------------------------------------

LM_CONFIG = "olmo-1b"
LM_BATCH, LM_SEQ = 4, 2048          # phase 10 (a): scoring
SERVE_PROMPT, SERVE_NEW, SERVE_MAX = 480, 32, 512   # phase 10 (b)
# Cross-path gates run on float32 copies of the bf16 weights, where the
# two attention backends, and serving and a forward, must agree (float32
# tolerance: 16 layers of sums taken in different orders, cuBLAS and the
# kernel).  In bf16 two paths that round in different places drift apart
# with depth, past the reference's 0.06 / 0.05 at 16 layers (PERF.md
# has the readings).  So in bf16 every attention launch of the forward is held against
# the plain version on its own inputs (ATTN_BF16_ATOL below), and the
# logits are held, position by position, against the float32 forward: a
# bf16 path's largest error there may be at most LM_BF16_MARGIN times the
# bf16 chunked forward's.
LM_F32_TOL = 1e-3
LM_BF16_MARGIN = 2.0
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# bf16 outputs: the kernel and the plain version both round a float32
# result to bf16, and their float32 results differ only in summation order
# (the float32 cases of phase 9 measure it), so they may differ by one
# bf16 ulp of the larger, plus that float32 difference where the output
# is near 0 and its ulp smaller than the difference.
ATTN_BF16_ATOL = 1e-5
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def attention_bound(bh, sq, skv, hd, hdv, causal, dtype):
    """(bound_ms, bound_by, bytes, ops) of one attention call: q, k, v
    read once and the output written once; two operations a multiply-add
    on the (query, key) pairs the mask keeps.  bf16: at the bf16 tensor
    cores' peak.  float32: the smaller of :func:`f32_attention_floors`,
    which is three TF32 products on the tensor cores."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * bh * (sq * hd + skv * hd + skv * hdv + sq * hdv)
    pairs = (sum(min(q + 1, skv) for q in range(sq)) if causal
             else sq * skv)
    ops = 2 * bh * pairs * (hd + hdv)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (ops / BF16_OPS_PER_S if dtype == torch.bfloat16
             else min(f32_attention_floors(ops)) / 1e3)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def f32_attention_floors(ops):
    """(ms, ms): the least time of float32-accurate products of ``ops``
    operations as three TF32 products on the tensor cores (the kernel's
    3xTF32 split), and as float32 FMA on the CUDA cores."""
    return 3e3 * ops / TF32_OPS_PER_S, 1e3 * ops / FP32_OPS_PER_S


def attention_f64(q, k, v, causal):
    """The attention of float32 ``(BH, S, d)`` q, k, v in float64, 8 heads
    at a time: what both float32 versions are measured against."""
    sq, skv = q.shape[1], k.shape[1]
    above = (torch.arange(sq, device=q.device)[:, None]
             < torch.arange(skv, device=q.device)[None, :])
    out = torch.empty(v.shape[0], sq, v.shape[2], dtype=torch.float64,
                      device=q.device)
    for h in range(0, q.shape[0], 8):
        s = torch.einsum("bqd,bkd->bqk", q[h:h + 8].double(),
                         k[h:h + 8].double()) * q.shape[2] ** -0.5
        if causal:
            s = s.masked_fill(above[None], fa.NEG_INF)
        out[h:h + 8] = torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1),
                                    v[h:h + 8].double())
    return out


def _bf16_ulp(x):
    """One bf16 ulp of each element of the float32 ``x`` (2^-8 at 0)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def _attn_err(got, want, label):
    """Max |got - want|; fails beyond ATTN_TOL (abs and rel) for the type,
    and for bf16 beyond one ulp of the larger plus ATTN_BF16_ATOL."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: {got.dtype} {tuple(got.shape)} != {want.dtype} "
             f"{tuple(want.shape)}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    tol = ATTN_TOL[got.dtype]
    if not torch.allclose(g, w, atol=tol, rtol=tol):
        fail(f"{label}: max abs error {err} > {tol} (abs and rel)")
    if got.dtype == torch.bfloat16:
        bound = _bf16_ulp(torch.maximum(g.abs(), w.abs())) + ATTN_BF16_ATOL
        over = int((diff > bound).sum())
        if over:
            fail(f"{label}: {over} outputs differ by more than one bf16 ulp "
                 f"+ {ATTN_BF16_ATOL}")
    return err


def phase_flash(seed: int):
    """Phase 9: both attention kernels against their plain version: the
    wgmma kernel on bf16, the 3xTF32 kernel on float32."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, s, hd = LM_BATCH, 16, LM_SEQ, 128
    scale = hd ** -0.5
    errs, rows = {}, {}
    for dtype in (torch.float32, torch.bfloat16):   # bf16 last: GQA below
        name = fa.kernel_for(dtype, hd, hd)
        q4, k4, v4 = (_randn(gen, (b, h, s, hd), dtype) for _ in range(3))
        q, k, v = (t.reshape(b * h, s, hd) for t in (q4, k4, v4))
        for causal in (True, False):
            before = fa.LAUNCHES[name]
            got = fa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if fa.LAUNCHES[name] != before + 1:
                fail(f"flash: the {name} launch counter did not move")
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            label = (f"main_{'causal' if causal else 'full'}"
                     f"{'_f32' if dtype == torch.float32 else ''}")
            errs[label] = _attn_err(got, want, f"flash {label}")
            if dtype == torch.float32:    # reported, not gated
                exact = attention_f64(q, k, v, causal)
                print(f"[flash] {label}: max |x - float64 attention| "
                      f"kernel {float((got - exact).abs().max()):.4e}, "
                      f"plain {float((want - exact).abs().max()):.4e}",
                      flush=True)
                del exact
            del got, want
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), 10)
        b_ms, b_by, nbytes, nops = attention_bound(b * h, s, s, hd, hd,
                                                   True, dtype)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                          ops=nops, dtype=str(dtype).split(".")[-1])
        print(f"[flash] {name}, main shape ({b}x{h}, {s}, {hd}) "
              f"{rows[name]['dtype']} causal: kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"(scaled_dot_product_attention) bound_ms={b_ms:.4f} "
              f"({b_by}; {nbytes} B, {nops} ops); "
              f"{nops / (ms / 1e3) / 1e12:.2f} TFLOP/s", flush=True)
        if dtype == torch.float32:
            tf32_ms, core_ms = f32_attention_floors(nops)
            profile(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True),
                "flash", "scaled_dot_product_attention in float32")
            print(f"[flash] {name} float32 bounds: {tf32_ms:.4f} ms as "
                  f"three TF32 products at {TF32_OPS_PER_S / 1e12:.0f} "
                  f"TFLOP/s (the kernel's 3xTF32; bound_ms), "
                  f"{core_ms:.4f} ms as float32 FMA at "
                  f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s (CUDA cores)",
                  flush=True)

    # What the split of p buys: the bf16 kernel on bf16(p) alone (reported,
    # not gated: the wrapper always runs p_hi and p_lo).
    want = fa.flash_attention_plain(q, k, v, causal=True)
    single = fa._launch(q, k, v, True, scale, p_terms=1)
    diff = (single.float() - want.float()).abs()
    over = int((diff > _bf16_ulp(torch.maximum(single.float().abs(),
                                               want.float().abs()))
                + ATTN_BF16_ATOL).sum())
    single_p = dict(max_abs_err=float(diff.max()), outputs_beyond_ulp=over,
                    outputs=diff.numel(),
                    ms=cuda_ms(lambda: fa._launch(q, k, v, True, scale,
                                                  p_terms=1), 10))
    del single, want, diff
    print(f"[flash] bf16 p alone instead of p_hi + p_lo: max_abs_err "
          f"{single_p['max_abs_err']:.4g} (split {errs['main_causal']:.4g}),"
          f" {over} of {single_p['outputs']} outputs beyond one bf16 ulp + "
          f"{ATTN_BF16_ATOL}; {single_p['ms']:.4f} ms (split "
          f"{rows['flash_attention_wgmma']['ms']:.4f})", flush=True)

    qf, kf, vf = (_randn(gen, (16, 512, 64), torch.float32)
                  for _ in range(3))
    errs["f32_16x512x64"] = _attn_err(
        fa.flash_attention(qf, kf, vf), fa.flash_attention_plain(qf, kf, vf),
        "flash f32 16x512x64")
    kg, vg = k4[:, :2].contiguous(), v4[:, :2].contiguous()   # 2 KV heads
    before = fa.LAUNCHES["flash_attention_wgmma"]
    got = ops.flash_attention_bhsd(q4, kg, vg, causal=True)
    if fa.LAUNCHES["flash_attention_wgmma"] != before + 1:
        fail("flash gqa: not on the flash_attention_wgmma kernel")
    want = fa.flash_attention_plain(
        q, kg.repeat_interleave(8, dim=1).reshape(b * h, s, hd),
        vg.repeat_interleave(8, dim=1).reshape(b * h, s, hd))
    errs["gqa_hkv2"] = _attn_err(got, want.reshape(b, h, s, hd), "flash gqa")
    del got, want

    # Head dim 80 (hubert-xlarge's), which the wrapper zero-pads to 128:
    # the bf16 case on the wgmma kernel, float32 on the 3xTF32 one.
    for dtype in (torch.float32, torch.bfloat16):
        name = fa.kernel_for(dtype, 128, 128)
        sfx = "_f32" if dtype == torch.float32 else ""
        q4, k4, v4 = (_randn(gen, (b, h, s, 80), dtype) for _ in range(3))
        q, k, v = (t.reshape(b * h, s, 80) for t in (q4, k4, v4))
        for causal in (True, False):
            before = dict(fa.LAUNCHES)
            got = fa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if (fa.LAUNCHES[name] != before[name] + 1
                    or sum(fa.LAUNCHES.values()) != sum(before.values()) + 1):
                fail(f"flash hd 80: not one launch of {name}")
            label = f"hd80_{'causal' if causal else 'full'}{sfx}"
            errs[label] = _attn_err(
                got, fa.flash_attention_plain(q, k, v, causal=causal),
                f"flash {label}")
            del got
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), 10)
        b_ms, b_by, nbytes, nops = attention_bound(b * h, s, s, 80, 80,
                                                   True, dtype)
        rows[name]["hd80"] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by, useful_share=80 / 128)
        print(f"[flash] {name} at head dim 80, padded to 128, "
              f"({b}x{h}, {s}, 80) causal: kernel_ms={ms:.4f} (at 128: "
              f"{rows[name]['ms']:.4f}) plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}; of "
              f"the true 80 columns); 80/128 of the work is useful",
              flush=True)
    print(f"[flash] max_abs_err {errs}", flush=True)
    f32 = ("main_causal_f32", "main_full_f32", "f32_16x512x64",
           "hd80_causal_f32", "hd80_full_f32")
    rows["flash_attention"]["max_abs_err"] = max(errs[n] for n in f32)
    rows["flash_attention_wgmma"]["max_abs_err"] = max(
        v for n, v in errs.items() if n not in f32)
    rows["flash_attention_wgmma"]["p_alone"] = single_p
    return dict(rows=rows, errs=errs)


def _lm_close(got, want, label, atol, rtol, vocab):
    """Max |got - want| over the real vocabulary columns; fails beyond
    ``atol + rtol * |want|``."""
    if got.shape != want.shape:
        fail(f"{label}: shapes {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got[..., :vocab].float(), want[..., :vocab].float()
    err = float((g - w).abs().max())
    if not torch.allclose(g, w, atol=atol, rtol=rtol):
        fail(f"{label}: logits differ by up to {err} (atol {atol}, rtol "
             f"{rtol})")
    return err


def _bf16_ratio(got, base, ref, vocab):
    """Largest ratio, over positions, of ``got``'s to ``base``'s largest
    distance from the float32 logits ``ref`` at that position; also the two
    largest distances."""
    def dist(x):
        return (x[..., :vocab].float() - ref[..., :vocab].float()
                ).abs().amax(dim=-1)

    d_got, d_base = dist(got), dist(base)
    return (float((d_got / d_base).max()), float(d_got.max()),
            float(d_base.max()))


def serve_batch(model, params, prompt, cache, pos0: int, n_new: int):
    """Greedy serving: prefill the inputs ``prompt`` (``pos0`` positions)
    into ``cache``, then ``n_new`` decode steps.  Returns the logits of the
    prefill's last position and of every step ``(B, n_new + 1, V)``, the
    generated tokens ``(B, n_new)``, the prefill's ms and the ms a decode
    step (CUDA events)."""
    prefill = lm_steps.make_prefill_step(model)
    decode = lm_steps.make_serve_decode_step(model)
    start, mid, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    start.record()
    logits, cache = prefill(params, prompt, cache)
    mid.record()
    rows, gen_tok = [logits[:, -1]], []
    for t in range(n_new):
        nxt = torch.argmax(rows[-1], dim=-1).to(torch.int32)[:, None]
        gen_tok.append(nxt)
        logits, cache = decode(params, cache, nxt, pos0 + t)
        rows.append(logits[:, -1])
    end.record()
    end.synchronize()
    return (torch.stack(rows, dim=1), torch.cat(gen_tok, dim=1),
            start.elapsed_time(mid), mid.elapsed_time(end) / n_new)


def serve(model, params, prompt, cache):
    """Phase 10's serving: ``SERVE_NEW`` greedy tokens after ``prompt``;
    returns :func:`serve_batch`'s logits, the prompt with the generated
    tokens, and its two times."""
    rows, gen_tok, prefill_ms, decode_ms = serve_batch(
        model, params, {"tokens": prompt}, cache, prompt.shape[1], SERVE_NEW)
    seq = torch.cat([prompt, gen_tok], dim=1)
    if seq.shape[1] != SERVE_MAX:
        fail(f"serving: {seq.shape[1]} tokens, not {SERVE_MAX}")
    return rows, seq, prefill_ms, decode_ms


def phase_lm(seed: int):
    """Phase 10: olmo-1b scoring and greedy serving at full size."""
    cfg = get_config(LM_CONFIG).full
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model.load_params(P.init(model.spec, gen, device="cuda"))
    params = model.params
    torch.cuda.synchronize()
    n_params = P.count_params(model.spec)
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.hd}, vocab {cfg.padded_vocab}; "
          f"{n_params} parameters in bf16 from params.init: "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    tok = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ + 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    out = {}
    with torch.no_grad():
        # (a) scoring; a warm-up forward first, then the counted one
        lm_steps.loss_fn(model, params, batch, backend="kernel")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss = lm_steps.loss_fn(model, params, batch, backend="kernel")
        end.record()
        end.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
        launches = all_launches()
        peak = torch.cuda.max_memory_allocated()
        fwd_ms = start.elapsed_time(end)
        loss = float(loss)
        expected = {n: 0 for n in launches}
        expected["flash_attention_wgmma"] = cfg.n_layers   # bf16, hd 128
        if launches != expected:
            fail(f"lm scoring: kernel launches {launches} != {expected}")
        if not math.isfinite(loss):
            fail(f"lm scoring: loss {loss}")
        tokens = LM_BATCH * LM_SEQ
        print(f"[lm] scoring {LM_BATCH}x{LM_SEQ}: loss {loss:.6f} "
              f"(ln vocab {math.log(cfg.vocab):.6f}); {fwd_ms:.3f} ms a "
              f"forward + loss (CUDA events; host {host_ms:.3f}), "
              f"{tokens / (fwd_ms / 1e3):.6g} tokens/s; peak device memory "
              f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)
        times = profile(lambda: lm_steps.loss_fn(model, params, batch,
                                                  backend="kernel"),
                         "lm profile", "one scoring forward + loss")
        attn_share = None
        if times:
            attn_us = sum(us for k, us in times.items()
                          if "flash_wgmma_kernel" in k
                          or "flash_attention_kernel" in k)
            attn_share = attn_us / sum(times.values())
            print(f"[lm profile] attention kernels {attn_us / 1e3:.3f} ms "
                  f"= {100 * attn_share:.1f}% of the forward's device "
                  "time", flush=True)
        # every attention launch of one more forward, against the plain
        # version on that launch's own inputs
        before = dict(fa.LAUNCHES)
        with Capture(fa, ["flash_attention"]) as cap:
            kern = model.logits(params, batch, backend="kernel")
        calls = cap.calls["flash_attention"]
        if len(calls) != cfg.n_layers or fa.LAUNCHES["flash_attention_wgmma"] \
                != before["flash_attention_wgmma"] + cfg.n_layers:
            fail(f"lm scoring: {len(calls)} attention calls recorded, "
                 f"launches {before} -> {fa.LAUNCHES}; expected "
                 f"{cfg.n_layers} on flash_attention_wgmma")
        err_launch = max(_attn_err(got, fa.flash_attention_plain(*qkv, **kw),
                                   f"lm attention launch {i}")
                         for i, (qkv, kw, got) in enumerate(calls))
        del calls, cap
        finite = bool(torch.isfinite(kern[..., :cfg.vocab]).all())
        masked = (float(kern[..., cfg.vocab:].float().max())
                  if cfg.padded_vocab > cfg.vocab else -math.inf)
        if kern.shape != (LM_BATCH, LM_SEQ, cfg.padded_vocab) or not finite \
                or masked > -1e29:
            fail(f"lm scoring: logits {tuple(kern.shape)}, finite {finite}, "
                 f"padded columns up to {masked}")
        chunked = model.logits(params, batch, backend="chunked")
        chunked_ms = cuda_ms(lambda: model.logits(params, batch,
                                                  backend="chunked"), 1)
        # The same weights in float32: the two backends must agree there;
        # in bf16 each is held against this float32 forward.
        p32 = P.tree_map(lambda a: a.float(), params)
        ref = model.logits(p32, batch, backend="chunked")
        # the float32 kernel's path: the kernel backend on float32 weights,
        # its launches counted
        reset_all_launches()
        kern32 = model.logits(p32, batch, backend="kernel")
        torch.cuda.synchronize()
        f32_launches = all_launches()
        expected = {n: 0 for n in f32_launches}
        expected["flash_attention"] = cfg.n_layers
        if f32_launches != expected:
            fail(f"lm scoring, float32 weights: kernel launches "
                 f"{f32_launches} != {expected}")
        err_f32 = _lm_close(kern32, ref,
                            "lm kernel vs chunked (float32 weights)",
                            LM_F32_TOL, LM_F32_TOL, cfg.vocab)
        del kern32
        v = cfg.vocab
        ratio, err_k, err_c = _bf16_ratio(kern, chunked, ref, v)
        bf16_diff = float((kern[..., :v].float()
                           - chunked[..., :v].float()).abs().max())
        del kern, chunked, ref
        print(f"[lm] {cfg.n_layers} attention launches of a forward vs the "
              f"plain version on their inputs: max abs diff {err_launch:.4g} "
              f"(one bf16 ulp + {ATTN_BF16_ATOL}); float32 weights: logits "
              f"kernel vs chunked backend max abs diff {err_f32:.4g} (limit "
              f"{LM_F32_TOL} abs and rel); bf16 weights: max |logits - "
              f"float32 forward| kernel {err_k:.5g}, chunked {err_c:.5g}, "
              f"largest ratio at one position {ratio:.4g} (limit "
              f"{LM_BF16_MARGIN}); max |kernel - chunked| {bf16_diff:.4g} "
              f"(reported); chunked forward {chunked_ms:.3f} ms", flush=True)
        if not ratio <= LM_BF16_MARGIN:
            fail(f"lm scoring: bf16 kernel backend up to {ratio} x the "
                 "chunked backend's distance from the float32 forward")
        out.update(score_ms=fwd_ms, score_host_ms=host_ms,
                   score_tokens_per_s=tokens / (fwd_ms / 1e3), loss=loss,
                   score_peak_bytes=peak, score_launches=launches,
                   f32_launches=f32_launches, attention_share=attn_share,
                   launch_vs_plain=err_launch, kernel_vs_chunked_f32=err_f32,
                   bf16_max_err_kernel=err_k, bf16_max_err_chunked=err_c,
                   bf16_ratio=ratio, bf16_kernel_vs_chunked=bf16_diff,
                   chunked_ms=chunked_ms)

        # (b) greedy serving: bf16, timed and counted
        prompt = tok[:, :SERVE_PROMPT]
        cache = model.init_cache(LM_BATCH, SERVE_MAX, device="cuda")
        decode = lm_steps.make_serve_decode_step(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        got, seq, prefill_ms, decode_ms = serve(model, params, prompt, cache)
        serve_launches = all_launches()
        serve_peak = torch.cuda.max_memory_allocated()
        if any(serve_launches.values()):
            fail(f"serving: prefill/decode launched {serve_launches}; "
                 "they run the plain attention paths")
        times = profile(lambda: decode(params, cache, seq[:, -1:],
                                       SERVE_MAX - 1),
                        "lm profile", "one more decode step (the last again)")
        decode_device_ms = sum(times.values()) / 1e3 if times else None
        if decode_device_ms is not None:
            print(f"[lm profile] a decode step: {decode_device_ms:.3f} ms "
                  f"of device kernels in {decode_ms:.3f} ms: the card idles "
                  f"{100 * (1 - decode_device_ms / decode_ms):.1f}% of it",
                  flush=True)
        # bf16: the prefill's row is the chunked forward's own computation;
        # the decode steps are held, position by position, against the
        # float32 forward over the same tokens, as scoring is
        fwd = model.logits(params, {"tokens": seq},
                           backend="chunked")[:, SERVE_PROMPT - 1:]
        ref = model.logits(p32, {"tokens": seq},
                           backend="chunked")[:, SERVE_PROMPT - 1:]
        err_prefill = _lm_close(got[:, :1], fwd[:, :1],
                                "serving: prefill vs chunked forward (bf16)",
                                0.06, 0.05, v)
        serve_ratio, _, _ = _bf16_ratio(got, fwd, ref, v)
        bf16_serve = float((got[..., :v].float()
                            - fwd[..., :v].float()).abs().max())
        del fwd, ref
        # float32 weights and cache: the serving path against a kernel
        # forward over the same tokens
        cache32 = tuple(c.float() for c in model.init_cache(
            LM_BATCH, SERVE_MAX, device="cuda"))
        got, seq, _, _ = serve(model, p32, prompt, cache32)
        full = model.logits(p32, {"tokens": seq}, backend="kernel")
        err_serve = _lm_close(got, full[:, SERVE_PROMPT - 1:],
                              "serving vs kernel forward (float32)",
                              LM_F32_TOL, LM_F32_TOL, v)
        del p32, cache32, full
        print(f"[lm] serving {LM_BATCH} x {SERVE_PROMPT}-token prompts, "
              f"{SERVE_NEW} greedy tokens, cache {SERVE_MAX}: prefill "
              f"{prefill_ms:.3f} ms, {decode_ms:.3f} ms a decode step, "
              f"{LM_BATCH / (decode_ms / 1e3):.6g} decode tokens/s; peak "
              f"device memory {serve_peak / 2**30:.2f} GiB; logits at "
              f"{SERVE_PROMPT - 1}..{SERVE_MAX - 1} vs a kernel forward over "
              f"the {SERVE_MAX} tokens: float32 max abs diff {err_serve:.4g} "
              f"(limit {LM_F32_TOL}); bf16: prefill vs chunked forward "
              f"{err_prefill:.4g} (limit 0.06 abs, 0.05 rel), largest ratio "
              f"of a position's distance from the float32 forward to the "
              f"chunked forward's {serve_ratio:.4g} (limit {LM_BF16_MARGIN}),"
              f" max |serving - chunked forward| {bf16_serve:.4g} (reported)",
              flush=True)
        if not serve_ratio <= LM_BF16_MARGIN:
            fail(f"serving: bf16 logits up to {serve_ratio} x the chunked "
                 "forward's distance from the float32 forward")
        out.update(prefill_ms=prefill_ms, decode_step_ms=decode_ms,
                   decode_tokens_per_s=LM_BATCH / (decode_ms / 1e3),
                   serve_peak_bytes=serve_peak, serve_vs_forward_f32=err_serve,
                   decode_step_device_ms=decode_device_ms,
                   serve_prefill_vs_forward_bf16=err_prefill,
                   serve_bf16_ratio=serve_ratio,
                   serve_vs_forward_bf16=bf16_serve)
    return out


# ---------------------------------------------------------------------------
# Phase 11: the legacy neighbor_force kernel on gathered slabs
# ---------------------------------------------------------------------------

FORCE_INTERIOR = (1024, 1024)
FORCE_KW = dict(radius=2.0, repulsion=2.0, adhesion=0.6)
FORCE_CHUNK = 4096                  # cells a plain-version chunk


def force_slabs(soa):
    """The legacy kernel's ten slabs, gathered from an aura-filled SoA as
    ``neighborhood_slabs`` builds them; the single gid is ``gid_count``
    (one device: every ``gid_rank`` is 0)."""
    ai, aj, vi, vj = ni.neighborhood_slabs(soa.attrs, soa.valid,
                                           ("diameter", "ctype"))

    def side(a, v):
        return [a["pos"].contiguous(), a["diameter"].contiguous(),
                a["ctype"].contiguous(), v.contiguous(),
                a["gid_count"].contiguous()]

    return side(ai, vi) + side(aj, vj)


def sector_bytes(valid, sizes):
    """Bytes of the 32-byte sectors that hold the valid rows of columns of
    ``sizes`` bytes a row, laid out like ``valid``."""
    rows = valid.reshape(-1).nonzero().squeeze(1)    # ascending
    return sum(32 * torch.unique_consecutive(rows * size // 32).numel()
               for size in sizes)


def force_plain_chunked(args, kw):
    """The plain version ``FORCE_CHUNK`` cells at a time (its (C, K, NK)
    pair tensors would not fit at once); also counts the pairs within the
    radius, the work the law does on this data."""
    c = args[0].shape[0]
    parts, in_radius = [], 0
    r2 = torch.tensor(np.float32(kw["radius"] ** 2), device="cuda")
    for c0 in range(0, c, FORCE_CHUNK):
        sl = [a[c0:c0 + FORCE_CHUNK] for a in args]
        parts.append(ni.neighbor_force_plain(*sl, **kw))
        disp = sl[5][:, None] - sl[0][:, :, None]
        near = ((disp * disp).sum(-1) <= r2) & sl[3][:, :, None] \
            & sl[8][:, None] & (sl[4][:, :, None] != sl[9][:, None])
        in_radius += int(near.sum())
    return torch.cat(parts), in_radius


def phase_force(seed: int):
    """Phase 11: ``ops.neighbor_force`` at the main size, then against its
    plain version, and on the reference test's (C, K) cases."""
    n_agents = 4 * math.prod(FORCE_INTERIOR)
    sim = make_sim(cc.behavior(), interior=FORCE_INTERIOR, cap=MAIN_CAP,
                   device="cuda")
    cc.init(sim, n_agents, seed=seed)
    sim.run(1)
    refs = {d: {f: v[0, 0] for f, v in s.items()}
            for d, s in sim.state.refs.items()}
    soa, _, _, _ = halo_exchange(
        sim.geom, clear_ring(device_block(sim.state.soa, (0, 0))),
        LocalComm(toroidal=sim.geom.toroidal), refs, sim.engine.delta_cfg,
        True)
    del sim
    args = force_slabs(soa)
    del soa
    gc.collect()
    torch.cuda.empty_cache()
    c, k = args[3].shape
    nk = args[8].shape[1]
    nbytes = sum(a.numel() * a.element_size() for a in args) + c * k * 2 * 4
    print(f"[force] slabs of {c} cells, K {k}, NK {nk}: {nbytes / 1e9:.3f} "
          f"GB read and written; {int(args[3].sum())} agents", flush=True)

    reset_all_launches()
    got = ops.neighbor_force(*args, **FORCE_KW)            # the entry point
    torch.cuda.synchronize()
    launches = all_launches()
    expected = {n: 0 for n in launches}
    expected["neighbor_force"] = 1
    if launches != expected:
        fail(f"force: kernel launches {launches} != {expected}")
    plain_t0 = torch.cuda.Event(enable_timing=True)
    plain_t1 = torch.cuda.Event(enable_timing=True)
    plain_t0.record()
    want, in_radius = force_plain_chunked(args, FORCE_KW)
    plain_t1.record()
    plain_t1.synchronize()
    plain_ms = plain_t0.elapsed_time(plain_t1)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=1e-5, rtol=1e-5):
        fail(f"force: max abs error {err} > 1e-5")
    del got, want
    ms = cuda_ms(lambda: ni.neighbor_force(*args, **FORCE_KW), 5)
    valid_pairs = int((args[3].sum(1, dtype=torch.int64)
                       * args[8].sum(1, dtype=torch.int64)).sum())
    nops = OPS_DISTANCE_TEST * valid_pairs \
        + OPS_LAW["soft_repulsion_adhesion"] * in_radius
    # the bytes a valid-first read needs: both valid columns whole, the
    # 32-byte sectors of the other columns that hold valid rows, the output
    sizes = (8, 4, 4, 4)              # pos, diameter, type, gid
    first_bytes = (args[3].numel() + args[8].numel() + c * k * 2 * 4
                   + sector_bytes(args[3], sizes)
                   + sector_bytes(args[8], sizes))
    t_ops = nops / FP32_OPS_PER_S
    dense_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, t_ops)
    t_bytes = first_bytes / HBM_BYTES_PER_S
    b_ms = 1e3 * max(t_bytes, t_ops)
    b_by = "bytes" if t_bytes >= t_ops else "operations"
    del args
    gc.collect()
    torch.cuda.empty_cache()

    small = {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for cc_, kk in ((8, 8), (16, 16), (4, 32)):
        def side(n):
            return [torch.rand((cc_, n, 2), generator=gen,
                               device="cuda") * 10,
                    0.5 + torch.rand((cc_, n), generator=gen, device="cuda"),
                    torch.randint(0, 2, (cc_, n), generator=gen,
                                  device="cuda", dtype=torch.int32),
                    torch.rand((cc_, n), generator=gen, device="cuda") < 0.8,
                    torch.randint(0, 10_000, (cc_, n), generator=gen,
                                  device="cuda", dtype=torch.int32)]

        a = side(kk) + side(9 * kk)
        kw = dict(radius=2.0, repulsion=2.0, adhesion=0.4)
        g_, w_ = ni.neighbor_force(*a, **kw), ni.neighbor_force_plain(*a,
                                                                      **kw)
        e = float((g_ - w_).abs().max())
        if not torch.allclose(g_, w_, atol=1e-5, rtol=1e-5):
            fail(f"force ({cc_}, {kk}): max abs error {e} > 1e-5")
        small[f"{cc_}x{kk}"] = e
    print(f"[force] max_abs_err {err:.3g} at the main shape, {small} on the "
          f"reference test's cases; kernel_ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}; {first_bytes} B "
          f"read valid-first and written, {nops} ops; {in_radius} pairs "
          f"within the radius); dense bound {dense_ms:.4f} ms ({nbytes} B "
          f"if every slab row is read)", flush=True)
    return dict(launches=launches["neighbor_force"],
                max_abs_err=max([err] + list(small.values())), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, bytes=first_bytes, ops=nops,
                small_errs=small)


# ---------------------------------------------------------------------------
# Phase 12: the other bundled sims, the RNG and the spawn path
# ---------------------------------------------------------------------------

SIM_AGENTS = 4 * math.prod(MAIN_INTERIOR)    # epidemiology, sir_mechanics
SIM_INFECTED = round(0.05 * SIM_AGENTS)      # the reference's 30 of 600
SIM_STEPS = 10
EPI_CAP = 24                                 # epidemiology's own cap
SIRM_CAP = 32                                # sir_mechanics' own cap
SIRM_CAP_RAISED = 48                         # if 32 drops agents
# The spawn sims on the reference's init geometry, a disk of radius L/8
# at the centre, cap 32.  The reference's densities (~16 and ~26 agents
# a cell) overflow cap 32 at init, so the seeds are cut to 8 agents a
# cell (2 a unit^2) for proliferation and 4 (1 a unit^2) for oncology.
SPAWN_CAP = 32
PROLIF_DENSITY, ONC_DENSITY = 2.0, 1.0       # agents a unit^2 in the disk
PROLIF_STEPS, ONC_STEPS = 20, 10             # proliferation: the default


def drive(sim, steps, label, collect):
    """``steps`` steps with the launch counts zeroed just before and read
    just after; per-step device ms by CUDA events around each of steps
    2.. alone; peak memory; ``collect(sim)`` (a device tensor, read after
    the last step) after every step, outside the timed windows."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    series = []
    sim.run(1)
    series.append(collect(sim))
    torch.cuda.synchronize()
    windows = []
    for _ in range(steps - 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sim.run(1)
        end.record()
        windows.append((start, end))
        series.append(collect(sim))
    torch.cuda.synchronize()
    series = [tuple(int(v) for v in t.tolist()) for t in series]
    launches = {k: v for k, v in all_launches().items() if v}
    step_ms = sum(a.elapsed_time(b) for a, b in windows) / (steps - 1)
    peak = torch.cuda.max_memory_allocated()
    n = total_agents(sim.state)
    print(f"[{label}] steps 2-{steps}: {step_ms:.3f} ms/step (CUDA events),"
          f" "
          f"{n / (step_ms / 1e3):.4g} agent-updates/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    return series, launches, dict(step_ms=step_ms, peak_bytes=peak,
                                  agents=n)


def sir_counts_of(sim):
    st, v = sim.state.soa.attrs["state"], sim.state.soa.valid
    return torch.stack([((st == c) & v).sum() for c in (ep.S, ep.I, ep.R)])


def check_launches(launches, law, steps, label):
    want = {ni.law_for(LAW_ARGS[law][0]).name: steps}
    if launches != want:
        fail(f"{label}: kernel launches {launches} != {want}")


def rng_row(sim, uniforms: int = 2):
    """An update's draws at the step's shapes, timed alone: a normal over
    every slot and axis (threefry bits, then the uniform transform and
    XLA's erfinv) and ``uniforms`` uniforms over every slot (epidemiology
    draws two, tumor_spheroid one); ms a step and ns a draw."""
    key = prng.fold_in(sim.state.key[(0,) * sim.geom.ndim], 0)
    shape_u = sim.geom.interior + (sim.geom.cap,)
    shape_n = shape_u + (sim.geom.ndim,)
    n_u, n_n = math.prod(shape_u), math.prod(shape_n)
    bits_ms = (cuda_ms(lambda: prng.random_bits(key, shape_n), 3)
               + uniforms * cuda_ms(lambda: prng.random_bits(key, shape_u),
                                    3))
    normal_ms = cuda_ms(lambda: prng.normal(key, shape_n), 3)
    uniform_ms = cuda_ms(lambda: prng.uniform(key, shape_u), 3)
    total = normal_ms + uniforms * uniform_ms
    return dict(threefry_ms=bits_ms, normal_ms=normal_ms,
                uniform_ms=uniform_ms, total_ms=total,
                ns_per_normal=1e6 * normal_ms / n_n,
                ns_per_uniform=1e6 * uniform_ms / n_u,
                draws=n_n + uniforms * n_u)


def phase_epidemiology(seed: int):
    """Phase 12 (a): epidemiology at the main path's width, 10 steps."""
    t0 = time.perf_counter()
    sim = make_sim(ep.behavior(), interior=MAIN_INTERIOR, cap=EPI_CAP,
                   boundary="toroidal", dt=1.0, sweep_backend="auto",
                   device="cuda")
    ep.init(sim, SIM_AGENTS, SIM_INFECTED, seed=seed)
    torch.cuda.synchronize()
    s0 = ep.sir_counts(sim.state)
    print(f"[epidemiology] init {SIM_AGENTS} agents ({s0[1]} infected) on "
          f"{sim.geom.local_shape} x {EPI_CAP} slots: "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    series, launches, stats = drive(sim, SIM_STEPS, "epidemiology",
                                    sir_counts_of)
    print(f"[epidemiology] S/I/R by step {[s0] + series}", flush=True)
    for t, c in enumerate(series):
        if sum(c) != SIM_AGENTS:
            fail(f"epidemiology: S+I+R = {sum(c)} != {SIM_AGENTS} at step "
                 f"{t + 1}")
    if int(sim.state.dropped.sum()) != 0:
        fail(f"epidemiology: {int(sim.state.dropped.sum())} agents dropped")
    if not series[-1][2] > 0 or not series[-1][0] < s0[0]:
        fail(f"epidemiology: no infection or recovery ({series[-1]})")
    check_launches(launches, "epidemiology", SIM_STEPS, "epidemiology")
    if not torch.isfinite(sim.state.soa.pos).all():
        fail("epidemiology: non-finite positions")
    sim.run(1)                                      # a mid-run SoA (step 11)
    row = law_row(aura_block(sim), sim.geom, "epidemiology", 8, 5,
                  "epidemiology")
    rng = rng_row(sim)
    times = profile(lambda: sim.run(1), "epidemiology profile", "one step")
    step_dev = sum(times.values()) / 1e3 if times else stats["step_ms"]
    print(f"[epidemiology] RNG of a step, timed alone at its shapes: "
          f"{rng['total_ms']:.3f} ms = {100 * rng['total_ms'] / step_dev:.1f}"
          f"% of a step's {step_dev:.3f} ms of device time (threefry "
          f"{rng['threefry_ms']:.3f} ms; normal {rng['normal_ms']:.3f} ms, "
          f"{rng['ns_per_normal']:.4f} ns a draw, incl. erfinv; uniform "
          f"{rng['uniform_ms']:.3f} ms, {rng['ns_per_uniform']:.4f} ns a "
          f"draw; {rng['draws']} draws)", flush=True)
    return row, dict(stats, launches=launches[ni.law_for(ep._pair).name],
                     rng=rng, sir_final=list(series[-1]))


def phase_sir_mechanics(seed: int):
    """Phase 12 (b): sir_mechanics (the compose stack) at full width."""
    drops32 = None
    for cap in (SIRM_CAP, SIRM_CAP_RAISED):
        t0 = time.perf_counter()
        sim = make_sim(sm.behavior(), interior=MAIN_INTERIOR, cap=cap,
                       boundary="toroidal", dt=1.0, sweep_backend="auto",
                       device="cuda")
        sm.init(sim, SIM_AGENTS, SIM_INFECTED, seed=seed)
        torch.cuda.synchronize()
        print(f"[sir_mechanics] init {SIM_AGENTS} agents on "
              f"{sim.geom.local_shape} x {cap} slots: "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
        series, launches, stats = drive(sim, SIM_STEPS, "sir_mechanics",
                                        sir_counts_of)
        dropped = int(sim.state.dropped.sum())
        print(f"[sir_mechanics] cap {cap}: dropped {dropped}; S/I/R by "
              f"step {series}", flush=True)
        if cap == SIRM_CAP:
            drops32 = dropped
        if dropped == 0:
            break
        del sim
        gc.collect()
        torch.cuda.empty_cache()
    if dropped != 0:
        fail(f"sir_mechanics: {dropped} agents dropped at cap {cap}")
    n_live = total_agents(sim.state)
    for t, c in enumerate(series):
        if sum(c) != SIM_AGENTS:
            fail(f"sir_mechanics: S+I+R = {sum(c)} != {SIM_AGENTS} at step "
                 f"{t + 1}")
    if n_live != SIM_AGENTS:
        fail(f"sir_mechanics: agents {n_live} != {SIM_AGENTS}")
    check_launches(launches, STACK, SIM_STEPS, "sir_mechanics")
    sim.run(1)
    row = law_row(aura_block(sim), sim.geom, STACK, 8, 5, "sir_mechanics")
    return row, dict(stats, cap=cap, dropped_at_cap32=drops32,
                     launches=launches[STACK], sir_final=list(series[-1]))


def spawn_collect(sim):
    """Live agents, the gid counters' sum, drops, one device's
    ``halo_bytes`` and the codec's overflow count (one device tensor)."""
    st = sim.state
    return torch.stack([st.soa.valid.sum(), st.gid_counter.sum(),
                        st.dropped.sum(), st.halo_bytes.reshape(-1)[0],
                        st.codec_overflow.max()])


def check_spawn_series(label, n0, c0, series):
    """live = initial + spawned - dropped at every step (``c0``: the gid
    counters' sum at the start); returns (spawned, dropped) at the end."""
    for t, row in enumerate(series):
        n, g, d = row[:3]
        if n != n0 + (g - c0) - d:
            fail(f"{label}: step {t + 1}: {n} live != {n0} + {g - c0} "
                 f"spawned - {d} dropped")
    return series[-1][1] - c0, series[-1][2]


def check_gids(label, state):
    """Unique gids and finite positions of the live agents."""
    v = state.soa.valid
    gid = ((state.soa.attrs["gid_rank"][v].to(torch.int64) << 32)
           | state.soa.attrs["gid_count"][v].to(torch.int64))
    if int(torch.unique(gid).numel()) != int(v.sum()):
        fail(f"{label}: gids are not unique")
    if not torch.isfinite(state.soa.pos[v]).all():
        fail(f"{label}: non-finite positions")


def phase_spawn(seed: int, name: str):
    """Phase 12 (c): a spawn sim on the full grid, seeded as a disk."""
    # The sim's own init attributes (diameter, ctype), on a disk of
    # cell_proliferation's radius min(L) / 8 for both sims.
    mod, density, steps, law, diameter, ctype = {
        "cell_proliferation": (cp, PROLIF_DENSITY, PROLIF_STEPS, PROLIF_LAW,
                               0.6, 0),
        "oncology": (onc, ONC_DENSITY, ONC_STEPS, "oncology", 0.9, 1)}[name]
    t0 = time.perf_counter()
    sim = make_sim(mod.behavior(), interior=MAIN_INTERIOR, cap=SPAWN_CAP,
                   sweep_backend="auto", device="cuda")
    lx, ly = sim.geom.domain_size
    radius = min(lx, ly) / 8
    n0 = int(density * math.pi * radius ** 2)
    pos = disk_positions(np.random.default_rng(seed), n0, (lx / 2, ly / 2),
                         radius)
    init_agents(sim, pos, {"diameter": np.full((n0,), diameter, np.float32),
                           "ctype": np.full((n0,), ctype, np.int32)},
                seed=seed)
    del pos
    torch.cuda.synchronize()
    print(f"[{name}] init {n0} agents in a disk of radius {radius:g} on "
          f"{sim.geom.local_shape} x {SPAWN_CAP} slots: "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    c0 = tuple(int(v) for v in spawn_collect(sim).tolist())
    series, launches, stats = drive(sim, steps, name, spawn_collect)
    spawned, dropped = check_spawn_series(name, n0, c0[1], series)
    print(f"[{name}] agents / gid counters / dropped by step "
          f"{[row[:3] for row in [c0] + series]}; {spawned} spawned, "
          f"{dropped} dropped", flush=True)
    if spawned <= 0:
        fail(f"{name}: nothing spawned in {steps} steps")
    check_gids(name, sim.state)
    check_launches(launches, law, steps, name)
    sim.run(1)
    row = law_row(aura_block(sim), sim.geom, law, 8, 5, name)
    return row, dict(stats, agents_initial=n0, spawned=spawned,
                     dropped=dropped, launches=launches[
                         ni.law_for(LAW_ARGS[law][0]).name])


def phase_sims(seed: int):
    """Phase 12: epidemiology, sir_mechanics, cell_proliferation and
    oncology on the card."""
    rows, stats = {}, {}
    for name, fn in (("epidemiology", phase_epidemiology),
                     ("sir_mechanics", phase_sir_mechanics),
                     ("cell_proliferation",
                      lambda s: phase_spawn(s, "cell_proliferation")),
                     ("oncology", lambda s: phase_spawn(s, "oncology"))):
        law = {"epidemiology": "epidemiology", "sir_mechanics": STACK,
               "cell_proliferation": PROLIF_LAW,
               "oncology": "oncology"}[name]
        row, st = fn(seed)
        rows[law] = dict(row, launches=st["launches"])
        stats[name] = st
        gc.collect()
        torch.cuda.empty_cache()
    return rows, stats


# ---------------------------------------------------------------------------
# Phase 13: the 3-D path (tumor_spheroid, the D = 3 pair sweep)
# ---------------------------------------------------------------------------

SPH_INTERIOR = (128, 128, 128)               # L = 256, 2,097,152 cells
SPH_CAP = 32                                 # the sim's own cap
SPH_UNIFORM_AGENTS = 8 * math.prod(SPH_INTERIOR)   # (a): 16,777,216
# (b), (c): the reference's init geometry, a ball of radius L/8 at the
# centre, seeded at 1/32 of an agent a unit^3.  The reference's density
# (40 agents in a ball of radius 1.5, 2.83 a unit^3) overflows cap 32 at
# init on this grid, and any density from 1/16 up drops agents within 20
# steps, the adhesive ball clumping and dividing into cells of more than
# 32 (tools/spheroid_density.py).
SPH_DENSITY = 1.0 / 32
SPH_STEPS = 20
SPH_MESH = (2, 2, 2)                         # (c): 64^3 cells a device
SPH_MESH_STEPS = 10                          # full, 7 delta, full, delta
SPH_MESH_DELTA = DeltaConfig(enabled=True, qdtype=torch.int16,
                             refresh_interval=8, migration=torch.int16)


def seed_spheroid(sim, seed: int) -> int:
    """The spheroid's ball at SPH_DENSITY, as the sim's ``init`` seeds it
    (diameter 0.8, ctype 1, nutrient 1.0); returns the agents seeded."""
    size = sim.geom.domain_size
    radius = min(size) / 8
    n0 = int(SPH_DENSITY * 4.0 / 3.0 * math.pi * radius ** 3)
    pos = ball_positions(np.random.default_rng(seed), n0,
                         tuple(s / 2 for s in size), radius)
    init_agents(sim, pos, {"diameter": np.full((n0,), 0.8, np.float32),
                           "ctype": np.ones((n0,), np.int32),
                           "nutrient": np.ones((n0,), np.float32)},
                seed=seed)
    return n0


def phase_sweep_3d(seed: int):
    """Phase 13 (a): the D = 3 kernel of law 0, law 1 and the spheroid's
    stack on a uniform 128^3-cell SoA, 8 agents a cell, cap 32, against
    the plain version (in blocks of 2 x 32 x 128 cells) and the bound."""
    t0 = time.perf_counter()
    sim = make_sim(cc.behavior(), interior=SPH_INTERIOR, cap=SPH_CAP,
                   device="cuda")
    cc.init(sim, SPH_UNIFORM_AGENTS, seed=seed)
    soa = aura_block(sim)
    torch.cuda.synchronize()
    print(f"[3d sweep] {SPH_UNIFORM_AGENTS} agents uniform on "
          f"{sim.geom.local_shape} x {SPH_CAP} slots: "
          f"{time.perf_counter() - t0:.2f}s; fullest cell "
          f"{int(soa.valid.sum(-1).max())}", flush=True)
    kw = dict(rows_per_chunk=2, reps=5, label="3d sweep", cols_per_chunk=32)
    same = law_row(soa, sim.geom, "same_type", **kw)
    rows = {
        "same_type": same,
        "soft_repulsion_adhesion": law_row(
            soa, sim.geom, "soft_repulsion_adhesion",
            in_radius=same["in_radius_pairs"], **kw),
        SPH_STACK: law_row(soa, sim.geom, SPH_STACK, **kw),
    }
    return rows


def phase_spheroid(seed: int):
    """Phase 13 (b): tumor_spheroid on one device, 128^3 cells, 20 steps."""
    t0 = time.perf_counter()
    sim = make_sim(ts.behavior(), interior=SPH_INTERIOR, cap=SPH_CAP,
                   sweep_backend="auto", device="cuda")
    n0 = seed_spheroid(sim, seed)
    torch.cuda.synchronize()
    d0 = ts.spheroid_diameter(sim.state)
    print(f"[spheroid] init {n0} agents in a ball of radius "
          f"{min(sim.geom.domain_size) / 8:g} on {sim.geom.local_shape} x "
          f"{SPH_CAP} slots: {time.perf_counter() - t0:.2f}s; diameter "
          f"{d0:.4f}", flush=True)
    c0 = int(sim.state.gid_counter.sum())
    series, launches, stats = drive(sim, SPH_STEPS, "spheroid",
                                    spawn_collect)
    spawned, dropped = check_spawn_series("spheroid", n0, c0, series)
    d1 = ts.spheroid_diameter(sim.state)
    print(f"[spheroid] agents / gid counters / dropped by step "
          f"{[row[:3] for row in series]}; {spawned} spawned, {dropped} "
          f"dropped; diameter {d0:.4f} -> {d1:.4f}", flush=True)
    if spawned <= 0:
        fail("spheroid: nothing spawned")
    if dropped != 0:
        fail(f"spheroid: {dropped} agents dropped at cap {SPH_CAP}")
    if not d1 > d0:
        fail(f"spheroid: the diameter did not grow ({d0} -> {d1})")
    check_gids("spheroid", sim.state)
    check_launches(launches, SPH_STACK, SPH_STEPS, "spheroid")
    sim.run(1)                                   # a mid-run SoA (step 21)
    row = law_row(aura_block(sim), sim.geom, SPH_STACK, 2, 5, "spheroid",
                  cols_per_chunk=32)
    rng = rng_row(sim, uniforms=1)
    times = profile(lambda: sim.run(1), "spheroid profile", "one step")
    step_dev = sum(times.values()) / 1e3 if times else stats["step_ms"]
    print(f"[spheroid] RNG of a step, timed alone at its shapes: "
          f"{rng['total_ms']:.3f} ms = {100 * rng['total_ms'] / step_dev:.1f}"
          f"% of a step's {step_dev:.3f} ms of device time (threefry "
          f"{rng['threefry_ms']:.3f} ms; normal {rng['normal_ms']:.3f} ms, "
          f"{rng['ns_per_normal']:.4f} ns a draw; uniform "
          f"{rng['uniform_ms']:.3f} ms; {rng['draws']} draws); the sweep "
          f"{row['ms']:.3f} ms", flush=True)
    return row, dict(stats, agents_initial=n0, spawned=spawned,
                     dropped=dropped, diameter=[d0, d1], rng=rng,
                     step_device_ms=step_dev,
                     launches=launches[SPH_STACK])


def phase_spheroid_mesh(seed: int):
    """Phase 13 (c): the same global grid on a 2x2x2 virtual mesh, int16
    aura codec (refresh interval 8) and int16 migration codec; returns its
    stats and the recorded codec calls of one more delta step."""
    interior = tuple(n // m for n, m in zip(SPH_INTERIOR, SPH_MESH))
    sim = make_sim(ts.behavior(), interior=interior, mesh_shape=SPH_MESH,
                   cap=SPH_CAP, delta=SPH_MESH_DELTA, sweep_backend="auto",
                   device="cuda")
    n0 = seed_spheroid(sim, seed)
    c0 = int(sim.state.gid_counter.sum())
    series, launches, stats = drive(sim, SPH_MESH_STEPS, "spheroid mesh",
                                    spawn_collect)
    spawned, dropped = check_spawn_series("spheroid mesh", n0, c0, series)
    overflow = series[-1][4]
    bytes_full, bytes_delta = series[0][3], series[1][3]
    print(f"[spheroid mesh] {SPH_MESH} x {sim.geom.local_shape} x "
          f"{SPH_CAP} slots, {n0} agents: agents / gid counters / dropped / "
          f"halo_bytes by step {[row[:4] for row in series]}; {spawned} "
          f"spawned, {dropped} dropped, codec_overflow {overflow}; "
          f"halo_bytes a device: full step {bytes_full}, delta step "
          f"{bytes_delta}", flush=True)
    if overflow != 0:
        fail(f"spheroid mesh: codec overflow {overflow}")
    if dropped != 0:
        fail(f"spheroid mesh: {dropped} agents dropped")
    if spawned <= 0:
        fail("spheroid mesh: nothing spawned")
    if not bytes_full > bytes_delta > 0:
        fail(f"spheroid mesh: halo bytes full {bytes_full} / delta "
             f"{bytes_delta}")
    check_gids("spheroid mesh", sim.state)
    n_dev = sim.geom.n_devices
    want = dict(codec_launches(sim, SPH_MESH_STEPS),
                **{SPH_STACK: SPH_MESH_STEPS * n_dev})
    want = {k: v for k, v in want.items() if v}
    if launches != want:
        fail(f"spheroid mesh: kernel launches {launches} != {want}")
    if sim.iteration % SPH_MESH_DELTA.refresh_interval == 0:
        fail("spheroid mesh: the recorded step would be a full refresh")
    with Capture(dc, CODEC_REPLACES) as cap:
        sim.run(1)                               # one more delta step
        torch.cuda.synchronize()
    return dict(stats, agents_initial=n0, spawned=spawned, dropped=dropped,
                codec_overflow=overflow, bytes_full=bytes_full,
                bytes_delta=bytes_delta, launches=launches), cap.calls


def phase_spheroid_parity(seed: int):
    """Phase 13 (d): the spheroid's mechanics (law 0 at D = 3, no draws) on
    a 2x2x2 mesh of 8^3 cells with a full refresh against one device of
    16^3 cells, 8 steps.  Agents carry no key-dependent state, so the two
    runs hold the same agents; a migrant joins its cell's slots in another
    order on the mesh than on one device, so the force sums may differ in
    the last bits (phase 8's limit, 1e-4)."""
    mech = ts.behavior().children[0]
    out = {}
    runs = {}
    for name, mesh, interior in (("one", (1, 1, 1), (16, 16, 16)),
                                 ("mesh", SPH_MESH, (8, 8, 8))):
        sim = make_sim(mech, interior=interior, mesh_shape=mesh, cap=SPH_CAP,
                       delta="off", device="cuda")
        size = sim.geom.domain_size
        pos = ball_positions(np.random.default_rng(seed), 600,
                             tuple(s / 2 for s in size), min(size) / 4)
        init_agents(sim, pos, {"diameter": np.full((600,), 0.8, np.float32),
                               "ctype": np.ones((600,), np.int32)},
                    seed=seed)
        sim.run(8)
        runs[name] = sim
    a, b = runs["one"].state, runs["mesh"].state
    if not total_agents(a) == total_agents(b) == 600:
        fail(f"spheroid parity: agents {total_agents(a)} / "
             f"{total_agents(b)}")
    if int(a.dropped.sum()) or int(b.dropped.sum()):
        fail("spheroid parity: agents dropped")

    def sorted_pos(st):
        v = st.soa.valid.reshape(-1)
        p = st.soa.pos.reshape(-1, 3)[v].cpu().numpy()
        return p[np.lexsort(p.T)]

    err = float(np.abs(sorted_pos(a) - sorted_pos(b)).max())
    out["off_vs_one_device"] = err
    print(f"[spheroid parity] 2x2x2 full refresh vs one device, 8 steps, "
          f"600 agents: max |sorted pos| diff {err:.3g} (limit 1e-4)",
          flush=True)
    if err > 1e-4:
        fail(f"spheroid parity: 2x2x2 vs 1x1x1 positions differ by {err}")
    return out


def phase_3d(seed: int):
    """Phase 13: the D = 3 kernel, tumor_spheroid on one device and on the
    2x2x2 mesh, and the mesh against one device."""
    rows = phase_sweep_3d(seed)
    gc.collect()
    torch.cuda.empty_cache()
    path_row, one = phase_spheroid(seed)
    gc.collect()
    torch.cuda.empty_cache()
    mesh, calls = phase_spheroid_mesh(seed)
    phase_codec_apart(calls, "codec 3d")         # its lines only
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    parity = phase_spheroid_parity(seed)
    return rows, path_row, dict(one_device=one, mesh=mesh, parity=parity)


# ---------------------------------------------------------------------------
# Phase 14: sir_mechanics ensembles and the scenario server (B1 a, d)
# ---------------------------------------------------------------------------

ENS_INTERIOR = (512, 512)                    # L = 1024
ENS_CAP = 32                                 # the family's own cap
ENS_AGENTS = 4 * math.prod(ENS_INTERIOR)     # 1,048,576 a lane
ENS_INFECTED = round(0.05 * ENS_AGENTS)      # 52,429, as phase 12 b
ENS_STEPS = 10
ENS_MESH = (2, 2)                            # (c): 256^2 cells a device
ENS_MESH_LANES = 4
# R = 8 points (the reference server's slot_size), every knob of
# ENSEMBLE_PARAMS varying across the lanes, sir_radius in {0.75, 1.0,
# 1.25, 1.5}.  The mechanics stay at or below the default's clumping
# (adhesion at most 0.5 and a quarter of repulsion, max_step at most
# 0.35), which drops nothing at cap 32 in 12 b's 16.7M agents: a lane at
# repulsion 1.0 and adhesion 0.7 dropped 5 agents within 7 steps, one at
# 2.5 / 0.6 (max_step 0.35) 4 in 10 steps on the 2x2 mesh (NVIDIA H100
# 80GB HBM3, 700 W), clumping past the cap.
ENS_POINTS = [
    dict(repulsion=2.0, adhesion=0.5, max_step=0.3, beta=0.05, gamma=0.1,
         sigma=0.3, sir_radius=1.5),
    dict(repulsion=2.4, adhesion=0.4, max_step=0.25, beta=0.03, gamma=0.08,
         sigma=0.2, sir_radius=1.25),
    dict(repulsion=2.6, adhesion=0.5, max_step=0.35, beta=0.08, gamma=0.12,
         sigma=0.4, sir_radius=1.0),
    dict(repulsion=3.0, adhesion=0.3, max_step=0.2, beta=0.1, gamma=0.15,
         sigma=0.25, sir_radius=0.75),
    dict(repulsion=2.2, adhesion=0.45, max_step=0.3, beta=0.02, gamma=0.05,
         sigma=0.35, sir_radius=1.5),
    dict(repulsion=2.2, adhesion=0.2, max_step=0.3, beta=0.06, gamma=0.2,
         sigma=0.15, sir_radius=1.25),
    dict(repulsion=2.0, adhesion=0.35, max_step=0.15, beta=0.12, gamma=0.06,
         sigma=0.45, sir_radius=1.0),
    dict(repulsion=2.8, adhesion=0.45, max_step=0.25, beta=0.04, gamma=0.3,
         sigma=0.3, sir_radius=0.75),
]
SERVE_BUDGETS = (8, 12, 16)
# The server's cap: at the family's 32 the default point drops agents
# past 10 steps (17 of 1,048,576 by step 16 on an NVIDIA H100 80GB HBM3,
# 700 W: its clusters outgrow 32 slots), so the 16-step budgets run at
# 48, as phase 12 b raises its cap when 32 drops.
SERVE_CAP = 48
SERVE_REQUESTS = 12


def lane_seed(seed: int, r: int) -> int:
    """The placement and RNG seed of lane ``r``, from ``--seed``."""
    return 1000 * seed + r


def ens_family(mesh_shape=(1, 1)):
    interior = tuple(n // m for n, m in zip(ENS_INTERIOR, mesh_shape))
    return sm.ensemble_family(interior=interior, mesh_shape=mesh_shape,
                              cap=ENS_CAP, device="cuda")


def ens_init(ens, points, seed):
    return sm.ensemble_init(
        ens, [dict(p, seed=lane_seed(seed, r)) for r, p in enumerate(points)],
        n_agents=ENS_AGENTS, initial_infected=ENS_INFECTED)


def state_leaves(state):
    """(path, tensor) of every leaf of a SimState."""
    for n, a in state.soa.attrs.items():
        yield f"soa.attrs.{n}", a
    yield "soa.valid", state.soa.valid
    for e, slab in state.refs.items():
        for f, a in slab.items():
            yield f"refs.{e}.{f}", a
    for name in ("it", "key", "gid_counter", "dropped", "halo_bytes",
                 "codec_overflow", "health"):
        yield name, getattr(state, name)


def check_lane_equals_solo(label, lane, solo):
    for (path, a), (_, b) in zip(state_leaves(lane), state_leaves(solo)):
        if not torch.equal(a, b):
            fail(f"{label}: {path} of the lane differs from its solo run")


def solo_runs(ens, estate, marks, collect=None):
    """Each lane's solo engine at its point from the lane's initial state,
    stepped to each of ``marks``; returns the final states, the frames of
    ``collect`` at each mark and the summed ms a step (CUDA events over
    steps 2.. of each lane)."""
    finals, frames, ms = [], [], 0.0
    host = {n: estate.params[n].tolist() for n in ens.param_names}
    for r in range(estate.replicas):
        eng = ens.solo_engine({n: host[n][r] for n in host})
        seg = eng.make_segment_runner()
        st = replica_state(estate.state, r)
        st = seg(st, 1)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st = seg(st, marks[0] - 1)
        end.record()
        torch.cuda.synchronize()
        ms += start.elapsed_time(end) / (marks[0] - 1)
        fr = [collect(st)] if collect else []
        done = marks[0]
        for m in marks[1:]:
            st = seg(st, m - done)
            done = m
            if collect:
                fr.append(collect(st))
        finals.append(st)
        frames.append(fr)
    return finals, frames, ms


def lane_aura(ens, estate):
    """The stacked aura-filled SoA of every lane, as step 1's sweep sees
    it, and the run's lanes (engines and table)."""
    lanes = ens.lanes(estate.params)
    comm = lanes.engines[0]._comm()
    st = estate.state
    aura = AgentSoA(attrs={n: torch.empty_like(a)
                           for n, a in st.soa.attrs.items()},
                    valid=torch.empty_like(st.soa.valid))
    for r, eng in enumerate(lanes.engines):
        eng._aura(replica_state(st, r), comm, True, out=AgentSoA(
            attrs={n: a[r] for n, a in aura.attrs.items()},
            valid=aura.valid[r]))
    return aura, lanes


def lane_plain(soa, geom, pair_fn, pattrs, params, rows_per_chunk):
    """The plain version of one lane over the whole grid, in chunks of
    ``rows_per_chunk`` interior rows."""
    n, k = geom.interior, geom.cap
    out = None
    for r0 in range(0, n[0], rows_per_chunk):
        r1 = min(n[0], r0 + rows_per_chunk)
        ai, aj, vi, vj = ni.neighborhood_slabs(soa.attrs, soa.valid, pattrs,
                                               rows=(r0, r1))
        part = ni.pair_sweep_plain(ai, aj, vi, vj, pair_fn=pair_fn,
                                   radius=2.0, params=params,
                                   box=minimum_image_box(geom))
        if out is None:
            out = {a: torch.empty(n + (k,) + tuple(t.shape[2:]),
                                  dtype=t.dtype, device=t.device)
                   for a, t in part.items()}
        for a, t in part.items():
            out[a][r0:r1] = t.reshape((r1 - r0,) + n[1:] + (k,)
                                      + tuple(t.shape[2:]))
        del ai, aj, vi, vj, part
    return out


def lane_row(aura, geom, label, law_label, fns, params, pattrs, table,
             rows_per_chunk=16, reps=5):
    """One lane launch of ``fns``' law over every lane of ``aura`` (device
    (0, 0) of each lane, read in place): against the plain version lane by
    lane (forces 1e-5, counts exactly) and bit-equal to one B = 1 launch a
    lane at its params; times of the lane launch, the B = 1 launches
    summed, the plain version, and the bound summed over the lanes."""
    at = (slice(None), 0, 0)
    attrs = {n: a[at] for n, a in aura.attrs.items()}
    valid = aura.valid[at]
    blocks = [AgentSoA(attrs={n: a[r] for n, a in attrs.items()},
                       valid=valid[r]) for r in range(valid.shape[0])]

    def lane_launch():
        return ni.pair_sweep_lanes(attrs, valid, pair_fns=fns,
                                   pair_attrs=pattrs, radius=2.0,
                                   params=params, box=minimum_image_box(geom),
                                   table=table)

    def solo(r):
        return ni.pair_sweep(blocks[r].attrs, blocks[r].valid,
                             pair_fn=fns[r], pair_attrs=pattrs, radius=2.0,
                             params=params[r], box=minimum_image_box(geom))

    before = ni.LAUNCHES[law_label]
    got = lane_launch()
    torch.cuda.synchronize()
    if ni.LAUNCHES[law_label] != before + 1:
        fail(f"{label}: a lane launch did not count one launch")
    worst = 0.0
    plain_ms = 0.0
    nbytes = ops = 0
    for r, blk in enumerate(blocks):
        one = solo(r)
        for n, g in got.items():
            if not torch.equal(g[r], one[n]):
                fail(f"{label}: lane {r} {n} differs from its B = 1 launch")
        want = {}
        plain_ms += cuda_ms(lambda: want.update(lane_plain(
            blk, geom, fns[r], pattrs, params[r], rows_per_chunk)), 1,
            warmup=False)
        worst = max(worst, compare({n: g[r] for n, g in got.items()}, want,
                                   f"{label} lane {r}"))
        in_radius = in_radius_pairs(blk, geom, rows_per_chunk)
        _, _, b, o = bound(blk, geom, law_label, in_radius)
        nbytes += b
        ops += o
        del one, want
    ms = cuda_ms(lane_launch, reps)
    singles_ms = cuda_ms(lambda: [solo(r) for r in range(len(blocks))], reps)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    b_ms = 1e3 * max(t_bytes, t_ops)
    b_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[{label}] {law_label}: {len(blocks)} lanes in one launch, "
          f"max_abs_err={worst:.3g}, bit-equal to B = 1; lane launch "
          f"{ms:.4f} ms, {len(blocks)} B = 1 launches {singles_ms:.4f} ms, "
          f"plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}; {nbytes} "
          f"B, {ops} ops)", flush=True)
    return dict(max_abs_err=worst, ms=ms, singles_ms=singles_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, ops=ops, library_ms=None)


def ensemble_kernel_rows(ens, estate):
    """Phase 14 (a): stack 18 and law 5 alone, one lane launch over the 8
    lanes' aura-filled SoA of step 1."""
    aura, lanes = lane_aura(ens, estate)
    engines = lanes.engines
    beh = engines[0].behavior
    rows = {ENS_STACK: lane_row(
        aura, ens.geom, "ensemble kernel", ENS_STACK,
        [e.behavior.pair_fn for e in engines],
        [e.behavior.params for e in engines], beh.pair_attrs, lanes.table)}
    radii = [{"sir_radius": float(r)}
             for r in estate.params["sir_radius"].tolist()]
    fns = [sm._gated_sir_pair] * len(radii)
    rows[ENS_LAW5] = lane_row(
        aura, ens.geom, "ensemble kernel", ENS_LAW5, fns, radii, ("state",),
        ni.lane_table(fns, radii, aura.valid.device))
    return rows


def ens_collect(estate):
    """Each lane's S, I, R and dropped agents, (R, 4), as a device tensor
    (read after the run, so the steps do not wait on the host)."""
    st = estate.state
    r = st.soa.valid.shape[0]
    s, v = st.soa.attrs["state"].reshape(r, -1), st.soa.valid.reshape(r, -1)
    return torch.stack([((s == c) & v).sum(1) for c in (sm.S, sm.I, sm.R)]
                       + [st.dropped.reshape(r, -1).sum(1)], dim=1)


def phase_ensemble(seed: int):
    """Phase 14 (b): Ensemble.run on one device, 10 steps, 8 lanes."""
    t0 = time.perf_counter()
    ens = ens_family()
    e0 = ens_init(ens, ENS_POINTS, seed)
    torch.cuda.synchronize()
    print(f"[ensemble] init {len(ENS_POINTS)} lanes of {ENS_AGENTS} agents "
          f"({ENS_INFECTED} infected) on {ens.geom.local_shape} x {ENS_CAP} "
          f"slots: {time.perf_counter() - t0:.2f}s", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    est, _ = ens.run(e0, 1)
    collected = [ens_collect(est)]
    windows = []
    for _ in range(ENS_STEPS - 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        est, _ = ens.run(est, 1)
        end.record()
        windows.append((start, end))
        collected.append(ens_collect(est))
    torch.cuda.synchronize()
    series = [c[:, :3].cpu().numpy() for c in collected]
    drops = [c[:, 3].tolist() for c in collected]
    launches = {k: v for k, v in all_launches().items() if v}
    step_ms = sum(a.elapsed_time(b) for a, b in windows) / (ENS_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    n_all = len(ENS_POINTS) * ENS_AGENTS
    print(f"[ensemble] steps 2-{ENS_STEPS}: {step_ms:.3f} ms/step (CUDA "
          f"events), {n_all / (step_ms / 1e3):.4g} agent-updates/s over "
          f"{len(ENS_POINTS)} lanes; peak device memory {peak / 2**30:.2f} "
          f"GiB; launches {launches}", flush=True)
    curves = np.stack([c[:, 1] for c in series], axis=1)    # (R, steps)
    print(f"[ensemble] I by lane and step {curves.tolist()}; dropped by "
          f"step and lane {drops}", flush=True)
    for t, c in enumerate(series):
        if not (c.sum(axis=1) == ENS_AGENTS).all():
            fail(f"ensemble: S+I+R {c.sum(axis=1).tolist()} != {ENS_AGENTS} "
                 f"at step {t + 1}")
    if all(np.array_equal(curves[0], c) for c in curves[1:]):
        fail("ensemble: every lane's I-curve is the same")
    if any(drops[-1]):
        fail(f"ensemble: agents dropped by lane {drops[-1]}")
    if not torch.isfinite(est.state.soa.pos).all():
        fail("ensemble: non-finite positions")
    if launches != {ENS_STACK: ENS_STEPS}:
        fail(f"ensemble: kernel launches {launches} != "
             f"{ {ENS_STACK: ENS_STEPS} }")
    finals, _, solo_ms = solo_runs(ens, e0, [ENS_STEPS])
    for r, st in enumerate(finals):
        check_lane_equals_solo(f"ensemble lane {r}",
                               replica_state(est.state, r), st)
    print(f"[ensemble] every lane bit-equal, every column, to its solo run "
          f"on the card; the {len(ENS_POINTS)} solo runs one after another: "
          f"{solo_ms:.3f} ms a step summed (lanes {step_ms:.3f})",
          flush=True)
    del finals
    times = profile(lambda: ens.run(est, 1), "ensemble profile",
                    "one more step")
    step_dev = sum(times.values()) / 1e3 if times else None
    if step_dev is not None:
        print(f"[ensemble] a step's {step_dev:.3f} ms of device kernels in "
              f"{step_ms:.3f} ms: the card idles "
              f"{100 * (1 - step_dev / step_ms):.1f}% of it", flush=True)
    del est
    gc.collect()
    rows = ensemble_kernel_rows(ens, e0)
    return rows, dict(step_ms=step_ms, agent_updates_per_s=n_all / (
        step_ms / 1e3), peak_bytes=peak, solo_ms_summed=solo_ms,
        step_device_ms=step_dev, launches=launches,
        i_curves=curves.tolist())


def phase_ensemble_mesh(seed: int):
    """Phase 14 (c): the first 4 points on a 2x2 virtual mesh (the same
    domain), codec off, 10 steps; each lane bit-equal to its solo mesh
    run; one lane launch a device a step."""
    ens = ens_family(ENS_MESH)
    e0 = ens_init(ens, ENS_POINTS[:ENS_MESH_LANES], seed)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    est, _ = ens.run(e0, ENS_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in all_launches().items() if v}
    want = {ENS_STACK: ENS_STEPS * ens.geom.n_devices}
    collected = ens_collect(est).cpu().numpy()
    c, dropped = collected[:, :3], collected[:, 3].tolist()
    print(f"[ensemble mesh] {ENS_MESH} x {ens.geom.local_shape} x {ENS_CAP}"
          f" slots, {ENS_MESH_LANES} lanes, {ENS_STEPS} steps: "
          f"{1e3 * wall / ENS_STEPS:.3f} ms a step (host clock); S/I/R "
          f"{c.tolist()}; dropped by lane {dropped}; launches {launches}",
          flush=True)
    if launches != want:
        fail(f"ensemble mesh: kernel launches {launches} != {want}")
    if not (c.sum(axis=1) == ENS_AGENTS).all():
        fail(f"ensemble mesh: S+I+R {c.sum(axis=1).tolist()}")
    if any(dropped):
        fail(f"ensemble mesh: agents dropped by lane {dropped}")
    finals, _, _ = solo_runs(ens, e0, [ENS_STEPS])
    for r, st in enumerate(finals):
        check_lane_equals_solo(f"ensemble mesh lane {r}",
                               replica_state(est.state, r), st)
    print("[ensemble mesh] every lane bit-equal to its solo mesh run",
          flush=True)
    return dict(step_ms_host=1e3 * wall / ENS_STEPS, launches=launches)


def phase_serve(seed: int):
    """Phase 14 (d): the scenario server at (b)'s size, slot 8: 12
    requests (budgets 8, 12, 16; streaming every 0 or 4 steps) in two
    batches, the second padded, plus three rejected at submit."""
    from repro_torch.core import Domain
    from repro_torch.core.ensemble import Ensemble, runner_cache_stats
    from repro_torch.core.operations import batch_attr_counts
    from repro_torch.launch.serve import (
        ScenarioFamily, ScenarioRequest, ScenarioServer)

    # sir_mechanics_family at (b)'s size, on a grid of SERVE_CAP slots
    fam = ScenarioFamily(
        name="sir_mechanics",
        ensemble=sm.ensemble_family(interior=ENS_INTERIOR, cap=SERVE_CAP,
                                    device="cuda"),
        init_point=lambda e, s: sm.ensemble_point_state(
            e, seed=s, n_agents=ENS_AGENTS, initial_infected=ENS_INFECTED),
        metric=batch_attr_counts("state", (sm.S, sm.I, sm.R)),
        defaults=sm.ensemble_defaults())
    server = ScenarioServer([fam], slot_size=len(ENS_POINTS))

    def bad_factory(params):      # the reference smoke's bad_radius_sweep
        return dataclasses.replace(cc.behavior(),
                                   radius=float(params["radius"]))

    server.register(ScenarioFamily(
        name="bad_radius_sweep",
        ensemble=Ensemble(geom=Domain(cell_size=2.0, interior=(8, 8),
                                      mesh_shape=(1, 1), cap=24,
                                      boundary="toroidal"),
                          behavior_fn=bad_factory, param_names=("radius",),
                          family="bad_radius_sweep", device="cuda"),
        init_point=lambda e, s: None, metric=lambda s: np.zeros((1, 1))))
    reqs = []
    for i in range(SERVE_REQUESTS):
        p = ENS_POINTS[i % len(ENS_POINTS)]
        reqs.append(ScenarioRequest(
            family="sir_mechanics", params=dict(p, beta=p["beta"] + 0.01 * i),
            steps=SERVE_BUDGETS[i % 3], stream_every=4 * (i % 2),
            seed=lane_seed(seed, 100 + i)))
    t0 = time.perf_counter()
    rids = [server.submit(r) for r in reqs]
    bad = {
        "serve-unknown-family": server.submit(ScenarioRequest(
            family="nope", params={}, steps=4)),
        "serve-unknown-param": server.submit(ScenarioRequest(
            family="sir_mechanics", params={"not_a_knob": 1.0}, steps=4)),
        "ensemble-factory-static": server.submit(ScenarioRequest(
            family="bad_radius_sweep", params={"radius": 1.0}, steps=4)),
    }
    for contract, rid in bad.items():
        h = server.handle(rid)
        if h.status != "rejected" or not any(
                d.contract == contract for d in h.diagnostics):
            fail(f"serve: request {rid} not rejected with {contract}: "
                 f"{h.status} {h.diagnostics}")
    s0 = runner_cache_stats()
    server.pump()
    s1 = runner_cache_stats()
    server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s2 = runner_cache_stats()
    st = server.stats()
    print(f"[serve] {SERVE_REQUESTS} requests in {st['batches']} batches "
          f"at mean occupancy {st['mean_occupancy']:.2f} in {wall:.2f}s "
          f"({SERVE_REQUESTS / wall:.3f} requests/s); runner cache "
          f"{s2['hits']}h/{s2['misses']}m", flush=True)
    if st["batches"] != 2 or st["mean_occupancy"] != 0.75:
        fail(f"serve: {st['batches']} batches at occupancy "
             f"{st['mean_occupancy']}")
    if s2["misses"] != s1["misses"] or s2["hits"] <= s1["hits"]:
        fail(f"serve: the second batch was not a runner-cache hit "
             f"({s1} -> {s2})")
    if st["requests"]["done"] != SERVE_REQUESTS or \
            st["requests"]["rejected"] != 3:
        fail(f"serve: requests {st['requests']}")
    ens = fam.ensemble
    latencies = []
    for rid, req in zip(rids, reqs):
        h = server.handle(rid)
        marks = (list(range(req.stream_every, req.steps, req.stream_every))
                 if req.stream_every else []) + [req.steps]
        if [s for s, _ in h.frames] != marks:
            fail(f"serve: request {rid} frames at {[s for s, _ in h.frames]}"
                 f" != {marks}")
        for _, f in h.frames:
            if int(f.sum()) != ENS_AGENTS:
                fail(f"serve: request {rid} frame sums to {int(f.sum())}")
        point = {**fam.defaults, **req.params}
        e1 = ens.init([fam.init_point(ens, req.seed)],
                      [{k: point[k] for k in ens.param_names}])
        _, frames, _ = solo_runs(
            ens, e1, marks, collect=lambda s: np.array(
                [int(((s.soa.attrs["state"] == c) & s.soa.valid).sum())
                 for c in (sm.S, sm.I, sm.R)]))
        for (step, f), g in zip(h.frames, frames[0]):
            if not np.array_equal(f, g):
                fail(f"serve: request {rid} frame at {step} {f.tolist()} "
                     f"!= its solo run's {g.tolist()}")
        latencies.append(h.latency_s)
    print(f"[serve] every request's frames equal its solo run's; latency "
          f"by request {[round(x, 3) for x in latencies]} s", flush=True)
    return dict(requests_per_s=SERVE_REQUESTS / wall, wall_s=wall,
                latency_s=latencies, batches=st["batches"],
                mean_occupancy=st["mean_occupancy"],
                cache={"before": s0, "after_batch1": s1, "after": s2})


def phase_ensembles(seed: int):
    """Phase 14: the ensemble path (B1 a, d)."""
    t0 = time.perf_counter()
    rows, one = phase_ensemble(seed)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = phase_ensemble_mesh(seed)
    gc.collect()
    torch.cuda.empty_cache()
    serve = phase_serve(seed)
    print(f"[ensembles] phase 14 in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return rows, dict(one_device=one, mesh=mesh, serve=serve)


# ---------------------------------------------------------------------------
# Phase 15: uneven partitions and the overlapped sweep (the virtual mesh)
# ---------------------------------------------------------------------------

# The main grid cut unevenly: 896 and 1152 cells along x, 1152 and 896
# along y (a padded block of 1152^2 cells a device, 1154^2 with its ring).
PART_WIDTHS = ((896, 1152), (1152, 896))
PART_STEPS = 10
# The small count-driven check (c): 32 x 24 cells, x toroidal.
DET_CELLS = (32, 24)
DET_WIDTHS = ((13, 19), (10, 14))
DET_AGENTS = 700
# (d): 14 c's 512^2 domain cut in the main run's proportions.
ENS_PART_WIDTHS = ((224, 288), (288, 224))


def balanced_positions(geom, n, rng):
    """``n`` agents, ``n / devices`` uniform in each device's owned slab
    (0.5 from the domain's edges): a piecewise-constant density that the
    partition balances, as a load balancer's cut follows a skewed one."""
    cs, part = geom.cell_size, geom.partition
    size = geom.domain_size
    per = n // geom.n_devices
    out = []
    for c in np.ndindex(*geom.mesh_shape):
        lo = [max(part.cuts[a][c[a]] * cs, 0.5) for a in range(geom.ndim)]
        hi = [min(part.cuts[a][c[a] + 1] * cs, size[a] - 0.5)
              for a in range(geom.ndim)]
        out.append(rng.uniform(lo, hi, (per, geom.ndim)))
    return np.concatenate(out).astype(np.float32)


def partition_sim(seed: int, overlap: str):
    """The main path's agents on the uneven 2x2 cut, int8+mig, cap 48."""
    from repro_torch.core import Partition

    part = Partition.from_widths(PART_WIDTHS)
    sim = make_sim(cc.behavior(), partition=part, cap=MAIN_CAP,
                   delta=MESH_DELTA, overlap=overlap, sweep_backend="auto",
                   device="cuda")
    n = 4 * math.prod(MAIN_INTERIOR)
    rng = np.random.default_rng(seed)
    pos = balanced_positions(sim.geom, n, rng)
    attrs = {"diameter": np.full((n,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, n).astype(np.int32)}
    sim.init(pos, attrs)
    return sim


def band_rows(sim, coords):
    """The overlapped sweep's launches on device ``coords`` at this
    state's aura: the interior pass over the block before the exchange
    (a full-block launch) and each face band of the block after it, each
    band against the plain version on the band (1e-5) and, bit for bit,
    against the same cells of a full-block launch on the block after the
    exchange; the kernel times, the bands' bound (the same bytes rule on
    the band), and what the contiguous copy of a strided band costs (the
    overlapped sweep copies the columns the law reads before a launch)."""
    from repro_torch.core.neighbors import face_band, face_indices

    law = "soft_repulsion_adhesion"
    geom, eng = sim.geom, sim.engine
    post, _, _, _, pre, _ = eng._aura(sim.state, eng._comm(), True)
    blk, pre_blk = device_block(post, coords), device_block(pre, coords)
    del post, pre
    whole = kernel_call(blk, geom, law)["force"]
    interior_ms = cuda_ms(lambda: kernel_call(pre_blk, geom, law), 10)
    owned = geom.owned_widths(coords)
    faces, worst = [], 0.0
    for axis in range(geom.ndim):
        for face in face_indices(geom, axis, owned):
            bgeom, band = face_band(geom, blk, axis, face)
            cols = ("pos", "gid_rank", "gid_count") + LAW_ARGS[law][1]
            copy_ms = 0.0
            if not band.valid.is_contiguous():
                copy_ms = cuda_ms(lambda: [band.attrs[c].contiguous()
                                           for c in cols]
                                  + [band.valid.contiguous()], 20)
            band = AgentSoA(attrs={c: band.attrs[c].contiguous()
                                   for c in cols},
                            valid=band.valid.contiguous())
            lengths = bgeom.local_shape
            label = f"partition band {coords} axis {axis} face {face}"
            res, _ = check_kernel(band, bgeom, law, rows_per_chunk=8,
                                  reps=20, label=label)
            got = kernel_call(band, geom, law)["force"]
            if not torch.equal(got, whole.narrow(axis, face - 1, 1)):
                fail(f"{label}: differs from the full-block launch's cells")
            worst = max(worst, res["max_abs_err"])
            in_radius = in_radius_pairs(band, bgeom, rows_per_chunk=8)
            b_ms, b_by, nbytes, ops = bound(band, bgeom, law, in_radius)
            faces.append(dict(res, axis=axis, face=face, shape=lengths,
                              copy_ms=copy_ms, bound_ms=b_ms, bound_by=b_by,
                              bytes=nbytes, ops=ops))
            print(f"[{label}] band {lengths}: bit-equal to the full "
                  f"block's cells; max_abs_err={res['max_abs_err']:.3g} "
                  f"kernel_ms={res['ms']:.4f} (contiguous copy "
                  f"{copy_ms:.4f}) plain_ms={res['plain_ms']:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}; {nbytes} B, {ops} ops)",
                  flush=True)
    whole_ms = cuda_ms(lambda: kernel_call(blk, geom, law), 10)
    face_ms = sum(f["ms"] for f in faces)
    print(f"[partition] device {coords} (owned {owned}): interior pass "
          f"{interior_ms:.4f} ms, its {len(faces)} face bands "
          f"{face_ms:.4f} ms, the monolithic launch {whole_ms:.4f} ms",
          flush=True)
    return dict(coords=coords, owned=owned, interior_ms=interior_ms,
                faces_ms=face_ms, monolithic_ms=whole_ms, faces=faces,
                max_abs_err=worst)


def partition_run(seed: int, overlap: str):
    """Phase 15 (a)-(b): one run of the uneven main path, counts zeroed
    just before and read after; gates on agents, drops, codec overflow,
    balance and launches."""
    t0 = time.perf_counter()
    sim = partition_sim(seed, overlap)
    torch.cuda.synchronize()
    geom = sim.geom
    n0 = 4 * math.prod(MAIN_INTERIOR)
    held = sim.state.soa.valid.sum(
        dim=tuple(range(geom.ndim, sim.state.soa.valid.dim())))
    held = held.reshape(-1).tolist()
    print(f"[partition {overlap}] init {n0} agents on cut {PART_WIDTHS}, "
          f"mesh {geom.mesh_shape} x {geom.local_shape} x {geom.cap} slots: "
          f"{time.perf_counter() - t0:.2f}s; agents by device {held}",
          flush=True)
    if any(abs(h - n0 / geom.n_devices) > 0.01 * n0 / geom.n_devices
           for h in held):
        fail(f"partition: devices hold {held}, not a quarter each within 1%")

    def collect(s):
        st = s.state
        return torch.stack([st.soa.valid.sum(), st.dropped.sum(),
                            st.codec_overflow.max()])

    series, launches, stats = drive(sim, PART_STEPS, f"partition {overlap}",
                                    collect)
    n_dev = geom.n_devices
    # one full-block launch a device a step (on: the interior pass), and
    # with the overlapped sweep 2 D face bands, each counted at its launch
    bands = 2 * geom.ndim if overlap == "on" else 0
    want = {k: v for k, v in dict(
        codec_launches(sim, PART_STEPS),
        soft_repulsion_adhesion=PART_STEPS * n_dev,
        **{"soft_repulsion_adhesion" + ni.FACE: PART_STEPS * n_dev * bands}
    ).items() if v}
    if launches != want:
        fail(f"partition {overlap}: kernel launches {launches} != {want}")
    for t, (n, dropped, overflow) in enumerate(series):
        if n != n0 or dropped or overflow:
            fail(f"partition {overlap}: step {t + 1}: agents {n}, dropped "
                 f"{dropped}, codec_overflow {overflow}")
    if not torch.isfinite(sim.state.soa.pos).all():
        fail(f"partition {overlap}: non-finite positions")
    fullest = int(sim.state.soa.valid.sum(dim=-1).max())
    print(f"[partition {overlap}] agents {n0} at every step, dropped 0, "
          f"codec_overflow 0; fullest cell {fullest}/{geom.cap}; "
          f"pair_sweep launches a device a step: 1 full block, {bands} face "
          f"bands", flush=True)
    return sim, launches, dict(stats, fullest=fullest, held=held,
                               agent_updates_per_s=n0 / (
                                   stats["step_ms"] / 1e3))


def _det_update(attrs, valid, acc, key, params, dt):
    """A drift driven by the same-type law's pair count (under one cell a
    step) and a child where the count is 3 (tests/test_partition.py's
    deterministic update)."""
    dev = valid.device
    new = dict(attrs)
    step = torch.tensor([1.25, -0.75], device=dev) * (
        1.0 + 0.0625 * torch.clamp(acc["cnt"], max=8.0)[..., None])
    new["pos"] = attrs["pos"] + torch.where(
        valid[..., None], step, torch.zeros((), device=dev))
    spawn = valid & (acc["cnt"] == 3.0) & (attrs["ctype"] == 1)
    child = dict(new)
    child["pos"] = new["pos"] + torch.tensor([0.1, 0.05], device=dev)
    child["ctype"] = torch.zeros_like(attrs["ctype"])
    return new, valid, spawn, child


def _fingerprint(state):
    """Live agents' (pos, ctype), sorted (gids follow device ranks)."""
    v = state.soa.valid.reshape(-1)
    p = state.soa.pos.reshape(-1, 2)[v].cpu().numpy()
    c = state.soa.attrs["ctype"].reshape(-1)[v].cpu().numpy()
    o = np.lexsort((c, p[:, 1], p[:, 0]))
    return p[o], c[o]


def phase_partition_parity(seed: int):
    """Phase 15 (c): the count-driven drift with spawns on one device, the
    equal 2x2 split and the uneven one (overlapped sweep), on the card:
    bit-equal."""
    from repro_torch.core import Partition

    base = cc.behavior()
    beh = Behavior(schema=base.schema, pair_fn=cc._same_type_pair,
                   pair_attrs=("ctype",), update_fn=_det_update,
                   radius=2.0, params={}, can_spawn=True)
    rng = np.random.default_rng(seed)
    size = np.asarray(DET_CELLS) * 2.0
    pos = rng.uniform(0.5, size - 0.5, (DET_AGENTS, 2)).astype(np.float32)
    attrs = {"diameter": np.full((DET_AGENTS,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, DET_AGENTS).astype(np.int32)}
    runs = {}
    for name, kw in (
            ("one device", dict(interior=DET_CELLS)),
            ("equal 2x2", dict(partition=Partition.equal(DET_CELLS,
                                                         (2, 2)))),
            ("uneven 2x2", dict(partition=Partition.from_widths(DET_WIDTHS),
                                overlap="on"))):
        sim = make_sim(beh, cap=MAIN_CAP, boundary=("toroidal", "closed"),
                       dt=1.0, delta="off", device="cuda", **kw)
        sim.init(pos, attrs)
        sim.run(PART_STEPS)
        if int(sim.state.dropped.sum()):
            fail(f"partition parity {name}: agents dropped")
        runs[name] = _fingerprint(sim.state)
    want = runs["one device"]
    if len(want[0]) <= DET_AGENTS:
        fail("partition parity: the spawn path did not fire")
    for name, got in runs.items():
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            fail(f"partition parity: {name} differs from one device")
    print(f"[partition parity] {DET_CELLS} cells, {DET_AGENTS} agents -> "
          f"{len(want[0])}, {PART_STEPS} steps of a count-driven drift with "
          f"spawns: one device, the equal 2x2 split and the uneven cut "
          f"{DET_WIDTHS} (overlapped sweep) bit-equal", flush=True)
    return dict(agents=len(want[0]))


def phase_partition_ensemble(seed: int):
    """Phase 15 (d): 14 c's ensemble (4 lanes of 1,048,576 agents) on an
    uneven 2x2 cut: one lane launch a device a step, each lane bit-equal
    to its solo run on the same cut."""
    from repro_torch.core import Partition

    ens = sm.ensemble_family(partition=Partition.from_widths(
        ENS_PART_WIDTHS), cap=ENS_CAP, device="cuda")
    e0 = ens_init(ens, ENS_POINTS[:ENS_MESH_LANES], seed)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    est, _ = ens.run(e0, ENS_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in all_launches().items() if v}
    want = {ENS_STACK: ENS_STEPS * ens.geom.n_devices}
    collected = ens_collect(est).cpu().numpy()
    c, dropped = collected[:, :3], collected[:, 3].tolist()
    print(f"[partition ensemble] cut {ENS_PART_WIDTHS} x {ens.geom.cap} "
          f"slots, {ENS_MESH_LANES} lanes, {ENS_STEPS} steps: "
          f"{1e3 * wall / ENS_STEPS:.3f} ms a step (host clock); S/I/R "
          f"{c.tolist()}; dropped by lane {dropped}; launches {launches}",
          flush=True)
    if launches != want:
        fail(f"partition ensemble: kernel launches {launches} != {want}")
    if not (c.sum(axis=1) == ENS_AGENTS).all() or any(dropped):
        fail(f"partition ensemble: S+I+R {c.sum(axis=1).tolist()}, "
             f"dropped {dropped}")
    finals, _, _ = solo_runs(ens, e0, [ENS_STEPS])
    for r, st in enumerate(finals):
        check_lane_equals_solo(f"partition ensemble lane {r}",
                               replica_state(est.state, r), st)
    print("[partition ensemble] every lane bit-equal to its solo run on the "
          "same cut", flush=True)
    return dict(step_ms_host=1e3 * wall / ENS_STEPS, launches=launches)


def phase_partition(seed: int):
    """Phase 15: uneven partitions and the overlapped sweep."""
    t0 = time.perf_counter()
    off, _, stats_off = partition_run(seed, "off")
    # the off run's final state waits on the host, so the on run's peak
    # memory is its own
    final_off = [(path, a.cpu()) for path, a in state_leaves(off.state)]
    del off
    gc.collect()
    torch.cuda.empty_cache()
    on, launches, stats_on = partition_run(seed, "on")
    for (path, a), (_, b) in zip(state_leaves(on.state), final_off):
        if not torch.equal(a.cpu(), b):
            fail(f"partition: overlap on and off differ in {path}")
    print(f"[partition] overlap on vs off after {PART_STEPS} steps: every "
          f"field bit-equal; {stats_on['step_ms']:.3f} vs "
          f"{stats_off['step_ms']:.3f} ms a step", flush=True)
    del final_off
    gc.collect()
    torch.cuda.empty_cache()
    dense = max(np.ndindex(*on.geom.mesh_shape),
                key=lambda c: stats_on["held"][
                    int(np.ravel_multi_index(c, on.geom.mesh_shape))]
                / math.prod(on.geom.owned_widths(c)))
    bands = band_rows(on, dense)
    del on
    gc.collect()
    torch.cuda.empty_cache()
    parity = phase_partition_parity(seed)
    ens = phase_partition_ensemble(seed)
    print(f"[partition] phase 15 in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return dict(on=stats_on, off=stats_off, launches=launches,
                bands=bands, parity=parity, ensemble=ens)


# ---------------------------------------------------------------------------
# Phase 16: the process mesh (one process a device) on the one card
# ---------------------------------------------------------------------------

PM_DIR = ROOT / "build" / "process_mesh"
PM_TIMEOUT_S = 300.0      # the group's waits and the parent's join


def state_sha(state, coords=None):
    """sha256 of every field of one device's state, keyed by field path:
    device ``coords`` of a virtual-mesh state, or a process's own."""
    import hashlib

    from repro_torch.bridge import rank_arrays, rank_state

    if coords is not None:
        state = rank_state(state, coords)
    out = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
           for k, v in sorted(rank_arrays(state).items())}
    del state
    return out


def pm_rank(rank: int, world: int, label: str, seed: int, interior,
            n_agents: int, out: str):
    """One rank of phase 16: its device of the process mesh on cuda:0
    (``interior`` and ``n_agents``: the main configuration's, as the
    parent has them)."""
    import torch.distributed as dist

    from repro_torch.core.engine import codec_overflow_count
    from repro_torch.launch.mesh import make_abm_mesh

    torch.cuda.set_device(0)
    if label == "main":
        mesh = make_abm_mesh(MESH_SHAPE)
        sim = make_sim(cc.behavior(), interior=tuple(interior),
                       mesh_shape=MESH_SHAPE, cap=MAIN_CAP, delta=MESH_DELTA,
                       sweep_backend="auto", device="cuda", mesh=mesh)
        cc.init(sim, n_agents, seed=seed)
        steps = MAIN_STEPS
    else:
        mesh = make_abm_mesh((2, 1))
        sim = torus_sim(seed, mesh=mesh)
        steps = TORUS_STEPS
    comm = sim.engine._comm(mesh)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    fracs = []
    if label == "main":
        fracs.append(cc.same_type_fraction(sim.state, sim.engine))
    sim.run(1)                                   # full refresh
    torch.cuda.synchronize()
    bytes_full = int(sim.state.halo_bytes.reshape(-1)[0])
    dist.barrier()
    c0 = dict(comm.stats)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    sim.run(steps - 1)
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t0
    dist.barrier()
    wall_s = time.perf_counter() - t0
    c1 = dict(comm.stats)
    if label == "main":
        fracs.append(cc.same_type_fraction(sim.state, sim.engine))
    launches = {k: v for k, v in all_launches().items() if v}
    st = sim.state
    res = dict(
        rank=rank, coords=list(comm.coords()), steps=steps,
        step_ms=start.elapsed_time(end) / (steps - 1),
        host_ms=1e3 * host_s / (steps - 1),
        wall_ms=1e3 * wall_s / (steps - 1),
        comm_ms=1e3 * (c1["seconds"] - c0["seconds"]) / (steps - 1),
        wire_bytes=(c1["bytes"] - c0["bytes"]) / (steps - 1),
        messages=(c1["messages"] - c0["messages"]) / (steps - 1),
        halo_bytes_full=bytes_full,
        halo_bytes=int(st.halo_bytes.reshape(-1)[0]),
        agents=sim.n_agents(), local_agents=total_agents(st),
        dropped=int(sim.sum_over_all_ranks(st.dropped.sum())),
        overflow=codec_overflow_count(st, comm),
        finite=bool(torch.isfinite(st.soa.pos).all()),
        peak_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, fractions=fracs, sha=state_sha(st))
    with open(f"{out}/r{rank}.json", "w") as f:
        json.dump(res, f)


def pm_spawn(label: str, world: int, seed: int):
    """Run phase 16's ``label`` on ``world`` ranks; their results."""
    import tempfile

    from repro_torch.launch.mesh import spawn_ranks

    PM_DIR.mkdir(parents=True, exist_ok=True)
    out = tempfile.mkdtemp(prefix=f"{label}-", dir=PM_DIR)
    t0 = time.perf_counter()
    spawn_ranks(pm_rank, world, f"{out}/store",
                args=(label, seed, MESH_INTERIOR,
                      4 * math.prod(MAIN_INTERIOR), out),
                timeout_s=PM_TIMEOUT_S)
    secs = time.perf_counter() - t0
    res = []
    for r in range(world):
        with open(f"{out}/r{r}.json") as f:
            res.append(json.load(f))
    return res, secs


def pm_gate(label: str, ranks, want_sha, want_launches, n_agents: int,
            want_halo: int):
    """Phase 16's gates on one run's ranks."""
    for r in ranks:
        c = tuple(r["coords"])
        tag = f"process mesh {label} rank {r['rank']} {c}"
        if r["agents"] != n_agents:
            fail(f"{tag}: agents {r['agents']} != {n_agents}")
        if r["dropped"] or r["overflow"] or not r["finite"]:
            fail(f"{tag}: dropped {r['dropped']}, codec overflow "
                 f"{r['overflow']}, finite {r['finite']}")
        if r["halo_bytes"] != want_halo:
            fail(f"{tag}: halo_bytes {r['halo_bytes']} != {want_halo}")
        if r["launches"] != want_launches:
            fail(f"{tag}: launches {r['launches']} != {want_launches}")
        diff = sorted(k for k, v in want_sha[c].items()
                      if r["sha"].get(k) != v)
        if diff or set(r["sha"]) != set(want_sha[c]):
            fail(f"{tag}: the final block differs from the virtual mesh's "
                 f"in {diff or 'its fields'}")
    if sum(r["local_agents"] for r in ranks) != n_agents:
        fail(f"process mesh {label}: ranks hold "
             f"{sum(r['local_agents'] for r in ranks)} agents")


def phase_process_mesh(seed: int, mesh_launches, mesh_stats):
    """Phase 16: phase 6's path on four ranks, one process a device, and
    phase 8's torus on two."""
    n_agents = 4 * math.prod(MAIN_INTERIOR)
    card_total = torch.cuda.get_device_properties(0).total_memory
    ranks, secs = pm_spawn("main", 4, seed)
    sim = make_sim(cc.behavior(), interior=(2, 2), mesh_shape=MESH_SHAPE,
                   cap=MAIN_CAP, delta=MESH_DELTA, device="cuda")
    codec = {k: v for k, v in codec_launches(sim, MAIN_STEPS).items() if v}
    want = dict(soft_repulsion_adhesion=MAIN_STEPS, same_type=2, **codec)
    share = {k: (v // 4 if k in ("soft_repulsion_adhesion", "same_type")
                 else v) for k, v in mesh_launches.items() if v}
    if share != want:
        fail(f"process mesh: phase 6's launches {mesh_launches} give "
             f"{share} a rank, not {want}")
    pm_gate("main", ranks, mesh_stats["block_sha"], want, n_agents,
            mesh_stats["bytes_delta"])
    slowest = max(r["step_ms"] for r in ranks)
    for r in ranks:
        print(f"[process mesh] rank {r['rank']} {tuple(r['coords'])}: "
              f"{r['step_ms']:.3f} ms/step (CUDA events), host "
              f"{r['host_ms']:.3f}, between barriers {r['wall_ms']:.3f}; "
              f"comm {r['comm_ms']:.3f} ms/step; wire "
              f"{r['wire_bytes']:.0f} B/step in {r['messages']:.0f} "
              f"buffers (halo_bytes {r['halo_bytes']}, full step "
              f"{r['halo_bytes_full']}); peak device memory "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; agents here "
              f"{r['local_agents']}; launches {r['launches']}", flush=True)
    print(f"[process mesh] 4 ranks on one card: slowest {slowest:.3f} "
          f"ms/step = {n_agents / (slowest / 1e3):.4g} agent-updates/s; "
          f"the virtual mesh (phase 6) {mesh_stats['step_ms']:.3f} ms/step; "
          f"card memory {card_total / 2**30:.2f} GiB; every rank's block "
          f"bit-equal to phase 6's; spawn to join {secs:.1f}s", flush=True)

    torus, tsecs = pm_spawn("torus", 2, seed)
    ref = torus_sim(seed)
    reset_all_launches()
    ref.run(1)
    ref.run(TORUS_STEPS - 1)
    torch.cuda.synchronize()
    tl = {k: v for k, v in all_launches().items() if v}
    twant = {k: (v // 2 if k == "soft_repulsion_adhesion" else v)
             for k, v in tl.items()}
    shas = {c: state_sha(ref.state, c) for c in np.ndindex(2, 1)}
    pm_gate("torus", torus, shas, twant, total_agents(ref.state),
            int(ref.state.halo_bytes.reshape(-1)[0]))
    print(f"[process mesh] 2x1 torus, {TORUS_STEPS} steps, 2 ranks: "
          f"launches {torus[0]['launches']} a rank, each rank's block "
          f"bit-equal to the virtual mesh's; comm "
          f"{max(r['comm_ms'] for r in torus):.3f} ms/step; spawn to join "
          f"{tsecs:.1f}s", flush=True)
    return dict(
        ranks=[{k: v for k, v in r.items() if k != "sha"} for r in ranks],
        slowest_step_ms=slowest, virtual_step_ms=mesh_stats["step_ms"],
        agent_updates_per_s=n_agents / (slowest / 1e3),
        card_total_bytes=card_total, seconds=secs,
        torus=dict(launches=torus[0]["launches"], seconds=tsecs,
                   comm_ms=[r["comm_ms"] for r in torus]))


# ---------------------------------------------------------------------------
# Phase 17: dynamic load balancing and logical checkpoints
# ---------------------------------------------------------------------------

RB_STEPS = 10
RB_POLICY = Rebalance(every=5, threshold=0.1, ownership="rcb")
RB_BEFORE = (0.22, 0.25)          # the equal split's imbalance, 0.2346 by hand
RB_AFTER = 0.01
RB_DIR = ROOT / "build" / "rebalance_ckpt"
RB_SMALL_INTERIOR = (64, 64)      # (d): 128^2 cells on four ranks
RB_SMALL_STEPS = 6


def rb_sim(seed: int, interior, mesh=None):
    """Phase 15's seeding (a quarter of the agents in each slab of the
    cut ``PART_WIDTHS``, scaled to the grid) on the equal 2x2 split, 4 a
    cell, cap 48, ``int8+mig``, with phase 17's rebalance policy."""
    from repro_torch.core import Domain, Partition

    g = tuple(2 * i for i in interior)
    widths = tuple(tuple(w * g[a] // sum(ws) for w in ws)
                   for a, ws in enumerate(PART_WIDTHS))
    part = Partition.from_widths(widths)
    cut = Domain(cell_size=2.0, interior=part.max_widths,
                 mesh_shape=MESH_SHAPE, cap=MAIN_CAP, partition=part)
    sim = make_sim(cc.behavior(), interior=tuple(interior),
                   mesh_shape=MESH_SHAPE, cap=MAIN_CAP, delta=MESH_DELTA,
                   sweep_backend="auto", device="cuda", mesh=mesh,
                   rebalance=RB_POLICY)
    n = 4 * math.prod(g)
    rng = np.random.default_rng(seed)
    pos = balanced_positions(cut, n, rng)
    sim.init(pos, {"diameter": np.full((n,), 1.0, np.float32),
                   "ctype": rng.integers(0, 2, n).astype(np.int32)})
    return sim


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def states_bit_equal(a, b):
    """The field paths where two states differ (bit for bit)."""
    from repro_torch.bridge import _leaves

    la, lb = _leaves(a), _leaves(b)
    return sorted(k for k in set(la) | set(lb)
                  if k not in la or k not in lb or not bit_equal(la[k], lb[k]))


def by_gid(state):
    """Every column of the live agents, sorted by gid (rank, count)."""
    v = state.soa.valid
    a = state.soa.attrs
    key = (a["gid_rank"][v].long() << 32) + a["gid_count"][v].long()
    key, order = torch.sort(key)
    return key, {n: t[v][order] for n, t in a.items()}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rb_transports(sim):
    """Phase 17 (b): the initial state re-sharded onto the planned cut by
    each transport, timed, every field bit-equal; the histogram and the
    plan timed; the equal split's delta step timed."""
    eng, st = sim.engine, sim.state
    hist, hist_s = timed(lambda: rs.occupancy_histogram(eng.geom, st))
    plan, plan_s = timed(lambda: rs.plan_reshard(hist, eng.geom))
    imb = rs.imbalance(rs.realized_loads(eng.geom, hist))
    print(f"[rebalance] equal 2x2 split: imbalance {imb:.6f}; histogram "
          f"{1e3 * hist_s:.3f} ms, plan {1e3 * plan_s:.3f} ms (cut "
          f"{plan.partition.widths}, planned imbalance "
          f"{plan.partition_imbalance:.6f}, rcb bound {plan.rcb_bound:.6f})",
          flush=True)
    if not RB_BEFORE[0] <= imb <= RB_BEFORE[1]:
        fail(f"rebalance: imbalance before {imb} not in {RB_BEFORE}")
    # the equal split's step before any re-shard (a step is functional:
    # the facade's state is untouched): a full step, then three delta
    # steps, each timed; the last two's mean (the first pays the
    # allocator's growth)
    step = eng.make_local_step()
    s = step(st, full_halo=True)
    before = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        s = step(s, full_halo=False)
        end.record()
        end.synchronize()
        before.append(start.elapsed_time(end))
    before_ms = sum(before[1:]) / 2
    del s
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (e_host, s_host), host_s = timed(lambda: rs.reshard_state(
        eng, st, partition=plan.partition, transport="host"))
    (e_dev, s_dev), dev_s = timed(lambda: rs.reshard_state(
        eng, st, partition=plan.partition, transport="device"))
    peak = torch.cuda.max_memory_allocated()
    diff = states_bit_equal(s_host, s_dev)
    if diff or e_host.geom != e_dev.geom:
        fail(f"rebalance: host and device transports differ in {diff}")
    n = total_agents(s_dev)
    del s_host, s_dev
    torch.cuda.empty_cache()
    print(f"[rebalance] transports onto the cut: host {host_s:.3f} s, "
          f"device {dev_s:.3f} s, every field bit-equal; {n} agents; peak "
          f"{peak / 2**30:.2f} GiB; the equal split's delta steps "
          f"{', '.join(f'{v:.3f}' for v in before)} ms", flush=True)
    return dict(imbalance_before=imb, histogram_ms=1e3 * hist_s,
                plan_ms=1e3 * plan_s, widths=plan.partition.widths,
                planned_imbalance=plan.partition_imbalance,
                rcb_bound=plan.rcb_bound, host_s=host_s, device_s=dev_s,
                transport_peak_bytes=peak, step_ms_before=before_ms,
                delta_steps_ms_before=before)


def rb_run(sim, plan_widths):
    """Phase 17 (a): the rebalanced run, counts zeroed before and read
    after, each step timed (CUDA events) and gated."""
    n0 = total_agents(sim.state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    rows, halo = [], []
    for t in range(RB_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sim.run(1)
        end.record()
        st = sim.state
        rows.append(torch.stack([st.soa.valid.sum(), st.dropped.sum(),
                                 st.codec_overflow.max()]))
        halo.append(int(st.halo_bytes.reshape(-1)[0]))
        rows[-1] = (rows[-1], start, end)
    del st
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_launches().items() if v}
    peak = torch.cuda.max_memory_allocated()
    ms = [a.elapsed_time(b) for _, a, b in rows]
    hist = sim.rebalancer.history
    applied = [h for h in hist if h["applied"]]
    for t, (r, _, _) in enumerate(rows):
        n, dropped, overflow = (int(v) for v in r.tolist())
        if n != n0 or dropped or overflow:
            fail(f"rebalance: step {t + 1}: agents {n}, dropped {dropped}, "
                 f"codec_overflow {overflow}")
    if len(applied) != 1 or applied[0]["it"] != 0:
        fail(f"rebalance: {len(applied)} re-shards applied: {hist}")
    rec = applied[0]
    if rec["imbalance_after"] > RB_AFTER:
        fail(f"rebalance: imbalance after {rec['imbalance_after']}")
    if rec["partition_widths"] != tuple(plan_widths):
        fail(f"rebalance: applied cut {rec['partition_widths']} is not the "
             f"planned {plan_widths}")
    keys, _ = by_gid(sim.state)
    if keys.numel() != n0 or bool((keys[1:] == keys[:-1]).any()):
        fail("rebalance: gids not unique after the re-shard")
    eng = sim.engine
    full = eng._aura(sim.state, eng._comm(), True)[2]
    if halo[0] != full or not halo[1] < full:
        fail(f"rebalance: halo_bytes {halo[:2]}; a full aura is {full}: the "
             "step after the re-shard was not a full refresh")
    want = {k: v for k, v in dict(
        codec_launches(sim, RB_STEPS),
        soft_repulsion_adhesion=RB_STEPS * sim.geom.n_devices).items() if v}
    if launches != want:
        fail(f"rebalance: kernel launches {launches} != {want}")
    after_ms = sum(ms[1:]) / (RB_STEPS - 1)
    print(f"[rebalance] {RB_STEPS} steps: re-shard at tick 0 "
          f"({rec['transport']} transport, {rec['migration_s']:.3f} s), cut "
          f"{rec['partition_widths']} (pad {rec['pad_fraction']:.4f}), "
          f"imbalance {rec['imbalance_before']:.6f} -> "
          f"{rec['imbalance_after']:.6f}; later checks "
          f"{[(h['it'], round(h['imbalance_before'], 6)) for h in hist[1:]]};"
          f" agents {n0} at every step, dropped 0, codec_overflow 0, gids "
          f"unique; first step (re-shard + full refresh) {ms[0]:.3f} ms, "
          f"steps 2-{RB_STEPS} {after_ms:.3f} ms/step on the cut; halo_bytes "
          f"{halo[0]} (full) then {halo[1]}; peak {peak / 2**30:.2f} GiB; "
          f"launches {launches}", flush=True)
    return dict(history=[{k: v for k, v in h.items()} for h in hist],
                launches=launches, step_ms_after=after_ms,
                first_step_ms=ms[0], peak_bytes=peak,
                migration_s=rec["migration_s"],
                imbalance_after=rec["imbalance_after"])


def rb_checkpoint(sim):
    """Phase 17 (c): save_abm, then restore onto one device and onto the
    2x2 (ownership kept); agents by gid bit for bit, the carry, one step
    each with its launches counted."""
    import shutil

    shutil.rmtree(RB_DIR, ignore_errors=True)
    path, save_s = timed(lambda: ckpt.save_abm(
        str(RB_DIR), sim.iteration, sim.engine, sim.state))
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    keys, cols = by_gid(sim.state)
    base = sim.state.key[(0,) * sim.geom.ndim]
    floor = int(sim.state.gid_counter.max())
    out = dict(save_s=save_s, bytes_on_disk=nbytes, restores={})
    print(f"[checkpoint] save_abm {save_s:.3f} s, {nbytes} B on disk "
          f"({path})", flush=True)
    for n_dev in (1, 4):
        back, secs = timed(lambda: Simulation.restore(
            str(RB_DIR), cc.behavior(), n_devices=n_dev, device="cuda"))
        label = f"checkpoint -> {back.geom.mesh_shape}"
        if n_dev == 4 and not back.geom.uneven:
            fail(f"{label}: the uneven ownership was not kept")
        k2, c2 = by_gid(back.state)
        bad = [n for n in cols if not bit_equal(cols[n], c2[n])]
        if not torch.equal(keys, k2) or bad:
            fail(f"{label}: agents differ by gid in {bad or 'their gids'}")
        st = back.state
        want_keys = prng.split(prng.fold_in(base, sim.iteration), n_dev)
        if (back.iteration != sim.iteration or int(st.dropped.sum())
                or not torch.equal(st.key.reshape(-1, 2), want_keys)
                or int(st.gid_counter.min()) < floor):
            fail(f"{label}: the carry (iteration, drops, keys, counters) "
                 "differs")
        reset_all_launches()
        back.run(1)
        torch.cuda.synchronize()
        launches = {k: v for k, v in all_launches().items() if v}
        want = {k: v for k, v in dict(
            codec_launches(back, 1),
            soft_repulsion_adhesion=n_dev).items() if v}
        if launches != want or back.n_agents() != keys.numel():
            fail(f"{label}: a step: launches {launches} != {want}, agents "
                 f"{back.n_agents()}")
        print(f"[{label}] restore {secs:.3f} s ({back.geom.partition}); "
              f"agents by gid bit-equal in {sorted(cols)}; the carry "
              f"(iteration {back.iteration}, keys, counters >= {floor}); "
              f"one step: launches {launches}", flush=True)
        out["restores"][str(n_dev)] = dict(
            seconds=secs, mesh=back.geom.mesh_shape, launches=launches)
        del back, st
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(RB_DIR, ignore_errors=True)
    return out


def rb_rank(rank: int, world: int, out: str, seed: int):
    """Phase 17 (d): one rank of the small rebalanced run."""
    torch.cuda.set_device(0)
    from repro_torch.launch.mesh import make_abm_mesh

    sim = rb_sim(seed, RB_SMALL_INTERIOR, mesh=make_abm_mesh(MESH_SHAPE))
    reset_all_launches()
    sim.run(RB_SMALL_STEPS)
    torch.cuda.synchronize()
    comm = sim.engine._comm(sim.mesh)
    res = dict(coords=list(comm.coords()), mesh=list(sim.geom.mesh_shape),
               sha=state_sha(sim.state), agents=sim.n_agents(),
               applied=[h["it"] for h in sim.rebalancer.history
                        if h["applied"]],
               launches={k: v for k, v in all_launches().items() if v})
    with open(f"{out}/r{rank}.json", "w") as f:
        json.dump(res, f)


def rb_process_mesh(seed: int):
    """Phase 17 (d): four ranks against the virtual mesh."""
    import tempfile

    from repro_torch.launch.mesh import spawn_ranks

    PM_DIR.mkdir(parents=True, exist_ok=True)
    out = tempfile.mkdtemp(prefix="rebalance-", dir=PM_DIR)
    t0 = time.perf_counter()
    spawn_ranks(rb_rank, 4, f"{out}/store", args=(out, seed),
                timeout_s=PM_TIMEOUT_S)
    secs = time.perf_counter() - t0
    ref = rb_sim(seed, RB_SMALL_INTERIOR)
    ref.run(RB_SMALL_STEPS)
    torch.cuda.synchronize()
    applied = [h["it"] for h in ref.rebalancer.history if h["applied"]]
    for r in range(4):
        with open(f"{out}/r{r}.json") as f:
            got = json.load(f)
        c = tuple(got["coords"])
        want = state_sha(ref.state, c)
        diff = sorted(k for k in want if got["sha"].get(k) != want[k])
        if (diff or tuple(got["mesh"]) != ref.geom.mesh_shape
                or got["applied"] != applied
                or got["agents"] != ref.n_agents()):
            fail(f"rebalance process mesh rank {r} {c}: differs from the "
                 f"virtual mesh in {diff or 'its mesh, decisions or agents'}")
    print(f"[rebalance process mesh] 4 ranks, {RB_SMALL_STEPS} steps at "
          f"{tuple(2 * i for i in RB_SMALL_INTERIOR)} cells: re-shards at "
          f"{applied} onto {ref.geom.partition}; every rank's block "
          f"bit-equal to the virtual mesh's; launches a rank "
          f"{got['launches']}; spawn to join {secs:.1f}s", flush=True)
    return dict(seconds=secs, applied=applied, launches=got["launches"],
                cut=ref.geom.partition.widths if ref.geom.uneven else None)


def phase_rebalance(seed: int):
    """Phase 17: dynamic load balancing and logical checkpoints."""
    t0 = time.perf_counter()
    sim = rb_sim(seed, MESH_INTERIOR)
    torch.cuda.synchronize()
    print(f"[rebalance] init {total_agents(sim.state)} agents on the equal "
          f"2x2 split: {time.perf_counter() - t0:.2f}s", flush=True)
    transports = rb_transports(sim)
    run = rb_run(sim, transports["widths"])
    saved = rb_checkpoint(sim)
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    small = rb_process_mesh(seed)
    secs = time.perf_counter() - t0
    print(f"[rebalance] phase 17: {secs:.1f}s", flush=True)
    return dict(transports, **run, checkpoint=saved, process_mesh=small,
                seconds=secs)


# ---------------------------------------------------------------------------
# Phase 18: runtime guards, fault plans and supervised runs; the scenario
# server over a process mesh
# ---------------------------------------------------------------------------

GUARD_STEPS = 10
GUARD_NAN_FRAC = 1e-6
SUP_DIR = ROOT / "build" / "supervised_ckpt"
SUP_STEPS = 12
SUP_PLAN = [dict(step=6, kind="halo_slab", axis=0),
            dict(step=8, kind="torn_checkpoint"),
            dict(step=9, kind="device_loss", survivors=2)]
# (kind, step, rolled_back_to, devices, replay_steps) the plan implies:
# the halo fault caught at the end of the 4 -> 8 chunk and rolled back to
# 4; the checkpoint at 8 torn after its save; the device loss at 9
# skipping it, back to 4 again, onto 2 devices
SUP_WANT = [("checkpoint", 0), ("checkpoint", 4),
            ("fault", "HealthError", 8), ("recovered", 4, 4, 4),
            ("checkpoint", 8), ("torn_checkpoint",),
            ("fault", "DeviceLost", 9), ("recovered", 4, 2, 5),
            ("checkpoint", 8), ("checkpoint", 12), ("completed", 12)]
PM_SERVE = dict(n_agents=131072, interior=(128, 128), mesh_shape=(2, 2))
PM_SERVE_REQUESTS = [({"beta": 0.05}, 8, 4, 0), ({"beta": 0.2}, 12, 4, 1),
                     ({"gamma": 0.3, "sir_radius": 1.0}, 12, 4, 2)]
PM_GUARD_STEPS = 3
# Phase 18 (e): a supervised 2x2 run (int8+mig, guards "error") that
# loses two devices at step 6 and degrades onto the survivors.
DEG_INTERIOR = (256, 256)
DEG_STEPS = 10
DEG_PLAN = [dict(step=6, kind="device_loss", survivors=2)]
DEG_LOG_KEYS = ("kind", "step", "iteration", "error_type", "rolled_back_to",
                "devices", "replay_steps", "left")


def guard_sim(seed: int, guards, mesh_shape=(1, 1), mesh=None):
    """Phase 4's main path (``mesh_shape`` (1, 1)) or phase 6's 2x2 virtual
    mesh (int8+mig), with ``guards``."""
    one = tuple(mesh_shape) == (1, 1)
    sim = make_sim(cc.behavior(),
                   interior=MAIN_INTERIOR if one else MESH_INTERIOR,
                   mesh_shape=mesh_shape, cap=MAIN_CAP,
                   delta=None if one else MESH_DELTA, sweep_backend="auto",
                   device="cuda", guards=guards, mesh=mesh)
    cc.init(sim, 4 * math.prod(MAIN_INTERIOR), seed=seed)
    return sim


def guard_run(seed: int, guards):
    """Phase 18 (a): ``GUARD_STEPS`` steps of the main path; the sim, its
    launches and ms a step over steps 2-10."""
    sim = guard_sim(seed, guards)
    torch.cuda.synchronize()
    reset_all_launches()
    sim.run(1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    sim.run(GUARD_STEPS - 1)
    end.record()
    end.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / (GUARD_STEPS - 1)
    launches = {k: v for k, v in all_launches().items() if v}
    return sim, launches, start.elapsed_time(end) / (GUARD_STEPS - 1), \
        host_ms


def guards_main(seed: int):
    """Phase 18 (a): the main path with guards "error" and off: every
    health word 0, the final states bit-equal, the same launches; ms a
    step of each, and the control point's reads timed."""
    from repro_torch.core import guards as tg

    off, l_off, ms_off, host_off = guard_run(seed, None)
    on, l_on, ms_on, host_on = guard_run(seed, "error")
    counts = tg.health_counts(on.state)
    diff = states_bit_equal(off.state, on.state)
    n = total_agents(on.state)
    if counts.tolist() != [0] * tg.NUM_GUARDS:
        fail(f"guards: health words {counts.tolist()} on a healthy run")
    if diff:
        fail(f"guards: the guarded run differs from the unguarded in {diff}")
    if l_on != l_off or l_on.get("soft_repulsion_adhesion") != GUARD_STEPS:
        fail(f"guards: launches {l_on} guarded, {l_off} not")
    if n != 4 * math.prod(MAIN_INTERIOR):
        fail(f"guards: {n} agents")
    del off
    gc.collect()
    torch.cuda.empty_cache()
    reads = {}
    for name, fn in (("health_counts", lambda: tg.health_counts(on.state)),
                     ("gid_duplicate_count",
                      lambda: tg.gid_duplicate_count(on.state)),
                     ("check_health", lambda: tg.check_health(
                         on.engine.guards, on.state, counts))):
        fn()
        times = []
        for _ in range(3):
            _, secs = timed(fn)
            times.append(1e3 * secs)
        reads[name] = min(times)
    dups = tg.gid_duplicate_count(on.state)
    if dups:
        fail(f"guards: {dups} duplicate gids")
    print(f"[guards] main path, {GUARD_STEPS} steps: guards off "
          f"{ms_off:.3f} ms/step, guards='error' {ms_on:.3f} ms/step "
          f"(CUDA events, steps 2-{GUARD_STEPS}; host {host_off:.3f} / "
          f"{host_on:.3f}): +{ms_on - ms_off:.3f} ms "
          f"({100 * (ms_on - ms_off) / ms_off:.2f}%); health {counts.tolist()};"
          f" final states bit-equal in every field; launches {l_on}",
          flush=True)
    print(f"[guards] control point on {n} agents (host clock, synchronised,"
          f" best of 3): health_counts {reads['health_counts']:.3f} ms, "
          f"device duplicate check {reads['gid_duplicate_count']:.3f} ms, "
          f"check_health {reads['check_health']:.3f} ms", flush=True)
    del on
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_ms_off=ms_off, step_ms_guarded=ms_on,
                host_ms_off=host_off, host_ms_guarded=host_on,
                launches=l_on, control_point_ms=reads)


def nan_slots(soa) -> int:
    """Live slots with a NaN position (the guard's count, independently:
    positions are the only float attribute the faults hit)."""
    return int((torch.isnan(soa.pos).any(-1) & soa.valid).sum())


def guards_trip(seed: int):
    """Phase 18 (b): each guard trips on the 2x2 virtual mesh under
    "warn": a halo_slab and a nan_attrs fault (nan_inf, the count the
    aura-filled SoA holds), a duplicated gid (gid_duplicate, 1) and an
    agent moved into the next device's slab (out_of_slab, 1); and the
    card's float-to-int conversion of non-finite positions as the CPU's
    binning spells it out (XLA's)."""
    from repro_torch.core import guards as tg
    from repro_torch.core.grid import floor_int32
    from repro_torch.distributed.chaos import Fault, FaultPlan

    x = torch.tensor([math.nan, math.inf, -math.inf, 3.7, -2.5, 3e9])
    got = floor_int32(x.cuda()).cpu()
    if not torch.equal(got, floor_int32(x)):
        fail(f"guards: the card converts {x.tolist()} to {got.tolist()}, "
             f"the CPU binning to {floor_int32(x).tolist()}")
    sim = guard_sim(seed, "warn", MESH_SHAPE)
    sim.run(1)
    eng = sim.engine
    comm = eng._comm()
    cfg = eng.guards
    out = {}

    def step(label, state, want_idx, want_new):
        mark = tg.health_counts(state)
        aura = eng._aura(state, comm, True)
        expect = nan_slots(aura[0]) if want_new is None else want_new
        del aura
        state = eng.local_step(state, comm, True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, rep = tg.check_health(cfg, state, mark)
        if rep is None or rep.new[want_idx] != expect or expect <= 0:
            fail(f"guards: {label} did not trip {tg.GUARD_NAMES[want_idx]} "
                 f"with {expect}: {rep and rep.format()}")
        print(f"[guards trip] {label}: {rep.format()}", flush=True)
        out[label] = dict(new=rep.new.tolist(), counts=rep.counts.tolist())
        return state

    it = sim.iteration
    st, _ = FaultPlan((Fault(step=it, kind="halo_slab", axis=0),),
                      seed=seed).fire(eng, sim.state, it)
    step("halo_slab", st, tg.GUARD_NAN, None)
    st, _ = FaultPlan((Fault(step=it, kind="nan_attrs",
                             frac=GUARD_NAN_FRAC),), seed=seed).fire(
        eng, sim.state, it)
    k = max(1, round(GUARD_NAN_FRAC * total_agents(sim.state)))
    if nan_slots(st.soa) != k:
        fail(f"guards: nan_attrs poked {nan_slots(st.soa)} agents, not {k}")
    step("nan_attrs", st, tg.GUARD_NAN, None)
    # a gid of device (0, 0) given to device (1, 1)'s first live agent
    st = sim.state
    v00 = torch.nonzero(st.soa.valid[0, 0].reshape(-1))[0, 0]
    v11 = torch.nonzero(st.soa.valid[1, 1].reshape(-1))[0, 0]
    gid = {n: st.soa.attrs[n].clone() for n in ("gid_rank", "gid_count")}
    for n in gid:
        gid[n][1, 1].reshape(-1)[v11] = gid[n][0, 0].reshape(-1)[v00]
    dup = dataclasses.replace(st, soa=st.soa.replace(
        attrs={**st.soa.attrs, **gid}))
    step("duplicate gid", dup, tg.GUARD_GID_DUP, 1)
    del dup, gid
    # device (0, 0)'s first live agent moved one device along x
    pos = st.soa.pos.clone()
    pos[0, 0].reshape(-1, 2)[v00, 0] += MESH_INTERIOR[0] * sim.geom.cell_size
    moved = dataclasses.replace(st, soa=st.soa.replace(
        attrs={**st.soa.attrs, "pos": pos}))
    step("out of slab", moved, tg.GUARD_SLAB, 1)
    del moved, pos, st, sim
    gc.collect()
    torch.cuda.empty_cache()
    return out


def guards_supervised(seed: int):
    """Phase 18 (c): a supervised run at full width on the 2x2 (a halo
    fault, a torn checkpoint, a device loss), its log as the plan implies,
    agents conserved and health 0 after recovery, and the replay bit-equal
    by gid to an uninterrupted run resumed from the rollback checkpoint
    onto the same devices."""
    import shutil

    from repro_torch.core import guards as tg
    from repro_torch.distributed.chaos import Fault, FaultPlan
    from repro_torch.launch.supervise import Supervised, Supervisor

    shutil.rmtree(SUP_DIR, ignore_errors=True)
    sim = guard_sim(seed, "error", MESH_SHAPE)
    n0 = total_agents(sim.state)
    codec = sim.engine.delta_cfg    # a restore re-applies it (ROADMAP C 7)
    plan = FaultPlan(tuple(Fault(**f) for f in SUP_PLAN), seed=seed)
    sv = Supervisor(sim, Supervised(dir=str(SUP_DIR), every=4, keep=3),
                    fault_plan=plan)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the torn checkpoint's skip
        sv.run(SUP_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = []
    for e in sv.log:
        k = e["kind"]
        got.append((k,) + tuple(e[f] for f in {
            "checkpoint": ("step",), "fault": ("error_type", "iteration"),
            "recovered": ("rolled_back_to", "devices", "replay_steps"),
            "completed": ("iteration",)}.get(k, ())))
    if got != [tuple(w) for w in SUP_WANT]:
        fail(f"supervised: log {got} != {SUP_WANT}")
    counts = tg.health_counts(sim.state)
    if (total_agents(sim.state) != n0 or counts.any()
            or sim.geom.n_devices != 2):
        fail(f"supervised: {total_agents(sim.state)} agents of {n0}, "
             f"health {counts.tolist()}, {sim.geom.mesh_shape}")
    rec = sv.events("recovered")[-1]
    ctl, restore_s = timed(lambda: Simulation.restore(
        str(SUP_DIR), cc.behavior(), step=rec["rolled_back_to"],
        n_devices=rec["devices"], delta=codec, guards="error",
        device="cuda"))
    ctl.run(SUP_STEPS - rec["rolled_back_to"])
    k1, c1 = by_gid(sim.state)
    k2, c2 = by_gid(ctl.state)
    bad = [n for n in c1 if not bit_equal(c1[n], c2[n])]
    if not torch.equal(k1, k2) or bad:
        fail(f"supervised: the replay differs by gid in {bad or 'gids'}")
    saves = [round(e["seconds"], 3) for e in sv.events("checkpoint")]
    restores = [round(e["seconds"], 3) for e in sv.events("recovered")]
    print(f"[supervised] 2x2, {SUP_STEPS} steps, every=4 keep=3: log "
          f"{got}; agents {n0} conserved, health 0 on {sim.geom.mesh_shape};"
          f" the replay bit-equal by gid in {sorted(c1)} to a resume from "
          f"step {rec['rolled_back_to']} on {rec['devices']} devices; "
          f"saves {saves} s (async: the snapshot; the write overlaps), "
          f"recoveries {restores} s, the control's restore "
          f"{restore_s:.3f} s; supervised run {run_s:.1f} s", flush=True)
    del sim, ctl, c1, c2, k1, k2
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(SUP_DIR, ignore_errors=True)
    return dict(log=got, save_s=saves, recover_s=restores,
                control_restore_s=restore_s, run_s=run_s)


def serve_frames(mesh=None):
    """Every request's frames of phase 18 (d)'s sir_mechanics server."""
    from repro_torch.launch.serve import (
        ScenarioRequest, ScenarioServer, sir_mechanics_family)

    server = ScenarioServer([sir_mechanics_family(device="cuda", **PM_SERVE)],
                            slot_size=4, mesh=mesh)
    rids = [server.submit(ScenarioRequest(
        family="sir_mechanics", params=p, steps=n, stream_every=e, seed=s))
        for p, n, e, s in PM_SERVE_REQUESTS]
    server.drain()
    return {str(r): [(int(t), np.asarray(f).tolist())
                     for t, f in server.handle(r).frames] for r in rids}


def degrade_run(seed: int, ckpt_dir: str, mesh=None):
    """Phase 18 (e): the supervised run that degrades (on the virtual
    mesh, or this rank's device of a process ``mesh``): its sim and
    supervisor."""
    from repro_torch.distributed.chaos import Fault, FaultPlan
    from repro_torch.launch.supervise import Supervised, Supervisor

    sim = make_sim(cc.behavior(), interior=DEG_INTERIOR,
                   mesh_shape=MESH_SHAPE, cap=MAIN_CAP, delta=MESH_DELTA,
                   sweep_backend="auto", device="cuda", guards="error",
                   mesh=mesh)
    cc.init(sim, 4 * math.prod(DEG_INTERIOR) * math.prod(MESH_SHAPE),
            seed=seed)
    sv = Supervisor(sim, Supervised(dir=ckpt_dir, every=4, keep=3),
                    fault_plan=FaultPlan(tuple(Fault(**f) for f in DEG_PLAN),
                                         seed=seed))
    sv.run(DEG_STEPS)
    torch.cuda.synchronize()
    return sim, sv


def degrade_log(sv):
    return [{k: e[k] for k in DEG_LOG_KEYS if k in e} for e in sv.log]


def guarded_pm_run(seed: int, mesh=None):
    """Phase 16's configuration, guarded ("warn"), with a nan_attrs fault
    at its second step: the global health counts after
    ``PM_GUARD_STEPS`` steps."""
    from repro_torch.core import guards as tg
    from repro_torch.distributed.chaos import Fault, FaultPlan

    sim = guard_sim(seed, "warn", MESH_SHAPE, mesh)
    plan = FaultPlan((Fault(step=1, kind="nan_attrs",
                            frac=GUARD_NAN_FRAC),), seed=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim.run(PM_GUARD_STEPS, fault_plan=plan)
    return tg.health_counts(sim.state, sim._comm).tolist()


def guards_rank(rank: int, world: int, out: str, seed: int):
    """Phase 18 (d, e): one rank: the server's frames, the guarded run's
    health counts and the degraded supervised run."""
    from repro_torch.launch.mesh import make_abm_mesh

    torch.cuda.set_device(0)
    mesh = make_abm_mesh(MESH_SHAPE)
    t0 = time.perf_counter()
    frames = serve_frames(mesh)
    serve_s = time.perf_counter() - t0
    counts = guarded_pm_run(seed, mesh)
    sim, sv = degrade_run(seed, f"{out}/degrade_ckpt", mesh)
    degrade = dict(
        left=sv.left, log=degrade_log(sv), iteration=sim.iteration,
        recover_s=[e["seconds"] for e in sv.events("recovered")])
    if not sv.left:
        degrade.update(coords=list(sim.engine._comm(sim.mesh).coords()),
                       sha=state_sha(sim.state), n_agents=sim.n_agents(),
                       mesh=list(sim.geom.mesh_shape))
    with open(f"{out}/r{rank}.json", "w") as f:
        json.dump(dict(frames=frames, counts=counts, serve_s=serve_s,
                       degrade=degrade), f)


def guards_process_mesh(seed: int):
    """Phase 18 (d, e): four gloo ranks on the card against the virtual
    mesh: the server's frames, the guarded run's health counts, and a
    supervised run that loses two devices: each survivor's block (sha256
    of every field) and its log the virtual degraded run's, the ranks that
    left stopped at the fault."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import spawn_ranks

    PM_DIR.mkdir(parents=True, exist_ok=True)
    out = tempfile.mkdtemp(prefix="guards-", dir=PM_DIR)
    t0 = time.perf_counter()
    spawn_ranks(guards_rank, 4, f"{out}/store", args=(out, seed),
                timeout_s=PM_TIMEOUT_S)
    secs = time.perf_counter() - t0
    want_frames = json.loads(json.dumps(serve_frames()))
    want_counts = guarded_pm_run(seed)
    if not want_counts[0]:
        fail(f"guards process mesh: the virtual run's nan_inf is 0 "
             f"({want_counts})")
    deg_dir = PM_DIR / "degrade_virtual"
    shutil.rmtree(deg_dir, ignore_errors=True)
    vsim, vsv = degrade_run(seed, str(deg_dir))
    want_log = degrade_log(vsv)
    (vrec,) = vsv.events("recovered")
    vshape = tuple(vsim.geom.mesh_shape)
    if vsim.geom.n_devices != 2:
        fail(f"degrade: the virtual run ends on {vshape}")
    want_sha = {c: state_sha(vsim.state, c) for c in np.ndindex(*vshape)}
    v_agents = vsim.n_agents()
    del vsim, vsv
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(deg_dir, ignore_errors=True)
    cut = want_log.index({k: vrec[k] for k in DEG_LOG_KEYS if k in vrec})
    serve_s, recover_s = [], []
    for r in range(4):
        with open(f"{out}/r{r}.json") as f:
            got = json.load(f)
        d = got["degrade"]
        recover_s.append(d["recover_s"])
        if r < 2:
            if d["left"] or d["log"] != want_log or \
                    d["sha"] != want_sha[tuple(d["coords"])] or \
                    d["n_agents"] != v_agents:
                fail(f"degrade rank {r}: left {d['left']}, log "
                     f"{d['log']} against {want_log}, or its block differs "
                     f"from the virtual degraded run's")
        elif not d["left"] or d["log"] != want_log[:cut] + [
                dict(want_log[cut], left=True)] or \
                d["iteration"] != want_log[cut - 1]["iteration"]:
            fail(f"degrade rank {r}: did not leave at the fault ({d})")
        if got["frames"] != want_frames:
            fail(f"serve process mesh rank {r}: frames differ from the "
                 "virtual-mesh server's")
        if got["counts"] != want_counts:
            fail(f"guards process mesh rank {r}: health {got['counts']} != "
                 f"{want_counts}")
        serve_s.append(got["serve_s"])
    n = PM_SERVE["n_agents"]
    for frames in want_frames.values():
        if any(sum(f) != n for _, f in frames):
            fail(f"serve process mesh: a frame does not sum to {n}")
    print(f"[guards process mesh] 4 ranks: the sir_mechanics server "
          f"({len(PM_SERVE_REQUESTS)} requests, budgets 8 and 12, every 4;"
          f" {n} agents on {PM_SERVE['mesh_shape']} x "
          f"{PM_SERVE['interior']} cells) streams the virtual-mesh "
          f"server's frames on every rank, bit for bit "
          f"({max(serve_s):.1f} s a rank); a guarded run with a nan_attrs "
          f"fault: health {want_counts} on every rank and on the virtual "
          f"mesh; a supervised run losing 2 of 4 devices at step 6 "
          f"degrades onto ranks 0-1 ({vshape}), each survivor's block the "
          f"virtual degraded run's bit for bit ({v_agents} agents), its log "
          f"the virtual one's, ranks 2-3 stopped at the fault; spawn to "
          f"join {secs:.1f}s", flush=True)
    print(f"[degrade] recovery seconds, ranks 0-3: {recover_s}; the "
          f"virtual mesh's {vrec['seconds']:.3f}", flush=True)
    return dict(seconds=secs, health=want_counts, serve_s=serve_s,
                degrade=dict(recover_s=recover_s,
                             virtual_recover_s=vrec["seconds"],
                             mesh=list(vshape), n_agents=v_agents))


def phase_guards(seed: int):
    """Phase 18: guards, fault plans and supervision on the card, and the
    scenario server over a process mesh."""
    t0 = time.perf_counter()
    main_path = guards_main(seed)
    trips = guards_trip(seed)
    supervised = guards_supervised(seed)
    pm = guards_process_mesh(seed)
    secs = time.perf_counter() - t0
    print(f"[guards] phase 18: {secs:.1f}s", flush=True)
    return dict(main_path=main_path, trips=trips, supervised=supervised,
                process_mesh=pm, seconds=secs)


# ---------------------------------------------------------------------------
# Phase 19: the simcheck suite on the card
# ---------------------------------------------------------------------------

def _sc_item_update(attrs, valid, acc, key, params, dt):
    drift = attrs["diameter"].sum().item()   # planted: a device->host read
    new = dict(attrs)
    new["diameter"] = attrs["diameter"] + drift
    return new, valid, torch.zeros_like(valid), None


def _sc_f64_update(attrs, valid, acc, key, params, dt):
    new = dict(attrs)                         # planted: a float64 upcast
    new["diameter"] = (attrs["diameter"].double() * 2.0).float()
    return new, valid, torch.zeros_like(valid), None


def simcheck_main_sim(seed: int, mesh: bool):
    """Phase 4's main sim (``mesh=False``) or phase 6's 2x2 ``int8+mig``
    mesh, seeded as those phases seed it, after one step."""
    if mesh:
        sim = make_sim(cc.behavior(), interior=MESH_INTERIOR,
                       mesh_shape=MESH_SHAPE, cap=MAIN_CAP, delta=MESH_DELTA,
                       sweep_backend="auto", device="cuda")
    else:
        sim = make_sim(cc.behavior(), interior=MAIN_INTERIOR, cap=MAIN_CAP,
                       sweep_backend="auto", device="cuda")
    cc.init(sim, 4 * math.prod(MAIN_INTERIOR), seed=seed)
    sim.run(1)
    torch.cuda.synchronize()
    return sim


def simcheck_validate(sim, label: str):
    """Phase 19 (b) on one sim: ``validate()`` clean under strict, every
    field of ``sim.state`` bit-equal (sha256) and every launch counter as
    before; its seconds and peak memory."""
    before = state_sha(sim.state)
    counts = all_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rep = sim.validate()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    after = state_sha(sim.state)
    print(f"[simcheck] {label}: validate() {secs:.2f}s, peak device memory "
          f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB held before); "
          f"{rep.summary()}", flush=True)
    if rep.exit_code(strict=True):
        fail(f"simcheck {label}: validate() not clean under strict:\n"
             f"{rep.format_text()}")
    diff = sorted(k for k in before if before[k] != after.get(k))
    if diff:
        fail(f"simcheck {label}: validate() changed sim.state in {diff}")
    if all_launches() != counts:
        fail(f"simcheck {label}: validate() changed the launch counts "
             f"{counts} -> {all_launches()}")
    return dict(seconds=secs, peak_bytes=peak, held_bytes=base,
                diagnostics=len(rep))


def simcheck_syncs(audit, label: str, context: str):
    """Phase 19 (c): the engine's own host syncs of one audited step."""
    for line in audit.format_syncs(context).splitlines():
        print(f"[simcheck syncs] {label} {line}", flush=True)
    if audit.diagnostics:
        fail(f"simcheck {label}: the audit found "
             f"{[d.format() for d in audit.diagnostics]}")
    return dict(
        syncs=[[op, frame, n] for (op, frame), n
               in sorted(audit.syncs[context].items())],
        uploads=[[op, frame, n] for (op, frame), n
                 in sorted(audit.uploads[context].items())],
        ops=audit.n_ops[context], seconds=audit.seconds,
        launches=audit.launches)


def simcheck_planted():
    """Phase 19 (d): a planted ``.item()`` and a planted float64 update,
    each flagged on the card exactly as on the CPU."""
    from repro_torch.analysis import audit_engine
    from repro_torch.core.domain import Domain
    from repro_torch.core.engine import Engine

    out = {}
    for name, upd, contract in (("item", _sc_item_update, "host-sync"),
                                ("float64", _sc_f64_update, "dtype-drift")):
        beh = dataclasses.replace(cc.behavior(), update_fn=upd)
        geom = Domain(cell_size=2.0, interior=(8, 8), mesh_shape=(2, 2),
                      cap=24)
        got = {dev: [d.to_dict() for d in audit_engine(
            Engine(geom=geom, behavior=beh, delta_cfg=DeltaConfig(
                enabled=True, qdtype=torch.int8, migration=torch.int16),
                device=dev))] for dev in ("cuda", "cpu")}
        flagged = sorted({(d["severity"], d["contract"], d["location"])
                          for d in got["cuda"]})
        print(f"[simcheck planted] {name}: {flagged}", flush=True)
        if got["cuda"] != got["cpu"]:
            fail(f"simcheck planted {name}: the card's findings "
                 f"{got['cuda']} != the CPU's {got['cpu']}")
        if not any(d["contract"] == contract for d in got["cuda"]):
            fail(f"simcheck planted {name}: no {contract} finding")
        out[name] = flagged
    return out


def phase_simcheck(seed: int):
    """Phase 19: the simcheck suite on the card (``Simulation.validate``,
    the step audit, the lint, the CLI)."""
    import contextlib
    import io

    from repro_torch.analysis import audit_step
    from repro_torch.launch import simcheck

    t_phase = time.perf_counter()
    # (a) the bare CLI under --strict on the card
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = simcheck.main(["--strict"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    print(f"[simcheck] bare simcheck --strict on the card: rc {rc}, "
          f"{cli_s:.2f}s; {buf.getvalue().strip().splitlines()[-1]}",
          flush=True)
    if rc != 0:
        fail(f"simcheck --strict exited {rc}:\n{buf.getvalue()}")

    # (b) validate() on the main sim and on the 2x2 int8+mig mesh, and
    # (c) the engine's own host syncs of a main step, a mesh delta step
    # and a guarded main step
    sim = simcheck_main_sim(seed, mesh=False)
    main_v = simcheck_validate(sim, "main (16,777,216 agents, cap 48)")
    a_main = audit_step(sim.engine)
    syncs = {"main step[full]": simcheck_syncs(a_main, "main",
                                               "step[full]")}
    a_guard = audit_step(dataclasses.replace(sim.engine, guards="error"))
    syncs["guarded main step[full]"] = simcheck_syncs(
        a_guard, "guarded main", "step[full]")
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    sim = simcheck_main_sim(seed, mesh=True)
    mesh_v = simcheck_validate(sim, "2x2 int8+mig mesh")
    a_mesh = audit_step(sim.engine)
    syncs["mesh step[delta]"] = simcheck_syncs(a_mesh, "mesh",
                                               "step[delta]")
    del sim
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the probe steps' kernel launches
    launches = {"main": a_main.launches, "guarded main": a_guard.launches,
                "mesh": a_mesh.launches}
    print(f"[simcheck] the probe steps' launches: {launches}", flush=True)
    for label, got in launches.items():
        if got.get("soft_repulsion_adhesion", 0) < 1:
            fail(f"simcheck {label}: the probe step launched no pair_sweep")
    for name in CODEC_REPLACES:
        if a_mesh.launches.get(name, 0) < 1:
            fail(f"simcheck mesh: the probe steps launched no {name}")

    # (d) planted faults, flagged on the card as on the CPU
    planted = simcheck_planted()
    secs = time.perf_counter() - t_phase
    print(f"[simcheck] phase 19: {secs:.1f}s", flush=True)
    return dict(cli_seconds=cli_s, main=main_v, mesh=mesh_v, syncs=syncs,
                launches=launches, planted=planted, seconds=secs)


# ---------------------------------------------------------------------------
# Phase 20: ops.neighborhood_pair_sweep on gathered slabs, every law
# ---------------------------------------------------------------------------

# Every device law and stack of the kernel (law numbers 0-5, 16-18).
SLAB_LAWS = ("soft_repulsion_adhesion", "same_type", "epidemiology",
             "oncology", "crowd", ENS_LAW5, STACK, SPH_STACK, ENS_STACK)
SLAB_ROWS = (0, 64)        # interior rows of the main path's SoA gathered
SLAB_CHUNK = 2048          # cells a plain-version chunk


def slab_call(slabs, law, plain=False):
    pair_fn, _, params = LAW_ARGS[law]
    fn = ni.pair_sweep_plain if plain else ops.neighborhood_pair_sweep
    return fn(*slabs, pair_fn=pair_fn, radius=2.0, params=params, box=None)


def slab_plain_chunked(slabs, law):
    """The plain version ``SLAB_CHUNK`` cells at a time (its (C, K, NK)
    pair tensors would not fit at once)."""
    ai, aj, vi, vj = slabs
    parts = []
    for c0 in range(0, vi.shape[0], SLAB_CHUNK):
        sl = slice(c0, c0 + SLAB_CHUNK)
        parts.append(slab_call(({n: a[sl] for n, a in ai.items()},
                                {n: a[sl] for n, a in aj.items()},
                                vi[sl], vj[sl]), law, plain=True))
    return {n: torch.cat([p[n] for p in parts]) for n in parts[0]}


def slab_bound(slabs, law, valid_pairs: int, in_radius: int):
    """(bound_ms, bound_by, bytes, ops), valid-first as :func:`bound`
    counts: each slot's valid flag of both slabs, the law's columns (pos,
    the gids, its own) of the valid slots only (the kernel reads no more
    of an empty slot), each read once, and every self slot's outputs
    written once; the distance test on the valid pairs of distinct slots
    and the law on those within the radius."""
    ai, aj, vi, vj = slabs
    pl = ni.law_for(LAW_ARGS[law][0])
    names = ("pos", "gid_rank", "gid_count") + pl.float_cols + pl.int_cols
    row = sum(ai[n][0, 0].numel() * ai[n].element_size() for n in names)
    nbytes = vi.numel() + vj.numel() + row * (int(vi.sum()) + int(vj.sum()))
    c, k = vi.shape
    nd = ai["pos"].shape[-1]
    nbytes += c * k * 4 * sum(nd if ax else 1 for _, ax in pl.outputs)
    nops = (3 * nd + 1) * valid_pairs + OPS_LAW[law] * in_radius
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, nops)


def slab_small_3d(seed: int):
    """Every law on random D = 3 slabs on the card (64 cells, K 8, NK
    216), closed and toroidal, against the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c, k, nk = 64, 8, 216

    def side(n):
        return ({"pos": torch.rand((c, n, 3), generator=gen,
                                   device="cuda") * 6,
                 "gid_rank": torch.zeros((c, n), dtype=torch.int32,
                                         device="cuda"),
                 "gid_count": torch.randint(0, 10_000, (c, n), generator=gen,
                                            device="cuda",
                                            dtype=torch.int32),
                 "diameter": 0.6 + 0.8 * torch.rand((c, n), generator=gen,
                                                    device="cuda"),
                 "ctype": torch.randint(0, 2, (c, n), generator=gen,
                                        device="cuda", dtype=torch.int32),
                 "state": torch.randint(0, 3, (c, n), generator=gen,
                                        device="cuda", dtype=torch.int32)},
                torch.rand((c, n), generator=gen, device="cuda") < 0.7)

    (ai, vi), (aj, vj) = side(k), side(nk)
    errs = {}
    for box in (None, (6.0, 6.0, 6.0)):
        for law in SLAB_LAWS:
            pair_fn, _, params = LAW_ARGS[law]
            got = ops.neighborhood_pair_sweep(
                ai, aj, vi, vj, pair_fn=pair_fn, radius=2.0, params=params,
                box=box)
            want = ni.pair_sweep_plain(ai, aj, vi, vj, pair_fn=pair_fn,
                                       radius=2.0, params=params, box=box)
            tag = "toroidal" if box else "closed"
            errs[f"{law}@d3 {tag}"] = compare(got, want,
                                              f"slabs d3 {tag} {law}")
    return errs


def phase_slabs(seed: int):
    """Phase 20: ``ops.neighborhood_pair_sweep`` (the gathered-slab
    kernel) on slabs gathered from the main path's SoA after one step,
    interior rows ``SLAB_ROWS`` (the SoA carries no SIR state: a state
    0-2 a slot is drawn from the seed), each law once through the entry
    point (one launch), then against its plain version, timed; and every
    law on random D = 3 slabs."""
    t_phase = time.perf_counter()
    sim = make_sim(cc.behavior(), interior=MAIN_INTERIOR, cap=MAIN_CAP,
                   device="cuda")
    cc.init(sim, 4 * math.prod(MAIN_INTERIOR), seed=seed)
    sim.run(1)
    soa = aura_block(sim)
    del sim
    gen = torch.Generator(device="cuda").manual_seed(seed)
    attrs = dict(soa.attrs, state=torch.randint(
        0, 3, soa.valid.shape, generator=gen, device="cuda",
        dtype=torch.int32))
    ai, aj, vi, vj = ni.neighborhood_slabs(
        attrs, soa.valid, ("diameter", "ctype", "state"), rows=SLAB_ROWS)
    slabs = ({n: a.contiguous() for n, a in ai.items()},
             {n: a.contiguous() for n, a in aj.items()},
             vi.contiguous(), vj.contiguous())
    del soa, attrs, ai, aj, vi, vj
    gc.collect()
    torch.cuda.empty_cache()
    vi, vj = slabs[2], slabs[3]
    c, k = vi.shape
    nk = vj.shape[1]
    valid_pairs = int((vi.sum(1, dtype=torch.int64)
                       * vj.sum(1, dtype=torch.int64)).sum()) \
        - int(vi.sum())              # each self pair
    print(f"[slabs] interior rows {SLAB_ROWS} of the main path's SoA: "
          f"{c} cells, K {k}, NK {nk}, {int(vi.sum())} agents", flush=True)
    rows, in_radius = {}, None
    for law in SLAB_LAWS:
        reset_all_launches()
        got = slab_call(slabs, law)                 # the entry point
        torch.cuda.synchronize()
        launches = all_launches()
        want_l = {n: 0 for n in launches}
        want_l["neighborhood_pair_sweep"] = 1
        if launches != want_l:
            fail(f"slabs {law}: launches {launches} != {want_l}")
        want = {}
        plain_ms = cuda_ms(lambda: want.update(slab_plain_chunked(
            slabs, law)), 1, warmup=False)
        err = compare(got, want, f"slabs {law}")
        if law == "same_type":       # the pairs within the radius
            in_radius = int(want["cnt"].sum(dtype=torch.float64))
        del got, want
        ms = cuda_ms(lambda: slab_call(slabs, law), 5)
        rows[law] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    for law, r in rows.items():
        b_ms, b_by, nbytes, nops = slab_bound(slabs, law, valid_pairs,
                                              in_radius)
        r.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=nops,
                 library_ms=None)
        print(f"[slabs] {law}: max_abs_err={r['max_abs_err']:.3g} "
              f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}; {nbytes} B, {nops} ops)",
              flush=True)
    del slabs
    gc.collect()
    torch.cuda.empty_cache()
    small = slab_small_3d(seed)
    print(f"[slabs] D = 3 random slabs, every law closed and toroidal: "
          f"max_abs_err {max(small.values()):.3g}; phase 20 "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    return dict(rows=rows, d3_errs=small, cells=c, k=k, nk=nk,
                valid_pairs=valid_pairs, in_radius_pairs=in_radius)


# ---------------------------------------------------------------------------
# Phase 21: the ABM examples on the card (examples_torch/)
# ---------------------------------------------------------------------------

def run_example(name: str, **kw):
    """``examples_torch/<name>.py``'s ``main(device="cuda", **kw)`` at the
    reference's sizes: its result, wall seconds and peak device bytes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = mod.main(device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[examples] {name} {kw or ''}: {wall:.2f} s wall, peak "
          f"{peak} B on the card", flush=True)
    return out, dict(wall_s=wall, peak_bytes=peak)


def phase_examples():
    """Phase 21: ``quickstart``, ``supervised_run --device-loss`` and
    ``serve_lm`` through their ``main``s at the reference's sizes (each
    raises on a failed assertion of its own)."""
    quick, q = run_example("quickstart")
    if quick["n_agents"] != 400 or quick["dropped"]:
        fail(f"quickstart: {quick}")
    sup, s = run_example("supervised_run", device_loss=True)
    if sup["n_devices"] != 2 or sup["n_agents"] != 400:
        fail(f"supervised_run --device-loss: {sup['n_devices']} devices, "
             f"{sup['n_agents']} agents")
    lm, lm_stats = run_example("serve_lm")
    if lm["cache_shape"] != (2, 4, 40, 24) or len(lm["tokens"]) != 4 or any(
            len(t) != 16 for t in lm["tokens"]):
        fail(f"serve_lm: cache {lm['cache_shape']}, tokens {lm['tokens']}")
    return {"quickstart": q, "supervised_run --device-loss": dict(
        s, recover_s=sup["recoveries"]), "serve_lm": lm_stats}


# ---------------------------------------------------------------------------
# Phase 22: the transformer-block families of the LM stack
# ---------------------------------------------------------------------------

# (config, layers run at full width): None is full depth.  The two MoE
# configs are cut to fit one 80 GB card, each cut printed with the sizes
# that force it (phase_families).
FAMILIES = (("minicpm-2b", None), ("minicpm3-4b", None),
            ("qwen3-moe-235b-a22b", 8), ("phi3.5-moe-42b-a6.6b", 16),
            ("llava-next-mistral-7b", None), ("hubert-xlarge", None))
# serving: 4 prompts of 480 tokens + 32 greedy tokens into a 512-slot
# cache (sdpa_chunked needs Skv a multiple of its 512-key chunk, and an
# MLA prefill attends over the whole cache); llava: its 1152 patches and
# 384 tokens, a 1568-slot cache
FAM_PROMPT, FAM_NEW, FAM_MAX = 480, 32, 512
VLM_PROMPT, VLM_MAX = 384, 1568
# the reference's prefill-vs-forward tolerance (tests/test_archs_smoke.py)
SERVE_ATOL, SERVE_RTOL = 0.06, 0.05
HUBERT_F32_LAYERS = 4   # the float32 cross-path check's depth


def family_batch(cfg, gen):
    """Scoring inputs of ``LM_BATCH`` x ``LM_SEQ`` positions: tokens, a
    vlm's patch embeddings before its tokens, or an encoder's frames, and
    the labels (a vlm's over its text span)."""
    b, s = LM_BATCH, LM_SEQ
    if cfg.family == "audio":
        return {"frames": _randn(gen, (b, s, cfg.frontend_dim),
                                 torch.bfloat16),
                "labels": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                        device="cuda", dtype=torch.int32)}
    tok = torch.randint(0, cfg.vocab, (b, s - cfg.n_patches + 1),
                        generator=gen, device="cuda", dtype=torch.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "vlm":
        batch["patches"] = _randn(gen, (b, cfg.n_patches, cfg.frontend_dim),
                                  torch.bfloat16)
    return batch


def attention_row(q, k, v, causal: bool):
    """The attention kernel on one recorded launch's inputs: its ms, the
    plain version's, SDPA's on the same heads, and the bound of the
    launch's true head dims (the pairs its mask keeps)."""
    import torch.nn.functional as F

    bh, sq, hd = q.shape
    skv, hdv = v.shape[1], v.shape[2]
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal), 10)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=causal), 3)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], is_causal=causal), 10)
    b_ms, b_by, nbytes, nops = attention_bound(bh, sq, skv, hd, hdv, causal,
                                               q.dtype)
    return dict(shape=[bh, sq, hd], causal=causal, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, ops=nops,
                kernel=fa.kernel_for(q.dtype, fa.built_head_dim(hd),
                                     fa.built_head_dim(hdv)))


def family_scoring(name, model, params, cfg, batch):
    """Scoring: a counted, timed ``loss_fn`` forward; the attention
    launches of the first and last layer against the plain version; the
    kernel at this shape; a MoE model's drops and determinism."""
    gqa = cfg.attention == "gqa"
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    lm_steps.loss_fn(model, params, batch, backend="kernel")    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    loss = lm_steps.loss_fn(model, params, batch, backend="kernel")
    end.record()
    end.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    fwd_ms = start.elapsed_time(end)
    loss = float(loss)
    expected = {n: 0 for n in launches}
    if gqa:
        expected["flash_attention_wgmma"] = cfg.n_layers
    if launches != expected:
        fail(f"{name} scoring: kernel launches {launches} != {expected}")
    if not math.isfinite(loss):
        fail(f"{name} scoring: loss {loss}")
    tokens = LM_BATCH * LM_SEQ
    row = dict(layers=cfg.n_layers, score_ms=fwd_ms,
               score_tokens_per_s=tokens / (fwd_ms / 1e3), loss=loss,
               score_peak_bytes=peak, score_launches=launches)
    print(f"[families] {name} scoring {LM_BATCH}x{LM_SEQ} ({cfg.n_layers} "
          f"layers): loss {loss:.6f} (ln vocab {math.log(cfg.vocab):.6f}); "
          f"{fwd_ms:.3f} ms a forward + loss (CUDA events), "
          f"{row['score_tokens_per_s']:.6g} tokens/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; attention "
          + (f"on the kernel, launches "
             f"{ {k: n for k, n in launches.items() if n} }" if gqa else
             "through sdpa_chunked (MLA runs no kernel, as in the "
             "reference); no kernel launch"), flush=True)
    times = profile(lambda: lm_steps.loss_fn(model, params, batch,
                                             backend="kernel"),
                    "families profile", f"{name}: one scoring forward + loss")
    if times:
        total = sum(times.values())
        attn = sum(us for k, us in times.items()
                   if "flash_wgmma_kernel" in k or "flash_attention_kernel"
                   in k)
        row["profile"] = dict(
            device_ms=total / 1e3, attention_share=attn / total,
            top={k[:90]: us / 1e3 for k, us in sorted(
                times.items(), key=lambda kv: -kv[1])[:5]})
        print(f"[families profile] {name}: attention kernel "
              f"{attn / 1e3:.3f} ms = {100 * attn / total:.1f}% of the "
              f"forward's {total / 1e3:.3f} ms of device time", flush=True)

    last = cfg.n_layers - 1
    with Capture(fa, ["flash_attention"], keep=(0, last)) as cap:
        logits = model.logits(params, inputs, backend="kernel")
    if gqa:
        calls = cap.calls["flash_attention"]
        if cap.seen["flash_attention"] != cfg.n_layers or len(calls) != 2:
            fail(f"{name}: {cap.seen['flash_attention']} attention calls in "
                 f"a forward, not {cfg.n_layers}")
        row["launch_vs_plain"] = max(
            _attn_err(got, fa.flash_attention_plain(*qkv, **kw),
                      f"{name} attention launch of layer {i}")
            for i, (qkv, kw, got) in zip((0, last), calls))
        (q, k, v), kw, _ = calls[0]
        del calls, cap
        row["kernel_row"] = attention_row(q, k, v, kw["causal"])
        r = row["kernel_row"]
        print(f"[families] {name} attention launches of layers 0 and {last} "
              f"vs the plain version on their inputs: max abs diff "
              f"{row['launch_vs_plain']:.4g} (one bf16 ulp + "
              f"{ATTN_BF16_ATOL}); {r['kernel']} at {tuple(r['shape'])} "
              f"{'causal' if r['causal'] else 'full'}: kernel_ms="
              f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms="
              f"{r['library_ms']:.4f} (scaled_dot_product_attention) "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}; {r['bytes']} "
              f"B, {r['ops']} ops)", flush=True)
        del q, k, v
    elif cap.seen["flash_attention"]:
        fail(f"{name}: MLA called the attention kernel")
    v = cfg.vocab
    finite = bool(torch.isfinite(logits[..., :v]).all())
    masked = (float(logits[..., v:].float().max())
              if cfg.padded_vocab > v else -math.inf)
    if logits.shape != (LM_BATCH, LM_SEQ, cfg.padded_vocab) or not finite \
            or masked > -1e29:
        fail(f"{name} scoring: logits {tuple(logits.shape)}, finite "
             f"{finite}, padded columns up to {masked}")

    if cfg.moe is not None:
        shares = []
        apply = moe_mod.moe_apply

        def recorded(p, c, x):
            shares.append(moe_mod.dropped_share(p, c, x))
            return apply(p, c, x)

        moe_mod.moe_apply = recorded
        try:
            again = model.logits(params, inputs, backend="kernel")
        finally:
            moe_mod.moe_apply = apply
        if not torch.equal(again, logits):
            fail(f"{name}: two forwards differ (max "
                 f"{float((again.float() - logits.float()).abs().max())}): "
                 "the MoE combine must be deterministic")
        c = moe_mod.capacity(cfg, LM_SEQ)
        row["moe"] = dict(capacity=c, dropped_share_by_layer=shares)
        print(f"[families] {name}: capacity C = {c} of {LM_SEQ} tokens a "
              f"group ({cfg.moe.n_experts} experts, top {cfg.moe.top_k}, "
              f"factor {cfg.moe.capacity_factor}); (token, expert) "
              f"assignments dropped by capacity, by layer: "
              f"{[round(x, 6) for x in shares]} (mean "
              f"{sum(shares) / len(shares):.6f}); two forwards' logits "
              "bit-equal", flush=True)
        del again
    del logits
    return row


def hubert_f32(params, cfg, frames):
    """hubert's first ``HUBERT_F32_LAYERS`` layers on float32 copies of
    the weights: the ``"kernel"`` backend (the float32 kernel, non-causal,
    head dim 80 zero-padded to 128) against ``"chunked"``."""
    n = HUBERT_F32_LAYERS
    model = build_model(dataclasses.replace(cfg, n_layers=n))
    p32 = {k: P.tree_map((lambda a: a[:n].float()) if k == "blocks"
                         else (lambda a: a.float()), sub)
           for k, sub in params.items()}
    x = {"frames": frames.float()}
    reset_all_launches()
    kern = model.logits(p32, x, backend="kernel")
    torch.cuda.synchronize()
    launches = all_launches()
    expected = {k: 0 for k in launches}
    expected["flash_attention"] = n
    if launches != expected:
        fail(f"hubert float32: kernel launches {launches} != {expected}")
    err = _lm_close(kern, model.logits(p32, x, backend="chunked"),
                    "hubert float32: kernel vs chunked", LM_F32_TOL,
                    LM_F32_TOL, cfg.vocab)
    print(f"[families] hubert-xlarge float32, {n} layers: logits kernel vs "
          f"chunked backend max abs diff {err:.4g} (limit {LM_F32_TOL} abs "
          f"and rel); launches { {k: v for k, v in launches.items() if v} }",
          flush=True)
    return dict(layers=n, kernel_vs_chunked=err, launches=launches)


def family_serving(name, model, params, cfg, batch):
    """Greedy serving: a prompt's prefill into the cache, ``FAM_NEW``
    decode steps; the prefill's last logits against a chunked forward over
    the prompt (the reference's tolerance)."""
    vlm = cfg.family == "vlm"
    n_tok, max_len = (VLM_PROMPT, VLM_MAX) if vlm else (FAM_PROMPT, FAM_MAX)
    prompt = {"tokens": batch["tokens"][:, :n_tok]}
    if vlm:
        prompt["patches"] = batch["patches"]
    pos0 = n_tok + cfg.n_patches
    if pos0 + FAM_NEW != max_len:
        fail(f"{name} serving: {pos0} + {FAM_NEW} positions, cache {max_len}")
    cache = model.init_cache(LM_BATCH, max_len, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    rows, gen_tok, prefill_ms, decode_ms = serve_batch(
        model, params, prompt, cache, pos0, FAM_NEW)
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        fail(f"{name} serving: launched {launches}; prefill and decode run "
             "the plain attention paths")
    v = cfg.vocab
    if not bool(torch.isfinite(rows[..., :v]).all()):
        fail(f"{name} serving: logits not finite")
    decode = lm_steps.make_serve_decode_step(model)
    times = profile(lambda: decode(params, cache, gen_tok[:, -1:],
                                   max_len - 1),
                    "families profile",
                    f"{name}: one more decode step (the last again)")
    device_ms = sum(times.values()) / 1e3 if times else None
    fwd = model.logits(params, prompt, backend="chunked")[:, -1:]
    err = _lm_close(rows[:, :1], fwd, f"{name} serving: prefill vs chunked "
                    "forward (bf16)", SERVE_ATOL, SERVE_RTOL, v)
    del fwd
    out = dict(prefill_ms=prefill_ms, decode_step_ms=decode_ms,
               decode_tokens_per_s=LM_BATCH / (decode_ms / 1e3),
               serve_peak_bytes=peak, prefill_vs_forward=err, cache=max_len,
               decode_step_device_ms=device_ms)
    if device_ms is not None:
        print(f"[families profile] {name}: a decode step {device_ms:.3f} ms "
              f"of device kernels in {decode_ms:.3f} ms: the card idles "
              f"{100 * (1 - device_ms / decode_ms):.1f}% of it", flush=True)
    note = ""
    if not vlm:   # the 512 served positions tile sdpa_chunked's chunk
        seq = torch.cat([prompt["tokens"], gen_tok], dim=1)
        fwd = model.logits(params, {"tokens": seq},
                           backend="chunked")[:, pos0 - 1:]
        out["decode_vs_forward"] = float(
            (rows[..., :v].float() - fwd[..., :v].float()).abs().max())
        out["greedy_agrees"] = float(
            (rows[:, :-1, :v].argmax(-1) == fwd[:, :-1, :v].argmax(-1))
            .float().mean())
        note = (f"; reported: max |serving - chunked forward over the "
                f"{max_len} tokens| {out['decode_vs_forward']:.4g}, greedy "
                f"tokens equal to the forward's argmax "
                f"{100 * out['greedy_agrees']:.1f}%")
        del fwd
    print(f"[families] {name} serving {LM_BATCH} x {pos0}-position prompts, "
          f"{FAM_NEW} greedy tokens, cache {max_len}: prefill "
          f"{prefill_ms:.3f} ms, {decode_ms:.3f} ms a decode step, "
          f"{out['decode_tokens_per_s']:.6g} decode tokens/s; peak device "
          f"memory {peak / 2**30:.2f} GiB; prefill's last logits vs a chunked "
          f"forward over the prompt: max abs diff {err:.4g} (limit "
          f"{SERVE_ATOL} abs, {SERVE_RTOL} rel){note}", flush=True)
    return out


def family_run(name: str, layers, seed: int, card: str):
    full = get_config(name).full
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    model = build_model(cfg)
    per_layer = P.count_params(build_model(dataclasses.replace(
        full, n_layers=1)).spec["blocks"])
    n_params = P.count_params(model.spec)
    rest = n_params - cfg.n_layers * per_layer
    cut = None
    if layers is not None:
        cut = (f"{layers} of {full.n_layers} layers: one layer holds "
               f"{per_layer:.4g} parameters ({2 * per_layer / 1e9:.2f} GB in "
               f"bf16) and the embedding, head and norms {rest:.4g} "
               f"({2 * rest / 1e9:.2f} GB); all {full.n_layers} layers would "
               f"need {2 * (full.n_layers * per_layer + rest) / 1e9:.1f} GB "
               f"of the card's 80, {layers} need "
               f"{2 * n_params / 1e9:.1f} GB and leave the rest to scoring's "
               f"activations and logits")
        print(f"[families] {name}: depth cut to {cut}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model.load_params(P.init(model.spec, gen, device="cuda"))
    params = model.params
    torch.cuda.synchronize()
    print(f"[families] {name} ({cfg.family}, {cfg.attention}): "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"({cfg.n_kv_heads} KV) of {cfg.hd}, vocab {cfg.padded_vocab}; "
          f"{n_params} parameters in bf16 from params.init: "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    batch = family_batch(cfg, gen)
    with torch.no_grad():
        row = family_scoring(name, model, params, cfg, batch)
        row.update(depth_cut=cut, card=card, parameters=n_params)
        if cfg.family == "audio":
            row["f32"] = hubert_f32(params, cfg, batch["frames"])
        else:
            row.update(family_serving(name, model, params, cfg, batch))
    print(f"[families] {name} on {card}: scoring {row['score_ms']:.3f} ms, "
          f"{row['score_tokens_per_s']:.6g} tokens/s, peak "
          f"{row['score_peak_bytes'] / 2**30:.2f} GiB; "
          + (f"prefill {row['prefill_ms']:.3f} ms, decode "
             f"{row['decode_step_ms']:.3f} ms a step, peak "
             f"{row['serve_peak_bytes'] / 2**30:.2f} GiB; "
             if "prefill_ms" in row else "no serving (an encoder); ")
          + f"depth {cfg.n_layers} of {full.n_layers}", flush=True)
    return row


def phase_families(seed: int):
    """Phase 22: minicpm-2b, minicpm3-4b (MLA), qwen3-moe and phi3.5-moe
    (MoE), llava (vlm) and hubert (audio) at full width, scoring and
    (but hubert) serving."""
    t0 = time.perf_counter()
    card = card_line()
    out = {}
    for name, layers in FAMILIES:
        out[name] = family_run(name, layers, seed, card)
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"[families] phase 22: {out['seconds']:.1f}s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 23: the ssm and hybrid families of the LM stack
# ---------------------------------------------------------------------------

SSM_PARAMS = {"zamba2-1.2b": 1_167_979_840, "xlstm-1.3b": 1_996_185_936}
# serving: 4 prompts of 512 tokens + 32 greedy tokens (the chunked scans
# assert S a multiple of min(chunk, S); 512 is one of both chunks, 256);
# zamba2's KV cache holds the 544 positions
SSM_PROMPT, SSM_NEW = 512, 32
# the decode check's forward: the prompt, the generated tokens and the
# last of them repeated, to whole chunks of the scans (256) and of
# sdpa_chunked (512 keys); causal: a position sees none of the padding
SSM_FWD = 1024
# the cross-device check on float32 weights: a group and a tail block of
# zamba2, one segment of xLSTM; 1 x 512 tokens
SSM_CHECK_LAYERS = {"zamba2-1.2b": 7, "xlstm-1.3b": 8}
SSM_CHECK_SEQ = 512
# an mLSTM block rounds its chunk products' operands and its chunk outputs
# to bf16 (the reference's design, on float32 weights too): a one-ulp flip
# there is 2^-8 of that value, so the card and the CPU are held to the
# bf16 tolerance of the parity tests there, and to LM_F32_TOL elsewhere
SSM_MLSTM_TOL = 2e-2
# steps at which the sLSTM loop's float32 run is held against float64
SSM_CHAOS_STEPS = (1, 8, 16, 32, 64, 128, 512)
# the functions timed as spans of a scoring forward: (module, name, label)
SSM_SPANS = ((m2_mod, "_ssd_chunk", "ssd chunk scan"),
             (xl_mod, "_mlstm_chunk", "mlstm chunk scan"),
             (xl_mod, "_slstm_scan", "slstm time loop"))


class Spans:
    """While active, wraps module functions: each call's host seconds and
    its span on the card's timeline (CUDA events recorded before and after
    it; one stream runs in order, so the spans do not overlap).  The two
    event records add ~2 us of host time a call."""

    def __init__(self, spans):
        self.spans = spans
        self.events = {label: [] for _, _, label in spans}
        self.host_s = {label: 0.0 for _, _, label in spans}
        self._orig = []

    def __enter__(self):
        for mod, name, label in self.spans:
            fn = getattr(mod, name)
            self._orig.append((mod, name, fn))

            def timed(*args, _fn=fn, _label=label, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                out = _fn(*args, **kw)
                end.record()
                self.host_s[_label] += time.perf_counter() - t0
                self.events[_label].append((start, end))
                return out

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)
        return False

    def ms(self):
        torch.cuda.synchronize()
        return {label: sum(s.elapsed_time(e) for s, e in ev)
                for label, ev in self.events.items()}


def ssm_scoring(name, model, params, cfg, batch):
    """Scoring: after a warm-up forward over the serving prompts' size,
    one logits forward with the spans of the scans and the sLSTM loop,
    zamba2's first and last shared-attention launches recorded: its logits
    checked, the recorded launches against the plain version and the
    kernel at that shape; then, nothing else held, a counted, timed
    ``loss_fn`` forward (its peak memory); zamba2's kernel profile."""
    hybrid = cfg.family == "hybrid"
    n_attn = cfg.n_layers // cfg.shared_attn_every if hybrid else 0
    row = dict(layers=cfg.n_layers)
    model.logits(params, {"tokens": batch["tokens"][:, :SSM_PROMPT]},
                 backend="kernel")                           # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    with Spans(SSM_SPANS) as sp, \
            Capture(fa, ["flash_attention"], keep=(0, n_attn - 1)) as cap:
        logits = model.logits(params, {"tokens": batch["tokens"]},
                              backend="kernel")
    end.record()
    spans = sp.ms()
    span_fwd = start.elapsed_time(end)
    row["spans"] = {label: dict(ms=ms, share=ms / span_fwd,
                                host_s=sp.host_s[label],
                                calls=len(sp.events[label]))
                    for label, ms in spans.items() if sp.events[label]}
    row["spans_forward_ms"] = span_fwd
    print(f"[ssm] {name} spans of a logits forward ({span_fwd:.3f} ms with "
          "the spans' events): " + "; ".join(
              f"{label} {r['ms']:.3f} ms = {100 * r['share']:.1f}% "
              f"({r['calls']} calls, {r['host_s']:.3f} s of host time)"
              for label, r in row["spans"].items()), flush=True)
    v = cfg.vocab
    finite = bool(torch.isfinite(logits[..., :v]).all())
    masked = (float(logits[..., v:].float().max())
              if cfg.padded_vocab > v else -math.inf)
    if logits.shape != (LM_BATCH, LM_SEQ, cfg.padded_vocab) or not finite \
            or masked > -1e29:
        fail(f"{name} scoring: logits {tuple(logits.shape)}, finite "
             f"{finite}, padded columns up to {masked}")
    print(f"[ssm] {name}: logits finite over {LM_BATCH}x{LM_SEQ}x{v}"
          + (f" at chunk {cfg.ssm.chunk} (ROADMAP §C 11's gate)" if hybrid
             else "") + (f"; padded columns {v}..{cfg.padded_vocab - 1} "
                         f"masked (max {masked:.3g})"
                         if cfg.padded_vocab > v else "; no padded column"),
          flush=True)
    del logits
    if hybrid:
        calls = cap.calls["flash_attention"]
        if cap.seen["flash_attention"] != n_attn or len(calls) != 2:
            fail(f"{name}: {cap.seen['flash_attention']} attention calls in "
                 f"a forward, not {n_attn}")
        row["launch_vs_plain"] = max(
            _attn_err(got, fa.flash_attention_plain(*qkv, **kw),
                      f"{name} shared-attention launch {i}")
            for i, (qkv, kw, got) in zip((0, n_attn - 1), calls))
        (q, k, v_), kw, _ = calls[0]
        row["kernel_row"] = attention_row(q, k, v_, kw["causal"])
        del calls, q, k, v_
        r = row["kernel_row"]
        print(f"[ssm] {name} shared-attention launches 0 and {n_attn - 1} "
              f"vs the plain version on their inputs: max abs diff "
              f"{row['launch_vs_plain']:.4g} (one bf16 ulp + "
              f"{ATTN_BF16_ATOL}); {r['kernel']} at {tuple(r['shape'])} "
              f"{'causal' if r['causal'] else 'full'}: kernel_ms="
              f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms="
              f"{r['library_ms']:.4f} (scaled_dot_product_attention) "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}; {r['bytes']} "
              f"B, {r['ops']} ops)", flush=True)
    elif cap.seen["flash_attention"]:
        fail(f"{name}: xLSTM called the attention kernel")
    del cap

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    start.record()
    loss = lm_steps.loss_fn(model, params, batch, backend="kernel")
    end.record()
    end.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    fwd_ms = start.elapsed_time(end)
    loss = float(loss)
    expected = {n: 0 for n in launches}
    if hybrid:
        expected["flash_attention_wgmma"] = n_attn
    if launches != expected:
        fail(f"{name} scoring: kernel launches {launches} != {expected}")
    if not math.isfinite(loss):
        fail(f"{name} scoring: loss {loss}")
    tokens = LM_BATCH * LM_SEQ
    row.update(score_ms=fwd_ms, score_tokens_per_s=tokens / (fwd_ms / 1e3),
               loss=loss, score_peak_bytes=peak, score_launches=launches)
    print(f"[ssm] {name} scoring {LM_BATCH}x{LM_SEQ} ({cfg.n_layers} "
          f"layers): loss {loss:.6f} (ln vocab {math.log(cfg.vocab):.6f}); "
          f"{fwd_ms:.3f} ms a forward + loss (CUDA events), "
          f"{row['score_tokens_per_s']:.6g} tokens/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches "
          f"{ {k: n for k, n in launches.items() if n} }", flush=True)
    if hybrid:
        times = profile(lambda: lm_steps.loss_fn(model, params, batch,
                                                 backend="kernel"),
                        "ssm profile", f"{name}: one scoring forward + loss")
        if times:
            total = sum(times.values())
            attn = sum(us for k, us in times.items()
                       if "flash_wgmma_kernel" in k)
            row["profile"] = dict(
                device_ms=total / 1e3, attention_share=attn / total,
                top={k[:90]: us / 1e3 for k, us in sorted(
                    times.items(), key=lambda kv: -kv[1])[:5]})
            print(f"[ssm profile] {name}: attention kernel {attn / 1e3:.3f} "
                  f"ms = {100 * attn / total:.1f}% of the forward's "
                  f"{total / 1e3:.3f} ms of device time", flush=True)
    return row


def _fit(spec, tree):
    """The leading layers of a full-depth parameter tree that a shallower
    spec holds, as float32 copies."""
    if isinstance(spec, dict):
        return {k: _fit(sub, tree[k]) for k, sub in spec.items()}
    a = tree if tuple(tree.shape) == spec.shape else tree[:spec.shape[0]]
    if tuple(a.shape) != spec.shape:
        fail(f"cross-device check: {tuple(tree.shape)} does not fit "
             f"{spec.shape}")
    return a.float()


def slstm_sensitivity(cfg, params, u):
    """The sLSTM recurrence's own amplification of rounding: the first
    block's loop on the card in float32 and in float64 from the same
    float32 inputs ``u`` (B, S, d); max |h| difference at some steps."""
    blk = model_mod._layers_of(params["slstm"], 1)(0)
    r32, r64 = blk["r_gates"].float(), blk["r_gates"].double()
    gx = torch.einsum("bsd,dg->bsg", u.float(),
                      blk["w_gates"].float()) + blk["b_gates"]
    st32 = xl_mod.slstm_init_state(cfg, u.shape[0], u.device)
    st64 = xl_mod.SLSTMState(*(a.double() for a in st32))
    out = {}
    for t in range(u.shape[1]):
        st32 = xl_mod._slstm_step(st32, gx[:, t], r32)
        st64 = xl_mod._slstm_step(st64, gx[:, t].double(), r64)
        if t + 1 in SSM_CHAOS_STEPS:
            out[t + 1] = float((st32.h.double() - st64.h).abs().max())
    return out


def xlstm_blocks_card_vs_cpu(cfg, p_card, p_cpu, tok):
    """Every block of a one-segment xLSTM on the card against the same
    block on the CPU from the CPU's input to it: the mLSTM blocks over the
    whole sequence, the sLSTM block one token at a time from the CPU's
    state (its recurrence amplifies a rounding difference ~10x a step, so
    over the sequence two correct runs part; step by step each is held),
    then the head.  Returns the largest error of each."""
    norm = NORM_FNS[cfg.norm]
    n_seg, per = model_mod._segments(cfg)
    if n_seg != 1:
        fail(f"the block check takes one segment, not {n_seg}")
    errs = {}

    def lay(tree, *idx):
        return model_mod._layers_of(tree, len(idx))(*idx)

    def err(got, want, label, tol=LM_F32_TOL):
        return _lm_close(got.cpu(), want, label, tol, tol, got.shape[-1])

    x = model_mod._embed_inputs(p_cpu, cfg, {"tokens": tok})
    for j in range(per):
        u = norm(lay(p_cpu["ln_m"], 0, j), x)
        want, _ = xl_mod.mlstm_apply(lay(p_cpu["mlstm"], 0, j), cfg, u)
        got, _ = xl_mod.mlstm_apply(lay(p_card["mlstm"], 0, j), cfg,
                                    u.cuda())
        errs[f"mlstm {j}"] = err(got, want, f"xlstm mLSTM block {j}: card "
                                 "vs CPU", SSM_MLSTM_TOL)
        x = x + want
    u = norm(lay(p_cpu["ln_s"], 0), x)
    blk_c, blk_g = lay(p_cpu["slstm"], 0), lay(p_card["slstm"], 0)
    st = xl_mod.slstm_init_state(cfg, u.shape[0], "cpu")
    outs, e_out, e_h = [], 0.0, 0.0
    for t in range(u.shape[1]):
        want, st_next = xl_mod.slstm_apply(blk_c, cfg, u[:, t:t + 1], st)
        got, st_g = xl_mod.slstm_apply(
            blk_g, cfg, u[:, t:t + 1].cuda(),
            xl_mod.SLSTMState(*(a.cuda() for a in st)))
        e_out = max(e_out, err(got, want, f"xlstm sLSTM step {t}: card vs "
                               "CPU"))
        e_h = max(e_h, err(st_g.h, st_next.h, f"xlstm sLSTM state at step "
                           f"{t}: card vs CPU"))
        outs.append(want)
        st = st_next
    errs["slstm steps"], errs["slstm states"] = e_out, e_h
    x = x + torch.cat(outs, dim=1)
    want = model_mod._head(p_cpu, cfg, x)
    got = model_mod._head(p_card, cfg, x.cuda())
    errs["head"] = _lm_close(got.cpu(), want, "xlstm head: card vs CPU",
                             LM_F32_TOL, LM_F32_TOL, cfg.vocab)
    return errs


def ssm_cross_device(name, cfg, params, tokens):
    """A short model on float32 copies of the weights, the card against
    the port's own run on the CPU.  zamba2 (backend ``"kernel"``: its
    group runs the float32 attention kernel once): the logits, to
    LM_F32_TOL.  xLSTM: every block from the CPU's input to it
    (:func:`xlstm_blocks_card_vs_cpu`; the mLSTM blocks to SSM_MLSTM_TOL,
    the rest to LM_F32_TOL); the whole model's
    logits are reported with the first position where they part by more,
    beside the recurrence's own float32-vs-float64 divergence on the
    card."""
    n = SSM_CHECK_LAYERS[name]
    model = build_model(dataclasses.replace(cfg, n_layers=n))
    p32 = _fit(model.spec, params)
    p_cpu = P.tree_map(lambda a: a.cpu(), p32)
    tok = tokens[:1, :SSM_CHECK_SEQ]
    reset_all_launches()
    card = model.logits(p32, {"tokens": tok}, backend="kernel")
    torch.cuda.synchronize()
    launches = all_launches()
    expected = {k: 0 for k in launches}
    if cfg.family == "hybrid":
        expected["flash_attention"] = n // cfg.shared_attn_every
    if launches != expected:
        fail(f"{name} cross-device: kernel launches {launches} != "
             f"{expected}")
    t0 = time.perf_counter()
    cpu = model.logits(p_cpu, {"tokens": tok.cpu()}, backend="kernel")
    cpu_s = time.perf_counter() - t0
    v = cfg.vocab
    row = dict(layers=n, launches=launches, cpu_s=cpu_s)
    if cfg.family == "hybrid":
        row["card_vs_cpu"] = _lm_close(
            card.cpu(), cpu, f"{name} float32, {n} layers: card vs CPU",
            LM_F32_TOL, LM_F32_TOL, v)
        what = (f"max abs diff {row['card_vs_cpu']:.4g} (limit "
                f"{LM_F32_TOL} abs and rel)")
    else:
        g, w = card.cpu()[0, :, :v], cpu[0, :, :v]
        over = ((g - w).abs() > LM_F32_TOL * (1 + w.abs())).any(
            dim=-1).nonzero()
        row["logits_max_diff"] = float((g - w).abs().max())
        row["first_position_apart"] = int(over[0]) if len(over) else None
        x = model_mod._embed_inputs(p32, model.cfg, {"tokens": tok})
        ln_s = model_mod._layers_of(p32["ln_s"], 1)(0)
        u = NORM_FNS[cfg.norm](ln_s, x)
        row["slstm_f32_vs_f64"] = slstm_sensitivity(model.cfg, p32, u)
        row["blocks"] = xlstm_blocks_card_vs_cpu(model.cfg, p32, p_cpu,
                                                 tok.cpu())
        row["card_vs_cpu"] = max(row["blocks"].values())
        blocks = ", ".join(f"{k} {e:.3g}" for k, e in row["blocks"].items())
        what = (f"every block from the CPU's input to it: {blocks} (limit "
                f"{SSM_MLSTM_TOL} for the mLSTM blocks, {LM_F32_TOL} the "
                "rest, abs and rel); "
                f"reported: the whole model's logits part beyond "
                f"{LM_F32_TOL} from position {row['first_position_apart']} "
                f"(max {row['logits_max_diff']:.4g}); the sLSTM loop alone, "
                f"float32 vs float64 on the card, max |h| diff after "
                + ", ".join(f"{t} steps {e:.3g}"
                            for t, e in row["slstm_f32_vs_f64"].items()))
    print(f"[ssm] {name} float32, {n} layers, 1 x {SSM_CHECK_SEQ} tokens, "
          f"the card vs the port on the CPU ({cpu_s:.2f} s there): {what}; "
          "launches "
          f"{ {k: c for k, c in launches.items() if c} }", flush=True)
    del card, cpu, p32, p_cpu
    return row


def _cache_as(cache, dtype):
    """A copy of a serving cache (dicts, tuples and NamedTuples of tensors)
    with every floating leaf in ``dtype``."""
    if isinstance(cache, dict):
        return {k: _cache_as(v, dtype) for k, v in cache.items()}
    if isinstance(cache, tuple):
        leaves = [_cache_as(v, dtype) for v in cache]
        return type(cache)(*leaves) if hasattr(cache, "_fields") else tuple(
            leaves)
    return cache.to(dtype) if cache.is_floating_point() else cache


def serve_forced(model, params, prompt, cache, pos0: int, tokens):
    """Prefill ``prompt``, then decode the given ``tokens`` (B, n) one at a
    time; the logits of the prefill's last position and of every step, and
    the cache the prefill returned."""
    decode = lm_steps.make_serve_decode_step(model)
    logits, cache = lm_steps.make_prefill_step(model)(params, prompt, cache)
    prefilled = cache
    rows = [logits[:, -1]]
    for t in range(tokens.shape[1]):
        logits, cache = decode(params, cache, tokens[:, t:t + 1], pos0 + t)
        rows.append(logits[:, -1])
    return torch.stack(rows, dim=1), prefilled


def xlstm_continued(model, params, cache, tokens):
    """The logits of ``tokens[:, :1]`` on the chunked path continued from
    an xLSTM prefill's ``cache`` (the states carried into a chunk, as
    between the chunks of one forward) over ``tokens`` (B, 2): what a
    forward over the prompt and that token computes, the prompt's part
    taken from the same prefill."""
    cfg = model.cfg
    x = model_mod._embed_inputs(params, cfg, {"tokens": tokens})
    x, _ = model_mod._run_ssm(params, cfg, x, cache)
    return model_mod._head(params, cfg, x[:, :1])


def ssm_serving(name, model, params, cfg, batch):
    """Greedy serving of ``SSM_PROMPT``-token prompts and ``SSM_NEW``
    decode steps, timed and counted in bf16; then the same serving on
    float32 weights and cache, decoding the bf16 run's tokens.  Gated: the
    bf16 prefill's last logits against a chunked forward over the prompt
    (the same work; 0.06 abs, 0.05 rel).  zamba2, against forwards over
    the prompt and the tokens, as phase 10: the float32 first decode step
    within 0.06 / 0.05 and every float32 step within LM_F32_TOL; every
    bf16 step's distance from the float32 forward at most LM_BF16_MARGIN
    times the bf16 forward's.  xLSTM: its sLSTM recurrence amplifies a
    rounding difference ~10x a step, so a prefill and a forward, whose
    products have other shapes and round apart, reach position 512 in
    different states; the first decode step is held against the chunked
    path continued from the same prefill: float32 within 0.06 / 0.05 (the
    chunked mLSTM rounds its products' operands and its outputs to bf16,
    its one-token recurrence does not); bf16, its distance from the
    float32 step from that state at most LM_BF16_MARGIN times the bf16
    chunked path's.  The distances from the forward are reported.  The bf16
    first step's distance from the bf16 forward is reported: bf16 paths
    drift apart with depth."""
    hybrid = cfg.family == "hybrid"
    prompt = {"tokens": batch["tokens"][:, :SSM_PROMPT]}
    max_len = SSM_PROMPT + SSM_NEW
    cache = model.init_cache(LM_BATCH, max_len, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    rows, gen_tok, prefill_ms, decode_ms = serve_batch(
        model, params, prompt, cache, SSM_PROMPT, SSM_NEW)
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        fail(f"{name} serving: launched {launches}; prefill and decode run "
             "the plain paths")
    v = cfg.vocab
    if not bool(torch.isfinite(rows[..., :v]).all()):
        fail(f"{name} serving: logits not finite")
    decode = lm_steps.make_serve_decode_step(model)
    # the same work as a served step (the initial cache's states)
    times = profile(lambda: decode(params, cache, gen_tok[:, -1:],
                                   max_len - 1),
                    "ssm profile", f"{name}: one more decode step")
    device_ms = sum(times.values()) / 1e3 if times else None
    del cache
    fwd = model.logits(params, prompt, backend="chunked")[:, -1:]
    err = _lm_close(rows[:, :1], fwd, f"{name} serving: prefill vs chunked "
                    "forward (bf16)", SERVE_ATOL, SERVE_RTOL, v)
    seq = {"tokens": torch.cat([prompt["tokens"], gen_tok, gen_tok[:, -1:]
                                .expand(LM_BATCH, SSM_FWD - max_len)], 1)}
    fwd = model.logits(params, seq, backend="chunked")[
        :, SSM_PROMPT - 1:max_len]
    first_bf16 = float((rows[:, 1, :v].float() - fwd[:, 1, :v].float()
                        ).abs().max())
    all_bf16 = float((rows[..., :v].float() - fwd[..., :v].float()
                      ).abs().max())
    agree = float((rows[:, :-1, :v].argmax(-1) == fwd[:, :-1, :v].argmax(-1))
                  .float().mean())
    # float32 weights and cache, decoding the same tokens
    p32 = P.tree_map(lambda a: a.float(), params)
    ref = model.logits(p32, seq, backend="chunked")[:, SSM_PROMPT - 1:max_len]
    ratio, _, _ = _bf16_ratio(rows, fwd, ref, v)
    del fwd
    cache32 = _cache_as(model.init_cache(LM_BATCH, max_len, device="cuda"),
                        torch.float32)
    rows32, cache32 = serve_forced(model, p32, prompt, cache32, SSM_PROMPT,
                                   gen_tok)
    d32 = (rows32[..., :v] - ref[..., :v]).abs().amax(dim=-1).amax(dim=0)
    all32, first32 = float(d32.max()), float(d32[1])
    cont = {}
    if hybrid:
        _lm_close(rows32[:, 1:2], ref[:, 1:2], f"{name} serving: first "
                  "decode step vs forward (float32)", SERVE_ATOL, SERVE_RTOL,
                  v)
        _lm_close(rows32, ref, f"{name} serving vs forward (float32)",
                  LM_F32_TOL, LM_F32_TOL, v)
        if not ratio <= LM_BF16_MARGIN:
            fail(f"{name} serving: bf16 logits up to {ratio} x the chunked "
                 "forward's distance from the float32 forward")
    else:
        # the first decode step against the chunked path continued from
        # the same prefill, float32 and bf16
        two = seq["tokens"][:, SSM_PROMPT:SSM_PROMPT + 2]
        cont["f32"] = _lm_close(
            rows32[:, 1:2], xlstm_continued(model, p32, cache32, two),
            f"{name} serving: first decode step vs the chunked path from "
            "the prefill (float32)", SERVE_ATOL, SERVE_RTOL, v)
        # bf16, as phase 10: the decode step's distance from the float32
        # step from the same (bf16 prefill's) state, against the bf16
        # chunked path's
        _, cache16 = lm_steps.make_prefill_step(model)(
            params, prompt, model.init_cache(LM_BATCH, max_len,
                                             device="cuda"))
        cont16 = xlstm_continued(model, params, cache16, two)
        ref1 = xlstm_continued(model, p32, _cache_as(cache16, torch.float32),
                               two)
        cont["bf16_ratio"], _, _ = _bf16_ratio(rows[:, 1:2], cont16, ref1, v)
        cont["bf16"] = float((rows[:, 1, :v].float()
                              - cont16[:, 0, :v].float()).abs().max())
        del cache16, cont16, ref1
        if not cont["bf16_ratio"] <= LM_BF16_MARGIN:
            fail(f"{name} serving: the bf16 first decode step up to "
                 f"{cont['bf16_ratio']} x the bf16 chunked path's distance "
                 "from the float32 step")
    del ref, rows32, cache32, p32
    out = dict(prefill_ms=prefill_ms, decode_step_ms=decode_ms,
               decode_tokens_per_s=LM_BATCH / (decode_ms / 1e3),
               serve_peak_bytes=peak, prefill_vs_forward=err,
               bf16_ratio=ratio, first_decode_vs_forward_bf16=first_bf16,
               decode_vs_forward_bf16=all_bf16, greedy_agrees=agree,
               f32_first_decode_vs_forward=first32, f32_vs_forward=all32,
               first_decode_vs_continued=cont,
               f32_vs_forward_by_step=[float(x) for x in d32],
               cache=max_len, decode_step_device_ms=device_ms)
    if device_ms is not None:
        print(f"[ssm profile] {name}: a decode step {device_ms:.3f} ms of "
              f"device kernels in {decode_ms:.3f} ms: the card idles "
              f"{100 * (1 - device_ms / decode_ms):.1f}% of it", flush=True)
    steps32 = ", ".join(f"{x:.3g}" for x in out["f32_vs_forward_by_step"][:8])
    print(f"[ssm] {name} serving {LM_BATCH} x {SSM_PROMPT}-token prompts, "
          f"{SSM_NEW} greedy tokens" + (f", KV cache {max_len}" if hybrid
                                        else "")
          + f": prefill {prefill_ms:.3f} ms, {decode_ms:.3f} ms a decode "
          f"step, {out['decode_tokens_per_s']:.6g} decode tokens/s; peak "
          f"device memory {peak / 2**30:.2f} GiB; bf16 prefill's last logits "
          f"vs a chunked forward over the prompt {err:.4g} (limit "
          f"{SERVE_ATOL} abs, {SERVE_RTOL} rel); "
          + ("" if hybrid else
             f"the first decode step vs the chunked path continued from the "
             f"same prefill: float32 {cont['f32']:.4g} (limit {SERVE_ATOL} "
             f"abs, {SERVE_RTOL} rel: the chunked mLSTM rounds to bf16, the "
             f"recurrence does not); bf16: its distance from the float32 "
             f"step from the same state {cont['bf16_ratio']:.4g} x the bf16 "
             f"chunked path's (limit {LM_BF16_MARGIN}), reported: bf16 decode "
             f"vs chunked {cont['bf16']:.4g}; ")
          + f"float32 weights and cache, the same tokens: the first decode "
          f"step vs a forward over the prompt and the tokens {first32:.4g} ("
          + (f"limit {SERVE_ATOL} abs, {SERVE_RTOL} rel" if hybrid else
             "reported: the sLSTM recurrence parts the prefill's states from "
             "the forward's") + f"), every step {all32:.4g} ("
          + (f"limit {LM_F32_TOL}" if hybrid else "reported")
          + f"; by step {steps32}, ...); "
          f"bf16: largest ratio of a position's distance from the float32 "
          f"forward to the bf16 forward's {ratio:.4g} ("
          + (f"limit {LM_BF16_MARGIN}" if hybrid else "reported") + "); "
          f"reported: the first decode step vs the bf16 forward "
          f"{first_bf16:.4g}, every step {all_bf16:.4g}, greedy tokens equal "
          f"to the forward's argmax {100 * agree:.1f}%", flush=True)
    return out


def ssm_run(name: str, seed: int, card: str):
    cfg = get_config(name).full
    model = build_model(cfg)
    n_params = P.count_params(model.spec)
    if n_params != SSM_PARAMS[name]:
        fail(f"{name}: {n_params} parameters, not {SSM_PARAMS[name]}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model.load_params(P.init(model.spec, gen, device="cuda"))
    params = model.params
    torch.cuda.synchronize()
    what = (f"{cfg.n_layers} Mamba2 blocks (chunk {cfg.ssm.chunk}, "
            f"{cfg.ssm.n_heads} SSD heads, d_state {cfg.ssm.d_state}), the "
            f"shared attention every {cfg.shared_attn_every} ({cfg.n_heads} "
            f"heads of {cfg.hd})" if cfg.family == "hybrid" else
            f"{cfg.n_layers} blocks, every {cfg.xlstm.slstm_every}th an "
            f"sLSTM ({cfg.n_heads} heads)")
    print(f"[ssm] {name} ({cfg.family}): {what}, d_model {cfg.d_model}, "
          f"vocab {cfg.padded_vocab}; {n_params} parameters in bf16 from "
          f"params.init: {time.perf_counter() - t0:.2f}s", flush=True)
    batch = family_batch(cfg, gen)
    secs = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        row = ssm_scoring(name, model, params, cfg, batch)
        secs["scoring"] = time.perf_counter() - t0
        row.update(card=card, parameters=n_params)
        t0 = time.perf_counter()
        row["f32"] = ssm_cross_device(name, cfg, params, batch["tokens"])
        secs["cross_device"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        row.update(ssm_serving(name, model, params, cfg, batch))
        secs["serving"] = time.perf_counter() - t0
    row["seconds"] = secs
    print(f"[ssm] {name} on {card}: scoring {row['score_ms']:.3f} ms, "
          f"{row['score_tokens_per_s']:.6g} tokens/s, peak "
          f"{row['score_peak_bytes'] / 2**30:.2f} GiB; prefill "
          f"{row['prefill_ms']:.3f} ms, decode {row['decode_step_ms']:.3f} "
          f"ms a step, peak {row['serve_peak_bytes'] / 2**30:.2f} GiB; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()),
          flush=True)
    return row


def phase_ssm(seed: int):
    """Phase 23: zamba2-1.2b (hybrid) and xlstm-1.3b (ssm) at full width
    and depth: scoring, the cross-device check, serving."""
    t0 = time.perf_counter()
    card = card_line()
    out = {}
    for name in SSM_PARAMS:
        out[name] = ssm_run(name, seed, card)
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"[ssm] phase 23: {out['seconds']:.1f}s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 24: LM training
# ---------------------------------------------------------------------------

TRAIN_CONFIG = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ = 4, 2048     # the train cell: 8192 tokens a step
TRAIN_STEPS = 8                      # on one repeated batch; timed 2-8
TRAIN_REMATS = ("none", "dots", "full")
# remat recomputes and changes no value: the policies' losses and
# gradients must be bit-equal; a leaf may differ by at most this share of
# its largest element (bf16 gradients: a recomputed product rounded apart
# by one ulp) before the gate fails
TRAIN_REMAT_TOL = 2 ** -7
# card vs CPU: float32 copies of the weights at full width, 2 layers,
# 1 x 512 tokens
TRAIN_CHECK_LAYERS, TRAIN_CHECK_SEQ = 2, 512
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_MASTER_TOL = 1e-5, 1e-4, 1e-6
# an mLSTM block rounds its chunk products' operands to bf16 on float32
# weights too (tests/test_torch_train.py's 2e-3)
TRAIN_MLSTM_TOL = 2e-3
TRAIN_ACCUM_TOL = 1e-5               # accum 2 vs 1: loss and gradients
# cuBLAS's matrix-product kernels, by the profiler's names
GEMM_NAMES = ("nvjet", "gemm", "cutlass", "xmma")
# every config's smoke size takes two steps on the card
TRAIN_FAMILIES = ("olmo-1b", "internlm2-20b", "minicpm-2b", "minicpm3-4b",
                  "qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b",
                  "llava-next-mistral-7b", "hubert-xlarge", "xlstm-1.3b",
                  "zamba2-1.2b")
TRAIN_SPANS = ((lm_steps, "loss_fn", "forward"),
               (torch.autograd, "grad", "backward"),
               (optim_mod.AdamW, "update", "optimizer"))


def _grad_err(got, want, tol_of=lambda k: TRAIN_GRAD_TOL):
    """Each leaf's max |got - want| over want's max |.|: the worst share
    and its leaf; fails over ``tol_of(leaf)``."""
    worst, where = 0.0, None
    for (k, g), (_, w) in zip(ckpt._flatten_with_paths(got),
                              ckpt._flatten_with_paths(want)):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        if not bool(torch.isfinite(g).all()):
            fail(f"train: a non-finite gradient in {k}")
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if err > tol_of(k):
            fail(f"train: gradient {k} apart by {err:.3g} of its max "
                 f"(limit {tol_of(k)})")
        if err >= worst:
            worst, where = err, k
    return worst, where


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(
        ckpt._flatten_with_paths(a), ckpt._flatten_with_paths(b)))


def _timed_steps(step, p, st, batch, n, ctx=None):
    """``n`` train steps on one batch, each between CUDA events; returns
    the new state, the metrics read back, each step's device ms and each
    step's host ms (the call's own time: nothing reads back until the
    end)."""
    evs, metrics, host = [], [], []
    torch.cuda.synchronize()
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        if ctx is None:
            p, st, m = step(p, st, batch)
        else:
            p, st, m, ctx = step(p, st, batch, ctx)
        e.record()
        host.append(1e3 * (time.perf_counter() - t0))
        evs.append((s, e))
        metrics.append(m)
    torch.cuda.synchronize()
    got = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, m in enumerate(got):
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            fail(f"train step {i + 1}: loss {m['loss']}, grad_norm "
                 f"{m['grad_norm']}")
    return p, st, ctx, got, [s.elapsed_time(e) for s, e in evs], host


def train_main(model, cfg, params, batch, card):
    """(a) 8 steps on one batch (remat "dots"), timed; the spans of a 9th;
    (b) two steps with the gradient compressor."""
    opt = optim_mod.AdamW(schedule=optim_mod.WSDSchedule(warmup_steps=1))
    st = opt.init(params)
    step = lm_steps.make_train_step(model, opt, remat="dots")
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    p, st, _, ms, step_ms, host_ms = _timed_steps(step, params, st, batch,
                                                  TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    launches = all_launches()
    if any(launches.values()):
        fail(f"train: kernel launches {launches} (the path trains on the "
             "chunked attention, as the reference)")
    losses = [m["loss"] for m in ms]
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall over {TRAIN_STEPS} steps on one "
             f"batch: {losses}")
    timed = step_ms[1:]
    mean_ms = sum(timed) / len(timed)
    mean_host = sum(host_ms[1:]) / len(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] {cfg.name} on {card}: {TRAIN_STEPS} steps on one batch "
          f"of {TRAIN_BATCH} x {TRAIN_SEQ}, remat dots, AdamW + WSD (warmup "
          f"1): loss " + ", ".join(f"{v:.5f}" for v in losses)
          + f"; grad_norm {ms[0]['grad_norm']:.4g} -> "
          f"{ms[-1]['grad_norm']:.4g}; {mean_ms:.3f} ms a step (CUDA "
          f"events, steps 2-{TRAIN_STEPS}: "
          + ", ".join(f"{v:.3f}" for v in timed)
          + f"), {tokens / (mean_ms / 1e3):.6g} train tokens/s, host "
          f"{mean_host:.3f} ms a step (the calls' own time, steps 2-"
          f"{TRAIN_STEPS}; step 1 {step_ms[0]:.3f} ms on the card, "
          f"{host_ms[0]:.3f} on the host); peak {peak / 2**30:.2f} GiB",
          flush=True)
    with Spans(TRAIN_SPANS) as spans:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        p, st, _ = step(p, st, batch)
        e.record()
        span_ms = spans.ms()
    whole = s.elapsed_time(e)
    shares = {k: v / whole for k, v in span_ms.items()}
    print(f"[train] spans of one step ({whole:.3f} ms on the card): "
          + ", ".join(f"{k} {span_ms[k]:.3f} ms ({100 * shares[k]:.1f} %)"
                      for k in span_ms)
          + "; host s in each: " + ", ".join(
              f"{k} {v:.3f}" for k, v in spans.host_s.items()), flush=True)
    # the card's busy share of one more step (torch.profiler's device
    # events) against its CUDA-event time
    times = profile(lambda: step(p, st, batch), "train profile",
                    "one train step (remat dots)")
    busy_ms = sum(times.values()) / 1e3 if times else None
    idle = None if busy_ms is None else 1.0 - busy_ms / mean_ms
    gemm_ms = sum(us for k, us in times.items() if any(
        t in k.lower() for t in GEMM_NAMES)) / 1e3
    if idle is not None:
        print(f"[train] one step: {busy_ms:.3f} ms of device kernels "
              f"against {mean_ms:.3f} ms a step: idle {100 * idle:.1f} %; "
              f"the matrix products (cuBLAS) {gemm_ms:.3f} ms "
              f"({100 * gemm_ms / busy_ms:.1f} % of the kernels' time), "
              f"the rest elementwise, reductions and copies", flush=True)
    del p, st
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the step with --grad-compress: a refresh, then a quantized step
    comp = DeltaEFCompressor()
    st = opt.init(params)
    cstep = lm_steps.make_train_step(model, opt, remat="dots",
                                     grad_transform=comp)
    torch.cuda.reset_peak_memory_stats()
    _, _, ctx, cms, c_ms, c_host = _timed_steps(cstep, params, st, batch,
                                                2, comp.init(params))
    c_peak = torch.cuda.max_memory_allocated()
    if int(ctx["step"]) != 2:
        fail(f"train --grad-compress: context step {int(ctx['step'])}")
    print(f"[train] --grad-compress (int8 delta + error feedback): refresh "
          f"step {c_ms[0]:.3f} ms, quantized step {c_ms[1]:.3f} ms (host "
          f"{c_host[1]:.3f}; loss "
          f"{cms[1]['loss']:.5f}, grad_norm {cms[1]['grad_norm']:.4g}); "
          f"wire {comp.wire_bytes(params, full=False)} B a quantized step "
          f"against {comp.wire_bytes(params, full=True)} B float32; peak "
          f"{c_peak / 2**30:.2f} GiB", flush=True)
    del st, ctx
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, grad_norms=[m["grad_norm"] for m in ms],
                launches=launches, step_ms=mean_ms, step_ms_each=step_ms,
                host_ms=mean_host, host_ms_each=host_ms,
                busy_ms=busy_ms, idle_share=idle, gemm_ms=gemm_ms,
                tokens_per_s=tokens / (mean_ms / 1e3), peak_bytes=peak,
                span_ms=span_ms, span_shares=shares, span_step_ms=whole,
                compress=dict(refresh_ms=c_ms[0], quantized_ms=c_ms[1],
                              peak_bytes=c_peak))


def train_host_cost(cfg, seed, full_ms):
    """(a') The host's own cost of a train step: the same step (remat
    "dots", AdamW) on the smoke width at the full config's depth and the
    cell's 4 x 2048 tokens: the same calls, on device work small enough
    that the launch queue does not back up, so a call's time is the
    host's own.  Steps 2-4, host ms (the calls' own time) and card ms."""
    small = dataclasses.replace(get_config(TRAIN_CONFIG).smoke,
                                n_layers=cfg.n_layers)
    model = build_model(small)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.load_params(P.init(model.spec, gen, device="cuda")).params
    batch = SyntheticLM(small, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        seed=seed, device="cuda").batch_for_step(0)
    opt = optim_mod.AdamW(schedule=optim_mod.WSDSchedule(warmup_steps=1))
    step = lm_steps.make_train_step(model, opt, remat="dots")
    _, _, _, _, card_ms, host_ms = _timed_steps(step, params,
                                                opt.init(params), batch, 4)
    host = sum(host_ms[1:]) / 3
    card = sum(card_ms[1:]) / 3
    print(f"[train] the host's own cost of a step: {small.n_layers} layers "
          f"at the smoke width (d_model {small.d_model}), {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, remat dots: host {host:.3f} ms a step (the calls' "
          f"own time, steps 2-4: "
          + ", ".join(f"{v:.3f}" for v in host_ms[1:])
          + f"), card {card:.3f} ms (CUDA events); "
          f"{100 * host / full_ms:.1f} % of the full-width step's "
          f"{full_ms:.3f} ms", flush=True)
    del params, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=small.n_layers, d_model=small.d_model,
                host_ms=host, host_ms_each=host_ms, card_ms=card,
                card_ms_each=card_ms, share_of_full_step=host / full_ms)


def train_remat(model, params, batch):
    """(c) ``value_and_grad`` under each remat policy at 4 x 2048: peak
    memory and device ms of each, the losses and gradients bit-equal.  A
    policy that does not fit on the card fails the phase."""
    ref, row = None, {}
    for policy in TRAIN_REMATS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        try:
            t0 = time.perf_counter()
            s.record()
            loss, grads = lm_steps.value_and_grad(model, params, batch,
                                                  remat=policy)
            e.record()
            host_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            fail(f"remat {policy} at {TRAIN_BATCH} x {TRAIN_SEQ}: out of "
                 f"memory (peak so far "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
        r = {"peak_bytes": torch.cuda.max_memory_allocated(),
             "ms": s.elapsed_time(e), "host_ms": host_ms,
             "loss": float(loss)}
        if ref is None:
            ref = (policy, loss, grads)
        else:
            r["bit_equal"] = bool(torch.equal(loss, ref[1])
                                  and _leaves_equal(grads, ref[2]))
            if not r["bit_equal"]:
                if abs(float(loss) - float(ref[1])) > 1e-6 * abs(
                        float(ref[1])):
                    fail(f"remat {policy}: loss {float(loss)} against "
                         f"{ref[0]}'s {float(ref[1])}")
                r["max_share"] = _grad_err(
                    grads, ref[2], lambda k: TRAIN_REMAT_TOL)[0]
        row[policy] = r
        del loss, grads
    del ref
    print(f"[train] remat at {TRAIN_BATCH} x {TRAIN_SEQ} (value_and_grad, "
          "no optimizer state): " + "; ".join(
              f"{k} peak {v['peak_bytes'] / 2**30:.2f} GiB, "
              f"{v['ms']:.3f} ms (host {v['host_ms']:.3f}), "
              f"loss {v['loss']:.6f}"
              + ("" if "bit_equal" not in v else
                 ", bit-equal" if v["bit_equal"] else
                 f", apart by {v['max_share']:.3g} of a leaf's max")
              for k, v in row.items()), flush=True)
    return {f"{TRAIN_BATCH}x{TRAIN_SEQ}": row}


def train_card_vs_cpu(cfg, params, batch):
    """(d) Full width, 2 layers, float32 copies of the weights, 1 x 512
    tokens: the loss and every gradient, the card against the port on the
    CPU; one AdamW step from the same state on the CPU's gradients, the
    masters; and (e) accum_steps 2 against 1 on 2 x 512 rows."""
    model = build_model(dataclasses.replace(cfg,
                                            n_layers=TRAIN_CHECK_LAYERS))
    p32 = _fit(model.spec, params)
    p_cpu = P.tree_map(lambda a: a.cpu(), p32)
    b1 = {k: v[:1, :TRAIN_CHECK_SEQ] for k, v in batch.items()}
    b_cpu = {k: v.cpu() for k, v in b1.items()}
    loss, grads = lm_steps.value_and_grad(model, p32, b1)
    t0 = time.perf_counter()
    loss_c, grads_c = lm_steps.value_and_grad(model, p_cpu, b_cpu)
    cpu_s = time.perf_counter() - t0
    loss_err = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    if loss_err > TRAIN_LOSS_TOL:
        fail(f"train card vs CPU: loss {float(loss)} against "
             f"{float(loss_c)}")
    g_err, g_leaf = _grad_err(grads, grads_c)
    opt = optim_mod.AdamW(schedule=optim_mod.WSDSchedule(warmup_steps=1))
    g_card = P.tree_map(lambda a: a.to("cuda"), grads_c)
    _, st = opt.update(g_card, opt.init(p32), p32)
    _, st_c = opt.update(grads_c, opt.init(p_cpu), p_cpu)
    m_err = max(float((a.cpu() - b).abs().max()) for (_, a), (_, b) in zip(
        ckpt._flatten_with_paths(st.master),
        ckpt._flatten_with_paths(st_c.master)))
    if m_err > TRAIN_MASTER_TOL:
        fail(f"train card vs CPU: one AdamW step's master apart by {m_err}")
    del st, st_c, g_card
    # (e) accumulation: the same 2 x 512 rows in one step and in two
    seen = []

    def capture(g, ctx):
        seen.append(g)
        return g, ctx

    rows = {k: v[:2, :TRAIN_CHECK_SEQ] for k, v in batch.items()}
    res = {}
    for accum in (1, 2):
        st = opt.init(p32)
        step = lm_steps.make_train_step(model, opt, accum_steps=accum,
                                        grad_transform=capture)
        _, _, m, _ = step(p32, st, rows, None)
        res[accum] = {k: float(v) for k, v in m.items()}
    a_loss = abs(res[2]["loss"] - res[1]["loss"]) / abs(res[1]["loss"])
    if a_loss > TRAIN_ACCUM_TOL:
        fail(f"train accum 2 vs 1: loss {res[2]['loss']} against "
             f"{res[1]['loss']}")
    a_err, a_leaf = _grad_err(seen[1], seen[0],
                              lambda k: TRAIN_ACCUM_TOL)
    print(f"[train] card vs CPU, float32, full width, "
          f"{TRAIN_CHECK_LAYERS} layers, 1 x {TRAIN_CHECK_SEQ} tokens "
          f"({cpu_s:.2f} s on the CPU): loss {float(loss):.7f} against "
          f"{float(loss_c):.7f} (rel {loss_err:.3g}, limit "
          f"{TRAIN_LOSS_TOL}), gradients apart by at most {g_err:.3g} of a "
          f"leaf's max ({g_leaf}; limit {TRAIN_GRAD_TOL}); one AdamW step "
          f"on the same gradients: masters apart by {m_err:.3g} (limit "
          f"{TRAIN_MASTER_TOL}); accum 2 vs 1 on 2 x {TRAIN_CHECK_SEQ}: "
          f"loss rel {a_loss:.3g}, gradients {a_err:.3g} of a leaf's max "
          f"({a_leaf}; limit {TRAIN_ACCUM_TOL})", flush=True)
    return dict(loss_rel=loss_err, grad_share=g_err, master_abs=m_err,
                cpu_s=cpu_s, accum_loss_rel=a_loss, accum_grad_share=a_err)


def train_resume(seed):
    """(f) olmo-1b's smoke model: 4 steps with a checkpoint at 2 under
    build/, then steps 3-4 again from the restore: bit-identical."""
    cfg = get_config(TRAIN_CONFIG).smoke
    model = build_model(cfg)
    opt = optim_mod.AdamW()
    pipe = SyntheticLM(cfg, seq_len=32, global_batch=2, seed=seed,
                       device="cuda")
    step = lm_steps.make_train_step(model, opt)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = model.load_params(P.init(model.spec, gen, device="cuda")).params
    st = opt.init(p)
    for i in range(2):
        p, st, _ = step(p, st, pipe.batch_for_step(i))
    where = ROOT / "build" / "train_ckpt"
    shutil.rmtree(where, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(str(where), 2, {"params": p, "opt": st})
    save_s = time.perf_counter() - t0
    pa, sa = p, st
    for i in range(2, 4):
        pa, sa, _ = step(pa, sa, pipe.batch_for_step(i))
    t0 = time.perf_counter()
    _, back, _ = ckpt.restore(str(where), like={"params": p, "opt": st})
    restore_s = time.perf_counter() - t0
    pb, sb = back["params"], back["opt"]
    for i in range(2, 4):
        pb, sb, _ = step(pb, sb, pipe.batch_for_step(i))
    shutil.rmtree(where, ignore_errors=True)
    if not _leaves_equal((pa, sa), (pb, sb)):
        fail("train resume: steps 3-4 from the checkpoint differ")
    print(f"[train] resume ({cfg.name} smoke): steps 3-4 from the step-2 "
          f"checkpoint bit-identical on the card; save {save_s:.3f} s, "
          f"restore {restore_s:.3f} s", flush=True)
    return dict(save_s=save_s, restore_s=restore_s)


def train_families(seed):
    """(g) every smoke config: 2 steps on the card (bf16 weights), finite
    and the parameters moved; float32 copies of the weights: the loss and
    gradients on the card against the CPU's; (h) ``backend="kernel"``
    under autograd raises before any launch."""
    out = {}
    for name in TRAIN_FAMILIES:
        cfg = get_config(name).smoke
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        p0 = model.load_params(P.init(model.spec, gen, device="cuda")).params
        seq = 64 + (cfg.n_patches if cfg.family == "vlm" else 0)
        pipe = SyntheticLM(cfg, seq_len=seq, global_batch=2, seed=seed,
                           device="cuda")
        opt = optim_mod.AdamW(schedule=optim_mod.WSDSchedule(
            warmup_steps=2, stable_steps=5, decay_steps=2))
        step = lm_steps.make_train_step(model, opt, remat="dots")
        p, st = p0, opt.init(p0)
        losses = []
        for i in range(2):
            p, st, m = step(p, st, pipe.batch_for_step(i))
            losses.append(float(m["loss"]))
            if not (math.isfinite(losses[-1])
                    and math.isfinite(float(m["grad_norm"]))):
                fail(f"train {name}: step {i + 1} loss {losses[-1]}, "
                     f"grad_norm {float(m['grad_norm'])}")
        moved = max(float((a.float() - b.float()).abs().max()) for (_, a),
                    (_, b) in zip(ckpt._flatten_with_paths(p),
                                  ckpt._flatten_with_paths(p0)))
        if not moved > 0:
            fail(f"train {name}: the parameters did not move")
        p32 = P.tree_map(lambda a: a.float(), p0)
        batch = pipe.batch_for_step(0)
        loss, grads = lm_steps.value_and_grad(model, p32, batch)
        loss_c, grads_c = lm_steps.value_and_grad(
            model, P.tree_map(lambda a: a.cpu(), p32),
            {k: v.cpu() for k, v in batch.items()})
        l_err = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
        if l_err > TRAIN_LOSS_TOL:
            fail(f"train {name}: card loss {float(loss)} against the CPU's "
                 f"{float(loss_c)}")
        g_err, g_leaf = _grad_err(grads, grads_c, lambda k: (
            TRAIN_MLSTM_TOL if k.startswith("mlstm/") else TRAIN_GRAD_TOL))
        out[name] = dict(losses=losses, moved=moved, loss_rel=l_err,
                         grad_share=g_err, grad_leaf=g_leaf)
    # (h) the attention kernel has no backward: it raises (ROADMAP B5 b)
    cfg = get_config(TRAIN_CONFIG).smoke
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = model.load_params(P.init(model.spec, gen, device="cuda")).params
    batch = SyntheticLM(cfg, seq_len=128, global_batch=2,
                        device="cuda").batch_for_step(0)
    reset_all_launches()
    try:
        lm_steps.value_and_grad(model, p, batch, backend="kernel")
        fail("train: backend 'kernel' under autograd did not raise")
    except NotImplementedError as e:
        if "B5 b" not in str(e):
            fail(f"train: backend 'kernel' raised {e!r}")
    if any(all_launches().values()):
        fail(f"train: the raising call launched {all_launches()}")
    print("[train] every smoke config, 2 steps on the card (remat dots): "
          "finite, parameters moved; float32 loss and gradients against the "
          "CPU: " + "; ".join(
              f"{k} loss rel {v['loss_rel']:.2g}, grads {v['grad_share']:.2g}"
              for k, v in out.items())
          + f" (limits {TRAIN_LOSS_TOL}, {TRAIN_GRAD_TOL}, mLSTM leaves "
          f"{TRAIN_MLSTM_TOL}); backend 'kernel' under autograd raises "
          "NotImplementedError (B5 b) before any launch", flush=True)
    return out


def phase_train(seed: int):
    """Phase 24: olmo-1b training at full width and depth on the card
    (the train step, its spans, the compressed step, the host's own cost
    of a step, the remat policies,
    card vs CPU, accumulation), a resume, every smoke config, the
    example."""
    t0 = time.perf_counter()
    card = card_line()
    cfg = get_config(TRAIN_CONFIG).full
    model = build_model(cfg)
    n_params = P.count_params(model.spec)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.load_params(P.init(model.spec, gen, device="cuda")).params
    batch = SyntheticLM(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        seed=seed, device="cuda").batch_for_step(0)
    torch.cuda.synchronize()
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.padded_vocab}; {n_params} parameters "
          f"(bf16 {2 * n_params / 2**30:.2f} GiB; float32 master, m and v "
          f"{12 * n_params / 2**30:.2f} GiB); SyntheticLM {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: {time.perf_counter() - t0:.2f}s", flush=True)
    out = {"parameters": n_params, "card": card}
    out["main"] = train_main(model, cfg, params, batch, card)
    out["host_cost"] = train_host_cost(cfg, seed, out["main"]["step_ms"])
    out["remat"] = train_remat(model, params, batch)
    out["card_vs_cpu"] = train_card_vs_cpu(cfg, params, batch)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["resume"] = train_resume(seed)
    out["families"] = train_families(seed)
    ex, ex_stats = run_example("train_lm")
    if ex["latest"] != 200 or not math.isfinite(ex["final_loss"]):
        fail(f"train_lm example: {ex}")
    out["example"] = dict(ex_stats, final_loss=ex["final_loss"])
    out["seconds"] = time.perf_counter() - t0
    print(f"[train] phase 24: {out['seconds']:.1f}s", flush=True)
    return out


def phase_lm_mesh(seed: int):
    """Phase 25: the LM mesh, four ranks on the card
    (``tools/lm_mesh_phase.py``)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import lm_mesh_phase

    return lm_mesh_phase.run(seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--codec-calls", help="phase 7 alone, on the calls "
                    "phase_codec_apart saved; prints its rows as JSON")
    ap.add_argument("--codec-label", default="codec")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.codec_calls:
        saved = torch.load(args.codec_calls, map_location="cuda",
                           weights_only=False)
        rows = phase_codec({name: [(a, kw, None) for a, kw in rec]
                            for name, rec in saved.items()},
                           args.codec_label)
        print(json.dumps(rows), flush=True)
        return 0

    # 1. card
    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {card}", flush=True)

    # 2. build: one nvcc a kernel source, started together
    t0 = time.perf_counter()
    _build.load_all(["pair_sweep", "delta_codec", "flash_attention"])
    print(f"[build] the three kernel libraries in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    for name, built in _build.BUILDS.items():
        print(f"[build] {name}: {built.path.name} (nvcc "
              f"{built.seconds:.2f}s)", flush=True)
        for line in built.log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"[build]   {line.strip()}", flush=True)
    # the bf16 attention kernel must run on the tensor cores' wgmma
    hgmma = sum("HGMMA" in line
                for line in _build.sass("flash_attention").splitlines())
    print(f"[build] flash_attention: {hgmma} HGMMA instructions in its "
          "machine code (cuobjdump -sass)", flush=True)
    if hgmma == 0:
        fail("flash_attention: no HGMMA instruction in the machine code")

    small = phase_small(args.seed)
    rows, launches, main_stats = phase_main(args.seed)
    parity = phase_parity(args.seed)
    gc.collect()                 # free the single-device path's 43 GiB
    torch.cuda.empty_cache()
    mesh_launches, calls, mesh_stats = phase_mesh(args.seed)
    mesh_parity, torus_calls = phase_mesh_parity(args.seed)
    codec = phase_codec_apart({**calls, TORUS_DECODE: torus_calls})
    torus_row = codec.pop(TORUS_DECODE)
    del calls, torus_calls
    gc.collect()
    torch.cuda.empty_cache()
    flash = phase_flash(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    lm = phase_lm(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    force = phase_force(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    sim_rows, sim_stats = phase_sims(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    rows_3d, spheroid_row, spheroid = phase_3d(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    ens_rows, ensembles = phase_ensembles(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    partition = phase_partition(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    process_mesh = phase_process_mesh(args.seed, mesh_launches, mesh_stats)
    gc.collect()
    torch.cuda.empty_cache()
    rebalance = phase_rebalance(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    guards = phase_guards(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    checks = phase_simcheck(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    slab_phase = phase_slabs(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    examples = phase_examples()
    gc.collect()
    torch.cuda.empty_cache()
    families = phase_families(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    ssm = phase_ssm(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    lm_mesh = phase_lm_mesh(args.seed)

    soft, same = rows["soft_repulsion_adhesion"], rows["same_type"]
    # phase 16: each rank's launches of the process mesh's driven run
    pm_launches = [r["launches"] for r in process_mesh["ranks"]]
    kernels = [{
        "name": "pair_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pair_sweep.cu",
        "replaces": "src/repro/kernels/neighbor_interaction.py:92",
        "tpu": "repro/kernels/neighbor_interaction.py:pair_sweep_kernel",
        "launches": launches["soft_repulsion_adhesion"]
        + launches["same_type"],
        "max_abs_err": max(soft["max_abs_err"], same["max_abs_err"]),
        "max_err": max(soft["max_abs_err"], same["max_abs_err"]),
        # the per-step law at the main-path shape; both laws under "laws"
        "law": "soft_repulsion_adhesion",
        "ms": soft["ms"], "plain_ms": soft["plain_ms"],
        "bound_ms": soft["bound_ms"], "bound_by": soft["bound_by"],
        "library_ms": None,
        # every law it ran: the main path's two, then phase 12's, then
        # phase 13's D = 3 rows: the uniform 128^3 SoA (launches: none on a
        # driven path but the stack's) and the spheroid path's own SoA
        "laws": {**{law: dict(r, launches=launches[law])
                    for law, r in rows.items()}, **sim_rows,
                 **{f"{law}@d3": dict(r, launches=spheroid["one_device"][
                     "launches"] if law == SPH_STACK else 0)
                    for law, r in rows_3d.items()},
                 f"{SPH_STACK}@spheroid": dict(
                     spheroid_row,
                     launches=spheroid["one_device"]["launches"])},
        "sims": dict(sim_stats, tumor_spheroid=spheroid),
        "small_128x128": small,
        "step_ms": main_stats["step_ms"],
        "peak_device_bytes": main_stats["peak_bytes"],
        "parity_pos_err": parity,
        "mesh_launches": mesh_launches["soft_repulsion_adhesion"]
        + mesh_launches["same_type"],
    }]
    for name, r in codec.items():
        kernels.append(dict(
            {"name": name, "route": "cuda", "source": SOURCE_CODEC,
             "replaces": f"{TPU_CODEC}:{CODEC_REPLACES[name]}",
             "launches": mesh_launches[name],
             "process_mesh_path": {"launches": [
                 lc.get(name, 0) for lc in pm_launches]}}, **r))
        if name == "migration_pos_decode":
            kernels[-1]["toroidal_calls"] = torus_row
    kernels[0]["mesh_path"] = dict(
        {k: v for k, v in mesh_stats.items() if k != "block_sha"},
        parity=mesh_parity)
    # phase 17: the rebalanced run's launches (10 steps on the cut)
    kernels[0]["rebalance_path"] = dict(
        rebalance, launches=rebalance["launches"].get(
            "soft_repulsion_adhesion", 0))
    for k in kernels[1:]:
        if k["name"] in dc.LAUNCHES:
            k["rebalance_path"] = {"launches": rebalance["launches"].get(
                k["name"], 0)}
    # phase 18: the guarded main path's launches (10 steps)
    kernels[0]["guards_path"] = dict(
        guards, launches=guards["main_path"]["launches"].get(
            "soft_repulsion_adhesion", 0))
    # phase 19: the step audit's probe steps (validate's path)
    sc = checks["launches"]
    kernels[0]["simcheck_path"] = dict(
        {k: v for k, v in checks.items() if k != "launches"},
        launches=sum(got.get("soft_repulsion_adhesion", 0)
                     for got in sc.values()),
        probe_launches=sc)
    for k in kernels[1:]:
        if k["name"] in dc.LAUNCHES:
            k["simcheck_path"] = {"launches": sc["mesh"].get(k["name"], 0)}
    kernels[0]["process_mesh_path"] = dict(
        process_mesh, launches=[
            lc.get("soft_repulsion_adhesion", 0) + lc.get("same_type", 0)
            for lc in pm_launches])
    # phase 15: the overlapped sweep's launches on the uneven cut, each
    # kind as counted (interior passes, face bands)
    interior = partition["launches"]["soft_repulsion_adhesion"]
    faces = partition["launches"]["soft_repulsion_adhesion" + ni.FACE]
    kernels[0]["partition_path"] = dict(
        partition, launches=interior + faces, face_band_launches=faces,
        interior_launches=interior)
    kernels.append(dict(
        {"name": "neighbor_force", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pair_sweep.cu",
         "replaces": "src/repro/kernels/neighbor_interaction.py:201"},
        **force))
    kernels.append(dict(
        {"name": "flash_attention_wgmma", "route": "cuda",
         "source": FLASH_SOURCE,
         "replaces": "src/repro/kernels/flash_attention.py:75",
         "launches": lm["score_launches"]["flash_attention_wgmma"]},
        **flash["rows"]["flash_attention_wgmma"], lm_path=lm,
        # phase 22: each config's scoring forward, counted alone
        families_path=dict(
            {name: dict(r, launches=r["score_launches"][
                "flash_attention_wgmma"]) for name, r in families.items()
             if name != "seconds"}, seconds=families["seconds"]),
        # phase 23: zamba2's scoring forward (its shared attention block),
        # counted alone; xLSTM launches none
        ssm_path=dict(
            {name: dict(r, launches=r["score_launches"][
                "flash_attention_wgmma"]) for name, r in ssm.items()
             if name != "seconds"}, seconds=ssm["seconds"]),
        # phase 24: training runs the chunked attention, as the
        # reference's; under autograd the kernel raises (B5 b)
        train_path=dict(train, launches=train["main"]["launches"][
            "flash_attention_wgmma"], raises_under_autograd=True),
        # phase 25: each rank's serving launches (its prefill's layers)
        lm_mesh_path=dict(lm_mesh, launches=[
            r["launches"].get("flash_attention_wgmma", 0)
            for r in lm_mesh["serve"]["ranks"]])))
    kernels.append(dict(
        {"name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
         "replaces": "src/repro/kernels/flash_attention.py:75",
         # the scoring forward on float32 copies of the weights
         "launches": lm["f32_launches"]["flash_attention"]},
        **flash["rows"]["flash_attention"],
        # phase 22: hubert's float32 forward at reduced depth
        families_path={"hubert-xlarge": dict(
            families["hubert-xlarge"]["f32"],
            launches=families["hubert-xlarge"]["f32"]["launches"][
                "flash_attention"])},
        # phase 23: the 7-layer zamba2 on float32 weights (card vs CPU)
        ssm_path={"zamba2-1.2b": dict(
            ssm["zamba2-1.2b"]["f32"],
            launches=ssm["zamba2-1.2b"]["f32"]["launches"][
                "flash_attention"])}))
    for law in (ENS_STACK, ENS_LAW5):
        launched = ensembles["one_device"]["launches"].get(law, 0)
        kernels.append(dict(
            {"name": f"pair_sweep_lanes:{law}", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/pair_sweep.cu",
             "replaces": "src/repro/kernels/neighbor_interaction.py:92",
             "lanes": len(ENS_POINTS), "launches": launched},
            **ens_rows[law]))
    kernels[-2]["ensembles"] = ensembles
    # phase 20: no driven path launches it (only ops calls it); its row
    # is the force law's, every law under "laws"
    soft_slab = slab_phase["rows"]["soft_repulsion_adhesion"]
    kernels.append(dict(
        {"name": "neighborhood_pair_sweep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pair_sweep.cu",
         "replaces": "src/repro/kernels/neighbor_interaction.py:92",
         "launches": 0, "law": "soft_repulsion_adhesion",
         "max_abs_err": max(max(r["max_abs_err"]
                                for r in slab_phase["rows"].values()),
                            max(slab_phase["d3_errs"].values()))},
        **{k: soft_slab[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        laws=slab_phase["rows"],
        **{k: v for k, v in slab_phase.items() if k != "rows"}))
    kernels[0]["examples"] = examples
    print(f"[total] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
