"""PyTorch/CUDA port of the ``repro`` ABM engine.

The package mirrors ``src/repro/`` module for module (``core/grid.py`` here
is the counterpart of ``repro/core/grid.py``, and so on) and imports only
``torch`` and ``numpy``.  Plain tensor code is PyTorch; every kernel the
JAX package wrote in Pallas for the TPU becomes a hand-written Hopper
kernel under ``kernels/``, with its plain PyTorch version beside it.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; asking for CUDA on a machine without one raises
(:func:`repro_torch.device.resolve_device`).

Ported so far: cell clustering (``sims.cell_clustering``) end to end on
one device and on a virtual device mesh (the whole mesh on one card);
``epidemiology``, ``sir_mechanics`` (a ``core.behaviors.compose`` stack),
``cell_proliferation`` and ``oncology`` with the reference's threefry
draws (``core.prng``) and the spawn path; every sim's neighbour sweep on
the ``pair_sweep`` kernel and the delta-encoded aura
exchange and migration codec on the four ``delta_codec`` kernels; the
legacy ``kernels.ops.neighbor_force`` on its own kernel; and the dense GQA
language models (``configs``: olmo-1b, internlm2-20b) for scoring
(``models.model.Model.logits``, ``training.steps.loss_fn``; backend
``"kernel"`` runs attention on the ``flash_attention`` kernel) and greedy
serving with a KV cache (``training.steps.make_prefill_step``,
``make_serve_decode_step``).  Every TPU kernel of the JAX package now has
a hand-written counterpart.  See ``ROADMAP.md`` for what is still to come.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
