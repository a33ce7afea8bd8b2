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
one device and on a virtual device mesh (the whole mesh on one card), the
neighbour sweep on the ``pair_sweep`` kernel and the delta-encoded aura
exchange and migration codec on the four ``delta_codec`` kernels.  See
``ROADMAP.md`` for what is still to come.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
