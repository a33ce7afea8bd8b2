"""Port of ``repro.distributed``: logical ABM checkpoints and the ABM half
of the elastic restore (``checkpoint``, ``elastic``)."""
