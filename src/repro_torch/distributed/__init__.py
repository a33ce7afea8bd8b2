"""Port of ``repro.distributed``: checkpoints (logical ABM ones and
trees of tensors), the ABM half of the elastic restore, fault plans, and
the delta-encoded gradient compressor (``checkpoint``, ``elastic``,
``chaos``, ``grad_compress``)."""
