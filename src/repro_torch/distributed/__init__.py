"""Port of ``repro.distributed``: the LM mesh's sharding rules and
collectives (``sharding``, ``collectives``), checkpoints (logical ABM ones
and trees of tensors), the elastic restore (both halves), fault plans, and
gradient compression (``checkpoint``, ``elastic``, ``chaos``,
``grad_compress``)."""
