"""minicpm-2b — llama-like dense arch trained with WSD [arXiv:2404.06395]."""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122753, attention="gqa", norm="rmsnorm", pos="rope",
    tie_embeddings=True,
    notes="WSD (warmup-stable-decay) schedule is the training-side feature; "
          "see repro.training.optimizer.WSDSchedule.",
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab=255,
)

register(FULL, SMOKE)
