"""olmo-1b — dense, non-parametric LayerNorm [arXiv:2402.00838]."""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50304, attention="gqa", norm="nonparametric_ln", pos="rope",
    tie_embeddings=True,
    notes="Non-parametric LN (no scale/bias), tied embeddings.",
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab=256,
)

register(FULL, SMOKE)
