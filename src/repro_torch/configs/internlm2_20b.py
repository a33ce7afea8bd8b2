"""internlm2-20b — dense GQA kv=8 [arXiv:2403.17297]."""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92544, attention="gqa", norm="rmsnorm", pos="rope",
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=192,
    vocab=256,
)

register(FULL, SMOKE)
