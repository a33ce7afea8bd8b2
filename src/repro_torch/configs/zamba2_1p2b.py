"""zamba2-1.2b — Mamba2 blocks + shared attention [arXiv:2411.15242]."""
import dataclasses

from repro_torch.configs.base import ArchConfig, SSMConfig, register

FULL = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, attention="gqa", norm="rmsnorm", pos="rope",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, n_heads=32, chunk=256),
    shared_attn_every=6, sub_quadratic=True,
    notes="38 Mamba2 blocks; ONE shared attention+MLP block (weight reuse) "
          "applied every 6 blocks (6 groups + 2-layer tail).",
)

SMOKE = dataclasses.replace(
    FULL, n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, n_heads=4, chunk=32),
    shared_attn_every=2,
)

register(FULL, SMOKE)
