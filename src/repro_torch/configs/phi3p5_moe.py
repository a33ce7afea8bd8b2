"""phi3.5-moe-42b-a6.6b — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig, register

FULL = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=0,
    vocab=32064, attention="gqa", norm="layernorm", pos="rope",
    moe=MoEConfig(n_experts=16, top_k=2, expert_d_ff=6400),
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab=256,
    moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=96),
)

register(FULL, SMOKE)
