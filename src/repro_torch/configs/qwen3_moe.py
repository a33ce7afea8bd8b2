"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-235B-A22B family]."""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig, register

FULL = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=0,
    head_dim=128, vocab=151936, attention="gqa", norm="rmsnorm", pos="rope",
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, expert_d_ff=1536),
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    vocab=256, moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=64),
)

register(FULL, SMOKE)
