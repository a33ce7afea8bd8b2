"""minicpm3-4b — MLA attention [hf:openbmb/MiniCPM3-4B]."""
import dataclasses

from repro_torch.configs.base import ArchConfig, MLAConfig, register

FULL = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73448, attention="mla", norm="rmsnorm", pos="rope",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    notes="Multi-head Latent Attention: KV cache stores only the 288-d "
          "compressed latent per position — the paper-analogue "
          "small-slowly-varying exchange state.",
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8),
)

register(FULL, SMOKE)
