"""llava-next-mistral-7b — VLM, anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Vision tower is a STUB per the assignment: input_specs provide precomputed
1024-d CLIP patch embeddings for the anyres tiles (n_patches prefix); the
Mistral-7B decoder backbone is fully implemented.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, attention="gqa", norm="rmsnorm", pos="rope",
    rope_theta=1e6, frontend_dim=1024, n_patches=1152,
    notes="anyres tiling -> 1152-patch prefix (base 576 + tile pool), "
          "projected and prepended to the token sequence.",
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, frontend_dim=24, n_patches=8,
)

register(FULL, SMOKE)
