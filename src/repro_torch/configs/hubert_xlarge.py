"""hubert-xlarge — encoder-only audio backbone [arXiv:2106.07447].

The conv feature extractor is a STUB per the assignment: input_specs provide
precomputed 512-d frame embeddings; the backbone (48L transformer encoder)
is fully implemented.  Encoder-only => no decode shapes.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab=504, attention="gqa", causal=False, norm="layernorm", pos="rope",
    frontend_dim=512,
    notes="Bidirectional encoder; masked-unit prediction head (504 units). "
          "Conv frontend stubbed with precomputed frame embeddings.",
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=64, frontend_dim=16,
)

register(FULL, SMOKE)
