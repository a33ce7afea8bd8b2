"""Architecture registry of the port: importing this package registers the
configurations ported so far (exact published numbers plus their smoke
reductions): the dense, MoE, vision-language and audio families of the
transformer block.  xlstm-1.3b and zamba2-1.2b wait for their families,
ssm and hybrid (ROADMAP A12)."""

from repro_torch.configs import (  # noqa: F401
    hubert_xlarge,
    internlm2_20b,
    llava_next_mistral_7b,
    minicpm3_4b,
    minicpm_2b,
    olmo_1b,
    phi3p5_moe,
    qwen3_moe,
)
from repro_torch.configs.base import ArchConfig, ArchSpec, get, names  # noqa: F401
