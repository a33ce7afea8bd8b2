"""Architecture registry of the port: importing this package registers the
configurations (exact published numbers plus their smoke reductions): the
dense, MoE, vision-language and audio families of the transformer block,
the ssm family (xlstm-1.3b: mLSTM and sLSTM blocks) and the hybrid one
(zamba2-1.2b: Mamba2 blocks and one shared attention block): all ten of
the reference's."""

from repro_torch.configs import (  # noqa: F401
    hubert_xlarge,
    internlm2_20b,
    llava_next_mistral_7b,
    minicpm3_4b,
    minicpm_2b,
    olmo_1b,
    phi3p5_moe,
    qwen3_moe,
    xlstm_1p3b,
    zamba2_1p2b,
)
from repro_torch.configs.base import ArchConfig, ArchSpec, get, names  # noqa: F401
