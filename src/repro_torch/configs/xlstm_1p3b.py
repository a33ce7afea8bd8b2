"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
import dataclasses

from repro_torch.configs.base import ArchConfig, XLSTMConfig, register

FULL = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, attention="none", norm="layernorm", pos="none",
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, conv_kernel=4),
    sub_quadratic=True,
    notes="48 blocks, 7:1 mLSTM:sLSTM mixing; linear-time state.",
)

SMOKE = dataclasses.replace(
    FULL, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, vocab=256,
    xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0, conv_kernel=4),
)

register(FULL, SMOKE)
