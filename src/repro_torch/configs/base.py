"""Architecture configuration system (a copy of ``repro/configs/base.py``:
the port imports nothing of the JAX package).

One ``ArchConfig`` per assigned architecture (exact published numbers) plus a
``smoke()`` reduction of the same family for CPU tests.  Block composition is
expressed as a pattern over block kinds so dense, MoE, SSM, hybrid and
encoder-only families all lower through the same assembly code.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    n_heads: int = 32          # SSD heads
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8        # every k-th block is sLSTM, rest mLSTM
    proj_factor: float = 2.0    # mLSTM up-projection
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    attention: str = "gqa"      # gqa | mla | none
    causal: bool = True
    norm: str = "rmsnorm"       # rmsnorm | layernorm | nonparametric_ln
    pos: str = "rope"           # rope | learned | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (zamba2): one shared attention block applied every k SSM blocks
    shared_attn_every: int = 0
    # modality frontend stubs (audio/vlm): precomputed embedding dim
    frontend_dim: int = 0
    n_patches: int = 0          # vlm: image-patch prefix length
    sub_quadratic: bool = False # may run long_500k
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding/head shard
        cleanly over any mesh axis (standard production padding; the extra
        logit columns are masked to -inf in the loss)."""
        return ((self.vocab + 255) // 256) * 256

    # -- parameter count (for MODEL_FLOPS = 6*N*D) ----------------------
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        n = 0
        # embeddings (+ untied head)
        n += v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attention == "gqa":
            per_layer += d * self.n_heads * hd          # q
            per_layer += 2 * d * self.n_kv_heads * hd   # k, v
            per_layer += self.n_heads * hd * d          # o
        elif self.attention == "mla":
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_hd
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        if self.moe is not None:
            e = self.moe.n_experts if not active_only else self.moe.top_k
            per_layer += d * self.moe.n_experts          # router
            per_layer += e * 3 * d * self.moe.expert_d_ff
        elif self.family in ("ssm",) and self.xlstm is not None:
            di = int(self.d_model * self.xlstm.proj_factor)
            per_layer += 2 * d * di + di * d + 3 * di * (di // 64)  # coarse
        elif self.family in ("ssm", "hybrid") and self.ssm is not None:
            di = self.ssm.expand * d
            per_layer += d * 2 * di + di * d + di * self.ssm.d_conv
            per_layer += di * 2 * self.ssm.d_state
        if f:
            per_layer += 3 * d * f                       # swiglu (or 2*d*f gelu)
        n += self.n_layers * per_layer
        return n

    def model_flops_per_token(self) -> float:
        """6*N (dense) or 6*N_active (MoE) — multiplied by tokens D later."""
        return 6.0 * self.param_count(active_only=self.moe is not None)


# Registry ------------------------------------------------------------------

_REGISTRY: Dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    full: ArchConfig
    smoke: ArchConfig


def register(full: ArchConfig, smoke: ArchConfig) -> ArchSpec:
    spec = ArchSpec(full=full, smoke=smoke)
    _REGISTRY[full.name] = spec
    return spec


def get(name: str) -> ArchSpec:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401 — registers the ported configs
    return _REGISTRY[name]


def names() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401
    return tuple(sorted(_REGISTRY))
