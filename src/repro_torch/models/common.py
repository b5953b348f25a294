"""Model/shape configuration (torch counterpart of repro/models/common.py).

Field for field the same dataclass; ``tdtype`` (a ``torch.dtype``) takes the
place of the reference's ``jdtype``."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

__all__ = ["Family", "ModelConfig"]


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    VLM = "vlm"
    AUDIO = "audio"


_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    # --- attention details
    head_dim: Optional[int] = None  # default d_model // n_heads
    qk_norm: bool = False  # qwen3
    rope_theta: float = 10000.0
    # --- FFN
    act: str = "swiglu"  # swiglu | squared_relu | gelu
    # --- MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "a2a"
    # --- SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0
    # --- enc-dec (whisper)
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500
    # --- vlm
    n_vision_tokens: int = 0
    # --- numerics / serving
    pad_vocab_to: int = 1
    kv_quant: bool = False
    dtype: str = "bfloat16"
    quant_mode: str = "none"  # none | w4a8 (TLM) | bvq (DLM)
    # --- distribution (carried for field parity; the port runs one device)
    fsdp: bool = False
    seq_shard: bool = True
    sp_once_per_block: bool = False
    remat: bool = True
    remat_policy: str = "full"
    optim_dtype: str = "float32"
    grad_constraint: bool = False
    grad_barrier: bool = False
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def vocab_padded(self) -> int:
        m = self.pad_vocab_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def tdtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def is_encdec(self) -> bool:
        return self.family is Family.AUDIO
