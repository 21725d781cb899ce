"""Model/config dataclasses + the input-shape registry for all assigned cells."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free families
    n_kv_heads: int
    d_ff: int                   # per-expert width for MoE
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid (zamba2): one weight-tied attention block every k layers
    shared_attn_every: int = 0

    # vlm (llama-3.2-vision): cross-attention layer every k layers
    cross_attn_every: int = 0
    n_vision_tokens: int = 0
    vision_dim: int = 0

    # audio (musicgen): frontend stubbed -> inputs are frame embeddings
    embed_input: bool = True    # False: model consumes (B, S, d_model) floats

    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat_policy: str = "full"  # full | dots | none
    scan_layers: bool = True
    logical_group: int = 1      # layers per scan group (vlm/hybrid patterns)

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    # ---------------- derived sizes ---------------- #
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the vocab axis shards evenly
        on any power-of-two mesh (Megatron/MaxText practice).  Logits are
        sliced back to ``vocab_size`` — padding never leaks out."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def d_inner(self) -> int:           # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def attends(self) -> bool:
        return self.n_heads > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid families)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytical parameter count (used for roofline MODEL_FLOPS)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        total = V * D                                   # embed
        if not (self.family == "audio" and not self.embed_input):
            pass
        total += D * V                                  # lm head (untied)
        hd = self.head_dim
        attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd \
            + self.n_heads * hd * D if self.attends else 0
        mlp_dense = 3 * D * F                           # SwiGLU
        if self.family == "moe":
            mlp = self.n_experts * 3 * D * F + D * self.n_experts
        else:
            mlp = mlp_dense if F else 0
        ssm = 0
        if self.ssm_state:
            din, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            conv_dim = din + 2 * self.ssm_groups * N
            ssm = (D * (2 * din + 2 * self.ssm_groups * N + H)   # in_proj
                   + conv_dim * self.ssm_conv                     # conv
                   + 3 * H                                        # A, D, dt_bias
                   + din                                          # gated norm
                   + din * D)                                     # out_proj
        if self.family == "ssm":
            per_layer = ssm + D                        # + norm
        elif self.family == "hybrid":
            per_layer = ssm + D
        else:
            per_layer = attn + mlp + 2 * D
        total += L * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            # one weight-tied attention+mlp block (+ the 2D->D in-proj)
            total += attn + mlp_dense + 2 * D + 2 * D * D
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (attn + 2 * D) + self.vision_dim * D
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE uses top-k of the experts)."""
        if self.family != "moe":
            return self.param_count()
        D, F = self.d_model, self.d_ff
        inactive = (self.n_experts - self.experts_per_token) * 3 * D * F
        return int(self.param_count() - self.n_layers * inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """The assignment's applicability rules (DESIGN.md §4)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names
