"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 [arXiv:2411.15242; hf] — Mamba2 backbone +
weight-tied shared attention block applied every 6 layers (9 applications).

d_inner = 5120, ssm headdim 64 -> 80 SSD heads; shared block is MHA
(kv=32) with head_dim 80 and its own SwiGLU (d_ff=10240)."""
from repro_torch.configs.base import ModelConfig

def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000,
        head_dim=80, ssm_state=64, ssm_expand=2, ssm_headdim=64,
        ssm_chunk=128, ssm_groups=1, shared_attn_every=6,
        rope_theta=10_000.0)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid", n_layers=4, d_model=48,
        n_heads=4, n_kv_heads=4, d_ff=96, vocab_size=128, head_dim=12,
        ssm_state=8, ssm_expand=2, ssm_headdim=8, ssm_chunk=8,
        ssm_groups=1, shared_attn_every=2, dtype="float32",
        remat_policy="none")
