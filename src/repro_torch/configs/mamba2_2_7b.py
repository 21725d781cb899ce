"""mamba2-2.7b [ssm]: 64L d_model=2560 (attn-free) vocab=50280,
ssm_state=128 [arXiv:2405.21060; unverified] — SSD (state-space duality).

d_inner = 2 * d_model = 5120, headdim 64 -> 80 SSD heads."""
from repro_torch.configs.base import ModelConfig

def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=50280, head_dim=1,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=128,
        ssm_groups=1)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke", family="ssm", n_layers=2, d_model=48,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=128, head_dim=1,
        ssm_state=16, ssm_expand=2, ssm_headdim=8, ssm_chunk=8,
        ssm_groups=1, dtype="float32", remat_policy="none")
