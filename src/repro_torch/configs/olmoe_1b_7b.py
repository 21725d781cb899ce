"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ModelConfig

def full() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1024, vocab_size=50304,
        head_dim=128, n_experts=64, experts_per_token=8,
        rope_theta=10_000.0)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=48, vocab_size=192, head_dim=16,
        n_experts=8, experts_per_token=2, dtype="float32",
        remat_policy="none")
