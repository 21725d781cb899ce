"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.configs.base import ModelConfig

def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", n_layers=32,
        d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512, vocab_size=49155,
        head_dim=64, n_experts=40, experts_per_token=8,
        rope_theta=10_000_000.0)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke", family="moe", n_layers=2,
        d_model=48, n_heads=6, n_kv_heads=2, d_ff=32, vocab_size=160,
        head_dim=8, n_experts=5, experts_per_token=2, dtype="float32",
        remat_policy="none")
