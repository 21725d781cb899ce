"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from repro_torch.configs.base import ModelConfig

def full() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b", family="dense", n_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=12800, vocab_size=49155,
        head_dim=128, rope_theta=10_000_000.0)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=2, d_ff=160, vocab_size=203, head_dim=8,
        dtype="float32", remat_policy="none")
