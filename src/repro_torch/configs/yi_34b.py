"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[arXiv:2403.04652; hf] — llama-arch GQA."""
from repro_torch.configs.base import ModelConfig

def full() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=20480, vocab_size=64000,
        head_dim=128, rope_theta=5_000_000.0)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=8,
        dtype="float32", remat_policy="none")
