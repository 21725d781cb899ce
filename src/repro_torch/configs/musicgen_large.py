"""musicgen-large [audio]: 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

Backbone only: the EnCodec frontend is a STUB; inputs are precomputed frame
embeddings (B, S, d_model) per the assignment."""
from repro_torch.configs.base import ModelConfig

def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=2048,
        head_dim=64, embed_input=False, rope_theta=10_000.0)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64, head_dim=16,
        embed_input=False, dtype="float32", remat_policy="none")
