"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 [hf:meta-llama/Llama-3.2-11B-Vision; unverified] — cross-attn
image layers every 5th layer (80 self + 20 cross = 100L).

Vision frontend is a STUB: inputs are precomputed patch embeddings
(B, 1600, 1280) per the assignment."""
from repro_torch.configs.base import ModelConfig

def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm", n_layers=100,
        d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
        vocab_size=128256, head_dim=128, cross_attn_every=5,
        n_vision_tokens=1600, vision_dim=1280, rope_theta=500_000.0)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke", family="vlm", n_layers=4,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        head_dim=16, cross_attn_every=2, n_vision_tokens=8, vision_dim=32,
        dtype="float32", remat_policy="none")
