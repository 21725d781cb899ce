"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

The port's own copy of ``repro.configs`` (the port imports nothing of the
JAX package): the same ten architectures with their published ``full()``
widths and their ``smoke()`` cuts, field for field."""
from repro_torch.configs import (granite_3_8b, granite_moe_3b_a800m,
                                 internlm2_1_8b, llama3_2_vision_90b,
                                 llama3_8b, mamba2_2_7b, musicgen_large,
                                 olmoe_1b_7b, pagerank_5k, yi_34b,
                                 zamba2_2_7b)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      applicable_shapes)

_MODULES = {
    "yi-34b": yi_34b,
    "llama3-8b": llama3_8b,
    "internlm2-1.8b": internlm2_1_8b,
    "granite-3-8b": granite_3_8b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "olmoe-1b-7b": olmoe_1b_7b,
    "musicgen-large": musicgen_large,
    "mamba2-2.7b": mamba2_2_7b,
    "llama-3.2-vision-90b": llama3_2_vision_90b,
    "zamba2-2.7b": zamba2_2_7b,
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].full()


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].smoke()


__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig",
           "applicable_shapes", "get_config", "get_smoke_config",
           "pagerank_5k"]
