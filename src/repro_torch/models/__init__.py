"""The LM stack's models: the PyTorch counterpart of ``repro.models``."""
from repro_torch.models import model
from repro_torch.models.model import (LanguageModel, abstract_params,
                                      decode_step, forward, init_cache,
                                      init_params, param_logical_axes,
                                      prefill)

__all__ = ["model", "LanguageModel", "abstract_params", "decode_step",
           "forward", "init_cache", "init_params", "param_logical_axes",
           "prefill"]
