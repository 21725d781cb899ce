"""Carry a model's parameters and decode cache across from numpy arrays.

:func:`params_from_numpy` takes the JAX package's parameter tree as numpy
arrays — ``repro.models.init_params(cfg, key)`` through ``np.asarray``
leaf by leaf, layer stacks included — and returns the port's
:class:`~repro_torch.models.model.LanguageModel` with the same values, each
stacked leaf split over its ``nn.ModuleList``.  :func:`cache_from_numpy`
and :func:`cache_to_numpy` carry a decode cache (the dict of
``repro.models.init_cache`` / ``prefill`` / ``decode_step``) each way.
numpy has no native bfloat16: a bfloat16 array (numpy's ``ml_dtypes``
extension type, as JAX hands it out) is carried through float32, which is
exact for bfloat16 values, and :func:`cache_to_numpy` returns a bfloat16
tensor as float32 the same way.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.layers import build_tree
from repro_torch.models.model import LanguageModel, param_specs

__all__ = ["params_from_numpy", "cache_from_numpy", "cache_to_numpy"]


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # np.asarray of a JAX array is read-only: copy before from_numpy
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(cfg: ModelConfig, tree: Mapping, *,
                      device: str | torch.device | None = None
                      ) -> LanguageModel:
    """The port's model holding the values of the JAX-layout ``tree``."""
    dev = resolve_device(device)

    def make(spec, path):
        leaf = tree
        for key in (p for p in path if isinstance(p, str)):
            leaf = leaf[key]
        index = tuple(p for p in path if isinstance(p, int))
        a = np.asarray(leaf)
        if a.shape != spec.stacked_shape:
            raise ValueError(f"{'/'.join(map(str, path))}: shape {a.shape}, "
                             f"the config gives {spec.stacked_shape}")
        return _tensor(a[index] if index else a, dev)

    return build_tree(param_specs(cfg), make, into=LanguageModel(cfg))


def cache_from_numpy(tree: Mapping, *,
                     device: str | torch.device | None = None) -> dict:
    """A decode cache of numpy arrays (``len`` a 0-d int32) as tensors."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in tree.items()}


def cache_to_numpy(cache: Mapping) -> dict:
    """Copies of the cache's tensors as numpy arrays (bfloat16 as
    float32); a later decode step does not change them."""
    out = {}
    for k, v in cache.items():
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[k] = t.numpy()
    return out
