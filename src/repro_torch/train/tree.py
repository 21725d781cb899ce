"""The trees the trainer works on: a model-shaped ``nn.Module`` tree (the
parameters, and the optimizer's moments, which take its shape), a dict of
tensors, a list or tuple of tensors, or one tensor.  :func:`leaves` lists
the tensors of any of them in one order for trees of one structure, so
the optimizer zips a tree's leaves with its gradients' and its moments'.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from repro_torch.models.layers import map_tree

__all__ = ["leaves", "zeros_like"]


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``: a module's parameters in
    ``parameters()`` order, a dict's values by sorted key."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def zeros_like(tree, dtype: torch.dtype = torch.float32):
    """A tree of ``tree``'s structure holding zeros of ``dtype`` on each
    leaf's device; a module's copy is not trainable."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree, dtype=dtype)
    if isinstance(tree, nn.Module):
        return map_tree(tree, lambda path, p: torch.zeros_like(
            p, dtype=dtype, requires_grad=False), requires_grad=False)
    if isinstance(tree, Mapping):
        return {k: zeros_like(v, dtype) for k, v in tree.items()}
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")
