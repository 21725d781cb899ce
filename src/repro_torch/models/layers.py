"""Shared building blocks: init specs, RMSNorm, RoPE, SwiGLU MLP, embeddings.

The PyTorch counterpart of ``repro.models.layers``.  Every layer exposes

* ``<layer>_specs(cfg) -> {name: ParamSpec}``   (shape + logical axes + init)
* ``<layer>(params, x, ...) -> y``              (pure apply)

as in the JAX package.  A spec tree becomes an ``nn.Module`` tree through
:func:`build_tree`: a dict of specs is a :class:`ParamModule` holding one
``nn.Parameter`` per leaf, and a :class:`StackSpec` (the JAX
scan-over-layers stack, :func:`stack_specs`) is an ``nn.ModuleList`` of
its layers.  A :class:`ParamModule` is indexed like the JAX dict
(``params["attn"]["wq"]``), so the apply functions read the same.  The
weight layouts are the JAX ones: ``x @ W`` with W as (in, out), ``wq``
(d, H, hd), ``wo`` (H, hd, d) — no ``nn.Linear`` transpose — so carrying
weights across (:mod:`repro_torch.models.convert`) is a copy.

The init rule is the reference's, quirk included: a ``normal`` leaf draws
with std = scale / sqrt(fan_in), where fan_in is the first dimension of
the leaf *as stacked*.  Under a layer stack that is the number of layers
(of groups for the doubly stacked vlm / hybrid layers), not the layer's
input width.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.kernels.common import resolve_device

__all__ = ["ParamSpec", "StackSpec", "ParamModule", "stack_specs",
           "build_tree", "abstract_tree", "logical_axes_tree",
           "rmsnorm_specs", "rmsnorm", "rope_frequencies", "apply_rope",
           "mlp_specs", "mlp", "embedding_specs", "embed", "lm_head_specs",
           "lm_head"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones
    scale: float = 1.0
    # the stacking dimensions in front of ``shape`` (outermost first), as
    # the JAX spec carries them in its own shape
    stack: tuple[int, ...] = ()

    @property
    def stacked_shape(self) -> tuple[int, ...]:
        return self.stack + self.shape

    def std(self) -> float:
        full = self.stacked_shape
        fan_in = full[0] if full else 1
        return self.scale / math.sqrt(max(fan_in, 1))

    def materialize(self, generator: torch.Generator, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
        """One layer's leaf, drawn in float32 on ``device`` and cast."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        x = torch.randn(self.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(self.std()).to(dtype)


@dataclasses.dataclass(frozen=True)
class StackSpec:
    """``n`` layers of the spec tree ``inner`` (whose leaves carry the
    stack in their ``stack``)."""
    n: int
    inner: dict


def stack_specs(specs, n: int) -> StackSpec:
    """Prepend a stacking dimension (the scan-over-layers layout; its
    logical axis is unnamed, as every JAX caller leaves it)."""
    return StackSpec(n, _prepend(specs, n))


def _prepend(tree, n: int):
    if isinstance(tree, ParamSpec):
        return dataclasses.replace(tree, stack=(n,) + tree.stack)
    if isinstance(tree, StackSpec):
        return StackSpec(tree.n, _prepend(tree.inner, n))
    return {k: _prepend(v, n) for k, v in tree.items()}


class ParamModule(nn.Module):
    """A dict of parameters and sub-trees, indexed like the JAX dict."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def build_tree(specs, make, into: ParamModule | None = None,
               path: tuple = ()) -> nn.Module:
    """The module tree of ``specs`` (filled into ``into`` when given).
    ``make(spec, path)`` gives each leaf's tensor for one layer; ``path``
    holds the dict keys and the layer indices down to the leaf, e.g.
    ``("layers", 3, "attn", "wq")``.  Leaves are made in sorted-key order,
    a stack layer by layer."""
    if isinstance(specs, StackSpec):
        return nn.ModuleList([build_tree(specs.inner, make, path=path + (i,))
                              for i in range(specs.n)])
    mod = ParamModule() if into is None else into
    for name in sorted(specs):
        sub = specs[name]
        if isinstance(sub, ParamSpec):
            mod.register_parameter(name, nn.Parameter(
                make(sub, path + (name,)), requires_grad=False))
        else:
            mod.add_module(name, build_tree(sub, make, path=path + (name,)))
    return mod


def abstract_tree(specs, dtype: torch.dtype = torch.float32):
    """Meta tensors of the stacked shapes (no allocation)."""
    if isinstance(specs, ParamSpec):
        return torch.empty(specs.stacked_shape, dtype=dtype, device="meta")
    if isinstance(specs, StackSpec):
        return abstract_tree(specs.inner, dtype)
    return {k: abstract_tree(v, dtype) for k, v in specs.items()}


def logical_axes_tree(specs):
    if isinstance(specs, ParamSpec):
        return (None,) * len(specs.stack) + specs.logical
    if isinstance(specs, StackSpec):
        return logical_axes_tree(specs.inner)
    return {k: logical_axes_tree(v) for k, v in specs.items()}


# --------------------------------------------------------------------------- #
# RMSNorm                                                                     #
# --------------------------------------------------------------------------- #
def rmsnorm_specs(d: int):
    return {"scale": ParamSpec((d,), (None,), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


# --------------------------------------------------------------------------- #
# Rotary position embeddings                                                  #
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float,
                     device: str | torch.device | None = None
                     ) -> torch.Tensor:
    """The (hd/2,) rotary frequencies; on the card unless ``device``
    says otherwise."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=resolve_device(device)) / head_dim
    return 1.0 / (theta ** exponent)                      # (hd/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S); the two halves of hd rotate
    together (split halves, not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs         # (B, S, hd/2)
    cos = torch.cos(angles)[..., None, :]                 # (B, S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# SwiGLU MLP                                                                  #
# --------------------------------------------------------------------------- #
def mlp_specs(d: int, f: int):
    return {
        "wi_gate": ParamSpec((d, f), ("embed", "mlp")),
        "wi_up": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    h = nn.functional.silu(x @ params["wi_gate"].to(dtype)) * (
        x @ params["wi_up"].to(dtype))
    return h @ params["wo"].to(dtype)


# --------------------------------------------------------------------------- #
# Embedding / LM head                                                         #
# --------------------------------------------------------------------------- #
def embedding_specs(vocab_padded: int, d: int):
    return {"table": ParamSpec((vocab_padded, d), ("vocab", "embed"),
                               scale=1.0)}


def embed(params, tokens: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    # the rows, then the cast: the same values as casting the whole table
    return params["table"][tokens].to(dtype)


def lm_head_specs(d: int, vocab_padded: int):
    return {"kernel": ParamSpec((d, vocab_padded), ("embed", "vocab"))}


def lm_head(params, x: torch.Tensor, vocab: int) -> torch.Tensor:
    """Logits in float32 (loss stability), sliced to the true vocab.  As
    in the reference, the whole head is upcast to float32 on every call."""
    logits = x.float() @ params["kernel"].float()
    if logits.shape[-1] != vocab:
        logits = logits[..., :vocab]
    return logits
