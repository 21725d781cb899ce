"""AdamW and its learning-rate schedule, the port's counterpart of
``repro.train.optimizer``.

Mixed-precision convention: the parameters are the float32 master copy
and every layer casts to the activation dtype at use, so no second weight
tree is kept.  All arithmetic is float32 on the parameters' device, with
the step count a 0-d int32 tensor there: nothing waits on the host.  The
update is applied in place, leaf by leaf, under ``torch.no_grad`` (one
leaf's temporaries at a time, not a parameter-sized tree of them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.train.tree import leaves, zeros_like

__all__ = ["OptimizerConfig", "OptState", "lr_schedule", "init_opt_state",
           "global_norm", "clip_by_global_norm", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    # gradient compression for the cross-pod reduce: none | int8_ef
    compression: str = "none"


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32 on the parameters' device
    m: Any              # trees of the parameters' structure, float32
    v: Any
    ef: Any             # error-feedback residual; {} without compression


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio`` (float32)."""
    step = torch.as_tensor(step).float()
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm,
                       cfg.learning_rate * cos)


def init_opt_state(params, compression: str = "none") -> OptState:
    """Zero moments of the parameters' structure; the error-feedback
    buffer only exists when compression is on (a whole extra
    parameter-sized tree otherwise)."""
    first = leaves(params)[0]
    ef = zeros_like(params) if compression != "none" else {}
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                    m=zeros_like(params), v=zeros_like(params), ef=ef)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    norms = torch._foreach_norm([x.float() for x in leaves(tree)])
    return torch.stack(norms).square().sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place to a global norm of at most
    ``max_norm``; returns (grads, the norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    torch._foreach_mul_(leaves(grads), scale)
    return grads, norm


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, state: OptState):
    """One AdamW step.  Returns (params, new_state, metrics).

    Updates ``params`` and the moments of ``state`` in place, and uses
    ``grads`` (float32, the parameters' structure or a list in
    :func:`~repro_torch.train.tree.leaves` order) as scratch: they are
    compressed and clipped in place."""
    from repro_torch.train.compression import compress_with_error_feedback

    g_leaves = [g.float() for g in leaves(grads)]
    if cfg.compression == "int8_ef" and not (
            isinstance(state.ef, dict) and not state.ef):
        compress_with_error_feedback(g_leaves, state.ef)
    _, grad_norm = clip_by_global_norm(g_leaves, cfg.grad_clip_norm)

    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, m, v in zip(leaves(params), g_leaves, leaves(state.m),
                          leaves(state.v), strict=True):
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        delta.add_(p.float(), alpha=cfg.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float() - delta)
    metrics = {"lr": lr, "grad_norm": grad_norm,
               "param_norm": global_norm(params)}
    return params, OptState(step, state.m, state.v, state.ef), metrics
