"""Loss and train step: next-token cross-entropy, gradient accumulation,
metrics.  The port's counterpart of ``repro.train.train_step``.

The gradients accumulate in each parameter's ``.grad`` (float32, as the
master copy is), so no second gradient tree is held; the optimizer then
uses them as its scratch and :func:`train_step` drops them.  Remat is the
model's own (``cfg.remat_policy``, applied by ``model.forward`` while
autograd records).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         adamw_update, init_opt_state)

__all__ = ["cross_entropy", "loss_fn", "train_step", "make_train_state"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE in float32.  logits: (B, S, V); labels: (B, S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, batch, cfg: ModelConfig):
    """(loss + aux loss, metrics) of one batch."""
    logits, aux = M.forward(params, batch, cfg)
    if "labels" in batch:                      # audio stub: explicit labels
        loss = cross_entropy(logits, batch["labels"])
    else:                                      # next-token prediction
        loss = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
    total = loss + aux["aux_loss"]
    metrics = {"loss": loss, "aux_loss": aux["aux_loss"],
               "dropped_frac": aux["dropped_frac"]}
    return total, metrics


def _split_microbatches(batch, n: int) -> list[dict]:
    """``n`` microbatches of consecutive rows."""
    split = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
             for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def train_step(params: M.LanguageModel, opt_state: OptState, batch,
               cfg: ModelConfig, opt_cfg: OptimizerConfig,
               accum_steps: int = 1):
    """One optimizer step over ``accum_steps`` microbatches.  Updates
    ``params`` and the moments of ``opt_state`` in place and returns
    (params, new opt_state, metrics); the metrics are 0-d tensors on the
    device (reading one waits for the step)."""
    leaves = list(params.parameters())
    for p in leaves:
        p.grad = None
    sums = None
    for mb in _split_microbatches(batch, accum_steps):
        total, metrics = loss_fn(params, mb, cfg)
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        sums = metrics if sums is None else {k: sums[k] + metrics[k]
                                             for k in sums}
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    if accum_steps > 1:
        torch._foreach_div_(grads, accum_steps)
        sums = {k: v / accum_steps for k, v in sums.items()}
    params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
    for p in leaves:
        p.grad = None
    sums.update(opt_metrics)
    return params, opt_state, sums


def make_train_state(cfg: ModelConfig, seed: int | torch.Generator = 0,
                     compression: str = "int8_ef",
                     device: str | torch.device | None = None):
    """(float32 master parameters, opt_state) on ``device`` (the card
    unless the caller asks for the CPU): the draw of ``init_params``
    rounded to ``cfg.dtype``, then held in float32, as the JAX package's
    ``make_train_state``.  ``compression`` defaults to allocating the
    error-feedback buffer, as there; production passes the
    ``OptimizerConfig`` value."""
    params = M.init_params(cfg, seed, device, trainable=True)
    return params, init_opt_state(params, compression)
