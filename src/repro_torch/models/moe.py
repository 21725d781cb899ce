"""Mixture-of-Experts layer: top-k routing, sort-based static-capacity
dispatch.

The PyTorch counterpart of ``repro.models.moe`` on one device:

  1. top-k gating in float32 -> (T*k) (expert, prob, token) assignments,
     the k probabilities renormalised;
  2. stable sort by expert id; position-in-expert = rank within the
     segment (``searchsorted`` of the segment starts);
  3. scatter into a fixed (E*C + 1, D) buffer whose last row is the
     overflow slot (tokens beyond capacity drop — counted and returned as
     ``dropped_frac``);
  4. two grouped GEMMs over the expert axis;
  5. gather back and combine weighted by the router probs.

The combine does not scatter-add: every token has exactly k assignments,
so their contributions are gathered back through the inverse of the sort
into (T, k, D) and summed over k in a fixed order (no atomics, so repeats
are bit-identical on the card).  The Switch aux load-balance loss is
``E * sum(mean prob * top-1 fraction) * router_aux_weight``.

:func:`moe` takes the expert-parallel path (``models/moe_ep.py``)
whenever a mesh of more than one position is active, as the JAX ``moe``
does; :func:`moe_reference` is the single-device path and its oracle.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe_ep as ep
from repro_torch.models.layers import ParamSpec

__all__ = ["moe_specs", "moe", "moe_reference"]


def moe_specs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("embed", None)),
        "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "wi_up": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "mlp", "embed")),
    }


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def moe(params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) -> (y, aux) where aux = {'aux_loss', 'dropped_frac'}.
    Under a mesh with more than one position: ``moe_ep``."""
    if ep.moe_ep_applicable(cfg):
        return ep.moe_ep(params, x, cfg)
    return moe_reference(params, x, cfg)


def moe_reference(params, x: torch.Tensor, cfg: ModelConfig):
    """Sort-based dispatch with a static capacity per expert."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    C = _capacity(T, cfg)
    xt = x.reshape(T, D)
    dev = x.device

    # ---- routing (f32 for numerics) ---------------------------------- #
    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    top_p, top_e = torch.topk(probs, K, dim=-1)              # (T, K)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)          # renormalize

    # ---- aux load-balance loss (Switch eq. 4) ------------------------- #
    me = probs.mean(dim=0)                                   # (E,)
    ce = nn.functional.one_hot(top_e[:, 0], E).float().mean(dim=0)
    aux_loss = E * (me * ce).sum() * cfg.router_aux_weight

    # ---- sort-based dispatch ------------------------------------------ #
    flat_e = top_e.reshape(-1)                               # (T*K,)
    flat_p = top_p.reshape(-1)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)

    order = torch.sort(flat_e, stable=True).indices          # group by expert
    sorted_e = flat_e[order]
    sorted_tok = flat_tok[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                                   side="left")
    pos_in_e = torch.arange(T * K, device=dev) - seg_start[sorted_e]
    keep = pos_in_e < C
    dropped_frac = 1.0 - keep.float().mean()

    # scatter tokens into the (E, C, D) expert buffer; a dropped token
    # goes to the overflow row, which no expert reads
    slot = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    buf[slot] = xt[sorted_tok]
    expert_in = buf[:-1].reshape(E, C, D)

    # ---- expert computation (grouped SwiGLU GEMMs) -------------------- #
    dtype = x.dtype
    h = nn.functional.silu(torch.einsum("ecd,edf->ecf", expert_in,
                                        params["wi_gate"].to(dtype)))
    h = h * torch.einsum("ecd,edf->ecf", expert_in,
                         params["wi_up"].to(dtype))
    expert_out = torch.einsum("ecf,efd->ecd", h, params["wo"].to(dtype))

    # ---- combine ------------------------------------------------------- #
    flat_out = torch.cat([expert_out.reshape(E * C, D),
                          torch.zeros((1, D), dtype=dtype, device=dev)])
    gathered = flat_out[slot]                                # (T*K, D)
    w = torch.where(keep, flat_p[order], torch.zeros_like(flat_p))
    contrib = gathered.float() * w[:, None]
    # back to (token, k) order: the inverse of the sort
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(T * K, device=dev)
    per_tok = contrib[inverse].reshape(T, K, D)
    y = per_tok[:, 0]
    for k in range(1, K):
        y = y + per_tok[:, k]
    y = y.reshape(B, S, D).to(x.dtype)
    return y, {"aux_loss": aux_loss, "dropped_frac": dropped_frac}
