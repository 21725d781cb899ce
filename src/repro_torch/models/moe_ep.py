"""Expert-parallel MoE over the mesh: the counterpart of
``repro.models.moe_ep``, the path the JAX ``moe`` takes under a mesh.

The dataflow is the JAX one, written per mesh position (one process
drives the mesh, as ``core/fabric_matvec.py`` sets out):

  * tokens stay local to their ``data`` shard (replicated over
    ``model``), so routing is computed once per data shard and every
    model position sees the same assignment;
  * every position keeps, of its local tokens' assignments, those
    addressed to ITS experts (experts sharded over ``model``): no
    dispatch communication;
  * under the training rules the expert weights are FSDP-sharded over
    ``data`` on the d_model axis and all-gathered per layer
    (:func:`~repro_torch.core.fabric_matvec.all_gather`); autograd's
    backward of the gather sums each shard's gradient back;
  * combine = a local combine into the (T_loc, D) buffer, then one
    ``psum`` over ``model``; the aux loss and the dropped fraction are
    means over the data shards of per-shard values (JAX's ``pmean``).

The collectives add in mesh order and are counted in
``fabric_matvec.collectives``.  The local combine gathers each token's k
contributions back through the inverse of the sort and sums them over k
in order, as :func:`~repro_torch.models.moe.moe_reference` does (no
scatter-add, so repeats are bit-identical on the card).  The output is
the global (B, S, D) tensor on the mesh's home device (position 0's), and
the whole layer is differentiable through autograd.

Two differences from ``moe_reference`` are the JAX package's own: the
capacity comes from each data shard's ``T_loc`` rounded *down* to a
multiple of 8 (the reference rounds the global count up), and the aux
loss is the mean over data shards of ``E * sum(me * ce)`` per shard, not
the product of global means.  ``n_experts`` not divisible by the model
axis is padded (``padded_experts``): the dummy experts get -inf router
logits and are never selected.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fabric_matvec import (P, ShardedTensor, all_gather,
                                            psum, shard_map)
from repro_torch.sharding.partition import current_mesh, current_rules

__all__ = ["padded_experts", "moe_ep", "moe_ep_applicable"]


def _data_axes(rules) -> tuple[str, ...]:
    r = rules.get("batch", "data")
    return r if isinstance(r, tuple) else (r,)


def _fsdp_axes(rules) -> tuple[str, ...]:
    r = rules.get("embed", None)
    if r is None:
        return ()
    return r if isinstance(r, tuple) else (r,)


def padded_experts(cfg: ModelConfig, n_model: int) -> int:
    e = cfg.n_experts
    return (e + n_model - 1) // n_model * n_model


def _local(x_blk, router, wig, wiu, won, m_idx, *, cfg: ModelConfig,
           E_pad: int, E_loc: int, C: int):
    """One mesh position: route its data shard's tokens ``x_blk``, run
    the position's ``E_loc`` experts on those addressed to them.  Returns
    the position's float32 partial output (T_loc, D), its data shard's
    aux loss and dropped fraction."""
    dtype, dev = x_blk.dtype, x_blk.device
    D = x_blk.shape[-1]
    xt = x_blk.reshape(-1, D)                       # (T_loc, D)
    T_loc = xt.shape[0]
    K = cfg.experts_per_token

    # ---- routing (replicated over model) ------------------------------ #
    logits = xt.float() @ router.float()
    logits = torch.where(torch.arange(E_pad, device=dev) < cfg.n_experts,
                         logits, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    me = probs.mean(dim=0)
    ce = nn.functional.one_hot(top_e[:, 0], E_pad).float().mean(dim=0)
    aux = cfg.n_experts * (me * ce).sum() * cfg.router_aux_weight

    # ---- select the assignments addressed to MY experts --------------- #
    flat_e = top_e.reshape(-1)
    flat_p = top_p.reshape(-1)
    flat_tok = torch.arange(T_loc, device=dev).repeat_interleave(K)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    sorted_tok = flat_tok[order]
    seg_start = torch.searchsorted(sorted_e,
                                   torch.arange(E_pad, device=dev),
                                   side="left")
    pos_in_e = torch.arange(T_loc * K, device=dev) - seg_start[sorted_e]
    local_e = sorted_e - m_idx * E_loc
    kept = pos_in_e < C
    mine = (local_e >= 0) & (local_e < E_loc) & kept
    dropped = 1.0 - kept.float().mean()

    slot = torch.where(mine, local_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E_loc * C))
    buf = torch.zeros((E_loc * C + 1, D), dtype=dtype, device=dev)
    buf[slot] = xt[sorted_tok]
    expert_in = buf[:-1].reshape(E_loc, C, D)

    # ---- my experts' SwiGLU.  The JAX body slices E_loc experts at
    # m_idx * E_loc out of its block with dynamic_slice_in_dim, which
    # clamps the start to 0 on a block of E_loc: the block itself ------- #
    h = nn.functional.silu(torch.einsum("ecd,edf->ecf", expert_in,
                                        wig.to(dtype)))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, wiu.to(dtype))
    expert_out = torch.einsum("ecf,efd->ecd", h, won.to(dtype))

    # ---- local combine: back to (token, k) order, summed over k ------- #
    flat_out = torch.cat([expert_out.reshape(E_loc * C, D),
                          torch.zeros((1, D), dtype=dtype, device=dev)])
    w = torch.where(mine, flat_p[order], torch.zeros_like(flat_p))
    contrib = flat_out[slot].float() * w[:, None]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(T_loc * K, device=dev)
    per_tok = contrib[inverse].reshape(T_loc, K, D)
    y = per_tok[:, 0]
    for k in range(1, K):
        y = y + per_tok[:, k]
    return y, aux, dropped


def _pad_experts(w: torch.Tensor, e_pad: int, dim: int) -> torch.Tensor:
    if w.shape[dim] == e_pad:
        return w
    pad = list(w.shape)
    pad[dim] = e_pad - w.shape[dim]
    return torch.cat([w, w.new_zeros(pad)], dim=dim)


def moe_ep(params, x: torch.Tensor, cfg: ModelConfig):
    """Drop-in for ``moe.moe`` when a mesh with a model axis is active.
    x: (B, S, D) -> (y, aux).  Raises ``ValueError`` when B * S does not
    split over the data axes (the JAX ``shard_map`` raises too)."""
    mesh = current_mesh()
    rules = current_rules()
    n_model = mesh.shape["model"]
    dp = _data_axes(rules)
    fsdp = _fsdp_axes(rules)
    fsdp_part = fsdp if fsdp else None
    E_pad = padded_experts(cfg, n_model)
    K = cfg.experts_per_token

    B, S, D = x.shape
    dp_size = math.prod(mesh.shape[a] for a in dp)
    T_loc = B * S // dp_size
    C = max(8, int(T_loc * K * cfg.capacity_factor / cfg.n_experts)
            // 8 * 8)
    E_loc = E_pad // n_model

    def place(w, spec):
        return ShardedTensor.from_global(w, mesh, spec)

    xs = place(x, P(dp, None, None))                  # tokens over data
    router = place(_pad_experts(params["router"], E_pad, 1),
                   P(fsdp_part, None))
    wig = place(_pad_experts(params["wi_gate"], E_pad, 0),
                P("model", fsdp_part, None))          # EP + FSDP
    wiu = place(_pad_experts(params["wi_up"], E_pad, 0),
                P("model", fsdp_part, None))
    wo = place(_pad_experts(params["wo"], E_pad, 0),
               P("model", None, fsdp_part))           # FSDP on D out
    if fsdp:
        # the FSDP all-gather of this layer's expert weights (training
        # rules); the inference rules keep them stationary
        router = all_gather(router, mesh, fsdp, dim=0)
        wig = all_gather(wig, mesh, fsdp, dim=1)
        wiu = all_gather(wiu, mesh, fsdp, dim=1)
        wo = all_gather(wo, mesh, fsdp, dim=2)
    # the port's shard_map has no axis_index: each position's model
    # coordinate goes in as a per-position argument
    m_idx = [mesh.coords(p)["model"] for p in range(mesh.size)]

    out = shard_map(lambda *a: _local(*a, cfg=cfg, E_pad=E_pad,
                                      E_loc=E_loc, C=C),
                    mesh, xs, router, wig, wiu, wo, m_idx)
    y = psum([o[0] for o in out], mesh, "model")
    aux = psum([o[1] for o in out], mesh, dp)[0] / dp_size
    dropped = psum([o[2] for o in out], mesh, dp)[0] / dp_size

    # the global (B, S, D): each data shard's block once, in order
    blocks = {}
    for p, t in enumerate(y):
        blocks.setdefault(xs.ranges(p)[0], t)
    home = mesh.device_list[0]
    y = torch.cat([blocks[r].to(home) for r in sorted(blocks)])
    return (y.reshape(B, S, D).to(x.dtype),
            {"aux_loss": aux.to(home), "dropped_frac": dropped.to(home)})


def moe_ep_applicable(cfg: ModelConfig) -> bool:
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return False
    rules = current_rules()
    dp_size = 1
    for a in _data_axes(rules):
        dp_size = dp_size * mesh.shape.get(a, 1)
    return dp_size > 1 or mesh.shape["model"] > 1
