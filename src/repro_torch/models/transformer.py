"""Decoder blocks per family, for the prefill/train path and for decode.

The PyTorch counterpart of ``repro.models.transformer``.  The decode
blocks write the block's K / V into the cache views they are given (see
:func:`repro_torch.models.attention.decode_attention`).
:func:`remat_wrap` is the training path's rematerialisation: activation
checkpointing around a block (or a group of blocks) while autograd
records.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ParamSpec, mlp, mlp_specs, rmsnorm,
                                       rmsnorm_specs)
from repro_torch.sharding.partition import (current_mesh, current_rules,
                                            use_mesh)

__all__ = ["block_specs", "cross_block_specs", "shared_block_specs",
           "dense_block", "moe_block", "ssm_block", "cross_block",
           "shared_block", "dense_block_decode", "moe_block_decode",
           "ssm_block_decode", "cross_block_decode", "shared_block_decode",
           "remat_wrap"]


# --------------------------------------------------------------------------- #
# Per-family block specs                                                      #
# --------------------------------------------------------------------------- #
def block_specs(cfg: ModelConfig) -> dict:
    if cfg.family in ("dense", "audio", "vlm"):
        # vlm: the self-attention block; cross blocks are stacked apart
        return {
            "ln1": rmsnorm_specs(cfg.d_model),
            "attn": attn.attention_specs(cfg),
            "ln2": rmsnorm_specs(cfg.d_model),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff),
        }
    if cfg.family == "moe":
        return {
            "ln1": rmsnorm_specs(cfg.d_model),
            "attn": attn.attention_specs(cfg),
            "ln2": rmsnorm_specs(cfg.d_model),
            "moe": moe_mod.moe_specs(cfg),
        }
    if cfg.family in ("ssm", "hybrid"):
        return {
            "ln1": rmsnorm_specs(cfg.d_model),
            "ssm": ssm_mod.ssm_specs(cfg),
        }
    raise ValueError(cfg.family)


def cross_block_specs(cfg: ModelConfig) -> dict:
    return {
        "ln": rmsnorm_specs(cfg.d_model),
        "attn": attn.attention_specs(cfg),
        "gate": ParamSpec((1,), (None,), init="zeros"),
    }


def shared_block_specs(cfg: ModelConfig) -> dict:
    """zamba2's weight-tied attention+MLP block (+ the 2D -> D in-proj that
    folds in the residual-stream/original-embedding concat)."""
    return {
        "in_proj": ParamSpec((2 * cfg.d_model, cfg.d_model),
                             ("embed", None)),
        "ln1": rmsnorm_specs(cfg.d_model),
        "attn": attn.attention_specs(cfg),
        "ln2": rmsnorm_specs(cfg.d_model),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff),
        "gate": ParamSpec((1,), (None,), init="zeros"),
    }


# --------------------------------------------------------------------------- #
# Train / prefill blocks                                                      #
# --------------------------------------------------------------------------- #
def dense_block(params, x, cfg: ModelConfig, positions):
    h = x + attn.self_attention(params["attn"],
                                rmsnorm(params["ln1"], x, cfg.norm_eps),
                                cfg, positions)
    return h + mlp(params["mlp"], rmsnorm(params["ln2"], h, cfg.norm_eps))


def moe_block(params, x, cfg: ModelConfig, positions):
    h = x + attn.self_attention(params["attn"],
                                rmsnorm(params["ln1"], x, cfg.norm_eps),
                                cfg, positions)
    y, aux = moe_mod.moe(params["moe"],
                         rmsnorm(params["ln2"], h, cfg.norm_eps), cfg)
    return h + y, aux


def ssm_block(params, x, cfg: ModelConfig):
    return x + ssm_mod.ssm_block(params["ssm"],
                                 rmsnorm(params["ln1"], x, cfg.norm_eps),
                                 cfg)


def cross_block(params, x, vision_kv, cfg: ModelConfig):
    y = attn.cross_attention(params["attn"],
                             rmsnorm(params["ln"], x, cfg.norm_eps),
                             vision_kv, cfg)
    return x + torch.tanh(params["gate"].to(x.dtype)) * y


def shared_block(params, x, x0, cfg: ModelConfig, positions):
    """zamba2 shared block: concat(current, original embedding) -> D."""
    cat = torch.cat([x, x0], dim=-1)
    h = cat @ params["in_proj"].to(x.dtype)
    h = h + attn.self_attention(params["attn"],
                                rmsnorm(params["ln1"], h, cfg.norm_eps),
                                cfg, positions)
    h = h + mlp(params["mlp"], rmsnorm(params["ln2"], h, cfg.norm_eps))
    return x + torch.tanh(params["gate"].to(x.dtype)) * h


# --------------------------------------------------------------------------- #
# Decode blocks (single token, cached)                                        #
# --------------------------------------------------------------------------- #
def dense_block_decode(params, x, ck, cv, clen, cfg: ModelConfig):
    y, ck, cv = attn.decode_attention(
        params["attn"], rmsnorm(params["ln1"], x, cfg.norm_eps),
        ck, cv, clen, cfg)
    h = x + y
    h = h + mlp(params["mlp"], rmsnorm(params["ln2"], h, cfg.norm_eps))
    return h, ck, cv


def moe_block_decode(params, x, ck, cv, clen, cfg: ModelConfig):
    y, ck, cv = attn.decode_attention(
        params["attn"], rmsnorm(params["ln1"], x, cfg.norm_eps),
        ck, cv, clen, cfg)
    h = x + y
    y2, _ = moe_mod.moe(params["moe"],
                        rmsnorm(params["ln2"], h, cfg.norm_eps), cfg)
    return h + y2, ck, cv


def ssm_block_decode(params, x, state, cfg: ModelConfig):
    y, state = ssm_mod.ssm_decode_step(
        params["ssm"], rmsnorm(params["ln1"], x, cfg.norm_eps), state, cfg)
    return x + y, state


def cross_block_decode(params, x, cross_k, cross_v, cfg: ModelConfig):
    """Cross-attn at decode reuses the prefill-computed vision KV."""
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    B = x.shape[0]
    q = torch.einsum("bsd,dhk->bshk", h, params["attn"]["wq"].to(x.dtype))
    H, hd = q.shape[2], q.shape[3]
    K = cross_k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgh,btkh->bkgt", qg,
                     cross_k.float()) / math.sqrt(hd)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p, cross_v.float())
    out = out.reshape(B, 1, H, hd).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params["attn"]["wo"].to(x.dtype))
    return x + torch.tanh(params["gate"].to(x.dtype)) * y


def shared_block_decode(params, x, x0, ck, cv, clen, cfg: ModelConfig):
    cat = torch.cat([x, x0], dim=-1)
    h = cat @ params["in_proj"].to(x.dtype)
    y, ck, cv = attn.decode_attention(
        params["attn"], rmsnorm(params["ln1"], h, cfg.norm_eps),
        ck, cv, clen, cfg)
    h = h + y
    h = h + mlp(params["mlp"], rmsnorm(params["ln2"], h, cfg.norm_eps))
    return x + torch.tanh(params["gate"].to(x.dtype)) * h, ck, cv


# --------------------------------------------------------------------------- #
# Remat policy                                                                #
# --------------------------------------------------------------------------- #
def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of matrix
    products without a batch dimension (``x @ W``, and the projection
    einsums, which PyTorch runs as a ``bmm`` over a batch of one);
    recompute the rest."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _records(args) -> bool:
    """Whether autograd records a call on ``args``: grad mode on and a
    tensor, or a parameter of a module, among them that requires grad."""
    if not torch.is_grad_enabled():
        return False
    for a in args:
        if isinstance(a, torch.Tensor) and a.requires_grad:
            return True
        if isinstance(a, nn.Module) and any(
                p.requires_grad for p in a.parameters()):
            return True
    return False


def remat_wrap(fn, policy: str):
    """``fn`` under the remat policy: ``"none"`` keeps every activation;
    ``"full"`` keeps only the call's inputs and recomputes the rest in
    the backward pass; ``"dots"`` also keeps the outputs of the products
    with no batch dimension.  A call autograd does not record (serving,
    ``torch.no_grad``) runs ``fn`` as it is."""
    if policy == "none":
        return fn
    if policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_policy)
    elif policy == "full":
        context_fn = noop_context_fn
    else:
        raise ValueError(f"unknown remat policy {policy!r}")

    @functools.wraps(fn)
    def wrapped(*args):
        if not _records(args):
            return fn(*args)
        # the recompute runs inside the backward pass, which autograd runs
        # on a thread of its own for CUDA tensors: it re-enters the mesh
        # and rules the forward ran under (they are thread-local)
        mesh, rules = current_mesh(), current_rules()

        def under_mesh(*a):
            with use_mesh(mesh, rules):
                return fn(*a)
        return checkpoint(under_mesh, *args, use_reentrant=False,
                          context_fn=context_fn)
    return wrapped
