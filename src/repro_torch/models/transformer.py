"""Decoder blocks per family, for the prefill/train path and for decode.

The PyTorch counterpart of ``repro.models.transformer`` (its
``remat_wrap`` belongs to training and is not ported yet).  The decode
blocks write the block's K / V into the cache views they are given (see
:func:`repro_torch.models.attention.decode_attention`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ParamSpec, mlp, mlp_specs, rmsnorm,
                                       rmsnorm_specs)

__all__ = ["block_specs", "cross_block_specs", "shared_block_specs",
           "dense_block", "moe_block", "ssm_block", "cross_block",
           "shared_block", "dense_block_decode", "moe_block_decode",
           "ssm_block_decode", "cross_block_decode", "shared_block_decode"]


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
