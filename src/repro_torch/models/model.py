"""Full language-model assembly: parameter tree, train/prefill forward,
cached single-token decode — for all six architecture families.

The PyTorch counterpart of ``repro.models.model``.  The parameters are an
``nn.Module`` tree (:class:`LanguageModel`) whose layer stacks are
``nn.ModuleList``\\ s, walked by Python loops where the JAX package scans.
Families with interleaved heterogeneous blocks nest them as the JAX
stacks do:

* ``vlm``    — ``layers[g][j]``: groups of (cross_attn_every - 1) self
               blocks, and ``cross[g]`` one cross block per group;
* ``hybrid`` — ``layers[g][j]``: groups of ``shared_attn_every`` Mamba2
               blocks, each group followed by the weight-tied ``shared``
               attention block (zamba2 pattern).

Public entry points, with the JAX names and arguments:

* :func:`forward`      — train/prefill logits (+ MoE aux losses)
* :func:`prefill`      — last-position logits + populated decode cache
* :func:`decode_step`  — one token for the whole batch; writes the cache
* :func:`init_cache`   — a zeroed cache for a given batch / length

The decode cache is a dict laid out as the JAX one (layer-stacked
tensors, ``len`` a 0-d int32 tensor on the cache's device).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (ParamModule, ParamSpec, abstract_tree,
                                       build_tree, embed, embedding_specs,
                                       lm_head, lm_head_specs,
                                       logical_axes_tree, mlp, rmsnorm,
                                       rmsnorm_specs, stack_specs)

__all__ = ["DTYPES", "activation_dtype", "LanguageModel", "n_groups",
           "param_specs", "init_params", "abstract_params",
           "param_logical_axes", "forward", "init_cache",
           "cache_logical_axes", "prefill", "decode_step"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def activation_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# --------------------------------------------------------------------------- #
# Parameter tree                                                              #
# --------------------------------------------------------------------------- #
def n_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(number of scan groups, self/mamba layers per group)."""
    if cfg.family == "vlm":
        g = cfg.n_layers // cfg.cross_attn_every
        return g, cfg.cross_attn_every - 1
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.shared_attn_every
        return g, cfg.shared_attn_every
    return cfg.n_layers, 1


def param_specs(cfg: ModelConfig) -> dict:
    specs: dict[str, Any] = {}
    if cfg.embed_input:
        specs["embed"] = embedding_specs(cfg.padded_vocab, cfg.d_model)
    block = tfm.block_specs(cfg)
    if cfg.family == "vlm":
        g, per = n_groups(cfg)
        specs["layers"] = stack_specs(stack_specs(block, per), g)
        specs["cross"] = stack_specs(tfm.cross_block_specs(cfg), g)
        specs["vision_proj"] = ParamSpec((cfg.vision_dim, cfg.d_model),
                                         (None, "embed"))
    elif cfg.family == "hybrid":
        g, per = n_groups(cfg)
        specs["layers"] = stack_specs(stack_specs(block, per), g)
        specs["shared"] = tfm.shared_block_specs(cfg)
    else:
        specs["layers"] = stack_specs(block, cfg.n_layers)
    specs["final_ln"] = rmsnorm_specs(cfg.d_model)
    specs["head"] = lm_head_specs(cfg.d_model, cfg.padded_vocab)
    return specs


class LanguageModel(ParamModule):
    """The parameter tree of one config; calling it runs :func:`forward`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def empty_like(self) -> "LanguageModel":
        return LanguageModel(self.cfg)

    @property
    def device(self) -> torch.device:
        return self.final_ln.scale.device

    def forward(self, batch: dict):
        return forward(self, batch, self.cfg)


def init_params(cfg: ModelConfig, seed: int | torch.Generator = 0,
                device: str | torch.device | None = None, *,
                trainable: bool = False) -> LanguageModel:
    """Random parameters drawn on ``device`` (the card unless the caller
    asks for the CPU) from ``seed`` or a ``torch.Generator`` on that
    device, one layer's leaf at a time: nothing is made on the host, and
    no stack is ever held in float32.  The distribution is the JAX
    package's (std = scale / sqrt(stacked fan-in)); the draws are not.

    ``trainable`` gives the training master copy, as the JAX
    ``make_train_state`` makes it: each leaf is the draw rounded to
    ``cfg.dtype`` and then held in float32, with ``requires_grad``."""
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
        if gen.device.type != dev.type:
            raise ValueError(f"the generator lies on {gen.device}, the "
                             f"parameters on {dev}")
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = DTYPES[cfg.dtype]

    def make(spec, path):
        leaf = spec.materialize(gen, dtype, dev)
        return leaf.float() if trainable else leaf

    return build_tree(param_specs(cfg), make, into=LanguageModel(cfg),
                      requires_grad=trainable)


def abstract_params(cfg: ModelConfig) -> dict:
    """The JAX-layout tree (stacks as leading dims) of meta tensors."""
    return abstract_tree(param_specs(cfg), DTYPES[cfg.dtype])


def param_logical_axes(cfg: ModelConfig) -> dict:
    return logical_axes_tree(param_specs(cfg))


# --------------------------------------------------------------------------- #
# Forward (train / prefill-without-cache)                                     #
# --------------------------------------------------------------------------- #
def _embed_inputs(params, batch, cfg: ModelConfig):
    dtype = DTYPES[cfg.dtype]
    if cfg.embed_input:
        x = embed(params["embed"], batch["tokens"], dtype)
        B, S = batch["tokens"].shape
    else:                                   # audio: stubbed frontend
        x = batch["embeds"].to(dtype)
        B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions


def _vision_kv(params, batch, cfg: ModelConfig):
    dtype = DTYPES[cfg.dtype]
    return batch["vision_embeds"].to(dtype) @ params["vision_proj"].to(dtype)


def forward(params, batch, cfg: ModelConfig):
    """Returns (logits, aux) — aux carries MoE losses (zeros otherwise).
    While autograd records, each block (each group of blocks for the
    vlm / hybrid families, as the JAX package wraps its scan bodies) runs
    under ``cfg.remat_policy`` (:func:`transformer.remat_wrap`)."""
    x, positions = _embed_inputs(params, batch, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"aux_loss": zero, "dropped_frac": zero}

    def remat(fn):
        return tfm.remat_wrap(fn, cfg.remat_policy)

    if cfg.family in ("dense", "audio"):
        block = remat(tfm.dense_block)
        for layer in params["layers"]:
            x = block(layer, x, cfg, positions)

    elif cfg.family == "moe":
        block = remat(tfm.moe_block)
        aux_sum, dropped = zero, []
        for layer in params["layers"]:
            x, a = block(layer, x, cfg, positions)
            aux_sum = aux_sum + a["aux_loss"]
            dropped.append(a["dropped_frac"])
        aux = {"aux_loss": aux_sum,
               "dropped_frac": torch.stack(dropped).mean()}

    elif cfg.family == "ssm":
        block = remat(tfm.ssm_block)
        for layer in params["layers"]:
            x = block(layer, x, cfg)

    elif cfg.family == "hybrid":
        def hybrid_group(layers, shared, h, x0):
            for layer in layers:
                h = tfm.ssm_block(layer, h, cfg)
            return tfm.shared_block(shared, h, x0, cfg, positions)

        group = remat(hybrid_group)
        x0 = x
        for layers in params["layers"]:
            x = group(layers, params["shared"], x, x0)

    elif cfg.family == "vlm":
        def vlm_group(layers, cross, h, vision_kv):
            for layer in layers:
                h = tfm.dense_block(layer, h, cfg, positions)
            return tfm.cross_block(cross, h, vision_kv, cfg)

        group = remat(vlm_group)
        vision_kv = _vision_kv(params, batch, cfg)
        for layers, cross in zip(params["layers"], params["cross"]):
            x = group(layers, cross, x, vision_kv)
    else:
        raise ValueError(cfg.family)

    x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
    return lm_head(params["head"], x, cfg.vocab_size), aux


# --------------------------------------------------------------------------- #
# Decode cache                                                                #
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    kvd = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    f32 = torch.float32

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    cache: dict[str, Any] = {"len": zeros((), torch.int32)}
    g, per = n_groups(cfg)
    if cfg.family in ("dense", "moe", "audio"):
        cache["k"] = zeros((cfg.n_layers,) + kvd)
        cache["v"] = zeros((cfg.n_layers,) + kvd)
    elif cfg.family == "ssm":
        s, c = ssm_mod.ssm_decode_init(cfg, batch, device="meta")
        cache["ssm"] = zeros((cfg.n_layers,) + s.shape, f32)
        cache["conv"] = zeros((cfg.n_layers,) + c.shape, f32)
    elif cfg.family == "hybrid":
        s, c = ssm_mod.ssm_decode_init(cfg, batch, device="meta")
        cache["ssm"] = zeros((g, per) + s.shape, f32)
        cache["conv"] = zeros((g, per) + c.shape, f32)
        cache["k"] = zeros((g,) + kvd)
        cache["v"] = zeros((g,) + kvd)
    elif cfg.family == "vlm":
        cache["k"] = zeros((g, per) + kvd)
        cache["v"] = zeros((g, per) + kvd)
        vdim = (batch, cfg.n_vision_tokens, cfg.n_kv_heads, cfg.head_dim)
        cache["cross_k"] = zeros((g,) + vdim)
        cache["cross_v"] = zeros((g,) + vdim)
    return cache


def cache_logical_axes(cfg: ModelConfig) -> dict:
    """Logical sharding for the cache (batch over data, kv heads over
    model), as the JAX package names it."""
    ax: dict[str, Any] = {"len": ()}
    kv = (None, "batch", "kv_seq", "kv_heads", None)
    if cfg.family in ("dense", "moe", "audio"):
        ax["k"] = kv
        ax["v"] = kv
    elif cfg.family == "ssm":
        ax["ssm"] = (None, "batch", "ssm_heads", None, None)
        ax["conv"] = (None, "batch", None, "ssm_inner")
    elif cfg.family == "hybrid":
        ax["ssm"] = (None, None, "batch", "ssm_heads", None, None)
        ax["conv"] = (None, None, "batch", None, "ssm_inner")
        ax["k"] = kv
        ax["v"] = kv
    elif cfg.family == "vlm":
        ax["k"] = (None,) + kv
        ax["v"] = (None,) + kv
        ax["cross_k"] = (None, "batch", "vision_seq", "kv_heads", None)
        ax["cross_v"] = (None, "batch", "vision_seq", "kv_heads", None)
    return ax


# --------------------------------------------------------------------------- #
# Prefill (populate cache) and decode                                         #
# --------------------------------------------------------------------------- #
def _prefill_attn_block(layer, h, cfg: ModelConfig, positions, ck, cv):
    """A self-attention block over the prompt; its K / V go into the
    first S positions of the cache views ``ck`` / ``cv``."""
    y, k, v = attn_mod.prefill_attention(
        layer["attn"], rmsnorm(layer["ln1"], h, cfg.norm_eps), cfg, positions)
    S = k.shape[1]
    ck[:, :S] = k
    cv[:, :S] = v
    h = h + y
    hn = rmsnorm(layer["ln2"], h, cfg.norm_eps)
    if "moe" in layer:
        return h + moe_mod.moe(layer["moe"], hn, cfg)[0]
    return h + mlp(layer["mlp"], hn)


def _ssm_prefill_block(layer, h, cfg: ModelConfig):
    y, state = ssm_mod.ssm_prefill(
        layer["ssm"], rmsnorm(layer["ln1"], h, cfg.norm_eps), cfg)
    return h + y, state


def prefill(params, batch, cfg: ModelConfig, max_len: int):
    """Run the prompt, return (last-position logits, populated cache).
    K / V are zero past the prompt, up to ``max_len``."""
    x, positions = _embed_inputs(params, batch, cfg)
    B, S = positions.shape
    if S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"{max_len}")
    cache = init_cache(cfg, B, max_len, device=x.device)

    if cfg.family in ("dense", "moe", "audio"):
        for i, layer in enumerate(params["layers"]):
            x = _prefill_attn_block(layer, x, cfg, positions,
                                    cache["k"][i], cache["v"][i])

    elif cfg.family == "ssm":
        states = []
        for layer in params["layers"]:
            x, st = _ssm_prefill_block(layer, x, cfg)
            states.append(st)
        # stacked, not copied into the zeroed carry: a short conv window
        # (a prompt under ssm_conv - 1 tokens) stays short, as in the JAX
        # cache, and the first decode step fails on it
        cache["ssm"] = torch.stack([s for s, _ in states])
        cache["conv"] = torch.stack([c for _, c in states])

    elif cfg.family == "hybrid":
        x0 = x
        shared = params["shared"]
        states = []
        for gi, group in enumerate(params["layers"]):
            group_states = []
            for layer in group:
                x, st = _ssm_prefill_block(layer, x, cfg)
                group_states.append(st)
            states.append(group_states)
            # the shared block, with its own KV cache entry per group
            hh = torch.cat([x, x0], dim=-1) @ shared["in_proj"].to(x.dtype)
            hh = _prefill_attn_block(shared, hh, cfg, positions,
                                     cache["k"][gi], cache["v"][gi])
            x = x + torch.tanh(shared["gate"].to(x.dtype)) * hh
        cache["ssm"] = torch.stack(
            [torch.stack([s for s, _ in gs]) for gs in states])
        cache["conv"] = torch.stack(
            [torch.stack([c for _, c in gs]) for gs in states])

    elif cfg.family == "vlm":
        dtype = DTYPES[cfg.dtype]
        vision_kv = _vision_kv(params, batch, cfg)
        for gi, (group, cross) in enumerate(zip(params["layers"],
                                                params["cross"])):
            for j, layer in enumerate(group):
                x = _prefill_attn_block(layer, x, cfg, positions,
                                        cache["k"][gi, j], cache["v"][gi, j])
            # the cross block's (static) vision K / V for this group
            cache["cross_k"][gi] = torch.einsum(
                "btd,dhk->bthk", vision_kv, cross["attn"]["wk"].to(dtype))
            cache["cross_v"][gi] = torch.einsum(
                "btd,dhk->bthk", vision_kv, cross["attn"]["wv"].to(dtype))
            x = tfm.cross_block(cross, x, vision_kv, cfg)
    else:
        raise ValueError(cfg.family)

    cache["len"].fill_(S)
    x = rmsnorm(params["final_ln"], x[:, -1:, :], cfg.norm_eps)
    logits = lm_head(params["head"], x, cfg.vocab_size)
    return logits[:, 0], cache


def decode_step(params, batch, cache, cfg: ModelConfig):
    """One decode step.  batch: {"tokens": (B, 1)} (or {"embeds"} for
    audio).  Returns (logits (B, V), cache).

    **Writes into the cache it is given** (K / V at the fill position,
    the SSM and conv states, ``len`` + 1) and returns that same dict: a
    full-width copy per step would be waste.  Clone a cache (every tensor)
    to decode from it twice."""
    dtype = DTYPES[cfg.dtype]
    if cfg.embed_input:
        x = embed(params["embed"], batch["tokens"], dtype)
    else:
        x = batch["embeds"].to(dtype)
    clen = cache["len"]

    if cfg.family in ("dense", "moe", "audio"):
        block = (tfm.moe_block_decode if cfg.family == "moe"
                 else tfm.dense_block_decode)
        for i, layer in enumerate(params["layers"]):
            x, _, _ = block(layer, x, cache["k"][i], cache["v"][i], clen, cfg)

    elif cfg.family == "ssm":
        for i, layer in enumerate(params["layers"]):
            x = _ssm_decode_block(layer, x, cache, (i,), cfg)

    elif cfg.family == "hybrid":
        x0 = x
        for gi, group in enumerate(params["layers"]):
            for j, layer in enumerate(group):
                x = _ssm_decode_block(layer, x, cache, (gi, j), cfg)
            x, _, _ = tfm.shared_block_decode(
                params["shared"], x, x0, cache["k"][gi], cache["v"][gi],
                clen, cfg)

    elif cfg.family == "vlm":
        for gi, (group, cross) in enumerate(zip(params["layers"],
                                                params["cross"])):
            for j, layer in enumerate(group):
                x, _, _ = tfm.dense_block_decode(
                    layer, x, cache["k"][gi, j], cache["v"][gi, j], clen, cfg)
            x = tfm.cross_block_decode(cross, x, cache["cross_k"][gi],
                                       cache["cross_v"][gi], cfg)
    else:
        raise ValueError(cfg.family)

    clen.add_(1)
    x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
    logits = lm_head(params["head"], x, cfg.vocab_size)
    return logits[:, 0], cache


def _ssm_decode_block(layer, x, cache, at: tuple, cfg: ModelConfig):
    """One Mamba2 block's decode step; its carry is ``cache[...][at]``,
    overwritten with the new one."""
    x, (s, c) = tfm.ssm_block_decode(
        layer, x, (cache["ssm"][at], cache["conv"][at]), cfg)
    cache["ssm"][at] = s
    cache["conv"][at] = c
    return x
