"""GQA attention: flash-style chunked prefill, cached decode, cross-attention.

The PyTorch counterpart of ``repro.models.attention``.  Prefill runs an
online softmax over KV chunks (``n_chunks = max(T // k_chunk, 1)``, float32
inside), so the (S x S) score matrix is never materialized; decode reads
the K-headed cache grouped (no K -> H repeat).  Everything is ``torch``
einsum / matmul: the JAX package computes these products outside any
Pallas kernel, and so does the port.

The JAX module picks a GSPMD layout for the K / V heads
(``_kv_heads_shardable``): under a mesh whose model axis does not divide
the K kv heads it repeats them to H heads first, otherwise it takes the
grouped arithmetic below.  Both give the same values; the port keeps the
grouped arithmetic under any mesh (the mesh tests hold it to the JAX
repeat path).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamSpec, apply_rope

__all__ = ["NEG_INF", "attention_specs", "self_attention", "cross_attention",
           "prefill_attention", "decode_attention"]

NEG_INF = -1e30


def attention_specs(cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": ParamSpec((d, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, cfg.n_kv_heads, hd),
                        ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, cfg.n_kv_heads, hd),
                        ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.n_heads, hd, d), ("heads", "head_dim", "embed")),
    }


def _project_qkv(params, x, kv_x, cfg: ModelConfig, positions,
                 rope: bool = True):
    dtype = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dtype))
    k = torch.einsum("btd,dhk->bthk", kv_x, params["wk"].to(dtype))
    v = torch.einsum("btd,dhk->bthk", kv_x, params["wv"].to(dtype))
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _flash_gqa(q, k, v, *, causal: bool, k_chunk: int):
    """Online-softmax attention.  q: (B, S, H, hd); k/v: (B, T, K, hd).
    The H query heads are grouped (K, H // K) over the K kv heads."""
    K = k.shape[2]
    return _flash_core(q, k, v, causal=causal, k_chunk=k_chunk,
                       group=q.shape[2] // K)


def _flash_core(q, k, v, *, causal: bool, k_chunk: int, group: int = 1):
    """q: (B, S, Hq, hd) where Hq = K*group; k/v: (B, T, K, hd)."""
    B, S, Hq, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qf = q.reshape(B, S, K, group, hd).float()
    scale = 1.0 / math.sqrt(hd)

    n_chunks = max(T // k_chunk, 1)
    if T % n_chunks:
        # the JAX reshape into (n_chunks, T // n_chunks) fails the same way
        raise ValueError(f"{T} keys do not split into {n_chunks} chunks")
    Tc = T // n_chunks
    q_pos = torch.arange(S, device=q.device)

    m = torch.full((B, S, K, group), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, S, K, group), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, K, group, hd), dtype=torch.float32,
                      device=q.device)
    for idx in range(n_chunks):
        k_blk = k[:, idx * Tc:(idx + 1) * Tc].float()
        v_blk = v[:, idx * Tc:(idx + 1) * Tc].float()
        s = torch.einsum("bskgd,btkd->bskgt", qf, k_blk) * scale
        if causal:
            k_pos = idx * Tc + torch.arange(Tc, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]        # (S, Tc)
            s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
        m_blk = s.amax(dim=-1)
        m_new = torch.maximum(m, m_blk)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bskgt,btkd->bskgd", p, v_blk)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def self_attention(params, x, cfg: ModelConfig, positions,
                   k_chunk: int = 1024):
    """Causal prefill/train path."""
    q, k, v = _project_qkv(params, x, x, cfg, positions)
    kc = min(k_chunk, x.shape[1])
    out = _flash_gqa(q, k, v, causal=True, k_chunk=kc)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))


def cross_attention(params, x, vision_kv, cfg: ModelConfig,
                    k_chunk: int = 1024):
    """VLM cross-attn: queries from the text stream, KV from the vision
    embeddings (no RoPE, no causal mask)."""
    B, S, _ = x.shape
    pos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    q, _, _ = _project_qkv(params, x, x, cfg, pos, rope=False)
    dtype = x.dtype
    k = torch.einsum("btd,dhk->bthk", vision_kv, params["wk"].to(dtype))
    v = torch.einsum("btd,dhk->bthk", vision_kv, params["wv"].to(dtype))
    kc = min(k_chunk, vision_kv.shape[1])
    out = _flash_gqa(q, k, v, causal=False, k_chunk=kc)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))


def prefill_attention(params, x, cfg: ModelConfig, positions,
                      k_chunk: int = 1024):
    """Causal attention that also returns (k, v) for cache population."""
    q, k, v = _project_qkv(params, x, x, cfg, positions)
    kc = min(k_chunk, x.shape[1])
    out = _flash_gqa(q, k, v, causal=True, k_chunk=kc)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, k, v


def decode_attention(params, x, cache_k, cache_v, cache_len,
                     cfg: ModelConfig):
    """Single-token decode. x: (B, 1, D); cache_k/v: (B, S_max, K, hd);
    cache_len: () int32 tensor, the current fill.  Returns
    (y, cache_k, cache_v).

    Writes the new K / V into ``cache_k`` / ``cache_v`` in place, at
    ``cache_len`` clamped to ``S_max - 1`` as ``dynamic_update_slice``
    clamps its start: a cache that is full overwrites its last slot.
    Nothing here waits on the device (the fill stays a tensor)."""
    B = x.shape[0]
    positions = cache_len.expand(B, 1)
    q, k_new, v_new = _project_qkv(params, x, x, cfg, positions)
    S_max, K = cache_k.shape[1], cache_k.shape[2]
    slot = cache_len.clamp(0, S_max - 1).reshape(1).long()
    cache_k.index_copy_(1, slot, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v_new.to(cache_v.dtype))

    H, hd = q.shape[2], q.shape[3]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, cache_k.float()) / math.sqrt(hd)
    valid = torch.arange(S_max, device=x.device)[None, :] <= cache_len
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, cache_v.float())
    out = out.reshape(B, 1, H, hd).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, cache_k, cache_v
