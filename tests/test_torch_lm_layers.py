"""The LM stack's pieces, port against the JAX package on the same inputs:
RMSNorm, RoPE, the SwiGLU MLP, the embedding and head, flash attention,
cached decode attention (with the clamp of a full cache), the SSM pieces
and the MoE layer, plus the two SSM failures both packages keep.

Inputs are drawn with numpy and handed to both packages.  float32
comparisons use rtol 1e-5 / atol 1e-5 unless a test states otherwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm

from lm_parity import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """The same numpy tree as JAX arrays and as CPU tensors."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _cfgs(**kw):
    return JConfig(**kw), ModelConfig(**kw)


# --------------------------------------------------------------------------- #
# layers.py                                                                   #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = _rng(0)
    x = _randn(rng, 2, 5, 48, scale=30.0)
    scale = _randn(rng, 48)
    jx, tx = _both(x)
    (js, ts) = _both({"scale": scale})
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = tlayers.rmsnorm(ts, tx.to(td), 1e-5)
    want = jlayers.rmsnorm(js, jx.astype(jd), 1e-5)
    assert got.dtype == td
    # bf16: both compute in float32 and round once (measured: equal)
    tol = TOL if dtype == "float32" else dict(rtol=0, atol=0)
    _close(got.float(), np.asarray(want.astype(jnp.float32)), **tol)


def test_apply_rope_matches_jax():
    rng = _rng(1)
    x = _randn(rng, 2, 9, 3, 16, scale=5.0)
    pos = rng.integers(0, 4096, (2, 9)).astype(np.int32)
    (jx, tx), (jp, tp) = _both(x), _both(pos)
    got = tlayers.apply_rope(tx, tp, 500_000.0)
    want = jlayers.apply_rope(jx, jp, 500_000.0)
    _close(got, want)                         # angles up to 4096 rad
    # split halves: position 0 is the identity
    zero = torch.zeros((2, 9), dtype=torch.int32)
    assert torch.equal(tlayers.apply_rope(tx, zero, 1e4), tx)


def test_mlp_embed_and_head_match_jax():
    rng = _rng(2)
    d, f, vocab, padded = 24, 40, 200, 256
    p = {"wi_gate": _randn(rng, d, f, scale=0.2),
         "wi_up": _randn(rng, d, f, scale=0.2),
         "wo": _randn(rng, f, d, scale=0.2)}
    x = _randn(rng, 2, 7, d)
    jp, tp = _both(p)
    jx, tx = _both(x)
    _close(tlayers.mlp(tp, tx), jlayers.mlp(jp, jx))

    table = _randn(rng, padded, d)
    tokens = rng.integers(0, vocab, (3, 5)).astype(np.int32)
    (jt, tt), (jk, tk) = _both({"table": table}), _both(tokens)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        got = tlayers.embed(tt, tk.long(), td)
        assert got.dtype == td
        assert np.array_equal(got.float().numpy(),
                              np.asarray(jlayers.embed(jt, jk, jd)
                                         .astype(jnp.float32)))

    head = {"kernel": _randn(rng, d, padded, scale=0.2)}
    jh, th = _both(head)
    got = tlayers.lm_head(th, tx.to(torch.bfloat16), vocab)
    want = jlayers.lm_head(jh, jx.astype(jnp.bfloat16), vocab)
    assert got.dtype == torch.float32 and got.shape == (2, 7, vocab)
    _close(got, want)


# --------------------------------------------------------------------------- #
# attention.py                                                                #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("S,H,K,chunk", [
    (32, 4, 4, 8), (32, 8, 2, 16), (64, 4, 1, 32), (64, 6, 3, 64),
])
def test_flash_gqa_matches_jax(S, H, K, chunk):
    """The four cases of the JAX suite's flash test."""
    rng = _rng(S + H)
    hd = 16
    q, k, v = (_randn(rng, 2, S, H, hd), _randn(rng, 2, S, K, hd),
               _randn(rng, 2, S, K, hd))
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    got = tattn._flash_gqa(tq, tk, tv, causal=True, k_chunk=chunk)
    want = jattn._flash_gqa(jq, jk, jv, causal=True, k_chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32, 64])
def test_flash_chunk_invariance(chunk):
    rng = _rng(0)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 64, 2, 8)) for _ in range(3))
    ref = tattn._flash_gqa(q, k, v, causal=True, k_chunk=64)
    got = tattn._flash_gqa(q, k, v, causal=True, k_chunk=chunk)
    _close(got, ref)
    want = jattn._flash_gqa(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                            causal=True, k_chunk=chunk)
    _close(got, want)


def _attn_case(seed, cfg_kw, B=2, S_max=12):
    jc, tc = _cfgs(**cfg_kw)
    rng = _rng(seed)
    d, hd = jc.d_model, jc.head_dim
    p = {"wq": _randn(rng, d, jc.n_heads, hd, scale=0.3),
         "wk": _randn(rng, d, jc.n_kv_heads, hd, scale=0.3),
         "wv": _randn(rng, d, jc.n_kv_heads, hd, scale=0.3),
         "wo": _randn(rng, jc.n_heads, hd, d, scale=0.3)}
    ck = _randn(rng, B, S_max, jc.n_kv_heads, hd)
    cv = _randn(rng, B, S_max, jc.n_kv_heads, hd)
    x = _randn(rng, B, 1, d)
    return jc, tc, p, ck, cv, x


ATTN_CFG = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=64, head_dim=8,
                dtype="float32")


@pytest.mark.parametrize("fill", [0, 5, 11, 12])
def test_decode_attention_matches_jax(fill):
    """Including ``cache_len == S_max``: the start of the JAX update slice
    clamps to S_max - 1, so a full cache overwrites its last slot, and
    the port writes the same slot."""
    jc, tc, p, ck, cv, x = _attn_case(fill, ATTN_CFG)
    jp, tp = _both(p)
    (jck, tck), (jcv, tcv), (jx, tx) = _both(ck), _both(cv), _both(x)
    jy, jk2, jv2 = jax.jit(
        lambda *a: jattn.decode_attention(*a, jc))(
        jp, jx, jck, jcv, jnp.asarray(fill, jnp.int32))
    ty, tk2, tv2 = tattn.decode_attention(
        tp, tx, tck, tcv, torch.tensor(fill, dtype=torch.int32), tc)
    _close(ty, jy)
    _close(tk2, jk2)
    _close(tv2, jv2)
    assert tk2 is tck and tv2 is tcv          # written in place
    slot = min(fill, 11)
    changed = np.any(tk2.numpy() != ck, axis=(0, 2, 3))
    assert changed.tolist() == [i == slot for i in range(12)]


def test_prefill_attention_and_cross_attention_match_jax():
    jc, tc, p, _, _, _ = _attn_case(3, ATTN_CFG)
    rng = _rng(4)
    x = _randn(rng, 2, 6, 32)
    vis = _randn(rng, 2, 5, 32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    jp, tp = _both(p)
    (jx, tx), (jv, tv), (jpos, tpos) = _both(x), _both(vis), _both(pos)
    jy, jk, jvv = jax.jit(
        lambda *a: jattn.prefill_attention(*a, jc, jpos))(jp, jx)
    ty, tk, tvv = tattn.prefill_attention(tp, tx, tc, tpos)
    for got, want in ((ty, jy), (tk, jk), (tvv, jvv)):
        _close(got, want)
    _close(tattn.self_attention(tp, tx, tc, tpos),
           jax.jit(lambda *a: jattn.self_attention(*a, jc, jpos))(jp, jx))
    _close(tattn.cross_attention(tp, tx, tv, tc),
           jax.jit(lambda *a: jattn.cross_attention(*a, jc))(jp, jx, jv))


# --------------------------------------------------------------------------- #
# ssm.py                                                                      #
# --------------------------------------------------------------------------- #
SSM_CFG = dict(name="s", family="ssm", n_layers=1, d_model=16, n_heads=0,
               n_kv_heads=0, d_ff=0, vocab_size=64, head_dim=1, ssm_state=8,
               ssm_expand=2, ssm_headdim=8, ssm_chunk=4, ssm_groups=1,
               dtype="float32")


def _ssm_params(seed, cfg):
    rng = _rng(seed)
    d, din, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    W = cfg.ssm_conv
    return {"wz": _randn(rng, d, din, scale=0.25),
            "wx": _randn(rng, d, din, scale=0.25),
            "wB": _randn(rng, d, gn, scale=0.25),
            "wC": _randn(rng, d, gn, scale=0.25),
            "wdt": _randn(rng, d, h, scale=0.25),
            "conv_x": _randn(rng, W, din, scale=0.5),
            "conv_B": _randn(rng, W, gn, scale=0.5),
            "conv_C": _randn(rng, W, gn, scale=0.5),
            "A_log": _randn(rng, h, scale=0.5),
            "D_skip": _randn(rng, h),
            "dt_bias": _randn(rng, h, scale=0.5),
            "norm": 1.0 + _randn(rng, din, scale=0.1),
            "wo": _randn(rng, din, d, scale=0.25)}


def test_causal_conv_and_segsum_match_jax():
    rng = _rng(5)
    x, kern = _randn(rng, 2, 9, 6), _randn(rng, 4, 6)
    (jx, tx), (jk, tk) = _both(x), _both(kern)
    _close(tssm._causal_conv(tx, tk), jssm._causal_conv(jx, jk))
    a = _randn(rng, 3, 7, scale=0.5)
    ja, ta = _both(a)
    _close(tssm._segsum(ta), jssm._segsum(ja))


@pytest.mark.parametrize("T,chunk,g", [(16, 4, 1), (16, 16, 2), (12, 3, 2)])
def test_ssd_chunked_matches_jax(T, chunk, g):
    rng = _rng(T + chunk)
    b, h, p, n = 2, 4, 8, 5
    x = _randn(rng, b, T, h, p)
    dt = np.log1p(np.exp(_randn(rng, b, T, h))).astype(np.float32)
    A = -np.exp(_randn(rng, h, scale=0.5)).astype(np.float32)
    B, C = _randn(rng, b, T, g, n), _randn(rng, b, T, g, n)
    args = [_both(a) for a in (x, dt, A, B, C)]
    jy, js = jax.jit(lambda *a: jssm.ssd_chunked(*a, chunk))(
        *(a[0] for a in args))
    ty, ts = tssm.ssd_chunked(*(a[1] for a in args), chunk)
    _close(ty, jy)
    _close(ts, js)


def test_ssm_block_prefill_and_decode_match_jax():
    jc, tc = _cfgs(**SSM_CFG)
    p = _ssm_params(6, jc)
    jp, tp = _both(p)
    rng = _rng(7)
    x = _randn(rng, 2, 8, jc.d_model)
    jx, tx = _both(x)
    _close(tssm.ssm_block(tp, tx, tc),
           jax.jit(lambda *a: jssm.ssm_block(*a, jc))(jp, jx))
    jy, (js, jw) = jax.jit(lambda *a: jssm.ssm_prefill(*a, jc))(jp, jx)
    ty, (ts, tw) = tssm.ssm_prefill(tp, tx, tc)
    for got, want in ((ty, jy), (ts, js), (tw, jw)):
        _close(got, want)
    jstate, tstate = (js, jw), (ts, tw)
    jdecode = jax.jit(lambda *a: jssm.ssm_decode_step(*a, jc))
    for step in range(3):
        xt = _randn(rng, 2, 1, jc.d_model)
        jxt, txt = _both(xt)
        jy, jstate = jdecode(jp, jxt, jstate)
        ty, tstate = tssm.ssm_decode_step(tp, txt, tstate, tc)
        _close(ty, jy)
        _close(tstate[0], jstate[0])
        _close(tstate[1], jstate[1])
    js0, jw0 = jssm.ssm_decode_init(jc, 2)
    ts0, tw0 = tssm.ssm_decode_init(tc, 2, device="cpu")
    assert ts0.shape == js0.shape and tw0.shape == jw0.shape


def test_ssd_chunk_divisibility_fails_in_both():
    """T % min(chunk, T) != 0 fails in the reference (an assert) and in
    the port (ValueError); neither pads."""
    rng = _rng(8)
    b, T, h, p, n = 1, 12, 2, 4, 3
    args = [_both(a) for a in (
        _randn(rng, b, T, h, p), np.ones((b, T, h), np.float32),
        -np.ones(h, np.float32), _randn(rng, b, T, 1, n),
        _randn(rng, b, T, 1, n))]
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*(a[0] for a in args), 8)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssm.ssd_chunked(*(a[1] for a in args), 8)


def test_short_prompt_conv_window_fails_next_decode_in_both():
    """A prompt shorter than ssm_conv - 1 gives a short conv window in
    both packages, and the decode step after it fails in both."""
    jc, tc = _cfgs(**dict(SSM_CFG, ssm_chunk=2))
    p = _ssm_params(9, jc)
    jp, tp = _both(p)
    rng = _rng(10)
    x = _randn(rng, 1, 2, jc.d_model)          # T = 2 < ssm_conv - 1 = 3
    jx, tx = _both(x)
    _, (js, jw) = jax.jit(lambda *a: jssm.ssm_prefill(*a, jc))(jp, jx)
    _, (ts, tw) = tssm.ssm_prefill(tp, tx, tc)
    assert jw.shape[1] < jc.ssm_conv - 1
    assert tuple(tw.shape) == jw.shape
    _close(tw, jw)
    xt = _randn(rng, 1, 1, jc.d_model)
    jxt, txt = _both(xt)
    with pytest.raises((TypeError, ValueError)):
        jax.jit(lambda *a: jssm.ssm_decode_step(*a, jc))(jp, jxt, (js, jw))
    with pytest.raises(RuntimeError):
        tssm.ssm_decode_step(tp, txt, (ts, tw), tc)


# --------------------------------------------------------------------------- #
# moe.py                                                                      #
# --------------------------------------------------------------------------- #
MOE_CFG = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
               n_kv_heads=2, d_ff=24, vocab_size=64, head_dim=8, n_experts=4,
               experts_per_token=2, dtype="float32")


@pytest.mark.parametrize("capacity_factor,S", [(1.25, 8), (0.25, 32)])
def test_moe_reference_matches_jax(capacity_factor, S):
    """Output, aux loss and dropped fraction; the second case's capacity
    (8 slots per expert for 64 assignments over 4 experts) drops tokens."""
    kw = dict(MOE_CFG, capacity_factor=capacity_factor)
    jc, tc = _cfgs(**kw)
    rng = _rng(11)
    p = {"router": _randn(rng, 16, 4),
         "wi_gate": _randn(rng, 4, 16, 24, scale=0.25),
         "wi_up": _randn(rng, 4, 16, 24, scale=0.25),
         "wo": _randn(rng, 4, 24, 16, scale=0.25)}
    x = _randn(rng, 2, S, 16)
    jp, tp = _both(p)
    jx, tx = _both(x)
    jy, jaux = jax.jit(lambda *a: jmoe.moe_reference(*a, jc))(jp, jx)
    ty, taux = tmoe.moe_reference(tp, tx, tc)
    _close(ty, jy)
    _close(taux["aux_loss"], jaux["aux_loss"])
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    if capacity_factor < 1:
        assert float(taux["dropped_frac"]) > 0.2
    else:
        assert float(taux["dropped_frac"]) == 0.0
    assert tmoe._capacity(2 * S, tc) == jmoe._capacity(2 * S, jc)
    # the combine adds in a fixed order: a repeat is bit-identical
    assert torch.equal(tmoe.moe(tp, tx, tc)[0], ty)


def test_param_spec_std_follows_the_stacked_fan_in():
    """The reference's init takes fan-in from the first dim of the leaf as
    stacked; the port's spec does the same."""
    spec = jlayers.stack_specs({"w": jlayers.ParamSpec((64, 32), (None,
                                                                   None))}, 3)
    tspec = tlayers.stack_specs({"w": tlayers.ParamSpec((64, 32), (None,
                                                                    None))},
                                3)
    assert tspec.inner["w"].stacked_shape == spec["w"].shape
    assert tspec.inner["w"].std() == pytest.approx(1 / np.sqrt(3))
    assert dataclasses.replace(tspec.inner["w"], stack=()).std() == \
        pytest.approx(1 / np.sqrt(64))
