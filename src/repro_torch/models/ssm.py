"""Mamba2 (SSD — state-space duality) block, chunked.

The PyTorch counterpart of ``repro.models.ssm``.  The chunked SSD
algorithm (Dao & Gu 2024) splits the sequence into chunks of Q tokens:
intra-chunk terms are small dense matmuls, inter-chunk terms a linear
recurrence over per-chunk states (a Python loop over chunks here, the
JAX ``lax.scan``).  Train / prefill use the chunked form; decode keeps the
O(1) recurrent state.  Projections stay unfused (wz / wx / wB / wC / wdt),
as in the JAX package.

Two failures of the reference stay failures: :func:`ssd_chunked` needs
``T % min(chunk, T) == 0``, and :func:`ssm_prefill` of a prompt shorter
than ``ssm_conv - 1`` returns a short conv window, on which the next
:func:`ssm_decode_step` fails.  Nothing pads them away.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.layers import ParamSpec, rmsnorm

__all__ = ["NEG_INF", "ssm_specs", "ssd_chunked", "ssm_block", "ssm_prefill",
           "ssm_decode_init", "ssm_decode_step"]

NEG_INF = -1e30


def ssm_specs(cfg: ModelConfig):
    d, din = cfg.d_model, cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    h = cfg.ssm_heads
    w = cfg.ssm_conv
    return {
        "wz": ParamSpec((d, din), ("embed", "ssm_inner")),
        "wx": ParamSpec((d, din), ("embed", "ssm_inner")),
        "wB": ParamSpec((d, gn), ("embed", None)),
        "wC": ParamSpec((d, gn), ("embed", None)),
        "wdt": ParamSpec((d, h), ("embed", "ssm_heads")),
        "conv_x": ParamSpec((w, din), (None, "ssm_inner"), init="normal",
                            scale=0.5),
        "conv_B": ParamSpec((w, gn), (None, None), init="normal", scale=0.5),
        "conv_C": ParamSpec((w, gn), (None, None), init="normal", scale=0.5),
        "A_log": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "D_skip": ParamSpec((h,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "norm": ParamSpec((din,), ("ssm_inner",), init="ones"),
        "wo": ParamSpec((din, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as the W-tap shifted sum (no cuDNN, so no
    TF32 convolution).  x: (B, T, C), kernel: (W, C)."""
    W = kernel.shape[0]
    T = x.shape[1]
    xp = nn.functional.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for w in range(W):
        out = out + xp[:, w:w + T, :] * kernel[w][None, None, :]
    return out


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L) -> (..., L, L) with [i, j] = sum a[j+1..i], -inf above
    the diagonal."""
    L = a.shape[-1]
    csum = torch.cumsum(a, dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, NEG_INF)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan.

    x: (b, T, h, p); dt: (b, T, h) positive step sizes (folded in here);
    A: (h,) negative decay rates; B, C: (b, T, g, n), the h heads grouped
    over g.  Returns y (b, T, h, p) and the final state (b, h, p, n).
    """
    b, T, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"sequence length {T} is not a multiple of the "
                         f"SSD chunk {Q}")
    c = T // Q
    rep = h // g

    xd = x * dt[..., None]                              # fold dt into x
    a = dt * A[None, None, :]                            # (b, T, h) log-decay

    xc = xd.reshape(b, c, Q, h, p)
    ac = a.reshape(b, c, Q, h).permute(0, 3, 1, 2)       # (b, h, c, Q)
    Bh = B.reshape(b, c, Q, g, n).repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, c, Q, g, n).repeat_interleave(rep, dim=3)

    a_cs = torch.cumsum(ac, dim=-1)                      # (b, h, c, Q)

    # 1. intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(ac))                        # (b, h, c, Q, Q)
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)  # (b, c, h, L, S)
    scores = scores * Lmat.permute(0, 2, 1, 3, 4)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xc)

    # 2. per-chunk final states
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)      # (b, h, c, Q)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay_states, xc)

    # 3. inter-chunk recurrence, one chunk at a time; each chunk reads the
    #    state at its start
    chunk_decay = torch.exp(a_cs[..., -1])               # (b, h, c)
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    starts = []
    for i in range(c):
        starts.append(state)
        state = state * chunk_decay[:, :, i, None, None] + states[:, i]
    start_states = torch.stack(starts, dim=1)            # (b, c, h, p, n)

    # 4. inter-chunk output: decay from chunk start
    out_decay = torch.exp(a_cs)                          # (b, h, c, Q)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, start_states,
                         out_decay)

    y = (y_diag + y_off).reshape(b, T, h, p)
    return y, state


def _mix(params, x: torch.Tensor, cfg: ModelConfig):
    """The projections, convolutions and SSD of a block over the whole
    sequence: (output, final SSD state, the pre-conv x / B / C)."""
    dtype = x.dtype
    b, T, _ = x.shape
    h, p = cfg.ssm_heads, cfg.ssm_headdim
    g, n = cfg.ssm_groups, cfg.ssm_state
    silu = nn.functional.silu

    z = x @ params["wz"].to(dtype)                       # (B, T, din)
    xs_pre = x @ params["wx"].to(dtype)
    Bv_pre = x @ params["wB"].to(dtype)
    Cv_pre = x @ params["wC"].to(dtype)
    dt = x @ params["wdt"].to(dtype)

    xs = silu(_causal_conv(xs_pre, params["conv_x"].to(dtype)))
    Bv = silu(_causal_conv(Bv_pre, params["conv_B"].to(dtype)))
    Cv = silu(_causal_conv(Cv_pre, params["conv_C"].to(dtype)))

    dt = nn.functional.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())

    xh = xs.reshape(b, T, h, p).float()
    Bh = Bv.reshape(b, T, g, n).float()
    Ch = Cv.reshape(b, T, g, n).float()

    y, final_state = ssd_chunked(xh, dt, A, Bh, Ch, cfg.ssm_chunk)
    y = y + xh * params["D_skip"].float()[None, None, :, None]
    y = y.reshape(b, T, h * p).to(dtype)

    y = rmsnorm({"scale": params["norm"]}, y * silu(z), cfg.norm_eps)
    out = y @ params["wo"].to(dtype)
    return out, final_state, (xs_pre, Bv_pre, Cv_pre)


def ssm_block(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full Mamba2 block for train/prefill.  x: (B, T, D) -> (B, T, D)."""
    return _mix(params, x, cfg)[0]


def ssm_prefill(params, x: torch.Tensor, cfg: ModelConfig):
    """Like :func:`ssm_block` but also returns the decode carry
    (ssm_state, conv_window) capturing the prompt."""
    out, final_state, pre = _mix(params, x, cfg)
    T, W = x.shape[1], cfg.ssm_conv
    # conv window: the last W-1 *pre-conv* inputs, concat(x, B, C); the
    # slice is the JAX one, Python semantics included, so a prompt shorter
    # than W - 1 gives a short window
    window = torch.cat(pre, dim=-1)[:, T - (W - 1):, :]
    return out, (final_state.float(), window.float())


# --------------------------------------------------------------------------- #
# Decode (recurrent, O(1) state)                                              #
# --------------------------------------------------------------------------- #
def ssm_decode_init(cfg: ModelConfig, batch: int,
                    dtype: torch.dtype = torch.float32,
                    device: str | torch.device | None = None):
    """(ssm_state, conv_state) carry for one layer, on the card unless
    ``device`` says otherwise."""
    device = resolve_device(device)
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    gn = cfg.ssm_groups * cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * gn
    return (torch.zeros((batch, h, p, n), dtype=dtype, device=device),
            torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                        device=device))


def ssm_decode_step(params, x, state, cfg: ModelConfig):
    """x: (B, 1, D); state = (ssm_state (B,h,p,n), conv_state). Returns
    (y (B, 1, D), new_state); the state given is not written."""
    dtype = x.dtype
    b = x.shape[0]
    h, p = cfg.ssm_heads, cfg.ssm_headdim
    g, n = cfg.ssm_groups, cfg.ssm_state
    gn = g * n
    din = cfg.d_inner
    ssm_state, conv_state = state
    silu = nn.functional.silu

    xt = x[:, 0, :]
    z = xt @ params["wz"].to(dtype)
    xs = xt @ params["wx"].to(dtype)
    Bv = xt @ params["wB"].to(dtype)
    Cv = xt @ params["wC"].to(dtype)
    dt = xt @ params["wdt"].to(dtype)

    # causal conv over the rolling window
    new_in = torch.cat([xs, Bv, Cv], dim=-1)              # (B, conv_dim)
    window = torch.cat([conv_state, new_in[:, None, :].to(conv_state.dtype)],
                       dim=1)
    kernel = torch.cat([params["conv_x"], params["conv_B"],
                        params["conv_C"]], dim=1).to(dtype)  # (W, conv_dim)
    conv_out = silu(torch.einsum("bwc,wc->bc", window.to(dtype), kernel))
    xs = conv_out[:, :din]
    Bv = conv_out[:, din:din + gn]
    Cv = conv_out[:, din + gn:]
    new_conv_state = window[:, 1:, :]

    dt = nn.functional.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    dA = torch.exp(dt * A[None, :])                       # (B, h)

    xh = xs.reshape(b, h, p).float()
    Bh = Bv.reshape(b, g, n).repeat_interleave(h // g, dim=1).float()
    Ch = Cv.reshape(b, g, n).repeat_interleave(h // g, dim=1).float()

    upd = (dt[..., None] * xh)[..., :, None] * Bh[..., None, :]  # (B,h,p,n)
    new_ssm = ssm_state.float() * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, Ch)
    y = y + xh * params["D_skip"].float()[None, :, None]
    y = y.reshape(b, din).to(dtype)

    y = rmsnorm({"scale": params["norm"]}, y * silu(z), cfg.norm_eps)
    out = (y @ params["wo"].to(dtype))[:, None, :]
    return out, (new_ssm.to(ssm_state.dtype), new_conv_state)
