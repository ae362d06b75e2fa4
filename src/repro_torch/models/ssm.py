"""Mamba2 block (SSD — state space dual, chunked scan).

Recurrence per head (state h: (N, P), N = d_state, P = head_dim):
    a_t = exp(dt_t * A)                    (scalar decay per head, A < 0)
    h_t = a_t * h_{t-1} + dt_t * B_t x_t^T
    y_t = C_t^T h_t + D * x_t

``RunConfig.attn_impl`` selects the scan: ``"kernel"`` is the hand-written
CUDA kernel (``repro_torch.kernels.ssd``), anything else the plain chunked
version ``ssd_chunked``, as the reference takes its chunked path for
anything other than ``"pallas"``. The one-token decode is plain tensor code,
as in the reference.

Weight layouts are the reference's: in_proj ``(d, 2 d_inner + 2 G N + H)``
(z, xBC, dt), conv ``(d_conv, conv_dim)``, out_proj ``(d_inner, d)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.ssd import ssd, ssd_chunked
from repro_torch.models import layers as L


def init_mamba2(generator, cfg: ModelConfig, *, dtype=torch.float32,
                device=None):
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    N = s.d_state
    conv_dim = d_inner + 2 * s.n_groups * N
    kw = dict(dtype=dtype, device=device)
    # softplus^-1 of dt drawn log-uniformly in [1e-3, 1e-1]
    dt = torch.exp(L.uniform_init(generator, (H,), math.log(1e-3),
                                  math.log(1e-1), device=device))
    return {
        # in_proj -> [z (d_inner), xBC (conv_dim), dt (H)]
        "in_proj": L.dense_init(generator,
                                (d, 2 * d_inner + 2 * s.n_groups * N + H), **kw),
        "conv_w": (L.dense_init(generator, (s.d_conv, conv_dim),
                                device=device) * 0.5).to(dtype),
        "conv_b": torch.zeros((conv_dim,), **kw),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)
                           ).to(dtype),                  # A = -exp(A_log)
        "D": torch.ones((H,), **kw),
        "dt_bias": torch.log(torch.expm1(dt)).to(dtype),
        "ssm_norm": torch.ones((d_inner,), **kw),
        "out_proj": L.dense_init(generator, (d_inner, d), in_axis_size=d_inner,
                                 **kw),
    }


def _split_in_proj(cfg, proj):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    gN = s.n_groups * s.d_state
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:2 * d_inner + 2 * gN]
    dt = proj[..., 2 * d_inner + 2 * gN:]
    return z, xBC, dt, d_inner, H, gN


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, width d_conv, as shifted multiply-adds (no
    cuDNN, so no TF32). xBC: (B,S,C); w: (W,C)."""
    W = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(W):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def _per_head(m, H):
    """(B,S,G,N) group tensor -> (B,S,H,N), head h reading group h // (H/G).
    One group is an expand()ed view with a zero head stride, no copy."""
    B, S, G, N = m.shape
    if G == 1:
        return m.expand(B, S, H, N)
    return m.repeat_interleave(H // G, dim=2)


def mamba2(params, x, cfg: ModelConfig, run: RunConfig):
    """Full-sequence (prefill) Mamba2 block. x: (B,S,d) -> (B,S,d)."""
    s = cfg.ssm
    B, S, d = x.shape
    proj = x @ params["in_proj"].to(x.dtype)
    z, xBC, dt, d_inner, H, gN = _split_in_proj(cfg, proj)
    xBC = F.silu(_causal_conv(xBC, params["conv_w"].to(x.dtype),
                              params["conv_b"].to(x.dtype)))
    xs = xBC[..., :d_inner].reshape(B, S, H, s.head_dim)
    Bm = _per_head(xBC[..., d_inner:d_inner + gN]
                   .reshape(B, S, s.n_groups, s.d_state), H)
    Cm = _per_head(xBC[..., d_inner + gN:]
                   .reshape(B, S, s.n_groups, s.d_state), H)
    dt = F.softplus(dt.float() + params["dt_bias"].float())      # (B,S,H)
    A = -torch.exp(params["A_log"].float())                       # (H,)
    if run.attn_impl == "kernel":
        y, _ = ssd(xs, dt, A, Bm, Cm, chunk=s.chunk)
    else:
        y, _ = ssd_chunked(xs, dt, A, Bm, Cm, chunk=s.chunk)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xs.to(y.dtype)
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), params["ssm_norm"], cfg.norm_eps)
    return y @ params["out_proj"].to(x.dtype)


def ssd_recurrent(xs, dt, A, Bm, Cm, h0=None, dtype=torch.float32):
    """Step-by-step oracle (tests). Same signature as ssd_chunked, computed
    in `dtype` (float64 for a reference of the float32 paths)."""
    B, S, H, P = xs.shape
    N = Bm.shape[-1]
    h = torch.zeros((B, H, N, P), dtype=dtype, device=xs.device) \
        if h0 is None else h0.to(dtype)
    A = A.to(dtype)
    ys = []
    for t in range(S):
        x_t, dt_t = xs[:, t].to(dtype), dt[:, t].to(dtype)
        b_t, c_t = Bm[:, t].to(dtype), Cm[:, t].to(dtype)
        a = torch.exp(dt_t * A[None, :])                          # (B,H)
        h = h * a[:, :, None, None] + torch.einsum(
            "bhn,bhp->bhnp", b_t * dt_t[..., None], x_t)
        ys.append(torch.einsum("bhn,bhnp->bhp", c_t, h))
    return torch.stack(ys, dim=1), h


def mamba2_decode(params, x, cache, cfg: ModelConfig, run: RunConfig):
    """One-token decode. cache: {"h": (B,H,N,P) float32, "conv":
    (B,W-1,conv_dim)}, updated IN PLACE and handed back."""
    s = cfg.ssm
    B = x.shape[0]
    proj = x @ params["in_proj"].to(x.dtype)
    z, xBC, dt, d_inner, H, gN = _split_in_proj(cfg, proj)
    # conv with the carried window
    conv = cache["conv"]
    win = torch.cat([conv, xBC.to(conv.dtype)], dim=1)           # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", win,
                            params["conv_w"].to(win.dtype))
    xBC = F.silu(conv_out + params["conv_b"].to(win.dtype))[:, None, :]
    xs = xBC[..., :d_inner].reshape(B, 1, H, s.head_dim)
    Bm = _per_head(xBC[..., d_inner:d_inner + gN]
                   .reshape(B, 1, s.n_groups, s.d_state), H)
    Cm = _per_head(xBC[..., d_inner + gN:]
                   .reshape(B, 1, s.n_groups, s.d_state), H)
    dtv = F.softplus(dt.float() + params["dt_bias"].float())[:, 0]  # (B,H)
    A = -torch.exp(params["A_log"].float())
    x0 = xs[:, 0].float()
    a = torch.exp(dtv * A[None, :])
    h = cache["h"] * a[:, :, None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bm[:, 0].float() * dtv[..., None], x0)
    y = torch.einsum("bhn,bhnp->bhp", Cm[:, 0].float(), h)
    y = y + params["D"].float()[None, :, None] * x0
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), params["ssm_norm"], cfg.norm_eps)
    out = y @ params["out_proj"].to(x.dtype)
    cache["h"].copy_(h)
    conv.copy_(win[:, 1:])
    return out, cache


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, *, device=None):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return {"h": torch.zeros((batch, H, s.d_state, s.head_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                                device=device)}
