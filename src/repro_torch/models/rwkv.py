"""RWKV6 ("Finch") block: token-shift time-mix with data-dependent decay,
WKV linear-attention recurrence, and squared-ReLU channel-mix.

Recurrence per head (state S: (K, V), K = V = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          w_t in (0,1), data-dependent
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

``RunConfig.attn_impl`` selects the recurrence: ``"kernel"`` is the
hand-written CUDA kernel (``repro_torch.kernels.wkv6``), anything else the
plain chunked version ``wkv_chunked``, as the reference takes its chunked
path for anything other than ``"pallas"``. The decay is data-dependent via
the Finch LoRA (w = exp(-exp(w0 + tanh(x @ A) @ B))); the r/k/v/g token-shift
mixes use static learned coefficients, as in the reference.

Weight layouts are the reference's: r/k/v ``(d, H, K)``, g/o/cm_r
``(d, d)``, LoRA ``(d, lora)`` and ``(lora, H, K)``, channel mix
``(d, d_ff)`` / ``(d_ff, d)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.wkv6 import wkv6, wkv_chunked
from repro_torch.models import layers as L


def init_rwkv6(generator, cfg: ModelConfig, *, dtype=torch.float32,
               device=None):
    d, H = cfg.d_model, cfg.n_heads
    K = d // H
    lora = max(32, d // 64)
    kw = dict(dtype=dtype, device=device)

    def full(shape, value):
        return torch.full(shape, value, **kw)

    return {
        "mix": full((5, d), 0.5),                   # mu for r,k,v,g,w
        "wr": L.dense_init(generator, (d, H, K), **kw),
        "wk": L.dense_init(generator, (d, H, K), **kw),
        "wv": L.dense_init(generator, (d, H, K), **kw),
        "wg": L.dense_init(generator, (d, d), **kw),
        "w0": full((H, K), -0.6),                   # base decay exp(-exp(-0.6))
        "w_lora_a": L.dense_init(generator, (d, lora), **kw),
        "w_lora_b": (L.dense_init(generator, (lora, H, K), in_axis_size=lora,
                                  device=device) * 0.1).to(dtype),
        "u": (0.1 * L.normal_init(generator, (H, K), device=device)).to(dtype),
        "ln_x": full((d,), 1.0),                    # per-head group norm scale
        "wo": L.dense_init(generator, (d, d), **kw),
        # channel mix
        "cm_mix": full((2, d), 0.5),
        "cm_k": L.dense_init(generator, (d, cfg.d_ff), **kw),
        "cm_v": L.dense_init(generator, (cfg.d_ff, d), in_axis_size=cfg.d_ff,
                             **kw),
        "cm_r": L.dense_init(generator, (d, d), **kw),
    }


def _token_shift(x, last=None):
    """x_{t-1} with zero (or carried `last`) at t=0. x: (B,S,d)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([first.to(x.dtype), x[:, :-1]], dim=1)


def _heads(x, w, H, K):
    """x (B,S,d) @ w (d,H,K) -> (B,S,H,K)."""
    B, S, d = x.shape
    return (x @ w.to(x.dtype).reshape(d, H * K)).view(B, S, H, K)


def _decay(params, xw):
    """Data-dependent log-decay lw (B,S,H,K) float32, < 0."""
    lo = torch.tanh(xw @ params["w_lora_a"].to(xw.dtype))
    _, H, K = params["w_lora_b"].shape
    ww = params["w0"].float() + _heads(lo, params["w_lora_b"], H, K).float()
    return -torch.exp(ww)          # log w_t = -exp(ww)  =>  w in (0,1)


def time_mix(params, x, cfg: ModelConfig, run: RunConfig, state=None,
             shift_last=None, update_state: bool = False):
    """WKV6 time-mix over a sequence. Returns (out, (new_state, new_last)).
    With `update_state` the new state is written into `state` itself (the
    decode path's cache) and that tensor is returned."""
    B, S, d = x.shape
    H = cfg.n_heads
    K = d // H
    xp = _token_shift(x, shift_last)
    mix = params["mix"].to(x.dtype)
    xr = x + (xp - x) * mix[0]
    xk = x + (xp - x) * mix[1]
    xv = x + (xp - x) * mix[2]
    xg = x + (xp - x) * mix[3]
    xw = x + (xp - x) * mix[4]
    r = _heads(xr, params["wr"], H, K)
    k = _heads(xk, params["wk"], H, K)
    v = _heads(xv, params["wv"], H, K)
    g = F.silu(xg @ params["wg"].to(x.dtype))
    lw = _decay(params, xw)                                   # (B,S,H,K) f32
    u = params["u"].float()
    state_out = state if update_state else None
    if run.attn_impl == "kernel":
        y, new_state = wkv6(r, k, v, lw, u, state=state, state_out=state_out)
    else:
        y, new_state = wkv_chunked(r, k, v, lw, u, chunk=16, state=state)
        if state_out is not None:
            new_state = state_out.copy_(new_state)
    y = y.reshape(B, S, d).to(x.dtype)
    # per-head group norm, statistics in float32
    yh = y.reshape(B, S, H, K)
    y32 = yh.float()
    mu = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    yh = ((yh - mu) * torch.rsqrt(var + 64e-5)).to(x.dtype)
    y = yh.reshape(B, S, d) * params["ln_x"].to(x.dtype)
    out = (y * g) @ params["wo"].to(x.dtype)
    return out, (new_state, x[:, -1, :])


def wkv_recurrent(r, k, v, lw, u, state=None, dtype=torch.float32):
    """Step oracle (tests). Same contract as wkv_chunked, computed in
    `dtype` (float64 for a reference of the float32 paths)."""
    B, S, H, K = r.shape
    s_t = torch.zeros((B, H, K, K), dtype=dtype, device=r.device) \
        if state is None else state.to(dtype)
    u = u.to(dtype)
    ys = []
    for t in range(S):
        r_t, k_t, v_t, w_t = (a[:, t].to(dtype) for a in (r, k, v, lw))
        kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t,
                               s_t + u[None, :, :, None] * kv))
        s_t = s_t * torch.exp(w_t)[..., None] + kv
    return torch.stack(ys, dim=1), s_t


def channel_mix(params, x, state_last=None):
    xp = _token_shift(x, state_last)
    mix = params["cm_mix"].to(x.dtype)
    xk = x + (xp - x) * mix[0]
    xr = x + (xp - x) * mix[1]
    kk = torch.relu(xk @ params["cm_k"].to(x.dtype)).square()
    vv = kk @ params["cm_v"].to(x.dtype)
    rr = torch.sigmoid(xr @ params["cm_r"].to(x.dtype))
    return vv * rr, x[:, -1, :]


def rwkv_block(params, x, cfg: ModelConfig, run: RunConfig, norms):
    """Full RWKV6 layer: ln1 -> time-mix -> residual; ln2 -> channel-mix."""
    h, _ = time_mix(params, L.rms_norm(x, norms["ln1"], cfg.norm_eps), cfg,
                    run)
    x = x + h
    h, _ = channel_mix(params, L.rms_norm(x, norms["ln2"], cfg.norm_eps))
    return x + h


def rwkv_block_decode(params, x, cache, cfg: ModelConfig, run: RunConfig,
                      norms):
    """One-token decode. cache: {"wkv": (B,H,K,K) float32, "tm_last": (B,d),
    "cm_last": (B,d)}, updated IN PLACE (the wkv state by the kernel itself)
    and handed back."""
    xn = L.rms_norm(x, norms["ln1"], cfg.norm_eps)
    h, (_, tm_last) = time_mix(params, xn, cfg, run, state=cache["wkv"],
                               shift_last=cache["tm_last"], update_state=True)
    cache["tm_last"].copy_(tm_last)
    x = x + h
    xn = L.rms_norm(x, norms["ln2"], cfg.norm_eps)
    h, cm_last = channel_mix(params, xn, state_last=cache["cm_last"])
    cache["cm_last"].copy_(cm_last)
    return x + h, cache


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype, *, device=None):
    d, H = cfg.d_model, cfg.n_heads
    K = d // H
    return {"wkv": torch.zeros((batch, H, K, K), dtype=torch.float32,
                               device=device),
            "tm_last": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_last": torch.zeros((batch, d), dtype=dtype, device=device)}
