"""Grouped-query attention: full sequence, prefill and one-token decode.

``RunConfig.attn_impl`` selects the softmax core for a full sequence:
``"kernel"`` is the hand-written flash-attention kernel
(``repro_torch.kernels.flash_attention``), ``"full"`` the plain version that
builds the score matrix. ``gqa_prefill`` honours the setting exactly as
``gqa`` does. Decode attention over the cache is plain tensor code.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# GQA weights
# ---------------------------------------------------------------------------


def init_gqa(generator, cfg: ModelConfig, *, dtype=torch.float32,
             device=None):
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": L.dense_init(generator, (d, H, Dh), **kw),
        "wk": L.dense_init(generator, (d, K, Dh), **kw),
        "wv": L.dense_init(generator, (d, K, Dh), **kw),
        "wo": L.dense_init(generator, (H, Dh, d), in_axis_size=H * Dh, **kw),
    }


# ---------------------------------------------------------------------------
# softmax attention cores
# ---------------------------------------------------------------------------


def full_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None):
    """Plain softmax attention. q: (B,Sq,H,D); k,v: (B,Sk,K,D).
    q_offset: absolute position of q[0] (for causal masking w/ cache).
    kv_len: number of valid kv positions (decode) — scalar or (B,).
    The softmax is taken in float32 and cast to v.dtype before PV."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * (1.0 / math.sqrt(D))
    s = s.float()
    kpos = torch.arange(Sk, device=q.device)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        s = s.masked_fill(~(qpos >= kpos[None, :]), NEG_INF)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        if kv_len.dim() == 0:
            mask = kpos[None, :] < kv_len
        else:   # per-row lengths (continuous batching)
            mask = kpos[None, None, None, None, :] < \
                kv_len[:, None, None, None, None]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(B, Sq, H, D)


def decode_attention(q, k_cache, v_cache, kv_len):
    """Single-step decode. q: (B,1,H,D); caches (B,Smax,K,D); kv_len scalar
    or (B,)."""
    return full_attention(q, k_cache, v_cache, causal=False, kv_len=kv_len)


def _sequence_attention(q, k, v, run: RunConfig, *, causal: bool):
    """The softmax core for a whole sequence, as `run.attn_impl` names it."""
    if run.attn_impl == "kernel":
        return flash_attention(q, k, v, causal=causal)
    if run.attn_impl == "full":
        return full_attention(q, k, v, causal=causal)
    if run.attn_impl in ("blocked", "zigzag"):
        raise NotImplementedError(
            f"attn_impl={run.attn_impl!r} is not ported yet (ROADMAP.md, "
            f"Queue 1, blocked/zigzag attention); use 'kernel' or 'full'")
    raise ValueError(f"unknown attn_impl {run.attn_impl!r}")


# ---------------------------------------------------------------------------
# GQA module
# ---------------------------------------------------------------------------


def _project_qkv(params, x, cfg: ModelConfig, positions):
    B, S, d = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    # (d, H, Dh) weights contract over d: a matmul with the (d, H*Dh) view
    q = (x @ params["wq"].to(x.dtype).reshape(d, H * Dh)).view(B, S, H, Dh)
    k = (x @ params["wk"].to(x.dtype).reshape(d, K * Dh)).view(B, S, K, Dh)
    v = (x @ params["wv"].to(x.dtype).reshape(d, K * Dh)).view(B, S, K, Dh)
    q = L.rotary(q, positions, cfg.rope_kind, cfg.rope_fraction, cfg.rope_theta)
    k = L.rotary(k, positions, cfg.rope_kind, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


def _project_out(params, o, x):
    B, S, H, Dh = o.shape
    wo = params["wo"].to(x.dtype)
    return o.reshape(B, S, H * Dh) @ wo.reshape(H * Dh, wo.shape[-1])


def gqa(params, x, cfg: ModelConfig, run: RunConfig, *, positions=None,
        causal: bool = True):
    """Self-attention over a full sequence."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    o = _sequence_attention(q, k, v, run, causal=causal)
    return _project_out(params, o, x)


def gqa_prefill(params, x, cfg: ModelConfig, run: RunConfig, *,
                positions=None, pad_to: int = 0):
    """Like gqa() but also returns the (k, v) cache content, padded to
    `pad_to` positions (the serve-time max length)."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    o = _sequence_attention(q, k, v, run, causal=True)
    out = _project_out(params, o, x)
    if pad_to > S:
        pad = (0, 0, 0, 0, 0, pad_to - S)      # last dimension first
        k, v = F.pad(k, pad), F.pad(v, pad)
    return out, (k, v)


def gqa_decode(params, x, cache, cfg: ModelConfig, run: RunConfig):
    """One-token decode against a KV cache.

    cache: {"k": (B,Smax,K,D), "v": ..., "pos": (B,) int32} — pos[b] is the
    slot this token writes for row b (per-row: continuous batching);
    kv_len = pos+1. The k and v tensors are updated IN PLACE and handed back
    in the returned dict beside a new `pos`. A row whose pos is at or past
    Smax writes nothing, as an out-of-range scatter does in the reference:
    the engine steps idle slots too, and their pos runs past the end.
    """
    B = x.shape[0]
    pos = cache["pos"]                       # (B,)
    q, k, v = _project_qkv(params, x, cfg, pos[:, None])
    k_cache, v_cache = cache["k"], cache["v"]
    smax = k_cache.shape[1]
    rows = torch.arange(B, device=x.device)
    in_range = pos < smax
    idx = torch.where(in_range, pos, torch.zeros_like(pos)).long()
    keep = in_range[:, None, None]
    k_cache[rows, idx] = torch.where(keep, k[:, 0].to(k_cache.dtype),
                                     k_cache[rows, idx])
    v_cache[rows, idx] = torch.where(keep, v[:, 0].to(v_cache.dtype),
                                     v_cache[rows, idx])
    o = decode_attention(q, k_cache, v_cache, pos + 1)
    return _project_out(params, o, x), \
        {"k": k_cache, "v": v_cache, "pos": pos + 1}


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                   device=None, quant: bool = False):
    if quant:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP.md, Queue 1)")
    K, Dh = cfg.n_kv_heads, cfg.d_head
    return {"k": torch.zeros((batch, max_len, K, Dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, max_len, K, Dh), dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
