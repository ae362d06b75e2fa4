"""Grouped-query attention: full sequence, prefill and one-token decode.

``RunConfig.attn_impl`` selects the softmax core for a full sequence:
``"kernel"`` is the hand-written flash-attention kernel
(``repro_torch.kernels.flash_attention``, inference only: it has no backward
yet), ``"full"`` the plain version that builds the score matrix,
``"blocked"`` and ``"zigzag"`` the reference's online-softmax walk over
blocks of queries and keys in plain tensor code (what its trainer takes
above 512 tokens). ``gqa_prefill`` honours the setting exactly as ``gqa``
does. Decode attention over the cache is plain tensor code.
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


def _fresh(B, K, G, bq, D, device):
    """(m, l, acc) of an online softmax that has seen no key yet."""
    return (torch.full((B, K, G, bq), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((B, K, G, bq), dtype=torch.float32, device=device),
            torch.zeros((B, K, G, bq, D), dtype=torch.float32, device=device))


def _online_update(carry, qb, kb, vb, bias, scale):
    """Fold one block of keys into (m, l, acc) for the queries qb
    (B, bq, K, G, D); bias (bq, bkv) is 0 where a key is visible and NEG_INF
    where it is masked, or None when every key is visible.

    The reference's update, with two changes that leave every value as it
    is: a masked score is s + NEG_INF (== NEG_INF in float32) rather than a
    select, and its exponential exp(NEG_INF - m) is 0 without the select
    the reference adds. The running maximum is taken off the graph: it only
    keeps exp in range, the output does not depend on it, and autograd
    then neither differentiates it nor saves the block's scores for it."""
    m, l, acc = carry
    s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb).float() * scale
    if bias is not None:
        s = s + bias
    m_new = torch.maximum(m, s.detach().amax(dim=-1))
    msafe = torch.where(m_new > NEG_INF / 2, m_new, torch.zeros_like(m_new))
    p = torch.exp(s - msafe[..., None])
    corr = torch.where(m > NEG_INF / 2, torch.exp(m - msafe),
                       torch.zeros_like(m))
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bkgqs,bskd->bkgqd", p.to(vb.dtype), vb).float()
    return m_new, l_new, acc_new


def _finish(carry, dtype):
    m, l, acc = carry
    return (acc / l.clamp(min=1e-30)[..., None]).to(dtype)


def _block_bias(q0, bq, k0, bkv, device, limit=None):
    """The additive mask of the block of queries q0 .. q0 + bq - 1 and keys
    k0 .. k0 + bkv - 1: NEG_INF where the key is after the query (causal,
    limit None) or at or past `limit` (padding), else 0; None when every key
    is visible. Decided on the host from the positions alone."""
    if (k0 + bkv - 1 <= q0) if limit is None else (k0 + bkv <= limit):
        return None
    kpos = k0 + torch.arange(bkv, device=device)
    if limit is None:
        qpos = q0 + torch.arange(bq, device=device)
        visible = qpos[:, None] >= kpos[None, :]
    else:
        visible = (kpos < limit)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(visible, zero, zero + NEG_INF)


def blocked_attention(q, k, v, *, causal: bool, block_q: int, block_kv: int,
                      q_offset: int = 0, zigzag: bool = False):
    """Flash-style attention in plain tensor code: an online softmax over
    blocks of keys for each block of queries. q: (B,Sq,H,D); k, v:
    (B,Sk,K,D) -> (B,Sq,H,D) in q.dtype.

    The reference's ``blocked_attention`` (``src/repro/models/attention.py``),
    with its loops written out: its scan over every key block masks the
    blocks that lie wholly after a causal block of queries, which leaves the
    running sums exactly as they were, so here those blocks are skipped.
    Under autograd each visited block keeps its exponentiated scores, (B, H,
    block_q, block_kv) float32, for the backward: about B * H * Sq * Sk * 2
    bytes a call when causal, twice that when not. With ``causal``,
    ``zigzag`` and an even number of query blocks (Sq == Sk, no offset) the
    reference's zigzag schedule is taken instead: query block p is paired
    with block nq - 1 - p, and two lanes walk the pair's key blocks in the
    same order as the reference's scan; it needs block_q == block_kv.
    """
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Sk)
    pq, pk = (-Sq) % block_q, (-Sk) % block_kv
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = (Sq + pq) // block_q, (Sk + pk) // block_kv
    qg = q.reshape(B, nq, block_q, K, G, D)
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    def kv_block(j):
        return (k[:, j * block_kv:(j + 1) * block_kv],
                v[:, j * block_kv:(j + 1) * block_kv])

    if causal and zigzag and nq % 2 == 0 and Sq == Sk and q_offset == 0:
        if block_q != block_kv:
            raise ValueError("zigzag attention requires square blocks "
                             f"(block_q {block_q} != block_kv {block_kv})")
        outs = _zigzag_causal(qg, kv_block, B, nq, nk, block_q, K, G, D,
                              scale, q.dtype)
    else:
        outs = []
        for qi in range(nq):
            q0 = q_offset + qi * block_q
            carry = _fresh(B, K, G, block_q, D, dev)
            for ki in range(nk):
                if causal and ki * block_kv > q0 + block_q - 1:
                    break           # wholly after the block's last query
                bias = _block_bias(q0, block_q, ki * block_kv, block_kv, dev,
                                   None if causal else Sk)
                carry = _online_update(carry, qg[:, qi], *kv_block(ki), bias,
                                       scale)
            outs.append(_finish(carry, q.dtype))
    # (nq, B, K, G, bq, D) -> (B, nq, bq, K, G, D) -> (B, Sq, H, D)
    o = torch.stack(outs).permute(1, 0, 4, 2, 3, 5)
    return o.reshape(B, nq * block_q, H, D)[:, :Sq]


def _zigzag_causal(qg, kv_block, B, nq, nk, bq, K, G, D, scale, dtype):
    """The reference's ``_zigzag_causal``: query block p ("lo") is paired
    with nq - 1 - p ("hi"), which together need nq + 1 key blocks for every
    pair. Step t of T = ceil((nq + 1) / 2): lane A serves lo with key block
    t while t <= p, then hi with key block nq - t from the top where that
    is not lane B's and hi needs it; lane B serves hi with key block t while
    hi needs it. The reference runs every step of both lanes and masks the
    updates that are not due; here they are skipped."""
    half, T = nq // 2, (nq + 2) // 2
    dev = qg.device
    lo_outs, hi_outs = [], []
    for p in range(half):
        lo, hi = qg[:, p], qg[:, nq - 1 - p]
        lo_pos, hi_pos = p * bq, (nq - 1 - p) * bq

        def update(carry, qb, q0, j):
            return _online_update(carry, qb, *kv_block(j),
                                  _block_bias(q0, bq, j * bq, bq, dev), scale)

        cl = _fresh(B, K, G, bq, D, dev)
        ch = _fresh(B, K, G, bq, D, dev)
        for t in range(T):
            if t <= p:
                cl = update(cl, lo, lo_pos, t)
            else:
                j = min(max(nq - t, 0), nk - 1)
                if T - 1 < j <= nq - 1 - p:
                    ch = update(ch, hi, hi_pos, j)
            if t <= nq - 1 - p:
                ch = update(ch, hi, hi_pos, t)
        lo_outs.append(_finish(cl, dtype))
        hi_outs.append(_finish(ch, dtype))
    return lo_outs + hi_outs[::-1]


def _sequence_attention(q, k, v, run: RunConfig, *, causal: bool):
    """The softmax core for a whole sequence, as `run.attn_impl` names it."""
    if run.attn_impl == "kernel":
        return flash_attention(q, k, v, causal=causal)
    if run.attn_impl == "full":
        return full_attention(q, k, v, causal=causal)
    if run.attn_impl in ("blocked", "zigzag"):
        return blocked_attention(q, k, v, causal=causal,
                                 block_q=run.attn_block_q,
                                 block_kv=run.attn_block_kv,
                                 zigzag=run.attn_impl == "zigzag")
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
