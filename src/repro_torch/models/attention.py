"""Grouped-query attention, DeepSeek-V3's multi-head latent attention
(MLA) and the cross-attention of the VLM and enc-dec families: full
sequence, prefill and one-token decode.

``RunConfig.attn_impl`` selects the softmax core for a full sequence:
``"kernel"`` is the hand-written flash-attention kernel
(``repro_torch.kernels.flash_attention``, inference only: it has no backward
yet), ``"full"`` the plain version that builds the score matrix,
``"blocked"`` and ``"zigzag"`` the reference's online-softmax walk over
blocks of queries and keys in plain tensor code (what its trainer takes
above 512 tokens). ``gqa_prefill`` honours the setting exactly as ``gqa``
does. Decode attention over the cache is plain tensor code.

MLA runs its softmax core through the same switch, at the combined q/k dim
(128 + 64 = 192 at deepseek-v3) with v zero-padded to it and the output
sliced after, as the reference does; its decode attends over the
compressed cache {ckv, kr} with wuk and wuv absorbed (plain tensor code).

Cross-attention (llama-3.2-vision's tanh-gated media layers, whisper's
decoder over the encoder's output) takes its keys and values from a media
or encoder tensor and is never causal. Its core is the same switch, at a
full sequence and at a one-row decode query alike: on the card the flash
kernel, where the reference takes ``full_attention`` up to 4096 query rows.
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


# ---------------------------------------------------------------------------
# Cross-attention (vision / enc-dec): keys and values from media or encoder
# embeddings, recomputed at every call, as in the reference
# ---------------------------------------------------------------------------


def init_cross_attn(generator, cfg: ModelConfig, *, dtype=torch.float32,
                    device=None):
    """GQA's four weights and llama-vision's tanh gate, a 0-d leaf that
    starts at 0 (so that the layer adds nothing until trained)."""
    p = init_gqa(generator, cfg, dtype=dtype, device=device)
    p["gate"] = torch.zeros((), dtype=dtype, device=device)
    return p


def cross_attn_kv(params, media):
    """media (B, M, d) -> k, v (B, M, K, Dh), each contiguous."""
    B, M, d = media.shape
    _, K, Dh = params["wk"].shape
    k = media @ params["wk"].to(media.dtype).reshape(d, K * Dh)
    v = media @ params["wv"].to(media.dtype).reshape(d, K * Dh)
    return k.view(B, M, K, Dh), v.view(B, M, K, Dh)


def cross_attn(params, x, kv, run: RunConfig, gated: bool = True):
    """x (B, S, d) attends to every key of kv (non-causal), S >= 1; the
    output is scaled by tanh(gate) when `gated`. The softmax core is
    `run.attn_impl`'s, one call for a sequence and for a decode step."""
    k, v = kv
    B, S, d = x.shape
    _, H, Dh = params["wq"].shape
    q = (x @ params["wq"].to(x.dtype).reshape(d, H * Dh)).view(B, S, H, Dh)
    out = _project_out(params, _sequence_attention(q, k, v, run,
                                                   causal=False), x)
    if gated:
        out = torch.tanh(params["gate"]).to(x.dtype) * out
    return out


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(generator, cfg: ModelConfig, *, dtype=torch.float32,
             device=None):
    """MLA weights. Nothing sizes from cfg.d_head (deepseek-v3's default,
    d_model / n_heads = 56, is no head size of MLA's)."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "wdq": L.dense_init(generator, (d, m.q_lora_rank), **kw),
        "q_norm": torch.ones((m.q_lora_rank,), **kw),
        "wuq": L.dense_init(generator, (m.q_lora_rank, H, qk),
                            in_axis_size=m.q_lora_rank, **kw),
        "wdkv": L.dense_init(generator, (d, m.kv_lora_rank), **kw),
        "kv_norm": torch.ones((m.kv_lora_rank,), **kw),
        "wuk": L.dense_init(generator, (m.kv_lora_rank, H, m.qk_nope_dim),
                            in_axis_size=m.kv_lora_rank, **kw),
        "wuv": L.dense_init(generator, (m.kv_lora_rank, H, m.v_head_dim),
                            in_axis_size=m.kv_lora_rank, **kw),
        "wkr": L.dense_init(generator, (d, m.qk_rope_dim), **kw),
        "wo": L.dense_init(generator, (H, m.v_head_dim, d),
                           in_axis_size=H * m.v_head_dim, **kw),
    }


def _heads(a, w):
    """a (..., r) times w (r, H, k) -> (..., H, k)."""
    r, H, k = w.shape
    return (a @ w.to(a.dtype).reshape(r, H * k)).view(*a.shape[:-1], H, k)


def _mla_q(params, x, cfg: ModelConfig, positions):
    m = cfg.mla
    cq = L.rms_norm(x @ params["wdq"].to(x.dtype), params["q_norm"],
                    cfg.norm_eps)
    q = _heads(cq, params["wuq"])
    q_rope = L.rotary(q[..., m.qk_nope_dim:], positions, "full", 1.0,
                      cfg.rope_theta)
    return q[..., :m.qk_nope_dim], q_rope


def _mla_latent(params, x, cfg: ModelConfig, positions):
    ckv = L.rms_norm(x @ params["wdkv"].to(x.dtype), params["kv_norm"],
                     cfg.norm_eps)
    kr = x @ params["wkr"].to(x.dtype)
    kr = L.rotary(kr[:, :, None, :], positions, "full", 1.0,
                  cfg.rope_theta)[:, :, 0, :]
    return ckv, kr


def _mla_core(params, x, cfg: ModelConfig, run: RunConfig, positions,
              causal: bool):
    """(out, (ckv, kr)): the latents are computed once, for the attention
    and for a prefill's cache."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    ckv, kr = _mla_latent(params, x, cfg, positions)
    k_nope = _heads(ckv, params["wuk"])
    v = _heads(ckv, params["wuv"])
    # q, k and the padded v are contiguous: the kernel reads them by strides
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, m.qk_rope_dim)],
                  dim=-1)
    qk = m.qk_nope_dim + m.qk_rope_dim
    if m.v_head_dim != qk:
        v = F.pad(v, (0, qk - m.v_head_dim))
    o = _sequence_attention(q, k, v, run, causal=causal)[..., :m.v_head_dim]
    return _project_out(params, o, x), (ckv, kr)


def mla(params, x, cfg: ModelConfig, run: RunConfig, *, positions=None,
        causal: bool = True):
    """MLA over a full sequence: the latents expanded to per-head k and v,
    the softmax core (`run.attn_impl`) over the combined (nope | rope) q/k
    dim, v zero-padded to it and the output sliced back."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _mla_core(params, x, cfg, run, positions, causal)[0]


def mla_prefill(params, x, cfg: ModelConfig, run: RunConfig, *,
                positions=None, pad_to: int = 0):
    """MLA forward that also emits the latent cache (ckv (B, max(S, pad_to),
    r), kr (B, max(S, pad_to), rope)). The reference computes the latents a
    second time for the cache; here the attention's are kept."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    out, (ckv, kr) = _mla_core(params, x, cfg, run, positions, True)
    if pad_to > S:
        ckv = F.pad(ckv, (0, 0, 0, pad_to - S))
        kr = F.pad(kr, (0, 0, 0, pad_to - S))
    return out, (ckv, kr)


def mla_decode(params, x, cache, cfg: ModelConfig, run: RunConfig):
    """Absorbed-latent decode over the cache {"ckv": (B, Smax, r), "kr":
    (B, Smax, rope), "pos": (B,) int32}: only the compressed latent and the
    rotated key are cached, wuk is absorbed into q and wuv into the output.
    ckv and kr are updated IN PLACE (a row whose pos is at or past Smax
    writes nothing, as in ``gqa_decode``) and handed back beside a new
    pos."""
    m = cfg.mla
    B = x.shape[0]
    pos = cache["pos"]
    positions = pos[:, None]
    q_nope, q_rope = _mla_q(params, x, cfg, positions)       # (B, 1, H, *)
    ckv_t, kr_t = _mla_latent(params, x, cfg, positions)     # (B, 1, *)
    ckv, kr = cache["ckv"], cache["kr"]
    smax = ckv.shape[1]
    rows = torch.arange(B, device=x.device)
    in_range = pos < smax
    idx = torch.where(in_range, pos, torch.zeros_like(pos)).long()
    keep = in_range[:, None]
    ckv[rows, idx] = torch.where(keep, ckv_t[:, 0].to(ckv.dtype), ckv[rows, idx])
    kr[rows, idx] = torch.where(keep, kr_t[:, 0].to(kr.dtype), kr[rows, idx])
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope,
                         params["wuk"].to(x.dtype))
    s = torch.einsum("bshr,btr->bhst", q_lat, ckv.to(x.dtype)) + \
        torch.einsum("bshk,btk->bhst", q_rope, kr.to(x.dtype))
    s = s.float() / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    visible = torch.arange(smax, device=x.device)[None, None, None, :] <= \
        pos[:, None, None, None]
    s = s.masked_fill(~visible, NEG_INF)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhst,btr->bshr", p, ckv.to(x.dtype))
    o = torch.einsum("bshr,rhk->bshk", ctx, params["wuv"].to(x.dtype))
    return _project_out(params, o, x), {"ckv": ckv, "kr": kr, "pos": pos + 1}


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                   device=None):
    m = cfg.mla
    kw = dict(dtype=dtype, device=device)
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank), **kw),
            "kr": torch.zeros((batch, max_len, m.qk_rope_dim), **kw),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
