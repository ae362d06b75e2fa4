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

Under a mesh whose 'model' axis splits the heads (``wk``'s block holds
fewer than H), a layer runs on this rank's blocks as ``sharding.rules``
lays them out: ``wk``, ``wv``, ``w_lora_b``, ``u`` and ``w0`` split on the
heads, ``wg`` on its columns (d is head-major, so they line up with the
heads); ``wr``, ``w_lora_a``, ``ln_x`` and the mixes replicated, this
rank's heads sliced out of them. The recurrence and the per-head norm run
on this rank's heads, and ``(y * g) @ wo`` on this rank's rows of the
layer's ``wo`` is a partial sum, all-reduced over 'model'. The stacked
``wo`` (L, d, d) is split on its LAYER axis by the rules (its first
matching rule is attention's ``("model", None, None)``): the rank that
owns layer l holds it whole, and ``wo_rows`` moves the rows each rank
reads from the owner, one layer at a time, by a reduce-scatter whose
backward all-gathers the gradient back onto the owner's block. The
channel mix is a Megatron pair: ``cm_k`` split on its columns, ``cm_v`` on
its rows and its output all-reduced, ``cm_r`` replicated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.wkv6 import wkv6, wkv_chunked
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C


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


def _decay(params, lo):
    """Data-dependent log-decay lw (B,S,H,K) float32, < 0, of the LoRA's
    hidden lo = tanh(xw @ w_lora_a)."""
    _, H, K = params["w_lora_b"].shape
    ww = params["w0"].float() + _heads(lo, params["w_lora_b"], H, K).float()
    return -torch.exp(ww)          # log w_t = -exp(ww)  =>  w in (0,1)


def heads_split(params, cfg: ModelConfig, mesh) -> bool:
    """Whether this rank holds a block of the heads over 'model'."""
    return mesh is not None and params["wk"].shape[-2] != cfg.n_heads


def wo_rows(w, cfg: ModelConfig, mesh, like=None):
    """The rows of a layer's ``wo`` (d, d) that this rank's heads read: `w`
    whole on one device or where the heads are whole; this rank's heads'
    rows of it where 'model' splits the heads. With `like` None every rank
    holds the layer's `w` (a replicated leaf: the rows are sliced, their
    gradient summed over 'model'); else only the rank that owns the layer
    does (the leaf split on its layer axis; `w` None on the others, `like`
    a layer of this rank's own block), and the rows move from it by a
    reduce-scatter over 'model' of its `w` and zeros on the others, whose
    backward all-gathers the gradient back onto the owner's block. A rank
    makes one layer's (d, d) beyond its own blocks at a time."""
    n = C.axis_size(mesh, "model")
    by_heads = n > 1 and cfg.n_heads % n == 0
    if like is None:
        if not by_heads:
            return w
        rows = w.shape[0] // n
        r = C.axis_index(mesh, "model")
        return C.enter_split(w, mesh, "model")[r * rows:(r + 1) * rows]
    if w is None:
        # zeros on the graph of this rank's own block, as the owner's
        # block is, so that every rank's reduce-scatter has a backward
        # (its all-gather) wherever the owner's does: a collective on one
        # rank alone would wait for the others forever. Their gradient
        # adds exact zeros to this rank's block.
        w = like * 0
    if not by_heads:
        return C.all_reduce(w, mesh, "model")
    return C.reduce_scatter(w, mesh, "model", 0)


def time_mix(params, x, cfg: ModelConfig, run: RunConfig, state=None,
             shift_last=None, update_state: bool = False, mesh=None):
    """WKV6 time-mix over a sequence. Returns (out, (new_state, new_last)).
    With `update_state` the new state is written into `state` itself (the
    decode path's cache) and that tensor is returned. params["wo"] is the
    layer's rows of wo that this rank reads (``wo_rows``); over a mesh that
    splits the heads, `state` is this rank's heads' and the output is
    all-reduced over 'model'."""
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
    lo = torch.tanh(xw @ params["w_lora_a"].to(x.dtype))
    wr, ln_x = params["wr"], params["ln_x"]
    split = heads_split(params, cfg, mesh)
    if split:
        # the replicated inputs enter the split; this rank's heads' slices
        # of the replicated weights are summed over 'model' in the backward
        xr, xk, xv, xg, lo = (C.enter_split(t, mesh, "model")
                              for t in (xr, xk, xv, xg, lo))
        H = params["wk"].shape[-2]
        h0 = C.axis_index(mesh, "model") * H
        wr = C.enter_split(wr, mesh, "model")[:, h0:h0 + H]
        ln_x = C.enter_split(ln_x, mesh, "model")[h0 * K:(h0 + H) * K]
    r = _heads(xr, wr, H, K)
    k = _heads(xk, params["wk"], H, K)
    v = _heads(xv, params["wv"], H, K)
    g = F.silu(xg @ params["wg"].to(x.dtype))
    lw = _decay(params, lo)                                   # (B,S,H,K) f32
    u = params["u"].float()
    state_out = state if update_state else None
    if run.attn_impl == "kernel":
        y, new_state = wkv6(r, k, v, lw, u, state=state, state_out=state_out)
    else:
        y, new_state = wkv_chunked(r, k, v, lw, u, chunk=16, state=state)
        if state_out is not None:
            new_state = state_out.copy_(new_state)
    y = y.reshape(B, S, H * K).to(x.dtype)
    # per-head group norm, statistics in float32
    yh = y.reshape(B, S, H, K)
    y32 = yh.float()
    mu = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    yh = ((yh - mu) * torch.rsqrt(var + 64e-5)).to(x.dtype)
    y = yh.reshape(B, S, H * K) * ln_x.to(x.dtype)
    out = (y * g) @ params["wo"].to(x.dtype)
    if split:
        out = C.all_reduce(out, mesh, "model")
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


def channel_mix(params, x, state_last=None, cfg: ModelConfig = None,
                mesh=None):
    """Squared-ReLU channel mix; over a mesh whose 'model' axis splits
    ``cm_k``'s columns (`cfg` names the whole d_ff), the Megatron pair."""
    xp = _token_shift(x, state_last)
    mix = params["cm_mix"].to(x.dtype)
    xk = x + (xp - x) * mix[0]
    xr = x + (xp - x) * mix[1]
    split = mesh is not None and params["cm_k"].shape[-1] != cfg.d_ff
    if split:
        xk = C.enter_split(xk, mesh, "model")
    kk = torch.relu(xk @ params["cm_k"].to(x.dtype)).square()
    vv = kk @ params["cm_v"].to(x.dtype)
    if split:
        vv = C.all_reduce(vv, mesh, "model")
    rr = torch.sigmoid(xr @ params["cm_r"].to(x.dtype))
    return vv * rr, x[:, -1, :]


def rwkv_block(params, x, cfg: ModelConfig, run: RunConfig, norms,
               mesh=None):
    """Full RWKV6 layer: ln1 -> time-mix -> residual; ln2 -> channel-mix.
    params["wo"] is the layer's rows of wo (``wo_rows``)."""
    h, _ = time_mix(params, L.rms_norm(x, norms["ln1"], cfg.norm_eps), cfg,
                    run, mesh=mesh)
    x = x + h
    h, _ = channel_mix(params, L.rms_norm(x, norms["ln2"], cfg.norm_eps),
                       cfg=cfg, mesh=mesh)
    return x + h


def rwkv_block_decode(params, x, cache, cfg: ModelConfig, run: RunConfig,
                      norms, mesh=None):
    """One-token decode. cache: {"wkv": (B,H,K,K) float32, "tm_last": (B,d),
    "cm_last": (B,d)}, updated IN PLACE (the wkv state by the kernel itself)
    and handed back; over a mesh, wkv holds this rank's heads."""
    xn = L.rms_norm(x, norms["ln1"], cfg.norm_eps)
    h, (_, tm_last) = time_mix(params, xn, cfg, run, state=cache["wkv"],
                               shift_last=cache["tm_last"], update_state=True,
                               mesh=mesh)
    cache["tm_last"].copy_(tm_last)
    x = x + h
    xn = L.rms_norm(x, norms["ln2"], cfg.norm_eps)
    h, cm_last = channel_mix(params, xn, state_last=cache["cm_last"],
                             cfg=cfg, mesh=mesh)
    cache["cm_last"].copy_(cm_last)
    return x + h, cache


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype, *, device=None):
    d, H = cfg.d_model, cfg.n_heads
    K = d // H
    return {"wkv": torch.zeros((batch, H, K, K), dtype=torch.float32,
                               device=device),
            "tm_last": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_last": torch.zeros((batch, d), dtype=dtype, device=device)}
