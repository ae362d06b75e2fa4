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

Under a mesh whose 'model' axis splits the heads (``A_log``'s block holds
fewer than H), a block runs on this rank's blocks as ``sharding.rules``
lays them out. ``in_proj``'s columns and ``conv_w``'s channels are split in
contiguous blocks that do not line up with the heads (at zamba2-7b over
two ranks, 7288 of the 14576 z | x | B | C | dt columns, and 3648 of the
7296 conv channels, 57 heads' worth of x), so the block's projection is
all-gathered over 'model' (its backward reduce-scatters the gradient),
as are conv_w and conv_b, and each rank takes its own heads' z, x and dt
and the whole B and C (``_own_columns``). The causal conv runs on its x
channels and on B and C, ``ssd`` on its heads (``A_log``, ``D``,
``dt_bias`` and ``out_proj``'s rows are split on the heads). The gated
norm is an RMSNorm over the whole d_inner row: y * silu(z) is all-gathered
over 'model' and normalised whole by the rmsnorm kernel (at the width of
one device), and this rank keeps its columns; ``out_proj`` gives a partial
sum, all-reduced over 'model'. (The other way, an all-reduce of the
partial sums of squares and a kernel entry point that takes the
statistic, moves a scalar a row where this moves half the row; this one
needs no new kernel and runs the one the model already runs, at the same
width, and its gather is half the size of in_proj's.) A decode step
gathers the conv cache, split in channel blocks as conv_w is, and writes
back its own block.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.ssd import ssd, ssd_chunked
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C


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


def _whole(t, full: int, mesh, dim: int = -1):
    """A leaf that this rank's heads read a part of, whole: all-gathered
    over 'model' along `dim` where the rules split it (its size there is
    not `full`; the backward reduce-scatters the gradient), else entering
    the split (the backward sums the ranks' gradients)."""
    if t.shape[dim] == full:
        return C.enter_split(t, mesh, "model")
    return C.all_gather(t, mesh, "model", dim % t.dim())


def _own_columns(cfg: ModelConfig, H: int, h0: int, device):
    """The indices of this rank's heads h0 .. h0 + H - 1 in the whole
    projection's z and x and in the conv's channels (x, then the whole B
    and C), and of its heads' dt: (z, conv channels, dt)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    gN = s.n_groups * s.d_state
    P = s.head_dim
    heads = torch.arange(h0 * P, (h0 + H) * P, device=device)
    bc = torch.arange(d_inner, d_inner + 2 * gN, device=device)
    conv = torch.cat([heads, bc])
    return heads, conv, 2 * d_inner + 2 * gN + h0 + \
        torch.arange(H, device=device)


def heads_split(params, cfg: ModelConfig, mesh) -> bool:
    """Whether this rank holds a block of the heads over 'model'."""
    s = cfg.ssm
    return mesh is not None and \
        params["A_log"].shape[-1] != s.expand * cfg.d_model // s.head_dim


def _project(params, x, cfg: ModelConfig, mesh):
    """(z, xBC, dt, conv_w, conv_b, d_inner, H, gN, xBC_whole): the
    in-projection of x split as ``_split_in_proj`` splits it and the conv's
    weights, of this rank's heads (``_own_columns``) where the mesh splits
    them; xBC_whole, the conv's input over every channel there (a decode
    step's next window), else None."""
    s = cfg.ssm
    conv_w, conv_b = params["conv_w"], params["conv_b"]
    if not heads_split(params, cfg, mesh):
        z, xBC, dt, d_inner, H, gN = _split_in_proj(
            cfg, x @ params["in_proj"].to(x.dtype))
        return z, xBC, dt, conv_w, conv_b, d_inner, H, gN, None
    d_inner = s.expand * cfg.d_model
    gN = s.n_groups * s.d_state
    H = params["A_log"].shape[-1]
    h0 = C.axis_index(mesh, "model") * H
    cols = 2 * d_inner + 2 * gN + d_inner // s.head_dim
    x = C.enter_split(x, mesh, "model")
    w = params["in_proj"]
    if w.shape[-1] == cols:
        proj = x @ C.enter_split(w, mesh, "model").to(x.dtype)
    else:
        proj = C.all_gather(x @ w.to(x.dtype), mesh, "model", x.dim() - 1)
    zi, ci, di = _own_columns(cfg, H, h0, x.device)
    conv_dim = d_inner + 2 * gN
    conv_w = _whole(conv_w, conv_dim, mesh)[:, ci]
    conv_b = _whole(conv_b, conv_dim, mesh)[ci]
    return (proj[..., zi], proj[..., d_inner + ci], proj[..., di], conv_w,
            conv_b, H * s.head_dim, H, gN, proj[..., d_inner:d_inner +
                                                 conv_dim])


def _gated_norm_out(params, y, z, cfg: ModelConfig, mesh, split: bool):
    """rms_norm(y * silu(z)) over the whole d_inner row, then out_proj:
    where the heads are split, y * silu(z) and ssm_norm are all-gathered
    over 'model', normalised whole, this rank's columns kept, and
    out_proj's partial sum all-reduced."""
    g = y * F.silu(z)
    if not split:
        return L.rms_norm(g, params["ssm_norm"], cfg.norm_eps) @ \
            params["out_proj"].to(y.dtype)
    width = g.shape[-1]
    d_inner = cfg.ssm.expand * cfg.d_model
    r = C.axis_index(mesh, "model")
    g = L.rms_norm(C.all_gather(g, mesh, "model", g.dim() - 1),
                   _whole(params["ssm_norm"], d_inner, mesh), cfg.norm_eps)
    out = g[..., r * width:(r + 1) * width] @ params["out_proj"].to(y.dtype)
    return C.all_reduce(out, mesh, "model")


def mamba2(params, x, cfg: ModelConfig, run: RunConfig, mesh=None):
    """Full-sequence (prefill) Mamba2 block. x: (B,S,d) -> (B,S,d); under a
    mesh, on this rank's heads (see the module's docstring)."""
    s = cfg.ssm
    B, S, d = x.shape
    split = heads_split(params, cfg, mesh)
    z, xBC, dt, conv_w, conv_b, d_inner, H, gN, _ = _project(params, x, cfg,
                                                             mesh)
    xBC = F.silu(_causal_conv(xBC, conv_w.to(x.dtype), conv_b.to(x.dtype)))
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
    return _gated_norm_out(params, y, z, cfg, mesh, split)


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


def mamba2_decode(params, x, cache, cfg: ModelConfig, run: RunConfig,
                  mesh=None):
    """One-token decode. cache: {"h": (B,H,N,P) float32, "conv":
    (B,W-1,conv_dim)}, updated IN PLACE and handed back. Under a mesh that
    splits the heads, h is this rank's heads' and conv this rank's block of
    the channels (as conv_w's): the window is gathered whole, and this
    rank writes back its own block of the next one."""
    s = cfg.ssm
    B = x.shape[0]
    split = heads_split(params, cfg, mesh)
    z, xBC, dt, conv_w, conv_b, d_inner, H, gN, xBC_all = _project(
        params, x, cfg, mesh)
    # conv with the carried window
    conv = cache["conv"]
    if split:
        # the whole window (B, W, C), this rank's heads' channels of it,
        # and the next one's block of the channels that this rank holds
        whole = torch.cat([_whole(conv, xBC_all.shape[-1], mesh),
                           xBC_all.to(conv.dtype)], dim=1)
        _, ci, _ = _own_columns(cfg, H, C.axis_index(mesh, "model") * H,
                                x.device)
        win = whole[..., ci]
        blk, r = conv.shape[-1], C.axis_index(mesh, "model")
        nxt = whole[:, 1:] if blk == whole.shape[-1] else \
            whole[:, 1:, r * blk:(r + 1) * blk]
    else:
        win = torch.cat([conv, xBC.to(conv.dtype)], dim=1)       # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", win, conv_w.to(win.dtype))
    xBC = F.silu(conv_out + conv_b.to(win.dtype))[:, None, :]
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
    out = _gated_norm_out(params, y, z, cfg, mesh, split)
    cache["h"].copy_(h)
    conv.copy_(nxt if split else win[:, 1:])
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
