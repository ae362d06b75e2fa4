"""Core layer primitives of the dense decoder family.

Plain functions on tensors: ``init_*`` builds a nested dict of tensors,
``apply``-style functions take (params, x, ...). Weight layouts are the JAX
package's, leaf for leaf:

  embed:        (vocab, d_model)
  attn q/k/v:   (d_model, n_heads, d_head)
  attn out:     (n_heads, d_head, d_model)
  mlp up/gate:  (d_model, d_ff)
  mlp down:     (d_ff, d_model)
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import rmsnorm

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: Optional[torch.Generator], shape: Sequence[int],
               in_axis_size: Optional[int] = None, *,
               dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: std 1/sqrt(fan_in), cut at two standard
    deviations. Drawn in float32 and cast, so a low-precision parameter is
    the rounding of a float32 draw. `generator` lives on `device`."""
    if in_axis_size is None:
        in_axis_size = shape[0]
    std = 1.0 / math.sqrt(max(in_axis_size, 1))
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if w.device.type != "meta":
        torch.nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2.0 * std,
                                    b=2.0 * std, generator=generator)
    return w.to(dtype)


def normal_init(generator: Optional[torch.Generator], shape: Sequence[int],
                *, device=None) -> torch.Tensor:
    """Standard normal draws in float32 (nothing is drawn on the meta
    device). `generator` lives on `device`."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if w.device.type != "meta":
        w.normal_(generator=generator)
    return w


def uniform_init(generator: Optional[torch.Generator], shape: Sequence[int],
                 low: float, high: float, *, device=None) -> torch.Tensor:
    """Uniform draws on [low, high) in float32 (nothing is drawn on the meta
    device). `generator` lives on `device`."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if w.device.type != "meta":
        w.uniform_(low, high, generator=generator)
    return w


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Every norm of the model goes through the kernel's wrapper, which
    launches the CUDA kernel for a CUDA tensor and computes the plain
    version for a CPU tensor."""
    return rmsnorm(x, scale, eps=eps)


# ---------------------------------------------------------------------------
# rotary embeddings: full / partial / 2d (GLM) / none
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, positions: torch.Tensor):
    """(..., dim/2) angle table for given positions (any int tensor);
    angles in float32."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=positions.device) / dim
    inv = 1.0 / (theta ** exponent)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs (x[..., ::2], x[..., 1::2]).
    x: (..., S, H, D) with cos/sin broadcastable (..., S, 1, D/2)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def rotary(x: torch.Tensor, positions: torch.Tensor, kind: str,
           fraction: float, theta: float) -> torch.Tensor:
    """Apply a RoPE variant to (B, S, H, D) given positions (B, S) or (S,).

    kind: "full"    — rotate all dims
          "partial" — rotate the leading `fraction` of dims (nemotron)
          "2d"      — GLM-style, applied as partial(0.5) over interleaved
                      pairs, which is ChatGLM's form for 1-d text positions
          "none"
    """
    if kind == "none":
        return x
    d = x.shape[-1]
    rot = d if kind == "full" else int(d * fraction)
    rot = max(2, (rot // 2) * 2)
    if positions.dim() == 1:
        positions = positions[None, :]
    cos, sin = rope_freqs(rot, theta, positions)      # (B, S, rot/2)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    if rot == d:
        return apply_rope(x, cos, sin)
    xr, xp = x[..., :rot], x[..., rot:]
    return torch.cat([apply_rope(xr, cos, sin), xp], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(generator, d_model: int, d_ff: int, kind: str, *,
             dtype=torch.float32, device=None):
    kw = dict(dtype=dtype, device=device)
    p = {}
    if kind == "swiglu":
        p["gate"] = dense_init(generator, (d_model, d_ff), **kw)
    p["up"] = dense_init(generator, (d_model, d_ff), **kw)
    p["down"] = dense_init(generator, (d_ff, d_model), in_axis_size=d_ff, **kw)
    return p


def mlp(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        g = x @ params["gate"].to(x.dtype)
        u = x @ params["up"].to(x.dtype)
        h = F.silu(g) * u
    elif kind == "relu2":
        h = torch.relu(x @ params["up"].to(x.dtype)).square()
    elif kind == "gelu":
        # the reference's jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["up"].to(x.dtype), approximate="tanh")
    else:
        raise ValueError(kind)
    return h @ params["down"].to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------


def init_embed(generator, vocab: int, d_model: int, *, dtype=torch.float32,
               device=None):
    return dense_init(generator, (vocab, d_model), in_axis_size=d_model,
                      dtype=dtype, device=device)


def embed(table: torch.Tensor, ids: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    # F.embedding's gradient on the card is a sorted segment sum, the same
    # bits on every run (an index_put with atomics would not be)
    return F.embedding(ids, table).to(compute_dtype)


def logits(table_or_head: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, V). Head stored (V, D) (embed layout) or
    (D, V)."""
    w = table_or_head.to(x.dtype)
    if w.shape[0] == x.shape[-1]:
        return x @ w
    return x @ w.t()


def cross_entropy(lg: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean cross entropy with an optional z-loss; labels < 0 are
    masked. The log-sum-exp is taken in float32 over the whole last axis:
    padded vocabulary columns hold -1e30 (``Model._logits``), so their
    exponentials are 0 and they add nothing to it, and no label points at
    them. The target logit is picked by advanced indexing.

    The gradient, (softmax (1 + 2 z_loss lse) - onehot) x mask / count, is
    written into one float32 buffer of the logits' shape (``_CrossEntropyFn``),
    where autograd of the same expressions held four or five at once: at a
    float32 vocabulary of 102400 and 4096 tokens each is 1.56 GiB, and they
    were a train step's peak at shallow depth. The one-hot is subtracted at
    distinct places, so the gradient is the same bits on every run."""
    return _CrossEntropyFn.apply(lg, labels, z_loss)


class _CrossEntropyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lg, labels, z_loss):
        in_dtype = lg.dtype
        lg = lg.float()
        lse = torch.logsumexp(lg, dim=-1)
        flat = lg.reshape(-1, lg.shape[-1])
        rows = torch.arange(flat.shape[0], device=lg.device)
        cols = labels.clamp(min=0).reshape(-1)
        nll = lse - flat[rows, cols].reshape(labels.shape)
        if z_loss:
            nll = nll + z_loss * lse.square()
        mask = (labels >= 0).float()
        count = mask.sum().clamp(min=1.0)
        ctx.save_for_backward(lg, lse, cols, mask, count)
        ctx.z_loss, ctx.in_dtype = z_loss, in_dtype
        return (nll * mask).sum() / count

    @staticmethod
    def backward(ctx, g):
        lg, lse, cols, mask, count = ctx.saved_tensors
        p = (lg - lse[..., None]).contiguous()
        p.exp_()
        if ctx.z_loss:
            p.mul_((1.0 + 2.0 * ctx.z_loss * lse)[..., None])
        flat = p.view(-1, p.shape[-1])
        rows = torch.arange(flat.shape[0], device=p.device)
        flat[rows, cols] -= 1.0
        p.mul_((mask * (g / count))[..., None])
        return p.to(ctx.in_dtype), None, None
