"""Plain PyTorch reference of one training step of a dense decoder under
AdamW, in float32 with TF32 off.

The forward is ``reference.transformer``'s (pre-norm RMSNorm blocks, RoPE,
causal softmax attention, SwiGLU MLP, final norm, untied head) over every
position, the loss the token mean of the cross entropy of each position's
logits against its label, and the gradients autograd's, one layer's
activations recomputed at a time (``torch.utils.checkpoint``) so that a
deep job fits beside its weights. The optimizer step is AdamW as the job
states it (the traffic file's ``optimizer``): the gradient scaled by
min(1, clip / (|g| + 1e-9)) over all leaves, moments from zero, bias
corrections at step 1, decoupled decay, and the learning rate of the
warmup-cosine schedule at step 0. This module imports nothing of the
program.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.transformer import (Precision, attention, rms_norm,
                                             rope, swiglu)

CHUNK = 1 << 26


def sum_squares(t: torch.Tensor) -> float:
    """The sum of squares of every entry in float64, a chunk at a time."""
    flat = t.detach().reshape(-1)
    return float(sum(torch.sum(torch.square(c.double()))
                     for c in flat.split(CHUNK)))


def norm(t: torch.Tensor) -> float:
    return math.sqrt(sum_squares(t))


def _layer(x, lw, cfg, positions, p):
    B, S, d = x.shape
    H, K = cfg["n_heads"], cfg["n_kv_heads"]
    D = cfg.get("d_head") or d // H
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    h = rms_norm(x, lw["ln1"], eps).reshape(B * S, d)
    q = p.mm(h, lw["attn.wq"].reshape(d, H * D)).view(B, S, H, D)
    k = p.mm(h, lw["attn.wk"].reshape(d, K * D)).view(B, S, K, D)
    v = p.mm(h, lw["attn.wv"].reshape(d, K * D)).view(B, S, K, D)
    q, k = rope(q, positions, theta), rope(k, positions, theta)
    o = attention(q, k, v, p).reshape(B * S, H * D)
    x = x + p.mm(o, lw["attn.wo"].reshape(H * D, d)).view(B, S, d)
    h = rms_norm(x, lw["ln2"], eps).reshape(B * S, d)
    y = swiglu(h, lw["mlp.gate"], lw["mlp.up"], lw["mlp.down"], p)
    return x + y.view(B, S, d)


def loss(weights: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy of a dense decoder's logits at every
    position against `labels` (B, S); `weights` float32, named as
    ``portbench.weights.leaves``."""
    if cfg["family"] != "dense":
        raise ValueError(f"no training reference for {cfg['family']!r}")
    p = Precision("float32")
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x = weights["embed"][tokens.long()]
    for layer in range(cfg["n_layers"]):
        lw = {name[len("layers."):]: t[layer]
              for name, t in weights.items() if name.startswith("layers.")}
        x = checkpoint(_layer, x, lw, cfg, positions, p, use_reentrant=False)
    h = rms_norm(x, weights["norm"], cfg["norm_eps"])
    head = weights["embed" if cfg.get("tie_embeddings") else "head"]
    logits = p.mm(h.reshape(B * S, -1), head.t())[:, :cfg["vocab_size"]]
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.reshape(-1, 1).long())[:, 0]
    return (lse - picked).mean()


def lr_scale(step: int, opt: dict) -> float:
    """The warmup-cosine schedule's scale of the learning rate at `step`:
    linear from 0 over ``warmup`` steps, then cosine down to ``floor``."""
    warm = min(step / max(opt["warmup"], 1), 1.0)
    frac = min(max((step - opt["warmup"]) /
                   max(opt["total_steps"] - opt["warmup"], 1), 0.0), 1.0)
    return warm * (opt["floor"] + (1 - opt["floor"]) * 0.5 *
                   (1 + math.cos(math.pi * frac)))


def first_step(weights: Dict[str, torch.Tensor], cfg: dict,
               tokens: torch.Tensor, labels: torch.Tensor, opt: dict,
               scale_lr: Optional[float] = None) -> Dict[str, object]:
    """One AdamW step from zeroed moments -> {"loss", "grad": {leaf: the norm
    of the gradient as the optimizer takes it, clip applied}, "change":
    {leaf: the norm of the parameter's change}}. The learning rate is the
    schedule's at step 0 (`scale_lr`: that scale of it instead). `weights`
    are not changed."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        leaves = {n: t.detach().requires_grad_(True)
                  for n, t in weights.items()}
        value = loss(leaves, cfg, tokens, labels)
        grads = torch.autograd.grad(value, list(leaves.values()))
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    names = list(leaves)
    del leaves
    sq = {n: sum_squares(g) for n, g in zip(names, grads)}
    scale = min(1.0, opt["clip_norm"] / (math.sqrt(sum(sq.values())) + 1e-9))
    lr = opt["lr"] * (lr_scale(0, opt) if scale_lr is None else scale_lr)
    b1, b2 = opt["b1"], opt["b2"]
    change = {}
    with torch.no_grad():
        for n, g in zip(names, grads):
            p0 = weights[n]
            gs = g * scale
            m, v = (1 - b1) * gs, (1 - b2) * gs * gs
            step = lr * (m / (1 - b1) / ((v / (1 - b2)).sqrt() + opt["eps"])
                         + opt["weight_decay"] * p0)
            change[n] = norm(step)
            del gs, m, v, step
    return {"loss": float(value.detach()),
            "grad": {n: math.sqrt(sq[n]) * scale for n in names},
            "change": change}


def worst_leaf(mine: Dict[str, float], theirs: Dict[str, float],
               skip: Iterable[str] = ()) -> float:
    """max over leaves of |mine - theirs| / max(theirs, the median leaf's
    theirs), leaves in `skip` left out; a leaf the program lacks is inf.
    Where every reference value is 0, any departure is inf."""
    keep = [n for n in theirs if n not in set(skip)]
    if not keep:
        return float("inf")
    vals = sorted(theirs[n] for n in keep)
    median = vals[len(vals) // 2]
    out = 0.0
    for n in keep:
        if n not in mine or not math.isfinite(mine[n]):
            return float("inf")
        gap = abs(mine[n] - theirs[n])
        den = max(theirs[n], median)
        out = max(out, gap / den if den > 0 else
                  (0.0 if gap == 0 else float("inf")))
    return out
