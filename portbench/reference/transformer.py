"""Plain PyTorch reference of a decoder-only transformer's prefill, for the
dense and mixture-of-experts families.

It follows the published description of these models (pre-norm blocks with
RMSNorm, rotary embeddings on interleaved pairs, causal softmax attention,
a SwiGLU MLP or top-k routed SwiGLU experts whose gates are the softmax
probabilities of the chosen experts renormalised to sum to one, a final
norm and an untied output head), computed in float32 with TF32 off, one
prompt batch at a time, with no cache, no kernel and no batching beyond the
batch it is given. It imports nothing of the program.

``precision="fp8"`` is the control: every product's operands, and the k and
v it hands back, are rounded to float8 e4m3 (one scale a tensor, from its
largest magnitude), the rest stays in float32, as an fp8 inference path
would run it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """Where the products' operands are rounded: not at all (float32), or
    to float8 e4m3 (the control)."""

    def __init__(self, name: str):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name == "float32" else _round_fp8(t)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self(a) @ self(b)


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """x: (B, S, H, D); rotate the pairs (x[..., 2i], x[..., 2i + 1]) by
    position * theta^(-2i / D)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = positions.float()[:, None] * inv[None, :]          # (S, D/2)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def attention(q, k, v, p: Precision):
    """Causal softmax attention, one sequence and head group at a time.
    q: (B, S, H, D); k, v: (B, S, K, D) -> (B, S, H, D)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    out = torch.empty_like(q)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    for b in range(B):
        for h0 in range(0, H, 8):
            hs = range(h0, min(h0 + 8, H))
            qh = torch.stack([q[b, :, h] for h in hs])          # (h, S, D)
            kh = torch.stack([k[b, :, h // G] for h in hs])
            vh = torch.stack([v[b, :, h // G] for h in hs])
            s = p.mm(qh, kh.transpose(1, 2)) / math.sqrt(D)
            s = s.masked_fill(~mask, float("-inf"))
            o = p.mm(torch.softmax(s, dim=-1), vh)
            for i, h in enumerate(hs):
                out[b, :, h] = o[i]
    return out


def swiglu(x, gate, up, down, p: Precision):
    return p.mm(F.silu(p.mm(x, gate)) * p.mm(x, up), down)


def moe(x, lw: Dict[str, torch.Tensor], m: dict, p: Precision,
        route: Optional[Callable[[torch.Tensor], None]] = None):
    """x: (T, d). Each token's top_k experts by softmax probability, their
    outputs weighted by the chosen probabilities renormalised to sum to 1.
    ``route(margin)`` sees each token's router-logit gap (T,) between its
    top_k-th expert and the next: where it is within rounding, another
    precision may pick the other expert."""
    logits = p.mm(x, lw["moe.router"])
    if route is not None:
        top = torch.topk(logits, m["top_k"] + 1, dim=-1).values
        route(top[:, -2] - top[:, -1])
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, m["top_k"], dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(x[tok], lw["moe.w_gate"][e], lw["moe.w_up"][e],
                   lw["moe.w_down"][e], p)
        out.index_add_(0, tok, y * gates[tok, slot, None])
    return out


def prefill(weights: Dict[str, torch.Tensor], cfg: dict,
            tokens: torch.Tensor, precision: str = "float32",
            observe: Optional[Callable[[int, torch.Tensor, torch.Tensor],
                                       None]] = None,
            route: Optional[Callable[[int, torch.Tensor], None]] = None
            ) -> torch.Tensor:
    """The last position's logits (B, V) of prompts `tokens` (B, S), float32.
    `weights` are float32 tensors named as ``portbench.weights.leaves``.
    ``observe(layer, k, v)`` sees each layer's k (after RoPE) and v,
    (B, S, K, D), as a cache would hold them; ``route(layer, margin)`` each
    MoE layer's router margins (B, S) (``moe``)."""
    p = Precision(precision)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _prefill(weights, cfg, tokens, p, observe, route)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def _prefill(weights, cfg, tokens, p, observe, route):
    B, S = tokens.shape
    d, H, K = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    D = cfg.get("d_head") or d // H
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    positions = torch.arange(S, device=tokens.device)
    x = weights["embed"][tokens.long()]                       # (B, S, d)
    for layer in range(cfg["n_layers"]):
        lw = {name[len("layers."):]: t[layer]
              for name, t in weights.items() if name.startswith("layers.")}
        h = rms_norm(x, lw["ln1"], eps).reshape(B * S, d)
        q = p.mm(h, lw["attn.wq"].reshape(d, H * D)).view(B, S, H, D)
        k = p.mm(h, lw["attn.wk"].reshape(d, K * D)).view(B, S, K, D)
        v = p.mm(h, lw["attn.wv"].reshape(d, K * D)).view(B, S, K, D)
        q, k = rope(q, positions, theta), rope(k, positions, theta)
        k, v = p(k), p(v)
        if observe is not None:
            observe(layer, k, v)
        o = attention(q, k, v, p).reshape(B * S, H * D)
        x = x + p.mm(o, lw["attn.wo"].reshape(H * D, d)).view(B, S, d)
        h = rms_norm(x, lw["ln2"], eps).reshape(B * S, d)
        if cfg["family"] == "moe":
            y = moe(h, lw, cfg["moe"], p, None if route is None else
                    lambda gap, layer=layer: route(layer, gap.view(B, S)))
        else:
            y = swiglu(h, lw["mlp.gate"], lw["mlp.up"], lw["mlp.down"], p)
        x = x + y.view(B, S, d)
    h = rms_norm(x[:, -1], weights["norm"], eps)
    head = weights["embed" if cfg.get("tie_embeddings") else "head"]
    return p.mm(h, head.t())[:, :cfg["vocab_size"]]
