"""Frozen model FLOP counts, by family, from a configuration file's sizes.

Only products count, two operations a multiply-add: the projections, the
MLP or the routed experts a token is sent to (top_k of them, and the router),
the two attention products over the (query, key) pairs the causal mask
leaves, and the output head. Norms, RoPE, softmax and the embedding lookup
are left out. A training step's useful work is three times its forward's
(forward, and the backward's two products a forward product), with no
recompute under remat.
"""
from __future__ import annotations

from portbench.counts.kernels import attention_pairs


def _head_dim(cfg: dict) -> int:
    return cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"]


def layer_flops_per_token(cfg: dict) -> float:
    """Operations of one layer's products for one token, attention's
    score and value products left out."""
    d, H, K, D = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        _head_dim(cfg)
    attn = 2 * d * (H * D + 2 * K * D) + 2 * H * D * d
    moe = cfg.get("moe")
    if cfg["family"] == "moe":
        ffn = 2 * d * moe["n_experts"] + \
            moe["top_k"] * 3 * 2 * d * moe["d_ff_expert"]
    elif cfg["family"] == "dense":
        ffn = 3 * 2 * d * cfg["d_ff"]
    else:
        raise ValueError(f"no count for family {cfg['family']!r}")
    return float(attn + ffn)


def attention_flops(cfg: dict, B: int, S: int) -> float:
    """Both attention products of one layer over B causal sequences of S."""
    return 4.0 * _head_dim(cfg) * cfg["n_heads"] * B * \
        attention_pairs(S, S, True)


def forward_flops(cfg: dict, B: int, S: int, head_rows: int) -> float:
    """A forward over B x S tokens through `cfg["n_layers"]` layers, with the
    head over `head_rows` rows."""
    L = cfg["n_layers"]
    return L * (B * S * layer_flops_per_token(cfg) +
                attention_flops(cfg, B, S)) + \
        2.0 * head_rows * cfg["d_model"] * cfg["vocab_size"]


def prefill_flops(cfg: dict, B: int, S: int) -> float:
    """A prefill: the whole stack over every prompt token, the head over
    the last position of each prompt."""
    return forward_flops(cfg, B, S, head_rows=B)


def train_flops(cfg: dict, B: int, S: int) -> float:
    """One training step's useful work: three forwards' products, the head
    over every position."""
    return 3.0 * forward_flops(cfg, B, S, head_rows=B * S)
