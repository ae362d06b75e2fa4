"""The benchmark's weights, drawn from the seed on the device.

Both sides read these: the program gets them in the type it serves them in,
written into its own parameters, and the reference draws them again after
the window from the same seed. The leaves are named and laid out as the
port's parameters (``state_dict`` keys): layers stacked on a leading axis,
attention weights (d, heads, head_dim) and (heads, head_dim, d), experts
(E, d, ff) and (E, ff, d). One draw a leaf, whole stacks at once.

Every matrix is normal with standard deviation 1 / sqrt(fan-in), the
embedding table normal with standard deviation 1, the norms' scales ones.
This module imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch

MASK64 = (1 << 64) - 1


def mix(*parts: int) -> int:
    """A 63-bit seed from integers (splitmix64 over each in turn), so that
    streams of one run seed differ and any whole number is a valid seed."""
    z = 0x9E3779B97F4A7C15
    for p in parts:
        z = (z ^ (int(p) & MASK64)) & MASK64
        z = (z + 0x9E3779B97F4A7C15) & MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        z ^= z >> 31
    return z & ((1 << 63) - 1)


def head_dim(cfg: dict) -> int:
    return cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"]


def padded_vocab(cfg: dict) -> int:
    v = cfg["vocab_size"]
    return -(-v // 128) * 128


def leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], Optional[float]]]:
    """(name, shape, std) of every leaf in draw order; std None: ones."""
    d, H, K, D = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        head_dim(cfg)
    L, V = cfg["n_layers"], padded_vocab(cfg)
    out = [("embed", (V, d), 1.0), ("norm", (d,), None)]
    if not cfg.get("tie_embeddings", False):
        out.append(("head", (V, d), 1.0 / math.sqrt(d)))
    out += [("layers.ln1", (L, d), None), ("layers.ln2", (L, d), None),
            ("layers.attn.wq", (L, d, H, D), 1.0 / math.sqrt(d)),
            ("layers.attn.wk", (L, d, K, D), 1.0 / math.sqrt(d)),
            ("layers.attn.wv", (L, d, K, D), 1.0 / math.sqrt(d)),
            ("layers.attn.wo", (L, H, D, d), 1.0 / math.sqrt(H * D))]
    if cfg["family"] == "moe":
        m = cfg["moe"]
        if m.get("n_shared_experts") or m.get("first_dense_layers"):
            raise ValueError("shared experts and leading dense layers have "
                             "no leaves here yet")
        E, ff = m["n_experts"], m["d_ff_expert"]
        out += [("layers.moe.router", (L, d, E), 1.0 / math.sqrt(d)),
                ("layers.moe.w_gate", (L, E, d, ff), 1.0 / math.sqrt(d)),
                ("layers.moe.w_up", (L, E, d, ff), 1.0 / math.sqrt(d)),
                ("layers.moe.w_down", (L, E, ff, d), 1.0 / math.sqrt(ff))]
    elif cfg["family"] == "dense":
        ff = cfg["d_ff"]
        out += [("layers.mlp.gate", (L, d, ff), 1.0 / math.sqrt(d)),
                ("layers.mlp.up", (L, d, ff), 1.0 / math.sqrt(d)),
                ("layers.mlp.down", (L, ff, d), 1.0 / math.sqrt(ff))]
    else:
        raise ValueError(f"no weights for family {cfg['family']!r}")
    return out


def draw(cfg: dict, seed: int, device, dtype: torch.dtype,
         into: Optional[Dict[str, torch.Tensor]] = None
         ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, tensor) leaf by leaf in draw order, each drawn in
    `dtype` by one generator on `device` seeded from `seed`. With `into`
    (name -> tensor of the same shape and dtype) the draws are written into
    those tensors in place and they are yielded."""
    generator = torch.Generator(device=device)
    generator.manual_seed(mix(seed, 0))
    for name, shape, std in leaves(cfg):
        if into is not None:
            t = into[name]
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"{name}: the program holds "
                                 f"{tuple(t.shape)} {t.dtype}, the benchmark "
                                 f"draws {shape} {dtype}")
        else:
            t = torch.empty(shape, dtype=dtype, device=device)
        if std is None:
            t.fill_(1.0)
        else:
            t.normal_(0.0, std, generator=generator)
        yield name, t


def fill(params: Dict[str, torch.Tensor], cfg: dict, seed: int) -> None:
    """Write the seed's weights into `params` (the program's parameters by
    name), which must hold exactly the leaves of `leaves(cfg)`."""
    want = {name for name, _, _ in leaves(cfg)}
    if set(params) != want:
        raise ValueError(f"the program's leaves {sorted(set(params) ^ want)} "
                         f"differ from the benchmark's")
    first = next(iter(params.values()))
    with torch.no_grad():
        for _ in draw(cfg, seed, first.device, first.dtype, into=params):
            pass
