"""Dense decoder stack over parameters stacked on a leading layer axis.

Every leaf of a stack's parameters has the layer count as its first
dimension; the stack is applied by a plain Python loop over that axis, each
layer reading its slice as a view.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def _require_dense(kind: str) -> None:
    if kind != "dense":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md, Queue 1)")


def tree_map(fn, tree):
    """Apply fn to every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def n_stacked(params) -> int:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


# ---------------------------------------------------------------------------
# standard decoder block (dense MLP)
# ---------------------------------------------------------------------------


def init_block(generator, cfg: ModelConfig, kind: str = "dense",
               d_ff: Optional[int] = None, *, dtype=torch.float32,
               device=None):
    _require_dense(kind)
    if cfg.attention_kind != "gqa":
        raise NotImplementedError(
            f"attention kind {cfg.attention_kind!r} is not ported yet "
            f"(ROADMAP.md, Queue 1)")
    kw = dict(dtype=dtype, device=device)
    return {
        "ln1": torch.ones((cfg.d_model,), **kw),
        "ln2": torch.ones((cfg.d_model,), **kw),
        "attn": A.init_gqa(generator, cfg, **kw),
        "mlp": L.init_mlp(generator, cfg.d_model, d_ff or cfg.d_ff,
                          cfg.mlp_kind, **kw),
    }


def block(params, x, cfg: ModelConfig, run: RunConfig, *, kind="dense",
          positions=None, causal=True):
    """One transformer block."""
    _require_dense(kind)
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    h = A.gqa(params["attn"], h, cfg, run, positions=positions, causal=causal)
    x = x + h
    h = L.rms_norm(x, params["ln2"], cfg.norm_eps)
    h = L.mlp(params["mlp"], h, cfg.mlp_kind)
    return x + h


def block_decode(params, x, cache, cfg: ModelConfig, run: RunConfig, *,
                 kind="dense"):
    """One-token decode through a block; returns (x, new_cache). The
    cache's k and v are updated in place (see attention.gqa_decode)."""
    _require_dense(kind)
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    h, new_cache = A.gqa_decode(params["attn"], h, cache, cfg, run)
    x = x + h
    h = L.rms_norm(x, params["ln2"], cfg.norm_eps)
    h = L.mlp(params["mlp"], h, cfg.mlp_kind)
    return x + h, new_cache


def block_prefill(params, x, cfg: ModelConfig, run: RunConfig, *,
                  kind="dense", positions=None, pad_to=0):
    """Block forward that also returns KV-cache contents."""
    _require_dense(kind)
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    h, kv = A.gqa_prefill(params["attn"], h, cfg, run, positions=positions,
                          pad_to=pad_to)
    x = x + h
    h = L.rms_norm(x, params["ln2"], cfg.norm_eps)
    h = L.mlp(params["mlp"], h, cfg.mlp_kind)
    return x + h, kv


# ---------------------------------------------------------------------------
# stacked application
# ---------------------------------------------------------------------------


def copy_tree(dst, src) -> None:
    """Copy every tensor of the nested dict `src` into its place in `dst`."""
    for name, value in src.items():
        if isinstance(value, dict):
            copy_tree(dst[name], value)
        else:
            dst[name].copy_(value)


def fill_stack(stacked, generator, cfg: ModelConfig, kind="dense", d_ff=None):
    """Draw the blocks of a stack, IN PLACE: layer by layer, so the largest
    temporary is one layer's parameters."""
    leaf = stacked["ln1"]
    for i in range(leaf.shape[0]):
        copy_tree(tree_map(lambda a: a[i], stacked),
                  init_block(generator, cfg, kind, d_ff, dtype=leaf.dtype,
                             device=leaf.device))
    return stacked


def init_stack(generator, cfg: ModelConfig, n: int, kind="dense", d_ff=None,
               *, dtype=torch.float32, device=None):
    """Parameters of n blocks, stacked on a leading axis. On the meta device
    only the shapes are made."""
    shapes = init_block(None, cfg, kind, d_ff, dtype=dtype, device="meta")
    stacked = tree_map(
        lambda a: torch.empty((n, *a.shape), dtype=dtype, device=device),
        shapes)
    if torch.device(device or "cpu").type == "meta":
        return stacked
    return fill_stack(stacked, generator, cfg, kind, d_ff)


def stack(params, x, cfg, run, *, kind="dense", positions=None, causal=True):
    """Run x through a stacked block group."""
    for i in range(n_stacked(params)):
        x = block(tree_map(lambda a: a[i], params), x, cfg, run, kind=kind,
                  positions=positions, causal=causal)
    return x


def stack_decode(params, x, caches, cfg, run, *, kind="dense"):
    """One token through a stacked group, threading per-layer caches.
    caches: dict of tensors stacked on axis 0; k and v are updated in place
    and `pos` is rewritten in place, so the dict handed back holds the same
    tensors."""
    for i in range(n_stacked(params)):
        cache = tree_map(lambda a: a[i], caches)
        x, new_cache = block_decode(tree_map(lambda a: a[i], params), x,
                                    cache, cfg, run, kind=kind)
        caches["pos"][i].copy_(new_cache["pos"])
    return x, caches


def stack_prefill(params, x, cfg, run, *, kind="dense", positions=None,
                  pad_to=0):
    """Run a stacked group, collecting per-layer KV caches stacked on a
    leading axis: (x, (k, v)) with k, v (L, B, max(S, pad_to), K, D)."""
    n = n_stacked(params)
    ks = vs = None
    for i in range(n):
        x, (k, v) = block_prefill(tree_map(lambda a: a[i], params), x, cfg,
                                  run, kind=kind, positions=positions,
                                  pad_to=pad_to)
        if ks is None:
            ks = torch.empty((n, *k.shape), dtype=k.dtype, device=k.device)
            vs = torch.empty_like(ks)
        ks[i].copy_(k)
        vs[i].copy_(v)
    return x, (ks, vs)
