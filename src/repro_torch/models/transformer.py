"""Layer stacks over parameters stacked on a leading layer axis: the
decoder (dense MLP or mixture of experts; GQA or MLA attention), the RWKV6
stack and the Zamba2 hybrid (Mamba2 groups with shared attention blocks).

Every leaf of a stack's parameters has the layer count as its first
dimension (the hybrid's Mamba2 leaves: groups, then layers in a group); the
stack is applied by a plain Python loop over that axis, each layer reading
its slice as a view. Decode caches are updated in place.

Under autograd the dense stack takes its layers out with one
``torch.unbind`` of each leaf, whose backward stacks the layers' gradients
once; indexing a[i] for every layer would give each layer's backward a
zero tensor the size of the whole leaf. ``RunConfig.remat`` then wraps each
layer as the reference wraps its scan body (``remat_wrap``).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as SSM


def _require_ported(kind: str) -> None:
    if kind not in ("dense", "moe"):
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md, Queue 1)")


def tree_map(fn, tree):
    """Apply fn to every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def n_stacked(params) -> int:
    return first_leaf(params).shape[0]


# ---------------------------------------------------------------------------
# standard decoder block (dense MLP or MoE; GQA or MLA)
# ---------------------------------------------------------------------------


def _mla(cfg: ModelConfig) -> bool:
    if cfg.attention_kind not in ("gqa", "mla"):
        raise NotImplementedError(
            f"attention kind {cfg.attention_kind!r} is not ported yet "
            f"(ROADMAP.md, Queue 1)")
    return cfg.attention_kind == "mla"


def _init_attn(generator, cfg: ModelConfig, **kw):
    return (A.init_mla if _mla(cfg) else A.init_gqa)(generator, cfg, **kw)


def init_block(generator, cfg: ModelConfig, kind: str = "dense",
               d_ff: Optional[int] = None, *, dtype=torch.float32,
               device=None):
    """kind: dense | moe."""
    _require_ported(kind)
    kw = dict(dtype=dtype, device=device)
    p = {"ln1": torch.ones((cfg.d_model,), **kw),
         "ln2": torch.ones((cfg.d_model,), **kw),
         "attn": _init_attn(generator, cfg, **kw)}
    if kind == "moe":
        p["moe"] = M.init_moe(generator, cfg, **kw)
    else:
        p["mlp"] = L.init_mlp(generator, cfg.d_model, d_ff or cfg.d_ff,
                              cfg.mlp_kind, **kw)
    return p


def _ffn(params, h, cfg: ModelConfig, kind: str):
    """(the block's MLP or MoE of h, the MoE's aux loss or 0)."""
    if kind == "moe":
        return M.moe(params["moe"], h, cfg)
    return L.mlp(params["mlp"], h, cfg.mlp_kind), \
        torch.zeros((), dtype=torch.float32, device=h.device)


def block(params, x, cfg: ModelConfig, run: RunConfig, *, kind="dense",
          positions=None, causal=True):
    """One transformer block. Returns (x, aux_loss)."""
    _require_ported(kind)
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    attn = A.mla if _mla(cfg) else A.gqa
    h = attn(params["attn"], h, cfg, run, positions=positions, causal=causal)
    x = x + h
    h, aux = _ffn(params, L.rms_norm(x, params["ln2"], cfg.norm_eps), cfg,
                  kind)
    return x + h, aux


def block_decode(params, x, cache, cfg: ModelConfig, run: RunConfig, *,
                 kind="dense"):
    """One-token decode through a block; returns (x, new_cache). The
    cache's tensors are updated in place (see attention.gqa_decode and
    attention.mla_decode)."""
    _require_ported(kind)
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    decode = A.mla_decode if _mla(cfg) else A.gqa_decode
    h, new_cache = decode(params["attn"], h, cache, cfg, run)
    x = x + h
    h, _ = _ffn(params, L.rms_norm(x, params["ln2"], cfg.norm_eps), cfg, kind)
    return x + h, new_cache


def block_prefill(params, x, cfg: ModelConfig, run: RunConfig, *,
                  kind="dense", positions=None, pad_to=0):
    """Block forward that also returns the cache contents: (k, v) for GQA,
    (ckv, kr) for MLA."""
    _require_ported(kind)
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    prefill = A.mla_prefill if _mla(cfg) else A.gqa_prefill
    h, kv = prefill(params["attn"], h, cfg, run, positions=positions,
                    pad_to=pad_to)
    x = x + h
    h, _ = _ffn(params, L.rms_norm(x, params["ln2"], cfg.norm_eps), cfg, kind)
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


def fill_stacked(stacked, make):
    """Draw the layers of a stacked tree IN PLACE, layer by layer, so the
    largest temporary is one layer's parameters. `make(dtype=, device=)`
    gives one layer's tree."""
    leaf = first_leaf(stacked)
    for i in range(leaf.shape[0]):
        copy_tree(tree_map(lambda a: a[i], stacked),
                  make(dtype=leaf.dtype, device=leaf.device))
    return stacked


def init_stacked(n: int, make, *, dtype=torch.float32, device=None):
    """UNINITIALISED parameters of n layers of `make(dtype=, device=)`,
    stacked on a leading axis (on the meta device: the shapes only);
    `fill_stacked` draws them."""
    shapes = make(dtype=dtype, device="meta")
    return tree_map(
        lambda a: torch.empty((n, *a.shape), dtype=dtype, device=device),
        shapes)


def fill_block(dst, generator, cfg: ModelConfig, kind="dense", d_ff=None):
    """Draw one block's parameters into `dst`, IN PLACE. A moe block's
    experts are drawn into their slices one at a time (``moe.fill_moe``)."""
    leaf = first_leaf(dst)
    kw = dict(dtype=leaf.dtype, device=leaf.device)
    if kind != "moe":
        copy_tree(dst, init_block(generator, cfg, kind, d_ff, **kw))
        return dst
    dst["ln1"].fill_(1.0)
    dst["ln2"].fill_(1.0)
    copy_tree(dst["attn"], _init_attn(generator, cfg, **kw))
    M.fill_moe(dst["moe"], generator, cfg)
    return dst


def fill_stack(stacked, generator, cfg: ModelConfig, kind="dense", d_ff=None):
    """Draw the blocks of a stack, IN PLACE, layer by layer."""
    for i in range(n_stacked(stacked)):
        fill_block(tree_map(lambda a: a[i], stacked), generator, cfg, kind,
                   d_ff)
    return stacked


def init_stack(cfg: ModelConfig, n: int, kind="dense", d_ff=None, *,
               dtype=torch.float32, device=None):
    """Uninitialised parameters of n blocks, stacked on a leading axis."""
    return init_stacked(n, lambda **kw: init_block(None, cfg, kind, d_ff, **kw),
                        dtype=dtype, device=device)


def _save_weight_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of products with a weight (2-D
    ``mm``, no batch dimension) and recompute the rest, the attention
    scores (batched) included, as the reference's
    ``dots_with_no_batch_dims_saveable`` does."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, policy: str):
    """A layer function under `policy`, as the reference's ``remat_wrap``:
    "nothing" keeps every activation; "boundaries" keeps only the layer's
    input and recomputes the layer in the backward; "dots" keeps the
    products with weights and recomputes the rest."""
    if policy == "nothing":
        return fn
    if policy == "boundaries":
        return partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return partial(checkpoint, fn, use_reentrant=False,
                       context_fn=partial(create_selective_checkpoint_contexts,
                                          _save_weight_products))
    raise ValueError(f"unknown remat policy {policy!r}")


def unstack(params, n: int):
    """The n layers of a stacked tree, each leaf taken apart by one
    ``torch.unbind``."""
    parts = tree_map(lambda a: a.unbind(0), params)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def stack(params, x, cfg, run, *, kind="dense", positions=None, causal=True):
    """Run x through a stacked block group -> (x, summed aux). With grad
    mode on the layers come out of one unbind a leaf and each runs under
    `run.remat` (when `run.scan_layers`, as the reference remats its scan
    body only); the serving path (no grad) reads each layer's slices."""
    n = n_stacked(params)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if not torch.is_grad_enabled():
        layers = (tree_map(lambda a: a[i], params) for i in range(n))
        layer = block
    else:
        layers = unstack(params, n)
        layer = remat_wrap(block, run.remat if run.scan_layers else "nothing")
    for lp in layers:
        x, aux = layer(lp, x, cfg, run, kind=kind, positions=positions,
                       causal=causal)
        aux_total = aux_total + aux
    return x, aux_total


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
    """Run a stacked group, collecting per-layer caches stacked on a
    leading axis: (x, (k, v)) with k, v (L, B, max(S, pad_to), K, D), or
    for MLA (x, (ckv, kr)) with ckv (L, B, max(S, pad_to), r) and kr
    (L, B, max(S, pad_to), rope)."""
    n = n_stacked(params)
    out = None
    for i in range(n):
        x, kv = block_prefill(tree_map(lambda a: a[i], params), x, cfg, run,
                              kind=kind, positions=positions, pad_to=pad_to)
        if out is None:
            out = tuple(torch.empty((n, *t.shape), dtype=t.dtype,
                                    device=t.device) for t in kv)
        for dst, t in zip(out, kv):
            dst[i].copy_(t)
    return x, out


# ---------------------------------------------------------------------------
# RWKV stack
# ---------------------------------------------------------------------------


def init_rwkv_layer(generator, cfg: ModelConfig, *, dtype=torch.float32,
                    device=None):
    p = R.init_rwkv6(generator, cfg, dtype=dtype, device=device)
    p["ln1"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return p


def init_rwkv_stack(cfg: ModelConfig, *, dtype=torch.float32, device=None):
    """Uninitialised parameters of the RWKV6 stack."""
    return init_stacked(cfg.n_layers,
                        lambda **kw: init_rwkv_layer(None, cfg, **kw),
                        dtype=dtype, device=device)


def fill_rwkv_stack(stacked, generator, cfg: ModelConfig):
    return fill_stacked(stacked,
                        lambda **kw: init_rwkv_layer(generator, cfg, **kw))


def _norms(lp):
    return {"ln1": lp["ln1"], "ln2": lp["ln2"]}


def rwkv_stack(params, x, cfg, run):
    for i in range(n_stacked(params)):
        lp = tree_map(lambda a: a[i], params)
        x = R.rwkv_block(lp, x, cfg, run, _norms(lp))
    return x


def rwkv_stack_decode(params, x, caches, cfg, run):
    """One token through the stack; caches {"wkv", "tm_last", "cm_last"}
    stacked on axis 0 are updated in place and handed back."""
    for i in range(n_stacked(params)):
        lp = tree_map(lambda a: a[i], params)
        x, _ = R.rwkv_block_decode(lp, x, tree_map(lambda a: a[i], caches),
                                   cfg, run, _norms(lp))
    return x, caches


# ---------------------------------------------------------------------------
# Zamba2 hybrid stack: groups of `period` Mamba2 blocks + a shared attention
# block (n_shared_sets alternating weight sets: group g uses set g % n_sets,
# true weight sharing across depth).
# ---------------------------------------------------------------------------


def hybrid_groups(cfg: ModelConfig) -> int:
    return max(1, cfg.n_layers // cfg.hybrid.period)


def init_mamba_layer(generator, cfg: ModelConfig, *, dtype=torch.float32,
                     device=None):
    p = SSM.init_mamba2(generator, cfg, dtype=dtype, device=device)
    p["ln"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return p


def _shared_d_ff(cfg: ModelConfig) -> int:
    return cfg.hybrid.shared_d_ff or cfg.d_ff


def init_hybrid(cfg: ModelConfig, *, dtype=torch.float32, device=None):
    """Uninitialised parameters of the hybrid stack: {"mamba": leaves
    (G, period, ...), "shared": leaves (n_sets, ...)}."""
    hy = cfg.hybrid
    G = hybrid_groups(cfg)
    mamba = init_stacked(G * hy.period,
                         lambda **kw: init_mamba_layer(None, cfg, **kw),
                         dtype=dtype, device=device)
    mamba = tree_map(lambda a: a.reshape(G, hy.period, *a.shape[1:]), mamba)
    shared = init_stack(cfg, hy.n_shared_sets, "dense", _shared_d_ff(cfg),
                        dtype=dtype, device=device)
    return {"mamba": mamba, "shared": shared}


def fill_hybrid(params, generator, cfg: ModelConfig):
    """Draw a hybrid stack's parameters IN PLACE."""
    flat = tree_map(lambda a: a.view(-1, *a.shape[2:]), params["mamba"])
    fill_stacked(flat, lambda **kw: init_mamba_layer(generator, cfg, **kw))
    fill_stack(params["shared"], generator, cfg, "dense", _shared_d_ff(cfg))
    return params


def hybrid_stack(params, x, cfg, run, *, positions=None):
    mamba, shared = params["mamba"], params["shared"]
    G, period = first_leaf(mamba).shape[:2]
    n_sets = n_stacked(shared)
    for g in range(G):
        for i in range(period):
            lp = tree_map(lambda a: a[g, i], mamba)
            x = x + SSM.mamba2(lp, L.rms_norm(x, lp["ln"], cfg.norm_eps),
                               cfg, run)
        x, _ = block(tree_map(lambda a: a[g % n_sets], shared), x, cfg, run,
                     kind="dense", positions=positions)
    return x


def hybrid_stack_decode(params, x, caches, cfg, run):
    """caches: {"mamba": (G, period, ...) Mamba2 caches, "attn": (G, ...) KV
    caches}, updated in place and handed back."""
    mamba, shared = params["mamba"], params["shared"]
    G, period = first_leaf(mamba).shape[:2]
    n_sets = n_stacked(shared)
    for g in range(G):
        for i in range(period):
            lp = tree_map(lambda a: a[g, i], mamba)
            y, _ = SSM.mamba2_decode(
                lp, L.rms_norm(x, lp["ln"], cfg.norm_eps),
                tree_map(lambda a: a[g, i], caches["mamba"]), cfg, run)
            x = x + y
        x, new = block_decode(tree_map(lambda a: a[g % n_sets], shared), x,
                              tree_map(lambda a: a[g], caches["attn"]), cfg,
                              run, kind="dense")
        caches["attn"]["pos"][g].copy_(new["pos"])
    return x, caches
