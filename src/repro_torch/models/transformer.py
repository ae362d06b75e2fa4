"""Layer stacks over parameters stacked on a leading layer axis: the
decoder (dense MLP or mixture of experts; GQA or MLA attention), the RWKV6
stack, the Zamba2 hybrid (Mamba2 groups with shared attention blocks), the
VLM stack (groups of self-attention blocks and one gated cross-attention
block) and whisper's encoder-decoder.

Every leaf of a stack's parameters has the layer count as its first
dimension (the hybrid's Mamba2 leaves and the VLM's self-attention leaves:
groups, then layers in a group); the stack is applied by a plain Python
loop over that axis. Serving (no grad) reads each layer's slice as a view.
Decode caches are updated in place.

Under autograd every stack takes its layers out with one ``torch.unbind``
of each leaf (``layer_params``), whose backward stacks the layers'
gradients once; indexing a[i] for every layer would give each layer's
backward a zero tensor the size of the whole leaf. ``RunConfig.remat`` then
wraps the bodies that the reference wraps in ``remat_wrap`` (``layer_fn``):
the dense and MoE blocks, the RWKV6 layer, the Mamba2 block, the VLM's
self-attention blocks and the decoder layer of the encoder-decoder; the
hybrid's shared block and the VLM's cross block run unwrapped, as there.
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
    """kind: dense | moe | cross (the VLM's gated cross-attention block,
    with a dense MLP)."""
    kw = dict(dtype=dtype, device=device)
    attn = A.init_cross_attn if kind == "cross" else _init_attn
    p = {"ln1": torch.ones((cfg.d_model,), **kw),
         "ln2": torch.ones((cfg.d_model,), **kw),
         "attn": attn(generator, cfg, **kw)}
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
          positions=None, causal=True, media_kv=None):
    """One transformer block. Returns (x, aux_loss). A cross block attends
    to `media_kv`, the (k, v) of ``attention.cross_attn_kv``."""
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind == "cross":
        h = A.cross_attn(params["attn"], h, media_kv, run)
    else:
        attn = A.mla if _mla(cfg) else A.gqa
        h = attn(params["attn"], h, cfg, run, positions=positions,
                 causal=causal)
    x = x + h
    h, aux = _ffn(params, L.rms_norm(x, params["ln2"], cfg.norm_eps), cfg,
                  kind)
    return x + h, aux


def block_decode(params, x, cache, cfg: ModelConfig, run: RunConfig, *,
                 kind="dense", media_kv=None):
    """One-token decode through a block; returns (x, new_cache). The
    cache's tensors are updated in place (see attention.gqa_decode and
    attention.mla_decode). A cross block has no cache: it hands back the
    one it was given."""
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind == "cross":
        h, new_cache = A.cross_attn(params["attn"], h, media_kv, run), cache
    else:
        decode = A.mla_decode if _mla(cfg) else A.gqa_decode
        h, new_cache = decode(params["attn"], h, cache, cfg, run)
    x = x + h
    h, _ = _ffn(params, L.rms_norm(x, params["ln2"], cfg.norm_eps), cfg, kind)
    return x + h, new_cache


def block_prefill(params, x, cfg: ModelConfig, run: RunConfig, *,
                  kind="dense", positions=None, pad_to=0):
    """Block forward that also returns the cache contents: (k, v) for GQA,
    (ckv, kr) for MLA."""
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


def layer_params(params, n: int):
    """The n layers of a tree stacked on a leading axis: with grad mode on,
    each leaf taken apart by one ``torch.unbind``; with no grad (serving),
    each layer's slices as views."""
    if torch.is_grad_enabled():
        parts = tree_map(lambda a: a.unbind(0), params)
        return [tree_map(lambda t: t[i], parts) for i in range(n)]
    return [tree_map(lambda a: a[i], params) for i in range(n)]


def flat_groups(params):
    """A tree stacked on (groups, layers in a group) as one stacked on
    groups x layers: views of the same storage."""
    return tree_map(lambda a: a.view(-1, *a.shape[2:]), params)


def layer_fn(fn, run: RunConfig):
    """`fn`, a layer of a stack, under `run.remat` when grad mode is on and
    `run.scan_layers` (the reference remats its scan bodies only); as it is
    otherwise."""
    if not torch.is_grad_enabled():
        return fn
    return remat_wrap(fn, run.remat if run.scan_layers else "nothing")


def stack(params, x, cfg, run, *, kind="dense", positions=None, causal=True):
    """Run x through a stacked block group -> (x, summed aux)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = layer_fn(block, run)
    for lp in layer_params(params, n_stacked(params)):
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


def _rwkv_layer(lp, x, cfg, run):
    return R.rwkv_block(lp, x, cfg, run, _norms(lp))


def rwkv_stack(params, x, cfg, run):
    layer = layer_fn(_rwkv_layer, run)
    for lp in layer_params(params, n_stacked(params)):
        x = layer(lp, x, cfg, run)
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
    fill_stacked(flat_groups(params["mamba"]),
                 lambda **kw: init_mamba_layer(generator, cfg, **kw))
    fill_stack(params["shared"], generator, cfg, "dense", _shared_d_ff(cfg))
    return params


def _mamba_layer(lp, x, cfg, run):
    return x + SSM.mamba2(lp, L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg, run)


def hybrid_stack(params, x, cfg, run, *, positions=None):
    """The groups' Mamba2 blocks (each under `run.remat`), each group
    followed by its shared block, unwrapped."""
    mamba, shared = params["mamba"], params["shared"]
    G, period = first_leaf(mamba).shape[:2]
    blocks = layer_params(flat_groups(mamba), G * period)
    sets = layer_params(shared, n_stacked(shared))
    layer = layer_fn(_mamba_layer, run)
    for g in range(G):
        for lp in blocks[g * period:(g + 1) * period]:
            x = layer(lp, x, cfg, run)
        x, _ = block(sets[g % len(sets)], x, cfg, run, kind="dense",
                     positions=positions)
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


# ---------------------------------------------------------------------------
# VLM stack (llama-3.2-vision): groups of period - 1 self-attention blocks
# and one gated cross-attention block. The media's keys and values are
# computed for each cross layer at every call, as in the reference.
# ---------------------------------------------------------------------------


def vlm_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.cross_attn.period


def init_vlm(cfg: ModelConfig, *, dtype=torch.float32, device=None):
    """Uninitialised parameters of the VLM stack: {"self": leaves
    (G, period - 1, ...), "cross": cross blocks' leaves (G, ...), the gate
    (G,)}."""
    G, n_self = vlm_groups(cfg), cfg.cross_attn.period - 1
    selfp = init_stack(cfg, G * n_self, "dense", dtype=dtype, device=device)
    return {"self": tree_map(lambda a: a.reshape(G, n_self, *a.shape[1:]),
                             selfp),
            "cross": init_stack(cfg, G, "cross", dtype=dtype, device=device)}


def fill_vlm(params, generator, cfg: ModelConfig):
    """Draw a VLM stack's parameters IN PLACE."""
    fill_stack(flat_groups(params["self"]), generator, cfg, "dense")
    fill_stack(params["cross"], generator, cfg, "cross")
    return params


def vlm_stack(params, x, media, cfg, run, *, positions=None):
    """x (B, S, d) through the groups; media (B, M, d) in x's dtype. The
    self-attention blocks run under `run.remat`, the cross block
    unwrapped."""
    selfp, crossp = params["self"], params["cross"]
    G, n_self = first_leaf(selfp).shape[:2]
    selfs = layer_params(flat_groups(selfp), G * n_self)
    layer = layer_fn(block, run)
    for g, cp in enumerate(layer_params(crossp, G)):
        for lp in selfs[g * n_self:(g + 1) * n_self]:
            x, _ = layer(lp, x, cfg, run, kind="dense", positions=positions)
        x, _ = block(cp, x, cfg, run, kind="cross",
                     media_kv=A.cross_attn_kv(cp["attn"], media))
    return x


def vlm_stack_decode(params, x, media, caches, cfg, run):
    """caches: the self-attention blocks' KV caches, leaves
    (G, period - 1, B, ...), updated in place and handed back."""
    selfp, crossp = params["self"], params["cross"]
    n_self = first_leaf(selfp).shape[1]
    for g in range(n_stacked(crossp)):
        for i in range(n_self):
            x, new = block_decode(tree_map(lambda a: a[g, i], selfp), x,
                                  tree_map(lambda a: a[g, i], caches), cfg,
                                  run, kind="dense")
            caches["pos"][g, i].copy_(new["pos"])
        cp = tree_map(lambda a: a[g], crossp)
        x, _ = block_decode(cp, x, None, cfg, run, kind="cross",
                            media_kv=A.cross_attn_kv(cp["attn"], media))
    return x, caches


# ---------------------------------------------------------------------------
# Whisper encoder-decoder: a non-causal encoder over the frames, and decoder
# layers of self-attention, MLP, then ungated cross-attention to the
# encoder's output. No positions beyond the encoder's sinusoid: the config
# has rope_kind "none" and the reference learns none.
# ---------------------------------------------------------------------------


def init_dec_layer(generator, cfg: ModelConfig, *, dtype=torch.float32,
                   device=None):
    p = init_block(generator, cfg, "dense", dtype=dtype, device=device)
    p["cross"] = A.init_cross_attn(generator, cfg, dtype=dtype, device=device)
    p["ln_cross"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return p


def init_encdec(cfg: ModelConfig, *, dtype=torch.float32, device=None):
    """Uninitialised parameters of the encoder-decoder: {"enc": blocks
    (n_encoder_layers, ...), "dec": decoder layers (n_layers, ...), each a
    dense block with "cross" and "ln_cross", "enc_ln"}."""
    return {"enc": init_stack(cfg, cfg.encdec.n_encoder_layers, "dense",
                              dtype=dtype, device=device),
            "dec": init_stacked(
                cfg.n_layers, lambda **kw: init_dec_layer(None, cfg, **kw),
                dtype=dtype, device=device),
            "enc_ln": torch.empty((cfg.d_model,), dtype=dtype, device=device)}


def fill_encdec(params, generator, cfg: ModelConfig):
    """Draw an encoder-decoder's parameters IN PLACE."""
    fill_stack(params["enc"], generator, cfg, "dense")
    fill_stacked(params["dec"],
                 lambda **kw: init_dec_layer(generator, cfg, **kw))
    params["enc_ln"].fill_(1.0)
    return params


def _sinusoid(S: int, d: int, dtype, device) -> torch.Tensor:
    """(1, S, d) sin | cos position table, computed in float32 and cast."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)[None]


def encdec_encode(params, frames, cfg, run):
    """The encoder half of ``encdec_apply``: frames (B, enc_len, d) plus the
    sinusoid, the non-causal stack and enc_ln -> enc_out (B, enc_len, d),
    what ``encdec_decode`` attends to."""
    S = frames.shape[1]
    enc = frames + _sinusoid(S, cfg.d_model, frames.dtype, frames.device)
    enc, _ = stack(params["enc"], enc, cfg, run, kind="dense",
                   positions=torch.arange(S, device=frames.device),
                   causal=False)
    return L.rms_norm(enc, params["enc_ln"], cfg.norm_eps)


def _dec_cross(lp, h, enc_out, cfg, run):
    kv = A.cross_attn_kv(lp["cross"], enc_out)
    c = L.rms_norm(h, lp["ln_cross"], cfg.norm_eps)
    return A.cross_attn(lp["cross"], c, kv, run, gated=False)


def _dec_block(lp, x, enc_out, cfg, run, positions):
    """One decoder layer: the dense block, then the ungated cross-attention
    to enc_out added to its output."""
    h, _ = block(lp, x, cfg, run, kind="dense", positions=positions)
    return h + _dec_cross(lp, h, enc_out, cfg, run)


def encdec_apply(params, frames, tokens_x, cfg, run, *, positions=None):
    """frames (B, enc_len, d) stub embeddings; tokens_x (B, S, d) embedded
    tokens -> the decoder's output (B, S, d). The decoder layers run under
    `run.remat`, as the encoder's blocks do (``stack``)."""
    enc_out = encdec_encode(params, frames, cfg, run)
    layer = layer_fn(_dec_block, run)
    x = tokens_x
    for lp in layer_params(params["dec"], n_stacked(params["dec"])):
        x = layer(lp, x, enc_out, cfg, run, positions)
    return x


def encdec_decode(params, x, enc_out, caches, cfg, run):
    """One token through the decoder; caches: the self-attention KV caches,
    leaves (n_layers, B, ...), updated in place and handed back."""
    for i in range(n_stacked(params["dec"])):
        lp = tree_map(lambda a: a[i], params["dec"])
        h, new = block_decode(lp, x, tree_map(lambda a: a[i], caches), cfg,
                              run, kind="dense")
        caches["pos"][i].copy_(new["pos"])
        x = h + _dec_cross(lp, h, enc_out, cfg, run)
    return x, caches
