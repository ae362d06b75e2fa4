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
of each leaf (``layer_slices``), whose backward stacks the layers'
gradients once; indexing a[i] for every layer would give each layer's
backward a zero tensor the size of the whole leaf. ``RunConfig.remat`` then
wraps the bodies that the reference wraps in ``remat_wrap`` (``layer_fn``):
the dense and MoE blocks, the RWKV6 layer, the Mamba2 block, the VLM's
self-attention blocks and the decoder layer of the encoder-decoder; the
hybrid's shared block and the VLM's cross block run unwrapped, as there.

Every stack takes ``mesh=``: each layer's blocks are then this rank's
(``sharding.rules``), and attention, the MLP, the MoE, the RWKV6 layer and
the Mamba2 block write their collectives out (``attention``, ``layers``,
``moe``, ``rwkv``, ``ssm``). Prefill and decode over a mesh read and write
this rank's blocks of the caches (``rules.cache_specs``).

Under ``fsdp_params`` every stack takes ``fsdp=``, an ``Fsdp`` of the
stacked tree's specs (``Model`` builds it where 'data' is above 1), and
gathers each layer's leaves over 'data' as it reads that layer
(``layer_slices``, ``gather_layer``), never the whole stack. Under grad
mode the gather runs inside the function that ``layer_fn`` checkpoints, so
that a remat policy keeps no gathered weight for the backward and the
recompute gathers again; the all-gather's backward reduce-scatters the
layer's gradient when that layer's backward ends.
"""
from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as SSM
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import map_with_path
from repro_torch.telemetry.spans import traced


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


def _ffn(params, h, cfg: ModelConfig, kind: str, run=None, mesh=None,
         d_ff=None):
    """(the block's MLP or MoE of h, the MoE's aux loss or 0)."""
    if kind == "moe":
        return M.moe(params["moe"], h, cfg, run, mesh)
    return L.mlp(params["mlp"], h, cfg.mlp_kind, mesh, d_ff or cfg.d_ff), \
        torch.zeros((), dtype=torch.float32, device=h.device)


def block(params, x, cfg: ModelConfig, run: RunConfig, *, kind="dense",
          positions=None, causal=True, media_kv=None, mesh=None, d_ff=None):
    """One transformer block. Returns (x, aux_loss). A cross block attends
    to `media_kv`, the (k, v) of ``attention.cross_attn_kv``. `d_ff` is
    the whole MLP width (default cfg.d_ff), which tells a block of it under
    a mesh."""
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind == "cross":
        h = A.cross_attn(params["attn"], h, media_kv, run, cfg=cfg,
                         mesh=mesh)
    elif _mla(cfg):
        h = A.mla(params["attn"], h, cfg, run, positions=positions,
                  causal=causal, mesh=mesh)
    else:
        h = A.gqa(params["attn"], h, cfg, run, positions=positions,
                  causal=causal, mesh=mesh)
    x = x + h
    h, aux = _ffn(params, L.rms_norm(x, params["ln2"], cfg.norm_eps), cfg,
                  kind, run, mesh, d_ff)
    return x + h, aux


def block_decode(params, x, cache, cfg: ModelConfig, run: RunConfig, *,
                 kind="dense", media_kv=None, mesh=None, d_ff=None,
                 whole: bool = False):
    """One-token decode through a block; returns (x, new_cache). The
    cache's tensors are updated in place (see attention.gqa_decode and
    attention.mla_decode; `whole`: a cache that the rules leave whole over
    'model'). A cross block has no cache: it hands back the one it was
    given."""
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind == "cross":
        h = A.cross_attn(params["attn"], h, media_kv, run, cfg=cfg, mesh=mesh)
        new_cache = cache
    else:
        decode = A.mla_decode if _mla(cfg) else A.gqa_decode
        h, new_cache = decode(params["attn"], h, cache, cfg, run, mesh,
                              whole)
    x = x + h
    h, _ = _ffn(params, L.rms_norm(x, params["ln2"], cfg.norm_eps), cfg, kind,
                run, mesh, d_ff)
    return x + h, new_cache


def block_prefill(params, x, cfg: ModelConfig, run: RunConfig, *,
                  kind="dense", positions=None, pad_to=0, mesh=None,
                  d_ff=None):
    """Block forward that also returns the cache contents: (k, v) for GQA,
    (ckv, kr) for MLA (over a mesh, this rank's blocks of them). The
    attention and a MoE block's experts are the ranges "prefill.attention"
    and "prefill.moe" while a profiler records (``telemetry.traced``)."""
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    prefill = A.mla_prefill if _mla(cfg) else A.gqa_prefill
    with traced("prefill.attention"):
        h, kv = prefill(params["attn"], h, cfg, run, positions=positions,
                        pad_to=pad_to, mesh=mesh)
    x = x + h
    h = L.rms_norm(x, params["ln2"], cfg.norm_eps)
    with traced("prefill.moe") if kind == "moe" else nullcontext():
        h, _ = _ffn(params, h, cfg, kind, run, mesh, d_ff)
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


# ---------------------------------------------------------------------------
# fsdp_params: a stack's leaves gathered over 'data' a layer at a time
# ---------------------------------------------------------------------------

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class Fsdp:
    """The specs of a (stacked) parameter tree whose leaves ``fsdp_params``
    split over 'data', the mesh, and whether ``fsdp_experts`` split the
    experts' ff over 'data' (the MoE gathers those itself): what
    ``layer_slices`` reads to gather a layer."""
    specs: Dict
    mesh: object
    experts: bool = False

    def sub(self, name: str) -> "Fsdp":
        return Fsdp(self.specs[name], self.mesh, self.experts)


def fsdp_of(specs, mesh, experts: bool = False) -> Optional[Fsdp]:
    """An ``Fsdp`` over `specs` where the mesh's 'data' axis is above 1,
    else None (nothing to gather). `experts`: ``RunConfig.fsdp_experts``."""
    if mesh is None or C.axis_size(mesh, "data") == 1:
        return None
    return Fsdp(specs, mesh, experts)


def _data_dim(name: str, spec, ndim: int, experts: bool) -> Optional[int]:
    """The dimension of a leaf that its spec splits over 'data', or None
    where none is, or where it is the experts' ff and `experts` (then
    ``fsdp_experts`` put 'data' there, and ``moe._experts`` gathers it
    inside the MoE). Without ``fsdp_experts``, 'data' on an expert leaf is
    ``fsdp_params``' (the first replicated dimension it divides, the ff of
    w_down too) and the layer's gather takes it."""
    for dim, entry in enumerate(spec):
        if entry == "data":
            if experts and name in EXPERT_LEAVES and \
                    dim == (ndim - 2 if name == "w_down" else ndim - 1):
                return None
            return dim
    return None


def _locate(t, d: Optional[int], idx, lead: int):
    """(the index of layer `idx` among `t`'s local layers, its gather step)
    for a leaf whose spec puts 'data' on dimension `d` (``layer_slices``)."""
    local_idx = list(idx)
    step = None
    if d is not None and d < lead:
        per = t.shape[d]
        step = ("owner", idx[d] // per)
        local_idx[d] = idx[d] % per
    elif d is not None:
        step = ("gather", d - lead)
    j = 0
    for k in range(lead):
        j = j * t.shape[k] + local_idx[k]
    return j, step


def layer_slices(params, fsdp: Optional[Fsdp] = None, lead: int = 1
                 ) -> list:
    """[(layer's local tree, its plan)] for every layer of a tree stacked on
    `lead` leading axes (lead 2: groups, then layers in a group, in that
    order), as this rank holds them; ``gather_layer(lp, plan)`` makes the
    layer whole over 'data'. With grad mode on each leaf is taken apart by
    one ``torch.unbind``, whose backward stacks the layers' gradients once
    (indexing a[i] for every layer would give each layer's backward a zero
    tensor the size of the whole leaf); with no grad each layer's slice is
    a view. lead 0 is one layer (a block outside a stack).

    Where ``fsdp_params`` puts 'data' on a leaf, a layer is gathered one of
    two ways, by the dimension the spec puts 'data' on:

    * inside the layer (d_model, heads, ff, ...): every rank holds a block
      of every layer, and the layer's blocks are all-gathered over 'data'
      on that dimension (``C.all_gather``; backward: the reduce-scatter of
      the layer's gradient);
    * on a LAYER axis (the layer count divides 'data' and the spec took
      it, as a reduced model's two layers on two data ranks): a layer
      lives whole on the rank that owns its block of layers. Every rank
      all-gathers its own slice at the layer's place in its block, and
      keeps the owner's, so that the owner's slice is handed to every rank;
      the backward's reduce-scatter sums the ranks' gradients of the layer
      onto the owner's slice (and exact zeros onto the others'). The
      gather holds one layer from every data rank for that moment; at the
      production meshes no layer count of a model that ``fsdp_params``
      (``launch.presets``) splits divides 16, so 'data' never lands
      there."""
    if fsdp is None:
        dims = tree_map(lambda t: None, params)
    else:
        dims = map_with_path(lambda path, t, spec: _data_dim(
            path[-1], spec, t.dim(), fsdp.experts), params, fsdp.specs)
    # the stacked axes' whole sizes
    lead_shape = list(first_leaf(params).shape[:lead])
    d = first_leaf(dims)
    if d is not None and d < lead:
        lead_shape[d] *= C.axis_size(fsdp.mesh, "data")
    grad = torch.is_grad_enabled()

    def split(t):
        if not lead:
            return t
        local = t.reshape(-1, *t.shape[lead:])
        return local.unbind(0) if grad else local

    parts = tree_map(split, params)
    out = []
    for i in range(math.prod(lead_shape)):
        idx, rest = [], i
        for n in reversed(lead_shape):
            idx.append(rest % n)
            rest //= n
        idx = idx[::-1]
        where = map_with_path(lambda _, t, dim: _locate(t, dim, idx, lead),
                              params, dims)
        lp = map_with_path(lambda _, t, part, w: part[w[0]] if lead else t,
                           params, parts, where)
        plan = None if fsdp is None else (
            fsdp.mesh, map_with_path(lambda _, t, w: w[1], params, where))
        out.append((lp, plan))
    return out


def _gather_leaf(t, step, mesh):
    if step is None:
        return t
    kind, arg = step
    if kind == "gather":
        return C.all_gather(t, mesh, "data", arg)
    # the owner's slice: this rank's slice of the same place gathered from
    # every data rank, the owner's kept; with no grad the others' are
    # dropped with the view, under grad a copy lets them go at once
    whole = C.all_gather(t.unsqueeze(0), mesh, "data", 0)[arg]
    return whole.clone() if torch.is_grad_enabled() else whole


def gather_layer(lp, plan):
    """`lp`, a layer's local tree from ``layer_slices``, with its leaves
    that 'data' splits all-gathered (``plan`` None: `lp` as it is)."""
    if plan is None:
        return lp
    mesh, steps = plan
    return map_with_path(lambda _, t, step: _gather_leaf(t, step, mesh),
                         lp, steps)


def gather_tree(tree, fsdp: Optional[Fsdp]):
    """A tree that is no stack (the MTP block, a top-level leaf's dict)
    gathered whole over 'data' where its leaves are read."""
    if fsdp is None:
        return tree
    return gather_layer(*layer_slices(tree, fsdp, lead=0)[0])


def _gathering(fn):
    """`fn(lp, ...)`, a layer function, taking (lp, plan, ...): the layer is
    gathered first, inside whatever wraps the result (``layer_fn``)."""
    def call(lp, plan, *args, **kwargs):
        return fn(gather_layer(lp, plan), *args, **kwargs)
    return call


def stack(params, x, cfg, run, *, kind="dense", positions=None, causal=True,
          mesh=None, d_ff=None, fsdp: Optional[Fsdp] = None):
    """Run x through a stacked block group -> (x, summed aux)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = layer_fn(_gathering(block), run)
    for lp, plan in layer_slices(params, fsdp):
        x, aux = layer(lp, plan, x, cfg, run, kind=kind, positions=positions,
                       causal=causal, mesh=mesh, d_ff=d_ff)
        aux_total = aux_total + aux
    return x, aux_total


def stack_decode(params, x, caches, cfg, run, *, kind="dense", mesh=None,
                 d_ff=None, fsdp: Optional[Fsdp] = None, whole: bool = False):
    """One token through a stacked group, threading per-layer caches.
    caches: dict of tensors stacked on axis 0; k and v are updated in place
    and `pos` is rewritten in place, so the dict handed back holds the same
    tensors."""
    for i, (lp, plan) in enumerate(layer_slices(params, fsdp)):
        cache = tree_map(lambda a: a[i], caches)
        x, new_cache = block_decode(gather_layer(lp, plan), x, cache, cfg,
                                    run, kind=kind, mesh=mesh, d_ff=d_ff,
                                    whole=whole)
        caches["pos"][i].copy_(new_cache["pos"])
    return x, caches


def stack_prefill(params, x, cfg, run, *, kind="dense", positions=None,
                  pad_to=0, mesh=None, d_ff=None, fsdp: Optional[Fsdp] = None):
    """Run a stacked group, collecting per-layer caches stacked on a
    leading axis: (x, (k, v)) with k, v (L, B, max(S, pad_to), K, D), or
    for MLA (x, (ckv, kr)) with ckv (L, B, max(S, pad_to), r) and kr
    (L, B, max(S, pad_to), rope); over a mesh, this rank's blocks."""
    slices = layer_slices(params, fsdp)
    n = len(slices)
    out = None
    for i, (lp, plan) in enumerate(slices):
        x, kv = block_prefill(gather_layer(lp, plan), x, cfg, run,
                              kind=kind, positions=positions, pad_to=pad_to,
                              mesh=mesh, d_ff=d_ff)
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


def _rwkv_params(lp, plan, wo, cfg, mesh):
    """A layer's parameters, gathered over 'data' (``gather_layer``), with
    the rows of its ``wo`` that this rank reads (``rwkv.wo_rows``, inside
    the layer function so that a remat policy remakes them in the backward
    instead of keeping every layer's). `wo` is None where wo is a leaf of
    the layer's tree, else (the layer's wo or None, like, its 'data'
    step)."""
    lp = gather_layer(lp, plan)
    if wo is None:
        return {**lp, "wo": R.wo_rows(lp["wo"], cfg, mesh)}
    w, like, step = wo
    if step is not None:
        if w is not None:
            w = _gather_leaf(w, step, mesh)
        else:
            # a layer this 'model' rank does not own: its data peers own
            # none either; like (zeros in wo_rows) at the gathered shape
            like = torch.cat([like] * C.axis_size(mesh, "data"), step[1])
    return {**lp, "wo": R.wo_rows(w, cfg, mesh, like)}


def _rwkv_layer(lp, plan, wo, x, cfg, run, mesh):
    lp = _rwkv_params(lp, plan, wo, cfg, mesh)
    return R.rwkv_block(lp, x, cfg, run, _norms(lp), mesh)


def _rwkv_layers(params, mesh, fsdp=None):
    """[(layer's local tree, its plan, wo)] (``_rwkv_params``). wo's
    leading axis is the layers': where 'model' leaves it whole (read from
    the spec under FSDP, else from the shape), wo is one more leaf of the
    layer (``layer_slices``: 'data' may split it on any axis, the layer
    axis too). Split on it over 'model', a rank holds the layers of its
    block (and None for the others' layers), `like` is a layer of its block
    (``rwkv.wo_rows``), and 'data' can only split it inside a layer: its
    step gathers the owner's slice."""
    n = params["ln1"].shape[0]
    wo = params["wo"]
    spec = fsdp.specs["wo"] if fsdp is not None else None
    by_model = spec[0] == "model" if spec else wo.shape[0] != n
    if not by_model:
        return [(lp, plan, None) for lp, plan in layer_slices(params, fsdp)]
    rest = {k: v for k, v in params.items() if k != "wo"}
    rest_fsdp = None if fsdp is None else Fsdp(
        {k: v for k, v in fsdp.specs.items() if k != "wo"}, fsdp.mesh)
    dim = None if spec is None else _data_dim("wo", spec, wo.dim(), False)
    step = None if dim is None else ("gather", dim - 1)
    per = wo.shape[0]
    mine = C.axis_index(mesh, "model")
    own = [lp["wo"] for lp, _ in layer_slices({"wo": wo})]
    return [(lp, plan, (own[i % per] if i // per == mine else None, own[0],
                        step))
            for i, (lp, plan) in enumerate(layer_slices(rest, rest_fsdp))]


def rwkv_stack(params, x, cfg, run, mesh=None, fsdp: Optional[Fsdp] = None):
    layer = layer_fn(_rwkv_layer, run)
    for lp, plan, wo in _rwkv_layers(params, mesh, fsdp):
        x = layer(lp, plan, wo, x, cfg, run, mesh)
    return x


def rwkv_stack_decode(params, x, caches, cfg, run, mesh=None,
                      fsdp: Optional[Fsdp] = None):
    """One token through the stack; caches {"wkv", "tm_last", "cm_last"}
    stacked on axis 0 are updated in place and handed back."""
    for i, (lp, plan, wo) in enumerate(_rwkv_layers(params, mesh, fsdp)):
        lp = _rwkv_params(lp, plan, wo, cfg, mesh)
        x, _ = R.rwkv_block_decode(lp, x, tree_map(lambda a: a[i], caches),
                                   cfg, run, _norms(lp), mesh)
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


def _mamba_layer(lp, x, cfg, run, mesh=None):
    return x + SSM.mamba2(lp, L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg, run,
                          mesh)


def _sub(fsdp: Optional[Fsdp], name: str) -> Optional[Fsdp]:
    return None if fsdp is None else fsdp.sub(name)


def hybrid_stack(params, x, cfg, run, *, positions=None, mesh=None,
                 fsdp: Optional[Fsdp] = None):
    """The groups' Mamba2 blocks (each under `run.remat`), each group
    followed by its shared block, unwrapped (gathered at each use)."""
    mamba, shared = params["mamba"], params["shared"]
    G, period = mamba["ln"].shape[:2]
    blocks = layer_slices(mamba, _sub(fsdp, "mamba"), lead=2)
    sets = layer_slices(shared, _sub(fsdp, "shared"))
    layer = layer_fn(_gathering(_mamba_layer), run)
    for g in range(G):
        for lp, plan in blocks[g * period:(g + 1) * period]:
            x = layer(lp, plan, x, cfg, run, mesh)
        x, _ = block(gather_layer(*sets[g % len(sets)]), x, cfg, run,
                     kind="dense", positions=positions, mesh=mesh,
                     d_ff=_shared_d_ff(cfg))
    return x


def hybrid_stack_decode(params, x, caches, cfg, run, mesh=None,
                        fsdp: Optional[Fsdp] = None, whole: bool = False):
    """caches: {"mamba": (G, period, ...) Mamba2 caches, "attn": (G, ...) KV
    caches}, updated in place and handed back."""
    mamba, shared = params["mamba"], params["shared"]
    G, period = mamba["ln"].shape[:2]
    blocks = layer_slices(mamba, _sub(fsdp, "mamba"), lead=2)
    sets = layer_slices(shared, _sub(fsdp, "shared"))
    for g in range(G):
        for i in range(period):
            lp = gather_layer(*blocks[g * period + i])
            y, _ = SSM.mamba2_decode(
                lp, L.rms_norm(x, lp["ln"], cfg.norm_eps),
                tree_map(lambda a: a[g, i], caches["mamba"]), cfg, run, mesh)
            x = x + y
        x, new = block_decode(gather_layer(*sets[g % len(sets)]), x,
                              tree_map(lambda a: a[g], caches["attn"]), cfg,
                              run, kind="dense", mesh=mesh,
                              d_ff=_shared_d_ff(cfg), whole=whole)
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


def vlm_stack(params, x, media, cfg, run, *, positions=None, mesh=None,
              fsdp: Optional[Fsdp] = None):
    """x (B, S, d) through the groups; media (B, M, d) in x's dtype. The
    self-attention blocks run under `run.remat`, the cross block
    unwrapped."""
    selfp, crossp = params["self"], params["cross"]
    n_self = selfp["ln1"].shape[1]
    selfs = layer_slices(selfp, _sub(fsdp, "self"), lead=2)
    layer = layer_fn(_gathering(block), run)
    for g, cross in enumerate(layer_slices(crossp, _sub(fsdp, "cross"))):
        for lp, plan in selfs[g * n_self:(g + 1) * n_self]:
            x, _ = layer(lp, plan, x, cfg, run, kind="dense",
                         positions=positions, mesh=mesh)
        cp = gather_layer(*cross)
        x, _ = block(cp, x, cfg, run, kind="cross", mesh=mesh,
                     media_kv=A.cross_attn_kv(cp["attn"], media, cfg, mesh))
    return x


def vlm_stack_decode(params, x, media, caches, cfg, run, mesh=None,
                     fsdp: Optional[Fsdp] = None, whole: bool = False):
    """caches: the self-attention blocks' KV caches, leaves
    (G, period - 1, B, ...), updated in place and handed back."""
    selfp, crossp = params["self"], params["cross"]
    n_self = selfp["ln1"].shape[1]
    selfs = layer_slices(selfp, _sub(fsdp, "self"), lead=2)
    for g, cross in enumerate(layer_slices(crossp, _sub(fsdp, "cross"))):
        for i in range(n_self):
            x, new = block_decode(gather_layer(*selfs[g * n_self + i]), x,
                                  tree_map(lambda a: a[g, i], caches), cfg,
                                  run, kind="dense", mesh=mesh, whole=whole)
            caches["pos"][g, i].copy_(new["pos"])
        cp = gather_layer(*cross)
        x, _ = block_decode(cp, x, None, cfg, run, kind="cross", mesh=mesh,
                            media_kv=A.cross_attn_kv(cp["attn"], media, cfg,
                                                     mesh))
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


def encdec_encode(params, frames, cfg, run, mesh=None,
                  fsdp: Optional[Fsdp] = None):
    """The encoder half of ``encdec_apply``: frames (B, enc_len, d) plus the
    sinusoid, the non-causal stack and enc_ln -> enc_out (B, enc_len, d),
    what ``encdec_decode`` attends to."""
    S = frames.shape[1]
    enc = frames + _sinusoid(S, cfg.d_model, frames.dtype, frames.device)
    enc, _ = stack(params["enc"], enc, cfg, run, kind="dense",
                   positions=torch.arange(S, device=frames.device),
                   causal=False, mesh=mesh, fsdp=_sub(fsdp, "enc"))
    return L.rms_norm(enc, params["enc_ln"], cfg.norm_eps)


def _dec_cross(lp, h, enc_out, cfg, run, mesh=None):
    kv = A.cross_attn_kv(lp["cross"], enc_out, cfg, mesh)
    c = L.rms_norm(h, lp["ln_cross"], cfg.norm_eps)
    return A.cross_attn(lp["cross"], c, kv, run, gated=False, cfg=cfg,
                        mesh=mesh)


def _dec_block(lp, x, enc_out, cfg, run, positions, mesh=None):
    """One decoder layer: the dense block, then the ungated cross-attention
    to enc_out added to its output."""
    h, _ = block(lp, x, cfg, run, kind="dense", positions=positions,
                 mesh=mesh)
    return h + _dec_cross(lp, h, enc_out, cfg, run, mesh)


def encdec_apply(params, frames, tokens_x, cfg, run, *, positions=None,
                 mesh=None, fsdp: Optional[Fsdp] = None):
    """frames (B, enc_len, d) stub embeddings; tokens_x (B, S, d) embedded
    tokens -> the decoder's output (B, S, d). The decoder layers run under
    `run.remat`, as the encoder's blocks do (``stack``)."""
    enc_out = encdec_encode(params, frames, cfg, run, mesh, fsdp)
    layer = layer_fn(_gathering(_dec_block), run)
    x = tokens_x
    for lp, plan in layer_slices(params["dec"], _sub(fsdp, "dec")):
        x = layer(lp, plan, x, enc_out, cfg, run, positions, mesh)
    return x


def encdec_decode(params, x, enc_out, caches, cfg, run, mesh=None,
                  fsdp: Optional[Fsdp] = None, whole: bool = False):
    """One token through the decoder; caches: the self-attention KV caches,
    leaves (n_layers, B, ...), updated in place and handed back."""
    for i, slices in enumerate(layer_slices(params["dec"],
                                            _sub(fsdp, "dec"))):
        lp = gather_layer(*slices)
        h, new = block_decode(lp, x, tree_map(lambda a: a[i], caches), cfg,
                              run, kind="dense", mesh=mesh, whole=whole)
        caches["pos"][i].copy_(new["pos"])
        x = h + _dec_cross(lp, h, enc_out, cfg, run, mesh)
    return x, caches
