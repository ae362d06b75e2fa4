"""Weights and caches across the two packages, as nested dicts of numpy
arrays.

The port keeps the JAX package's parameter names and layouts, so conversion
is a copy leaf by leaf: ``jax.tree.map(np.asarray, params)`` on the JAX side
gives the tree these functions take, and what they give back loads there
with ``jax.tree.map(jnp.asarray, tree)``. Nothing here imports JAX. A
missing, extra or mis-shaped leaf raises.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.optim import OptState
from repro_torch.train.step import TrainState


def _moe_leaves(mla: bool, dense_layers: bool):
    names = ("ckv", "kr", "pos") if mla else ("k", "v", "pos")
    groups = ("dense", "moe") if dense_layers else ("moe",)
    return tuple(f"{g}.{n}" for g in groups for n in names)


# the cache leaves of each ported family (the moe family: GQA or MLA, with
# or without leading dense layers), as paths joined by dots; the vlm's are
# its self-attention blocks' (G, period - 1, ...), the audio family's its
# decoder layers'
CACHE_LEAVES = {
    "dense": ("k", "v", "pos"),
    "vlm": ("k", "v", "pos"),
    "audio": ("k", "v", "pos"),
    "ssm": ("wkv", "tm_last", "cm_last"),
    "hybrid": ("mamba.h", "mamba.conv", "attn.k", "attn.v", "attn.pos"),
    "moe": _moe_leaves(False, False),
    "moe+dense": _moe_leaves(False, True),
    "moe-mla": _moe_leaves(True, False),
    "moe-mla+dense": _moe_leaves(True, True),
}
# the scale leaves an int8 KV cache adds beside each GQA cache's k and v
SCALE_LEAVES = ("k_scale", "v_scale")


def _cache_leaves(kind: str, quant: bool):
    """CACHE_LEAVES[kind], with k_scale and v_scale beside every k when
    `quant` (an int8 GQA cache; MLA and RWKV caches have no scales)."""
    leaves = CACHE_LEAVES[kind]
    if not quant:
        return leaves
    out = []
    for path in leaves:
        out.append(path)
        if path.rsplit(".", 1)[-1] == "k":
            out += [path[:-1] + name for name in SCALE_LEAVES]
    return tuple(out)


def _is_quant(flat: Mapping) -> bool:
    return any(path.rsplit(".", 1)[-1] in SCALE_LEAVES for path in flat)


# (leaf, its batch axis, leaf with the cache length or None, its axis)
_CACHE_SIZES = {"dense": ("k", 1, "k", 2), "ssm": ("wkv", 1, None, None),
                "hybrid": ("mamba.h", 2, "attn.k", 2),
                "moe": ("moe.pos", 1, "moe.k", 2),
                "moe+dense": ("moe.pos", 1, "moe.k", 2),
                "moe-mla": ("moe.pos", 1, "moe.ckv", 2),
                "moe-mla+dense": ("moe.pos", 1, "moe.ckv", 2),
                "vlm": ("k", 2, "k", 3), "audio": ("k", 1, "k", 2)}


def _cache_kind(model: Model) -> str:
    cfg = model.cfg
    if cfg.family != "moe":
        return cfg.family
    return ("moe-mla" if cfg.attention_kind == "mla" else "moe") + \
        ("+dense" if cfg.moe.first_dense_layers else "")


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path + "."))
        else:
            flat[path] = value
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def _to_tensor(value, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own; go through float32
        arr = arr.astype(np.float32)
    # torch.tensor copies: the result never shares memory with the array,
    # which may be read-only and is not the port's to update in place
    return torch.tensor(arr).to(device=device, dtype=dtype)


def _own_dtype(value) -> torch.dtype:
    """The torch dtype of a numpy leaf (numpy's float32 / int32, or the
    bfloat16 that JAX arrays convert to)."""
    arr = np.asarray(value)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), dtype=arr.dtype)).dtype


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _check_leaves(kind: str, got, want) -> None:
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing:
        raise KeyError(f"{kind}: missing leaves {missing}")
    if extra:
        raise KeyError(f"{kind}: unexpected leaves {extra}")


@torch.no_grad()
def params_from_numpy(tree: Mapping, model: Model) -> Model:
    """Load a parameter tree (nested dicts of numpy arrays, names and
    layouts of the JAX package) into `model`, in place."""
    flat = flatten_tree(tree)
    own = model.state_dict()
    _check_leaves("params", flat, own)
    for path, param in own.items():
        shape = tuple(np.shape(flat[path]))
        if shape != tuple(param.shape):
            raise ValueError(f"params: leaf {path} has shape {shape}, the "
                             f"model wants {tuple(param.shape)}")
    for path, param in own.items():
        param.copy_(_to_tensor(flat[path], param.dtype, param.device))
    return model


def shard_params(params: Mapping, specs: Mapping, mesh) -> Dict:
    """This rank's blocks of a whole parameter tree under `specs`
    (``rules.param_specs``): the JAX package's full parameters (numpy
    arrays) carried to one rank's shards, ready for ``params_from_numpy``
    into a ``Model`` over `mesh`; tensors give tensors."""
    from repro_torch.sharding.rules import shard_tensor
    out = {}
    for name, value in params.items():
        if isinstance(value, Mapping):
            out[name] = shard_params(value, specs[name], mesh)
        elif isinstance(value, torch.Tensor):
            out[name] = shard_tensor(value, specs[name], mesh).contiguous()
        else:
            out[name] = np.ascontiguousarray(
                shard_tensor(np.asarray(value), specs[name], mesh))
    return out


def shard_caches(caches: Mapping, specs: Mapping, mesh) -> Dict:
    """This rank's blocks of a whole cache tree (the JAX package's caches
    of one device, numpy arrays, or the port's tensors) under `specs`
    (``Model.cache_specs``): the blocks a model over `mesh` holds
    (``Model.init_caches``); the inverse of ``gather_caches``."""
    return shard_params(caches, specs, mesh)


def gather_caches(blocks, specs: Mapping, mesh) -> Dict:
    """The whole cache tree from every rank's blocks (`blocks[r]`: world
    rank r's cache tree, numpy arrays or tensors, as ``caches_to_numpy`` or
    the model gives them) under `specs`: what one device would hold, to be
    held against the JAX package's caches."""
    from repro_torch.sharding.rules import gather_tensor
    flat = [flatten_tree(b) for b in blocks]
    spec_flat = flatten_tree(specs)
    return unflatten_tree({path: gather_tensor([f[path] for f in flat],
                                               spec_flat[path], mesh)
                           for path in flat[0]})


def params_to_numpy(model: Model) -> Dict:
    """The model's parameters as nested dicts of numpy arrays (bfloat16
    leaves come back as float32)."""
    return unflatten_tree({path: _to_numpy(p)
                       for path, p in model.state_dict().items()})


def _wanted_caches(flat: Mapping, model: Model) -> Dict[str, torch.Tensor]:
    """The model's caches on the meta device, flattened, at the batch size
    and cache length that `flat` carries."""
    kind, quant = _cache_kind(model), _is_quant(flat)
    _check_leaves("caches", flat, _cache_leaves(kind, quant))
    leaf, b_axis, len_leaf, len_axis = _CACHE_SIZES[kind]
    shape = np.shape(flat[leaf])
    if len(shape) <= b_axis:
        raise ValueError(f"caches: {leaf} has shape {shape}, no batch axis")
    max_len = 1
    if len_leaf is not None:
        len_shape = np.shape(flat[len_leaf])
        if len(len_shape) <= len_axis:
            raise ValueError(f"caches: {len_leaf} has shape {len_shape}, no "
                             f"length axis")
        max_len = len_shape[len_axis]
    return flatten_tree(model.init_caches(shape[b_axis], max_len,
                                          device="meta", quant=quant))


def caches_from_numpy(tree: Mapping, model: Model) -> Dict:
    """A cache tree of the JAX package as the port's caches, on the model's
    device, in the dtypes the model's own caches have:
      dense:  {"k", "v": (L,B,Smax,K,D), "pos": (L,B)};
      ssm:    {"wkv": (L,B,H,K,K) float32, "tm_last", "cm_last": (L,B,d)};
      hybrid: {"mamba": {"h": (G,P,B,H,N,Pd) float32, "conv": (G,P,B,W-1,C)},
               "attn": {"k", "v": (G,B,Smax,K,D), "pos": (G,B)}};
      moe:    {"moe": the dense tree, or for MLA {"ckv": (L,B,Smax,r),
               "kr": (L,B,Smax,rope), "pos": (L,B)}, and "dense" of the same
               kind when the config has leading dense layers};
      vlm:    {"k", "v": (G,P-1,B,Smax,K,D), "pos": (G,P-1,B)};
      audio:  the dense tree over the decoder's layers.
    An int8 KV cache (a tree with k_scale / v_scale beside each k and v)
    keeps its int8 k and v as int8 (never through float32) and its
    bfloat16 scales by name; a tree without scales loads in the compute
    dtype, whatever the model's ``kv_cache_dtype`` (what its prefill
    returns)."""
    flat = flatten_tree(tree)
    want = _wanted_caches(flat, model)
    for path, w in want.items():
        shape = tuple(np.shape(flat[path]))
        if shape != tuple(w.shape):
            raise ValueError(f"caches: leaf {path} has shape {shape}, the "
                             f"model wants {tuple(w.shape)}")
    return unflatten_tree({path: _to_tensor(flat[path], w.dtype, model.device)
                           for path, w in want.items()})


def caches_to_numpy(caches: Mapping) -> Dict:
    """The port's caches as nested dicts of numpy arrays (bfloat16 leaves
    come back as float32, int8 ones as int8). The leaves must be those of a
    ported family, with or without int8 scales."""
    flat = flatten_tree(caches)
    if set(flat) not in [set(_cache_leaves(kind, _is_quant(flat)))
                         for kind in CACHE_LEAVES]:
        raise KeyError(f"caches: leaves {sorted(flat)} are no ported "
                       f"family's ({CACHE_LEAVES})")
    return unflatten_tree({path: _to_numpy(t) for path, t in flat.items()})


def _field(tree, name: str):
    """A field of a train state: an attribute (the reference's NamedTuples
    after ``jax.tree.map(np.asarray, state)``) or a key (a dict)."""
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _tensors_like(tree: Mapping, params: Mapping, kind: str) -> Dict:
    """A numpy tree with the leaves of `params` as tensors on their device,
    each in the numpy leaf's own dtype."""
    flat, own = flatten_tree(tree), flatten_tree(params)
    _check_leaves(kind, flat, own)
    out = {}
    for path, p in own.items():
        shape = tuple(np.shape(flat[path]))
        if shape != tuple(p.shape):
            raise ValueError(f"{kind}: leaf {path} has shape {shape}, the "
                             f"model wants {tuple(p.shape)}")
        out[path] = _to_tensor(flat[path], _own_dtype(flat[path]), p.device)
    return unflatten_tree(out)


def train_state_from_numpy(tree, model: Model) -> TrainState:
    """A train state of the reference (``TrainState(params, OptState(step,
    m, v, master), residual)`` with numpy leaves, or a dict of the same
    fields) as the port's: the params loaded into `model` and made
    trainable, the moments, master and residual on the model's device in
    their own dtypes, the step a 0-d int32 tensor on the CPU."""
    params_from_numpy(_field(tree, "params"), model)
    params = model.trainable().params
    opt = _field(tree, "opt")
    master = _field(opt, "master")
    residual = _field(tree, "residual")
    step = torch.tensor(int(np.asarray(_field(opt, "step"))),
                        dtype=torch.int32)
    return TrainState(
        params,
        OptState(step, _tensors_like(_field(opt, "m"), params, "m"),
                 _tensors_like(_field(opt, "v"), params, "v"),
                 None if master is None else
                 _tensors_like(master, params, "master")),
        None if residual is None else
        _tensors_like(residual, params, "residual"))


def train_state_to_numpy(state: TrainState) -> Dict:
    """The port's train state as {"params", "opt": {"step", "m", "v",
    "master"}, "residual"} of numpy arrays (bfloat16 leaves as float32,
    None kept), the fields of the reference's TrainState and OptState."""
    def tree(t: Optional[Mapping]):
        if t is None:
            return None
        return unflatten_tree({path: _to_numpy(v)
                               for path, v in flatten_tree(t).items()})

    opt = state.opt
    return {"params": tree(state.params),
            "opt": {"step": np.asarray(int(opt.step), dtype=np.int32),
                    "m": tree(opt.m), "v": tree(opt.v),
                    "master": tree(opt.master)},
            "residual": tree(state.residual)}

