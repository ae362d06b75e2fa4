"""Weights and caches across the two packages, as nested dicts of numpy
arrays.

The port keeps the JAX package's parameter names and layouts, so conversion
is a copy leaf by leaf: ``jax.tree.map(np.asarray, params)`` on the JAX side
gives the tree these functions take, and what they give back loads there
with ``jax.tree.map(jnp.asarray, tree)``. Nothing here imports JAX. A
missing, extra or mis-shaped leaf raises.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models.model import Model

CACHE_LEAVES = ("k", "v", "pos")


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


def params_to_numpy(model: Model) -> Dict:
    """The model's parameters as nested dicts of numpy arrays (bfloat16
    leaves come back as float32)."""
    return unflatten_tree({path: _to_numpy(p)
                       for path, p in model.state_dict().items()})


def caches_from_numpy(tree: Mapping, model: Model) -> Dict:
    """A KV-cache tree of the JAX package ({"k", "v": (L,B,Smax,K,D),
    "pos": (L,B)}) as the port's caches, on the model's device."""
    _check_leaves("caches", tree, CACHE_LEAVES)
    cfg = model.cfg
    k_shape = tuple(np.shape(tree["k"]))
    if len(k_shape) != 5 or k_shape[0] != cfg.n_layers or \
            k_shape[3:] != (cfg.n_kv_heads, cfg.d_head):
        raise ValueError(f"caches: k has shape {k_shape}, the model wants "
                         f"({cfg.n_layers}, B, Smax, {cfg.n_kv_heads}, "
                         f"{cfg.d_head})")
    if tuple(np.shape(tree["v"])) != k_shape:
        raise ValueError("caches: v does not match k in shape")
    if tuple(np.shape(tree["pos"])) != k_shape[:2]:
        raise ValueError(f"caches: pos has shape {np.shape(tree['pos'])}, "
                         f"wanted {k_shape[:2]}")
    return {"k": _to_tensor(tree["k"], model.compute_dtype, model.device),
            "v": _to_tensor(tree["v"], model.compute_dtype, model.device),
            "pos": _to_tensor(tree["pos"], torch.int32, model.device)}


def caches_to_numpy(caches: Mapping) -> Dict:
    _check_leaves("caches", caches, CACHE_LEAVES)
    return {name: _to_numpy(caches[name]) for name in CACHE_LEAVES}
