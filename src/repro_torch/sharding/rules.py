"""Logical-axis sharding rules: parameter-tree leaf name -> partition spec,
a copy of the reference's ``repro/sharding/rules.py``.

Megatron-style tensor parallelism over the 'model' mesh axis:
  attention heads, MLP ff dim, expert dim, vocab dim -> 'model'
plus optional FSDP of expert ff over 'data' (RunConfig.fsdp_experts) and
ZeRO-1 sharding of optimizer state over ('pod','data').

A spec is the port's ``PartitionSpec``: a tuple with one entry a dimension
(trailing entries may be left out), each None (replicated), an axis name
or a tuple of names (split over their product, the first major). ``()``
is wholly replicated. Specs are *trailing-dim* patterns: stacked params
(leading layer / group dims) get Nones prepended. A dim whose size is not
divisible by its mesh axis falls back to replicated (e.g. whisper's 12
heads on a 16-way model axis, chatglm's 2 KV heads).

`mesh` is anything with ``shape`` (a name -> size mapping) and
``axis_names``: a ``launch.mesh.Mesh``, a ``MeshShape``, or the
reference's mesh. ``rank_coords``, ``local_shape``, ``shard_tensor`` and
``gather_tensor`` are the port's own: a rank's coordinates, the shape of
its block, the block itself, and the whole tensor from every rank's
block.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import RunConfig

Spec = Tuple

# (leaf name, trailing spec). First rank-compatible match wins.
_RULES = [
    ("embed", ("model", None)),
    ("head", ("model", None)),
    # attention projections (d, H, Dh) / (H, Dh, d)
    ("wq", (None, "model", None)),
    ("wk", (None, "model", None)),
    ("wv", (None, "model", None)),
    ("wo", ("model", None, None)),
    ("wo", ("model", None)),            # rwkv output (d, d)
    # MLA
    ("wuq", (None, "model", None)),
    ("wuk", (None, "model", None)),
    ("wuv", (None, "model", None)),
    # dense MLP (d, ff) / (ff, d)
    ("gate", (None, "model")),
    ("up", (None, "model")),
    ("down", ("model", None)),
    # MoE experts (E, d, f) / (E, f, d); f optionally FSDP over data
    ("w_gate", ("model", None, "__ff__")),
    ("w_up", ("model", None, "__ff__")),
    ("w_down", ("model", "__ff__", None)),
    # rwkv
    ("wg", (None, "model")),
    ("w_lora_b", (None, "model", None)),
    ("u", ("model", None)),
    ("w0", ("model", None)),
    ("cm_k", (None, "model")),
    ("cm_v", ("model", None)),
    # mamba2
    ("in_proj", (None, "model")),
    ("out_proj", ("model", None)),
    ("conv_w", (None, "model")),
    ("conv_b", ("model",)),
    ("A_log", ("model",)),
    ("D", ("model",)),
    ("dt_bias", ("model",)),
    ("ssm_norm", ("model",)),
]


def _axis_size(mesh, name: str) -> int:
    try:
        return mesh.shape[name]
    except (KeyError, TypeError):
        return 1


def _spec_for(name: str, shape: Tuple[int, ...], mesh, run: RunConfig
              ) -> Spec:
    ff_axis = "data" if run.fsdp_experts else None
    for rule_name, trailing in _RULES:
        if rule_name != name or len(trailing) > len(shape):
            continue
        lead = len(shape) - len(trailing)
        spec = [None] * lead
        for dim, ax in zip(shape[lead:], trailing):
            if ax == "__ff__":
                ax = ff_axis
            if ax is not None and dim % max(_axis_size(mesh, ax), 1) == 0 \
                    and _axis_size(mesh, ax) > 1:
                spec.append(ax)
            else:
                spec.append(None)       # unsplit, or non-divisible
        if run.fsdp_params:
            # FSDP: 2D-shard, 'data' on the first replicated divisible dim
            return _zero1_extend(tuple(spec), shape, mesh, ("data",))
        return tuple(spec)
    return ()                           # replicated (norms, scalars, biases)


def map_with_path(fn, tree, *rest, path=()):
    """fn(path, leaf, *the leaves at that path of `rest`) over nested dicts
    -> a tree like `tree`."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def param_specs(params, mesh, run: RunConfig):
    """A spec for every leaf of `params` (nested dicts of anything with a
    ``shape``: tensors, tensors on the meta device, numpy arrays)."""
    if mesh is None:
        return map_with_path(lambda path, leaf: (), params)
    return map_with_path(lambda path, leaf: _spec_for(
        path[-1] if path else "", tuple(leaf.shape), mesh, run), params)


def _zero1_extend(spec: Spec, shape: Tuple[int, ...], mesh,
                  axes=("data",)) -> Spec:
    """ZeRO-1: additionally shard over each of `axes` on the first dim that
    is still replicated and divisible."""
    spec_t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for ax in axes:
        n = _axis_size(mesh, ax)
        if n <= 1:
            continue
        used = set(a for a in spec_t if a is not None)
        if ax in used:
            continue
        for i, (dim, cur) in enumerate(zip(shape, spec_t)):
            if cur is None and dim % n == 0 and dim >= n:
                spec_t = spec_t[:i] + (ax,) + spec_t[i + 1:]
                break
    return spec_t


def zero1_axes(mesh, run: RunConfig) -> Tuple[str, ...]:
    """The axes ZeRO-1 extends the optimizer state over."""
    if mesh is None or not run.zero1:
        return ()
    return tuple(a for a in ("data", "pod") if _axis_size(mesh, a) > 1)


def state_spec(spec: Spec, shape, mesh, run: RunConfig) -> Spec:
    """The spec of a moment (or master) of a leaf of `shape` and `spec`."""
    axes = zero1_axes(mesh, run)
    return _zero1_extend(spec, tuple(shape), mesh, axes) if axes else spec


def cache_specs(caches, mesh, run: RunConfig, global_batch: int):
    """Specs for serve caches. Batch dim over (pod, data) when divisible;
    KV heads / state heads over 'model' when divisible."""
    if mesh is None:
        return map_with_path(lambda path, leaf: (), caches)
    baxes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    dp = 1
    for a in baxes:
        dp *= _axis_size(mesh, a)
    bax = _canon(baxes) if (dp > 1 and global_batch % dp == 0) else None

    def model_if(dim):
        n = _axis_size(mesh, "model")
        return "model" if (n > 1 and dim % n == 0) else None

    def one(path, leaf):
        name = path[-1] if path else ""
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name == "pos" or nd <= 1:
            return ()
        if name in ("k", "v", "k_scale", "v_scale"):  # (..., B, S, K, D|1)
            lead = nd - 4
            k_ax = model_if(shape[lead + 2])
            # too few KV heads to shard (GQA kv<16, MQA): shard the cache's
            # SEQUENCE dim over 'model' instead (flash-decoding layout)
            s_ax = None if k_ax else model_if(shape[lead + 1])
            return (*([None] * lead), bax, s_ax, k_ax, None)
        if name in ("ckv", "kr"):          # (..., B, S, r) — MLA latents
            lead = nd - 3
            return (*([None] * lead), bax, model_if(shape[lead + 1]), None)
        if name == "h":                    # (..., B, H, N, P)
            lead = nd - 4
            return (*([None] * lead), bax, model_if(shape[lead + 1]), None,
                    None)
        if name == "conv":                 # (..., B, W, C)
            lead = nd - 3
            return (*([None] * lead), bax, None, model_if(shape[lead + 2]))
        if name == "wkv":                  # (..., B, H, K, K)
            lead = nd - 4
            return (*([None] * lead), bax, model_if(shape[lead + 1]), None,
                    None)
        if name in ("tm_last", "cm_last"):  # (..., B, d)
            lead = nd - 2
            return (*([None] * lead), bax, None)
        return ()

    return map_with_path(one, caches)


def opt_state_specs(opt_state, p_specs, params, mesh, run: RunConfig):
    """Specs for OptState(step, m, v, master): moments & master follow the
    param spec, ZeRO-1-extended over 'data' (+ 'pod' if present)."""
    from repro_torch.optim.adamw import OptState
    if mesh is None:
        return OptState((), map_with_path(lambda p, s: (), p_specs),
                        map_with_path(lambda p, s: (), p_specs),
                        None if opt_state.master is None else
                        map_with_path(lambda p, s: (), p_specs))

    def z(path, spec, leaf):
        return state_spec(spec, leaf.shape, mesh, run)

    m = map_with_path(z, p_specs, params)
    v = map_with_path(z, p_specs, params)
    master = None if opt_state.master is None else map_with_path(z, p_specs,
                                                             params)
    return OptState((), m, v, master)


def batch_spec(mesh, ndim: int = 2) -> Spec:
    if mesh is None:
        return ()
    axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return (_canon(axes), *([None] * (ndim - 1)))


def _canon(axes: Tuple[str, ...]):
    """An entry of names as the reference's PartitionSpec keeps it: None
    for none, the name for one, the tuple for more."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


# ---------------------------------------------------------------------------
# blocks of a rank (the port's own)
# ---------------------------------------------------------------------------


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _parts(mesh, entry) -> int:
    n = 1
    for a in entry_axes(entry):
        n *= _axis_size(mesh, a)
    return n


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The axes a spec splits over, in order of appearance."""
    return tuple(a for e in spec for a in entry_axes(e))


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of `shape` under `spec`."""
    out = list(shape)
    for i, entry in enumerate(spec):
        n = _parts(mesh, entry)
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {entry} ({n})")
        out[i] //= n
    return tuple(out)


def rank_coords(mesh, rank: int) -> Dict[str, int]:
    """World rank `rank`'s coordinates on the mesh's axes, row-major in
    ``axis_names`` (as ``jax.make_mesh`` lays out the CPU's devices)."""
    out = {}
    for name in reversed(tuple(mesh.axis_names)):
        n = mesh.shape[name]
        out[name] = rank % n
        rank //= n
    return {name: out[name] for name in mesh.axis_names}


def block_index(mesh, entry, coords=None) -> int:
    """A rank's place among the parts of a dim split over `entry`: its
    coordinates on the entry's axes, row-major in the entry's order."""
    coords = mesh.coords if coords is None else coords
    i = 0
    for a in entry_axes(entry):
        i = i * _axis_size(mesh, a) + coords.get(a, 0)
    return i


def shard_tensor(t, spec: Spec, mesh, base: Spec = (), coords=None):
    """This rank's block of `t` under `spec` (a tensor or a numpy array;
    a view where slicing gives one). `t` may already be split by `base`
    (a spec whose every split is also in `spec`): then only the dims split
    further are cut. `coords` (axis -> index) defaults to the mesh's
    rank's."""
    index = [slice(None)] * len(t.shape)
    for i, entry in enumerate(spec):
        have = base[i] if i < len(base) else None
        if entry == have or entry is None:
            continue
        if have is not None:
            raise ValueError(f"dim {i}: {have} cannot be cut to {entry}")
        n = _parts(mesh, entry)
        size = t.shape[i] // n
        j = block_index(mesh, entry, coords)
        index[i] = slice(j * size, (j + 1) * size)
    return t[tuple(index)]


def gather_tensor(blocks: Sequence, spec: Spec, mesh):
    """The whole tensor from every rank's block (`blocks[r]`: world rank r's
    block under `spec`), numpy arrays or tensors: the inverse of
    ``shard_tensor`` over the mesh's ranks."""
    import numpy as np
    first = blocks[0]
    shape = [s * _parts(mesh, spec[i] if i < len(spec) else None)
             for i, s in enumerate(first.shape)]
    torch_like = not isinstance(first, np.ndarray)
    out = (first.new_empty(shape) if torch_like
           else np.empty(shape, dtype=first.dtype))
    for r, block in enumerate(blocks):
        coords = rank_coords(mesh, r)
        index = [slice(None)] * len(shape)
        for i, entry in enumerate(spec):
            if entry is None:
                continue
            size = first.shape[i]
            j = block_index(mesh, entry, coords)
            index[i] = slice(j * size, (j + 1) * size)
        out[tuple(index)] = block
    return out
