"""AdamW with a float32 master copy, optional low-precision (bf16) moments
and global-norm clipping, as the reference's ``repro/optim/adamw.py``.

Parameters, gradients and moments are nested dicts of tensors. The update
is elementwise tensor code on each leaf (the reference leaves it to XLA, no
kernel of its own). Unlike the reference it writes the new values into the
tensors it is given (params, m, v, master), which saves a copy of the whole
state in device memory, and hands back the same dicts; the step counter is a
0-d int32 tensor on the CPU, so that the bias corrections and the learning
rate are computed on the host without waiting for the card.

Memory layout:
    stored params: RunConfig.param_dtype  (the compute copy)
    master:        float32 copy iff a param is not float32 (keep_master)
    m, v:          moment_dtype (float32, or bfloat16 to halve them)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_dtype
from repro_torch.models.transformer import tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    keep_master: bool = True      # keep f32 master if params are low-precision


class OptState(NamedTuple):
    step: torch.Tensor            # 0-d int32, on the CPU
    m: Dict
    v: Dict
    master: Optional[Dict]


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict in the reference's order (keys sorted,
    as ``jax.tree.leaves`` walks a dict)."""
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in leaves(tree[key])]
    return [tree]


def like_tree(tree, flat: List):
    """`flat` (in ``leaves`` order) laid out as the nested dict `tree`."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


def init_adamw(params: Dict, cfg: AdamWConfig) -> OptState:
    """Zeroed moments beside each parameter, and a float32 master when a
    parameter is stored in lower precision (and cfg.keep_master)."""
    mdt = resolve_dtype(cfg.moment_dtype)
    with torch.no_grad():
        m = tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params)
        v = tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params)
        master = None
        if cfg.keep_master and any(p.dtype != torch.float32
                                   for p in leaves(params)):
            master = tree_map(lambda p: p.detach().float().clone(), params)
    return OptState(torch.zeros((), dtype=torch.int32), m, v, master)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, on the
    leaves' device, as the reference sums them. (Not
    ``torch.linalg.vector_norm``: in float32 on the CPU it loses 2e-4 of
    the norm over 8e6 elements and 7 % over a 102400 x 4096 embedding,
    where ``torch.sum`` stays within 1e-7.)"""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(params: Dict, grads: Dict, state: OptState,
                 cfg: AdamWConfig, lr_scale=1.0
                 ) -> Tuple[Dict, OptState, Dict]:
    """One AdamW step, IN PLACE: returns (params, new state, metrics) with
    params, m, v and master the dicts given, their tensors updated.

    As the reference: gradients scaled by min(1, clip / (|g| + 1e-9)), bias
    corrections 1 - b^t at the new step t, decay decoupled (lr * wd * p),
    the update computed in float32 from the master (when kept) and every
    new parameter cast to the dtype of the first leaf (the reference casts
    so; the port's parameters share one dtype, so this is each leaf's
    own)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0) \
        if cfg.clip_norm else 1.0
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32)
    mdt = resolve_dtype(cfg.moment_dtype)
    flat_p = leaves(params)
    source = leaves(state.master) if state.master is not None else flat_p
    pdt = flat_p[0].dtype
    for i, (p, g, m, v) in enumerate(zip(flat_p, leaves(grads),
                                         leaves(state.m), leaves(state.v))):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        p32 = source[i].float()
        new = p32 - lr * (m32 / bc1 / ((v32 / bc2).sqrt() + cfg.eps)
                          + cfg.weight_decay * p32)
        if state.master is not None:
            source[i].copy_(new)
        p.copy_(new.to(pdt))
        m.copy_(m32.to(mdt))
        v.copy_(v32.to(mdt))
    return params, OptState(step, state.m, state.v, state.master), \
        {"grad_norm": gnorm, "lr": lr}
