"""Gradient compression with error feedback, as the reference's
``repro/optim/compression.py``: gradients go to bfloat16, and what the
cast drops is carried in a float32 residual to the next step, so the
compression is unbiased over time. (On one card nothing is sent anywhere;
the arithmetic is the reference's.)"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import tree_map
from repro_torch.optim.adamw import leaves, like_tree


@torch.no_grad()
def compress_grads_bf16(grads: Dict, residual: Optional[Dict]
                        ) -> Tuple[Dict, Dict]:
    """Returns (bfloat16 grads, residual):

    compressed = bf16(g + r);  r <- (g + r) - f32(compressed)

    The residual is updated IN PLACE when given (zeros when None)."""
    if residual is None:
        residual = init_residual(grads)

    def one(g, r):
        tot = g.float() + r
        q = tot.to(torch.bfloat16)
        r.copy_(tot - q.float())
        return q

    return like_tree(grads, [one(g, r) for g, r in
                             zip(leaves(grads), leaves(residual))]), residual


def init_residual(params: Dict) -> Dict:
    """A zeroed float32 residual beside each parameter."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
