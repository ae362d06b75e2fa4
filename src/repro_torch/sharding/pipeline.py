"""GPipe-style pipeline parallelism over a mesh axis, as the reference's
``repro/sharding/pipeline.py``.

Layout: mesh axis 'pipe' with P stages; the layer stack (L, ...) is split
into P contiguous blocks of L/P layers, stage s holding block s (the
leading stacked axis split over 'pipe': ``stacked_params`` is this rank's
block). Microbatches stream through the classic GPipe schedule: T =
n_micro + P - 1 ticks, stage s working on microbatch t - s at tick t;
activations hop stages by ``collectives.ppermute`` (the reference's
``lax.ppermute`` over the cyclic permutation). As there, every stage runs
`fn` at every tick and the bubble ticks' results are masked, so that every
rank's graph holds the same collectives in the same order: the backward
runs each ppermute's transpose (the reverse shift) at the same tick on
every rank, which carries the gradient one stage back. The last stage's
outputs reach every stage by a masked all-reduce.

Bubble fraction = (P-1)/T as usual; choose n_micro >> P.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.sharding import collectives as C


def pipeline_apply(fn: Callable, stacked_params, x: torch.Tensor, mesh, *,
                   n_micro: int, axis: str = "pipe") -> torch.Tensor:
    """Run `x` through the whole stacked layer group, the stack split over
    the mesh's `axis`.

    fn(stage_params, x) applies this rank's (L/P, ...) block of layers. x:
    (B, S, d), replicated over `axis` (stage 0 reads it; its gradient is
    summed over the stages, each holding the whole); B must divide into
    n_micro. Returns (B, S, d), replicated over `axis`."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not divide into {n_micro} "
                         f"microbatches")
    x_micro = C.enter_split(x, mesh, axis).reshape(
        n_micro, B // n_micro, *x.shape[1:])
    n_stages = C.axis_size(mesh, axis)
    stage = C.axis_index(mesh, axis)
    ticks = n_micro + n_stages - 1
    first = float(stage == 0)
    incoming = torch.zeros_like(x_micro[0])
    outputs = []
    for t in range(ticks):
        # stage 0 ingests microbatch t (clamped; bubble ticks are masked)
        mb_in = x_micro[min(t, n_micro - 1)]
        y = fn(stacked_params, first * mb_in + (1.0 - first) * incoming)
        # the last stage emits microbatch t - (P - 1)
        if t >= n_stages - 1:
            outputs.append(y)
        if t < ticks - 1:
            incoming = C.ppermute(y, mesh, axis)
    out = torch.stack(outputs)
    # only the last stage holds real outputs: broadcast by a masked sum
    out = C.all_reduce(out * float(stage == n_stages - 1), mesh, axis)
    return out.reshape(B, *x.shape[1:])
