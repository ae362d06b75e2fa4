"""Crispy §III-A step 1 / §III-B: the 5-point sample-size ladder.

The paper: start from ~1% of the dataset, adjust so one profiling run takes
0.5–3 minutes, then take five equally spaced sizes up to that anchor. For
the CUDA-memory backend the 'run' is one step on the card, and the knob is a
job-size parameter (layer count) instead of input bytes; the ladder logic
is identical. A copy of the JAX package's ``repro/core/sampling.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

N_SAMPLES = 5                    # paper: five differently sized samples


@dataclass
class Ladder:
    sizes: List[float]
    anchor: float


def ladder_from_anchor(anchor: float, n: int = N_SAMPLES,
                       lo_frac: float = 0.2) -> Ladder:
    """Equally spaced sizes in [lo_frac*anchor, anchor] (paper: 'equally
    spaced and reasonably far apart')."""
    lo = anchor * lo_frac
    step = (anchor - lo) / (n - 1)
    return Ladder([lo + i * step for i in range(n)], anchor)


def calibrate_anchor(run_at_size: Callable[[float], float],
                     initial: float,
                     target_lo_s: float = 0.5,
                     target_hi_s: float = 30.0,
                     max_iters: int = 6) -> float:
    """Adjust the anchor size until a run's wall time lands in the target
    band (paper: cancel & restart with a smaller portion if too slow). The
    default band is scaled down from the paper's 30–180 s to keep the bench
    suite fast; the paper's band is a parameter."""
    size = initial
    for _ in range(max_iters):
        wall = run_at_size(size)
        if wall > target_hi_s:
            size *= max(0.25, (target_hi_s * 0.6) / wall)
        elif wall < target_lo_s:
            size *= min(4.0, (target_lo_s * 2.0) / max(wall, 1e-6))
        else:
            return size
    return size


def integer_ladder(anchor: int, n: int = N_SAMPLES, lo: int = 1) -> List[int]:
    """Ladder over an integer knob (layers, microbatch rows, ...)."""
    lo = max(lo, 1)
    if anchor <= lo:
        return [max(1, anchor)]
    step = (anchor - lo) / (n - 1)
    sizes = sorted({int(round(lo + i * step)) for i in range(n)})
    return sizes
