"""Flora-style nearest-job classification (arXiv:2502.21046).

When no zoo candidate passes its confidence gate, Crispy degenerates to the
BFA baseline and the profiling work is discarded. Flora's observation: jobs
with similar resource-usage *shape* want similar allocations, so an
unusable profile can still be matched against previously seen jobs and the
neighbor's allocation transferred.

The classifier embeds a profiling ladder into a small scale-invariant
feature vector — the memory curve resampled onto a fixed grid and
normalized by its peak, plus growth, roughness, and linear-fit-R² summary
terms — and answers nearest-neighbor queries under a Euclidean distance
gate. Every job the AllocationService profiles is `observe`d here (even
gate-failing ones), so the feature store grows with traffic and nothing is
thrown away.

Memory shape alone cannot separate jobs whose memory curves agree but
whose *runtime* curves do not (a linear-memory scan vs a linear-memory
quadratic join): profiling already measures per-point wall time, so the
ladder's runtime-vs-size curve is embedded the same scale-invariant way
(`runtime_features`) and concatenated into the distance whenever both
sides observed it. Jobs observed without runtimes (e.g. warm-started from
persisted registry ladders, which keep only sizes/mems) fall back to the
memory-shape distance, so the feature store never fragments.

Flora additionally classifies on *categorical* job descriptors — input
format, operator palette — because two jobs can tie on every measured
curve yet be different programs. `observe`/`classify` accept an optional
set of string tags (e.g. ``{"format:parquet", "op:join"}``); when both
sides carry tags, their Jaccard distance joins the numeric blocks as
`TAG_WEIGHT` virtual feature components in the same RMS pooling, so the
distance gate's scale is unchanged and tags act as a tie-breaker rather
than a veto. Sides without tags participate exactly as before.

A copy of the JAX package's ``repro/allocator/classifier.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core.memory_model import fit_memory_model

FEATURE_POINTS = 8          # resampled curve resolution
RUNTIME_POINTS = 8          # resampled runtime-curve resolution
# virtual components the categorical block adds to the RMS pooling. The
# tie-breaker contract bounds it: even a fully disjoint palette (Jaccard
# distance 1) over byte-identical curves must stay under the distance
# gate, i.e. sqrt(W / (n_numeric + W)) < DEFAULT_MAX_DISTANCE for the
# smallest numeric block (memory-only, n = FEATURE_POINTS + 3 = 11),
# which needs W < ~0.73. W = 0.5 keeps tags decisive on exact ties and
# influential on near-ties without ever vetoing a curve match alone.
TAG_WEIGHT = 0.5
DEFAULT_MAX_DISTANCE = 0.25


def _resample_unit_curve(sizes: Sequence[float], values: Sequence[float],
                         points: int) -> Optional[np.ndarray]:
    """Values resampled onto a unit grid over the size span, normalized by
    their peak magnitude — the shared scale-invariant embedding."""
    x = np.asarray(sizes, dtype=np.float64)
    y = np.asarray(values, dtype=np.float64)
    keep = np.isfinite(x) & np.isfinite(y)
    x, y = x[keep], y[keep]
    if x.size < 2:
        return None
    order = np.argsort(x)
    x, y = x[order], y[order]
    span = x[-1] - x[0]
    t = (x - x[0]) / span if span > 0 else np.zeros_like(x)
    scale = float(np.abs(y).max()) or 1.0
    grid = np.linspace(0.0, 1.0, points)
    return np.interp(grid, t, y / scale)


def profile_features(sizes: Sequence[float],
                     mems: Sequence[float]) -> np.ndarray:
    """Scale-invariant embedding of a profiling ladder's memory curve."""
    curve = _resample_unit_curve(sizes, mems, FEATURE_POINTS)
    if curve is None:
        return np.zeros(FEATURE_POINTS + 3)
    growth = float(curve[-1] - curve[0])
    rough = float(np.sqrt(np.mean(np.diff(curve, 2) ** 2))) \
        if curve.size >= 3 else 0.0
    x = np.asarray(sizes, dtype=np.float64)
    y = np.asarray(mems, dtype=np.float64)
    lin = fit_memory_model(x, y)
    r2c = float(np.clip(lin.r2, 0.0, 1.0))
    return np.concatenate([curve, [growth, rough, r2c]])


def runtime_features(sizes: Sequence[float],
                     runtimes: Optional[Sequence[float]]
                     ) -> Optional[np.ndarray]:
    """Scale-invariant embedding of the ladder's runtime-vs-size curve, or
    None when fewer than two finite runtimes were measured. The convexity
    term separates linear from superlinear runtime growth even when the
    resampled curves are close."""
    if runtimes is None or len(runtimes) != len(sizes):
        return None
    curve = _resample_unit_curve(sizes, runtimes, RUNTIME_POINTS)
    if curve is None:
        return None
    growth = float(curve[-1] - curve[0])
    convexity = float(np.mean(np.diff(curve, 2))) if curve.size >= 3 else 0.0
    return np.concatenate([curve, [growth, convexity]])


def feature_distance(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)))


def tag_distance(a: FrozenSet[str], b: FrozenSet[str]) -> float:
    """Jaccard distance between two categorical tag sets (0 == identical
    palettes, 1 == disjoint)."""
    if not a and not b:
        return 0.0
    union = len(a | b)
    return 1.0 - len(a & b) / union if union else 0.0


@dataclass
class Classification:
    neighbor: str               # signature of the nearest observed job
    distance: float


class NearestJobClassifier:
    def __init__(self, max_distance: float = DEFAULT_MAX_DISTANCE):
        self.max_distance = max_distance
        self._features: Dict[str, np.ndarray] = {}
        self._runtime: Dict[str, Optional[np.ndarray]] = {}
        self._tags: Dict[str, Optional[FrozenSet[str]]] = {}

    def __len__(self) -> int:
        return len(self._features)

    def jobs(self) -> List[str]:
        return sorted(self._features)

    def has(self, signature: str) -> bool:
        return signature in self._features

    def observe(self, signature: str, sizes: Sequence[float],
                mems: Sequence[float],
                runtimes: Optional[Sequence[float]] = None,
                tags: Optional[Iterable[str]] = None) -> None:
        if len(sizes) >= 2:
            self._features[signature] = profile_features(sizes, mems)
            self._runtime[signature] = runtime_features(sizes, runtimes)
            if tags is not None:
                self._tags[signature] = frozenset(tags)
            else:
                # a tagless re-observation (service plan-cache miss, registry
                # warm-up) must not erase a previously observed palette
                self._tags.setdefault(signature, None)

    def _distance(self, query_mem: np.ndarray,
                  query_rt: Optional[np.ndarray],
                  query_tags: Optional[FrozenSet[str]], sig: str) -> float:
        """Memory-shape distance, extended over the runtime block and the
        categorical tag block when both sides observed them. Pooling is
        RMS over all (virtual) components, so the gate's scale is
        unchanged however many blocks participate."""
        blocks = [(query_mem, self._features[sig])]
        cand_rt = self._runtime.get(sig)
        if query_rt is not None and cand_rt is not None:
            blocks.append((query_rt, cand_rt))
        sq_sum = sum(float(((a - b) ** 2).sum()) for a, b in blocks)
        n = sum(a.size for a, _b in blocks)
        cand_tags = self._tags.get(sig)
        if query_tags is not None and cand_tags is not None:
            sq_sum += TAG_WEIGHT * tag_distance(query_tags, cand_tags) ** 2
            n += TAG_WEIGHT
        return float(np.sqrt(sq_sum / n))

    def classify(self, sizes: Sequence[float], mems: Sequence[float],
                 runtimes: Optional[Sequence[float]] = None,
                 exclude: Iterable[str] = (),
                 tags: Optional[Iterable[str]] = None
                 ) -> Optional[Classification]:
        """Nearest observed job under the distance gate, or None."""
        query_mem = profile_features(sizes, mems)
        query_rt = runtime_features(sizes, runtimes)
        query_tags = frozenset(tags) if tags is not None else None
        skip = set(exclude)
        best: Optional[Classification] = None
        for sig in self._features:
            if sig in skip:
                continue
            d = self._distance(query_mem, query_rt, query_tags, sig)
            if best is None or d < best.distance:
                best = Classification(sig, d)
        if best is None or best.distance > self.max_distance:
            return None
        return best
