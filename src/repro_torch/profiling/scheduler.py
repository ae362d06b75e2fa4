"""Adaptive ladder scheduling — now a strategy of the unified pipeline.

The `AdaptiveLadderScheduler` (walk the ladder smallest-first, refit
per point, stop early on a confident+stable requirement, escalate into
the widest gaps only when the zoo's candidates disagree) survives as the
`placement="ladder"` strategy of `repro_torch.pipeline`: its decision logic
lives in `repro_torch.pipeline.placement.LadderPlacer`, the acquisition loop in
`repro_torch.pipeline.placement.drive_placement`, and this class is the
back-compat loop for callers that hold a raw `(size) -> (result,
fresh)` profile callable (with optional `.peek`) and want budget gating
handled for them. The information-optimal default strategy is
`repro_torch.pipeline.placement.InfoGainPlacer` (`placement="infogain"`).

Every point is gated by an optional `ProfilingBudget`; cached points
(served via `.peek`) are always free, and exhaustion mid-schedule returns
whatever was measured (`budget_exhausted=True`) with the fit over the
partial ladder — the caller's fallback chain handles an unconfident
result exactly as it handles a noisy one.

A copy of the JAX package's ``repro/profiling/scheduler.py``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.allocator.model_zoo import fit_zoo
from repro_torch.core.profiler import ProfileResult
from repro_torch.core.sampling import calibrate_anchor
from repro_torch.pipeline.placement import (DISAGREE_RTOL, InfoGainPlacer,
                                      LadderPlacer, MAX_EXTRA_POINTS,
                                      MIN_POINTS, STABILITY_RTOL,
                                      drive_placement, make_placer)
from repro_torch.profiling.budget import ProfilingBudget

# (size) -> (result, fresh): the caller owns caching; `fresh` says whether
# the point cost a real profile run (budget is only charged for fresh
# ones). An optional `.peek(size)` attribute on the callable returns a
# cached result without profiling — consulted before the budget gate, so
# an exhausted budget never denies points that are already known.
ProfilePointFn = Callable[[float], Tuple[ProfileResult, bool]]


@dataclass
class AdaptiveProfile:
    """Outcome of one adaptive schedule over a job signature."""
    sizes: List[float]
    mems: List[float]
    results: List[ProfileResult]
    fit: object                      # ZooFit (or custom fitter output)
    points: int                      # fresh profile runs spent
    cache_hits: int                  # points served from caches/stores
    early_stop: bool                 # stopped before the base ladder ended
    escalated: bool                  # profiled beyond the base ladder
    budget_exhausted: bool           # a point was denied by the budget
    wall_s: float
    requirement_trace: List[float] = field(default_factory=list)

    @property
    def total_points(self) -> int:
        return len(self.sizes)


class AdaptiveLadderScheduler:
    """Budget-gating loop around a `PointPlacer` (default: the
    ladder strategy; pass `placement="infogain"` or a placer instance for
    information-optimal placement)."""

    def __init__(self, fitter: Optional[Callable] = None,
                 candidates: Optional[Sequence] = None,
                 min_points: int = MIN_POINTS,
                 stability_rtol: float = STABILITY_RTOL,
                 disagree_rtol: float = DISAGREE_RTOL,
                 max_extra_points: int = MAX_EXTRA_POINTS,
                 budget: Optional[ProfilingBudget] = None,
                 placement=None):
        self.fitter = fitter
        self.candidates = candidates
        self.min_points = max(2, min_points)
        self.stability_rtol = stability_rtol
        self.disagree_rtol = disagree_rtol
        self.max_extra_points = max_extra_points
        self.budget = budget
        # a placement NAME builds its placer with THIS scheduler's knobs;
        # a placer INSTANCE is used as-is (its own knobs win)
        if placement is None or placement == "ladder":
            placement = LadderPlacer(min_points=min_points,
                                     stability_rtol=stability_rtol,
                                     disagree_rtol=disagree_rtol,
                                     max_extra_points=max_extra_points)
        elif placement == "infogain":
            placement = InfoGainPlacer(min_points=min_points,
                                       stability_rtol=stability_rtol,
                                       max_extra_points=max_extra_points)
        self.placer = make_placer(placement)

    def _fit(self, sizes: Sequence[float], mems: Sequence[float]):
        if self.fitter is not None:
            return self.fitter(sizes, mems)
        return fit_zoo(sizes, mems, self.candidates)

    def run(self, ladder: Sequence[float], full_size: float,
            profile_point: ProfilePointFn) -> AdaptiveProfile:
        t0 = time.monotonic()
        peek = getattr(profile_point, "peek", None)

        def acquire(size: float):
            """Budget-gated point: cached (peeked) points are free; only
            a genuinely fresh run keeps its reservation and charge."""
            r = peek(size) if peek is not None else None
            if r is not None:
                return r, False
            if self.budget is not None and not self.budget.try_spend():
                return None
            try:
                r, was_fresh = profile_point(size)
            except BaseException:
                if self.budget is not None:
                    self.budget.refund()    # failed run: hand the point back
                raise
            if self.budget is not None:
                if was_fresh:
                    self.budget.charge(r.wall_s)
                else:
                    self.budget.refund()    # raced a cache fill: no run
            return r, was_fresh

        out = drive_placement(self.placer, ladder, full_size, acquire,
                              self._fit)
        return AdaptiveProfile(out.sizes, out.mems, out.results, out.fit,
                               out.fresh, out.cache_hits, out.early_stop,
                               out.escalated, out.budget_exhausted,
                               time.monotonic() - t0,
                               out.requirement_trace)


def calibrated_anchor(store, signature: str,
                      run_at_size: Callable[[float], float],
                      initial: float, **calibrate_kwargs) -> float:
    """`calibrate_anchor` with persistence: a signature calibrated by any
    process (or a past run) skips the measurement loop entirely."""
    if store is not None:
        known = store.get_anchor(signature)
        if known is not None:
            return known
    anchor = calibrate_anchor(run_at_size, initial, **calibrate_kwargs)
    if store is not None:
        store.put_anchor(signature, anchor)
    return anchor
