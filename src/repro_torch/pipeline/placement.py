"""Point placement: which sample size to profile next, and when to stop.

The paper profiles a fixed five-point ladder. The ladder placer makes
the *count* adaptive (walk the ladder smallest-first, stop once the fit is
confident and stable, escalate into the widest gaps when candidates
disagree) but keeps the *positions* ladder-bound. This module makes placement itself a
strategy behind one protocol:

  LadderPlacer    the ladder semantics: smallest-first prefix of the base
                  ladder, early stop on confident+stable, gap-midpoint
                  escalation entered only when the zoo's candidates
                  disagree about the full-size prediction (and run to
                  confidence or the cap once entered). Midpoints are
                  recomputed from the measured sizes per step — identical
                  to a precomputed midpoint list on equally spaced ladders.

  InfoGainPlacer  information-optimal placement (the default). After two
                  cheap seed points, every unmeasured candidate size is
                  scored by the *expected reduction in candidate-model
                  disagreement at full_size*: each fitted zoo candidate is
                  taken in turn as the truth hypothesis, the candidate
                  pool is refit as if the point had been measured under
                  that hypothesis, and the spread of the refit full-size
                  predictions is averaged over hypotheses. The argmax
                  size is profiled next; placement stops when the best
                  expected gain falls below the stability threshold (more
                  measurement would not change the answer), or the fit is
                  confident and stable, as with the ladder. Single-model
                  (non-zoo) fitters have nothing to rank, so they get
                  full ladder semantics — same points, same cost.

Why it wins on curved jobs: a smallest-first prefix clusters measurements
at the cheap end of the ladder, exactly where a power-law or piecewise
curve is least distinguishable from a line, so the prefix must run long
(or escalate) before the models separate. Disagreement-driven placement
jumps straight to the sizes where the hypotheses diverge — usually the
far end of the calibrated range — and separates the candidates in fewer
points (benchmarks/point_placement.py measures this; Ruya,
arXiv:2211.04240, motivates memory-aware iterative search over fixed
ladders).

Both placers only ever propose sizes inside [min(ladder), max(ladder)]:
the anchor was calibrated so the largest ladder point stays in the
paper's per-run wall-time band, and placement must not silently leave it.

The driving loop lives in `repro_torch.pipeline.pipeline.AllocationPipeline`
(the acquisition stage); placers are pure decision objects and never
profile anything themselves.

A copy of the JAX package's ``repro/pipeline/placement.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Protocol, Sequence

from repro_torch.allocator.model_zoo import ZooFit
from repro_torch.core.memory_model import LinearMemoryModel, fit_memory_model

MIN_POINTS = 3              # LOOCV needs 3; stability needs a predecessor
STABILITY_RTOL = 0.05       # requirement prediction settled within 5%
DISAGREE_RTOL = 0.25        # candidate spread that justifies extra points
MAX_EXTRA_POINTS = 2        # extra spend beyond the base ladder, either placer

PLACEMENTS = ("infogain", "ladder")


@dataclass
class PlacementState:
    """What a placer may look at when proposing the next size: the base
    ladder, everything measured so far, and the latest (re)fit."""
    ladder: List[float]              # base ladder, ascending
    full_size: float
    sizes: List[float] = field(default_factory=list)
    mems: List[float] = field(default_factory=list)
    walls: List[float] = field(default_factory=list)   # per-point wall s
    fit: Optional[object] = None     # ZooFit (or custom fitter output)
    stable: bool = False             # last two requirement predictions agree

    @property
    def measured(self) -> set:
        return set(self.sizes)

    @property
    def beyond_base(self) -> int:
        """Points spent past the base-ladder length (escalation depth)."""
        return max(0, len(self.sizes) - len(self.ladder))


class PointPlacer(Protocol):
    """Strategy protocol: propose the next sample size, or None to stop.
    Implementations must be stateless across runs (one placer instance
    serves many signatures); all run state arrives via PlacementState."""

    name: str

    def next_size(self, state: PlacementState) -> Optional[float]: ...


def _confident(fit: object) -> bool:
    return bool(getattr(fit, "confident", False))


def prediction_spread(fits: dict, full_size: float) -> float:
    """Relative spread of a candidate set's full-size predictions
    (non-finite predictions dropped; < 2 finite answers spread 0)."""
    preds = []
    for m in fits.values():
        try:
            p = float(m.predict(full_size))
        except (OverflowError, ValueError):
            p = math.inf
        if math.isfinite(p):
            preds.append(p)
    if len(preds) < 2:
        return 0.0
    lo, hi = min(preds), max(preds)
    scale = max(abs(hi), abs(lo), 1e-12)
    return (hi - lo) / scale


def candidate_disagreement(fit: object, full_size: float) -> float:
    """Relative spread of the zoo candidates' full-size predictions — the
    quantity both placers treat as 'how unsettled is the answer'. A
    non-zoo (single-model) fit disagrees with itself only through
    non-confidence."""
    if not isinstance(fit, ZooFit):
        return math.inf if not _confident(fit) else 0.0
    return prediction_spread(fit.fits or {}, full_size)


def gap_midpoints(sizes: Sequence[float], n: int) -> List[float]:
    """Midpoints of the `n` widest gaps between measured sizes —
    densification candidates inside the calibrated range."""
    xs = sorted(set(sizes))
    if len(xs) < 2 or n <= 0:
        return []
    gaps = sorted(((xs[i + 1] - xs[i], 0.5 * (xs[i] + xs[i + 1]))
                   for i in range(len(xs) - 1)), reverse=True)
    return [mid for _gap, mid in gaps[:n]]


class LadderPlacer:
    """The ladder semantics as a placement strategy: the smallest-first ladder
    prefix with early stop, then gap-midpoint escalation entered only
    when the candidates disagree."""

    name = "ladder"

    def __init__(self, min_points: int = MIN_POINTS,
                 stability_rtol: float = STABILITY_RTOL,
                 disagree_rtol: float = DISAGREE_RTOL,
                 max_extra_points: int = MAX_EXTRA_POINTS):
        self.min_points = max(2, min_points)
        self.stability_rtol = stability_rtol
        self.disagree_rtol = disagree_rtol
        self.max_extra_points = max_extra_points

    def next_size(self, state: PlacementState) -> Optional[float]:
        measured = state.measured
        remaining = [s for s in state.ladder if s not in measured]
        if remaining:
            # early stop mid-ladder once the fit is confident AND stable
            if (state.fit is not None and len(state.sizes) >= self.min_points
                    and _confident(state.fit) and state.stable):
                return None
            return remaining[0]          # ladder is ascending: smallest first
        # base ladder done: candidate disagreement gates STARTING to
        # escalate; once escalating, extra points run to confidence or the
        # cap (the ladder semantics — the first midpoint shrinking the spread
        # under the threshold must not strand a still-unconfident fit)
        if (state.fit is None or _confident(state.fit)
                or state.beyond_base >= self.max_extra_points
                or (state.beyond_base == 0
                    and candidate_disagreement(state.fit, state.full_size)
                    <= self.disagree_rtol)):
            return None
        mids = [m for m in gap_midpoints(state.sizes, self.max_extra_points)
                if m not in measured]
        return mids[0] if mids else None


class InfoGainPlacer:
    """Information-optimal placement: profile the size whose measurement
    is expected to shrink candidate-model disagreement at full_size the
    most; stop when the best expected shrink falls below the stability
    threshold (the answer would not change) or the fit is confident and
    stable."""

    name = "infogain"

    def __init__(self, min_points: int = MIN_POINTS,
                 stability_rtol: float = STABILITY_RTOL,
                 max_extra_points: int = MAX_EXTRA_POINTS,
                 grid_points: int = 3,
                 cost_aware: bool = True):
        self.min_points = max(2, min_points)
        self.stability_rtol = stability_rtol
        self.max_extra_points = max_extra_points
        self.grid_points = grid_points
        # cost_aware: among the informative sizes, buy bits-per-second —
        # rank by expected gain per predicted wall-second instead of raw
        # gain, so a ten-minute ProfilingBudget stretches further. The
        # stop rule stays on RAW gain (a cheap uninformative point must
        # not keep the loop alive), and with constant per-point walls the
        # weighted argmax equals the raw one.
        self.cost_aware = cost_aware
        # single-model (non-zoo) fitters have no candidate set to
        # disagree: fall back to FULL ladder semantics — prefix AND
        # midpoint escalation — not just the prefix
        self._ladder_fallback = LadderPlacer(
            min_points=min_points, stability_rtol=stability_rtol,
            max_extra_points=max_extra_points)

    # -- candidate pool -----------------------------------------------------
    def _pool(self, state: PlacementState) -> List[float]:
        """Unmeasured ladder sizes plus widest-gap midpoints: the same
        sizes either strategy could reach, ranked here by information
        instead of position."""
        measured = state.measured
        pool = [s for s in state.ladder if s not in measured]
        pool += [m for m in gap_midpoints(state.sizes, self.grid_points)
                 if m not in measured and m not in pool]
        return pool

    # -- expected disagreement ----------------------------------------------
    @staticmethod
    def _refit_candidates(fits: dict, sizes: Sequence[float],
                          mems: Sequence[float]) -> dict:
        """Scores-free refit of the currently fitted candidate kinds on
        augmented data. LOOCV selection is irrelevant for a hypothesis
        refit — only the candidates' full-size predictions feed the
        spread — so paying fit_zoo's n-fold held-out scoring here would
        be an O(n x candidates) pure waste per scored pool size."""
        out = {}
        for kind, m in fits.items():
            fit = getattr(type(m), "fit", None)
            if callable(fit):
                refit = fit(sizes, mems)
            elif kind == LinearMemoryModel.kind:
                refit = fit_memory_model(sizes, mems)
            else:
                continue
            if refit is not None:
                out[kind] = refit
        return out

    def _expected_disagreement(self, state: PlacementState, fit: ZooFit,
                               size: float) -> float:
        """Average over truth hypotheses h (the currently fitted
        candidates) of the candidate spread at full_size after refitting
        everyone as if mem(size) == h.predict(size)."""
        hyps = fit.fits or {}
        if not hyps:
            return 0.0
        spreads = []
        for h in hyps.values():
            try:
                y = float(h.predict(size))
            except (OverflowError, ValueError):
                continue
            if not math.isfinite(y) or y < 0:
                continue
            refit = self._refit_candidates(hyps, state.sizes + [size],
                                           state.mems + [y])
            spreads.append(prediction_spread(refit, state.full_size))
        if not spreads:
            return math.inf
        return sum(spreads) / len(spreads)

    # -- protocol -----------------------------------------------------------
    def next_size(self, state: PlacementState) -> Optional[float]:
        measured = state.measured
        ladder = state.ladder
        # seeds: the two cheapest points (no fit exists yet, so nothing
        # can be ranked by information — and a single-model fitter, which
        # never will rank, must keep the ladder's cheap-prefix cost profile).
        # With zoo candidates, the first gain-scored choice then jumps to
        # whichever size separates them best, usually the far end.
        if len(state.sizes) < 2:
            remaining = [s for s in ladder if s not in measured]
            return remaining[0] if remaining else None
        if (state.fit is not None and len(state.sizes) >= self.min_points
                and _confident(state.fit) and state.stable):
            return None
        if state.beyond_base >= self.max_extra_points:
            return None
        if not isinstance(state.fit, ZooFit):
            # custom single-model fitter: delegate to ladder semantics
            # (prefix + escalation), preserving the ladder's behavior exactly
            return self._ladder_fallback.next_size(state)
        pool = self._pool(state)
        if not pool:
            return None
        current = candidate_disagreement(state.fit, state.full_size)
        scored = [(current - self._expected_disagreement(state, state.fit,
                                                         s), s)
                  for s in pool]
        best_gain, best_size = max(scored)
        # the answer is as settled as it is going to get: every remaining
        # measurement is expected to move the candidate spread by less
        # than the stability threshold
        if (len(state.sizes) >= self.min_points
                and best_gain < self.stability_rtol):
            return None
        if self.cost_aware:
            return self._cheapest_informative(state, scored, best_size)
        return best_size

    # -- cost-aware ranking -------------------------------------------------
    def _predicted_wall(self, state: PlacementState,
                        size: float) -> Optional[float]:
        """OLS wall-time estimate for profiling `size`, from the walls of
        the points measured so far; None when walls are unavailable."""
        walls = state.walls
        if len(walls) != len(state.sizes) or len(walls) < 2:
            return None
        m = fit_memory_model(state.sizes, walls)
        w = m.predict(size)
        if not math.isfinite(w) or w <= 0.0:
            w = sum(walls) / len(walls)
        return max(w, 1e-9)

    def _cheapest_informative(self, state: PlacementState, scored,
                              best_size: float) -> float:
        """Among sizes whose expected gain clears the stability threshold
        (each one individually worth measuring), pick the best expected
        gain per predicted wall-second. Falls back to the raw argmax when
        no size clears the bar alone (min_points not yet reached) or no
        wall model exists."""
        informative = [(g, s) for g, s in scored
                       if g >= self.stability_rtol]
        if not informative:
            return best_size
        weighted = []
        for g, s in informative:
            w = self._predicted_wall(state, s)
            if w is None:
                return best_size
            weighted.append((g / w, s))
        return max(weighted)[1]


@dataclass
class PlacementOutcome:
    """What one placement-driven acquisition produced."""
    sizes: List[float]
    mems: List[float]
    results: List[object]            # ProfileResults, aligned with sizes
    fit: object
    fresh: int                       # profile runs actually executed
    cache_hits: int                  # points served from caches/stores
    early_stop: bool                 # confident+stable before the base end
    escalated: bool                  # measured a size outside the base ladder
    budget_exhausted: bool           # a point was denied by the budget
    requirement_trace: List[float]


def drive_placement(placer: PointPlacer, ladder: Sequence[float],
                    full_size: float, acquire, fit_fn) -> PlacementOutcome:
    """The one adaptive-acquisition loop every caller drives: ask the
    placer for the next size, acquire it (None == budget denial), refit,
    update stability, repeat until the placer stops or the budget does.

    `acquire(size) -> Optional[(ProfileResult, fresh)]` owns caching and
    budget accounting (see repro_torch.pipeline.acquisition.PointSource);
    `fit_fn(sizes, mems)` is the model-fitting stage."""
    base = sorted(float(s) for s in ladder)
    state = PlacementState(ladder=base, full_size=float(full_size))
    results: List[object] = []
    trace: List[float] = []
    rtol = getattr(placer, "stability_rtol", STABILITY_RTOL)
    fresh = hits = 0
    prev_pred: Optional[float] = None
    exhausted = False
    while True:
        nxt = placer.next_size(state)
        if nxt is None:
            break
        got = acquire(nxt)
        if got is None:
            exhausted = True
            break
        r, was_fresh = got
        fresh += int(was_fresh)
        hits += int(not was_fresh)
        state.sizes.append(float(nxt))
        state.mems.append(r.job_mem_bytes)
        state.walls.append(float(getattr(r, "wall_s", 0.0)))
        results.append(r)
        if len(state.sizes) >= 2:
            fit = fit_fn(state.sizes, state.mems)
            pred = float(fit.predict(full_size))
            trace.append(pred)
            state.stable = (prev_pred is not None
                            and math.isfinite(pred) and pred != 0.0
                            and abs(pred - prev_pred) <= rtol * abs(pred))
            prev_pred = pred
            state.fit = fit
    if state.fit is None:            # budget denied even a second point
        state.fit = fit_fn(state.sizes, state.mems)
    base_set = set(base)
    early = (not exhausted and len(state.sizes) < len(base)
             and _confident(state.fit) and state.stable)
    escalated = any(s not in base_set for s in state.sizes)
    return PlacementOutcome(state.sizes, state.mems, results, state.fit,
                            fresh, hits, early, escalated, exhausted, trace)


def make_placer(placement) -> PointPlacer:
    """Resolve a placement spec: a PointPlacer instance passes through,
    a name ("infogain" | "ladder") builds the default instance."""
    if placement is None:
        return InfoGainPlacer()
    if isinstance(placement, str):
        if placement == "infogain":
            return InfoGainPlacer()
        if placement == "ladder":
            return LadderPlacer()
        raise ValueError(f"unknown placement {placement!r}; "
                         f"expected one of {PLACEMENTS}")
    if not hasattr(placement, "next_size"):
        raise TypeError("placement must be a name or a PointPlacer "
                        "(object with next_size(state))")
    return placement
