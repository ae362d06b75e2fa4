"""Candidate-model zoo: richer memory models than the paper's single OLS.

Crispy (arXiv:2206.13852) fits exactly one model — linear with an R² > 0.99
train gate — and throws the profiling work away when the gate fails. Ruya
(arXiv:2211.04240) shows memory-aware modeling benefits from richer model
candidates. The zoo keeps the paper's linear fit as the *first, default*
candidate (so perfectly linear jobs reproduce seed behavior bit-for-bit)
and adds:

  loglinear  mem = a·ln(size) + b      (sub-linear growth, e.g. dedup-heavy)
  powerlaw   mem = c·size^p            (JVM object blow-up, super-linear)
  piecewise  two OLS segments          (phase changes: build side then probe)

Selection is leave-one-out cross-validation: every candidate is refit n
times with one sample held out and scored by normalized held-out RMSE. The
simplest candidate within 10% of the best score wins (linear first), so the
zoo never trades the paper's model away for an overfit one on linear data.

A `ZooFit` implements the same interface as `LinearMemoryModel` (`predict`
/ `confident` / `requirement`) and is therefore a drop-in for
`CrispyAllocator(fitter=zoo_fitter())` and `CrispyReport.model`. Its
confidence adds an out-of-sample gate on top of the paper's train-R² gate:
the winning candidate's LOOCV error must stay under `LOOCV_GATE` — the
natural generalization of "extrapolate only when the fit is near-perfect"
to model families with more free parameters.

A copy of the JAX package's ``repro/allocator/model_zoo.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.memory_model import (GatedMemoryModel, LinearMemoryModel,
                                     fit_memory_model, ols_fit, r2_score)

LOOCV_GATE = 0.05      # max normalized held-out RMSE to trust extrapolation


@dataclass
class LogLinearModel(GatedMemoryModel):
    a: float
    b: float
    r2: float
    n: int

    kind: ClassVar[str] = "loglinear"

    def predict(self, size: float) -> float:
        return self.a * math.log(max(size, 1e-300)) + self.b

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "a": self.a, "b": self.b,
                "r2": self.r2, "n": self.n}

    @classmethod
    def from_dict(cls, d: Dict) -> "LogLinearModel":
        return cls(float(d["a"]), float(d["b"]), float(d["r2"]),
                   int(d["n"]))

    @classmethod
    def fit(cls, sizes: Sequence[float],
            mems: Sequence[float]) -> Optional["LogLinearModel"]:
        x = np.asarray(sizes, dtype=np.float64)
        y = np.asarray(mems, dtype=np.float64)
        if x.size < 2 or (x <= 0).any():
            return None
        coef = ols_fit(np.log(x), y)
        if coef is None:
            return None
        a, b = coef
        pred = a * np.log(x) + b
        return cls(a, b, r2_score(y, pred), int(x.size))


@dataclass
class PowerLawModel(GatedMemoryModel):
    c: float
    p: float
    r2: float
    n: int

    kind: ClassVar[str] = "powerlaw"

    def predict(self, size: float) -> float:
        s = max(size, 0.0)
        if s == 0.0 and self.p < 0:
            # limit of c*s^p as s->0+ with a decreasing fit: unbounded.
            # inf flows through requirement() into the selector's
            # nothing-fits fallback instead of raising ZeroDivisionError.
            return math.inf
        return self.c * s ** self.p

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "c": self.c, "p": self.p,
                "r2": self.r2, "n": self.n}

    @classmethod
    def from_dict(cls, d: Dict) -> "PowerLawModel":
        return cls(float(d["c"]), float(d["p"]), float(d["r2"]),
                   int(d["n"]))

    @classmethod
    def fit(cls, sizes: Sequence[float],
            mems: Sequence[float]) -> Optional["PowerLawModel"]:
        x = np.asarray(sizes, dtype=np.float64)
        y = np.asarray(mems, dtype=np.float64)
        if x.size < 2 or (x <= 0).any() or (y <= 0).any():
            return None
        coef = ols_fit(np.log(x), np.log(y))
        if coef is None:
            return None
        p, lnc = coef
        c = math.exp(lnc)
        # score in the ORIGINAL space — log-space R² flatters large errors
        # at the top of the ladder, exactly where extrapolation leans
        pred = c * x ** p
        return cls(c, p, r2_score(y, pred), int(x.size))


@dataclass
class PiecewiseLinearModel(GatedMemoryModel):
    break_size: float
    left_slope: float
    left_intercept: float
    right_slope: float
    right_intercept: float
    r2: float
    n: int

    kind: ClassVar[str] = "piecewise"

    def predict(self, size: float) -> float:
        if size <= self.break_size:
            return self.left_slope * size + self.left_intercept
        # extrapolation always rides the right (large-size) segment
        return self.right_slope * size + self.right_intercept

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "break_size": self.break_size,
                "left_slope": self.left_slope,
                "left_intercept": self.left_intercept,
                "right_slope": self.right_slope,
                "right_intercept": self.right_intercept,
                "r2": self.r2, "n": self.n}

    @classmethod
    def from_dict(cls, d: Dict) -> "PiecewiseLinearModel":
        return cls(float(d["break_size"]), float(d["left_slope"]),
                   float(d["left_intercept"]), float(d["right_slope"]),
                   float(d["right_intercept"]), float(d["r2"]),
                   int(d["n"]))

    @classmethod
    def fit(cls, sizes: Sequence[float],
            mems: Sequence[float]) -> Optional["PiecewiseLinearModel"]:
        x = np.asarray(sizes, dtype=np.float64)
        y = np.asarray(mems, dtype=np.float64)
        if x.size < 4:
            return None
        order = np.argsort(x)
        x, y = x[order], y[order]
        best = None
        for k in range(2, x.size - 1):          # >= 2 points per segment
            lo = ols_fit(x[:k], y[:k])
            hi = ols_fit(x[k:], y[k:])
            if lo is None or hi is None:
                continue
            brk = 0.5 * (x[k - 1] + x[k])
            pred = np.where(x <= brk,
                            lo[0] * x + lo[1], hi[0] * x + hi[1])
            r2 = r2_score(y, pred)
            if best is None or r2 > best[0]:
                best = (r2, brk, lo, hi)
        if best is None:
            return None
        r2, brk, lo, hi = best
        return cls(brk, lo[0], lo[1], hi[0], hi[1], r2, int(x.size))


class _LinearCandidate:
    """The paper's model, adapted to the candidate protocol."""
    kind = LinearMemoryModel.kind
    fit = staticmethod(fit_memory_model)


DEFAULT_CANDIDATES: Tuple = (_LinearCandidate, LogLinearModel,
                             PowerLawModel, PiecewiseLinearModel)


# --------------------------------------------------------------------------
# Runtime curves (arXiv:2306.03672): the same candidate families fit the
# per-point wall times the profiling ladder already measures. Runtime feeds
# a *ranking* (cost = price × predicted runtime), not a provisioning
# decision, so its train gate is looser than the paper's memory gate — a
# mis-ranked config wastes dollars, a mis-provisioned one OOMs.
# --------------------------------------------------------------------------

RUNTIME_R2_GATE = 0.95
RUNTIME_LOOCV_GATE = 0.10


class _RuntimeGate:
    """Mixin (MRO-first) relaxing the train gate for runtime candidates."""

    @property
    def confident(self) -> bool:
        return self.r2 > RUNTIME_R2_GATE


@dataclass
class RuntimeLinearModel(_RuntimeGate, LinearMemoryModel):
    kind: ClassVar[str] = "runtime_linear"

    @classmethod
    def fit(cls, sizes: Sequence[float],
            mems: Sequence[float]) -> "RuntimeLinearModel":
        m = fit_memory_model(sizes, mems)
        return cls(m.slope, m.intercept, m.r2, m.n)


@dataclass
class RuntimeLogLinearModel(_RuntimeGate, LogLinearModel):
    kind: ClassVar[str] = "runtime_loglinear"


@dataclass
class RuntimePowerLawModel(_RuntimeGate, PowerLawModel):
    kind: ClassVar[str] = "runtime_powerlaw"


@dataclass
class RuntimePiecewiseLinearModel(_RuntimeGate, PiecewiseLinearModel):
    kind: ClassVar[str] = "runtime_piecewise"


RUNTIME_CANDIDATES: Tuple = (RuntimeLinearModel, RuntimeLogLinearModel,
                             RuntimePowerLawModel,
                             RuntimePiecewiseLinearModel)

# kind -> class, for registry deserialization
MODEL_KINDS = {LinearMemoryModel.kind: LinearMemoryModel,
               LogLinearModel.kind: LogLinearModel,
               PowerLawModel.kind: PowerLawModel,
               PiecewiseLinearModel.kind: PiecewiseLinearModel,
               RuntimeLinearModel.kind: RuntimeLinearModel,
               RuntimeLogLinearModel.kind: RuntimeLogLinearModel,
               RuntimePowerLawModel.kind: RuntimePowerLawModel,
               RuntimePiecewiseLinearModel.kind: RuntimePiecewiseLinearModel}


def model_to_dict(model) -> Dict:
    return model.to_dict()


def model_from_dict(d: Dict):
    kind = d.get("kind")
    if kind not in MODEL_KINDS:
        raise ValueError(f"unknown memory-model kind {kind!r}")
    return MODEL_KINDS[kind].from_dict(d)


@dataclass
class ZooFit(GatedMemoryModel):
    """Best-candidate fit; drop-in for the LinearMemoryModel interface.
    Inherits the shared requirement clamp; `confident` tightens the train
    gate with the out-of-sample one."""
    model: object                    # the winning fitted candidate
    candidate: str                   # its kind
    scores: Dict[str, float]         # kind -> normalized LOOCV RMSE
    train_r2: Dict[str, float]       # kind -> train R²
    n: int
    loocv_gate: float = LOOCV_GATE
    fits: Optional[Dict[str, object]] = None   # kind -> fitted candidate
                                     # (all of them — the adaptive
                                     # scheduler's disagreement check
                                     # reads their full-size predictions
                                     # without refitting)

    @property
    def loocv_score(self) -> float:
        return self.scores.get(self.candidate, math.inf)

    @property
    def confident(self) -> bool:
        """Train gate (paper) AND out-of-sample gate (zoo)."""
        return (bool(getattr(self.model, "confident", False))
                and self.loocv_score <= self.loocv_gate)

    @property
    def r2(self) -> float:
        return getattr(self.model, "r2", -math.inf)

    def predict(self, size: float) -> float:
        return self.model.predict(size)


@dataclass
class RuntimeFit(ZooFit):
    """Zoo fit over (size, wall-time) points; same selection machinery,
    runtime-calibrated out-of-sample gate."""
    loocv_gate: float = RUNTIME_LOOCV_GATE


def _fit_candidate_zoo(sizes: Sequence[float], values: Sequence[float],
                       cands: Tuple, loocv_gate: float,
                       fallback_fit, fallback_kind: str, result_cls):
    """Shared fit/LOOCV/select core of `fit_zoo` and `fit_runtime_zoo`.

    Non-finite samples (a crashed or mis-parsed profiling run reporting
    NaN/inf) are dropped at this boundary: a single NaN otherwise poisons
    `scale` and every LOOCV score, making all `<=` comparisons False and
    the final selection unreachable.
    """
    x = np.asarray(sizes, dtype=np.float64)
    y = np.asarray(values, dtype=np.float64)
    keep = np.isfinite(x) & np.isfinite(y)
    if not bool(keep.all()):
        x, y = x[keep], y[keep]
    n = int(x.size)
    scale = float(np.abs(y).mean()) or 1.0 if n else 1.0
    fits: Dict[str, object] = {}
    scores: Dict[str, float] = {}
    train_r2: Dict[str, float] = {}
    order: List[str] = []
    for cand in cands:
        m = cand.fit(x, y)
        if m is None:
            continue
        fits[cand.kind] = m
        train_r2[cand.kind] = getattr(m, "r2", -math.inf)
        order.append(cand.kind)
        errs: Optional[List[float]] = []
        if n >= 3:
            for i in range(n):
                sub = cand.fit(np.delete(x, i), np.delete(y, i))
                if sub is None:
                    errs = None
                    break
                errs.append(sub.predict(float(x[i])) - float(y[i]))
        else:
            errs = None
        if errs:
            scores[cand.kind] = float(
                np.sqrt(np.mean(np.square(errs)))) / scale
        else:
            scores[cand.kind] = math.inf

    if not fits:     # degenerate input (n < 2): unconfident linear fallback
        return result_cls(fallback_fit(x, y), fallback_kind,
                          scores, train_r2, n, loocv_gate, fits)

    eligible = [k for k in order if getattr(fits[k], "confident", False)]
    pool = eligible or order
    best_score = min(scores[k] for k in pool)
    # absolute floor of 10% of the LOOCV gate: differences far below the
    # confidence threshold are measurement noise, and the simpler (earlier)
    # candidate — the paper's linear — should win them
    tol = best_score * 0.10 + 0.1 * loocv_gate
    # the defensive default can only trigger if a candidate's score is NaN
    # despite the finite-input filter (e.g. a pathological custom candidate)
    chosen = next((k for k in order
                   if k in pool and scores[k] <= best_score + tol), pool[0])
    return result_cls(fits[chosen], chosen, scores, train_r2, n, loocv_gate,
                      fits)


def fit_zoo(sizes: Sequence[float], mems: Sequence[float],
            candidates: Optional[Sequence] = None,
            loocv_gate: float = LOOCV_GATE) -> ZooFit:
    """Fit every candidate, score by leave-one-out CV, pick the simplest
    candidate within 10% of the best score (candidate order = simplicity
    order, linear first)."""
    cands = tuple(candidates) if candidates is not None else \
        DEFAULT_CANDIDATES
    return _fit_candidate_zoo(sizes, mems, cands, loocv_gate,
                              fit_memory_model, LinearMemoryModel.kind,
                              ZooFit)


def fit_runtime_zoo(sizes: Sequence[float], walls: Sequence[float],
                    candidates: Optional[Sequence] = None,
                    loocv_gate: float = RUNTIME_LOOCV_GATE) -> RuntimeFit:
    """Zoo fit over the ladder's per-point wall times. Same families, same
    LOOCV selection; the result ranks configs by predicted runtime (and so
    by cost) — it never gates a memory requirement."""
    cands = tuple(candidates) if candidates is not None else \
        RUNTIME_CANDIDATES
    return _fit_candidate_zoo(sizes, walls, cands, loocv_gate,
                              RuntimeLinearModel.fit,
                              RuntimeLinearModel.kind, RuntimeFit)


def zoo_fitter(candidates: Optional[Sequence] = None,
               loocv_gate: float = LOOCV_GATE):
    """A `(sizes, mems) -> model` callable for `CrispyAllocator(fitter=...)`."""
    def fitter(sizes, mems):
        return fit_zoo(sizes, mems, candidates, loocv_gate)
    return fitter
