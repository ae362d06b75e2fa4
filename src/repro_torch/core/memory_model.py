"""Crispy §III-C: memory usage modeling.

Ordinary least squares `mem = a * size + b` over the profiling samples, with
the paper's train-set R² > 0.99 linearity gate. No sklearn — the closed form
is two lines and this *is* the paper's model (LinearRegression + r2_score).

`LinearMemoryModel` is also the memory-model interface the JAX package's
allocator generalizes over: `predict(size)`, `confident`,
`requirement(full_size, leeway)` plus `to_dict`/`from_dict` for a persistent
model registry. A copy of the JAX package's ``repro/core/memory_model.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar, Dict, Optional, Sequence, Tuple

import numpy as np

R2_GATE = 0.99          # paper §III-A step 3


def ols_fit(x: np.ndarray, y: np.ndarray) -> Optional[Tuple[float, float]]:
    """Closed-form OLS `(slope, intercept)`; None for degenerate x (<2
    points or no spread) — shared by the paper's model and every zoo
    candidate that fits a line in some transformed space."""
    if x.size < 2 or np.allclose(x, x[0]):
        return None
    xm, ym = x.mean(), y.mean()
    sxx = float(((x - xm) ** 2).sum())
    slope = float(((x - xm) * (y - ym)).sum()) / sxx
    return slope, float(ym - slope * xm)


def r2_score(y: np.ndarray, pred: np.ndarray) -> float:
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    if ss_tot == 0.0:
        # flat target: a constant-memory job; the fit is exact iff residuals
        # are zero, in which case extrapolation is trivially safe. Plain
        # Python -inf (not np.float64): the gate path compares against
        # Python floats and the value must survive JSON round-trips of
        # registry records exactly.
        return 1.0 if ss_res == 0.0 else -math.inf
    return 1.0 - ss_res / ss_tot


class GatedMemoryModel:
    """Gate + clamp semantics every memory model shares: extrapolate only
    when the train fit is (near-)perfect, and clamp a negative
    extrapolation (negative intercept at small full_size) to 0 rather than
    crediting memory back. Subclasses provide `r2` and `predict`."""

    @property
    def confident(self) -> bool:
        return self.r2 > R2_GATE

    def requirement(self, full_size: float, leeway: float = 0.0) -> float:
        """Total memory requirement for the full dataset (0 if the model is
        not confident — Crispy then degenerates to the BFA baseline)."""
        if not self.confident:
            return 0.0
        return max(0.0, self.predict(full_size)) * (1.0 + leeway)


@dataclass
class LinearMemoryModel(GatedMemoryModel):
    slope: float
    intercept: float
    r2: float
    n: int

    kind: ClassVar[str] = "linear"

    def predict(self, size: float) -> float:
        return self.slope * size + self.intercept

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "slope": self.slope,
                "intercept": self.intercept, "r2": self.r2, "n": self.n}

    @classmethod
    def from_dict(cls, d: Dict) -> "LinearMemoryModel":
        return cls(float(d["slope"]), float(d["intercept"]),
                   float(d["r2"]), int(d["n"]))


def fit_memory_model(sizes: Sequence[float],
                     mems: Sequence[float]) -> LinearMemoryModel:
    x = np.asarray(sizes, dtype=np.float64)
    y = np.asarray(mems, dtype=np.float64)
    coef = ols_fit(x, y)
    if coef is None:
        return LinearMemoryModel(0.0, float(y.mean()) if y.size else 0.0,
                                 -math.inf, int(x.size))
    slope, intercept = coef
    r2 = r2_score(y, slope * x + intercept)
    return LinearMemoryModel(slope, intercept, r2, int(x.size))
