"""ProfilingBudget: the paper's ten-minute envelope as an enforced resource.

Crispy's pitch is that profiling costs "less than ten minutes per job on a
consumer-grade laptop" (§IV-B, Table II). The follow-up allocation study
(arXiv:2306.03672) argues profiling itself must be treated as a budgeted
resource: every profile point spent on one job is wall time unavailable to
another. `ProfilingBudget` makes that envelope explicit and shared — the
adaptive scheduler, the profiling executor and the AllocationService all
check the same budget before spending a point.

Three independent limits, any of which exhausts the budget:

  wall_s      real elapsed time since the budget started;
  charge_s    *accounted* profiling seconds — the sum of ProfileResult
              wall_s values charged via `charge()`. This is the limit the
              simulator-driven tests and benchmarks exercise: simulated
              profile runs report minutes of "wall time" while taking
              microseconds, so charging the reported time reproduces the
              paper's envelope deterministically;
  max_points  total profile runs across all jobs sharing the budget.

Two sharing scopes:

  local (default)      thread-safe within one process: many executor
                       workers / schedulers spend from one budget.
  shared (backend=)    the counters live in a `repro_torch.state.StateBackend`
                       document and every reserve/charge/refund goes
                       through the backend's atomic lease primitive
                       (`reserve`), so N service *processes* arbitrate ONE
                       envelope instead of each owning a full copy. The
                       wall clock is anchored to a shared `started_at`
                       stamped by whichever process touches the envelope
                       first. Pass the same backend + namespace/key to
                       every process (a FileBackend directory or one
                       crispy-daemon socket).

A copy of the JAX package's ``repro/profiling/budget.py``.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, Optional

from repro_torch.telemetry import default_registry


class BudgetExhausted(RuntimeError):
    """Raised by `spend()` when the budget cannot cover another point."""


class ProfilingBudget:
    def __init__(self, wall_s: Optional[float] = None,
                 charge_s: Optional[float] = None,
                 max_points: Optional[int] = None,
                 backend=None,              # repro_torch.state StateBackend
                 namespace: str = "budget",
                 key: str = "envelope",
                 telemetry=None):           # repro_torch.telemetry MetricsRegistry
        self.wall_s = wall_s
        self.charge_s = charge_s
        self.max_points = max_points
        self.backend = backend
        self.namespace = namespace
        self.key = key
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        # shared-mode wall anchor: the doc's started_at is stamped once
        # at creation and never rewritten, so it is safe to cache —
        # saves one backend round trip per wall-limited try_spend
        self._started_at: Optional[float] = None
        self._points = 0
        self._charged = 0.0
        self._denials = 0
        # envelope accounting audit trail: reserved vs refunded must net
        # out to points actually profiled
        tel = telemetry if telemetry is not None else default_registry()
        self._c_reserved = tel.counter("budget.reserved_points")
        self._c_refunded = tel.counter("budget.refunded_points")
        self._c_charged = tel.counter("budget.charged_seconds")
        self._c_denials = tel.counter("budget.denials")
        if backend is not None:
            self._ensure_doc()

    # -- shared-mode plumbing ------------------------------------------------
    def _ensure_doc(self) -> Dict:
        """Create the shared envelope document once (first toucher stamps
        `started_at`); any raced creation keeps the winner's stamp."""
        value, _version = self.backend.load(self.namespace, self.key)
        if value is not None:
            return self._note_started(value)
        doc = {"started_at": time.time(), "points": 0.0, "charged": 0.0,
               "denials": 0.0}
        won, current, _ver = self.backend.cas(self.namespace, self.key,
                                              0, doc)
        return self._note_started(doc if won else (current or doc))

    def _note_started(self, doc: Dict) -> Dict:
        if self._started_at is None and doc.get("started_at") is not None:
            self._started_at = float(doc["started_at"])
        return doc

    def _doc(self) -> Dict:
        value, _version = self.backend.load(self.namespace, self.key)
        return (self._note_started(value) if value is not None
                else self._ensure_doc())

    @property
    def shared(self) -> bool:
        return self.backend is not None

    # -- accounting ---------------------------------------------------------
    @property
    def points_spent(self) -> int:
        if self.shared:
            return int(self._doc().get("points", 0))
        with self._lock:
            return self._points

    @property
    def charged_s(self) -> float:
        if self.shared:
            return float(self._doc().get("charged", 0.0))
        with self._lock:
            return self._charged

    @property
    def denials(self) -> int:
        if self.shared:
            return int(self._doc().get("denials", 0))
        with self._lock:
            return self._denials

    def elapsed_s(self) -> float:
        if self.shared:
            started = (self._started_at if self._started_at is not None
                       else self._doc().get("started_at"))
            if started is not None:
                return max(0.0, time.time() - float(started))
        return time.monotonic() - self._t0

    def remaining_points(self) -> float:
        if self.max_points is None:
            return math.inf
        return max(0, self.max_points - self.points_spent)

    def remaining_s(self) -> float:
        """Most restrictive of the two time limits (inf if neither set)."""
        rem = math.inf
        if self.wall_s is not None:
            rem = min(rem, self.wall_s - self.elapsed_s())
        if self.charge_s is not None:
            rem = min(rem, self.charge_s - self.charged_s)
        return rem

    def exhausted(self) -> bool:
        return self.remaining_points() <= 0 or self.remaining_s() <= 0

    # -- spending -----------------------------------------------------------
    def try_spend(self, points: int = 1) -> bool:
        """Reserve `points` profile runs; False (and a recorded denial) if
        any limit is already crossed. Never blocks. In shared mode the
        reservation is an atomic backend lease, so concurrent processes
        can never over-grant one envelope."""
        if self.shared:
            granted = self._try_spend_shared(points)
            (self._c_reserved.inc(points) if granted
             else self._c_denials.inc())
            return granted
        with self._lock:
            over_points = (self.max_points is not None
                           and self._points + points > self.max_points)
            over_wall = (self.wall_s is not None
                         and time.monotonic() - self._t0 >= self.wall_s)
            over_charge = (self.charge_s is not None
                           and self._charged >= self.charge_s)
            if over_points or over_wall or over_charge:
                self._denials += 1
                granted = False
            else:
                self._points += points
                granted = True
        (self._c_reserved.inc(points) if granted else self._c_denials.inc())
        return granted

    def _try_spend_shared(self, points: int) -> bool:
        if self.wall_s is not None:
            # the wall check only needs the shared started_at stamp,
            # which is immutable after doc creation — the cached copy
            # (stamped by __init__'s _ensure_doc) makes the happy path
            # a single reserve round trip even with a wall limit
            if self._started_at is not None:
                started = self._started_at
            else:
                doc = self._ensure_doc()
                started = float(doc.get("started_at", time.time()))
            if time.time() - started >= self.wall_s:
                # wall time is monotone — no atomicity needed for the check,
                # only for the denial counter
                self.backend.reserve(self.namespace, self.key,
                                     {"denials": 1}, {})
                return False
        limits: Dict[str, float] = {}
        if self.max_points is not None:
            limits["points"] = float(self.max_points)
        if self.charge_s is not None:
            limits["charged"] = float(self.charge_s)
        granted, _doc = self.backend.reserve(
            self.namespace, self.key, {"points": float(points)}, limits)
        if not granted:
            self.backend.reserve(self.namespace, self.key,
                                 {"denials": 1}, {})
        return granted

    def spend(self, points: int = 1) -> None:
        if not self.try_spend(points):
            raise BudgetExhausted(
                f"profiling budget exhausted after {self.points_spent} "
                f"points / {self.charged_s:.1f}s charged / "
                f"{self.elapsed_s():.1f}s elapsed")

    def refund(self, points: int = 1) -> None:
        """Hand back a reservation that turned out not to need a profile
        run (the point was served from a cache/store)."""
        if self.shared:
            # clamped decrement: a double refund must not go negative, so
            # this is a CAS loop rather than a plain negative reserve
            while True:
                value, version = self.backend.load(self.namespace, self.key)
                doc = dict(value or {})
                doc["points"] = max(0.0,
                                    float(doc.get("points", 0)) - points)
                won, _cur, _ver = self.backend.cas(self.namespace, self.key,
                                                   version, doc)
                if won:
                    self._c_refunded.inc(points)
                    return
        with self._lock:
            self._points = max(0, self._points - points)
        self._c_refunded.inc(points)

    def charge(self, seconds: float) -> None:
        """Account a completed profile run's (reported) wall time."""
        self._c_charged.inc(max(0.0, float(seconds)))
        if self.shared:
            self.backend.reserve(self.namespace, self.key,
                                 {"charged": max(0.0, float(seconds))}, {})
            return
        with self._lock:
            self._charged += max(0.0, float(seconds))

    # -- reporting ----------------------------------------------------------
    def snapshot(self) -> Dict:
        """Wire-friendly state for endpoint/benchmark reporting."""
        base = {"wall_s": self.wall_s, "charge_s": self.charge_s,
                "max_points": self.max_points,
                "shared": self.shared,
                "backend": getattr(self.backend, "kind", None)}
        if self.shared:
            doc = self._doc()
            base.update({"points_spent": int(doc.get("points", 0)),
                         "charged_s": float(doc.get("charged", 0.0)),
                         "elapsed_s": self.elapsed_s(),
                         "denials": int(doc.get("denials", 0))})
            return base
        with self._lock:
            base.update({"points_spent": self._points,
                         "charged_s": self._charged,
                         "elapsed_s": time.monotonic() - self._t0,
                         "denials": self._denials})
            return base

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        s = self.snapshot()
        return (f"ProfilingBudget(points {s['points_spent']}"
                f"/{s['max_points']}, charged {s['charged_s']:.1f}"
                f"/{s['charge_s']}s, elapsed {s['elapsed_s']:.1f}"
                f"/{s['wall_s']}s, shared={s['shared']})")
