"""Point acquisition: ONE cache-hierarchy + budget gate for every caller.

Before the pipeline existed, three code paths each re-implemented "get a
profile point without paying twice": the AllocationService (LRU -> store
-> fresh run), the AdaptiveLadderScheduler's `take()`, and the
ProfilingExecutor's `one()`. They mostly agreed — but the one-shot
CrispyAllocator path never refreshed its ProfileStore, so points a
sibling process had already profiled (and charged to a shared
ProfilingBudget envelope) were invisible, re-profiled, and charged a
second time. `PointSource` is now the only implementation of the rule:

  peek (LRU, then shared store — refreshed once per acquisition) is
  consulted BEFORE the budget gate, so cached work is always free;
  only a genuinely fresh run reserves a budget point and charges its
  reported wall seconds; a reservation that races another thread's
  fresh run is refunded, never charged.

Callers plug in at the edges: an optional `cache` (get/put, e.g. the
service's LRU), an optional `store` (repro_torch.profiling.ProfileStore), an
optional `budget`, and counter hooks for service stats.

A copy of the JAX package's ``repro/pipeline/acquisition.py``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

from repro_torch.core.profiler import ProfileResult
from repro_torch.telemetry import default_registry


@dataclass
class AcquisitionStats:
    """Counters one acquisition run accumulates (feeds PipelineTrace)."""
    fresh: int = 0               # profile runs actually executed
    cache_hits: int = 0          # points served by LRU or store
    store_hits: int = 0          # subset of cache_hits served by the store
    denied: bool = False         # the budget refused at least one point


class PointSource:
    """Budget-gated, cache-backed access to `profile_at(size)` for one
    job signature. Thread-safe: fixed ladders fan points over a
    ProfilingExecutor pool through one instance."""

    def __init__(self, signature: str,
                 profile_at: Callable[[float], ProfileResult],
                 budget=None,                 # repro_torch.profiling ProfilingBudget
                 store=None,                  # repro_torch.profiling ProfileStore
                 cache=None,                  # object with get/put (LRU view)
                 refresh_store: bool = True,
                 telemetry=None):             # repro_torch.telemetry MetricsRegistry
        self.signature = signature
        self.profile_at = profile_at
        self.budget = budget
        self.store = store
        self.cache = cache
        self.stats = AcquisitionStats()
        self._lock = threading.Lock()
        # process-wide acquisition-tier heat (stats above is per-plan)
        tel = telemetry if telemetry is not None else default_registry()
        self._c_fresh = tel.counter("acquisition.fresh")
        self._c_lru = tel.counter("acquisition.lru_hits")
        self._c_store = tel.counter("acquisition.store_hits")
        self._c_denied = tel.counter("acquisition.denied")
        # reported profile cost (the paper's envelope currency), not the
        # simulator's real microseconds — matches what budgets charge
        self._h_profile = tel.histogram("acquisition.profile_seconds")
        if store is not None and refresh_store:
            try:
                # pull sibling processes' points in BEFORE planning: a
                # point any process already profiled must be served free,
                # not re-measured and double-charged to a shared envelope
                store.refresh()
            except Exception:
                pass                         # a stale view is still correct

    # -- cache hierarchy ----------------------------------------------------
    def peek(self, size: float) -> Optional[ProfileResult]:
        """LRU then shared store; no profiling, no budget interaction.
        Does NOT count hits (acquire() does) — safe for budget gates and
        schedulers to call speculatively."""
        if self.cache is not None:
            r = self.cache.get(self.signature, size)
            if r is not None:
                return r
        if self.store is not None:
            r = self.store.get(self.signature, size)
            if r is not None:
                if self.cache is not None:
                    self.cache.put(self.signature, size, r, from_store=True)
                return r
        return None

    def _record_hit(self, from_store: bool) -> None:
        with self._lock:
            self.stats.cache_hits += 1
            if from_store:
                self.stats.store_hits += 1
        (self._c_store if from_store else self._c_lru).inc()

    # -- the one acquisition rule -------------------------------------------
    def acquire(self, size: float) -> Optional[Tuple[ProfileResult, bool]]:
        """One point through the hierarchy: `(result, fresh)`, or None
        when the budget denied a fresh run. Cached points are free by
        construction — they are served before the budget is consulted."""
        if self.cache is not None:
            r = self.cache.get(self.signature, size)
            if r is not None:
                self._record_hit(from_store=False)
                return r, False
        if self.store is not None:
            r = self.store.get(self.signature, size)
            if r is not None:
                if self.cache is not None:
                    self.cache.put(self.signature, size, r, from_store=True)
                self._record_hit(from_store=True)
                return r, False
        if self.budget is not None and not self.budget.try_spend():
            with self._lock:
                self.stats.denied = True
            self._c_denied.inc()
            return None
        # a sibling thread may have profiled this size between the peek
        # and the reservation: re-check the cache so the run (and its
        # charge) never happens twice
        if self.cache is not None:
            r = self.cache.get(self.signature, size)
            if r is not None:
                if self.budget is not None:
                    self.budget.refund()
                self._record_hit(from_store=False)
                return r, False
        try:
            r = self.profile_at(size)
        except BaseException:
            # a failing profile run must hand its reservation back: with
            # a shared max_points envelope, leaked reservations from
            # transient profiler crashes would drain the budget without a
            # single point measured
            if self.budget is not None:
                self.budget.refund()
            raise
        if self.budget is not None:
            self.budget.charge(r.wall_s)
        with self._lock:
            self.stats.fresh += 1
        self._c_fresh.inc()
        self._h_profile.observe(r.wall_s)
        if self.cache is not None:
            self.cache.put(self.signature, size, r, from_store=False)
        if self.store is not None:
            try:
                self.store.put(self.signature, size, r)
            except Exception:
                pass            # a write-through failure costs a future
                                # re-profile, never this plan
        return r, True

    # -- legacy ProfilePointFn adapter --------------------------------------
    def as_point_fn(self):
        """The `(size) -> (result, fresh)` callable (with `.peek`) the
        profiling scheduler/executor interfaces expect, WITHOUT their budget
        handling: this source already gates and charges, so callers must
        not pass a budget of their own alongside it."""
        def pp(size: float) -> Tuple[ProfileResult, bool]:
            got = self.acquire(size)
            if got is None:
                from repro_torch.profiling.budget import BudgetExhausted
                raise BudgetExhausted(
                    f"budget denied point {size!r} for {self.signature!r}")
            return got
        pp.peek = self.peek
        return pp


@dataclass
class MemoryPointCache:
    """Minimal `cache=` adapter for embedders and tests that want a
    process-local point cache without a service LRU: a plain dict, no
    eviction. (The one-shot CrispyAllocator path runs cache-less on
    purpose — placers never re-request a measured size, and its shared
    reuse goes through `store=`.)"""
    _points: dict = field(default_factory=dict)

    def get(self, signature: str, size: float) -> Optional[ProfileResult]:
        return self._points.get((signature, float(size)))

    def put(self, signature: str, size: float, result: ProfileResult,
            from_store: bool = False) -> None:
        self._points[(signature, float(size))] = result
