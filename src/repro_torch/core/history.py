"""Execution history + normalized-cost bookkeeping (paper §IV-C).

Cost of a (job, config) execution is normalized per job to the cheapest
config for that job, so the best possible selection scores 1.0 — Table I's
metric. ``ExecutionHistory`` is what BFA averages over: records of *other*
jobs (Crispy never assumes the job at hand recurs). A copy of the JAX
package's ``repro/core/history.py``."""
from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional


@dataclass(frozen=True)
class Execution:
    job: str
    config_name: str
    runtime_s: float
    usd: float


class ExecutionHistory:
    def __init__(self, executions: Iterable[Execution] = ()):
        self._by_job: Dict[str, Dict[str, Execution]] = defaultdict(dict)
        # normalized_costs is the selection hot path (BFA scans every
        # config x every job per request); memoize per job, drop on add.
        # The RLock closes the check-then-set race with a concurrent add()
        # (the AllocationService worker reads while submitters may record).
        self._nc_cache: Dict[str, Dict[str, float]] = {}
        # the full BFA score table (config -> mean normalized cost over all
        # jobs but one), memoized per exclude_job: one O(jobs x configs)
        # scan amortized over every selection until the history changes
        self._bfa_cache: Dict[Optional[str], Dict[str, float]] = {}
        self._lock = threading.RLock()
        self._version = 0
        for e in executions:
            self.add(e)

    @property
    def version(self) -> int:
        """Bumped on every add() — lets derived caches (e.g. the
        AllocationService plan cache) detect that selections computed from
        this history are stale."""
        with self._lock:
            return self._version

    def add(self, e: Execution) -> None:
        with self._lock:
            self._by_job[e.job][e.config_name] = e
            self._nc_cache.pop(e.job, None)
            self._bfa_cache.clear()     # every exclude_job view is stale
            self._version += 1

    def jobs(self) -> List[str]:
        with self._lock:
            return sorted(self._by_job)

    def cost(self, job: str, config_name: str) -> Optional[float]:
        with self._lock:
            e = self._by_job.get(job, {}).get(config_name)
            return None if e is None else e.usd

    def normalized_costs(self, job: str) -> Dict[str, float]:
        """config name -> cost / best cost, for one job. Returns a copy —
        callers may mutate it without poisoning the memo."""
        return dict(self._normalized_costs_cached(job))

    def _normalized_costs_cached(self, job: str) -> Dict[str, float]:
        """Internal shared dict for the BFA hot loop; do not mutate."""
        with self._lock:
            cached = self._nc_cache.get(job)
            if cached is not None:
                return cached
            ex = self._by_job.get(job, {})
            if not ex:
                return {}
            best = min(e.usd for e in ex.values())
            nc = {name: e.usd / best for name, e in ex.items()}
            self._nc_cache[job] = nc
            return nc

    def best_config_name(self, job: str) -> Optional[str]:
        """Cheapest recorded config for `job` (None if the job never ran) —
        what a Flora-style classifier transfers from a neighboring job."""
        with self._lock:
            ex = self._by_job.get(job, {})
            if not ex:
                return None
            return min(ex, key=lambda name: ex[name].usd)

    def bfa_scores(self, exclude_job: Optional[str] = None
                   ) -> Dict[str, float]:
        """config name -> mean normalized cost over all jobs but
        `exclude_job` — the whole BFA ranking table in one scan, memoized
        per exclude_job and invalidated whenever the history gains a run.
        Catalog-independent (keyed by config name), so any catalog subset
        the selector restricts to reuses the same table. Do not mutate."""
        with self._lock:
            cached = self._bfa_cache.get(exclude_job)
            if cached is not None:
                return cached
            sums: Dict[str, float] = defaultdict(float)
            counts: Dict[str, int] = defaultdict(int)
            for job in self._by_job:
                if job == exclude_job:
                    continue
                for name, v in self._normalized_costs_cached(job).items():
                    sums[name] += v
                    counts[name] += 1
            scores = {name: sums[name] / counts[name] for name in sums}
            self._bfa_cache[exclude_job] = scores
            return scores

    def mean_normalized_cost(self, config_name: str,
                             exclude_job: Optional[str] = None) -> float:
        """Average normalized cost of `config_name` over all *other* jobs —
        the BFA ranking signal. inf if the config never ran."""
        return self.bfa_scores(exclude_job).get(config_name, float("inf"))

    def config_names(self) -> List[str]:
        with self._lock:
            names = set()
            for ex in self._by_job.values():
                names.update(ex)
            return sorted(names)
