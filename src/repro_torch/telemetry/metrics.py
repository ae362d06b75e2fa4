"""Process-local metrics: counters, gauges, fixed-bucket histograms.

Hot paths in the allocation stack (warm-start lookups, point acquisition,
daemon request dispatch) run at microsecond scale, so every instrument
here is built around a lock-free fast path: each thread writes its own
shard (a plain list only that thread mutates — safe under the GIL) and
shards are folded only when a snapshot is taken. The registry lock is
touched once per (metric, thread) pair, never per observation.

Instruments:

  Counter     monotonically increasing float (`inc(n)`); folded `value`.
  Gauge       last-write-wins float (`set(v)`), e.g. queue depth.
  Histogram   fixed-bucket distribution (`observe(v)`): per-bucket
              counts + sum/count/min/max, with p50/p95/p99 estimated by
              linear interpolation inside the winning bucket. Default
              bucket bounds cover 1us..60s — the latency range of
              everything from an LRU hit to a fresh profile run. When an
              observation happens inside an active trace span, the
              bucket keeps the most recent (value, trace_id) pair as an
              EXEMPLAR — a p99 outlier in a dashboard links straight to
              the stitched distributed trace that produced it (see
              repro_torch.telemetry.spans / export.stitch_fleet_traces).

`MetricsRegistry` names and caches instruments (`counter("a.b")`,
`histogram("a.b.seconds")`); `snapshot()` folds every shard into one
JSON-safe dict (the exporters in `repro_torch.telemetry.export` render it).
A registry constructed with `enabled=False` hands out shared no-op
instruments — the whole telemetry plane compiles down to attribute
lookups, which is what the <5% warm-start overhead regression test pins
against.

A copy of the JAX package's ``repro/telemetry/metrics.py``.
"""
from __future__ import annotations

import math
import threading
import time
from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.telemetry.spans import current_span

# 1us .. 60s, roughly 4 buckets per decade: wide enough for an LRU hit
# and a minutes-long profile run to land in *different* buckets
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """Monotonic counter with a per-thread-shard fast path."""

    def __init__(self, name: str):
        self.name = name
        self._local = threading.local()
        self._shards: List[List[float]] = []
        self._lock = threading.Lock()

    def _cell(self) -> List[float]:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = [0.0]
            self._local.cell = cell
            with self._lock:            # once per (counter, thread)
                self._shards.append(cell)
        return cell

    def inc(self, n: float = 1.0) -> None:
        self._cell()[0] += n

    @property
    def value(self) -> float:
        with self._lock:
            return sum(cell[0] for cell in self._shards)


class Gauge:
    """Last-write-wins value (a plain attribute store is atomic under
    the GIL; gauges are too rare to shard)."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        # best-effort (gauges tolerate lost updates; use a Counter when
        # exactness matters)
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class _HistShard:
    __slots__ = ("counts", "sum", "count", "min", "max", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf
        # bucket index -> (value, trace_id, epoch_ts); latest wins
        self.exemplars: Dict[int, Tuple[float, str, float]] = {}


class Histogram:
    """Fixed-bucket histogram; per-thread shards folded on snapshot."""

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b)
                                                      for b in buckets))
        self._n = len(self.bounds) + 1          # +1: overflow bucket
        self._local = threading.local()
        self._shards: List[_HistShard] = []
        self._lock = threading.Lock()

    def _shard(self) -> _HistShard:
        s = getattr(self._local, "shard", None)
        if s is None:
            s = _HistShard(self._n)
            self._local.shard = s
            with self._lock:
                self._shards.append(s)
        return s

    def observe(self, v: float) -> None:
        v = float(v)
        s = self._shard()
        idx = bisect_right(self.bounds, v)
        s.counts[idx] += 1
        s.sum += v
        s.count += 1
        if v < s.min:
            s.min = v
        if v > s.max:
            s.max = v
        sp = current_span()          # one contextvar get; None off-trace
        if sp is not None and sp.trace_id is not None:
            s.exemplars[idx] = (v, sp.trace_id, time.time())

    def time(self):
        """Context manager observing the block's wall seconds."""
        return _Timer(self)

    # -- folding ------------------------------------------------------------
    def _fold(self) -> Tuple[List[int], float, int, float, float,
                             Dict[int, Tuple[float, str, float]]]:
        counts = [0] * self._n
        total = 0.0
        n = 0
        lo, hi = math.inf, -math.inf
        exemplars: Dict[int, Tuple[float, str, float]] = {}
        with self._lock:
            shards = list(self._shards)
        for s in shards:
            for i, c in enumerate(s.counts):
                counts[i] += c
            total += s.sum
            n += s.count
            lo = min(lo, s.min)
            hi = max(hi, s.max)
            for i, ex in s.exemplars.items():
                cur = exemplars.get(i)
                if cur is None or ex[2] >= cur[2]:     # latest ts wins
                    exemplars[i] = ex
        return counts, total, n, lo, hi, exemplars

    def summary(self) -> Dict:
        counts, total, n, lo, hi, exemplars = self._fold()
        out = {"count": n, "sum": total,
               "min": lo if n else 0.0, "max": hi if n else 0.0,
               "buckets": counts, "bounds": list(self.bounds)}
        for q, label in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            out[label] = quantile_from_buckets(self.bounds, counts, q,
                                               lo=lo, hi=hi)
        out["exemplars"] = [
            {"bucket": i,
             "le": (f"{self.bounds[i]:g}" if i < len(self.bounds)
                    else "+Inf"),
             "value": ex[0], "trace_id": ex[1], "ts": ex[2]}
            for i, ex in sorted(exemplars.items())]
        return out

    def percentile(self, q: float) -> float:
        counts, _total, n, lo, hi, _ex = self._fold()
        if not n:
            return 0.0
        return quantile_from_buckets(self.bounds, counts, q, lo=lo, hi=hi)

    @property
    def count(self) -> int:
        return self._fold()[2]


class _Timer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist):
        self._hist = hist

    def __enter__(self):
        import time
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time
        self._hist.observe(time.perf_counter() - self._t0)


def quantile_from_buckets(bounds: Sequence[float], counts: Sequence[int],
                          q: float, lo: float = math.inf,
                          hi: float = -math.inf) -> float:
    """Estimate the q-quantile of a folded bucket distribution by linear
    interpolation inside the winning bucket (clamped to observed
    min/max where known). Shared by Histogram.summary and the fleet
    aggregator, so merged snapshots report percentiles the same way."""
    n = sum(counts)
    if n == 0:
        return 0.0
    rank = q * n
    seen = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if seen + c >= rank:
            b_lo = bounds[i - 1] if i > 0 else 0.0
            b_hi = bounds[i] if i < len(bounds) else (
                hi if hi > -math.inf else bounds[-1])
            if lo < math.inf:
                b_lo = max(b_lo, min(lo, b_hi))
            if hi > -math.inf:
                b_hi = min(b_hi, hi) if b_hi > hi else b_hi
            frac = (rank - seen) / c
            return b_lo + (b_hi - b_lo) * min(1.0, max(0.0, frac))
        seen += c
    return hi if hi > -math.inf else float(bounds[-1])


# -- no-op instruments (shared singletons; enabled=False registries) ----------

class _NullCounter:
    name = "<null>"
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass


class _NullGauge:
    name = "<null>"
    value = 0.0

    def set(self, v: float) -> None:
        pass

    def inc(self, n: float = 1.0) -> None:
        pass


class _NullHistogram:
    name = "<null>"
    count = 0
    bounds: Tuple[float, ...] = ()

    def observe(self, v: float) -> None:
        pass

    def time(self):
        return _NULL_TIMER

    def summary(self) -> Dict:
        return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                "buckets": [], "bounds": [], "p50": 0.0, "p95": 0.0,
                "p99": 0.0, "exemplars": []}

    def percentile(self, q: float) -> float:
        return 0.0


class _NullTimer:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


_NULL_TIMER = _NullTimer()
NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Named instrument factory + snapshot point (see module docstring).

    `counter/gauge/histogram` return the same instrument for the same
    name (a name may carry only one kind). With `enabled=False` every
    accessor returns a shared no-op instrument and `snapshot()` is
    empty — instrumented code needs no branches of its own."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- factories ----------------------------------------------------------
    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return NULL_COUNTER
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                self._check_free_locked(name, self._counters)
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return NULL_GAUGE
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                self._check_free_locked(name, self._gauges)
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        if not self.enabled:
            return NULL_HISTOGRAM
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                self._check_free_locked(name, self._histograms)
                h = self._histograms[name] = Histogram(name, buckets)
            return h

    def _check_free_locked(self, name: str, own: Dict) -> None:
        for kind in (self._counters, self._gauges, self._histograms):
            if kind is not own and name in kind:
                raise ValueError(
                    f"metric {name!r} already registered as a different "
                    f"instrument kind")

    # -- reporting ----------------------------------------------------------
    def snapshot(self) -> Dict:
        """Fold every shard into one JSON-safe dict."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        return {
            "counters": {c.name: c.value for c in counters},
            "gauges": {g.name: g.value for g in gauges},
            "histograms": {h.name: h.summary() for h in hists},
        }


# -- process default ----------------------------------------------------------

_default = MetricsRegistry()
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry instrumented components fall back to
    when no explicit `telemetry=` is passed."""
    return _default


def set_default_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests; embedders that want isolation).
    Returns the previous default so callers can restore it."""
    global _default
    with _default_lock:
        prev, _default = _default, registry
        return prev
