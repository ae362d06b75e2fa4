"""Adaptive warm-path sampling: spend observation budget where latency
is misbehaving.

The pipeline's warm path (registry hit -> extrapolate -> select) answers
in tens of microseconds, so it samples its stage histograms 1-in-8 to
keep telemetry off the critical path. That rate is a blind spot exactly
when it matters: if warm-path p99 starts drifting, 7 of 8 samples —
and 7 of 8 would-be exemplars — are thrown away while the regression
is live. `AdaptiveSampler` closes the loop:

  * it watches `pipeline.stage.<stage>.seconds` p99 computed over a
    WINDOW (bucket-count deltas between ticks — the histograms
    themselves are cumulative, so raw p99 would never recover after a
    single bad burst);
  * when windowed p99 crosses `gate_p99_s`, the sampling mask halves
    (1-in-8 -> 1-in-4 -> ... -> 1-in-1), one step per tick;
  * when p99 falls back under `recover_p99_s` (default: gate/2 —
    hysteresis, so a p99 hovering at the gate doesn't flap the rate),
    the mask decays one step back toward `base_mask`.

Masks are `2**k - 1` values used as `counter & mask == 0` tests by the
pipeline, so "rate" here is always a power of two. The sampler itself
is instrumented: counters `sampling.{escalations,decays}` and gauge
`sampling.mask` make rate changes visible in every fleet snapshot.

`tick()` is called from the pipeline's sampled (1-in-mask) branches and
is interval-gated, so its steady-state cost is one clock read + compare.
The clock is injectable for deterministic tests.

`FixedSampler` keeps the fixed-rate behavior (constant mask) for callers that
want it; `resolve_sampler` maps the `sampler=` constructor argument
(None | "adaptive" | "fixed" | int | instance) to an instance.

A copy of the JAX package's ``repro/telemetry/sampling.py``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

from repro_torch.telemetry.metrics import (MetricsRegistry, default_registry,
                                     quantile_from_buckets)

DEFAULT_STAGES = ("warm_start", "extrapolate", "select")


class FixedSampler:
    """Constant-rate sampler: `mask` is forever what you constructed it
    with (7 -> 1-in-8, 0 -> every observation)."""

    def __init__(self, mask: int = 7):
        if mask < 0 or (mask & (mask + 1)) != 0:
            raise ValueError(f"mask must be 2**k - 1, got {mask}")
        self.mask = mask

    def tick(self, force: bool = False) -> int:
        return self.mask


class AdaptiveSampler:
    """Escalate the warm-path sampling rate while stage p99 drifts past
    a gate; decay it back once latency recovers (see module docstring).

    Parameters:
      telemetry      registry whose `pipeline.stage.<stage>.seconds`
                     histograms are watched (default: process default).
      stages         stage names to watch (the warm-path trio).
      gate_p99_s     windowed p99 above this escalates sampling.
      recover_p99_s  windowed p99 below this (on every watched stage)
                     decays sampling; default gate/2.
      interval_s     min seconds between evaluations; `tick()` calls in
                     between just return the current mask.
      base_mask      resting mask (7 = 1-in-8, the fixed rate).
      min_mask       floor while escalated (0 = sample everything).
      clock          injectable monotonic clock for tests.
    """

    def __init__(self, telemetry: Optional[MetricsRegistry] = None,
                 stages: Sequence[str] = DEFAULT_STAGES,
                 gate_p99_s: float = 0.005,
                 recover_p99_s: Optional[float] = None,
                 interval_s: float = 2.0,
                 base_mask: int = 7, min_mask: int = 0,
                 clock=time.monotonic):
        for m in (base_mask, min_mask):
            if m < 0 or (m & (m + 1)) != 0:
                raise ValueError(f"mask must be 2**k - 1, got {m}")
        if min_mask > base_mask:
            raise ValueError("min_mask must not exceed base_mask")
        self.telemetry = telemetry if telemetry is not None \
            else default_registry()
        self.stages = tuple(stages)
        self.gate_p99_s = gate_p99_s
        self.recover_p99_s = (recover_p99_s if recover_p99_s is not None
                              else gate_p99_s / 2.0)
        self.interval_s = interval_s
        self.base_mask = base_mask
        self.min_mask = min_mask
        self.mask = base_mask
        self._clock = clock
        self._last_tick = -float("inf")
        # per-stage cumulative bucket counts at the previous evaluation,
        # so each tick sees only the WINDOW of new observations
        self._prev: Dict[str, list] = {}
        tel = self.telemetry
        self._escalations = tel.counter("sampling.escalations")
        self._decays = tel.counter("sampling.decays")
        self._gauge = tel.gauge("sampling.mask")
        self._gauge.set(self.mask)

    # -- evaluation ---------------------------------------------------------
    def _windowed_p99(self, stage: str) -> Optional[float]:
        """p99 over observations since the previous tick, or None when
        the window is empty (no traffic -> no opinion)."""
        hist = self.telemetry.histogram(f"pipeline.stage.{stage}.seconds")
        counts, _total, n, lo, hi, _ex = hist._fold()
        prev = self._prev.get(stage)
        if prev is None or len(prev) != len(counts):
            delta = list(counts)
        else:
            delta = [c - p for c, p in zip(counts, prev)]
        self._prev[stage] = list(counts)
        window_n = sum(delta)
        if window_n <= 0:
            return None
        return quantile_from_buckets(hist.bounds, delta, 0.99,
                                     lo=lo, hi=hi)

    def tick(self, force: bool = False) -> int:
        """Re-evaluate at most once per `interval_s`; returns the mask
        the caller should sample with from now on."""
        if not self.telemetry.enabled:     # no histograms to watch
            return self.mask
        now = self._clock()
        if not force and now - self._last_tick < self.interval_s:
            return self.mask
        self._last_tick = now
        worst: Optional[float] = None
        for stage in self.stages:
            p99 = self._windowed_p99(stage)
            if p99 is not None and (worst is None or p99 > worst):
                worst = p99
        if worst is None:                  # idle window: hold the rate
            return self.mask
        if worst > self.gate_p99_s and self.mask > self.min_mask:
            self.mask >>= 1                # double the sampling rate
            self._escalations.inc()
            self._gauge.set(self.mask)
        elif worst <= self.recover_p99_s and self.mask < self.base_mask:
            self.mask = (self.mask << 1) | 1
            self._decays.inc()
            self._gauge.set(self.mask)
        return self.mask


def resolve_sampler(spec, telemetry: Optional[MetricsRegistry] = None):
    """Map a `sampler=` constructor argument to a sampler instance:

      None / "fixed"   FixedSampler(7) — the fixed constant 1-in-8
      "adaptive"       AdaptiveSampler(telemetry)
      int              FixedSampler(mask=spec)
      instance         passed through (anything with .mask and .tick())
    """
    if spec is None or spec == "fixed":
        return FixedSampler()
    if spec == "adaptive":
        return AdaptiveSampler(telemetry)
    if isinstance(spec, int):
        return FixedSampler(spec)
    if hasattr(spec, "tick") and hasattr(spec, "mask"):
        return spec
    raise ValueError(f"unknown sampler spec: {spec!r}")
