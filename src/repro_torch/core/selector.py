"""Crispy §III-D / §IV-C: configuration selection + the three baselines.

* Random — expected cost of a uniformly random pick (paper evaluates this as
  the average normalized cost over the catalog).
* Medium — fixed medium VM, medium scale-out.
* BFA ("Best For All") — config with the lowest mean normalized cost over
  all *other* jobs.
* Crispy — BFA restricted to configs whose usable total memory satisfies the
  extrapolated requirement. Requirement 0 (no confident model) == exactly BFA
  — the never-worse-than-fallback property the paper reports.

Objective axis (arXiv:2306.03672): fully-in-memory is often not
cost-optimal. When a confident *runtime* model is available,
`objective="min_cost"` ranks the memory-feasible configs by
`usd_per_hour × predicted_runtime(config)` on the (cost, runtime) Pareto
front, and `objective="min_runtime"` by predicted runtime. Per-config
runtime scales the model's profiling-machine prediction by relative
compute capacity — `peak_tflops` against the roofline peak when the
catalog carries it, total cores otherwise — with sublinear parallel
efficiency. Whenever the runtime model is missing or unconfident both
objectives degrade to `cheapest_fit` (the paper's selection), preserving
never-worse-than-BFA.

A copy of the JAX package's ``repro/core/selector.py``; the peak that
capacities are normalized against is one H100's (989 TFLOP/s) where the
reference's is one v5e chip's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.catalog import (H100_PEAK_FLOPS, ClusterConfig,
                                     medium_config)
from repro_torch.core.history import ExecutionHistory

DEFAULT_OVERHEAD_GIB = 2.0      # Spark/Hadoop+OS per node (paper §III-D)

OBJECTIVES = ("cheapest_fit", "min_cost", "min_runtime")

# runtime ∝ 1 / capacity^eff: doubling the cluster does not halve the wall
# time (stragglers, shuffle, coordination), which is exactly what makes
# over-provisioning cost-inefficient under the min_cost objective
PARALLEL_EFFICIENCY = 0.9


@dataclass
class Selection:
    config: ClusterConfig
    method: str
    mem_requirement_gib: float
    feasible_count: int
    fell_back: bool
    objective: str = "cheapest_fit"
    predicted_runtime_s: Optional[float] = None
    predicted_cost_usd: Optional[float] = None
    objective_fell_back: bool = False   # runtime objective degraded to
                                        # cheapest_fit (unconfident model)


def select_bfa(catalog: List[ClusterConfig], history: ExecutionHistory,
               exclude_job: Optional[str] = None) -> ClusterConfig:
    # one precomputed score table per (history state, exclude_job) — see
    # ExecutionHistory.bfa_scores — then an O(catalog) argmin; the
    # AllocationService no longer re-runs the jobs x configs scan per
    # request, and feasibility-restricted subsets reuse the same table
    scores = history.bfa_scores(exclude_job=exclude_job)
    inf = float("inf")
    return min(catalog,
               key=lambda c: (scores.get(c.name, inf), c.usd_per_hour))


def select_medium(catalog: List[ClusterConfig]) -> ClusterConfig:
    return medium_config(catalog)


def config_capacity(config: ClusterConfig) -> float:
    """Relative compute capacity of a config. Accelerator catalogs carry
    `peak_tflops` (normalized against one H100's peak, so GPU and CPU
    capacities live on one scale); CPU catalogs fall back to core count."""
    node = config.node
    peak = getattr(node, "peak_tflops", 0.0) or 0.0
    if peak > 0.0:
        return (peak * 1e12 / H100_PEAK_FLOPS) * config.scale_out
    return float(config.total_cores)


def predicted_runtime_s(runtime_model, full_size: float,
                        config: ClusterConfig,
                        parallel_efficiency: float = PARALLEL_EFFICIENCY,
                        ) -> Optional[float]:
    """Wall-time estimate for `config` on the full dataset, or None when
    the model's base prediction is unusable (non-finite / non-positive)."""
    try:
        base = float(runtime_model.predict(float(full_size)))
    except (OverflowError, ValueError, ZeroDivisionError):
        return None
    if not math.isfinite(base) or base <= 0.0:
        return None
    cap = max(config_capacity(config), 1.0)
    return base / cap ** parallel_efficiency


def predicted_cost_usd(runtime_s: float, config: ClusterConfig) -> float:
    return config.usd_per_hour * runtime_s / 3600.0


def pareto_front(scored: List[Tuple[ClusterConfig, float, float]]
                 ) -> List[Tuple[ClusterConfig, float, float]]:
    """Non-dominated subset of `(config, cost, runtime)` rows: a row stays
    iff no other row is at least as good on both axes and strictly better
    on one."""
    front = []
    for row in scored:
        _, cost, rt = row
        dominated = any(
            (o_cost <= cost and o_rt <= rt
             and (o_cost < cost or o_rt < rt))
            for _o, o_cost, o_rt in scored)
        if not dominated:
            front.append(row)
    return front


def _score_feasible(feasible: List[ClusterConfig], runtime_model,
                    full_size: float, parallel_efficiency: float,
                    ) -> Optional[List[Tuple[ClusterConfig, float, float]]]:
    """(config, predicted cost, predicted runtime) rows, or None whenever
    the runtime model cannot back a ranking (the cheapest_fit fallback)."""
    if runtime_model is None:
        return None
    if not getattr(runtime_model, "confident", False):
        return None
    if not full_size or full_size <= 0.0:
        return None
    rows = []
    for c in feasible:
        rt = predicted_runtime_s(runtime_model, full_size, c,
                                 parallel_efficiency)
        if rt is None:
            return None
        rows.append((c, predicted_cost_usd(rt, c), rt))
    return rows


def select_crispy(catalog: List[ClusterConfig], history: ExecutionHistory,
                  mem_requirement_gib: float,
                  overhead_per_node_gib: float = DEFAULT_OVERHEAD_GIB,
                  exclude_job: Optional[str] = None,
                  objective: str = "cheapest_fit",
                  runtime_model=None,
                  full_size: float = 0.0,
                  parallel_efficiency: float = PARALLEL_EFFICIENCY,
                  ) -> Selection:
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"expected one of {OBJECTIVES}")
    feasible = [c for c in catalog
                if c.usable_mem_gib(overhead_per_node_gib)
                >= mem_requirement_gib]
    fell_back = False
    if not feasible:
        # nothing satisfies the requirement (requirement larger than the
        # biggest cluster): take the largest-memory config — still the
        # bottleneck-minimizing choice — breaking usable-memory ties by
        # price so an infeasible requirement never lands on a strictly
        # dominated config
        feasible = [min(catalog,
                        key=lambda c: (-c.usable_mem_gib(
                            overhead_per_node_gib), c.usd_per_hour))]
        fell_back = True
    fell_back = fell_back or mem_requirement_gib <= 0.0
    objective_fell_back = False
    if objective != "cheapest_fit":
        scored = _score_feasible(feasible, runtime_model, full_size,
                                 parallel_efficiency)
        if scored is not None:
            front = pareto_front(scored)
            if objective == "min_cost":
                cfg, cost, rt = min(
                    front, key=lambda r: (r[1], r[2],
                                          r[0].usd_per_hour, r[0].name))
            else:   # min_runtime
                cfg, cost, rt = min(
                    front, key=lambda r: (r[2], r[1],
                                          r[0].usd_per_hour, r[0].name))
            return Selection(cfg, "crispy", mem_requirement_gib,
                             len(feasible), fell_back,
                             objective=objective,
                             predicted_runtime_s=rt,
                             predicted_cost_usd=cost)
        objective_fell_back = True
    cfg = select_bfa(feasible, history, exclude_job=exclude_job)
    return Selection(cfg, "crispy", mem_requirement_gib, len(feasible),
                     fell_back, objective=objective,
                     objective_fell_back=objective_fell_back)


def select_like(catalog: List[ClusterConfig], history: ExecutionHistory,
                neighbor_job: str) -> Optional[Selection]:
    """Flora-style transfer (arXiv:2502.21046): when a job's own profile is
    unusable, allocate what worked best for its nearest classified neighbor.
    None if the neighbor has no usable record in this catalog."""
    best = history.best_config_name(neighbor_job)
    if best is None:
        return None
    cfg = next((c for c in catalog if c.name == best), None)
    if cfg is None:
        return None
    return Selection(cfg, "classifier", 0.0, 1, False)


def random_expected_cost(catalog: List[ClusterConfig],
                         history: ExecutionHistory, job: str) -> float:
    """Paper baseline 1: the expectation of a uniform random selection =
    mean normalized cost over configs with a recorded execution."""
    nc = history.normalized_costs(job)
    vals = [nc[c.name] for c in catalog if c.name in nc]
    return sum(vals) / len(vals) if vals else float("inf")
