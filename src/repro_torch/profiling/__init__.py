"""Profiling orchestration: budgeted, adaptive, concurrent, multi-process.

Crispy's whole value proposition is cheap profiling — under ten minutes
per job on a laptop — yet a plain pipeline spends a fixed 5-point ladder
serially on every new signature and keeps its caches per-process. This
package turns profiling itself into a managed resource:

  budget.py     `ProfilingBudget` — the paper's ten-minute envelope as an
                enforced, thread-safe limit (wall clock, accounted profile
                seconds, and point count) shared by everything below.

  scheduler.py  `AdaptiveLadderScheduler` — now a budget-gating loop
                over the `repro_torch.pipeline` placement strategies: the
                ladder-prefix behavior lives in
                `repro_torch.pipeline.placement.LadderPlacer` (smallest-first,
                refit per point, early stop on confident+stable,
                gap-midpoint escalation while candidates disagree;
                Ruya-style iterative spend, arXiv:2211.04240), and
                `placement="infogain"` swaps in information-optimal
                placement. `calibrated_anchor` persists per-signature
                anchors so repeat signatures skip `calibrate_anchor`
                entirely.

  executor.py   `ProfilingExecutor` — thread pool the pipeline fans
                fixed-ladder points and the service fans independent
                signature groups over (`map_tasks`); budget gating lives
                in the pipeline's acquisition stage, not here.

  store.py      `ProfileStore` (profile points + calibrated anchors in a
                backend append-only log), `BackendModelRegistry`
                (read-merge-CAS registry flushes: concurrent services
                lose no records) and the back-compat `LockedModelRegistry`
                file constructor. All sharing is delegated to the
                `repro_torch.state` StateBackend protocol (memory / fcntl file
                / crispy-daemon); no fcntl lives here anymore.

The acquisition loop itself now lives in `repro_torch.pipeline` (PointSource +
drive_placement): both `AllocationService` and `CrispyAllocator` reach
these resources through the unified pipeline's `budget=`, `store=` and
`executor=` knobs; `benchmarks/profiling_adaptive.py` measures fixed-vs-
adaptive points, wall time and requirement error, and
`benchmarks/point_placement.py` compares placement strategies (both are
the JAX package's benchmarks).

A copy of the JAX package's ``repro/profiling/``.
"""
from repro_torch.profiling.budget import BudgetExhausted, ProfilingBudget
from repro_torch.profiling.executor import DEFAULT_WORKERS, ProfilingExecutor
from repro_torch.profiling.scheduler import (AdaptiveLadderScheduler,
                                       AdaptiveProfile, DISAGREE_RTOL,
                                       MAX_EXTRA_POINTS, MIN_POINTS,
                                       STABILITY_RTOL, calibrated_anchor)
from repro_torch.profiling.store import (BackendModelRegistry, FileLock,
                                   HAS_FCNTL, LockedModelRegistry,
                                   ProfileStore)

__all__ = [
    "AdaptiveLadderScheduler", "AdaptiveProfile", "BackendModelRegistry",
    "BudgetExhausted", "DEFAULT_WORKERS", "DISAGREE_RTOL", "FileLock",
    "HAS_FCNTL", "LockedModelRegistry", "MAX_EXTRA_POINTS", "MIN_POINTS",
    "ProfileStore", "ProfilingBudget", "ProfilingExecutor",
    "STABILITY_RTOL", "calibrated_anchor",
]
