"""Crispy orchestration (paper §III-A): sample -> profile -> model -> select.

`CrispyAllocator` is the one-shot convenience wrapper over the unified
`repro_torch.pipeline.AllocationPipeline` — the same staged decision path the
batched `AllocationService` drives (see repro_torch/pipeline/__init__.py for
the stage diagram). Give it a `profile_at(size)` callable (RSS-based for
local dataflow jobs, a step on the card for the port's model jobs via
core/hbm_planner.gpu_profile_fn) and a full-size target, and it runs the paper's four
steps end to end, returning a `CrispyReport` built from the shared
`PipelineTrace`.

The modeling step is pluggable: `fitter(sizes, mems)` must return an
object with `requirement(full_size, leeway)` and `confident` (the
memory-model interface of core/memory_model.py). The default is the
paper's OLS linear fit; pass `repro_torch.allocator.model_zoo.zoo_fitter()` for
the multi-candidate model zoo (which also unlocks information-optimal
point placement — `placement="infogain"` needs candidate models to
disagree about).

A copy of the JAX package's ``repro/core/crispy.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, List, Optional, Sequence

from repro_torch.core.catalog import ClusterConfig
from repro_torch.core.history import ExecutionHistory
from repro_torch.core.memory_model import fit_memory_model
from repro_torch.core.profiler import ProfileResult
from repro_torch.core.selector import DEFAULT_OVERHEAD_GIB, Selection

if TYPE_CHECKING:       # runtime import is deferred: repro_torch.pipeline's
    # acquisition stage imports repro_torch.core submodules
    from repro_torch.pipeline import AllocationPipeline, PipelineTrace

GiB = 1024 ** 3

# (sizes, mems) -> memory model (predict/confident/requirement)
ModelFitter = Callable[[Sequence[float], Sequence[float]], Any]


@dataclass
class CrispyReport:
    job: str
    sizes: List[float]
    mems_bytes: List[float]
    model: Any                       # LinearMemoryModel or a zoo model
    requirement_gib: float
    selection: Selection
    profiling_wall_s: float
    results: List[ProfileResult] = field(default_factory=list)
    early_stop: bool = False         # adaptive: stopped before the ladder end
    escalated: bool = False          # adaptive: spent extra points
    budget_exhausted: bool = False   # a point was denied by the budget
    trace: Optional[PipelineTrace] = None    # the full staged-path record
    runtime_model: Any = None        # runtime companion fit (feeds the
                                     # min_cost/min_runtime objectives)

    @property
    def points_profiled(self) -> int:
        return len(self.sizes)

    @classmethod
    def from_trace(cls, trace: "PipelineTrace") -> "CrispyReport":
        plan = trace.plan
        return cls(trace.job, list(plan.sizes), list(plan.mems),
                   plan.fit if plan.fit is not None else plan.model,
                   trace.requirement_gib, trace.selection, trace.wall_s,
                   list(plan.results), plan.early_stop, plan.escalated,
                   plan.budget_exhausted, trace,
                   runtime_model=plan.runtime_fit)


class CrispyAllocator:
    def __init__(self, catalog: List[ClusterConfig],
                 history: ExecutionHistory,
                 overhead_per_node_gib: float = DEFAULT_OVERHEAD_GIB,
                 leeway: float = 0.0,
                 fitter: ModelFitter = fit_memory_model,
                 placement="infogain"):
        self.catalog = catalog
        self.history = history
        self.overhead = overhead_per_node_gib
        self.leeway = leeway
        self.fitter = fitter
        self.placement = placement

    def _pipeline(self, budget=None, store=None) -> "AllocationPipeline":
        from repro_torch.pipeline import AllocationPipeline
        return AllocationPipeline(
            self.catalog, self.history, fitter=self.fitter,
            overhead_per_node_gib=self.overhead, leeway=self.leeway,
            placement=self.placement, budget=budget, store=store)

    def allocate(self, job: str,
                 profile_at: Callable[[float], ProfileResult],
                 full_size: float,
                 anchor: Optional[float] = None,
                 sizes: Optional[List[float]] = None,
                 exclude_job_in_history: bool = True,
                 adaptive: bool = False,
                 budget=None,
                 store=None,
                 placement=None,
                 objective: str = "cheapest_fit") -> CrispyReport:
        """Paper steps 1-4 through the unified pipeline. With
        `adaptive=True` (or a profiling budget passed as
        `budget=`) point placement is strategy-driven: the default
        `placement="infogain"` profiles whichever size is expected to
        shrink candidate-model disagreement at full size the most and
        stops when further measurement would not change the answer;
        `placement="ladder"` keeps the smallest-first prefix with
        gap-midpoint escalation. Both profile strictly fewer points than
        the fixed ladder on clean jobs and fall back identically on noisy
        ones.

        `store=` (a profile store: `get`, `put`, `get_anchor`,
        `put_anchor`, `refresh`; the JAX package's ProfileStore over its
        state plane is not ported yet) makes the one-shot path a shared-state
        citizen too: ladder points and calibrated anchors profiled by any
        process are reused instead of re-measured (the acquisition stage
        refreshes the store, so sibling points are never double-charged),
        and fresh points are written back."""
        from repro_torch.pipeline import PipelineRequest
        pipeline = self._pipeline(budget=budget, store=store)
        trace = pipeline.run(PipelineRequest(
            job, profile_at, full_size, anchor=anchor, sizes=sizes,
            adaptive=adaptive or budget is not None,
            placement=placement,
            exclude_job_in_history=exclude_job_in_history,
            objective=objective))
        return CrispyReport.from_trace(trace)
