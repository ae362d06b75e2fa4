"""AllocationPipeline: the paper's loop as ONE staged decision path.

See the package docstring (`repro_torch/pipeline/__init__.py`) for the stage
diagram. `AllocationPipeline.plan()` runs the per-signature stages
(warm-start, acquisition, fitting, fallback classification);
`finalize()` runs the per-request stages (requirement extrapolation,
config selection) and returns a `PipelineTrace` — the one record both
`CrispyReport` (core/crispy.py) and `AllocationResponse`
(allocator/service.py) are built from. `run()` composes the two for
one-shot callers.

Telemetry (repro_torch.telemetry): stages record wall histograms
(`pipeline.stage.<stage>.seconds`) and spans (`pipeline.<stage>`) into
the pipeline's `MetricsRegistry` (the process default unless
`telemetry=` overrides it). Cold stages (acquire/fit/classify) always
record; warm stages (warm_start/extrapolate/select) sample their
histograms 1-in-8 and open spans only when nested inside a caller span
— see the `_sample_mask` comment in `__init__` for the economics.
Exact per-request stage walls always land on `PipelinePlan.stage_walls`
/ `PipelineTrace.stage_walls` so a single decision can be broken down
after the fact. Acquisition-tier heat (LRU/store/fresh/denied) is
counted by `PointSource`.

A copy of the JAX package's ``repro/pipeline/pipeline.py``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from time import perf_counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.allocator.model_zoo import fit_runtime_zoo, fit_zoo
from repro_torch.telemetry import (current_span, default_registry,
                             resolve_sampler, span_if)
from repro_torch.core.catalog import ClusterConfig
from repro_torch.core.history import ExecutionHistory
from repro_torch.core.profiler import ProfileResult
from repro_torch.core.sampling import ladder_from_anchor
from repro_torch.core.selector import (DEFAULT_OVERHEAD_GIB, Selection,
                                 select_crispy, select_like)
from repro_torch.pipeline.acquisition import PointSource
from repro_torch.pipeline.placement import drive_placement, make_placer

GiB = 1024 ** 3


@dataclass
class PipelineRequest:
    """One allocation question, backend-agnostic: everything the staged
    path needs to answer 'how much memory, which config'."""
    job: str
    profile_at: Callable[[float], ProfileResult]
    full_size: float
    anchor: Optional[float] = None
    sizes: Optional[Sequence[float]] = None
    signature: Optional[str] = None     # defaults to the job name
    leeway: Optional[float] = None      # overrides the pipeline default
    adaptive: Optional[bool] = None     # overrides the pipeline default
    placement: Optional[object] = None  # "infogain" | "ladder" | PointPlacer
    exclude_job_in_history: bool = True
    tags: Optional[Sequence[str]] = None    # Flora-style categorical tags
    objective: str = "cheapest_fit"     # | "min_cost" | "min_runtime"

    @property
    def sig(self) -> str:
        return self.signature if self.signature is not None else self.job


@dataclass
class PipelinePlan:
    """Per-signature outcome of stages 1-4; shared by every request that
    coalesced onto the same (signature, ladder)."""
    signature: str
    source: str                      # registry | zoo | classifier | baseline
    model: Optional[object]          # the SERVING model (None on baseline)
    candidate: Optional[str]         # winning model kind (None on baseline)
    fit: Optional[object] = None     # this job's own fit (unconfident ones
                                     # still reach CrispyReport.model)
    runtime_fit: Optional[object] = None   # runtime companion model (a
                                     # RuntimeFit, or the bare registered
                                     # model on warm starts); feeds the
                                     # min_cost/min_runtime objectives
    runtime_candidate: Optional[str] = None
    neighbor: Optional[str] = None
    neighbor_selection: Optional[Selection] = None
    sizes: List[float] = field(default_factory=list)
    mems: List[float] = field(default_factory=list)
    walls: List[float] = field(default_factory=list)
    results: List[ProfileResult] = field(default_factory=list)
    requirement_trace: List[float] = field(default_factory=list)
    profiled: int = 0                # fresh profile_at calls
    cache_hits: int = 0              # points served by LRU or shared store
    store_hits: int = 0              # subset served by the shared store
    adaptive: bool = False
    placement: Optional[str] = None  # placer name when adaptive
    early_stop: bool = False
    escalated: bool = False
    budget_exhausted: bool = False
    base_points: int = 0             # base-ladder length (points_saved basis)
    fit_ran: bool = False            # a zoo/fitter fit happened
    registered: bool = False         # a confident model was registered
    newly_observed: bool = False     # first time the classifier saw this sig
    stage_walls: Dict[str, float] = field(default_factory=dict)
    # per-stage wall seconds for THIS plan (warm_start | acquire | fit |
    # classify); finalize() adds the per-request stages on the trace

    @property
    def total_points(self) -> int:
        return len(self.sizes)


@dataclass
class PipelineTrace:
    """One finished decision: the shared plan plus this request's
    extrapolation and selection — the single record CrispyReport and
    AllocationResponse are both built from."""
    plan: PipelinePlan
    job: str
    full_size: float
    requirement_gib: float
    selection: Selection
    wall_s: float = 0.0
    stage_walls: Dict[str, float] = field(default_factory=dict)
    # plan stages + this request's extrapolate/select walls (seconds)

    # convenience proxies (reports read these off the trace)
    @property
    def sizes(self) -> List[float]:
        return self.plan.sizes

    @property
    def mems(self) -> List[float]:
        return self.plan.mems

    @property
    def results(self) -> List[ProfileResult]:
        return self.plan.results

    @property
    def source(self) -> str:
        return self.plan.source


class AllocationPipeline:
    """The one staged decision path (see package docstring). Thread-safe:
    concurrent signature groups may call `plan()` simultaneously (the
    AllocationService fans them over a ProfilingExecutor)."""

    def __init__(self, catalog: List[ClusterConfig],
                 history: ExecutionHistory,
                 registry=None,             # allocator ModelRegistry (or None)
                 classifier=None,           # NearestJobClassifier (or None)
                 fitter: Optional[Callable] = None,
                 candidates: Optional[Sequence] = None,
                 runtime_fitter: Optional[Callable] = None,
                 overhead_per_node_gib: float = DEFAULT_OVERHEAD_GIB,
                 leeway: float = 0.0,
                 adaptive: bool = False,
                 placement="infogain",
                 budget=None,               # repro_torch.profiling ProfilingBudget
                 store=None,                # repro_torch.profiling ProfileStore
                 executor=None,             # repro_torch.profiling ProfilingExecutor
                 cache=None,                # LRU adapter (get/put), optional
                 defer_registry_save: bool = False,
                 refresh_store: bool = True,
                 telemetry=None,            # repro_torch.telemetry MetricsRegistry
                 sampler=None):             # None|"adaptive"|"fixed"|int|obj
        # refresh_store=False is for callers that already refresh the
        # shared store on their own cadence (the AllocationService does it
        # once per batch); everyone else must see sibling points before
        # planning, or re-profile — and double-charge a shared budget
        # envelope for — work that is already stored.
        self.catalog = catalog
        self.history = history
        self.registry = registry
        self.classifier = classifier
        self.fitter = fitter
        self.candidates = candidates
        self.runtime_fitter = runtime_fitter
        self.overhead = overhead_per_node_gib
        self.leeway = leeway
        self.adaptive = adaptive
        self.placement = placement
        self.budget = budget
        self.store = store
        self.executor = executor
        self.cache = cache
        self.defer_registry_save = defer_registry_save
        self.refresh_store = refresh_store
        self._lock = threading.Lock()       # guards the classifier
        self.telemetry = telemetry if telemetry is not None \
            else default_registry()
        # instruments are created once here, not per plan: the factory
        # takes the registry lock, the hot path must not
        self._stage_hist = {
            s: self.telemetry.histogram(f"pipeline.stage.{s}.seconds")
            for s in ("warm_start", "acquire", "fit", "classify",
                      "extrapolate", "select")}
        self._warm_hits = self.telemetry.counter("pipeline.warm_start.hits")
        self._warm_misses = self.telemetry.counter(
            "pipeline.warm_start.misses")
        # warm-path economics: a registry hit answers in tens of µs, so
        # per-request spans (or even an unconditional histogram observe)
        # would blow the <5% overhead pin. Warm-path stage histograms are
        # sampled 1-in-(mask+1); warm-path spans exist only when nested
        # inside an active caller span. Counters stay exact. The cold
        # path (acquire/fit) always records — profiling dwarfs it.
        # The mask comes from a sampler (repro_torch.telemetry.sampling):
        # FixedSampler(7) by default, or AdaptiveSampler — which raises
        # the rate toward 1-in-1 while warm-stage windowed p99 drifts
        # past its gate — via sampler="adaptive". tick() is called only
        # on sampled iterations and is interval-gated inside.
        self.sampler = resolve_sampler(sampler, self.telemetry)
        self._sample_mask = self.sampler.mask
        self._sample_n = 0      # benign races: a lost bump skews sampling

    # -- stage 2a: ladder resolution ----------------------------------------
    def ladder_for(self, req: PipelineRequest) -> Tuple[float, ...]:
        """The base ladder this request profiles over: explicit sizes win;
        otherwise the anchor (given > store-persisted > 1% of full size)
        shapes the paper's 5-point ladder. An explicit anchor is written
        back to the store so sibling processes skip anchor guessing."""
        if req.sizes is not None:
            return tuple(float(s) for s in req.sizes)
        anchor = req.anchor
        if anchor is None and self.store is not None:
            anchor = self.store.get_anchor(req.sig)
        if anchor is None:
            anchor = req.full_size * 0.01
        elif req.anchor is not None and self.store is not None \
                and self.store.get_anchor(req.sig) is None:
            try:
                self.store.put_anchor(req.sig, float(req.anchor))
            except Exception:
                pass        # a failed anchor write must never fail the plan
        return tuple(float(s) for s in ladder_from_anchor(anchor).sizes)

    # -- stage 3: model fitting ---------------------------------------------
    def _fit(self, sizes: Sequence[float], mems: Sequence[float]):
        if self.fitter is not None:
            return self.fitter(sizes, mems)
        return fit_zoo(sizes, mems, self.candidates)

    def _fit_runtime(self, sizes: Sequence[float], walls: Sequence[float]):
        if self.runtime_fitter is not None:
            return self.runtime_fitter(sizes, walls)
        return fit_runtime_zoo(sizes, walls)

    # -- stage 1: warm start ------------------------------------------------
    def warm_start(self, signature: str) -> Optional[PipelinePlan]:
        """A confident registered model answers without any profiling."""
        t0 = perf_counter()
        plan = None
        with span_if(self.telemetry.enabled
                     and current_span() is not None,
                     "pipeline.warm_start", signature=signature):
            if self.registry is not None:
                rec = self.registry.get(signature)
                if rec is not None and getattr(rec.model, "confident",
                                               False):
                    plan = PipelinePlan(
                        signature, "registry", rec.model, rec.candidate,
                        runtime_fit=rec.runtime_model,
                        runtime_candidate=rec.runtime_candidate)
        wall = perf_counter() - t0
        if plan is not None:
            self._warm_hits.inc()
            plan.stage_walls["warm_start"] = wall
        else:
            self._warm_misses.inc()
        self._sample_n = n = (self._sample_n + 1) & self._sample_mask
        if not n:
            self._stage_hist["warm_start"].observe(wall)
            self._sample_mask = self.sampler.tick()
        return plan

    # -- stages 1-4: per-signature plan -------------------------------------
    def plan(self, req: PipelineRequest,
             ladder: Optional[Sequence[float]] = None) -> PipelinePlan:
        warm = self.warm_start(req.sig)
        if warm is not None:
            return warm
        return self.measure_plan(req, ladder)

    # -- stages 2-4: profile, fit, fall back --------------------------------
    def measure_plan(self, req: PipelineRequest,
                     ladder: Optional[Sequence[float]] = None
                     ) -> PipelinePlan:
        sig = req.sig
        tel = self.telemetry
        # stage 2: point acquisition through the one budgeted cache
        # hierarchy (LRU -> shared store -> fresh run)
        base = list(ladder if ladder is not None else self.ladder_for(req))
        source = PointSource(sig, req.profile_at, budget=self.budget,
                             store=self.store, cache=self.cache,
                             refresh_store=self.refresh_store,
                             telemetry=tel)
        adaptive = req.adaptive if req.adaptive is not None else self.adaptive

        # adaptive placement interleaves fitting with acquisition inside
        # drive_placement, so the fit wall is accumulated through this
        # wrapper and subtracted from the acquisition elapsed time —
        # stage walls stay disjoint either way
        fit_wall = [0.0]

        def timed_fit(sizes, mems):
            t0 = perf_counter()
            try:
                return self._fit(sizes, mems)
            finally:
                fit_wall[0] += perf_counter() - t0

        t_acq = perf_counter()
        if adaptive:
            placer = make_placer(req.placement if req.placement is not None
                                 else self.placement)
            with span_if(tel.enabled, "pipeline.acquire", signature=sig,
                         adaptive=True):
                out = drive_placement(placer, base, req.full_size,
                                      source.acquire, timed_fit)
            sizes, mems, results, fit = out.sizes, out.mems, out.results, \
                out.fit
            flags = (out.early_stop, out.escalated, out.budget_exhausted)
            placement_name = getattr(placer, "name", None)
            trace = out.requirement_trace
        else:
            with span_if(tel.enabled, "pipeline.acquire", signature=sig,
                         adaptive=False):
                sizes, mems, results, exhausted = self._acquire_fixed(
                    source, base)
            with span_if(tel.enabled, "pipeline.fit", signature=sig):
                fit = timed_fit(sizes, mems)
            flags = (False, False, exhausted)
            placement_name = None
            trace = []
        acquire_wall = max(0.0, perf_counter() - t_acq - fit_wall[0])
        walls = [r.wall_s for r in results]

        # stage 3b: runtime companion fit over the same ladder's wall
        # times — the min_cost/min_runtime objectives rank feasible
        # configs by it at selection time (charged to the fit stage)
        runtime_fit = None
        if len(sizes) >= 2 and len(walls) == len(sizes):
            t_rt = perf_counter()
            with span_if(tel.enabled, "pipeline.fit_runtime",
                         signature=sig):
                runtime_fit = self._fit_runtime(sizes, walls)
            fit_wall[0] += perf_counter() - t_rt
        self._stage_hist["acquire"].observe(acquire_wall)
        self._stage_hist["fit"].observe(fit_wall[0])

        # stage 4a: every profiled ladder feeds future classifications,
        # gate-failing ones included
        newly_observed = False
        classify_wall = 0.0
        if self.classifier is not None:
            t_cls = perf_counter()
            with self._lock:
                newly_observed = not self.classifier.has(sig)
                self.classifier.observe(sig, sizes, mems, walls,
                                        tags=req.tags)
            classify_wall += perf_counter() - t_cls

        plan = PipelinePlan(sig, "baseline", None, None, fit=fit,
                            runtime_fit=runtime_fit,
                            runtime_candidate=getattr(runtime_fit,
                                                      "candidate", None),
                            sizes=list(sizes), mems=list(mems), walls=walls,
                            results=list(results), requirement_trace=trace,
                            profiled=source.stats.fresh,
                            cache_hits=source.stats.cache_hits,
                            store_hits=source.stats.store_hits,
                            adaptive=adaptive, placement=placement_name,
                            early_stop=flags[0], escalated=flags[1],
                            budget_exhausted=flags[2],
                            base_points=len(base), fit_ran=True,
                            newly_observed=newly_observed)
        plan.stage_walls["acquire"] = acquire_wall
        plan.stage_walls["fit"] = fit_wall[0]

        # stage 4b: confident fit -> serve and register it
        resolved = False
        if getattr(fit, "confident", False):
            model = getattr(fit, "model", fit)
            candidate = getattr(fit, "candidate",
                                getattr(fit, "kind", "linear"))
            plan.source, plan.model, plan.candidate = "zoo", fit, candidate
            if self.registry is not None:
                rt_ok = getattr(runtime_fit, "confident", False)
                self.registry.put(
                    sig, model, candidate, sizes, mems,
                    defer_save=self.defer_registry_save,
                    runtime_model=getattr(runtime_fit, "model",
                                          runtime_fit) if rt_ok else None,
                    runtime_candidate=getattr(runtime_fit, "candidate",
                                              None) if rt_ok else None,
                    walls=walls)
                plan.registered = True
            resolved = True

        # stage 4c: unconfident -> nearest-neighbor transfer (Flora)
        if not resolved and self.classifier is not None and len(sizes) >= 2:
            t_cls = perf_counter()
            with self._lock:
                cls = self.classifier.classify(sizes, mems, walls,
                                               exclude=(sig,),
                                               tags=req.tags)
            classify_wall += perf_counter() - t_cls
            if cls is not None:
                neighbor_rec = self.registry.get(cls.neighbor,
                                                 count_hit=False) \
                    if self.registry is not None else None
                if neighbor_rec is not None and \
                        getattr(neighbor_rec.model, "confident", False):
                    plan.source = "classifier"
                    plan.model = neighbor_rec.model
                    plan.candidate = neighbor_rec.candidate
                    plan.neighbor = cls.neighbor
                else:
                    sel = select_like(self.catalog, self.history,
                                      cls.neighbor)
                    if sel is not None:
                        plan.source = "classifier"
                        plan.neighbor = cls.neighbor
                        plan.neighbor_selection = sel
        # stage 4d: baseline (requirement 0 == exactly BFA, the paper's
        # never-worse-than-fallback property): plan.source is still
        # "baseline" when neither 4b nor 4c claimed the plan above
        self._stage_hist["classify"].observe(classify_wall)
        plan.stage_walls["classify"] = classify_wall
        return plan

    def _acquire_fixed(self, source: PointSource,
                       sizes: Sequence[float]):
        """Fixed-ladder acquisition: every point, concurrently when an
        executor is configured; budget denials leave holes and the fit
        runs over whatever materialized."""
        if self.executor is not None and len(sizes) > 1:
            rows = self.executor.map_tasks(source.acquire, list(sizes))
        else:
            rows = [source.acquire(s) for s in sizes]
        used = [s for s, rf in zip(sizes, rows) if rf is not None]
        results = [rf[0] for rf in rows if rf is not None]
        mems = [r.job_mem_bytes for r in results]
        return used, mems, results, any(rf is None for rf in rows)

    # -- stages 5-6: per-request finalization -------------------------------
    def finalize(self, plan: PipelinePlan, req: PipelineRequest,
                 wall_s: float = 0.0) -> PipelineTrace:
        """Requirement extrapolation + config selection for one request
        over a (possibly shared) plan."""
        leeway = req.leeway if req.leeway is not None else self.leeway
        exclude = req.job if req.exclude_job_in_history else None
        nested = self.telemetry.enabled and current_span() is not None
        t0 = perf_counter()
        with span_if(nested, "pipeline.extrapolate", job=req.job,
                     source=plan.source):
            if plan.model is not None:
                req_gib = plan.model.requirement(req.full_size,
                                                 leeway) / GiB
                sel = None
            elif plan.neighbor_selection is not None:
                req_gib = 0.0
                sel = plan.neighbor_selection
            else:
                req_gib = 0.0
                sel = None
        t_extra = perf_counter()
        if sel is None:
            with span_if(nested, "pipeline.select", job=req.job):
                sel = select_crispy(self.catalog, self.history, req_gib,
                                    overhead_per_node_gib=self.overhead,
                                    exclude_job=exclude,
                                    objective=req.objective,
                                    runtime_model=plan.runtime_fit,
                                    full_size=req.full_size)
        t_sel = perf_counter()
        self._sample_n = n = (self._sample_n + 1) & self._sample_mask
        if not n:
            self._stage_hist["extrapolate"].observe(t_extra - t0)
            self._stage_hist["select"].observe(t_sel - t_extra)
            self._sample_mask = self.sampler.tick()
        trace = PipelineTrace(plan, req.job, req.full_size, req_gib, sel,
                              wall_s)
        trace.stage_walls = dict(plan.stage_walls)
        trace.stage_walls["extrapolate"] = t_extra - t0
        trace.stage_walls["select"] = t_sel - t_extra
        return trace

    def run(self, req: PipelineRequest) -> PipelineTrace:
        """The whole staged path for one request (the one-shot and
        example/benchmark entry point)."""
        t0 = time.monotonic()
        plan = self.plan(req)
        return self.finalize(plan, req, time.monotonic() - t0)
