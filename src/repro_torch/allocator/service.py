"""AllocationService: the unified pipeline behind a batched service front.

All allocation *decisions* — ladder resolution, point acquisition and
placement, model fitting, requirement extrapolation, config selection,
the registry/zoo/classifier/baseline fallback chain — live in
`repro_torch.pipeline.AllocationPipeline` (one staged path shared with the
one-shot `CrispyAllocator`; see repro_torch/pipeline/__init__.py for the stage
diagram). This module contains ONLY the service concerns around it:

  submit() --+                          +--> pipeline.warm_start
             |   drain window (coalesce |      (registry hit: no profiling)
  submit() --+-> concurrent requests    +--> plan cache (negative outcomes
             |   into one batch, group  |      served without a refit)
  submit() --+   by job signature)      +--> pipeline.measure_plan
                                        |      (acquire -> fit -> fall back)
                                        +--> pipeline.finalize per request
                                             (extrapolate -> select)

plus the worker thread + futures, the cross-batch ProfileResult LRU the
pipeline's acquisition stage reads through, per-batch registry/store
refreshes and flushes, and wire-facing stats. Requests for the same job
signature that land in one batch share a single plan; repeats across
batches hit the model registry and never profile again.

Profiling orchestration composes as in the JAX package:

  adaptive=True      placement-driven acquisition — the default
                     `placement="infogain"` profiles whichever size is
                     expected to shrink candidate-model disagreement at
                     full size the most and stops when further
                     measurement would not change the answer;
                     `placement="ladder"` keeps the smallest-first
                     prefix with gap-midpoint escalation.
  budget=            a profiling budget (duck-typed: `try_spend`, `refund`,
                     `charge`, `snapshot`) gates every fresh profile run
                     (adaptive or fixed) — the paper's ten-minute envelope
                     enforced service-wide. Cached points are NEVER charged.
  executor=          a profiling executor (duck-typed: `map_tasks`, and
                     `profile_ladder` for fixed ladders) profiles ladders
                     point-concurrently and fans independent signature
                     groups of one batch out over its pool.
  store=, backend=   the shared profile store and state plane (points,
                     anchors, models and one budget envelope shared by N
                     service processes). Neither is ported yet: passing
                     either raises NotImplementedError, and the service
                     keeps its points in its own LRU and its models in its
                     own registry.

A copy of the JAX package's ``repro/allocator/service.py``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.allocator.classifier import NearestJobClassifier
from repro_torch.allocator.registry import ModelRegistry
from repro_torch.core.catalog import ClusterConfig
from repro_torch.core.history import ExecutionHistory
from repro_torch.core.profiler import ProfileResult
from repro_torch.core.selector import DEFAULT_OVERHEAD_GIB, Selection
from repro_torch.telemetry import (MetricsRegistry, current_trace_context,
                             span_if)

GiB = 1024 ** 3


def _resolve(fut: Future, result=None, exc: Optional[Exception] = None):
    """Resolve a future the caller may have cancelled (or be cancelling
    concurrently) without letting InvalidStateError kill the worker."""
    if fut.cancelled():
        return
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:       # cancelled between the check and the set
        pass


def _sync_registry(registry) -> None:
    """Push a registry's deferred saves and read what others saved: the
    JAX package's ``sync_views`` for a view without backend hooks."""
    flush = getattr(registry, "flush", None)
    if callable(flush):
        flush()
    refresh = getattr(registry, "refresh", None)
    if callable(refresh):
        refresh()


@dataclass
class AllocationRequest:
    job: str
    profile_at: Callable[[float], ProfileResult]
    full_size: float
    anchor: Optional[float] = None
    sizes: Optional[List[float]] = None
    signature: Optional[str] = None     # defaults to the job name
    leeway: Optional[float] = None      # overrides the service default
    adaptive: Optional[bool] = None     # overrides the service default
    placement: Optional[object] = None  # "infogain" | "ladder" | PointPlacer
    tags: Optional[Sequence[str]] = None    # Flora-style categorical tags
    objective: str = "cheapest_fit"     # | "min_cost" | "min_runtime"

    @property
    def sig(self) -> str:
        return self.signature if self.signature is not None else self.job

    @property
    def tags_key(self) -> Optional[frozenset]:
        """Canonical form of the tag palette for grouping/caching: tags
        can steer the classifier, so requests carrying different palettes
        must never share a plan."""
        return frozenset(self.tags) if self.tags is not None else None


@dataclass
class AllocationResponse:
    job: str
    signature: str
    source: str                  # registry | zoo | classifier | baseline
    candidate: Optional[str]     # winning model kind (None on baseline)
    model: Optional[object]
    requirement_gib: float
    selection: Selection
    neighbor: Optional[str] = None
    profiled: int = 0            # fresh profile_at calls for this plan
    cache_hits: int = 0          # ladder points served from the LRU/store
    wall_s: float = 0.0
    early_stop: bool = False     # adaptive schedule stopped before 5 points
    escalated: bool = False      # adaptive schedule spent extra points
    budget_exhausted: bool = False   # the budget denied at least one point
    placement: Optional[str] = None  # point-placement strategy (adaptive)
    store_hits: int = 0          # subset of cache_hits served by the store
    stage_walls: Optional[Dict[str, float]] = None   # per-stage seconds
                                 # (warm_start/acquire/fit/classify/
                                 # extrapolate/select); wire opt-in via
                                 # AllocationEndpoint.handle(include_trace=)
    objective: str = "cheapest_fit"  # what this request optimized for
    runtime_candidate: Optional[str] = None   # runtime model kind backing
                                 # a cost/runtime ranking (None without one)


# the wire-facing counter names; each is a `service.<name>` Counter on
# the service's MetricsRegistry
_STAT_FIELDS = (
    "requests", "batches", "profile_calls", "cache_hits", "registry_hits",
    "zoo_fits", "zoo_confident", "classifier_fallbacks",
    "baseline_fallbacks",
    "plan_cache_hits",           # unconfident repeats answered w/o refit
    "flush_errors",              # registry persistence failures survived
    "store_hits",                # ladder points served by the shared store
    "adaptive_plans",            # plans scheduled adaptively
    "early_stops",               # adaptive plans that stopped early
    "escalations",               # adaptive plans that spent extra points
    "points_saved",              # ladder points adaptive plans did not run
    "budget_denied",             # plans the budget cut short
    "runtime_fits",              # plans that fit a runtime companion model
    "runtime_confident",         # runtime fits that passed their gate
    "cost_objective_requests",   # requests asking min_cost / min_runtime
    "objective_fallbacks",       # of those, selections that degraded to
                                 # cheapest_fit (unconfident runtime model)
)


class ServiceStats:
    """Compatibility VIEW over the service's `service.*` counters in its
    MetricsRegistry. Attribute reads (`stats.requests`) fold the
    per-thread counter shards, so they always agree with
    `AllocationService.metrics()` — one thread-safe source of truth
    where two racing sets of `+=` (some outside the lock) used to drift.
    Read-only by construction: increments go through `inc()`, which the
    service owns. Over a disabled registry every field reads 0."""

    FIELDS = _STAT_FIELDS

    def __init__(self, telemetry: Optional[MetricsRegistry] = None):
        tel = telemetry if telemetry is not None else MetricsRegistry()
        object.__setattr__(self, "_counters",
                           {f: tel.counter("service." + f)
                            for f in _STAT_FIELDS})

    def inc(self, name: str, n: float = 1) -> None:
        self._counters[name].inc(n)

    def __getattr__(self, name: str):
        counters = object.__getattribute__(self, "_counters")
        if name in counters:
            return int(counters[name].value)
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        raise AttributeError(
            f"ServiceStats is a read-only view over MetricsRegistry "
            f"counters; cannot set {name!r}")

    @property
    def profile_hit_rate(self) -> float:
        total = self.profile_calls + self.cache_hits
        return self.cache_hits / total if total else 0.0

    def as_dict(self) -> Dict[str, int]:
        return {f: int(c.value) for f, c in self._counters.items()}


class _ProfileLRU:
    """Cross-batch ProfileResult LRU behind the pipeline's PointSource
    cache interface (get/put). Thread-safe AND lock-striped: fixed-ladder
    points and concurrent signature groups read through it from executor
    workers, and under a hot mixed batch a single global lock serializes
    every group on every point lookup — so entries are sharded by
    signature hash, each shard owning its own lock, OrderedDict, and a
    proportional slice of the capacity. LRU order is per-shard (a global
    order would need the global lock back), which approximates global
    LRU well when signatures spread across shards."""

    SHARDS = 16

    def __init__(self, cap: int, shards: int = SHARDS):
        self._nshards = max(1, min(int(shards), max(1, cap)))
        self._shard_cap = max(1, cap // self._nshards)
        self._shards = [
            (threading.Lock(), OrderedDict())
            for _ in range(self._nshards)]

    def _shard(self, signature: str):
        return self._shards[hash(signature) % self._nshards]

    def get(self, signature: str, size: float) -> Optional[ProfileResult]:
        key = (signature, float(size))
        lock, cache = self._shard(signature)
        with lock:
            r = cache.get(key)
            if r is not None:
                cache.move_to_end(key)
            return r

    def put(self, signature: str, size: float, result: ProfileResult,
            from_store: bool = False) -> None:
        key = (signature, float(size))
        lock, cache = self._shard(signature)
        with lock:
            cache[key] = result
            cache.move_to_end(key)
            while len(cache) > self._shard_cap:
                cache.popitem(last=False)


class _PlanCache:
    """Striped negative-outcome plan cache (see AllocationService: maps
    (sig, ladder, tags, objective, settings) -> unconfident plan). Same
    sharding
    rationale as _ProfileLRU — concurrent signature groups must not
    serialize on one lock — with the history-version invalidation kept
    PER SHARD: each shard remembers the history version it was filled
    under and self-clears lazily on its next access after a mutation,
    so invalidation needs no global barrier either."""

    SHARDS = 16

    def __init__(self, cap: int, hist_version, shards: int = SHARDS):
        self._nshards = max(1, min(int(shards), max(1, cap)))
        self._shard_cap = max(1, cap // self._nshards)
        self._shards = [
            [threading.Lock(), OrderedDict(), hist_version]
            for _ in range(self._nshards)]

    def _shard(self, plan_key: Tuple):
        # shard by signature (plan_key[0]): everything else in the key
        # only disambiguates within a signature
        return self._shards[hash(plan_key[0]) % self._nshards]

    def get(self, plan_key: Tuple, hist_version):
        shard = self._shard(plan_key)
        lock, cache, _ = shard
        with lock:
            if shard[2] != hist_version:
                cache.clear()
                shard[2] = hist_version
                return None
            plan = cache.get(plan_key)
            if plan is not None:
                cache.move_to_end(plan_key)
            return plan

    def put(self, plan_key: Tuple, plan, hist_version) -> None:
        shard = self._shard(plan_key)
        lock, cache, _ = shard
        with lock:
            if shard[2] != hist_version:
                cache.clear()
                shard[2] = hist_version
            cache[plan_key] = plan
            cache.move_to_end(plan_key)
            while len(cache) > self._shard_cap:
                cache.popitem(last=False)

    def clear(self) -> None:
        for shard in self._shards:
            lock, cache, _ = shard
            with lock:
                cache.clear()


class AllocationService:
    def __init__(self, catalog: List[ClusterConfig],
                 history: ExecutionHistory,
                 registry: Optional[ModelRegistry] = None,
                 classifier: Optional[NearestJobClassifier] = None,
                 candidates: Optional[Sequence] = None,
                 overhead_per_node_gib: float = DEFAULT_OVERHEAD_GIB,
                 leeway: float = 0.0,
                 profile_cache_size: int = 512,
                 batch_window_s: float = 0.005,
                 adaptive: bool = False,
                 placement="infogain",      # repro_torch.pipeline point placement
                 budget=None,               # a ProfilingBudget (duck-typed)
                 store=None,                # not ported: raises
                 executor=None,             # a ProfilingExecutor (duck-typed)
                 backend=None,              # not ported: raises
                 telemetry=None,            # repro_torch.telemetry MetricsRegistry
                 sampler=None):             # warm-path sampling policy:
                                            # None|"adaptive"|"fixed"|int|obj
                                            # (repro_torch.telemetry.sampling)
        self.catalog = catalog
        self.history = history
        if store is not None or backend is not None:
            raise NotImplementedError(
                "store= and backend= need the profiling store and the shared "
                "state plane, which are not ported yet (ROADMAP.md, Queue 1, "
                "item 5b)")
        self.backend = backend
        self.registry = registry if registry is not None else ModelRegistry()
        self.classifier = classifier if classifier is not None \
            else NearestJobClassifier()
        self.budget = budget
        self.store = store
        self.executor = executor
        self.batch_window_s = batch_window_s
        self.adaptive = adaptive
        # per-SERVICE registry by default (not the process default): two
        # services in one process must not sum each other's counters.
        # Pass an explicit registry to share one (e.g. with a budget).
        self.telemetry = telemetry if telemetry is not None \
            else MetricsRegistry()
        self.stats = ServiceStats(self.telemetry)
        self._h_batch = self.telemetry.histogram(
            "service.batch.size",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                     192, 256))
        self._h_queue = self.telemetry.histogram(
            "service.queue_wait.seconds")
        self._h_request = self.telemetry.histogram(
            "service.request.seconds")
        self._cache = _ProfileLRU(profile_cache_size)

        # the ONE decision path (deferred import: repro_torch.pipeline imports
        # allocator submodules)
        from repro_torch.pipeline import AllocationPipeline
        self.pipeline = AllocationPipeline(
            catalog, history, registry=self.registry,
            classifier=self.classifier, candidates=candidates,
            overhead_per_node_gib=overhead_per_node_gib, leeway=leeway,
            adaptive=adaptive, placement=placement, budget=budget,
            store=store, executor=executor, cache=self._cache,
            defer_registry_save=True,
            refresh_store=False,    # _process_batch refreshes once per batch
            telemetry=self.telemetry, sampler=sampler)

        self._cache_cap = profile_cache_size
        # negative-outcome cache: (sig, ladder, tags, settings) ->
        # unconfident plan,
        # so a noisy job resubmitted N times doesn't redo the zoo LOOCV
        # fit and classifier scan N times. Cleared whenever the observable
        # world changes (new signature observed / new model registered),
        # because either can turn a baseline outcome into a classifier
        # one. Lock-striped (_PlanCache): with an executor, a batch's
        # signature groups plan concurrently and must not serialize on
        # a single cache lock.
        self._plan_cache = _PlanCache(profile_cache_size, history.version)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # pending tuples carry the submitter's trace context: contextvars
        # do not cross threads, so the worker must be handed the token
        # explicitly to open its spans inside the caller's trace
        self._pending: List[Tuple[AllocationRequest, Future, float,
                                  Optional[Dict]]] = []
        self._worker: Optional[threading.Thread] = None
        self._closed = False

        # warm the classifier from persisted registry records: a restarted
        # service classifies against every CONFIDENT signature it ever
        # registered (gate-failing ladders live only in memory and are
        # re-observed as their jobs resubmit)
        for rec in self.registry.records():
            self.classifier.observe(rec.signature, rec.sizes, rec.mems)

    def _shared_backend(self):
        for b in (self.backend, getattr(self.store, "backend", None),
                  getattr(self.registry, "backend", None),
                  getattr(self.budget, "backend", None)):
            if b is not None:
                return b
        return None

    @property
    def backend_kind(self) -> Optional[str]:
        """Kind of the shared-state backend this service operates over
        ("memory" | "file" | "daemon"), from whichever shared component
        carries one; None for a fully process-local service."""
        return getattr(self._shared_backend(), "kind", None)

    @property
    def backend_transport(self) -> Optional[str]:
        """Transport of a daemon backend ("unix" | "tcp"); None for
        local backends — the monitoring signal that distinguishes a
        co-located daemon from a multi-host one."""
        return getattr(self._shared_backend(), "transport", None)

    @property
    def backend_address(self) -> Optional[str]:
        """Address a daemon backend connects to (unix path or host:port);
        None for local backends."""
        return getattr(self._shared_backend(), "address", None)

    @property
    def backend_shards(self) -> Optional[List[Dict]]:
        """Shard topology of a sharded backend: one {"name", "kind",
        "address", "standby"} descriptor per shard (see
        repro.state.sharding.ShardedBackend.topology); None over a
        single backend."""
        topo = getattr(self._shared_backend(), "topology", None)
        if not callable(topo):
            return None
        return topo().get("shards")

    def metrics(self) -> Dict:
        """Snapshot of every instrument on this service's registry —
        the `service.*` counters/histograms plus whatever the pipeline,
        acquisition, and (if it shares the registry) budget recorded.
        See repro_torch.telemetry for the map."""
        return self.telemetry.snapshot()

    # -- public -------------------------------------------------------------
    def submit(self, req: AllocationRequest) -> "Future[AllocationResponse]":
        fut: Future = Future()
        ctx = current_trace_context()   # captured HERE, in the caller's
        with self._cv:                  # thread; None when untraced
            if self._closed:
                raise RuntimeError("AllocationService is closed")
            self._pending.append((req, fut, time.monotonic(), ctx))
            self._ensure_worker_locked()
            self._cv.notify()
        return fut

    def allocate(self, req: AllocationRequest,
                 timeout: Optional[float] = None) -> AllocationResponse:
        return self.submit(req).result(timeout)

    def allocate_many(self, reqs: Sequence[AllocationRequest],
                      timeout: Optional[float] = None
                      ) -> List[AllocationResponse]:
        futs = [self.submit(r) for r in reqs]
        return [f.result(timeout) for f in futs]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        # durability backstop for write-behind rows + deferred puts
        self._flush_shared_state()

    def __enter__(self) -> "AllocationService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker -------------------------------------------------------------
    def _ensure_worker_locked(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    def _run(self) -> None:
        while True:
            # under sustained load a batch's writes are carried by the
            # NEXT batch's sync frame (see _process_batch); when the
            # queue drains, flush now so siblings see the last batch's
            # points/models without waiting for more traffic. Outside
            # the lock: a flush round trip must not block submitters.
            with self._cv:
                idle = not self._pending and not self._closed
            if idle:
                self._flush_shared_state()
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending and self._closed:
                    return
            # coalesce: give concurrent submitters a window to land in the
            # same batch so same-signature ladders dedup to one plan
            if self.batch_window_s > 0:
                time.sleep(self.batch_window_s)
            with self._cv:
                batch, self._pending = self._pending, []
            if batch:
                self._process_batch(batch)

    def _flush_shared_state(self) -> None:
        """Push buffered write-behind rows and deferred registry models
        to the backend. A persistence failure (disk full, daemon down)
        must never kill the worker — rows stay queued / models stay in
        memory and the next flush retries."""
        flush_writes = getattr(self.store, "flush_writes", None)
        if flush_writes is not None:
            try:
                flush_writes()
            except Exception:
                self.stats.inc("flush_errors")
        try:
            self.registry.flush()
        except Exception:
            self.stats.inc("flush_errors")

    def _preq(self, req: AllocationRequest):
        """The pipeline-facing view of a wire request."""
        from repro_torch.pipeline import PipelineRequest
        return PipelineRequest(req.job, req.profile_at, req.full_size,
                               anchor=req.anchor, sizes=req.sizes,
                               signature=req.signature, leeway=req.leeway,
                               adaptive=req.adaptive,
                               placement=req.placement, tags=req.tags,
                               objective=req.objective)

    def _settings_key(self, req: AllocationRequest):
        """Resolved acquisition settings for grouping/plan-cache keys: an
        explicit adaptive=/placement= override produces different points
        than the service defaults, so such requests must never share (or
        be served) a plan computed under other settings."""
        adaptive = req.adaptive if req.adaptive is not None \
            else self.adaptive
        if not adaptive:
            return (False, None)
        placement = req.placement if req.placement is not None \
            else self.pipeline.placement
        # a placer INSTANCE keys by identity (two instances of one class
        # can carry different knobs, so a shared name would alias them;
        # holding the instance in the key also keeps its id from being
        # recycled under a cached plan). Placement names key by value.
        return (True, placement)

    def _process_batch(
            self,
            batch: List[Tuple[AllocationRequest, Future, float,
                              Optional[Dict]]]) -> None:
        self.stats.inc("batches")
        self.stats.inc("requests", len(batch))
        self._h_batch.observe(len(batch))
        now = time.monotonic()
        for _req, _fut, t_sub, _ctx in batch:
            self._h_queue.observe(now - t_sub)
        # batch-level backend work (refresh below, flush at the end) joins
        # the FIRST traced requester's trace — the same convention as the
        # shared planning work — so coalescing round trips out of the
        # per-request path doesn't also detach them from every trace
        batch_ctx = next((ctx for _r, _f, _t, ctx in batch
                          if ctx is not None), None)
        # the reference pulls sibling processes' points and models in here
        # (one round trip to the shared backend per batch); with no store
        # and no backend the only view is the registry: flush, then refresh
        try:
            with span_if(batch_ctx is not None, "service.refresh",
                         parent=batch_ctx):
                _sync_registry(self.registry)
        except Exception:
            pass                            # stale view is still correct
        # group by (signature, ladder, tags, objective, acquisition
        # settings): same-signature requests share one plan only when
        # they ask for the same ladder, carry the same tag palette, the
        # same selection objective AND resolve to the same
        # adaptive/placement settings — coalescing never silently
        # overrides an explicit sizes/anchor, a tag-steered
        # classification, a cost objective, or a per-request acquisition
        # override
        groups: "OrderedDict[Tuple, " \
                "List[Tuple[AllocationRequest, Future, float, " \
                "Optional[Dict]]]" = \
            OrderedDict()
        for req, fut, t_sub, ctx in batch:
            ladder = self.pipeline.ladder_for(self._preq(req))
            groups.setdefault(
                (req.sig, ladder, req.tags_key, req.objective,
                 self._settings_key(req)),
                []).append((req, fut, t_sub, ctx))

        def handle_group(entry) -> None:
            (sig, ladder, _tags, _objective, _settings), items = entry
            live = [(req, fut, ts, ctx) for req, fut, ts, ctx in items
                    if not fut.cancelled()]
            if not live:                    # whole group cancelled: don't
                return                      # profile for nobody
            t0 = time.monotonic()
            # the shared planning work joins the FIRST traced requester's
            # trace (coalesced siblings get their own service.respond
            # spans below); untraced groups open no span at all, exactly
            # the pre-tracing behavior
            ctx0 = next((ctx for _r, _f, _t, ctx in live
                         if ctx is not None), None)
            try:
                with span_if(ctx0 is not None, "service.plan",
                             parent=ctx0, signature=sig,
                             coalesced=len(live)):
                    plan = self._plan(sig, ladder, live[0][0])
            except Exception as e:          # a failing profile_at fails its
                for _, fut, _ts, _ctx in live:  # group, never the batch
                    _resolve(fut, exc=e)
                return
            wall = time.monotonic() - t0
            for req, fut, ts, ctx in live:
                try:
                    with span_if(ctx is not None, "service.respond",
                                 parent=ctx, job=req.job):
                        resp = self._respond(plan, req, wall)
                except Exception as e:
                    _resolve(fut, exc=e)
                    continue
                _resolve(fut, result=resp)
                # submit -> answer, queue wait and batching included
                self._h_request.observe(time.monotonic() - ts)

        entries = list(groups.items())
        if self.executor is not None and len(entries) > 1:
            # independent signatures plan (and profile) concurrently;
            # handle_group resolves its own futures and never raises
            self.executor.map_tasks(handle_group, entries)
        else:
            for entry in entries:
                handle_group(entry)
        # NO flush here: whatever this batch wrote stays buffered (rows)
        # or deferred (registry models) and rides in the NEXT batch's
        # sync frame — or is pushed by the worker's idle-time
        # _flush_shared_state the moment the queue drains. Either way
        # the loaded steady state is one wire frame per batch.

    # -- planning: pipeline calls + caches + stats --------------------------
    def _plan(self, sig: str, ladder: Tuple[float, ...],
              req: AllocationRequest):
        plan = self.pipeline.warm_start(sig)
        if plan is not None:
            self.stats.inc("registry_hits")
            return plan

        plan_key = (sig, ladder, req.tags_key, req.objective,
                    self._settings_key(req))
        # classifier/baseline plans freeze history-derived selections,
        # so a history mutation invalidates the negative cache (each
        # shard self-clears on its next access at the new version)
        cached_plan = self._plan_cache.get(plan_key, self.history.version)
        if cached_plan is not None:
            self.stats.inc("plan_cache_hits")
            # this request did no profiling; don't report the
            # original's counters or adaptive-schedule flags
            return dataclasses.replace(cached_plan, profiled=0,
                                       cache_hits=0, store_hits=0,
                                       early_stop=False,
                                       escalated=False,
                                       budget_exhausted=False)

        plan = self.pipeline.measure_plan(self._preq(req), ladder)
        self._count_plan(plan)
        if plan.newly_observed or plan.registered:
            # a new neighbor (or a new confident model) may rescue
            # previously-cached negative outcomes
            self._plan_cache.clear()
        # cache only fully-profiled negative outcomes: a plan cut short by
        # the budget reflects a transient denial, not a property of the
        # job, and must not stick once the budget recovers
        if plan.source in ("classifier", "baseline") \
                and not plan.budget_exhausted:
            self._plan_cache.put(plan_key, plan, self.history.version)
        return plan

    def _count_plan(self, plan) -> None:
        """Map one measured plan onto the wire-facing counters (no lock:
        the counters themselves are thread-safe)."""
        s = self.stats
        s.inc("zoo_fits", int(plan.fit_ran))
        s.inc("zoo_confident", int(plan.registered))
        if plan.source == "classifier":
            s.inc("classifier_fallbacks")
        elif plan.source == "baseline":
            s.inc("baseline_fallbacks")
        s.inc("profile_calls", plan.profiled)
        s.inc("cache_hits", plan.cache_hits)
        s.inc("store_hits", plan.store_hits)
        if plan.adaptive:
            s.inc("adaptive_plans")
            s.inc("early_stops", int(plan.early_stop))
            s.inc("escalations", int(plan.escalated))
            s.inc("points_saved", max(0, plan.base_points
                                      - plan.total_points))
        s.inc("budget_denied", int(plan.budget_exhausted))
        if plan.runtime_fit is not None:
            s.inc("runtime_fits")
            s.inc("runtime_confident",
                  int(getattr(plan.runtime_fit, "confident", False)))

    def _respond(self, plan, req: AllocationRequest,
                 wall: float) -> AllocationResponse:
        trace = self.pipeline.finalize(plan, self._preq(req), wall)
        p = trace.plan
        sel = trace.selection
        if req.objective != "cheapest_fit":
            self.stats.inc("cost_objective_requests")
            self.stats.inc("objective_fallbacks",
                           int(getattr(sel, "objective_fell_back", False)))
        return AllocationResponse(req.job, req.sig, p.source, p.candidate,
                                  p.model, trace.requirement_gib,
                                  sel, p.neighbor, p.profiled,
                                  p.cache_hits, wall, p.early_stop,
                                  p.escalated, p.budget_exhausted,
                                  p.placement, p.store_hits,
                                  dict(trace.stage_walls),
                                  objective=req.objective,
                                  runtime_candidate=p.runtime_candidate)
