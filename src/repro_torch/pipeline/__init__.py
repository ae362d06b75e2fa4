"""Unified allocation pipeline: ONE staged decision path for every caller.

The paper's core loop (§III-A: sample -> profile -> model -> select) used
to exist twice — once in `CrispyAllocator.allocate` and once, with
diverging cache/store/budget semantics, inside `AllocationService`. This
package is now the only implementation; everything else is an entry point
that builds requests and reports around it:

                         PipelineRequest
                               |
        +----------------------v----------------------+
        | 1  warm-start lookup                        |
        |    registry.get(sig) -> confident model?    |--yes--> stage 5
        +----------------------+----------------------+
                               | no
        +----------------------v----------------------+
        | 2  point acquisition        (acquisition.py)|
        |    PointSource: LRU -> shared ProfileStore  |
        |    -> fresh profile run; cached points are  |
        |    NEVER budget-charged; ladder from anchor |
        |    (given > store > 1% of full size)        |
        |    placement when adaptive   (placement.py) |
        |      "infogain" (default): next size =      |
        |        argmax expected reduction in         |
        |        candidate disagreement at full_size, |
        |        cost-aware: among informative sizes  |
        |        prefer the cheapest predicted wall   |
        |      "ladder": smallest-first prefix +      |
        |        gap-midpoint escalation              |
        +----------------------+----------------------+
                               |
        +----------------------v----------------------+
        | 3  model fitting                            |
        |    fitter / model zoo (LOOCV selection)     |
        | 3b runtime companion fit    (fit_runtime_   |
        |    zoo over the ladder's wall times; its    |
        |    own relaxed gate, R2>0.95 + LOOCV<=0.10) |
        +----------------------+----------------------+
                               |
        +----------------------v----------------------+
        | 4  gate + fallback chain                    |
        |    classifier.observe (always)              |
        |    confident -> register + serve "zoo"      |
        |    (confident runtime fit registered too)   |
        |    else nearest-job transfer ("classifier") |
        |    else requirement 0 ("baseline" == BFA)   |
        +----------------------+----------------------+
                               |            (per request, plans are shared
        +----------------------v----------+  by coalesced signature groups)
        | 5  requirement extrapolation    |
        |    model.requirement(full_size, |
        |                      leeway)    |
        +----------------------+----------+
                               |
        +----------------------v----------+
        | 6  config selection             |
        |    select_crispy / neighbor's   |
        |    best config / BFA            |
        |    objective axis (request):    |
        |      cheapest_fit (default,     |
        |        the paper, bit-exact)    |
        |      min_cost / min_runtime:    |
        |        Pareto front over        |
        |        ($/h x predicted wall,   |
        |        wall); degrade to        |
        |        cheapest_fit whenever    |
        |        the runtime fit is       |
        |        unconfident              |
        +----------------------+----------+
                               |
                         PipelineTrace
                          /          \
                 CrispyReport    AllocationResponse
               (core/crispy.py) (allocator/service.py)

Entry points driving the pipeline:

  * `CrispyAllocator.allocate` (core/crispy.py) — thin one-shot wrapper;
  * `AllocationService` (allocator/service.py) — batching, coalescing,
    futures, LRU and plan caches, wire stats: CONCURRENCY ONLY, no
    ladder/fit/selection logic of its own (tests/test_allocator.py pins
    this with a parity contract: service and one-shot answers over the
    same backend are byte-identical);
  * `examples/profile_and_select.py`, `benchmarks/point_placement.py` —
    direct `AllocationPipeline.run()` users.

Shared state composes exactly as before: `store=` (ProfileStore over any
repro.state backend), `budget=` (ProfilingBudget, shared-envelope aware),
`executor=` (ProfilingExecutor for fixed-ladder point concurrency),
`registry=`/`classifier=` for warm starts and Flora-style transfer.

Telemetry (repro_torch.telemetry; `telemetry=` overrides the process default):

  stage 1      hist  pipeline.stage.warm_start.seconds (sampled 1-in-8*)
               ctrs  pipeline.warm_start.{hits,misses}        (exact)
  stage 2      hist  pipeline.stage.acquire.seconds           (always)
               ctrs  acquisition.{fresh,lru_hits,store_hits,denied}
               hist  acquisition.profile_seconds   (PointSource; exact)
               ctrs  budget.{reserved_points,refunded_points,
                     charged_seconds,denials}   (ProfilingBudget; exact)
  stage 3      hist  pipeline.stage.fit.seconds               (always)
  stage 4      hist  pipeline.stage.classify.seconds          (always)
  stages 5-6   hist  pipeline.stage.{extrapolate,select}.seconds
                     (sampled 1-in-8*)

* the resting rate. `sampler=` picks the warm-path sampling policy
(repro_torch.telemetry.sampling): None/"fixed"/int keep a constant mask,
"adaptive" raises the rate toward 1-in-1 while warm-stage windowed p99
drifts past its gate and decays it back after recovery.

Spans (`pipeline.<stage>`) open on the cold path always, on the warm
path only when nested inside a caller's span; exact per-request walls
always land on `PipelinePlan.stage_walls` -> `PipelineTrace.stage_walls`
(opt-in on the wire via `AllocationEndpoint.handle(include_trace=True)`).
See repro_torch/telemetry/__init__.py for the full observability map.

A copy of the JAX package's ``repro/pipeline/``. Its profiling store,
budget and executor (``repro.profiling``) and its state plane are not ported
yet: the pipeline takes any object with their methods. The examples,
benchmarks and tests named above are the JAX package's.
"""
from repro_torch.pipeline.acquisition import (AcquisitionStats, MemoryPointCache,
                                        PointSource)
from repro_torch.pipeline.pipeline import (AllocationPipeline, GiB, PipelinePlan,
                                     PipelineRequest, PipelineTrace)
from repro_torch.pipeline.placement import (DISAGREE_RTOL, InfoGainPlacer,
                                      LadderPlacer, MAX_EXTRA_POINTS,
                                      MIN_POINTS, PLACEMENTS,
                                      PlacementOutcome, PlacementState,
                                      PointPlacer, STABILITY_RTOL,
                                      candidate_disagreement,
                                      drive_placement, gap_midpoints,
                                      make_placer, prediction_spread)

__all__ = [
    "AcquisitionStats", "AllocationPipeline", "DISAGREE_RTOL", "GiB",
    "InfoGainPlacer", "LadderPlacer", "MAX_EXTRA_POINTS",
    "MemoryPointCache", "MIN_POINTS", "PLACEMENTS", "PipelinePlan",
    "PipelineRequest", "PipelineTrace", "PlacementOutcome",
    "PlacementState", "PointPlacer", "PointSource", "STABILITY_RTOL",
    "candidate_disagreement", "drive_placement", "gap_midpoints",
    "make_placer", "prediction_spread",
]
