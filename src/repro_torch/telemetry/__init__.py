r"""Telemetry plane: spans + metrics through the whole allocation stack.

Crispy's premise is quantified self-knowledge — extrapolating a job's
memory need from a ten-minute profiling envelope — and this package
gives the SYSTEM the same property: every layer reports where its wall
time goes and how hot its caches run, with zero dependencies beyond the
stdlib and a hot-path cost low enough to leave on in production (a
warm-start plan with telemetry enabled is pinned within 5% of a no-op'd
registry by tests/test_telemetry.py).

  metrics.py   `MetricsRegistry` of counters / gauges / fixed-bucket
               histograms (p50/p95/p99). Lock-free fast path: each
               thread writes its own shard; shards fold on `snapshot()`.
               `MetricsRegistry(enabled=False)` hands out shared no-op
               instruments — the off switch. Buckets keep the most
               recent on-trace (value, trace_id) as an EXEMPLAR.
  spans.py     `span(name, **attrs)` context manager -> nested,
               thread-aware span trees via `contextvars`, recorded into
               a bounded `TraceRing` when the root closes. Every span
               carries trace/span/parent ids; `span(..., parent=ctx)`
               adopts a REMOTE parent across process edges.
  sampling.py  `AdaptiveSampler`: raises the pipeline's warm-path
               1-in-8 sampling toward 1-in-1 while windowed stage p99
               drifts past a gate, decays back on recovery (hysteresis);
               `FixedSampler` keeps a constant rate.
  export.py    snapshots as JSON (`render_json`) or Prometheus text
               (`render_prometheus`, with OpenMetrics exemplars); fleet
               aggregation by publishing periodic snapshots into the
               reserved `__telemetry__` namespace of any
               `repro.state.StateBackend` (`publish_snapshot` /
               `TelemetryPublisher` / `fleet_snapshot` /
               `aggregate_fleet`), trace forests into `__traces__`
               (`publish_traces` / `fleet_traces`), and cross-process
               stitching (`stitch_fleet_traces`).
  logs.py      `StructuredLogger`: leveled one-line-JSON events on
               stderr (the daemon's server-side logging); stamps
               `trace_id`/`span_id` automatically inside an active span.
  trace_tool.py  `python -m repro_torch.telemetry.trace_tool` — connect to a
               crispy-daemon, pull fleet snapshots + trace forests,
               print stitched cross-process trees and slowest-span
               tables.

Distributed tracing (how one request becomes ONE tree):

      service process                        daemon process
  ---------------------------          ------------------------
  endpoint.request  <- root: mints     |
    service.plan       trace_id T     |
      pipeline.acquire                 |
        [DaemonBackend.read] --frame {"op": .., "trace": {T, S}}-->
                                       daemon.op.read   <- local ROOT,
                                       |   trace_id=T, parent_id=S
                                       |   (recorded in daemon ring)
  each ring publishes roots            |
  (publish_traces / `traces` op)       |
           \                          /
            stitch_fleet_traces: graft daemon roots under span S
            => one tree, every span annotated with its source

  * Identity: every span gets a 64-bit hex trace_id (minted at the
    trace root, inherited by descendants) and span_id; the propagation
    token is `current_trace_context()` == {"trace_id", "span_id"}.
  * Wire: clients stamp the token as a `trace` field on newline-JSON
    frames (repro.state.transport.TRACE_FIELD, unix AND tcp); a frame
    WITHOUT the field is an old client and gets byte-identical legacy
    behavior. `AllocationEndpoint.handle(trace=ctx)` is the same hop
    one level up, and replies carry `trace_id`.
  * Clock: each local trace anchors (epoch, perf_counter) ONCE at its
    root; descendants derive `started_at` monotonically, so sibling
    offsets survive NTP steps. Remote spans re-anchor on their own
    host's clock (stitching joins by ids, never by timestamps).
  * Sampling policy: cold pipeline stages always span/observe; warm
    stages sample 1-in-`(mask+1)` and only span when nested. The mask
    is 7 under `FixedSampler` (default) and breathes 7 -> 0 -> 7 under
    `AdaptiveSampler` as windowed p99 crosses/recovers its gate.
  * Exemplars: a histogram bucket remembers its most recent on-trace
    (value, trace_id, ts); exporters render them (OpenMetrics suffix in
    `render_prometheus`), so "p99 got worse" links to a concrete
    stitched trace.

Where each span/metric hangs (the observability map):

  AllocationPipeline   histograms `pipeline.stage.<stage>.seconds`;
  (repro_torch.pipeline)     counters `pipeline.warm_start.{hits,misses}`;
                       spans `pipeline.warm_start` / `.acquire` / `.fit`
                       / `.extrapolate` / `.select`. Warm-path economics
                       (a registry hit answers in tens of us): cold
                       stages (acquire/fit/classify) always span and
                       observe; warm stages (warm_start/extrapolate/
                       select) sample their histograms 1-in-8 and open
                       spans only when nested inside a caller's span.
                       Counters are exact, and exact per-request walls
                       always land on `PipelinePlan.stage_walls` ->
                       `PipelineTrace.stage_walls` (opt-in on the wire
                       via `AllocationEndpoint.handle(include_trace=
                       True)`).
  PointSource          counters `acquisition.{fresh,lru_hits,
  (repro_torch.pipeline)     store_hits,denied}` + `acquisition.profile_
                       seconds` — the LRU -> store -> fresh tier heat.
  ProfilingBudget      counters `budget.{reserved_points,refunded_
  (repro.profiling)    points,charged_seconds,denials}` — envelope
                       accounting is auditable: charged vs refunded.
  AllocationService    histograms `service.batch.size`, `service.queue_
  (repro_torch.allocator)    wait.seconds`, `service.request.seconds`;
                       counters `service.*` (the legacy `stats`
                       dataclass is now a compatibility VIEW over these
                       counters — one thread-safe source of truth).
                       `service.metrics()` returns the snapshot;
                       `AllocationEndpoint.metrics()` is the wire form.
  CrispyDaemon         histograms `daemon.op.<op>.seconds` per request
  (repro.state)        op — batch frames time each sub-op into the same
                       histograms and record their width (ops per
                       frame) in `daemon.batch.size`; counters
                       `daemon.{frames,bytes_in,auth_
                       failures,compactions}` (a batch frame counts
                       once in `daemon.frames`). Served over BOTH
                       transports as the `{"op": "metrics"}` wire op
                       (`DaemonBackend.metrics()`), and optionally
                       auto-published to the daemon's own backend with
                       `--telemetry-interval S`.

`benchmarks/load_tiers.py` drives the instrumented service across
request-mix tiers and records p50/p99 latency + throughput (plus key
counters) to `BENCH_load.json` — the perf trajectory across PRs.

A copy of the JAX package's ``repro/telemetry/`` without ``trace_tool.py``,
which reads a daemon: the JAX package's state plane (``repro.state``), its
profiling budget (``repro.profiling``) and its daemon, named above, are not
ported yet (ROADMAP.md, Queue 1, item 5b).
"""
from repro_torch.telemetry.export import (KEY_FIELDS, TELEMETRY_NS, TRACES_NS,
                                    TelemetryPublisher, aggregate_fleet,
                                    fleet_snapshot, fleet_traces,
                                    publish_snapshot, publish_traces,
                                    render_json, render_prometheus,
                                    shard_heat, stitch_fleet_traces)
from repro_torch.telemetry.logs import StructuredLogger
from repro_torch.telemetry.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     NULL_COUNTER, NULL_GAUGE,
                                     NULL_HISTOGRAM, default_registry,
                                     quantile_from_buckets,
                                     set_default_registry)
from repro_torch.telemetry.sampling import (AdaptiveSampler, FixedSampler,
                                      resolve_sampler)
from repro_torch.telemetry.spans import (Span, TraceRing, current_span,
                                   current_trace_context, default_ring,
                                   new_span_id, span, span_if)

__all__ = [
    "AdaptiveSampler", "Counter", "DEFAULT_BUCKETS", "FixedSampler",
    "Gauge", "Histogram", "KEY_FIELDS", "MetricsRegistry",
    "NULL_COUNTER", "NULL_GAUGE", "NULL_HISTOGRAM", "Span",
    "StructuredLogger", "TELEMETRY_NS", "TRACES_NS",
    "TelemetryPublisher", "TraceRing", "aggregate_fleet",
    "current_span", "current_trace_context", "default_registry",
    "default_ring", "fleet_snapshot", "fleet_traces", "new_span_id",
    "publish_snapshot", "publish_traces", "quantile_from_buckets",
    "render_json", "render_prometheus", "resolve_sampler",
    "set_default_registry", "shard_heat", "span", "span_if",
    "stitch_fleet_traces",
]
