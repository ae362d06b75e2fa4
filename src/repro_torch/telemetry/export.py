"""Exporters: registry snapshots as JSON, Prometheus text, and fleet
snapshots published through any `repro.state.StateBackend`.

Local forms:

  render_json(registry)        one JSON object (the raw `snapshot()`).
  render_prometheus(registry)  Prometheus text exposition: counters as
                               `<name>_total`, gauges verbatim,
                               histograms as cumulative `_bucket{le=..}`
                               series plus `_sum`/`_count` — scrapeable
                               by anything that speaks the format.
                               Bucket lines carry OpenMetrics EXEMPLAR
                               suffixes (`# {trace_id="<id>"} v ts`)
                               when the bucket saw an on-trace
                               observation, so a latency outlier links
                               straight to its stitched trace.
                               `style="flat"` keeps a label-free,
                               non-cumulative per-bucket form for
                               humans and line-oriented diffing.

Fleet form — N service processes plus the daemon aggregate into one
view. Each participant periodically appends its snapshot to a reserved
`__telemetry__` log namespace on the shared backend (the same
append-only shape as the profile store, so daemon compaction folds it);
readers take latest-per-source and can merge sources into fleet totals:

  publish_snapshot(backend, "svc-4711", registry)   # one push
  TelemetryPublisher(backend, "svc-4711", registry,
                     period_s=10.0).start()         # periodic pushes
  fleet_snapshot(backend)       {source: {"ts": .., "metrics": snap}}
  aggregate_fleet(fleet)        counters summed, histogram buckets
                                merged, percentiles recomputed from the
                                merged buckets, exemplars latest-per-
                                bucket

Trace form — the same machinery for finished span trees. Each process
publishes its `TraceRing` roots (span dicts, see Span.to_dict) into a
reserved `__traces__` namespace; `stitch_fleet_traces` then joins the
per-process forests into cross-process trees by grafting any root whose
`parent_id` names a span in ANOTHER process's forest under that span
(remote-parent adoption: the daemon opens its `daemon.op.*` spans as
local roots carrying the caller's trace_id/parent_id — see
repro_torch.telemetry.spans and repro.state.daemon):

  publish_traces(backend, "svc-4711")         # push default_ring roots
  fleet_traces(backend)                       # {source: [root, ...]}
  stitch_fleet_traces(fleet)                  # [cross-process trees]

Every span in a stitched tree is annotated with the `source` that
produced it, so a printed tree reads "this 40 ms request spent 31 ms in
svc-4711 and 9 ms across 3 daemon round-trips".

A copy of the JAX package's ``repro/telemetry/export.py``; the state plane
it publishes through is not ported yet.
"""
from __future__ import annotations

import copy
import json
import threading
import time
from typing import Dict, List, Optional

from repro_torch.telemetry.metrics import (MetricsRegistry, quantile_from_buckets)
from repro_torch.telemetry.spans import TraceRing, default_ring

TELEMETRY_NS = "__telemetry__"
TRACES_NS = "__traces__"

# identity fields the state-plane compactor folds the telemetry log on
# (later snapshot per source wins; see repro.state.compaction.fold_log)
KEY_FIELDS = ("source",)


# -- local renderers ----------------------------------------------------------

def render_json(registry: MetricsRegistry, indent: Optional[int] = None,
                ) -> str:
    return json.dumps(registry.snapshot(), indent=indent, sort_keys=True)


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return s if not s[:1].isdigit() else "_" + s


def render_prometheus(registry: MetricsRegistry, prefix: str = "crispy",
                      style: str = "prom") -> str:
    """Text exposition of a registry snapshot.

    style="prom" (default): the real Prometheus/OpenMetrics shape —
    cumulative `le`-labeled buckets including `+Inf`, `_sum`/`_count`,
    and per-bucket exemplar suffixes (`# {trace_id="..."} value ts`)
    where an on-trace observation was captured.

    style="flat": label-free, NON-cumulative per-bucket lines
    (`<name>_bucket_<i>`) — not scrapeable, but stable for humans and
    line diffs."""
    if style not in ("prom", "flat"):
        raise ValueError(f"unknown prometheus style: {style!r}")
    snap = registry.snapshot()
    lines = []
    for name, value in sorted(snap.get("counters", {}).items()):
        m = f"{prefix}_{_prom_name(name)}_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {value:g}")
    for name, value in sorted(snap.get("gauges", {}).items()):
        m = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {value:g}")
    for name, s in sorted(snap.get("histograms", {}).items()):
        m = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# TYPE {m} histogram")
        exemplars = {ex["bucket"]: ex for ex in s.get("exemplars", [])}
        if style == "flat":
            for i, count in enumerate(s["buckets"]):
                lines.append(f"{m}_bucket_{i} {count}")
        else:
            cum = 0
            n_bounds = len(s["bounds"])
            for i, (bound, count) in enumerate(zip(s["bounds"],
                                                   s["buckets"])):
                cum += count
                lines.append(f'{m}_bucket{{le="{bound:g}"}} {cum}'
                             + _exemplar_suffix(exemplars.get(i)))
            lines.append(f'{m}_bucket{{le="+Inf"}} {s["count"]}'
                         + _exemplar_suffix(exemplars.get(n_bounds)))
        lines.append(f"{m}_sum {s['sum']:g}")
        lines.append(f"{m}_count {s['count']}")
    return "\n".join(lines) + "\n"


def _exemplar_suffix(ex: Optional[Dict]) -> str:
    if not ex:
        return ""
    return (f' # {{trace_id="{ex["trace_id"]}"}} '
            f'{ex["value"]:g} {ex["ts"]:.6f}')


# -- fleet publishing ---------------------------------------------------------

def publish_snapshot(backend, source: str, registry: MetricsRegistry,
                     namespace: str = TELEMETRY_NS) -> Dict:
    """Append one labelled snapshot to the shared telemetry log. Returns
    the published row."""
    row = {"source": source, "ts": time.time(),
           "metrics": registry.snapshot()}
    backend.append(namespace, row)
    return row


def fleet_snapshot(backend, namespace: str = TELEMETRY_NS
                   ) -> Dict[str, Dict]:
    """Latest snapshot per source across every process publishing to
    this backend: {source: {"ts": epoch, "metrics": snapshot}}."""
    rows, _cursor = backend.read(namespace, 0)
    latest: Dict[str, Dict] = {}
    for row in rows:                       # later rows win per source
        src = row.get("source")
        if src is not None:
            latest[src] = {"ts": row.get("ts"),
                           "metrics": row.get("metrics", {})}
    return latest


def aggregate_fleet(fleet: Dict[str, Dict]) -> Dict:
    """Merge per-source snapshots into fleet totals: counters summed,
    histogram buckets merged (bounds must agree — they do, every
    instrument uses DEFAULT_BUCKETS unless deliberately overridden),
    percentiles recomputed from the merged buckets."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict] = {}
    for entry in fleet.values():
        snap = entry.get("metrics", {})
        for name, v in snap.get("counters", {}).items():
            counters[name] = counters.get(name, 0.0) + v
        for name, v in snap.get("gauges", {}).items():
            gauges[name] = gauges.get(name, 0.0) + v
        for name, s in snap.get("histograms", {}).items():
            agg = hists.get(name)
            if agg is None:
                hists[name] = {"count": s["count"], "sum": s["sum"],
                               "min": s["min"], "max": s["max"],
                               "buckets": list(s["buckets"]),
                               "bounds": list(s["bounds"]),
                               "exemplars": [dict(ex) for ex in
                                             s.get("exemplars", [])]}
                continue
            if agg["bounds"] != list(s["bounds"]):
                continue                   # incompatible; keep the first
            agg["count"] += s["count"]
            agg["sum"] += s["sum"]
            if s["count"]:
                agg["min"] = (min(agg["min"], s["min"])
                              if agg["count"] - s["count"] else s["min"])
                agg["max"] = max(agg["max"], s["max"])
            agg["buckets"] = [a + b for a, b in zip(agg["buckets"],
                                                    s["buckets"])]
            by_bucket = {ex["bucket"]: ex for ex in agg["exemplars"]}
            for ex in s.get("exemplars", []):
                cur = by_bucket.get(ex["bucket"])
                if cur is None or ex.get("ts", 0) >= cur.get("ts", 0):
                    by_bucket[ex["bucket"]] = dict(ex)
            agg["exemplars"] = [by_bucket[i] for i in sorted(by_bucket)]
    for s in hists.values():
        for q, label in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            s[label] = quantile_from_buckets(s["bounds"], s["buckets"], q,
                                             lo=s["min"], hi=s["max"])
    return {"counters": counters, "gauges": gauges, "histograms": hists,
            "sources": sorted(fleet)}


def shard_heat(fleet: Dict[str, Dict],
               prefix: str = "daemon.op.") -> Dict[str, Dict]:
    """Per-source daemon op-load breakdown from a fleet snapshot map
    (the same {source: {"metrics": ...}} shape `fleet_snapshot` and
    trace_tool.collect_fleet_metrics return). `aggregate_fleet` sums
    sources together, which is exactly wrong for spotting a hot shard —
    this keeps them apart: {source: {"ops": {op: count}, "total": n}},
    counting observations of each `daemon.op.<op>.seconds` histogram.
    Sources without daemon op histograms (plain services) are omitted,
    so over a sharded fleet the keys are the shard-qualified daemon
    labels ("crispy-daemon@shard-0", ...) and skew is one dict away."""
    suffix = ".seconds"
    heat: Dict[str, Dict] = {}
    for source, entry in fleet.items():
        snap = (entry or {}).get("metrics", {})
        ops: Dict[str, int] = {}
        for name, h in snap.get("histograms", {}).items():
            if name.startswith(prefix) and name.endswith(suffix):
                op = name[len(prefix):-len(suffix)]
                ops[op] = ops.get(op, 0) + int(h.get("count", 0))
        if ops:
            heat[source] = {"ops": dict(sorted(ops.items())),
                            "total": sum(ops.values())}
    return heat


# -- fleet traces -------------------------------------------------------------

def publish_traces(backend, source: str, ring: Optional[TraceRing] = None,
                   namespace: str = TRACES_NS) -> Dict:
    """Append this process's finished root spans (as dicts) to the
    shared trace log. Defaults to the process `default_ring()`. Returns
    the published row."""
    if ring is None:
        ring = default_ring()
    row = {"source": source, "ts": time.time(),
           "traces": [s.to_dict() for s in ring.traces()]}
    backend.append(namespace, row)
    return row


def fleet_traces(backend, namespace: str = TRACES_NS
                 ) -> Dict[str, List[Dict]]:
    """Latest trace forest per source: {source: [root_span_dict, ...]}."""
    rows, _cursor = backend.read(namespace, 0)
    latest: Dict[str, List[Dict]] = {}
    for row in rows:                       # later rows win per source
        src = row.get("source")
        if src is not None:
            latest[src] = row.get("traces", [])
    return latest


def _annotate_source(span_dict: Dict, source: str) -> None:
    span_dict["source"] = source
    for child in span_dict.get("children", ()):
        _annotate_source(child, source)


def _index_spans(span_dict: Dict, root_key: int,
                 index: Dict[str, tuple]) -> None:
    sid = span_dict.get("span_id")
    if sid and sid not in index:           # first definition wins
        index[sid] = (span_dict, root_key)
    for child in span_dict.get("children", ()):
        _index_spans(child, root_key, index)


def stitch_fleet_traces(fleet: Dict[str, List[Dict]]) -> List[Dict]:
    """Join per-process trace forests into cross-process trees.

    A root whose `parent_id` names a span living in another root's tree
    is grafted under that span (this is how a daemon's `daemon.op.*`
    roots — opened with the caller's remote trace context — rejoin the
    caller's `endpoint.request` tree). Roots whose parent never made it
    into any ring stay top-level: an orphan is still a trace. Every
    span is annotated with its producing `source`; children are kept
    sorted by `started_at` so grafted remote spans interleave with local
    ones in causal order."""
    roots: List[Dict] = []
    for source, forest in sorted(fleet.items()):
        for root in forest:
            root = copy.deepcopy(root)
            _annotate_source(root, source)
            roots.append(root)

    index: Dict[str, tuple] = {}
    for key, root in enumerate(roots):
        _index_spans(root, key, index)

    # owner[k] = index of the root that root k was grafted into (path-
    # compressed on walk) — the cycle guard for mutually-parented rings
    owner: Dict[int, int] = {}

    def _resolve(k: int) -> int:
        seen = []
        while k in owner:
            seen.append(k)
            k = owner[k]
        for s in seen:
            owner[s] = k
        return k

    grafted = set()
    for key, root in enumerate(roots):
        pid = root.get("parent_id")
        if not pid or pid not in index:
            continue
        parent_span, parent_key = index[pid]
        if _resolve(parent_key) == key:    # would close a cycle
            continue
        parent_span.setdefault("children", []).append(root)
        parent_span["children"].sort(
            key=lambda s: s.get("started_at", 0.0))
        owner[key] = parent_key
        grafted.add(key)

    out = [r for k, r in enumerate(roots) if k not in grafted]
    out.sort(key=lambda s: s.get("started_at", 0.0))
    return out


class TelemetryPublisher:
    """Background thread pushing periodic snapshots — and, when given a
    `ring`, trace forests — to a backend's telemetry logs. `stop()`
    publishes one final round so short-lived processes still land their
    totals. Publish failures are swallowed: losing a telemetry push must
    never take a service down."""

    def __init__(self, backend, source: str, registry: MetricsRegistry,
                 period_s: float = 10.0, namespace: str = TELEMETRY_NS,
                 ring: Optional[TraceRing] = None,
                 traces_namespace: str = TRACES_NS):
        self.backend = backend
        self.source = source
        self.registry = registry
        self.period_s = period_s
        self.namespace = namespace
        self.ring = ring
        self.traces_namespace = traces_namespace
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self._publish()

    def _publish(self) -> None:
        try:
            publish_snapshot(self.backend, self.source, self.registry,
                             self.namespace)
        except Exception:
            pass
        if self.ring is not None:
            try:
                publish_traces(self.backend, self.source, self.ring,
                               self.traces_namespace)
            except Exception:
                pass

    def start(self) -> "TelemetryPublisher":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._publish()                     # final totals

    def __enter__(self) -> "TelemetryPublisher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
