"""trace_tool: inspect fleet-wide distributed traces from a terminal.

    python -m repro_torch.telemetry.trace_tool --daemon /tmp/crispy.sock
    python -m repro_torch.telemetry.trace_tool --daemon host:7421 --slowest 10
    python -m repro_torch.telemetry.trace_tool --daemon ... --trace <id> --json
    python -m repro_torch.telemetry.trace_tool \
        --daemon /tmp/s0.sock,/tmp/s1.sock --fleet     # sharded fleet

Connects to one or more crispy-daemons (comma-separated unix paths or
host:port addresses, token auth via --auth-token /
$CRISPY_DAEMON_TOKEN), pulls every trace source it can reach, stitches
them into cross-process trees, and prints:

  * the stitched trees (indented; per-span wall ms, attrs, [source]),
    newest last — or one tree with `--trace <id>`;
  * a slowest-span table (`--slowest N`) across every stitched tree,
    the "where did the time go" answer sorted by self-time;
  * with `--fleet`, the aggregated fleet metrics snapshot, a per-shard
    `daemon.op.*` heat table (shard-qualified daemon sources, so
    hot-shard skew is visible at a glance) and any histogram exemplars,
    each linking a bucket to a trace id that can be fed straight back
    into `--trace`.

Trace sources, all merged under their source labels:

  1. each daemon's OWN ring, over the `traces` wire op (`daemon.op.*`
     spans adopted from traced callers), labeled by the daemon's
     shard-qualified source ("crispy-daemon@shard-0" under
     --shard-name, plain "crispy-daemon" otherwise);
  2. every forest published into the backends' `__traces__` namespaces
     by service-side `TelemetryPublisher(ring=...)` / `publish_traces`.

`--expect-cross-process` exits non-zero unless at least one stitched
tree contains spans from two or more sources — the CI assertion that
trace propagation over the live wire actually works.

Everything here is read-only against the daemon; `main(argv)` returns
an exit code and prints to stdout, so tests drive it in-process.

A copy of the JAX package's ``repro/telemetry/trace_tool.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from repro_torch.telemetry.export import (aggregate_fleet, fleet_snapshot,
                                    fleet_traces, shard_heat,
                                    stitch_fleet_traces)

DAEMON_SOURCE = "crispy-daemon"


def collect_fleet(backend) -> Dict[str, List[Dict]]:
    """Every reachable trace forest: published `__traces__` rows plus
    the daemon's own ring (daemon wins its label on conflict — its ring
    is fresher than anything it published). The daemon's label is its
    shard-qualified source when it announces one (a --shard-name fleet
    member), the historical DAEMON_SOURCE otherwise."""
    fleet = dict(fleet_traces(backend))
    traces_op = getattr(backend, "traces", None)
    if callable(traces_op):
        try:
            try:
                source, roots = traces_op(with_source=True)
            except TypeError:       # pre-sharding DaemonBackend
                source, roots = DAEMON_SOURCE, traces_op()
            fleet[source] = roots
        except Exception:
            pass                    # daemon without the op: published only
    return fleet


def collect_fleet_metrics(backend) -> Dict[str, Dict]:
    """Every reachable metrics snapshot: published `__telemetry__` rows
    plus the daemon's own live registry over the `metrics` wire op
    (shard-qualified label, same rule as `collect_fleet`)."""
    fleet = dict(fleet_snapshot(backend))
    metrics_op = getattr(backend, "metrics", None)
    if callable(metrics_op):
        try:
            try:
                source, snap = metrics_op(with_source=True)
            except TypeError:       # pre-sharding DaemonBackend
                source, snap = DAEMON_SOURCE, metrics_op()
            fleet[source] = {"ts": None, "metrics": snap}
        except Exception:
            pass
    return fleet


def _walk(span_dict: Dict, depth: int = 0):
    yield depth, span_dict
    for child in span_dict.get("children", ()):
        yield from _walk(child, depth + 1)


def self_seconds(span_dict: Dict) -> float:
    """Wall seconds not accounted for by children — the span's own
    time. Children may overlap (concurrent ladder points), so this is
    clamped at zero rather than pretending overlap is negative work."""
    child_wall = sum(c.get("wall_s", 0.0)
                     for c in span_dict.get("children", ()))
    return max(0.0, span_dict.get("wall_s", 0.0) - child_wall)


def render_trace(root: Dict) -> str:
    """One stitched tree as indented text."""
    lines = [f"trace {root.get('trace_id')}"]
    for depth, s in _walk(root):
        attrs = s.get("attrs") or {}
        attr_txt = ("  " + " ".join(f"{k}={v}" for k, v in attrs.items())
                    if attrs else "")
        lines.append(
            f"  {'  ' * depth}{s.get('name')}  "
            f"{s.get('wall_s', 0.0) * 1e3:9.3f} ms  "
            f"[{s.get('source', '?')}]{attr_txt}")
    return "\n".join(lines)


def slowest_spans(trees: List[Dict], n: int) -> List[Dict]:
    rows = []
    for root in trees:
        for _depth, s in _walk(root):
            rows.append({"name": s.get("name"),
                         "source": s.get("source", "?"),
                         "trace_id": s.get("trace_id"),
                         "wall_s": s.get("wall_s", 0.0),
                         "self_s": self_seconds(s)})
    rows.sort(key=lambda r: r["self_s"], reverse=True)
    return rows[:n]


def render_slowest(rows: List[Dict]) -> str:
    lines = ["slowest spans (by self time):",
             f"  {'self ms':>10}  {'total ms':>10}  "
             f"{'span':<28} {'source':<16} trace"]
    for r in rows:
        lines.append(f"  {r['self_s'] * 1e3:10.3f}  "
                     f"{r['wall_s'] * 1e3:10.3f}  "
                     f"{r['name']:<28} {r['source']:<16} {r['trace_id']}")
    return "\n".join(lines)


def cross_process_trees(trees: List[Dict]) -> List[Dict]:
    out = []
    for root in trees:
        sources = {s.get("source") for _d, s in _walk(root)}
        if len(sources) > 1:
            out.append(root)
    return out


def _exemplar_rows(metrics: Dict) -> List[Dict]:
    rows = []
    for name, h in sorted(metrics.get("histograms", {}).items()):
        for ex in h.get("exemplars", []):
            rows.append({"histogram": name, "le": ex.get("le"),
                         "value": ex.get("value"),
                         "trace_id": ex.get("trace_id")})
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.trace_tool",
        description="Pull + stitch distributed traces from a "
                    "crispy-daemon fleet (see module docstring).")
    ap.add_argument("--daemon", required=True, metavar="ADDR[,ADDR...]",
                    help="daemon address: unix socket path or host:port; "
                         "comma-separate several to pull a sharded fleet")
    ap.add_argument("--auth-token", default=None,
                    help="shared daemon token "
                         "(default: $CRISPY_DAEMON_TOKEN)")
    ap.add_argument("--timeout", type=float, default=10.0, metavar="S",
                    help="socket timeout in seconds")
    ap.add_argument("--trace", default=None, metavar="ID",
                    help="print only the stitched tree with this trace id")
    ap.add_argument("--slowest", type=int, default=0, metavar="N",
                    help="also print the N slowest spans by self time")
    ap.add_argument("--fleet", action="store_true",
                    help="also print aggregated fleet metrics, per-shard "
                         "daemon op heat, and exemplars")
    ap.add_argument("--json", action="store_true",
                    help="machine form: one JSON object instead of text")
    ap.add_argument("--expect-cross-process", action="store_true",
                    help="exit 1 unless some stitched tree spans >= 2 "
                         "sources (CI assertion)")
    args = ap.parse_args(argv)

    # deferred import: repro_torch.state imports repro_torch.telemetry
    from repro_torch.state.daemon import DaemonBackend

    addresses = [a.strip() for a in args.daemon.split(",") if a.strip()]
    fleet: Dict[str, List[Dict]] = {}
    metrics_by_source: Dict[str, Dict] = {}
    for address in addresses:
        with DaemonBackend(address, timeout_s=args.timeout,
                           auth_token=args.auth_token) as backend:
            # merge across daemons: each shard contributes its own ring
            # under its shard-qualified label, plus whatever was
            # published into the namespaces IT owns on the hash ring
            fleet.update(collect_fleet(backend))
            if args.fleet:
                metrics_by_source.update(collect_fleet_metrics(backend))
    trees = stitch_fleet_traces(fleet)
    if args.trace:
        trees = [t for t in trees if t.get("trace_id") == args.trace]
    fleet_metrics = heat = None
    if args.fleet:
        fleet_metrics = aggregate_fleet(metrics_by_source)
        heat = shard_heat(metrics_by_source)

    crossed = cross_process_trees(trees)

    if args.json:
        out = {"sources": sorted(fleet), "traces": trees,
               "cross_process_traces": len(crossed)}
        if args.slowest:
            out["slowest"] = slowest_spans(trees, args.slowest)
        if fleet_metrics is not None:
            out["fleet"] = fleet_metrics
            out["shard_heat"] = heat
            out["exemplars"] = _exemplar_rows(fleet_metrics)
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        print(f"sources: {', '.join(sorted(fleet)) or '(none)'}")
        print(f"stitched traces: {len(trees)} "
              f"({len(crossed)} cross-process)")
        for root in trees:
            print()
            print(render_trace(root))
        if args.slowest:
            print()
            print(render_slowest(slowest_spans(trees, args.slowest)))
        if fleet_metrics is not None:
            print()
            rows = _exemplar_rows(fleet_metrics)
            print(f"fleet sources: "
                  f"{', '.join(fleet_metrics.get('sources', []))}")
            if heat:
                print("per-shard daemon op heat:")
                for source in sorted(heat):
                    entry = heat[source]
                    ops = " ".join(f"{op}={n}" for op, n in
                                   entry["ops"].items())
                    print(f"  {source:<28} total={entry['total']:<8} {ops}")
            print(f"exemplars: {len(rows)}")
            for r in rows:
                print(f"  {r['histogram']} le={r['le']} "
                      f"value={r['value']:g} trace={r['trace_id']}")

    if args.expect_cross_process and not crossed:
        print("FAIL: no stitched trace spans more than one source",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
