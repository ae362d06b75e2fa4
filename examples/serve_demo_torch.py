"""The shared-state demo through the PyTorch port alone: two allocation
services share one crispy-daemon (``repro_torch.state``). Service A reaches
it over a unix socket, service B over loopback TCP. Profile points,
confident models and ONE profiling envelope are common property, so B
answers A's jobs without a fresh profile run and without charging the
envelope again. A compaction pass then folds the shared profile log, and
the stitched traces show each request's spans in the service and in the
daemon under one trace id.

  PYTHONPATH=src python examples/serve_demo_torch.py

The allocation plane needs no GPU: the jobs are the simulator's. In
production the daemon is its own process:

  PYTHONPATH=src python -m repro_torch.state.daemon \\
      --socket /tmp/crispy.sock --listen 127.0.0.1:7421 --root ./crispy-state
  PYTHONPATH=src python -m repro_torch.state.daemon --socket /tmp/crispy.sock --ping
  PYTHONPATH=src python -m repro_torch.telemetry.trace_tool \\
      --daemon /tmp/crispy.sock --slowest 5 --expect-cross-process
  PYTHONPATH=src python -m repro_torch.state.daemon --socket /tmp/crispy.sock --shutdown

Here the daemon runs in-process (``CrispyDaemon(...)`` in a ``with``
block); everything else is the same.
"""
import os
import tempfile
import textwrap

from repro_torch.allocator import AllocationService
from repro_torch.core.catalog import aws_like_catalog
from repro_torch.core.simulator import (GiB, build_history, make_profile_fn,
                                        scout_like_jobs)
from repro_torch.profiling import ProfilingBudget
from repro_torch.serve.engine import AllocationEndpoint
from repro_torch.state import HAS_UNIX_SOCKETS, CrispyDaemon, DaemonBackend
from repro_torch.telemetry import publish_traces, stitch_fleet_traces
from repro_torch.telemetry.trace_tool import (collect_fleet,
                                              cross_process_trees,
                                              render_trace)


def demo_shared_state(n_jobs: int = 8) -> int:
    """Service A then service B over one daemon; returns B's fresh
    profiles (0 when the state plane works)."""
    if not HAS_UNIX_SOCKETS:
        raise SystemExit("shared state needs unix-domain sockets")
    jobs = scout_like_jobs()[:n_jobs]
    catalog = aws_like_catalog()
    history = build_history(jobs, catalog)
    tmp = tempfile.mkdtemp(prefix="crispy-demo-")
    sock = os.path.join(tmp, "crispy.sock")
    with CrispyDaemon(sock, root=os.path.join(tmp, "state"),
                      listen="127.0.0.1:0") as daemon:
        def serve_all(tag, address):
            with DaemonBackend(address) as backend:
                budget = ProfilingBudget(charge_s=600.0 * len(jobs),
                                         backend=backend)
                with AllocationService(catalog, history, backend=backend,
                                       adaptive=True, budget=budget) as svc:
                    for j in jobs:
                        full = j.dataset_gib * GiB
                        AllocationEndpoint(svc).handle(
                            job=j.name, profile_at=make_profile_fn(j),
                            full_size=full, anchor=full * 0.01)
                    s, snap = svc.stats, budget.snapshot()
                    print(f"  service {tag} [{svc.backend_kind} via "
                          f"{svc.backend_transport}:{svc.backend_address}]: "
                          f"{s.profile_calls} fresh profiles, "
                          f"{s.registry_hits} registry hits, "
                          f"{s.store_hits} store hits; shared envelope "
                          f"{snap['charged_s']:.0f}/{snap['charge_s']:.0f}s "
                          f"charged")
                    return s.profile_calls
        first = serve_all("A", sock)
        second = serve_all("B", daemon.tcp_address)
        print(f"shared state: service B re-profiled {second} points after "
              f"A spent {first}")
        with DaemonBackend(sock) as admin:
            stats = admin.compact("profiles")
            print(f"  compaction: profile log {stats['before']} -> "
                  f"{stats['after']} rows")
            dm = admin.metrics()
            publish_traces(admin, "serve-demo-torch")
            trees = stitch_fleet_traces(collect_fleet(admin))
        ops = {n.split(".")[2]: h["count"] for n, h in dm["histograms"].items()
               if n.startswith("daemon.op.")}
        print(f"  daemon: {dm['counters']['daemon.frames']:.0f} frames; "
              f"ops {dict(sorted(ops.items()))}")
    crossed = cross_process_trees(trees)
    print(f"  tracing: {len(trees)} stitched traces, {len(crossed)} "
          f"cross-process; last one:")
    if crossed:
        print(textwrap.indent(render_trace(crossed[-1]), "  "))
    return second


if __name__ == "__main__":
    raise SystemExit(1 if demo_shared_state() else 0)
