"""The serving demos of ``examples/serve_demo.py`` through the PyTorch port
alone, run in its order by ``main``:

- ``demo_allocation``: concurrent allocation requests against the
  service's endpoint, a mix of novel and repeated jobs; the repeats are
  answered from the model registry without profiling.
- ``demo_shared_state``: two allocation services share one crispy-daemon
  (``repro_torch.state``). Service A reaches it over a unix socket,
  service B over loopback TCP. Profile points, confident models and ONE
  profiling envelope are common property, so B answers A's jobs without a
  fresh profile run and without charging the envelope again. A compaction
  pass then folds the shared profile log, and the stitched traces show
  each request's spans in the service and in the daemon under one trace
  id.
- ``demo``: continuous batching over a fixed-slot cache with staggered
  arrivals, of the reduced deepseek-7b (a KV cache) and rwkv6-7b (an O(1)
  recurrent state), half the requests greedy and half sampled.

  PYTHONPATH=src python examples/serve_demo_torch.py                # the GPU
  PYTHONPATH=src python examples/serve_demo_torch.py --device cpu

The allocation plane needs no GPU: the jobs are the simulator's. The
engine demos run on the GPU unless given ``--device cpu``. In production
the daemon is its own process:

  PYTHONPATH=src python -m repro_torch.state.daemon \\
      --socket /tmp/crispy.sock --listen 127.0.0.1:7421 --root ./crispy-state
  PYTHONPATH=src python -m repro_torch.state.daemon --socket /tmp/crispy.sock --ping
  PYTHONPATH=src python -m repro_torch.telemetry.trace_tool \\
      --daemon /tmp/crispy.sock --slowest 5 --expect-cross-process
  PYTHONPATH=src python -m repro_torch.state.daemon --socket /tmp/crispy.sock --shutdown

Here the daemon runs in-process (``CrispyDaemon(...)`` in a ``with``
block); everything else is the same.
"""
import argparse
import os
import tempfile
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.allocator import AllocationService
from repro_torch.configs import RunConfig, get_arch
from repro_torch.core.catalog import aws_like_catalog
from repro_torch.core.simulator import (GiB, build_history, make_profile_fn,
                                        scout_like_jobs)
from repro_torch.models.model import build_model
from repro_torch.profiling import ProfilingBudget
from repro_torch.serve.engine import AllocationEndpoint, Request, ServeEngine
from repro_torch.state import HAS_UNIX_SOCKETS, CrispyDaemon, DaemonBackend
from repro_torch.telemetry import publish_traces, stitch_fleet_traces
from repro_torch.telemetry.trace_tool import (collect_fleet,
                                              cross_process_trees,
                                              render_trace)


RUN = RunConfig(attn_impl="full", remat="nothing", compute_dtype="float32")


def allocation_mix(jobs, n_requests: int):
    """Half the corpus, twice over: the second visit of each signature is a
    registry (or LRU) hit, not a fresh profiling ladder."""
    return [jobs[i % (len(jobs) // 2)] for i in range(n_requests)]


def demo_allocation(n_requests: int = 16, workers: int = 8):
    """Concurrent allocation traffic against the service endpoint -> the
    wire answers, in request order."""
    jobs = scout_like_jobs()
    catalog = aws_like_catalog()
    history = build_history(jobs, catalog)
    with AllocationService(catalog, history) as svc:
        endpoint = AllocationEndpoint(svc)
        t0 = time.monotonic()

        def one(j):
            return endpoint.handle(job=j.name, profile_at=make_profile_fn(j),
                                   full_size=j.dataset_gib * GiB,
                                   anchor=j.dataset_gib * GiB * 0.01)

        with ThreadPoolExecutor(workers) as ex:
            answers = list(ex.map(one, allocation_mix(jobs, n_requests)))
        wall = time.monotonic() - t0
        by_source = {}
        for a in answers:
            by_source[a["source"]] = by_source.get(a["source"], 0) + 1
        s = svc.stats
        print(f"allocation: {len(answers)} requests in {wall:.2f}s "
              f"({len(answers) / wall:.0f} req/s); sources {by_source}; "
              f"profile calls {s.profile_calls}, registry hits "
              f"{s.registry_hits}, LRU hit-rate {s.profile_hit_rate:.0%}")
        a = answers[0]
        print(f"  e.g. {a['job']}: {a['requirement_gib']:.0f} GiB via "
              f"{a['candidate']} -> {a['config']} "
              f"(${a['usd_per_hour']:.2f}/h, source={a['source']})")
        m = endpoint.metrics()["metrics"]
        req_h = m["histograms"].get("service.request.seconds", {})
        print(f"  telemetry: request p50 {req_h.get('p50', 0) * 1e3:.1f}ms "
              f"p99 {req_h.get('p99', 0) * 1e3:.1f}ms over "
              f"{req_h.get('count', 0)} requests; warm hits "
              f"{m['counters'].get('pipeline.warm_start.hits', 0):.0f}, "
              f"fresh profiles "
              f"{m['counters'].get('acquisition.fresh', 0):.0f}")
    return answers


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


def demo_requests(n_requests: int = 12):
    """Staggered requests: odd ids greedy, even ids sampled at 0.8."""
    return [Request(rid, prompt=[rid % 17 + 1, 5, 9], max_new_tokens=16,
                    temperature=0.0 if rid % 2 else 0.8)
            for rid in range(n_requests)]


def demo(arch: str, n_requests: int = 12, slots: int = 4, device=None,
         model=None):
    """The reduced `arch` (weights from seed 0 on `device`, None the GPU;
    or `model`) serving `n_requests` on `slots` slots -> the finished
    requests by id."""
    if model is None:
        model = build_model(get_arch(arch).reduced(), RUN, device=device,
                            seed=0)
    engine = ServeEngine(model, slots=slots, max_len=64)
    t0 = time.monotonic()
    for req in demo_requests(n_requests):
        engine.submit(req)
    done = sorted(engine.run(), key=lambda r: r.rid)
    wall = time.monotonic() - t0
    lat = [r.finished_at - r.submitted_at for r in done]
    toks = sum(len(r.out_tokens) for r in done)
    print(f"{arch} ({model.device}): served {len(done)} requests / {toks} "
          f"tokens in {wall:.2f}s ({toks / wall:.1f} tok/s aggregate, "
          f"{slots} slots); mean latency {sum(lat) / len(lat):.2f}s")
    print(f"  e.g. request 0: {done[0].prompt} -> {done[0].out_tokens}")
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the engine demos' device: cuda (the default) or "
                         "cpu")
    args = ap.parse_args(argv)
    demo_allocation()
    reprofiled = demo_shared_state()
    demo("deepseek-7b", device=args.device)
    demo("rwkv6-7b", device=args.device)
    return 1 if reprofiled else 0


if __name__ == "__main__":
    raise SystemExit(main())
