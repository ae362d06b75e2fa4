"""The allocation plane of the port against the JAX package, on the CPU:
the simulator and the local dataflow jobs give the reference's numbers, the
model zoos pick the reference's candidates and requirements, and every
``scout_like_jobs()`` request through ``AllocationEndpoint.handle`` gives
the reference's wire answer field for field (but ``wall_s`` and
``trace_id``), under the three objectives, the fixed ladder and both
adaptive placements, with tags, and the same ``stats()``, counters and
spans. Over ``backend=`` (memory, file, a crispy-daemon) the service
gives the reference's answers, ``stats()`` and backend rows; two services
over one daemon profile nothing twice and never over-grant one envelope;
``trace_tool`` stitches a request across the service and the daemon.
Within the port, ``CrispyAllocator`` answers as the service does;
``ServeEngine`` answers allocation requests beside generation, from
threads while it serves.

Every service here is closed (``with``), and no future is waited on without
a timeout: a worker thread left alive would hold the test process."""
import contextlib
import dataclasses
import json
import math
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

import repro.profiling as JP
import repro.state as JState
from repro.allocator import AllocationService as JService
from repro.allocator import fit_runtime_zoo as j_fit_runtime_zoo
from repro.allocator import fit_zoo as j_fit_zoo
from repro.core import local_jobs as JL
from repro.core import simulator as JS
from repro.core.catalog import aws_like_catalog as j_aws_like_catalog
from repro.serve.engine import AllocationEndpoint as JEndpoint
from repro.telemetry import default_ring as j_default_ring

import repro_torch.profiling as TP
import repro_torch.state as TState
from repro_torch.allocator import (AllocationRequest, AllocationService,
                                   fit_runtime_zoo, fit_zoo, zoo_fitter)
from repro_torch.configs import RunConfig, get_arch
from repro_torch.core import local_jobs as TL
from repro_torch.core import simulator as TS
from repro_torch.core.catalog import aws_like_catalog, gpu_catalog
from repro_torch.core.crispy import CrispyAllocator
from repro_torch.core.hbm_planner import GPU_OVERHEAD_GIB, HBMPlanner
from repro_torch.core.history import ExecutionHistory
from repro_torch.core.memory_model import fit_memory_model
from repro_torch.core.profiler import ProfileResult, RSSProfiler
from repro_torch.models.model import build_model
from repro_torch.serve.engine import AllocationEndpoint, Request, ServeEngine
from repro_torch.telemetry import default_ring

GiB = 1024 ** 3
SIZES = [2e9, 4e9, 6e9, 8e9, 1e10]
TIMEOUT = 60.0
MODES = {"fixed": {}, "ladder": {"adaptive": True, "placement": "ladder"},
         "infogain": {"adaptive": True, "placement": "infogain"}}
OBJECTIVES = ("cheapest_fit", "min_cost", "min_runtime")


def strip(wire):
    return {k: v for k, v in wire.items() if k not in ("wall_s", "trace_id")}


def payload(sim, job, seed=0, **extra):
    """The request a client sends for `job`, with `sim`'s (the port's or
    the reference's) profile function: the paper's 1 % anchor."""
    full = job.dataset_gib * GiB
    return dict(job=job.name, profile_at=sim.make_profile_fn(job, seed),
                full_size=full, anchor=full * 0.01, **extra)


# ---------------------------------------------------------------------------
# the simulator, the local jobs, the zoos
# ---------------------------------------------------------------------------


def test_simulator_gives_the_references_numbers():
    jj, tj = JS.scout_like_jobs(), TS.scout_like_jobs()
    assert [dataclasses.astuple(j) for j in jj] == \
        [dataclasses.astuple(t) for t in tj]
    jc, tc = j_aws_like_catalog(), aws_like_catalog()
    assert [(c.name, c.total_mem_gib, c.total_cores, c.usd_per_hour)
            for c in jc] == [(c.name, c.total_mem_gib, c.total_cores,
                              c.usd_per_hour) for c in tc]
    for j, t in zip(jj, tj):
        for c1, c2 in zip(jc, tc):
            assert JS.runtime_s(j, c1) == TS.runtime_s(t, c2)
            assert JS.cost_usd(j, c1) == TS.cost_usd(t, c2)
        for seed in (0, 1):
            jf, tf = JS.make_profile_fn(j, seed), TS.make_profile_fn(t, seed)
            for size in SIZES + [j.dataset_gib * GiB * 0.01]:
                a, b = jf(size), tf(size)
                assert (a.size, a.peak_mem_bytes, a.base_mem_bytes,
                        a.wall_s) == (b.size, b.peak_mem_bytes,
                                      b.base_mem_bytes, b.wall_s)
                assert a.job_mem_bytes == b.job_mem_bytes
    jh, th = JS.build_history(), TS.build_history()
    assert jh.jobs() == th.jobs()
    for name in jh.jobs():
        assert jh.normalized_costs(name) == th.normalized_costs(name)
        assert jh.best_config_name(name) == th.best_config_name(name)
    assert jh.bfa_scores() == th.bfa_scores()


@pytest.mark.parametrize("name", sorted(JL.LOCAL_JOBS))
def test_local_jobs_compute_the_references_results(name):
    assert sorted(TL.LOCAL_JOBS) == sorted(JL.LOCAL_JOBS)
    want = JL.LOCAL_JOBS[name](1 << 16)()
    got = TL.LOCAL_JOBS[name](1 << 16)()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_rss_profiler_reads_a_local_job():
    r = RSSProfiler().profile(TL.LOCAL_JOBS["sort"](1 << 22), 1 << 22)
    assert r.peak_mem_bytes >= r.base_mem_bytes > 0 and r.wall_s > 0


def _memory_cases():
    rng3, rng0 = np.random.default_rng(3), np.random.default_rng(0)
    nan = [0.9 * s + 1.6e9 for s in SIZES]
    nan[2] = float("nan")
    return {
        "linear": [0.9 * s + 1.6e9 for s in SIZES],
        "powerlaw": [3.0e-4 * s ** 1.35 for s in SIZES],
        "loglinear": [2e9 * math.log(s) + 1e9 for s in SIZES],
        "piecewise": [0.1 * s + 1e9 if s <= 6e9 else 2.0 * s - 1.04e10
                      for s in SIZES],
        "noisy": [s * (1 + rng3.normal(0, 0.09)) for s in SIZES],
        "near_linear": [(4.5 * s) * (1 + rng0.normal(0, 0.002))
                        for s in SIZES],
        "nan": nan,
        "one_finite": [math.nan, math.inf, -math.inf, math.nan, 3e9],
    }


def _runtime_cases():
    rng3, rng7 = np.random.default_rng(3), np.random.default_rng(7)
    inf = [20.0 + 4e-8 * s for s in SIZES]
    inf[0] = math.inf
    return {
        "linear": [20.0 + 4e-8 * s for s in SIZES],
        "superlinear": [1e-11 * s ** 1.35 for s in SIZES],
        "mild_noise": [(20.0 + 4e-8 * s) * (1 + rng3.normal(0, 0.06))
                       for s in SIZES],
        "noisy": [abs(10.0 * (1 + rng7.normal(0, 0.6))) for _ in SIZES],
        "inf": inf,
    }


@pytest.mark.parametrize("case", sorted(_memory_cases()))
def test_fit_zoo_picks_the_references_candidate(case):
    mems = _memory_cases()[case]
    want, got = j_fit_zoo(SIZES, mems), fit_zoo(SIZES, mems)
    assert (got.candidate, got.confident, got.n) == \
        (want.candidate, want.confident, want.n)
    for full, leeway in ((1e12, 0.0), (5e11, 0.05)):
        assert got.requirement(full, leeway) == want.requirement(full, leeway)
        assert got.predict(full) == want.predict(full)


@pytest.mark.parametrize("case", sorted(_runtime_cases()))
def test_fit_runtime_zoo_picks_the_references_candidate(case):
    walls = _runtime_cases()[case]
    want = j_fit_runtime_zoo(SIZES, walls)
    got = fit_runtime_zoo(SIZES, walls)
    assert (got.candidate, got.confident) == (want.candidate, want.confident)
    assert got.predict(5e11) == want.predict(5e11)


# ---------------------------------------------------------------------------
# the endpoint, against the reference's
# ---------------------------------------------------------------------------


def _traffic(sim, objective, mode):
    """Every scout job once (every other one tagged), then the first four
    again: fresh plans, classifier and baseline fallbacks, registry and
    plan-cache hits."""
    jobs = sim.scout_like_jobs()
    extra = dict(MODES[mode], objective=objective)
    reqs = [payload(sim, j, **extra,
                    **({"tags": [j.framework, j.mem_profile]} if i % 2 else {}))
            for i, j in enumerate(jobs)]
    return reqs + reqs[:4]


def _serve(service_cls, endpoint_cls, sim, catalog, objective, mode):
    with service_cls(catalog, sim.build_history()) as svc:
        ep = endpoint_cls(svc)
        wires = [strip(ep.handle(timeout=TIMEOUT, **r))
                 for r in _traffic(sim, objective, mode)]
        snap = svc.metrics()
        return wires, ep.stats(), snap


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_endpoint_wire_answers_equal_the_references(objective, mode):
    want, want_stats, want_snap = _serve(JService, JEndpoint, JS,
                                         j_aws_like_catalog(), objective, mode)
    got, got_stats, got_snap = _serve(AllocationService, AllocationEndpoint,
                                      TS, aws_like_catalog(), objective, mode)
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert g == w, g["job"]
    assert got_stats == want_stats
    assert got_stats["registry_hits"] + got_stats["plan_cache_hits"] >= 4
    # the telemetry copy counts what the reference counts
    assert got_snap["counters"] == want_snap["counters"]
    assert {n: h["count"] for n, h in got_snap["histograms"].items()} == \
        {n: h["count"] for n, h in want_snap["histograms"].items()}
    sources = {w["source"] for w in got}
    assert {"zoo", "registry"} <= sources
    assert sources & {"classifier", "baseline"}


def _span_names(ring, trace_id):
    names = []

    def walk(s):
        if s.trace_id == trace_id:
            names.append(s.name)
        for c in s.children:
            walk(c)
    for root in ring.traces():
        walk(root)
    return sorted(names)


def test_a_traced_request_records_the_references_spans():
    """A caller's trace token joins the endpoint's, the service worker's
    and the pipeline's spans under one trace id, in both packages."""
    token = {"trace_id": "feedfacecafe0001", "span_id": "00000000000000aa"}
    job = TS.scout_like_jobs()[2]
    with JService(j_aws_like_catalog(), JS.build_history()) as svc:
        want = JEndpoint(svc).handle(timeout=TIMEOUT, trace=token,
                                     **payload(JS, JS.scout_like_jobs()[2]))
    with AllocationService(aws_like_catalog(), TS.build_history()) as svc:
        got = AllocationEndpoint(svc).handle(timeout=TIMEOUT, trace=token,
                                             **payload(TS, job))
    assert got["trace_id"] == want["trace_id"] == token["trace_id"]
    names = _span_names(default_ring(), token["trace_id"])
    assert names == _span_names(j_default_ring(), token["trace_id"])
    assert {"endpoint.request", "service.plan", "service.respond",
            "pipeline.acquire"} <= set(names)


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("job_index", [0, 2, 6, 10])   # linear x2, noisy, flat
def test_crispy_allocator_answers_as_the_service_does(job_index):
    job = TS.scout_like_jobs()[job_index]
    catalog, history = aws_like_catalog(), TS.build_history()
    req = payload(TS, job)
    with AllocationService(catalog, history) as svc:
        resp = svc.allocate(AllocationRequest(**req), timeout=TIMEOUT)
    rep = CrispyAllocator(catalog, history, fitter=zoo_fitter()).allocate(
        req["job"], req["profile_at"], req["full_size"], anchor=req["anchor"])
    assert rep.requirement_gib == resp.requirement_gib
    s1, s2 = rep.selection, resp.selection
    assert (s1.config.name, s1.method, s1.mem_requirement_gib,
            s1.feasible_count, s1.fell_back) == \
        (s2.config.name, s2.method, s2.mem_requirement_gib,
         s2.feasible_count, s2.fell_back)


# ---------------------------------------------------------------------------
# over the shared state plane, against the reference's
# ---------------------------------------------------------------------------


def _short_socket() -> str:
    # AF_UNIX paths are length-limited (~108 bytes): not under tmp_path
    return os.path.join(tempfile.mkdtemp(prefix="crispyd-"), "d.sock")


@contextlib.contextmanager
def _state_backend(pkg, kind, tmp_path):
    """A `pkg.state` backend of `kind`; a daemon is in-process, on a unix
    socket, and stopped on exit."""
    if kind == "memory":
        yield pkg.InMemoryBackend()
    elif kind == "file":
        yield pkg.FileBackend(str(tmp_path / f"{pkg.__name__}-state"))
    else:
        sock = _short_socket()
        with pkg.CrispyDaemon(sock), pkg.DaemonBackend(sock) as backend:
            yield backend


def _untimed(value):
    """`value` without the fields that hold a time or a local address."""
    if isinstance(value, dict):
        return {k: _untimed(v) for k, v in value.items()
                if k not in ("ts", "created_at", "started_at", "elapsed_s",
                             "wall_s", "backend_address")}
    if isinstance(value, (list, tuple)):
        return [_untimed(v) for v in value]
    return value


def _rows(backend):
    return {"logs": {ns: backend.read(ns)[0]
                     for ns in sorted(backend.log_namespaces())},
            "docs": sorted((ns, key, value, version) for ns, key, value, version
                           in backend.doc_snapshot())}


def _serve_over(service_cls, endpoint_cls, sim, catalog, backend, P):
    with service_cls(catalog, sim.build_history(), backend=backend,
                     adaptive=True,
                     budget=P.ProfilingBudget(charge_s=6000.0,
                                              backend=backend)) as svc:
        ep = endpoint_cls(svc)
        wires = [strip(ep.handle(timeout=TIMEOUT, **r))
                 for r in _traffic(sim, "cheapest_fit", "infogain")]
        stats = ep.stats()
    return wires, stats


@pytest.mark.parametrize("kind", ["memory", "file", "daemon"])
def test_the_service_over_a_backend_answers_as_the_references(kind, tmp_path):
    """Every scout job over `backend=` (and a shared budget over it): the
    wire answers, ``stats()`` and the rows and documents left on the
    backend are the reference's, times and addresses aside."""
    with _state_backend(JState, kind, tmp_path) as jb:
        want, want_stats = _serve_over(JService, JEndpoint, JS,
                                       j_aws_like_catalog(), jb, JP)
        # a daemon's rows: test_the_daemons_rows_are_the_references
        want_rows = _rows(jb) if kind != "daemon" else None
    with _state_backend(TState, kind, tmp_path) as tb:
        got, got_stats = _serve_over(AllocationService, AllocationEndpoint,
                                     TS, aws_like_catalog(), tb, TP)
        got_rows = _rows(tb) if kind != "daemon" else None
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert g == w, g["job"]
    assert _untimed(got_stats) == _untimed(want_stats)
    assert got_stats["backend"] == (kind if kind != "daemon" else "daemon")
    assert got_stats["backend_transport"] == \
        ("unix" if kind == "daemon" else None)
    assert got_stats["profile_calls"] > 0 and got_stats["registry_hits"] > 0
    if got_rows is not None:
        assert _untimed(got_rows) == _untimed(want_rows)
        assert {"profiles", "registry", "budget"} <= \
            set(got_rows["logs"]) | {ns for ns, *_ in got_rows["docs"]}


def test_the_daemons_rows_are_the_references(tmp_path):
    """The same traffic through each package's daemon, with `root=`: the
    directories the two daemons leave hold the same rows and documents."""
    dirs = {}
    for pkg, svc_cls, ep_cls, sim, catalog, P in (
            (JState, JService, JEndpoint, JS, j_aws_like_catalog(), JP),
            (TState, AllocationService, AllocationEndpoint, TS,
             aws_like_catalog(), TP)):
        sock, root = _short_socket(), str(tmp_path / pkg.__name__)
        with pkg.CrispyDaemon(sock, root=root), \
                pkg.DaemonBackend(sock) as backend:
            _serve_over(svc_cls, ep_cls, sim, catalog, backend, P)
        dirs[pkg] = _rows(pkg.FileBackend(root))
    assert _untimed(dirs[TState]) == _untimed(dirs[JState])
    assert dirs[TState]["logs"]["profiles"]


def _shared_state_demo(pkg, svc_cls, ep_cls, sim, catalog, P, n_jobs=8):
    """The reference's demo_shared_state (examples/serve_demo.py): service
    A over the unix socket, then service B over loopback TCP, one daemon,
    one budget envelope."""
    jobs = sim.scout_like_jobs()[:n_jobs]
    history = sim.build_history(jobs, catalog)
    out = []
    sock = _short_socket()
    with pkg.CrispyDaemon(sock, listen="127.0.0.1:0") as daemon:
        for address in (sock, daemon.tcp_address):
            with pkg.DaemonBackend(address) as backend:
                budget = P.ProfilingBudget(charge_s=600.0 * len(jobs),
                                           backend=backend)
                with svc_cls(catalog, history, backend=backend,
                             adaptive=True, budget=budget) as svc:
                    ep = ep_cls(svc)
                    wires = [strip(ep.handle(
                        timeout=TIMEOUT, job=j.name,
                        profile_at=sim.make_profile_fn(j),
                        full_size=j.dataset_gib * GiB,
                        anchor=j.dataset_gib * GiB * 0.01)) for j in jobs]
                    out.append((wires, _untimed(ep.stats())))
    return out


def test_two_services_over_one_daemon_profile_nothing_twice():
    want = _shared_state_demo(JState, JService, JEndpoint, JS,
                              j_aws_like_catalog(), JP)
    got = _shared_state_demo(TState, AllocationService, AllocationEndpoint,
                             TS, aws_like_catalog(), TP)
    assert got == want
    (a_wires, a), (b_wires, b) = got
    assert a["profile_calls"] > 0 and b["profile_calls"] == 0
    assert b["registry_hits"] + b["store_hits"] >= len(b_wires)
    assert (a["backend_transport"], b["backend_transport"]) == ("unix", "tcp")
    # B charged the shared envelope nothing
    assert b["budget"]["charged_s"] == a["budget"]["charged_s"] > 0
    assert b["budget"]["points_spent"] == a["budget"]["points_spent"]
    # a model A fitted answers B from the shared registry
    zoo = [(aw, bw) for aw, bw in zip(a_wires, b_wires)
           if aw["source"] == "zoo"]
    assert zoo
    for aw, bw in zoo:
        assert bw["source"] == "registry"
        assert (bw["requirement_gib"], bw["config"]) == \
            (aw["requirement_gib"], aw["config"])


def test_a_shared_envelope_is_never_over_granted_across_two_services():
    """Two services over one daemon spend one envelope of LIMIT points
    from 8 threads: the fresh profiles of both add up to the envelope's
    count, which never passes LIMIT, and the rest are denied."""
    limit = 17
    jobs = TS.scout_like_jobs()
    catalog = aws_like_catalog()
    sock = _short_socket()
    with TState.CrispyDaemon(sock, listen="127.0.0.1:0") as daemon, \
            TState.DaemonBackend(sock) as b1, \
            TState.DaemonBackend(daemon.tcp_address) as b2:
        services = [AllocationService(
            catalog, TS.build_history(), backend=b, adaptive=True,
            budget=TP.ProfilingBudget(max_points=limit, backend=b))
            for b in (b1, b2)]
        answers = []

        def client(i):
            svc = services[i % 2]
            for j in jobs[i::8]:
                answers.append(AllocationEndpoint(svc).handle(
                    timeout=TIMEOUT, **payload(TS, j, seed=i)))

        with services[0], services[1]:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=2 * TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            fresh = sum(s.stats.profile_calls for s in services)
            snap = services[0].budget.snapshot()
            denied = sum(s.stats.budget_denied for s in services)
    assert len(answers) == len(jobs)
    assert snap["points_spent"] == fresh == limit
    assert snap["denials"] > 0 and denied > 0


def test_trace_tool_stitches_a_request_across_the_service_and_the_daemon(
        capsys):
    """A traced request through a service over a daemon, then each
    package's trace_tool against that daemon: one tree under the request's
    trace id holds the service's spans and the daemon's, and both tools
    print the same stitched forest."""
    from repro.telemetry import trace_tool as j_trace_tool
    from repro_torch.telemetry import publish_traces
    from repro_torch.telemetry import trace_tool
    token = {"trace_id": "feedfacecafe0024", "span_id": "00000000000000bb"}
    sock = _short_socket()
    with TState.CrispyDaemon(sock), TState.DaemonBackend(sock) as backend:
        with AllocationService(aws_like_catalog(), TS.build_history(),
                               backend=backend) as svc:
            AllocationEndpoint(svc).handle(
                timeout=TIMEOUT, trace=token,
                **payload(TS, TS.scout_like_jobs()[3]))
        publish_traces(backend, "alloc-svc")
        argv = ["--daemon", sock, "--slowest", "5", "--expect-cross-process"]
        assert trace_tool.main(argv) == 0
        text = capsys.readouterr().out
        assert trace_tool.main(argv + ["--json", "--trace",
                                       token["trace_id"]]) == 0
        got = json.loads(capsys.readouterr().out)
        assert j_trace_tool.main(argv + ["--json", "--trace",
                                         token["trace_id"]]) == 0
        want = json.loads(capsys.readouterr().out)
    assert got == want
    assert "[alloc-svc]" in text and "[crispy-daemon]" in text
    assert got["sources"] == ["alloc-svc", "crispy-daemon"]
    (tree,) = got["traces"]

    def sources(span):
        yield span["source"], span["name"]
        for child in span.get("children", ()):
            yield from sources(child)
    seen = set(sources(tree))
    assert ("alloc-svc", "endpoint.request") in seen
    assert any(src == "crispy-daemon" and name.startswith("daemon.op.")
               for src, name in seen)


def test_the_shared_state_example_runs(capsys):
    """examples/serve_demo_torch.py: service B re-profiles nothing."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "serve_demo_torch.py")
    spec = importlib.util.spec_from_file_location("serve_demo_torch", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    assert demo.demo_shared_state(n_jobs=4) == 0
    out = capsys.readouterr().out
    assert "service B re-profiled 0 points" in out
    assert "[crispy-daemon]" in out


def test_crispy_allocator_over_a_store_answers_as_the_references(tmp_path):
    """CrispyAllocator.allocate(store=) with the port's ProfileStore: the
    reference's report, the points written back, and a second call (a
    sibling store over the same directory) served from them."""
    from repro.core.crispy import CrispyAllocator as JCrispy
    reports = {}
    for name, crispy, sim, catalog, P, S in (
            ("jax", JCrispy, JS, j_aws_like_catalog(), JP, JState),
            ("port", CrispyAllocator, TS, aws_like_catalog(), TP, TState)):
        root = str(tmp_path / name)
        job = sim.scout_like_jobs()[2]
        req = payload(sim, job)
        alloc = crispy(catalog, sim.build_history())
        out = []
        for _ in range(2):
            store = P.ProfileStore(backend=S.FileBackend(root))
            rep = alloc.allocate(req["job"], req["profile_at"],
                                 req["full_size"], anchor=req["anchor"],
                                 adaptive=True, store=store)
            out.append((rep.sizes, rep.mems_bytes, rep.requirement_gib,
                        rep.selection.config.name, rep.trace.plan.profiled,
                        rep.trace.plan.store_hits, len(store)))
        reports[name] = out
    assert reports["port"] == reports["jax"]
    (first, second) = reports["port"]
    assert first[4] > 0 and second[4] == 0 and second[5] == len(second[0])


def test_a_depth_request_answers_as_the_planner_does():
    """A request over the planner's depth ladder, with bytes linear in
    depth (as a dense model's prefill is) and the GPU catalog: the zoo
    picks its linear candidate, and the requirement and selection are
    HBMPlanner's on the same points."""
    cfg = get_arch("deepseek-7b")
    sizes = HBMPlanner.depth_ladder(cfg)

    def profile_at(depth):
        return ProfileResult(depth, 2.1e9 + 0.43e9 * depth, 0.0, 1.0 + depth)

    mems = [profile_at(d).job_mem_bytes for d in sizes]
    planner = HBMPlanner()
    want_req = fit_memory_model(sizes, mems).requirement(
        cfg.n_layers, planner.leeway) / GiB
    want_sel = planner.select(want_req, want_req)
    with AllocationService(gpu_catalog(), ExecutionHistory(),
                           overhead_per_node_gib=GPU_OVERHEAD_GIB,
                           leeway=planner.leeway) as svc:
        wire = AllocationEndpoint(svc).handle(
            timeout=TIMEOUT, job="deepseek-7b:prefill_2048",
            profile_at=profile_at, sizes=sizes, full_size=cfg.n_layers)
    assert wire["candidate"] == "linear" and wire["source"] == "zoo"
    assert wire["requirement_gib"] == pytest.approx(want_req, rel=1e-9)
    assert wire["config"] == want_sel.config.name


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _engine(allocator=None):
    cfg = get_arch("deepseek-7b").reduced()
    run = RunConfig(attn_impl="kernel", remat="nothing",
                    compute_dtype="float32")
    model = build_model(cfg, run, device="cpu", seed=0)
    return ServeEngine(model, slots=4, max_len=24, allocator=allocator)


def _generate(engine, n=6):
    rng = np.random.default_rng(1)
    for rid in range(n):
        engine.submit(Request(rid, prompt=rng.integers(
            1, engine.model.cfg.vocab_size, size=4).tolist(),
            max_new_tokens=6))
    engine.finished = []
    return {r.rid: r.out_tokens for r in engine.run()}


def test_engine_answers_allocation_requests_beside_generation():
    job = TS.scout_like_jobs()[2]
    with pytest.raises(RuntimeError, match="attach_allocator"):
        _engine().allocate(**payload(TS, job))
    with AllocationService(aws_like_catalog(), TS.build_history()) as svc:
        engine = _engine(allocator=svc)
        assert engine.allocation_endpoint.service is svc
        wire = engine.allocate(timeout=TIMEOUT, **payload(TS, job))
        tokens = _generate(engine)
    assert wire["source"] == "zoo" and wire["job"] == job.name
    assert len(tokens) == 6 and all(len(t) == 6 for t in tokens.values())
    other = _engine()
    assert other.attach_allocator(svc).service is svc


def test_allocation_traffic_from_threads_leaves_answers_and_tokens_alone():
    """The chip smoke's allocate phase at a small size: 8 threads send 8
    first requests, then their 8 repeats, while the main thread serves;
    each answer equals the one the same request gets sequentially with no
    engine running, the tokens equal those of a run without traffic, and
    the repeats are registry hits. The 8 first requests are the six
    linear scout jobs and a rerun of each kmeans job (another noise seed,
    its own signature), whose answers do not depend on the order in which
    the batch meets them."""
    jobs = [j for j in TS.scout_like_jobs() if j.mem_profile == "linear"]
    firsts = [payload(TS, j) for j in jobs] + [
        payload(TS, j, seed=1, signature=j.name + "/rerun")
        for j in jobs if j.name.startswith("kmeans")]
    assert len(firsts) == 8
    with AllocationService(aws_like_catalog(), TS.build_history()) as svc:
        ep = AllocationEndpoint(svc)
        want = [strip(ep.handle(timeout=TIMEOUT, **r)) for r in firsts * 2]
    with AllocationService(aws_like_catalog(), TS.build_history()) as svc:
        engine = _engine(allocator=svc)
        quiet = _generate(engine)
        got = [None] * 16
        barrier = threading.Barrier(8)

        def client(i):
            got[i] = strip(engine.allocate(timeout=TIMEOUT, **firsts[i]))
            barrier.wait(timeout=TIMEOUT)
            got[8 + i] = strip(engine.allocate(timeout=TIMEOUT, **firsts[i]))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        busy = _generate(engine)
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        stats = engine.allocation_endpoint.stats()
    assert busy == quiet
    assert got == want
    assert stats["registry_hits"] == 8 and stats["requests"] == 16
