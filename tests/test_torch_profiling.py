"""The port's profiling orchestration (``repro_torch.profiling``) against
the JAX package's, on the CPU: ``ProfilingBudget`` (local, and shared over a
backend) grants, denies and reports as the reference's for a seeded
sequence; ``ProfilingExecutor`` runs nested fan-out inline;
``AdaptiveLadderScheduler`` over the simulator's scout jobs gives the
reference's sizes, points and requirement trace; ``ProfileStore``,
``BackendModelRegistry`` and ``LockedModelRegistry`` round-trip, also
through the other package; and ``BudgetExhausted`` is one class."""
import threading

import numpy as np
import pytest

import repro.core.memory_model as JM
import repro.core.sampling as JSa
import repro.core.simulator as JS
import repro.profiling as JP
import repro.state as JState

import repro_torch.core.memory_model as TM
import repro_torch.core.sampling as TSa
import repro_torch.core.simulator as TS
import repro_torch.pipeline.acquisition as TA
import repro_torch.profiling as TP
import repro_torch.state as TState
from repro_torch.core.profiler import ProfileResult

GiB = 1024 ** 3


# ---------------------------------------------------------------------------
# the budget
# ---------------------------------------------------------------------------


def _budget_trace(P, backend, seed):
    """A seeded sequence of spends, refunds and charges against `P`'s
    ProfilingBudget: what each call answered, and the snapshot after."""
    rng = np.random.default_rng(seed)
    budget = P.ProfilingBudget(charge_s=30.0, max_points=6, backend=backend)
    out = []
    for _ in range(40):
        op = int(rng.integers(4))
        if op == 0:
            out.append(("spend", budget.try_spend(int(rng.integers(1, 3)))))
        elif op == 1:
            budget.refund()
            out.append(("refund", budget.points_spent))
        elif op == 2:
            budget.charge(float(rng.uniform(0.0, 9.0)))
            out.append(("charge", budget.charged_s))
        else:
            out.append(("state", budget.exhausted(), budget.remaining_points(),
                        budget.denials))
    snap = budget.snapshot()
    snap.pop("elapsed_s")
    return out, snap


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["local", "shared"])
def test_budget_gives_the_references_grants_and_snapshot(mode, seed):
    jb = JState.InMemoryBackend() if mode == "shared" else None
    tb = TState.InMemoryBackend() if mode == "shared" else None
    want, want_snap = _budget_trace(JP, jb, seed)
    got, got_snap = _budget_trace(TP, tb, seed)
    assert got == want
    assert got_snap == want_snap
    assert any(s == ("spend", False) for s in got)      # a denial happened
    assert got_snap["shared"] == (mode == "shared")
    if mode == "shared":
        assert tb.load("budget", "envelope")[0].keys() == \
            jb.load("budget", "envelope")[0].keys()


def test_budget_exhausted_is_one_class():
    """The pipeline raises the profiling package's class (imported where it
    raises it, as the reference does: profiling imports the allocator) and
    defines none of its own."""
    source = TA.PointSource("sig", lambda s: ProfileResult(s, 2 * s, 0.0, 1.0),
                            budget=TP.ProfilingBudget(max_points=1))
    point = source.as_point_fn()
    assert point(1e9)[1] is True
    with pytest.raises(TP.BudgetExhausted) as e:
        point(2e9)
    assert type(e.value) is TP.BudgetExhausted is TP.budget.BudgetExhausted
    assert not hasattr(TA, "BudgetExhausted")
    with pytest.raises(TP.BudgetExhausted):
        TP.ProfilingBudget(max_points=0).spend()


def test_a_shared_envelope_is_never_over_granted_across_handles():
    backend = TState.InMemoryBackend()
    handles = [TP.ProfilingBudget(max_points=23, backend=backend)
               for _ in range(4)]
    granted = [0] * len(handles)

    def spender(i):
        for _ in range(20):
            granted[i] += handles[i].try_spend()

    threads = [threading.Thread(target=spender, args=(i,))
               for i in range(len(handles))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert sum(granted) == 23
    assert handles[0].snapshot()["points_spent"] == 23
    assert handles[1].denials == 80 - 23


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [JP, TP], ids=["jax", "port"])
def test_executor_runs_nested_fan_out_inline(P):
    """Every worker is parked in an outer task: the inner fan-out runs on
    the outer task's own thread instead of waiting for a free worker."""
    result = {}

    def run():
        with P.ProfilingExecutor(max_workers=2) as ex:
            def group(g):
                outer = threading.current_thread().name
                inner = ex.map_tasks(
                    lambda x: (x * 10 + g, threading.current_thread().name),
                    range(3))
                return g, ex.in_worker, [v for v, _ in inner], \
                    {name for _, name in inner} == {outer}
            result["out"] = ex.map_tasks(group, range(5))
            result["outside"] = ex.in_worker

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "nested fan-out deadlocked"
    assert result["out"] == [(g, True, [g, 10 + g, 20 + g], True)
                             for g in range(5)]
    assert result["outside"] is False


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def _schedule(P, sim, sampling, job, placement, max_points):
    full = job.dataset_gib * GiB
    ladder = sampling.ladder_from_anchor(full * 0.01).sizes
    fn = sim.make_profile_fn(job, 0)
    budget = P.ProfilingBudget(max_points=max_points) if max_points else None
    ap = P.AdaptiveLadderScheduler(placement=placement, budget=budget).run(
        ladder, full, lambda s: (fn(s), True))
    return {"sizes": ap.sizes, "mems": ap.mems, "points": ap.points,
            "cache_hits": ap.cache_hits, "early_stop": ap.early_stop,
            "escalated": ap.escalated,
            "budget_exhausted": ap.budget_exhausted,
            "requirement_trace": ap.requirement_trace,
            "candidate": ap.fit.candidate, "confident": ap.fit.confident,
            "requirement": ap.fit.requirement(full),
            "results": [r.to_dict() for r in ap.results],
            "budget": budget.snapshot()["points_spent"] if budget else None}


@pytest.mark.parametrize("max_points", [None, 3])
@pytest.mark.parametrize("placement", ["ladder", "infogain"])
def test_scheduler_gives_the_references_schedule(placement, max_points):
    jobs = list(zip(JS.scout_like_jobs(), TS.scout_like_jobs()))
    kinds = set()
    for jj, tj in jobs:
        want = _schedule(JP, JS, JSa, jj, placement, max_points)
        got = _schedule(TP, TS, TSa, tj, placement, max_points)
        assert got == want, tj.name
        kinds.add((got["early_stop"], got["escalated"],
                   got["budget_exhausted"]))
    assert len(kinds) >= 2              # the jobs take different paths


def test_calibrated_anchor_is_measured_once_per_signature():
    store = TP.ProfileStore(backend=TState.InMemoryBackend())
    runs = []

    def run_at(size):
        runs.append(size)
        return 1.0 + size / 1e10

    got = TP.calibrated_anchor(store, "sig", run_at, 1e9)
    want = JP.calibrated_anchor(None, "sig", run_at, 1e9)
    n = len(runs)
    assert got == want and n > 0
    assert TP.calibrated_anchor(store, "sig", run_at, 1e9) == got
    assert len(runs) == n
    assert TP.ProfileStore(backend=store.backend).get_anchor("sig") == got


# ---------------------------------------------------------------------------
# the store and the registries
# ---------------------------------------------------------------------------


def _points():
    rng = np.random.default_rng(4)
    return [(f"sig{i % 3}", float(i + 1) * 1e9, ProfileResult(
        float(i + 1) * 1e9, int(rng.integers(1 << 33, 1 << 36)),
        int(rng.integers(0, 1 << 30)), float(rng.uniform(1, 60))))
        for i in range(10)]


@pytest.mark.parametrize("write_behind", [False, True])
def test_profile_store_round_trips(write_behind, tmp_path):
    backend = TState.FileBackend(str(tmp_path / "state"))
    s1 = TP.ProfileStore(backend=backend, write_behind=write_behind)
    s2 = TP.ProfileStore(backend=backend)
    for sig, size, r in _points():
        s1.put(sig, size, r)
    s1.put_anchor("sig0", 2.5e8)
    assert s1.get("sig1", _points()[1][1]) == _points()[1][2]
    assert s2.refresh() == (0 if write_behind else 11)
    if write_behind:
        assert s1.flush_writes() == 11
        assert s2.refresh() == 11
    for sig, size, r in _points():
        assert s2.get(sig, size) == r
    assert s2.get_anchor("sig0") == 2.5e8
    s2.evict("sig0", _points()[0][1])
    s1.refresh()
    assert s1.get("sig0", _points()[0][1]) is None
    # the JAX package's store reads the same rows from the same directory
    j = JP.ProfileStore(backend=JState.FileBackend(str(tmp_path / "state")))
    assert len(j) == len(s1) == len(s2)
    for sig, size, r in _points()[1:]:
        assert j.get(sig, size).to_dict() == r.to_dict()
    assert j.get("sig0", _points()[0][1]) is None
    assert j.anchors() == s1.anchors() == {"sig0": 2.5e8}
    # and the path form keeps the file layout
    legacy = TP.ProfileStore(str(tmp_path / "prof.jsonl"))
    legacy.put("sig", 1e9, ProfileResult(1e9, 2e9, 0.0, 5.0))
    assert JP.ProfileStore(str(tmp_path / "prof.jsonl")).get(
        "sig", 1e9).peak_mem_bytes == 2e9


def _model(M, slope):
    sizes = [2e9, 4e9, 6e9, 8e9, 1e10]
    return M.fit_memory_model(sizes, [slope * s + 1e9 for s in sizes])


def test_backend_model_registry_round_trips(tmp_path):
    backend = TState.FileBackend(str(tmp_path / "state"))
    r1, r2 = TP.BackendModelRegistry(backend), TP.BackendModelRegistry(backend)
    r1.put("a", _model(TM, 2.0), "linear", defer_save=True)
    r1.flush()
    r2.put("b", _model(TM, 3.0), "linear", defer_save=True)
    r2.flush()                          # merge on flush: "a" survives
    assert "a" in r2 and "b" in r2
    assert r1.refresh() >= 1 and "b" in r1
    assert r1.evict("a")
    r1.flush()
    r2.refresh()
    assert "a" not in r2
    # the JAX package's registry reads the same document
    j = JP.BackendModelRegistry(JState.FileBackend(str(tmp_path / "state")))
    assert sorted(r.signature for r in j.records()) == ["b"]
    assert j.get("b").model.requirement(1e12) == \
        r2.get("b").model.requirement(1e12) == \
        _model(JM, 3.0).requirement(1e12)
    # and what the JAX package writes, the port reads
    j.put("c", _model(JM, 4.0), "linear")
    r1.refresh()
    assert r1.get("c").model.requirement(1e12) == \
        _model(TM, 4.0).requirement(1e12)


def test_locked_model_registry_keeps_its_file(tmp_path):
    path = str(tmp_path / "registry.json")
    reg = TP.LockedModelRegistry(path)
    reg.put("x", _model(TM, 2.0), "linear")
    assert "x" in TP.LockedModelRegistry(path)
    assert "x" in JP.LockedModelRegistry(path)


def test_sync_views_flushes_then_refreshes_over_a_daemon():
    """One batched frame per call: the store's buffered rows and the
    registry's deferred model go out, a sibling's rows come in."""
    from repro_torch.profiling.store import sync_views
    with TState.CrispyDaemon(listen="127.0.0.1:0") as daemon:
        with TState.DaemonBackend(daemon.tcp_address) as a, \
                TState.DaemonBackend(daemon.tcp_address) as b:
            store_a = TP.ProfileStore(backend=a, write_behind=True)
            reg_a = TP.BackendModelRegistry(a)
            store_b = TP.ProfileStore(backend=b)
            reg_b = TP.BackendModelRegistry(b)
            store_a.put("s", 1e9, ProfileResult(1e9, 2e9, 0.0, 1.0))
            reg_a.put("s", _model(TM, 2.0), "linear", defer_save=True)
            store_b.put("t", 2e9, ProfileResult(2e9, 3e9, 0.0, 1.0))
            frames = daemon.telemetry.counter("daemon.frames").value
            sync_views(store_a, reg_a)
            assert daemon.telemetry.counter("daemon.frames").value == \
                frames + 1
            assert store_a.get("t", 2e9).peak_mem_bytes == 3e9
            sync_views(store_b, reg_b)
            assert store_b.get("s", 1e9).peak_mem_bytes == 2e9
            assert "s" in reg_b
