"""The release around the planner's profiles, on the CPU: the caching
allocator's calls replaced by a fake card that logs them. An answer's
ladder starts cold and hands the cache back once at its end, clears cuBLAS's
workspaces at every point and collects garbage only where a job left bytes;
a profile alone, or on another thread, releases fully before and after; a
plan on the CPU touches no ``torch.cuda`` function. The readings' equality
with cold ones is the card's to show (tests/test_torch_cuda.py)."""
import collections
import contextlib
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.core import hbm_planner as HP
from repro_torch.core import profiler as P
from repro_torch.core.profiler import ProfileResult
from repro_torch.telemetry.metrics import MetricsRegistry, set_default_registry

GiB = 1024 ** 3
LADDER = [2, 3, 4, 6, 7]             # deepseek-7b's default ladder
SHAPE = ShapeConfig("train_b2_s2048", 2048, 2, "train")


class FakeCard:
    """The allocator's statistics as the profiler reads them: a job of
    depth d allocates d GiB and frees them, but for what `leave` says
    (bytes, and whether a collection frees them); `fail` names a depth
    whose job raises, `retry` one at which the allocator frees its cache
    to satisfy a request."""

    def __init__(self):
        self.allocated = self.peak = self.garbage = self.retries = 0
        self.calls = []
        self.leave = {}
        self.fail = self.retry = None

    def collect(self, *args):
        self.calls.append("gc")
        self.allocated -= self.garbage
        self.garbage = 0
        return 0

    def job(self, depth):
        def run():
            self.calls.append(f"job{depth}")
            if depth == self.fail:
                raise ValueError(f"the job at depth {depth} failed")
            self.allocated += depth * GiB
            self.peak = max(self.peak, self.allocated)
            self.retries += depth == self.retry
            left, collectable = self.leave.get(depth, (0, False))
            self.allocated -= depth * GiB - left
            self.garbage += left if collectable else 0
        return run

    def counters(self):
        return {k: v for k, v in self.registry.snapshot()["counters"].items()
                if k.startswith("planner.")}


@pytest.fixture
def card(monkeypatch):
    c = FakeCard()
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(P, "resolve_device", lambda device: cuda)
    for name, fn in {
            "synchronize": lambda device=None: None,
            "memory_allocated": lambda device=None: c.allocated,
            "reset_peak_memory_stats":
                lambda device=None: setattr(c, "peak", c.allocated),
            "max_memory_allocated": lambda device=None: c.peak,
            "max_memory_reserved": lambda device=None: c.peak,
            "mem_get_info": lambda device=None: (0, c.peak),
            "memory_stats":
                lambda device=None: {"num_alloc_retries": c.retries},
            "device": lambda device: contextlib.nullcontext(),
            "empty_cache": lambda: c.calls.append("cache")}.items():
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces",
                        lambda: c.calls.append("workspaces"), raising=False)
    monkeypatch.setattr(P.gc, "collect", c.collect)
    monkeypatch.setattr(HP, "build_step",
                        lambda cfg, *args, **kwargs: c.job(cfg.n_layers))
    c.registry = MetricsRegistry()
    previous = set_default_registry(c.registry)
    try:
        yield c
    finally:
        set_default_registry(previous)


def plan():
    return HP.HBMPlanner().plan(get_arch("deepseek-7b"), SHAPE,
                                device="cuda")


def warm_point(depth):
    return ["workspaces", f"job{depth}", "workspaces"]


def test_an_answer_hands_the_cache_back_at_its_ends_only(card):
    rep = plan()
    assert rep.ladder == LADDER
    assert rep.per_dev_bytes == [d * GiB for d in LADDER]
    assert card.calls == ["workspaces", "gc", "cache", "job2", "workspaces",
                          *warm_point(3), *warm_point(4), *warm_point(6),
                          *warm_point(7), "cache"]
    assert card.counters() == {"planner.points_warm": 4,
                               "planner.cache_handbacks": 2,
                               "planner.gc_runs": 1,
                               "planner.alloc_retries": 0}


def test_a_job_that_leaves_garbage_is_collected_at_its_point(card):
    card.leave[4] = (GiB // 2, True)
    rep = plan()
    assert rep.per_dev_bytes == [d * GiB for d in LADDER]
    i = card.calls.index("job4")
    assert card.calls[i:i + 3] == ["job4", "workspaces", "gc"]
    assert card.calls.count("gc") == 2 and card.calls.count("cache") == 2
    assert card.counters()["planner.gc_runs"] == 2


def test_bytes_no_collection_frees_still_raise_and_the_cache_goes_back(card):
    card.leave[4] = (GiB // 2, False)
    with pytest.raises(RuntimeError, match="still allocated"):
        plan()
    i = card.calls.index("job4")
    # the point's own release collects; the scope's end releases fully
    assert card.calls[i:] == ["job4", "workspaces", "gc",
                              "workspaces", "gc", "cache"]
    assert card.counters()["planner.cache_handbacks"] == 2


def test_a_job_that_raises_mid_ladder_still_ends_with_the_hand_back(card):
    card.fail = 4
    with pytest.raises(ValueError, match="depth 4"):
        plan()
    i = card.calls.index("job4")
    assert card.calls[i:] == ["job4", "workspaces", "gc", "cache"]
    c = card.counters()
    assert c["planner.cache_handbacks"] == 2 and c["planner.points_warm"] == 2
    # the scope is closed: the next profile is cold again
    del card.calls[:]
    card.fail = None
    P.CUDAMemoryProfiler().profile(card.job(1), 1.0, "cuda")
    assert card.calls == ["workspaces", "gc", "cache", "job1",
                          "workspaces", "gc", "cache"]


@pytest.mark.parametrize("how", ["profiler", "gpu_profile_fn"])
def test_a_profile_alone_releases_fully_before_and_after(card, how):
    if how == "profiler":
        got = P.CUDAMemoryProfiler().profile(card.job(3), 3.0, "cuda")
    else:
        got = HP.gpu_profile_fn(get_arch("deepseek-7b"), SHAPE,
                                device="cuda")(3.0)
    assert got.job_mem_bytes == 3 * GiB
    assert card.calls == ["workspaces", "gc", "cache", "job3",
                          "workspaces", "gc", "cache"]
    assert card.counters() == {"planner.cache_handbacks": 2,
                               "planner.gc_runs": 2}


def test_a_profile_on_another_thread_is_not_part_of_the_ladder(card):
    got = []
    with P.ladder_scope(5):
        t = threading.Thread(target=lambda: got.append(
            P.CUDAMemoryProfiler().profile(card.job(2), 2.0, "cuda")))
        t.start()
        t.join(timeout=60)
    assert not t.is_alive() and len(got) == 1
    assert card.calls == ["workspaces", "gc", "cache", "job2",
                          "workspaces", "gc", "cache"]
    assert "planner.points_warm" not in card.counters()


def test_alloc_retries_count_the_allocators_frees_over_an_answer(card):
    card.retry = 7
    plan()
    assert card.counters()["planner.alloc_retries"] == 1


def test_an_answer_opens_ten_release_ranges(card):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan()
    got = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.is_user_annotation())
    assert got["planner.point"] == 5
    assert got["planner.release"] == 10


def test_a_plan_on_the_cpu_touches_no_cuda_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a torch.cuda function was called")
    for name in ("is_available", "current_device", "synchronize",
                 "memory_allocated", "memory_reserved", "memory_stats",
                 "reset_peak_memory_stats", "max_memory_allocated",
                 "max_memory_reserved", "mem_get_info", "empty_cache",
                 "device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces", refuse,
                        raising=False)

    class Profiler:
        def profile(self, job, size, device=None):
            job()
            return ProfileResult(size, 1e9 + 3e8 * size, 0.0, 0.0)

    monkeypatch.setattr(HP, "CUDAMemoryProfiler", Profiler)
    monkeypatch.setattr(HP, "build_step",
                        lambda *args, **kwargs: lambda: None)
    rep = HP.HBMPlanner().plan(get_arch("deepseek-7b"), SHAPE, device="cpu")
    assert rep.per_dev_bytes == [1e9 + 3e8 * d for d in LADDER]
