"""Crispy §III-B: job profiling backends of the port.

``RSSProfiler`` — the paper's literal method: run the job on this machine
while a background thread samples OS-level memory (/proc/self/statm and
/proc/meminfo), with aggressive garbage collection between samples (the
analogue of the paper's JVM NewRatio tuning, Fig. 4: measure live objects,
not allocator slack).

``CUDAMemoryProfiler`` — the GPU adaptation, in place of the JAX package's
``XLACompileProfiler``: "run" = one step of a scaled-down job on the card,
which builds its weights, state and inputs there itself, and the reading is
the CUDA caching allocator's peak of allocated bytes over that step
(``torch.cuda.max_memory_allocated``). Where XLA's compile-time analysis
predicts the buffers, this measures what the step really allocated. The
device is the card; the profiler refuses any other.

The release around a profile (``_release_cached``): alone, a profile
collects garbage, clears cuBLAS's workspaces and hands every cached block
back to CUDA before and after its job. Inside ``ladder_scope`` (one planner
answer's ladder) only the scope's first point starts from that full
release and only its last point hands the cache back; between them a point
clears the workspaces, keeps the cached blocks for the next point, and
collects garbage only where its job left bytes allocated. Allocated bytes
count blocks, not the segments that hold them, so a point that starts on
the cache reads the bytes a cold one reads.

``ProfileResult`` and ``RSSProfiler`` are copies of the JAX package's
``repro/core/profiler.py``.
"""
from __future__ import annotations

import ctypes
import gc
import os
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.telemetry.metrics import default_registry
from repro_torch.telemetry.spans import traced

GiB = 1024 ** 3
_PAGE = os.sysconf("SC_PAGE_SIZE")

try:
    _LIBC = ctypes.CDLL("libc.so.6")
    _LIBC.malloc_trim.argtypes = [ctypes.c_size_t]
    _LIBC.malloc_trim.restype = ctypes.c_int
except OSError:                                    # non-glibc platforms
    _LIBC = None


def _malloc_trim():
    """Return freed arena pages to the OS so RSS tracks live memory.
    This is the userspace analogue of the paper's aggressive-GC tuning
    (Fig. 4): without it, consecutive profiling runs in one process read
    the allocator high-water mark, the memory(size) relation flattens and
    the R2 gate wrongly rejects linear jobs (measured in
    benchmarks/fig4_measurement_hygiene.py)."""
    if _LIBC is not None:
        _LIBC.malloc_trim(0)


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * _PAGE


@dataclass
class ProfileResult:
    size: float                  # the scale knob value (bytes / tokens / ...)
    peak_mem_bytes: float        # measured peak
    base_mem_bytes: float        # pre-run baseline (subtracted by caller)
    wall_s: float
    trace: List[float] = field(default_factory=list)   # sampled series
    trace_t: List[float] = field(default_factory=list)

    @property
    def job_mem_bytes(self) -> float:
        """Paper: 'the system-wide allocated memory before the start of
        execution is captured and accounted for'."""
        return max(0.0, self.peak_mem_bytes - self.base_mem_bytes)

    def to_dict(self, with_trace: bool = False) -> dict:
        """JSON-safe form (allocator registry / profile caches persist
        these). Traces are dropped by default — they dominate the payload
        and only the scalar summary feeds the memory models."""
        d = {"size": self.size, "peak_mem_bytes": self.peak_mem_bytes,
             "base_mem_bytes": self.base_mem_bytes, "wall_s": self.wall_s}
        if with_trace:
            d["trace"] = list(self.trace)
            d["trace_t"] = list(self.trace_t)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ProfileResult":
        return cls(float(d["size"]), float(d["peak_mem_bytes"]),
                   float(d["base_mem_bytes"]), float(d["wall_s"]),
                   list(d.get("trace", [])), list(d.get("trace_t", [])))


class RSSProfiler:
    """Profile a python callable's peak RSS with a sampler thread."""

    def __init__(self, interval_s: float = 0.005, aggressive_gc: bool = True):
        self.interval_s = interval_s
        self.aggressive_gc = aggressive_gc

    def profile(self, job: Callable[[], object], size: float) -> ProfileResult:
        gc.collect()
        if self.aggressive_gc:
            _malloc_trim()
        base = _rss_bytes()
        peak = [base]
        trace: List[float] = []
        trace_t: List[float] = []
        stop = threading.Event()
        t0 = time.monotonic()

        def sampler():
            n = 0
            while not stop.is_set():
                rss = _rss_bytes()
                peak[0] = max(peak[0], rss)
                trace.append(rss)
                trace_t.append(time.monotonic() - t0)
                n += 1
                # aggressive GC: reclaim short-lived objects so the reading
                # tracks live use (paper Fig. 4). Do it sparsely — a full
                # collect per sample would distort the wall time it charges.
                if self.aggressive_gc and n % 20 == 0:
                    gc.collect(0)
                    _malloc_trim()
                time.sleep(self.interval_s)

        th = threading.Thread(target=sampler, daemon=True)
        th.start()
        try:
            job()
        finally:
            stop.set()
            th.join(timeout=1.0)
        wall = time.monotonic() - t0
        peak[0] = max(peak[0], _rss_bytes())
        return ProfileResult(size, float(peak[0]), float(base), wall,
                             trace, trace_t)


@dataclass
class CUDAProfileResult(ProfileResult):
    """A ProfileResult with what the card showed beside the allocator's
    peak; ``to_dict`` keeps the reference's keys."""
    reserved_mem_bytes: float = 0.0   # max_memory_reserved over the job
    device_used_bytes: float = 0.0    # total - free (mem_get_info) at its end

    @property
    def overhead_bytes(self) -> float:
        """Memory the card held beyond the allocated peak: the CUDA
        context, the kernels' modules and the caching allocator's slack."""
        return self.device_used_bytes - self.peak_mem_bytes


def _release_cached(device: torch.device, hand_back: bool = True,
                    base: Optional[int] = None) -> None:
    """Free what no tensor holds: drop cuBLAS's workspaces (allocated
    through the caching allocator at a handle's first product and kept for
    the life of the process, so that the first profile alone would pay for
    them), collect garbage, and hand cached blocks back to CUDA. With
    `base`, garbage is collected only where more than `base` bytes are
    still allocated once the workspaces are gone; without `hand_back`, the
    cached blocks stay for the next point."""
    with traced("planner.release"):
        torch._C._cuda_clearCublasWorkspaces()
        if base is None or torch.cuda.memory_allocated(device) > base:
            gc.collect()
            default_registry().counter("planner.gc_runs").inc()
        if hand_back:
            with torch.cuda.device(device):
                torch.cuda.empty_cache()
            default_registry().counter("planner.cache_handbacks").inc()


@dataclass
class _Ladder:
    """An open ``ladder_scope``."""
    points: int                              # profiles still to come
    device: Optional[torch.device] = None    # the card, from its first one
    retries: int = 0                         # num_alloc_retries then
    held: bool = False                       # a finished point's cache kept


_LADDER: ContextVar[Optional[_Ladder]] = ContextVar("ladder", default=None)


def _alloc_retries(device: torch.device) -> int:
    return torch.cuda.memory_stats(device).get("num_alloc_retries", 0)


@contextmanager
def ladder_scope(points: int) -> Iterator[None]:
    """The next `points` profiles of this thread on one card are one
    ladder: the first starts cold, each later one on the cache the one
    before it left, and the last hands the cache back, as does the scope's
    end where a job raised first. Nothing happens on the card until a
    profile runs there, so on another device the scope does nothing.
    Counters of ``telemetry.default_registry()``: ``planner.points_warm``
    (profiles begun on a held cache), ``planner.cache_handbacks`` and
    ``planner.gc_runs`` (the releases' ``empty_cache`` calls and
    collections, in or out of a scope) and ``planner.alloc_retries`` (the
    allocator's own frees of the cache to satisfy a request, over the
    scope)."""
    ladder = _Ladder(points)
    token = _LADDER.set(ladder)
    try:
        yield
    finally:
        _LADDER.reset(token)
        if ladder.device is not None:
            default_registry().counter("planner.alloc_retries").inc(
                _alloc_retries(ladder.device) - ladder.retries)
            if ladder.held:
                _release_cached(ladder.device)


class CUDAMemoryProfiler:
    """Peak device memory of one step on the card. ``job`` builds its own
    weights, state and inputs on the device (so that they count, as XLA's
    arguments do) and runs the step; what it returns is dropped at once. A
    job may reset the peak statistics once it has built its inputs
    (``launch.dryrun.build_step`` does), so that the reading is the step's
    peak with them live. Memory still allocated after the job raises: a
    leak between ladder points would bend the fit.

    Alone, a profile releases fully before and after its job. Inside a
    ``ladder_scope`` a point other than the first begins on the cache its
    predecessor left: its peak of allocated bytes is the cold reading, but
    its ``reserved_mem_bytes`` and ``device_used_bytes`` include the held
    cache. Nothing fits those two, and a profile alone reads them as
    before."""

    def profile(self, job: Callable[[], object], size: float,
                device: Optional[Union[str, torch.device]] = None
                ) -> CUDAProfileResult:
        device = resolve_device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDAMemoryProfiler measures a CUDA device, "
                             f"not {device}")
        ladder = _LADDER.get()
        if ladder is not None and ladder.device is None:
            ladder.device, ladder.retries = device, _alloc_retries(device)
        if ladder is not None and ladder.device != device:
            ladder = None
        torch.cuda.synchronize(device)
        if ladder is not None and ladder.held:
            _release_cached(device, hand_back=False,
                            base=torch.cuda.memory_allocated(device))
            default_registry().counter("planner.points_warm").inc()
        else:
            _release_cached(device)
        if ladder is not None:
            ladder.points -= 1
            ladder.held = True
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.monotonic()
        job()
        torch.cuda.synchronize(device)
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated(device)
        reserved = torch.cuda.max_memory_reserved(device)
        free, total = torch.cuda.mem_get_info(device)
        if ladder is None:
            _release_cached(device)
        else:
            ladder.held = ladder.points > 0
            _release_cached(device, hand_back=not ladder.held, base=base)
        left = torch.cuda.memory_allocated(device) - base
        if left != 0:
            raise RuntimeError(
                f"profile at size {size}: {left} bytes still allocated after "
                f"the job (base {base}); a job must free what it allocates")
        return CUDAProfileResult(size, float(peak), float(base), wall,
                                 reserved_mem_bytes=float(reserved),
                                 device_used_bytes=float(total - free))
