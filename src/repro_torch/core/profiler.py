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

``ProfileResult`` and ``RSSProfiler`` are copies of the JAX package's
``repro/core/profiler.py``.
"""
from __future__ import annotations

import ctypes
import gc
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Union

import torch

from repro_torch import resolve_device

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


def _release_cached(device: torch.device) -> None:
    """Free what no tensor holds: collect garbage, drop cuBLAS's workspaces
    (allocated through the caching allocator at a handle's first product and
    kept for the life of the process, so that the first profile alone would
    pay for them) and hand cached blocks back to CUDA."""
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    with torch.cuda.device(device):
        torch.cuda.empty_cache()


class CUDAMemoryProfiler:
    """Peak device memory of one step on the card. ``job`` builds its own
    weights, state and inputs on the device (so that they count, as XLA's
    arguments do) and runs the step; what it returns is dropped at once. A
    job may reset the peak statistics once it has built its inputs
    (``launch.dryrun.build_step`` does), so that the reading is the step's
    peak with them live. Memory still allocated after the job raises: a
    leak between ladder points would bend the fit."""

    def profile(self, job: Callable[[], object], size: float,
                device: Optional[Union[str, torch.device]] = None
                ) -> CUDAProfileResult:
        device = resolve_device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDAMemoryProfiler measures a CUDA device, "
                             f"not {device}")
        torch.cuda.synchronize(device)
        _release_cached(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.monotonic()
        job()
        torch.cuda.synchronize(device)
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated(device)
        reserved = torch.cuda.max_memory_reserved(device)
        free, total = torch.cuda.mem_get_info(device)
        _release_cached(device)
        left = torch.cuda.memory_allocated(device) - base
        if left != 0:
            raise RuntimeError(
                f"profile at size {size}: {left} bytes still allocated after "
                f"the job (base {base}); a job must free what it allocates")
        return CUDAProfileResult(size, float(peak), float(base), wall,
                                 reserved_mem_bytes=float(reserved),
                                 device_used_bytes=float(total - free))
