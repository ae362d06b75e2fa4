"""ProfilingExecutor: concurrent profiling work under one thread pool.

Two axes of independence a serial pipeline leaves on the table, both
driven through `map_tasks`:

  * the points of a *fixed* ladder are independent measurements — the
    pipeline's acquisition stage fans them over the pool (budget gating
    and cache hierarchy live in `repro_torch.pipeline.acquisition.PointSource`,
    the ONE implementation); adaptive schedules stay sequential by
    construction (each point's necessity depends on the previous refit);
  * distinct job signatures are independent jobs — the AllocationService
    fans a batch's signature groups out over the same pool.

Threads, not processes: profiling callables close over simulator state /
jax compilation contexts that do not pickle, and the real work (RSS
sampling of a child workload, XLA AOT compilation) releases the GIL.

A copy of the JAX package's ``repro/profiling/executor.py``.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, TypeVar

from repro_torch.profiling.budget import ProfilingBudget

T = TypeVar("T")
R = TypeVar("R")

DEFAULT_WORKERS = 4


class ProfilingExecutor:
    def __init__(self, max_workers: int = DEFAULT_WORKERS,
                 budget: Optional[ProfilingBudget] = None):
        self.budget = budget
        self._local = threading.local()
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="profiling",
            initializer=self._mark_worker)
        self._closed = False

    def _mark_worker(self) -> None:
        self._local.in_worker = True

    @property
    def in_worker(self) -> bool:
        """True on threads owned by this pool. Nested fan-out (a signature
        group task profiling its ladder through the same pool) must run
        inline instead of enqueueing-and-blocking: with every worker parked
        in a group task, the inner tasks would never start (deadlock)."""
        return getattr(self._local, "in_worker", False)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "ProfilingExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- concurrent tasks ---------------------------------------------------
    def map_tasks(self, fn: Callable[[T], R], items: Sequence[T]
                  ) -> List[R]:
        """Run `fn` over independent items (signature groups) on the pool,
        preserving order. Exceptions propagate per item to the caller."""
        if self.in_worker:              # nested call: run inline
            return [fn(it) for it in items]
        futs = [self._pool.submit(fn, it) for it in items]
        out: List[R] = []
        for f in futs:
            out.append(f.result())
        return out
