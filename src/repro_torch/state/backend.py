"""StateBackend: the one shared-state protocol behind Crispy's stores.

Before this package, every shared-state owner hand-rolled its own
multi-process machinery: `ProfileStore` and `LockedModelRegistry` each
carried their own fcntl JSONL/merge code, and `ProfilingBudget` was
process-local (two service processes could each spend the full ten-minute
envelope). `StateBackend` factors the sharing into one transport-agnostic
protocol with exactly two storage shapes plus one arbitration primitive:

  append-only logs    `append(ns, record)` / `read(ns, cursor)` — ordered
                      JSON-safe records per namespace, read incrementally
                      from an opaque integer cursor. This is the shape of
                      the profile/anchor store: later rows win, so readers
                      need no compaction.

  versioned documents `load(ns, key)` / `cas(ns, key, version, value)` —
                      a JSON document with a monotonically increasing
                      version; `cas` succeeds only when the caller's
                      version matches the current one. This is the shape
                      of the model registry (read-merge-CAS flush) and the
                      shared budget doc.

  lease reservations  `reserve(ns, key, deltas, limits)` — atomically bump
                      numeric counters in a document iff the limits hold.
                      This is the shape of cross-process budget
                      arbitration: N processes reserve points from one
                      envelope and the backend guarantees the sum never
                      exceeds it. The base implementation is a CAS retry
                      loop so any backend gets it for free; the daemon
                      backend forwards it as a single RPC the single-writer
                      server applies atomically.

Implementations:

  InMemoryBackend     dict + threading.Lock. Tests, embedded single-process
                      use, and the storage engine inside the daemon.
  FileBackend         fcntl-locked JSONL logs + atomically rewritten JSON
                      doc files (file_backend.py). The only module in the
                      package allowed to touch fcntl.
  DaemonBackend       newline-JSON RPC over a unix-domain socket to a
                      single-writer `crispy-daemon` (daemon.py).

A copy of the JAX package's ``repro/state/backend.py``.
"""
from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.state.compaction import fold_log


class StateBackendError(RuntimeError):
    """Base error for backend failures."""


class StateBackendUnavailable(StateBackendError):
    """The backend's transport is down (daemon crashed / socket gone).
    Callers may retry after the daemon restarts; state survives when the
    daemon is backed by a FileBackend root."""


class CASConflict(StateBackendError):  # pragma: no cover - debugging aid
    """Optional strict-mode error for callers that treat a lost CAS race
    as exceptional rather than retryable."""


class StateBackend(ABC):
    """Transport-agnostic shared-state protocol (see module docstring).

    All values must be JSON-serializable dicts; namespaces are short
    identifier-like strings (implementations may sanitize them into
    filenames). Every operation is atomic with respect to every other
    operation on the same backend, across threads and — for FileBackend
    and DaemonBackend — across processes.
    """

    kind: str = "abstract"

    # -- append-only logs ---------------------------------------------------
    @abstractmethod
    def append(self, ns: str, record: Dict) -> None:
        """Append one record to the `ns` log. Concurrent appends never
        interleave or drop records."""

    @abstractmethod
    def read(self, ns: str, cursor: int = 0) -> Tuple[List[Dict], int]:
        """Records appended since `cursor` (0 = start), plus the new
        cursor. Cursors are opaque ints valid only for this backend;
        they stay monotone across `compact` — a cursor taken before a
        compaction re-reads the folded snapshot (rows are idempotent
        under "later wins", so re-application is harmless), never a torn
        or partial view."""

    def compact(self, ns: str,
                key_fields: Optional[Sequence[str]] = None,
                max_age_s: Optional[float] = None) -> Dict:
        """Fold the `ns` log into snapshot-plus-tail form (see
        repro_torch.state.compaction.fold_log): keep the LAST row per identity
        key — a tombstone row survives as its identity's last word, so
        stale readers still observe the deletion — and drop over-age
        survivors. Returns {"before": n, "after": m, "dropped": n - m}.
        Pre-compaction cursors remain valid (they re-read the snapshot).
        Backends that cannot rewrite their log raise StateBackendError."""
        raise StateBackendError(
            f"{self.kind} backend does not support compaction")

    # -- versioned documents ------------------------------------------------
    @abstractmethod
    def load(self, ns: str, key: str) -> Tuple[Optional[Dict], int]:
        """Current (value, version) of a document; (None, 0) if absent."""

    @abstractmethod
    def cas(self, ns: str, key: str, version: int,
            value: Dict) -> Tuple[bool, Optional[Dict], int]:
        """Replace the document iff its version still equals `version`
        (0 = create). Returns (won, current_value, current_version) —
        on a lost race the current state is returned so the caller can
        merge and retry."""

    # -- lease-style reservations ------------------------------------------
    def reserve(self, ns: str, key: str, deltas: Dict[str, float],
                limits: Optional[Dict[str, float]] = None
                ) -> Tuple[bool, Dict]:
        """Atomically apply `deltas` to numeric fields of the document iff
        every limit holds. For each (field, limit) in `limits`:

          * the field is being bumped (a nonzero delta): granted iff the
            post-apply value stays <= limit — a reservation may land
            exactly on the ceiling;
          * the field is a pure guard (no/zero delta): granted iff the
            current value is strictly < limit — matches "the envelope is
            already spent" semantics for charged-seconds checks.

        Returns (granted, document-after). A denied reservation changes
        nothing. Default implementation: CAS retry loop (correct on any
        backend); DaemonBackend overrides with a single server-side RPC.
        """
        limits = limits or {}
        while True:
            current, version = self.load(ns, key)
            doc = dict(current or {})
            granted = True
            for field, limit in limits.items():
                if limit is None:
                    continue
                cur = float(doc.get(field, 0))
                delta = float(deltas.get(field, 0))
                ok = (cur + delta <= limit) if delta else (cur < limit)
                if not ok:
                    granted = False
                    break
            if not granted:
                return False, doc
            for field, delta in deltas.items():
                doc[field] = float(doc.get(field, 0)) + float(delta)
            won, cur_val, _v = self.cas(ns, key, version, doc)
            if won:
                return True, doc
            # lost the race: re-read and re-check against fresh state

    # -- batched ops ---------------------------------------------------------
    def batch(self, ops: Sequence[Dict]) -> List[Dict]:
        """Execute several ops as one unit, returning one wire-shaped
        result dict per op, in order (the same shapes the crispy-daemon
        puts on the wire — {"ok": true, "rows": ...} etc.). Failures are
        isolated per op: a failing op yields {"ok": false, "error": ...}
        and the remaining ops still run. Ops are applied sequentially in
        order, so a batch may read its own earlier writes.

        The base implementation loops locally — correct on any backend,
        no faster than N calls. `DaemonBackend` overrides it with ONE
        {"op": "batch"} wire frame, turning N round-trips into one;
        views coalesce their hot read patterns through this method (see
        repro_torch.profiling.store.refresh_views)."""
        return [self._apply_batch_op(op) for op in ops]

    def _apply_batch_op(self, req: Dict) -> Dict:
        try:
            if not isinstance(req, dict):
                raise StateBackendError(f"batch op is not a dict: {req!r}")
            op = req.get("op")
            if op == "ping":
                return {"ok": True, "kind": self.kind}
            if op == "append":
                self.append(req["ns"], req["record"])
                return {"ok": True}
            if op == "read":
                rows, cursor = self.read(req["ns"],
                                         int(req.get("cursor", 0)))
                return {"ok": True, "rows": rows, "cursor": cursor}
            if op == "load":
                value, version = self.load(req["ns"], req["key"])
                return {"ok": True, "value": value, "version": version}
            if op == "cas":
                won, value, version = self.cas(req["ns"], req["key"],
                                               int(req["version"]),
                                               req["value"])
                return {"ok": True, "won": won, "value": value,
                        "version": version}
            if op == "reserve":
                granted, doc = self.reserve(req["ns"], req["key"],
                                            req.get("deltas", {}),
                                            req.get("limits") or {})
                return {"ok": True, "granted": granted, "doc": doc}
            if op == "compact":
                stats = self.compact(req["ns"],
                                     key_fields=req.get("key_fields"),
                                     max_age_s=req.get("max_age_s"))
                resp = {"ok": True}
                resp.update(stats)
                return resp
            return {"ok": False, "error": f"unknown op {op!r}"}
        except Exception as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    # -- replication enumeration --------------------------------------------
    def log_namespaces(self) -> List[str]:
        """Namespaces that currently hold log rows. Used by the warm-standby
        ReplicationShipper (which runs colocated with the primary's local
        storage backend) to discover what to ship; backends that cannot
        enumerate return [] and simply aren't shippable sources."""
        return []

    def doc_snapshot(self) -> List[Tuple[str, str, Optional[Dict], int]]:
        """Every versioned document as (ns, key, value, version). Same
        consumer and same default as `log_namespaces`."""
        return []

    # -- lifecycle ----------------------------------------------------------
    def ping(self) -> bool:
        """True when the backend is reachable."""
        return True

    def close(self) -> None:
        """Release transport resources (no-op for local backends)."""

    def __enter__(self) -> "StateBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class InMemoryBackend(StateBackend):
    """Process-local reference implementation: tests, embedded use, and
    the storage engine the daemon serves when started with --memory."""

    kind = "memory"

    def __init__(self):
        self._lock = threading.Lock()
        self._logs: Dict[str, List[Dict]] = {}
        # logical cursor = base + index into the current (possibly folded)
        # log; compaction bumps the base past every pre-compaction cursor
        # so stale cursors deterministically re-read the snapshot
        self._bases: Dict[str, int] = {}
        self._docs: Dict[Tuple[str, str], Tuple[Dict, int]] = {}

    def append(self, ns: str, record: Dict) -> None:
        with self._lock:
            self._logs.setdefault(ns, []).append(dict(record))

    def read(self, ns: str, cursor: int = 0) -> Tuple[List[Dict], int]:
        with self._lock:
            log = self._logs.get(ns, ())
            base = self._bases.get(ns, 0)
            start = max(0, cursor - base)
            rows = [dict(r) for r in log[start:]]
            return rows, base + len(log)

    def compact(self, ns: str,
                key_fields: Optional[Sequence[str]] = None,
                max_age_s: Optional[float] = None) -> Dict:
        with self._lock:
            log = self._logs.get(ns, [])
            before = len(log)
            folded = fold_log(log, key_fields=key_fields,
                              max_age_s=max_age_s)
            # every pre-compaction cursor is <= base + before == new base,
            # so each lands at snapshot start after the fold
            self._bases[ns] = self._bases.get(ns, 0) + before
            self._logs[ns] = folded
            return {"before": before, "after": len(folded),
                    "dropped": before - len(folded)}

    def load(self, ns: str, key: str) -> Tuple[Optional[Dict], int]:
        with self._lock:
            value, version = self._docs.get((ns, key), (None, 0))
            return (dict(value) if value is not None else None), version

    def cas(self, ns: str, key: str, version: int,
            value: Dict) -> Tuple[bool, Optional[Dict], int]:
        with self._lock:
            cur_val, cur_ver = self._docs.get((ns, key), (None, 0))
            if cur_ver != version:
                return (False,
                        dict(cur_val) if cur_val is not None else None,
                        cur_ver)
            self._docs[(ns, key)] = (dict(value), cur_ver + 1)
            return True, dict(value), cur_ver + 1

    def log_namespaces(self) -> List[str]:
        with self._lock:
            return sorted(ns for ns, log in self._logs.items()
                          if log or self._bases.get(ns, 0))

    def doc_snapshot(self) -> List[Tuple[str, str, Optional[Dict], int]]:
        with self._lock:
            return [(ns, key, dict(value), version)
                    for (ns, key), (value, version) in sorted(
                        self._docs.items())]
