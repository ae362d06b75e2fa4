"""Profile store and model registry as thin views over a StateBackend.

ProfileStore and LockedModelRegistry once had their own fcntl JSONL
machinery; this module now contains none of it. Both classes are views
over the `repro_torch.state` StateBackend protocol, so the same code shares
state in-process (InMemoryBackend), across processes on one host
(FileBackend), or through the single-writer crispy-daemon
(DaemonBackend):

  ProfileStore           (signature, size) -> ProfileResult rows plus
                         per-signature calibrated anchors, kept in a
                         backend append-only log. Later rows win, so
                         readers never NEED compaction — but re-profiled
                         points and recalibrated anchors shadow earlier
                         rows forever, so `compact()` folds the log into
                         snapshot-plus-tail form (one row per identity,
                         tombstoned points dropped) and `evict()`
                         tombstones a point across every process sharing
                         the backend. Cross-process freshness is
                         pull-based via `refresh()` (the
                         AllocationService refreshes once per batch).
                         `ProfileStore(path)` keeps the original file layout:
                         a FileBackend JSONL at exactly that path.

  BackendModelRegistry   a ModelRegistry persisted as one versioned
                         backend document. Saves are read-merge-CAS:
                         on-disk records are merged with ours (newest
                         `created_at` wins per signature) and written only
                         if nobody raced us — a lost race re-merges and
                         retries, so concurrent flushes lose nothing and
                         each flush absorbs sibling processes' models.

  LockedModelRegistry    back-compat constructor: BackendModelRegistry
                         over a FileBackend rooted at the path's
                         directory. (The on-disk JSON is now the backend
                         document envelope; pre-StateBackend registry
                         files are treated as empty and rewritten on the
                         first flush.)

Wire coalescing: on a DaemonBackend every view method above is a
round trip, and the AllocationService's per-batch pattern — store
tail-read + registry doc load + N point/anchor appends + registry CAS —
paid for each one. Three hooks collapse that: `refresh_views(store,
registry)` fetches both views' refreshes in ONE `backend.batch()`
frame; `ProfileStore(write_behind=True)` buffers point/anchor/evict
rows (in-memory index updated immediately, a pending-identity set keeps
refresh from shadowing them) until `flush_writes()` sends them as one
batched append frame; and `BackendModelRegistry` flushes CAS-first
against its cached `_doc_version` — an unchanged version proves the
document unchanged since our last merge, so the uncontended flush is
one round trip, and a lost race merges the returned winner and retries
exactly as before. `sync_views(store, registry)` composes all three:
pending writes ride at the front of the refresh frame (batch frames
read their own writes), so a loaded service's steady state is ONE wire
frame per batch — batch N's writes carried by batch N+1's sync.

`FileLock` and `HAS_FCNTL` are re-exported from `repro_torch.state` for
backward compatibility — no fcntl use remains outside `repro_torch/state/`.

A copy of the JAX package's ``repro/profiling/store.py``.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.allocator.registry import (ModelRecord, ModelRegistry,
                                      REGISTRY_VERSION)
from repro_torch.core.profiler import ProfileResult
from repro_torch.state import FileBackend, StateBackend
from repro_torch.state.compaction import prune_registry_doc
from repro_torch.state.file_backend import FileLock, HAS_FCNTL  # noqa: F401 (compat)

STORE_VERSION = 2


def _split_path(path: str, ext: str) -> Tuple[str, str]:
    """(backend root, namespace) for a legacy file path: the namespace is
    the basename minus `ext`, so FileBackend reproduces the same file."""
    root = os.path.dirname(path) or "."
    base = os.path.basename(path)
    if base.endswith(ext):
        base = base[:-len(ext)]
    else:
        base = os.path.splitext(base)[0] or base
    return root, base


class ProfileStore:
    """Backend-log store of profile points and calibrated anchors.

    One record per row:
      {"kind": "profile", "sig": ..., "size": ..., "result": {...}}
      {"kind": "anchor",  "sig": ..., "anchor": ...}

    In-memory index is thread-safe; `refresh()` pulls rows appended by
    any sibling process/client since the last read.
    """

    def __init__(self, path: Optional[str] = None,
                 lock_timeout_s: float = 10.0,
                 backend: Optional[StateBackend] = None,
                 namespace: Optional[str] = None,
                 write_behind: bool = False):
        if backend is None:
            if path is None:
                raise ValueError("ProfileStore needs a path or a backend")
            root, stem = _split_path(path, ".jsonl")
            backend = FileBackend(root, lock_timeout_s=lock_timeout_s)
            namespace = namespace or stem
        self.backend = backend
        self.namespace = namespace or "profiles"
        self.path = path
        self._lock = threading.Lock()
        self._points: Dict[Tuple[str, float], ProfileResult] = {}
        self._anchors: Dict[str, float] = {}
        self._cursor = 0
        # write-behind mode (see class docstring): writes update the
        # in-memory index immediately but buffer their backend rows
        # until flush_writes() sends them as ONE batched append frame.
        # _pending_ids guards refresh(): a backend row whose identity
        # has a newer buffered write must not shadow it.
        self.write_behind = bool(write_behind)
        self._pending: List[Dict] = []
        self._pending_ids: set = set()
        self.refresh()

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._points)

    def anchors(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._anchors)

    # -- reads --------------------------------------------------------------
    def get(self, signature: str, size: float) -> Optional[ProfileResult]:
        with self._lock:
            return self._points.get((signature, float(size)))

    def get_anchor(self, signature: str) -> Optional[float]:
        with self._lock:
            return self._anchors.get(signature)

    def refresh(self) -> int:
        """Index rows appended (by any process) since the last read.
        Returns the number of new rows."""
        rows, cursor = self.backend.read(self.namespace, self._cursor)
        return self._apply_rows(rows, cursor)

    def refresh_op(self) -> Dict:
        """The wire-shaped read op `refresh()` would send — for
        coalescing several views' refreshes into one backend.batch()
        frame (see `refresh_views`)."""
        return {"op": "read", "ns": self.namespace, "cursor": self._cursor}

    def apply_refresh(self, resp: Dict) -> int:
        """Apply one batch-result slot produced by `refresh_op()`. A
        failed slot ({"ok": false}) leaves the view stale — the cursor
        does not move, so the next refresh re-reads the same tail."""
        if not resp or not resp.get("ok"):
            return 0
        return self._apply_rows(resp.get("rows") or [],
                                int(resp.get("cursor", self._cursor)))

    def _apply_rows(self, rows: List[Dict], cursor: int) -> int:
        with self._lock:
            for row in rows:
                self._apply_locked(row)
            # rows are idempotent (later wins), so a concurrent refresh
            # racing us to a shorter cursor only re-applies, never loses
            self._cursor = max(self._cursor, cursor)
        return len(rows)

    @staticmethod
    def _row_identity(row: Dict) -> Tuple:
        if row.get("kind") == "anchor":
            return ("anchor", row.get("sig"))
        return ("profile", row.get("sig"), float(row.get("size", 0.0)))

    def _apply_locked(self, row: Dict) -> None:
        kind = row.get("kind")
        if self._pending_ids and self._row_identity(row) in self._pending_ids:
            # a buffered write-behind row for this identity is newer
            # than anything the backend can show us yet — don't let a
            # sibling's older row shadow it
            return
        if row.get("tombstone"):
            if kind == "profile":
                self._points.pop((row["sig"], float(row["size"])), None)
            elif kind == "anchor":
                self._anchors.pop(row["sig"], None)
            return
        if kind == "profile":
            key = (row["sig"], float(row["size"]))
            self._points[key] = ProfileResult.from_dict(row["result"])
        elif kind == "anchor":
            self._anchors[row["sig"]] = float(row["anchor"])

    # -- writes -------------------------------------------------------------
    def _write(self, row: Dict) -> None:
        if self.write_behind:
            with self._lock:
                self._pending.append(row)
                self._pending_ids.add(self._row_identity(row))
            return
        self.backend.append(self.namespace, row)

    def flush_ops(self) -> List[Dict]:
        """Pop buffered write-behind rows as wire-shaped append ops, for
        riding in a shared `backend.batch()` frame (see `sync_views`).
        The caller MUST follow up with `apply_flush(ops, results)` —
        with `results=None` on transport failure — or the popped rows
        are lost."""
        with self._lock:
            rows, self._pending = self._pending, []
            self._pending_ids = set()
        return [{"op": "append", "ns": self.namespace, "record": row}
                for row in rows]

    def apply_flush(self, ops: List[Dict],
                    results: Optional[List[Dict]]) -> int:
        """Settle a `flush_ops()` frame: rows whose append slot failed
        (or every row, when `results is None` — the frame never made it)
        are re-queued ahead of anything buffered meanwhile, so no write
        is lost. Returns rows durably flushed."""
        if results is None:
            failed = [op["record"] for op in ops]
        else:
            failed = [op["record"] for op, r in zip(ops, results)
                      if not (r and r.get("ok"))]
        if failed:
            with self._lock:
                self._pending = failed + self._pending
                self._pending_ids.update(
                    self._row_identity(r) for r in self._pending)
        return len(ops) - len(failed)

    def flush_writes(self) -> int:
        """Send buffered write-behind rows as ONE batched append frame
        (one round trip on a DaemonBackend regardless of how many points
        a service batch produced). Ordering is preserved. On transport
        failure the rows are re-queued ahead of anything buffered
        meanwhile, so no write is lost. Returns rows flushed."""
        with self._lock:
            rows, self._pending = self._pending, []
            self._pending_ids = set()
        if not rows:
            return 0
        try:
            if len(rows) == 1:
                self.backend.append(self.namespace, rows[0])
            else:
                results = self.backend.batch(
                    [{"op": "append", "ns": self.namespace, "record": row}
                     for row in rows])
                failed = [r for r in results if not r.get("ok")]
                if failed:
                    raise RuntimeError(
                        f"{len(failed)}/{len(rows)} batched profile "
                        f"appends failed: {failed[0].get('error')}")
        except BaseException:
            with self._lock:
                self._pending = rows + self._pending
                self._pending_ids.update(
                    self._row_identity(r) for r in self._pending)
            raise
        return len(rows)

    def put(self, signature: str, size: float,
            result: ProfileResult) -> None:
        self._write({"kind": "profile", "sig": signature,
                     "size": float(size), "result": result.to_dict(),
                     "ts": time.time()})
        with self._lock:
            self._points[(signature, float(size))] = result

    def put_anchor(self, signature: str, anchor: float) -> None:
        self._write({"kind": "anchor", "sig": signature,
                     "anchor": float(anchor), "ts": time.time()})
        with self._lock:
            self._anchors[signature] = float(anchor)

    def evict(self, signature: str, size: float) -> None:
        """Tombstone one profile point: siblings drop it on their next
        `refresh()`, and the next `compact()` erases it (and the
        tombstone) from the log for good."""
        self._write({"kind": "profile", "sig": signature,
                     "size": float(size), "tombstone": True,
                     "ts": time.time()})
        with self._lock:
            self._points.pop((signature, float(size)), None)

    # -- maintenance --------------------------------------------------------
    KEY_FIELDS = ("kind", "sig", "size")

    def compact(self, max_age_s: Optional[float] = None) -> Dict:
        """Fold the backing log: one row per (kind, sig, size) identity —
        the LAST appended, which for an evicted point is its tombstone
        (kept so siblings with stale cursors still observe the
        deletion). Given `max_age_s`, surviving rows older than that —
        tombstones included — are evicted. Point counts are unchanged
        unless rows are tombstoned or over-age; cursors held by sibling
        processes stay valid. Returns the backend's
        {"before", "after", "dropped"} stats."""
        return self.backend.compact(self.namespace,
                                    key_fields=self.KEY_FIELDS,
                                    max_age_s=max_age_s)


class BackendModelRegistry(ModelRegistry):
    """ModelRegistry persisted as one versioned StateBackend document.

    Flushes are read-merge-CAS (see module docstring): safe for any
    number of concurrent services sharing one backend, on any transport.
    `refresh()` imports sibling records without writing."""

    DOC_KEY = "records"

    def __init__(self, backend: StateBackend, namespace: str = "registry",
                 autosave: bool = True, path: Optional[str] = None):
        self.backend = backend
        self.namespace = namespace
        # evictions, by time. They are PERSISTED in the backend document
        # ("tombstones"): without them the merge-before-CAS in
        # _save_locked — ours or any sibling process's — would re-import
        # the evicted record straight from the backend document and
        # resurrect it. A genuinely newer record still supersedes its
        # tombstone on both sides of the merge.
        self._tombstones: Dict[str, float] = {}
        # last version at which we observed (and merged) the backend
        # document — lets _save_locked CAS first instead of paying a
        # load round-trip per flush (see _save_locked)
        self._doc_version = 0
        super().__init__(path=None, autosave=autosave)
        # the base class persists iff `path is not None`; backend-only
        # registries get a descriptive sentinel so autosave still fires
        self.path = path if path is not None \
            else f"<{backend.kind}:{namespace}>"
        self.refresh()

    # how long a persisted eviction tombstone lives (see
    # repro_torch.state.compaction.DEFAULT_TOMBSTONE_TTL_S)
    TOMBSTONE_TTL_S = 24 * 3600.0

    # -- codec --------------------------------------------------------------
    def _encode_locked(self) -> Dict:
        # a tombstone superseded by a newer record of the same signature —
        # or older than the TTL (every live sibling has long since merged
        # the eviction) — has done its job; don't persist it forever
        horizon = time.time() - self.TOMBSTONE_TTL_S
        tombstones = {
            sig: ts for sig, ts in self._tombstones.items()
            if ts >= horizon
            and (sig not in self._records
                 or self._records[sig].created_at <= ts)}
        return {"version": REGISTRY_VERSION,
                "records": {sig: rec.to_dict()
                            for sig, rec in self._records.items()},
                "tombstones": tombstones}

    @staticmethod
    def _decode(value: Optional[Dict]) -> Dict[str, ModelRecord]:
        if not value:
            return {}
        return {sig: ModelRecord.from_dict(sig, d)
                for sig, d in value.get("records", {}).items()}

    @staticmethod
    def _decode_tombstones(value: Optional[Dict]) -> Dict[str, float]:
        if not value:
            return {}
        return {sig: float(ts)
                for sig, ts in (value.get("tombstones") or {}).items()}

    def _merge_locked(self, disk_records: Dict[str, ModelRecord],
                      disk_tombstones: Optional[Dict[str, float]] = None
                      ) -> None:
        # sibling evictions first: they delete any copy of ours that is
        # not strictly newer than the eviction
        for sig, ts in (disk_tombstones or {}).items():
            mine = self._records.get(sig)
            if mine is not None and mine.created_at > ts:
                continue                # our record outlives the eviction
            self._records.pop(sig, None)
            self._tombstones[sig] = max(ts, self._tombstones.get(sig, ts))
        for sig, rec in disk_records.items():
            evicted_at = self._tombstones.get(sig)
            if evicted_at is not None:
                if rec.created_at <= evicted_at:
                    continue            # the copy this registry evicted
                del self._tombstones[sig]   # newer model supersedes it
            mine = self._records.get(sig)
            if mine is None or rec.created_at > mine.created_at:
                self._records[sig] = rec

    def put(self, signature: str, model, candidate: Optional[str] = None,
            sizes=(), mems=(), defer_save: bool = False,
            runtime_model=None, runtime_candidate: Optional[str] = None,
            walls=()):
        with self._lock:
            # re-registering a signature revokes our own eviction of it
            self._tombstones.pop(signature, None)
            return super().put(signature, model, candidate=candidate,
                               sizes=sizes, mems=mems,
                               defer_save=defer_save,
                               runtime_model=runtime_model,
                               runtime_candidate=runtime_candidate,
                               walls=walls)

    def evict(self, signature: str) -> bool:
        with self._lock:
            gone = self._records.pop(signature, None) is not None
            if gone:
                self._tombstones[signature] = time.time()
                self._dirty = True
                if self.autosave and self.path is not None:
                    self._save_locked(self.path)
            return gone

    def prune(self, max_records: Optional[int] = None,
              max_age_s: Optional[float] = None) -> List[str]:
        """Evict records older than `max_age_s` and/or the oldest records
        beyond `max_records`, tombstoning each (shared across processes)
        with ONE flush. Same policy, same code as the daemon-side
        eviction: both delegate to `prune_registry_doc`. Returns the
        evicted signatures."""
        with self._lock:
            new_value, evicted = prune_registry_doc(
                self._encode_locked(), max_records=max_records,
                max_age_s=max_age_s, tombstone_ttl_s=self.TOMBSTONE_TTL_S)
            if evicted:
                self._records = self._decode(new_value)
                self._tombstones = self._decode_tombstones(new_value)
                self._dirty = True
                if self.autosave and self.path is not None:
                    self._save_locked(self.path)
            return evicted

    # -- persistence (overrides the file I/O of the base class) -------------
    def _save_locked(self, path: Optional[str] = None) -> None:
        # optimistic CAS-first flush: `_doc_version` is the version at
        # which we last merged the backend document (refresh/load/a won
        # CAS), and an unchanged version means an unchanged document —
        # so our in-memory state is already a superset and the CAS is
        # safe without re-loading. One round trip per uncontended flush
        # instead of two; a lost race falls back to merge-and-retry on
        # the loser's returned (value, version), same as before.
        version = self._doc_version
        while True:
            won, cur, ver = self.backend.cas(
                self.namespace, self.DOC_KEY, version, self._encode_locked())
            if won:
                self._doc_version = ver
                break
            # lost the flush race: merge the winner's document and retry
            self._merge_locked(self._decode(cur),
                               self._decode_tombstones(cur))
            version = ver
        self._dirty = False

    def load(self, path: Optional[str] = None) -> int:
        value, version = self.backend.load(self.namespace, self.DOC_KEY)
        records = self._decode(value)
        with self._lock:
            # explicit reload adopts the backend wholesale, evictions
            # included
            self._records = records
            self._tombstones = self._decode_tombstones(value)
            self._doc_version = version
            self._dirty = False
            return len(self._records)

    def refresh(self) -> int:
        """Merge sibling processes' records AND evictions into memory (no
        write). Returns the number of records imported or updated."""
        value, version = self.backend.load(self.namespace, self.DOC_KEY)
        return self._merge_refresh(value, version)

    def refresh_op(self) -> Dict:
        """The wire-shaped load op `refresh()` would send — for
        coalescing with other views' refreshes into one backend.batch()
        frame (see `refresh_views`)."""
        return {"op": "load", "ns": self.namespace, "key": self.DOC_KEY}

    def apply_refresh(self, resp: Dict) -> int:
        """Apply one batch-result slot produced by `refresh_op()`. A
        failed slot leaves the registry stale (and `_doc_version`
        untouched, so the next flush just takes the CAS-retry path)."""
        if not resp or not resp.get("ok"):
            return 0
        return self._merge_refresh(resp.get("value"),
                                   int(resp.get("version", 0)))

    def flush_ops(self) -> List[Dict]:
        """The wire-shaped CAS op a dirty registry's flush would send
        ([] when clean) — for riding in a shared `backend.batch()` frame
        (see `sync_views`). Settle with `apply_flush(ops, results)`."""
        with self._lock:
            if not self._dirty:
                return []
            return [{"op": "cas", "ns": self.namespace, "key": self.DOC_KEY,
                     "version": self._doc_version,
                     "value": self._encode_locked()}]

    def apply_flush(self, ops: List[Dict],
                    results: Optional[List[Dict]]) -> int:
        """Settle a `flush_ops()` frame. A won CAS marks the registry
        clean; a lost race merges the winner's document and LEAVES the
        registry dirty — the next sync (or `flush()`) retries against
        the winner's version, exactly like `_save_locked`'s retry loop
        but amortized across frames. A failed/absent slot changes
        nothing (still dirty, same version)."""
        if not ops:
            return 0
        resp = results[0] if results else None
        if not (resp and resp.get("ok")):
            return 0
        with self._lock:
            self._doc_version = int(resp.get("version", self._doc_version))
            if resp.get("won"):
                self._dirty = False
                return 1
            self._merge_locked(self._decode(resp.get("value")),
                               self._decode_tombstones(resp.get("value")))
        return 0

    def _merge_refresh(self, value: Optional[Dict], version: int) -> int:
        with self._lock:
            before = {sig: rec.created_at
                      for sig, rec in self._records.items()}
            self._merge_locked(self._decode(value),
                               self._decode_tombstones(value))
            self._doc_version = version
            return sum(1 for sig, rec in self._records.items()
                       if before.get(sig) != rec.created_at)


def refresh_views(*views) -> int:
    """Refresh several backend views (ProfileStore, BackendModelRegistry,
    anything with `refresh_op()`/`apply_refresh()`) in as few round trips
    as possible: views sharing ONE backend object are coalesced into a
    single `backend.batch()` call — one wire frame on a DaemonBackend
    instead of one per view — and applied in order. Views on distinct
    backends (or without the coalescing hooks) fall back to their own
    `refresh()`. Returns the total number of rows/records applied.

    Per-op error isolation carries through: a failed slot leaves that
    view stale (it re-reads the same tail next time) without aborting
    its neighbors.

    Over a sharded backend (repro_torch.state.sharding.ShardedBackend) the
    coalesced frame is split by owning shard INSIDE `batch()` — each
    view's namespace lives on exactly one shard, sub-frames fan out
    concurrently, and results come back in this frame's order — so the
    one-call-per-backend pattern here needs no sharding awareness."""
    total = 0
    groups: List[Tuple[StateBackend, List]] = []
    for view in views:
        if view is None:
            continue
        if not (hasattr(view, "refresh_op")
                and hasattr(view, "apply_refresh")):
            refresh = getattr(view, "refresh", None)
            if callable(refresh):
                result = refresh()
                total += result if isinstance(result, int) else 0
            continue
        for backend, members in groups:
            if backend is view.backend:
                members.append(view)
                break
        else:
            groups.append((view.backend, [view]))
    for backend, members in groups:
        if len(members) == 1:
            total += members[0].refresh()
            continue
        results = backend.batch([v.refresh_op() for v in members])
        for view, resp in zip(members, results):
            total += view.apply_refresh(resp)
    return total


def sync_views(*views) -> int:
    """Flush AND refresh several backend views in ONE round trip per
    shared backend: each view's pending writes (`flush_ops()` — buffered
    write-behind rows, a dirty registry's CAS) ride at the FRONT of the
    frame, followed by every view's `refresh_op()`. Batch frames read
    their own earlier writes, so each refresh observes the flush it
    shares a frame with. This is the AllocationService's steady-state
    wire pattern: batch N's writes are carried by batch N+1's sync, so a
    loaded service pays exactly one frame per batch.

    Failure semantics compose from the parts: a failed append slot
    re-queues its row (`ProfileStore.apply_flush`), a lost CAS merges
    the winner and stays dirty (`BackendModelRegistry.apply_flush`), a
    failed refresh slot leaves that view stale, and a transport error
    mid-frame restores every popped row before propagating. Views
    without the hooks fall back to their own `flush_writes`/`flush` +
    `refresh`. Returns rows/records applied by the refresh half.

    Sharded backends keep every one of those guarantees: a view's flush
    and refresh ops share a namespace, hence a shard, hence relative
    order within that shard's sub-frame (refresh still reads its own
    flush); a shard whose primary AND standby are down degrades to
    {"ok": false} slots for ITS ops only, so exactly the affected
    views re-queue while views on healthy shards proceed."""
    total = 0
    groups: List[Tuple[StateBackend, List]] = []
    for view in views:
        if view is None:
            continue
        if not (hasattr(view, "refresh_op")
                and hasattr(view, "apply_refresh")):
            for name in ("flush_writes", "flush"):
                fn = getattr(view, name, None)
                if callable(fn):
                    fn()
                    break
            refresh = getattr(view, "refresh", None)
            if callable(refresh):
                result = refresh()
                total += result if isinstance(result, int) else 0
            continue
        for backend, members in groups:
            if backend is view.backend:
                members.append(view)
                break
        else:
            groups.append((view.backend, [view]))
    for backend, members in groups:
        flushes = [(v, v.flush_ops() if hasattr(v, "flush_ops") else [])
                   for v in members]
        ops = [op for _v, vops in flushes for op in vops]
        ops += [v.refresh_op() for v in members]
        try:
            results = backend.batch(ops)
        except BaseException:
            for v, vops in flushes:
                if vops:
                    v.apply_flush(vops, None)
            raise
        i = 0
        for v, vops in flushes:
            if vops:
                v.apply_flush(vops, results[i:i + len(vops)])
            i += len(vops)
        for v in members:
            total += v.apply_refresh(results[i])
            i += 1
    return total


class LockedModelRegistry(BackendModelRegistry):
    """Back-compat file-backed registry: a BackendModelRegistry over a
    FileBackend rooted next to `path` (same concurrency guarantees as any
    backend registry — concurrent flushes lose no records)."""

    def __init__(self, path: str, autosave: bool = True,
                 lock_timeout_s: float = 10.0):
        self.lock_timeout_s = lock_timeout_s
        root, stem = _split_path(path, ".json")
        super().__init__(FileBackend(root, lock_timeout_s=lock_timeout_s),
                         namespace=stem, autosave=autosave, path=path)
