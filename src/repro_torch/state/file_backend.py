"""FileBackend: the StateBackend over fcntl-locked files.

This module is the ONLY place in the package that touches fcntl — it absorbs
the locking/JSONL machinery that was once duplicated across
`repro_torch.profiling.store.ProfileStore` and `LockedModelRegistry`.

Layout under the backend root (one directory shared by all processes):

  <ns>.jsonl        append-only log. Appends happen under an exclusive
                    lock as a single O_APPEND write, so concurrent writers
                    never interleave partial lines; `read` consumes bytes
                    from an offset cursor and only complete lines.
  <ns>.jsonl.meta   cursor base of a compacted log: {"base": n}. Logical
                    cursor = base + byte offset in the current file;
                    `compact` folds the log (tmp + rename) and bumps the
                    base past every pre-compaction cursor, so stale
                    cursors re-read the folded snapshot instead of
                    landing mid-line in the rewritten file. The meta file
                    persists with the log, which is what makes a
                    compacted daemon --root survive restarts.
  <ns>.json         versioned documents of the namespace:
                    {"docs": {key: {"version": n, "value": {...}}}}.
                    `cas` rewrites the file atomically (tmp + rename)
                    under an exclusive lock.
  <file>.lock       fcntl advisory lock files (created on demand).

Namespaces are sanitized into filenames, so `FileBackend(dir)` with
namespace "prof" shares state with any process that opens the same
directory — the cross-process story is the filesystem.

A copy of the JAX package's ``repro/state/file_backend.py``.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.state.backend import StateBackend
from repro_torch.state.compaction import fold_log

try:
    import fcntl
    HAS_FCNTL = True
except ImportError:                      # non-POSIX: degrade gracefully
    fcntl = None
    HAS_FCNTL = False

# characters of a namespace that may not appear in a file name
_NS_RE = r"[^A-Za-z0-9._-]+"


class FileLock:
    """fcntl advisory lock on `path` (created on demand). Not reentrant
    within a process — hold it briefly. Degrades to a no-op lock where
    fcntl is unavailable (the O_APPEND write and atomic rename below are
    then the only cross-process guarantees)."""

    def __init__(self, path: str, shared: bool = False,
                 timeout_s: float = 10.0, poll_s: float = 0.005):
        self.path = path
        self.shared = shared
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self._fd: Optional[int] = None

    def acquire(self) -> "FileLock":
        self._fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        if not HAS_FCNTL:
            return self
        flag = fcntl.LOCK_SH if self.shared else fcntl.LOCK_EX
        deadline = time.monotonic() + self.timeout_s
        while True:
            try:
                fcntl.flock(self._fd, flag | fcntl.LOCK_NB)
                return self
            except (BlockingIOError, OSError):
                if time.monotonic() >= deadline:
                    os.close(self._fd)
                    self._fd = None
                    raise TimeoutError(
                        f"could not lock {self.path} within "
                        f"{self.timeout_s}s")
                time.sleep(self.poll_s)

    def release(self) -> None:
        if self._fd is None:
            return
        try:
            if HAS_FCNTL:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
        finally:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "FileLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class FileBackend(StateBackend):
    kind = "file"

    def __init__(self, root: str, lock_timeout_s: float = 10.0):
        self.root = root
        self.lock_timeout_s = lock_timeout_s
        os.makedirs(root, exist_ok=True)

    # -- paths --------------------------------------------------------------
    def _ns(self, ns: str) -> str:
        clean = re.sub(_NS_RE, "_", ns).strip("._") or "default"
        return os.path.join(self.root, clean)

    def log_path(self, ns: str) -> str:
        return self._ns(ns) + ".jsonl"

    def doc_path(self, ns: str) -> str:
        return self._ns(ns) + ".json"

    def _lock(self, path: str, shared: bool = False) -> FileLock:
        return FileLock(path + ".lock", shared=shared,
                        timeout_s=self.lock_timeout_s)

    # -- append-only logs ---------------------------------------------------
    def append(self, ns: str, record: Dict) -> None:
        line = (json.dumps(record) + "\n").encode()
        path = self.log_path(ns)
        with self._lock(path):
            fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                os.write(fd, line)
            finally:
                os.close(fd)

    def read(self, ns: str, cursor: int = 0) -> Tuple[List[Dict], int]:
        path = self.log_path(ns)
        if not os.path.exists(path):
            return [], cursor
        with self._lock(path, shared=True):
            base = self._read_base(path)
            # a cursor below the compaction base predates the last fold:
            # restart at the snapshot head (rows are idempotent)
            offset = max(0, cursor - base)
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read()
        if not data:
            return [], max(cursor, base + offset)
        # only consume complete lines; a torn tail (should not happen under
        # the lock, but be paranoid) is re-read by the next call
        end = data.rfind(b"\n") + 1
        rows: List[Dict] = []
        for line in data[:end].splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except ValueError:
                continue            # skip a corrupt row, keep the rest
        return rows, base + offset + end

    def compact(self, ns: str,
                key_fields: Optional[Sequence[str]] = None,
                max_age_s: Optional[float] = None) -> Dict:
        path = self.log_path(ns)
        if not os.path.exists(path):
            return {"before": 0, "after": 0, "dropped": 0}
        with self._lock(path):
            with open(path, "rb") as f:
                data = f.read()
            old_base = self._read_base(path)
            rows = []
            for line in data.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue
            folded = fold_log(rows, key_fields=key_fields,
                              max_age_s=max_age_s)
            # bump the base FIRST: a crash between the two writes leaves
            # base past every handed-out cursor with the old log intact —
            # readers re-read from the head, nothing tears. (No reader
            # runs in between anyway: both writes happen under the
            # exclusive lock `read` takes shared.)
            self._write_base(path, old_base + len(data))
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                for row in folded:
                    f.write((json.dumps(row) + "\n").encode())
            os.replace(tmp, path)
            return {"before": len(rows), "after": len(folded),
                    "dropped": len(rows) - len(folded)}

    def _meta_path(self, log_path: str) -> str:
        return log_path + ".meta"

    def _read_base(self, log_path: str) -> int:
        try:
            with open(self._meta_path(log_path)) as f:
                return int(json.load(f).get("base", 0))
        except (OSError, ValueError):
            return 0

    def _write_base(self, log_path: str, base: int) -> None:
        meta = self._meta_path(log_path)
        tmp = meta + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"base": base}, f)
        os.replace(tmp, meta)

    # -- versioned documents ------------------------------------------------
    def _read_docs(self, path: str) -> Dict[str, Dict]:
        if not os.path.exists(path):
            return {}
        try:
            with open(path) as f:
                payload = json.load(f)
        except ValueError:              # half-written legacy file
            return {}
        docs = payload.get("docs")
        return docs if isinstance(docs, dict) else {}

    def _write_docs(self, path: str, docs: Dict[str, Dict]) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"docs": docs}, f)
        os.replace(tmp, path)       # atomic on POSIX: no torn reads

    # -- replication enumeration --------------------------------------------
    # The shipper sees the SANITIZED namespace (the filename stem). That is
    # fine: sanitization is a fixpoint, so re-applying ops under the stem on
    # the standby lands in the same files, and every daemon-facing caller
    # already uses filename-safe namespaces.
    def log_namespaces(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(f[:-len(".jsonl")] for f in names
                      if f.endswith(".jsonl"))

    def doc_snapshot(self) -> List[Tuple[str, str, Optional[Dict], int]]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out: List[Tuple[str, str, Optional[Dict], int]] = []
        for f in sorted(names):
            if not f.endswith(".json"):
                continue
            ns = f[:-len(".json")]
            path = os.path.join(self.root, f)
            with self._lock(path, shared=True):
                docs = self._read_docs(path)
            for key in sorted(docs):
                entry = docs[key]
                out.append((ns, key, entry.get("value"),
                            int(entry.get("version", 0))))
        return out

    def load(self, ns: str, key: str) -> Tuple[Optional[Dict], int]:
        path = self.doc_path(ns)
        with self._lock(path, shared=True):
            entry = self._read_docs(path).get(key)
        if entry is None:
            return None, 0
        return entry.get("value"), int(entry.get("version", 0))

    def cas(self, ns: str, key: str, version: int,
            value: Dict) -> Tuple[bool, Optional[Dict], int]:
        path = self.doc_path(ns)
        with self._lock(path):
            docs = self._read_docs(path)
            entry = docs.get(key)
            cur_ver = int(entry.get("version", 0)) if entry else 0
            if cur_ver != version:
                return False, (entry.get("value") if entry else None), cur_ver
            docs[key] = {"version": cur_ver + 1, "value": value}
            self._write_docs(path, docs)
            return True, value, cur_ver + 1
