"""Persistent memory-model registry keyed by job signature.

The paper assumes jobs are too unique to recur — but a *service* sees the
same signature again and again (the same nightly ETL job over a growing
dataset). The registry closes that loop: once a job's memory model passes
its confidence gate, repeated allocation requests skip profiling entirely
and go straight to selection.

JSON-backed so a service restart keeps its models; each record also keeps
the training ladder (sizes, mems) so the nearest-job classifier can rebuild
its feature store from disk. Thread-safe: the AllocationService worker and
any direct callers share one lock.

A copy of the JAX package's ``repro/allocator/registry.py``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.allocator.model_zoo import model_from_dict, model_to_dict

REGISTRY_VERSION = 1


@dataclass
class ModelRecord:
    signature: str
    model: object                   # fitted memory model (MODEL_KINDS)
    candidate: str                  # model kind that won selection
    sizes: List[float] = field(default_factory=list)
    mems: List[float] = field(default_factory=list)
    created_at: float = 0.0
    hits: int = 0
    # runtime companion model (MODEL_KINDS runtime_* kinds) + the ladder
    # wall times it was fit on; absent in records written by older versions
    runtime_model: Optional[object] = None
    runtime_candidate: Optional[str] = None
    walls: List[float] = field(default_factory=list)

    def to_dict(self) -> Dict:
        d = {"model": model_to_dict(self.model),
             "candidate": self.candidate,
             "sizes": list(self.sizes), "mems": list(self.mems),
             "created_at": self.created_at, "hits": self.hits}
        if self.runtime_model is not None:
            d["runtime_model"] = model_to_dict(self.runtime_model)
            d["runtime_candidate"] = self.runtime_candidate
        if self.walls:
            d["walls"] = list(self.walls)
        return d

    @classmethod
    def from_dict(cls, signature: str, d: Dict) -> "ModelRecord":
        rm = d.get("runtime_model")
        runtime_model = model_from_dict(rm) if rm else None
        return cls(signature, model_from_dict(d["model"]),
                   d.get("candidate", d["model"].get("kind", "linear")),
                   list(d.get("sizes", [])), list(d.get("mems", [])),
                   float(d.get("created_at", 0.0)), int(d.get("hits", 0)),
                   runtime_model=runtime_model,
                   runtime_candidate=d.get("runtime_candidate"),
                   walls=list(d.get("walls", [])))


class ModelRegistry:
    def __init__(self, path: Optional[str] = None, autosave: bool = True):
        self.path = path
        self.autosave = autosave
        self._lock = threading.RLock()
        self._records: Dict[str, ModelRecord] = {}
        self._dirty = False
        if path is not None and os.path.exists(path):
            self.load()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def __contains__(self, signature: str) -> bool:
        with self._lock:
            return signature in self._records

    def signatures(self) -> List[str]:
        with self._lock:
            return sorted(self._records)

    def records(self) -> List[ModelRecord]:
        with self._lock:
            return list(self._records.values())

    def get(self, signature: str,
            count_hit: bool = True) -> Optional[ModelRecord]:
        with self._lock:
            rec = self._records.get(signature)
            if rec is not None and count_hit:
                rec.hits += 1
            return rec

    def put(self, signature: str, model, candidate: Optional[str] = None,
            sizes: Sequence[float] = (), mems: Sequence[float] = (),
            defer_save: bool = False, runtime_model=None,
            runtime_candidate: Optional[str] = None,
            walls: Sequence[float] = ()) -> ModelRecord:
        """Store a model. `defer_save=True` marks the registry dirty
        instead of rewriting the JSON file (which is O(all records)) —
        the AllocationService uses it and calls `flush()` once per batch."""
        if runtime_model is not None and runtime_candidate is None:
            runtime_candidate = getattr(runtime_model, "kind", None)
        rec = ModelRecord(signature, model,
                          candidate or getattr(model, "kind", "linear"),
                          list(sizes), list(mems), time.time(),
                          runtime_model=runtime_model,
                          runtime_candidate=runtime_candidate,
                          walls=list(walls))
        with self._lock:
            self._records[signature] = rec
            self._dirty = True
            if not defer_save and self.autosave and self.path is not None:
                self._save_locked(self.path)
        return rec

    def flush(self) -> None:
        """Write deferred puts to disk, one file rewrite for many puts."""
        with self._lock:
            if self._dirty and self.autosave and self.path is not None:
                self._save_locked(self.path)

    def evict(self, signature: str) -> bool:
        with self._lock:
            gone = self._records.pop(signature, None) is not None
            if gone:
                self._dirty = True
                if self.autosave and self.path is not None:
                    self._save_locked(self.path)
            return gone

    # -- persistence --------------------------------------------------------
    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if path is None:
            raise ValueError("ModelRegistry has no path to save to")
        with self._lock:
            self._save_locked(path)

    def _save_locked(self, path: str) -> None:
        payload = {"version": REGISTRY_VERSION,
                   "records": {sig: rec.to_dict()
                               for sig, rec in self._records.items()}}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)       # atomic on POSIX: no torn reads
        self._dirty = False

    def load(self, path: Optional[str] = None) -> int:
        path = path or self.path
        if path is None:
            raise ValueError("ModelRegistry has no path to load from")
        with open(path) as f:
            payload = json.load(f)
        records = payload.get("records", {})
        with self._lock:
            self._records = {sig: ModelRecord.from_dict(sig, d)
                             for sig, d in records.items()}
            return len(self._records)
