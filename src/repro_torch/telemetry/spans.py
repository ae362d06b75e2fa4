"""Nested, thread-aware wall-time spans over `contextvars`, with
distributed-trace identity.

A `span("name", **attrs)` block times itself and attaches to whatever
span is current in this context; the outermost span of a context becomes
a root and is recorded into a bounded in-memory `TraceRing` when it
closes. `contextvars` gives thread isolation for free: each thread (and
each asyncio task, should one ever appear) sees its own current-span
chain, so concurrent pipeline plans never splice into each other's
trees.

Every span carries distributed-tracing identity:

  trace_id    16 hex chars, minted when a trace's first span opens and
              inherited by every descendant — including descendants in
              OTHER processes (the daemon wire protocol forwards it).
  span_id     16 hex chars, unique per span.
  parent_id   the parent's span_id. For a local child this is implied by
              tree position; for a span adopted from a REMOTE parent
              (`span(..., parent={"trace_id": .., "span_id": ..})`) it
              is the only link — `stitch_fleet_traces` in
              repro_torch.telemetry.export grafts such roots back under their
              cross-process parent.

Clock discipline: each trace anchors wall-clock time ONCE — the root
span records an `(epoch, perf_counter)` pair when it opens, and every
descendant derives `started_at = epoch + (perf_counter_now - anchor)`.
Sibling spans therefore can never disagree with their walls after an
NTP step mid-trace: `time.time()` is consulted exactly once per local
trace, all offsets come from the monotonic clock.

    with span("pipeline.plan", signature=sig):
        with span("pipeline.acquire"):
            ...
    for root in default_ring().traces():
        print(root.to_dict())   # {"name", "trace_id", "span_id", ...}

Spans are deliberately tiny (one object, two perf_counter calls, one
contextvar set/reset, one 64-bit id draw) — cheap enough to leave on in
production hot paths; instrumented code that wants a zero-cost off
switch uses `span_if(enabled, ...)`, which degrades to a shared no-op
context manager.

`traced("name", **attrs)` is the other kind of range: one on the
device's timeline. While a `torch.profiler` records, it opens a
`torch.profiler.record_function` range of that name (a user annotation
in the profiler's trace, on the clock of its device events) and keeps
the range's host interval on `time.monotonic` (`traced_ranges()`);
otherwise it hands back the shared no-op context manager, for the cost
of one flag check. It never imports torch: a process that has not
loaded torch runs no profiler.

`current_trace_context()` returns the innermost open span's
`{"trace_id", "span_id"}` (or None) — the propagation token clients
stamp onto wire frames (see repro.state.transport.TRACE_FIELD) and
`StructuredLogger` stamps onto log lines.

A copy of the JAX package's ``repro/telemetry/spans.py``, but for
`traced`, the port's own.
"""
from __future__ import annotations

import contextvars
import random
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_current: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("crispy_current_span", default=None)

# id source: a private urandom-seeded Mersenne instance. getrandbits on
# a shared Random is a single C call (atomic under the GIL) and ~10x
# cheaper than os.urandom per span — collisions at 64 bits are
# negligible for bounded rings of short-lived traces.
_ids = random.Random()


def new_span_id() -> str:
    """A fresh 64-bit hex id (used for both trace and span ids)."""
    return f"{_ids.getrandbits(64):016x}"


class Span:
    """One timed block: identity, name, attributes, children, wall
    seconds. `anchor` is the trace's (epoch, perf_counter) pair — see
    the module docstring for the clock discipline."""

    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "started_at", "wall_s", "children", "thread", "anchor")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = attrs
        self.trace_id: Optional[str] = None
        self.span_id: Optional[str] = None
        self.parent_id: Optional[str] = None
        self.started_at = 0.0
        self.wall_s = 0.0
        self.children: List[Span] = []
        self.thread = threading.current_thread().name
        self.anchor = None          # (epoch_s, perf_counter_s) of the trace

    def context(self) -> Dict[str, str]:
        """The propagation token for this span: {"trace_id", "span_id"}."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def to_dict(self) -> Dict:
        out = {"name": self.name, "trace_id": self.trace_id,
               "span_id": self.span_id, "started_at": self.started_at,
               "wall_s": self.wall_s, "thread": self.thread}
        if self.parent_id is not None:
            out["parent_id"] = self.parent_id
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"wall_s={self.wall_s:.6f}, "
                f"children={len(self.children)})")


class TraceRing:
    """Bounded ring of finished ROOT spans (children live inside their
    roots). Thread-safe; oldest traces fall off the end. `recorded` is
    the monotonic count of roots ever recorded — ring wrap-around never
    hides throughput from the load benchmarks."""

    def __init__(self, cap: int = 256):
        self.cap = cap
        self._ring: "deque[Span]" = deque(maxlen=cap)
        self._recorded = 0
        self._lock = threading.Lock()

    def record(self, span_: Span) -> None:
        with self._lock:
            self._ring.append(span_)
            self._recorded += 1

    def traces(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    @property
    def recorded(self) -> int:
        with self._lock:
            return self._recorded

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_default_ring = TraceRing()


def default_ring() -> TraceRing:
    return _default_ring


def current_span() -> Optional[Span]:
    """The innermost open span of this thread/context, or None."""
    return _current.get()


def current_trace_context() -> Optional[Dict[str, str]]:
    """The innermost open span's {"trace_id", "span_id"}, or None —
    what wire clients stamp onto outgoing frames so remote work joins
    this trace."""
    s = _current.get()
    if s is None or s.trace_id is None:
        return None
    return {"trace_id": s.trace_id, "span_id": s.span_id}


class _SpanContext:
    """The `span(...)` context manager (a class, not @contextmanager:
    ~2x cheaper to enter and exit, and this sits on hot paths)."""

    __slots__ = ("_span", "_ring", "_parent", "_token", "_t0")

    def __init__(self, name: str, ring: Optional[TraceRing],
                 parent: Optional[Dict], attrs: Dict):
        self._span = Span(name, attrs)
        self._ring = ring
        self._parent = parent

    def __enter__(self) -> Span:
        s = self._span
        local_parent = _current.get()
        t0 = time.perf_counter()
        if local_parent is not None and local_parent.anchor is not None:
            # inherit the trace: identity AND its one clock anchor
            s.trace_id = local_parent.trace_id
            s.parent_id = local_parent.span_id
            s.anchor = local_parent.anchor
        else:
            remote = self._parent
            if remote:
                # adopted from another process/thread: same trace id,
                # remote span as parent — but a FRESH local clock anchor
                # (the remote one lives on a different host clock)
                s.trace_id = remote.get("trace_id") or new_span_id()
                s.parent_id = remote.get("span_id")
            else:
                s.trace_id = new_span_id()
            s.anchor = (time.time(), t0)
        s.span_id = new_span_id()
        s.started_at = s.anchor[0] + (t0 - s.anchor[1])
        self._token = _current.set(s)
        self._t0 = t0
        return s

    def __exit__(self, *exc) -> None:
        s = self._span
        s.wall_s = time.perf_counter() - self._t0
        _current.reset(self._token)
        parent = _current.get()
        if parent is not None:
            parent.children.append(s)
        else:
            (self._ring if self._ring is not None
             else _default_ring).record(s)


def span(name: str, ring: Optional[TraceRing] = None,
         parent: Optional[Dict] = None, **attrs) -> _SpanContext:
    """Open a timed span; nested calls build a tree, the outermost lands
    in `ring` (default: the process ring) when it exits. `parent` is an
    optional REMOTE trace context ({"trace_id", "span_id"}, e.g. taken
    off a wire frame): the span joins that trace as a cross-process
    child — ignored when a local parent span is already open."""
    return _SpanContext(name, ring, parent, attrs)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        pass


_NULL_SPAN = _NullSpan()


def span_if(enabled: bool, name: str, ring: Optional[TraceRing] = None,
            parent: Optional[Dict] = None, **attrs):
    """`span(...)` when `enabled`, else a shared no-op context manager —
    the branch instrumented hot paths use so a disabled registry costs
    one attribute load."""
    if not enabled:
        return _NULL_SPAN
    return _SpanContext(name, ring, parent, attrs)


class _Traced:
    """A ``record_function`` range that keeps its host interval."""

    __slots__ = ("_name", "_range", "_t0")

    def __init__(self, name: str, record_range):
        self._name = name
        self._range = record_range

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.monotonic()

    def __exit__(self, *exc):
        _traced.append((self._name, self._t0, time.monotonic()))
        self._range.__exit__(*exc)


# (name, start, end) of the last ranges `traced` closed, time.monotonic
_traced: "deque[tuple]" = deque(maxlen=1 << 20)


def traced(name: str, **attrs):
    """A ``record_function`` range `name` while a ``torch.profiler``
    records (`attrs` become its args, "key=value" joined by commas), else
    the shared no-op context manager."""
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is None or not profiler._is_profiler_enabled:
        return _NULL_SPAN
    args = ",".join(f"{k}={v}" for k, v in attrs.items()) or None
    return _Traced(name, profiler.record_function(name, args))


def traced_ranges() -> List[tuple]:
    """(name, start, end) on ``time.monotonic`` of the ranges `traced`
    opened and closed while a profiler recorded, the last 2**20, oldest
    first."""
    return list(_traced)
