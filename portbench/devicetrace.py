"""What a traced run reads from ``torch.profiler``: device intervals, the
window, and what the host was doing in the device's idle gaps.

The profiler's raw events (``kineto_results.events()``) are read once and
reduced to a summary in memory: no chrome trace is written. Device
operations are kernels, copies and fills; their union over the window is
the time the device was busy. An idle gap is named by the innermost host
event that spans its middle (an aten op, a CUDA runtime call, or one of the
benchmark's own ``portbench.*`` ranges), or "host" where none does.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW = "portbench.window"
TOP = 10


def _device_kind(event) -> str:
    return str(event.device_type()).rsplit(".", 1)[-1]


def _annotation(event) -> bool:
    """A ``record_function`` range: on the host it names what the host
    does; its copy on the device's timeline is no device operation."""
    user = getattr(event, "is_user_annotation", None)
    return bool(user()) if user is not None else \
        event.name().startswith("portbench.")


def summarise(prof) -> Dict:
    """The summary of a finished ``torch.profiler.profile``: window_s,
    busy_s, kernel seconds by name, device ops and idle gaps (top 10)."""
    events = prof.profiler.kineto_results.events()
    dev: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    window: Optional[Tuple[int, int]] = None
    for e in events:
        start, end = e.start_ns(), e.end_ns()
        on_device = _device_kind(e) in ("CUDA", "PrivateUse1")
        if on_device and not _annotation(e):
            dev.append((start, end, e.name()))
        elif not on_device and e.name() == WINDOW:
            window = (start, end)
        elif not on_device:
            host.append((start, end, e.name()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    return reduce(dev, host, window)


def reduce(dev: List[Tuple[int, int, str]], host: List[Tuple[int, int, str]],
           window: Tuple[int, int]) -> Dict:
    """The summary from device and host intervals in ns (start, end, name)
    and the window (start, end); a pure function, tested on synthetic
    intervals."""
    w0, w1 = window
    by_name: Dict[str, float] = defaultdict(float)
    clipped = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e))
            by_name[name] += (e - s) * 1e-9
    clipped.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, None
    last_end = w0
    for s, e in clipped:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last_end = max(last_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > last_end:
        gaps.append((last_end, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = _name_gaps(gaps[:200], host)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "kernel_s": dict(by_name),
            "device_ops": [[name[:160], secs] for name, secs in ops],
            "idle_gaps": named[:TOP]}


def _name_gaps(gaps, host) -> List[List]:
    """[name, seconds] of each gap, longest first; the name is the
    innermost host event spanning the gap's middle."""
    if not gaps:
        return []
    if host:
        starts = np.array([h[0] for h in host], dtype=np.int64)
        ends = np.array([h[1] for h in host], dtype=np.int64)
        names = [h[2] for h in host]
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        name = "host"
        if host:
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if inside.size:
                i = inside[np.argmin(ends[inside] - starts[inside])]
                name = names[i]
        out.append([name[:160], (e - s) * 1e-9])
    return out


def kernel_seconds(summary: Dict, match, exclude=()) -> float:
    """Seconds of the kernels whose name contains `match` and none of
    `exclude`."""
    return sum(secs for name, secs in summary["kernel_s"].items()
               if match in name and not any(x in name for x in exclude))
