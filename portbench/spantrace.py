"""The program's own ranges in a traced run: the phases of the planner and
of the MoE prefill that ``repro_torch.telemetry.traced`` opens while a
profiler records ("planner.point", "planner.release", "planner.build",
"planner.step", "prefill.attention", "prefill.moe", "moe.count_wait").

Two readings of them:

- ``program_host(ctx, name)``: from the program's own record of its ranges
  (``repro_torch.telemetry.traced_ranges``, host intervals on
  ``time.monotonic``), clipped to the window's requests. The per-layer
  readers ``release.plan`` and ``moe_wait.prefill`` read this; on a program
  without the record they read nothing.
- ``summarise(prof)``: from the profiler's own events, for every user
  annotation on the host (the program's ranges and the benchmark's
  ``portbench.*``): ``n``, ``host_s`` (the union of its intervals in the
  window), ``idle_s`` (the device-idle seconds inside that union) and
  ``device_s`` (the device seconds of the operations launched while a
  range of that name was open: each kernel, copy or fill joined to the
  CUDA runtime or driver call that launched it by the events' correlation
  id). ``table`` is its pure core, tested on synthetic intervals.

  python3 -m portbench.spantrace --workload <name> --seed <n> --seconds <s>

runs the cell as ``run.py --trace 1`` does and prints, to standard error
before the check lines, the span table and the shares of ``SHARES`` that the
table gives.
"""
from __future__ import annotations

import importlib
import sys
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.devicetrace import WINDOW, _annotation, _device_kind


def _union(starts: np.ndarray, ends: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """The union of intervals, as sorted disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    first = np.ones(s.size, dtype=bool)
    first[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(first)
    return s[idx], np.append(reach[idx[1:] - 1], reach[-1])


def _below(starts: np.ndarray, ends: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The measure of the disjoint sorted intervals below each time t."""
    if starts.size == 0:
        return np.zeros(t.shape)
    before = np.concatenate(([0], np.cumsum(ends - starts)))
    i = np.searchsorted(starts, t, side="right") - 1
    j = np.maximum(i, 0)
    part = np.clip(t - starts[j], 0, ends[j] - starts[j])
    return np.where(i >= 0, before[j] + part, 0)


def table(dev: List[Tuple[int, int, Optional[int]]],
          ranges: List[Tuple[int, int, str]],
          window: Tuple[int, int]) -> Dict[str, Dict[str, float]]:
    """For each name of `ranges` (host intervals in ns: start, end, name)
    that meets the window: n, host_s, idle_s, device_s. `dev` holds the
    device operations (start, end, and the ns at which the host launched
    it, or None where no launch was found); idle is the window less the
    union of `dev`, as ``devicetrace.reduce`` counts it."""
    w0, w1 = window
    d = np.array([(max(s, w0), min(e, w1), -1 if t is None else t)
                  for s, e, t in dev], dtype=np.int64).reshape(-1, 3)
    d = d[d[:, 1] > d[:, 0]]
    busy_s, busy_e = _union(d[:, 0], d[:, 1])
    gap_s = np.concatenate(([w0], busy_e))
    gap_e = np.concatenate((busy_s, [w1]))
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    launched = d[:, 2] >= 0
    when, secs = d[launched, 2], (d[launched, 1] - d[launched, 0]) * 1e-9

    by_name: Dict[str, List[Tuple[int, int]]] = {}
    for s, e, name in ranges:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_name.setdefault(name, []).append((s, e))
    out = {}
    for name, iv in sorted(by_name.items()):
        a = np.array(iv, dtype=np.int64)
        us, ue = _union(a[:, 0], a[:, 1])
        idle = _below(gap_s, gap_e, ue) - _below(gap_s, gap_e, us)
        i = np.searchsorted(us, when, side="right") - 1
        inside = (i >= 0) & (when < ue[np.maximum(i, 0)])
        out[name] = {"n": len(iv), "host_s": float((ue - us).sum()) * 1e-9,
                     "idle_s": float(idle.sum()) * 1e-9,
                     "device_s": float(secs[inside].sum())}
    return out


def summarise(prof) -> Dict:
    """The span table of a finished ``torch.profiler.profile`` whose window
    is the ``portbench.window`` range, with ``launch_found``: the share of
    the window's device seconds whose launch the correlation ids found."""
    events = prof.profiler.kineto_results.events()
    launch: Dict[int, int] = {}
    ops, ranges = [], []
    window = None
    for e in events:
        if _device_kind(e) in ("CUDA", "PrivateUse1"):
            if not _annotation(e):
                ops.append(e)
        elif e.name() == WINDOW:
            window = (e.start_ns(), e.end_ns())
        elif e.is_user_annotation():
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.name().startswith("cu"):     # a CUDA runtime or driver call
            launch[e.correlation_id()] = e.start_ns()
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    dev = []
    for e in ops:
        dev.append((e.start_ns(), e.end_ns(), launch.get(e.correlation_id())))
    w0, w1 = window
    total = sum(max(0, min(e, w1) - max(s, w0)) for s, e, _ in dev)
    found = sum(max(0, min(e, w1) - max(s, w0)) for s, e, t in dev
                if t is not None)
    return {"spans": table(dev, ranges, window),
            "launch_found": found / total if total else None}


def _share(name: str, key: str, of: str):
    def read(spans: Dict, trace: Dict) -> Optional[float]:
        if name not in spans or trace[of] <= 0:
            return None
        return 100.0 * spans[name][key] / trace[of]
    return read


# the shares the span table gives, in %, by the name a per-layer metric of
# each would take
SHARES = {
    "release.plan": _share("planner.release", "host_s", "window_s"),
    "init_share.plan": _share("planner.build", "device_s", "busy_s"),
    "moe_wait.prefill": _share("moe.count_wait", "host_s", "window_s"),
    "idle_moe.prefill": _share("prefill.moe", "idle_s", "window_s"),
    "idle_attention.prefill": _share("prefill.attention", "idle_s",
                                     "window_s"),
}


def program_host(ctx: Dict, name: str) -> Optional[Dict[str, float]]:
    """{n, host_s} of the program's own ranges `name` inside the window's
    requests (the first one's start to the last one's end), from
    ``repro_torch.telemetry.traced_ranges``; None where the program keeps
    no such record or holds no such range there."""
    spans = importlib.import_module("repro_torch.telemetry.spans")
    record = getattr(spans, "traced_ranges", None)
    reqs = ctx["record"]["requests"]
    if record is None or not reqs:
        return None
    w0 = min(r["done"] - r["latency_s"] for r in reqs)
    w1 = max(r["done"] for r in reqs)
    iv = [(max(s, w0), min(e, w1)) for n, s, e in record()
          if n == name and min(e, w1) > max(s, w0)]
    if not iv:
        return None
    a = np.array(iv, dtype=np.float64)
    us, ue = _union(a[:, 0], a[:, 1])
    return {"n": len(iv), "host_s": float((ue - us).sum())}


def print_table(spans: Dict, shares: Dict, log=sys.stderr) -> None:
    print("span name n host_s idle_s device_s", file=log)
    for name, row in spans.items():
        print(f"span {name} {row['n']} {row['host_s']!r} {row['idle_s']!r} "
              f"{row['device_s']!r}", file=log)
    for name, value in shares.items():
        print(f"span share {name}: {value!r}", file=log)


@contextmanager
def recording(into: Dict, log=sys.stderr):
    """While open, a traced ``harness.run`` also reduces the profiler's
    events to the span table, puts it in `into` ("spans", "launch_found",
    "shares", and "kernel_s": the window's device seconds) and prints it to
    `log` before the check lines."""
    from portbench import harness
    real = harness.summarise

    def both(prof):
        summary = real(prof)
        into.update(summarise(prof),
                    kernel_s=sum(summary["kernel_s"].values()))
        into["shares"] = {name: read(into["spans"], summary)
                          for name, read in SHARES.items()}
        print_table(into["spans"], into["shares"], log)
        print(f"span launch_found {into['launch_found']!r} of "
              f"{into['kernel_s']!r} device seconds", file=log)
        return summary

    harness.summarise = both
    try:
        yield into
    finally:
        harness.summarise = real


def main(argv=None) -> int:
    from portbench import run
    with recording({}):
        return run.main(list(argv if argv is not None else sys.argv[1:]) +
                        ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
