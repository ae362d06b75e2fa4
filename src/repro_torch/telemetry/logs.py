"""Structured logging: one JSON object per line on stderr.

The daemon (and anything else with a server lifecycle) logs through
this instead of ad-hoc `print(..., file=sys.stderr)`: every line is
machine-parseable `{"ts", "level", "component", "event", ...fields}`,
so multi-process test harnesses and log shippers stop grepping prose.
stdout is never touched — CLI contracts like the daemon's `--ping` ->
"pong" stay byte-identical.

    log = StructuredLogger("crispy-daemon")
    log.info("serving", unix=sock_path, tcp=tcp_addr)
    log.error("bind failed", error=str(e))

Levels: debug < info < warn < error; records below `level` are dropped.
Non-JSON-serializable field values are stringified rather than raised —
a log line must never take the server down.

Lines emitted inside an active trace span are stamped with `trace_id`
and `span_id` automatically, so stderr joins the distributed traces for
free (explicit `trace_id=`/`span_id=` fields win over the stamp).

A copy of the JAX package's ``repro/telemetry/logs.py``.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO

from repro_torch.telemetry.spans import current_span

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


class StructuredLogger:
    """Minimal leveled JSON-lines logger (stderr by default)."""

    def __init__(self, component: str, stream: Optional[TextIO] = None,
                 level: str = "info"):
        self.component = component
        self.stream = stream
        self.threshold = _LEVELS.get(level, 20)

    def log(self, level: str, event: str, **fields) -> None:
        if _LEVELS.get(level, 20) < self.threshold:
            return
        rec = {"ts": round(time.time(), 3), "level": level,
               "component": self.component, "event": event}
        sp = current_span()
        if sp is not None and sp.trace_id is not None:
            rec["trace_id"] = sp.trace_id
            rec["span_id"] = sp.span_id
        rec.update(fields)
        try:
            line = json.dumps(rec, default=str)
        except (TypeError, ValueError):     # pathological keys
            line = json.dumps({"ts": rec["ts"], "level": level,
                               "component": self.component,
                               "event": str(event)})
        stream = self.stream if self.stream is not None else sys.stderr
        try:
            print(line, file=stream, flush=True)
        except (OSError, ValueError):
            pass                            # closed stream on shutdown

    def debug(self, event: str, **fields) -> None:
        self.log("debug", event, **fields)

    def info(self, event: str, **fields) -> None:
        self.log("info", event, **fields)

    def warn(self, event: str, **fields) -> None:
        self.log("warn", event, **fields)

    def error(self, event: str, **fields) -> None:
        self.log("error", event, **fields)
