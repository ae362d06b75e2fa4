"""crispy-daemon: a single-writer shared-state server, unix socket + TCP.

The FileBackend shares state through fcntl locks — correct, but every CAS
is a lock/read/rewrite of a JSON file and contended reservations retry
through the filesystem. The daemon centralizes writes the way Ruya
centralizes its iteratively-updated memory model: ONE process owns the
state and applies every mutation atomically under one lock, and clients
talk to it over a newline-delimited JSON protocol (framing/address
parsing in transport.py). `reserve` becomes a single round trip instead
of a CAS retry loop, so N allocation-service processes arbitrate one
profiling envelope with no lock convoys.

Two transports, same protocol, served simultaneously:

  unix socket   --socket /tmp/crispy.sock — co-located services on one
                host, gated by filesystem permissions.
  tcp           --listen host:port — services on OTHER hosts share the
                same envelope/registry/store. Port 0 binds an ephemeral
                port; the resolved address is announced in the "serving"
                log line and written to --port-file when given. TCP crosses the
                unix-permission boundary, so pair it with --auth-token
                (or $CRISPY_DAEMON_TOKEN): the first frame on every
                connection must then be {"op": "auth", "token": ...}.

Wire protocol (one JSON object per line, request -> response):

  {"op": "auth", "token": ..}                      -> {"ok": true}
  {"op": "ping"}                                   -> {"ok": true}
  {"op": "append", "ns": .., "record": {..}}       -> {"ok": true}
  {"op": "read", "ns": .., "cursor": 0}            -> {"ok": true,
                                                       "rows": [..],
                                                       "cursor": n}
  {"op": "load", "ns": .., "key": ..}              -> {"ok": true,
                                                       "value": ..,
                                                       "version": n}
  {"op": "cas", "ns": .., "key": .., "version": n,
   "value": {..}}                                  -> {"ok": true,
                                                       "won": bool, ..}
  {"op": "reserve", "ns": .., "key": ..,
   "deltas": {..}, "limits": {..}}                 -> {"ok": true,
                                                       "granted": bool,
                                                       "doc": {..}}
  {"op": "compact", "ns": .., "key_fields": [..],
   "max_age_s": ..}                                -> {"ok": true,
                                                       "before": n,
                                                       "after": m,
                                                       "dropped": n-m}
  {"op": "evict_registry", "ns": .., "key": ..,
   "max_records": .., "max_age_s": ..}             -> {"ok": true,
                                                       "evicted": [..]}
  {"op": "metrics"}                                -> {"ok": true,
                                                       "metrics": {..}}
  {"op": "traces", "clear": false}                 -> {"ok": true,
                                                       "source": ..,
                                                       "traces": [..]}
  {"op": "replicate", "log": {..} | "doc": {..}}   -> {"ok": true,
                                                       "applied": ..,
                                                       "cursor"/"version"}
  {"op": "batch", "ops": [<frame>, ..]}            -> {"ok": true,
                                                       "results": [..]}
  {"op": "shutdown"}                               -> {"ok": true}

`batch` carries N sub-op frames in one round trip: exactly one result
per sub-op, in order, with per-op error isolation (a failing sub-op
contributes its own {"ok": false, "error": ..} slot and the rest still
run). `auth`, `shutdown` and `batch` itself may not nest inside it. The
daemon dispatches the sub-ops in a tight loop — one frame decode, one
batch span — while still timing each sub-op into its
`daemon.op.<op>.seconds` histogram, and records the distribution of
batch widths in `daemon.batch.size`. Clients may also PIPELINE legacy
single-op frames (write N lines, then read N responses — the daemon
answers strictly in order per connection); `DaemonBackend.pipeline()`
wraps that, and `DaemonBackend.batch()` wraps the batch frame with
automatic chunking under the frame cap. The shared views coalesce
automatically: `repro_torch.profiling.store.refresh_views` fetches the
profile-store tail and the registry doc in one frame, and
`ProfileStore(write_behind=True)` flushes buffered point/anchor writes
as one batched append frame.

Additionally, ANY request frame may carry a `trace` field — the
caller's {"trace_id", "span_id"} propagation token (see
repro_torch.state.transport and repro_torch.telemetry). The daemon then times the
op inside a `daemon.op.<op>` span ADOPTED into the caller's trace
(recorded as a local root in the daemon's TraceRing, parent_id = the
caller's span), so `stitch_fleet_traces` can graft daemon work under
the requesting service's tree. Frames without the field — everything an
old client sends — take the pre-tracing code path and get
byte-identical responses, on both transports.

`metrics` returns the daemon's own telemetry snapshot (repro_torch.telemetry):
per-op latency histograms `daemon.op.<op>.seconds` (with exemplars
referencing traced callers) plus frames/bytes_in/auth_failures/
compactions counters — identical over both transports. `traces` returns
(and with `"clear": true` drains) the daemon's finished trace roots as
span dicts. Server-side lifecycle events (serving announcement, errors,
clean shutdown) are structured one-line JSON on stderr
(`StructuredLogger`); the CLI's stdout answers ("pong", "no daemon",
"shutdown requested") are a scripting contract and never change shape.

Log compaction + registry eviction: append-only namespaces grow forever
under "later rows win", so `compact` folds a log into snapshot-plus-tail
form (repro_torch.state.compaction) — cursors stay monotone, tombstoned
identities stay dead, and with a FileBackend --root the shrunken log
survives restarts. `--compact-after N` auto-compacts any log namespace
every N appends (optionally dropping rows older than
`--compact-max-age`); `--registry-max-records` / `--registry-max-age`
prune the model-registry document after each registry flush, recording
doc tombstones so sibling services cannot resurrect the eviction.

Lifecycle (also documented in the repro_torch.state package docstring):

  start     python -m repro_torch.state.daemon --socket /tmp/crispy.sock \
                [--listen 0.0.0.0:7421] [--root DIR | --memory]
            --root persists state through a FileBackend so a restarted
            daemon resumes where it stopped; --memory (the default when no
            root is given) serves an InMemoryBackend. With --listen and
            no --socket the daemon is TCP-only.
  health    python -m repro_torch.state.daemon --socket ... --ping   (or
            --listen host:port --ping) exits 0 iff the daemon answers.
  shutdown  python -m repro_torch.state.daemon --socket ... --shutdown
            asks the daemon to stop; the server drains, unlinks its
            socket and the foreground process exits 0. SIGTERM/SIGINT do
            the same.

Clients (`DaemonBackend`) accept either address form ("/tmp/crispy.sock"
or "host:port" / "tcp://host:port"), keep one connection per thread and
reconnect once on a transport error — a daemon restarted on the same
address is picked up transparently; a daemon that stays down surfaces
`StateBackendUnavailable` naming the exact unix path or host:port it
could not reach.

Sharding + warm-standby replication (repro_torch.state.sharding): a daemon
started with `--shard-name shard-0 --standby ADDR` runs a
`ReplicationShipper` that periodically ships log tails and changed
documents to the standby daemon via batched `replicate` frames
(idempotent by cursor/version; `--replicate-interval` sets the period).
The applied `replicate` op is purely additive to the wire protocol —
legacy frames stay byte-identical (pinned by the conformance suite).
`--shard-name` also tags the daemon's telemetry source as
"crispy-daemon@<shard>", so fleet snapshots and `trace_tool --fleet`
attribute per-op heat to the right shard. Clients carrying `standby=`
fail over: on `StateBackendUnavailable` they retry the standby address
once and re-resolve the shard's primary from the topology doc stored
on the ring itself (sharding.publish_topology).

A copy of the JAX package's ``repro/state/daemon.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import socketserver
import sys
import tempfile
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.state.backend import (InMemoryBackend, StateBackend,
                                 StateBackendError, StateBackendUnavailable)
from repro_torch.state.compaction import prune_registry_doc
from repro_torch.state.file_backend import FileBackend
from repro_torch.state.transport import (BATCH_EXCLUDED_OPS, BATCH_OP,
                                   MAX_FRAME_BYTES, TOPOLOGY_KEY,
                                   TOPOLOGY_NS, TRACE_FIELD,
                                   auth_frame, connect,
                                   default_auth_token, describe_address,
                                   parse_address, recv_frame, send_frame)
from repro_torch.telemetry import (MetricsRegistry, StructuredLogger,
                             TelemetryPublisher, TraceRing,
                             current_trace_context, span)
from time import perf_counter, sleep

HAS_UNIX_SOCKETS = hasattr(socket, "AF_UNIX")

DEFAULT_SOCKET = os.path.join(tempfile.gettempdir(), "crispy-daemon.sock")
DEFAULT_TIMEOUT_S = 10.0

REGISTRY_NS = "registry"
REGISTRY_KEY = "records"


def default_socket_path() -> str:
    return os.environ.get("CRISPY_DAEMON_SOCKET", DEFAULT_SOCKET)


class CrispyDaemon:
    """Single-writer state server. Owns a local backend (InMemoryBackend
    by default, FileBackend when constructed with `root=` for durability
    across restarts), serializes every mutation under one lock, and
    serves it over a unix socket (`socket_path`), TCP (`listen`,
    "host:port" — port 0 for ephemeral), or both at once."""

    def __init__(self, socket_path: Optional[str] = None,
                 backend: Optional[StateBackend] = None,
                 root: Optional[str] = None,
                 listen: Optional[str] = None,
                 auth_token: Optional[str] = None,
                 compact_after: Optional[int] = None,
                 compact_max_age_s: Optional[float] = None,
                 registry_max_records: Optional[int] = None,
                 registry_max_age_s: Optional[float] = None,
                 telemetry=None,            # repro_torch.telemetry MetricsRegistry
                 standby: Optional[str] = None,
                 replicate_interval_s: float = 0.5,
                 shard_name: Optional[str] = None,
                 op_delay_s: float = 0.0):
        if socket_path is None and listen is None:
            raise StateBackendError(
                "CrispyDaemon needs a unix socket_path, a tcp listen "
                "address, or both")
        if socket_path is not None and not HAS_UNIX_SOCKETS:
            raise StateBackendError(        # pragma: no cover - non-POSIX
                "unix-domain sockets are unavailable on this platform; "
                "use listen='host:port'")
        if backend is None:
            backend = FileBackend(root) if root else InMemoryBackend()
        self.backend = backend
        self.socket_path = socket_path
        self.listen = listen
        self.auth_token = auth_token
        self.compact_after = compact_after
        self.compact_max_age_s = compact_max_age_s
        self.registry_max_records = registry_max_records
        self.registry_max_age_s = registry_max_age_s
        # warm-standby replication (repro_torch.state.sharding): when `standby`
        # names another daemon, start() launches a ReplicationShipper that
        # periodically ships this daemon's state there; `shard_name` tags
        # the telemetry source so fleet views attribute per-shard heat
        self.standby = standby
        self.replicate_interval_s = replicate_interval_s
        self.shard_name = shard_name
        self.shipper = None                      # set by start() if standby
        self._applier = None                     # lazy ReplicationApplier
        # opt-in per-mutation service-time model (--op-delay): slept
        # INSIDE the writer lock, where a durable backend would pay its
        # fsync — makes shard-topology scaling measurable on hosts with
        # fewer cores than shards, and widens failover race windows for
        # tests. Zero (the default) is a no-op on the hot path.
        self.op_delay_s = float(op_delay_s)
        self.tcp_address: Optional[str] = None   # resolved after start()
        self._write_lock = threading.Lock()
        self._appends_since_compact: Dict[str, int] = {}
        self._servers: List[socketserver.BaseServer] = []
        # servers whose serve_forever loop was started: shutdown() on a
        # never-served socketserver blocks forever on its is-shut-down
        # event, so stop() must only shut these down and merely close
        # the rest (a bound-but-unserved server from a failed start())
        self._serving: set = set()
        self._threads: List[threading.Thread] = []
        # open client connections, severed on stop() so handler threads
        # (daemon_threads) don't keep serving a "stopped" daemon
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        # per-daemon registry by default: two daemons in one test process
        # must not sum each other's counters. Served as the `metrics` op.
        self.telemetry = telemetry if telemetry is not None \
            else MetricsRegistry()
        self._c_frames = self.telemetry.counter("daemon.frames")
        self._c_bytes = self.telemetry.counter("daemon.bytes_in")
        self._c_auth_failures = self.telemetry.counter(
            "daemon.auth_failures")
        self._c_compactions = self.telemetry.counter("daemon.compactions")
        # sub-ops per {"op": "batch"} frame — the wire-coalescing ledger:
        # mean batch size is how many round-trips each frame saved
        self._h_batch_size = self.telemetry.histogram(
            "daemon.batch.size",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                     192, 256))
        # daemon.op.<op>.seconds histograms, created lazily on first use;
        # the plain-dict read is the lock-free fast path (a lost race just
        # calls the locking registry factory twice for the same name)
        self._op_hist: Dict[str, object] = {}
        # finished daemon-side spans (roots adopted into callers' traces);
        # served by the `traces` op and published by --telemetry-interval
        self.trace_ring = TraceRing()

    def _op_hist_for(self, op) -> "object":
        if not isinstance(op, str):
            op = "invalid"              # unknown junk shares one series
        h = self._op_hist.get(op)
        if h is None:
            h = self.telemetry.histogram(f"daemon.op.{op}.seconds")
            self._op_hist[op] = h
        return h

    @property
    def source(self) -> str:
        """Telemetry source label: shard-qualified when this daemon is
        one shard of a fleet, the historical label otherwise."""
        return (f"crispy-daemon@{self.shard_name}" if self.shard_name
                else "crispy-daemon")

    # -- request dispatch ---------------------------------------------------
    def handle_request(self, req: Dict) -> Dict:
        op = req.get("op")
        trace = req.pop(TRACE_FIELD, None)
        if isinstance(trace, dict):
            # traced caller: time the op INSIDE a span adopted into the
            # caller's trace, so the histogram observe lands its exemplar
            # with the caller's trace_id and the span (a local root with
            # parent_id = the caller's span) is stitchable fleet-wide
            op_name = op if isinstance(op, str) else "invalid"
            with span(f"daemon.op.{op_name}", ring=self.trace_ring,
                      parent=trace):
                t0 = perf_counter()
                try:
                    return self._dispatch(op, req)
                finally:
                    self._op_hist_for(op).observe(perf_counter() - t0)
        # untraced (legacy) frame: the exact pre-tracing path
        t0 = perf_counter()
        try:
            return self._dispatch(op, req)
        finally:
            self._op_hist_for(op).observe(perf_counter() - t0)

    def _dispatch(self, op, req: Dict) -> Dict:
        b = self.backend
        if op == BATCH_OP:
            return self._dispatch_batch(req)
        if op in ("ping", "auth"):      # auth is a no-op once admitted
            return {"ok": True, "kind": b.kind}
        if op == "metrics":
            # per-op latency histograms + frame/byte/compaction counters,
            # identical over both transports; `source` is shard-qualified
            # so fleet aggregation can attribute per-shard heat
            return {"ok": True, "kind": b.kind, "source": self.source,
                    "metrics": self.telemetry.snapshot()}
        if op == "traces":
            # finished daemon-side span roots, ready for stitching; the
            # in-flight request's own span closes after this snapshot
            roots = [s.to_dict() for s in self.trace_ring.traces()]
            if req.get("clear"):
                self.trace_ring.clear()
            return {"ok": True, "source": self.source,
                    "traces": roots}
        if op == "replicate":
            # warm-standby application, idempotent by primary cursor /
            # doc version (repro_torch.state.sharding.ReplicationApplier)
            if self._applier is None:
                from repro_torch.state.sharding import ReplicationApplier
                self._applier = ReplicationApplier(b)
            with self._write_lock:
                return self._applier.apply(req)
        if op == "append":
            with self._write_lock:
                b.append(req["ns"], req["record"])
                if self.op_delay_s:
                    sleep(self.op_delay_s)
                self._maybe_autocompact_locked(req["ns"])
            return {"ok": True}
        if op == "read":
            rows, cursor = b.read(req["ns"], int(req.get("cursor", 0)))
            return {"ok": True, "rows": rows, "cursor": cursor}
        if op == "load":
            value, version = b.load(req["ns"], req["key"])
            return {"ok": True, "value": value, "version": version}
        if op == "cas":
            with self._write_lock:
                won, value, version = b.cas(req["ns"], req["key"],
                                            int(req["version"]),
                                            req["value"])
                if self.op_delay_s:
                    sleep(self.op_delay_s)
                if won and self._maybe_prune_registry_locked(req["ns"],
                                                             req["key"]):
                    value, version = b.load(req["ns"], req["key"])
            return {"ok": True, "won": won, "value": value,
                    "version": version}
        if op == "reserve":
            # the whole check-and-bump happens under the writer lock: this
            # is the single-RPC arbitration FileBackend needs a CAS retry
            # loop for
            with self._write_lock:
                granted, doc = b.reserve(req["ns"], req["key"],
                                         req.get("deltas", {}),
                                         req.get("limits") or {})
                if self.op_delay_s:
                    sleep(self.op_delay_s)
            return {"ok": True, "granted": granted, "doc": doc}
        if op == "compact":
            with self._write_lock:
                stats = b.compact(req["ns"],
                                  key_fields=req.get("key_fields"),
                                  max_age_s=req.get("max_age_s"))
                self._appends_since_compact[req["ns"]] = 0
            self._c_compactions.inc()
            resp = {"ok": True}
            resp.update(stats)
            return resp
        if op == "evict_registry":
            with self._write_lock:
                evicted = self._prune_registry_locked(
                    req.get("ns", REGISTRY_NS),
                    req.get("key", REGISTRY_KEY),
                    req.get("max_records"), req.get("max_age_s"))
            return {"ok": True, "evicted": evicted}
        if op == "shutdown":
            threading.Thread(target=self.stop, daemon=True).start()
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _dispatch_batch(self, req: Dict) -> Dict:
        """One {"op": "batch"} frame: execute the sub-ops in order with
        per-op error isolation. Sub-ops skip the per-frame plumbing
        (framing, trace adoption, frame counters are paid ONCE) but each
        still lands in its own `daemon.op.<op>.seconds` histogram, so
        per-op latency telemetry stays comparable across batched and
        single-op clients."""
        ops = req.get("ops")
        if not isinstance(ops, list):
            return {"ok": False,
                    "error": "batch needs \"ops\": [frame, ...]"}
        self._h_batch_size.observe(len(ops))
        results: List[Dict] = []
        for sub in ops:
            if not isinstance(sub, dict):
                results.append({"ok": False,
                                "error": f"batch op is not a frame: "
                                         f"{sub!r}"})
                continue
            sub_op = sub.get("op")
            if sub_op in BATCH_EXCLUDED_OPS:
                results.append({"ok": False,
                                "error": f"op {sub_op!r} is not allowed "
                                         f"inside a batch"})
                continue
            t0 = perf_counter()
            try:
                results.append(self._dispatch(sub_op, sub))
            except Exception as e:      # isolation: one bad sub-op must
                results.append({"ok": False,    # not fail its siblings
                                "error": f"{type(e).__name__}: {e}"})
            finally:
                self._op_hist_for(sub_op).observe(perf_counter() - t0)
        return {"ok": True, "results": results}

    # -- compaction / eviction thresholds -----------------------------------
    def _maybe_autocompact_locked(self, ns: str) -> None:
        if not self.compact_after:
            return
        n = self._appends_since_compact.get(ns, 0) + 1
        if n >= self.compact_after:
            self.backend.compact(ns, max_age_s=self.compact_max_age_s)
            self._c_compactions.inc()
            n = 0
        self._appends_since_compact[ns] = n

    def _maybe_prune_registry_locked(self, ns: str, key: str) -> bool:
        if (self.registry_max_records is None
                and self.registry_max_age_s is None):
            return False
        if ns != REGISTRY_NS or key != REGISTRY_KEY:
            return False
        return bool(self._prune_registry_locked(
            ns, key, self.registry_max_records, self.registry_max_age_s))

    def _prune_registry_locked(self, ns: str, key: str,
                               max_records: Optional[int],
                               max_age_s: Optional[float]) -> List[str]:
        b = self.backend
        while True:
            value, version = b.load(ns, key)
            new_value, evicted = prune_registry_doc(
                value, max_records=max_records, max_age_s=max_age_s)
            if not evicted:
                return []
            won, _cur, _ver = b.cas(ns, key, version, new_value)
            if won:
                return evicted
            # only possible when another PROCESS shares our FileBackend
            # root directly; re-read and retry

    # -- lifecycle ----------------------------------------------------------
    def _make_handler(self):
        daemon = self

        class Handler(socketserver.StreamRequestHandler):
            def setup(self):
                super().setup()
                with daemon._conns_lock:
                    daemon._conns.add(self.connection)

            def finish(self):
                with daemon._conns_lock:
                    daemon._conns.discard(self.connection)
                super().finish()

            def handle(self):
                authed = daemon.auth_token is None
                while True:
                    # bounded readline: an (even unauthenticated) peer
                    # streaming newline-free bytes must cost one frame's
                    # budget, not daemon RAM (see transport.MAX_FRAME_BYTES)
                    line = self.rfile.readline(MAX_FRAME_BYTES + 1)
                    if not line:
                        break
                    daemon._c_frames.inc()
                    daemon._c_bytes.inc(len(line))
                    if len(line) > MAX_FRAME_BYTES:
                        try:
                            self.wfile.write((json.dumps(
                                {"ok": False,
                                 "error": "frame too large"}) +
                                "\n").encode())
                            self.wfile.flush()
                        except OSError:
                            pass
                        return                  # drop: cannot resync
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                        if not authed:
                            # the first frame MUST authenticate; anything
                            # else (including a wrong token) is answered
                            # once and the connection is dropped
                            if (req.get("op") == "auth" and
                                    req.get("token") == daemon.auth_token):
                                authed = True
                                resp = {"ok": True,
                                        "kind": daemon.backend.kind}
                            else:
                                daemon._c_auth_failures.inc()
                                resp = {"ok": False, "error":
                                        "auth required: send "
                                        '{"op": "auth", "token": ...} '
                                        "as the first frame"}
                        else:
                            resp = daemon.handle_request(req)
                    except Exception as e:      # a bad request must never
                        resp = {"ok": False,    # kill the server
                                "error": f"{type(e).__name__}: {e}"}
                    try:
                        self.wfile.write((json.dumps(resp) + "\n").encode())
                        self.wfile.flush()
                    except OSError:
                        return                  # client went away
                    if not resp.get("ok") and not authed:
                        return                  # failed auth: hang up

        return Handler

    def start(self, background: bool = True) -> "CrispyDaemon":
        handler = self._make_handler()
        try:
            if self.socket_path is not None:
                self._servers.append(self._start_unix(handler))
            if self.listen is not None:
                self._servers.append(self._start_tcp(handler))
        except BaseException:
            # e.g. the unix socket bound but the tcp port was taken: tear
            # down whatever DID bind, or the half-started daemon leaks a
            # listening-but-unserved socket that fools the liveness probe
            self.stop()
            raise
        if background:
            for server in self._servers:
                self._serve_on_thread(server)
        if self.standby is not None and self.shipper is None:
            from repro_torch.state.sharding import ReplicationShipper
            self.shipper = ReplicationShipper(
                self.backend, self.standby, auth_token=self.auth_token,
                period_s=self.replicate_interval_s).start()
        return self

    def _serve_on_thread(self, server) -> None:
        self._serving.add(server)
        t = threading.Thread(
            target=lambda: server.serve_forever(poll_interval=0.05),
            daemon=True)
        t.start()
        self._threads.append(t)

    def _start_unix(self, handler) -> socketserver.BaseServer:
        if os.path.exists(self.socket_path):
            # a crash leaves a stale socket behind (safe to reclaim), but
            # a LIVE daemon must not be silently usurped — two daemons on
            # one path would split "the one shared envelope" in two
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            probe.settimeout(1.0)
            alive = False
            try:
                probe.connect(self.socket_path)
                alive = True
            except OSError:
                pass                         # stale: nobody listening
            finally:
                probe.close()
            if alive:
                raise StateBackendError(
                    f"a daemon is already serving {self.socket_path}; "
                    f"connect a DaemonBackend to it or pick another "
                    f"--socket")
            os.unlink(self.socket_path)

        class UnixServer(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True

        return UnixServer(self.socket_path, handler)

    def _start_tcp(self, handler) -> socketserver.BaseServer:
        scheme, target = parse_address(self.listen)
        if scheme != "tcp":
            raise StateBackendError(
                f"listen= wants a tcp host:port address, got "
                f"{self.listen!r}")

        class TCPServer(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True
            if ":" in target[0]:        # a literal IPv6 host ([::1]:port)
                address_family = socket.AF_INET6

        server = TCPServer(target, handler)
        host, port = server.server_address[:2]
        self.tcp_address = (f"[{host}]:{port}" if ":" in str(host)
                            else f"{host}:{port}")   # resolves host:0
        return server

    def serve_forever(self) -> None:
        if not self._servers:
            self.start(background=False)
        servers = list(self._servers)
        if not servers:                 # stop() may have raced us
            return
        # extra servers run on background threads; the last one occupies
        # the foreground so `python -m repro_torch.state.daemon` blocks
        for server in servers[:-1]:
            self._serve_on_thread(server)
        self._serving.add(servers[-1])
        servers[-1].serve_forever(poll_interval=0.05)

    def stop(self) -> None:
        shipper, self.shipper = self.shipper, None
        if shipper is not None:
            shipper.stop()      # final ship drains the tail when reachable
        servers, self._servers = self._servers, []
        for server in servers:
            if server in self._serving:
                server.shutdown()
            server.server_close()
        self._serving.clear()
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self.socket_path and os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
        threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "CrispyDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class DaemonBackend(StateBackend):
    """StateBackend speaking the crispy-daemon wire protocol over either
    transport: `DaemonBackend("/tmp/crispy.sock")` (unix) or
    `DaemonBackend("crispy-host:7421")` / `"tcp://host:port"` (tcp).

    One connection per thread (the AllocationService worker, profiling
    executor workers and direct callers each get their own); connections
    whose owning thread has exited are swept and closed on the next call
    from any thread, so long-lived services with thread churn never
    exhaust the daemon's connection slots. A transport error drops the
    connection and retries once, so clients fail over to a daemon
    restarted on the same address. A daemon that stays down raises
    `StateBackendUnavailable` naming the unix path or host:port —
    callers see a clean, debuggable error, never a hang: connects are
    bounded by `timeout_s` and response reads by `read_timeout_s`
    (default: `timeout_s`), so a daemon that accepts but never answers
    surfaces a timeout error instead of wedging the service worker.
    When the daemon requires a shared token, pass `auth_token=` or
    export $CRISPY_DAEMON_TOKEN; the client then authenticates every
    fresh connection before its first request.

    Wire coalescing: `batch(ops)` executes N ops in ONE round trip via
    the {"op": "batch"} frame (ordered results, per-op error isolation);
    `pipeline()` returns a context manager that queues ordinary backend
    calls and flushes them as pipelined legacy frames — N writes, one
    socket flush, N reads — which works against daemons that predate the
    batch op. The shared views coalesce automatically: see
    `repro_torch.profiling.store.refresh_views` (store tail-read + registry
    doc get in one frame) and `ProfileStore(write_behind=True)` (profile
    point/anchor write-through flushed as one batched append frame)."""

    kind = "daemon"

    def __init__(self, address: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 auth_token: Optional[str] = None,
                 read_timeout_s: Optional[float] = None,
                 standby: Optional[str] = None,
                 shard_name: Optional[str] = None):
        self.address = address or default_socket_path()
        self._parsed = parse_address(self.address)
        self.transport = self._parsed[0]          # "unix" | "tcp"
        if self.transport == "unix" and not HAS_UNIX_SOCKETS:
            raise StateBackendError(   # pragma: no cover - non-POSIX
                "unix-domain sockets are unavailable on this platform; "
                "connect to a tcp daemon (host:port) instead")
        # back-compat: unix clients historically exposed .socket_path
        self.socket_path = (self._parsed[1]
                            if self.transport == "unix" else None)
        self.timeout_s = timeout_s
        self.read_timeout_s = (read_timeout_s if read_timeout_s is not None
                               else timeout_s)
        self.auth_token = (auth_token if auth_token is not None
                           else default_auth_token())
        # client-side failover (repro_torch.state.sharding): when this client's
        # primary is unreachable and `standby` names the shard's warm
        # standby, _call retries there ONCE, then re-resolves the shard's
        # current primary/standby from the topology doc on the ring
        self.standby_address = standby
        self.shard_name = shard_name
        self.failovers = 0              # observable: how often we switched
        self._local = threading.local()
        # every open (thread, sock, file) triple, for the dead-thread
        # sweep + close(): per-thread caching alone leaks sockets when
        # threads exit without closing (executor pools churn workers)
        self._conn_registry: Dict[int, tuple] = {}
        self._conn_lock = threading.Lock()

    def describe(self) -> str:
        return describe_address(self._parsed)

    # -- transport ----------------------------------------------------------
    def _files(self):
        files = getattr(self._local, "files", None)
        if files is None:
            self._sweep_dead_threads()
            sock = connect(self._parsed, self.timeout_s)
            if self.read_timeout_s != self.timeout_s:
                sock.settimeout(self.read_timeout_s)
            files = (sock, sock.makefile("rwb"))
            self._local.files = files
            with self._conn_lock:
                # thread idents are REUSED: a new thread can inherit a
                # dead thread's ident before any sweep ran, and plainly
                # overwriting the slot would leak the dead thread's
                # socket until process exit — close the usurped entry
                stale = self._conn_registry.pop(threading.get_ident(), None)
                self._conn_registry[threading.get_ident()] = \
                    (threading.current_thread(), files)
            if stale is not None and stale[1] is not files:
                self._close_files(stale[1])
            if self.auth_token is not None:
                self._auth(files[1])
        return files

    def _sweep_dead_threads(self) -> None:
        """Close cached connections whose owning thread has exited —
        their threading.local slots are unreachable, so without this
        sweep every dead worker thread leaks one daemon connection for
        the life of the process."""
        with self._conn_lock:
            dead = [ident for ident, (thread, _f) in
                    self._conn_registry.items() if not thread.is_alive()]
            victims = [self._conn_registry.pop(ident) for ident in dead]
        for _thread, files in victims:
            self._close_files(files)

    @staticmethod
    def _close_files(files) -> None:
        sock, f = files
        for closer in (f.close, sock.close):
            try:
                closer()
            except OSError:
                pass

    def _auth(self, f) -> None:
        send_frame(f, auth_frame(self.auth_token))
        resp = recv_frame(f)
        if resp is None:
            raise ConnectionError("daemon closed the connection during auth")
        if not resp.get("ok"):
            self._drop()
            raise StateBackendError(
                f"crispy-daemon at {self.describe()} rejected our auth "
                f"token: {resp.get('error')}")

    def _drop(self) -> None:
        files = getattr(self._local, "files", None)
        self._local.files = None
        with self._conn_lock:
            self._conn_registry.pop(threading.get_ident(), None)
        if files is not None:
            self._close_files(files)

    # ops safe to blindly resend: they mutate nothing server-side that a
    # duplicate could corrupt (`traces` with clear= drains telemetry, so
    # a resend loses at worst best-effort trace rows, never state)
    _IDEMPOTENT_OPS = frozenset({"ping", "read", "load", "metrics",
                                 "traces"})

    def _retry_safe(self, payload: Dict) -> bool:
        """May this fully-sent frame be resent on a fresh connection? A
        batch frame is exactly as resendable as its least-resendable
        sub-op."""
        op = payload.get("op")
        if op == BATCH_OP:
            return all(isinstance(sub, dict)
                       and sub.get("op") in self._IDEMPOTENT_OPS
                       for sub in payload.get("ops") or ())
        return op in self._IDEMPOTENT_OPS

    def _call(self, payload: Dict) -> Dict:
        """`_call_once` plus client-side failover: when the primary is
        unreachable and a standby address is known, switch every future
        connection to the standby, retry the frame ONCE there, and
        re-resolve the shard's topology from the doc on the ring. A
        mutating frame that died mid-flight may thus execute at most
        twice (once invisibly on the dying primary, once on the
        standby); log rows are idempotent under the store's later-wins
        fold and CAS/reserve re-arbitrate, the same contract as the
        single-daemon reconnect retry. `shutdown` never fails over — a
        dead primary must not take its healthy standby down with it."""
        try:
            return self._call_once(payload)
        except StateBackendUnavailable as primary_err:
            target = self.standby_address
            if (target is None or payload.get("op") == "shutdown"
                    or parse_address(target) == self._parsed):
                raise
            self._activate(target)
            try:
                resp = self._call_once(payload)
            except StateBackendUnavailable:
                raise primary_err       # both down: name the primary error
            self.failovers += 1
            self._adopt_topology()
            return resp

    def _activate(self, address: str) -> None:
        """Point every future connection at `address` (the old address
        becomes the failover candidate, so a recovered ex-primary can be
        retried if the new one dies too)."""
        self.close()                    # sever EVERY thread's cached conn
        old = self.address
        self.address = address
        self._parsed = parse_address(address)
        self.transport = self._parsed[0]
        self.socket_path = (self._parsed[1]
                            if self.transport == "unix" else None)
        self.standby_address = old

    def _adopt_topology(self) -> None:
        """Refresh this shard's primary/standby from the topology doc on
        whatever node we just reached (best-effort: a fleet without a
        published doc keeps the swapped pair from `_activate`)."""
        if self.shard_name is None or getattr(self._local, "adopting",
                                              False):
            return
        self._local.adopting = True     # the load() below re-enters _call
        try:
            value, _version = self.load(TOPOLOGY_NS, TOPOLOGY_KEY)
            entry = ((value or {}).get("shards") or {}).get(self.shard_name)
            if not isinstance(entry, dict):
                return
            primary, standby = entry.get("primary"), entry.get("standby")
            for candidate in (primary, standby):
                if (candidate and
                        parse_address(candidate) != self._parsed):
                    self.standby_address = candidate
                    return
        except (StateBackendError, ValueError):
            pass
        finally:
            self._local.adopting = False

    def _call_once(self, payload: Dict) -> Dict:
        op = payload.get("op")
        ctx = current_trace_context()
        if ctx is not None:
            # inside an active span: stamp the propagation token so the
            # daemon's work joins this trace (old daemons ignore unknown
            # request fields, so this is safe against version skew)
            payload = dict(payload)
            payload[TRACE_FIELD] = ctx
        last: Optional[Exception] = None
        for attempt in range(2):        # second attempt = fresh connection
            sent = False
            try:
                _sock, f = self._files()
                send_frame(f, payload)
                sent = True
                resp = recv_frame(f)
                if resp is None:
                    raise ConnectionError("daemon closed the connection")
                if not resp.get("ok"):
                    raise StateBackendError(
                        f"daemon at {self.describe()} rejected {op}: "
                        f"{resp.get('error')}")
                return resp
            except StateBackendError:
                raise                   # auth rejection / op rejection
            except socket.timeout as e:
                # the daemon accepted the frame but never answered (a
                # wedged writer lock, a stuck disk): drop the connection
                # and name the wedge — the caller must never hang
                self._drop()
                raise StateBackendUnavailable(
                    f"crispy-daemon at {self.describe()} did not answer "
                    f"{op} within {self.read_timeout_s}s (the operation "
                    f"may or may not have been applied): "
                    f"{e or 'timed out'}")
            except (OSError, ValueError, ConnectionError) as e:
                self._drop()
                last = e
                # a mutating op (append/cas/reserve/compact) whose request
                # was fully sent may already have been applied server-side
                # — resending could apply it twice (double-spend a budget
                # point, duplicate a log row), so surface the ambiguity
                # instead of retrying. Failures before the request went
                # out (dead cached connection, connect refused) are
                # always safe to retry on a fresh connection.
                if sent and not self._retry_safe(payload):
                    raise StateBackendUnavailable(
                        f"crispy-daemon connection lost mid-{op} at "
                        f"{self.describe()} (the operation may or may "
                        f"not have been applied): {e}")
        raise StateBackendUnavailable(
            f"crispy-daemon unreachable at {self.describe()}: {last}")

    # -- protocol ------------------------------------------------------------
    def append(self, ns: str, record: Dict) -> None:
        self._call({"op": "append", "ns": ns, "record": record})

    def read(self, ns: str, cursor: int = 0) -> Tuple[List[Dict], int]:
        resp = self._call({"op": "read", "ns": ns, "cursor": cursor})
        return resp["rows"], resp["cursor"]

    def load(self, ns: str, key: str) -> Tuple[Optional[Dict], int]:
        resp = self._call({"op": "load", "ns": ns, "key": key})
        return resp["value"], resp["version"]

    def cas(self, ns: str, key: str, version: int,
            value: Dict) -> Tuple[bool, Optional[Dict], int]:
        resp = self._call({"op": "cas", "ns": ns, "key": key,
                           "version": version, "value": value})
        return resp["won"], resp["value"], resp["version"]

    def reserve(self, ns: str, key: str, deltas: Dict[str, float],
                limits: Optional[Dict[str, float]] = None
                ) -> Tuple[bool, Dict]:
        resp = self._call({"op": "reserve", "ns": ns, "key": key,
                           "deltas": deltas, "limits": limits or {}})
        return resp["granted"], resp["doc"]

    def compact(self, ns: str,
                key_fields: Optional[Sequence[str]] = None,
                max_age_s: Optional[float] = None) -> Dict:
        resp = self._call({"op": "compact", "ns": ns,
                           "key_fields": (list(key_fields)
                                          if key_fields is not None
                                          else None),
                           "max_age_s": max_age_s})
        return {"before": resp["before"], "after": resp["after"],
                "dropped": resp["dropped"]}

    # -- wire coalescing -----------------------------------------------------

    # leave the daemon headroom under MAX_FRAME_BYTES: the batch frame
    # wraps the sub-ops in envelope JSON and may gain a trace field
    _BATCH_BYTE_BUDGET = MAX_FRAME_BYTES // 2

    def batch(self, ops: Sequence[Dict]) -> List[Dict]:
        """Execute N ops in ONE {"op": "batch"} round trip: ordered
        wire-shaped results, per-op error isolation (a failing sub-op
        yields its {"ok": false} slot without aborting the rest — this
        method raises only on transport/frame failures). Oversized
        batches are split into successive frames, each well under the
        daemon's 8 MiB line cap, preserving op order across chunks.
        Reconnect-retry follows `_call`'s single-op rule: a batch frame
        is resent only when EVERY sub-op is idempotent."""
        results: List[Dict] = []
        for chunk in self._chunk_ops(list(ops)):
            resp = self._call({"op": BATCH_OP, "ops": chunk})
            got = resp.get("results")
            if not isinstance(got, list) or len(got) != len(chunk):
                raise StateBackendError(
                    f"daemon at {self.describe()} returned "
                    f"{len(got) if isinstance(got, list) else 'no'} "
                    f"batch results for {len(chunk)} ops")
            results.extend(got)
        return results

    def _chunk_ops(self, ops: List[Dict]) -> List[List[Dict]]:
        """Split a batch so each frame stays under _BATCH_BYTE_BUDGET
        serialized (single over-budget ops still go out alone — the
        daemon's frame cap is the real enforcement boundary)."""
        chunks: List[List[Dict]] = []
        current: List[Dict] = []
        used = 0
        for op in ops:
            size = len(json.dumps(op)) + 2       # +2 for ", " separators
            if current and used + size > self._BATCH_BYTE_BUDGET:
                chunks.append(current)
                current, used = [], 0
            current.append(op)
            used += size
        if current:
            chunks.append(current)
        return chunks

    def pipeline(self) -> "_DaemonPipeline":
        """Context manager that queues ordinary single-op frames and
        flushes them as a pipelined burst on exit — N request lines
        written with ONE socket flush, then N responses read in order.
        Works against daemons that predate the batch op (the server
        answers strictly in order per connection, so no protocol change
        is needed). Queued calls return handles whose `.result()` is
        valid after the `with` block:

            with backend.pipeline() as p:
                h1 = p.read("profiles", cursor)
                h2 = p.load("registry", "records")
            rows, cur = h1.result()["rows"], h1.result()["cursor"]

        A transport failure mid-flush raises `StateBackendUnavailable`
        when any non-idempotent op may have reached the daemon (same
        ambiguity rule as `_call`); a failure before any byte went out
        retries once on a fresh connection."""
        return _DaemonPipeline(self)

    def evict_registry(self, ns: str = REGISTRY_NS, key: str = REGISTRY_KEY,
                       max_records: Optional[int] = None,
                       max_age_s: Optional[float] = None) -> List[str]:
        """Daemon-side registry eviction by count/age; returns the evicted
        signatures (tombstoned in the doc, so siblings honor it)."""
        resp = self._call({"op": "evict_registry", "ns": ns, "key": key,
                           "max_records": max_records,
                           "max_age_s": max_age_s})
        return list(resp.get("evicted", []))

    def metrics(self, with_source: bool = False):
        """The daemon's telemetry snapshot (`daemon.op.<op>.seconds`
        histograms + frame/byte/auth-failure/compaction counters) —
        same answer over unix and tcp transports. `with_source=True`
        returns (source, snapshot) where source is the daemon's
        shard-qualified telemetry label ("crispy-daemon@shard-0" on a
        fleet member, "crispy-daemon" on a lone daemon or one that
        predates sharding)."""
        resp = self._call({"op": "metrics"})
        if with_source:
            return resp.get("source") or "crispy-daemon", resp["metrics"]
        return resp["metrics"]

    def traces(self, clear: bool = False, with_source: bool = False):
        """The daemon's finished trace roots (span dicts, ready for
        `stitch_fleet_traces`); `clear=True` drains the ring.
        `with_source=True` returns (source, roots), same labeling rule
        as `metrics`."""
        resp = self._call({"op": "traces", "clear": bool(clear)})
        roots = list(resp.get("traces", []))
        if with_source:
            return resp.get("source") or "crispy-daemon", roots
        return roots

    def ping(self) -> bool:
        try:
            return bool(self._call({"op": "ping"}).get("ok"))
        except StateBackendError:
            return False

    def shutdown_daemon(self) -> None:
        """Ask the daemon to stop (it drains and unlinks its socket)."""
        self._call({"op": "shutdown"})
        self._drop()

    def close(self) -> None:
        """Close EVERY cached connection, not just the calling thread's:
        a service shutting down must release all its daemon slots even
        for worker threads that are still parked in a pool — including
        connections whose owning thread died mid-call (the registry
        holds them regardless of thread liveness). Idempotent: a second
        close() finds an empty registry and does nothing. Surviving
        threads that call again after close() reconnect transparently
        (their first attempt fails on the closed socket and `_call`
        retries on a fresh connection)."""
        self._local.files = None
        with self._conn_lock:
            victims = list(self._conn_registry.values())
            self._conn_registry.clear()
        for _thread, files in victims:
            self._close_files(files)


class _PipelineHandle:
    """Future-like result slot for one pipelined op (see
    `DaemonBackend.pipeline`). `.result()` returns the wire-shaped
    response dict ({"ok": true, "rows": ...} etc.) once the pipeline
    has flushed; a rejected op raises StateBackendError there, so one
    bad op never poisons its neighbors' results."""

    __slots__ = ("op", "_resp", "_error", "_done")

    def __init__(self, op: str):
        self.op = op
        self._resp: Optional[Dict] = None
        self._error: Optional[Exception] = None
        self._done = False

    def _resolve(self, resp: Optional[Dict], error: Optional[Exception]):
        self._resp, self._error, self._done = resp, error, True

    def result(self) -> Dict:
        if not self._done:
            raise StateBackendError(
                f"pipelined {self.op} has not been flushed yet — read "
                f"results after the `with backend.pipeline()` block")
        if self._error is not None:
            raise self._error
        return self._resp


class _DaemonPipeline:
    """Queues single-op frames and flushes them as one write burst (see
    `DaemonBackend.pipeline`). Not thread-safe — a pipeline belongs to
    the thread that opened it, like the connection it rides on."""

    def __init__(self, backend: DaemonBackend):
        self._backend = backend
        self._queue: List[Tuple[Dict, _PipelineHandle]] = []
        self._flushed = False

    # -- queuing (mirrors the backend's protocol surface) -------------------
    def call(self, payload: Dict) -> _PipelineHandle:
        if self._flushed:
            raise StateBackendError("pipeline already flushed")
        handle = _PipelineHandle(str(payload.get("op")))
        self._queue.append((dict(payload), handle))
        return handle

    def ping(self) -> _PipelineHandle:
        return self.call({"op": "ping"})

    def append(self, ns: str, record: Dict) -> _PipelineHandle:
        return self.call({"op": "append", "ns": ns, "record": record})

    def read(self, ns: str, cursor: int = 0) -> _PipelineHandle:
        return self.call({"op": "read", "ns": ns, "cursor": cursor})

    def load(self, ns: str, key: str) -> _PipelineHandle:
        return self.call({"op": "load", "ns": ns, "key": key})

    def cas(self, ns: str, key: str, version: int,
            value: Dict) -> _PipelineHandle:
        return self.call({"op": "cas", "ns": ns, "key": key,
                          "version": version, "value": value})

    def reserve(self, ns: str, key: str, deltas: Dict[str, float],
                limits: Optional[Dict[str, float]] = None
                ) -> _PipelineHandle:
        return self.call({"op": "reserve", "ns": ns, "key": key,
                          "deltas": deltas, "limits": limits or {}})

    # -- flush ---------------------------------------------------------------
    def __enter__(self) -> "_DaemonPipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.flush()

    def flush(self) -> None:
        """Write every queued frame, one socket flush, then read the
        responses in order and resolve the handles."""
        if self._flushed:
            return
        self._flushed = True
        if not self._queue:
            return
        backend = self._backend
        ctx = current_trace_context()
        payloads = []
        for payload, _h in self._queue:
            if ctx is not None:
                payload = dict(payload, **{TRACE_FIELD: ctx})
            payloads.append(payload)
        all_idempotent = all(backend._retry_safe(p) for p in payloads)
        last: Optional[Exception] = None
        for attempt in range(2):
            sent = False
            try:
                _sock, f = backend._files()
                blob = b"".join((json.dumps(p) + "\n").encode()
                                for p in payloads)
                f.write(blob)
                f.flush()
                sent = True
                for payload, handle in self._queue:
                    resp = recv_frame(f)
                    if resp is None:
                        raise ConnectionError(
                            "daemon closed the connection mid-pipeline")
                    if not resp.get("ok"):
                        handle._resolve(None, StateBackendError(
                            f"daemon at {backend.describe()} rejected "
                            f"{handle.op}: {resp.get('error')}"))
                    else:
                        handle._resolve(resp, None)
                return
            except socket.timeout as e:
                backend._drop()
                err = StateBackendUnavailable(
                    f"crispy-daemon at {backend.describe()} did not "
                    f"answer a pipelined burst of {len(self._queue)} ops "
                    f"within {backend.read_timeout_s}s (the operations "
                    f"may or may not have been applied): "
                    f"{e or 'timed out'}")
                self._fail_unresolved(err)
                raise err
            except (OSError, ValueError, ConnectionError) as e:
                backend._drop()
                last = e
                if sent and not all_idempotent:
                    err = StateBackendUnavailable(
                        f"crispy-daemon connection lost mid-pipeline at "
                        f"{backend.describe()} (some of the "
                        f"{len(self._queue)} queued operations may have "
                        f"been applied): {e}")
                    self._fail_unresolved(err)
                    raise err
        err = StateBackendUnavailable(
            f"crispy-daemon unreachable at {self._backend.describe()}: "
            f"{last}")
        self._fail_unresolved(err)
        raise err

    def _fail_unresolved(self, error: Exception) -> None:
        for _payload, handle in self._queue:
            if not handle._done:
                handle._resolve(None, error)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.state.daemon",
        description="crispy-daemon: shared-state server for Crispy "
                    "allocation services (see module docstring for the "
                    "lifecycle).")
    ap.add_argument("--socket", default=None,
                    help="unix socket path (default: $CRISPY_DAEMON_SOCKET "
                         f"or {DEFAULT_SOCKET}, unless --listen makes the "
                         "daemon tcp-only)")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="also serve TCP on this address (port 0 = "
                         "ephemeral; resolved address is announced and "
                         "written to --port-file)")
    ap.add_argument("--port-file", default=None,
                    help="write the resolved tcp host:port here after "
                         "binding (for scripts that use --listen host:0)")
    ap.add_argument("--auth-token", default=None,
                    help="require this shared token as the first frame of "
                         "every connection (default: $CRISPY_DAEMON_TOKEN "
                         "when set)")
    ap.add_argument("--root", default=None,
                    help="persist state in this directory (FileBackend); "
                         "a restarted daemon resumes from it")
    ap.add_argument("--memory", action="store_true",
                    help="serve an in-memory backend (the default when "
                         "--root is not given)")
    ap.add_argument("--compact-after", type=int, default=None, metavar="N",
                    help="auto-compact a log namespace every N appends")
    ap.add_argument("--compact-max-age", type=float, default=None,
                    metavar="S", help="during compaction, drop rows whose "
                    "'ts' is older than S seconds")
    ap.add_argument("--registry-max-records", type=int, default=None,
                    metavar="N", help="evict oldest registry records "
                    "beyond N after each registry flush")
    ap.add_argument("--registry-max-age", type=float, default=None,
                    metavar="S", help="evict registry records older than "
                    "S seconds after each registry flush")
    ap.add_argument("--telemetry-interval", type=float, default=None,
                    metavar="S", help="publish the daemon's own metrics "
                    "snapshot (__telemetry__ namespace) and trace roots "
                    "(__traces__) into its backend every S seconds "
                    "(source 'crispy-daemon', shard-qualified under "
                    "--shard-name)")
    ap.add_argument("--standby", default=None, metavar="ADDR",
                    help="warm-standby daemon address (unix path or "
                         "host:port); this daemon ships its log tails "
                         "and changed documents there via batched "
                         "'replicate' frames")
    ap.add_argument("--replicate-interval", type=float, default=0.5,
                    metavar="S", help="seconds between replication "
                    "rounds to --standby (default 0.5)")
    ap.add_argument("--shard-name", default=None, metavar="NAME",
                    help="this daemon's shard name in a sharded fleet "
                    "(e.g. shard-0); tags telemetry as "
                    "'crispy-daemon@NAME' for per-shard heat")
    ap.add_argument("--op-delay", type=float, default=0.0, metavar="S",
                    help="inject S seconds of per-mutation service time "
                    "under the writer lock (models a durable backend's "
                    "fsync; benchmark/failover testing only, default 0)")
    ap.add_argument("--ping", action="store_true",
                    help="health-check a running daemon and exit")
    ap.add_argument("--shutdown", action="store_true",
                    help="ask a running daemon to stop and exit")
    args = ap.parse_args(argv)

    auth_token = args.auth_token or default_auth_token()
    # server-side events are structured one-line JSON on stderr; the CLI
    # answers on stdout ("pong" / "no daemon" / "shutdown requested" and
    # the exit codes) are a scripting contract and stay byte-identical
    log = StructuredLogger("crispy-daemon")

    if args.ping or args.shutdown:
        # --listen names the tcp daemon to target; else the unix socket
        target = args.listen or args.socket or default_socket_path()
        try:
            client = DaemonBackend(target, timeout_s=5.0,
                                   auth_token=auth_token)
            if args.ping:
                ok = client.ping()
                print("pong" if ok else "no daemon", flush=True)
                return 0 if ok else 1
            client.shutdown_daemon()
            print("shutdown requested", flush=True)
            return 0
        except StateBackendError as e:
            log.error("client command failed", target=target, error=str(e))
            return 1

    socket_path = args.socket
    if socket_path is None and args.listen is None:
        socket_path = default_socket_path()
    if socket_path is not None and not HAS_UNIX_SOCKETS:
        log.error("unix sockets unavailable on this platform; "
                  "use --listen host:port")
        return 2

    daemon = CrispyDaemon(socket_path, root=args.root, listen=args.listen,
                          auth_token=auth_token,
                          compact_after=args.compact_after,
                          compact_max_age_s=args.compact_max_age,
                          registry_max_records=args.registry_max_records,
                          registry_max_age_s=args.registry_max_age,
                          standby=args.standby,
                          replicate_interval_s=args.replicate_interval,
                          shard_name=args.shard_name,
                          op_delay_s=args.op_delay)
    # stop() blocks until serve_forever returns, so it must not run on the
    # thread serve_forever occupies (the signal handler interrupts it)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: threading.Thread(
            target=daemon.stop, daemon=True).start())
    try:
        daemon.start(background=True)   # bind before announcing
    except (StateBackendError, OSError) as e:   # e.g. live daemon / EADDRINUSE
        log.error("start failed", error=str(e))
        return 1
    log.info("serving", backend=daemon.backend.kind,
             unix=socket_path, tcp=daemon.tcp_address,
             auth=bool(auth_token), shard=args.shard_name,
             standby=args.standby)
    if args.port_file and daemon.tcp_address:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(daemon.tcp_address)
        os.replace(tmp, args.port_file)
    publisher = None
    if args.telemetry_interval:
        publisher = TelemetryPublisher(
            daemon.backend, daemon.source, daemon.telemetry,
            period_s=args.telemetry_interval,
            ring=daemon.trace_ring).start()
    try:
        # the servers run on background threads (started above so the
        # announce/port-file happens after EVERY bind); park until stop()
        for t in list(daemon._threads):
            t.join()
    except OSError:                     # server socket closed by stop()
        pass
    # a remote "shutdown" op triggers stop() on a daemon thread; finish
    # the cleanup (socket unlink) here so process exit never races it
    daemon.stop()
    if publisher is not None:
        publisher.stop()                # final snapshot lands the totals
    log.info("clean shutdown")
    return 0


if __name__ == "__main__":
    sys.exit(main())
