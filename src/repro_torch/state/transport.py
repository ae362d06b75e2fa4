"""Shared transport machinery for crispy-daemon and DaemonBackend.

The daemon originally spoke newline-JSON over a unix-domain socket only,
with the framing inlined in daemon.py. Multi-host support needs the same
framing over TCP, so this module owns everything both transports share:

  addresses   `parse_address` maps one string form onto either transport:

                /tmp/crispy.sock          unix (anything with a path
                unix:///tmp/crispy.sock    separator, or no ':')
                127.0.0.1:7421            tcp  (host:port, numeric port)
                tcp://crispy-host:7421    tcp
                [::1]:7421                tcp  (bracketed IPv6)

              `describe_address` renders the parsed form back into the
              human string every connect error must carry — "unix socket
              '/tmp/crispy.sock'" vs "tcp address 127.0.0.1:7421" — so a
              misconfigured multi-host client names exactly what it
              failed to reach.

  framing     one JSON object per line, request -> response
              (`send_frame` / `recv_frame` over a socket makefile).

  auth        TCP exposes the daemon beyond the unix-permission boundary,
              so connections may be gated by a shared token: the FIRST
              frame on a connection must then be
              {"op": "auth", "token": ...}. `default_auth_token` reads
              $CRISPY_DAEMON_TOKEN so daemon and clients agree without
              plumbing the secret through every constructor.

  tracing     any request frame MAY carry a `trace` field (TRACE_FIELD)
              holding the caller's {"trace_id", "span_id"} propagation
              token (repro_torch.telemetry.current_trace_context). The daemon
              then opens its per-op span as a child of that remote
              span, so cross-process traces stitch into one tree. The
              field is strictly optional on BOTH transports: a frame
              without it — i.e. every frame an old client sends — takes
              the exact pre-tracing code path and gets byte-identical
              responses.

  batching    {"op": "batch", "ops": [<frame>, ...]} (BATCH_OP) carries
              N sub-op frames in ONE round trip. The response is
              {"ok": true, "results": [<resp>, ...]} with exactly one
              result per sub-op, in order. Sub-op failures are isolated:
              a failing sub-op yields its own {"ok": false, "error": ..}
              slot and the remaining sub-ops still execute. Connection-
              scoped ops (`auth`) and frame-scoped ones (`batch` itself,
              `shutdown`) may not nest inside a batch. A frame-level
              `trace` field covers the whole batch (one adopted
              `daemon.op.batch` span; sub-ops are timed into their own
              `daemon.op.<op>.seconds` histograms). Like the trace
              field, the batch op is strictly additive: frames without
              it take the exact legacy single-op path, byte-identical
              (pinned by test_state_conformance).

              Clients may also PIPELINE legacy single-op frames: write
              N request lines before reading the N responses. The
              daemon answers strictly in order on each connection, so
              pipelining needs no protocol change and works against any
              daemon version (`DaemonBackend.pipeline()`).

  replication {"op": "replicate", "log": {"ns": .., "rows": [..],
              "base": c0, "cursor": c1}} ships a log tail (primary
              cursors c0..c1) to a warm-standby daemon, and
              {"op": "replicate", "doc": {"ns": .., "key": ..,
              "value": {..}, "version": n}} ships a versioned document.
              Both are idempotent by cursor/version: the standby tracks
              the highest primary cursor applied per namespace (and the
              highest primary doc version per key) and skips anything
              at or below it, so a restarted shipper can replay from
              zero without duplicating state. A frame whose `base` is
              past the standby's applied cursor is a replication GAP
              and is rejected ({"ok": false, "error": "replication
              gap..."}); the shipper then resets to cursor 0 and
              re-ships the (compacted) log from the head. Like every
              op, `replicate` rides behind the connection-level auth
              handshake, so a token-gated standby only accepts
              replication from holders of the shared secret. The op may
              ride inside a batch frame — the shipper coalesces one
              round of tails + docs into one round trip. See
              repro_torch.state.sharding.ReplicationShipper.

A copy of the JAX package's ``repro/state/transport.py``.
"""
from __future__ import annotations

import json
import os
import socket
from typing import Dict, Optional, Tuple, Union

AUTH_TOKEN_ENV = "CRISPY_DAEMON_TOKEN"

# optional per-frame trace-propagation field (see module docstring)
TRACE_FIELD = "trace"

# multi-op frame: {"op": BATCH_OP, "ops": [...]} -> {"ok": true,
# "results": [...]} (see module docstring)
BATCH_OP = "batch"

# ops that must not appear INSIDE a batch frame: auth is connection
# state, shutdown tears the connection down mid-frame, and nesting
# batches would unbound the per-frame work a single line can demand
BATCH_EXCLUDED_OPS = frozenset({"auth", BATCH_OP, "shutdown"})

# warm-standby replication frame (see module docstring). May ride
# inside a batch — the shipper coalesces one round into one frame.
REPLICATE_OP = "replicate"

# the shard topology document lives ON the ring itself (a plain CAS doc
# replicated to every node), so any reachable daemon can answer "who is
# primary for shard X now" during client-side failover. Double-underscore
# namespace: reserved, same convention as __telemetry__ / __traces__.
TOPOLOGY_NS = "__topology__"
TOPOLOGY_KEY = "shards"

# parsed address forms: ("unix", path) | ("tcp", (host, port))
Address = Tuple[str, Union[str, Tuple[str, int]]]


def default_auth_token() -> Optional[str]:
    return os.environ.get(AUTH_TOKEN_ENV) or None


def parse_address(address: str) -> Address:
    """Classify an address string as unix or tcp (see module docstring)."""
    addr = address.strip()
    if addr.startswith("unix://"):
        return "unix", addr[len("unix://"):]
    if addr.startswith("tcp://"):
        addr = addr[len("tcp://"):]
        return "tcp", _host_port(addr)
    if addr.startswith("[") or (":" in addr and os.sep not in addr
                                and addr.rsplit(":", 1)[1].isdigit()):
        return "tcp", _host_port(addr)
    return "unix", addr


def _host_port(addr: str) -> Tuple[str, int]:
    if addr.startswith("["):                 # bracketed IPv6: [::1]:7421
        host, _, rest = addr[1:].partition("]")
        port = rest.lstrip(":")
    else:
        host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"not a host:port tcp address: {addr!r} (use host:port, "
            f"tcp://host:port or a unix socket path)")
    return host, int(port)


def describe_address(parsed: Address) -> str:
    """Human form for error messages: names the transport AND the target
    so unix-path vs host:port misconfiguration is obvious at a glance."""
    scheme, target = parsed
    if scheme == "unix":
        return f"unix socket '{target}'"
    host, port = target
    return f"tcp address {host}:{port}"


def connect(parsed: Address, timeout_s: float) -> socket.socket:
    """Open a connected stream socket for either transport."""
    scheme, target = parsed
    if scheme == "unix":
        if not hasattr(socket, "AF_UNIX"):   # pragma: no cover - non-POSIX
            raise OSError("unix-domain sockets unavailable on this platform")
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout_s)
        try:
            sock.connect(target)
        except BaseException:
            sock.close()
            raise
        return sock
    host, port = target
    sock = socket.create_connection((host, port), timeout=timeout_s)
    sock.settimeout(timeout_s)
    return sock


# -- framing ------------------------------------------------------------------

def send_frame(wfile, payload: Dict) -> None:
    wfile.write((json.dumps(payload) + "\n").encode())
    wfile.flush()


# hard cap on one frame's pre-parse buffering. readline() with no bound
# buffers an arbitrarily long newline-free stream in RAM — on the TCP
# transport that lets any peer that can reach the port (even pre-auth)
# OOM the single daemon holding everyone's shared state. Generous for
# real traffic: the largest legitimate frame is a registry document.
MAX_FRAME_BYTES = 8 * 1024 * 1024


def recv_frame(rfile) -> Optional[Dict]:
    """Next frame, or None on a clean EOF. Raises ValueError on garbage
    or an over-long frame (the caller drops the connection — framing
    never resynchronizes)."""
    line = rfile.readline(MAX_FRAME_BYTES + 1)
    if not line:
        return None
    if len(line) > MAX_FRAME_BYTES:
        raise ValueError(f"frame exceeds {MAX_FRAME_BYTES} bytes")
    obj = json.loads(line)
    if not isinstance(obj, dict):
        raise ValueError(f"frame is not a JSON object: {obj!r}")
    return obj


def auth_frame(token: str) -> Dict:
    return {"op": "auth", "token": token}
