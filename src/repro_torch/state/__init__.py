"""Unified shared-state backend for Crispy's cross-process resources.

One host serving many concurrent allocation clients needs exactly three
shared things: the profile/anchor log (`ProfileStore`), the confident-model
registry (`LockedModelRegistry` / `BackendModelRegistry`), and the
profiling envelope (`ProfilingBudget` in shared mode). Before this package
each of them hand-rolled its own sharing (two copies of fcntl JSONL
locking, and no budget sharing at all); now all three are thin views over
one `StateBackend` protocol:

  backend.py       `StateBackend` — append-only logs (`append`/`read`),
                   versioned documents (`load`/`cas`), and lease-style
                   `reserve` for budget arbitration — plus
                   `InMemoryBackend` (tests/embedded).
  file_backend.py  `FileBackend` — the fcntl implementation. The ONLY
                   module in the package that may import fcntl; `FileLock`
                   lives here.
  daemon.py        `CrispyDaemon` server + `DaemonBackend` client —
                   single-writer state over a unix-domain socket and/or
                   TCP, so contended reservations are one RPC instead of
                   a CAS retry loop through the filesystem, and services
                   on OTHER hosts share the same substrate.
  transport.py     address parsing ("/path" vs "host:port" vs
                   "tcp://host:port"), newline-JSON framing, and the
                   shared-token auth frame both daemon and client speak.
  compaction.py    `fold_log` (snapshot-plus-tail log folding, tombstone
                   and age handling) + `prune_registry_doc` (size/age
                   registry eviction with doc tombstones). Every backend
                   exposes them via `compact(ns, ...)`.
  sharding.py      `ShardedBackend` — the same protocol over N daemons
                   via consistent hashing of namespaces — plus
                   `ReplicationShipper`/`ReplicationApplier` (warm-
                   standby replication) and the topology-doc helpers.

Daemon lifecycle (full wire protocol in daemon.py):

  start     python -m repro_torch.state.daemon --socket /tmp/crispy.sock \
                [--listen 0.0.0.0:7421] [--auth-token SECRET] \
                [--root state-dir | --memory] \
                [--compact-after N] [--registry-max-records N]
            With --root the daemon persists through a FileBackend and a
            restart resumes from disk; --memory serves volatile state.
            The socket path defaults to $CRISPY_DAEMON_SOCKET, else
            <tmpdir>/crispy-daemon.sock; --listen alone makes the daemon
            tcp-only. TCP should carry an auth token ($CRISPY_DAEMON_TOKEN
            or --auth-token).
  connect   backend = DaemonBackend("/tmp/crispy.sock")        # unix
            backend = DaemonBackend("crispy-host:7421")        # tcp
            then AllocationService(..., backend=backend) or
            ProfileStore(backend=backend) / ProfilingBudget(...,
            backend=backend). Clients reconnect once on transport errors
            (daemon restarts are transparent); a daemon that stays down
            raises StateBackendUnavailable naming the unix path or
            host:port it could not reach.
  health    python -m repro_torch.state.daemon --socket ... --ping
            (or --listen host:port --ping for a tcp daemon)
  shutdown  python -m repro_torch.state.daemon --socket ... --shutdown
            (or SIGTERM/SIGINT) — the server drains, unlinks the socket,
            and exits 0.

Wire batching + pipelining: every backend exposes `batch(ops)` — N
wire-shaped ops executed in order with per-op error isolation (a failing
op yields its own {"ok": false} slot). On `DaemonBackend` that is ONE
{"op": "batch", "ops": [...]} round trip (auto-chunked under the 8 MiB
frame cap), and `DaemonBackend.pipeline()` additionally pipelines plain
single-op frames — N request lines, one flush, N ordered responses —
against daemons of any version. Frames without the batch op stay
byte-identical to the legacy protocol (pinned by
tests/test_state_conformance.py), and on an authed TCP daemon the auth
handshake still gates batch frames like any other. The shared views
coalesce their hot patterns automatically:
`repro_torch.profiling.store.refresh_views(store, registry)` fetches the
profile-log tail and the registry document in one frame, and
`ProfileStore(write_behind=True)` flushes buffered point/anchor rows as
one batched append frame. The daemon records batch widths in
`daemon.batch.size` and still times each sub-op into its
`daemon.op.<op>.seconds` histogram.

Sharded fleet topology, replication and failover (sharding.py): when one
daemon's write throughput caps the fleet, shard the state plane —

  topology   N primary daemons, each optionally paired with a warm
             standby:

               python -m repro_torch.state.daemon --socket /tmp/s0.sock \
                   --shard-name shard-0 --standby /tmp/s0-standby.sock
               python -m repro_torch.state.daemon --socket /tmp/s0-standby.sock
               python -m repro_torch.state.daemon --socket /tmp/s1.sock \
                   --shard-name shard-1

             backend = ShardedBackend.from_addresses(
                 ["/tmp/s0.sock", "/tmp/s1.sock"],
                 standbys=["/tmp/s0-standby.sock", None])
             publish_topology(backend)   # the doc lives on the ring

             Namespaces route by a stable md5 hash ring with virtual
             nodes, so each namespace (hence each budget envelope,
             each log, each document key's arbitration) is owned by
             exactly ONE shard and every per-namespace protocol
             guarantee holds unchanged; `batch()` splits frames by
             owning shard and fans out concurrently, so aggregate
             ops/s scales with shard count
             (`benchmarks/state_backends.py --shards N`).

  replicate  each primary's `ReplicationShipper` periodically ships log
             tails + changed documents to its standby as batched
             `replicate` frames — idempotent by cursor/version, full
             resync after a compaction gap, auth-gated like every op.

  failover   a `DaemonBackend(primary, standby=.., shard_name=..)` that
             gets `StateBackendUnavailable` from its primary retries
             the standby ONCE and re-resolves the shard's current
             primary/standby from the topology doc stored at
             (`__topology__`, "shards") on whatever node answered.
             Mutating frames interrupted mid-flight may execute at most
             twice (availability over exactly-once); log rows are
             idempotent under later-wins folding and CAS/reserve
             re-arbitrate, so views stay correct.

Choosing a backend: `InMemoryBackend` for tests and single-process
embedding; `FileBackend` for a handful of processes on one host with no
extra moving parts; `DaemonBackend` when reservation traffic is contended,
you want one process to own all writes, or clients live on other hosts
(tcp); `ShardedBackend` when one daemon's throughput or blast radius is
the bottleneck. `benchmarks/state_backends.py --transport {unix,tcp}`
measures file vs daemon under multi-process load on either transport, its
`--batch N` flag measures batched vs single-op round trips, and its
`--shards N` flag measures aggregate ops/s over 1/2/4-shard topologies.

A copy of the JAX package's ``repro/state/``. The benchmark named above is
the JAX package's.
"""
from repro_torch.state.backend import (CASConflict, InMemoryBackend, StateBackend,
                                 StateBackendError, StateBackendUnavailable)
from repro_torch.state.compaction import (DEFAULT_KEY_FIELDS, fold_log,
                                    prune_registry_doc)
from repro_torch.state.file_backend import FileBackend, FileLock, HAS_FCNTL
from repro_torch.state.transport import (AUTH_TOKEN_ENV, default_auth_token,
                                   describe_address, parse_address)

# daemon exports resolve lazily (PEP 562): `python -m repro_torch.state.daemon`
# would otherwise import the module twice (package import + runpy __main__)
# and warn about unpredictable behaviour
_DAEMON_EXPORTS = ("CrispyDaemon", "DaemonBackend", "HAS_UNIX_SOCKETS",
                   "default_socket_path")

# sharding exports resolve lazily too: sharding imports DaemonBackend for
# from_addresses/shipping, so eager import would drag daemon.py in
_SHARDING_EXPORTS = ("HashRing", "ReplicationApplier", "ReplicationShipper",
                     "ShardedBackend", "TOPOLOGY_KEY", "TOPOLOGY_NS",
                     "load_topology", "publish_topology")

__all__ = [
    "AUTH_TOKEN_ENV", "CASConflict", "CrispyDaemon", "DaemonBackend",
    "DEFAULT_KEY_FIELDS", "FileBackend", "FileLock", "HAS_FCNTL",
    "HAS_UNIX_SOCKETS", "HashRing", "InMemoryBackend",
    "ReplicationApplier", "ReplicationShipper", "ShardedBackend",
    "StateBackend", "StateBackendError", "StateBackendUnavailable",
    "TOPOLOGY_KEY", "TOPOLOGY_NS", "default_auth_token",
    "default_socket_path", "describe_address", "fold_log", "load_topology",
    "parse_address", "prune_registry_doc", "publish_topology",
]


def __getattr__(name):
    if name in _DAEMON_EXPORTS:
        from repro_torch.state import daemon
        return getattr(daemon, name)
    if name in _SHARDING_EXPORTS:
        from repro_torch.state import sharding
        return getattr(sharding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
