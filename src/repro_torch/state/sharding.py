"""Sharded, replicated state plane: scale past the single-writer daemon.

One crispy-daemon is a single writer and a single point of failure —
its throughput ceiling caps the entire fleet, and its crash takes the
shared registry with it. This module scales the state plane OUT while
keeping the `StateBackend` protocol unchanged, so every existing view
(`ProfileStore`, `BackendModelRegistry`, `ProfilingBudget`,
`TelemetryPublisher`, `__traces__` publishing) works over the sharded
plane with zero call-site changes:

  ShardedBackend      the full StateBackend protocol over N children via
                      consistent hashing of NAMESPACES. Each namespace is
                      owned by exactly one shard (a stable md5 hash ring
                      with virtual nodes), so everything the protocol
                      guarantees per namespace — append ordering, CAS
                      arbitration, reserve never-over-grants, compaction
                      cursor monotonicity — holds unchanged: it all
                      happens on the one daemon that owns the namespace.
                      A shared `ProfilingBudget` envelope is one
                      namespace, hence one arbiter. `batch()` splits a
                      multi-op frame by owning shard, fans the per-shard
                      sub-frames out CONCURRENTLY, and reassembles the
                      per-op results in original order — the service's
                      one-frame-per-batch round-trip win survives, and
                      aggregate ops/s now scales with shard count
                      (benchmarks/state_backends.py --shards).

  HashRing            the routing core. Ring positions hash
                      "<shard-name>#<vnode>"; shard names default to
                      index-based "shard-<i>" so routing depends only on
                      the shard COUNT and never on addresses — a failover
                      that swaps a shard's primary address must not
                      remap namespaces.

  ReplicationShipper  warm-standby replication for one shard. Runs
                      inside the primary daemon process with direct
                      access to its storage backend, and periodically
                      ships log tails (from per-namespace cursors) plus
                      changed versioned documents to the standby daemon
                      as ONE batched frame of `replicate` wire ops.
                      Shipping is idempotent by cursor/version (the
                      standby skips anything already applied), and a
                      post-compaction gap triggers a full re-ship from
                      the snapshot head. See repro_torch.state.transport for
                      the frame shapes.

  topology doc        {"version": n, "shards": {name: {"primary": addr,
                      "standby": addr}}} stored as a CAS document at
                      (TOPOLOGY_NS, TOPOLOGY_KEY) on EVERY node
                      (`publish_topology`), so any reachable daemon can
                      answer "who serves shard X now". `DaemonBackend`
                      uses it client-side: on `StateBackendUnavailable`
                      it retries the shard's standby once and re-resolves
                      primaries from the doc (see
                      DaemonBackend._adopt_topology).

Consistency model, stated plainly: replication is asynchronous (warm
standby, not synchronous quorum). On primary failure, rows shipped
since the last replication round may be absent on the standby until
the primary returns; acknowledged-write durability across a kill is
guaranteed for everything the shipper delivered (tests pin this via an
explicit `ship_once()` barrier). Client failover retries an
un-acknowledged op on the standby, so a mutating op interrupted
mid-flight may execute at most twice — log rows are idempotent under
the store's "later wins" fold and CAS/reserve re-arbitrate, which is
the same at-most-twice contract `DaemonBackend` already documents for
its single-daemon retry path.

A copy of the JAX package's ``repro/state/sharding.py``.
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.state.backend import StateBackend, StateBackendError
from repro_torch.state.transport import REPLICATE_OP, TOPOLOGY_KEY, TOPOLOGY_NS

# virtual nodes per shard: the ring-arc granularity. 256 keeps the
# heaviest shard within a few percent of the mean for realistic
# namespace counts (at 64 the skew reaches ~10%); building the ring is
# still just shards*vnodes md5 calls at construction time
DEFAULT_VNODES = 256


def stable_hash(text: str) -> int:
    """64-bit stable hash for ring placement. Python's builtin hash() is
    salted per process (PYTHONHASHSEED), which would route the same
    namespace to different shards in different processes — md5 is stable
    across processes, platforms and Python versions."""
    return int.from_bytes(hashlib.md5(text.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring mapping namespaces onto shard indices.

    Virtual nodes smooth the per-shard load: each shard owns `vnodes`
    ring positions, so with realistic namespace counts the heaviest
    shard stays close to the mean. Lookup is O(log(n*vnodes)) bisect.
    """

    def __init__(self, names: Sequence[str], vnodes: int = DEFAULT_VNODES):
        if not names:
            raise ValueError("hash ring needs at least one shard name")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate shard names: {list(names)}")
        self.names = list(names)
        self.vnodes = max(1, int(vnodes))
        points: List[Tuple[int, int]] = []
        for idx, name in enumerate(self.names):
            for v in range(self.vnodes):
                points.append((stable_hash(f"{name}#{v}"), idx))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._owners = [i for _, i in points]

    def owner_index(self, ns: str) -> int:
        """Index of the shard owning `ns` (first ring point clockwise of
        the namespace's hash, wrapping at the top)."""
        pos = bisect.bisect(self._hashes, stable_hash(ns))
        if pos == len(self._hashes):
            pos = 0
        return self._owners[pos]

    def owner(self, ns: str) -> str:
        return self.names[self.owner_index(ns)]


class ShardedBackend(StateBackend):
    """StateBackend over N children, routing each namespace to the one
    shard that owns it on the hash ring (see module docstring).

    Children are usually `DaemonBackend`s (one per shard primary, each
    optionally carrying a standby address for client-side failover) but
    any StateBackend works — the conformance suite runs this class over
    both in-memory and daemon children.
    """

    kind = "sharded"

    def __init__(self, children: Sequence[StateBackend],
                 names: Optional[Sequence[str]] = None,
                 vnodes: int = DEFAULT_VNODES):
        if not children:
            raise ValueError("ShardedBackend needs at least one child")
        self.children = list(children)
        # index-based default names: routing must depend only on shard
        # COUNT, never on child addresses (addresses change on failover)
        self.names = (list(names) if names is not None
                      else [f"shard-{i}" for i in range(len(self.children))])
        if len(self.names) != len(self.children):
            raise ValueError(
                f"{len(self.names)} names for {len(self.children)} children")
        self.ring = HashRing(self.names, vnodes=vnodes)

    @classmethod
    def from_addresses(cls, addresses: Sequence[str],
                       standbys: Optional[Sequence[Optional[str]]] = None,
                       auth_token: Optional[str] = None,
                       timeout_s: float = 10.0,
                       vnodes: int = DEFAULT_VNODES) -> "ShardedBackend":
        """Build the usual fleet client: one DaemonBackend per primary
        address, each tagged with its shard name and (optional) standby
        so client-side failover re-routes per shard."""
        from repro_torch.state.daemon import DaemonBackend
        standbys = list(standbys or [])
        standbys += [None] * (len(addresses) - len(standbys))
        children = [
            DaemonBackend(addr, timeout_s=timeout_s, auth_token=auth_token,
                          standby=standby, shard_name=f"shard-{i}")
            for i, (addr, standby) in enumerate(zip(addresses, standbys))]
        return cls(children, vnodes=vnodes)

    # -- routing ------------------------------------------------------------
    def shard_index(self, ns: str) -> int:
        return self.ring.owner_index(ns)

    def shard_for(self, ns: str) -> StateBackend:
        return self.children[self.ring.owner_index(ns)]

    # -- protocol: every single-namespace op routes to its owner ------------
    def append(self, ns, record):
        self.shard_for(ns).append(ns, record)

    def read(self, ns, cursor=0):
        return self.shard_for(ns).read(ns, cursor)

    def compact(self, ns, key_fields=None, max_age_s=None):
        return self.shard_for(ns).compact(ns, key_fields=key_fields,
                                          max_age_s=max_age_s)

    def load(self, ns, key):
        return self.shard_for(ns).load(ns, key)

    def cas(self, ns, key, version, value):
        return self.shard_for(ns).cas(ns, key, version, value)

    def reserve(self, ns, key, deltas, limits=None):
        # one namespace -> one owning shard -> one arbiter: the shared
        # budget envelope keeps its never-over-grant guarantee
        return self.shard_for(ns).reserve(ns, key, deltas, limits)

    # -- batched ops ---------------------------------------------------------
    def batch(self, ops: Sequence[Dict]) -> List[Dict]:
        """Split the frame by owning shard, fan the sub-frames out
        concurrently, reassemble ordered per-op results.

        Ops without a routable namespace (non-dict ops, missing "ns")
        deterministically go to shard 0, which answers with the same
        per-op error shape a single daemon would. A shard whose whole
        sub-frame fails at the transport (its primary AND standby are
        down) degrades to per-op {"ok": false} slots rather than
        poisoning the other shards' results — `sync_views` re-queues
        exactly the rows whose slots failed.

        Within one shard, sub-ops keep their relative order, so a batch
        still reads its own earlier writes per namespace (cross-shard
        sub-frames run concurrently, but ops on the SAME namespace are
        always on the same shard)."""
        ops = list(ops)
        if not ops:
            return []
        by_shard: Dict[int, List[Tuple[int, Dict]]] = {}
        for pos, op in enumerate(ops):
            ns = op.get("ns") if isinstance(op, dict) else None
            idx = self.shard_index(ns) if isinstance(ns, str) else 0
            by_shard.setdefault(idx, []).append((pos, op))

        results: List[Optional[Dict]] = [None] * len(ops)

        def run(idx: int, members: List[Tuple[int, Dict]]) -> None:
            sub = [op for _pos, op in members]
            try:
                got = self.children[idx].batch(sub)
                if len(got) != len(sub):
                    raise StateBackendError(
                        f"shard {self.names[idx]} answered {len(got)} "
                        f"results for {len(sub)} ops")
            except StateBackendError as e:
                got = [{"ok": False,
                        "error": f"shard {self.names[idx]}: {e}"}] * len(sub)
            for (pos, _op), result in zip(members, got):
                results[pos] = result

        groups = sorted(by_shard.items())
        if len(groups) == 1:
            run(*groups[0])
        else:
            threads = [threading.Thread(target=run, args=group, daemon=True)
                       for group in groups[1:]]
            for t in threads:
                t.start()
            run(*groups[0])      # run one sub-frame on the calling thread
            for t in threads:
                t.join()
        return results            # every slot filled by run()

    # -- lifecycle / introspection ------------------------------------------
    def ping(self) -> bool:
        return all(child.ping() for child in self.children)

    def close(self) -> None:
        for child in self.children:
            child.close()

    def describe(self) -> str:
        parts = []
        for name, child in zip(self.names, self.children):
            addr = getattr(child, "address", None)
            parts.append(f"{name}={addr or getattr(child, 'kind', '?')}")
        return f"sharded[{', '.join(parts)}]"

    def topology(self) -> Dict:
        """Topology descriptor for stats surfaces AND the on-ring doc:
        per-shard name/kind/address/standby plus the ring's vnode count."""
        shards = []
        for name, child in zip(self.names, self.children):
            shards.append({
                "name": name,
                "kind": getattr(child, "kind", "unknown"),
                "address": getattr(child, "address", None),
                "standby": getattr(child, "standby_address", None),
            })
        return {"vnodes": self.ring.vnodes, "shards": shards}


# -- topology doc -------------------------------------------------------------

def publish_topology(backend: ShardedBackend) -> Dict:
    """CAS-write the topology doc onto EVERY shard (so any reachable node
    can answer during failover). Returns the doc value written. Nodes
    that are down are skipped — they adopt the doc via replication or
    the next publish."""
    entries = {s["name"]: {"primary": s["address"], "standby": s["standby"]}
               for s in backend.topology()["shards"]}
    written = None
    for child in backend.children:
        try:
            while True:
                value, version = child.load(TOPOLOGY_NS, TOPOLOGY_KEY)
                doc = {"version": int((value or {}).get("version", 0)) + 1,
                       "shards": entries}
                won, _cur, _ver = child.cas(TOPOLOGY_NS, TOPOLOGY_KEY,
                                            version, doc)
                if won:
                    written = doc
                    break
        except StateBackendError:
            continue
    return written or {"version": 1, "shards": entries}


def load_topology(backend: StateBackend) -> Optional[Dict]:
    """The topology doc as seen by one node, or None."""
    value, _version = backend.load(TOPOLOGY_NS, TOPOLOGY_KEY)
    return value


# -- warm-standby replication -------------------------------------------------

class ReplicationShipper:
    """Ships one shard's state to its warm standby (see module docstring).

    Runs inside the primary daemon process against the daemon's own
    storage backend (memory or file root) — enumeration uses
    `log_namespaces()` / `doc_snapshot()` directly, no self-RPC. Each
    round reads every namespace's tail past the last shipped cursor plus
    every document whose version moved, and sends the lot as ONE batch
    frame of `replicate` ops to the standby. The standby's cursor
    tracking makes re-shipping idempotent; a "replication gap" answer
    (the standby's applied cursor predates our post-compaction base)
    resets that namespace's cursor to 0 so the next round re-ships the
    folded snapshot from the head.
    """

    def __init__(self, backend: StateBackend, standby: str,
                 auth_token: Optional[str] = None,
                 period_s: float = 0.5, timeout_s: float = 5.0):
        self.backend = backend
        self.standby = standby
        self.auth_token = auth_token
        self.period_s = max(0.01, float(period_s))
        self.timeout_s = timeout_s
        self.stats = {"rounds": 0, "shipped_rows": 0, "shipped_docs": 0,
                      "errors": 0, "resyncs": 0}
        self._cursors: Dict[str, int] = {}
        self._doc_versions: Dict[Tuple[str, str], int] = {}
        self._client: Optional[StateBackend] = None
        self._lock = threading.Lock()      # ship_once vs the period thread
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _standby_client(self) -> StateBackend:
        if self._client is None:
            from repro_torch.state.daemon import DaemonBackend
            self._client = DaemonBackend(self.standby,
                                         timeout_s=self.timeout_s,
                                         auth_token=self.auth_token)
        return self._client

    def ship_once(self) -> Dict:
        """One replication round. Returns round stats; raises
        StateBackendError when the standby is unreachable (the period
        thread swallows that — warm standby is best-effort until the
        standby returns)."""
        with self._lock:
            return self._ship_locked()

    def _ship_locked(self) -> Dict:
        ops: List[Dict] = []
        meta: List[Tuple[str, object, int]] = []
        for ns in self.backend.log_namespaces():
            prev = self._cursors.get(ns, 0)
            rows, end = self.backend.read(ns, prev)
            if not rows:
                # nothing new (a fold that dropped every row still moves
                # the cursor — track it locally, nothing to ship)
                self._cursors[ns] = max(prev, end)
                continue
            ops.append({"op": REPLICATE_OP,
                        "log": {"ns": ns, "rows": rows,
                                "base": prev, "cursor": end}})
            meta.append(("log", ns, end))
        for ns, key, value, version in self.backend.doc_snapshot():
            if version > self._doc_versions.get((ns, key), 0):
                ops.append({"op": REPLICATE_OP,
                            "doc": {"ns": ns, "key": key, "value": value,
                                    "version": version}})
                meta.append(("doc", (ns, key), version))
        round_stats = {"ops": len(ops), "rows": 0, "docs": 0, "errors": 0}
        if not ops:
            self.stats["rounds"] += 1
            return round_stats
        results = self._standby_client().batch(ops)
        for (kind, ident, val), resp in zip(meta, results):
            if resp.get("ok"):
                if kind == "log":
                    self._cursors[ident] = int(resp.get("cursor", val))
                    round_stats["rows"] += int(resp.get("applied", 0))
                else:
                    self._doc_versions[ident] = val
                    round_stats["docs"] += 1
            else:
                round_stats["errors"] += 1
                if (kind == "log"
                        and "replication gap" in str(resp.get("error", ""))):
                    # the standby is behind our compacted base: re-ship
                    # the whole folded log next round
                    self._cursors[ident] = 0
                    self.stats["resyncs"] += 1
        self.stats["rounds"] += 1
        self.stats["shipped_rows"] += round_stats["rows"]
        self.stats["shipped_docs"] += round_stats["docs"]
        self.stats["errors"] += round_stats["errors"]
        return round_stats

    # -- period thread ------------------------------------------------------
    def start(self) -> "ReplicationShipper":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="crispy-replication")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.ship_once()
            except StateBackendError:
                self.stats["errors"] += 1     # standby down: keep trying

    def stop(self, final_ship: bool = True) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        if final_ship:
            try:
                self.ship_once()     # drain the tail on graceful shutdown
            except StateBackendError:
                pass
        client, self._client = self._client, None
        if client is not None:
            client.close()


# -- standby-side application -------------------------------------------------

class ReplicationApplier:
    """The standby daemon's side of the protocol: applies `replicate`
    frames idempotently onto a local backend. Owned by CrispyDaemon
    (one per daemon; dispatch calls `apply` under the daemon's write
    lock)."""

    def __init__(self, backend: StateBackend):
        self.backend = backend
        self._log_cursors: Dict[str, int] = {}      # highest primary cursor
        self._doc_versions: Dict[Tuple[str, str], int] = {}

    def apply(self, req: Dict) -> Dict:
        log = req.get("log")
        if isinstance(log, dict):
            return self._apply_log(log)
        doc = req.get("doc")
        if isinstance(doc, dict):
            return self._apply_doc(doc)
        return {"ok": False,
                "error": "replicate frame needs a 'log' or 'doc' body"}

    def _apply_log(self, body: Dict) -> Dict:
        ns = body.get("ns")
        rows = body.get("rows")
        if not isinstance(ns, str) or not isinstance(rows, list):
            return {"ok": False, "error": "replicate log needs ns + rows"}
        base = int(body.get("base", 0))
        cursor = int(body.get("cursor", base + len(rows)))
        applied_to = self._log_cursors.get(ns, 0)
        if cursor <= applied_to:               # already have it: idempotent
            return {"ok": True, "applied": 0, "cursor": applied_to}
        if base > applied_to:
            # the primary compacted past what we hold — we cannot splice
            # this tail without a hole; demand a full re-ship
            return {"ok": False,
                    "error": (f"replication gap in {ns!r}: frame base "
                              f"{base} > applied cursor {applied_to}")}
        # overlap (base <= applied_to < cursor): skip the prefix we already
        # applied. Best-effort dedup — under the store's later-wins fold a
        # duplicated row would be harmless anyway.
        skip = min(len(rows), max(0, applied_to - base))
        applied = 0
        for row in rows[skip:]:
            self.backend.append(ns, row)
            applied += 1
        self._log_cursors[ns] = cursor
        return {"ok": True, "applied": applied, "cursor": cursor}

    def _apply_doc(self, body: Dict) -> Dict:
        ns, key = body.get("ns"), body.get("key")
        if not isinstance(ns, str) or not isinstance(key, str):
            return {"ok": False, "error": "replicate doc needs ns + key"}
        version = int(body.get("version", 0))
        value = body.get("value")
        seen = self._doc_versions.get((ns, key), 0)
        if version <= seen:                    # already have it: idempotent
            return {"ok": True, "applied": False, "version": seen}
        # force-write via CAS loop from whatever local version we hold —
        # replication is the one writer allowed to overwrite unconditionally
        # (the primary's version ordering is the source of truth)
        while True:
            _cur, local_version = self.backend.load(ns, key)
            won, _v, _ver = self.backend.cas(ns, key, local_version,
                                             value if isinstance(value, dict)
                                             else {})
            if won:
                break
        self._doc_versions[(ns, key)] = version
        return {"ok": True, "applied": True, "version": version}


__all__ = [
    "DEFAULT_VNODES", "HashRing", "ReplicationApplier", "ReplicationShipper",
    "ShardedBackend", "TOPOLOGY_KEY", "TOPOLOGY_NS", "load_topology",
    "publish_topology", "stable_hash",
]
