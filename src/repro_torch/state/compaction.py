"""Log folding + registry-document eviction: the pure logic behind the
backends' `compact` and the daemon's size/age thresholds.

Append-only logs grow forever under "later rows win" semantics — every
re-profiled point and recalibrated anchor adds a row that permanently
shadows an earlier one. Folding rewrites a log into snapshot-plus-tail
form: one surviving row per identity key (the LAST appended), dropped
tombstones, optionally dropped over-age rows. Backends then republish the
folded rows under a bumped cursor base, so the logical cursor space stays
monotone across compactions (see `StateBackend.read`).

Identity of a row = the (field, value) pairs of the `key_fields` it
actually carries, e.g. the default ("kind", "sig", "size", "key") gives
profile rows the identity (kind=profile, sig=..., size=...) and anchor
rows (kind=anchor, sig=...). A row carrying NONE of the key fields has no
foldable identity and is always kept — generic logs (benchmark counters,
audit trails) pass through a fold verbatim instead of collapsing into
their last row.

Tombstones: a row with a truthy "tombstone" field deletes its identity —
the fold drops every earlier row it shadows but KEEPS the tombstone
itself as the identity's surviving row. That is load-bearing for
incremental readers: a sibling process whose pre-compaction cursor
re-reads the folded snapshot must still see the deletion to drop the
point from its in-memory index (ProfileStore.refresh applies rows, it
never diffs against absence). Anything appended for the identity *after*
the tombstone wins over it as usual. Surviving tombstones are reaped by
the age filter: `max_age_s` drops over-age SURVIVORS (rows without a
"ts" are exempt) — the filter runs after shadowing, so an over-age
tombstone takes everything it shadows with it instead of resurrecting
older rows. Folding is idempotent and order-preserving (rows survive in
last-occurrence order), so replaying a folded log rebuilds exactly the
state of replaying the original.

A copy of the JAX package's ``repro/state/compaction.py``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

# identity fields of the rows Crispy's own stores append; rows without
# any of them (generic logs) never fold
DEFAULT_KEY_FIELDS: Tuple[str, ...] = ("kind", "sig", "size", "key")

# field names writers stamp on rows ("tombstone" marks a deletion row —
# fold_log needs no special case for it, it wins its identity like any
# later row; "ts" is what max_age_s filters on)
TOMBSTONE_FIELD = "tombstone"
TIMESTAMP_FIELD = "ts"


def fold_log(rows: Sequence[Dict],
             key_fields: Optional[Sequence[str]] = None,
             max_age_s: Optional[float] = None,
             now: Optional[float] = None) -> List[Dict]:
    """Fold `rows` (oldest first) into their surviving subset."""
    key_fields = tuple(key_fields if key_fields is not None
                       else DEFAULT_KEY_FIELDS)
    now = time.time() if now is None else now
    # "later rows win" needs no tombstone special-case here: a tombstone
    # is simply the identity's last row, shadowing the rows before it
    # (and being shadowed by a later re-put)
    survivors: Dict[object, Dict] = {}      # identity -> last row
    order: Dict[object, int] = {}           # identity -> last position
    for i, row in enumerate(rows):
        ident = tuple((f, _hashable(row[f]))
                      for f in key_fields if f in row)
        key: object = ident if ident else ("__row__", i)
        survivors[key] = row
        order[key] = i

    def over_age(row: Dict) -> bool:
        # applied to SURVIVORS only — everything an over-age tombstone
        # shadowed is already gone, so dropping it resurrects nothing
        if max_age_s is None:
            return False
        ts = row.get(TIMESTAMP_FIELD)
        return ts is not None and float(ts) < now - max_age_s

    return [survivors[k] for k in sorted(order, key=order.__getitem__)
            if not over_age(survivors[k])]


def _hashable(value):
    if isinstance(value, (list, tuple)):
        return tuple(_hashable(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _hashable(v)) for k, v in value.items()))
    return value


# -- registry-document eviction -----------------------------------------------

# how long an eviction tombstone outlives its record: long enough for
# every live sibling registry to merge the deletion into memory, short
# enough that a churning registry's tombstone map stays bounded. (A
# sibling dormant longer than this may resurrect the record on its next
# flush — the record is then simply re-evictable.)
DEFAULT_TOMBSTONE_TTL_S = 24 * 3600.0


def prune_registry_doc(value: Optional[Dict],
                       max_records: Optional[int] = None,
                       max_age_s: Optional[float] = None,
                       now: Optional[float] = None,
                       tombstone_ttl_s: float = DEFAULT_TOMBSTONE_TTL_S
                       ) -> Tuple[Dict, List[str]]:
    """Evict records from a BackendModelRegistry document by age/count.

    Works on the raw document shape ({"records": {sig: {"created_at": ..}},
    "tombstones": {sig: ts}}) so the state package needs no import of the
    allocator. Evicted signatures gain a tombstone stamped `now`, which the
    registry's merge honors — a sibling process flushing its in-memory copy
    cannot resurrect a daemon-side eviction. Tombstones older than
    `tombstone_ttl_s` have done their job and are reaped, so the doc the
    eviction knobs exist to bound never grows with eviction history.
    Returns (new_value, evicted).
    """
    now = time.time() if now is None else now
    value = dict(value or {})
    records = dict(value.get("records") or {})
    tombstones = {k: float(v)
                  for k, v in (value.get("tombstones") or {}).items()
                  if float(v) >= now - tombstone_ttl_s}
    by_age = sorted(records,
                    key=lambda sig: float(records[sig].get("created_at", 0.0)))
    evicted: List[str] = []
    if max_age_s is not None:
        for sig in by_age:
            if float(records[sig].get("created_at", 0.0)) < now - max_age_s:
                evicted.append(sig)
    if max_records is not None and len(records) - len(evicted) > max_records:
        extra = len(records) - len(evicted) - max_records
        remaining = [sig for sig in by_age if sig not in evicted]
        evicted.extend(remaining[:extra])   # oldest beyond the cap go first
    for sig in evicted:
        del records[sig]
        tombstones[sig] = now
    value["records"] = records
    value["tombstones"] = tombstones
    return value, evicted
