"""Bit-exact verdict caching and dedup.

Soundness: the ``policy_matrix`` kernel and the combine after it are a
stateless pure function of the encoded row. What is cached is the OUTPUT
ROW (verdict bits and rule indices), never the AdmissionResponse:
materialization re-runs per request, so uids, patches and dynamic messages
are computed from each request's own payload (bit-identical by key
equality, but carrying the right uid).

Two dedup tiers, and why BOTH exist:

* **Blob tier** — key: (target, canonical payload blob) — the exact JSON
  bytes the encoder consumes (environment._payload_blob, which already
  embeds the context providers' outputs). Equal blobs mean equal encoded
  rows mean equal device outputs. Because the key exists BEFORE encoding,
  an exact replay skips the encoder entirely, where without it every
  duplicate would pay a full C++ encode just to discover its row key.
  It cannot, however, see through uid/name variation: a Deployment
  rollout admits replica pods whose payloads differ in uid and generated
  name, so their blobs differ even though no policy reads those fields.

* **Row tier** — key: (target, packed row bytes) — the encoded feature
  row. The request uid is not a policy feature, so uid/name-varying
  duplicates collapse to one row AFTER encoding; this tier catches what
  the blob tier structurally cannot, at the price of paying the encode.
  Schema packed widths are unique (ensure_unique_packed_widths), so the
  bytes alone identify (schema, encoded request).

A hit in either tier returns the identical output row, so the tiers are
interchangeable for correctness; they differ only in what they can prove
equal and how early. Lookups go blob tier first (cheaper, earlier),
then row tier; misses populate both.

Capacity is BYTES, not rows: a row budget smaller than the live
template working set thrashes. The byte estimate per entry covers the key
bytes, the row's array payloads, and container overheads — approximate
but monotone, which is all an eviction bound needs.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable, Iterable, Mapping

# Fixed per-entry overhead estimate: OrderedDict slot + key tuple + the
# row dict's own header. Deliberately conservative (real CPython cost is
# a little higher); the bound only needs to be monotone in entry count.
_ENTRY_OVERHEAD = 256
# Per row-dict item: dict slot + boxed Python scalar (keys are interned
# strings shared across every row of an environment, so not counted).
_ROW_ITEM_COST = 80


def entry_cost(key: Hashable, row: Mapping[str, Any]) -> int:
    """Approximate resident bytes of one cache entry (key + row)."""
    cost = _ENTRY_OVERHEAD
    if isinstance(key, tuple):
        for part in key:
            if isinstance(part, (bytes, bytearray, str)):
                cost += len(part)
    cost += _ROW_ITEM_COST * len(row)
    # list() snapshots the view in one C-level pass (no thread switch):
    # cached rows are MUTATED after insertion — the
    # fragment lane lazily attaches FRAG_KEY to a hit row, and a
    # concurrent backfill re-inserting the same row object must not
    # race that insert with a Python-level values() iteration
    # (RuntimeError: dictionary changed size during iteration)
    for v in list(row.values()):
        nbytes = getattr(v, "nbytes", None)
        if nbytes is not None:
            cost += int(nbytes)
        elif isinstance(v, (bytes, str)):
            cost += len(v)
    return cost


class VerdictCache:
    """Thread-safe, byte-bounded LRU of cache key -> output-row dict.

    One instance per tier (blob / row); the batched ``get_many`` /
    ``put_many`` entry points exist so a dispatch chunk pays ONE lock
    acquisition per tier per chunk instead of one per row.
    """

    def __init__(self, capacity_bytes: int) -> None:
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be positive")
        self.capacity_bytes = capacity_bytes
        # key -> (row, cost)
        self._data: OrderedDict[Hashable, tuple[Mapping[str, Any], int]] = (
            OrderedDict()
        )  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock

    def get(self, key: Hashable) -> Mapping[str, Any] | None:
        with self._lock:
            ent = self._data.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return ent[0]

    def get_many(
        self, keys: Iterable[Hashable | None]
    ) -> list[Mapping[str, Any] | None]:
        """Batched get under ONE lock; ``None`` keys pass through as
        ``None`` without counting as misses (callers use them for
        uncacheable rows to keep index alignment)."""
        out: list[Mapping[str, Any] | None] = []
        with self._lock:
            data = self._data
            hits = misses = 0
            for key in keys:
                if key is None:
                    out.append(None)
                    continue
                ent = data.get(key)
                if ent is None:
                    misses += 1
                    out.append(None)
                else:
                    data.move_to_end(key)
                    hits += 1
                    out.append(ent[0])
            self.hits += hits
            self.misses += misses
        return out

    def adjust_counts(self, hits: int = 0, misses: int = 0) -> None:
        """Re-scale hit/miss accounting to ROW granularity: a batched
        ``get_many`` over deduplicated combo keys counts one hit per KEY,
        but one key may answer many rows of the chunk — the caller adds
        the per-row remainder so the counters count rows (served from /
        missed by this tier)."""
        with self._lock:
            self.hits += hits
            self.misses += misses

    def _put_locked(self, key: Hashable, row: Mapping[str, Any], cost: int) -> None:
        data = self._data
        old = data.pop(key, None)  # pop+reinsert lands at the MRU end
        if old is not None:
            self._bytes -= old[1]
        data[key] = (row, cost)
        self._bytes += cost
        while self._bytes > self.capacity_bytes and data:
            _, (_, evicted_cost) = data.popitem(last=False)
            self._bytes -= evicted_cost

    def put(self, key: Hashable, row: Mapping[str, Any]) -> None:
        cost = entry_cost(key, row)
        with self._lock:
            self._put_locked(key, row, cost)

    def put_many(
        self, pairs: Iterable[tuple[Hashable, Mapping[str, Any]]]
    ) -> None:
        """Batched put under ONE lock. Row cost is memoized by object
        identity within the call — a dispatch chunk inserts the same row
        object under many keys (one per duplicate blob)."""
        cost_of: dict[int, int] = {}
        costed = []
        for key, row in pairs:
            c = cost_of.get(id(row))
            if c is None:
                # key bytes vary per entry; split the estimate so the
                # memo only covers the row part
                c = entry_cost((), row)
                cost_of[id(row)] = c
            kc = 0
            if isinstance(key, tuple):
                for part in key:
                    if isinstance(part, (bytes, bytearray, str)):
                        kc += len(part)
            costed.append((key, row, c + kc))
        with self._lock:
            for key, row, cost in costed:
                self._put_locked(key, row, cost)

    def __len__(self) -> int:
        # locked: len(OrderedDict) races a concurrent _put_locked's
        # pop/reinsert
        with self._lock:
            return len(self._data)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = 0

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "cache_hits": self.hits,
                "cache_misses": self.misses,
                "cache_entries": len(self._data),
                "cache_bytes": self._bytes,
                "cache_capacity": self.capacity_bytes,
            }


def extract_row(outputs: Mapping[str, Any], row: int) -> dict[str, Any]:
    """One row of a batched outputs dict as a flat, self-owned dict.

    np scalars become Python scalars (smaller, no parent-buffer refs);
    array-valued entries are copied so the cached row never pins the
    batch buffer it was sliced from.
    """
    import numpy as np

    out: dict[str, Any] = {}
    for k, v in outputs.items():
        rv = v[row]
        if isinstance(rv, np.generic):
            rv = rv.item()
        elif isinstance(rv, np.ndarray):
            rv = rv.copy()
        out[k] = rv
    return out
