"""String interning: the bridge between unbounded JSON strings and
fixed-shape int32 tensors.

TPU-first design note (SURVEY.md §7.4 hard-part #1): strings never reach the
device. Every string is mapped to a dense int32 id by an append-only,
thread-safe table. Policy-settings constants are interned at compile time, so
device-side string equality is id equality; string *predicates* (regex, glob,
prefix...) are evaluated host-side once per unique string at intern time and
cached per predicate, so the codec can emit the precomputed boolean as a
feature column — no vocabulary-sized tables on device, features stay O(batch).

There is no reference counterpart: the reference hands raw JSON to WASM
(src/evaluation/evaluation_environment.rs:546-581). Interning is what makes
the batched XLA predicate path possible.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterator

MISSING_ID = 0
_MISSING_SENTINEL = "\x00__missing__"


class InternTable:
    """Append-only string → int32 id table with per-predicate bit caches.

    Thread-safe: many HTTP worker threads intern concurrently. Ids are dense
    and start at 1 (0 is the reserved MISSING id).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # guarded-by: _lock for WRITES; reads are lock-free by the
        # append-only + publish-id-last protocol (inline ignores below)
        self._ids: dict[str, int] = {_MISSING_SENTINEL: MISSING_ID}  # guarded-by: _lock
        self._strings: list[str] = [_MISSING_SENTINEL]  # guarded-by: _lock
        # pred_key -> (fn, list[bool] aligned with self._strings)
        self._preds: dict[str, tuple[Callable[[str], bool], list[bool]]] = {}  # guarded-by: _lock

    def __len__(self) -> int:
        return len(self._strings)  # graftcheck: ignore — append-only, len is monotone

    def intern(self, s: str) -> int:
        existing = self._ids.get(s)  # graftcheck: ignore — lock-free fast path (publish-last)
        if existing is not None:
            return existing
        with self._lock:
            existing = self._ids.get(s)
            if existing is not None:
                return existing
            new_id = len(self._strings)
            self._strings.append(s)
            for fn, bits in self._preds.values():
                bits.append(self._apply(fn, s))
            # publish the id LAST: pred_bit's lock-free fast path indexes
            # the bit lists by any id it can observe, so an id must never
            # be visible before every predicate's bit exists (parallel
            # encode threads hit this race otherwise)
            self._ids[s] = new_id
            return new_id

    def lookup(self, s: str) -> int | None:
        return self._ids.get(s)  # graftcheck: ignore — lock-free read (publish-last)

    def string_of(self, id_: int) -> str:
        if id_ == MISSING_ID:
            raise KeyError("MISSING id has no string")
        return self._strings[id_]  # graftcheck: ignore — ids index the append-only prefix

    def register_pred(self, key: str, fn: Callable[[str], bool]) -> None:
        """Register a string predicate; backfills bits for existing strings.
        Idempotent per key."""
        with self._lock:
            if key in self._preds:
                return
            bits = [False] + [self._apply(fn, s) for s in self._strings[1:]]
            self._preds[key] = (fn, bits)

    def pred_bit(self, key: str, id_: int) -> bool:
        """Predicate result for an already-interned string id (False for
        MISSING)."""
        if id_ == MISSING_ID:
            return False
        return self._preds[key][1][id_]  # graftcheck: ignore — bit exists before id is visible

    def pred_value(self, key: str, s: str) -> bool:
        return self.pred_bit(key, self.intern(s))

    @staticmethod
    def _apply(fn: Callable[[str], bool], s: str) -> bool:
        try:
            return bool(fn(s))
        except Exception:
            return False

    def strings(self) -> Iterator[str]:
        yield from self._strings[1:]  # graftcheck: ignore — append-only snapshot read
