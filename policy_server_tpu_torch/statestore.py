"""Durable last-good state store: the substrate of crash recovery
(counterpart of the JAX package's ``statestore.py``; standard library only).

Without it a restart refetches every policy module from its registry, so a
restart during a registry outage is a total outage, and a crash forgets the
last-good epoch pin and the fetched artifacts. ``--state-dir`` points at
one directory holding:

* **a content-addressed artifact cache** (``artifacts/<sha256>``): the raw
  bytes of every module the fetch layer resolved, keyed by digest, with a
  journaled url→digest map. Boot and hot reload share it through the
  module resolver: when the policies file is byte-identical to the
  last-good manifest, pinned artifacts load from the cache with no network
  (the registry may be down); when the file changed, the live fetch is
  preferred and the cache is the loud last-good fallback when it fails.
* **per-tenant last-good epoch manifests** (``manifests.journal``),
  persisted at boot and on every promotion and rollback: the policies
  file's digest and raw text, the artifact digests the epoch resolved and
  the fingerprint of the serving configuration, so the rollback pin
  survives a restart.
* **the boot report** (``last_boot.json``) and **the shard incident log**
  (``shard_events.json``).
* **the audit snapshot and verdict-matrix spills** (``audit/*.journal``);
  their writers and readers are here, their callers are not yet.

Crash consistency: every write under the state directory goes through
:func:`atomic_write_bytes` (temp file, fsync, rename, directory fsync), and
journals are sequences of CRC-framed, generation-numbered records, so any
state on disk is a complete generation. Torn or bit-flipped state never
fails the boot: :meth:`StateStore.fsck` (run at open) moves whatever fails
framing, CRC or content-address verification into ``quarantine/``, logs
it at error level, and salvages the valid record prefix, so a boot lands
on the newest valid generation or on a clean cold start.

The on-disk format is the JAX package's byte for byte: a state directory
written by either package opens in the other.
"""

from __future__ import annotations

import binascii
import hashlib
import itertools
import json
import os
import struct
import threading
import time
from pathlib import Path
from typing import Any, Iterable, Mapping

from policy_server_tpu_torch.telemetry.tracing import logger

# journal record framing: magic | generation (u64) | payload length (u32)
# | crc32 of payload (u32) | payload (JSON). Big-endian so a hex dump is
# human-checkable during an incident.
_MAGIC = b"TPSJ"
_HEADER = struct.Struct(">4sQII")

# retention: how many manifest generations each tenant keeps in the
# journal (current + the pinned previous — the on-disk analog of the
# lifecycle's one-generation rollback pin window)
_MANIFEST_RETENTION = 2


_tmp_counter = itertools.count()


def atomic_write_bytes(path: str | Path, data: bytes) -> None:
    """The ONE durable write primitive for the state dir: write to a
    same-directory temp file, flush + fsync it, atomically rename over
    the destination, then fsync the directory so the rename itself is
    durable. A crash at ANY point leaves either the old complete file or
    the new complete file — never a torn mix. The temp name carries a
    process-wide counter on top of the pid: concurrent same-process
    writers (N tenants promoting on one SIGHUP) must never share a temp
    file."""
    path = Path(path)
    tmp = path.with_name(
        f"{path.name}.tmp.{os.getpid()}.{next(_tmp_counter)}"
    )
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dir_fd = os.open(str(path.parent), os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def _record_crc(gen: int, body: bytes) -> int:
    # the CRC covers the generation too: a bit-flipped header must not
    # reorder otherwise-valid records
    return binascii.crc32(body, binascii.crc32(struct.pack(">Q", gen))) \
        & 0xFFFFFFFF


def frame_records(records: Iterable[tuple[int, dict]]) -> bytes:
    """Serialize (generation, payload-dict) pairs into journal bytes."""
    out = bytearray()
    for gen, payload in records:
        body = json.dumps(payload, separators=(",", ":")).encode()
        out += _HEADER.pack(
            _MAGIC, int(gen), len(body), _record_crc(gen, body)
        )
        out += body
    return bytes(out)


def parse_records(data: bytes) -> tuple[list[tuple[int, dict]], bool]:
    """Parse journal bytes → ``(records, corrupt)``. Reading stops at the
    first framing/CRC/JSON failure — once one record is untrustworthy,
    so is every length-prefixed byte after it — and ``corrupt`` is True
    when ANY trailing bytes were discarded. The valid prefix is always
    returned: a torn tail costs at most the newest generation, never the
    journal."""
    records: list[tuple[int, dict]] = []
    off = 0
    n = len(data)
    while off < n:
        if off + _HEADER.size > n:
            return records, True  # torn header
        magic, gen, length, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC or length > n - off - _HEADER.size:
            return records, True
        body = data[off + _HEADER.size: off + _HEADER.size + length]
        if _record_crc(gen, body) != crc:
            return records, True
        try:
            payload = json.loads(body)
        except ValueError:
            return records, True
        if not isinstance(payload, dict):
            return records, True
        records.append((gen, payload))
        off += _HEADER.size + length
    return records, False


def compute_fingerprint(parts: Mapping[str, Any]) -> str:
    """The serving configuration's fingerprint: a digest over what the
    compiled programs of a policy set depend on — the policy ids, the
    lowering knobs (backend, optimizer, kernel, columnar) and the runtime's
    versions. A warm boot whose fingerprint matches the last-good
    manifest's builds the same programs."""
    body = json.dumps(parts, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(body.encode()).hexdigest()


class StateStore:
    """The durable last-good store (see module docstring). Construction
    runs the fsck pass: quarantine anything torn or corrupt, salvage the
    valid journal prefixes, and load the surviving state. Never raises
    for on-disk damage — the worst outcome is a clean cold boot."""

    ARTIFACTS_DIR = "artifacts"
    QUARANTINE_DIR = "quarantine"
    AUDIT_DIR = "audit"
    MANIFESTS_JOURNAL = "manifests.journal"
    URLMAP_JOURNAL = "urlmap.journal"
    AUDIT_SPILL = "audit/spill.journal"
    MATRIX_SPILL = "audit/matrix.journal"
    BOOT_REPORT = "last_boot.json"
    SHARD_EVENTS = "shard_events.json"

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self._lock = threading.Lock()
        # tenant -> newest valid manifest payload
        self._manifests: dict[str, dict] = {}  # guarded-by: _lock
        # tenant -> retained (generation, payload) history (newest last)
        self._manifest_history: dict[str, list[tuple[int, dict]]] = {}  # guarded-by: _lock
        # url -> {"digest": sha256-hex, "suffix": str}
        self._urlmap: dict[str, dict] = {}  # guarded-by: _lock
        self._generation = 0  # guarded-by: _lock
        # counters (the policy_server_statestore_* /metrics families)
        self._cache_hits = 0  # guarded-by: _lock
        self._cache_misses = 0  # guarded-by: _lock
        self._manifests_persisted = 0  # guarded-by: _lock
        self._fsck_quarantined = 0  # guarded-by: _lock
        self._audit_spills = 0  # guarded-by: _lock
        # newest generation durably spilled (write-ordering guard)
        self._audit_spill_gen = 0  # guarded-by: _lock
        self._audit_rows_restored = 0  # guarded-by: _lock
        self._matrix_spills = 0  # guarded-by: _lock
        # newest matrix generation durably spilled (same ordering guard)
        self._matrix_spill_gen = 0  # guarded-by: _lock
        self._matrix_cells_restored = 0  # guarded-by: _lock
        self._degraded_loads = 0  # guarded-by: _lock
        # shard fencing incidents durably logged
        self._shard_events_recorded = 0  # guarded-by: _lock
        for sub in ("", self.ARTIFACTS_DIR, self.QUARANTINE_DIR,
                    self.AUDIT_DIR):
            (self.root / sub).mkdir(parents=True, exist_ok=True)
        self.fsck()

    # -- fsck / quarantine -------------------------------------------------

    def _quarantine(self, path: Path, reason: str) -> None:
        """Move a damaged file into quarantine/ (rename — the bytes are
        preserved for forensics, the boot path never sees them again)."""
        dest = (
            self.root / self.QUARANTINE_DIR
            / f"{int(time.time())}-{path.name}"
        )
        try:
            os.replace(path, dest)
        except OSError:
            return  # already gone — nothing to quarantine
        with self._lock:
            self._fsck_quarantined += 1
        logger.error(
            "statestore fsck QUARANTINED %s (%s) -> %s; boot continues on "
            "the surviving state", path, reason, dest,
        )

    def _load_journal(self, rel: str) -> list[tuple[int, dict]]:
        """Read one journal through the fsck contract: salvage the valid
        record prefix, quarantine the original when anything past it was
        corrupt, and rewrite the salvage atomically so the next boot
        reads a clean file."""
        path = self.root / rel
        try:
            data = path.read_bytes()
        except FileNotFoundError:
            return []
        except OSError as e:
            self._quarantine(path, f"unreadable: {e}")
            return []
        records, corrupt = parse_records(data)
        if corrupt:
            self._quarantine(path, "torn or corrupt record(s)")
            if records:
                atomic_write_bytes(path, frame_records(records))
                logger.warning(
                    "statestore salvaged %d valid record(s) of %s",
                    len(records), rel,
                )
        return records

    def fsck(self) -> dict[str, int]:
        """The boot-time consistency pass: load + salvage the journals,
        verify every artifact blob against its content address, and
        sweep stray temp files. Damage is quarantined and counted, never
        fatal."""
        swept = 0
        quarantine_dir = self.root / self.QUARANTINE_DIR
        for path in sorted(self.root.rglob("*")):
            if quarantine_dir in path.parents:
                continue  # already-quarantined damage is settled forever
            if ".tmp." in path.name and path.is_file():
                self._quarantine(path, "stray temp file (interrupted write)")
                swept += 1
        manifest_records = self._load_journal(self.MANIFESTS_JOURNAL)
        urlmap_records = self._load_journal(self.URLMAP_JOURNAL)
        bad_blobs = 0
        for blob in sorted((self.root / self.ARTIFACTS_DIR).iterdir()):
            if not blob.is_file():
                continue
            if blob.name.endswith(".sig.json"):
                # detached-signature sidecars are keyed by their
                # artifact's digest, not their own — verification
                # decides their fate at load time
                continue
            try:
                digest = hashlib.sha256(blob.read_bytes()).hexdigest()
            except OSError:
                digest = ""
            if digest != blob.name:
                self._quarantine(
                    blob, f"content-address mismatch (sha256={digest[:12]})"
                )
                bad_blobs += 1
        with self._lock:
            self._manifests = {}
            self._manifest_history = {}
            self._urlmap = {}
            gen = 0
            for g, payload in manifest_records:
                tenant = str(payload.get("tenant", "default"))
                hist = self._manifest_history.setdefault(tenant, [])
                hist.append((g, payload))
                self._manifests[tenant] = payload
                gen = max(gen, g)
            for g, payload in urlmap_records:
                url = payload.get("url")
                if url:
                    self._urlmap[str(url)] = {
                        "digest": payload.get("digest", ""),
                    }
                gen = max(gen, g)
            self._generation = gen
            quarantined = self._fsck_quarantined
        return {
            "quarantined": quarantined,
            "manifests": len(manifest_records),
            "urls": len(urlmap_records),
            "bad_blobs": bad_blobs,
            "stray_tmp": swept,
        }

    # -- content-addressed artifact cache ----------------------------------

    def _blob_path(self, digest: str) -> Path:
        return self.root / self.ARTIFACTS_DIR / digest

    def record_artifact(
        self, url: str, data: bytes, sidecar: bytes | None = None
    ) -> str:
        """Cache one fetched module's bytes (content-addressed) and
        journal the url→digest mapping. Returns the digest. Called by
        the module resolver on every SUCCESSFUL live fetch — the cache
        always holds exactly what last fetched cleanly. ``sidecar`` is
        the detached-signature document fetched alongside the artifact:
        it lands at ``<blob>.sig.json`` so a cache-served artifact
        verifies exactly like a live-fetched one (verification configs
        must not fail-close the warm boot). No file extension is kept —
        ``load_artifact`` dispatches on content, never the name."""
        digest = hashlib.sha256(data).hexdigest()
        blob = self._blob_path(digest)
        if not blob.exists():
            atomic_write_bytes(blob, data)
        if sidecar is not None:
            atomic_write_bytes(
                blob.with_name(blob.name + ".sig.json"), sidecar
            )
        with self._lock:
            prior = self._urlmap.get(url)
            if prior is not None and prior.get("digest") == digest:
                return digest
            self._urlmap[url] = {"digest": digest}
            self._generation += 1
            # the map IS the state: one record per url, all stamped with
            # the store generation of this rewrite (newest-wins ordering
            # only matters across generations, not within one rewrite).
            # The write happens UNDER the lock: a stale snapshot written
            # after a newer one would durably lose the newer mapping.
            records = [
                (self._generation, {"url": u, **m})
                for u, m in sorted(self._urlmap.items())
            ]
            atomic_write_bytes(
                self.root / self.URLMAP_JOURNAL, frame_records(records)
            )
        return digest

    def cached_artifact(
        self, url: str, digest: str | None = None
    ) -> Path | None:
        """Resolve a url from the cache: the blob path when the mapped
        (or explicitly pinned) digest's blob exists AND its bytes verify
        against the content address; None otherwise. An explicit
        ``digest`` (the last-good manifest's pin) needs NO url-map entry
        — the pin is authoritative even when the url journal was lost to
        quarantine, which is exactly the damage scenario the pin exists
        for. A verification failure quarantines the blob — a bit-flipped
        artifact must never load."""
        want = digest
        if want is None:
            with self._lock:
                entry = self._urlmap.get(url)
            if entry is None:
                with self._lock:
                    self._cache_misses += 1
                return None
            want = entry.get("digest", "")
        blob = self._blob_path(want)
        try:
            data = blob.read_bytes()
        except OSError:
            with self._lock:
                self._cache_misses += 1
            return None
        if hashlib.sha256(data).hexdigest() != want:
            self._quarantine(blob, "artifact bytes fail content address")
            with self._lock:
                self._cache_misses += 1
            return None
        with self._lock:
            self._cache_hits += 1
        return blob

    def count_degraded_load(self) -> None:
        """A source degraded to last-good (fetch failed, cache served)."""
        with self._lock:
            self._degraded_loads += 1

    def artifact_digests(self, urls: Iterable[str]) -> dict[str, str]:
        """url → cached digest for the urls this store knows."""
        with self._lock:
            return {
                u: self._urlmap[u]["digest"]
                for u in urls
                if u in self._urlmap
            }

    # -- per-tenant last-good epoch manifests ------------------------------

    def persist_manifest(
        self,
        tenant: str,
        *,
        epoch: int,
        outcome: str,
        policy_ids: Iterable[str],
        policies_yaml: str | None = None,
        artifact_digests: Mapping[str, str] | None = None,
        fingerprint: str | None = None,
    ) -> None:
        """Append one tenant's last-good manifest (called on every
        promotion, rollback, and boot — the rollback pin must survive a
        crash that lands one nanosecond after the epoch flip)."""
        yaml_text = policies_yaml
        payload = {
            "kind": "epoch-manifest",
            "tenant": tenant,
            "epoch": int(epoch),
            "outcome": outcome,
            "policy_ids": sorted(policy_ids),
            "policies_digest": (
                hashlib.sha256(yaml_text.encode()).hexdigest()
                if yaml_text is not None else None
            ),
            "policies_yaml": yaml_text,
            "artifact_digests": dict(artifact_digests or {}),
            "fingerprint": fingerprint,
            "time": time.time(),
        }
        with self._lock:
            self._generation += 1
            hist = self._manifest_history.setdefault(tenant, [])
            hist.append((self._generation, payload))
            del hist[:-_MANIFEST_RETENTION]
            self._manifests[tenant] = payload
            self._manifests_persisted += 1
            records = sorted(
                (rec for h in self._manifest_history.values() for rec in h),
                key=lambda r: r[0],
            )
            # write UNDER the lock: two tenants promoting concurrently
            # (one SIGHUP fans out N pipelines) must serialize the
            # journal rewrite, or the stale snapshot could land second
            # and durably drop the other tenant's fresh pin
            atomic_write_bytes(
                self.root / self.MANIFESTS_JOURNAL, frame_records(records)
            )

    def last_good_manifest(self, tenant: str = "default") -> dict | None:
        """The newest valid manifest for one tenant (None = cold)."""
        with self._lock:
            m = self._manifests.get(tenant)
            return dict(m) if m is not None else None

    def pinned_digests(
        self, tenant: str, policies_yaml: str | None
    ) -> dict[str, str]:
        """The warm-boot pin: when the CURRENT policies config is
        byte-identical to the tenant's last-good manifest, return its
        url→digest pins — the resolver then loads those artifacts from
        the cache without touching the network. A changed config returns
        no pins (live fetch is preferred; the cache stays the loud
        fallback)."""
        if policies_yaml is None:
            return {}
        manifest = self.last_good_manifest(tenant)
        if manifest is None or not manifest.get("artifact_digests"):
            return {}
        digest = hashlib.sha256(policies_yaml.encode()).hexdigest()
        if manifest.get("policies_digest") != digest:
            return {}
        return dict(manifest["artifact_digests"])

    # -- audit snapshot spill ----------------------------------------------

    def spill_audit(
        self,
        rvs: Mapping[str, str],
        fed: Mapping[str, Mapping[Any, str]],
        rows: Iterable[tuple[str, bytes]],
    ) -> int:
        """Spill the audit inventory: per-kind resourceVersion cursors,
        the watch feed's fed-object map (for DELETE synthesis after a
        resume), and every snapshot row's pre-encoded payload. The whole
        spill is ONE atomic journal replace — a crash mid-spill leaves
        the previous complete spill. Returns rows spilled."""
        head = {
            "kind": "audit-spill-head",
            "rvs": dict(rvs),
            "fed": {
                k: [[list(ok), sk] for ok, sk in mapping.items()]
                for k, mapping in fed.items()
            },
            "time": time.time(),
        }
        with self._lock:
            self._generation += 1
            gen = self._generation
        records: list[tuple[int, dict]] = [(gen, head)]
        count = 0
        for key, payload in rows:
            records.append(
                (gen, {"k": key, "p": payload.decode("utf-8")})
            )
            count += 1
        data = frame_records(records)
        with self._lock:
            # ordered by GENERATION, not lock-arrival: a slower writer
            # holding an older generation (possible during a restart
            # overlap) must never rename its stale spill over a newer
            # one — it simply discards. The expensive framing stayed
            # outside the lock.
            if gen < self._audit_spill_gen:
                return count
            atomic_write_bytes(self.root / self.AUDIT_SPILL, data)
            self._audit_spill_gen = gen
            self._audit_spills += 1
        return count

    def load_audit_spill(self) -> dict | None:
        """The spilled audit state (already fsck-salvaged at open):
        ``{"rvs": {...}, "fed": {...}, "rows": [(key, payload_bytes)]}``
        or None when no spill survived. Row records after a torn tail
        were discarded by the salvage — the watch resume re-LISTs
        whatever the spill lost."""
        records = self._load_journal(self.AUDIT_SPILL)
        if not records:
            return None
        head = records[0][1]
        if head.get("kind") != "audit-spill-head":
            return None
        rows = [
            (rec["k"], rec["p"].encode("utf-8"))
            for _g, rec in records[1:]
            if "k" in rec and "p" in rec
        ]
        with self._lock:
            self._audit_rows_restored = len(rows)
        fed = {
            k: {tuple(ok): sk for ok, sk in pairs}
            for k, pairs in (head.get("fed") or {}).items()
        }
        return {"rvs": dict(head.get("rvs") or {}), "fed": fed, "rows": rows}

    # -- verdict matrix spill (audit/matrix.py) ----------------------------

    def spill_matrix(
        self, head: Mapping[str, Any], cells: Iterable[Mapping[str, Any]]
    ) -> int:
        """Spill the verdict matrix next to the audit snapshot: the head
        carries the serving epoch, matrixVersion, and the COLUMN
        FINGERPRINTS (a warm boot with a different policy set invalidates
        its columns by fingerprint mismatch, never by trust); each cell
        record carries one (resource, policy) verdict plus the payload
        hash that scopes it. Same CRC-framed journal + fsck/quarantine +
        generation-ordering contract as :meth:`spill_audit`. Returns
        cells spilled."""
        with self._lock:
            self._generation += 1
            gen = self._generation
        records: list[tuple[int, dict]] = [
            (gen, {"kind": "matrix-spill-head", "time": time.time(),
                   **dict(head)})
        ]
        count = 0
        for cell in cells:
            records.append((gen, dict(cell)))
            count += 1
        data = frame_records(records)
        with self._lock:
            # generation-ordered like spill_audit: a slower writer with
            # an older generation discards rather than clobbering
            if gen < self._matrix_spill_gen:
                return count
            atomic_write_bytes(self.root / self.MATRIX_SPILL, data)
            self._matrix_spill_gen = gen
            self._matrix_spills += 1
        return count

    def load_matrix_spill(self) -> dict | None:
        """The spilled verdict matrix (fsck-salvaged like every journal):
        ``{"epoch", "version", "cols": {policy_id: fingerprint},
        "cells": [{...}]}`` or None when no spill survived. Cell records
        past a torn tail were discarded by the salvage — the boot sweep
        re-judges whatever the spill lost."""
        records = self._load_journal(self.MATRIX_SPILL)
        if not records:
            return None
        head = records[0][1]
        if head.get("kind") != "matrix-spill-head":
            return None
        cells = [rec for _g, rec in records[1:] if "k" in rec and "p" in rec]
        with self._lock:
            self._matrix_cells_restored = len(cells)
        return {
            "epoch": int(head.get("epoch", 0)),
            "version": int(head.get("version", 0)),
            "cols": dict(head.get("cols") or {}),
            "cells": cells,
        }

    # -- boot report -------------------------------------------------------

    def record_boot_report(self, report: Mapping[str, Any]) -> None:
        """Persist the boot report (warm/cold, time-to-ready, cache
        accounting) — the restart drill and operators read it from the
        state dir after the process is up."""
        atomic_write_bytes(
            self.root / self.BOOT_REPORT,
            json.dumps(dict(report), indent=1).encode(),
        )

    # -- shard incident log (runtime/shards.py) ----------------------------

    _SHARD_EVENTS_RETAINED = 256

    def record_shard_event(self, event: Mapping[str, Any]) -> None:
        """Append one shard fencing/respawn incident to a bounded
        on-disk log — the durable complement of the router's in-memory
        counters, so post-crash forensics can answer 'which shard died,
        when, and what happened to its rows' after the process is gone.
        Best-effort like the boot report: damage loses forensics, never
        serving, and is logged at error level."""
        path = self.root / self.SHARD_EVENTS
        with self._lock:
            events = self._read_shard_events(path)
            events.append({"time": time.time(), **dict(event)})
            del events[: -self._SHARD_EVENTS_RETAINED]
            try:
                atomic_write_bytes(
                    path, json.dumps(events, indent=1).encode()
                )
                self._shard_events_recorded += 1
            except OSError as e:
                logger.error(
                    "statestore could not write the shard incident log "
                    "%s: %s; the incident stays only in memory", path, e,
                )

    @staticmethod
    def _read_shard_events(path: Path) -> "list[dict]":
        """The incident log's events; an absent log is empty, and a
        damaged one is empty too, with the damage logged at error
        level."""
        try:
            events = json.loads(path.read_bytes())
        except FileNotFoundError:
            return []
        except (OSError, ValueError) as e:
            logger.error(
                "statestore could not read the shard incident log %s: %s; "
                "its incidents are lost", path, e,
            )
            return []
        if not isinstance(events, list):
            logger.error(
                "statestore shard incident log %s is not a list; its "
                "incidents are lost", path,
            )
            return []
        return events

    def shard_events(self) -> "list[dict]":
        """The retained shard incident log, oldest first (empty when
        nothing was ever fenced or the log was damaged). The durable
        read side of :meth:`record_shard_event`: router counters reset
        whenever a reload epoch or restart rebuilds the router, this
        file does not."""
        with self._lock:
            return self._read_shard_events(self.root / self.SHARD_EVENTS)

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict[str, Any]:
        artifacts = 0
        nbytes = 0
        try:
            for blob in (self.root / self.ARTIFACTS_DIR).iterdir():
                if blob.is_file():
                    if not blob.name.endswith(".sig.json"):
                        artifacts += 1
                    nbytes += blob.stat().st_size
        except OSError as e:
            logger.error(
                "statestore could not list its artifact cache: %s", e
            )
        with self._lock:
            return {
                "artifacts_resident": artifacts,
                "bytes_resident": nbytes,
                "artifact_cache_hits": self._cache_hits,
                "artifact_cache_misses": self._cache_misses,
                "manifests_persisted": self._manifests_persisted,
                "journal_records": sum(
                    len(h) for h in self._manifest_history.values()
                ) + len(self._urlmap),
                "fsck_quarantined": self._fsck_quarantined,
                "audit_spills": self._audit_spills,
                "audit_rows_restored": self._audit_rows_restored,
                "matrix_spills": self._matrix_spills,
                "matrix_cells_restored": self._matrix_cells_restored,
                "degraded_loads": self._degraded_loads,
            }
