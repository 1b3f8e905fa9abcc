"""Flight recorder — always-on, batch-granular phase observability.

A copy of ``policy_server_tpu/telemetry/flightrec.py`` (numpy only) under
the port's name, with the same phases, ring, exemplars, trace export and
attribution:

* a per-process ring of nanosecond-stamped **phase events** covering a
  request's lifecycle — batcher queue-wait and formation, the dispatch
  window and its pool hand-off, prepare, blob dedup, encode, bookkeeping,
  fetch and the device wait under it (``device_execute``: the host-observed
  wait on the step's CUDA event), materialize, deliver. The native-frontend
  phases (``native_*``, ``ring_cross``) and ``admit`` keep their names for
  the frontend that will stamp them. Events are COMPLETE intervals (start,
  end) written into preallocated numpy arrays; the write path is lock-free
  (an ``itertools.count`` slot reservation — atomic under the GIL — plus
  plain array stores, sequence number written last so readers can reject
  torn slots). One event per phase per BATCH; per-row events only for
  sampled rows (``--recorder-row-sample-rate``).
* per-phase latency **histograms** on /metrics
  (``policy_server_phase_latency_seconds{phase=...}``, fed through
  telemetry.metrics), with tail **exemplars**: the slowest N rows per
  window keep their trace id (the request uid) and phase breakdown,
  exported as a labelled gauge family so a slow tail links to its
  timeline.
* ``GET /debug/timeline`` exports the ring as Chrome/Perfetto trace JSON,
  and :meth:`attribution` reconciles summed phase time against per-batch
  wall time — the RESIDUAL (unattributed µs per row) is a number of its
  own.

Cost: one clock read per phase boundary per batch (boundaries shared
between adjacent phases), a few array stores per event and one histogram
observe; per ROW nothing but the batch's one stride reservation and one
exemplar offer. Every phase name below is a constant stamped by exactly
one ``record_phase`` call site in the package.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Iterable

import numpy as np

# -- phase names -------------------------------------------------------------
# One constant per lifecycle phase; PHASES is the closed set. Native
# phases are stamped from timestamps a native frontend carries across its
# ring; host phases are stamped at their one call site.

PH_NATIVE_ACCEPT = "native_accept"        # request first byte → fully received
PH_NATIVE_PARSE = "native_parse"          # received → canonicalized + ring-pushed
PH_RING_CROSS = "ring_cross"              # ring push → Python drainer pop
PH_ADMIT = "admit"                        # drainer pop → batcher admission done
PH_QUEUE_WAIT = "queue_wait"              # admission → batch formed
PH_FORM = "form"                          # batch formed → phase-1 host work done
PH_DISPATCH = "dispatch"                  # phase-2 window (encode..results)
PH_HANDOFF = "handoff"                    # pool pickup + GIL wake latency
PH_PREPARE = "prepare"                    # target resolution + payload blobs
PH_ENCODE = "encode"                      # native batch encode
PH_BLOB_DEDUP = "blob_dedup"              # pre-encode blob-tier dedup pass
PH_DEVICE_EXECUTE = "device_execute"      # wait on the step's CUDA event
PH_FETCH = "fetch"                        # materialize blocked on the device result
PH_MATERIALIZE = "materialize"            # outputs → AdmissionResponse rows
PH_BOOKKEEPING = "bookkeeping"            # row dedup tiers + slot/LRU bookkeeping
PH_DELIVER = "deliver"                    # phase-3 post-process + completion fan-out
PH_NATIVE_SERIALIZE = "native_serialize"  # verdict bulk fill to the native frontend

PHASES = (
    PH_NATIVE_ACCEPT,
    PH_NATIVE_PARSE,
    PH_RING_CROSS,
    PH_ADMIT,
    PH_QUEUE_WAIT,
    PH_FORM,
    PH_DISPATCH,
    PH_HANDOFF,
    PH_PREPARE,
    PH_ENCODE,
    PH_BLOB_DEDUP,
    PH_DEVICE_EXECUTE,
    PH_FETCH,
    PH_MATERIALIZE,
    PH_BOOKKEEPING,
    PH_DELIVER,
    PH_NATIVE_SERIALIZE,
)

_PHASE_INDEX = {name: i for i, name in enumerate(PHASES)}

# phases that nest INSIDE the batcher's dispatch window and do not
# overlap each other on the single-chunk common path — the attribution
# report sums these against PH_DISPATCH. PH_DEVICE_EXECUTE is excluded:
# it is the wait on the CUDA event UNDER the fetch window, so counting both
# would double-attribute the device wall.
_DISPATCH_NESTED = (
    PH_HANDOFF, PH_PREPARE, PH_ENCODE, PH_BLOB_DEDUP, PH_FETCH,
    PH_MATERIALIZE, PH_BOOKKEEPING,
)

# event kinds
_KIND_BATCH = 0
_KIND_ROW = 1
# per-batch cache-hit/miss mix marker: not a phase interval —
# the start field carries the hit-row count, rows the delivered total.
# attribution() uses it to split phase time into hit/miss batch groups.
_KIND_MIX = 2

_KIND_NAMES = ("batch", "row", "mix")

DEFAULT_RING_EVENTS = 65536
DEFAULT_ROW_SAMPLE_RATE = 0.01
EXEMPLAR_SLOTS = 8
EXEMPLAR_WINDOW_SECONDS = 30.0


def _pow2(n: int) -> int:
    p = 1
    while p < max(16, int(n)):
        p <<= 1
    return p


class FlightRecorder:
    """Lock-free ring of phase events + exemplar reservoir.

    Writers reserve a slot with ``itertools.count`` (GIL-atomic), store
    the event fields, and store the sequence number LAST; readers copy
    the arrays, then keep only slots whose sequence survived a second
    read — a torn slot (overwritten mid-copy) is dropped, never
    misread. No lock is ever taken on the serving path.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_RING_EVENTS,
        row_sample_rate: float = DEFAULT_ROW_SAMPLE_RATE,
        registry: Any = None,
        exemplar_slots: int = EXEMPLAR_SLOTS,
        exemplar_window_seconds: float = EXEMPLAR_WINDOW_SECONDS,
    ) -> None:
        cap = _pow2(capacity)
        self._cap = cap
        self._mask = cap - 1
        self._start = np.zeros(cap, dtype=np.int64)
        self._end = np.zeros(cap, dtype=np.int64)
        self._phase = np.zeros(cap, dtype=np.int16)
        self._kind = np.zeros(cap, dtype=np.int8)
        self._batch = np.full(cap, -1, dtype=np.int64)
        self._rows = np.zeros(cap, dtype=np.int32)
        self._seq = np.full(cap, -1, dtype=np.int64)
        # per-slot row id (request uid) for sampled-row events; plain
        # list — assignment is GIL-atomic like the array stores
        self._uids: list[str | None] = [None] * cap
        self._counter = itertools.count()
        self._batch_counter = itertools.count(1)
        # deterministic 1-in-stride row sampling: no RNG on the serving
        # path, reproducible tests
        stride = (
            0 if row_sample_rate <= 0
            else max(1, int(round(1.0 / min(1.0, row_sample_rate))))
        )
        self._row_stride = stride
        self._row_tick = itertools.count()
        # batch-granular stride reservation (sample_indices): one tiny
        # lock acquisition per BATCH replaces a counter tick per row
        self._row_lock = threading.Lock()
        self._row_pos = 0  # guarded-by: _row_lock
        self._rows_sampled = itertools.count()
        self._rows_sampled_n = 0  # last drawn value (scrape-only)
        # per-phase histogram children through the metrics registry (one
        # funnel: /metrics pull + OTLP push read the same aggregation)
        self._observe = None
        if registry is not None:
            observe = getattr(registry, "observe_phase", None)
            if observe is not None:
                self._observe = observe
        # -- exemplar reservoir (slowest N rows per window) ---------------
        self._ex_lock = threading.Lock()
        self._ex_slots = max(1, int(exemplar_slots))
        self._ex_window_ns = int(exemplar_window_seconds * 1e9)
        self._ex_current: list[tuple] = []  # guarded-by: _ex_lock
        self._ex_prev: list[tuple] = []  # guarded-by: _ex_lock
        self._ex_window_start = time.perf_counter_ns()  # guarded-by: _ex_lock
        # lock-free fast-path floor: rows faster than the slowest
        # retained exemplar skip the lock entirely (stale reads are
        # benign — at worst one extra lock acquisition)
        self._ex_floor = 0.0  # lock-free: a monotone hint, re-checked under _ex_lock

    # -- write path --------------------------------------------------------

    def next_batch(self) -> int:
        """Reserve a batch id (timeline correlation key)."""
        return next(self._batch_counter)

    def record_phase(
        self,
        phase: str,
        start_ns: int,
        end_ns: int,
        rows: int = 1,
        batch: int = -1,
    ) -> None:
        """One batch-granular phase interval. ``start_ns``/``end_ns`` are
        ``time.perf_counter_ns`` stamps (or the native frontend's
        CLOCK_MONOTONIC ns — the same clock on Linux)."""
        self._write(
            _PHASE_INDEX[phase], _KIND_BATCH, int(start_ns), int(end_ns),
            rows, batch, None,
        )
        if self._observe is not None:
            self._observe(phase, max(0, end_ns - start_ns) / 1e9)

    def record_batch_mix(
        self, batch: int, hit_rows: int, total_rows: int
    ) -> None:
        """One per-batch marker tagging how many delivered rows rode the
        pre-serialized cache-hit lane (the batcher's phase-3
        FragVerdict count). :meth:`attribution` joins it against the
        batch's phase intervals to report hit-batch vs miss-batch phase
        cost separately — the decomposition that shows WHERE the
        miss-path gap lives. Costs one ring write per batch."""
        self._write(
            0, _KIND_MIX, int(hit_rows), 0, int(total_rows), int(batch),
            None,
        )

    def _write(
        self, phase_i: int, kind: int, start_ns: int, end_ns: int,
        rows: int, batch: int, uid: str | None,
    ) -> None:
        seq = next(self._counter)
        i = seq & self._mask
        self._seq[i] = -1  # invalidate while fields are torn
        self._start[i] = start_ns
        self._end[i] = end_ns
        self._phase[i] = phase_i
        self._kind[i] = kind
        self._batch[i] = batch
        self._rows[i] = rows
        self._uids[i] = uid
        self._seq[i] = seq  # publish last

    # row flags: bit 0 = timeline-sampled, bit 1 = exemplar candidate
    ROW_SAMPLED = 1
    ROW_EXEMPLAR = 2

    def row_flags(self, latency_s: float) -> int:
        """The per-row hot-path gate (the batcher calls this once per
        delivered row): one counter tick decides timeline sampling, one
        float compare against the exemplar floor decides candidacy.
        Everything heavier happens only for the sampled/slow tail
        (record_row)."""
        flags = 0
        if self._row_stride and next(self._row_tick) % self._row_stride == 0:
            flags = self.ROW_SAMPLED
        if latency_s > self._ex_floor:
            flags |= self.ROW_EXEMPLAR
        return flags

    def record_row(
        self,
        uid: str,
        policy_id: str,
        enqueued_ns: int,
        done_ns: int,
        batch: int,
        breakdown: "dict[str, int]",
        flags: int,
    ) -> None:
        """The slow-tail half of the per-row hook: write the sampled
        row's timeline segments and/or offer it to the exemplar
        reservoir. ``breakdown`` maps phase name → duration ns for the
        phases the caller attributes to this row; timeline segments lay
        the durations back to back from the enqueue stamp."""
        if flags & self.ROW_SAMPLED:
            self._rows_sampled_n = next(self._rows_sampled) + 1
            t = enqueued_ns
            for name, dur in breakdown.items():
                self._write(
                    _PHASE_INDEX[name], _KIND_ROW, t, t + int(dur),
                    1, batch, uid,
                )
                t += int(dur)
        if flags & self.ROW_EXEMPLAR:
            latency_s = max(0, done_ns - enqueued_ns) / 1e9
            self._observe_exemplar(
                uid, policy_id, latency_s, done_ns, breakdown
            )

    def observe_row(
        self,
        uid: str,
        policy_id: str,
        enqueued_ns: int,
        done_ns: int,
        batch: int,
        breakdown: "dict[str, int] | None" = None,
    ) -> None:
        """Convenience form of row_flags + record_row (tests, embedders;
        the batcher uses the batch-granular sample_indices +
        offer_exemplar forms)."""
        latency_s = max(0, done_ns - enqueued_ns) / 1e9
        flags = self.row_flags(latency_s)
        if flags:
            self.record_row(
                uid, policy_id, enqueued_ns, done_ns, batch,
                breakdown or {}, flags,
            )

    def sample_indices(self, n: int) -> range:
        """Reserve the row-sampling stride positions for a batch of
        ``n`` rows: ONE lock acquisition per batch (replacing a counter
        tick per row — measured as real overhead at serving rate),
        returning the in-batch indices that fall on the deterministic
        stride."""
        stride = self._row_stride
        if not stride or n <= 0:
            return range(0)
        with self._row_lock:
            start = self._row_pos
            self._row_pos = start + n
        first = (-start) % stride
        return range(first, n, stride)

    def offer_exemplar(
        self,
        uid: str,
        policy_id: str,
        enqueued_ns: int,
        done_ns: int,
        breakdown: "dict[str, int]",
    ) -> None:
        """One exemplar offer per BATCH (the batcher offers its oldest
        live row — all rows of a batch share the completion stamp, so
        the oldest IS the batch's slowest). The floor pre-check keeps
        the fast path lock-free."""
        latency_s = max(0, done_ns - enqueued_ns) / 1e9
        # enter on floor-beat OR window expiry: rotation happens inside
        # _observe_exemplar, and a floor-only gate would FREEZE the
        # table after a transient spike (boot compiles fill the window
        # with ~100 ms rows, steady-state ~2 ms rows then never beat
        # the floor, and the stale spike serves forever)
        if (
            latency_s > self._ex_floor
            or done_ns - self._ex_window_start > self._ex_window_ns  # an expiry hint like _ex_floor, re-checked under _ex_lock
        ):
            self._observe_exemplar(
                uid, policy_id, latency_s, done_ns, breakdown
            )

    def _rotate_window_locked(self, now_ns: int) -> None:
        # holds: _ex_lock — the ONE rotation sequence for the write
        # (offer) and read (exemplars) paths
        if now_ns - self._ex_window_start > self._ex_window_ns:
            self._ex_prev = self._ex_current
            self._ex_current = []
            self._ex_window_start = now_ns
            self._ex_floor = 0.0

    def _observe_exemplar(
        self, uid, policy_id, latency_s, now_ns, breakdown
    ) -> None:
        with self._ex_lock:
            self._rotate_window_locked(now_ns)
            cur = self._ex_current
            cur.append((latency_s, uid, policy_id, dict(breakdown)))
            cur.sort(key=lambda e: -e[0])
            del cur[self._ex_slots:]
            if len(cur) >= self._ex_slots:
                self._ex_floor = cur[-1][0]

    # -- read surfaces -----------------------------------------------------

    def events_recorded(self) -> int:
        """Total events ever written (exact: derived from the published
        sequence numbers, so racing writers cannot under-count)."""
        return int(self._seq.max(initial=-1)) + 1

    def rows_sampled(self) -> int:
        return self._rows_sampled_n

    def snapshot(self) -> list[dict]:
        """Consistent copy of the ring's live events, oldest first. Slots
        overwritten while copying are dropped (seq re-check), never
        misread."""
        seq1 = self._seq.copy()
        start = self._start.copy()
        end = self._end.copy()
        phase = self._phase.copy()
        kind = self._kind.copy()
        batch = self._batch.copy()
        rows = self._rows.copy()
        uids = list(self._uids)
        seq2 = self._seq.copy()
        valid = (seq1 >= 0) & (seq1 == seq2)
        order = np.argsort(seq1[valid], kind="stable")
        idx = np.nonzero(valid)[0][order]
        return [
            {
                "seq": int(seq1[i]),
                "phase": PHASES[phase[i]],
                "kind": _KIND_NAMES[kind[i]],
                "start_ns": int(start[i]),
                "end_ns": int(end[i]),
                "rows": int(rows[i]),
                "batch": int(batch[i]),
                "uid": uids[i],
            }
            for i in idx
        ]

    def exemplars(self) -> list[dict]:
        """The slowest rows of the current + previous exemplar windows,
        slowest first — each with its trace id (request uid) and phase
        breakdown, so a p99 blip links to its timeline. Reads also
        rotate an expired window, so an idle tail (no offers) ages out
        within two windows instead of pinning stale rows."""
        with self._ex_lock:
            self._rotate_window_locked(time.perf_counter_ns())
            merged = sorted(
                self._ex_current + self._ex_prev, key=lambda e: -e[0]
            )
        out: list[dict] = []
        seen: set[tuple] = set()
        for lat, uid, pid, br in merged:
            slowest = max(br, key=br.get) if br else ""
            # dedup by the FULL label tuple: the uid is client-supplied,
            # and a duplicate (same request in both windows, or a
            # replayed uid) would make the /metrics exemplar family emit
            # two series with identical labels — prometheus rejects the
            # entire scrape on duplicate samples. Slowest entry wins
            # (merged is sorted slowest-first).
            key = (uid, pid, slowest)
            if key in seen:
                continue
            seen.add(key)
            out.append(
                {
                    "trace_id": uid,
                    "policy_id": pid,
                    "latency_seconds": round(lat, 6),
                    "slowest_phase": slowest,
                    "phase_breakdown_us": {
                        k: round(v / 1e3, 1) for k, v in br.items()
                    },
                }
            )
            if len(out) >= self._ex_slots:
                break
        return out

    # -- Chrome/Perfetto trace export --------------------------------------

    def chrome_trace(self) -> dict:
        """The ring as a Chrome trace JSON object (load it in Perfetto or
        chrome://tracing). Batch events land on pid 1 with one track per
        in-flight batch lane (environment phases share their batch's
        track, so encode/fetch nest visually under the dispatch slice);
        native burst events get their own track; sampled rows land on
        pid 2, one track per hash lane."""
        events: list[dict] = []
        names = {
            (1, 0): "native frontend (burst aggregates)",
        }
        for ev in self.snapshot():
            if ev["kind"] == "mix":
                continue  # bookkeeping marker, not a timeline interval
            if ev["kind"] == "batch":
                pid = 1
                tid = 0 if ev["batch"] < 0 else 1 + (ev["batch"] % 12)
                if tid:
                    names[(1, tid)] = f"batch lane {tid - 1}"
            else:
                pid = 2
                tid = (hash(ev["uid"]) & 0x7) + 1
                names[(2, tid)] = f"sampled rows lane {tid - 1}"
            args = {"rows": ev["rows"], "batch": ev["batch"]}
            if ev["uid"]:
                args["uid"] = ev["uid"]
            events.append(
                {
                    "name": ev["phase"],
                    "cat": "serving" if pid == 1 else "row",
                    "ph": "X",
                    "ts": ev["start_ns"] / 1e3,
                    "dur": max(0, ev["end_ns"] - ev["start_ns"]) / 1e3,
                    "pid": pid,
                    "tid": tid,
                    "args": args,
                }
            )
        meta = [
            {
                "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                "args": {"name": "policy-server serving path"},
            },
            {
                "name": "process_name", "ph": "M", "pid": 2, "tid": 0,
                "args": {"name": "policy-server sampled rows"},
            },
        ]
        for (pid, tid), name in sorted(names.items()):
            meta.append(
                {
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": name},
                }
            )
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "clock": "CLOCK_MONOTONIC ns (ts in us)",
                "events_recorded": self.events_recorded(),
                "ring_capacity": self._cap,
                "rows_sampled": self.rows_sampled(),
            },
            "exemplars": self.exemplars(),
        }

    def chrome_trace_json(self) -> bytes:
        return json.dumps(self.chrome_trace()).encode()

    # -- phase attribution -------------------------------------------------

    def attribution(self, since: int = 0) -> dict:
        """Reconcile summed phase time against wall time per batch.
        ``since`` is an event cursor (``events_recorded()`` taken before
        the measured window) so warmup/cold-compile batches already in
        the ring do not pollute a steady-state measurement.

        For every COMPLETE batch (form + dispatch + deliver events all
        present in the ring), wall = form.start → deliver.end. The
        attributed time is form + deliver plus the environment phases
        nested inside the dispatch window (encode, blob_dedup, fetch,
        materialize, bookkeeping — device_execute is excluded as it
        runs UNDER the fetch wait). The residual — dispatch time no
        nested phase explains, plus gaps between the batcher phases —
        is the measured unattributed host floor, reported per row."""
        snap = self.snapshot()
        batches: dict[int, dict[str, list[tuple[int, int, int]]]] = {}
        # batch id → (hit_rows, total_rows) from the per-batch mix
        # markers: joins each batch's phase intervals to its
        # cache-hit/miss composition
        mixes: dict[int, tuple[int, int]] = {}
        for ev in snap:
            if ev["batch"] < 0 or ev["seq"] < since:
                continue
            if ev["kind"] == "mix":
                mixes[ev["batch"]] = (ev["start_ns"], ev["rows"])
                continue
            if ev["kind"] != "batch":
                continue
            batches.setdefault(ev["batch"], {}).setdefault(
                ev["phase"], []
            ).append((ev["start_ns"], ev["end_ns"], ev["rows"]))

        def dur(phs, name) -> int:
            return sum(max(0, e - s) for s, e, _r in phs.get(name, ()))

        def _acc() -> dict:
            return {
                "totals": {p: 0.0 for p in PHASES},
                "rows": 0, "wall": 0, "residual": 0, "queue": 0,
                "batches": 0,
            }

        overall = _acc()
        # hit = every delivered row rode the cache-hit lane, miss = none
        # did, mixed = both in one batch; batches with no mix marker
        # (producers that write none) stay out of the
        # split but keep counting into the overall numbers
        groups: dict[str, dict] = {}
        for bid, phs in batches.items():
            if not all(
                k in phs for k in (PH_FORM, PH_DISPATCH, PH_DELIVER)
            ):
                continue
            form_s, form_e, rows = phs[PH_FORM][0]
            _disp_s, _disp_e, _ = phs[PH_DISPATCH][0]
            _del_s, del_e, _ = phs[PH_DELIVER][0]
            wall = max(0, del_e - form_s)
            form_d = dur(phs, PH_FORM)
            disp_d = dur(phs, PH_DISPATCH)
            del_d = dur(phs, PH_DELIVER)
            nested = sum(dur(phs, p) for p in _DISPATCH_NESTED)
            residual = max(0, disp_d - nested) + max(
                0, wall - (form_d + disp_d + del_d)
            )
            sinks = [overall]
            mix = mixes.get(bid)
            if mix is not None:
                hits, total = mix
                name = (
                    "miss" if hits <= 0
                    else "hit" if hits >= total
                    else "mixed"
                )
                sinks.append(groups.setdefault(name, _acc()))
            for acc in sinks:
                acc["batches"] += 1
                acc["rows"] += rows
                acc["wall"] += wall
                acc["residual"] += residual
                acc["queue"] += dur(phs, PH_QUEUE_WAIT)
                for p in PHASES:
                    acc["totals"][p] += dur(phs, p)

        def _report(acc: dict) -> dict:
            rows = max(1, acc["rows"])
            return {
                "batches_complete": acc["batches"],
                "rows": acc["rows"],
                "wall_us_per_row": round(acc["wall"] / rows / 1e3, 2),
                "queue_wait_us_per_row": round(
                    acc["queue"] / rows / 1e3, 2
                ),
                "phase_us_per_row": {
                    p: round(acc["totals"][p] / rows / 1e3, 2)
                    for p in PHASES
                    if acc["totals"][p] > 0
                },
                "residual_us_per_row": round(
                    acc["residual"] / rows / 1e3, 2
                ),
                "residual_fraction_of_wall": round(
                    acc["residual"] / max(1, acc["wall"]), 4
                ),
            }

        out = _report(overall)
        out["mix_groups"] = {
            name: _report(acc) for name, acc in sorted(groups.items())
        }
        return out


# ---------------------------------------------------------------------------
# Global recorder + cross-thread batch scope
# ---------------------------------------------------------------------------

_recorder: FlightRecorder | None = None
# batch-id scope carried onto pool threads explicitly (threading.local —
# the encode/device pool workers inherit it from the submitting wrapper,
# mirroring failpoints.scope)
_scope = threading.local()


def install(rec: FlightRecorder | None) -> FlightRecorder | None:
    """Install (or clear, with None) the process-wide recorder. Called by
    the server bootstrap; tests install their own and clear after."""
    global _recorder
    _recorder = rec
    return rec


def recorder() -> FlightRecorder | None:
    return _recorder


def current_batch() -> int:
    """The ambient batch id on this thread (-1 outside a batch scope)."""
    return getattr(_scope, "batch", -1)


class batch_scope:
    """Context manager pinning the ambient batch id on this thread —
    evaluation work crosses to pool threads, and the environment's phase
    events must attribute to the submitting batch."""

    __slots__ = ("_bid", "_prev")

    def __init__(self, bid: int):
        self._bid = bid

    def __enter__(self) -> "batch_scope":
        self._prev = getattr(_scope, "batch", -1)
        _scope.batch = self._bid
        return self

    def __exit__(self, *exc) -> None:
        _scope.batch = self._prev
