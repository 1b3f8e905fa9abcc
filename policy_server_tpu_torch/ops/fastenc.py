"""ctypes bindings and g++ build of the native encoder
(``policy_server_tpu_torch/csrc/fastenc.cpp``).

The native encoder is the C++ twin of the codec's extraction trie
(``ops/codec.py``): it parses a request's JSON bytes directly (no Python
dict on the hot path), writes numeric, bool and presence features straight
into the packed numpy buffer, and returns the id and predicate strings
through an arena that Python interns with the environment's table. The
whole encode runs with the GIL released, so pipeline workers encode on
parallel threads.

Build: compiled at first use with ``g++ -O2 -shared -fPIC -std=c++17`` into
``build/torch_kernels/torch_fastenc-<abi>.so`` beside the package, and
reused while it is newer than the source. A failed build or load raises
with g++'s output: there is no silent fallback to the Python trie, which
stays the encoder's plain version (``FeatureSchema.encode``) for the
tests, ``encode_bucketed`` and the host path.
"""

from __future__ import annotations

import ctypes
import fcntl
import json
import os
import subprocess
import sys
import sysconfig
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

from policy_server_tpu_torch.ops.codec import (
    PACKED_KEY,
    FeatureSchema,
    FeatureSpec,
    mask_key_for,
)
from policy_server_tpu_torch.utils.interning import InternTable

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE_DIR / "csrc" / "fastenc.cpp"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "torch_kernels"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_KIND = {"value": 0, "present": 1, "pred": 2}
_DTYPE = {"id": 0, "f32": 1, "bool": 2, "i32": 3}


@dataclass
class EncoderLibrary:
    """The loaded encoder library and how it was built."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date library was reused


_library: EncoderLibrary | None = None
_library_lock = threading.Lock()


def library_path() -> Path:
    tag = sysconfig.get_config_var("SOABI") or (
        f"py{sys.version_info[0]}{sys.version_info[1]}"
    )
    return BUILD_DIR / f"torch_fastenc-{tag}.so"


def _compile(out: Path) -> float:
    """g++ the source into ``out`` (atomically, under a file lock that
    other processes building the same library wait on) → seconds spent in
    g++, 0.0 when another process had already built it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".torch_fastenc.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
            return 0.0
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=300
            )
        except FileNotFoundError as e:
            raise RuntimeError(
                "g++ not found: the native encoder is compiled from "
                f"{SOURCE} at first use"
            ) from e
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
        return seconds


def build_library(force: bool = False) -> EncoderLibrary:
    """Compile the encoder when its library is missing or older than the
    source, then load it and declare its entry points. Raises with g++'s
    output when the build fails."""
    global _library
    with _library_lock:
        if _library is not None and not force:
            return _library
        out = library_path()
        if force:
            out.unlink(missing_ok=True)
        seconds = 0.0
        if not (out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime):
            seconds = _compile(out)
        lib = ctypes.CDLL(str(out))
        lib.fastenc_create.restype = ctypes.c_void_p
        lib.fastenc_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.fastenc_destroy.restype = None
        lib.fastenc_destroy.argtypes = [ctypes.c_void_p]
        lib.fastenc_encode_batch.restype = ctypes.c_int64
        lib.fastenc_encode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_void_p,  # void** (an int64 address array)
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _library = EncoderLibrary(lib, out, seconds)
        return _library


# ---------------------------------------------------------------------------
# Schema description (mirrors the Python trie, _build_trie in codec.py)
# ---------------------------------------------------------------------------


def _describe_schema(
    schema: FeatureSchema,
) -> tuple[str, list[FeatureSpec], list[str]]:
    """→ (schema JSON for fastenc_create, array-id → spec order, pred keys).

    Array ids: each spec gets one buffer; value specs get a second (mask)
    buffer appended after all primary buffers."""
    specs = list(schema.specs.values())
    array_id = {spec.key: i for i, spec in enumerate(specs)}
    mask_id: dict[str, int] = {}
    next_id = len(specs)
    for spec in specs:
        if spec.has_mask:
            mask_id[spec.key] = next_id
            next_id += 1
    pred_keys: list[str] = []
    pred_id: dict[str, int] = {}
    for spec in specs:
        if spec.kind == "pred":
            pk = spec.pred_key()
            if pk not in pred_id:
                pred_id[pk] = len(pred_keys)
                pred_keys.append(pk)

    def elsize(spec: FeatureSpec) -> int:
        return (
            4
            if spec.kind == "value"
            and spec.dtype is not None
            and spec.dtype.value in ("id", "f32", "i32")
            else 1
        )

    # batch mode writes into column blocks of the single packed buffer
    # (codec.PackedLayout): every array's row stride is the packed row width
    stride = schema.row_stride
    arrays = [
        {"caps": list(s.caps), "elsize": elsize(s), "row_stride": stride}
        for s in specs
    ]
    arrays += [
        {"caps": list(s.caps), "elsize": 1, "row_stride": stride}
        for s in specs
        if s.has_mask
    ]

    # serialize the SAME trie the Python encoder walks (codec._build_trie):
    # one source of truth for traversal order, caps and overflow reporting
    def node_desc(node: Any) -> dict[str, Any]:
        return {
            "terminals": [
                {
                    "array": array_id[spec.key],
                    "kind": _KIND[spec.kind],
                    "dtype": _DTYPE[spec.dtype.value] if spec.dtype else 0,
                    "mask": mask_id.get(spec.key, -1),
                    "pred": (
                        pred_id[spec.pred_key()] if spec.kind == "pred" else -1
                    ),
                }
                for spec in node.terminals
            ],
            "children": {
                seg: node_desc(child) for seg, child in node.children.items()
            },
            "star": node_desc(node.star) if node.star is not None else None,
            "axis_cap": node.axis_cap,
            "overflow_id": array_id.get(node.repr_key, -1),
        }

    doc = {"arrays": arrays, "trie": node_desc(schema._trie())}
    return json.dumps(doc), specs, pred_keys


class NativeEncoder:
    """Per-schema native encoder (thread-safe for concurrent encodes: all
    mutable state is per call or per thread)."""

    ARENA_CAP = 1 << 20
    RECORDS_CAP = 1 << 16

    def __init__(self, schema: FeatureSchema):
        self._lib = build_library().lib
        desc, self._specs, self._pred_keys = _describe_schema(schema)
        raw = desc.encode()
        self._handle = self._lib.fastenc_create(raw, len(raw))
        if not self._handle:
            raise RuntimeError("fastenc_create failed (bad schema description)")
        # specs carrying a validity-mask buffer (value specs minus the
        # optimizer's mask-elided columns)
        self._value_specs = [s for s in self._specs if s.has_mask]
        self._schema = schema
        self._scratch = threading.local()
        # where each array sits in a packed row: a batch encode passes the
        # buffer's address plus these offsets, and the string scatter
        # writes by byte address (a ctypes cast per array per call, and a
        # numpy view per array, cost about as much as encoding one row)
        probe = schema.empty_batch_packed(1)
        views = schema.packed_views(probe)
        base = probe[PACKED_KEY].ctypes.data
        keys = [s.key for s in self._specs] + [
            mask_key_for(s.key) for s in self._value_specs
        ]
        self._offset_of = np.asarray(
            [views[k].ctypes.data - base for k in keys], np.int64
        )
        self._elems_of = np.asarray([views[k].shape[1] for k in keys], np.int64)
        self._itemsize_of = np.asarray([views[k].itemsize for k in keys], np.int64)
        self._stride = schema.row_stride

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.fastenc_destroy(handle)

    def encode_batch(
        self,
        payload_jsons: list[bytes],
        batch_size: int,
        table: InternTable,
    ) -> tuple[dict[str, np.ndarray], np.ndarray]:
        """Encode a whole batch in ONE native call, rows written directly
        into the packed batch buffer (``codec.PackedLayout``).

        → ({PACKED_KEY: the wide packed buffer}, per-row status: 0 ok, <0
        failed — failed rows are all-missing in the buffer and the caller
        re-routes them)."""
        n = len(payload_jsons)
        if n > batch_size:
            raise ValueError(f"{n} payloads for a batch of {batch_size}")
        out = self._schema.empty_batch_packed(batch_size)
        # the arrays' addresses, as one int64 array the call reads as void*
        buffers = self._offset_of + out[PACKED_KEY].ctypes.data
        jsons = (ctypes.c_char_p * n)(*payload_jsons)
        lens = (ctypes.c_int64 * n)(*[len(b) for b in payload_jsons])
        arena_cap = max(self.ARENA_CAP, sum(len(b) for b in payload_jsons))
        records_cap = self.RECORDS_CAP * max(1, (n + 63) // 64)
        # reusable per-thread scratch: allocating and zeroing tens of MB
        # per dispatch would dominate the path this encoder speeds up
        scratch = self._scratch
        arena = getattr(scratch, "arena", None)
        if arena is None or len(arena) < arena_cap:
            arena = scratch.arena = ctypes.create_string_buffer(arena_cap)
        records = getattr(scratch, "records", None)
        if records is None or len(records) < records_cap * 6:
            records = scratch.records = (ctypes.c_int32 * (records_cap * 6))()
        status = (ctypes.c_int32 * n)()
        n_rec = self._lib.fastenc_encode_batch(
            self._handle, jsons, lens, n,
            buffers.ctypes.data, arena, len(arena),
            ctypes.cast(records, ctypes.POINTER(ctypes.c_int32)),
            len(records) // 6,
            status,
        )
        if n_rec == -2:
            raise ValueError("fastenc: arena/records overflow")
        if n_rec:
            self._scatter_strings(
                np.frombuffer(
                    records, dtype=np.int32, count=int(n_rec) * 6
                ).reshape(-1, 6),
                arena, out[PACKED_KEY], table,
            )
        return out, np.frombuffer(status, dtype=np.int32).copy()

    def _scatter_strings(
        self,
        rec: np.ndarray,
        arena,
        buf: np.ndarray,
        table: InternTable,
    ) -> None:
        """Vectorized interning: the native encoder dedups strings at the
        batch level, so Python work is O(#unique strings) plus a handful of
        numpy scatters. New strings intern in (pred tag, arena offset)
        order — the order the JAX package's encoder uses, so intern ids,
        and with them packed bytes and row-tier keys, agree with it on
        identical inputs."""
        pred_keys = self._pred_keys
        used = int((rec[:, 4] + rec[:, 5]).max())
        raw_arena = ctypes.string_at(arena, used)
        # the arena offset identifies a string (the native encoder dedups
        # them); a (pred tag, offset) int64 key makes the unique pass a
        # plain integer sort
        tag = np.where(rec[:, 2] == 1, rec[:, 3].astype(np.int64) + 1, 0)
        keys = (tag << 40) | rec[:, 4].astype(np.int64)
        uniq, first, inverse = np.unique(keys, return_index=True, return_inverse=True)
        vals = np.empty(len(uniq), np.int32)
        for u, ri in enumerate(first):
            is_pred, pred_idx, soff, slen = rec[ri, 2:6]
            s = raw_arena[soff : soff + slen].decode("utf-8", "surrogatepass")
            vals[u] = (
                table.pred_value(pred_keys[pred_idx], s)
                if is_pred
                else table.intern(s)
            )
        rvals = vals[inverse]
        # a record's flat offset indexes its array's (batch, elems) view:
        # → the byte address in the packed buffer. Strings land in id
        # lanes (int32, little-endian) or predicate lanes (one byte).
        aids = rec[:, 0]
        row, col = np.divmod(rec[:, 1].astype(np.int64), self._elems_of[aids])
        size = self._itemsize_of[aids]
        addr = row * self._stride + self._offset_of[aids] + col * size
        flat = buf.reshape(-1)
        one = size == 1
        flat[addr[one]] = rvals[one].astype(np.uint8)
        if not one.all():
            four = ~one
            lanes = rvals[four].astype("<i4").view(np.uint8).reshape(-1, 4)
            flat[addr[four][:, None] + np.arange(4)] = lanes


def attach_native(schema: FeatureSchema) -> None:
    """Give a FeatureSchema its native encoder (the evaluation environment
    does this at build). Raises when the encoder cannot be built or
    loaded — g++'s output is in the message."""
    schema.native = NativeEncoder(schema)
