"""The port's two-tier verdict cache and in-batch row dedup
(``policy_server_tpu_torch/evaluation/verdict_cache.py`` and the
environment's native path) against the JAX package's, on the CPU: the
cases of ``tests/test_verdict_cache.py`` that involve no wasm, each run
through the port and through the JAX environment (``kernel="pallas"``,
every bucket armed, interpret mode) on identical inputs. Responses must be
equal, and where the JAX package's test asserts counters, the port's
``dedup_stats`` (and ``host_profile`` row counts) must move as the JAX
environment's do. Tolerance: exact equality."""

from __future__ import annotations

import copy

import numpy as np
import pytest

from policy_server_tpu.evaluation import verdict_cache as jax_vc
from policy_server_tpu.evaluation.environment import (
    DEFAULT_VERDICT_CACHE_SIZE as JAX_DEFAULT_VERDICT_CACHE_SIZE,
)
from policy_server_tpu.models import AdmissionReviewRequest as JReview
from policy_server_tpu.models import ValidateRequest as JRequest
from policy_server_tpu_torch.evaluation import verdict_cache as vc
from policy_server_tpu_torch.evaluation.environment import (
    DEFAULT_VERDICT_CACHE_SIZE,
)
from policy_server_tpu_torch.models import AdmissionReviewRequest as TReview
from policy_server_tpu_torch.models import ValidateRequest as TRequest

from conftest import build_admission_review_dict
from torch_port_support import jax_env, response_dicts, torch_env

POLICIES = {
    "priv": {"module": "builtin://pod-privileged"},
    "ns": {
        "module": "builtin://namespace-validate",
        "settings": {"denied_namespaces": ["blocked"]},
    },
    "grp": {
        "expression": "a() && b()",
        "message": "group denied",
        "policies": {
            "a": {"module": "builtin://always-happy"},
            "b": {"module": "builtin://pod-privileged"},
        },
    },
}


def pallas_env(specs: dict, **kw):
    env = jax_env(specs, kernel="pallas", **kw)
    env._pallas_armed.update(range(len(env.schemas)))
    env._pallas_interpret = True
    return env


def pod_doc(namespace: str, privileged: bool, uid: str) -> dict:
    doc = build_admission_review_dict()
    doc["request"]["uid"] = uid
    doc["request"]["namespace"] = namespace
    doc["request"]["object"] = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": "p", "namespace": namespace},
        "spec": {
            "containers": [
                {"name": "c", "image": "nginx",
                 "securityContext": {"privileged": privileged}}
            ]
        },
    }
    return doc


def pair(doc: dict) -> tuple[JRequest, TRequest]:
    """One review as a request of each package."""
    return (
        JRequest.from_admission(JReview.from_dict(copy.deepcopy(doc)).request),
        TRequest.from_admission(TReview.from_dict(copy.deepcopy(doc)).request),
    )


def dup_heavy_batch(n: int, uid_prefix: str = "uid") -> list[tuple]:
    """n rows over 6 distinct (policy, document) combinations, every row
    with a FRESH uid — the admission stream's shape (one template
    re-admitted; the API server mints a new uid each time). → (policy id,
    JAX request, port request) triples."""
    out = []
    for k in range(n):
        pid = ["priv", "ns", "grp"][k % 3]
        ns = "blocked" if k % 6 >= 3 else "fine"
        out.append((pid, *pair(pod_doc(ns, k % 2 == 0, f"{uid_prefix}-{k}"))))
    return out


def run_both(envs, triples, **kw) -> tuple[list, list]:
    """The same items through the JAX and the port environment →
    (JAX response dicts, port response dicts)."""
    jenv, tenv = envs
    want = response_dicts(jenv.validate_batch([(p, j) for p, j, _t in triples], **kw))
    got = response_dicts(tenv.validate_batch([(p, t) for p, _j, t in triples], **kw))
    return want, got


@pytest.fixture(scope="module")
def envs():
    return pallas_env(POLICIES), torch_env(POLICIES)


@pytest.fixture
def fresh(envs):
    for env in envs:
        env.reset_verdict_cache()
    return envs


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if "capacity" not in k}


def test_dedup_is_bit_exact_and_keeps_uids(fresh):
    jenv, tenv = fresh
    off = torch_env(POLICIES, verdict_cache_size=0)
    triples = dup_heavy_batch(96)
    j0, t0 = jenv.dedup_stats, tenv.dedup_stats
    want, got = run_both(fresh, triples)
    assert got == want
    assert response_dicts(off.validate_batch([(p, t) for p, _j, t in triples])) == got
    for (_p, _j, t), resp in zip(triples, got):
        assert resp["uid"] == t.uid()
    # the batch REALLY deduplicated (6 unique rows in 96), as much as the
    # JAX environment's did
    d = delta(tenv.dedup_stats, t0)
    assert d["batch_dup_hits"] > 0
    assert d == delta(jenv.dedup_stats, j0)
    assert off.dedup_stats["cache_capacity"] == 0


def test_cross_batch_cache_hits_despite_fresh_uids(fresh):
    jenv, tenv = fresh
    base = run_both(fresh, dup_heavy_batch(24))
    j0, t0 = jenv.dedup_stats, tenv.dedup_stats
    again = run_both(fresh, dup_heavy_batch(24))  # same docs and uids
    d = delta(tenv.dedup_stats, t0)
    # exact replays land in the BLOB tier (pre-encode)
    assert d["blob_cache_hits"] > 0
    assert d == delta(jenv.dedup_stats, j0)
    assert again[1] == base[1] == base[0] == again[0]
    # fresh uids: the row tier sees through them
    j1, t1 = jenv.dedup_stats, tenv.dedup_stats
    want, got = run_both(fresh, dup_heavy_batch(24, uid_prefix="new"))
    assert got == want
    d = delta(tenv.dedup_stats, t1)
    assert d["cache_hits"] > 0
    assert d == delta(jenv.dedup_stats, j1)


def test_blob_tier_skips_encode_row_tier_catches_uid_variants(fresh):
    """An EXACT replay (same blob) is answered pre-encode by the blob tier;
    a uid-varying duplicate has a different blob but the identical packed
    row, so only the row tier sees through it — without a dispatch."""
    jenv, tenv = fresh
    run_both(fresh, [("priv", *pair(pod_doc("fine", True, "seed")))])
    jp0, tp0 = jenv.host_profile, tenv.host_profile
    js0, ts0 = jenv.dedup_stats, tenv.dedup_stats

    # exact replay: a blob-tier hit, the encoder untouched
    want, got = run_both(fresh, [("priv", *pair(pod_doc("fine", True, "seed")))])
    assert got == want
    jp1, tp1 = jenv.host_profile, tenv.host_profile
    js1, ts1 = jenv.dedup_stats, tenv.dedup_stats
    assert ts1["blob_cache_hits"] == ts0["blob_cache_hits"] + 1
    assert tp1["encode_rows"] == tp0["encode_rows"]
    assert delta(ts1, ts0) == delta(js1, js0)

    # fresh uid: the blob tier misses, the row tier hits — encoded, not
    # dispatched
    want, got = run_both(fresh, [("priv", *pair(pod_doc("fine", True, "other")))])
    assert got == want and got[0]["uid"] == "other"
    tp2 = tenv.host_profile
    ts2 = tenv.dedup_stats
    assert ts2["cache_hits"] == ts1["cache_hits"] + 1
    assert tp2["encode_rows"] == tp1["encode_rows"] + 1
    assert tp2["dispatched_rows"] == tp1["dispatched_rows"]
    assert delta(ts2, ts1) == delta(jenv.dedup_stats, js1)
    jp2 = jenv.host_profile
    for key in ("encode_rows", "dispatched_rows"):
        assert tp2[key] - tp0[key] == jp2[key] - jp0[key], key


def test_host_fastpath_shares_the_cache(fresh):
    jenv, tenv = fresh
    direct = run_both(
        fresh, [("priv", *pair(pod_doc("fine", True, "fp-1")))], prefer_host=True
    )
    assert direct[1] == direct[0]
    h0 = tenv.dedup_stats["cache_hits"]
    hit = run_both(
        fresh, [("priv", *pair(pod_doc("fine", True, "fp-2")))], prefer_host=True
    )
    assert tenv.dedup_stats["cache_hits"] > h0
    assert hit[1] == hit[0]
    assert hit[1][0]["uid"] == "fp-2"
    assert hit[1][0]["allowed"] == direct[1][0]["allowed"]
    # the device path answers from a fast-path entry
    t_disp = tenv.host_profile["dispatched_rows"]
    dev = run_both(fresh, [("priv", *pair(pod_doc("fine", True, "fp-3")))])
    assert dev[1] == dev[0] and dev[1][0]["uid"] == "fp-3"
    assert tenv.host_profile["dispatched_rows"] == t_disp


def test_mutating_policy_duplicates_each_get_their_patch():
    specs = {"mut": {"module": "builtin://raw-mutation", "allowedToMutate": True}}
    envs = (pallas_env(specs), torch_env(specs))
    triples = []
    for k in range(8):
        raw = {"uid": f"m-{k}", "x": 1}
        triples.append(
            ("mut", JRequest.from_raw(dict(raw)), TRequest.from_raw(dict(raw)))
        )
    want, got = run_both(envs, triples)
    assert got == want
    for k, resp in enumerate(got):
        assert resp["uid"] == f"m-{k}"
        assert resp["patch"]  # every duplicate materialized its own
    assert len({r["patch"] for r in got}) == 1  # identical docs, patches


@pytest.mark.parametrize("module", [vc, jax_vc], ids=["port", "jax"])
def test_lru_eviction_bounds_bytes(module):
    """Capacity is BYTES: inserting past the budget evicts oldest-first;
    the port's cache evicts exactly as the JAX package's."""
    one = module.entry_cost(("p", bytes([0])), {"v": 0})
    assert one == jax_vc.entry_cost(("p", bytes([0])), {"v": 0})
    c = module.VerdictCache(4 * one)
    for k in range(10):
        c.put(("p", bytes([k])), {"v": k})
    assert len(c) == 4
    assert c.bytes_used <= c.capacity_bytes
    assert c.get(("p", bytes([9])))["v"] == 9
    assert c.get(("p", bytes([0]))) is None


def test_eviction_sequence_matches_jax():
    rng = np.random.default_rng(91)
    caches = [m.VerdictCache(5_000) for m in (vc, jax_vc)]
    for _ in range(300):
        k = int(rng.integers(0, 40))
        row = {"v": k, "a": np.arange(int(rng.integers(1, 64)), dtype=np.int32)}
        single = rng.random() < 0.5
        for c in caches:
            if single:
                c.put(("p", bytes([k])), row)
            else:
                c.put_many([(("p", bytes([k])), row), (("g", bytes([k])), row)])
            c.get(("p", bytes([int(k * 7 % 40)])))
    assert caches[0].stats() == caches[1].stats()
    assert list(caches[0]._data) == list(caches[1]._data)


def test_get_many_put_many_batched_lock_semantics():
    c = vc.VerdictCache(1 << 20)
    c.put_many([(("p", b"a"), {"v": 1}), (("p", b"b"), {"v": 2})])
    out = c.get_many([("p", b"a"), None, ("p", b"missing"), ("p", b"b")])
    assert out[0]["v"] == 1 and out[3]["v"] == 2
    assert out[1] is None and out[2] is None
    # None keys (uncacheable rows) are alignment placeholders, not misses
    assert c.hits == 2 and c.misses == 1
    c.adjust_counts(hits=3, misses=1)
    assert (c.hits, c.misses) == (5, 2)


def test_default_cache_size_matches_jax():
    assert DEFAULT_VERDICT_CACHE_SIZE == JAX_DEFAULT_VERDICT_CACHE_SIZE
    # both tiers hold a 12,500-template working set at ~6 KB an entry
    assert DEFAULT_VERDICT_CACHE_SIZE >= 2 * 12_500 * 6_000


def test_extract_row_detaches_from_batch():
    outputs = {
        "a": np.arange(8, dtype=np.int32),
        "b": np.ones((8, 3), dtype=np.bool_),
        "s": [None] * 8,
    }
    row = vc.extract_row(outputs, 2)
    assert row["a"] == 2 and isinstance(row["a"], int)
    outputs["b"][2, :] = False
    assert row["b"].all()  # copied, not a view
    assert row["s"] is None
    jrow = jax_vc.extract_row(
        {"a": np.arange(8, dtype=np.int32),
         "b": np.ones((8, 3), dtype=np.bool_),
         "s": [None] * 8},
        2,
    )
    assert row.keys() == jrow.keys() and row["a"] == jrow["a"]
    np.testing.assert_array_equal(row["b"], jrow["b"])
