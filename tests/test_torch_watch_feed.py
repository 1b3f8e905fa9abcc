"""The audit watch feed in the PyTorch port (``audit/watch_feed.py`` over
``context/service.run_watch_loop``) against the JAX package: every case of
``tests/test_watch_feed.py`` but the state-store spill (which waits for
the port's state store) drives both packages' feeds with synthetic
clusters made from the same seed (``tools/soak/cluster.SyntheticCluster``)
and compares what the stores converge to: their keys, their sizes, the
rows' payloads and the feeds' counters. Then the port's own: the feed
through ``--audit-watch`` on a server against a local Kubernetes API
server, with the watch families on ``/metrics``."""

from __future__ import annotations

import json
import time

import pytest

import policy_server_tpu.audit as j_audit
import policy_server_tpu.audit.snapshot as j_snapshot
import policy_server_tpu_torch.audit as p_audit
import policy_server_tpu_torch.audit.snapshot as p_snapshot
from tools.soak.cluster import SyntheticCluster

PACKAGES = ((j_audit, j_snapshot), (p_audit, p_snapshot))


def wait_until(cond, timeout=10.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def converged(cluster, store) -> bool:
    return cluster.object_count() == len(store)


def keys_of(store) -> list:
    return sorted(k for k, _r in store.collect(dirty_only=False))


def settled_keys(s) -> list:
    """The store's keys once they are the cluster's objects' keys (equal
    counts alone can hide a pending ADDED beside a pending DELETED)."""
    def want() -> list:
        with s.cluster._lock:
            objs = [o for kind in s.cluster._objects.values() for o in kind.values()]
        return sorted(
            s.snapshot.resource_key(s.snapshot.synthesize_review(o, "UPDATE"))
            for o in objs
        )

    assert wait_until(lambda: keys_of(s.store) == want(), timeout=30)
    return keys_of(s.store)


class Setup:
    """One package's cluster, store and feeds (stopped by ``close``)."""

    def __init__(self, audit, snapshot, seed=7, **store_kw):
        self.audit, self.snapshot = audit, snapshot
        self.cluster = SyntheticCluster(seed=seed)
        self.store = audit.SnapshotStore(**store_kw)
        self.feeds = []

    def make_feed(self, **kw):
        kw.setdefault("refresh_seconds", 1.0)
        feed = self.audit.WatchFeed(self.cluster, self.cluster.kinds, self.store, **kw)
        self.feeds.append(feed)
        return feed

    def close(self):
        for f in self.feeds:
            f.stop()
        self.cluster.stop()


def both(case, **setup_kw):
    """``case(setup)`` for the JAX package, then the port, each over its
    own cluster made from the same seed: equal observations."""
    out = []
    for audit, snapshot in PACKAGES:
        s = Setup(audit, snapshot, **setup_kw)
        try:
            out.append(case(s))
        finally:
            s.close()
    assert out[0] == out[1], out
    return out[1]


def test_boot_list_and_added_modified_supersede():
    def case(s):
        s.cluster.populate(200)
        s.make_feed().start()
        assert wait_until(lambda: len(s.store) == 200)
        pod = s.cluster.kinds[0]
        name = s.cluster.add_object(pod, namespace="ns-x")
        assert wait_until(lambda: converged(s.cluster, s.store))
        recorded = s.store.stats()["recorded"]
        before_len = len(s.store)
        assert s.cluster.modify_object(pod, name)
        assert wait_until(
            lambda: s.store.stats()["superseded"] >= 1
            and s.store.stats()["recorded"] > recorded
        )
        key = s.snapshot.resource_key(s.snapshot.synthesize_review(
            {"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": name, "namespace": "ns-x",
                          "uid": f"uid-{name}"}},
            "UPDATE",
        ))
        rows = dict(s.store.collect(dirty_only=False))
        newest = b'"generation":2' in rows[key].payload_json().replace(b" ", b"")
        return (len(s.store) == before_len, newest, settled_keys(s),
                rows[key].payload_json())

    same_len, newest, _keys, _payload = both(case)
    assert same_len and newest


def test_deleted_evicts_and_prunes_reports():
    def case(s):
        s.cluster.populate(50)
        s.make_feed().start()
        assert wait_until(lambda: len(s.store) == 50)
        reports = s.audit.PolicyReportStore()
        key, request = s.store.collect(dirty_only=False)[0]
        _g, _v, kind, _ns, name = key.split("/", 4)
        resource = next(r for r in s.cluster.kinds if r.kind == kind)
        reports.put([reports.row_from_result(
            key, "policy-a", request, RuntimeError("placeholder"), epoch=0
        )])
        resident = reports.stats()["resident"]
        assert s.cluster.delete_object(resource, name)
        assert wait_until(lambda: converged(s.cluster, s.store))
        deletions = s.store.take_deletions()
        reports.drop_resources(deletions)
        return (resident, len(s.store), key in deletions,
                reports.stats()["resident"], settled_keys(s))

    assert both(case)[:4] == (1, 49, True, 0)


def test_stream_close_resumes_from_resource_version():
    def case(s):
        s.cluster.populate(100)
        feed = s.make_feed().start()
        assert wait_until(lambda: len(s.store) == 100)
        streams_before = feed.stats()["streams_opened"]
        resyncs_before = feed.stats()["resyncs"]
        s.cluster.close_streams()
        assert wait_until(
            lambda: feed.stats()["streams_opened"]
            >= streams_before + len(s.cluster.kinds)
        )
        s.cluster.churn(60)
        assert wait_until(lambda: converged(s.cluster, s.store))
        return (feed.stats()["resyncs"] - resyncs_before,
                feed.stats()["events_applied"] > 0, settled_keys(s))

    resyncs, applied, _keys = both(case)
    assert resyncs == 0 and applied


def test_compacted_history_forces_counted_resync_with_delete_repair():
    def case(s):
        s.cluster.event_log_bound = 20
        s.cluster.populate(60)
        feed = s.make_feed().start()
        assert wait_until(lambda: len(s.store) == 60)
        s.cluster.close_streams()
        s.store.take_deletions()
        s.cluster.churn(400)
        assert wait_until(lambda: converged(s.cluster, s.store), timeout=20)
        stats = feed.stats()
        return (stats["resyncs"] >= 1,
                stats["resync_reasons"].get("expired", 0) >= 1,
                bool(s.store.take_deletions()), settled_keys(s))

    assert both(case)[:3] == (True, True, True)


def test_resync_repair_keeps_recreated_object_with_new_uid():
    def pod(uid, name="web-0"):
        return {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"uid": uid, "name": name, "namespace": "ns"},
            "spec": {"containers": []},
        }

    def case(s):
        feed = s.make_feed()
        key = "v1/Pod"
        feed._apply_batch([
            ("event", key, "ADDED", pod("uid-old"), None),
            ("event", key, "ADDED", pod("uid-gone", name="web-1"), None),
        ])
        first = len(s.store)
        s.store.take_deletions()
        feed._apply_batch([("replace", key, (pod("uid-new"),), None)])
        pruned = sorted(s.store.take_deletions())
        return (first, len(s.store), feed.stats()["deletes_synthesized"],
                pruned, keys_of(s.store))

    first, after, synthesized, pruned, _keys = both(case)
    assert (first, after, synthesized) == (2, 1, 1)
    assert all("web-1" in k for k in pruned)


def test_bounded_queue_overflow_drops_loudly_and_resyncs():
    def case(s):
        s.cluster.populate(30)
        feed = s.make_feed(max_queue_events=4).start()
        assert wait_until(lambda: len(s.store) == 30)
        s.cluster.churn(500)
        assert wait_until(lambda: converged(s.cluster, s.store), timeout=20)
        stats = feed.stats()
        if stats["events_dropped"]:
            assert stats["resyncs"] >= 1
        assert stats["events_applied"] + stats["replaces"] > 0
        return settled_keys(s)

    both(case)


def test_interval_resync_bounds_staleness():
    def case(s):
        s.cluster.populate(40)
        feed = s.make_feed(refresh_seconds=0.5, resync_multiplier=1).start()
        assert wait_until(lambda: len(s.store) == 40)
        time.sleep(1.0)
        s.cluster.close_streams()
        assert wait_until(
            lambda: feed.stats()["resync_reasons"].get("interval", 0) >= 1,
            timeout=15,
        )
        return converged(s.cluster, s.store), settled_keys(s)

    assert both(case)[0]


@pytest.mark.parametrize("spec,ok", [
    ("v1/Pod , apps/v1/Deployment", True), ("Pod", False), ("v1/", False),
])
def test_parse_watch_resources_rejects_malformed(spec, ok):
    def parse(audit):
        try:
            return [(r.api_version, r.kind) for r in audit.parse_watch_resources(spec)]
        except ValueError as e:
            return str(e)

    got = [parse(audit) for audit, _s in PACKAGES]
    assert got[0] == got[1]
    assert isinstance(got[1], list) == ok
    if ok:
        assert len(got[1]) == 2


def test_churning_cluster_bounded_bytes():
    """The JAX suite's acceptance-scale case (100,000 objects, marked slow
    there) at 5,000 objects, so it runs in the default suite: the store
    stays byte-bounded, churn with deletes converges and DELETE pruning
    queues, the same in both packages."""
    def case(s):
        feed = s.make_feed(refresh_seconds=5.0)
        s.cluster.populate(5_000)
        feed.start()
        assert wait_until(lambda: len(s.store) == 5_000, timeout=120)
        stats = s.store.stats()
        bounded = 0 < stats["bytes"] <= 256 * 1024 * 1024
        s.store.take_deletions()
        s.cluster.churn(2_000)
        assert wait_until(
            lambda: s.cluster.object_count() == len(s.store), timeout=60
        )
        return (bounded, len(s.store.take_deletions()) > 0,
                feed.stats()["events_applied"] >= 1_000, settled_keys(s))

    assert both(case, seed=13, max_bytes=256 * 1024 * 1024)[:3] == (
        True, True, True
    )


# -- --audit-watch on a server ------------------------------------------------


def test_audit_watch_server_feeds_the_snapshot_and_the_watch_families(
    monkeypatch, tmp_path,
):
    """``--audit-watch`` on the port's server against a local Kubernetes
    API server: the LIST seeds the snapshot, ADDED/MODIFIED/DELETED events
    reach it, a 410 forces one counted resync, the report rows equal a
    JAX audit oracle's over the same inventory, and the watch families on
    /metrics read the feed's counts."""
    import policy_server_tpu_torch.context.service as p_service
    from policy_server_tpu_torch import __main__ as cli
    import torch_fetch_fixtures as fx

    api = fx.KubeApi(tmp_path / "kube")
    pods = fx.list_path("v1", "Pod")

    def pod(i, privileged=False):
        return {"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": f"p{i}", "namespace": "ns",
                             "uid": f"u{i}"},
                "spec": {"containers": [{
                    "name": "c", "image": "nginx:1.25",
                    "securityContext": {"privileged": privileged}}]}}

    api.register(pods, [pod(i, i % 3 == 0) for i in range(40)])
    sa = api.write_service_account(tmp_path / "sa")
    monkeypatch.setattr(p_service, "SERVICE_ACCOUNT_DIR", sa)
    monkeypatch.setattr(p_service, "KUBE_API_SERVER", api.url)
    policies = tmp_path / "policies.json"
    policies.write_text(json.dumps({"priv": {"module": "builtin://pod-privileged"}}))
    args = cli.build_cli().parse_args([
        "--policies", str(policies), "--port", "0", "--readiness-probe-port", "0",
        "--device", "cpu", "--no-warmup", "--audit-mode", "interval",
        "--audit-interval-seconds", "0.2", "--audit-watch",
        "--audit-watch-resources", "v1/Pod", "--context-refresh-seconds", "1",
    ])
    server = cli.server_from_args(args)
    server.start()
    try:
        feed = server.state.audit_watch
        assert feed is not None and server.state.audit.watch_feed is feed
        snap = server.state.audit.snapshot
        assert wait_until(lambda: len(snap) == 40)
        api.add(pods, pod(100, True))
        api.modify(pods, pod(1, True))
        api.delete(pods, pod(2))
        assert wait_until(lambda: feed.stats()["events_applied"] == 3)
        api.expire(pods)
        assert wait_until(lambda: feed.stats()["resyncs"] == 1, timeout=15)
        assert len(snap) == 40
        # the report rows settle to a JAX oracle's verdicts on the same
        # inventory (the API server's objects after the events)
        from policy_server_tpu.audit.snapshot import synthesize_review
        from torch_port_support import jax_env

        jenv = jax_env({"priv": {"module": "builtin://pod-privileged"}},
                       backend="oracle")
        want = {
            obj["metadata"]["name"]: jenv.validate(
                "priv", synthesize_review(obj, "UPDATE")
            ).allowed
            for obj in api.kinds[pods].values()
        }

        def reported():
            return {
                r["name"]: r["allowed"]
                for r in server.state.audit.report_payload()["reports"]
                if not r["stale"]
            }

        assert wait_until(lambda: reported() == want, timeout=30), (
            reported(), want
        )
        assert sum(1 for v in want.values() if not v) == 16
        stats = server.state.audit.stats()
        assert stats["watch_events_applied"] == feed.stats()["events_applied"] == 3
        assert stats["watch_resyncs"] == 1
        import urllib.request

        text = urllib.request.urlopen(
            f"http://127.0.0.1:{server.readiness_port}/metrics", timeout=10
        ).read().decode()
        assert "policy_server_audit_watch_events_applied_total 3" in text
        assert "policy_server_audit_watch_resyncs_total 1" in text
        assert "policy_server_audit_watch_events_dropped_total 0" in text
    finally:
        server.stop()
        api.stop()
    assert feed.stats()["queue_depth"] == 0
