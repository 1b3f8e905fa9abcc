"""The port's HTTP server (standard library) on the CPU against the JAX
package's python frontend (``--host-fastpath-threshold 0``): /validate and
/validate_raw bodies byte-equal, the same 404 and 422 error bodies, and
the micro-batcher's batching and concurrency."""

from __future__ import annotations

import asyncio
import http.client
import json
import sys
import threading

import pytest

from policy_server_tpu.config.config import Config, TlsConfig
from policy_server_tpu.models.policy import parse_policy_entry
from policy_server_tpu.server import PolicyServer as JaxPolicyServer
from policy_server_tpu_torch.api.service import RequestOrigin, evaluate
from policy_server_tpu_torch.models.policy import (
    parse_policy_entry as t_parse_policy_entry,
)
from policy_server_tpu_torch.runtime.batcher import MicroBatcher
from policy_server_tpu_torch.server import PolicyServer

from conftest import build_admission_review_dict
from torch_port_support import firehose_docs, items_for, torch_env

SPECS = {
    "pod-privileged": {"module": "builtin://pod-privileged"},
    "priv-monitor": {"module": "builtin://pod-privileged",
                     "policyMode": "monitor"},
    "psp-capabilities": {
        "module": "builtin://psp-capabilities",
        "allowedToMutate": False,
        "settings": {
            "allowed_capabilities": ["NET_BIND_SERVICE", "CHOWN"],
            "required_drop_capabilities": ["NET_ADMIN"],
            "default_add_capabilities": ["CHOWN"],
        },
    },
    "trusted-repos": {
        "module": "builtin://trusted-repos",
        "settings": {"registries": {"allow": ["docker.io"]},
                     "tags": {"reject": ["latest"]}},
    },
    "raw-mutation": {"module": "builtin://raw-mutation",
                     "allowedToMutate": True},
    "group": {
        "expression": "unpriv() && (nonroot() || trusted())",
        "message": "group rejected the request",
        "policies": {
            "unpriv": {"module": "builtin://pod-privileged"},
            "nonroot": {"module": "builtin://run-as-non-root"},
            "trusted": {"module": "builtin://trusted-repos",
                        "settings": {"registries": {"allow": ["docker.io"]}}},
        },
    },
}


class JaxServerHandle:
    """The JAX package's PolicyServer inside a private event loop thread."""

    def __init__(self) -> None:
        config = Config(
            addr="127.0.0.1",
            port=0,
            readiness_probe_port=0,
            tls_config=TlsConfig(),
            policies={
                k: parse_policy_entry(k, v) for k, v in SPECS.items()
            },
            max_batch_size=8,
            batch_timeout_ms=1.0,
            host_fastpath_threshold=0,
        )
        self.server = JaxPolicyServer.new_from_config(config)
        self.loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        assert self._started.wait(timeout=120), "server failed to start"

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.server.start())
        self._started.set()
        self.loop.run_forever()

    @property
    def port(self) -> int:
        return self.server.api_port

    def stop(self) -> None:
        async def _shutdown():
            await self.server.stop()
            self.loop.stop()

        asyncio.run_coroutine_threadsafe(_shutdown(), self.loop)
        self.thread.join(timeout=30)


@pytest.fixture(scope="module")
def servers():
    jax_server = JaxServerHandle()
    port_server = PolicyServer(
        {k: t_parse_policy_entry(k, v) for k, v in SPECS.items()},
        port=0, device="cpu", max_batch_size=8,
    )
    port_server.start()
    yield jax_server, port_server
    port_server.stop()
    jax_server.stop()


def _post(port: int, path: str, body: bytes) -> tuple[int, bytes, str]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Content-Type")
    finally:
        conn.close()


def _reviews() -> list[tuple[str, bytes]]:
    docs = firehose_docs(12, seed=71, wide_every=4)
    ids = sorted(SPECS)
    out = [(ids[i % len(ids)], json.dumps(d).encode()) for i, d in enumerate(docs)]
    out.append(("group", json.dumps(build_admission_review_dict()).encode()))
    return out


def test_validate_bodies_are_byte_equal(servers):
    jax_server, port_server = servers
    rejected = 0
    for pid, body in _reviews():
        want = _post(jax_server.port, f"/validate/{pid}", body)
        got = _post(port_server.port, f"/validate/{pid}", body)
        assert got == want, (pid, got, want)
        rejected += b'"allowed": false' in got[1]
    assert rejected > 0


def test_validate_raw_bodies_are_byte_equal(servers):
    jax_server, port_server = servers
    body = json.dumps(
        {"request": {"uid": "raw-7", "operation": "create",
                     "resource": {"replicas": 3}}}
    ).encode()
    for pid in ("raw-mutation", "pod-privileged"):
        want = _post(jax_server.port, f"/validate_raw/{pid}", body)
        got = _post(port_server.port, f"/validate_raw/{pid}", body)
        assert got == want, (pid, got, want)


@pytest.mark.parametrize(
    "path,body",
    [
        ("/validate/no-such-policy", None),
        ("/validate/pod-privileged", b"{not json"),
        ("/validate/pod-privileged", b'{"request": 3}'),
        ("/validate_raw/pod-privileged", b"[1, 2"),
    ],
)
def test_error_bodies_are_byte_equal(servers, path, body):
    jax_server, port_server = servers
    if body is None:
        body = json.dumps(build_admission_review_dict()).encode()
    want = _post(jax_server.port, path, body)
    got = _post(port_server.port, path, body)
    assert got[0] == want[0] and got[1] == want[1], (got, want)
    assert got[0] in (404, 422)


def test_readiness(servers):
    _jax_server, port_server = servers
    conn = http.client.HTTPConnection("127.0.0.1", port_server.port, timeout=30)
    try:
        conn.request("GET", "/readiness")
        resp = conn.getresponse()
        assert (resp.status, resp.read()) == (200, b"ok")
    finally:
        conn.close()


def test_submit_many_batches_and_matches_evaluate():
    env = torch_env(SPECS)
    items = [
        (p, t) for p, _j, t in items_for(
            firehose_docs(40, seed=72), sorted(SPECS), seed=73
        )
    ]
    batcher = MicroBatcher(env, max_batch_size=16, batch_timeout_ms=50.0)
    try:
        futures = batcher.submit_many(items)
        got = [f.result(timeout=60).to_dict() for f in futures]
    finally:
        batcher.close()
    want = [
        evaluate(env, p, r, RequestOrigin.VALIDATE).to_dict() for p, r in items
    ]
    assert got == want
    assert batcher.batches >= 3 and batcher.batch_rows == len(items)
    assert max(1, batcher.batch_rows // batcher.batches) <= 16


def test_concurrent_submitters_all_answered():
    """More submitting threads than cores, with a short switch interval:
    every future resolves exactly once with its own request's answer."""
    env = torch_env(SPECS)
    triples = items_for(firehose_docs(48, seed=74), sorted(SPECS), seed=75)
    want = [
        evaluate(env, p, t, RequestOrigin.VALIDATE).to_dict()
        for p, _j, t in triples
    ]
    batcher = MicroBatcher(env, max_batch_size=8, batch_timeout_ms=2.0)
    got: list = [None] * len(triples)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(k: int) -> None:
            for i in range(k, len(triples), 12):
                p, _j, t = triples[i]
                got[i] = batcher.submit(p, t).result(timeout=60).to_dict()

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        batcher.close()
    assert got == want
