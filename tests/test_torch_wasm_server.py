"""Host-executed policies over HTTP: the port's native and stdlib servers,
built with ``module_resolver=``, against the JAX package's native server
with the same wasm modules (status, headers but Date, body); the wasm
wall-clock budget from ``--policy-timeout``; ``--long-version``; and a
non-builtin module URL on the command line."""

from __future__ import annotations

import asyncio
import importlib
import json
import subprocess
import sys
import threading
import time

import pytest

from policy_server_tpu.config.cli import long_version as jax_long_version
from policy_server_tpu.config.config import Config, TlsConfig
from policy_server_tpu.models.policy import parse_policy_entry
from policy_server_tpu.runtime import native_frontend as jnf
from policy_server_tpu.server import PolicyServer as JaxPolicyServer
from policy_server_tpu_torch import __main__ as cli
from policy_server_tpu_torch.evaluation.errors import BootstrapFailure
from policy_server_tpu_torch.models.policy import (
    parse_policy_entry as t_parse_policy_entry,
)
from policy_server_tpu_torch.policies import resolve_builtin
from policy_server_tpu_torch.runtime import native_frontend as nf
from policy_server_tpu_torch.server import PolicyServer

from test_torch_native_frontend import exchange, post_bytes
from test_torch_wasm_group_members import (
    JAX,
    PORT,
    SPECS,
    pod_docs,
    resolver_for,
)
from torch_port_support import firehose_docs
import torch_wasm_fixtures as fixtures


class JaxServerHandle:
    """The JAX package's PolicyServer with a module resolver, inside a
    private event-loop thread."""

    def __init__(self, specs: dict, resolver, **overrides) -> None:
        config = Config(
            addr="127.0.0.1", port=0, readiness_probe_port=0,
            tls_config=TlsConfig(),
            policies={k: parse_policy_entry(k, v) for k, v in specs.items()},
            **dict(dict(max_batch_size=8, batch_timeout_ms=1.0), **overrides),
        )
        self.server = JaxPolicyServer.new_from_config(config, module_resolver=resolver)
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run() -> None:
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.server.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(timeout=120), "JAX server failed to start"

    @property
    def port(self) -> int:
        return self.server.api_port

    def stop(self) -> None:
        async def shutdown():
            await self.server.stop()
            self.loop.stop()

        asyncio.run_coroutine_threadsafe(shutdown(), self.loop)
        self.thread.join(timeout=30)


def port_server(specs: dict, resolver, **kw) -> PolicyServer:
    server = PolicyServer(
        {k: t_parse_policy_entry(k, v) for k, v in specs.items()},
        **dict(dict(port=0, readiness_probe_port=0, device="cpu",
                    max_batch_size=8, module_resolver=resolver), **kw),
    )
    server.start()
    return server


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """(JAX native, port native, port stdlib) over the mixed wasm set."""
    tmp = tmp_path_factory.mktemp("wasm-server")
    mp = pytest.MonkeyPatch()
    mp.setattr(nf, "server_header", jnf.server_header)
    jax_server = JaxServerHandle(SPECS, resolver_for(JAX, tmp), frontend="native")
    servers = []
    try:
        servers.append(port_server(SPECS, resolver_for(PORT, tmp), frontend="python"))
        servers.append(port_server(SPECS, resolver_for(PORT, tmp), frontend="native"))
        yield jax_server, servers[1], servers[0]
    finally:
        for s in servers:
            s.stop()
        jax_server.stop()
        mp.undo()


def bodies() -> list[tuple[str, bytes]]:
    docs = pod_docs() + firehose_docs(8, seed=97)
    return [
        (pid, json.dumps(doc).encode())
        for pid in sorted(SPECS)
        for doc in docs
    ]


@pytest.mark.parametrize("route", ["validate", "validate_raw"])
def test_wasm_set_over_http_matches_the_jax_server(trio, route):
    jax_server, port_native, port_stdlib = trio
    for pid, body in bodies():
        if route == "validate_raw":
            body = json.dumps(json.loads(body)["request"]).encode()
        payload = post_bytes(f"/{route}/{pid}", body)
        want = exchange(jax_server.port, payload)
        got = exchange(port_native.port, payload)
        assert got == want, (pid, want, got)
        status, headers, rbody = exchange(port_stdlib.port, payload)[0]
        assert (status, headers.get("content-type"), rbody) == (
            want[0][0], want[0][1].get("content-type"), want[0][2]
        ), pid


def mod(side: str, name: str):
    return importlib.import_module(f"{side}.{name}")


class _DeadlineSide:
    """One package's server over ``spin`` and ``priv`` at
    ``policy_timeout=0.2``, with a count of its batcher's watchdog answers
    (the JAX batcher keeps none, so its ``_reject_deadline`` is wrapped on
    the instance)."""

    def __init__(self, side: str, frontend: str) -> None:
        self.spin = mod(side, "evaluation.wasm_policy").WasmPolicyModule(
            mod(side, "wasm.wat").assemble(fixtures.SPIN_ON_VALIDATE_WAPC),
            name="spin", digest="x", fuel=None,
        )
        builtin = mod(side, "policies").resolve_builtin

        def resolver(url: str):
            return self.spin if url.endswith("spin.wasm") else builtin(url)

        specs = {"spin": {"module": "file:///spin.wasm"},
                 "priv": {"module": "builtin://pod-privileged"}}
        if side == JAX:
            self.handle = JaxServerHandle(
                specs, resolver, frontend=frontend, policy_timeout_seconds=0.2,
            )
            self.port = self.handle.port
            batcher = self.handle.server.batcher
            self.env = self.handle.server.environment
            self._watchdog = 0
            reject = batcher._reject_deadline

            def counted(*args, **kwargs):
                self._watchdog += 1
                return reject(*args, **kwargs)

            batcher._reject_deadline = counted
        else:
            self.handle = port_server(specs, resolver, frontend=frontend,
                                      policy_timeout=0.2)
            self.port = self.handle.port
            self.env = self.handle.env
        self.side = side

    def watchdog_answers(self) -> int:
        if self.side == JAX:
            return self._watchdog
        return self.handle.batcher.deadline_rejections

    def answer(self, pid: str, k: int) -> dict:
        doc = pod_docs()[k % 4]
        body = exchange(
            self.port, post_bytes(f"/validate/{pid}", json.dumps(doc).encode())
        )[0][2]
        return json.loads(body)["response"]

    def stop(self) -> None:
        self.handle.stop()


def deadline_run(side: str, frontend: str) -> dict:
    """What one package's server answers: (a) four spinning and four
    ``priv`` rows at once, the guest's budget equal to the watchdog's;
    (b) ``priv`` rows one at a time; (c) spinning rows one at a time with
    the guest's budget cut to 0.05 s, below the watchdog's 0.2 s, so the
    guest's own in-band cut answers and the watchdog answers none."""
    srv = _DeadlineSide(side, frontend)
    try:
        out = {"budget": srv.spin.wall_clock_budget, "concurrent": {}}

        def hit(pid, k):
            out["concurrent"][(pid, k)] = srv.answer(pid, k)

        threads = [threading.Thread(target=hit, args=(pid, k))
                   for k in range(4) for pid in ("spin", "priv")]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        out["concurrent_wall"] = time.perf_counter() - t0
        out["alone"] = [srv.answer("priv", k) for k in range(4)]
        # the abandoned spinning evaluations end within their budget each
        time.sleep(4 * 0.2)
        srv.spin.wall_clock_budget = 0.05
        before = srv.watchdog_answers()
        out["in_band"] = [srv.answer("spin", k) for k in range(4)]
        out["in_band_watchdog"] = srv.watchdog_answers() - before
        out["trips"] = srv.env.breaker_stats["trips"]
        return out
    finally:
        srv.stop()


@pytest.mark.parametrize("frontend", ["python", "native"])
def test_policy_timeout_is_the_wasm_budget(frontend):
    """A spinning guest under ``policy_timeout=0.2``, on the port's server
    and on the JAX package's with the same frontend. The server gives the
    guest the timeout as its wall-clock budget. At equal budgets the
    batch watchdog, whose deadline runs from admission, answers a spinning
    row first, with the same "execution deadline exceeded" 500 body; a
    ``priv`` row batched with a spinning one shares its batch's deadline.
    With the guest's budget below the watchdog's, the guest's own cut
    answers in-band and the watchdog answers nothing. ``priv`` rows sent
    alone answer normally; no breaker trip. Both packages answer alike."""
    deadline = {"message": "execution deadline exceeded", "code": 500}
    runs = {side: deadline_run(side, frontend) for side in (JAX, PORT)}
    for side, run in runs.items():
        assert run["budget"] == 0.2, side
        assert run["concurrent_wall"] < 10, side
        assert run["trips"] == 0, side
        for (pid, k), resp in run["concurrent"].items():
            if pid == "spin":
                assert resp["allowed"] is False and resp["status"] == deadline
            else:
                assert resp.get("status") == deadline or resp == run["alone"][k], (
                    side, resp,
                )
        for k, resp in enumerate(run["alone"]):
            assert resp["allowed"] is (k % 2 == 0), (side, resp)
        for resp in run["in_band"]:
            assert resp["allowed"] is False and resp["status"] == deadline, side
        assert run["in_band_watchdog"] == 0, side
    jax_run, port_run = runs[JAX], runs[PORT]
    assert port_run["alone"] == jax_run["alone"]
    assert port_run["in_band"] == jax_run["in_band"]
    assert {k: v for k, v in port_run["concurrent"].items() if k[0] == "spin"} == {
        k: v for k, v in jax_run["concurrent"].items() if k[0] == "spin"
    }


def test_long_version_matches_the_jax_cli():
    out = subprocess.run(
        [sys.executable, "-m", "policy_server_tpu_torch", "--long-version"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = out.stdout.rstrip("\n").split("\n")
    want = jax_long_version().split("\n")
    assert got[0].startswith("policy_server_tpu_torch ")
    assert got[1:] == want[1:]
    assert "  - units.parse_bytes" in got and "predicate IR ops:" in got


def test_non_builtin_module_on_the_command_line(tmp_path):
    """A module that is not a builtin goes through the fetch path: one
    that cannot be fetched fails the boot with the downloader's error, and
    under --continue-on-errors answers that error as its init error while
    the rest serve."""
    from policy_server_tpu_torch.fetch import FetchError

    missing = tmp_path / "missing.tpp.json"
    policies = tmp_path / "policies.json"
    policies.write_text(json.dumps({
        "w": {"module": f"file://{missing}"},
        "priv": {"module": "builtin://pod-privileged"},
    }))
    base = ["--policies", str(policies), "--port", "0",
            "--readiness-probe-port", "0", "--device", "cpu", "--no-warmup",
            "--policies-download-dir", str(tmp_path / "store")]
    with pytest.raises(FetchError, match="file not found"):
        cli.server_from_args(cli.build_cli().parse_args(base))
    server = cli.server_from_args(
        cli.build_cli().parse_args(base + ["--continue-on-errors"])
    )
    server.start()
    try:
        doc = json.loads(exchange(server.port, post_bytes(
            "/validate/w", json.dumps(pod_docs()[0]).encode()
        ))[0][2])
        assert doc["response"]["allowed"] is False
        assert "file not found" in doc["response"]["status"]["message"]
    finally:
        server.stop()
