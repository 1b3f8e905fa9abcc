"""The port's policy lifecycle (``policy_server_tpu_torch/lifecycle.py``)
held against the JAX package's (``policy_server_tpu/lifecycle.py``): each
case of ``tests/test_lifecycle.py``, under the same name, runs its sequence
through a harness of each package, wired as each server wires it (a
shared shadow recorder, one batcher per epoch; the JAX side on its ``jax``
backend, the port's on ``device="cpu"``), and the two must agree exactly
(tolerance 0: integers and bytes) on ``lifecycle.stats()`` after the
sequence and on every served body before and after each flip: promote, a
failed stage per failpoint, canary divergence and its threshold, a hung
canary's timeout, manual stage and promote, rollback with and without a
previous epoch, 409 during an in-flight reload, coalesced triggers, the
file watch, and synthetics never capped. Also held: the admin endpoints'
status and bodies against a JAX server, and the readiness texts."""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from policy_server_tpu import failpoints as jfp
from policy_server_tpu import lifecycle as jlc
from policy_server_tpu.api import handlers as jhandlers
from policy_server_tpu.api.service import RequestOrigin as JOrigin
from policy_server_tpu.api.state import ApiServerState as JState
from policy_server_tpu.evaluation.environment import (
    EvaluationEnvironmentBuilder as JBuilder,
)
from policy_server_tpu.models import AdmissionResponse as JResponse
from policy_server_tpu.models import AdmissionReviewRequest as JReview
from policy_server_tpu.models import AdmissionReviewResponse as JReviewResponse
from policy_server_tpu.models import ValidateRequest as JValidateRequest
from policy_server_tpu.models.policy import parse_policy_entry as jparse
from policy_server_tpu.runtime.batcher import MicroBatcher as JBatcher
from policy_server_tpu_torch import failpoints as tfp
from policy_server_tpu_torch import lifecycle as tlc
from policy_server_tpu_torch.api import handlers as thandlers
from policy_server_tpu_torch.api.service import RequestOrigin as TOrigin
from policy_server_tpu_torch.api.state import ApiServerState as TState
from policy_server_tpu_torch.evaluation.environment import (
    EvaluationEnvironmentBuilder as TBuilder,
)
from policy_server_tpu_torch.models import AdmissionResponse as TResponse
from policy_server_tpu_torch.models import AdmissionReviewRequest as TReview
from policy_server_tpu_torch.models import AdmissionReviewResponse as TReviewResponse
from policy_server_tpu_torch.models import ValidateRequest as TValidateRequest
from policy_server_tpu_torch.models.policy import parse_policy_entry as tparse
from policy_server_tpu_torch.runtime.batcher import MicroBatcher as TBatcher
from policy_server_tpu_torch.server import PolicyServer, read_policies_source

from conftest import build_admission_review_dict

V1 = {
    "ns": {
        "module": "builtin://namespace-validate",
        "settings": {"denied_namespaces": ["blocked"]},
    },
}
V2 = dict(V1, happy={"module": "builtin://always-happy"})
# (policy id, namespace) served before and after each flip
PROBES = (("ns", None), ("ns", "blocked"), ("happy", None))

JAX = SimpleNamespace(
    name="jax", fp=jfp, lc=jlc, parse=jparse, State=JState, Batcher=JBatcher,
    origin=JOrigin.VALIDATE, Review=JReview, ValidateRequest=JValidateRequest,
    Response=JResponse, ReviewResponse=JReviewResponse,
    env=lambda specs: JBuilder(backend="jax", verdict_cache_size=0).build(specs),
    oracle=lambda specs: JBuilder(backend="oracle").build(specs),
    read_file=lambda path: __import__(
        "policy_server_tpu.config.config", fromlist=["x"]
    ).read_policies_source(path),
)
PORT = SimpleNamespace(
    name="port", fp=tfp, lc=tlc, parse=tparse, State=TState, Batcher=TBatcher,
    origin=TOrigin.VALIDATE, Review=TReview, ValidateRequest=TValidateRequest,
    Response=TResponse, ReviewResponse=TReviewResponse,
    env=lambda specs: TBuilder(device="cpu", verdict_cache_size=0).build(specs),
    oracle=lambda specs: TBuilder(backend="oracle").build(specs),
    read_file=read_policies_source,
)
SIDES = (JAX, PORT)


@pytest.fixture(autouse=True)
def clean_failpoints():
    for side in SIDES:
        side.fp.reset()
    yield
    for side in SIDES:
        side.fp.reset()


def policies(side, specs: dict) -> dict:
    return {k: side.parse(k, v) for k, v in specs.items()}


def review(side, namespace: str | None = None):
    doc = build_admission_review_dict()
    if namespace is not None:
        doc["request"]["namespace"] = namespace
    return side.ValidateRequest.from_admission(side.Review.from_dict(doc).request)


class Harness:
    """A lifecycle manager of one package over its real environments,
    wired as that package's server wires it (``tests/test_lifecycle.py``'s
    harness)."""

    def __init__(self, side, mode: str = "auto",
                 divergence_threshold: float = 0.0, oracle_wrapper=None):
        self.side = side
        self.recorder = side.lc.ShadowRecorder(capacity=16)
        self._oracle_wrapper = oracle_wrapper
        env0 = self.build_env(policies(side, V1))
        batcher0 = self.build_batcher(env0)
        batcher0.start()
        self.state = side.State(
            evaluation_environment=env0, batcher=batcher0, ready=False
        )
        self.manager = side.lc.PolicyLifecycleManager(
            state=self.state,
            build_environment=self.build_env,
            build_oracle_environment=self.build_oracle,
            build_batcher=self.build_batcher,
            recorder=self.recorder,
            mode=mode,
            canary_requests=16,
            divergence_threshold=divergence_threshold,
            warmup=False,
        )
        self.state.lifecycle = self.manager
        self.epoch0 = self.manager.install_first_epoch(
            env0, batcher0, policies(side, V1)
        )

    def build_env(self, policy_set):
        return self.side.env(dict(policy_set))

    def build_oracle(self, policy_set):
        env = self.side.oracle(dict(policy_set))
        if self._oracle_wrapper is not None:
            env = self._oracle_wrapper(self.side, env)
        return env

    def build_batcher(self, env):
        return self.side.Batcher(
            env, max_batch_size=4, batch_timeout_ms=1.0, policy_timeout=5.0,
            host_fastpath_threshold=64, shadow_recorder=self.recorder,
        )

    def reload(self, specs: dict | None = None, **kw):
        """reload() → its outcome, or the rejection's stage and text."""
        try:
            return self.manager.reload(
                policies=None if specs is None else policies(self.side, specs),
                **kw,
            )
        except self.side.lc.ReloadRejected as e:
            return ("rejected", e.stage, str(e))

    def serve(self, policy_id: str, namespace: str | None = None):
        return self.state.batcher.submit(
            policy_id, review(self.side, namespace), self.side.origin
        ).result(timeout=10)

    def body(self, policy_id: str, namespace: str | None = None):
        """The served body (the AdmissionReview the API would write), or
        the error's type and text."""
        try:
            r = self.serve(policy_id, namespace)
        except Exception as e:  # noqa: BLE001 — compared across packages
            return ("exc", type(e).__name__, str(e))
        if hasattr(r, "to_response"):
            r = r.to_response()
        return json.dumps(self.side.ReviewResponse(r).to_dict())

    def bodies(self) -> list:
        return [self.body(pid, ns) for pid, ns in PROBES]

    def close(self):
        self.manager.shutdown()


def both(scenario, **harness_kw):
    """Run ``scenario(harness)`` for each package; their observations must
    be equal. → the port's."""
    out = {}
    for side in SIDES:
        h = Harness(side, **harness_kw)
        try:
            out[side.name] = scenario(h)
        finally:
            h.close()
    assert out["port"] == out["jax"]
    return out["port"]


def wait_for(pred, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# ---------------------------------------------------------------------------
# Shadow recorder
# ---------------------------------------------------------------------------


def test_shadow_recorder_ring_is_bounded():
    out = {}
    for side in SIDES:
        rec = side.lc.ShadowRecorder(capacity=4)
        for i in range(10):
            rec.observe([(f"p{i}", object())])
        out[side.name] = ([pid for pid, _ in rec.snapshot()], len(rec))
    assert out["port"] == out["jax"] == (["p6", "p7", "p8", "p9"], 4)


def test_batcher_feeds_the_recorder():
    def scenario(h):
        b = h.body("ns")
        return b, [pid for pid, _ in h.recorder.snapshot()]

    _body, recorded = both(scenario)
    assert "ns" in recorded


# ---------------------------------------------------------------------------
# Reload pipeline: promote / reject / epoch scoping
# ---------------------------------------------------------------------------


def test_reload_promotes_new_epoch_atomically():
    def scenario(h):
        before = h.bodies()
        old_env = h.state.evaluation_environment
        old_batcher = h.state.batcher
        outcome = h.reload(V2)
        flipped = (
            h.state.evaluation_environment is not old_env,
            h.state.batcher is not old_batcher,
            h.state.evaluation_environment.breaker is not old_env.breaker,
        )
        after = h.bodies()
        stats = h.manager.stats()
        retired = wait_for(lambda: old_batcher._stopping, 5)
        return before, outcome, flipped, after, stats, retired, old_env._closed

    before, outcome, flipped, after, stats, retired, closed = both(scenario)
    assert outcome == "promoted" and all(flipped)
    assert before[2][0] == "exc" and '"allowed": true' in after[2]
    assert stats["reloads"] == 1 and stats["epoch"] == 1
    assert stats["canary_replays"] > 0
    assert retired and not closed  # the pinned epoch's env stays open


def test_second_promotion_closes_the_epoch_beyond_the_pin():
    def scenario(h):
        env0 = h.state.evaluation_environment
        first = h.reload(V2)
        open_after_first = not env0._closed
        second = h.reload(V1)
        closed = wait_for(lambda: env0._closed, 10)
        return first, open_after_first, second, closed, h.manager.stats(), h.bodies()

    first, open_after_first, second, closed, stats, _bodies = both(scenario)
    assert (first, second) == ("promoted", "promoted")
    assert open_after_first and closed and stats["epoch"] == 2


@pytest.mark.parametrize("site,stage", [
    ("reload.fetch", "fetch"),
    ("reload.compile", "compile"),
    ("reload.canary", "canary"),
])
def test_failed_stage_keeps_last_good_and_counts_rollback(site, stage):
    def scenario(h):
        h.side.fp.configure(f"{site}=raise:injected-reload-fault")
        env_before = h.state.evaluation_environment
        before = h.bodies()
        outcome = h.reload(V2)
        fired = h.side.fp.fired_count(site)
        return (
            before, outcome, fired,
            h.state.evaluation_environment is env_before,
            h.bodies(), h.manager.stats(),
        )

    before, outcome, fired, same_env, after, stats = both(scenario)
    assert outcome[:2] == ("rejected", stage) and fired == 1 and same_env
    assert after == before and after[2][0] == "exc"  # never served
    assert (stats["reload_failures"], stats["rollbacks"]) == (1, 1)
    assert (stats["reloads"], stats["epoch"]) == (0, 0)


def test_settings_validation_failure_rejects_at_compile():
    bad = {
        "ns": {
            "module": "builtin://namespace-validate",
            "settings": {"denied_namespaces": 17},
        }
    }

    def scenario(h):
        return h.reload(bad), h.bodies(), h.manager.stats()

    outcome, _bodies, stats = both(scenario)
    assert outcome[:2] == ("rejected", "compile") and stats["rollbacks"] == 1


# ---------------------------------------------------------------------------
# Shadow canary: divergence, threshold, timeout
# ---------------------------------------------------------------------------


class _FlippingOracle:
    """An oracle whose every verdict disagrees with the candidate."""

    def __init__(self, side, inner):
        self._side = side
        self._inner = inner

    def validate_batch(self, pairs, run_hooks=True, prefer_host=False):
        out = self._inner.validate_batch(pairs, run_hooks=run_hooks)
        return [
            r if isinstance(r, Exception)
            else self._side.Response(uid=r.uid, allowed=not r.allowed)
            for r in out
        ]

    def close(self):
        self._inner.close()


def test_canary_divergence_rejects_candidate():
    def scenario(h):
        return h.reload(V2), h.bodies(), h.manager.stats()

    outcome, bodies, stats = both(scenario, oracle_wrapper=_FlippingOracle)
    assert outcome[:2] == ("rejected", "canary") and "divergence" in outcome[2]
    assert stats["canary_divergences"] > 0
    assert (stats["rollbacks"], stats["epoch"]) == (1, 0)
    assert bodies[2][0] == "exc"


def test_divergence_threshold_tolerates_configured_fraction():
    def scenario(h):
        return h.reload(V2), h.bodies(), h.manager.stats()

    outcome, bodies, stats = both(
        scenario, oracle_wrapper=_FlippingOracle, divergence_threshold=1.0
    )
    assert outcome == "promoted" and stats["canary_divergences"] > 0
    assert '"allowed": true' in bodies[2]


def test_hung_canary_rejects_by_timeout():
    def scenario(h):
        h.manager.canary_timeout_seconds = 0.3
        h.side.fp.set_failpoint("reload.canary", lambda: time.sleep(5))
        t0 = time.perf_counter()
        outcome = h.reload(V2)
        return outcome, time.perf_counter() - t0 < 4.0, h.bodies(), h.manager.stats()

    outcome, quick, _bodies, _stats = both(scenario)
    assert outcome[:2] == ("rejected", "canary") and quick


def test_slow_oracle_replay_rejected_by_timeout():
    def slow_oracle(side, env):
        real = env.validate_batch

        def slow(pairs, run_hooks=True, prefer_host=False):
            time.sleep(5)
            return real(pairs, run_hooks=run_hooks)

        env.validate_batch = slow
        return env

    def scenario(h):
        h.manager.canary_timeout_seconds = 0.3
        return h.reload(V2), h.manager.stats()

    outcome, _stats = both(scenario, oracle_wrapper=slow_oracle)
    assert outcome[:2] == ("rejected", "canary") and "hung candidate" in outcome[2]


# ---------------------------------------------------------------------------
# Manual mode + rollback
# ---------------------------------------------------------------------------


def _promote_staged(h):
    try:
        return h.manager.promote_staged()
    except h.side.lc.ReloadRejected as e:
        return ("rejected", e.stage, str(e))


def _rollback(h):
    try:
        return h.manager.rollback()
    except h.side.lc.ReloadRejected as e:
        return ("rejected", e.stage, str(e))


def test_manual_mode_stages_then_promotes():
    def scenario(h):
        staged = h.reload(V2)
        while_staged = (h.bodies(), h.manager.stats())
        promoted = _promote_staged(h)
        after = (h.bodies(), h.manager.stats())
        return staged, while_staged, promoted, after, _promote_staged(h)

    staged, while_staged, promoted, after, again = both(scenario, mode="manual")
    assert staged == "staged" and promoted == "promoted"
    assert while_staged[0][2][0] == "exc" and while_staged[1]["staged"] == 1
    assert after[1]["epoch"] == 1 and '"allowed": true' in after[0][2]
    assert again[:2] == ("rejected", "promote")


def test_rollback_restores_previous_epoch():
    def scenario(h):
        out = [h.reload(V2), h.bodies()]
        out += [_rollback(h), h.bodies(), h.manager.stats()]
        out += [_rollback(h), h.bodies(), h.manager.stats()]
        return out

    out = both(scenario)
    assert out[0] == "promoted" and out[2] == out[5] == "rolled-back"
    assert out[3][2][0] == "exc" and '"allowed": true' in out[6][2]
    assert (out[4]["rollbacks"], out[4]["epoch"]) == (1, 0)


def test_rollback_without_previous_epoch_rejects():
    def scenario(h):
        return _rollback(h), h.manager.stats()

    outcome, _stats = both(scenario)
    assert outcome[:2] == ("rejected", "rollback")


def test_request_reload_coalesces():
    def scenario(h):
        release = threading.Event()
        h.side.fp.set_failpoint("reload.fetch", lambda: release.wait(10))
        try:
            first = h.manager.request_reload("t1")
            time.sleep(0.1)
            second = h.manager.request_reload("t2")
        finally:
            release.set()
        wait_for(lambda: h.manager.stats()["reloads"] == 1)
        wait_for(lambda: not h.manager.reload_in_flight())
        return first, second, h.manager.stats(), h.bodies()

    first, second, stats, _bodies = both(scenario)
    assert (first, second, stats["reloads"]) == (True, False, 1)


# ---------------------------------------------------------------------------
# File-watch trigger
# ---------------------------------------------------------------------------


def _write(path, specs: dict) -> None:
    """Replace the file in one step, as a ConfigMap update does: the
    watchers poll every 0.05 s here and must never read half a file."""
    import os

    import yaml

    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(yaml.safe_dump(specs))
    os.replace(tmp, path)


def test_policies_file_watch_triggers_reload(tmp_path, monkeypatch):
    for side in SIDES:
        monkeypatch.setattr(side.lc, "WATCH_INTERVAL_SECONDS", 0.05)

    def scenario(h):
        path = tmp_path / f"{h.side.name}-policies.yml"
        _write(path, V1)
        h.manager._read_policies = lambda: h.side.read_file(path)
        h.manager._policies_path = str(path)
        h.manager.start_watching()
        time.sleep(0.2)
        _write(path, V2)
        wait_for(lambda: h.manager.stats()["reloads"] == 1, 15)
        return h.manager.stats(), h.bodies()

    stats, bodies = both(scenario)
    assert stats["reloads"] == 1 and '"allowed": true' in bodies[2]


def test_file_watch_redetects_change_landing_during_inflight_reload(
    tmp_path, monkeypatch
):
    for side in SIDES:
        monkeypatch.setattr(side.lc, "WATCH_INTERVAL_SECONDS", 0.05)

    def scenario(h):
        path = tmp_path / f"{h.side.name}-policies.yml"
        _write(path, V1)
        h.manager._read_policies = lambda: h.side.read_file(path)
        h.manager._policies_path = str(path)
        h.manager.start_watching()
        time.sleep(0.2)
        release = threading.Event()
        h.side.fp.set_failpoint(
            "reload.compile", lambda: release.wait(15), count=1
        )
        occupant = h.manager.request_reload("occupant")
        time.sleep(0.1)
        _write(path, V2)
        time.sleep(0.3)
        release.set()
        wait_for(lambda: h.manager.stats()["reloads"] == 2, 20)
        wait_for(lambda: not h.manager.reload_in_flight())
        return occupant, h.manager.stats(), h.bodies()

    occupant, stats, bodies = both(scenario)
    assert occupant and stats["reloads"] == 2
    assert '"allowed": true' in bodies[2], "the change written mid-reload was lost"


# ---------------------------------------------------------------------------
# Readiness honesty
# ---------------------------------------------------------------------------


class _FakeEnv:
    breaker_all_open = False
    breaker_stats: dict = {}
    device_errors = 0

    def close(self):
        pass


class _FakeBatcher:
    degraded_mode = "oracle"

    def __init__(self, env):
        self.env = env

    def shutdown(self):
        pass


def test_readiness_honest_states():
    out = {}
    for side in SIDES:
        env = _FakeEnv()
        batcher = _FakeBatcher(env)
        state = side.State(evaluation_environment=env, batcher=batcher, ready=False)
        seen = [state.readiness()]
        state.ready = True
        seen.append(state.readiness())
        batcher.degraded_mode = "reject"
        env.breaker_all_open = True
        seen.append(state.readiness())
        batcher.degraded_mode = "oracle"
        seen.append(state.readiness())
        out[side.name] = seen
    assert out["port"] == out["jax"]
    assert [c for c, _ in out["port"]] == [503, 200, 503, 200]


def test_readiness_stays_200_on_last_good_during_background_reload():
    def scenario(h):
        h.state.ready = True
        release = threading.Event()
        h.side.fp.set_failpoint("reload.compile", lambda: release.wait(10))
        try:
            started = h.manager.request_reload("bg")
            time.sleep(0.1)
            seen = (started, h.state.readiness(), h.bodies())
        finally:
            release.set()
        wait_for(lambda: not h.manager.reload_in_flight())
        return seen

    started, readiness, _bodies = both(scenario)
    assert started and readiness == (200, "ok")


def test_default_auto_mode_wires_lifecycle_into_server_config():
    """The port's defaults are the JAX package's: reload on (auto), a
    canary budget of 64, threshold 0, no admin token, the self-heal
    watchdog every 5 s, and no watcher for a programmatic policy set; an
    unknown mode is refused."""
    from policy_server_tpu.config.config import Config, TlsConfig
    from policy_server_tpu_torch.__main__ import build_cli

    cfg = Config(policies={}, tls_config=TlsConfig())
    args = build_cli().parse_args([])
    assert (
        args.policy_reload_mode, args.reload_canary_requests,
        args.reload_divergence_threshold, args.reload_admin_token,
        args.selfheal_interval_seconds,
    ) == (
        cfg.policy_reload_mode, cfg.reload_canary_requests,
        cfg.reload_divergence_threshold, cfg.reload_admin_token,
        cfg.selfheal_interval_seconds,
    ) == ("auto", 64, 0.0, None, 5.0)
    server = PolicyServer(
        policies(PORT, V1), port=0, readiness_probe_port=0, device="cpu"
    )
    try:
        assert server.lifecycle is not None and server.lifecycle.mode == "auto"
        assert server.state.lifecycle is server.lifecycle
        assert server.lifecycle._policies_path is None
        assert server.state.readiness() == (200, "ok")
        server.start()
        assert server.selfheal.interval_seconds == 5.0
    finally:
        server.stop()
    with pytest.raises(ValueError):
        PolicyServer(
            policies(PORT, V1), port=0, readiness_probe_port=0, device="cpu",
            policy_reload_mode="sometimes",
        )


# ---------------------------------------------------------------------------
# Review-hardening regressions
# ---------------------------------------------------------------------------


def test_hung_canary_does_not_poison_the_next_reload():
    def scenario(h):
        h.manager.canary_timeout_seconds = 0.3
        h.side.fp.set_failpoint("reload.canary", lambda: time.sleep(5), count=1)
        first = h.reload(V2)
        h.manager.canary_timeout_seconds = 4.0
        second = h.reload(V2)
        return first, second, h.bodies(), h.manager.stats()

    first, second, bodies, _stats = both(scenario)
    assert first[:2] == ("rejected", "canary") and second == "promoted"
    assert '"allowed": true' in bodies[2]


def test_rollback_answers_409_during_inflight_reload():
    def scenario(h):
        h.manager._ADMIN_LOCK_TIMEOUT_SECONDS = 0.2
        release = threading.Event()
        h.side.fp.set_failpoint("reload.compile", lambda: release.wait(10))
        try:
            started = h.manager.request_reload("bg")
            time.sleep(0.1)
            outcome = _rollback(h)
        finally:
            release.set()
        wait_for(lambda: not h.manager.reload_in_flight())
        return started, outcome, h.manager.stats()

    started, outcome, _stats = both(scenario)
    assert started and outcome[:2] == ("rejected", "rollback")
    assert "in progress" in outcome[2]


def test_corpus_synthetics_are_never_capped():
    many = {f"p{i}": {"module": "builtin://always-happy"} for i in range(5)}

    def scenario(h):
        for _ in range(10):
            h.recorder.observe([("ns", review(h.side))])
        h.manager.canary_requests = 2
        capped = [pid for pid, _ in h.manager._corpus(policies(h.side, many))]
        h.manager.canary_requests = 0
        synth = [pid for pid, _ in h.manager._corpus(policies(h.side, many))]
        return capped, synth

    capped, synth = both(scenario)
    assert capped[:2] == ["ns", "ns"] and set(capped[2:]) == set(many)
    assert set(synth) == set(many) and len(synth) == 5


# ---------------------------------------------------------------------------
# The admin endpoints
# ---------------------------------------------------------------------------


class _Request:
    def __init__(self, authorization: str | None):
        self.headers = {} if authorization is None else {"Authorization": authorization}


@pytest.mark.parametrize("lifecycle,token,authorization", [
    (False, "s3cret", "Bearer s3cret"),
    (True, None, "Bearer s3cret"),
    (True, "s3cret", None),
    (True, "s3cret", "Bearer wrong"),
    (True, "s3cret", "s3cret"),
    (True, "s3cret", "Bearer s3cret"),
])
def test_admin_gate_statuses_and_bodies(lifecycle, token, authorization):
    """404 with reload off, 403 without a configured token, 401 for a
    missing or wrong bearer, and through for the right one: status and
    body as the JAX package's ``_admin_gate``."""
    lc = object() if lifecycle else None
    jstate = SimpleNamespace(lifecycle=lc, admin_token=token)
    tstate = SimpleNamespace(lifecycle=lc, admin_token=token)
    want = jhandlers._admin_gate(jstate, _Request(authorization))
    got = thandlers.admin_gate(tstate, authorization or "")
    if want is None:
        assert got is None
    else:
        assert got == (want.status, want.body)


class _JaxServer:
    """The JAX package's PolicyServer (oracle backend, reload on, an admin
    token) in a private event-loop thread."""

    def __init__(self, token: str) -> None:
        import asyncio

        from policy_server_tpu.config.config import Config, TlsConfig
        from policy_server_tpu.server import PolicyServer as JaxPolicyServer

        config = Config(
            addr="127.0.0.1", port=0, readiness_probe_port=0,
            tls_config=TlsConfig(), policies=policies(JAX, V1),
            evaluation_backend="oracle", reload_admin_token=token,
            selfheal_interval_seconds=0,
        )
        self.server = JaxPolicyServer.new_from_config(config)
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.server.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(60)
        self.readiness_port = self.server.readiness_port
        self.lifecycle = self.server.lifecycle

    def stop(self) -> None:
        import asyncio

        async def _shutdown():
            await self.server.stop()
            self.loop.stop()

        asyncio.run_coroutine_threadsafe(_shutdown(), self.loop)
        self.thread.join(timeout=30)


def _admin_post(port: int, path: str, authorization: str | None):
    headers = {} if authorization is None else {"Authorization": authorization}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=b"", headers=headers, method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_admin_endpoints_statuses_and_bodies_match_the_jax_server():
    """POST /policies/reload (401 without the bearer, 202 with it), then
    /policies/promote with nothing staged (409) and /policies/rollback
    twice (200, symmetric): status, content type and body equal to the
    JAX server's, with the lifecycle's stats after each."""
    token = "s3cret"
    out = {}
    for side in SIDES:
        if side is JAX:
            server = _JaxServer(token)
        else:
            server = PolicyServer(
                policies(PORT, V1), port=0, readiness_probe_port=0,
                device="cpu", reload_admin_token=token,
                selfheal_interval_seconds=0,
            )
            server.start()
        seen = []
        try:
            port, lc = server.readiness_port, server.lifecycle
            seen.append(_admin_post(port, "/policies/reload", None))
            seen.append(_admin_post(port, "/policies/reload", "Bearer no"))
            seen.append(_admin_post(port, "/policies/reload", f"Bearer {token}"))
            assert wait_for(lambda: lc.stats()["reloads"] == 1)
            assert wait_for(lambda: not lc.reload_in_flight())
            for path in ("/policies/promote", "/policies/rollback",
                         "/policies/rollback"):
                seen.append(_admin_post(port, path, f"Bearer {token}"))
                stats = lc.stats()
                seen.append((stats["epoch"], stats["rollbacks"], stats["reloads"]))
        finally:
            server.stop()
        out[side.name] = seen
    assert out["port"] == out["jax"]
    statuses = [s[0] for s in out["port"] if len(s) == 3 and isinstance(s[1], str)]
    assert statuses == [401, 401, 202, 409, 200, 200]


# ---------------------------------------------------------------------------
# This slice's flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv,field,value", [
    (["--workers", "0"], "pool_size", 0),
    (["--reload-canary-requests", "-1"], "reload_canary_requests", -1),
    (["--reload-divergence-threshold", "1.5"], "reload_divergence_threshold", 1.5),
    (["--selfheal-interval-seconds", "-1"], "selfheal_interval_seconds", -1.0),
])
def test_flag_validation_texts_are_the_jax_configs(argv, field, value):
    from policy_server_tpu.config.config import Config, TlsConfig
    from policy_server_tpu_torch.__main__ import build_cli, validate_args

    cfg = Config(policies={}, tls_config=TlsConfig(), **{field: value})
    with pytest.raises(ValueError) as want:
        cfg.validate()
    with pytest.raises(ValueError) as got:
        validate_args(build_cli().parse_args(argv))
    assert str(got.value) == str(want.value)


def test_flags_reach_the_server(tmp_path, monkeypatch):
    """--workers sizes the queue, --disable-timeout-protection lifts the
    policy timeout, --no-warmup skips the warmup, KUBEWARDEN_POLICY_RELOAD_
    MODE sets the mode, and the policies file is watched."""
    from policy_server_tpu_torch.__main__ import build_cli, server_from_args

    path = tmp_path / "policies.json"
    path.write_text(json.dumps(V1))
    monkeypatch.setenv("KUBEWARDEN_POLICY_RELOAD_MODE", "manual")
    args = build_cli().parse_args([
        "--policies", str(path), "--port", "0", "--readiness-probe-port", "0",
        "--addr", "127.0.0.1", "--device", "cpu", "--workers", "2",
        "--max-batch-size", "8", "--disable-timeout-protection", "--no-warmup",
        "--selfheal-interval-seconds", "0",
    ])
    server = server_from_args(args)
    server.start()
    try:
        assert server.batcher._queue.maxsize == 16
        assert server.batcher.policy_timeout is None
        assert server.batcher._dev_rtt == {}  # no warmup
        assert server.lifecycle.mode == "manual"
        assert server.lifecycle._policies_path == str(path)
        assert server.lifecycle.current_epoch == 0
        assert server.selfheal is None
    finally:
        server.stop()


def test_version_flag_prints_the_version(capsys):
    from policy_server_tpu_torch import __version__
    from policy_server_tpu_torch.__main__ import build_cli

    with pytest.raises(SystemExit) as e:
        build_cli().parse_args(["--version"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip() == f"policy_server_tpu_torch {__version__}"
