"""The rest of the flag table in the PyTorch port's CLI against the JAX
package's (``config/cli.py``): the acquisition and cluster flags, each
with the JAX name, default, choices, ``KUBEWARDEN_*`` variable and help
text; ``--evaluation-backend`` and ``--predicate-opt`` on the served path;
the ``docs`` subcommand; and ``--daemon``."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from policy_server_tpu.config import cli as jcli
from policy_server_tpu.config.config import Config
from policy_server_tpu_torch import __main__ as cli

from test_torch_native_frontend import exchange, post_bytes
from torch_port_support import JaxServer, firehose_docs

REPO = str(Path(__file__).resolve().parent.parent)
SLICE_FLAGS = (
    "--policies-download-dir", "--sources-path", "--verification-path",
    "--sigstore-cache-dir", "--docker-config-json-path",
    "--context-refresh-seconds", "--context-no-watch",
    "--kube-insecure-skip-tls-verify", "--ignore-kubernetes-connection-failure",
    "--predicate-opt", "--daemon", "--daemon-pid-file", "--daemon-stdout-file",
    "--daemon-stderr-file", "--evaluation-backend", "--state-dir",
    "--state-audit-spill-seconds", "--kernel", "--columnar",
    "--donate-buffers", "--compilation-cache-dir", "--mesh", "--mesh-dispatch",
    "--distributed-coordinator", "--distributed-num-processes",
    "--distributed-process-id",
)
# the JAX flags whose item has not come yet: none
NOT_YET: set = set()
# flags whose help is the port's own: what --kernel, --donate-buffers and
# --compilation-cache-dir mean for CUDA kernels and native libraries, and
# what the mesh and the process group are over CUDA devices and
# torch.distributed
OWN_HELP = {
    "--evaluation-backend": "CUDA kernels",
    "--kernel": "policy_matrix CUDA kernel",
    "--donate-buffers": "no donate_argnums",
    "--compilation-cache-dir": "native libraries",
    "--mesh-dispatch": "CUDA device",
    "--distributed-coordinator": "torch.distributed",
}


def specs_of(module) -> dict:
    return {flag: (env, kw) for flag, env, kw in module._flag_specs()}


@pytest.mark.parametrize("flag", SLICE_FLAGS)
def test_slice_flags_are_the_jax_packages(flag):
    jax, port = specs_of(jcli)[flag], specs_of(cli)[flag]
    assert port[0] == jax[0]
    for key in ("default", "metavar", "choices", "action", "type"):
        if flag == "--kernel" and key == "default":
            # the port's main path is K1: its default is pallas
            assert (jax[1]["default"], port[1]["default"]) == ("xla", "pallas")
            continue
        assert port[1].get(key) == jax[1].get(key), (flag, key)
    if flag in OWN_HELP:
        assert OWN_HELP[flag] in port[1]["help"]
        assert port[1]["help"] != jax[1]["help"]
    else:
        assert port[1]["help"] == jax[1]["help"]


def test_port_has_every_jax_flag_but_those_still_to_come():
    jax, port = set(specs_of(jcli)), set(specs_of(cli))
    assert port - jax == {"--device"}
    assert jax - port == NOT_YET


@pytest.mark.parametrize("flag,env,value,attr,want", [
    ("--sources-path", "KUBEWARDEN_SOURCES_PATH", "s.json", "sources_path", "s.json"),
    ("--context-no-watch", "KUBEWARDEN_CONTEXT_NO_WATCH", "true",
     "context_no_watch", True),
    ("--evaluation-backend", "KUBEWARDEN_EVALUATION_BACKEND", "oracle",
     "evaluation_backend", "oracle"),
    ("--predicate-opt", "KUBEWARDEN_PREDICATE_OPT", "off", "predicate_opt", "off"),
    ("--context-refresh-seconds", "KUBEWARDEN_CONTEXT_REFRESH_SECONDS", "5",
     "context_refresh_seconds", 5.0),
    ("--state-dir", "KUBEWARDEN_STATE_DIR", "/var/lib/kw", "state_dir",
     "/var/lib/kw"),
    ("--state-audit-spill-seconds", "KUBEWARDEN_STATE_AUDIT_SPILL_SECONDS", "5",
     "state_audit_spill_seconds", 5.0),
    ("--kernel", "KUBEWARDEN_KERNEL", "xla", "kernel", "xla"),
    ("--columnar", "KUBEWARDEN_COLUMNAR", "off", "columnar", "off"),
    ("--donate-buffers", "KUBEWARDEN_DONATE_BUFFERS", "off", "donate_buffers",
     "off"),
    ("--compilation-cache-dir", "KUBEWARDEN_COMPILATION_CACHE_DIR",
     "/var/cache/kw", "compilation_cache_dir", "/var/cache/kw"),
    ("--mesh", "KUBEWARDEN_MESH", "data:4,policy:2", "mesh", "data:4,policy:2"),
    ("--mesh-dispatch", "KUBEWARDEN_MESH_DISPATCH", "threaded", "mesh_dispatch",
     "threaded"),
    ("--distributed-coordinator", "KUBEWARDEN_DISTRIBUTED_COORDINATOR",
     "c:1234", "distributed_coordinator", "c:1234"),
    ("--distributed-num-processes", "KUBEWARDEN_DISTRIBUTED_NUM_PROCESSES", "2",
     "distributed_num_processes", 2),
    ("--distributed-process-id", "KUBEWARDEN_DISTRIBUTED_PROCESS_ID", "0",
     "distributed_process_id", 0),
])
def test_environment_variables_read_as_the_jax_cli(monkeypatch, flag, env, value,
                                                   attr, want):
    monkeypatch.setenv(env, value)
    assert getattr(cli.build_cli().parse_args([]), attr) == want
    assert getattr(jcli.build_cli().parse_args([]), attr) == want


def test_validation_texts_are_the_jax_packages(tmp_path):
    policies = tmp_path / "p.json"
    policies.write_text(json.dumps({"p": {"module": "builtin://pod-privileged"}}))
    cases = [
        ["--context-refresh-seconds", "0"],
        ["--audit-watch"],
        ["--audit-mode", "interval", "--audit-watch", "--audit-watch-resources", ","],
        ["--audit-mode", "interval", "--audit-watch", "--audit-watch-resources", "Pod"],
        ["--state-audit-spill-seconds", "0"],
        ["--audit-matrix-spill-seconds", "-1"],
        ["--mesh", "gpu:2"],
        ["--mesh", "data:0"],
        ["--mesh", "data:x"],
        ["--mesh", "data:2,data:2"],
    ]
    for extra in cases:
        argv = ["--policies", str(policies)] + extra
        with pytest.raises(ValueError) as jerr:
            Config.from_args(jcli.build_cli().parse_args(argv))
        with pytest.raises(ValueError) as perr:
            cli.validate_args(cli.build_cli().parse_args(argv))
        assert str(perr.value) == str(jerr.value), extra


@pytest.fixture(scope="module")
def backends(tmp_path_factory):
    """Port servers from the command line at ``--evaluation-backend jax``
    and ``oracle`` and ``--predicate-opt off``, and a JAX server."""
    from torch_port_support import flagship_specs

    tmp = tmp_path_factory.mktemp("cli-backends")
    specs = flagship_specs()
    path = tmp / "policies.json"
    path.write_text(json.dumps(specs))
    base = ["--policies", str(path), "--port", "0", "--readiness-probe-port",
            "0", "--device", "cpu", "--no-warmup", "--host-fastpath-threshold",
            "0", "--verdict-cache-size", "0"]
    servers = {}
    for name, extra in (("jax", []), ("oracle", ["--evaluation-backend", "oracle"]),
                        ("noopt", ["--predicate-opt", "off"])):
        servers[name] = cli.server_from_args(cli.build_cli().parse_args(base + extra))
        servers[name].start()
    jax_server = JaxServer(specs, evaluation_backend="oracle")
    yield specs, servers, jax_server
    for s in servers.values():
        s.stop()
    jax_server.stop()


def test_evaluation_backend_and_predicate_opt_on_the_served_path(backends):
    specs, servers, jax_server = backends
    assert servers["jax"].env.backend == "torch"
    assert servers["oracle"].env.backend == "oracle"
    assert servers["jax"].env.predicate_opt is True
    assert servers["noopt"].env.predicate_opt is False
    assert servers["noopt"].env.optimization is None
    docs = firehose_docs(6, seed=131)
    for pid in sorted(specs):
        for doc in docs:
            payload = post_bytes(f"/validate/{pid}", json.dumps(doc).encode())
            want = exchange(jax_server.port, payload)[0]
            for name, server in servers.items():
                got = exchange(server.port, payload)[0]
                assert (got[0], got[2]) == (want[0], want[2]), (name, pid)


def test_docs_subcommand_writes_the_jax_format(tmp_path, monkeypatch):
    """``docs --output FILE`` writes the markdown reference: the JAX
    package's ``generate_docs`` run over the port's flag table gives the
    same text, and each entry of a flag both CLIs share with equal help
    text equals the JAX package's own entry."""
    out = tmp_path / "cli-docs.md"
    proc = subprocess.run(
        [sys.executable, "-m", "policy_server_tpu_torch", "docs", "--output",
         str(out)], capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    text = out.read_text()
    assert text == cli.generate_docs()
    monkeypatch.setattr(jcli, "_flag_specs", cli._flag_specs)
    monkeypatch.setattr(jcli, "PROG", cli.PROG)
    assert jcli.generate_docs() == text
    monkeypatch.undo()

    def entries(doc: str) -> dict:
        body = doc.split("###### **Options:**\n\n", 1)[1]
        # the document's last entry carries its closing newline
        return {
            e.split("`", 2)[1].split(" ")[0]: e.rstrip("\n")
            for e in body.split("\n\n* ")
        }

    jax_text = jcli.generate_docs()
    port_e, jax_e = entries(text), entries(jax_text)
    jax_specs, port_specs = specs_of(jcli), specs_of(cli)
    same = [f for f in port_e if f in jax_e
            and port_specs[f][1].get("help") == jax_specs[f][1].get("help")]
    assert len(same) >= 40
    for flag in same:
        assert port_e[flag] == jax_e[flag], flag
    assert "--device" in port_e and "--device" not in jax_e
    assert text.split("###### **Options:**")[0] == jax_text.split(
        "###### **Options:**"
    )[0].replace(jcli.PROG, cli.PROG)


def test_daemon_detaches_writes_its_pid_and_serves(tmp_path):
    """``--daemon`` detaches (the command returns at once), writes the pid
    file and redirects stdout and stderr to the given files; the daemon
    serves until it is signalled."""
    policies = tmp_path / "p.json"
    policies.write_text(json.dumps({"p": {"module": "builtin://pod-privileged"}}))
    pid_file = tmp_path / "server.pid"
    err_file = tmp_path / "stderr.log"
    env = dict(os.environ, KUBEWARDEN_LOG_NO_COLOR="1")
    proc = subprocess.run(
        [sys.executable, "-m", "policy_server_tpu_torch", "--policies",
         str(policies), "--device", "cpu", "--addr", "127.0.0.1", "--port",
         "0", "--readiness-probe-port", "0", "--no-warmup", "--daemon",
         "--daemon-pid-file", str(pid_file),
         "--daemon-stdout-file", str(tmp_path / "stdout.log"),
         "--daemon-stderr-file", str(err_file)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    deadline = time.monotonic() + 120
    while not (pid_file.exists() and "serving on" in (
        err_file.read_text() if err_file.exists() else ""
    )):
        assert time.monotonic() < deadline, (
            err_file.read_text() if err_file.exists() else "no stderr file"
        )
        time.sleep(0.2)
    pid = int(pid_file.read_text())
    try:
        os.kill(pid, 0)  # alive
        import re

        api = int(re.search(r"serving on 127\.0\.0\.1:(\d+)",
                            err_file.read_text()).group(1))
        doc = firehose_docs(1, seed=7)[0]
        status, _h, body = exchange(api, post_bytes(
            "/validate/p", json.dumps(doc).encode()
        ))[0]
        assert status.split()[1] == "200"
        assert json.loads(body)["kind"] == "AdmissionReview"
    finally:
        os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        os.kill(pid, signal.SIGKILL)


def test_columnar_and_kernel_families_under_kernel_xla_equal_the_jax_default():
    """The port's server at ``--kernel xla``, kernel-only, after its
    warmup (both of the batcher's passes) and reviews one at a time, against the JAX package's default
    environment (``xla``, the columnar transport on; one device, where the
    test session's eight virtual CPU devices would give the JAX server a
    data axis of 8) after the same warmup and the same reviews: the seven
    columnar families and the three kernel-mode families read what the
    JAX server renders from that environment."""
    from policy_server_tpu.models import AdmissionReviewRequest, ValidateRequest
    from policy_server_tpu_torch.telemetry import metrics as tmetrics
    from test_torch_audit import _all_families
    from test_torch_native_frontend import SPECS, corpus, port_server
    from torch_port_support import jax_env

    jenv = jax_env(SPECS, verdict_cache_size=0)
    assert (jenv.kernel, jenv.columnar) == ("xla", True)
    tmetrics.reset_metrics_for_tests()
    # kernel-only: no host routing, by size or by the latency budget
    port_s = port_server(
        frontend="python", kernel="xla", host_fastpath_threshold=0,
        verdict_cache_size=0, latency_budget_ms=0,
    )
    try:
        sizes = (1, 2, 4, 8)
        # the batcher's warmup: every size, then each again for the seed
        jenv.warmup(sizes)
        for b in sizes:
            jenv.warmup((b,))
        for pid, body in corpus(9)[:24]:
            (status, _h, _b), = exchange(
                port_s.port, post_bytes(f"/validate/{pid}", body, close=True)
            )
            assert status.startswith("HTTP/1.1 200"), status
            req = ValidateRequest.from_admission(
                AdmissionReviewRequest.from_dict(json.loads(body)).request
            )
            jenv.validate_batch([(pid, req)])
        page = _all_families(port_s.readiness_port)
    finally:
        port_s.stop()
        tmetrics.reset_metrics_for_tests()
    profile, pstats = jenv.host_profile, jenv.pallas_stats
    want = {
        "policy_server_wire_bytes_shipped": profile["wire_bytes_shipped"],
        "policy_server_wire_bytes_packed_equivalent":
            profile["wire_bytes_packed_equiv"],
        "policy_server_wire_rows": profile["wire_rows"],
        "policy_server_delta_columns_shipped": profile["delta_cols_shipped"],
        "policy_server_delta_columns_available": profile["delta_cols_total"],
        "policy_server_donated_buffer_dispatches":
            profile["donated_dispatches"],
        "policy_server_device_resident_constant_bytes":
            profile["resident_const_bytes"],
        "policy_server_pallas_dispatches": pstats["dispatches"],
        "policy_server_pallas_buckets_armed": pstats["buckets_armed"],
        "policy_server_pallas_interpret_mode": pstats["interpret_mode"],
    }
    got = {n: [float(v) for v in page[n][2]] for n in want}
    assert got == {n: [float(v)] for n, v in want.items()}
    assert want["policy_server_wire_rows"] > 0
    assert want["policy_server_pallas_dispatches"] == 0
