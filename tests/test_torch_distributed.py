"""The port's multi-process plumbing (``parallel/mesh.py``
``initialize_distributed``, the server's bootstrap) against the JAX
package's: the three ``--distributed-*`` flags parse, fall back to their
environment variables and are rejected as ``tests/test_distributed.py``
has them, through both packages; a bring-up that fails leaves no process
group behind; and two server processes on localhost form one
``torch.distributed`` group over gloo with a global ``data:2`` mesh (one
CPU entry each), each serving its own reviews with the oracle's bodies."""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from policy_server_tpu.config import cli as jcli
from policy_server_tpu.config.config import Config
from policy_server_tpu_torch import __main__ as cli
from policy_server_tpu_torch.parallel import mesh as tmesh

REPO = str(Path(__file__).resolve().parent.parent)
DRIVE = str(Path(__file__).resolve().parent / "torch_mesh_drive.py")
# each subprocess case's own time limit
CASE_TIMEOUT_S = 60
REVIEWS_PER_PROCESS = 64


def both_configs(tmp_path, *extra: str):
    """(JAX Config, port namespace after validate_args) for one command
    line."""
    policies = tmp_path / "policies.yml"
    if not policies.exists():
        policies.write_text("{}")
    argv = ["--policies", str(policies), *extra]
    jcfg = Config.from_args(jcli.build_cli().parse_args(argv))
    args = cli.build_cli().parse_args(argv)
    cli.validate_args(args)
    return jcfg, args


def test_cli_distributed_flags(tmp_path):
    jcfg, args = both_configs(
        tmp_path,
        "--distributed-coordinator", "coord:8476",
        "--distributed-num-processes", "4",
        "--distributed-process-id", "2",
    )
    for key in ("distributed_coordinator", "distributed_num_processes",
                "distributed_process_id"):
        assert getattr(args, key) == getattr(jcfg, key)
    assert (args.distributed_coordinator, args.distributed_num_processes,
            args.distributed_process_id) == ("coord:8476", 4, 2)


def test_distributed_env_fallback(tmp_path, monkeypatch):
    policies = tmp_path / "policies.yml"
    policies.write_text("{}")
    monkeypatch.setenv("KUBEWARDEN_POLICIES", str(policies))
    monkeypatch.setenv("KUBEWARDEN_DISTRIBUTED_COORDINATOR", "c:1234")
    monkeypatch.setenv("KUBEWARDEN_DISTRIBUTED_NUM_PROCESSES", "2")
    monkeypatch.setenv("KUBEWARDEN_DISTRIBUTED_PROCESS_ID", "0")
    jcfg = Config.from_args(jcli.build_cli().parse_args([]))
    args = cli.build_cli().parse_args([])
    cli.validate_args(args)
    got = (args.distributed_coordinator, args.distributed_num_processes,
           args.distributed_process_id)
    assert got == ("c:1234", 2, 0) == (
        jcfg.distributed_coordinator, jcfg.distributed_num_processes,
        jcfg.distributed_process_id,
    )


@pytest.mark.parametrize(
    "extra",
    [
        ["--distributed-num-processes", "2"],
        ["--distributed-process-id", "0"],
        ["--distributed-coordinator", "c:1", "--distributed-num-processes", "2"],
        ["--distributed-coordinator", "c:1", "--distributed-process-id", "0"],
        ["--distributed-coordinator", "c:1",
         "--distributed-num-processes", "2", "--distributed-process-id", "2"],
    ],
)
def test_distributed_validation_rejects(tmp_path, extra):
    """Each of ``tests/test_distributed.py``'s rejects raises through both
    packages with the same text."""
    policies = tmp_path / "policies.yml"
    policies.write_text("{}")
    argv = ["--policies", str(policies), *extra]
    with pytest.raises(ValueError) as jerr:
        Config.from_args(jcli.build_cli().parse_args(argv))
    with pytest.raises(ValueError) as perr:
        cli.validate_args(cli.build_cli().parse_args(argv))
    assert str(perr.value) == str(jerr.value)


def test_initialize_distributed_without_a_coordinator_is_a_no_op():
    tmesh.initialize_distributed(None, 2, 0)
    assert not dist.is_initialized()
    assert tmesh.process_count() == 1 and tmesh.process_index() == 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_unserved_coordinator_raises_and_leaves_no_group():
    """A coordinator nobody serves: the bring-up raises at its timeout and
    leaves no process group."""
    with pytest.raises(Exception):
        tmesh.initialize_distributed(
            f"127.0.0.1:{free_port()}", 2, 1, timeout_seconds=2.0
        )
    assert not dist.is_initialized()


def test_failed_bring_up_destroys_the_group_it_made(monkeypatch, tmp_path):
    """The counterpart of the JAX package's cleanup after a failed
    ``jax.distributed.initialize``: a bring-up that raises after the group
    was made destroys it."""
    real = dist.init_process_group

    def made_then_failed(**kwargs):
        real(backend="gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
             world_size=1, rank=0, timeout=datetime.timedelta(seconds=10))
        assert dist.is_initialized()
        raise RuntimeError("bring-up failed after the group was made")

    monkeypatch.setattr(dist, "init_process_group", made_then_failed)
    with pytest.raises(RuntimeError, match="after the group was made"):
        tmesh.initialize_distributed("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()


def test_two_processes_form_one_mesh_and_serve_their_own_rows(tmp_path):
    """Two server processes over gloo on localhost: each joins through
    ``initialize_distributed`` and lays the global ``data:2`` mesh (one CPU
    entry each, its own data shard), keeps columnar off as the JAX
    package's multi-process mesh does, serves its own 64 reviews with the
    oracle's bodies on K1 (plain runs on the CPU), sums its own rows' K1
    allowed bits through ``acceptance_psum`` (one gloo ``all_reduce``) to
    the oracle's counts over both processes' rows, and leaves the group at
    stop."""
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = []
    for rank in range(2):
        out = tmp_path / f"rank{rank}.json"
        procs.append((out, subprocess.Popen(
            [sys.executable, DRIVE, str(out), coordinator, str(rank),
             str(REVIEWS_PER_PROCESS)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO,
        )))
    reports = []
    try:
        for out, proc in procs:
            text, _ = proc.communicate(timeout=CASE_TIMEOUT_S)
            assert proc.returncode == 0, text.decode()[-3000:]
            reports.append(json.loads(out.read_text()))
    finally:
        for _out, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, rep in enumerate(reports):
        assert rep["rank"] == rank and rep["world"] == 2
        assert rep["mesh"] == {"data": 2, "policy": 1}
        assert rep["local_shards"] == [["cpu"]]
        assert rep["columnar_ok"] is False and rep["wire_rows"] == 0
        assert rep["answered"] == REVIEWS_PER_PROCESS
        assert rep["mismatches"] == 0, rep["first_mismatch"]
        assert rep["k1_dispatches"] == rep["dispatched_chunks"] > 0
        assert rep["group_after_stop"] == 1
    # acceptance_psum over the gloo group: each process sums its own rows'
    # K1 bits (the oracle's), and both get the oracle's counts over both
    # processes' rows
    for rep in reports:
        assert rep["k1_bits_are_the_oracles"] and rep["psum_device"] == "cpu"
        assert rep["psum"] == rep["oracle_counts"]
        assert rep["psum_policies"] >= 30
    assert reports[0]["psum"] == reports[1]["psum"]
    assert 0 < sum(reports[0]["psum"]) < (
        2 * REVIEWS_PER_PROCESS * reports[0]["psum_policies"]
    )
