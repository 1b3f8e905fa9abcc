"""``--compilation-cache-dir`` in the PyTorch port (``ops/buildcache.py``):
the native libraries build into the named directory under names that
hash their inputs, a second boot over the same directory builds nothing,
an input change is a new name, and a directory that cannot be written is
refused, never replaced by another."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from policy_server_tpu_torch import __main__ as cli
from policy_server_tpu_torch.ops import buildcache

REPO = Path(__file__).resolve().parent.parent

# one boot in a process of its own: a server over DIR on the CPU under
# --frontend native (the encoder and the frontend build), then the wasm
# core; each library's file and its g++ seconds
BOOT = r"""
import json, sys
from policy_server_tpu_torch import __main__ as cli
from policy_server_tpu_torch.ops import buildcache, fastenc
from policy_server_tpu_torch.runtime import native_frontend as nf
from policy_server_tpu_torch.wasm import native_exec

args = cli.build_cli().parse_args([
    "--policies", sys.argv[1], "--port", "0", "--readiness-probe-port", "0",
    "--device", "cpu", "--frontend", "native", "--no-warmup",
    "--compilation-cache-dir", sys.argv[2],
])
server = cli.server_from_args(args)
server.start()
try:
    native_exec.build_library()
    enc = fastenc.build_library()
    front = nf.build_library()
    out = {
        "build_dir": str(buildcache.build_dir()),
        "module_dirs": [str(m.library_path().parent) for m in (fastenc, nf, native_exec)],
        "encoder": [str(enc.path), enc.build_seconds],
        "frontend": [str(front.path), front.build_seconds],
        "wasm": [str(native_exec.library_path()), native_exec.build_seconds],
    }
finally:
    server.stop()
print("BOOT " + json.dumps(out))
"""


def boot(policies: Path, cache: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", BOOT, str(policies), str(cache)],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("BOOT "))
    return json.loads(line[len("BOOT "):])


def test_libraries_build_into_the_cache_dir_by_hash_and_are_reused(tmp_path):
    policies = tmp_path / "policies.json"
    policies.write_text(json.dumps({"p": {"module": "builtin://pod-privileged"}}))
    cache = tmp_path / "cache"
    first = boot(policies, cache)
    assert first["build_dir"] == str(cache.resolve())
    assert first["module_dirs"] == [str(cache.resolve())] * 3
    built = {}
    for name in ("encoder", "frontend", "wasm"):
        path, seconds = first[name]
        assert Path(path).parent == cache.resolve(), name
        assert seconds > 0, name
        # the stem, the ABI, then the input hash
        key = Path(path).stem.rsplit("-", 1)[1]
        assert len(key) == buildcache.KEY_CHARS and int(key, 16) >= 0
        built[name] = path
    assert sorted(p.name for p in cache.glob("*.so")) == sorted(
        Path(p).name for p in built.values()
    )
    second = boot(policies, cache)
    for name in ("encoder", "frontend", "wasm"):
        assert second[name] == [built[name], 0.0], name


def test_the_key_hashes_sources_compiler_flags_and_abi(tmp_path):
    a = tmp_path / "a.cpp"
    a.write_text("int f() { return 1; }\n")
    base = buildcache.input_key([a], "g++", ("-O2",), "abi")
    assert base == buildcache.input_key([a], "g++", ("-O2",), "abi")
    assert base != buildcache.input_key([a], "g++", ("-O3",), "abi")
    assert base != buildcache.input_key([a], "clang++", ("-O2",), "abi")
    assert base != buildcache.input_key([a], "g++", ("-O2",), "other")
    a.write_text("int f() { return 2; }\n")
    assert base != buildcache.input_key([a], "g++", ("-O2",), "abi")


@pytest.mark.parametrize("kind", ["read-only", "under-a-file"])
def test_an_unusable_cache_dir_raises(tmp_path, kind):
    if kind == "read-only":
        bad = tmp_path / "ro"
        bad.mkdir()
        bad.chmod(0o555)
    else:
        (tmp_path / "file").write_text("x")
        bad = tmp_path / "file" / "cache"
    before = buildcache.build_dir()
    policies = tmp_path / "policies.json"
    policies.write_text(json.dumps({"p": {"module": "builtin://pod-privileged"}}))
    args = cli.build_cli().parse_args([
        "--policies", str(policies), "--port", "0", "--readiness-probe-port",
        "0", "--device", "cpu", "--no-warmup", "--compilation-cache-dir",
        str(bad),
    ])
    try:
        with pytest.raises(ValueError, match="--compilation-cache-dir"):
            cli.server_from_args(args)
        with pytest.raises(ValueError, match="--compilation-cache-dir"):
            buildcache.set_build_dir(bad)
    finally:
        if kind == "read-only":
            bad.chmod(0o755)
    # the setting is unchanged: no build went elsewhere
    assert buildcache.build_dir() == before
