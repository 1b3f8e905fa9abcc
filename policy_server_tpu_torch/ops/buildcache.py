"""Where the native libraries build, and how a built one is named.

The package compiles four libraries at first use: the CUDA kernels
(``ops/cuda_kernels.py``, nvcc), the native encoder (``ops/fastenc.py``),
the native HTTP frontend (``runtime/native_frontend.py``) and the native
wasm core (``wasm/native_exec.py``), each with g++. They build into
``build/torch_kernels/`` beside the package, or into the directory that
``--compilation-cache-dir`` names (``set_build_dir``, applied by the server
before its first build), where they survive restarts and are shared by
every checkout and process that points there.

A library's file name carries a hash of everything its bytes depend on:
the sources, the compiler and its flags, and the ABI it is loaded under.
A library whose file exists was built from exactly those inputs (each
build lands by an atomic rename), so it is reused as it is; any change
of an input is a new name and a new build. Nothing is judged by
modification times, which a directory shared across checkouts cannot
trust.

This module imports no torch: the prefork workers, which build the native
frontend, use it too.
"""

from __future__ import annotations

import hashlib
import os
import stat
import sys
import sysconfig
import tempfile
from pathlib import Path
from typing import Iterable

DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"

# hex digits of the input hash in a library's file name
KEY_CHARS = 16

_build_dir = DEFAULT_BUILD_DIR


def build_dir() -> Path:
    """The build directory: ``build/torch_kernels/`` unless
    ``set_build_dir`` named another."""
    return _build_dir


def set_build_dir(path: str | os.PathLike) -> Path:
    """Make ``path`` the build directory of every native library of this
    process (created when missing). Raises ``ValueError`` when it cannot
    be used: not a directory, read only, or not writable. Each library
    reads the setting when it names its file (``library_path``)."""
    global _build_dir
    p = Path(path).expanduser().resolve()
    try:
        p.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise ValueError(
            f"--compilation-cache-dir {path}: cannot create the directory: {e}"
        ) from e
    mode = p.stat().st_mode
    if not stat.S_ISDIR(mode):
        raise ValueError(f"--compilation-cache-dir {path}: not a directory")
    if not mode & stat.S_IWUSR or not os.access(p, os.W_OK | os.X_OK):
        raise ValueError(f"--compilation-cache-dir {path}: the directory is read only")
    try:
        with tempfile.NamedTemporaryFile(dir=p, prefix=".probe-"):
            pass
    except OSError as e:
        raise ValueError(
            f"--compilation-cache-dir {path}: the directory is not writable: {e}"
        ) from e
    _build_dir = p
    return p


def abi_tag() -> str:
    """The interpreter ABI a library is loaded under."""
    return sysconfig.get_config_var("SOABI") or (
        f"py{sys.version_info[0]}{sys.version_info[1]}"
    )


def input_key(
    sources: Iterable[Path], compiler: str, flags: Iterable[str], abi: str
) -> str:
    """The hash of a library's inputs: each source's name and bytes, the
    compiler, its flags and the ABI."""
    h = hashlib.sha256()
    for part in (compiler, *flags, abi):
        h.update(part.encode())
        h.update(b"\0")
    for source in sources:
        h.update(Path(source).name.encode())
        h.update(b"\0")
        h.update(Path(source).read_bytes())
        h.update(b"\0")
    return h.hexdigest()[:KEY_CHARS]
