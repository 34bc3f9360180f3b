"""Build shared libraries at first use and load them with ctypes.

Every library is keyed by a hash of its source bytes, the bytes of the
``.cuh`` headers beside it (``csrc/fwd_megakernel.cuh`` holds K1's body,
``csrc/expand16_plane.cuh`` K7's and ``csrc/stream_copy.cuh`` the
streaming copy, each included by two sources) and its compiler command,
so a changed source, header or flag gives a new file and a stale build is
never loaded.  Builds
go into ``lz4jpeg_tpu_torch/_build/`` (git-ignored): the compiler writes a
temporary file that ``os.replace`` moves into place, under an exclusive
file lock, so several test workers that need the same library at once
build it one time and never load a half-written file.  A failed compiler
run raises, naming the command; nothing degrades to another path.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE_DIR / "_build"
CSRC_DIR = PACKAGE_DIR / "csrc"

# Route (b) of the Hopper build: nvcc straight to a shared library with a
# plain C interface; no PyTorch headers, so it builds in seconds.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def library_path(name: str, source: Path, command: Sequence[str]) -> Path:
    """``_build/lib{name}-{hash}.so``: the hash covers ``source``, every
    ``*.cuh`` header in its directory (name and bytes, in name order) and
    ``command``."""
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(b"\0" + header.name.encode() + b"\0")
        digest.update(header.read_bytes())
    digest.update("\0".join(command).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_library(name: str, source: Path, command: Sequence[str]) -> Path:
    """Compile ``source`` with ``command`` (compiler argv without the output
    and source) into ``library_path(name, source, command)`` unless it
    exists."""
    source = Path(source)
    out = library_path(name, source, command)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        argv = [*command, "-o", str(tmp), str(source)]
        try:
            proc = subprocess.run(argv, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"compiler not found: {' '.join(argv)}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"build failed (exit {proc.returncode}): {' '.join(argv)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    return out


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


@functools.lru_cache(maxsize=None)
def load_cuda_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/{name}.cu`` for sm_90a (at first use) and load it."""
    path = build_library(
        name, CSRC_DIR / f"{name}.cu", [nvcc_path(), *NVCC_FLAGS]
    )
    return ctypes.CDLL(str(path))
