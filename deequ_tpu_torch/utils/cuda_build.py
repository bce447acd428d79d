"""Build the package's CUDA sources into shared libraries, at first use.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``deequ_tpu_torch/_build/``, then
loaded with ``ctypes``. A library is named by a digest of its source and
flags, so an edited source builds anew and an unchanged one loads from
the last build. Nothing is compiled when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler=-fPIC",
    "-Xptxas=-v",
)


def nvcc_path() -> str:
    for candidate in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc was not found (looked on PATH and in /usr/local/cuda/bin); "
        "the CUDA kernels of deequ_tpu_torch are built from source at "
        "first use"
    )


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(
        source.read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_library(source: Path) -> Path:
    """Compile ``source`` unless its library exists; returns the
    library's path. The compiler's report (registers, shared memory,
    spills) is kept beside it as ``.log``. Concurrent builds of one
    source are safe: each writes its own temporary file and the last
    rename wins with an identical library."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
        check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load_library(source: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(source)))
