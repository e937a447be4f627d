"""Build and load the port's CUDA kernels.

Each ``tpusim_torch/csrc/*.cu`` source is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with :mod:`ctypes`.  The build happens at first use, into
``build/tpusim_torch_kernels/<name>-<hash>/`` under the repo root (listed
in ``.gitignore``); the hash covers the source, every ``csrc/*.cuh`` header
and the flags, so a changed source or header rebuilds and an unchanged one
is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_library",
           "library_path", "load_library", "nvcc_command"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpusim_torch_kernels"

#: ``-Xptxas -v`` puts each kernel's registers, shared memory and spills
#: in the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME); the CUDA "
        "kernels of tpusim_torch are built from source at first use"
    )


def _key(source: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    source = CSRC_DIR / f"{name}.cu"
    return BUILD_DIR / f"{name}-{_key(source)}" / f"lib{name}.so"


def nvcc_command(name: str, output: Path,
                 nvcc: str | None = None) -> list[str]:
    """The nvcc command line that builds ``csrc/<name>.cu``."""
    return [nvcc or _find_nvcc(), *NVCC_FLAGS, "-o", str(output),
            str(CSRC_DIR / f"{name}.cu")]


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for this exact source
    is already built; returns its path.  Raises with nvcc's output when the
    build fails."""
    so = library_path(name)
    if so.is_file():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        nvcc_command(name, tmp), capture_output=True, text=True,
    )
    (so.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name} (rc={proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    # the library's blocks reach disk before it is published under the
    # name every later process loads
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, so)
    return so


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build_library(name)))
        return lib
