"""Build and load ``libtpusim_native.so``, the host C++ library of the
HLO scanner, the pricing scan and the packet network.

The sources are ``native/{hlo_scan,ici_net,op_price}.cpp`` (read only),
compiled with ``native/Makefile``'s flags (``-ffp-contract=off`` keeps
every float add unfused, which the byte-identity of the native paths
rests on) into ``build/tpusim_torch_native/<hash>/libtpusim_native.so``
under the repo root, at first use; the hash covers the sources, the
compiler and the flags.  The library ``make -C native`` writes next to
the sources is never loaded.

Several processes may build at once (test workers, forked nodes): each
compiles into a file of its own and ``os.replace``-s it into place, so a
reader sees a whole library or none.  ``TPUSIM_NO_NATIVE`` turns the
library off; a build or load that fails warns once and leaves it off, so
the Python paths run — an explicit request for a native path then
raises (its consumer's check).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import warnings
from pathlib import Path

__all__ = ["BUILD_DIR", "CXX_FLAGS", "NATIVE_DIR", "SOURCES",
           "build_native", "build_seconds", "library_path",
           "load_shared_lib"]

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "tpusim_torch_native")
SOURCES = ("hlo_scan.cpp", "ici_net.cpp", "op_price.cpp")
#: ``native/Makefile``'s ``CXXFLAGS`` and its link flag
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-ffp-contract=off", "-shared")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False
#: wall seconds of this process's build (None: it loaded a built one)
_BUILD_S: float | None = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    return cxx


def library_path(cxx: str | None = None) -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256()
    h.update(" ".join((cxx or _cxx(), *CXX_FLAGS)).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libtpusim_native.so"


def build_native() -> Path:
    """Compile the library unless this exact build exists; returns its
    path.  Raises with the compiler's output when the build fails."""
    global _BUILD_S
    cxx = _cxx()
    so = library_path(cxx)
    if so.is_file():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}"
                       ".tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp),
         *(str(NATIVE_DIR / name) for name in SOURCES)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed to build libtpusim_native.so "
            f"(rc={proc.returncode}):\n{proc.stderr[-4000:]}")
    # the library's blocks reach disk before it is published under the
    # name every later process loads
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, so)
    _BUILD_S = time.perf_counter() - t0
    return so


def build_seconds() -> float | None:
    """Seconds this process spent compiling the library (None when it
    loaded one already built)."""
    return _BUILD_S


def load_shared_lib() -> ctypes.CDLL | None:
    """The library, built at first use and opened once per process, or
    None under ``TPUSIM_NO_NATIVE`` or when it cannot be built or loaded
    (one warning).  No symbol setup: each consumer declares and
    version-checks its own entry points."""
    global _LIB, _TRIED
    if os.environ.get("TPUSIM_NO_NATIVE"):
        return None
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            try:
                _LIB = ctypes.CDLL(str(build_native()))
            except (OSError, RuntimeError) as e:
                warnings.warn(
                    f"tpusim_torch: libtpusim_native.so is unavailable, the "
                    f"Python paths run instead: {e}",
                    RuntimeWarning, stacklevel=2)
        return _LIB
