"""Wrapper of the ``scan_rows`` CUDA kernel and its plain version.

The kernel (``tpusim_torch/csrc/scan_rows.cu``) is the counterpart of the
JAX package's lane-axis scan backend ``jax_scan_rows``
(``tpusim/fastpath/jax_backend.py:74-93``): row-seeded serial float64
scans, one lane per column of an ops-major matrix.  A CUDA tensor goes to
the kernel, which raises if it cannot build or launch; a CPU tensor goes to
:func:`scan_rows_reference`.  There is no other route.

Both give, for lane ``s``, ``cumsum([seeds[s], *mat[:, s]])`` as a strict
left-to-right chain of float64 adds, so their results are equal byte for
byte (and equal to the pricing walk's ``+=`` sequence).
"""

from __future__ import annotations

import ctypes

import torch

from tpusim_torch.kernels.build import load_library

__all__ = ["check_inputs", "launch_count", "reset_launch_count",
           "scan_rows", "scan_rows_reference"]

#: launches of the CUDA kernel in this process (the wrapper adds one per
#: launch and nowhere else)
_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def check_inputs(seeds: torch.Tensor, mat: torch.Tensor) -> None:
    """Raise on what neither the kernel nor the plain version takes."""
    if seeds.dim() != 1 or mat.dim() != 2 or mat.shape[1] != seeds.shape[0]:
        raise ValueError(
            f"seeds must be [S] and mat ops-major [k, S]; got "
            f"{tuple(seeds.shape)}, {tuple(mat.shape)}"
        )
    if seeds.dtype != torch.float64 or mat.dtype != torch.float64:
        raise TypeError(
            f"seeds and mat must be float64; got {seeds.dtype}, {mat.dtype}"
        )
    if seeds.device != mat.device:
        raise ValueError("seeds and mat must lie on one device")
    if seeds.shape[0] < 1:
        raise ValueError("scan_rows needs at least one lane")


def scan_rows_reference(seeds: torch.Tensor, mat: torch.Tensor
                        ) -> torch.Tensor:
    """The plain version: ``[k+1, S]`` whose column ``s`` is the serial
    scan of ``seeds[s]`` followed by ``mat[:, s]`` (``torch.cumsum`` on
    the CPU is a strict serial scan)."""
    out = torch.empty((mat.shape[0] + 1, mat.shape[1]), dtype=torch.float64,
                      device=mat.device)
    out[0] = seeds
    out[1:] = mat
    return out.cumsum_(0)


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (built and
    loaded once per process)."""
    lib = load_library("scan_rows")
    fn = lib.tpusim_scan_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tpusim_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpusim_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_scan(seeds: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    global _launches
    if not (seeds.is_contiguous() and mat.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous seeds and mat")
    lib = _library()
    k, lanes = mat.shape
    out = torch.empty((k + 1, lanes), dtype=torch.float64, device=mat.device)
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream(mat.device).cuda_stream
        err = lib.tpusim_scan_rows(seeds.data_ptr(), mat.data_ptr(),
                                   out.data_ptr(), lanes, k, stream)
    if err != 0:
        msg = lib.tpusim_cuda_error_string(err).decode()
        raise RuntimeError(f"scan_rows kernel launch failed: {msg}")
    _launches += 1
    return out


def scan_rows(seeds: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Row-seeded serial scans of an ops-major ``[k, S]`` float64 matrix:
    returns ``[k+1, S]``.  The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    check_inputs(seeds, mat)
    if mat.is_cuda:
        return _cuda_scan(seeds, mat)
    if mat.device.type == "cpu":
        return scan_rows_reference(seeds, mat)
    raise ValueError(f"no scan_rows for device {mat.device}")
