"""Wrapper of the RMSNorm CUDA kernel and its plain version.

``tpusim_torch/csrc/rms_norm.cu`` replaces no TPU kernel: the reference's
``_rmsnorm`` (``tpusim/models/llama.py``) is plain ``jnp``, which the port's
decoders ran as an eager chain of eight kernels (:func:`rms_norm_reference`,
what a captured graph holds).  The kernel reads each bfloat16 row once, at
the caller's row stride, and writes it once, with the chain's roundings
(:func:`rms_norm_takes` says which calls go to it).  A CUDA tensor goes to
the kernel, which raises on what it does not take and when it cannot build
or launch; a CPU tensor goes to the plain version.  There is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from tpusim_torch.kernels.build import load_library
from tpusim_torch.kernels.flash_attention import _check_launch, _on_stream

__all__ = ["MAX_DIM", "rms_norm_fwd", "rms_norm_reference", "rms_norm_takes",
           "launch_count", "reset_launch_count"]

#: the widest row the kernel holds in registers: 1,024 threads of four
#: 16-byte vectors (``MAX_DIM`` in the source)
MAX_DIM = 1024 * 4 * 8

#: launches of the kernel in this process (the wrapper adds one per launch
#: and nowhere else)
_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """RMSNorm of ``x`` over its last dim, as the reference writes it: the
    mean of the squares in float32, ``rsqrt`` of it plus ``eps``, the
    product rounded to ``x``'s dtype, then times ``w``."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * w


def _row_stride(x: torch.Tensor) -> int | None:
    """The elements between two rows of ``x`` when its last dim is packed
    and its rows lie evenly apart, else None."""
    if x.dim() == 0 or (x.stride(-1) != 1 and x.shape[-1] != 1):
        return None
    ld = span = None
    for size, stride in zip(reversed(x.shape[:-1]),
                            reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if span is None:
            ld = stride
        elif stride != span:
            return None
        span = stride * size
    ld = x.shape[-1] if ld is None else ld
    return ld if ld >= x.shape[-1] else None


def rms_norm_takes(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether a norm of ``x [..., D]`` with weight ``w`` goes to the
    kernel: both bfloat16, D a multiple of 8 up to :data:`MAX_DIM`.  Reads
    only dtypes and shapes, so it answers for meta tensors too.  A layout
    the kernel cannot read (``x``'s rows not packed or not evenly apart by a
    multiple of 8 elements, ``w`` not a packed ``[D]``, a base off a
    16-byte boundary) reaches it and raises there."""
    return (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and x.dim() > 0 and 0 < x.shape[-1] <= MAX_DIM
            and x.shape[-1] % 8 == 0)


def _checked_row_stride(x: torch.Tensor, w: torch.Tensor) -> int:
    """``x``'s row stride, where the kernel takes ``x, w``; raises on what
    it does not take."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the RMSNorm kernel takes bfloat16 x and w; got "
                        f"{x.dtype}, {w.dtype}")
    if not rms_norm_takes(x, w) or x.numel() // x.shape[-1] >= 2 ** 31:
        raise ValueError(f"the RMSNorm kernel takes rows of a multiple of 8 "
                         f"elements up to {MAX_DIM}, fewer than 2^31 of "
                         f"them; got {tuple(x.shape)}")
    ld = _row_stride(x)
    if w.dim() != 1 or w.shape[0] != x.shape[-1] or w.stride(0) != 1 \
            or ld is None or ld % 8 or x.data_ptr() % 16 \
            or w.data_ptr() % 16:
        raise ValueError(f"the RMSNorm kernel takes x [..., D] of packed "
                         f"rows evenly apart by a multiple of 8 elements and "
                         f"a packed w [D], both on 16-byte boundaries; got "
                         f"{tuple(x.shape)} strides {x.stride()}, "
                         f"{tuple(w.shape)} strides {w.stride()}")
    return ld


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (built and
    loaded once per process)."""
    lib = load_library("rms_norm")
    if lib.tpusim_cuda_error_string.restype is not ctypes.c_char_p:
        fn = lib.tpusim_rms_norm_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tpusim_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpusim_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_rms_norm(x: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Launch the kernel on ``x``'s card; raises before the launch on a
    dtype, width or layout it does not take.  No rows launch nothing."""
    global _launches
    ld = _checked_row_stride(x, w)
    dim = x.shape[-1]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    err = _on_stream(x, lambda stream: lib.tpusim_rms_norm_fwd(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // dim, dim,
        ld, eps, stream))
    _check_launch(lib, err, "rms_norm")
    _launches += 1
    return out


def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """RMSNorm of ``x [..., D]`` with weight ``w [D]``, the output packed in
    ``x``'s shape: the kernel for CUDA tensors (launched on the current
    stream; it allocates only the output), the plain version for CPU
    tensors."""
    if x.is_cuda:
        return _cuda_rms_norm(x, w, float(eps))
    if x.device.type == "cpu":
        return rms_norm_reference(x, w, eps)
    raise ValueError(f"no rms_norm for device {x.device}")
