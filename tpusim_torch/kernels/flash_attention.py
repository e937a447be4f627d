"""Wrapper of the flash-attention CUDA kernel and its plain version.

The kernel (``tpusim_torch/csrc/flash_attention.cu``) replaces the TPU
kernel ``_attn_kernel`` of ``tpusim/models/pallas_attention.py``.  A CUDA
tensor goes to the kernel, which raises if it cannot build or launch; a
CPU tensor goes to :func:`flash_attention_reference`.  There is no other
route.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpusim_torch.kernels.build import load_library

__all__ = ["flash_attention_fwd", "flash_attention_reference",
           "check_inputs", "launch_count", "reset_launch_count"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128

#: launches of the CUDA kernel in this process (the wrapper adds one per
#: launch and nowhere else)
_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_q: int) -> None:
    """Raise on what neither the kernel nor the plain version takes."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one [BH, S, D] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"q, k, v must all be float32 or bfloat16; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    bh, s, d = q.shape
    if bh < 1 or s < 1 or d < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM} is not supported")
    bq = min(block_q, s)
    if bq < 1 or s % bq:
        # the TPU grid floors S // block_q and leaves the tail rows
        # unwritten; the port refuses such shapes instead
        raise ValueError(
            f"sequence length {s} is not a multiple of block_q {bq}"
        )


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """softmax(Q Kᵀ / √D) V in float32, cast back to the input dtype —
    the same arithmetic as the TPU kernel, in plain PyTorch."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return (torch.matmul(p, vf) / l).to(q.dtype)


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (built and
    loaded once per process)."""
    lib = load_library("flash_attention")
    fn = lib.tpusim_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tpusim_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpusim_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_fwd(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    global _launches
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous q, k, v")
    lib = _library()
    fn = lib.tpusim_flash_attention_fwd
    bh, s, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, s, d, _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d), stream)
    if err != 0:
        msg = lib.tpusim_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg}")
    _launches += 1
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_q: int = 128) -> torch.Tensor:
    """Attention over ``[BH, S, D]``: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  ``block_q`` only decides which
    shapes are taken (the TPU grid's query block); the kernel picks its
    own tiles."""
    check_inputs(q, k, v, block_q)
    if q.is_cuda:
        return _cuda_fwd(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    raise ValueError(f"no flash_attention for device {q.device}")
