"""Wrappers of the flash-attention CUDA kernels and their plain versions.

``tpusim_torch/csrc/flash_attention.cu`` replaces the TPU kernel
``_attn_kernel`` of ``tpusim/models/pallas_attention.py``
(:func:`flash_attention_fwd`, over ``[BH, S, D]``).  The causal kernel,
``tpusim_torch/csrc/flash_attention_wgmma.cu`` (wgmma, TMA and warp
specialisation; :func:`causal_attention_fwd`), replaces no TPU kernel but
the decoders' score chain: the Llama decoder's attention over ``[B, S, H,
D]`` queries and ``[B, S, KVH, D]`` grouped keys and values, read in
place, and DeepSeek-V2's latent attention, whose queries and keys have
another head dim than its values (192 and 128) and whose softmax scale is
not ``1 / sqrt(D)``.  It takes bfloat16 at the (q.k, v) head dims of
:data:`WGMMA_HEAD_DIMS` (:func:`causal_kernel_takes`); a decoder runs the
score chain outside that domain.  A CUDA tensor goes to a kernel, which
raises on what it does not take and when it cannot build or launch; a CPU
tensor goes to the plain version (:func:`flash_attention_reference`,
:func:`causal_attention_reference`).  There is no other route.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpusim_torch.kernels.build import load_library

__all__ = ["flash_attention_fwd", "flash_attention_reference",
           "check_inputs", "launch_count", "reset_launch_count",
           "causal_attention_fwd", "causal_attention_reference",
           "check_causal_inputs", "causal_kernel_takes",
           "causal_launch_count", "reset_causal_launch_count"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
#: the plain causal version's query/key head dim when the values' differs
#: (theirs at most :data:`MAX_HEAD_DIM`)
MAX_QK_HEAD_DIM = 192

#: the (q.k, v) head dims the causal kernel is built for
WGMMA_HEAD_DIMS = ((128, 128), (192, 128))

#: launches of the non-causal and of the causal kernel in this process (each
#: wrapper adds one per launch and nowhere else)
_launches = 0
_causal_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def causal_launch_count() -> int:
    return _causal_launches


def reset_causal_launch_count() -> None:
    global _causal_launches
    _causal_launches = 0


def _check_types(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"q, k, v must all be float32 or bfloat16; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_q: int) -> None:
    """Raise on what neither the kernel nor the plain version takes."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one [BH, S, D] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    _check_types(q, k, v)
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


#: each library's C entries: name -> (count of pointer, int arguments);
#: every entry ends with a float (the scale) and the stream
_ENTRIES = {
    "flash_attention": {"tpusim_flash_attention_fwd": (4, 4)},
    "flash_attention_wgmma": {"tpusim_causal_attention_wgmma_fwd": (4, 10)},
}


def _library(name: str = "flash_attention") -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` with its C signatures
    declared (built and loaded once per process)."""
    lib = load_library(name)
    if lib.tpusim_cuda_error_string.restype is not ctypes.c_char_p:
        for entry, (ptrs, ints) in _ENTRIES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.tpusim_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpusim_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _on_stream(x: torch.Tensor, launch) -> int:
    """``launch(stream)`` on the current stream of ``x``'s card; returns
    its cudaError_t."""
    with torch.cuda.device(x.device):
        return launch(torch.cuda.current_stream(x.device).cuda_stream)


def _check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.tpusim_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def _cuda_fwd(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    global _launches
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous q, k, v")
    lib = _library()
    bh, s, d = q.shape
    out = torch.empty_like(q)
    err = _on_stream(q, lambda stream: lib.tpusim_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d,
        _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d), stream))
    _check_launch(lib, err, "flash_attention")
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


def check_causal_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise on what the causal plain version does not take (the kernel
    takes less: :func:`causal_kernel_takes`): q ``[B, S, H, D]``, k ``[B,
    S, KVH, D]`` and v ``[B, S, KVH, DV]`` with ``H`` a multiple of
    ``KVH``, float32 or bfloat16 on one device; ``D = DV`` at most
    :data:`MAX_HEAD_DIM`, or ``D`` at most :data:`MAX_QK_HEAD_DIM` and
    ``DV`` at most :data:`MAX_HEAD_DIM`."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(
            f"q must be [B, S, H, D], k [B, S, KVH, D] and v [B, S, KVH, DV]; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(
            f"k and v {tuple(k.shape)} do not match q {tuple(q.shape)} in "
            f"batch, sequence and head dim"
        )
    _check_types(q, k, v)
    if min(b, s, h, d, kvh, dv) < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} "
                         f"key/value heads")
    if dv > MAX_HEAD_DIM or d > (MAX_HEAD_DIM if d == dv
                                 else MAX_QK_HEAD_DIM):
        raise ValueError(f"head dims {d} (q, k) and {dv} (v) are not "
                         f"supported: one dim of at most {MAX_HEAD_DIM}, or "
                         f"q, k at most {MAX_QK_HEAD_DIM} and v at most "
                         f"{MAX_HEAD_DIM}")


def causal_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               scale: float | None = None) -> torch.Tensor:
    """softmax(Q Kᵀ · scale, keys j <= i of row i) V over ``[B, S, H, D]``
    in float32 (``scale``: ``1 / √D`` when None), cast back to the input
    dtype: query head ``h`` reads key/value head ``h // (H / KVH)``; the
    output has v's head dim.  The causal kernel's arithmetic in plain
    PyTorch."""
    b, s, h, d = q.shape
    kv = torch.arange(h, device=q.device) // (h // k.shape[2])
    qf = q.float().transpose(1, 2)
    kf = k.float().index_select(2, kv).transpose(1, 2)
    vf = v.float().index_select(2, kv).transpose(1, 2)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.matmul(p, vf).transpose(1, 2).contiguous().to(q.dtype)


def _rows_apart(x: torch.Tensor) -> int | None:
    """The elements between two rows of ``x`` [B, S, heads, D] when its
    heads and head dim are packed and its batches follow each other (the
    layout the causal kernel reads), else None."""
    b, s, h, d = x.shape
    row = x.stride(1)
    packed = (x.stride(3) == 1 or d == 1) and (x.stride(2) == d or h == 1)
    batches = x.stride(0) == s * row or b == 1
    return row if packed and batches and row >= h * d else None


def _rows_and_heads(x: torch.Tensor) -> tuple[int, int] | None:
    """The elements between two rows and between two heads of ``x`` [B, S,
    heads, D] when each head's D elements are packed, its heads lie apart
    in a row and its batches follow each other, else None."""
    b, s, h, d = x.shape
    row, head = x.stride(1), (x.stride(2) if h > 1 else d)
    packed = (x.stride(3) == 1 or d == 1) and head >= d
    batches = x.stride(0) == s * row or b == 1
    return (row, head) if packed and batches and row >= (h - 1) * head + d \
        else None


def _causal_strides(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> tuple[int, int, int, int]:
    """The elements between two rows of q, of k and of v and between two
    heads of v, as the causal kernel reads them; raises on another
    layout."""
    d, dv = q.shape[3], v.shape[3]
    ldq, ldk = _rows_apart(q), _rows_apart(k)
    if d == dv:
        lv = (ldk, d) if _rows_apart(v) == ldk else None
    else:
        lv = _rows_and_heads(v)
    if ldq is None or ldk is None or lv is None:
        raise ValueError(
            "the causal kernel takes q, k whose rows hold their heads packed, "
            "and v laid out as k (with two head dims: the head dim of each "
            f"of its heads packed); got strides {q.stride()}, {k.stride()}, "
            f"{v.stride()}")
    return ldq, ldk, *lv


def causal_kernel_takes(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> bool:
    """Whether the causal kernel is built for ``q, k, v`` (as
    :func:`check_causal_inputs` takes them): bfloat16 at (q.k, v) head dims
    in :data:`WGMMA_HEAD_DIMS`.  Reads only dtypes and shapes, so it
    answers for meta and fake tensors too."""
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and (q.shape[3], v.shape[3]) in WGMMA_HEAD_DIMS)


def _cuda_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Launch the causal kernel on q, k, v's card; raises before the launch
    on what it does not take: another dtype or head dims
    (:func:`causal_kernel_takes`), or a layout TMA cannot address (every
    tensor on a 16-byte boundary, its row and head strides whole 16-byte
    chunks)."""
    global _causal_launches
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"the causal kernel takes bfloat16 q, k, v; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if (d, dv) not in WGMMA_HEAD_DIMS:
        raise ValueError(f"the causal kernel takes (q.k, v) head dims "
                         f"{WGMMA_HEAD_DIMS}; got ({d}, {dv})")
    strides = ldq, ldk, ldv, hsv = _causal_strides(q, k, v)
    if any(x.data_ptr() % 16 for x in (q, k, v)) or \
            any(n % 8 for n in strides):
        raise ValueError(
            f"the causal kernel takes tensors on 16-byte boundaries whose "
            f"row and head strides are whole 16-byte chunks; got element "
            f"strides {strides}")
    out = q.new_empty((b, s, h, dv))
    lib = _library("flash_attention_wgmma")
    fn = lib.tpusim_causal_attention_wgmma_fwd
    err = _on_stream(q, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, kvh, d, dv, ldq, ldk, ldv, hsv, scale, stream))
    _check_launch(lib, err, "causal attention")
    _causal_launches += 1
    return out


def causal_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """Causal attention over q ``[B, S, H, D]``, grouped k ``[B, S, KVH,
    D]`` and v ``[B, S, KVH, DV]``, scores scaled by ``scale`` (``1 /
    √D`` when None), the output ``[B, S, H, DV]`` contiguous: the causal
    kernel for CUDA tensors (launched on the current stream; it allocates
    only the output and refuses what :func:`causal_kernel_takes` does
    not), the plain version for CPU tensors."""
    check_causal_inputs(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if q.is_cuda:
        return _cuda_causal(q, k, v, scale)
    if q.device.type == "cpu":
        return causal_attention_reference(q, k, v, scale)
    raise ValueError(f"no causal attention for device {q.device}")
