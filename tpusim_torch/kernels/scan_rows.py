"""Wrapper of the ``scan_rows`` CUDA kernel and its plain versions.

The kernel (``tpusim_torch/csrc/scan_rows.cu``) is the counterpart of the
JAX package's lane-axis scan backend ``jax_scan_rows``
(``tpusim/fastpath/jax_backend.py:74-93``): row-seeded serial float64
scans, one lane per column of an ops-major matrix.  It has two entries:

* :func:`scan_rows` — one scan of every row of ``[k, S]`` from ``[S]``
  seeds, every partial sum returned (``[k+1, S]``);
* :func:`scan_segments` — the scans of one run step of the batched pricer
  in one launch: each segment gathers its rows of the matrix through an
  index array and returns its whole chain or only its end.
  :func:`pack_segments` packs a step's segments into a
  :class:`SegmentPlan` (an int64 table, then the indices) and
  :func:`unpack_segments` splits the launch's output back per segment.

A CUDA tensor goes to the kernel, which raises if it cannot build or
launch; a CPU tensor goes to the plain version (:func:`scan_rows_reference`,
:func:`scan_segments_reference`).  There is no other route.  Every result
is, for lane ``s``, ``cumsum([seed[s], *rows[:, s]])`` as a strict
left-to-right chain of float64 adds, so the kernel's and the plain
version's are equal byte for byte (and equal to the pricing walk's ``+=``
sequence).  Both entries add one to the one launch counter.
"""

from __future__ import annotations

import ctypes

import torch

from tpusim_torch.kernels.build import load_library

__all__ = ["SegmentPlan", "check_inputs", "launch_count", "pack_segments",
           "reset_launch_count", "scan_rows", "scan_rows_reference",
           "scan_segments", "scan_segments_reference", "unpack_segments"]

#: launches of the CUDA kernel in this process, by either entry (the
#: wrappers add one per launch and nowhere else)
_launches = 0

#: the columns of a segment's row of the table: offset of its rows in the
#: index array, length, first output row, full chain (1) or end only (0)
TABLE_COLS = 4
#: the kernel's row numbers are 32-bit
MAX_ROWS = 2 ** 31


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


# ---------------------------------------------------------------------------
# Segments: the scans of one run step
# ---------------------------------------------------------------------------


class SegmentPlan:
    """A run step's segments packed for one launch.

    ``head`` is one int64 tensor: the table (``[n_seg, 4]``, see
    :data:`TABLE_COLS`) followed by the index array (``n_idx`` rows).
    ``spans`` holds each segment's (first output row, length, full) for
    unpacking, and ``out_rows`` is the output's height."""

    __slots__ = ("head", "n_seg", "n_idx", "spans", "out_rows")

    def __init__(self, head, n_seg, n_idx, spans, out_rows):
        self.head = head
        self.n_seg = n_seg
        self.n_idx = n_idx
        self.spans = spans
        self.out_rows = out_rows

    def split(self, head: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The table (``[n_seg, 4]``) and the index array of ``head``, or
        of a copy of it on another device."""
        cut = TABLE_COLS * self.n_seg
        return (head[:cut].view(self.n_seg, TABLE_COLS),
                head[cut:cut + self.n_idx])


def pack_segments(segments) -> SegmentPlan:
    """Pack ``[(rows, full), ...]`` — each a sequence (or int64 tensor) of
    row numbers and whether the whole chain is wanted — into a
    :class:`SegmentPlan`, segments in the given order."""
    table: list[int] = []
    idx: list[int] = []
    spans = []
    orow = 0
    for rows, full in segments:
        rows = rows.tolist() if isinstance(rows, torch.Tensor) else list(rows)
        full = bool(full)
        table += [len(idx), len(rows), orow, int(full)]
        spans.append((orow, len(rows), full))
        idx += rows
        orow += len(rows) + 1 if full else 1
    if not spans:
        raise ValueError("a segment plan needs at least one segment")
    if idx and not 0 <= min(idx) <= max(idx) < MAX_ROWS:
        raise ValueError(f"row numbers must lie in [0, 2^31); got "
                         f"{min(idx)} .. {max(idx)}")
    head = torch.tensor(table + idx, dtype=torch.int64)
    return SegmentPlan(head, len(spans), len(idx), spans, orow)


def unpack_segments(plan: SegmentPlan, out: torch.Tensor
                    ) -> list[torch.Tensor]:
    """Split a launch's ``[out_rows, S]`` output per segment: a full
    segment's ``[len+1, S]`` chain (row 0 the seeds), an end-only
    segment's ``[S]`` ends."""
    return [out[orow:orow + ln + 1] if full else out[orow]
            for orow, ln, full in plan.spans]


def _check_segment_inputs(mat, idx, table, seeds) -> None:
    if mat.dim() != 2 or mat.dtype != torch.float64:
        raise ValueError(f"mat must be a float64 [ops, S] matrix; got "
                         f"{mat.dtype} {tuple(mat.shape)}")
    if seeds.dim() != 2 or seeds.dtype != torch.float64 \
            or seeds.shape[1] != mat.shape[1] or seeds.shape[1] < 1:
        raise ValueError(f"seeds must be float64 [n_seg, S] with S = "
                         f"{mat.shape[1]} >= 1; got {seeds.dtype} "
                         f"{tuple(seeds.shape)}")
    if table.dtype != torch.int64 or idx.dtype != torch.int64 \
            or tuple(table.shape) != (seeds.shape[0], TABLE_COLS) \
            or idx.dim() != 1:
        raise ValueError(f"table must be int64 [{seeds.shape[0]}, "
                         f"{TABLE_COLS}] and idx int64 [n]; got "
                         f"{table.dtype} {tuple(table.shape)}, {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if len({mat.device, idx.device, table.device, seeds.device}) != 1:
        raise ValueError("mat, idx, table and seeds must lie on one device")


def scan_segments_reference(mat: torch.Tensor, idx: torch.Tensor,
                            table: torch.Tensor, seeds: torch.Tensor,
                            out_rows: int) -> torch.Tensor:
    """The plain version of :func:`scan_segments`: per segment, the serial
    scan (``torch.cumsum`` on the CPU) of its seeds followed by its rows
    of ``mat`` gathered through ``idx``, written whole or as its end."""
    S = mat.shape[1]
    out = torch.empty((out_rows, S), dtype=torch.float64, device=mat.device)
    for (off, ln, orow, full), seed in zip(table.tolist(), seeds):
        chain = torch.empty((ln + 1, S), dtype=torch.float64,
                            device=mat.device)
        chain[0] = seed
        chain[1:] = mat[idx[off:off + ln]]
        chain.cumsum_(0)
        if full:
            out[orow:orow + ln + 1] = chain
        else:
            out[orow] = chain[-1]
    return out


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (built and
    loaded once per process)."""
    lib = load_library("scan_rows")
    fn = lib.tpusim_scan_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        seg = lib.tpusim_scan_segments
        seg.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
        seg.restype = ctypes.c_int
        lib.tpusim_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpusim_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.tpusim_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def _cuda_scan(seeds: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    global _launches
    if not (seeds.is_contiguous() and mat.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous seeds and mat")
    k, lanes = mat.shape
    if k >= MAX_ROWS:
        raise ValueError(f"scan_rows takes fewer than 2^31 rows; got {k}")
    lib = _library()
    out = torch.empty((k + 1, lanes), dtype=torch.float64, device=mat.device)
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream(mat.device).cuda_stream
        err = lib.tpusim_scan_rows(seeds.data_ptr(), mat.data_ptr(),
                                   out.data_ptr(), lanes, k, stream)
    _raise_on(lib, err, "scan_rows")
    _launches += 1
    return out


def _cuda_segments(mat, idx, table, seeds, out_rows: int) -> torch.Tensor:
    global _launches
    if not (idx.is_contiguous() and table.is_contiguous()
            and seeds.is_contiguous()) or min(mat.stride()) < 0:
        raise ValueError("the CUDA kernel takes contiguous idx, table and "
                         "seeds and a matrix with non-negative strides")
    if mat.shape[0] >= MAX_ROWS:
        raise ValueError(f"scan_segments takes fewer than 2^31 rows; got "
                         f"{mat.shape[0]}")
    lib = _library()
    lanes = mat.shape[1]
    out = torch.empty((out_rows, lanes), dtype=torch.float64,
                      device=mat.device)
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream(mat.device).cuda_stream
        err = lib.tpusim_scan_segments(
            mat.data_ptr(), mat.stride(0), mat.stride(1), idx.data_ptr(),
            table.data_ptr(), seeds.data_ptr(), out.data_ptr(), lanes,
            seeds.shape[0], stream)
    _raise_on(lib, err, "scan_segments")
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


def scan_segments(mat: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
                  seeds: torch.Tensor, out_rows: int) -> torch.Tensor:
    """The scans of a run step in one launch: ``mat`` is ``[ops, S]``
    float64, ops-major, and may be a column expanded over the lanes (lane
    stride 0); ``idx``, ``table`` and ``seeds`` are a
    :class:`SegmentPlan`'s (``seeds`` ``[n_seg, S]``); returns
    ``[out_rows, S]``.  Row numbers must lie below ``mat.shape[0]``.  The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_segment_inputs(mat, idx, table, seeds)
    if mat.is_cuda:
        return _cuda_segments(mat, idx, table, seeds, out_rows)
    if mat.device.type == "cpu":
        return scan_segments_reference(mat, idx, table, seeds, out_rows)
    raise ValueError(f"no scan_segments for device {mat.device}")
