"""ctypes bridge to the native pricing scan (``native/op_price.cpp``).

Port of ``tpusim/fastpath/native.py``.  Same shape as the HLO-scanner
bridge (:mod:`tpusim_torch.trace.native`): the shared library is optional,
``TPUSIM_NO_NATIVE`` is honoured through the shared loader, the ABI is
version-checked, and the ``torch.cumsum`` path is always available as a
byte-identical fallback.

The kernel is deliberately tiny: one fused **serial** scan over a run of
pre-transformed sync-op columns, accumulating the seven walk
accumulators (core clock, flops, mxu_flops, transcendentals, hbm_bytes,
vmem_bytes, vmem_spill_bytes) in exactly the serial walk's float order.
C ``double`` arithmetic is IEEE-754 binary64 like CPython floats and
torch's float64 (the library is built with ``-ffp-contract=off`` so no
FMA contraction reassociates an add), which is what makes the native
path byte-identical rather than merely close.

The columns are float64 CPU tensors passed by ``data_ptr()``: each must
be contiguous (a strided view raises, the kernel never reads strided
memory).
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "native_batch_available",
    "native_price_available",
    "price_scan",
    "price_scan_batch",
]

_LIB: ctypes.CDLL | None = None
_LIB_TRIED = False
_BATCH: ctypes.CDLL | None = None
_BATCH_TRIED = False

_ACC_SLOTS = 7  # [t, flops, mxu, trans, hbm, vmem, spill]

#: native scans run in this process (one per call of either entry; the
#: chip check reads it to show the native path was taken)
SCAN_CALLS = 0


def _load() -> ctypes.CDLL | None:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    from tpusim_torch.kernels.native_build import load_shared_lib

    lib = load_shared_lib()
    if lib is None:
        return None
    try:
        lib.op_price_abi_version.restype = ctypes.c_int
        if lib.op_price_abi_version() != 1:
            return None
        lib.op_price_scan.restype = None
        lib.op_price_scan.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),  # dur
            ctypes.POINTER(ctypes.c_double),  # flops
            ctypes.POINTER(ctypes.c_double),  # mxu
            ctypes.POINTER(ctypes.c_double),  # trans
            ctypes.POINTER(ctypes.c_double),  # hbm
            ctypes.POINTER(ctypes.c_double),  # vmem
            ctypes.POINTER(ctypes.c_double),  # spilled (may be NULL)
            ctypes.POINTER(ctypes.c_double),  # acc[7], in/out
            ctypes.POINTER(ctypes.c_double),  # t_before (may be NULL)
        ]
        _LIB = lib
    except (OSError, AttributeError):
        return None
    return _LIB


def native_price_available() -> bool:
    """True when the op_price kernel is loadable (library built, ABI
    matches, ``TPUSIM_NO_NATIVE`` unset)."""
    return _load() is not None


def _load_batch() -> ctypes.CDLL | None:
    """The scenario-batched scan, probed separately (a library without
    it still serves the scalar scan; the batch path then runs on the
    host's row scans, byte-identical either way)."""
    global _BATCH, _BATCH_TRIED
    if _BATCH_TRIED:
        return _BATCH
    _BATCH_TRIED = True
    lib = _load()
    if lib is None:
        return None
    try:
        lib.op_price_batch_abi_version.restype = ctypes.c_int
        if lib.op_price_batch_abi_version() != 1:
            return None
        lib.op_price_scan_batch.restype = None
        lib.op_price_scan_batch.argtypes = [
            ctypes.c_int64,                   # lanes
            ctypes.c_int64,                   # n
            ctypes.POINTER(ctypes.c_double),  # dur (lanes*n, lane-major)
            ctypes.POINTER(ctypes.c_double),  # flops (shared, n)
            ctypes.POINTER(ctypes.c_double),  # mxu
            ctypes.POINTER(ctypes.c_double),  # trans
            ctypes.POINTER(ctypes.c_double),  # hbm
            ctypes.POINTER(ctypes.c_double),  # vmem
            ctypes.POINTER(ctypes.c_double),  # spilled (may be NULL)
            ctypes.POINTER(ctypes.c_double),  # acc (lanes*7, in/out)
            ctypes.POINTER(ctypes.c_double),  # t_before (may be NULL)
        ]
        _BATCH = lib
    except (OSError, AttributeError):
        return None
    return _BATCH


def native_batch_available() -> bool:
    """True when the scenario-batched scan is loadable."""
    return _load_batch() is not None


_DP = ctypes.POINTER(ctypes.c_double)


def _ptr(t: torch.Tensor | None, shape: tuple[int, ...] | None = None):
    """``t``'s float64 storage as a ``double *`` (None stays NULL).
    Raises unless ``t`` is a contiguous float64 CPU tensor (of ``shape``
    when given): the kernel reads and writes it as one dense block."""
    if t is None:
        return None
    if (t.dtype != torch.float64 or t.device.type != "cpu"
            or not t.is_contiguous()):
        raise ValueError(
            f"native pricing scan needs contiguous float64 CPU tensors, "
            f"got {t.dtype} on {t.device} with strides {t.stride()}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"native pricing scan: shape {tuple(t.shape)} "
                         f"where {shape} is needed")
    return ctypes.cast(t.data_ptr(), _DP)


def price_scan(dur, flops, mxu, trans, hbm, vmem, spilled, acc,
               t_before=None) -> None:
    """Run the fused serial scan over one sync run.  All tensors are
    contiguous float64 of the run's length; ``acc`` is the 7-slot
    accumulator vector, updated in place.  ``spilled`` may be None (no
    vmem spill active); ``t_before`` receives the pre-op core clock when
    per-op aggregates are being collected."""
    global SCAN_CALLS
    lib = _load()
    assert lib is not None
    n = dur.shape[0]
    col = (n,)
    args = [_ptr(dur, col), _ptr(flops, col), _ptr(mxu, col),
            _ptr(trans, col), _ptr(hbm, col), _ptr(vmem, col),
            _ptr(spilled, col), _ptr(acc, (_ACC_SLOTS,)),
            _ptr(t_before, col)]
    SCAN_CALLS += 1
    lib.op_price_scan(n, *args)


def price_scan_batch(dur2, flops, mxu, trans, hbm, vmem, spilled, acc2,
                     t_before2=None) -> None:
    """Run the fused lane-major batch scan.  ``dur2`` is (lanes, n)
    contiguous float64 (per-lane transformed durations); the counter
    columns are the SHARED 1-D tensors (lane-invariant by the degrade /
    spill transform structure); ``acc2`` is (lanes, 7), updated in
    place; ``t_before2`` (lanes, n) receives each lane's pre-op clock
    when per-op aggregates are being collected."""
    global SCAN_CALLS
    lib = _load_batch()
    assert lib is not None
    lanes, n = dur2.shape
    col = (n,)
    args = [_ptr(dur2, (lanes, n)), _ptr(flops, col), _ptr(mxu, col),
            _ptr(trans, col), _ptr(hbm, col), _ptr(vmem, col),
            _ptr(spilled, col), _ptr(acc2, (lanes, _ACC_SLOTS)),
            _ptr(t_before2, (lanes, n))]
    SCAN_CALLS += 1
    lib.op_price_scan_batch(lanes, n, *args)
