"""Operations and bytes of a kernel, and the least time the card could
take for it: the larger of its operations over the peak rate and its
bytes over the peak bandwidth (each input read once, the output written
once)."""

from __future__ import annotations


def gemm_ops(m: int, n: int, k: int) -> float:
    """``[m, k] @ [k, n]``: two operations a multiply-add."""
    return 2.0 * m * n * k


def gemm_bytes(m: int, n: int, k: int, element_size: int) -> float:
    return float(element_size * (m * k + k * n + m * n))


def gemm_bound_s(gemms, element_size: int, peak_flops: float,
                 peak_bytes_s: float) -> tuple[float, float, float]:
    """``(bound seconds, seconds bound by operations, seconds bound by
    bytes)`` of ``gemms`` (``(m, n, k, count)`` each), summed call by
    call."""
    total = ops_s = bytes_s = 0.0
    for m, n, k, count in gemms:
        t_ops = gemm_ops(m, n, k) / peak_flops
        t_bytes = gemm_bytes(m, n, k, element_size) / peak_bytes_s
        total += count * max(t_ops, t_bytes)
        ops_s += count * t_ops
        bytes_s += count * t_bytes
    return total, ops_s, bytes_s
