"""Frozen least times of the port's kernels on one NVIDIA H100 (SXM).

Copied from ``chip_smoke.py``'s bound functions and frozen here, so that a
change to the program cannot move the yardstick. Each function gives the
least time of one launch in seconds: the larger of the bytes the call has to
move over the memory rate and the operations it has to do over the peak rate
of its type. Bytes count each input read once and each output written once.

Peaks: the H100 SXM data sheet, dense, at its 700 W limit.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def least_time(nbytes: float, flops: float, dtype: str) -> float:
    """max(bytes / memory rate, operations / peak rate of `dtype`), s."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def rmsnorm(rows: int, d: int, dtype: str, scale_dtype: str) -> float:
    """x read once, out written once, scale read once; about 4 float32
    operations an element."""
    nbytes = 2 * rows * d * ITEMSIZE[dtype] + d * ITEMSIZE[scale_dtype]
    return max(nbytes / PEAK_BYTES_PER_S,
               4.0 * rows * d / PEAK_FLOPS["float32"])


def rmsnorm_backward(rows: int, d: int, dtype: str, scale_dtype: str) -> float:
    """x and g read once, dx written once, scale read and dscale written
    once; about 10 float32 operations an element."""
    nbytes = 3 * rows * d * ITEMSIZE[dtype] + 2 * d * ITEMSIZE[scale_dtype]
    return max(nbytes / PEAK_BYTES_PER_S,
               10.0 * rows * d / PEAK_FLOPS["float32"])


def attention_pairs(sq: int, skv: int, causal: bool) -> int:
    """The (query, key) pairs a query block of `sq` rows sees."""
    if not causal:
        return sq * skv
    # sum over i < sq of min(i + 1, skv)
    full = min(sq, skv)
    return full * (full + 1) // 2 + (sq - full) * skv


def flash_attention(B: int, sq: int, skv: int, H: int, Hkv: int, D: int,
                    causal: bool, dtype: str) -> float:
    """q, k, v and the output moved once each, against 4 D operations for
    every visible (query, key) pair at the peak rate of the inputs' type."""
    nbytes = ITEMSIZE[dtype] * D * (2 * B * sq * H + 2 * B * skv * Hkv)
    flops = 4.0 * D * attention_pairs(sq, skv, causal) * B * H
    return least_time(nbytes, flops, dtype)
