"""The yardstick: the H100's published peaks and the least time a
kernel's work could take at them.

NVIDIA H100 SXM data sheet, dense rates: 989 TFLOP/s in bf16 on the
tensor cores, 67 TFLOP/s in f32 outside them, 3.35 TB/s of HBM. A
roofline share is the least time (the larger of operations over the
peak rate and bytes over the memory rate) over the measured time.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


def bound_s(ops: float, nbytes: float, ops_per_s: float) -> float:
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)


def k1_bound_s(rows: int, k: int, t: int, branches) -> float:
    """K1, the per-row top-t selection of (rows, k) f32 scores: each
    input byte read once and each (value, class) output written once;
    operations from the rows' branches (branches = rows with no
    candidate, with 1..t, with more than t): a key and a compare an
    element, a 64-wide bitonic network of 672 compare-exchanges a row
    with candidates, 4 histogram passes over k a row with more than t,
    at the f32 rate."""
    nbytes = rows * k * 4 + rows * t * 8
    w = (t + 63) // 64
    ops = (rows * k * 2 + (branches[1] + branches[2]) * 672 * w
           + branches[2] * 4 * k * 2 * w)
    return bound_s(ops, nbytes, F32_OPS_PER_S)


def attn_bound_s(heads: int, head_dim: int, pairs: float,
                 elems_in: float, elems_out: float, rows: float,
                 elem_bytes: int, ops_per_s: float) -> float:
    """An attention forward: 4 * heads * head_dim FLOPs a visible
    (query, key) pair (pairs summed over the batch), against q, k, v
    read once and the output and its f32 log-sum-exp written once."""
    nbytes = (elems_in + elems_out) * elem_bytes + rows * 4
    return bound_s(4.0 * heads * head_dim * pairs, nbytes, ops_per_s)
