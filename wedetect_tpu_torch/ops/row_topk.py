"""Per-row top-t (value, class) selection: kernel K1 of the port.

Replaces `wedetect_tpu/ops/pallas_topk.py` (`row_topk` and its Pallas
kernel `_row_topk_kernel`). `ops/nms._batched_select_topk` calls it in
the sparse branch of the pre-NMS selection: on the (B*A, K) thresholded
scores, once every anchor holds at most T = 64 candidates above
score_thr, it extracts them all per anchor before one sort over the
A*T remainder.

Contract (bit-identical to the Pallas kernel): per row, the top-t
values in descending order with their class ids; equal values come out
in ascending class order; once the finite values run out, each further
slot holds -inf and the lowest class index whose current value is -inf
(the Pallas kernel's `x == m` matches -inf lanes too). Signed zeros
follow XLA's max: the value is +0.0 while any +0.0 remains, the class
the lowest index equal to zero. A row that holds a NaN gives (that NaN,
K) in every slot, the NaN's bits kept (`jnp.max` propagates it, and
`x == m` then matches no lane); where the row holds several NaNs, the
Pallas interpreter reports the lowest-index NaN whose sign bit is set,
else the highest-index NaN.

`row_topk` launches the CUDA kernel (`csrc/row_topk.cu`) on a CUDA
tensor and runs `row_topk_plain` on a CPU tensor. There is no fallback:
a CUDA tensor that the kernel does not take raises. The kernel selects
by key, in one pass over the row; `row_topk_by_key` states its rule in
plain torch (only tests and chip_smoke.py call it), and the CPU tests
hold that rule bitwise to the Pallas kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch


def nan_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R,) bool: the rows of x (R, K) f32 that hold a NaN; (R,) int32:
    the bits of the NaN each such row reports (the lowest-index NaN with
    its sign bit set, else the highest-index NaN; 0 for other rows)."""
    k = x.shape[1]
    bits = x.view(torch.int32)
    nan = torch.isnan(x)
    iota = torch.arange(k, device=x.device)
    first_neg = torch.where(nan & (bits < 0), iota, k).min(dim=1).values
    last = torch.where(nan, iota, -1).max(dim=1).values
    pick = torch.where(first_neg < k, first_neg, last.clamp(min=0))
    has = nan.any(dim=1)
    return has, torch.where(has, bits.gather(1, pick[:, None])[:, 0], 0)


def row_topk_plain(scores: torch.Tensor, t: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: t rounds of iterative max
    with the kernel's tie rule. scores (R, K) f32 -> (vals (R, t) f32,
    cls (R, t) int32)."""
    r, k = scores.shape
    x = scores.to(torch.float32).contiguous()
    has_nan, nan_bits = nan_rows(x)
    x = torch.where(torch.isnan(x), float("-inf"), x)
    iota = torch.arange(k, dtype=torch.int32, device=x.device)
    vals = torch.empty((r, t), dtype=torch.float32, device=x.device)
    cls = torch.empty((r, t), dtype=torch.int32, device=x.device)
    for i in range(t):
        m = x.max(dim=1, keepdim=True).values
        # XLA's max returns +0.0 while any +0.0 remains beside -0.0
        pos_zero = ((x == 0) & ~torch.signbit(x)).any(dim=1, keepdim=True)
        m = torch.where((m == 0) & pos_zero, 0.0, m)
        # first occurrence of the max -> ascending-class tie order
        am = torch.where(x == m, iota, k).min(dim=1, keepdim=True).values
        vals[:, i:i + 1] = m
        cls[:, i:i + 1] = am
        x.scatter_(1, am.long(), float("-inf"))
    # a NaN row: every slot (that NaN, K), as the Pallas kernel gives
    vals = torch.where(has_nan[:, None], nan_bits[:, None],
                       vals.view(torch.int32)).view(torch.float32)
    cls = torch.where(has_nan[:, None], k, cls)
    return vals, cls


NEG_INF_KEY = 0x007FFFFF   # the key of -inf: no candidate


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """x (R, K) f32 -> (R, K) int64 keys in [0, 2**32) with the order of
    the values: a positive value's bits with the sign bit set, a negative
    value's bits all flipped; -0.0 takes +0.0's key (they tie as `==`
    ties them), -inf's key is NEG_INF_KEY."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, 0, bits)
    return torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                       bits | 0x80000000)


def row_topk_by_key(scores: torch.Tensor, t: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rule the CUDA kernel implements, in plain torch: selection by
    key in place of t rounds of iterative max, the same function bit for
    bit. scores (R, K) f32 -> (vals (R, t) f32, cls (R, t) int32).

    1. Each value's order-preserving key (`order_keys`); the n lanes
       above -inf are the candidates.
    2. One stable sort by key, descending: equal keys keep ascending
       class order. Slots from n on hold (-inf, 0).
    3. A zero slot carries +0.0 iff its class is <= the highest index of
       a +0.0 lane in the row, else -0.0.
    4. A row that holds a NaN: (that NaN, K) in every slot (`nan_rows`).
    """
    r, k = scores.shape
    x = scores.to(torch.float32).contiguous()
    key = order_keys(x)
    skey, idx = torch.sort(key, dim=1, descending=True, stable=True)
    skey, idx = skey[:, :t], idx[:, :t]
    n = (key > NEG_INF_KEY).sum(dim=1, keepdim=True)
    filled = torch.arange(t, device=x.device) < n
    bits = torch.where(skey >= 0x80000000, skey ^ 0x80000000,
                       skey ^ 0xFFFFFFFF)
    iota = torch.arange(k, device=x.device)
    last_pos_zero = torch.where(x.view(torch.int32) == 0, iota,
                                -1).max(dim=1, keepdim=True).values
    bits = torch.where((bits == 0) & (idx > last_pos_zero), 0x80000000, bits)
    bits = torch.where(filled, bits, 0xFF800000)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    cls = torch.where(filled, idx, 0).to(torch.int32)
    has_nan, nan_bits = nan_rows(x)
    vals = torch.where(has_nan[:, None], nan_bits[:, None],
                       bits).view(torch.float32)
    cls = torch.where(has_nan[:, None], k, cls)
    return vals, cls


def _lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("row_topk")
    if not getattr(lib, "_typed", False):
        lib.row_topk_f32_branches.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.row_topk_f32_branches.restype = ctypes.c_int
        lib.row_topk_max_k.argtypes = []
        lib.row_topk_max_k.restype = ctypes.c_int
        lib._typed = True
    return lib


def row_topk_max_k() -> int:
    """The largest K the CUDA kernel takes (builds it on first use)."""
    return _lib().row_topk_max_k()


def row_topk(scores: torch.Tensor, t: int, branches=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores (R, K) f32 -> (vals (R, t) f32 desc, cls (R, t) int32).

    CUDA tensor: one launch of the CUDA kernel, counted in
    `row_topk.launches`. CPU tensor: `row_topk_plain`.
    `branches`: None (the detect path), or a contiguous int32 tensor of
    4 on the scores' CUDA device, to which the kernel adds the rows that
    took each branch, in this order: no candidate, at most t candidates,
    more than t, a NaN.
    """
    if scores.device.type == "cpu":
        if branches is not None:
            raise ValueError("row_topk: the branches are the CUDA "
                             "kernel's; a CPU tensor takes none")
        return row_topk_plain(scores, t)
    if scores.device.type != "cuda":
        raise ValueError(f"row_topk: unsupported device {scores.device}")
    if scores.dtype != torch.float32:
        raise TypeError(f"row_topk: scores must be float32, "
                        f"got {scores.dtype}")
    if scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError("row_topk: scores must be a contiguous (R, K) "
                         f"tensor, got shape {tuple(scores.shape)}")
    r, k = scores.shape
    if not 1 <= t <= k:
        raise ValueError(f"row_topk: need 1 <= t <= K, got t={t}, K={k}")
    if r >= 2 ** 31 or r * max(k, t) >= 2 ** 62:
        raise ValueError(f"row_topk: too many rows ({r})")
    lib = _lib()
    if k > lib.row_topk_max_k():
        raise ValueError(f"row_topk: K={k} exceeds the kernel's "
                         f"{lib.row_topk_max_k()}")
    if branches is not None and (
            branches.dtype != torch.int32 or branches.shape != (4,)
            or branches.device != scores.device
            or not branches.is_contiguous()):
        raise ValueError("row_topk: branches must be a contiguous int32 "
                         "tensor of 4 on the scores' device")
    vals = torch.empty((r, t), dtype=torch.float32, device=scores.device)
    cls = torch.empty((r, t), dtype=torch.int32, device=scores.device)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.row_topk_f32_branches(
            scores.data_ptr(), vals.data_ptr(), cls.data_ptr(), r, k, t,
            None if branches is None else branches.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"row_topk: CUDA launch failed with error {err}")
    row_topk.launches += 1
    return vals, cls


row_topk.launches = 0
