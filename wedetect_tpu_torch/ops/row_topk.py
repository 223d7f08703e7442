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
the lowest index equal to zero.

`row_topk` launches the CUDA kernel (`csrc/row_topk.cu`) on a CUDA
tensor and runs `row_topk_plain` on a CPU tensor. There is no fallback:
a CUDA tensor that the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch


def row_topk_plain(scores: torch.Tensor, t: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: t rounds of iterative max
    with the kernel's tie rule. scores (R, K) f32 -> (vals (R, t) f32,
    cls (R, t) int32)."""
    r, k = scores.shape
    x = scores.to(torch.float32).clone()
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
    return vals, cls


def _lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("row_topk")
    if not getattr(lib, "_typed", False):
        lib.row_topk_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.row_topk_f32.restype = ctypes.c_int
        lib.row_topk_max_k.argtypes = []
        lib.row_topk_max_k.restype = ctypes.c_int
        lib._typed = True
    return lib


def row_topk(scores: torch.Tensor, t: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores (R, K) f32 -> (vals (R, t) f32 desc, cls (R, t) int32).

    CUDA tensor: one launch of the CUDA kernel, counted in
    `row_topk.launches`. CPU tensor: `row_topk_plain`.
    """
    if scores.device.type == "cpu":
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
    vals = torch.empty((r, t), dtype=torch.float32, device=scores.device)
    cls = torch.empty((r, t), dtype=torch.int32, device=scores.device)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.row_topk_f32(scores.data_ptr(), vals.data_ptr(),
                               cls.data_ptr(), r, k, t, stream)
    if err != 0:
        raise RuntimeError(f"row_topk: CUDA launch failed with error {err}")
    row_topk.launches += 1
    return vals, cls


row_topk.launches = 0
