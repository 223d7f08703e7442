"""Grouped-KV flash attention forward, rectangular end-aligned causal:
kernel K2 of the port.

Replaces `wedetect_tpu/ops/flash_gqa.py` (`gqa_flash_attention` and its
Pallas forward kernel `_fwd_kernel`). Every Qwen3-VL decoder layer calls
it through `ops/attention.gqa_attention`: square causal over the shared
prefix (S = Lk = P), rectangular causal for the suffix rows that attend
[prefix KV; own KV] (Lk = P + S, query i at key position Lk - S + i).

Contract (`gqa_flash_attention_plain`, and the kernel on the card):
q (B, S, H, D); k, v (B, Lk, KVH, D) pre-repeat, query head j reads kv
head j // (H // KVH); kv_valid (B, Lk). Logits q.k * sm_scale in f32,
f32 softmax, O in the input dtype; with `return_lse` also the per-row
logsumexp (B, KVH, S * G) in the folded-row order (row r = query
position r // G, head r % G of the group), f32.

Which keys a row sees follows the Pallas kernel's tiling. With JAX's
bq = _pick_bq(S, G) and bk = _pick_bk(Lk), the row of query i scans
keys [0, F) with F = min(Lk, bk * ceil((Lk - S + (i // bq + 1) * bq)
/ bk)) when causal (Lk when not): keys at or past F are absent; a key
below F that is invalid or causally later has logit -1e30 (not -inf).
So a row whose scanned keys are all masked returns the mean of V over
them, not 0; for every row with a valid key, F changes nothing.

`gqa_flash_attention` launches the CUDA kernel
(`csrc/flash_attn.cu:gqa_flash_fwd`) on CUDA tensors and runs the plain
version on CPU tensors; there is no fallback. The backward (the JAX
package's custom VJP) is not ported yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

_NEG = -1e30


def _pick_bq(s: int, g: int) -> int:
    """Query-position block of the Pallas kernel (flash_gqa._pick_bq)."""
    want = max(256 // g, 1) if g <= 2 else max(512 // g, 1)
    for bq in (want, 128, 64, 32, 16, 8, 4, 2, 1):
        if s % bq == 0 and bq * g >= 8:
            return bq
    return s


def _pick_bk(lk: int) -> int:
    """Key block of the Pallas kernel (flash_gqa._pick_bk); 0 = none."""
    for bk in (512, 256, 128):
        if lk % bk == 0:
            return bk
    return 0


def supports(s: int, lk: int, d: int, g: int) -> bool:
    """The JAX kernel's tiling rule: both packages route alike."""
    bq = _pick_bq(s, g)
    return (d % 128 == 0 and _pick_bk(lk) != 0 and s % bq == 0
            and bq * g >= 8)


def _check(q, k, v, causal):
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kvh}")
    if causal and lk < s:
        raise ValueError(f"causal needs Lk >= S ({lk} < {s})")
    if not supports(s, lk, d, h // kvh):
        raise ValueError(
            f"untileable shape: S={s}, Lk={lk}, D={d}, G={h // kvh} "
            "(Lk must be a multiple of 128, D of 128)")


def row_frontier(s: int, lk: int, g: int, causal: bool,
                 device=None) -> torch.Tensor:
    """(S,) int64: the key count F each query position scans."""
    i = torch.arange(s, device=device)
    if not causal:
        return torch.full((s,), lk, dtype=torch.int64, device=device)
    bq, bk = _pick_bq(s, g), _pick_bk(lk)
    end = (lk - s) + (i // bq + 1) * bq
    return torch.clamp((end + bk - 1) // bk * bk, max=lk)


def gqa_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              kv_valid: Optional[torch.Tensor] = None,
                              sm_scale: Optional[float] = None,
                              return_lse: bool = False):
    """The kernel's function in plain PyTorch (module docstring)."""
    _check(q, k, v, causal)
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dev = q.device
    qpos = (lk - s if causal else 0) + torch.arange(s, device=dev)
    kpos = torch.arange(lk, device=dev)
    present = kpos[None, :] < row_frontier(s, lk, g, causal, dev)[:, None]
    ok = torch.ones((b, s, lk), dtype=torch.bool, device=dev)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])[None]
    if kv_valid is not None:
        ok = ok & kv_valid.to(torch.bool)[:, None, :]
    qg = q.reshape(b, s, kvh, g, d).float()
    logits = torch.einsum("bskgd,blkd->bkgsl", qg, k.float()) * sm_scale
    logits = torch.where(ok[:, None, None], logits, _NEG)
    logits = logits.masked_fill(~present, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)                       # (B, KVH, G, S, 1)
    # the kernel casts p to V's dtype before the p.V product
    o = torch.einsum("bkgsl,blkd->bkgsd", p.to(v.dtype).float(), v.float())
    o = (o / l).permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log(l))[..., 0].permute(0, 1, 3, 2).reshape(
        b, kvh, s * g)
    return o, lse


def _lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_attn")
    if not getattr(lib, "_typed_gqa", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gqa_flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                      i, i, i, ctypes.c_float, i, p]
        lib.gqa_flash_fwd.restype = ctypes.c_int
        lib._typed_gqa = True
    return lib


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        kv_valid: Optional[torch.Tensor] = None,
                        sm_scale: Optional[float] = None,
                        return_lse: bool = False):
    """(B, S, H, D) x (B, Lk, KVH, D) -> (B, S, H, D) [, lse].

    CUDA tensors: one launch of the CUDA kernel, counted in
    `gqa_flash_attention.launches`. CPU tensors: the plain version.
    """
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return gqa_flash_attention_plain(q, k, v, causal=causal,
                                         kv_valid=kv_valid,
                                         sm_scale=sm_scale,
                                         return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"gqa_flash_attention: unsupported device "
                         f"{q.device}")
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gqa_flash_attention: dtype {q.dtype} (float32 "
                        "or bfloat16 only)")
    for name, t, shape in (("k", k, (b, lk, kvh, d)),
                           ("v", v, (b, lk, kvh, d))):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"gqa_flash_attention: {name} must match q's "
                            "dtype and device")
        if tuple(t.shape) != shape:
            raise ValueError(f"gqa_flash_attention: {name} shape "
                             f"{tuple(t.shape)}, want {shape}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("gqa_flash_attention: q, k, v must be contiguous")
    if d not in (64, 128):
        raise ValueError(f"gqa_flash_attention: head dim {d} (64 or 128)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if kv_valid is None:
        valid = torch.ones((b, lk), dtype=torch.int32, device=q.device)
    else:
        if tuple(kv_valid.shape) != (b, lk):
            raise ValueError(f"gqa_flash_attention: kv_valid shape "
                             f"{tuple(kv_valid.shape)}, want {(b, lk)}")
        valid = kv_valid.to(device=q.device, dtype=torch.int32).contiguous()
    g = h // kvh
    o = torch.empty_like(q)
    lse = torch.empty((b, kvh, s * g), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gqa_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, s, lk, h, kvh, d, int(causal),
            _pick_bq(s, g), _pick_bk(lk), float(sm_scale),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"gqa_flash_attention: CUDA launch failed with "
                           f"error {err}")
    gqa_flash_attention.launches += 1
    return (o, lse) if return_lse else o


gqa_flash_attention.launches = 0
