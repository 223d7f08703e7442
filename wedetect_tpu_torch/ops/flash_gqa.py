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
version on CPU tensors; there is no fallback. It is differentiable in
q, k and v (a `torch.autograd.Function`, the JAX package's custom VJP):
the forward saves q, k, v, kv_valid, O and lse, and the backward
(`gqa_flash_attention_bwd`) launches kernels K2-bwd-dq and K2-bwd-dkdv
(`csrc/flash_attn_bwd.cu`) on CUDA tensors and runs
`gqa_flash_attention_bwd_plain` on CPU tensors. delta = rowsum(dO * O)
is plain torch in both, as in JAX (`_bwd_grouped`).
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


def _acc_dtype(q):
    """The plain versions' accumulation type: f32, or f64 for f64
    inputs (gradcheck)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _masked_logits(q, k, kv_valid, causal, sm_scale):
    """(B, KVH, G, S, Lk) f32 logits: -1e30 where the mask rejects a
    scanned key, -inf past the row's frontier."""
    acc = _acc_dtype(q)
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    qpos = (lk - s if causal else 0) + torch.arange(s, device=dev)
    kpos = torch.arange(lk, device=dev)
    present = kpos[None, :] < row_frontier(s, lk, g, causal, dev)[:, None]
    ok = torch.ones((b, s, lk), dtype=torch.bool, device=dev)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])[None]
    if kv_valid is not None:
        ok = ok & kv_valid.to(torch.bool)[:, None, :]
    qg = q.reshape(b, s, kvh, g, d).to(acc)
    logits = torch.einsum("bskgd,blkd->bkgsl", qg, k.to(acc)) * sm_scale
    logits = torch.where(ok[:, None, None], logits, _NEG)
    return logits.masked_fill(~present, float("-inf"))


def gqa_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              kv_valid: Optional[torch.Tensor] = None,
                              sm_scale: Optional[float] = None,
                              return_lse: bool = False):
    """The kernel's function in plain PyTorch (module docstring)."""
    acc = _acc_dtype(q)
    _check(q, k, v, causal)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    logits = _masked_logits(q, k, kv_valid, causal, sm_scale)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)                       # (B, KVH, G, S, 1)
    # the kernel casts p to V's dtype before the p.V product
    o = torch.einsum("bkgsl,blkd->bkgsd", p.to(v.dtype).to(acc),
                     v.to(acc))
    o = (o / l).permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log(l))[..., 0].permute(0, 1, 3, 2).reshape(
        b, kvh, s * g)
    return o, lse


def row_delta(o: torch.Tensor, do: torch.Tensor, kvh: int) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, KVH, S * G) in the folded-row
    order of lse (JAX `_bwd_grouped`)."""
    acc = _acc_dtype(o)
    b, s, h, _ = o.shape
    g = h // kvh
    dl = (do.to(acc) * o.to(acc)).sum(-1)             # (B, S, H)
    return dl.reshape(b, s, kvh, g).permute(0, 2, 1, 3).reshape(
        b, kvh, s * g).contiguous()


def gqa_flash_attention_bwd_plain(q, k, v, kv_valid, o, lse, do, causal,
                                  sm_scale):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv).

    The Pallas kernels' formulas (flash_gqa.py `_dq_kernel`,
    `_dkdv_kernel`): p = exp(s - lse) with the forward's -1e30 fill and
    frontier, ds = p * (dO.V^T - delta) * sm_scale, dv = p^T.dO with p
    cast to dO's dtype, dk = ds^T.Q and dq = ds.K with ds cast to the
    input dtype; f32 sums, dq in q's dtype, dk and dv in k's."""
    acc = _acc_dtype(q)
    _check(q, k, v, causal)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    logits = _masked_logits(q, k, kv_valid, causal, sm_scale)
    lse_g = lse.reshape(b, kvh, s, g).permute(0, 1, 3, 2)[..., None]
    p = torch.exp(logits - lse_g)                     # (B, KVH, G, S, Lk)
    delta = row_delta(o, do, kvh).reshape(b, kvh, s, g).permute(
        0, 1, 3, 2)[..., None]
    dog = do.reshape(b, s, kvh, g, d)
    qg = q.reshape(b, s, kvh, g, d)
    dv = torch.einsum("bkgsl,bskgd->blkd", p.to(do.dtype).to(acc),
                      dog.to(acc))
    dp = torch.einsum("bskgd,blkd->bkgsl", dog.to(acc), v.to(acc))
    ds = p * (dp - delta) * sm_scale
    dk = torch.einsum("bkgsl,bskgd->blkd", ds.to(q.dtype).to(acc),
                      qg.to(acc))
    dq = torch.einsum("bkgsl,blkd->bskgd", ds.to(k.dtype).to(acc),
                      k.to(acc)).reshape(b, s, h, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _bwd_lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_attn_bwd")
    if not getattr(lib, "_typed_gqa", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gqa_flash_bwd_dq.argtypes = [p] * 8 + [i] * 9 + [f, i, p]
        lib.gqa_flash_bwd_dkdv.argtypes = [p] * 9 + [i] * 9 + [f, i, p]
        lib.gqa_flash_bwd_dq.restype = ctypes.c_int
        lib.gqa_flash_bwd_dkdv.restype = ctypes.c_int
        lib._typed_gqa = True
    return lib


def _check_cuda(name, q, k, v, others=()):
    """The kernels' input rules: dtype, device, shapes, contiguity."""
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} (float32 or bfloat16 "
                        "only)")
    for tname, t, shape in (("k", k, (b, lk, kvh, d)),
                            ("v", v, (b, lk, kvh, d)), *others):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name}: {tname} must match q's dtype and "
                            "device")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} shape {tuple(t.shape)}, "
                             f"want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    if d not in (64, 128):
        raise ValueError(f"{name}: head dim {d} (64 or 128)")


def _valid_i32(kv_valid, b, lk, device, name):
    if kv_valid is None:
        return torch.ones((b, lk), dtype=torch.int32, device=device)
    if tuple(kv_valid.shape) != (b, lk):
        raise ValueError(f"{name}: kv_valid shape {tuple(kv_valid.shape)}, "
                         f"want {(b, lk)}")
    return kv_valid.to(device=device, dtype=torch.int32).contiguous()


def _fwd_kernel(q, k, v, kv_valid, causal, sm_scale):
    """One launch of K2: (O, lse)."""
    _check_cuda("gqa_flash_attention", q, k, v)
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    valid = _valid_i32(kv_valid, b, lk, q.device, "gqa_flash_attention")
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
    return o, lse


def _forward(q, k, v, kv_valid, causal, sm_scale):
    if q.device.type == "cpu":
        return gqa_flash_attention_plain(q, k, v, causal=causal,
                                         kv_valid=kv_valid,
                                         sm_scale=sm_scale, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"gqa_flash_attention: unsupported device "
                         f"{q.device}")
    return _fwd_kernel(q, k, v, kv_valid, causal, sm_scale)


def _check_bwd(name, q, k, v, kv_valid, do, lse, delta):
    """The backward kernels' input rules; returns kv_valid as int32."""
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    _check_cuda(name, q, k, v, (("do", do, (b, s, h, d)),))
    rows = (b, kvh, s * (h // kvh))
    for tname, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != rows \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous f32 "
                             f"{rows}")
    return _valid_i32(kv_valid, b, lk, q.device, name)


def gqa_flash_bwd_dq(q, k, v, kv_valid, do, lse, delta, *, causal,
                     sm_scale):
    """One launch of K2-bwd-dq on CUDA tensors: dq (B, S, H, D). lse and
    delta (B, KVH, S * G) f32 (`row_delta`)."""
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    valid = _check_bwd("gqa_flash_bwd_dq", q, k, v, kv_valid, do, lse,
                       delta)
    dq = torch.empty_like(q)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gqa_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, s, lk, h, kvh, d, int(causal), _pick_bq(s, g), _pick_bk(lk),
            float(sm_scale), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"gqa_flash_bwd_dq: CUDA launch failed with "
                           f"error {err}")
    gqa_flash_bwd_dq.launches += 1
    return dq


def gqa_flash_bwd_dkdv(q, k, v, kv_valid, do, lse, delta, *, causal,
                       sm_scale):
    """One launch of K2-bwd-dkdv on CUDA tensors: (dk, dv), each
    (B, Lk, KVH, D)."""
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    valid = _check_bwd("gqa_flash_bwd_dkdv", q, k, v, kv_valid, do, lse,
                       delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gqa_flash_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, s, lk, h, kvh, d, int(causal), _pick_bq(s, g),
            _pick_bk(lk), float(sm_scale), int(q.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"gqa_flash_bwd_dkdv: CUDA launch failed with "
                           f"error {err}")
    gqa_flash_bwd_dkdv.launches += 1
    return dk, dv


gqa_flash_bwd_dq.launches = 0
gqa_flash_bwd_dkdv.launches = 0


def gqa_flash_attention_bwd(q, k, v, kv_valid, o, lse, do, *, causal,
                            sm_scale):
    """(dq, dk, dv) of gqa_flash_attention from the saved O and lse.
    CUDA tensors: K2-bwd-dq and K2-bwd-dkdv, one launch each; CPU
    tensors: the plain version."""
    if q.device.type == "cpu":
        return gqa_flash_attention_bwd_plain(q, k, v, kv_valid, o, lse, do,
                                             causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"gqa_flash_attention_bwd: unsupported device "
                         f"{q.device}")
    delta = row_delta(o, do, k.shape[2])
    kw = dict(causal=causal, sm_scale=sm_scale)
    dq = gqa_flash_bwd_dq(q, k, v, kv_valid, do, lse, delta, **kw)
    dk, dv = gqa_flash_bwd_dkdv(q, k, v, kv_valid, do, lse, delta, **kw)
    return dq, dk, dv


class _GqaFlash(torch.autograd.Function):
    """K2 with its backward: saves q, k, v, kv_valid, O and lse (never an
    S x Lk matrix)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal, sm_scale):
        o, lse = _forward(q, k, v, kv_valid, causal, sm_scale)
        ctx.save_for_backward(q, k, v, kv_valid, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, kv_valid, o, lse = ctx.saved_tensors
        dq, dk, dv = gqa_flash_attention_bwd(
            q, k, v, kv_valid, o, lse, do.contiguous(), causal=ctx.causal,
            sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        kv_valid: Optional[torch.Tensor] = None,
                        sm_scale: Optional[float] = None,
                        return_lse: bool = False):
    """(B, S, H, D) x (B, Lk, KVH, D) -> (B, S, H, D) [, lse].

    CUDA tensors: one launch of the CUDA kernel, counted in
    `gqa_flash_attention.launches`. CPU tensors: the plain version.
    Differentiable in q, k and v (module docstring).
    """
    _check(q, k, v, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = _GqaFlash.apply(q, k, v, kv_valid, causal, float(sm_scale))
    return (o, lse) if return_lse else o


gqa_flash_attention.launches = 0
