"""Square flash attention forward with segment ids: kernel K3 of the port.

Replaces the stock Pallas TPU `flash_attention`
(`jax.experimental.pallas.ops.tpu.flash_attention`) that
`wedetect_tpu/ops/attention.py:_flash_attention` calls; the Qwen3-VL
ViT reaches it once per block through `dot_product_attention`, with the
token axis padded to a multiple of 128 and the pad tokens in segment 0.

Contract (`flash_attention_plain`, and the kernel on the card):
q, k, v (B, L, H, D) -- the layout `_flash_attention` receives, read in
place; optional segment ids (B, L) for the queries and the keys. Logits
q.k * sm_scale in f32; a key whose segment differs from the query's has
logit -1e30; with `causal`, keys after the query are absent (weight 0).
f32 softmax, O in the input dtype; with `return_lse` also the per-row
logsumexp (B, H, L) f32. As in the stock kernel, a pad query row attends
the pad keys only, so it differs from the einsum reference
(`_reference_attention`, which masks pad keys for every row) on pad rows
and agrees on real rows; callers discard pad rows.

`flash_attention` launches the CUDA kernel
(`csrc/flash_attn.cu:flash_attention_fwd`) on CUDA tensors and runs the
plain version on CPU tensors; there is no fallback. It is differentiable
in q, k and v (a `torch.autograd.Function`, the stock kernel's custom
VJP): the forward saves q, k, v, the segment ids, O and lse, and the
backward (`flash_attention_bwd`) launches kernels K3-bwd-dq and
K3-bwd-dkv (`csrc/flash_attn_bwd.cu`, the stock `_flash_attention_bwd_dq`
and `_flash_attention_bwd_dkv`) on CUDA tensors and runs
`flash_attention_bwd_plain` on CPU tensors. p is recomputed as
exp(s - lse) from the saved logsumexp (the stock kernels keep m and l
apart: the same p up to rounding); di = rowsum(dO * O) is plain torch,
as in the stock VJP.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_NEG = -1e30


def _check(q, k, v, q_segment_ids, kv_segment_ids):
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError("flash_attention: q, k, v must share one "
                         f"(B, L, H, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("flash_attention: give both segment ids or none")
    if q_segment_ids is not None:
        b, l = q.shape[:2]
        for t in (q_segment_ids, kv_segment_ids):
            if tuple(t.shape) != (b, l):
                raise ValueError(f"flash_attention: segment ids shape "
                                 f"{tuple(t.shape)}, want {(b, l)}")


def _acc_dtype(q):
    """The plain versions' accumulation type: f32, or f64 for f64
    inputs (gradcheck)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _masked_logits(q, k, q_segment_ids, kv_segment_ids, causal, sm_scale):
    """(B, H, L, L) f32 logits: -1e30 across segments, -inf after the
    query when causal."""
    acc = _acc_dtype(q)
    l = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc),
                          k.to(acc)) * sm_scale
    if q_segment_ids is not None:
        same = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        logits = torch.where(same[:, None], logits, _NEG)
    if causal:
        later = torch.ones((l, l), dtype=torch.bool,
                           device=q.device).triu(1)
        logits = logits.masked_fill(later, float("-inf"))
    return logits


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, q_segment_ids: Optional[torch.Tensor] = None,
                          kv_segment_ids: Optional[torch.Tensor] = None,
                          causal: bool = False, sm_scale: float = 1.0,
                          return_lse: bool = False):
    """The kernel's function in plain PyTorch (module docstring)."""
    acc = _acc_dtype(q)
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    logits = _masked_logits(q, k, q_segment_ids, kv_segment_ids, causal,
                            sm_scale)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(-1, keepdim=True)                       # (B, H, L, 1)
    # the kernel casts p to V's dtype before the p.V product
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(acc),
                     v.to(acc))
    o = (o / s).transpose(1, 2).to(q.dtype)
    if not return_lse:
        return o
    return o, (m + torch.log(s))[..., 0]


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(dO * O) in f32, (B, H, L) like lse (the stock VJP)."""
    acc = _acc_dtype(o)
    return (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, q_segment_ids=None,
                              kv_segment_ids=None, causal=False,
                              sm_scale=1.0):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv).

    The stock kernels' formulas (`_flash_attention_dq_kernel`,
    `_flash_attention_dkv_kernel`) with p = exp(s - lse): ds = (dO.V^T -
    di) * p * sm_scale, dv = p^T.dO with p cast to dO's dtype, dk =
    ds^T.Q and dq = ds.K with ds cast to the input dtype; f32 sums."""
    acc = _acc_dtype(q)
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    logits = _masked_logits(q, k, q_segment_ids, kv_segment_ids, causal,
                            sm_scale)
    p = torch.exp(logits - lse[..., None])            # (B, H, L, L)
    delta = row_delta(o, do)[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(acc),
                      do.to(acc))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), v.to(acc))
    ds = p * (dp - delta) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(acc),
                      q.to(acc))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).to(acc),
                      k.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_attn")
    if not getattr(lib, "_typed_fa", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                            i, i, ctypes.c_float, i, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib._typed_fa = True
    return lib


def _bwd_lib():
    from wedetect_tpu_torch.ops import _build

    lib = _build.load("flash_attn_bwd")
    if not getattr(lib, "_typed_fa", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd_dq.argtypes = [p] * 9 + [i] * 5 + [f, i, p]
        lib.flash_attention_bwd_dkv.argtypes = [p] * 10 + [i] * 5 + [f, i, p]
        lib.flash_attention_bwd_dq.restype = ctypes.c_int
        lib.flash_attention_bwd_dkv.restype = ctypes.c_int
        lib._typed_fa = True
    return lib


def _check_cuda(name, q, *others):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} (float32 or bfloat16 "
                        "only)")
    if any(t.dtype != q.dtype or t.device != q.device for t in others):
        raise TypeError(f"{name}: k, v (and dO) must match q's dtype and "
                        "device")
    if not all(t.is_contiguous() for t in (q, *others)):
        raise ValueError(f"{name}: q, k, v (and dO) must be contiguous")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"{name}: head dim {q.shape[-1]} (64 or 128)")


def _segs(q, q_segment_ids, kv_segment_ids):
    if q_segment_ids is None:
        return [None, None]
    return [t.to(device=q.device, dtype=torch.int32).contiguous()
            for t in (q_segment_ids, kv_segment_ids)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_kernel(q, k, v, q_segment_ids, kv_segment_ids, causal, sm_scale):
    """One launch of K3: (O, lse)."""
    _check_cuda("flash_attention", q, k, v)
    b, l, h, d = q.shape
    segs = _segs(q, q_segment_ids, kv_segment_ids)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *map(_ptr, segs),
            o.data_ptr(), lse.data_ptr(), b, l, h, d, int(causal),
            float(sm_scale), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"error {err}")
    flash_attention.launches += 1
    return o, lse


def _forward(q, k, v, q_segment_ids, kv_segment_ids, causal, sm_scale):
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, causal=causal,
            sm_scale=sm_scale, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _fwd_kernel(q, k, v, q_segment_ids, kv_segment_ids, causal,
                       sm_scale)


def _check_rows(name, lse, delta, q):
    b, l, h, _ = q.shape
    for tname, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, l) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous f32 "
                             f"{(b, h, l)}")


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, q_segment_ids=None,
                           kv_segment_ids=None, causal=False, sm_scale=1.0):
    """One launch of K3-bwd-dq on CUDA tensors: dq (B, L, H, D). lse and
    delta (B, H, L) f32 (`row_delta`)."""
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    _check_cuda("flash_attention_bwd_dq", q, k, v, do)
    _check_rows("flash_attention_bwd_dq", lse, delta, q)
    b, l, h, d = q.shape
    segs = _segs(q, q_segment_ids, kv_segment_ids)
    dq = torch.empty_like(q)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *map(_ptr, segs),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, l, h, d, int(causal), float(sm_scale),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dq: CUDA launch failed "
                           f"with error {err}")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, q_segment_ids=None,
                            kv_segment_ids=None, causal=False,
                            sm_scale=1.0):
    """One launch of K3-bwd-dkv on CUDA tensors: (dk, dv), each
    (B, L, H, D)."""
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    _check_cuda("flash_attention_bwd_dkv", q, k, v, do)
    _check_rows("flash_attention_bwd_dkv", lse, delta, q)
    b, l, h, d = q.shape
    segs = _segs(q, q_segment_ids, kv_segment_ids)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *map(_ptr, segs),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, l, h, d, int(causal), float(sm_scale),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv: CUDA launch failed "
                           f"with error {err}")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, q_segment_ids=None,
                        kv_segment_ids=None, causal=False, sm_scale=1.0):
    """(dq, dk, dv) of flash_attention from the saved O and lse. CUDA
    tensors: K3-bwd-dq and K3-bwd-dkv, one launch each; CPU tensors: the
    plain version."""
    kw = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              causal=causal, sm_scale=sm_scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    delta = row_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """K3 with its backward: saves q, k, v, the segment ids, O and lse
    (never an L x L matrix)."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, causal,
                sm_scale):
        o, lse = _forward(q, k, v, q_segment_ids, kv_segment_ids, causal,
                          sm_scale)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, o,
                              lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, qs, ks, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), q_segment_ids=qs,
            kv_segment_ids=ks, causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    causal: bool = False, sm_scale: float = 1.0,
                    return_lse: bool = False):
    """(B, L, H, D) square attention -> (B, L, H, D) [, lse (B, H, L)].

    CUDA tensors: one launch of the CUDA kernel, counted in
    `flash_attention.launches`. CPU tensors: the plain version.
    Differentiable in q, k and v (module docstring).
    """
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    o, lse = _Flash.apply(q, k, v, q_segment_ids, kv_segment_ids, causal,
                          float(sm_scale))
    return (o, lse) if return_lse else o


flash_attention.launches = 0
