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
plain version on CPU tensors; there is no fallback. The backward (the
stock kernel's custom VJP) is not ported yet.
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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, q_segment_ids: Optional[torch.Tensor] = None,
                          kv_segment_ids: Optional[torch.Tensor] = None,
                          causal: bool = False, sm_scale: float = 1.0,
                          return_lse: bool = False):
    """The kernel's function in plain PyTorch (module docstring)."""
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    l = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if q_segment_ids is not None:
        same = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        logits = torch.where(same[:, None], logits, _NEG)
    if causal:
        later = torch.ones((l, l), dtype=torch.bool,
                           device=q.device).triu(1)
        logits = logits.masked_fill(later, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(-1, keepdim=True)                       # (B, H, L, 1)
    # the kernel casts p to V's dtype before the p.V product
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = (o / s).transpose(1, 2).to(q.dtype)
    if not return_lse:
        return o
    return o, (m + torch.log(s))[..., 0]


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    causal: bool = False, sm_scale: float = 1.0,
                    return_lse: bool = False):
    """(B, L, H, D) square attention -> (B, L, H, D) [, lse (B, H, L)].

    CUDA tensors: one launch of the CUDA kernel, counted in
    `flash_attention.launches`. CPU tensors: the plain version.
    """
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, causal=causal,
            sm_scale=sm_scale, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype {q.dtype} (float32 or "
                        "bfloat16 only)")
    if any(t.dtype != q.dtype or t.device != q.device for t in (k, v)):
        raise TypeError("flash_attention: k, v must match q's dtype and "
                        "device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    b, l, h, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"flash_attention: head dim {d} (64 or 128)")
    segs = [0, 0]
    if q_segment_ids is not None:
        segs = [t.to(device=q.device, dtype=torch.int32).contiguous()
                for t in (q_segment_ids, kv_segment_ids)]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(s.data_ptr() if torch.is_tensor(s) else None for s in segs),
            o.data_ptr(), lse.data_ptr(), b, l, h, d, int(causal),
            float(sm_scale), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"error {err}")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0
