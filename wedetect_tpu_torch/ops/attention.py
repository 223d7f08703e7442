"""Attention dispatch: the flash kernels on the card, exact einsum
attention otherwise.

Port of `wedetect_tpu/ops/attention.py`, with its routing and "on TPU"
read as "on a CUDA tensor":

- `dot_product_attention` (the ViT): `"flash"` runs K3
  (`ops/flash_attention.py`) and raises on a kv length it cannot tile
  (`_pick_block`); the rectangular causal route front-pads q with
  Lk - S dummy rows, as the JAX package does.
- `gqa_attention` (the decoder): `"flash"` runs K2 (`ops/flash_gqa.py`)
  and raises unless `flash_gqa.supports(S, Lk, D, G)` holds.
- `"auto"` is `"flash"` on a CUDA tensor and `"einsum"` on a CPU
  tensor. Where the JAX package drops an untileable shape to the einsum
  on TPU, the port raises on the card: callers pad lengths to multiples
  of 128 (`models/ref_api.RefScorer` does).
- `"einsum"` runs `_reference_attention`, or its grouped form (G > 1).
- Head dims: on a CUDA tensor the kernels take D up to 512, a
  deliberate difference from the JAX package, whose Pallas kernels
  take any D (K2: any D % 128 == 0). K3 zero-pads a D the kernels are
  not built for to the next of 64, 128, 256, 384 and 512; K2 needs no
  padding (its D % 128 == 0 up to 512 are all built). Above 512 both
  raise before any launch (`flash_attention.simt_head_dim`,
  `flash_gqa._check_cuda`).

The einsum paths keep the JAX contract: end-aligned rectangular causal
(query i sits at key position Lk - S + i), kv_valid key masking, f32
logits, a -1e9 additive bias and the softmax cast back to the input
dtype. Under `"flash"` a CPU tensor runs the kernels' plain versions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_FLASH_MIN_BLOCK = 128


def _pick_block(n: int, *, cap: int = 512) -> Optional[int]:
    """Largest power-of-two block <= cap that divides n (>= 128)."""
    b = cap
    while b >= _FLASH_MIN_BLOCK:
        if n % b == 0:
            return b
        b //= 2
    return None


def is_flash_tileable(lk: int) -> bool:
    """True when a kv length can run the flash kernels (a multiple of
    128). Bucket builders assert it so a mis-sized bucket fails loudly."""
    return _pick_block(lk) is not None


def _mask_bias(lq, lk, causal, kv_valid, device):
    mask = torch.ones((lq, lk), dtype=torch.bool, device=device)
    if causal:
        mask = mask.tril(lk - lq)
    mask = mask[None]
    if kv_valid is not None:
        mask = mask & kv_valid.to(torch.bool)[:, None, :]
    return torch.where(mask, 0.0, -1e9)               # (1 | B, Lq, Lk)


def _grouped_reference_attention(q, k, v, *, causal, kv_valid, sm_scale):
    """Einsum attention over pre-repeat grouped KV: the same products
    and reductions as repeating K/V and calling `_reference_attention`,
    without materializing the G-fold copy."""
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, lq, kvh, h // kvh, d)
    logits = torch.einsum("bqkgd,bckd->bkgqc", qg, k).float() * sm_scale
    bias = _mask_bias(lq, lk, causal, kv_valid, q.device)
    p = torch.softmax(logits + bias[:, None, None], dim=-1).to(q.dtype)
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v)
    return o.reshape(b, lq, h, d)


def _reference_attention(q, k, v, *, causal, kv_valid, sm_scale):
    """(B, L, H, D) einsum attention, f32 softmax, -1e9 mask bias.
    Rectangular causal is end-aligned."""
    lq, lk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    bias = _mask_bias(lq, lk, causal, kv_valid, q.device)
    p = torch.softmax(logits + bias[:, None], dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _flash_attention(q, k, v, *, causal, kv_valid, sm_scale):
    """K3 over (B, L, H, D), with kv_valid as the segment ids of both
    queries and keys (pad tokens form segment 0)."""
    from wedetect_tpu_torch.ops.flash_attention import flash_attention

    seg = None if kv_valid is None else kv_valid.to(torch.int32)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           q_segment_ids=seg, kv_segment_ids=seg,
                           causal=causal, sm_scale=sm_scale)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = False,
                          kv_valid: Optional[torch.Tensor] = None,
                          sm_scale: Optional[float] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Multi-head attention over (B, L, H, D) tensors; kv_valid (B, Lk)
    0/1. impl: "auto" (K3 on a CUDA tensor, einsum on a CPU tensor),
    "flash" (error if K3 cannot tile), "einsum"."""
    l, lk = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "flash" if q.is_cuda else "einsum"
    if lk != l and not causal:
        if impl == "flash":
            raise ValueError(
                "rectangular attention is only defined for causal=True"
                f" (end-aligned); got lq={l}, lk={lk}, causal=False")
    elif causal and lk < l:
        raise ValueError(f"causal attention needs lk >= lq ({lk} < {l})")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "flash":
        if _pick_block(lk) is None:
            raise ValueError(
                f"kv length {lk} not tileable for flash attention"
                f" (needs a multiple of {_FLASH_MIN_BLOCK})")
        if lk != l:
            qp = F.pad(q, (0, 0, 0, 0, lk - l, 0))
            out = _flash_attention(qp, k, v, causal=causal,
                                   kv_valid=kv_valid, sm_scale=sm_scale)
            return out[:, lk - l:]
        return _flash_attention(q, k, v, causal=causal, kv_valid=kv_valid,
                                sm_scale=sm_scale)
    return _reference_attention(q, k, v, causal=causal, kv_valid=kv_valid,
                                sm_scale=sm_scale)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  kv_valid: Optional[torch.Tensor] = None,
                  sm_scale: Optional[float] = None,
                  impl: str = "auto") -> torch.Tensor:
    """Grouped-query attention over pre-repeat KV: q (B, S, H, D); k, v
    (B, Lk, KVH, D); query head j reads kv head j // (H // KVH).
    impl: "auto" (K2 on a CUDA tensor, einsum on a CPU tensor), "flash"
    (error if K2 cannot tile), "einsum"."""
    from wedetect_tpu_torch.ops import flash_gqa

    s, h, d = q.shape[1:]
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if impl == "auto":
        impl = "flash" if q.is_cuda else "einsum"
    if impl == "flash":
        if not flash_gqa.supports(s, lk, d, g):
            raise ValueError(
                f"shape S={s}, Lk={lk}, D={d}, G={g} not tileable for "
                "the grouped-KV flash kernel")
        return flash_gqa.gqa_flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            kv_valid=kv_valid, sm_scale=sm_scale)
    if g > 1:
        return _grouped_reference_attention(
            q, k, v, causal=causal, kv_valid=kv_valid, sm_scale=sm_scale)
    return dot_product_attention(q, k, v, causal=causal, kv_valid=kv_valid,
                                 sm_scale=sm_scale, impl=impl)
