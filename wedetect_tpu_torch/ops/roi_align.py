"""RoIAlign as two separable contractions (NHWC), in plain PyTorch.

Port of `wedetect_tpu/ops/roi_align.py`, the stand-in for the
torchvision `roi_align` the reference calls (qwen3vl_referring.py:220-222:
7x7 output, spatial_scale 1/8, 1/16, 1/32, sampling_ratio=-1,
aligned=False). The JAX package computes it outside any Pallas kernel.

Semantics (torch's): roi coords scaled by spatial_scale, no -0.5 shift;
roi size clamped at >= 1; sampling_ratio > 0 averages ratio^2 bilinear
samples per bin, sampling_ratio <= 0 the adaptive ceil(roi_size /
out_size) samples per bin axis, over a static per-axis budget of
ceil(feat_size / out_size) (exact for every roi inside the map; an int
`max_ratio` caps it); samples with y/x < -1 or > size are dropped and
the rest clamped into the map. Bilinear sampling and bin averaging are
separable per axis, so the op is a (N, out, H) and a (N, out, W) weight
matrix contracted with the map.
"""

from __future__ import annotations

from typing import Optional

import torch


def _axis_weights(lo: torch.Tensor, bsize: torch.Tensor, g: torch.Tensor,
                  s: int, size: int, out_size: int) -> torch.Tensor:
    """Per-axis interpolation weights (N, out_size, size): for output bin
    i of roi n, the summed bilinear x averaging weight of every source
    index along this axis (sample j weighted 1/g, dropped at j >= g)."""
    dev = lo.device
    j = torch.arange(s, dtype=torch.float32, device=dev)
    off = (j[None, :] + 0.5) / g[:, None]                 # (N, s)
    wj = torch.where(j[None, :] < g[:, None], 1.0 / g[:, None],
                     torch.zeros((), device=dev))
    bins = torch.arange(out_size, dtype=torch.float32, device=dev)
    pos = (lo[:, None, None]
           + bsize[:, None, None] * (bins[None, :, None]
                                     + off[:, None, :]))  # (N, out, s)
    oob = (pos < -1.0) | (pos > size)
    p = torch.clamp(pos, 0.0, size - 1)
    p0 = torch.floor(p).to(torch.int64)
    p1 = torch.clamp(p0 + 1, max=size - 1)
    lp = p - p0
    w = torch.where(oob, torch.zeros((), device=dev), wj[:, None, :])
    grid = torch.arange(size, device=dev)
    oh0 = (p0[..., None] == grid) * ((1.0 - lp) * w)[..., None]
    oh1 = (p1[..., None] == grid) * (lp * w)[..., None]
    return (oh0 + oh1).sum(dim=2)                        # (N, out, size)


def roi_align(feat: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = -1,
              max_ratio: Optional[int] = None) -> torch.Tensor:
    """feat (H, W, C); rois (N, 4) xyxy in input coords ->
    (N, out_size, out_size, C) in feat's dtype."""
    h, w, _ = feat.shape
    if sampling_ratio > 0:
        sy = sx = sampling_ratio
    elif max_ratio is not None:
        sy = sx = max_ratio
    else:
        sy = -(-h // out_size)
        sx = -(-w // out_size)
    rois = rois.float() * spatial_scale
    x1, y1, x2, y2 = rois.unbind(-1)
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bw = rw / out_size
    bh = rh / out_size
    if sampling_ratio > 0:
        gy = torch.full_like(rh, sy)
        gx = torch.full_like(rw, sx)
    else:
        gy = torch.clamp(torch.ceil(rh / out_size), 1.0, sy)
        gx = torch.clamp(torch.ceil(rw / out_size), 1.0, sx)
    wy = _axis_weights(y1, bh, gy, sy, h, out_size)       # (N, out, H)
    wx = _axis_weights(x1, bw, gx, sx, w, out_size)       # (N, out, W)
    tmp = torch.einsum("nih,hwc->niwc", wy, feat.float())
    out = torch.einsum("njw,niwc->nijc", wx, tmp)
    return out.to(feat.dtype)
