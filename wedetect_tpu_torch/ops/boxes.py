"""Box coding and the IoU family, shape-polymorphic (broadcasting).

The same functions as `wedetect_tpu.ops.boxes`:
- distance2bbox / bbox2distance (reference: generate_proposal.py:1003-1049,
  distance_point_bbox_coder.py:13-79)
- aligned bbox_overlaps with iou/ciou/giou/siou modes (reference:
  wedetect/models/losses/iou_loss.py:13-180), used by the TAL assigner and
  the box loss
- plain pairwise IoU (reference: assigner/utils.py:83-110).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def distance2bbox(points: torch.Tensor,
                  distance: torch.Tensor) -> torch.Tensor:
    """Decode (l, t, r, b) distances at `points` into xyxy boxes.

    points: (..., 2), distance: (..., 4) -> (..., 4).
    """
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox2distance(points: torch.Tensor, bbox: torch.Tensor,
                  max_dis: Optional[float] = None,
                  eps: float = 0.01) -> torch.Tensor:
    """Encode xyxy boxes into (l, t, r, b) distances clamped to
    [0, max_dis - eps] (WeDetectDistancePointBBoxCoder.encode)."""
    d = torch.stack([points[..., 0] - bbox[..., 0],
                     points[..., 1] - bbox[..., 1],
                     bbox[..., 2] - points[..., 0],
                     bbox[..., 3] - points[..., 1]], dim=-1)
    if max_dis is not None:
        d = d.clamp(0.0, max_dis - eps)
    return d


def bbox_overlaps_aligned(pred: torch.Tensor, target: torch.Tensor,
                          iou_mode: str = "ciou", siou_theta: float = 4.0,
                          eps: float = 1e-7) -> torch.Tensor:
    """Elementwise (broadcasting) IoU / CIoU / GIoU / SIoU of xyxy boxes.

    pred / target: (..., 4) -> (...). The CIoU aspect term's `alpha` is
    detached (the YOLOv5 form, `stop_gradient` in JAX), and the result is
    clamped to [-1, 1].
    """
    b1x1, b1y1, b1x2, b1y2 = pred.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = target.unbind(-1)

    overlap = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1))
               .clamp(min=0)
               * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1))
               .clamp(min=0))
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1
    union = w1 * h1 + w2 * h2 - overlap + eps
    # the reference redefines h1 / h2 with +eps after the union
    h1e, h2e = h1 + eps, h2 + eps
    ious = overlap / union

    enc_w = (torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
             ).clamp(min=0)
    enc_h = (torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
             ).clamp(min=0)

    if iou_mode == "iou":
        out = ious
    elif iou_mode == "ciou":
        enclose_area = enc_w ** 2 + enc_h ** 2 + eps
        rho2 = (((b2x1 + b2x2) - (b1x1 + b1x2)) ** 2 / 4
                + ((b2y1 + b2y2) - (b1y1 + b1y2)) ** 2 / 4)
        wh_ratio = (4.0 / math.pi ** 2) * (
            torch.atan(w2 / h2e) - torch.atan(w1 / h1e)) ** 2
        alpha = (wh_ratio / (wh_ratio - ious + (1 + eps))).detach()
        out = ious - (rho2 / enclose_area + alpha * wh_ratio)
    elif iou_mode == "giou":
        convex = enc_w * enc_h + eps
        out = ious - (convex - union) / convex
    elif iou_mode == "siou":
        sigma_cw = (b2x1 + b2x2) / 2 - (b1x1 + b1x2) / 2 + eps
        sigma_ch = (b2y1 + b2y2) / 2 - (b1y1 + b1y2) / 2 + eps
        sigma = torch.sqrt(sigma_cw ** 2 + sigma_ch ** 2)
        sin_alpha = sigma_ch.abs() / sigma
        sin_beta = sigma_cw.abs() / sigma
        sin_alpha = torch.where(sin_alpha <= math.sin(math.pi / 4),
                                sin_alpha, sin_beta)
        angle_cost = torch.cos(torch.arcsin(sin_alpha) * 2 - math.pi / 2)
        rho_x = (sigma_cw / enc_w) ** 2
        rho_y = (sigma_ch / enc_h) ** 2
        gamma = 2 - angle_cost
        distance_cost = ((1 - torch.exp(-gamma * rho_x))
                         + (1 - torch.exp(-gamma * rho_y)))
        omiga_w = (w1 - w2).abs() / torch.maximum(w1, w2)
        omiga_h = (h1 - h2).abs() / torch.maximum(h1, h2)
        shape_cost = ((1 - torch.exp(-omiga_w)) ** siou_theta
                      + (1 - torch.exp(-omiga_h)) ** siou_theta)
        out = ious - (distance_cost + shape_cost) * 0.5
    else:
        raise ValueError(f"unknown iou_mode {iou_mode!r}")
    return out.clamp(-1.0, 1.0)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 eps: float = 1e-9) -> torch.Tensor:
    """Plain IoU matrix between (..., M, 4) and (..., N, 4) -> (..., M, N)
    (yolov6_iou_calculator: areas clipped at 0, eps added to the union)."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    lt = torch.maximum(b1[..., 0:2], b2[..., 0:2])
    rb = torch.minimum(b1[..., 2:4], b2[..., 2:4])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    wh1 = (b1[..., 2:4] - b1[..., 0:2]).clamp(min=0)
    wh2 = (b2[..., 2:4] - b2[..., 0:2]).clamp(min=0)
    union = wh1[..., 0] * wh1[..., 1] + wh2[..., 0] * wh2[..., 1] \
        - overlap + eps
    return overlap / union
