"""YOLOv5 legacy anchor-based decode.

The port of `wedetect_tpu.ops.yolov5` (reference
wedetect/models/dense_heads/yolov5_head.py, the anchor-based ancestor
kept for API parity; WeDetect itself is anchor-free): per level, 3
base anchors; raw predictions decode as

    xy = (sigmoid(txy) * 2 - 0.5 + grid) * stride
    wh = (sigmoid(twh) * 2)^2 * anchor
    score = sigmoid(obj) * sigmoid(cls)

followed by the shared selection and NMS (`ops/nms.batched_static_nms`).
The head's raw output stays channel-major, (B, A, 5+K, H, W); the
decode flattens anchors row-major over (H, W, A), the JAX package's
order, so an anchor index means the same box in both packages.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# the standard YOLOv5 COCO anchors (w, h) per level, strides 8/16/32
DEFAULT_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)


def yolov5_decode_level(pred: torch.Tensor, anchors, stride: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pred (B, A, 5+K, H, W) raw -> (boxes (B, H*W*A, 4) xyxy,
    scores (B, H*W*A, K)), in f32."""
    b, a, _, h, w = pred.shape
    p = torch.sigmoid(pred.float()).permute(0, 3, 4, 1, 2)  # B, H, W, A, C
    gx = torch.arange(w, dtype=torch.float32, device=p.device)[None, :,
                                                               None]
    gy = torch.arange(h, dtype=torch.float32, device=p.device)[:, None,
                                                               None]
    anc = torch.as_tensor(anchors, dtype=torch.float32, device=p.device)
    cx = (p[..., 0] * 2 - 0.5 + gx) * stride
    cy = (p[..., 1] * 2 - 0.5 + gy) * stride
    bw = (p[..., 2] * 2) ** 2 * anc[:, 0]
    bh = (p[..., 3] * 2) ** 2 * anc[:, 1]
    boxes = torch.stack([cx - bw / 2, cy - bh / 2,
                         cx + bw / 2, cy + bh / 2], dim=-1)
    scores = p[..., 5:] * p[..., 4:5]
    return boxes.reshape(b, h * w * a, 4), scores.reshape(b, h * w * a, -1)


def yolov5_decode(preds: Sequence[torch.Tensor], anchors=DEFAULT_ANCHORS,
                  strides: Sequence[int] = (8, 16, 32)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-level decode -> concatenated (B, N, 4) / (B, N, K)."""
    boxes, scores = zip(*(yolov5_decode_level(p, anc, s)
                          for p, anc, s in zip(preds, anchors, strides)))
    return torch.cat(boxes, 1), torch.cat(scores, 1)
