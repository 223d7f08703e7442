"""YOLOv5 legacy anchor-based head module.

The port of `wedetect_tpu.nn.yolov5_head` (reference
wedetect/models/dense_heads/yolov5_head.py:36-134, YOLOv5HeadModule):
one 1x1 conv a pyramid level emitting num_base_priors * (5+K) channels,
attributes [tx, ty, tw, th, obj, cls...K] for each prior, with the
YOLOv5 bias init (obj prior: 8 objects a 640 image; cls prior
0.6 / (K - 1)). The convs carry the reference's `convs_pred.{i}` keys.

Each level's output is the conv's, viewed as (B, A, 5+K, H, W) (the
JAX module returns (B, H, W, A, 5+K)); `ops/yolov5.yolov5_decode` and
`train/yolov5_loss.yolov5_loss` read it in that layout.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn


def _bias_init(num_base_priors: int, num_out_attrib: int, stride: int,
                num_classes: int) -> torch.Tensor:
    """The YOLOv5 head's bias init, (A * (5+K),) (reference
    yolov5_head.py:91-106)."""
    b = torch.zeros(num_base_priors, num_out_attrib)
    b[:, 4] += math.log(8 / (640 / stride) ** 2)
    if num_classes > 1:
        b[:, 5:5 + num_classes] += math.log(0.6 / (num_classes - 0.999999))
    return b.reshape(-1)


class YOLOv5HeadModule(nn.Module):
    """Per-level 1x1 prediction convs (the entire v5 head trunk)."""

    def __init__(self, num_classes: int,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 widen_factor: float = 1.0, num_base_priors: int = 3,
                 featmap_strides: Sequence[int] = (8, 16, 32)):
        super().__init__()
        self.num_base_priors = num_base_priors
        attrib = 5 + num_classes
        self.convs_pred = nn.ModuleList(
            nn.Conv2d(int(c * widen_factor), num_base_priors * attrib, 1)
            for c in in_channels)
        with torch.no_grad():
            for conv, s in zip(self.convs_pred, featmap_strides):
                conv.bias.copy_(_bias_init(num_base_priors, attrib, s,
                                           num_classes))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """feats: per-level (B, C, H, W) -> per-level raw
        (B, A, 5+K, H, W) predictions."""
        assert len(feats) == len(self.convs_pred)
        outs = []
        for conv, x in zip(self.convs_pred, feats):
            y = conv(x)
            b, _, h, w = y.shape
            outs.append(y.view(b, self.num_base_priors, -1, h, w))
        return outs
