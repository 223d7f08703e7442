"""Box decoding (reference: generate_proposal.py:1003-1049). The IoU
family of `wedetect_tpu.ops.boxes` is used only by training and is not
ported yet."""

from __future__ import annotations

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
