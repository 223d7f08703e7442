"""Distribution Focal Loss (DFL) expectation decode (reference:
yolo_world_head.py:280-289)."""

from __future__ import annotations

import torch


def dfl_expectation(dist_logits: torch.Tensor,
                    reg_max: int = 16) -> torch.Tensor:
    """(..., 4*reg_max) logits -> (..., 4) expected distances.

    The 4*reg_max channels factor as (side, bin): the first reg_max
    channels are the bins of the first side.
    """
    shape = dist_logits.shape[:-1] + (4, reg_max)
    probs = torch.softmax(dist_logits.reshape(shape).float(), dim=-1)
    proj = torch.arange(reg_max, dtype=torch.float32,
                        device=dist_logits.device)
    return torch.einsum("...sb,b->...s", probs, proj)
