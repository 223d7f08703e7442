"""Sine position embeddings for boxes and image grids.

Port of `wedetect_tpu/ops/sine_embed.py` (reference
qwen3vl_referring.py:13-50, gen_sineembed_for_position): per coordinate
c, dim_t[i] = 10000^(2*(i//2)/dim) with dim = embed_dim // n_coords;
pos = c*2pi / dim_t; sin(pos[0::2]) and cos(pos[1::2]) interleaved
pairwise, coordinates concatenated in the order (y, x[, w, h]).
"""

from __future__ import annotations

import math

import torch


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                       dim=-1)


def _coord_embed(c: torch.Tensor, dim: int) -> torch.Tensor:
    """c (N,) -> (N, dim) interleaved sin/cos."""
    i = torch.arange(dim, dtype=torch.float32, device=c.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(i / 2.0) / dim)
    pos = (c[:, None].float() * (2.0 * math.pi)) / dim_t
    return torch.stack([torch.sin(pos[:, 0::2]), torch.cos(pos[:, 1::2])],
                       dim=2).reshape(c.shape[0], -1)


def sine_embed(pos: torch.Tensor, embed_dim: int) -> torch.Tensor:
    """pos (N, 2) as (x, y) or (N, 4) as (cx, cy, w, h) -> (N, embed_dim),
    coordinates in the order (y, x) / (y, x, w, h)."""
    n_coords = pos.shape[-1]
    dim = embed_dim // n_coords
    x = _coord_embed(pos[:, 0], dim)
    y = _coord_embed(pos[:, 1], dim)
    if n_coords == 2:
        return torch.cat([y, x], dim=-1)
    w = _coord_embed(pos[:, 2], dim)
    h = _coord_embed(pos[:, 3], dim)
    return torch.cat([y, x, w, h], dim=-1)
