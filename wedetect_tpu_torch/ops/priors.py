"""Multi-level anchor-point (prior) generation.

Priors of a level with stride s and feature map (h, w) are the pixel
centres ((x + 0.5) * s, (y + 0.5) * s) in row-major order, concatenated
over levels (reference MlvlPointGenerator, offset 0.5). They depend only
on shapes, so they are numpy constants.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def single_level_priors(feat_size: Tuple[int, int], stride: int,
                        offset: float = 0.5) -> np.ndarray:
    """Priors of one level, shape (h*w, 2) as (x, y)."""
    h, w = feat_size
    xs = (np.arange(w, dtype=np.float32) + offset) * stride
    ys = (np.arange(h, dtype=np.float32) + offset) * stride
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1)


def grid_priors(feat_sizes: Sequence[Tuple[int, int]],
                strides: Sequence[int],
                offset: float = 0.5) -> List[np.ndarray]:
    """Per-level priors, each (h*w, 2)."""
    assert len(feat_sizes) == len(strides)
    return [single_level_priors(fs, s, offset)
            for fs, s in zip(feat_sizes, strides)]


def flat_priors_and_strides(feat_sizes: Sequence[Tuple[int, int]],
                            strides: Sequence[int],
                            offset: float = 0.5):
    """Concatenated priors (A, 2) and per-anchor stride vector (A,)."""
    levels = grid_priors(feat_sizes, strides, offset)
    flat = np.concatenate(levels, axis=0)
    stride_vec = np.concatenate([
        np.full((lvl.shape[0],), s, dtype=np.float32)
        for lvl, s in zip(levels, strides)
    ])
    return flat, stride_vec
