"""ConvNeXt vision backbone in NCHW.

Reference: generate_proposal.py:138-299 and mm_backbone.py:82-255. Stem
4x4/s4 conv + LayerNorm, three LayerNorm + 2x2/s2 downsample layers,
stages of blocks (7x7 depthwise conv -> LayerNorm -> Linear 4x -> exact
GELU -> Linear -> layer-scale gamma -> residual). Emits c1..c4 at
strides 4/8/16/32. Keys are the reference's (`downsample_layers.i.j`,
`stages.i.j.*`). LayerNorm (eps 1e-6) is over channels: channels-first
for the stem and downsample norms, channels-last inside a block, where
the block runs its Linears on the permuted tensor as the reference does.
Statistics are taken in f32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel axis of an NCHW tensor."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(1, keepdim=True)
        var = (xf - mean).square().mean(1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x):
        y = self.dwconv(x).permute(0, 2, 3, 1)
        y = F.layer_norm(y.float(), y.shape[-1:], self.norm.weight,
                         self.norm.bias, self.norm.eps).to(y.dtype)
        y = F.gelu(self.pwconv1(y).float(), approximate="none").to(y.dtype)
        y = self.pwconv2(y) * self.gamma.to(y.dtype)
        return x + y.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    """4-stage ConvNeXt returning (c1, c2, c3, c4) NCHW feature maps."""

    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024)):
        super().__init__()
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv2d(3, dims[0], 4, stride=4), LayerNorm2d(dims[0]))])
        for i in (1, 2, 3):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm2d(dims[i - 1]),
                nn.Conv2d(dims[i - 1], dims[i], 2, stride=2)))
        self.stages = nn.ModuleList(
            nn.Sequential(*(ConvNeXtBlock(dims[i]) for _ in range(d)))
            for i, d in enumerate(depths))

    def forward(self, x):
        outs = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = stage(down(x))
            outs.append(x)
        return tuple(outs)
