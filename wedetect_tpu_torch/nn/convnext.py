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

Stochastic depth (training only; mm_backbone.py:94-124): block k of n
drops its residual branch per sample with rate `drop_path_rate * k /
(n - 1)`, scaling the kept ones by 1 / keep. The mask is drawn from an
explicit `torch.Generator` that the caller passes to `forward` (the
train step seeds one per step); the global RNG is never used. At rate 0
or in eval mode a block is exactly the identity on that branch. Under a
data group (`ConvNeXtBlock.group`, a `parallel/collectives.Group` set
by `train_step.attach_mesh`) a block draws the global batch's mask and
keeps this rank's rows of it, so the ranks drop what one process would
drop on the whole batch.

Under the int8 mode the block MLP's Linears (`pwconv1`, `pwconv2`) run
in int8 (`ops/int8.QuantLinear`); the stem, the downsampling convs and
the 7x7 depthwise conv stay float, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wedetect_tpu_torch.ops.int8 import QuantLinear


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


def drop_path(y: torch.Tensor, rate: float,
              generator: Optional[torch.Generator],
              group=None) -> torch.Tensor:
    """Zero whole samples of `y` with probability `rate` and scale the
    kept ones by 1 / (1 - rate); the mask is drawn from `generator`.
    With a data `group`, `y` is member `group.index`'s block of a global
    batch of `group.size` such blocks: the global mask is drawn and this
    block's rows of it are used."""
    if generator is None:
        raise ValueError("drop path at rate > 0 needs a torch.Generator")
    keep = 1.0 - rate
    n = y.shape[0]
    parts = 1 if group is None else group.size
    shape = (n * parts,) + (1,) * (y.dim() - 1)
    mask = torch.rand(shape, generator=generator, device=y.device) < keep
    if parts > 1:
        mask = mask[group.index * n:(group.index + 1) * n]
    return torch.where(mask, y / keep, torch.zeros_like(y))


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6,
                 drop_path: float = 0.0):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = QuantLinear(dim, 4 * dim)
        self.pwconv2 = QuantLinear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))
        self.drop_path = drop_path
        self.group = None

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = self.dwconv(x).permute(0, 2, 3, 1)
        y = F.layer_norm(y.float(), y.shape[-1:], self.norm.weight,
                         self.norm.bias, self.norm.eps).to(y.dtype)
        y = F.gelu(self.pwconv1(y).float(), approximate="none").to(y.dtype)
        y = self.pwconv2(y) * self.gamma.to(y.dtype)
        if self.drop_path > 0 and self.training:
            y = drop_path(y, self.drop_path, generator, self.group)
        return x + y.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    """4-stage ConvNeXt returning (c1, c2, c3, c4) NCHW feature maps."""

    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024),
                 drop_path_rate: float = 0.0):
        super().__init__()
        total = sum(depths)
        rates = iter(drop_path_rate * k / max(total - 1, 1)
                     for k in range(total))
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv2d(3, dims[0], 4, stride=4), LayerNorm2d(dims[0]))])
        for i in (1, 2, 3):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm2d(dims[i - 1]),
                nn.Conv2d(dims[i - 1], dims[i], 2, stride=2)))
        self.stages = nn.ModuleList(
            nn.Sequential(*(ConvNeXtBlock(dims[i], drop_path=next(rates))
                            for _ in range(d)))
            for i, d in enumerate(depths))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        outs = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = down(x)
            for block in stage:
                x = block(x, generator)
            outs.append(x)
        return tuple(outs)
