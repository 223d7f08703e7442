"""CSPRepBiFPAN neck in NCHW (reference generate_proposal.py:470-578).

    fpn_out0 = reduce_layer0(c4)                      # 256s @ s32
    f_out0   = Rep_p4(Bifusion0(fpn_out0, c3, c2))    # 256s @ s16
    fpn_out1 = reduce_layer1(f_out0)                  # 128s @ s16
    P3       = Rep_p3(Bifusion1(fpn_out1, c2, c1))    # 128s @ s8
    P4       = Rep_n3(cat(downsample2(P3), fpn_out1)) # 256s @ s16
    P5       = Rep_n4(cat(downsample1(P4), fpn_out0)) # 512s @ s32

Channels are the base list scaled by `scale` with int() truncation;
reduce/downsample bricks are ReLU, BepC3 stacks SiLU.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from wedetect_tpu_torch.nn.layers import BepC3, BiFusion, ConvBN


def neck_out_channels(scale: float):
    """(P3, P4, P5) channels of the neck at `scale`."""
    return tuple(int(c * scale) for c in (128, 256, 512))


class CSPRepBiFPANNeck(nn.Module):
    def __init__(self, in_channels: Sequence[int], scale: float = 1.0,
                 repeats: int = 12):
        super().__init__()
        c1, c2, c3, c4 = in_channels
        ch = lambda c: int(c * scale)  # noqa: E731
        n = repeats
        self.reduce_layer0 = ConvBN(c4, ch(256), 1, 1, "relu")
        self.Bifusion0 = BiFusion((ch(256), c3, c2), ch(256))
        self.Rep_p4 = BepC3(ch(256), ch(256), n=n)
        self.reduce_layer1 = ConvBN(ch(256), ch(128), 1, 1, "relu")
        self.Bifusion1 = BiFusion((ch(128), c2, c1), ch(128))
        self.Rep_p3 = BepC3(ch(128), ch(128), n=n)
        self.downsample2 = ConvBN(ch(128), ch(128), 3, 2, "relu")
        self.Rep_n3 = BepC3(2 * ch(128), ch(256), n=n)
        self.downsample1 = ConvBN(ch(256), ch(256), 3, 2, "relu")
        self.Rep_n4 = BepC3(2 * ch(256), ch(512), n=n)

    def forward(self, feats):
        c1, c2, c3, c4 = feats
        fpn_out0 = self.reduce_layer0(c4)
        f_out0 = self.Rep_p4(self.Bifusion0(fpn_out0, c3, c2))
        fpn_out1 = self.reduce_layer1(f_out0)
        p3 = self.Rep_p3(self.Bifusion1(fpn_out1, c2, c1))
        p4 = self.Rep_n3(torch.cat([self.downsample2(p3), fpn_out1], 1))
        p5 = self.Rep_n4(torch.cat([self.downsample1(p4), fpn_out0], 1))
        return p3, p4, p5
