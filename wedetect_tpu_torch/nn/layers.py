"""Basic conv bricks in NCHW: Conv+BN+act, 1x1 conv with bias, 2x
transposed conv, BottleRep, RepBlock, BepC3, BiFusion, RepVGGBlock.

Module and parameter names are the reference checkpoint's
(generate_proposal.py:317-465: ConvBNReLU/ConvBNSiLU wrap a `block`
holding `conv` and `bn`; Transpose holds `upsample_transpose`), so a
torch state dict loads as it is. Padding is the symmetric k//2 of the
reference. BatchNorm eps is 1e-5 in the neck and 1e-3 in the head.

`BatchNorm2d` is torch's with flax's running-statistics update: in
train mode the running mean and variance move towards the batch's mean
and *biased* variance, `ra = (1 - momentum) * ra + momentum * batch`
(flax momentum 1 - `momentum`: torch 0.1 in the neck, 0.03 in the head).
In eval mode it is torch's. The legacy necks (`nn/yolo_world_pafpn.py`)
use mmcv ConvModule's keys (`<name>.conv`, `<name>.bn`, no `block`)
with eps 1e-3 and torch momentum 0.03.

Every Conv+BN conv is an `ops/int8.QuantConv2d`: int8 under the model's
int8 mode (`ModelCfg.quant_int8`), as JAX's ConvBN takes `quant`; the
transposed conv stays float.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from wedetect_tpu_torch.ops.int8 import QuantConv2d

ACTS = {"silu": nn.SiLU, "relu": nn.ReLU, None: nn.Identity}


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode update of the running statistics
    is flax's: the biased batch variance (torch's is unbiased,
    n / (n - 1) larger for n = B * H * W values a channel). The batch
    statistics are taken in f32; `num_batches_tracked` is not counted
    (flax has no counter). Eval mode is torch's, unchanged.

    `group` (a `parallel/collectives.Group`, set by
    `train_step.attach_mesh`) makes the train-mode statistics those of
    the global batch, as flax takes them over a sharded global batch:
    each rank's per-channel count, mean and biased variance are gathered
    over the data group by an all_reduce that autograd differentiates
    (so the backward is SyncBatchNorm's) and combined by Chan's rule.
    flax forms var = E[x^2] - E[x]^2 in one pass; the combination avoids
    that subtraction's cancellation where a channel's mean is far larger
    than its spread (WeDetect-Base's deep layers on an H100: gradients
    1e-3 off the one-process step's)."""

    group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.group is not None and self.group.size > 1:
            return self._global_forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    def _global_forward(self, x):
        xf = x.float()
        c = xf.shape[1]
        g = self.group
        # each rank's count, mean and biased variance (two-pass, as the
        # one-process path takes them), gathered by an all_reduce of a
        # zero-filled (ranks, 2C + 1) buffer that autograd differentiates
        var_r, mean_r = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        n_r = torch.full((1,), float(xf.numel() // c), device=x.device)
        mine = torch.cat([mean_r, var_r, n_r])
        buf = torch.zeros(g.size, 2 * c + 1, device=x.device)
        buf = buf.index_put((torch.tensor([g.index], device=x.device),),
                            mine[None])
        stats = g.all_reduce_grad(buf)
        means, vars_, n = stats[:, :c], stats[:, c:2 * c], stats[:, 2 * c:]
        total = n.sum()
        mean = (n * means).sum(0) / total
        # Chan's combination: sums of non-negative terms, no E[x^2] -
        # E[x]^2 cancellation where a channel's mean dwarfs its spread
        var = (n * (vars_ + (means - mean).square())).sum(0) / total
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
        shape = (1, c, 1, 1)
        y = ((xf - mean.view(shape))
             * torch.rsqrt(var.view(shape) + self.eps)
             * self.weight.view(shape) + self.bias.view(shape))
        return y.to(x.dtype)


class ConvModule(nn.Module):
    """Conv2d(bias=False) + BatchNorm2d + activation (`act=None`: none).
    BN momentum is torch's (0.1 here; flax's is 1 - it)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, act: str | None = "silu",
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1):
        super().__init__()
        self.conv = QuantConv2d(in_ch, out_ch, kernel, stride, kernel // 2,
                                bias=False)
        self.bn = BatchNorm2d(out_ch, eps=bn_eps, momentum=bn_momentum)
        self.act = ACTS[act]()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class ConvBN(nn.Module):
    """The reference's ConvBNReLU / ConvBNSiLU: a ConvModule under
    `block` (keys `<name>.block.conv.weight`, `<name>.block.bn.*`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, act: str = "silu", bn_eps: float = 1e-5):
        super().__init__()
        self.block = ConvModule(in_ch, out_ch, kernel, stride, act, bn_eps)

    def forward(self, x):
        return self.block(x)


class Conv1x1(nn.Module):
    """Plain conv with bias under `conv` (prediction layers; mmcv
    ConvModule without norm or activation)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, 1, kernel // 2,
                              bias=True)

    def forward(self, x):
        return self.conv(x)


class Transpose2x(nn.Module):
    """ConvTranspose2d(kernel=2, stride=2, bias=True): exact 2x upsample
    on the torch (in_ch, out_ch, 2, 2) weight."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.upsample_transpose = nn.ConvTranspose2d(in_ch, out_ch, 2, 2,
                                                     bias=True)

    def forward(self, x):
        return self.upsample_transpose(x)


class BottleRep(nn.Module):
    """Two 3x3 ConvBNSiLU + learnable-alpha residual (reference
    generate_proposal.py:387-405, weight=True). Every BottleRep of the
    neck keeps its width, so the residual is always on."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = ConvBN(ch, ch, 3, 1, "silu")
        self.conv2 = ConvBN(ch, ch, 3, 1, "silu")
        self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return self.conv2(self.conv1(x)) + self.alpha.to(x.dtype) * x


class RepBlock(nn.Module):
    """Stack of BottleReps: 1 + max(n//2 - 1, 0) blocks (reference
    generate_proposal.py:369-384)."""

    def __init__(self, ch: int, n: int = 1):
        super().__init__()
        self.conv1 = BottleRep(ch)
        self.block = nn.ModuleList(
            BottleRep(ch) for _ in range(max(n // 2 - 1, 0)))

    def forward(self, x):
        x = self.conv1(x)
        for blk in self.block:
            x = blk(x)
        return x


class BepC3(nn.Module):
    """CSPStackRep block: split 1x1s, RepBlock branch, concat, 1x1 out
    (reference generate_proposal.py:408-423, hidden width e = 0.5)."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1):
        super().__init__()
        c_ = out_ch // 2
        self.cv1 = ConvBN(in_ch, c_, 1, 1, "silu")
        self.cv2 = ConvBN(in_ch, c_, 1, 1, "silu")
        self.cv3 = ConvBN(2 * c_, out_ch, 1, 1, "silu")
        self.m = RepBlock(c_, n=n)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class BiFusion(nn.Module):
    """3-way fusion: cat(upsample(x0), cv1(x1), downsample(cv2(x2))) ->
    cv3, all ConvBNReLU (reference generate_proposal.py:442-465)."""

    def __init__(self, in_chs, out_ch: int):
        super().__init__()
        c0, c1, c2 = in_chs
        self.cv1 = ConvBN(c1, out_ch, 1, 1, "relu")
        self.cv2 = ConvBN(c2, out_ch, 1, 1, "relu")
        self.cv3 = ConvBN(3 * out_ch, out_ch, 1, 1, "relu")
        self.upsample = Transpose2x(c0, out_ch)
        self.downsample = ConvBN(out_ch, out_ch, 3, 2, "relu")

    def forward(self, x0, x1, x2):
        return self.cv3(torch.cat([self.upsample(x0), self.cv1(x1),
                                   self.downsample(self.cv2(x2))], 1))


class RepVGGBlock(nn.Module):
    """3x3 ConvBN + 1x1 ConvBN + identity BN (only when in == out and
    stride 1), summed, then ReLU (reference yolo_world_pafpn.py:211-334).
    `deploy=True` is the fused form: one 3x3 conv with bias, `reparam`,
    whose weights `repvgg_fuse` makes from a trained block. BN eps 1e-5,
    torch momentum 0.1."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 deploy: bool = False):
        super().__init__()
        if deploy:
            self.reparam = nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=True)
            return
        self.rbr_dense = ConvModule(in_ch, out_ch, 3, stride, None)
        self.rbr_1x1 = ConvModule(in_ch, out_ch, 1, stride, None)
        if in_ch == out_ch and stride == 1:
            self.rbr_identity = BatchNorm2d(in_ch)

    def forward(self, x):
        if hasattr(self, "reparam"):
            return F.relu(self.reparam(x))
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if hasattr(self, "rbr_identity"):
            y = y + self.rbr_identity(x)
        return F.relu(y)


def _fold_bn(bn: nn.BatchNorm2d):
    """BN in eval mode as a per-channel scale and shift."""
    k = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return k, bn.bias - bn.running_mean * k


def repvgg_fuse(block: RepVGGBlock) -> dict:
    """Fold a train-form RepVGGBlock's branches into the deploy 3x3
    conv: {"reparam.weight" (O, I, 3, 3), "reparam.bias" (O,)}, the
    state dict of `RepVGGBlock(..., deploy=True)` (the algebra of
    wedetect_tpu/nn/layers.py:284-307)."""
    with torch.no_grad():
        k3, b3 = _fold_bn(block.rbr_dense.bn)
        k1, b1 = _fold_bn(block.rbr_1x1.bn)
        weight = (block.rbr_dense.conv.weight * k3[:, None, None, None]
                  + F.pad(block.rbr_1x1.conv.weight
                          * k1[:, None, None, None], (1, 1, 1, 1)))
        bias = b3 + b1
        if hasattr(block, "rbr_identity"):
            kid, bid = _fold_bn(block.rbr_identity)
            cin = weight.shape[1]
            eye = torch.zeros_like(weight)
            eye[:, :, 1, 1] = torch.eye(cin, dtype=weight.dtype,
                                        device=weight.device)
            weight = weight + eye * kid[:, None, None, None]
            bias = bias + bid
    return {"reparam.weight": weight.clone(), "reparam.bias": bias.clone()}
