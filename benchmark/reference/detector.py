"""Plain WeDetect / WeDetect-Uni detector: the benchmark's reference.

The published graph (WeChatCV/WeDetect generate_proposal.py and
yolo_world_head.py), written out in plain PyTorch in float32:

    uint8 NHWC image -> /255 -> ConvNeXt -> CSPRepBiFPAN neck -> head
    -> BN-contrastive class logits, DFL box distances -> decode
    -> sigmoid -> top nms_pre candidates -> class-aware greedy NMS
    -> un-letterbox -> clamp

Module and parameter names are the reference checkpoint's, so one state
dict loads into this model and into the program under test. Nothing
here imports the program: there are no kernels, no int8 mode, no
autocast, no training paths. Selection is a stable sort over every
candidate and NMS a greedy loop over one image at a time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class DetCfg:
    depths: Sequence[int] = (3, 3, 27, 3)
    dims: Sequence[int] = (128, 256, 512, 1024)
    neck_scale: float = 1.0
    neck_repeats: int = 12
    embed_dims: int = 768
    reg_max: int = 16
    strides: Sequence[int] = (8, 16, 32)
    cls_hidden: int = 256
    reg_hidden: int = 64
    img_size: Sequence[int] = (640, 640)
    num_prompts: int = 0
    score_thr: float = 0.001
    nms_pre: int = 30000
    nms_iou_thr: float = 0.7
    max_per_img: int = 300


# ------------------------------------------------------------- backbone
class LayerNorm2d(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(1, keepdim=True)
        var = (x - mean).square().mean(1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        y = self.norm(self.dwconv(x).permute(0, 2, 3, 1))
        y = self.pwconv2(F.gelu(self.pwconv1(y))) * self.gamma
        return x + y.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    def __init__(self, depths, dims):
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
        return outs


# ----------------------------------------------------------------- neck
class ConvModule(nn.Module):
    def __init__(self, cin, cout, k=3, s=1, act="silu", eps=1e-5):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=eps)
        self.act = {"silu": nn.SiLU(), "relu": nn.ReLU()}[act]

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k=3, s=1, act="silu"):
        super().__init__()
        self.block = ConvModule(cin, cout, k, s, act)

    def forward(self, x):
        return self.block(x)


class Transpose2x(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.upsample_transpose = nn.ConvTranspose2d(cin, cout, 2, 2)

    def forward(self, x):
        return self.upsample_transpose(x)


class BottleRep(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv1 = ConvBN(ch, ch)
        self.conv2 = ConvBN(ch, ch)
        self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return self.conv2(self.conv1(x)) + self.alpha * x


class RepBlock(nn.Module):
    def __init__(self, ch, n):
        super().__init__()
        self.conv1 = BottleRep(ch)
        self.block = nn.ModuleList(BottleRep(ch)
                                   for _ in range(max(n // 2 - 1, 0)))

    def forward(self, x):
        x = self.conv1(x)
        for b in self.block:
            x = b(x)
        return x


class BepC3(nn.Module):
    def __init__(self, cin, cout, n):
        super().__init__()
        c_ = cout // 2
        self.cv1 = ConvBN(cin, c_, 1)
        self.cv2 = ConvBN(cin, c_, 1)
        self.cv3 = ConvBN(2 * c_, cout, 1)
        self.m = RepBlock(c_, n)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class BiFusion(nn.Module):
    def __init__(self, in_chs, cout):
        super().__init__()
        c0, c1, c2 = in_chs
        self.cv1 = ConvBN(c1, cout, 1, act="relu")
        self.cv2 = ConvBN(c2, cout, 1, act="relu")
        self.cv3 = ConvBN(3 * cout, cout, 1, act="relu")
        self.upsample = Transpose2x(c0, cout)
        self.downsample = ConvBN(cout, cout, 3, 2, act="relu")

    def forward(self, x0, x1, x2):
        return self.cv3(torch.cat([self.upsample(x0), self.cv1(x1),
                                   self.downsample(self.cv2(x2))], 1))


class Neck(nn.Module):
    def __init__(self, chans, scale, n):
        super().__init__()
        c1, c2, c3, c4 = chans
        ch = lambda c: int(c * scale)  # noqa: E731
        self.reduce_layer0 = ConvBN(c4, ch(256), 1, act="relu")
        self.Bifusion0 = BiFusion((ch(256), c3, c2), ch(256))
        self.Rep_p4 = BepC3(ch(256), ch(256), n)
        self.reduce_layer1 = ConvBN(ch(256), ch(128), 1, act="relu")
        self.Bifusion1 = BiFusion((ch(128), c2, c1), ch(128))
        self.Rep_p3 = BepC3(ch(128), ch(128), n)
        self.downsample2 = ConvBN(ch(128), ch(128), 3, 2, act="relu")
        self.Rep_n3 = BepC3(2 * ch(128), ch(256), n)
        self.downsample1 = ConvBN(ch(256), ch(256), 3, 2, act="relu")
        self.Rep_n4 = BepC3(2 * ch(256), ch(512), n)

    def forward(self, feats):
        c1, c2, c3, c4 = feats
        f0 = self.reduce_layer0(c4)
        fo = self.Rep_p4(self.Bifusion0(f0, c3, c2))
        f1 = self.reduce_layer1(fo)
        p3 = self.Rep_p3(self.Bifusion1(f1, c2, c1))
        p4 = self.Rep_n3(torch.cat([self.downsample2(p3), f1], 1))
        p5 = self.Rep_n4(torch.cat([self.downsample1(p4), f0], 1))
        return p3, p4, p5


# ----------------------------------------------------------------- head
def _tower(cin, hidden, cout):
    return nn.Sequential(
        nn.Conv2d(cin, hidden, 3, padding=1, bias=False),
        nn.BatchNorm2d(hidden, eps=1e-3), nn.SiLU(),
        nn.Conv2d(hidden, hidden, 3, padding=1, bias=False),
        nn.BatchNorm2d(hidden, eps=1e-3), nn.SiLU(),
        nn.Conv2d(hidden, cout, 1))


class ContrastiveScore(nn.Module):
    """BN on the region embeddings, dot with the class embeddings,
    times exp(logit_scale), plus bias."""

    def __init__(self, dims):
        super().__init__()
        self.norm = nn.BatchNorm2d(dims, eps=1e-3)
        self.bias = nn.Parameter(torch.zeros(()))
        self.logit_scale = nn.Parameter(torch.full((), -1.0))
        # what the product's operands go through (reference/lowp.py
        # rounds them to fp8 for the control)
        self.operand = None

    def forward(self, x, w, normalize_w):
        x = self.norm(x)
        if normalize_w:
            w = w / torch.sqrt(w.square().sum(-1, keepdim=True) + 1e-24)
        op = self.operand or (lambda t: t)
        sim = torch.einsum("bchw,kc->bkhw", op(x), op(w))
        return sim * self.logit_scale.exp() + self.bias, x


class Head(nn.Module):
    def __init__(self, chans, c: DetCfg):
        super().__init__()
        self.cls_preds = nn.ModuleList(
            _tower(ch, c.cls_hidden, c.embed_dims) for ch in chans)
        self.reg_preds = nn.ModuleList(
            _tower(ch, c.reg_hidden, 4 * c.reg_max) for ch in chans)
        self.cls_contrasts = nn.ModuleList(
            ContrastiveScore(c.embed_dims) for _ in chans)


class Detector(nn.Module):
    """backbone + neck + head (+ the Uni prompt bank `embeddings`)."""

    def __init__(self, c: DetCfg):
        super().__init__()
        self.c = c
        self.backbone = ConvNeXt(c.depths, c.dims)
        self.neck = Neck(c.dims, c.neck_scale, c.neck_repeats)
        self.bbox_head = Head(
            tuple(int(x * c.neck_scale) for x in (128, 256, 512)), c)
        if c.num_prompts:
            self.embeddings = nn.Parameter(
                torch.empty(c.num_prompts, c.embed_dims))

    def forward(self, images_u8: torch.Tensor, w: Optional[torch.Tensor]):
        """images_u8 (B, H, W, 3) uint8; w (K, C) class embeddings (None
        for Uni: the prompt bank, used raw). Returns per-anchor
        (logits (B, A, K), boxes (B, A, 4) letterboxed xyxy,
        embeds (B, A, C))."""
        c = self.c
        x = images_u8.permute(0, 3, 1, 2).float() / 255.0
        feats = self.neck(self.backbone(x))
        normalize_w = w is not None
        if w is None:
            w = self.embeddings
        h, wd = x.shape[2:]
        logits, boxes, embeds = [], [], []
        head = self.bbox_head
        for f, s, cls, reg, con in zip(feats, c.strides, head.cls_preds,
                                       head.reg_preds, head.cls_contrasts):
            lg, em = con(cls(f), w, normalize_w)
            b = f.shape[0]
            logits.append(lg.flatten(2).transpose(1, 2))
            embeds.append(em.flatten(2).transpose(1, 2))
            d = reg(f).flatten(2).transpose(1, 2)
            d = d.reshape(b, -1, 4, c.reg_max).softmax(-1)
            d = d @ torch.arange(c.reg_max, dtype=d.dtype, device=d.device)
            gh, gw = h // s, wd // s
            ys, xs = torch.meshgrid(
                (torch.arange(gh, device=d.device) + 0.5) * s,
                (torch.arange(gw, device=d.device) + 0.5) * s,
                indexing="ij")
            px, py = xs.reshape(-1), ys.reshape(-1)
            d = d * s
            boxes.append(torch.stack([px - d[..., 0], py - d[..., 1],
                                      px + d[..., 2], py + d[..., 3]], -1))
        return torch.cat(logits, 1), torch.cat(boxes, 1), torch.cat(embeds, 1)


# ------------------------------------------------------- post-processing
def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between (N, 4) and (M, 4) xyxy boxes -> (N, M)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda x: (x[:, 2:] - x[:, :2]).clamp(min=0).prod(-1)  # noqa
    union = area(a)[:, None] + area(b)[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def select_and_nms(scores: torch.Tensor, boxes: torch.Tensor, c: DetCfg):
    """One image: scores (A, K) post-sigmoid, boxes (A, 4). Every
    (anchor, class) pair above score_thr is a candidate; the nms_pre
    best by a stable descending sort (ties by anchor-major flat index)
    go through greedy class-aware NMS, one kept box at a time, until
    max_per_img are kept. Returns (anchors, labels, scores) of the kept,
    in keep order."""
    a, k = scores.shape
    flat = scores.reshape(-1)
    idx = torch.nonzero(flat > c.score_thr)[:, 0]
    order = torch.sort(flat[idx], descending=True, stable=True).indices
    idx = idx[order][:c.nms_pre]
    anc, lab, sc = idx // k, idx % k, flat[idx]
    bx = boxes[anc]
    alive = torch.ones(len(idx), dtype=torch.bool, device=scores.device)
    kept = []
    while len(kept) < c.max_per_img:
        rest = torch.nonzero(alive)[:, 0]
        if len(rest) == 0:
            break
        i = int(rest[0])
        kept.append(i)
        alive[i] = False
        sup = (iou_matrix(bx[i:i + 1], bx)[0] > c.nms_iou_thr) \
            & (lab == lab[i])
        alive &= ~sup
    kept = torch.tensor(kept, dtype=torch.long, device=scores.device)
    return anc[kept], lab[kept], sc[kept]


def unletterbox(boxes, scale_factor, pad, ori_hw):
    """Letterboxed xyxy -> original image coordinates, clamped.
    scale_factor (w_ratio, h_ratio); pad [top, bottom, left, right]."""
    off = boxes.new_tensor([pad[2], pad[0], pad[2], pad[0]])
    sf = boxes.new_tensor([scale_factor[0], scale_factor[1]] * 2)
    hi = boxes.new_tensor([ori_hw[1], ori_hw[0]] * 2)
    return torch.minimum(((boxes - off) / sf).clamp(min=0), hi)


def logit_scale_step(logits: torch.Tensor) -> float:
    """The step added to every level's logit_scale of a random head so
    that its logits (bias 0) spread by about 2 across classes, as a
    trained checkpoint's do."""
    return math.log(2.0 / float(logits.std(dim=-1).mean()))


def max_kth_logit(logits: torch.Tensor, scale: float, t: int) -> float:
    """The largest per-anchor t-th best logit once scaled by exp(scale)
    (the logits scale linearly in exp(logit_scale) while the bias is
    0)."""
    return float(torch.topk(logits * math.exp(scale), t,
                            dim=-1).values[..., -1].max())


def bias_step(kth: float, score_thr: float, margin: float) -> float:
    """The step added to every level's bias that puts the highest t-th
    logit `margin` below logit(score_thr): no anchor then holds t
    candidates, the sparse score profile of a trained checkpoint."""
    return math.log(score_thr / (1 - score_thr)) - kth - margin
