"""WeDetect head: conv towers + BN-contrastive scoring + DFL regression.

Reference: generate_proposal.py:586-752 and yolo_world_head.py:137-294.
Per pyramid level:
  cls_preds.i : 2x (3x3 conv, BN eps 1e-3, SiLU) -> 1x1 conv -> region
                embedding (embed_dims)
  cls_contrasts.i : BatchNorm(embed, eps 1e-3) . L2norm(w)^T
                    * exp(logit_scale) + bias
  reg_preds.i : 2x (3x3 conv, BN eps 1e-3, SiLU) -> 1x1 conv -> 4*reg_max
                DFL logits -> expectation -> (l, t, r, b) distances
The towers are the checkpoint's flat Sequentials (conv 0, bn 1, conv 3,
bn 4, pred 6). Outputs are flattened over levels to the JAX package's
anchor-major layout (B, A, ...). Every BN of the head (towers and
contrast norms) has torch momentum 0.03 (flax 0.97). Under the int8
mode the towers' 3x3 convs run in int8 (`ops/int8.QuantConv2d`); the
1x1 predictions and the contrastive product stay float, as in JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
from torch import nn

from wedetect_tpu_torch.nn.layers import BatchNorm2d
from wedetect_tpu_torch.ops.int8 import QuantConv2d
from wedetect_tpu_torch.ops.dfl import dfl_expectation

# every BN of the head: eps 1e-3, torch momentum 0.03 (flax 0.97)
HEAD_BN = dict(eps=1e-3, momentum=0.03)


def bn_fold_scale_bias(scale, bias, mean, var, eps: float = 1e-3):
    """Inference BatchNorm as an affine (k, b): y = k*x + b."""
    k = scale / torch.sqrt(var + eps)
    return k, bias - mean * k


class HeadOutputs(NamedTuple):
    """Flattened head outputs over all levels (anchor axis A)."""

    logits: torch.Tensor       # (B, A, K) pre-sigmoid class logits
    dists: torch.Tensor        # (B, A, 4) decoded DFL distances
    embeds: torch.Tensor       # (B, A, C) post-BN region embeddings
    dist_logits: torch.Tensor  # (B, A, 4, reg_max) raw DFL logits


def _normalize(w: torch.Tensor) -> torch.Tensor:
    wf = w.float()
    return (w * torch.rsqrt(wf.square().sum(-1, keepdim=True) + 1e-24)
            .to(w.dtype))


class ContrastiveScore(nn.Module):
    """BN on region embeddings + similarity against the text/prompt
    bank (reference BNContrastiveHead, generate_proposal.py:586-623).

    `normalize_w=False` is the Uni path, where the learned prompt bank
    is used raw (generate_proposal.py:1129-1131). `use_bn=False` is the
    plain ContrastiveHead: L2-normalized embeddings.
    """

    def __init__(self, embed_dims: int, use_bn: bool = True):
        super().__init__()
        self.use_bn = use_bn
        if use_bn:
            self.norm = BatchNorm2d(embed_dims, **HEAD_BN)
        self.bias = nn.Parameter(torch.zeros(()))
        self.logit_scale = nn.Parameter(torch.full(
            (), -1.0 if use_bn else math.log(1 / 0.07)))

    def forward(self, x, w, normalize_w: bool = True):
        """x: (B, C, H, W) embeddings; w: (K, C) or (B, K, C).

        Returns (logits (B, K, H, W), normed x (B, C, H, W))."""
        if self.use_bn:
            x = self.norm(x)
        else:
            x = x * torch.rsqrt(x.float().square().sum(1, keepdim=True)
                                + 1e-24).to(x.dtype)
        if normalize_w:
            w = _normalize(w)
        w = w.to(x.dtype)
        eq = "bchw,kc->bkhw" if w.dim() == 2 else "bchw,bkc->bkhw"
        sim = torch.einsum(eq, x, w)
        logits = sim.float() * self.logit_scale.exp() + self.bias
        return logits, x


def _tower(in_ch: int, hidden: int, out_ch: int) -> nn.Sequential:
    return nn.Sequential(
        QuantConv2d(in_ch, hidden, 3, padding=1, bias=False),
        BatchNorm2d(hidden, **HEAD_BN), nn.SiLU(),
        QuantConv2d(hidden, hidden, 3, padding=1, bias=False),
        BatchNorm2d(hidden, **HEAD_BN), nn.SiLU(),
        nn.Conv2d(hidden, out_ch, 1))


class WeDetectHead(nn.Module):
    """Multi-level head. Levels share structure, not weights."""

    def __init__(self, in_channels: Sequence[int], embed_dims: int = 768,
                 reg_max: int = 16, cls_hidden: int = 256,
                 reg_hidden: int = 64, use_bn_head: bool = True):
        super().__init__()
        self.embed_dims = embed_dims
        self.reg_max = reg_max
        self.cls_preds = nn.ModuleList(
            _tower(c, cls_hidden, embed_dims) for c in in_channels)
        self.reg_preds = nn.ModuleList(
            _tower(c, reg_hidden, 4 * reg_max) for c in in_channels)
        self.cls_contrasts = nn.ModuleList(
            ContrastiveScore(embed_dims, use_bn_head) for _ in in_channels)

    def forward(self, feats, w, normalize_w: bool = True) -> HeadOutputs:
        logits_l, dists_l, embeds_l, dl_l = [], [], [], []
        for f, cls_pred, reg_pred, contrast in zip(
                feats, self.cls_preds, self.reg_preds, self.cls_contrasts):
            b = f.shape[0]
            logit, embed = contrast(cls_pred(f), w, normalize_w)
            dist_logits = reg_pred(f).flatten(2).transpose(1, 2)  # (B,A,4R)
            logits_l.append(logit.flatten(2).transpose(1, 2))
            embeds_l.append(embed.flatten(2).transpose(1, 2))
            dists_l.append(dfl_expectation(dist_logits, self.reg_max))
            dl_l.append(dist_logits.reshape(b, -1, 4, self.reg_max))
        return HeadOutputs(logits=torch.cat(logits_l, 1),
                           dists=torch.cat(dists_l, 1),
                           embeds=torch.cat(embeds_l, 1),
                           dist_logits=torch.cat(dl_l, 1))
