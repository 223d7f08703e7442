"""Inference-time Conv+BN folding (the 'deploy' / Rep fusion pass) and
the text-head bake, on the port's state dict (the reference
checkpoint's key names). The port of `wedetect_tpu.ckpt.fuse`.

Behavioral spec: the reference's switch_to_deploy/forward_fuse idea
(yolo_world_pafpn.py:316-333, ConvModule_torch.forward_fuse) and the
Rep* heads that bake normalization into conv weights.

The fold keeps the state dict's shape: the conv weight absorbs
scale/sqrt(var+eps) and the BN becomes the neutral affine carrying the
folded bias,

    y = conv(x) * 1 + b'   with b' = bias - mean * scale / sqrt(var+eps)

(weight 1, running_mean 0, running_var 1 - eps), so the unchanged
modules run a folded checkpoint. The pairs are those the JAX package's
walk folds: every ConvModule's `conv` + `bn` (`<p>.block.conv` /
`<p>.block.bn` in the neck) and the head towers' `<i>` conv + `<i+1>`
BN (`bbox_head.{cls,reg}_preds.<l>.{0,1}` and `.{3,4}`); the contrastive
norms have no conv and stay as they are. No entry point folds by
default: these are library functions.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

# BN epsilons by location: the head's towers and contrastive norms use
# 1e-3 (torch momentum 0.03 convention), the neck's bricks the torch
# default 1e-5 (see nn/layers.py's docstring)
HEAD_EPS = 1e-3
NECK_EPS = 1e-5
HEAD_PREFIX = "bbox_head."

StateDict = Dict[str, torch.Tensor]


def _eps_for(key: str) -> float:
    return HEAD_EPS if key.startswith(HEAD_PREFIX) else NECK_EPS


def _conv_for(bn: str, sd: Mapping) -> Union[str, None]:
    """The prefix of the conv that BN `bn` follows, or None: `<p>.conv`
    beside `<p>.bn`, or entry `<i-1>` before entry `<i>` of a
    Sequential, where that entry is a conv of the BN's width."""
    head, _, last = bn.rpartition(".")
    if last == "bn":
        conv = head + ".conv"
    elif last.isdigit() and int(last) > 0:
        conv = f"{head}.{int(last) - 1}"
    else:
        return None
    w = sd.get(conv + ".weight")
    if w is None or w.dim() != 4 or w.shape[0] != sd[bn + ".weight"].shape[0]:
        return None
    return conv


def conv_bn_pairs(sd: Mapping) -> List[Tuple[str, str]]:
    """(conv prefix, BN prefix) of every Conv+BN pair in a state dict."""
    pairs = []
    for key in sd:
        if key.endswith(".running_var"):
            bn = key[:-len(".running_var")]
            conv = _conv_for(bn, sd)
            if conv is not None:
                pairs.append((conv, bn))
    return pairs


def _state(model_or_sd) -> Tuple[StateDict, List[Tuple[str, str]]]:
    """The state dict and its pairs; for a module, each pair's eps by
    location is checked against the module's own BatchNorm2d.eps."""
    if isinstance(model_or_sd, nn.Module):
        model = model_or_sd
        sd = model.state_dict()
        pairs = conv_bn_pairs(sd)
        for _, bn in pairs:
            eps = model.get_submodule(bn).eps
            if eps != _eps_for(bn):
                raise ValueError(f"{bn}: BatchNorm2d eps {eps}, the fold's "
                                 f"{_eps_for(bn)}")
        return sd, pairs
    sd = dict(model_or_sd)
    return sd, conv_bn_pairs(sd)


def fold_conv_bn(model_or_sd) -> StateDict:
    """A new state dict with every Conv+BN pair folded. Takes a state
    dict (the reference checkpoint's keys) or a module (its state dict,
    each BN's eps checked against the module's). Neither is changed."""
    sd, pairs = _state(model_or_sd)
    out = dict(sd)
    for conv, bn in pairs:
        eps = _eps_for(bn)
        scale, bias = sd[bn + ".weight"], sd[bn + ".bias"]
        mean, var = sd[bn + ".running_mean"], sd[bn + ".running_var"]
        k = scale * torch.rsqrt(var + eps)
        out[conv + ".weight"] = sd[conv + ".weight"] * k[:, None, None, None]
        out[bn + ".weight"] = torch.ones_like(scale)
        out[bn + ".bias"] = bias - mean * k
        out[bn + ".running_mean"] = torch.zeros_like(mean)
        out[bn + ".running_var"] = torch.full_like(var, 1.0 - eps)
    return out


def bake_text_head(model_or_sd, text_embeds,
                   normalize: bool = True) -> Dict[str, StateDict]:
    """Bake BN + text bank into per-level 1x1-conv weights.

    The reparameterized RepBNContrastiveHead form (reference
    yolo_world_head.py:112-134 + reparameterize): at inference the
    contrastive scoring  sigmoid_logits = BN(e) . L2norm(T)^T * e^s + b
    collapses into  e @ W^T + c  with
        W = e^s * L2norm(T) * bn_k      (K, C)
        c = e^s * L2norm(T) @ bn_b + b  (K,)
    Returns {"cls_contrasts.<l>": {"weight": (K, C), "bias": (K,)}} for
    scoring raw (pre-BN) region embeddings.
    """
    sd = (model_or_sd.state_dict() if isinstance(model_or_sd, nn.Module)
          else model_or_sd)
    t = torch.from_numpy(np.asarray(text_embeds, np.float32))
    if normalize:
        t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    out = {}
    prefix = HEAD_PREFIX + "cls_contrasts."
    levels = sorted({int(k[len(prefix):].split(".")[0]) for k in sd
                     if k.startswith(prefix)})
    for lvl in levels:
        p = f"{prefix}{lvl}."
        g = {k: sd[p + k].detach().float().cpu() for k in (
            "norm.weight", "norm.bias", "norm.running_mean",
            "norm.running_var", "logit_scale", "bias")}
        k = g["norm.weight"] * torch.rsqrt(g["norm.running_var"] + HEAD_EPS)
        shift = g["norm.bias"] - g["norm.running_mean"] * k
        es = torch.exp(g["logit_scale"])
        out[f"cls_contrasts.{lvl}"] = {"weight": es * t * k[None, :],
                                       "bias": es * (t @ shift) + g["bias"]}
    return out
