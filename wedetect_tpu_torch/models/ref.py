"""WeDetect-Ref: the Qwen3-VL-based referring-expression proposal scorer.

Port of `wedetect_tpu/models/ref.py` (reference
wedetect_ref/models/qwen3vl_referring.py:97-452). The ViT emits three
scales (the merged embeds and the last two deepstack taps); transposed
convolutions build a stride-8/16/32 pyramid; each proposal is RoI-
aligned 7x7 at every scale, merged, projected and summed with a sine
embedding of its box; the object features fill the <object> slots of
every query row, and one prefill scores every proposal with a binary
head at those slots. The vision tower runs once per image; queries
batch as (B, L) rows sharing the image.

`RefModules` carries the checkpoint's HF key names: `model.visual.*`,
`model.language_model.*`, the grounding extras under `model.` and
`out_proj.*`. Its methods take the image grid per call (the JAX package
fixes it per module instance). `cast_ref_model` casts the matmul weights
to the compute dtype once; norms, the pos-embed table and `out_proj`
stay f32, as in the JAX package. `sigmoid_focal_loss` is the stage-3
training loss (`train/ref_sft.py`). Not ported yet: the multi-image and
cross-image entry points (`score_multi`, `prefix_stage_multi`,
`ref_rec_batch_step`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wedetect_tpu_torch import resolve_device
from wedetect_tpu_torch.data.vision_process import IMAGE_MEAN, IMAGE_STD
from wedetect_tpu_torch.nn.qwen3vl import (RefCfg, RMSNorm, TextModel,
                                           VisionModel, layer_norm)
from wedetect_tpu_torch.ops.roi_align import roi_align
from wedetect_tpu_torch.ops.sine_embed import box_xyxy_to_cxcywh, sine_embed


def pixels_to_patches(pixels: torch.Tensor, patch: int, temporal_patch: int,
                      merge: int) -> torch.Tensor:
    """(H, W, 3) uint8 resized pixels -> (gh*gw, 3*T*P*P) f32 on their
    device: the torch twin of data/vision_process.image_to_patches'
    normalize + patchify tail (same row order, same f32 arithmetic)."""
    h, w, _ = pixels.shape
    gh, gw = h // patch, w // patch
    dev = pixels.device
    x = pixels.float() / 255.0
    x = ((x - torch.as_tensor(IMAGE_MEAN, device=dev))
         / torch.as_tensor(IMAGE_STD, device=dev))
    x = x.permute(2, 0, 1)                         # CHW
    x = torch.stack([x] * temporal_patch, 0)       # T, C, H, W
    x = x.reshape(temporal_patch, 3, gh // merge, merge, patch,
                  gw // merge, merge, patch)
    x = x.permute(2, 5, 3, 6, 1, 0, 4, 7)
    return x.reshape(gh * gw, 3 * temporal_patch * patch * patch)


class Mlp2xGelu(nn.Sequential):
    """mlp2x_gelu: Linear (key 0) -> exact GELU in f32 -> Linear (key 2)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__(nn.Linear(d_in, d_out), nn.GELU(),
                         nn.Linear(d_out, d_out))

    def forward(self, x):
        y = self[0](x)
        y = F.gelu(y.float(), approximate="none").to(y.dtype)
        return self[2](y)


class ConvT2x(nn.ConvTranspose2d):
    """ConvTranspose2d k=2 s=2 (weight (in, out, 2, 2)) applied to an
    (H, W, C) map, as the JAX package computes it (one matmul)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 2, stride=2)

    def forward(self, x):
        h, w, c = x.shape
        out = self.out_channels
        k = self.weight.reshape(c, out * 4)
        y = (x.to(k.dtype) @ k).reshape(h, w, out, 2, 2)
        y = y.permute(0, 3, 1, 4, 2).reshape(h * 2, w * 2, out)
        return y + self.bias


class GroundingExtras(nn.Module):
    """The reference's added modules around the Qwen3-VL trunk."""

    def __init__(self, cfg: RefCfg):
        super().__init__()
        self.cfg = cfg
        d = cfg.text.hidden
        self.image_pos_projector = Mlp2xGelu(d, d)
        self.object_vision_projector = Mlp2xGelu(
            d if d > 4000 else 49 * d, d)
        self.object_pos_projector = Mlp2xGelu(d, d)
        self.first_scale_conv1 = ConvT2x(d, d // 2)
        self.first_scale_conv2 = ConvT2x(d // 2, d // 4)
        self.second_scale_conv = ConvT2x(d, d // 2)
        self.first_scale_norm = nn.LayerNorm(d // 2, eps=1e-5)
        self.merge = nn.Linear(d // 4 + d // 2 + d, d)

    @property
    def dtype(self):
        return self.merge.weight.dtype

    def first_scale_norm_gelu(self, x):
        y = layer_norm(self.first_scale_norm, x, torch.float32)
        return F.gelu(y, approximate="none").to(self.dtype)

    def build_pyramid(self, scale1, scale2, scale3):
        """(H, W, D) maps -> the stride-8/16/32 maps."""
        s1 = self.first_scale_conv1(scale1)
        s1 = self.first_scale_norm_gelu(s1)
        s1 = self.first_scale_conv2(s1)            # (4H, 4W, D/4)
        s2 = self.second_scale_conv(scale2)        # (2H, 2W, D/2)
        return s1, s2, scale3

    def object_feats(self, s1, s2, s3, boxes_32):
        """Boxes in the (W*32, H*32) coordinate space -> (N, D)."""
        dt = self.dtype
        r1 = roi_align(s1, boxes_32, 7, 1.0 / 8)
        r2 = roi_align(s2, boxes_32, 7, 1.0 / 16)
        r3 = roi_align(s3, boxes_32, 7, 1.0 / 32)
        roi = self.merge(torch.cat([r1, r2, r3], dim=-1).to(dt))
        d = self.cfg.text.hidden
        if d > 4000:
            roi = self.object_vision_projector(
                roi.reshape(roi.shape[0], 49, d).mean(dim=1))
        else:
            roi = self.object_vision_projector(
                roi.reshape(roi.shape[0], 49 * d))
        h, w, _ = s3.shape
        norm = torch.tensor([w * 32.0, h * 32.0, w * 32.0, h * 32.0],
                            device=boxes_32.device)
        box_coor = box_xyxy_to_cxcywh(boxes_32) / norm
        pos = self.object_pos_projector(sine_embed(box_coor, d).to(dt))
        return roi + pos

    def image_pos(self, grid_h: int, grid_w: int):
        """Sine pos embeds of the merged image tokens: x/W + 0.5
        (reference qwen3vl_referring.py:143-152, 225-226)."""
        d = self.cfg.text.hidden
        xs = (np.arange(grid_w, dtype=np.float32) / grid_w) + 0.5
        ys = (np.arange(grid_h, dtype=np.float32) / grid_h) + 0.5
        xx, yy = np.meshgrid(xs, ys)
        coor = torch.as_tensor(np.stack([xx.reshape(-1), yy.reshape(-1)],
                                        -1), device=self.merge.weight.device)
        return self.image_pos_projector(sine_embed(coor, d).to(self.dtype))


class GroundingModel(GroundingExtras):
    """The checkpoint's `model.`: Qwen3-VL's vision tower and decoder
    beside the grounding extras."""

    def __init__(self, cfg: RefCfg):
        super().__init__(cfg)
        self.visual = VisionModel(cfg.vision)
        self.language_model = TextModel(cfg.text)


def _t(x, device, dtype=None):
    return torch.as_tensor(x, device=device, dtype=dtype)


class RefModules(nn.Module):
    """The whole scorer: `model` (trunk + extras) and `out_proj`."""

    def __init__(self, cfg: RefCfg, attn_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.model = GroundingModel(cfg)
        self.out_proj = nn.Linear(cfg.text.hidden, 1)

    @property
    def device(self) -> torch.device:
        return self.out_proj.weight.device

    def score(self, hidden):
        return self.out_proj(hidden.float())[..., 0]

    def _embed(self, ids):
        return self.model.language_model.embed_tokens(_t(ids, self.device))

    def _put_span(self, x, tokens, start: int):
        b, n = x.shape[0], tokens.shape[0]
        span = tokens.to(x.dtype)[None].expand(b, n, tokens.shape[1])
        return torch.cat([x[:, :start], span, x[:, start + n:]], dim=1)

    def _scatter_objects(self, x, obj, object_positions):
        """Write object features into the <object> slots; -1 marks a
        padded slot, which keeps the token's own embedding. obj is (N, D)
        shared by every row or (B, N, D) per row."""
        b = x.shape[0]
        bidx = torch.arange(b, device=x.device)[:, None]
        pos = object_positions.clamp(min=0).long()
        objb = (obj[None] if obj.dim() == 2 else obj).to(x.dtype)
        newv = torch.where((object_positions >= 0)[..., None],
                           objb.expand((b,) + objb.shape[1:]), x[bidx, pos])
        x = x.clone()
        x[bidx, pos] = newv
        return x

    def _pick(self, hidden, object_positions):
        logits = self.score(hidden)
        return torch.gather(logits, 1, object_positions.clamp(min=0).long())

    def _vision_and_objects(self, patches, boxes_xyxy, ori_wh, grid_h: int,
                            grid_w: int):
        """Vision tower + RoI object features + pos-embedded image
        tokens. patches: (S, C*t*p*p) f32 patches, or (H, W, 3) uint8
        resized pixels (patchified here, on the device)."""
        c = self.cfg
        dev = self.device
        patches = _t(patches, dev)
        if patches.dim() == 3:
            patches = pixels_to_patches(patches, c.vision.patch,
                                        c.vision.temporal_patch,
                                        c.vision.merge)
        m = c.vision.merge
        mh, mw = grid_h // m, grid_w // m
        d = c.text.hidden
        img_embeds, taps = self.model.visual(patches, grid_h, grid_w,
                                             attn_impl=self.attn_impl)
        scale3 = img_embeds[:mh * mw].reshape(mh, mw, d)
        scale2 = taps[-1][:mh * mw].reshape(mh, mw, d)
        scale1 = taps[-2][:mh * mw].reshape(mh, mw, d)
        s1, s2, s3 = self.model.build_pyramid(scale1, scale2, scale3)
        norm = torch.tensor([mw * 32.0, mh * 32.0, mw * 32.0, mh * 32.0],
                            device=dev)
        ori = _t(ori_wh, dev, torch.float32)
        boxes_32 = _t(boxes_xyxy, dev).float() / (torch.cat([ori, ori])
                                                  / norm)
        obj = self.model.object_feats(s1, s2, s3, boxes_32)
        img_tokens = img_embeds + self.model.image_pos(mh, mw)
        return img_tokens, obj, taps

    def forward(self, patches, input_ids, attn_mask, position_ids,
                boxes_xyxy, ori_wh, visual_start: int, object_positions, *,
                grid_h: int, grid_w: int):
        """Joint scoring. patches: one image; input_ids/attn_mask (B, L);
        position_ids (3, B, L); boxes_xyxy (N, 4) in original image
        coords; ori_wh (2,) (width, height); object_positions (B, N)
        indices of the <object> slots. Returns (B, N) logits."""
        hidden = self.hidden_states(
            patches, input_ids, attn_mask, position_ids, boxes_xyxy, ori_wh,
            visual_start, object_positions, grid_h=grid_h, grid_w=grid_w)
        return self._pick(hidden, _t(object_positions, self.device))

    def hidden_states(self, patches, input_ids, attn_mask, position_ids,
                      boxes_xyxy, ori_wh, visual_start: int,
                      object_positions, *, grid_h: int, grid_w: int):
        """forward's final normed hidden states (B, L, D), before
        out_proj (the LM-loss stages read them: train/ref_lm.py).
        object_positions may hold -1 (a caption-only sample's or a padded
        slot): that token keeps its own embedding."""
        dev = self.device
        img_tokens, obj, taps = self._vision_and_objects(
            patches, boxes_xyxy, ori_wh, grid_h, grid_w)
        x = self._put_span(self._embed(input_ids), img_tokens, visual_start)
        x = self._scatter_objects(x, obj, _t(object_positions, dev))
        return self.model.language_model(
            x, _t(position_ids, dev), _t(attn_mask, dev),
            deepstack_embeds=list(taps), visual_start=visual_start,
            attn_impl=self.attn_impl)

    def prefill_split(self, patches, prefix_ids, suffix_ids, prefix_mask,
                      suffix_mask, prefix_position_ids, suffix_position_ids,
                      boxes_xyxy, ori_wh, visual_start: int,
                      object_positions, *, grid_h: int, grid_w: int):
        """Prefix-sharing scoring in one call: prefix_stage then
        suffix_stage. prefix_* (1, P); suffix_* (B, S); position ids
        (3, 1, P) / (3, B, S) of the concatenated sequence;
        object_positions suffix-relative. Returns (B, N) logits, the
        same as forward() on the joint sequences."""
        obj, kvs = self.prefix_stage(patches, prefix_ids, prefix_mask,
                                     prefix_position_ids, boxes_xyxy,
                                     ori_wh, visual_start, grid_h=grid_h,
                                     grid_w=grid_w)
        return self.suffix_stage(obj, kvs, suffix_ids, suffix_mask,
                                 suffix_position_ids, prefix_mask,
                                 object_positions)

    def prefix_stage(self, patches, prefix_ids, prefix_mask,
                     prefix_position_ids, boxes_xyxy, ori_wh,
                     visual_start: int, *, grid_h: int, grid_w: int):
        """Image-level half: vision tower + object features + the prefix
        decoder pass. Returns (obj (N, D), kvs), reusable by every
        query batch of the image."""
        dev = self.device
        img_tokens, obj, taps = self._vision_and_objects(
            patches, boxes_xyxy, ori_wh, grid_h, grid_w)
        xp = self._put_span(self._embed(prefix_ids), img_tokens,
                            visual_start)
        kvs = self.model.language_model.prefix_pass(
            xp, _t(prefix_position_ids, dev), _t(prefix_mask, dev),
            deepstack_embeds=list(taps), visual_start=visual_start,
            attn_impl=self.attn_impl)
        return obj, kvs

    def suffix_stage(self, obj, kvs, suffix_ids, suffix_mask,
                     suffix_position_ids, prefix_mask, object_positions):
        """Per-query-batch half: embed the suffixes, scatter the object
        features, decode against the prefix KV, score."""
        dev = self.device
        objp = _t(object_positions, dev)
        xs = self._scatter_objects(self._embed(suffix_ids), obj, objp)
        hidden = self.model.language_model.suffix_pass(
            kvs, xs, _t(suffix_position_ids, dev), _t(prefix_mask, dev),
            _t(suffix_mask, dev), attn_impl=self.attn_impl)
        return self._pick(hidden, objp)


# ------------------------------------------------------------ init, dtype

_KEEP_F32 = ("out_proj", "model.visual.pos_embed")


def cast_ref_model(model: RefModules, dtype) -> RefModules:
    """Cast the matmul weights (Linear, Conv3d, ConvTranspose2d,
    Embedding) to `dtype` once, in place; norms, the pos-embed table and
    out_proj stay f32 (the JAX package computes them in f32)."""
    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}.get(dtype, dtype)
    for name, m in model.named_modules():
        if name in _KEEP_F32:
            continue
        if isinstance(m, (nn.Linear, nn.Conv3d, nn.ConvTranspose2d,
                          nn.Embedding)):
            m.to(dtype)
    return model


def _lecun_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    """flax lecun_normal: truncated normal at +-2 std, variance 1/fan_in."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


def init_ref_variables(cfg: RefCfg, seed: int = 0,
                       device="cuda") -> RefModules:
    """A RefModules with random weights from torch.Generator(seed), built
    on `device` (meta first: the full model is never made on the host).
    The flax initializers' distributions: lecun-normal Dense kernels
    (ConvT2x with flax's fan-in of its (in, out, 2, 2) kernel, 2*in*out),
    zero biases, unit norm scales, token embeddings N(0, 1/hidden),
    pos_embed N(0, 0.02), and out_proj's prior bias -log(0.99/0.01)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = RefModules(cfg)
    model = model.to_empty(device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    done = set()

    def put(t):
        done.add(id(t))
        return t

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, ConvT2x):
                _lecun_(put(m.weight), 2 * m.in_channels * m.out_channels, g)
            elif isinstance(m, (nn.Linear, nn.Conv3d)):
                _lecun_(put(m.weight), m.weight[0].numel(), g)
            elif isinstance(m, nn.Embedding):
                std = 0.02 if name.endswith("pos_embed") else \
                    1.0 / math.sqrt(m.embedding_dim)
                put(m.weight).normal_(0.0, std, generator=g)
            elif isinstance(m, (nn.LayerNorm, RMSNorm)):
                put(m.weight).fill_(1.0)
            if getattr(m, "bias", None) is not None:
                put(m.bias).zero_()
        model.out_proj.bias.fill_(-math.log((1 - 0.01) / 0.01))
    missed = [n for n, t in model.named_parameters() if id(t) not in done]
    if missed:
        raise RuntimeError(f"init_ref_variables: left uninitialized: "
                           f"{missed}")
    return model.eval()


# --------------------------------------------------------------- steps


@torch.inference_mode()
def ref_score_step(model: RefModules, grid_h: int, grid_w: int, patches,
                   input_ids, attn_mask, position_ids, visual_start: int,
                   boxes_xyxy, ori_wh, object_positions) -> torch.Tensor:
    """Joint REC scoring: (B, N) proposal logits."""
    return model(patches, input_ids, attn_mask, position_ids, boxes_xyxy,
                 ori_wh, visual_start, object_positions, grid_h=grid_h,
                 grid_w=grid_w)


@torch.inference_mode()
def ref_score_step_split(model: RefModules, grid_h: int, grid_w: int,
                         patches, prefix_ids, suffix_ids, prefix_mask,
                         suffix_mask, prefix_position_ids,
                         suffix_position_ids, boxes_xyxy, visual_start: int,
                         ori_wh, object_positions) -> torch.Tensor:
    """Prefix-sharing REC scoring in one call: (B, N) proposal logits."""
    return model.prefill_split(
        patches, prefix_ids, suffix_ids, prefix_mask, suffix_mask,
        prefix_position_ids, suffix_position_ids, boxes_xyxy, ori_wh,
        visual_start, object_positions, grid_h=grid_h, grid_w=grid_w)


@torch.inference_mode()
def ref_prefix_step(model: RefModules, grid_h: int, grid_w: int, patches,
                    prefix_ids, prefix_mask, prefix_position_ids,
                    boxes_xyxy, ori_wh, visual_start: int):
    """Image-level stage: (obj, kvs) for ref_suffix_step."""
    return model.prefix_stage(patches, prefix_ids, prefix_mask,
                              prefix_position_ids, boxes_xyxy, ori_wh,
                              visual_start, grid_h=grid_h, grid_w=grid_w)


@torch.inference_mode()
def ref_suffix_step(model: RefModules, obj, kvs, suffix_ids, suffix_mask,
                    suffix_position_ids, prefix_mask,
                    object_positions) -> torch.Tensor:
    """Per-query-batch stage against the cached (obj, kvs)."""
    return model.suffix_stage(obj, kvs, suffix_ids, suffix_mask,
                              suffix_position_ids, prefix_mask,
                              object_positions)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference qwen3vl_referring.py:69-91: alpha-weighted focal terms,
    mean-reduced (the reference ignores the positive count it computes at
    the call site). `valid` masks static-shape padding: the mean runs
    over valid elements only."""
    p = torch.sigmoid(logits)
    ce = (torch.clamp(logits, min=0) - logits * targets
          + torch.log1p(torch.exp(-torch.abs(logits))))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    loss = alpha_t * loss
    if valid is None:
        return loss.mean()
    v = valid.to(loss.dtype)
    return (loss * v).sum() / torch.clamp(v.sum(), min=1.0)
