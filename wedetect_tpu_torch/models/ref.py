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
training loss (`train/ref_sft.py`).

Several images a sequence (`score_multi`, `prefix_stage_multi`, through
`_assemble`): each image runs the ViT at its own grid, its object
features are optional, and its taps land at its own span; the
single-image `hidden_states` and `prefix_stage` are their one-image
calls. Cross-image
REC batching (`ref_rec_batch_step`, through `prefix_stage_batch`): B
images of one grid, one query row each; the ViT runs once over the
(B, S, ...) batch and the prefix pass once over (B, P) rows (one K3 or
K2 launch a layer, as the JAX package's `jax.vmap` of the single-image
stage computes it), then one suffix pass in which row i attends image
i's prefix KV. RoI object features loop over the images.
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
from wedetect_tpu_torch.ops.int8 import set_quant
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
    """The whole scorer: `model` (trunk + extras) and `out_proj`, and the
    untied LM head `lm_head` of a stage-1/2 checkpoint (reference
    qwen3vl_grounding.py:315), which the LM loss and generation read
    over the tied embedding; None unless the weights carry one."""

    def __init__(self, cfg: RefCfg, attn_impl: str = "auto",
                 lm_head: bool = False):
        super().__init__()
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.model = GroundingModel(cfg)
        self.out_proj = nn.Linear(cfg.text.hidden, 1)
        self.lm_head = (nn.Linear(cfg.text.hidden, cfg.text.vocab_size,
                                  bias=False) if lm_head else None)
        # the int8 prefill (RefCfg.quant_int8): the ViT and decoder
        # matmuls; RefScorer sets it from its own cfg for each call
        set_quant(self, cfg.quant_int8)

    def lm_logits(self, hidden):
        """f32 LM logits of hidden states: the untied head when present,
        else the tied input embedding (JAX train/ref_lm.py:99-104)."""
        w = (self.lm_head.weight if self.lm_head is not None
             else self.model.language_model.embed_tokens.weight)
        return hidden.float() @ w.float().T

    @property
    def device(self) -> torch.device:
        return self.out_proj.weight.device

    def score(self, hidden):
        return self.out_proj(hidden.float())[..., 0]

    def _embed(self, ids):
        return self.model.language_model.embed_tokens(_t(ids, self.device))

    def _put_span(self, x, tokens, start: int):
        """Write tokens (n, D), shared by every row, or (B, n, D), a row
        each, over x[:, start:start + n]."""
        b, n = x.shape[0], tokens.shape[-2]
        span = tokens.to(x.dtype).expand(b, n, tokens.shape[-1])
        return torch.cat([x[:, :start], span, x[:, start + n:]], dim=1)

    def _scatter_objects(self, x, obj, object_positions):
        """Write object features into the <object> slots; -1 marks a
        padded slot, which keeps the token's own embedding. obj is (N, D)
        shared by every row or (B, N, D) per row."""
        if object_positions.shape[1] == 0 or obj.shape[-2] == 0:
            return x            # no object slot (context-only images)
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
        img_tokens, taps, scales = self._vision_one(patches, grid_h, grid_w)
        obj = self._objects_from(scales, boxes_xyxy, ori_wh)
        return img_tokens, obj, taps

    def _patches(self, patches, batch: bool):
        """patches on the device: (S, C*t*p*p) f32 patches as given,
        (H, W, 3) resized pixels patchified; with `batch`, the same with
        a leading B (images of one size)."""
        v = self.cfg.vision
        patches = _t(patches, self.device)
        if patches.dim() == 2 + batch:
            return patches

        def patchify(pixels):
            return pixels_to_patches(pixels, v.patch, v.temporal_patch,
                                     v.merge)
        return (torch.stack([patchify(p) for p in patches]) if batch
                else patchify(patches))

    def _vision_one(self, patches, gh: int, gw: int, batch: bool = False):
        """The ViT at the call's grid: (pos-embedded image tokens, taps,
        (scale1, scale2, scale3) merged-grid maps) of one image, or with
        `batch` of B images of one grid in one batched pass (a leading B
        on every output)."""
        m = self.cfg.vision.merge
        mh, mw = gh // m, gw // m
        d = self.cfg.text.hidden
        img_embeds, taps = self.model.visual(self._patches(patches, batch),
                                             gh, gw,
                                             attn_impl=self.attn_impl)
        lead = img_embeds.shape[:-2]
        scales = tuple(t.reshape(*lead, mh, mw, d)
                       for t in (taps[-2], taps[-1], img_embeds))
        return img_embeds + self.model.image_pos(mh, mw), taps, scales

    def _objects_from(self, scales, boxes_xyxy, ori_wh):
        """RoI object features (N, D) for boxes (N, 4) in original image
        coordinates (ori_wh: (width, height)) on the image whose merged
        grid maps are `scales`."""
        dev = self.device
        s1, s2, s3 = self.model.build_pyramid(*scales)
        mh, mw = scales[2].shape[:2]
        norm = torch.tensor([mw * 32.0, mh * 32.0, mw * 32.0, mh * 32.0],
                            device=dev)
        ori = _t(ori_wh, dev, torch.float32)
        boxes_32 = _t(boxes_xyxy, dev).float() / (torch.cat([ori, ori])
                                                  / norm)
        return self.model.object_feats(s1, s2, s3, boxes_32)

    def _multi_assembly(self, patches_list, grids, boxes_list, ori_wh_list):
        """Every multi-image entry point's per-image loop: the ViT at
        each image's grid, its RoI object features where it has boxes
        (None: a context-only image), and the taps regrouped layer by
        layer. Returns (tokens list, per-layer tuples of taps, obj
        (N_total, D), (0, D) when no image has boxes)."""
        tokens, taps_all, objs = [], [], []
        for patches_i, (gh, gw), boxes_i, ori_i in zip(
                patches_list, grids, boxes_list, ori_wh_list):
            img_tokens, taps, scales = self._vision_one(patches_i, gh, gw)
            tokens.append(img_tokens)
            taps_all.append(taps)
            if boxes_i is not None:
                objs.append(self._objects_from(scales, boxes_i, ori_i))
        obj = (torch.cat(objs, dim=0) if objs else
               tokens[0].new_zeros((0, self.cfg.text.hidden)))
        ds = [tuple(taps[i] for taps in taps_all)
              for i in range(len(taps_all[0]))]
        return tokens, ds, obj

    def _assemble(self, patches_list, grids, input_ids, boxes_list,
                  ori_wh_list, visual_starts, object_positions=None):
        """The decoder's input embeddings of sequences holding the images
        (_multi_assembly) at their spans, with the object features
        scattered into the <object> slots when object_positions is
        given. Returns (x (B, L, D), per-layer taps, obj)."""
        tokens, ds, obj = self._multi_assembly(patches_list, grids,
                                               boxes_list, ori_wh_list)
        x = self._embed(input_ids)
        for tok, vs in zip(tokens, visual_starts):
            x = self._put_span(x, tok, vs)
        if object_positions is not None:
            x = self._scatter_objects(x, obj,
                                      _t(object_positions, self.device))
        return x, ds, obj

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
        slot): that token keeps its own embedding. The one-image call of
        hidden_states_multi."""
        return self.hidden_states_multi(
            (patches,), ((grid_h, grid_w),), input_ids, attn_mask,
            position_ids, (boxes_xyxy,), (ori_wh,), (visual_start,),
            object_positions)

    def hidden_states_multi(self, patches_list, grids, input_ids, attn_mask,
                            position_ids, boxes_list, ori_wh_list,
                            visual_starts, object_positions):
        """score_multi's final normed hidden states (B, L, D)."""
        x, ds, _ = self._assemble(patches_list, grids, input_ids,
                                  boxes_list, ori_wh_list, visual_starts,
                                  object_positions)
        return self.model.language_model(
            x, _t(position_ids, self.device), _t(attn_mask, self.device),
            deepstack_embeds=ds, visual_start=tuple(visual_starts),
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
        query batch of the image. The one-image call of
        prefix_stage_multi."""
        return self.prefix_stage_multi(
            (patches,), ((grid_h, grid_w),), prefix_ids, prefix_mask,
            prefix_position_ids, (boxes_xyxy,), (ori_wh,), (visual_start,))

    def score_multi(self, patches_list, grids, input_ids, attn_mask,
                    position_ids, boxes_list, ori_wh_list, visual_starts,
                    object_positions):
        """Joint scoring of sequences holding several images (reference
        qwen3vl_referring.py:186-258: one boxes / ori_shape entry per
        image; object features concatenate in image order). grids: each
        image's unmerged (gh, gw); visual_starts: each span's offset;
        boxes_list entries (N_i, 4) or None (context only);
        object_positions (B, N_total). Returns (B, N_total) logits."""
        hidden = self.hidden_states_multi(
            patches_list, grids, input_ids, attn_mask, position_ids,
            boxes_list, ori_wh_list, visual_starts, object_positions)
        return self._pick(hidden, _t(object_positions, self.device))

    def prefix_stage_multi(self, patches_list, grids, prefix_ids,
                           prefix_mask, prefix_position_ids, boxes_list,
                           ori_wh_list, visual_starts):
        """The multi-image prefix_stage: every image lies in the shared
        prefix, which runs the decoder once. Returns (obj (N_total, D),
        kvs)."""
        xp, ds, obj = self._assemble(patches_list, grids, prefix_ids,
                                     boxes_list, ori_wh_list, visual_starts)
        kvs = self.model.language_model.prefix_pass(
            xp, _t(prefix_position_ids, self.device),
            _t(prefix_mask, self.device), deepstack_embeds=ds,
            visual_start=tuple(visual_starts), attn_impl=self.attn_impl)
        return obj, kvs

    def prefix_stage_batch(self, patches, prefix_ids, prefix_mask,
                           prefix_position_ids, boxes_xyxy, ori_wh,
                           visual_start: int, *, grid_h: int, grid_w: int):
        """prefix_stage of B images of one grid, batched: patches
        (B, S, C*t*p*p) or (B, H, W, 3) uint8 pixels; prefix_ids /
        prefix_mask (B, P); prefix_position_ids (3, B, P); boxes_xyxy
        (B, N, 4); ori_wh (B, 2). The ViT and the prefix pass run once
        over the batch; the RoI features loop over the images. Returns
        (obj (B, N, D), kvs, each (B, P, kv_heads, head_dim))."""
        dev = self.device
        img_tokens, taps, scales = self._vision_one(patches, grid_h, grid_w,
                                                    batch=True)
        boxes, ori = _t(boxes_xyxy, dev), _t(ori_wh, dev)
        obj = torch.stack([
            self._objects_from(tuple(t[i] for t in scales), boxes[i],
                               ori[i]) for i in range(boxes.shape[0])])
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
        features, decode against the prefix KV, score. obj (N, D), kvs
        and prefix_mask (1, P) shared by every row (one image), or
        (B, ...) a row each (cross-image REC: row i is image i's)."""
        dev = self.device
        objp = _t(object_positions, dev)
        xs = self._scatter_objects(self._embed(suffix_ids), obj, objp)
        hidden = self.model.language_model.suffix_pass(
            kvs, xs, _t(suffix_position_ids, dev), _t(prefix_mask, dev),
            _t(suffix_mask, dev), attn_impl=self.attn_impl)
        return self._pick(hidden, objp)


# ------------------------------------------------------------ init, dtype

_KEEP_F32 = ("out_proj", "model.visual.pos_embed",
             "model.language_model.embed_tokens", "lm_head")


def cast_ref_model(model: RefModules, dtype) -> RefModules:
    """Cast the matmul weights (Linear, Conv3d, ConvTranspose2d,
    Embedding) to `dtype` once, in place; norms, the pos-embed table,
    out_proj and the LM head (the token table, which is also the tied
    head, and an untied `lm_head`) stay f32: the JAX package computes
    them in f32 and rounds a looked-up token row to the compute dtype."""
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


def init_ref_variables(cfg: RefCfg, seed: int = 0, device="cuda",
                       lm_head: bool = False) -> RefModules:
    """A RefModules with random weights from torch.Generator(seed), built
    on `device` (meta first: the full model is never made on the host).
    The flax initializers' distributions: lecun-normal Dense kernels
    (ConvT2x with flax's fan-in of its (in, out, 2, 2) kernel, 2*in*out),
    zero biases, unit norm scales, token embeddings N(0, 1/hidden),
    pos_embed N(0, 0.02), and out_proj's prior bias -log(0.99/0.01).
    `lm_head` adds an untied LM head (lecun-normal, drawn last)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = RefModules(cfg, lm_head=lm_head)
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
def ref_score_step_multi(model: RefModules, grids, patches_list, input_ids,
                         attn_mask, position_ids, boxes_list, ori_wh_list,
                         visual_starts, object_positions) -> torch.Tensor:
    """Joint multi-image REC scoring (RefModules.score_multi):
    (B, N_total) logits."""
    return model.score_multi(patches_list, grids, input_ids, attn_mask,
                             position_ids, boxes_list, ori_wh_list,
                             visual_starts, object_positions)


@torch.inference_mode()
def ref_prefix_step_multi(model: RefModules, grids, patches_list,
                          prefix_ids, prefix_mask, prefix_position_ids,
                          boxes_list, ori_wh_list, visual_starts):
    """Multi-image image-level stage: (obj, kvs) for ref_suffix_step."""
    return model.prefix_stage_multi(patches_list, grids, prefix_ids,
                                    prefix_mask, prefix_position_ids,
                                    boxes_list, ori_wh_list, visual_starts)


@torch.inference_mode()
def ref_rec_batch_step(model: RefModules, grid_h: int, grid_w: int, patches,
                       prefix_ids, prefix_mask, prefix_position_ids,
                       boxes_xyxy, ori_wh, visual_start: int, suffix_ids,
                       suffix_mask, suffix_position_ids,
                       object_positions) -> torch.Tensor:
    """Cross-image REC batching: B images of one grid bucket, one query
    row each, one fused step (the refcoco protocol, one query an image).
    Arguments as the JAX step takes them: patches (B, S, Dp) or (B, H,
    W, 3) uint8; prefix_ids / prefix_mask (B, P); prefix_position_ids
    (B, 3, 1, P), each image's (3, 1, P) prefix ids; boxes (B, N, 4);
    ori_wh (B, 2); suffix_* (B, S). The prefix stages run batched
    (prefix_stage_batch), then one suffix pass in which row i attends
    image i's KV. Returns (B, N) logits."""
    dev = model.device
    pos = _t(prefix_position_ids, dev)[:, :, 0].permute(1, 0, 2)
    obj, kvs = model.prefix_stage_batch(
        patches, prefix_ids, prefix_mask, pos, boxes_xyxy, ori_wh,
        visual_start, grid_h=grid_h, grid_w=grid_w)
    return model.suffix_stage(obj, kvs, suffix_ids, suffix_mask,
                              suffix_position_ids, prefix_mask,
                              object_positions)


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
