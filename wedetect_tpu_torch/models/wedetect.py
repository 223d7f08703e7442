"""WeDetect / WeDetect-Uni detector and its detect step.

Behavioral spec: reference yolo_world.py:12-260 and the predict path of
yolo_world_head.py:578-749 / generate_proposal.py:1082-1218; the same
graph as `wedetect_tpu.models.wedetect`:

    uint8 NHWC image -> /255 -> ConvNeXt -> BiFPAN -> head -> similarity
    -> decode (DFL * stride, distance2bbox) -> sigmoid -> top-k +
    class-aware NMS -> un-letterbox -> clamp

The public functions keep the JAX package's layout: uint8 NHWC images
in, (B, A, K) scores and fixed-slot `Detections` out. The text tower
runs separately (`Detector.reparameterize`); its (K, C) output is an
input here. `ModelCfg.quant_int8` is the int8 serving mode: the
channel-mixing matmuls and convolutions in dynamic int8 (`ops/int8.py`).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from wedetect_tpu_torch import resolve_device
from wedetect_tpu_torch.configs import ModelCfg
from wedetect_tpu_torch.nn.bifpan import CSPRepBiFPANNeck, neck_out_channels
from wedetect_tpu_torch.nn.convnext import ConvNeXt
from wedetect_tpu_torch.nn.head import HeadOutputs, WeDetectHead
from wedetect_tpu_torch.nn.init import init_module
from wedetect_tpu_torch.ops.boxes import distance2bbox
from wedetect_tpu_torch.ops.int8 import set_quant
from wedetect_tpu_torch.ops.nms import batched_static_nms, nms_labeled
from wedetect_tpu_torch.ops.priors import flat_priors_and_strides


class DetectorOutputs(NamedTuple):
    """Raw decoded per-anchor outputs (before NMS)."""

    scores: torch.Tensor       # (B, A, K) post-sigmoid
    boxes: torch.Tensor        # (B, A, 4) xyxy, letterboxed pixels
    embeds: torch.Tensor       # (B, A, C) post-BN region embeddings
    logits: torch.Tensor       # (B, A, K) pre-sigmoid
    dist_logits: torch.Tensor  # (B, A, 4, reg_max)


class Detections(NamedTuple):
    """Final fixed-slot detections in original-image coordinates."""

    boxes: torch.Tensor    # (B, max_out, 4)
    scores: torch.Tensor   # (B, max_out)
    labels: torch.Tensor   # (B, max_out) int32, -1 for empty slots
    embeds: torch.Tensor   # (B, max_out, C)
    anchors: torch.Tensor  # (B, max_out) int32 source anchor index
    valid: torch.Tensor    # (B, max_out) bool


class WeDetectModule(nn.Module):
    """backbone + neck + head (+ Uni prompt bank and adapter).

    Keys: `backbone.*`, `down_mlp.*` (xlarge), `neck.*`, `bbox_head.*`,
    `embeddings`, `adapter.0/2.*` -- the canonical reference keys
    (`wedetect_tpu.ckpt.convert.canonicalize_torch_keys`).
    """

    def __init__(self, cfg: ModelCfg):
        super().__init__()
        self.cfg = cfg
        self.backbone = ConvNeXt(cfg.depths, cfg.dims, cfg.drop_path_rate)
        c4 = cfg.dims[3]
        if cfg.backbone_down_proj:
            # xlarge: 1x1 down-projection of c4 (mm_backbone.py:278-301)
            self.down_mlp = nn.Conv2d(c4, cfg.backbone_down_proj, 1)
            c4 = cfg.backbone_down_proj
        self.neck = CSPRepBiFPANNeck((*cfg.dims[:3], c4), cfg.neck_scale,
                                     cfg.neck_repeats)
        self.bbox_head = WeDetectHead(
            neck_out_channels(cfg.neck_scale), cfg.embed_dims, cfg.reg_max,
            cfg.cls_hidden, cfg.reg_hidden, cfg.use_bn_head)
        if cfg.num_prompts:
            # Uni learned objectness prompt bank
            # (generate_proposal.py:1076-1078)
            self.embeddings = nn.Parameter(
                torch.empty(cfg.num_prompts, cfg.embed_dims))
            if cfg.use_mlp_adapter:
                # residual MLP adapter + L2 norm (yolo_world.py:160-165)
                self.adapter = nn.Sequential(
                    nn.Linear(cfg.embed_dims, 2 * cfg.embed_dims), nn.ReLU(),
                    nn.Linear(2 * cfg.embed_dims, cfg.embed_dims))
        # the int8 serving mode (ops/int8.py): the block MLPs, every
        # Conv+BN conv of the neck and the head's tower convs
        set_quant(self, cfg.quant_int8)

    def forward(self, images: torch.Tensor,
                w: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> HeadOutputs:
        """images: (B, 3, H, W) float in [0, 1]; w: (K, C) or (B, K, C).

        For Uni, `w` defaults to the prompt bank, used un-normalized
        unless the adapter is on (generate_proposal.py:1130). In train
        mode every BN normalizes with its batch statistics and updates
        its running ones (nn/layers.BatchNorm2d), and the backbone drops
        paths at cfg.drop_path_rate with masks from `generator`.
        """
        c = self.cfg
        normalize_w = True
        if w is None:
            if not c.num_prompts:
                raise ValueError("text embeddings required")
            w = self.embeddings
            if c.use_mlp_adapter:
                w = w + self.adapter(w)
                w = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)
            else:
                normalize_w = False
        autocast = (torch.autocast(images.device.type, dtype=torch.bfloat16)
                    if c.compute_dtype == "bfloat16"
                    else contextlib.nullcontext())
        with autocast:
            feats = self.backbone(images, generator)
            if c.backbone_down_proj:
                feats = feats[:3] + (self.down_mlp(feats[3]),)
            return self.bbox_head(self.neck(feats), w, normalize_w)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _as(x, device, dtype=None) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(x, device=device, dtype=dtype)


def decode_outputs(cfg: ModelCfg, out: HeadOutputs,
                   img_size: Optional[Tuple[int, int]] = None
                   ) -> DetectorOutputs:
    """Head outputs -> per-anchor scores / boxes in letterboxed pixels
    (dist * stride, distance2bbox against (x + .5) * s priors)."""
    dev = out.logits.device
    priors, strides = flat_priors_and_strides(cfg.feat_sizes(img_size),
                                              cfg.strides)
    priors = torch.from_numpy(priors).to(dev)
    strides = torch.from_numpy(strides).to(dev)
    dists = out.dists.float() * strides[None, :, None]
    boxes = distance2bbox(priors[None], dists)
    scores = torch.sigmoid(out.logits.float())
    return DetectorOutputs(scores=scores, boxes=boxes, embeds=out.embeds,
                           logits=out.logits, dist_logits=out.dist_logits)


def postprocess(cfg: ModelCfg, dec: DetectorOutputs,
                scale_factor: torch.Tensor, pad_param: torch.Tensor,
                ori_shape: torch.Tensor,
                class_mask: Optional[torch.Tensor] = None) -> Detections:
    """Static NMS + un-letterbox + clamp.

    scale_factor: (B, 2) (w_ratio, h_ratio); pad_param: (B, 4)
    [top, bottom, left, right]; ori_shape: (B, 2) (h, w).
    """
    t = cfg.test
    res = batched_static_nms(
        dec.scores, dec.boxes, score_thr=t.score_thr, nms_pre=t.nms_pre,
        iou_thr=t.nms_iou_thr, max_out=t.max_per_img,
        class_mask=class_mask, multi_label=t.multi_label)
    offs = torch.stack([pad_param[:, 2], pad_param[:, 0],
                        pad_param[:, 2], pad_param[:, 0]], dim=-1)
    boxes = res.boxes - offs[:, None, :]
    sf = torch.cat([scale_factor, scale_factor], dim=-1)
    boxes = boxes / sf[:, None, :]
    wh_max = torch.stack([ori_shape[:, 1], ori_shape[:, 0],
                          ori_shape[:, 1], ori_shape[:, 0]], dim=-1)
    boxes = torch.clamp(boxes, torch.zeros_like(wh_max[:, None, :]),
                        wh_max[:, None, :])
    idx = res.anchors.clamp(min=0).long()[..., None]
    embeds = dec.embeds.gather(
        1, idx.expand(-1, -1, dec.embeds.shape[-1])).float()
    return Detections(boxes=boxes, scores=res.scores, labels=res.labels,
                      embeds=embeds, anchors=res.anchors, valid=res.valid)


def _images(images_u8, device) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) f32 in [0, 1] on `device`."""
    x = _as(images_u8, device, torch.uint8)
    return x.permute(0, 3, 1, 2).float() / 255.0


@torch.inference_mode()
def detect_step(cfg: ModelCfg, model: WeDetectModule, images_u8, w,
                scale_factor, pad_param, ori_shape,
                class_mask=None) -> Detections:
    """The full inference step on the model's device.

    images_u8: (B, H, W, 3) uint8 RGB letterboxed images; w: (K, C)
    text/prompt embeddings (None only for Uni). Array arguments may be
    numpy arrays or tensors.
    """
    dev = _device_of(model)
    images = _images(images_u8, dev)
    out = model(images, _as(w, dev, torch.float32))
    dec = decode_outputs(cfg, out, tuple(images.shape[2:]))
    f32 = torch.float32
    return postprocess(cfg, dec, _as(scale_factor, dev, f32),
                       _as(pad_param, dev, f32), _as(ori_shape, dev, f32),
                       _as(class_mask, dev, torch.bool))


@torch.inference_mode()
def detect_step_tta(cfg: ModelCfg, model: WeDetectModule, images_u8, w,
                    scale_factor, pad_param, ori_shape,
                    class_mask=None) -> Detections:
    """Flip test-time augmentation in one detect step.

    Reference: test.py:95-128 --tta with the default DetTTAModel
    (horizontal RandomFlip view added after LetterResize; per-view
    predictions merged by one class-aware NMS at iou 0.5, top 100).
    As `wedetect_tpu.models.wedetect.detect_step_tta`: the flipped view
    is stacked onto the batch (one 2B forward), its letterbox pad
    mirrored (left/right swapped) so un-padding is exact, its boxes
    mirrored back in original-image coordinates, and the union of both
    views goes through one labeled NMS at tta_nms_iou_thr, keeping
    tta_max_per_img; the embeds are those of the kept detections.
    """
    dev = _device_of(model)
    f32 = torch.float32
    x = _as(images_u8, dev, torch.uint8)
    sf, pad, ori = (_as(a, dev, f32)
                    for a in (scale_factor, pad_param, ori_shape))
    b = x.shape[0]
    det = detect_step(cfg, model, torch.cat([x, x.flip(2)]), w,
                      torch.cat([sf, sf]),
                      torch.cat([pad, pad[:, [0, 1, 3, 2]]]),
                      torch.cat([ori, ori]), class_mask)
    fb = det.boxes[b:]
    wmax = ori[:, 1][:, None]
    fb = torch.stack([wmax - fb[..., 2], fb[..., 1],
                      wmax - fb[..., 0], fb[..., 3]], dim=-1)
    boxes = torch.cat([det.boxes[:b], fb], 1)
    scores, labels, valid, embeds = (torch.cat([a[:b], a[b:]], 1) for a in
                                     (det.scores, det.labels, det.valid,
                                      det.embeds))
    t = cfg.test
    res = nms_labeled(boxes, scores, labels, valid, t.tta_nms_iou_thr,
                      t.tta_max_per_img)
    idx = res.anchors.clamp(min=0).long()[..., None]
    kept = embeds.gather(1, idx.expand(-1, -1, embeds.shape[-1]))
    return Detections(boxes=res.boxes, scores=res.scores, labels=res.labels,
                      embeds=kept, anchors=res.anchors, valid=res.valid)


@torch.inference_mode()
def forward_raw(cfg: ModelCfg, model: WeDetectModule, images_u8,
                w=None) -> DetectorOutputs:
    """Decoded per-anchor outputs without NMS (for eval/proposals)."""
    dev = _device_of(model)
    images = _images(images_u8, dev)
    out = model(images, _as(w, dev, torch.float32))
    return decode_outputs(cfg, out, tuple(images.shape[2:]))


def per_anchor_scale_bias(cfg: ModelCfg, model: WeDetectModule,
                          img_size: Optional[Tuple[int, int]] = None):
    """Per-anchor (A,) logit_scale / bias vectors of the per-level
    contrastive heads (eval_recall.py:1334-1343 stores them)."""
    scales, biases = [], []
    for (h, w), c in zip(cfg.feat_sizes(img_size),
                         model.bbox_head.cls_contrasts):
        scales.append(np.full((h * w,), c.logit_scale.item(), np.float32))
        biases.append(np.full((h * w,), c.bias.item(), np.float32))
    return np.concatenate(scales), np.concatenate(biases)


def init_variables(cfg: ModelCfg, seed: int = 0,
                   device="cuda") -> WeDetectModule:
    """A randomly initialized WeDetectModule on `device`, in eval mode,
    seeded from torch.Generator(seed) (see nn/init.py)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        module = WeDetectModule(cfg)
    return init_module(module, seed, dev)
