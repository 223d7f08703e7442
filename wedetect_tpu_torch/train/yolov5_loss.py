"""YOLOv5 legacy anchor-based training loss, static shapes.

The port of `wedetect_tpu.train.yolov5_loss` (reference
wedetect/models/dense_heads/yolov5_head.py:474-700, loss_by_feat):

per level i with feature grid (H, W) and 3 base priors (grid units):
  1. gt cxcywh normalized to [0, 1], then scaled to grid units;
  2. shape match: max(wh_ratio, 1 / wh_ratio).max() < prior_match_thr;
  3. neighbour expansion: the left / up / right / bottom cell is also
     positive when the centre lies in the nearer half of its cell
     (near_neighbor_thr) and not on the border;
  4. box loss: 1 - CIoU(decoded xywh, [cell-relative xy, grid wh]),
     mean over positives, weight 0.05;
  5. obj loss: BCE over the whole (B, H, W, A) grid against the
     detached CIoU (clamped at 0) scattered at the positives, weight
     1.0, level weights (4.0, 1.0, 0.4);
  6. cls loss: BCE against one-hot labels, mean over positive x class
     elements, weight 0.5 (none when num_classes == 1);
  each scaled by `loss_scale` (batch x world in the reference).

The JAX package's static-shape design, kept: every (offset o of 5,
prior a of 3, gt g of G) triple is a candidate slot with a validity
mask, predictions are gathered at clamped indices, and the sums are
masked sums over counts. Where two candidates hit one (cell, prior)
slot, the obj target takes the larger CIoU (scatter-max,
deterministic); the torch reference's vectorized assignment keeps the
last one written instead.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from wedetect_tpu_torch.ops.boxes import bbox_overlaps_aligned
from wedetect_tpu_torch.ops.yolov5 import DEFAULT_ANCHORS
from wedetect_tpu_torch.train.losses import bce_with_logits


class V5Losses(NamedTuple):
    total: torch.Tensor
    cls: torch.Tensor
    obj: torch.Tensor
    bbox: torch.Tensor
    num_pos: torch.Tensor


def _cxcywh_to_xyxy(xy: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    half = wh / 2
    return torch.cat([xy - half, xy + half], dim=-1)


def _obj_target(lin: torch.Tensor, iou_t: torch.Tensor, valid: torch.Tensor,
                size: int) -> torch.Tensor:
    """The obj target (B, size): each candidate's detached CIoU at its
    slot `lin`, the larger one where candidates collide (scatter-max;
    `iou_t` is 0 at the invalid candidates, so `valid` is not needed)."""
    tgt = torch.zeros(lin.shape[0], size, dtype=iou_t.dtype,
                      device=iou_t.device)
    return tgt.scatter_reduce(1, lin, iou_t, reduce="amax")


# the candidate cell offsets: the centre, then left, up, right, bottom
_OFFSETS = ((0, 0), (1, 0), (0, 1), (-1, 0), (0, -1))


def yolov5_loss(preds: Sequence[torch.Tensor],
                gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor,
                gt_mask: torch.Tensor,
                img_hw: Tuple[int, int],
                anchors=DEFAULT_ANCHORS,
                strides: Sequence[int] = (8, 16, 32),
                prior_match_thr: float = 4.0,
                near_neighbor_thr: float = 0.5,
                obj_level_weights: Sequence[float] = (4.0, 1.0, 0.4),
                loss_cls_weight: float = 0.5,
                loss_obj_weight: float = 1.0,
                loss_bbox_weight: float = 0.05,
                loss_scale: float = 1.0) -> V5Losses:
    """preds: per-level raw (B, A, 5+K, H, W) (YOLOv5HeadModule's
    output); gt_boxes (B, G, 4) xyxy in input-image pixels; gt_labels
    (B, G) int; gt_mask (B, G) bool."""
    img_h, img_w = img_hw
    f32 = torch.float32
    dev = gt_boxes.device
    b, g = gt_boxes.shape[:2]
    num_classes = preds[0].shape[2] - 5
    gt_mask = gt_mask.bool()

    x1, y1, x2, y2 = gt_boxes.to(f32).unbind(-1)
    ncx, ncy = (x1 + x2) / 2 / img_w, (y1 + y2) / 2 / img_h
    nw, nh = (x2 - x1) / img_w, (y2 - y1) / img_h
    offs = torch.tensor(_OFFSETS, dtype=f32, device=dev)

    zero = torch.zeros((), dtype=f32, device=dev)
    loss_cls, loss_obj, loss_box, num_pos = zero, zero, zero, zero
    thr = near_neighbor_thr
    for i, (pred, stride) in enumerate(zip(preds, strides)):
        _, a, c, fh, fw = pred.shape
        # (B, H*W*A, 5+K): the JAX package's (H, W, A) order
        flat = pred.to(f32).permute(0, 3, 4, 1, 2).reshape(b, fh * fw * a, c)
        prior_wh = torch.tensor(anchors[i], dtype=f32, device=dev) / stride

        tcx, tcy = ncx * fw, ncy * fh                         # (B, G)
        twh = torch.stack([nw * fw, nh * fh], -1)             # (B, G, 2)

        # 2. shape match (B, A, G)
        r = twh[:, None] / prior_wh[None, :, None]            # (B,A,G,2)
        match = torch.maximum(r, 1.0 / r).amax(-1) < prior_match_thr
        match = match & gt_mask[:, None, :]

        # 3. neighbour-cell masks (B, G) each
        left = (tcx % 1 < thr) & (tcx > 1)
        up = (tcy % 1 < thr) & (tcy > 1)
        right = ((fw - tcx) % 1 < thr) & ((fw - tcx) > 1)
        bottom = ((fh - tcy) % 1 < thr) & ((fh - tcy) > 1)
        keep = torch.stack([torch.ones_like(left), left, up, right,
                            bottom], 1)                       # (B, 5, G)
        valid = match[:, None] & keep[:, :, None]             # (B,5,A,G)

        # candidate cells, one an offset (B, 5, G)
        gx = torch.floor(tcx[:, None] - offs[None, :, 0:1] * thr)
        gy = torch.floor(tcy[:, None] - offs[None, :, 1:2] * thr)
        gx = gx.clamp(0, fw - 1).long()
        gy = gy.clamp(0, fh - 1).long()

        # flatten the candidates (B, N), N = 5 * A * G
        n = 5 * a * g

        def bc(x):
            return x.expand(b, 5, a, g).reshape(b, n)

        gxc, gyc = bc(gx[:, :, None, :]), bc(gy[:, :, None, :])
        vc = bc(valid)
        pidx = bc(torch.arange(a, device=dev)[None, None, :, None])
        pwh = prior_wh[pidx]                                  # (B, N, 2)
        txyc = torch.stack([bc(tcx[:, None, None, :]),
                            bc(tcy[:, None, None, :])], -1)   # (B, N, 2)
        twhc = torch.stack([bc(twh[:, None, None, :, 0]),
                            bc(twh[:, None, None, :, 1])], -1)
        labc = bc(gt_labels[:, None, None, :].long())

        # gather the predictions at (gy, gx, prior)
        lin = (gyc * fw + gxc) * a + pidx                     # (B, N)
        pc = flat.gather(1, lin[..., None].expand(b, n, c))

        # 4. box loss (reference _decode_bbox_to_xywh :695-700)
        pxy = torch.sigmoid(pc[..., 0:2]) * 2 - 0.5
        pwh_dec = (torch.sigmoid(pc[..., 2:4]) * 2) ** 2 * pwh
        tgt_xy = txyc - torch.stack([gxc, gyc], -1).to(f32)
        ciou = bbox_overlaps_aligned(
            _cxcywh_to_xyxy(pxy, pwh_dec),
            _cxcywh_to_xyxy(tgt_xy, twhc), iou_mode="ciou")   # (B, N)
        vf = vc.to(f32)
        cnt = vf.sum()
        loss_box = loss_box + ((1.0 - ciou) * vf).sum() / cnt.clamp(min=1.0)
        num_pos = num_pos + cnt

        # 5. obj loss: the detached CIoU scattered into the whole grid
        iou_t = torch.where(vc, ciou.detach().clamp(min=0.0), 0.0)
        tgt_obj = _obj_target(lin, iou_t, vc, fh * fw * a)
        loss_obj = loss_obj + (bce_with_logits(flat[..., 4], tgt_obj).mean()
                               * obj_level_weights[i])

        # 6. cls loss (one-hot as jax.nn.one_hot: a label outside [0, K)
        # gives a zero row)
        if num_classes > 1:
            tcls = (labc[..., None] == torch.arange(
                num_classes, device=dev)).to(f32)
            lc = bce_with_logits(pc[..., 5:], tcls) * vf[..., None]
            loss_cls = loss_cls + lc.sum() / (cnt * num_classes).clamp(
                min=1.0)

    loss_cls = loss_cls * loss_cls_weight * loss_scale
    loss_obj = loss_obj * loss_obj_weight * loss_scale
    loss_box = loss_box * loss_bbox_weight * loss_scale
    return V5Losses(total=loss_cls + loss_obj + loss_box, cls=loss_cls,
                    obj=loss_obj, bbox=loss_box, num_pos=num_pos)
