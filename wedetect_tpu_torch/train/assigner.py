"""Batch Task-Aligned Assigner (TOOD TAL), batched over (B, G, A).

Port of `wedetect_tpu/train/assigner.py` (reference
wedetect/models/assigner/batch_task_aligned_assigner.py:160-456 and
assigner/utils.py:10-110, use_ciou=True, topk=10, alpha=0.5, beta=6.0):

1. alignment metric = score[gt_label]^alpha * clamp(CIoU, 0)^beta
2. candidate mask = prior center strictly inside gt
3. per-gt top-k candidates by metric (invalid gts masked out)
4. anchors claimed by >1 gt -> the gt with max CIoU wins
5. targets: one-hot scores scaled by the per-gt normalized metric

G is the padded gt axis, with a validity mask. Everything runs under
no_grad (the reference wraps the assigner in no_grad, JAX in
stop_gradient).

Ties: `jax.lax.top_k` takes the lower index first among equal metrics,
and many metrics are exactly 0 (every anchor outside a gt, and every
anchor past the few centres that a small gt holds), so which zeros
top-k picks decides `pos_mask`. `torch.topk` promises no order for
ties, so `_topk_mask` takes the first k of a stable descending sort.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wedetect_tpu_torch.ops.boxes import bbox_overlaps_aligned


class AssignResult(NamedTuple):
    labels: torch.Tensor    # (B, A) int32, num_classes for background
    bboxes: torch.Tensor    # (B, A, 4) assigned gt boxes (image units)
    scores: torch.Tensor    # (B, A, K) soft target scores
    fg_mask: torch.Tensor   # (B, A) bool
    gt_idx: torch.Tensor    # (B, A) int32 assigned gt index per anchor


def _topk_mask(metrics: torch.Tensor, topk: int,
               valid: torch.Tensor) -> torch.Tensor:
    """(B, G, A) metrics -> (B, G, A) {0, 1} top-k mask.

    The k largest metrics of each gt, ties to the lower anchor index; an
    invalid gt's indices are forced to 0 and an anchor hit more than once
    is zeroed (which also removes the index-0 hits of invalid gts when
    k > 1), as select_topk_candidates does."""
    idx = torch.sort(metrics, dim=-1, descending=True,
                     stable=True).indices[..., :topk]
    idx = torch.where(valid[..., None], idx, torch.zeros_like(idx))
    counts = torch.zeros(metrics.shape, dtype=torch.int32,
                         device=metrics.device)
    counts.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.int32))
    return torch.where(counts > 1, 0, counts).to(metrics.dtype)


def _one_hot(idx: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """f32 one-hot of `idx` along a new axis `dim`; an index outside
    [0, n) gives a zero vector (jax.nn.one_hot)."""
    ar = torch.arange(n, device=idx.device)
    shape = [1] * (idx.dim() + 1)
    shape[dim] = n
    return (idx.unsqueeze(dim) == ar.reshape(shape)).float()


@torch.no_grad()
def assign(pred_bboxes: torch.Tensor, pred_scores: torch.Tensor,
           priors_xy: torch.Tensor, gt_labels: torch.Tensor,
           gt_bboxes: torch.Tensor, gt_mask: torch.Tensor,
           num_classes: int, topk: int = 10, alpha: float = 0.5,
           beta: float = 6.0, eps: float = 1e-9) -> AssignResult:
    """pred_bboxes (B, A, 4) decoded xyxy; pred_scores (B, A, K) sigmoid;
    priors_xy (A, 2); gt_labels (B, G) int; gt_bboxes (B, G, 4) xyxy;
    gt_mask (B, G) bool (True = real gt)."""
    pred_bboxes = pred_bboxes.float()
    pred_scores = pred_scores.float()
    gt_bboxes = gt_bboxes.float()
    gt_mask = gt_mask.bool()
    k = pred_scores.shape[-1]
    g = gt_bboxes.shape[1]
    gtm = gt_mask.float()

    # --- alignment metric: the score of each anchor for each gt's class
    bbox_scores = pred_scores.transpose(1, 2).gather(
        1, gt_labels.long().clamp(0, k - 1)[:, :, None].expand(
            -1, -1, pred_scores.shape[1]))                     # (B, G, A)
    overlaps = bbox_overlaps_aligned(
        pred_bboxes[:, None, :, :], gt_bboxes[:, :, None, :],
        iou_mode="ciou").clamp(min=0.0)                        # (B, G, A)
    alignment = bbox_scores ** alpha * overlaps ** beta

    # --- in-gt + top-k masks
    px, py = priors_xy[:, 0], priors_xy[:, 1]
    inside = ((px[None, None, :] - gt_bboxes[..., 0:1] > eps)
              & (py[None, None, :] - gt_bboxes[..., 1:2] > eps)
              & (gt_bboxes[..., 2:3] - px[None, None, :] > eps)
              & (gt_bboxes[..., 3:4] - py[None, None, :] > eps)).float()
    topk_m = _topk_mask(alignment * inside, topk, gt_mask)
    pos_mask = topk_m * inside * gtm[..., None]                # (B, G, A)

    # --- resolve multi-gt anchors by max overlap
    multi = pos_mask.sum(dim=-2)[:, None, :] > 1
    is_max = _one_hot(overlaps.argmax(dim=1), g, dim=1)
    pos_mask = torch.where(multi, is_max, pos_mask)
    fg_mask = pos_mask.sum(dim=-2) > 0                          # (B, A)
    assigned_gt = pos_mask.argmax(dim=-2)                       # (B, A)

    # --- gather targets
    labels = gt_labels.long().clamp(min=0).gather(1, assigned_gt)
    bboxes = gt_bboxes.gather(1, assigned_gt[..., None].expand(-1, -1, 4))
    onehot = _one_hot(labels, num_classes, dim=-1)
    onehot = torch.where(fg_mask[..., None], onehot, 0.0)

    # --- per-gt metric normalization
    align_pos = alignment * pos_mask
    pos_align_max = align_pos.amax(dim=-1, keepdim=True)       # (B, G, 1)
    pos_overlap_max = (overlaps * pos_mask).amax(dim=-1, keepdim=True)
    norm = (align_pos * pos_overlap_max
            / (pos_align_max + eps)).amax(dim=-2)[..., None]   # (B, A, 1)
    return AssignResult(labels=labels.int(), bboxes=bboxes,
                        scores=onehot * norm, fg_mask=fg_mask,
                        gt_idx=assigned_gt.int())
