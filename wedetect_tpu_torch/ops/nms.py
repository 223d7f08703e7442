"""Static-shape multi-label top-k + class-aware greedy NMS.

The port of `wedetect_tpu.ops.nms`, with the same routing, tie rules
and fixed (max_out,) output slots:

1. multi-label expansion: scores (A, K) -> A*K candidates; candidates
   with score <= score_thr are masked to -inf.
2. top nms_pre candidates: a stable descending sort (the tie order of
   `lax.top_k`: lower flat index first), the exact bit bisection above
   TOPK_THRESHOLD_MIN_N candidates, or -- when every anchor holds at
   most ROW_TOPK_T candidates -- the per-anchor row top-k kernel
   (ops/row_topk.py) followed by one sort over the A*T remainder.
3. exact greedy class-aware NMS over score-sorted tiles.

Where JAX runs a data-dependent `while_loop` (the tile loop and the
fixpoint sweep of `_tile_greedy`) this runs a Python loop that reads
one flag from the device per step; batched inputs run as one loop
whose per-image results match the JAX vmap's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wedetect_tpu_torch.ops.row_topk import row_topk

NEG_INF = float("-inf")


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (B, max_out, 4)
    scores: torch.Tensor   # (B, max_out)
    labels: torch.Tensor   # (B, max_out) int32
    anchors: torch.Tensor  # (B, max_out) int32 -- source anchor index
    valid: torch.Tensor    # (B, max_out) bool


def _pairwise_iou_nn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (..., N, 4) and (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, 0:2], b[..., None, :, 0:2])
    rb = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0)
              * (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0)
              * (b[..., 3] - b[..., 1]).clamp(min=0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _tile_greedy(sup: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Exact greedy keep-mask within score-sorted tiles.

    sup (..., T, T): sup[j, i] means j (ranked higher) suppresses i,
    strictly upper-triangular. Solves keep[i] = alive[i] &
    !any_j(keep[j] & sup[j, i]) by fixpoint sweeps, which equals
    sequential greedy NMS. A converged row stays converged, so batched
    rows sweep together until all have converged.
    """
    keep = alive
    while True:
        new = alive & ~(keep[..., :, None] & sup).any(dim=-2)
        if torch.equal(new, keep):
            return keep
        keep = new


def _greedy_nms_tiled(boxes, scores, labels, anchors, iou_thr, max_out,
                      tile: int = 1024):
    """Exact greedy NMS over pre-sorted candidates, tile by tile.

    boxes (B, N, 4), scores (B, N), labels (B, N), anchors (B, N).
    Each tile is suppressed by the kept set so far, then resolved inside
    by `_tile_greedy`; kept candidates fill the max_out slots in order.
    The loop stops once every image's slots are full or its remaining
    candidates are all -inf: neither can change the kept set.
    """
    b, n = scores.shape
    dev = scores.device
    n_tiles = (n + tile - 1) // tile
    pad = n_tiles * tile - n
    if pad:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
        labels = torch.nn.functional.pad(labels, (0, pad), value=-2)
        anchors = torch.nn.functional.pad(anchors, (0, pad), value=-1)
    tri = torch.ones((tile, tile), dtype=torch.bool, device=dev).triu(1)

    # one extra dummy slot per image: non-kept / overflow candidates
    # scatter there, so real slots only receive their unique kept one
    m1 = max_out + 1
    kb = torch.zeros((b, m1, 4), dtype=boxes.dtype, device=dev)
    ks = torch.full((b, m1), NEG_INF, dtype=torch.float32, device=dev)
    kl = torch.full((b, m1), -1, dtype=torch.int32, device=dev)
    ka = torch.full((b, m1), -1, dtype=torch.int32, device=dev)
    kv = torch.zeros((b, m1), dtype=torch.bool, device=dev)
    n_kept = torch.zeros((b,), dtype=torch.int64, device=dev)

    for t in range(n_tiles):
        sl = slice(t * tile, (t + 1) * tile)
        if t and bool(((n_kept >= max_out)
                       | (scores[:, sl.start] == NEG_INF)).all()):
            break
        tb, ts, tl, ta = (x[:, sl] for x in (boxes, scores, labels,
                                             anchors))
        valid = ts > NEG_INF
        # suppression by already-kept boxes (the dummy slot is excluded)
        iou_prev = _pairwise_iou_nn(kb[:, :max_out], tb)
        sup_prev = ((iou_prev > iou_thr)
                    & (kl[:, :max_out, None] == tl[:, None, :])
                    & kv[:, :max_out, None])
        alive = valid & ~sup_prev.any(dim=1)
        iou_self = _pairwise_iou_nn(tb, tb)
        sup_self = ((iou_self > iou_thr)
                    & (tl[:, :, None] == tl[:, None, :]) & tri)
        keep = _tile_greedy(sup_self, alive)
        pos = n_kept[:, None] + keep.cumsum(dim=1) - 1
        pos = torch.where(keep & (pos < max_out), pos, max_out)
        kb.scatter_(1, pos[..., None].expand(-1, -1, 4), tb)
        ks.scatter_(1, pos, ts)
        kl.scatter_(1, pos, tl)
        ka.scatter_(1, pos, ta)
        kv.scatter_(1, pos, keep)
        n_kept = torch.clamp(n_kept + keep.sum(dim=1), max=max_out)

    kb, ks, kl, ka, kv = (x[:, :max_out] for x in (kb, ks, kl, ka, kv))
    ks = torch.where(kv, ks, 0.0)
    kl = torch.where(kv, kl, -1)
    ka = torch.where(kv, ka, -1)
    kb = torch.where(kv[..., None], kb, 0.0)
    return kb, ks, kl, ka, kv


def _topk_desc(x: torch.Tensor, k: int):
    """`lax.top_k` over the last axis: the k largest, descending, equal
    values in ascending index order (a stable descending sort; torch.topk
    promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_threshold(flat: torch.Tensor, k: int, iters: int = 42):
    """Exact top-k over a large score array in [0, 1] (or -inf).

    flat (B, N) -> (scores (B, k), indices (B, k) int64), descending;
    empty slots hold -inf. The k-th value is found by bisection on the
    int32 bit pattern (order-preserving for non-negative f32; -inf
    entries read negative and never count). The survivors `bits > hi`
    are taken in flat order and sorted stably, so ties resolve by flat
    index -- except at the k-th value itself, where all tied candidates
    are dropped and fewer than k may be returned (the same freedom the
    JAX version documents).
    """
    b, n = flat.shape
    bits = flat.contiguous().view(torch.int32)
    lo = torch.full((b, 1), -1, dtype=torch.int32, device=flat.device)
    hi = torch.full((b, 1), 0x7F800000, dtype=torch.int32,
                    device=flat.device)
    for _ in range(max(iters, 32)):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        too_many = (bits > mid).sum(dim=1, keepdim=True) > k
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)

    mask = bits > hi                                  # <= k per row
    rank = mask.cumsum(dim=1) - 1
    rows, cols = mask.nonzero(as_tuple=True)
    sel = torch.zeros((b, k), dtype=torch.int64, device=flat.device)
    sel[rows, rank[rows, cols]] = cols
    q = torch.arange(k, device=flat.device)
    valid = q[None, :] < mask.sum(dim=1, keepdim=True)
    vals = torch.where(valid, flat.gather(1, sel), NEG_INF)
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals, sel.gather(1, order)


# use the bisection path above this many candidates (the JAX package's
# crossover, kept so both packages route every shape alike)
TOPK_THRESHOLD_MIN_N = 1 << 21


def _select(scores: torch.Tensor, score_thr: float, nms_pre: int,
            class_mask: Optional[torch.Tensor], multi_label: bool):
    """Per-image candidate selection of `static_nms_single`, batched:
    (B, A, K) -> top scores (B, n), anchors (B, n) and labels (B, n)
    int32."""
    b, a, k = scores.shape
    s = scores.to(torch.float32)
    if class_mask is not None:
        s = torch.where(class_mask[None, None, :], s, NEG_INF)
    if multi_label and k > 1:
        flat = s.reshape(b, a * k)
        flat = torch.where(flat > score_thr, flat, NEG_INF)
        nms_pre = min(nms_pre, a * k)
        if a * k >= TOPK_THRESHOLD_MIN_N:
            top_scores, top_idx = _topk_threshold(flat, nms_pre)
        else:
            top_scores, top_idx = _topk_desc(flat, nms_pre)
        anchor_idx = torch.div(top_idx, k, rounding_mode="floor")
        label_idx = top_idx % k
    else:
        best_scores = s.max(dim=-1).values
        best_labels = s.argmax(dim=-1)      # first maximum, as jnp.argmax
        best_scores = torch.where(best_scores > score_thr, best_scores,
                                  NEG_INF)
        top_scores, anchor_idx = _topk_desc(best_scores, min(nms_pre, a))
        label_idx = best_labels.gather(1, anchor_idx)
    return (top_scores, anchor_idx.to(torch.int32),
            label_idx.to(torch.int32))


def _nms_candidates(boxes, scores, anchor_idx, label_idx, iou_thr,
                    max_out):
    """Gather each candidate's box and run the batched greedy NMS."""
    cand = boxes.gather(1, anchor_idx.long()[..., None].expand(-1, -1, 4))
    return _greedy_nms_tiled(cand.to(torch.float32), scores, label_idx,
                             anchor_idx, iou_thr, max_out)


def static_nms_single(scores_ak: torch.Tensor, boxes_a: torch.Tensor,
                      score_thr: float, nms_pre: int, iou_thr: float,
                      max_out: int,
                      class_mask: Optional[torch.Tensor] = None,
                      multi_label: bool = True):
    """Single-image pipeline: (A, K) scores + (A, 4) boxes -> NMS slots
    (boxes, scores, labels, anchors, valid), each without a batch axis.

    class_mask: optional (K,) bool -- False lanes are excluded.
    """
    sel = _select(scores_ak[None], score_thr, nms_pre, class_mask,
                  multi_label)
    out = _nms_candidates(boxes_a[None], *sel, iou_thr, max_out)
    return tuple(x[0] for x in out)


# per-anchor pre-reduction width of the row top-k path
ROW_TOPK_T = 64


def _pick_row_block(rows: int) -> int | None:
    """The JAX kernel's row block. The CUDA kernel needs none; the check
    stays so both packages take the same branch for every shape."""
    for rb in (240, 168, 120, 80, 56, 40, 24, 16, 8):
        if rows % rb == 0:
            return rb
    return None


def _batched_select_topk(scores: torch.Tensor, score_thr: float,
                         nms_pre: int, class_mask, t: int):
    """Batched exact top-nms_pre (value, anchor, label) selection.

    SPARSE (every anchor has <= t candidates above score_thr, the
    trained-checkpoint regime): the row top-k kernel extracts all
    above-threshold candidates per anchor, then one stable sort over the
    A*t remainder. DENSE (some anchor exceeds t): bisection +
    extraction (`_topk_threshold`). Both resolve ties by flat
    (anchor-major, class-minor) index, up to ties exactly at the k-th
    value (see `_topk_threshold`).
    """
    b, a, k = scores.shape
    s = scores.to(torch.float32)
    if class_mask is not None:
        s = torch.where(class_mask[None, None, :], s, NEG_INF)
    s = torch.where(s > score_thr, s, NEG_INF)

    dense = bool(((s > NEG_INF).sum(dim=-1) > t).any())
    if dense:
        tvs, tis = _topk_threshold(s.reshape(b, a * k), nms_pre)
        return (tvs, torch.div(tis, k, rounding_mode="floor").to(torch.int32),
                (tis % k).to(torch.int32))
    vals, cls = row_topk(s.reshape(b * a, k), t)
    tv, ti = _topk_desc(vals.reshape(b, a * t), nms_pre)
    anchor_idx = torch.div(ti, t, rounding_mode="floor").to(torch.int32)
    label_idx = cls.reshape(b, a * t).gather(1, ti).to(torch.int32)
    return tv, anchor_idx, label_idx


def batched_static_nms(scores: torch.Tensor, boxes: torch.Tensor,
                       score_thr: float = 0.001, nms_pre: int = 30000,
                       iou_thr: float = 0.7, max_out: int = 300,
                       class_mask: Optional[torch.Tensor] = None,
                       multi_label: bool = True) -> NMSResult:
    """Batched static NMS. scores: (B, A, K) post-sigmoid; boxes:
    (B, A, 4) xyxy."""
    b, a, k = scores.shape
    t = min(ROW_TOPK_T, k)
    rb = _pick_row_block(b * a)
    np_eff = min(nms_pre, a * k)
    if (multi_label and k > 1 and a * k >= TOPK_THRESHOLD_MIN_N
            and rb is not None and np_eff <= a * t):
        sel = _batched_select_topk(scores, score_thr, np_eff, class_mask,
                                   t)
    else:
        sel = _select(scores, score_thr, nms_pre, class_mask, multi_label)
    return NMSResult(*_nms_candidates(boxes, *sel, iou_thr, max_out))


def nms_labeled(boxes: torch.Tensor, scores: torch.Tensor,
                labels: torch.Tensor, valid: torch.Tensor,
                iou_thr: float, max_out: int) -> NMSResult:
    """Batched class-aware NMS over already-labeled detections.

    boxes (B, N, 4), scores (B, N), labels (B, N), valid (B, N) ->
    NMSResult with max_out slots (anchors = source index into N).
    """
    s = torch.where(valid, scores.to(torch.float32), NEG_INF)
    s, order = torch.sort(s, dim=1, descending=True, stable=True)
    bx = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    return NMSResult(*_greedy_nms_tiled(
        bx.to(torch.float32), s, labels.gather(1, order),
        order.to(torch.int32), iou_thr, max_out))
