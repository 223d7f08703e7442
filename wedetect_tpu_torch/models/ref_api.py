"""High-level WeDetect-Ref scorer: image + proposals + queries -> scores.

Port of the scoring half of `wedetect_tpu/models/ref_api.py` (reference
infer_wedetect_ref.py:53-131): the queries of one image are batched into
one prefill per bucket, with the Qwen chat layout of the reference
(user: image + 'Please detect the "<query>" in the image'; assistant:
"<object>" * N). With `prefix_sharing` (the default) the image-bearing
prefix runs the decoder once per image and each batch of queries runs
only its suffix against the prefix KV.

    scorer = RefScorer(cfg=cfg, model=model, tokenizer=tok)   # cuda
    scores = scorer.score(image_rgb_uint8, boxes_xyxy, ["the red car"])

Generation (`generate_text`: `models/ref_generate`, or
`models/ref_speculative` with `speculative=True`) and continuous-batching
generation (`generate_batch`: `models/serve.GenServer`) take the same
image through the chat template of `_build_gen_prompt`;
`quantize_decode` ("int8" / True, or "int4") feeds their decode steps a
`models/quant` tree; `calibrate_decode` fits the int4 tree on the
prefill activations of calibration requests (`models/quant_calib`).
`quant_prefill` sets `cfg.quant_int8`: every prefill (score, the prefill
of `generate_text` and `generate_batch`, calibration's vision tower)
runs the ViT and decoder matmuls in dynamic int8 (`ops/int8.py`). The
flag is the scorer's: each entry point sets the model's int8 modules
from `cfg.quant_int8` for its call and restores them after.

`score_rec` scores one query an image across images (the refcoco
protocol): with `grid_buckets` and `prefix_sharing`, the images of a
bucket go in chunks of `query_batch` through one fused step each
(`models/ref.ref_rec_batch_step`), else each through `score()`.
`score_multi_images` scores queries against the proposals of several
images in one conversation (`models/ref.score_multi`, or with
`prefix_sharing` one multi-image prefix stage and the suffix stages).
`rec_logits` and `multi_image_logits` return their pre-sigmoid scores,
as `logits` does for `score`.

`generate_video_text` is video chat: the frames of any
`data/vision_process.fetch_video` source, temporally patched
(`video_to_patches`), go in as one contiguous video span with
`get_rope_index_single_video` ids through the same generation
(`ref_generate(grid_t=...)`).

`device` defaults to "cuda" and raises without a card. The model's
matmul weights are cast to `dtype` once, at construction.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from wedetect_tpu_torch import resolve_device
from wedetect_tpu_torch.models.ref import (RefModules, cast_ref_model,
                                           ref_prefix_step,
                                           ref_prefix_step_multi,
                                           ref_rec_batch_step,
                                           ref_score_step,
                                           ref_score_step_multi,
                                           ref_suffix_step)
from wedetect_tpu_torch.nn.qwen3vl import (RefCfg, get_rope_index_multi,
                                           get_rope_index_single_image,
                                           get_rope_index_single_video)
from wedetect_tpu_torch.ops.attention import is_flash_tileable
from wedetect_tpu_torch.ops.int8 import quant_mode

QUERY_TEMPLATE = 'Please detect the "%s" in the image'


def _scorer_int8(fn):
    """Run a RefScorer entry point with the model's int8 modules set
    from the scorer's cfg (`quant_mode`), restored after the call."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        with quant_mode(self.model, self.cfg.quant_int8):
            return fn(self, *args, **kwargs)
    return run


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _drain_rec(out, fut, rows):
    """Read one fused REC step's (B, N) logits back into out[idx] for
    its real rows (the pad rows of a chunk are dropped)."""
    logits = fut.float().cpu().numpy()
    for i, s in enumerate(rows):
        out[s["idx"]] = logits[i, :s["n"]]


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n  # beyond the largest bucket: use the exact length


def pad_to_tileable_bucket(n: int, buckets: Sequence[int]) -> int:
    """`pad_to_bucket`, except that a length beyond the largest bucket
    is rounded up to a multiple of 128, which the flash kernels tile
    (the JAX package keeps the exact length and runs the einsum there;
    on the card the port's attention raises instead)."""
    if n > max(buckets):
        return -(-n // 128) * 128
    return pad_to_bucket(n, buckets)


@dataclasses.dataclass
class RefScorer:
    cfg: RefCfg
    model: RefModules
    tokenizer: object = None           # HF tokenizer (or any .encode)
    seq_buckets: Tuple[int, ...] = (512, 1024, 2048, 4096)
    query_batch: int = 8
    max_proposals: int = 100
    # snap images to a fixed grid set (None = exact smart_resize grids)
    grid_buckets: Optional[Tuple[Tuple[int, int], ...]] = None
    dtype: str = "float32"             # or "bfloat16"
    attn_impl: str = "auto"            # the kernels on the card
    prefix_sharing: bool = True
    suffix_buckets: Tuple[int, ...] = (128, 256, 512, 1024)
    # ship resized uint8 pixels and patchify on the device
    device_patchify: bool = True
    # dispatched query batches in flight before readbacks start
    dispatch_window: int = 4
    device: str = "cuda"
    # weight-only quantized generation decode (models/quant): True or
    # "int8" (per-channel scales), "int4" (rank-1 two-sided scales,
    # lossier); prefill and scoring stay full precision
    quantize_decode: object = False
    # dynamic int8 prefill matmuls (ops/int8.py via RefCfg.quant_int8),
    # independent of quantize_decode and composable with it
    quant_prefill: bool = False
    _decode_params: object = dataclasses.field(default=None, init=False,
                                               repr=False)

    def __post_init__(self):
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {self.dtype!r}: float32 or bfloat16")
        if self.quant_prefill and not self.cfg.quant_int8:
            self.cfg = dataclasses.replace(self.cfg, quant_int8=True)
        dev = resolve_device(self.device)
        self.model = cast_ref_model(self.model.to(dev), self.dtype)
        self.model.attn_impl = self.attn_impl
        # a bucket the kernels cannot tile would make every prefill on
        # the card raise: fail at construction
        if self.attn_impl == "einsum" or (self.attn_impl == "auto"
                                          and dev.type != "cuda"):
            return
        for name, buckets in (("seq_buckets", self.seq_buckets),
                              ("suffix_buckets", self.suffix_buckets)):
            bad = [b for b in buckets if not is_flash_tileable(b)]
            if bad:
                raise ValueError(
                    f"{name} {bad} not tileable for flash attention "
                    "(each bucket must be a multiple of 128)")

    # ------------------------------------------------------------ layout
    def build_prefix(self, n_img: int) -> np.ndarray:
        """Shared token prefix: chat preamble + vision span."""
        c = self.cfg
        tok = self.tokenizer
        assert tok is not None, "tokenizer required to build sequences"
        pre = tok.encode("<|im_start|>user\n", add_special_tokens=False)
        ve = tok.encode("<|vision_end|>", add_special_tokens=False)
        return np.array(pre + [c.vision_start_token_id]
                        + [c.image_token_id] * n_img + ve, np.int32)

    def build_suffix(self, query: str, n_obj: int) -> np.ndarray:
        """Per-query tail: query text + <object> slots."""
        c = self.cfg
        tok = self.tokenizer
        assert tok is not None, "tokenizer required to build sequences"
        q = tok.encode(QUERY_TEMPLATE % query, add_special_tokens=False)
        mid = tok.encode("<|im_end|>\n<|im_start|>assistant\n",
                         add_special_tokens=False)
        end = tok.encode("<|im_end|>\n", add_special_tokens=False)
        return np.array(q + mid + [c.object_token_id] * n_obj + end,
                        np.int32)

    def build_sequence(self, query: str, n_img: int, n_obj: int
                       ) -> np.ndarray:
        """Token ids for one chat with the image/object spans."""
        return np.concatenate([self.build_prefix(n_img),
                               self.build_suffix(query, n_obj)])

    def build_prefix_multi(self, n_imgs: Sequence[int]) -> np.ndarray:
        """Chat preamble + several vision spans, one an image."""
        c = self.cfg
        tok = self.tokenizer
        assert tok is not None, "tokenizer required to build sequences"
        parts = [tok.encode("<|im_start|>user\n", add_special_tokens=False)]
        ve = tok.encode("<|vision_end|>", add_special_tokens=False)
        for n in n_imgs:
            parts += [[c.vision_start_token_id], [c.image_token_id] * n, ve]
        return np.array([t for p in parts for t in p], np.int32)

    def _prep_patches(self, image: np.ndarray):
        """Resize (PIL-bicubic parity), then the resized uint8 pixels
        (device_patchify) or host-extracted f32 patches."""
        from wedetect_tpu_torch.data import vision_process as vp

        v = self.cfg.vision
        if self.device_patchify:
            return vp.image_to_pixels(image, patch=v.patch, merge=v.merge,
                                      grid_buckets=self.grid_buckets)
        return vp.image_to_patches(image, patch=v.patch,
                                   temporal_patch=v.temporal_patch,
                                   merge=v.merge,
                                   grid_buckets=self.grid_buckets)

    def _prep_proposals(self, proposals, w, h):
        """Clip to the image and pad the proposal axis to max_proposals
        (padded slots repeat the last box and are sliced off).
        Returns (padded (n_pad, 4), n)."""
        n_pad = self.max_proposals
        pr = np.array(proposals, np.float32, copy=True).reshape(-1, 4)
        pr = pr[:n_pad]
        pr[:, 0::2] = np.clip(pr[:, 0::2], 0, w)
        pr[:, 1::2] = np.clip(pr[:, 1::2], 0, h)
        n = len(pr)
        if n < n_pad:
            pr = np.concatenate(
                [pr, np.tile(pr[-1:] if n else
                             np.array([[0, 0, 1, 1]], np.float32),
                             (n_pad - n, 1))])
        return pr, n

    def _prefix_layout(self, gh, gw, pad_token_id):
        """(ids (1, P), mask (1, P), MRoPE positions (3, 1, P),
        visual_start, next_pos) of the shared prefix, P padded to a
        multiple of 128; next_pos is the first suffix token's position."""
        c = self.cfg
        mh, mw = gh // c.vision.merge, gw // c.vision.merge
        prefix = self.build_prefix(mh * mw)
        p_real = len(prefix)
        p_pad = -(-p_real // 128) * 128
        ids = np.full((1, p_pad), pad_token_id, np.int32)
        ids[0, :p_real] = prefix
        mask = np.zeros((1, p_pad), np.int32)
        mask[0, :p_real] = 1
        visual_start = int(np.nonzero(prefix == c.image_token_id)[0][0])
        pos = np.zeros((3, 1, p_pad), np.int32)
        pos[:, 0, :p_real] = get_rope_index_single_image(
            prefix, c.image_token_id, gh, gw, c.vision.merge)
        next_pos = int(visual_start + max(mh, mw)
                       + (p_real - visual_start - mh * mw))
        return ids, mask, pos, visual_start, next_pos

    def _pack_suffixes(self, sufs, s_pad, n_pad, pad_token_id):
        """Right-padded suffix rows: (ids, mask, suffix-relative object
        positions)."""
        b = len(sufs)
        ids = np.full((b, s_pad), pad_token_id, np.int32)
        mask = np.zeros((b, s_pad), np.int32)
        objp = np.zeros((b, n_pad), np.int32)
        for i, suf in enumerate(sufs):
            ids[i, :len(suf)] = suf
            mask[i, :len(suf)] = 1
            objp[i] = np.nonzero(suf == self.cfg.object_token_id)[0][:n_pad]
        return ids, mask, objp

    def _dispatch_batches(self, nq, n_pad, ids, mask, pos, obj_pos,
                          step_fn):
        """step_fn over query_batch-sized row groups; the last partial
        group is padded with copies of its first row (sliced off). CUDA
        work is queued ahead of the readbacks, at most dispatch_window
        groups deep."""
        out = np.zeros((nq, n_pad), np.float32)
        bsz = self.query_batch
        futs = []

        def drain_one():
            sl, rows, fut = futs.pop(0)
            out[sl] = fut.float().cpu().numpy()[:rows]

        for st in range(0, nq, bsz):
            en = min(st + bsz, nq)
            pad_rows = bsz - (en - st)
            sl = slice(st, en)
            idsb = np.concatenate([ids[sl]] + [ids[st:st + 1]] * pad_rows)
            maskb = np.concatenate([mask[sl]]
                                   + [mask[st:st + 1]] * pad_rows)
            posb = np.concatenate([pos[:, sl]]
                                  + [pos[:, st:st + 1]] * pad_rows, axis=1)
            objb = np.concatenate([obj_pos[sl]]
                                  + [obj_pos[st:st + 1]] * pad_rows)
            futs.append((sl, en - st, step_fn(idsb, maskb, posb, objb)))
            if len(futs) > self.dispatch_window:
                drain_one()
        while futs:
            drain_one()
        return out

    # ------------------------------------------------------------- score
    def score(self, image: np.ndarray, proposals: np.ndarray,
              queries: Sequence[str],
              pad_token_id: int = 151643) -> np.ndarray:
        """image HWC uint8 RGB; proposals (N, 4) xyxy in image coords ->
        (num_queries, N) sigmoid scores."""
        return _sigmoid(self.logits(image, proposals, queries, pad_token_id))

    @_scorer_int8
    def logits(self, image: np.ndarray, proposals: np.ndarray,
               queries: Sequence[str],
               pad_token_id: int = 151643) -> np.ndarray:
        """The (num_queries, N) pre-sigmoid scores of `score`."""
        c = self.cfg
        h, w = image.shape[:2]
        proposals, n = self._prep_proposals(proposals, w, h)
        n_pad = self.max_proposals
        patches, gh, gw = self._prep_patches(image)
        n_img = (gh // c.vision.merge) * (gw // c.vision.merge)
        dev = self.model.device
        patches = torch.tensor(patches, device=dev)
        boxes = torch.as_tensor(proposals, device=dev)
        ori = torch.tensor([w, h], dtype=torch.float32, device=dev)
        if self.prefix_sharing:
            return self._score_split(patches, gh, gw, boxes, ori, n, n_pad,
                                     queries, pad_token_id)

        seqs = [self.build_sequence(q, n_img, n_pad) for q in queries]
        l = pad_to_tileable_bucket(max(len(s) for s in seqs),
                                   self.seq_buckets)
        ids = np.full((len(seqs), l), pad_token_id, np.int32)
        mask = np.zeros((len(seqs), l), np.int32)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
            mask[i, :len(s)] = 1
        visual_start = int(np.nonzero(seqs[0] == c.image_token_id)[0][0])
        obj_pos = np.stack([np.nonzero(s == c.object_token_id)[0][:n_pad]
                            for s in seqs]).astype(np.int32)
        pos = np.stack([
            np.pad(get_rope_index_single_image(
                s, c.image_token_id, gh, gw, c.vision.merge),
                ((0, 0), (0, l - len(s))))
            for s in seqs], axis=1)                   # (3, Q, L)
        out = self._dispatch_batches(
            len(seqs), n_pad, ids, mask, pos, obj_pos,
            lambda idsb, maskb, posb, objb: ref_score_step(
                self.model, gh, gw, patches, idsb, maskb, posb,
                visual_start, boxes, ori, objb))
        return out[:, :n]

    def _score_split(self, patches, gh, gw, boxes, ori, n, n_pad, queries,
                     pad_token_id):
        """Prefix sharing: one image-level stage (vision + objects +
        prefix decoder pass) whose outputs feed every query batch's
        suffix stage."""
        sufs = [self.build_suffix(q, n_pad) for q in queries]
        s_pad = pad_to_tileable_bucket(max(len(s) for s in sufs),
                                       self.suffix_buckets)
        (prefix_ids, prefix_mask, pos_prefix, visual_start,
         next_pos) = self._prefix_layout(gh, gw, pad_token_id)
        nq = len(sufs)
        suffix_ids, suffix_mask, obj_pos = self._pack_suffixes(
            sufs, s_pad, n_pad, pad_token_id)
        pos_suffix = np.broadcast_to(
            (next_pos + np.arange(s_pad, dtype=np.int32))[None, None],
            (3, nq, s_pad)).copy()
        pmask = torch.as_tensor(prefix_mask, device=self.model.device)
        obj, kvs = ref_prefix_step(self.model, gh, gw, patches, prefix_ids,
                                   pmask, pos_prefix, boxes, ori,
                                   visual_start)
        out = self._dispatch_batches(
            nq, n_pad, suffix_ids, suffix_mask, pos_suffix, obj_pos,
            lambda idsb, maskb, posb, objb: ref_suffix_step(
                self.model, obj, kvs, idsb, maskb, posb, pmask, objb))
        return out[:, :n]

    # --------------------------------------------------- cross-image REC
    def score_rec(self, samples, pad_token_id: int = 151643):
        """Cross-image REC scoring: samples are (image HWC uint8,
        proposals (N_i, 4), query) with one query an image (the refcoco
        protocol). Returns a list of (N_i,) sigmoid scores in input
        order."""
        return [_sigmoid(x) for x in self.rec_logits(samples, pad_token_id)]

    @_scorer_int8
    def rec_logits(self, samples, pad_token_id: int = 151643):
        """The pre-sigmoid scores of `score_rec`. Images that snap to the
        same grid bucket go in chunks of query_batch through one fused
        step each (ref_rec_batch_step); a partial chunk is padded by
        repeating its last sample, whose rows are dropped. Without
        grid_buckets or prefix_sharing each image goes through logits(),
        as the JAX package does."""
        if not self.prefix_sharing or not self.grid_buckets:
            return [self.logits(im, pr, [q], pad_token_id)[0]
                    for im, pr, q in samples]
        n_pad = self.max_proposals
        dev = self.model.device
        groups = {}
        for idx, (image, proposals, query) in enumerate(samples):
            h, w = image.shape[:2]
            pr, n = self._prep_proposals(proposals, w, h)
            patches, gh, gw = self._prep_patches(image)
            groups.setdefault((gh, gw), []).append(dict(
                idx=idx, patches=patches, pr=pr, n=n, wh=(w, h),
                query=query))
        out = [None] * len(samples)
        futs = []
        bsz = self.query_batch
        for (gh, gw), grp in groups.items():
            (prefix_ids, prefix_mask, ppos, visual_start,
             next_pos) = self._prefix_layout(gh, gw, pad_token_id)
            sufs = [self.build_suffix(s["query"], n_pad) for s in grp]
            s_pad = pad_to_tileable_bucket(max(len(x) for x in sufs),
                                           self.suffix_buckets)
            spos = np.broadcast_to(
                (next_pos + np.arange(s_pad, dtype=np.int32))[None, None],
                (3, bsz, s_pad)).copy()
            for st in range(0, len(grp), bsz):
                chunk = grp[st:st + bsz]
                pad = [chunk[-1]] * (bsz - len(chunk))
                sids, smask, objp = self._pack_suffixes(
                    sufs[st:st + bsz] + [sufs[st + len(chunk) - 1]]
                    * len(pad), s_pad, n_pad, pad_token_id)
                rows = chunk + pad
                fut = ref_rec_batch_step(
                    self.model, gh, gw,
                    torch.as_tensor(np.stack([r["patches"] for r in rows]),
                                    device=dev),
                    np.tile(prefix_ids, (bsz, 1)),
                    np.tile(prefix_mask, (bsz, 1)),
                    np.tile(ppos, (bsz, 1, 1, 1)),
                    np.stack([r["pr"] for r in rows]),
                    np.array([r["wh"] for r in rows], np.float32),
                    visual_start, sids, smask, spos, objp)
                futs.append((fut, chunk))
                if len(futs) > self.dispatch_window:
                    _drain_rec(out, *futs.pop(0))
        while futs:
            _drain_rec(out, *futs.pop(0))
        return out

    # ------------------------------------------------------- multi-image
    def score_multi_images(self, images, proposals_list,
                           queries: Sequence[str],
                           pad_token_id: int = 151643):
        """Score proposals across several images in one conversation
        (a layout the reference model takes, qwen3vl_referring.py:
        186-258, that its single-image eval drivers never use). images:
        HWC uint8 RGB; proposals_list: per image (N_i, 4) xyxy boxes or
        None (context only); each query scored in its own row against
        every proposal. Returns a list of (num_queries, N_i) sigmoid
        scores, one a proposal-bearing image, in image order."""
        return [_sigmoid(x) for x in self.multi_image_logits(
            images, proposals_list, queries, pad_token_id)]

    @_scorer_int8
    def multi_image_logits(self, images, proposals_list,
                           queries: Sequence[str],
                           pad_token_id: int = 151643):
        """The pre-sigmoid scores of `score_multi_images`."""
        c = self.cfg
        m = c.vision.merge
        n_pad = self.max_proposals
        dev = self.model.device
        patches_list, grids, ori_list, boxes_list, n_real = [], [], [], [], []
        for image, proposals in zip(images, proposals_list):
            h, w = image.shape[:2]
            patches, gh, gw = self._prep_patches(image)
            patches_list.append(torch.tensor(patches, device=dev))
            grids.append((gh, gw))
            ori_list.append(torch.tensor([w, h], dtype=torch.float32,
                                         device=dev))
            if proposals is None:
                boxes_list.append(None)
            else:
                pr, n = self._prep_proposals(proposals, w, h)
                boxes_list.append(torch.as_tensor(pr, device=dev))
                n_real.append(n)
        n_total = n_pad * len(n_real)
        n_imgs = [(gh // m) * (gw // m) for gh, gw in grids]
        prefix = self.build_prefix_multi(n_imgs)
        img_pos = np.nonzero(prefix == c.image_token_id)[0]
        starts = [int(img_pos[off]) for off in np.cumsum([0] + n_imgs[:-1])]
        images_args = (patches_list, grids, boxes_list, ori_list, starts)
        if self.prefix_sharing:
            out = self._score_multi_split(*images_args, prefix, n_total,
                                          queries, pad_token_id)
        else:
            seqs = [np.concatenate([prefix, self.build_suffix(q, n_total)])
                    for q in queries]
            l = pad_to_tileable_bucket(max(len(s) for s in seqs),
                                       self.seq_buckets)
            ids = np.full((len(seqs), l), pad_token_id, np.int32)
            mask = np.zeros((len(seqs), l), np.int32)
            for i, s in enumerate(seqs):
                ids[i, :len(s)] = s
                mask[i, :len(s)] = 1
            obj_pos = np.stack([
                np.nonzero(s == c.object_token_id)[0][:n_total]
                for s in seqs]).astype(np.int32)
            pos = np.stack([
                np.pad(get_rope_index_multi(s, c.image_token_id, grids, m),
                       ((0, 0), (0, l - len(s))))
                for s in seqs], axis=1).astype(np.int32)   # (3, Q, L)
            out = self._dispatch_batches(
                len(seqs), n_total, ids, mask, pos, obj_pos,
                lambda idsb, maskb, posb, objb: ref_score_step_multi(
                    self.model, grids, patches_list, idsb, maskb, posb,
                    boxes_list, ori_list, starts, objb))
        return [out[:, i * n_pad:i * n_pad + n]
                for i, n in enumerate(n_real)]

    def _score_multi_split(self, patches_list, grids, boxes_list, ori_list,
                           starts, prefix, n_total, queries, pad_token_id):
        """Prefix sharing across several images: every image lies in the
        shared prefix, so one ref_prefix_step_multi covers every image's
        vision, RoI and the joint prefix pass; the query batches ride
        ref_suffix_step. The suffix starts at the prefix's largest
        position + 1."""
        c = self.cfg
        p_real = len(prefix)
        p_pad = -(-p_real // 128) * 128
        prefix_ids = np.full((1, p_pad), pad_token_id, np.int32)
        prefix_ids[0, :p_real] = prefix
        pmask = np.zeros((1, p_pad), np.int32)
        pmask[0, :p_real] = 1
        prefix_pos = get_rope_index_multi(prefix, c.image_token_id, grids,
                                          c.vision.merge)
        ppos = np.zeros((3, 1, p_pad), np.int32)
        ppos[:, 0, :p_real] = prefix_pos
        next_pos = int(prefix_pos.max()) + 1
        sufs = [self.build_suffix(q, n_total) for q in queries]
        s_pad = pad_to_tileable_bucket(max(len(s) for s in sufs),
                                       self.suffix_buckets)
        suffix_ids, suffix_mask, obj_pos = self._pack_suffixes(
            sufs, s_pad, n_total, pad_token_id)
        nq = len(sufs)
        pos_suffix = np.broadcast_to(
            (next_pos + np.arange(s_pad, dtype=np.int32))[None, None],
            (3, nq, s_pad)).copy()
        pmask_t = torch.as_tensor(pmask, device=self.model.device)
        obj, kvs = ref_prefix_step_multi(
            self.model, grids, patches_list, prefix_ids, pmask_t, ppos,
            boxes_list, ori_list, starts)
        return self._dispatch_batches(
            nq, n_total, suffix_ids, suffix_mask, pos_suffix, obj_pos,
            lambda idsb, maskb, posb, objb: ref_suffix_step(
                self.model, obj, kvs, idsb, maskb, posb, pmask_t, objb))

    # -------------------------------------------------------- generation
    def decode_tree(self):
        """The decode-param tree of the generation entry points: the
        quantized tree (built once) under quantize_decode, else None
        (the model's own weights)."""
        if self.quantize_decode and self._decode_params is None:
            from wedetect_tpu_torch.models.quant import quantize_decode_params

            bits = 4 if self.quantize_decode == "int4" else 8
            self._decode_params = quantize_decode_params(self.model,
                                                         bits=bits)
        return self._decode_params

    def _build_gen_prompt(self, image: np.ndarray, prompt: str,
                          pad_token_id: int, p_pad: int = 0):
        """Generation-prompt assembly: the image's patches (or pixels)
        and the chat template's ids, mask and MRoPE positions,
        right-padded to a multiple of 128 (or to p_pad) so the prefill
        tiles for the kernels. Returns (patches, gh, gw, ids (P,),
        mask (P,), pos (3, P), visual_start, w, h)."""
        c = self.cfg
        tok = self.tokenizer
        assert tok is not None, "tokenizer required"
        h, w = image.shape[:2]
        patches, gh, gw = self._prep_patches(image)
        m = c.vision.merge
        n_img = (gh // m) * (gw // m)
        tail = tok.encode(prompt + "<|im_end|>\n<|im_start|>assistant\n",
                          add_special_tokens=False)
        ids = np.concatenate([self.build_prefix(n_img),
                              np.array(tail, np.int32)])
        pos = get_rope_index_single_image(ids, c.image_token_id, gh, gw, m)
        visual_start = int(np.nonzero(ids == c.image_token_id)[0][0])
        p_real = len(ids)
        if not p_pad:
            p_pad = -(-p_real // 128) * 128
        assert p_real <= p_pad, (p_real, p_pad)
        mask = np.zeros(p_pad, np.int32)
        mask[:p_real] = 1
        ids = np.pad(ids, (0, p_pad - p_real), constant_values=pad_token_id)
        pos = np.pad(pos, ((0, 0), (0, p_pad - p_real))).astype(np.int32)
        return patches, gh, gw, ids, mask, pos, visual_start, w, h

    @_scorer_int8
    def calibrate_decode(self, requests, pad_token_id: int = 151643):
        """Fit the int4 decode tree on calibration activations before
        serving (models/quant_calib): `requests` are (image, prompt) pairs
        as in generate_batch; their prefill activations set the
        per-matmul channel statistics that quantize_weight4(act_rms=...)
        weighs its error by. Sets the scorer's decode tree (later
        generate_* calls use it) and returns the calibration tree.
        Requires quantize_decode == "int4" (int8 is plain absmax).
        Validate the result with cli/quant_gate before serving it."""
        assert self.quantize_decode == "int4", \
            "calibration applies to the int4 decode fit only"
        from wedetect_tpu_torch.models.quant import quantize_decode_params
        from wedetect_tpu_torch.models.quant_calib import (
            calibrate_decode_acts)

        batches = []
        for image, prompt in requests:
            patches, gh, gw, ids, mask, pos, visual_start, w, h = \
                self._build_gen_prompt(image, prompt, pad_token_id)
            batches.append(dict(
                grid_h=gh, grid_w=gw, patches=patches,
                input_ids=ids[None], attn_mask=mask[None],
                position_ids=pos[:, None], visual_start=visual_start,
                boxes_xyxy=np.array([[0, 0, w, h]], np.float32),
                ori_wh=np.array([w, h], np.float32)))
        calib = calibrate_decode_acts(self.cfg, self.model, batches)
        self._decode_params = quantize_decode_params(self.model, bits=4,
                                                     calib=calib)
        return calib

    def _decode_text(self, toks, eos_token_id: int, pad_token_id: int):
        keep = []
        for t in toks:
            if t in (eos_token_id, pad_token_id):
                break
            keep.append(int(t))
        tok = self.tokenizer
        return tok.decode(keep) if hasattr(tok, "decode") else keep

    @_scorer_int8
    def generate_text(self, image: np.ndarray, prompt: str,
                      max_new_tokens: int = 64, temperature: float = 0.0,
                      eos_token_id: int = 151645,
                      pad_token_id: int = 151643, seed: int = 0,
                      speculative: bool = False, spec_k: int = 8):
        """Chat or captioning from an image and a user prompt (the twin
        of the reference stage-1/2 class's inherited HF .generate(),
        qwen3vl_grounding.py:311-379): one batched prefill and a
        KV-cache decode (models/ref_generate), greedy or sampled from
        PRNGKey(seed). speculative=True (greedy only) takes the
        prompt-lookup path (models/ref_speculative): the same tokens in
        fewer decode steps where the output replays prompt n-grams.
        Returns the decoded text (the token ids without a decode())."""
        from wedetect_tpu_torch.models.ref_generate import ref_generate
        from wedetect_tpu_torch.ops import prng

        patches, gh, gw, ids, mask, pos, visual_start, w, h = \
            self._build_gen_prompt(image, prompt, pad_token_id)
        args = (self.cfg, gh, gw, self.model, patches, ids[None],
                mask[None], pos[:, None], visual_start,
                np.array([pos.max() + 1], np.int32),
                np.array([[0, 0, w, h]], np.float32),
                np.array([w, h], np.float32), max_new_tokens, eos_token_id)
        if speculative:
            assert temperature == 0.0, "speculative decoding is greedy-only"
            from wedetect_tpu_torch.models.ref_speculative import (
                ref_generate_spec)
            toks, _steps = ref_generate_spec(
                *args, pad_token_id, decode_params=self.decode_tree(),
                spec_k=spec_k)
        else:
            toks = ref_generate(
                *args, temperature, pad_token_id,
                rng=prng.PRNGKey(seed, device=self.model.device),
                decode_params=self.decode_tree())
        return self._decode_text(toks[0].cpu().numpy(), eos_token_id,
                                 pad_token_id)

    def build_video_prompt(self, video, prompt: str, pad_token_id: int,
                           fps: Optional[float] = None,
                           nframes: Optional[int] = None):
        """Video-prompt assembly on the host: fetch_video, then
        video_to_patches, then the chat layout: the user header, the
        vision start, grid_t * mh * mw video tokens, the vision end, the
        prompt and the assistant header, right-padded to a multiple of
        128, with get_rope_index_single_video positions. Returns
        (patches, grid_t, gh, gw, ids (P,), mask (P,), pos (3, P),
        visual_start, w, h)."""
        from wedetect_tpu_torch.data.vision_process import (fetch_video,
                                                            video_to_patches)

        c = self.cfg
        tok = self.tokenizer
        assert tok is not None, "tokenizer required"
        frames, _sample_fps = fetch_video(video, fps=fps, nframes=nframes)
        patches, gt, gh, gw = video_to_patches(
            frames, patch=c.vision.patch,
            temporal_patch=c.vision.temporal_patch, merge=c.vision.merge)
        m = c.vision.merge
        n_vid = gt * (gh // m) * (gw // m)
        pre = tok.encode("<|im_start|>user\n", add_special_tokens=False)
        ve = tok.encode("<|vision_end|>", add_special_tokens=False)
        tail = tok.encode(prompt + "<|im_end|>\n<|im_start|>assistant\n",
                          add_special_tokens=False)
        ids = np.array(pre + [c.vision_start_token_id]
                       + [c.video_token_id] * n_vid + ve + tail, np.int32)
        pos = get_rope_index_single_video(ids, c.video_token_id, gt, gh, gw,
                                          m)
        visual_start = int(np.nonzero(ids == c.video_token_id)[0][0])
        p_real = len(ids)
        p_pad = -(-p_real // 128) * 128
        mask = np.zeros(p_pad, np.int32)
        mask[:p_real] = 1
        ids = np.pad(ids, (0, p_pad - p_real), constant_values=pad_token_id)
        pos = np.pad(pos, ((0, 0), (0, p_pad - p_real))).astype(np.int32)
        h, w = frames.shape[1:3]
        return patches, gt, gh, gw, ids, mask, pos, visual_start, w, h

    @_scorer_int8
    def generate_video_text(self, video, prompt: str,
                            max_new_tokens: int = 64,
                            temperature: float = 0.0,
                            eos_token_id: int = 151645,
                            pad_token_id: int = 151643, seed: int = 0,
                            fps: Optional[float] = None,
                            nframes: Optional[int] = None):
        """Video chat or captioning from a video and a user prompt.
        `video` is any source fetch_video accepts (a file path or
        file:// URI, a frame list, a directory or glob of frames, a GIF,
        an .npy/.npz stack, a (T, H, W, 3) uint8 array); the frames are
        sampled (smart_nframes), temporally patched and fed as one
        contiguous video span (build_video_prompt), the layout that
        train/ref_lm's video SFT trains on. The next position is
        pos.max() + 1: text after the span resumes at
        st + max(grid_t, mh, mw). Decoding as in generate_text (the
        decode tree of quantize_decode; the prefill in int8 under
        quant_prefill). Returns the decoded text (the token ids without
        a decode())."""
        from wedetect_tpu_torch.models.ref_generate import ref_generate
        from wedetect_tpu_torch.ops import prng

        patches, gt, gh, gw, ids, mask, pos, visual_start, w, h = \
            self.build_video_prompt(video, prompt, pad_token_id, fps=fps,
                                    nframes=nframes)
        toks = ref_generate(
            self.cfg, gh, gw, self.model, patches, ids[None], mask[None],
            pos[:, None], visual_start, np.array([pos.max() + 1], np.int32),
            np.array([[0, 0, w, h]], np.float32),
            np.array([w, h], np.float32), max_new_tokens, eos_token_id,
            temperature, pad_token_id,
            rng=prng.PRNGKey(seed, device=self.model.device),
            decode_params=self.decode_tree(), grid_t=gt)
        return self._decode_text(toks[0].cpu().numpy(), eos_token_id,
                                 pad_token_id)

    @_scorer_int8
    def generate_batch(self, requests, max_new_tokens: int = 64,
                       eos_token_id: int = 151645,
                       pad_token_id: int = 151643, slots: int = 8,
                       chunk: int = 16, piggyback: bool = False,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0, seed: int = 0,
                       kv_bits: int = 16):
        """Continuous-batching generation over (image, prompt) requests
        through models/serve.GenServer: requests grouped by image grid
        (one server a group, prompts padded to the group's longest),
        each group a slot pool with mid-run admission and pipelined
        chunked decode. temperature > 0 samples (top_k / top_p warps)
        with per-request streams (request i uses seed + i). Returns the
        decoded texts in input order."""
        from wedetect_tpu_torch.models.serve import GenServer

        prepped = []
        groups = {}
        for i, (image, prompt) in enumerate(requests):
            built = self._build_gen_prompt(image, prompt, pad_token_id)
            prepped.append(built)
            groups.setdefault((built[1], built[2], built[6]), []).append(i)
        texts = [None] * len(requests)
        for (gh, gw, visual_start), idxs in groups.items():
            p_pad = max(int(prepped[i][4].sum()) for i in idxs)
            p_pad = -(-p_pad // 128) * 128
            srv = GenServer(
                self.cfg, gh, gw, self.model, slots=min(slots, len(idxs)),
                prompt_len=p_pad, max_new=max_new_tokens, chunk=chunk,
                eos_id=eos_token_id, pad_id=pad_token_id,
                decode_params=self.decode_tree(), piggyback=piggyback,
                temperature=temperature, top_k=top_k, top_p=top_p,
                kv_bits=kv_bits)
            rid_to_idx = {}
            for i in idxs:
                patches, _, _, ids, mask, pos, _, w, h = prepped[i]
                ids, mask, pos = _fit(ids, mask, pos, p_pad, pad_token_id)
                rid = srv.submit(
                    patches, ids, mask, pos, visual_start,
                    int(pos[:, mask.astype(bool)].max()) + 1,
                    boxes_xyxy=np.array([[0, 0, w, h]], np.float32),
                    ori_wh=np.array([w, h], np.float32), seed=seed + i)
                rid_to_idx[rid] = i
            for rid, toks in srv.run().items():
                texts[rid_to_idx[rid]] = self._decode_text(
                    toks, eos_token_id, pad_token_id)
        return texts


def _fit(ids, mask, pos, p_pad: int, pad_token_id: int):
    """A prompt's ids (P,), mask (P,) and positions (3, P) cut or
    right-padded to p_pad."""
    n = max(0, p_pad - len(ids))
    return (np.pad(ids[:p_pad], (0, n), constant_values=pad_token_id),
            np.pad(mask[:p_pad], (0, n)),
            np.pad(pos[:, :p_pad], ((0, 0), (0, n))))
