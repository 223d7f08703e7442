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

`device` defaults to "cuda" and raises without a card. The model's
matmul weights are cast to `dtype` once, at construction. Not ported
yet: `score_multi_images`, `score_rec`, generation, the calibrated and
quantized decode, and int8 prefill.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from wedetect_tpu_torch import resolve_device
from wedetect_tpu_torch.models.ref import (RefModules, cast_ref_model,
                                           ref_prefix_step, ref_score_step,
                                           ref_suffix_step)
from wedetect_tpu_torch.nn.qwen3vl import RefCfg, get_rope_index_single_image
from wedetect_tpu_torch.ops.attention import is_flash_tileable

QUERY_TEMPLATE = 'Please detect the "%s" in the image'


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

    def __post_init__(self):
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {self.dtype!r}: float32 or bfloat16")
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
        out = self.logits(image, proposals, queries, pad_token_id)
        return 1.0 / (1.0 + np.exp(-out))

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
