"""Chat-JSON SFT datasets for WeDetect-Ref training.

Port of `wedetect_tpu/data/sft_chat.py` (reference wedetect_ref/sft.py:
100-291, LazySupervisedDataset: a JSON list of {image, conversations
[{from: human/gpt, value}]}, '<image>\\n' stripped from the human turn,
the Qwen chat template, labels masking everything but assistant turns;
and sft_referring.py:219-331 for stage 3). Sequences are built with an
injected tokenizer; a sample that fails to load is replaced by a random
one (the reference's retry loop).

Images are read by `image_reader(path) -> HWC uint8 RGB`, by default
`data/loader.load_image_rgb` (cv2); pass another reader where cv2 is
missing or the images are in memory. A video sample's "video" entry is
a list of frame paths (each through `image_reader`) or one video file
(`data/vision_process.read_video_cv2`); its frames go through
`video_to_patches`, a "<video>" tag emits one contiguous span of
grid_t * mh * mw video tokens, and the sample carries its `grid_t`.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from wedetect_tpu_torch.train.ref_lm import IGNORE_INDEX

ImageReader = Callable[[str], np.ndarray]


def _default_reader(path: str) -> np.ndarray:
    from wedetect_tpu_torch.data.loader import load_image_rgb

    return load_image_rgb(path)


def _retrying(get, n: int, max_retry: int, rng: np.random.Generator,
              idx: int) -> Dict:
    """get(idx), replacing a failing index by a random one up to
    max_retry times."""
    for _ in range(max_retry + 1):
        try:
            return get(idx)
        except Exception:
            idx = int(rng.integers(n))
    raise ValueError("too many bad samples")


class ChatSftDataset:
    def __init__(self, data_path: str, tokenizer,
                 image_token_id: int, vision_start_token_id: int,
                 object_token_id: Optional[int] = None,
                 video_token_id: Optional[int] = None,
                 max_len: int = 5120, max_retry: int = 5,
                 patch: int = 16, merge: int = 2, seed: int = 0,
                 image_reader: Optional[ImageReader] = None):
        with open(data_path) as f:
            self.data = json.load(f)
        self.tok = tokenizer
        self.image_token_id = image_token_id
        self.vision_start_token_id = vision_start_token_id
        self.object_token_id = object_token_id
        self.video_token_id = video_token_id
        self.max_len = max_len
        self.max_retry = max_retry
        self.patch = patch
        self.merge = merge
        self.rng = np.random.default_rng(seed)
        self.image_reader = image_reader or _default_reader

    def __len__(self) -> int:
        return len(self.data)

    def _enc(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def build(self, conversations: Sequence[Dict], n_img: int
              ) -> Tuple[np.ndarray, np.ndarray, int]:
        """-> (input_ids, labels, visual_start). Assistant turns
        supervise; user/image tokens are IGNORE_INDEX. A "<video>" tag
        emits one contiguous video-token span instead (n_img is then the
        token count over every temporal group)."""
        ids: List[int] = []
        spans: List[Tuple[int, int]] = []
        visual_start = -1
        for conv in conversations:
            role = conv.get("from", conv.get("role"))
            text = conv["value"] if "value" in conv else conv["content"]
            has_image = "<image>" in text
            has_video = "<video>" in text
            text = text.replace("<image>\n", "").replace("<image>", "")
            text = text.replace("<video>\n", "").replace("<video>", "")
            if role in ("human", "user"):
                ids += self._enc("<|im_start|>user\n")
                if has_image or has_video:
                    tok_id = (self.video_token_id if has_video
                              else self.image_token_id)
                    assert tok_id is not None
                    ids.append(self.vision_start_token_id)
                    visual_start = len(ids)
                    ids += [tok_id] * n_img
                    ids += self._enc("<|vision_end|>")
                ids += self._enc(text)
                ids += self._enc("<|im_end|>\n")
            else:
                ids += self._enc("<|im_start|>assistant\n")
                st = len(ids)
                ids += self._enc(text)
                en = len(ids)
                ids += self._enc("<|im_end|>\n")
                spans.append((st, en + 1))  # supervise through im_end
        arr = np.asarray(ids, np.int32)
        if len(arr) > self.max_len:
            raise ValueError("input too long")
        labels = np.full_like(arr, IGNORE_INDEX)
        for st, en in spans:
            labels[st:min(en, len(arr))] = arr[st:min(en, len(arr))]
        labels[arr == self.image_token_id] = IGNORE_INDEX
        return arr, labels, visual_start

    def sample(self, idx: int) -> Dict:
        return _retrying(self._get, len(self), self.max_retry, self.rng, idx)

    def _get(self, idx: int) -> Dict:
        from wedetect_tpu_torch.data.vision_process import (image_to_patches,
                                                            read_video_cv2,
                                                            video_to_patches)

        src = self.data[idx]
        grid_t = 1
        if "video" in src:
            # a list of frame image paths, or one decodable video file
            vid = src["video"]
            if isinstance(vid, str):
                frames, _ = read_video_cv2(vid)
            else:
                frames = np.stack([self.image_reader(p) for p in vid])
            patches, grid_t, gh, gw = video_to_patches(
                frames, patch=self.patch, merge=self.merge)
            img = frames[0]
        else:
            img = self.image_reader(src["image"])
            patches, gh, gw = image_to_patches(img, patch=self.patch,
                                               merge=self.merge)
        n_img = grid_t * (gh // self.merge) * (gw // self.merge)
        ids, labels, visual_start = self.build(src["conversations"], n_img)
        out = {"input_ids": ids, "labels": labels,
               "visual_start": visual_start, "patches": patches,
               "grid": (gh, gw), "grid_t": grid_t, "image": img}
        # region-caption samples carry <object> turns + boxes
        # (reference sft.py stage-2 data)
        if self.object_token_id is not None:
            pos = np.nonzero(ids == self.object_token_id)[0]
            out["object_positions"] = pos.astype(np.int32)
            out["boxes"] = np.asarray(src.get("bounding_boxes", []),
                                      np.float32).reshape(-1, 4)
            out["ori_wh"] = np.array([img.shape[1], img.shape[0]],
                                     np.float32)
        return out


class ReferringSftDataset:
    """Stage-3 dataset: proposals + soft IoU labels + <object> chat.

    Reference wedetect_ref/sft_referring.py:219-331: proposals from a
    per-image json, gt boxes with no IoU > 0.5 proposal appended and the
    set shuffled, label = max IoU vs gts where > 0.5; the conversation
    'Please detect the "<class>" in the image' (caption variant when
    present) + assistant "<object>" * N; optional multiscale resize
    (random min/max pixel budget, :303-309); retry on error.
    """

    def __init__(self, data_path: str, proposals_path: str, tokenizer,
                 image_token_id: int, vision_start_token_id: int,
                 object_token_id: int, max_proposals: int = 100,
                 multiscale: bool = False, max_retry: int = 5,
                 grid_buckets=None, patch: int = 16, merge: int = 2,
                 seed: int = 0, image_reader: Optional[ImageReader] = None):
        with open(data_path) as f:
            self.data = json.load(f)
        with open(proposals_path) as f:
            self.proposals = json.load(f)
        self.tok = tokenizer
        self.image_token_id = image_token_id
        self.vision_start_token_id = vision_start_token_id
        self.object_token_id = object_token_id
        self.max_proposals = max_proposals
        self.multiscale = multiscale
        self.max_retry = max_retry
        self.grid_buckets = grid_buckets
        self.patch = patch
        self.merge = merge
        self.rng = np.random.default_rng(seed)
        self.image_reader = image_reader or _default_reader

    def __len__(self) -> int:
        return len(self.data)

    def sample(self, idx: int) -> Dict:
        return _retrying(self._get, len(self), self.max_retry, self.rng, idx)

    def _get(self, idx: int) -> Dict:
        from wedetect_tpu_torch.data.vision_process import image_to_patches
        from wedetect_tpu_torch.train.ref_sft import build_soft_labels

        src = self.data[idx]
        img = self.image_reader(src["image"])
        h, w = img.shape[:2]
        props = np.asarray(self.proposals[src["image"]],
                           np.float32).reshape(-1, 4)
        gts = np.asarray(src.get("bounding_boxes", []),
                         np.float32).reshape(-1, 4)
        props, soft = build_soft_labels(gts, props, self.rng)
        props, soft = props[:self.max_proposals], soft[:self.max_proposals]

        if self.multiscale:
            size = self.rng.uniform(0.5, 1.2)
            min_px = int(900 * size) * 32 ** 2
            max_px = int(1600 * size) * 32 ** 2
        else:
            min_px = max_px = None
        patches, gh, gw = image_to_patches(
            img, patch=self.patch, merge=self.merge, min_pixels=min_px,
            max_pixels=max_px, grid_buckets=self.grid_buckets)
        n_img = (gh // self.merge) * (gw // self.merge)

        if "caption" in src:
            query = ('Please detect the "%s" described in the caption'
                     ' "%s" in the image'
                     % (src["class_name"], src["caption"]))
        else:
            query = ('Please detect the "%s" in the image'
                     % src["class_name"])
        enc = lambda t: self.tok.encode(t, add_special_tokens=False)  # noqa: E731
        ids: List[int] = enc("<|im_start|>user\n")
        ids.append(self.vision_start_token_id)
        visual_start = len(ids)
        ids += [self.image_token_id] * n_img
        ids += enc("<|vision_end|>") + enc(query)
        ids += enc("<|im_end|>\n<|im_start|>assistant\n")
        obj_start = len(ids)
        ids += [self.object_token_id] * len(props)
        ids += enc("<|im_end|>\n")
        arr = np.asarray(ids, np.int32)
        obj_pos = np.arange(obj_start, obj_start + len(props),
                            dtype=np.int32)
        return {"input_ids": arr, "visual_start": visual_start,
                "patches": patches, "grid": (gh, gw),
                "boxes": props, "soft_labels": soft,
                "object_positions": obj_pos,
                "ori_wh": np.array([w, h], np.float32)}
