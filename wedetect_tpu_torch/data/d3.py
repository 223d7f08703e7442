"""D3 (Described Object Detection / d-cube) pickle-annotation reader.

The reference drives D3 through the external `d-cube` toolkit
(reference wedetect_ref/eval_grounding/eval.py:460-483:
`D3(img_root, pkl_root)` + get_img_ids/load_imgs/get_group_ids/
get_sent_ids/load_sents). This is a dependency-free reader for the
same pickled annotation layout so the d3 benchmark can run without
the toolkit.

Layout (d-cube data/d3_pkl): four pickles holding id-keyed dicts —
  *imgs*.pkl    {id: {id, file_name, ...}}
  *groups*.pkl  {id: {id, img_ids, (inner_)sent_ids, ...}}
  *sents*.pkl   {id: {id, raw_sent, ...}}
  *annos*.pkl   {id: {id, image_id, bbox, sent_ids, ...}}  (optional
                 here: eval uses the COCO-format json for gts)
File names are discovered by substring so minor naming drift between
toolkit versions doesn't break loading. The port's copy of
`wedetect_tpu.data.d3`.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional


def _load_pkl_by_substring(root: str, key: str) -> Optional[Dict]:
    for path in sorted(glob.glob(os.path.join(root, "*.pkl"))):
        name = os.path.basename(path).lower()
        if key in name:
            with open(path, "rb") as f:
                return pickle.load(f)
    return None


class D3:
    """Minimal reader mirroring the d-cube toolkit API surface the
    reference uses."""

    def __init__(self, img_root: str, pkl_root: str):
        self.img_root = img_root
        self.imgs = _load_pkl_by_substring(pkl_root, "img")
        self.groups = _load_pkl_by_substring(pkl_root, "group")
        self.sents = _load_pkl_by_substring(pkl_root, "sent")
        self.annos = _load_pkl_by_substring(pkl_root, "ann")
        if self.imgs is None or self.sents is None:
            raise FileNotFoundError(
                f"no *img*/*sent* pickles under {pkl_root}")
        if self.groups is None:
            self.groups = {}

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs.keys())

    def load_imgs(self, img_ids) -> List[Dict]:
        if isinstance(img_ids, int):
            img_ids = [img_ids]
        return [self.imgs[i] for i in img_ids]

    def get_group_ids(self, img_ids=None) -> List[int]:
        if img_ids is None:
            return sorted(self.groups.keys())
        img_ids = set(img_ids)
        out = []
        for gid in sorted(self.groups.keys()):
            g = self.groups[gid]
            members = g.get("img_ids", g.get("image_ids", []))
            if img_ids & set(members):
                out.append(gid)
        return out

    def get_sent_ids(self, group_ids=None) -> List[int]:
        if group_ids is None:
            return sorted(self.sents.keys())
        out: List[int] = []
        for gid in group_ids:
            g = self.groups[gid]
            sids = g.get("sent_ids", g.get("inner_sent_ids", []))
            out.extend(sids)
        return sorted(set(out))

    def load_sents(self, sent_ids=None) -> List[Dict]:
        if sent_ids is None:
            sent_ids = sorted(self.sents.keys())
        return [self.sents[i] for i in sent_ids]
