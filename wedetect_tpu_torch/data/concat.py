"""Dataset composition: concat with global text ids, repeat wrapper.

Behavioral spec: reference wedetect/datasets/weconcat.py:37-184
(WeConcatDataset: concatenate sub-datasets, build a global text ->
text-id index across them so the class-aware sampler can balance over
the union vocabulary; get_cat_ids maps a sample's labels to global
text ids) and werepeat.py:8-17 (RepeatDataset forwarding). A copy of
`wedetect_tpu.data.concat`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class ConcatDetDataset:
    """Concatenate datasets exposing __len__ + sample(idx) -> dict with
    'gt_labels' and 'texts' (per-class synonym lists)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])
        self.init_texts()

    def init_texts(self) -> List[str]:
        texts: List[str] = []
        for ds in self.datasets:
            for syns in getattr(ds, "texts", None) or []:
                texts.extend(syns)
        self.texts = texts
        self.text2textid = {t: i for i, t in enumerate(texts)}
        return texts

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def _locate(self, idx: int):
        d = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.datasets[d], idx - int(self.offsets[d])

    def sample(self, idx: int) -> Dict:
        ds, local = self._locate(idx)
        return ds.sample(local)

    def get_cat_ids(self, idx: int,
                    rng: Optional[np.random.Generator] = None
                    ) -> List[int]:
        """Global text ids of all annotations in a sample (for
        class-aware sampling); unknown texts get a random id, matching
        the reference's fallback."""
        ds, local = self._locate(idx)
        rng = rng or np.random.default_rng(idx)
        texts = getattr(ds, "texts", None) or []
        labels = ds.sample_labels(local) if hasattr(
            ds, "sample_labels") else ds.sample(local)["gt_labels"]
        out = []
        for lab in labels:
            syns = texts[int(lab)] if int(lab) < len(texts) else []
            for t in syns:
                out.append(self.text2textid.get(
                    t, int(rng.integers(len(self.texts)))
                    if self.texts else 0))
        return out

    def cat_to_indices(self) -> Dict[int, List[int]]:
        """{global text id: [dataset indices]} for ClassAwareSampler."""
        table: Dict[int, List[int]] = {}
        for i in range(len(self)):
            for cid in set(self.get_cat_ids(i)):
                table.setdefault(cid, []).append(i)
        return table


class RepeatDataset:
    """N-fold repetition (reference werepeat.py)."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times
        self.texts = getattr(dataset, "texts", None)

    def __len__(self) -> int:
        return len(self.dataset) * self.times

    def sample(self, idx: int) -> Dict:
        return self.dataset.sample(idx % len(self.dataset))
