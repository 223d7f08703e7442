"""Class-aware distributed sampler.

Behavioral spec: reference wedetect/datasets/wesampler.py:14-194
(WeSampler): cycle over categories in random order, then over each
category's image list in random order — balances rare classes. Epoch-
seeded for reproducibility; per-process sharding by round-robin. A copy
of `wedetect_tpu.data.sampler`.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


class RandomCycleIter:
    """Endless iterator over a list, reshuffled each pass."""

    def __init__(self, data: Sequence[int], rng: np.random.Generator):
        self.data = list(data)
        self.rng = rng
        self.i = len(self.data)

    def __next__(self) -> int:
        if self.i == len(self.data):
            self.rng.shuffle(self.data)
            self.i = 0
        self.i += 1
        return self.data[self.i - 1]


class ClassAwareSampler:
    """Yields dataset indices, one per class-cycle step.

    cat_to_indices: {category: [dataset indices]} (from
    WeConcatDataset.get_cat_ids semantics — global text ids).
    """

    def __init__(self, cat_to_indices: Dict[int, List[int]],
                 num_samples: int, seed: int = 0, epoch: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.cat_to_indices = {k: v for k, v in cat_to_indices.items()
                               if len(v)}
        self.num_samples = num_samples
        self.seed = seed
        self.epoch = epoch
        self.rank = rank
        self.world = world_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples // self.world

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        cats = sorted(self.cat_to_indices)
        cat_iter = RandomCycleIter(cats, rng)
        img_iters = {c: RandomCycleIter(v, rng)
                     for c, v in self.cat_to_indices.items()}
        out = [next(img_iters[next(cat_iter)])
               for _ in range(self.num_samples)]
        yield from out[self.rank::self.world]
