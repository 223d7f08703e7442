"""The traffic generator: a seed gives the same calls, another seed
other pixels and another order of the same sizes and query lengths."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.traffic import image_batches

MIXES = sorted((Path(__file__).resolve().parents[1] / "traffic").glob(
    "*.json"))


def small(params):
    return dict(params, calls=min(params["calls"], 4))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_deterministic_per_seed(path):
    params = small(json.loads(path.read_text()))
    a = image_batches.make(params, 7, torch.device("cpu"))
    b = image_batches.make(params, 7, torch.device("cpu"))
    c = image_batches.make(params, 2 ** 31 + 11, torch.device("cpu"))
    assert a.shapes == b.shapes and a.queries == b.queries
    assert all(np.array_equal(x, y) for r, s in zip(a.images, b.images)
               for x, y in zip(r, s))
    assert not all(np.array_equal(x, y) for r, s in zip(a.images, c.images)
                   for x, y in zip(r, s) if x.shape == y.shape)
    # the same work from every seed, in its own order
    flat = lambda t: Counter(s for row in t.shapes for s in row)  # noqa
    assert flat(a) == flat(c)
    for t in (a, c):
        assert len(t.images) == params["calls"]
        assert all(len(r) == params["batch"] for r in t.images)
        for row, shapes in zip(t.images, t.shapes):
            assert [im.shape[:2] for im in row] == list(shapes)
            assert all(im.dtype == np.uint8 for im in row)
            if params.get("one_shape_per_call"):
                assert len(set(shapes)) == 1
    if "query_chars" in params:
        lo, hi = params["query_chars"]
        lens = lambda t: sorted(len(q) for r in t.queries for q in r)  # noqa
        assert lens(a) == lens(c)
        assert min(lens(a)) >= lo and max(lens(a)) <= hi
        assert a.queries != c.queries


def test_counts_sum_and_follow_shares():
    assert image_batches.counts([0.45, 0.2, 0.2, 0.15], 128) == [58, 26, 25,
                                                                  19]
    assert sum(image_batches.counts([1, 1, 1], 10)) == 10
