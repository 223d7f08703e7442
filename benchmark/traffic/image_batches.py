"""Closed-loop batches of seeded uint8 RGB images, and optionally one
referring query an image.

Parameters (the mix's JSON file):

- `batch`: images a call; `calls`: distinct calls made at set-up, which
  the window sends in turn, again from the first after the last;
- `shapes` [[h, w], ...] and `shares`: the mix of image sizes. Every
  seed gets the same number of each size, `round(share * batch *
  calls)`, in an order of its own;
- `one_shape_per_call`: every image of a call has one size (the shares
  then count calls);
- `vocabulary`: the class names a detection call scores (K);
- `query_chars` [lo, hi]: with it, each image carries one query of lo
  to hi characters (one stub token each); every seed gets the same
  lengths, spread evenly over [lo, hi], in an order of its own.

Pixels are uniform noise, drawn on the device from the seed in one
call per size and copied to the host, where the program's entry point
takes its images.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

QUERY_ALPHABET = "abcdefghijklmnopqrstuvwxyz "


def counts(shares, total: int) -> List[int]:
    """Whole counts in proportion to shares, summing to total (largest
    remainders first)."""
    raw = np.asarray(shares, float) / sum(shares) * total
    out = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - out), kind="stable")[:total - out.sum()]:
        out[i] += 1
    return out.tolist()


@dataclass
class Traffic:
    shapes: List[List[tuple]]             # per call, per image (h, w)
    images: List[List[np.ndarray]]        # per call, per image HWC uint8
    queries: Optional[List[List[str]]]    # per call, per image
    vocabulary: int


def make(params: dict, seed: int, device) -> Traffic:
    import torch

    rng = np.random.default_rng(seed)
    b, n = params["batch"], params["calls"]
    shapes = [tuple(s) for s in params["shapes"]]
    if params.get("one_shape_per_call"):
        per_call = np.repeat(np.arange(len(shapes)),
                             counts(params["shares"], n))
        order = rng.permutation(per_call)
        idx = np.repeat(order, b).reshape(n, b)
    else:
        flat = np.repeat(np.arange(len(shapes)),
                         counts(params["shares"], n * b))
        idx = rng.permutation(flat).reshape(n, b)
    g = torch.Generator(device=device).manual_seed(seed)
    pixels = {}
    for k, (h, w) in enumerate(shapes):
        m = int((idx == k).sum())
        if m:
            pixels[k] = iter(torch.randint(
                0, 256, (m, h, w, 3), generator=g, device=device,
                dtype=torch.uint8).cpu().numpy())
    images = [[next(pixels[k]) for k in row] for row in idx]
    queries = None
    if "query_chars" in params:
        lo, hi = params["query_chars"]
        lengths = rng.permutation(
            lo + np.arange(n * b) * (hi - lo + 1) // (n * b))
        chars = rng.integers(0, len(QUERY_ALPHABET), int(lengths.sum()))
        text = "".join(QUERY_ALPHABET[c] for c in chars)
        cuts = np.concatenate([[0], np.cumsum(lengths)])
        qs = ["x" + text[cuts[i] + 1:cuts[i + 1]] for i in range(n * b)]
        queries = [qs[c * b:(c + 1) * b] for c in range(n)]
    return Traffic(shapes=[[shapes[k] for k in row] for row in idx],
                   images=images, queries=queries,
                   vocabulary=params.get("vocabulary", 0))
