"""Faults planted in the program under test, to show that the check that
decides `correct` catches them (benchmark/tests/test_bench_reference.py
at a miniature size on the CPU; `benchmark/readings.py --fault` on the
card at a cell's own size). A benchmark run never plants one.

Each is a context manager that patches the port's module for its
block:

- `selection`: the candidate selection before NMS (the sort path and
  the row top-k path, K1 among it) loses the better half of each
  image's candidates, so it hands NMS the wrong ones;
- `nms`: the greedy NMS computes every IoU as 0 and so suppresses
  nothing.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, wrapper):
    saved = getattr(module, name)
    setattr(module, name, wrapper(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def _drop_best_half(fn):
    def run(*a, **kw):
        vals, anchors, labels = fn(*a, **kw)
        n = (vals > float("-inf")).sum(dim=1, keepdim=True)
        col = torch.arange(vals.shape[1], device=vals.device)[None]
        return (torch.where(col < n // 2, float("-inf"), vals), anchors,
                labels)
    return run


@contextlib.contextmanager
def selection():
    from wedetect_tpu_torch.ops import nms

    with _patched(nms, "_select", _drop_best_half), \
            _patched(nms, "_batched_select_topk", _drop_best_half):
        yield


@contextlib.contextmanager
def nms():
    from wedetect_tpu_torch.ops import nms as N

    with _patched(N, "_pairwise_iou_nn",
                  lambda f: lambda a, b: torch.zeros(
                      a.shape[:-1] + b.shape[-2:-1], dtype=torch.float32,
                      device=a.device)):
        yield


FAULTS = {"selection": selection, "nms": nms}
