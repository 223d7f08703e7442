"""The port's selection + NMS against the JAX package on the same
inputs: exact on valid, anchors and labels; boxes and scores equal to
1e-6 (they are gathered copies, so in practice bitwise). Each branch of
the routing is forced in BOTH modules alike: the sparse row top-k
branch, the dense bisection guard, and the plain sort."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import wedetect_tpu.ops.nms as jnms
import wedetect_tpu_torch.ops.nms as tnms


def _case(rng, b, a, k, hi=1.0):
    scores = rng.uniform(0, hi, (b, a, k)).astype(np.float32)
    boxes = rng.uniform(0, 200, (b, a, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(5, 60, (b, a, 2))
    return scores, boxes


def _route(monkeypatch, min_n):
    monkeypatch.setattr(jnms, "TOPK_THRESHOLD_MIN_N", min_n)
    monkeypatch.setattr(tnms, "TOPK_THRESHOLD_MIN_N", min_n)


def _compare(want, got):
    assert int(np.asarray(want.valid).sum()) > 0
    for f in ("valid", "anchors", "labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def _both(scores, boxes, class_mask=None, **kw):
    jm = None if class_mask is None else jnp.asarray(class_mask)
    tm = None if class_mask is None else torch.from_numpy(class_mask)
    want = jnms.batched_static_nms(jnp.asarray(scores), jnp.asarray(boxes),
                                   class_mask=jm, **kw)
    got = tnms.batched_static_nms(torch.from_numpy(scores),
                                  torch.from_numpy(boxes), class_mask=tm,
                                  **kw)
    return want, got


@pytest.mark.parametrize("min_n", [1, 1 << 60], ids=["sparse", "sort"])
def test_batched_nms_branches(monkeypatch, min_n):
    _route(monkeypatch, min_n)
    scores, boxes = _case(np.random.default_rng(1), 2, 240, 16)
    _compare(*_both(scores, boxes, score_thr=0.3, nms_pre=64, iou_thr=0.6,
                    max_out=16))


def test_dense_guard_branch(monkeypatch):
    """One anchor holding > T = 64 candidates trips the density check:
    the bisection path runs in both packages."""
    _route(monkeypatch, 1)
    rng = np.random.default_rng(2)
    scores, boxes = _case(rng, 1, 240, 80, hi=0.4)
    scores[0, 7, :] = rng.uniform(0.9, 1.0, 80)
    _compare(*_both(scores, boxes, score_thr=0.3, nms_pre=128, iou_thr=0.6,
                    max_out=32))


@pytest.mark.parametrize("min_n", [1, 1 << 60], ids=["sparse", "sort"])
def test_class_mask(monkeypatch, min_n):
    _route(monkeypatch, min_n)
    scores, boxes = _case(np.random.default_rng(3), 1, 240, 16)
    mask = np.ones(16, bool)
    mask[10:] = False
    want, got = _both(scores, boxes, class_mask=mask, score_thr=0.3,
                      nms_pre=64, iou_thr=0.6, max_out=16)
    _compare(want, got)
    assert (got.labels[got.valid] < 10).all()


def test_single_label(monkeypatch):
    _route(monkeypatch, 1 << 60)
    scores, boxes = _case(np.random.default_rng(4), 2, 300, 6)
    _compare(*_both(scores, boxes, score_thr=0.2, nms_pre=100, iou_thr=0.5,
                    max_out=40, multi_label=False))


def test_multi_tile_early_exit(monkeypatch):
    """More than one 1024-candidate tile, with slots filling early for
    one image and late for the other."""
    _route(monkeypatch, 1 << 60)
    scores, boxes = _case(np.random.default_rng(5), 2, 900, 4)
    scores[1] *= 0.1
    _compare(*_both(scores, boxes, score_thr=0.05, nms_pre=3000,
                    iou_thr=0.5, max_out=500))


def test_topk_threshold_matches_sort():
    rng = np.random.default_rng(6)
    flat = rng.uniform(0, 1, (2, 5000)).astype(np.float32)
    flat[flat < 0.5] = -np.inf
    want_v, want_i = jnms._topk_threshold(jnp.asarray(flat[0]), 300)
    got_v, got_i = tnms._topk_threshold(torch.from_numpy(flat), 300)
    np.testing.assert_array_equal(got_v[0].numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i[0].numpy(), np.asarray(want_i))
    ref_v, ref_i = torch.sort(torch.from_numpy(flat), dim=1, descending=True,
                              stable=True)
    assert torch.equal(got_v, ref_v[:, :300])
    assert torch.equal(got_i, ref_i[:, :300])


def test_static_nms_single(monkeypatch):
    _route(monkeypatch, 1 << 60)
    scores, boxes = _case(np.random.default_rng(7), 1, 200, 8)
    want = jnms.static_nms_single(jnp.asarray(scores[0]),
                                  jnp.asarray(boxes[0]), 0.3, 200, 0.6, 20)
    got = tnms.static_nms_single(torch.from_numpy(scores[0]),
                                 torch.from_numpy(boxes[0]), 0.3, 200, 0.6,
                                 20)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nms_labeled():
    rng = np.random.default_rng(8)
    b, n = 2, 120
    boxes = rng.uniform(0, 100, (b, n, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(5, 40, (b, n, 2))
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    scores[:, ::9] = scores[:, 1::9]       # tied scores: stable order
    labels = rng.integers(0, 3, (b, n)).astype(np.int32)
    valid = rng.uniform(0, 1, (b, n)) > 0.2
    want = jnms.nms_labeled(*(jnp.asarray(x) for x in
                              (boxes, scores, labels, valid)), 0.5, 30)
    got = tnms.nms_labeled(*(torch.from_numpy(x) for x in
                             (boxes, scores, labels, valid)), 0.5, 30)
    _compare(want, got)


def test_pick_row_block_same_as_jax():
    for rows in (168, 240 * 8, 67200, 7, 8 * 8400 + 8, 1000):
        assert tnms._pick_row_block(rows) == jnms._pick_row_block(rows)
