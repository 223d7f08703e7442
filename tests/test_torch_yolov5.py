"""The port's YOLOv5 family (`nn/yolov5_head.py`, `ops/yolov5.py`,
`train/yolov5_loss.py`) against the JAX modules at miniature sizes, on
the same seeded inputs: the head on carried-across weights and its bias
init, the decode (and the decode through `ops/nms.batched_static_nms`),
and the loss with its gradient with respect to the predictions against
`jax.grad`, including the empty-gt case and the collision case of
tests/test_yolov5_loss.py (two gts on the same (cell, prior) slots:
scatter-max). A last-write-wins obj target at the collision must miss.

The port's predictions are (B, A, 5+K, H, W); the JAX package's
(B, H, W, A, 5+K).

Tolerances: f32 atol = rtol = 1e-4; gradients atol 1e-4 of the largest
|gradient| of the level and rtol 1e-4.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wedetect_tpu.nn.yolov5_head import YOLOv5HeadModule as JHead
from wedetect_tpu.ops import nms as jnms
from wedetect_tpu.ops import yolov5 as jdec
from wedetect_tpu.train.yolov5_loss import yolov5_loss as j_yolov5_loss
from wedetect_tpu_torch.nn import YOLOv5HeadModule
from wedetect_tpu_torch.ops import nms as tnms
from wedetect_tpu_torch.ops import yolov5 as tdec
from wedetect_tpu_torch.train import V5Losses, yolov5_loss

# the module (the package exports the function under its name)
tloss_mod = importlib.import_module("wedetect_tpu_torch.train.yolov5_loss")

from torch_legacy_util import ATOL, RTOL, jax_apply, nchw, port_from, x_nhwc

IMG = 128
SIDES = (16, 8, 4)          # IMG / strides 8, 16, 32
A = 3


def _to_port(p):
    """(B, H, W, A, C) -> (B, A, C, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(p).transpose(0, 3, 4, 1, 2)))


def _preds(b, k, seed, scale=1.5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, s, s, A, 5 + k)) * scale).astype(
        np.float32) for s in SIDES]


def _gts(b, g, k, seed, n_masked=1):
    rng = np.random.default_rng(seed)
    wh = rng.uniform(6, 90, (b, g, 2))
    c = rng.uniform(0, IMG, (b, g, 2))
    boxes = np.concatenate([np.clip(c - wh / 2, 0, IMG),
                            np.clip(c + wh / 2, 0, IMG)], -1)
    labels = rng.integers(0, k, (b, g))
    mask = np.ones((b, g), bool)
    mask[:, g - n_masked:] = False
    return boxes.astype(np.float32), labels.astype(np.int32), mask


def test_head_matches_jax():
    k = 7
    feats = [x_nhwc((2, s, s, c), i)
             for i, (s, c) in enumerate(zip(SIDES, (16, 32, 64)))]
    jm = JHead(num_classes=k, in_channels=(16, 32, 64))
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         [jnp.asarray(f) for f in feats]))
    # perturb the bias init so that the carried-across bias is checked
    rng = np.random.default_rng(1)
    v = {"params": {n: {"kernel": p["kernel"],
                        "bias": p["bias"] + rng.normal(0, 0.1, p["bias"].shape)
                        .astype(np.float32)}
                    for n, p in v["params"].items()}}
    tm = port_from("yolov5_head", v, YOLOv5HeadModule(k, (16, 32, 64)))
    assert sorted(tm.state_dict()) == [f"convs_pred.{i}.{w}" for i in range(3)
                                       for w in ("bias", "weight")]
    want = jax_apply(jm, v, feats)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    for gt, w in zip(got, want):
        assert gt.shape == (2, A, 5 + k) + tuple(gt.shape[-2:])
        np.testing.assert_allclose(gt.permute(0, 3, 4, 1, 2).numpy(),
                                   np.asarray(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k", [1, 7, 80])
def test_head_bias_init_matches_jax(k):
    jm = JHead(num_classes=k, in_channels=(16, 32, 64))
    feats = [jnp.zeros((1, s, s, c)) for s, c in zip(SIDES, (16, 32, 64))]
    jb = jm.init(jax.random.PRNGKey(0), feats)["params"]
    tm = YOLOv5HeadModule(k, (16, 32, 64))
    for i in range(3):
        np.testing.assert_allclose(tm.convs_pred[i].bias.detach().numpy(),
                                   np.asarray(jb[f"convs_pred_{i}"]["bias"]),
                                   rtol=1e-6, atol=1e-6)
    obj = tm.convs_pred[0].bias.detach().view(A, 5 + k)[:, 4]
    np.testing.assert_allclose(obj.numpy(), math.log(8 / 80 ** 2), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 4])
def test_decode_matches_jax(k):
    preds = _preds(2, k, 3)
    jb, js = jax.jit(jdec.yolov5_decode)([jnp.asarray(p) for p in preds])
    tb, ts = tdec.yolov5_decode([_to_port(p) for p in preds])
    n = A * sum(s * s for s in SIDES)
    assert tb.shape == (2, n, 4) and ts.shape == (2, n, k)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL,
                               rtol=RTOL)


def test_decode_through_nms_matches_jax():
    """yolov5_decode -> batched_static_nms, both packages, on the same
    decode output (the port's): the same kept slots."""
    preds = _preds(2, 4, 5, scale=2.5)
    tb, ts = tdec.yolov5_decode([_to_port(p) for p in preds])
    got = tnms.batched_static_nms(ts, tb, 0.05, 1000, 0.6, 50)
    want = jax.jit(lambda s, b: jnms.batched_static_nms(s, b, 0.05, 1000, 0.6,
                                                        50))(
        jnp.asarray(ts.numpy()), jnp.asarray(tb.numpy()))
    assert int(got.valid.sum()) > 10
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    for name in ("labels", "anchors"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[v],
                                      np.asarray(getattr(want, name))[v])
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, name).numpy()[v],
                                   np.asarray(getattr(want, name))[v],
                                   atol=ATOL, rtol=RTOL)


def _jax_loss(preds, boxes, labels, mask, img=(IMG, IMG), **kw):
    def f(ps):
        return j_yolov5_loss(ps, jnp.asarray(boxes), jnp.asarray(labels),
                             jnp.asarray(mask), img, **kw)
    ps = [jnp.asarray(p) for p in preds]
    out, grads = jax.jit(lambda ps: (f(ps), jax.grad(
        lambda q: f(q).total)(ps)))(ps)
    return out, [np.asarray(g) for g in grads]


def _port_loss(preds, boxes, labels, mask, img=(IMG, IMG), **kw):
    ps = [_to_port(p).requires_grad_(True) for p in preds]
    out = yolov5_loss(ps, torch.from_numpy(boxes), torch.from_numpy(labels),
                      torch.from_numpy(mask), img, **kw)
    out.total.backward()
    out = V5Losses(*(t.detach() for t in out))
    return out, [p.grad.permute(0, 3, 4, 1, 2).numpy() for p in ps]


def _check(got, want, gg, wg):
    assert isinstance(got, V5Losses)
    for name in V5Losses._fields:
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    for g, w in zip(gg, wg):
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g, w, atol=ATOL * scale, rtol=RTOL)


@pytest.mark.parametrize("k,g,seed", [(3, 6, 0), (3, 12, 1), (1, 5, 2),
                                      (5, 8, 3)])
def test_loss_and_grad_match_jax(k, g, seed):
    preds = _preds(2, k, 10 + seed)
    boxes, labels, mask = _gts(2, g, k, 20 + seed)
    got, gg = _port_loss(preds, boxes, labels, mask, loss_scale=2.0)
    want, wg = _jax_loss(preds, boxes, labels, mask, loss_scale=2.0)
    assert float(want.num_pos) > 0
    if k == 1:
        assert float(got.cls) == 0.0
    _check(got, want, gg, wg)


def test_loss_empty_gt_matches_jax():
    preds = _preds(2, 4, 30)
    boxes = np.zeros((2, 4, 4), np.float32)
    labels = np.zeros((2, 4), np.int32)
    mask = np.zeros((2, 4), bool)
    got, gg = _port_loss(preds, boxes, labels, mask, loss_scale=2.0)
    want, wg = _jax_loss(preds, boxes, labels, mask, loss_scale=2.0)
    assert float(got.cls) == 0.0 and float(got.bbox) == 0.0
    assert float(got.num_pos) == 0
    _check(got, want, gg, wg)


# the collision case of tests/test_yolov5_loss.py:308: two gts centred
# on one cell at every level, preds decoding to gt1's box, so gt1's CIoU
# dominates every colliding slot (class logits random here, 0 there)
ANCHORS = jdec.DEFAULT_ANCHORS


def _collision():
    b, k, img = 1, 3, 640
    sizes, strides = (80, 40, 20), (8, 16, 32)
    center, g1_wh, g2_wh = 321.0, 64.0, 150.0

    def box(wh):
        return [center - wh / 2, center - wh / 2, center + wh / 2,
                center + wh / 2]

    boxes = np.asarray([[box(g1_wh), box(g2_wh)]], np.float32)
    labels = np.asarray([[1, 2]], np.int32)
    mask = np.ones((1, 2), bool)
    rng = np.random.default_rng(7)
    preds = []
    for lvl, s in enumerate(sizes):
        p = np.zeros((b, s, s, A, 5 + k), np.float32)
        p[..., 4] = -5.0
        # class logits off 0, where the written-out BCE's max and |.|
        # have their kinks (see test_bce_gradient_at_zero_logit)
        p[..., 5:] = rng.standard_normal(p[..., 5:].shape)
        for ai in range(A):
            for ch, prior in ((2, ANCHORS[lvl][ai][0]),
                              (3, ANCHORS[lvl][ai][1])):
                q = math.sqrt(g1_wh / prior) / 2
                p[..., ai, ch] = math.log(q / (1 - q)) if 0 < q < 1 else 10.0
        preds.append(p)
    del strides
    return preds, boxes, labels, mask, (img, img)


def test_loss_collision_scatter_max_matches_jax():
    preds, boxes, labels, mask, img = _collision()
    got, gg = _port_loss(preds, boxes, labels, mask, img)
    want, wg = _jax_loss(preds, boxes, labels, mask, img)
    _check(got, want, gg, wg)


def _last_write_target(lin, iou_t, valid, size):
    """Control: the torch reference's assignment, the last valid
    candidate written to a slot wins."""
    tgt = torch.zeros(lin.shape[0], size, dtype=iou_t.dtype)
    for bi in range(lin.shape[0]):
        for n in range(lin.shape[1]):
            if valid[bi, n]:
                tgt[bi, lin[bi, n]] = iou_t[bi, n]
    return tgt


def test_loss_collision_last_write_control_misses(monkeypatch):
    preds, boxes, labels, mask, img = _collision()
    want, _ = _jax_loss(preds, boxes, labels, mask, img)
    monkeypatch.setattr(tloss_mod, "_obj_target", _last_write_target)
    got, _ = _port_loss(preds, boxes, labels, mask, img)
    # the box and cls terms do not see the target
    np.testing.assert_allclose(float(got.bbox), float(want.bbox), atol=ATOL,
                               rtol=RTOL)
    delta = abs(float(got.obj) - float(want.obj))
    assert delta > 10 * (ATOL + RTOL * abs(float(want.obj))), delta


def test_bce_gradient_at_zero_logit():
    """A stated difference: at a logit of exactly 0 the written-out BCE
    max(x, 0) - x t + log1p(exp(-|x|)) sits on the kinks of max and |.|,
    where autograd takes 1 - t (torch's clamp passes the gradient at the
    bound) and jax.grad -t; the derivative is 0.5 - t. Off 0 they agree."""
    from wedetect_tpu.train.losses import bce_with_logits as jbce
    from wedetect_tpu_torch.train.losses import bce_with_logits as tbce

    for x, t in ((0.0, 0.0), (0.0, 1.0), (0.0, 0.25), (1e-3, 0.25),
                 (-2.0, 1.0)):
        xt = torch.tensor(x, requires_grad=True)
        tbce(xt, torch.tensor(t)).backward()
        jg = float(jax.grad(lambda v: jbce(v, jnp.float32(t)))(
            jnp.float32(x)))
        if x == 0.0:
            assert float(xt.grad) == 1.0 - t and jg == -t
        else:
            np.testing.assert_allclose(float(xt.grad), jg, rtol=1e-6)
