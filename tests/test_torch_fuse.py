"""The port's Conv+BN fold and text-head bake (`ckpt/fuse.py`,
`nn/head.bn_fold_scale_bias`) against the JAX package's
(`wedetect_tpu.ckpt.fuse`, `wedetect_tpu.nn.head`) at mini_cfg's widths
(tests/test_detector.py:14).

Weights: the port's seeded init carried to JAX by its converter, with
random BN statistics (running variances
from 0.005 to 1.5, so that each location's eps matters), carried into
the port by `ckpt/convert.from_jax_variables`. Tolerances: the folded
tensors within 1e-6 relative (+1e-7 absolute) of JAX's fold carried
over (torch.rsqrt and XLA's differ in the last bit); the folded model's
f32 forward (scores, logits, boxes, embeddings) within 2e-4 of each
tensor's largest entry of the unfolded one (tests/test_fuse.py's limit,
which it states absolutely at activations of order 1; these reach
1500); the baked weights and biases within 1e-5 relative of JAX's, and
the baked product e @ W^T + c within 2e-4 of the head's contrastive
logits. Each limit has a control that must miss it: the neck's eps in
the head.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_detector import mini_cfg
from wedetect_tpu.ckpt import fuse as jfuse
from wedetect_tpu.ckpt.convert import convert_detector
from wedetect_tpu.nn.head import bn_fold_scale_bias as j_bn_fold
from wedetect_tpu_torch import configs as TC
from wedetect_tpu_torch.ckpt import bake_text_head, fold_conv_bn
from wedetect_tpu_torch.ckpt import fuse as tfuse
from wedetect_tpu_torch.ckpt.convert import from_jax_variables
from wedetect_tpu_torch.models import wedetect as TW
from wedetect_tpu_torch.models.api import Detector, _build_detector
from wedetect_tpu_torch.nn import bn_fold_scale_bias

FOLD_RTOL, FOLD_ATOL = 1e-6, 1e-7
FWD_TOL = 2e-4
BAKE_RTOL = 1e-5


def _tcfg():
    j = mini_cfg()
    return TC.ModelCfg(
        name="mini", depths=j.depths, dims=j.dims, neck_scale=j.neck_scale,
        neck_repeats=j.neck_repeats, head_in_channels=j.head_in_channels,
        embed_dims=j.embed_dims, img_size=j.img_size, text=None,
        num_classes=j.num_classes,
        test=TC.TestCfg(nms_pre=256, max_per_img=16))


@pytest.fixture(scope="module")
def jvars():
    """JAX variables (numpy) with random BN statistics and affines: the
    port's seeded init through JAX's own converter (JAX's eager init
    takes ~50 s)."""
    sd = TW.init_variables(_tcfg(), seed=0, device="cpu").state_dict()
    v = jax.tree.map(np.asarray, convert_detector(
        {k: t.numpy() for k, t in sd.items()}, mini_cfg()))
    rng = np.random.default_rng(3)

    def walk(d, stats):
        for k, x in d.items():
            if isinstance(x, dict):
                walk(x, stats)
            elif stats and k == "mean":
                d[k] = rng.normal(0, 0.5, x.shape).astype(np.float32)
            elif stats and k == "var":
                d[k] = rng.uniform(0.005, 1.5, x.shape).astype(np.float32)
            elif not stats and k in ("scale", "bias") and x.ndim == 1:
                d[k] = (x + rng.normal(0, 0.2, x.shape)).astype(np.float32)
    walk(v["batch_stats"], True)
    walk(v["params"], False)
    return v


def _jax_pairs(tree):
    """The conv+bn pairs JAX's walk folds, counted."""
    if not isinstance(tree, dict):
        return 0
    if "conv" in tree and "bn" in tree:
        return 1
    return sum(_jax_pairs(c) for c in tree.values())


def _close(got, want, tol=FWD_TOL) -> bool:
    """|got - want| within tol of want's largest entry (the random BN
    statistics take activations into the thousands)."""
    return bool((got - want).abs().max() <= tol * want.abs().max())


def _model(sd):
    model = _build_detector(_tcfg(), "cpu")
    model.load_state_dict(sd, strict=True)
    return model


def test_fold_equals_jax(jvars):
    """The port's fold of the carried state equals JAX's fold carried
    over, tensor by tensor; the same pairs (44 here) are folded, and
    every other tensor is unchanged."""
    tcfg = _tcfg()
    sd = from_jax_variables(jvars, tcfg)
    want = from_jax_variables(
        jax.tree.map(np.asarray, jfuse.fold_conv_bn(jvars)), tcfg)
    got = fold_conv_bn(sd)
    pairs = tfuse.conv_bn_pairs(sd)
    assert len(pairs) == _jax_pairs(jvars["params"]) == 44
    assert got.keys() == want.keys() == sd.keys()
    changed = set()
    for conv, bn in pairs:
        changed |= {conv + ".weight", bn + ".weight", bn + ".bias",
                    bn + ".running_mean", bn + ".running_var"}
    for k in got:
        g, w = got[k].float(), want[k].float()
        torch.testing.assert_close(g, w, rtol=FOLD_RTOL, atol=FOLD_ATOL)
        if k not in changed:
            assert torch.equal(got[k], sd[k]), k
    # the contrastive norms have no conv: not folded
    assert all("cls_contrasts" not in bn for _, bn in pairs)
    neck = "neck.reduce_layer0.block.bn."
    torch.testing.assert_close(got[neck + "weight"],
                               torch.ones_like(sd[neck + "weight"]))
    torch.testing.assert_close(got[neck + "running_var"],
                               torch.full_like(sd[neck + "running_var"],
                                               1 - 1e-5))


def test_fold_of_module_and_eps_check(jvars):
    """A module folds as its state dict does, and is left unchanged; a
    BN whose eps is not its location's raises."""
    sd = from_jax_variables(jvars, _tcfg())
    model = _model(sd)
    got = fold_conv_bn(model)
    want = fold_conv_bn(sd)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    model.neck.reduce_layer0.block.bn.eps = 1e-3
    with pytest.raises(ValueError, match="reduce_layer0"):
        fold_conv_bn(model)
    model.neck.reduce_layer0.block.bn.eps = 1e-5
    model.bbox_head.reg_preds[1][4].eps = 1e-5
    with pytest.raises(ValueError, match="reg_preds.1.4"):
        fold_conv_bn(model)


def test_folded_forward_equals_unfolded(jvars):
    """The unchanged modules run the folded state: the f32 forward's
    logits, boxes and embeddings within FWD_TOL of the unfolded one's; a
    fold with the neck's eps in the head misses."""
    sd = from_jax_variables(jvars, _tcfg())
    cfg = _tcfg()
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    w = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))

    def forward(state):
        with torch.inference_mode():
            return TW.forward_raw(cfg, _model(state), imgs, w)

    a, b = forward(sd), forward(fold_conv_bn(sd))
    for field in ("scores", "logits", "boxes", "embeds"):
        assert _close(getattr(b, field), getattr(a, field)), field
    saved = tfuse.HEAD_EPS
    tfuse.HEAD_EPS = tfuse.NECK_EPS
    try:
        c = forward(fold_conv_bn(sd))
    finally:
        tfuse.HEAD_EPS = saved
    assert not _close(c.logits, a.logits)


def test_bake_text_head_equals_jax_and_the_head(jvars):
    """Per level: W and c within BAKE_RTOL of JAX's bake, and e @ W^T + c
    within FWD_TOL of the head's contrastive logits on raw embeddings e;
    the neck's eps in the head misses the latter."""
    sd = from_jax_variables(jvars, _tcfg())
    t = np.random.default_rng(1).standard_normal((5, 32)).astype(np.float32)
    got = bake_text_head(sd, t)
    want = jfuse.bake_text_head(jvars, t)
    assert sorted(got) == [f"cls_contrasts.{i}" for i in range(3)]
    model = _model(sd)
    e = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 4, 4)).astype(np.float32) * 3)
    saved = tfuse.HEAD_EPS
    tfuse.HEAD_EPS = tfuse.NECK_EPS
    try:
        control = bake_text_head(model, t)
    finally:
        tfuse.HEAD_EPS = saved
    for i in range(3):
        g, w = got[f"cls_contrasts.{i}"], want[f"contrast{i}"]
        for k in ("weight", "bias"):
            torch.testing.assert_close(g[k], torch.from_numpy(
                np.array(w[k])), rtol=BAKE_RTOL, atol=BAKE_RTOL)
        with torch.inference_mode():
            logits, _ = model.bbox_head.cls_contrasts[i](
                e, torch.from_numpy(t))
        baked = (torch.einsum("bchw,kc->bkhw", e, g["weight"])
                 + g["bias"][None, :, None, None])
        torch.testing.assert_close(baked, logits, rtol=FWD_TOL, atol=FWD_TOL)
        c = control[f"cls_contrasts.{i}"]
        miss = (torch.einsum("bchw,kc->bkhw", e, c["weight"])
                + c["bias"][None, :, None, None])
        assert not torch.allclose(miss, logits, rtol=FWD_TOL, atol=FWD_TOL)


def test_bn_fold_scale_bias_equals_jax():
    rng = np.random.default_rng(4)
    scale, bias, mean = (rng.standard_normal(64).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.005, 1.5, 64).astype(np.float32)
    for eps in (1e-3, 1e-5):
        k, b = bn_fold_scale_bias(*(torch.from_numpy(x) for x in
                                    (scale, bias, mean, var)), eps=eps)
        jk, jb = j_bn_fold(*(jnp.asarray(x) for x in
                             (scale, bias, mean, var)), eps=eps)
        torch.testing.assert_close(k, torch.from_numpy(np.array(jk)),
                                   rtol=FOLD_RTOL, atol=FOLD_ATOL)
        torch.testing.assert_close(b, torch.from_numpy(np.array(jb)),
                                   rtol=FOLD_RTOL, atol=FOLD_ATOL)
    # the default is the head's eps; the neck's misses
    k3, _ = bn_fold_scale_bias(*(torch.from_numpy(x) for x in
                                 (scale, bias, mean, var)))
    k5, _ = bn_fold_scale_bias(*(torch.from_numpy(x) for x in
                                 (scale, bias, mean, var)), eps=1e-5)
    jk3, _ = j_bn_fold(*(jnp.asarray(x) for x in (scale, bias, mean, var)))
    torch.testing.assert_close(k3, torch.from_numpy(np.array(jk3)),
                               rtol=FOLD_RTOL, atol=FOLD_ATOL)
    assert not torch.allclose(k5, k3, rtol=FOLD_RTOL, atol=FOLD_ATOL)


def test_fold_flips_are_named():
    """chip_smoke.nms_flips, the fold phase's account of the detections
    that one model keeps and the other does not, at mini_cfg on the CPU:
    between the unfolded model and a fold with the neck's eps in the
    head (6 flips here) every flip is a crossed decision (none
    "unexplained"); a kept
    detection dropped by hand is "unexplained", and one whose score is
    put under the threshold is "score_thr"."""
    import dataclasses

    import chip_smoke as C

    cfg = _tcfg()
    cfg = dataclasses.replace(cfg, test=dataclasses.replace(
        cfg.test, score_thr=0.3, max_per_img=64, nms_pre=2000))
    model = TW.init_variables(cfg, seed=0, device="cpu")
    C.perturb_bn(model)
    rng = np.random.default_rng(0)
    w = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((cfg.num_classes, cfg.embed_dims)).astype(
            np.float32)), dim=-1)
    imgs = rng.integers(0, 255, (4, *cfg.img_size, 3)).astype(np.uint8)
    boxed = [(im, np.ones(2, np.float32), np.zeros(4, np.float32),
              tuple(cfg.img_size)) for im in imgs]
    saved = tfuse.HEAD_EPS
    tfuse.HEAD_EPS = tfuse.NECK_EPS
    try:
        control = tfuse.fold_conv_bn(model.state_dict())
    finally:
        tfuse.HEAD_EPS = saved
    folded = _build_detector(cfg, "cpu")
    folded.load_state_dict(control, strict=True)
    calls = []
    for m in (model, folded):
        det = Detector(cfg=cfg, model=m, _text_embeds=w)
        with C.record_nms(calls):
            C.call_on_letterboxed(det, boxed, cfg.test.score_thr)
    flips = C.nms_flips(*calls)
    assert flips and all(f["cause"] != "unexplained" for f in flips)

    scores, boxes, res, kw = calls[0]
    assert int(res.valid[0].sum()) >= 2
    valid = res.valid.clone()
    valid[0, :2] = False
    lowered = scores.clone()
    a, lab = int(res.anchors[0, 1]), int(res.labels[0, 1])
    lowered[0, a, lab] = kw["score_thr"] / 2
    dropped = (lowered, boxes, res._replace(valid=valid), kw)
    flips = C.nms_flips(calls[0], dropped)
    assert sorted((f["kept_by"], f["image"], f["cause"]) for f in flips) == [
        ("x", 0, "score_thr"), ("x", 0, "unexplained")]
