"""The PyTorch port's detector against the JAX package, on the same
weights (JAX init carried across with from_jax_variables) and the same
seeded inputs, at a miniature config on the CPU.

Tolerances: head outputs atol = rtol = 1e-4 -- both sides compute in
f32, but convolutions and matmuls sum in different orders (XLA vs
oneDNN), which moves the 5th-6th significant digit after ~20 layers.
postprocess fed identical decoded tensors is exact on slots, anchors,
labels and validity. detect_step end to end compares the NMS slots
exactly: the random inputs leave no candidate within 1e-4 of a
threshold or of a neighbour in rank.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import wedetect_tpu.ops.nms as jnms
import wedetect_tpu_torch.ops.nms as tnms
from wedetect_tpu.configs import ModelCfg as JModelCfg
from wedetect_tpu.configs import TestCfg as JTestCfg
from wedetect_tpu.models import wedetect as JW
from wedetect_tpu_torch import configs as TC
from wedetect_tpu_torch.ckpt.convert import from_jax_variables
from wedetect_tpu_torch.models import wedetect as TW
from wedetect_tpu_torch.ops.row_topk import row_topk

ATOL = RTOL = 1e-4


def mini_kw(num_prompts=0, num_classes=4, **kw):
    return dict(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                neck_scale=0.25, neck_repeats=2,
                head_in_channels=(32, 64, 128), embed_dims=32,
                img_size=(64, 64), text=None, num_prompts=num_prompts,
                num_classes=num_classes, **kw)


def cfgs(test_kw=None, **kw):
    """Matching (JAX cfg, port cfg)."""
    test_kw = test_kw or dict(nms_pre=256, max_per_img=16)
    return (JModelCfg(test=JTestCfg(**test_kw), **mini_kw(**kw)),
            TC.ModelCfg(test=TC.TestCfg(**test_kw), **mini_kw(**kw)))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def perturb_stats(variables, seed):
    """Random BN statistics and affine params, so the BN folds are
    exercised (init leaves them at 0/1)."""
    rng = np.random.default_rng(seed)
    v = to_numpy(variables)

    def walk(d, stats):
        for k, x in d.items():
            if isinstance(x, dict):
                walk(x, stats)
            elif stats and k == "mean":
                d[k] = rng.normal(0, 0.1, x.shape).astype(np.float32)
            elif stats and k == "var":
                d[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif not stats and k in ("scale", "bias") and x.ndim == 1:
                d[k] = (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
    walk(v["batch_stats"], True)
    walk(v["params"], False)
    return v


def build(jcfg, tcfg, seed=0):
    jvars = perturb_stats(JW.init_variables(jcfg, seed=seed), seed)
    model = TW.WeDetectModule(tcfg).eval()
    model.load_state_dict(from_jax_variables(jvars, tcfg), strict=True)
    return jax.tree.map(jnp.asarray, jvars), model


def images(b, seed=0, hw=64):
    return np.random.default_rng(seed).integers(
        0, 255, (b, hw, hw, 3), dtype=np.uint8)


@pytest.mark.parametrize("variant", ["text", "uni", "uni_adapter"])
def test_head_outputs_match(variant):
    kw = {"text": {}, "uni": dict(num_prompts=8, num_classes=8),
          "uni_adapter": dict(num_prompts=8, num_classes=8,
                              use_mlp_adapter=True)}[variant]
    jcfg, tcfg = cfgs(**kw)
    jvars, model = build(jcfg, tcfg)
    imgs = images(2, seed=1)
    w = (None if kw else np.random.default_rng(2).standard_normal(
        (4, 32)).astype(np.float32))
    want = JW.forward_raw(jcfg, jvars, jnp.asarray(imgs),
                          None if w is None else jnp.asarray(w))
    got = TW.forward_raw(tcfg, model, imgs, w)
    for f in ("logits", "embeds", "dist_logits", "boxes", "scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   atol=ATOL, rtol=RTOL, err_msg=f)


def test_postprocess_exact_on_jax_decoded():
    jcfg, tcfg = cfgs()
    jvars, _ = build(jcfg, tcfg)
    imgs = images(2, seed=3)
    w = np.random.default_rng(4).standard_normal((4, 32)).astype(np.float32)
    dec = JW.forward_raw(jcfg, jvars, jnp.asarray(imgs), jnp.asarray(w))
    sf = np.array([[0.5, 0.5], [1.0, 1.0]], np.float32)
    pad = np.array([[7, 0, 3, 0], [0, 0, 0, 0]], np.float32)
    ori = np.array([[100, 50], [64, 64]], np.float32)
    want = JW.postprocess(jcfg, dec, jnp.asarray(sf), jnp.asarray(pad),
                          jnp.asarray(ori))
    tdec = TW.DetectorOutputs(*(torch.from_numpy(np.asarray(x))
                                for x in dec))
    got = TW.postprocess(tcfg, tdec, torch.from_numpy(sf),
                         torch.from_numpy(pad), torch.from_numpy(ori))
    for f in TW.Detections._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_detect_step_end_to_end_sparse_branch(monkeypatch):
    """B = 2 at 64x64: B*A = 168 takes a row block, so with the
    threshold crossover patched to 1 both packages route the selection
    through the row top-k (Pallas interpret / the port's plain
    version)."""
    monkeypatch.setattr(jnms, "TOPK_THRESHOLD_MIN_N", 1)
    monkeypatch.setattr(tnms, "TOPK_THRESHOLD_MIN_N", 1)
    # with K = 4 <= 64, T = K and no anchor can exceed T candidates:
    # the density check always picks the sparse branch
    test_kw = dict(nms_pre=256, max_per_img=16, score_thr=0.5)
    jcfg, tcfg = cfgs(test_kw=test_kw)
    jvars, model = build(jcfg, tcfg, seed=5)
    imgs = images(2, seed=6)
    w = np.random.default_rng(7).standard_normal((4, 32)).astype(np.float32)
    sf = np.ones((2, 2), np.float32)
    pad = np.zeros((2, 4), np.float32)
    ori = np.full((2, 2), 64, np.float32)
    dec = TW.forward_raw(tcfg, model, imgs, w)
    counts = (dec.scores > 0.5).sum(-1)
    assert int(counts.max()) > 0

    want = JW.detect_step(jcfg, jvars, jnp.asarray(imgs), jnp.asarray(w),
                          jnp.asarray(sf), jnp.asarray(pad),
                          jnp.asarray(ori))
    got = TW.detect_step(tcfg, model, imgs, w, sf, pad, ori)
    assert int(got.valid.sum()) > 0
    for f in ("valid", "anchors", "labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("boxes", "scores", "embeds"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   atol=ATOL, rtol=RTOL, err_msg=f)


def test_row_topk_runs_plain_on_cpu_in_detect_step(monkeypatch):
    """On CPU tensors the wrapper takes the plain version: no launch."""
    monkeypatch.setattr(tnms, "TOPK_THRESHOLD_MIN_N", 1)
    monkeypatch.setattr(row_topk, "launches", 0)
    _, tcfg = cfgs(test_kw=dict(nms_pre=64, max_per_img=8, score_thr=0.5))
    model = TW.init_variables(tcfg, seed=0, device="cpu")
    det = TW.detect_step(tcfg, model, images(2), np.eye(4, 32, dtype=np.float32),
                         np.ones((2, 2), np.float32),
                         np.zeros((2, 4), np.float32),
                         np.full((2, 2), 64, np.float32))
    assert det.boxes.shape == (2, 8, 4)
    assert row_topk.launches == 0


def test_per_anchor_scale_bias_matches():
    jcfg, tcfg = cfgs()
    jvars, model = build(jcfg, tcfg)
    for a, b in zip(JW.per_anchor_scale_bias(jcfg, jvars),
                    TW.per_anchor_scale_bias(tcfg, model)):
        np.testing.assert_array_equal(a, b)


def test_down_proj_and_seeded_init():
    _, tcfg = cfgs()
    tcfg = dataclasses.replace(tcfg, dims=(32, 64, 128, 512),
                               backbone_down_proj=256)
    m1 = TW.init_variables(tcfg, seed=3, device="cpu")
    m2 = TW.init_variables(tcfg, seed=3, device="cpu")
    assert "down_mlp.weight" in m1.state_dict()
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    out = TW.forward_raw(tcfg, m1, np.zeros((1, 64, 64, 3), np.uint8),
                         np.ones((4, 32), np.float32))
    assert torch.isfinite(out.logits).all()
