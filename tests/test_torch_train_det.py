"""The port's detector training (`ops/boxes.py`'s IoU family,
`train/assigner.py`, `train/losses.py`, train-mode BN and drop path,
`train/train_step.py`, `train/loop.py`, `ckpt/convert.jax_param_paths`)
against the JAX package on the same weights (JAX init carried across
with from_jax_variables), data and seeds, on the CPU at `mini_cfg`
(tests/test_detector.py:14).

Tolerances:
- boxes, IoU family and losses: values to 1e-6 (f32 elementwise); IoU
  gradients to 1e-5 relative + 1e-6. The CIoU `alpha` is detached in
  both (`stop_gradient` in JAX): the gradients equal jax.grad's and fail
  torch's finite-difference gradcheck, which IoU and GIoU pass.
- assigner: labels, fg_mask and gt_idx bitwise, bboxes and scores to
  1e-6, ties among equal metrics included.
- BN running statistics after one train-mode forward: 1e-6 (measured
  5.4e-7). Control: torch's own update (the unbiased variance) misses.
- loss_fn and train_step: the loss and its parts to 1e-5 relative; each
  gradient tensor within 1e-4 of its largest entry, or within one f32
  ulp (2^-23) of the model's largest gradient entry; grad_norm, which
  carries the gradients' error, to 1e-4 relative (measured 1.0e-5 with
  one CPU thread). Measured 3.5e-5:
  the port's own gradients move 3.9e-5 when the input images move by
  2e-7 relative, since train-mode BN over 2 x 2 maps (n = 8 values a
  channel at P5) amplifies rounding; tensors whose gradient is zero in
  exact arithmetic (a bias ahead of a train-mode BN) hold only that
  rounding noise. Parameters after two steps: each entry within
  2 * steps * lr (Adam divides a near-zero gradient by its own size, so
  a sign that differs in the last bits moves it by lr either way), and
  within 1e-5 relative + 1e-6 on all but 0.1% of the entries, counted
  over the model (tests/test_torch_train_ref.py counts per tensor: the
  detector's bias tensors of 32-256 entries each hold a near-zero
  gradient entry or none) and leaving out the noise tensors above. BN
  running statistics after the steps: 1e-6 + 0.1 * 2 * steps * lr
  (measured 2.5e-5): a noise bias that differs by up to 2 * steps * lr
  shifts by about that much the batch mean that the BN it feeds
  records with momentum 0.1 (0.03 in the head).
- the loop: logged losses and num_pos as the train steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wedetect_tpu.configs import ModelCfg as JModelCfg
from wedetect_tpu.configs import TestCfg as JTestCfg
from wedetect_tpu.models.wedetect import WeDetectModule as JModule
from wedetect_tpu.ops import boxes as JB
from wedetect_tpu.train import assigner as JA
from wedetect_tpu.train import loop as JL
from wedetect_tpu.train import losses as JLS
from wedetect_tpu.train import optimizer as JO
from wedetect_tpu.train.train_step import Batch as JBatch
from wedetect_tpu.train.train_step import TrainState as JState
from wedetect_tpu.train.train_step import loss_fn as j_loss_fn
from wedetect_tpu.train.train_step import train_step as j_train_step
from wedetect_tpu_torch import configs as TC
from wedetect_tpu_torch.ckpt import io as CIO
from wedetect_tpu_torch.ckpt.convert import (from_jax_variables,
                                             jax_param_paths)
from wedetect_tpu_torch.models import wedetect as TW
from wedetect_tpu_torch.nn import convnext as TCX
from wedetect_tpu_torch.nn import layers as TLY
from wedetect_tpu_torch.ops import boxes as TB
from wedetect_tpu_torch.train import assigner as TA
from wedetect_tpu_torch.train import loop as TL
from wedetect_tpu_torch.train import losses as TLS
from wedetect_tpu_torch.train import train_step as TS

LR = 1e-4
G = 128                      # cfg.train.max_gt_per_image, the loop's pad


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the models here are small, and with several
    test workers on the host torch's default thread team only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mini_kw(**kw):
    base = dict(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                neck_scale=0.25, neck_repeats=2,
                head_in_channels=(32, 64, 128), embed_dims=32,
                img_size=(64, 64), text=None, num_classes=4)
    base.update(kw)
    return base


def cfgs(**kw):
    t = dict(nms_pre=256, max_per_img=16)
    return (JModelCfg(test=JTestCfg(**t), **mini_kw(**kw)),
            TC.ModelCfg(test=TC.TestCfg(**t), **mini_kw(**kw)))


def jax_variables(jcfg, seed=0):
    """The JAX detector's init, jitted (eager init takes ~40 s)."""
    module = JModule(jcfg)
    h, w = jcfg.img_size
    args = (jnp.zeros((1, h, w, 3)),)
    if not jcfg.num_prompts:
        args += (jnp.zeros((jcfg.num_classes, jcfg.embed_dims)),)
    init = jax.jit(lambda key: module.init(key, *args))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def port_model(jvars, tcfg):
    model = TW.WeDetectModule(tcfg).eval()
    model.load_state_dict(from_jax_variables(jvars, tcfg), strict=True)
    return model


def make_batch(seed=0, b=2, k=4, c=32, empty_row=False):
    """Seeded images, per-row text banks and padded gts: a large, a
    medium and a small gt (fewer than 10 anchor centres) in row 0."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (b, 64, 64, 3), dtype=np.uint8)
    texts = rng.standard_normal((b, k, c)).astype(np.float32)
    gtb = np.zeros((b, G, 4), np.float32)
    gtl = np.zeros((b, G), np.int32)
    gtm = np.zeros((b, G), bool)
    gtb[0, :3] = [[4, 4, 30, 40], [20, 10, 60, 50], [40, 40, 47, 46]]
    gtl[0, :3] = [1, 3, 2]
    gtm[0, :3] = True
    if not empty_row:
        gtb[1, :1] = [[10, 10, 20, 18]]
        gtm[1, :1] = True
    return images, texts, gtb, gtl, gtm


def jbatch(arrays):
    return JBatch(*[jnp.asarray(x) for x in arrays])


def jgrads_as_port(jgrads, jstats, tcfg):
    return from_jax_variables({"params": jax.tree.map(np.asarray, jgrads),
                               "batch_stats": jax.tree.map(np.asarray,
                                                           jstats)}, tcfg)


def assert_grads_close(model, want):
    """Each gradient within 1e-4 of its tensor's largest entry, or within
    one f32 ulp of the model's largest entry; returns the names of the
    tensors held only to the latter (rounding noise: their exact
    gradient is zero)."""
    names = [n for n, _ in model.named_parameters()]
    top = max(float(want[n].abs().max()) for n in names)
    noise = set()
    for n, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        w = want[n]
        err = float((g - w).abs().max())
        if err > 1e-4 * float(w.abs().max()):
            assert err <= 2.0 ** -23 * top, (n, err, float(w.abs().max()))
            noise.add(n)
    return noise


def assert_stats_close(model, want, atol=1e-6):
    bad = []
    for n, t in model.state_dict().items():
        if n.endswith(("running_mean", "running_var")):
            if not torch.allclose(t, want[n], atol=atol, rtol=1e-6):
                bad.append(n)
    assert not bad, bad


# ------------------------------------------------------------------ boxes
def _boxes(n, seed, scale=50.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(0.5, scale / 2, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_bbox2distance_and_pairwise_iou_match_jax():
    pts = np.random.default_rng(0).uniform(0, 60, (40, 2)).astype(
        np.float32)
    bx = _boxes(40, 1)
    want = JB.bbox2distance(jnp.asarray(pts), jnp.asarray(bx), max_dis=15)
    got = TB.bbox2distance(torch.from_numpy(pts), torch.from_numpy(bx),
                           max_dis=15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    a, b = _boxes(7, 2), _boxes(5, 3)
    a[0, 2:] = a[0, :2] - 1          # an inverted box: area clipped to 0
    want = JB.pairwise_iou(jnp.asarray(a), jnp.asarray(b))
    got = TB.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("mode", ["iou", "ciou", "giou", "siou"])
def test_bbox_overlaps_aligned_matches_jax(mode):
    """Values, broadcasting (B, 1, A) x (B, G, 1) and the gradients of a
    weighted sum w.r.t. both box sets, against jax.grad."""
    a = _boxes(24, 4).reshape(2, 1, 12, 4)
    b = _boxes(6, 5).reshape(2, 3, 1, 4)
    wgt = np.random.default_rng(6).uniform(0.5, 1.5, (2, 3, 12)).astype(
        np.float32)

    def jf(x, y):
        return (JB.bbox_overlaps_aligned(x, y, iou_mode=mode) * wgt).sum()

    want = JB.bbox_overlaps_aligned(jnp.asarray(a), jnp.asarray(b),
                                    iou_mode=mode)
    jga, jgb = jax.grad(jf, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = TB.bbox_overlaps_aligned(ta, tb, iou_mode=mode)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    (got * torch.from_numpy(wgt)).sum().backward()
    for g, w in ((ta.grad, jga), (tb.grad, jgb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["iou", "giou", "ciou"])
def test_ciou_alpha_is_detached(mode):
    """In f64, IoU and GIoU have the gradient of their values; CIoU does
    not: its alpha is a constant to the gradient (the gradients equal
    jax.grad's, test above)."""
    a = torch.from_numpy(_boxes(6, 7).astype(np.float64)).requires_grad_()
    b = torch.from_numpy(_boxes(6, 8).astype(np.float64))
    ok = torch.autograd.gradcheck(
        lambda x: TB.bbox_overlaps_aligned(x, b, iou_mode=mode), (a,),
        raise_exception=False)
    assert ok == (mode != "ciou")


# --------------------------------------------------------------- assigner
def _assign_inputs(case, seed=0):
    """pred boxes / scores at mini_cfg's 84 anchors and padded gts.
    "tie": small gts holding fewer than 10 anchor centres (top-k picks
    among exact zeros); "padded": 5 real gts of 12; "empty": an image
    with no gt."""
    from wedetect_tpu_torch.ops.priors import flat_priors_and_strides

    rng = np.random.default_rng(seed)
    priors, strides = flat_priors_and_strides([(8, 8), (4, 4), (2, 2)],
                                              (8, 16, 32))
    b, a, k, g = 2, len(priors), 4, 12
    d = rng.uniform(0.5, 4, (b, a, 4)).astype(np.float32) * strides[:, None]
    pred = np.concatenate([priors - d[..., :2], priors + d[..., 2:]], -1)
    scores = rng.uniform(0.01, 0.99, (b, a, k)).astype(np.float32)
    gtb = np.zeros((b, g, 4), np.float32)
    gtl = rng.integers(0, k, (b, g)).astype(np.int32)
    gtm = np.zeros((b, g), bool)
    n = {"random": 4, "tie": 4, "padded": 5, "empty": 3}[case]
    for i in range(b):
        if case == "empty" and i == 1:
            continue
        big = case != "tie"
        gtb[i, :n] = _boxes(n, seed + i + 10, scale=40.0 if big else 50.0)
        if not big:
            gtb[i, :n, 2:] = gtb[i, :n, :2] + rng.uniform(6, 14, (n, 2))
        gtm[i, :n] = True
    if case == "padded":
        gtb[:, n:] = _boxes(g - n, 99)[None]      # junk under the mask
    return (pred.astype(np.float32), scores, priors, gtl, gtb, gtm, k)


@pytest.mark.parametrize("case", ["random", "tie", "padded", "empty"])
def test_assign_matches_jax(case):
    *arrays, k = _assign_inputs(case)
    want = JA.assign(*[jnp.asarray(x) for x in arrays], num_classes=k)
    got = TA.assign(*[torch.from_numpy(x) for x in arrays], num_classes=k)
    for key in ("labels", "fg_mask", "gt_idx"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)), key)
    for key in ("bboxes", "scores"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)),
                                   atol=1e-6, err_msg=key)
    assert got.fg_mask.any()
    if case == "tie":
        # every gt holds fewer than 10 anchor centres: its top-k reaches
        # into the zeros, where ties go to the lower index
        _, _, priors, _, gtb, gtm = arrays
        gt = gtb[gtm][:, None, :]
        inside = ((priors[:, 0] > gt[..., 0]) & (priors[:, 1] > gt[..., 1])
                  & (priors[:, 0] < gt[..., 2])
                  & (priors[:, 1] < gt[..., 3])).sum(-1)
        assert (inside < 10).all() and (inside > 0).any()


def test_topk_mask_ties_to_lower_index():
    """Rows of many equal metrics (exact zeros, and a tie at the k-th
    place) and an invalid gt: the mask equals JAX's bitwise."""
    rng = np.random.default_rng(3)
    m = np.zeros((2, 5, 40), np.float32)
    m[:, :, :6] = rng.uniform(0, 1, (2, 5, 6))
    m[0, 1, 10:20] = 0.5                       # ten-way tie at the cut
    m[1, 2] = np.round(rng.uniform(0, 1, 40) * 3) / 3
    valid = np.array([[1, 1, 1, 0, 1], [1, 1, 1, 1, 0]], bool)
    want = JA._topk_mask(jnp.asarray(m), 10, jnp.asarray(valid))
    got = TA._topk_mask(torch.from_numpy(m), 10, torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------- losses
def test_losses_match_jax():
    _, tcfg = cfgs()
    jcfg = cfgs()[0]
    rng = np.random.default_rng(11)
    b, a, k, r = 2, 84, 4, 16
    logits = rng.normal(0, 3, (b, a, k)).astype(np.float32)
    targets = rng.uniform(0, 1, (b, a, k)).astype(np.float32)
    dist = rng.normal(0, 2, (b, a, 4, r)).astype(np.float32)
    tgt = rng.uniform(0, r - 1.01, (b, a, 4)).astype(np.float32)
    pairs = [(JLS.bce_with_logits, TLS.bce_with_logits, (logits, targets)),
             (JLS.dfl_loss, TLS.dfl_loss, (dist, tgt))]
    for jf, tf, args in pairs:
        np.testing.assert_allclose(
            tf(*[torch.from_numpy(x) for x in args]).numpy(),
            np.asarray(jf(*[jnp.asarray(x) for x in args])), atol=1e-6,
            rtol=1e-6)
    x = rng.uniform(0.1, 2, (6, 5)).astype(np.float32)
    np.testing.assert_allclose(float(TLS.cov_mse_loss(torch.from_numpy(x))),
                               float(JLS.cov_mse_loss(jnp.asarray(x))),
                               rtol=1e-6)

    *arrays, _ = _assign_inputs("random", seed=2)
    pred, scores, priors, gtl, gtb, gtm = arrays
    res = JA.assign(*[jnp.asarray(v) for v in arrays], num_classes=k)
    strides = np.concatenate([np.full(64, 8.0), np.full(16, 16.0),
                              np.full(4, 32.0)]).astype(np.float32)
    args = (logits, pred, dist, np.asarray(res.bboxes),
            np.asarray(res.scores), np.asarray(res.fg_mask), priors,
            strides)
    want = JLS.detection_loss(jcfg, *[jnp.asarray(v) for v in args],
                              loss_scale=2.0)
    got = TLS.detection_loss(tcfg, *[torch.from_numpy(v) for v in args],
                             loss_scale=2.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    assert float(got.num_pos) > 0


# --------------------------------------------------------- BN, drop path
@pytest.fixture(scope="module")
def det():
    jcfg, tcfg = cfgs()
    return jcfg, tcfg, jax_variables(jcfg, seed=0)


@pytest.fixture(scope="module")
def det_loss(det):
    """JAX loss_fn on make_batch(): (total, new batch_stats, losses,
    grads)."""
    jcfg, tcfg, jvars = det
    jb = jbatch(make_batch())

    def f(p):
        return j_loss_fn(jcfg, p, jvars["batch_stats"], jb, 0)

    (total, (stats, losses)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(jvars["params"])
    return total, stats, losses, grads


def test_bn_running_stats_match_jax(det, det_loss):
    """One train-mode forward updates every running mean and variance
    as flax does (biased batch variance, the JAX momentum of each BN);
    the control, torch's own update, misses."""
    jcfg, tcfg, jvars = det
    _, jstats, _, jgrads = det_loss
    want = jgrads_as_port(jgrads, jstats, tcfg)
    model = port_model(jvars, tcfg)
    TS.loss_fn(tcfg, model, TS.Batch(*make_batch()))
    assert not model.training
    assert_stats_close(model, want)
    # the head's BNs move by 0.03 of the batch, the neck's by 0.1
    assert model.bbox_head.cls_contrasts[0].norm.momentum == 0.03
    assert model.neck.reduce_layer0.block.bn.momentum == 0.1

    control = port_model(jvars, tcfg)
    stock = TLY.BatchNorm2d.forward
    try:
        TLY.BatchNorm2d.forward = torch.nn.BatchNorm2d.forward
        TS.loss_fn(tcfg, control, TS.Batch(*make_batch()))
    finally:
        TLY.BatchNorm2d.forward = stock
    with pytest.raises(AssertionError):
        assert_stats_close(control, want)


def test_eval_forward_unchanged_by_train_mode_bn(det):
    """Eval mode is torch's BatchNorm: the same output as
    nn.BatchNorm2d on the same statistics, bitwise."""
    _, tcfg, jvars = det
    bn = port_model(jvars, tcfg).neck.Rep_p3.cv1.block.bn
    ref = torch.nn.BatchNorm2d(bn.num_features, eps=bn.eps).eval()
    ref.load_state_dict(bn.state_dict())
    x = torch.randn(2, bn.num_features, 5, 5,
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(bn(x), ref(x))


def _block(rate):
    blk = TCX.ConvNeXtBlock(8, layer_scale_init=1.0, drop_path=rate)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape,
                                generator=torch.Generator().manual_seed(1)))
    return blk


def test_drop_path_identity_at_rate_0_and_in_eval():
    x = torch.randn(6, 8, 5, 5, generator=torch.Generator().manual_seed(2))
    base = _block(0.0).eval()(x)
    assert torch.equal(_block(0.0).train()(x), base)
    assert torch.equal(_block(0.0).train()(x, torch.Generator()), base)
    assert torch.equal(_block(0.5).eval()(x, torch.Generator()), base)
    with pytest.raises(ValueError, match="Generator"):
        _block(0.5).train()(x)


def test_drop_path_drops_whole_samples_deterministically():
    """At rate 0.5: the same generator seed gives the same output; each
    sample's branch is dropped whole or kept scaled by 1 / keep."""
    x = torch.randn(64, 8, 5, 5, generator=torch.Generator().manual_seed(2))
    blk = _block(0.5).train()
    outs = [blk(x, torch.Generator().manual_seed(9)) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], blk(x, torch.Generator().manual_seed(8)))
    branch = _block(0.5).eval()(x) - x
    got = outs[0] - x
    kept = [bool(torch.allclose(got[i], branch[i] / 0.5, rtol=1e-5,
                                atol=1e-6)) for i in range(len(x))]
    dropped = [bool(torch.equal(got[i], torch.zeros_like(got[i])))
               for i in range(len(x))]
    assert all(k != d for k, d in zip(kept, dropped))
    assert 16 <= sum(kept) <= 48
    # the rates rise linearly over the blocks, to drop_path_rate
    net = TCX.ConvNeXt((1, 1, 2, 1), (8, 8, 8, 8), drop_path_rate=0.4)
    rates = [b.drop_path for s in net.stages for b in s]
    np.testing.assert_allclose(rates, [0.0, 0.1, 0.2, 0.3, 0.4])


# ----------------------------------------------------------------- loss_fn
@pytest.fixture(scope="module")
def noise(det, det_loss):
    """The tensors whose gradient (at make_batch()) is rounding noise on
    both sides, found by the port's loss_fn against JAX's."""
    jcfg, tcfg, jvars = det
    _, jstats, _, jgrads = det_loss
    model = port_model(jvars, tcfg)
    TS.loss_fn(tcfg, model, TS.Batch(*make_batch()))[0].backward()
    found = assert_grads_close(model, jgrads_as_port(jgrads, jstats, tcfg))
    assert len(found) < 20
    return found


@pytest.mark.parametrize("variant", ["det", "uni"])
def test_loss_fn_matches_jax(variant, det, det_loss):
    """loss_fn's loss, parts, num_pos and gradients; Uni scores against
    its own prompt bank (texts=None)."""
    if variant == "det":
        jcfg, tcfg, jvars = det
        total, jstats, jl, jgrads = det_loss
    else:
        jcfg, tcfg = cfgs(num_prompts=8, num_classes=8)
        jvars = jax_variables(jcfg, seed=1)
        jb = jbatch(make_batch(seed=1, k=8))

        def f(p):
            return j_loss_fn(jcfg, p, jvars["batch_stats"], jb, 0)

        (total, (jstats, jl)), jgrads = jax.jit(
            jax.value_and_grad(f, has_aux=True))(jvars["params"])
    model = port_model(jvars, tcfg)
    batch = TS.Batch(*make_batch(seed=0 if variant == "det" else 1,
                                 k=4 if variant == "det" else 8))
    got, tl = TS.loss_fn(tcfg, model, batch)
    got.backward()
    np.testing.assert_allclose(float(got), float(total), rtol=1e-5)
    for g, w in zip(tl, jl):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    assert float(tl.num_pos) > 0
    assert_grads_close(model, jgrads_as_port(jgrads, jstats, tcfg))


# ------------------------------------------------------------------ steps
def _compare_params(model, jparams, jstats, tcfg, steps, noise):
    """The parameters by the rule of the module docstring; a tensor of
    `noise` (gradient zero in exact arithmetic: Adam turns its rounding
    noise into steps of +-lr) is held to 2 * steps * lr alone."""
    want = from_jax_variables({"params": jax.tree.map(np.asarray, jparams),
                               "batch_stats": jax.tree.map(np.asarray,
                                                           jstats)}, tcfg)
    loose = total = 0
    for n, p in model.named_parameters():
        got, w = p.detach().numpy(), want[n].numpy()
        err = np.abs(got - w)
        if n not in noise:
            loose += int((err > 1e-6 + 1e-5 * np.abs(w)).sum())
            total += err.size
        assert err.max() <= 2 * steps * LR + 1e-6, (n, err.max())
    assert loose <= 1e-3 * total, (loose, total)
    assert_stats_close(model, want, atol=1e-6 + 0.1 * 2 * steps * LR)


OPT = dict(base_lr=LR, weight_decay=0.025, total_batch_size=2)


@pytest.fixture(scope="module")
def jtx(det):
    """One optax transformation for every JAX state of this module: the
    jitted train_step takes it as a static field, so a new one would
    compile the step again."""
    return JO.make_optimizer(det[2]["params"], **OPT)


def _port_state(det):
    _, tcfg, jvars = det
    model = port_model(jvars, tcfg)
    return TS.TrainState.create(model, TS.det_optimizer(model, **OPT))


def _states(det, jtx):
    js = JState.create(jax.tree.map(jnp.asarray, det[2]), jtx)
    return js, _port_state(det)


def test_train_steps_match_jax(det, det_loss, noise, jtx):
    """Two train_steps from the same weights: metrics, the first step's
    gradients, the parameters and BN statistics after both."""
    jcfg, tcfg, _ = det
    js, ts = _states(det, jtx)
    for step in range(2):
        arrays = make_batch(seed=step)
        js, jm = j_train_step(jcfg, js, jbatch(arrays))
        ts, tm = TS.train_step(tcfg, ts, TS.Batch(*arrays))
        for key, rtol in (("loss", 1e-5), ("loss_cls", 1e-5),
                          ("loss_bbox", 1e-5), ("loss_dfl", 1e-5),
                          ("grad_norm", 1e-4)):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=rtol, err_msg=key)
        assert float(tm["num_pos"]) == float(jm["num_pos"])
        if step == 0:
            _, jstats, _, jgrads = det_loss
            assert_grads_close(ts.model,
                               jgrads_as_port(jgrads, jstats, tcfg))
    assert ts.step == int(js.step) == 2 and ts.tx.count == 2
    assert not ts.model.training
    _compare_params(ts.model, js.params, js.batch_stats, tcfg, 2, noise)


def test_decay_mask_and_paths_match_jax(det):
    """jax_param_paths names every port parameter's JAX leaf once, and
    the port optimizer's decay flags equal JAX's decay_mask, leaf for
    leaf."""
    jcfg, tcfg, jvars = det
    model = port_model(jvars, tcfg)
    tx = TS.det_optimizer(model)
    want = {JO._path_str(p): bool(d) for p, d in
            jax.tree_util.tree_leaves_with_path(
                JO.decay_mask(jvars["params"]))}
    assert sorted(tx.paths) == sorted(want)
    assert dict(zip(tx.paths, tx.decay)) == want
    assert any(tx.decay) and not all(tx.decay)
    paths = jax_param_paths(tcfg)
    for n, p in model.named_parameters():
        leaf = jvars["params"]
        for name in paths[n].split("/"):
            leaf = leaf[name]
        assert np.asarray(leaf).size == p.numel(), n


# ------------------------------------------------------------ loop, ckpt
def _sample_fn(rng):
    """Seeded samples at mini_cfg's 64 x 64: 1-3 boxes, labels over a
    5-class text list (label 4 exceeds K = 4 and is dropped)."""
    img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    n = int(rng.integers(1, 4))
    xy = rng.uniform(0, 40, (n, 2))
    wh = rng.uniform(6, 24, (n, 2))
    return {"image": img,
            "gt_bboxes": np.concatenate([xy, xy + wh], -1).astype(
                np.float32),
            "gt_labels": rng.integers(0, 5, n),
            "texts": ["a", "b", "c", "d", "e"]}


def _text_embed(texts):
    seed = sum(ord(c) * (i + 1) for i, t in enumerate(texts) for c in t)
    e = np.random.default_rng(seed).standard_normal(
        (len(texts), 32)).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def test_loop_matches_jax(det, noise, jtx):
    """make_batch_iterator + run_training, 2 steps: the same batches,
    logged losses and num_pos, and the same parameters after."""
    jcfg, tcfg, _ = det
    js, ts = _states(det, jtx)
    jit = JL.make_batch_iterator(jcfg, JL.TrainLoopCfg(batch_size=2),
                                 _sample_fn, _text_embed, seed=5,
                                 num_workers=2)
    tit = TL.make_batch_iterator(tcfg, TL.TrainLoopCfg(batch_size=2),
                                 _sample_fn, _text_embed, seed=5,
                                 num_workers=2)
    jb, tb = next(jit), next(tit)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, np.asarray(b))
    logs = {"jax": [], "port": []}
    loop = dict(steps=2, batch_size=2, log_every=1)
    js = JL.run_training(jcfg, js, jit, JL.TrainLoopCfg(**loop),
                         log_fn=lambda s, m: logs["jax"].append(m))
    ts = TL.run_training(tcfg, ts, tit, TL.TrainLoopCfg(**loop),
                         log_fn=lambda s, m: logs["port"].append(m))
    assert [m["step"] for m in logs["port"]] == [1, 2]
    for got, want in zip(logs["port"], logs["jax"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["num_pos"] == want["num_pos"] > 0
    _compare_params(ts.model, js.params, js.batch_stats, tcfg, 2, noise)


def test_loop_profiles_its_window(det, tmp_path):
    """profile_dir: torch.profiler over steps [profile_start,
    profile_start + profile_steps), a chrome trace written at its end."""
    _, tcfg, _ = det
    ts = _port_state(det)
    loop = TL.TrainLoopCfg(steps=2, batch_size=2, log_every=5,
                           profile_dir=str(tmp_path), profile_start=0,
                           profile_steps=1)
    it = TL.make_batch_iterator(tcfg, loop, _sample_fn, _text_embed,
                                num_workers=2)
    ts = TL.run_training(tcfg, ts, it, loop)
    assert ts.step == 2
    trace = (tmp_path / "trace.json").read_text()
    assert "aten::" in trace


def test_detector_resume_is_bitwise(det, tmp_path):
    """A train state saved after one step and restored into a fresh
    model continues bitwise (parameters, BN statistics, Adam state)."""
    _, tcfg, _ = det
    a = _port_state(det)
    a, _ = TS.train_step(tcfg, a, TS.Batch(*make_batch(seed=0)))
    CIO.save_train_state(str(tmp_path / "step_1"), a)
    b = _port_state(det)
    b = CIO.restore_train_state(CIO.latest_checkpoint(str(tmp_path)), b)
    assert b.step == 1
    for st in (a, b):
        TS.train_step(tcfg, st, TS.Batch(*make_batch(seed=1)))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert any(k.endswith("running_var") for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for x, y in zip(a.tx.mu + a.tx.nu, b.tx.mu + b.tx.nu):
        assert torch.equal(x, y)


def test_drop_path_in_loss_fn(det):
    """At drop_path_rate > 0 the masks come from the step's generator:
    two runs agree bitwise, and differ from the run at rate 0 (the
    backbone's gradients)."""
    _, tcfg, jvars = det
    cfg = dataclasses.replace(tcfg, drop_path_rate=0.5)
    out = []
    for c in (cfg, cfg, tcfg):
        model = TW.WeDetectModule(c).eval()
        model.load_state_dict(from_jax_variables(jvars, c), strict=True)
        TS.loss_fn(c, model, TS.Batch(*make_batch()),
                   TS.drop_path_generator(c, 3, "cpu"))[0].backward()
        out.append(torch.cat([p.grad.flatten() for p in
                              model.backbone.parameters()]))
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])
    assert TS.drop_path_generator(tcfg, 0, "cpu") is None
