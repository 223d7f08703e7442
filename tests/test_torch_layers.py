"""The port's network modules, stage by stage, against their flax
counterparts on the same weights (a JAX init of the miniature detector
with random BN statistics, carried across with from_jax_variables) and
the same seeded NHWC inputs (NCHW on the port side).

Tolerance atol = rtol = 1e-4: f32 on both sides, convolutions summed in
another order by XLA and oneDNN.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wedetect_tpu.configs import ModelCfg as JModelCfg
from wedetect_tpu.models.wedetect import init_variables
from wedetect_tpu.nn import bifpan as jbifpan
from wedetect_tpu.nn import convnext as jconvnext
from wedetect_tpu.nn import head as jhead
from wedetect_tpu.nn import layers as jlayers
from wedetect_tpu_torch.ckpt.convert import _Writer, from_jax_variables
from wedetect_tpu_torch.configs import ModelCfg
from wedetect_tpu_torch.models.wedetect import WeDetectModule
from wedetect_tpu_torch.nn.layers import ConvBN

ATOL = RTOL = 1e-4
KW = dict(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
          neck_scale=0.25, neck_repeats=4, head_in_channels=(32, 64, 128),
          embed_dims=32, img_size=(64, 64), text=None, num_classes=4)


def _randomize(variables, seed):
    rng = np.random.default_rng(seed)

    def walk(d, stats):
        for k, x in d.items():
            if isinstance(x, dict):
                walk(x, stats)
            elif stats and k == "mean":
                d[k] = rng.normal(0, 0.2, x.shape).astype(np.float32)
            elif stats and k == "var":
                d[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif not stats and k in ("scale", "bias", "gamma") and x.ndim:
                d[k] = (x + rng.normal(0, 0.2, x.shape)).astype(np.float32)
    v = jax.tree.map(np.array, variables)
    walk(v["batch_stats"], True)
    walk(v["params"], False)
    return v


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelCfg(**KW)
    v = _randomize(init_variables(jcfg, seed=0), seed=1)
    model = WeDetectModule(ModelCfg(**KW)).eval()
    model.load_state_dict(from_jax_variables(v, ModelCfg(**KW)), strict=True)
    return v["params"], v["batch_stats"], model


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got, want):
    """got: NCHW torch tensor, want: NHWC jax array."""
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=ATOL, rtol=RTOL)


def _apply(module, params, stats, *args, **kw):
    v = {"params": params}
    if stats is not None:
        v["batch_stats"] = stats
    return module.apply(jax.tree.map(jnp.asarray, v),
                        *(jnp.asarray(a) for a in args), **kw)


@pytest.mark.parametrize("eps,path", [(1e-5, ("neck", "reduce0")),
                                      (1e-3, ("head", "cls1_conv0"))])
def test_convbn(weights, eps, path):
    params, stats, _ = weights
    p, s = params[path[0]][path[1]], stats[path[0]][path[1]]
    out_ch, in_ch = p["conv"]["kernel"].shape[3], p["conv"]["kernel"].shape[2]
    w = _Writer()
    w.convbn("", p, s)
    act = "relu" if path[0] == "neck" else "silu"
    port = ConvBN(in_ch, out_ch, p["conv"]["kernel"].shape[0], 1, act,
                  bn_eps=eps).eval()
    port.load_state_dict(w.sd, strict=True)
    x = _x((2, 8, 8, in_ch), 2)
    want = _apply(jlayers.ConvBN(out_ch, p["conv"]["kernel"].shape[0], 1,
                                 act, bn_eps=eps), p, s, x)
    _close(port(_nchw(x)), want)


def test_transpose2x(weights):
    params, _, model = weights
    p = params["neck"]["bifusion0"]["upsample"]
    x = _x((2, 4, 4, p["kernel"].shape[0]), 3)
    want = _apply(jlayers.Transpose2x(p["kernel"].shape[1]), p, None, x)
    _close(model.neck.Bifusion0.upsample(_nchw(x)), want)


def test_bepc3(weights):
    params, stats, model = weights
    x = _x((2, 8, 8, 64), 4)   # Rep_p4: ch(256) at scale 0.25 in and out
    want = _apply(jlayers.BepC3(64, n=4), params["neck"]["rep_p4"],
                  stats["neck"]["rep_p4"], x)
    _close(model.neck.Rep_p4(_nchw(x)), want)


def test_bifusion(weights):
    params, stats, model = weights
    x0, x1, x2 = _x((2, 4, 4, 64), 5), _x((2, 8, 8, 128), 6), \
        _x((2, 16, 16, 64), 7)
    want = _apply(jlayers.BiFusion(64), params["neck"]["bifusion0"],
                  stats["neck"]["bifusion0"], x0, x1, x2)
    _close(model.neck.Bifusion0(_nchw(x0), _nchw(x1), _nchw(x2)), want)


def test_convnext_block(weights):
    params, _, model = weights
    x = _x((2, 8, 8, 128), 8)
    want = _apply(jconvnext.ConvNeXtBlock(128),
                  params["backbone"]["stage2_block1"], None, x)
    _close(model.backbone.stages[2][1](_nchw(x)), want)


def test_convnext_backbone(weights):
    params, _, model = weights
    x = np.random.default_rng(9).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = _apply(jconvnext.ConvNeXt(depths=KW["depths"], dims=KW["dims"]),
                  params["backbone"], None, x)
    got = model.backbone(_nchw(x))
    for g, w in zip(got, want):
        _close(g, w)


def test_neck(weights):
    params, stats, model = weights
    feats = [_x((2, 64 // s, 64 // s, c), 10 + i) for i, (s, c) in
             enumerate(zip((4, 8, 16, 32), KW["dims"]))]
    want = jbifpan.CSPRepBiFPANNeck(scale=0.25, repeats=4).apply(
        jax.tree.map(jnp.asarray, {"params": params["neck"],
                                   "batch_stats": stats["neck"]}),
        tuple(jnp.asarray(f) for f in feats))
    got = model.neck([_nchw(f) for f in feats])
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("normalize_w", [True, False])
def test_head(weights, normalize_w):
    params, stats, model = weights
    feats = [_x((2, 64 // s, 64 // s, c), 20 + i) for i, (s, c) in
             enumerate(zip((8, 16, 32), (32, 64, 128)))]
    w = _x((4, 32), 30)
    want = jhead.WeDetectHead(embed_dims=32).apply(
        jax.tree.map(jnp.asarray, {"params": params["head"],
                                   "batch_stats": stats["head"]}),
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(w),
        normalize_w=normalize_w)
    got = model.bbox_head([_nchw(f) for f in feats], torch.from_numpy(w),
                          normalize_w)
    for f in ("logits", "dists", "embeds", "dist_logits"):
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(want, f)),
                                   atol=ATOL, rtol=RTOL, err_msg=f)
