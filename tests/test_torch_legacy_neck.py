"""The port's legacy necks and RepVGG (`nn/yolo_world_pafpn.py`,
`nn/layers.RepVGGBlock` / `repvgg_fuse` / `Conv1x1`) against the JAX
modules at miniature widths: the same seeded NHWC inputs (NCHW on the
port side) and seeded random JAX variables (the init's tree, random BN
statistics included), carried across with
`ckpt/convert.from_jax_module`.

Each module in eval mode and in train mode; in train mode the BN running
statistics must equal flax's `batch_stats` after one update (torch
momentum 0.03 in the necks, 0.1 in RepVGG). The key names are pinned by
a round trip through the JAX package's own converters
(`wedetect_tpu.ckpt.convert`). A MaxSigmoid head split in the wrong
order, (E/m, m), must miss.

Tolerance atol = rtol = 1e-4 (f32 both sides).
"""

import numpy as np
import pytest
import torch

import jax

from wedetect_tpu.ckpt import convert as jconvert
from wedetect_tpu.nn import layers as jl
from wedetect_tpu.nn import yolo_world_pafpn as jw
from wedetect_tpu_torch.ckpt.convert import from_jax_module
from wedetect_tpu_torch.nn import layers as tl
from wedetect_tpu_torch.nn import yolo_world_pafpn as tw

from torch_legacy_util import (ATOL, RTOL, close_nchw, jax_apply, jax_init,
                               nchw, port_from, running_stats_match, x_nhwc)

B = 2
# three levels: 16x16, 8x8, 4x4
FEATS = ((16, 16), (8, 32), (4, 64))   # (side, channels)
OUT = (16, 32, 64)
GUIDE = 24


def _feats(chs=None, seed=3):
    chs = chs or [c for _, c in FEATS]
    return [x_nhwc((B, s, s, c), seed + i)
            for i, ((s, _), c) in enumerate(zip(FEATS, chs))]


def _text(k=5, c=GUIDE, seed=9):
    return x_nhwc((B, k, c), seed)


# name -> (flax module, port module, writer kind, writer kw, JAX args)
# where each arg is ("x", array) for an NHWC image, ("feats", list) for a
# pyramid or ("t", array) for a (B, K, C) tensor
def _cases():
    x16 = ("x", x_nhwc((B, 8, 8, 16), 1))
    x32 = ("x", x_nhwc((B, 8, 8, 32), 2))
    g = ("t", _text())
    return {
        "repvgg_s1": (jl.RepVGGBlock(16), tl.RepVGGBlock(16, 16),
                      "repvgg", {}, [x16]),
        "repvgg_s2": (jl.RepVGGBlock(24, stride=2),
                      tl.RepVGGBlock(16, 24, stride=2), "repvgg", {}, [x16]),
        "darknet": (jw.DarknetBottleneck(16), tw.DarknetBottleneck(16, 16),
                    "darknet_bottleneck", {}, [x16]),
        "csp2": (jw.CSPLayerWithTwoConv(24, num_blocks=2),
                 tw.CSPLayerWithTwoConv(32, 24, num_blocks=2), "csp2",
                 {"n": 2}, [x32]),
        "max_csp": (jw.MaxSigmoidCSPLayerWithTwoConv(
                        32, 16, num_heads=2, num_blocks=2),
                    tw.MaxSigmoidCSPLayerWithTwoConv(
                        32, 32, GUIDE, 16, num_heads=2, num_blocks=2),
                    "max_csp", {"n": 2}, [x32, g]),
        "efficient_csp": (jw.EfficientCSPLayerWithTwoConv(32, num_blocks=1),
                          tw.EfficientCSPLayerWithTwoConv(32, 32,
                                                          num_blocks=1),
                          "efficient_csp", {"n": 1}, [x32, g]),
        "c3": (jw.CSPLayer(24, num_blocks=2, add_identity=True),
               tw.CSPLayer(32, 24, num_blocks=2, add_identity=True),
               "mmdet_csp", {"n": 2}, [x32]),
        "yolo_world": (jw.YOLOWorldPAFPN(OUT, (8, 16, 32), (2, 2, 4),
                                         num_csp_blocks=1),
                       tw.YOLOWorldPAFPN(None, OUT, GUIDE, (8, 16, 32),
                                         (2, 2, 4), num_csp_blocks=1),
                       "yolo_world_pafpn", {"n_blocks": 1},
                       [("feats", _feats()), g]),
        "yolo_world_dual": (jw.YOLOWorldPAFPN(OUT, (8, 16, 32), (2, 2, 4),
                                              num_csp_blocks=1, dual=True),
                            tw.YOLOWorldPAFPN(None, OUT, GUIDE, (8, 16, 32),
                                              (2, 2, 4), num_csp_blocks=1,
                                              dual=True),
                            "yolo_world_pafpn",
                            {"n_blocks": 1, "dual": True},
                            [("feats", _feats()), g]),
        "yolov5_pafpn": (jw.YOLOv5PAFPN(OUT, num_csp_blocks=2),
                         tw.YOLOv5PAFPN(OUT, num_csp_blocks=2),
                         "yolov5_pafpn", {"n_blocks": 2},
                         [("feats", _feats())]),
        "yolov8_pafpn": (jw.YOLOv8PAFPN(OUT, num_csp_blocks=1),
                         tw.YOLOv8PAFPN(None, OUT, num_csp_blocks=1),
                         "yolov8_pafpn", {"n_blocks": 1},
                         [("feats", _feats())]),
    }


CASES = list(_cases())


def _jargs(args):
    return [a for _, a in args]


def _targs(args):
    out = []
    for kind, a in args:
        if kind == "x":
            out.append(nchw(a))
        elif kind == "feats":
            out.append([nchw(f) for f in a])
        else:
            out.append(torch.from_numpy(a))
    return out


def _compare(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close_nchw(g, w)
    else:
        close_nchw(got, want)


@pytest.fixture(scope="module")
def built():
    """Each case's flax module, port module (loaded), kind, kw, args and
    randomized variables, built once."""
    out = {}
    for i, (name, (jm, tm, kind, kw, args)) in enumerate(_cases().items()):
        v = jax_init(jm, i, *_jargs(args))
        out[name] = (jm, port_from(kind, v, tm, **kw), kind, kw, args, v)
    return out


@pytest.mark.parametrize("name", CASES)
def test_module_eval_matches_jax(built, name):
    jm, tm, kind, kw, args, v = built[name]
    want = jax_apply(jm, v, *_jargs(args))
    with torch.no_grad():
        got = tm(*_targs(args))
    _compare(got, want)


@pytest.mark.parametrize("name", CASES)
def test_module_train_matches_jax(name):
    """Train mode: the batch statistics normalize, and the running
    statistics after one update equal flax's."""
    jm, tm, kind, kw, args = _cases()[name]
    v = jax_init(jm, CASES.index(name), *_jargs(args))
    port_from(kind, v, tm, **kw).train()
    want, new_stats = jax_apply(jm, v, *_jargs(args), train=True)
    with torch.no_grad():
        got = tm(*_targs(args))
    _compare(got, want)
    running_stats_match(tm, kind, v, new_stats, **kw)


def test_convmodule_defaults_unchanged():
    """The ConvModule options keep their defaults: torch momentum 0.1,
    eps 1e-5, SiLU, and the same key names."""
    m = tl.ConvModule(4, 8)
    assert m.bn.momentum == 0.1 and m.bn.eps == 1e-5
    assert isinstance(m.act, torch.nn.SiLU)
    assert sorted(m.state_dict()) == [
        "bn.bias", "bn.num_batches_tracked", "bn.running_mean",
        "bn.running_var", "bn.weight", "conv.weight"]
    n = tl.ConvModule(4, 8, 1, act=None, bn_eps=1e-3, bn_momentum=0.03)
    assert isinstance(n.act, torch.nn.Identity)
    assert n.bn.momentum == 0.03 and n.bn.eps == 1e-3


def test_conv1x1_matches_jax():
    x = x_nhwc((B, 6, 6, 16), 4)
    jm = jl.Conv1x1(8)
    v = jax_init(jm, 0, x)
    tm = tl.Conv1x1(16, 8)
    tm.load_state_dict({"conv.weight": torch.from_numpy(np.ascontiguousarray(
        np.asarray(v["params"]["conv"]["kernel"]).transpose(3, 2, 0, 1))),
        "conv.bias": torch.from_numpy(v["params"]["conv"]["bias"])})
    close_nchw(tm(nchw(x)), jax_apply(jm, v, x))


@pytest.mark.parametrize("in_ch,out_ch,stride", [(16, 16, 1), (16, 24, 2),
                                                 (16, 24, 1)])
def test_repvgg_fuse_matches_jax(in_ch, out_ch, stride):
    """repvgg_fuse against JAX's on the same block, and the deploy form
    on the fused weights against the train form."""
    x = x_nhwc((B, 8, 8, in_ch), 5)
    jm = jl.RepVGGBlock(out_ch, stride=stride)
    v = jax_init(jm, 7, x)
    tm = port_from("repvgg", v, tl.RepVGGBlock(in_ch, out_ch, stride))
    assert hasattr(tm, "rbr_identity") == (in_ch == out_ch and stride == 1)
    fused = tl.repvgg_fuse(tm)
    want = jax.jit(jl.repvgg_fuse)(v["params"], v["batch_stats"])["reparam"]
    np.testing.assert_allclose(
        fused["reparam.weight"].permute(2, 3, 1, 0).numpy(),
        np.asarray(want["kernel"]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(fused["reparam.bias"].numpy(),
                               np.asarray(want["bias"]), atol=ATOL,
                               rtol=RTOL)
    deploy = tl.RepVGGBlock(in_ch, out_ch, stride, deploy=True)
    deploy.load_state_dict(fused, strict=True)
    with torch.no_grad():
        close_nchw(deploy(nchw(x)), jax_apply(jm, v, x))
        torch.testing.assert_close(deploy(nchw(x)), tm(nchw(x)), atol=ATOL,
                                   rtol=RTOL)
    # the deploy form's keys through the writer
    sd = from_jax_module("repvgg", {"params": {"reparam": want}})
    assert sorted(sd) == ["reparam.bias", "reparam.weight"]


@pytest.mark.parametrize("embed,scale", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_max_sigmoid_attn_matches_jax(embed, scale):
    """MaxSigmoidAttnBlock with and without embed_conv (embed_ch != in)
    and with_scale, eval and train."""
    x = x_nhwc((B, 6, 6, 16), 6)
    g = x_nhwc((B, 5, GUIDE), 7)
    e = 8 if embed else 16
    jm = jw.MaxSigmoidAttnBlock(16, e, num_heads=2, with_scale=scale)
    v = jax_init(jm, 11, x, g)
    assert ("embed_conv" in v["params"]) == embed
    assert ("scale" in v["params"]) == scale
    tm = port_from("max_sigmoid_attn", v,
                   tw.MaxSigmoidAttnBlock(16, 16, GUIDE, e, 2, scale))
    with torch.no_grad():
        close_nchw(tm(nchw(x), torch.from_numpy(g)), jax_apply(jm, v, x, g))
        tm.train()
        want, new_stats = jax_apply(jm, v, x, g, train=True)
        close_nchw(tm(nchw(x), torch.from_numpy(g)), want)
    running_stats_match(tm, "max_sigmoid_attn", v, new_stats)


def test_max_sigmoid_wrong_head_split_misses():
    """Control: splitting the guide's channels (E/m, m) in place of
    (m, E/m) must miss the JAX block."""
    x = x_nhwc((B, 6, 6, 16), 6)
    g = x_nhwc((B, 5, GUIDE), 7)
    jm = jw.MaxSigmoidAttnBlock(16, 16, num_heads=4)
    v = jax_init(jm, 12, x, g)
    tm = port_from("max_sigmoid_attn", v,
                   tw.MaxSigmoidAttnBlock(16, 16, GUIDE, 16, 4))
    want = np.asarray(jax_apply(jm, v, x, g))
    fc = tm.guide_fc

    class WrongSplit(torch.nn.Module):
        def forward(self, t):
            y = fc(t)
            return y.reshape(*y.shape[:-1], 4, 4).transpose(-1, -2).reshape(
                y.shape)

    tm.guide_fc = WrongSplit()
    with torch.no_grad():
        got = tm(nchw(x), torch.from_numpy(g)).permute(0, 2, 3, 1).numpy()
    assert not np.allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(got - want).max() > 100 * ATOL


@pytest.mark.parametrize("h,w,out", [(7, 5, 3), (10, 13, 3), (16, 16, 3),
                                     (4, 4, 3), (5, 9, 4)])
def test_adaptive_max_pool_matches_jax(h, w, out):
    """The image-pooling attention's pool, F.adaptive_max_pool2d, against
    JAX's hand-sliced windows, uneven sizes included."""
    x = x_nhwc((2, h, w, 4), h * w)
    want = np.asarray(jw._adaptive_max_pool(jax.numpy.asarray(x), out))
    close_nchw(torch.nn.functional.adaptive_max_pool2d(nchw(x), out), want,
               atol=0, rtol=0)


@pytest.mark.parametrize("scale", [False, True])
def test_image_pooling_attention_matches_jax(scale):
    feats = _feats()
    text = _text(6, 20)
    jm = jw.ImagePoolingAttentionModule(20, 32, num_heads=4,
                                        with_scale=scale)
    v = jax_init(jm, 13, text, feats)
    assert ("scale" in v["params"]) == scale
    tm = port_from("image_pool_attn", v, tw.ImagePoolingAttentionModule(
        [c for _, c in FEATS], 20, 32, num_heads=4, with_scale=scale))
    want = np.asarray(jax_apply(jm, v, text, feats))
    with torch.no_grad():
        got = tm(torch.from_numpy(text), [nchw(f) for f in feats])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def _round_trip(convert, sd_port, v, **kw):
    """Port state dict -> numpy -> the JAX converter: every leaf of the
    original variables back, bit for bit."""
    sd = {k: t.numpy() for k, t in sd_port.items()}
    params, stats = convert(sd, "", **kw)
    for tree, ref in ((params, v["params"]), (stats, v.get("batch_stats"))):
        if ref is None:
            continue
        a = dict(jax.tree_util.tree_leaves_with_path(ref))
        b = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert a.keys() == b.keys()
        for path, x in a.items():
            np.testing.assert_array_equal(np.asarray(b[path]), x)


@pytest.mark.parametrize("name,convert,kw", [
    ("csp2", jconvert.convert_csp2, {"n": 2}),
    ("max_csp", jconvert.convert_max_csp, {"n": 2}),
    ("yolo_world_dual", jconvert.convert_yolo_world_pafpn,
     {"n_blocks": 1, "dual": True}),
    ("yolo_world", jconvert.convert_yolo_world_pafpn, {"n_blocks": 1}),
    ("yolov5_pafpn", jconvert.convert_yolov5_pafpn, {"n_blocks": 2}),
    ("yolov8_pafpn", jconvert.convert_yolov8_pafpn, {"n_blocks": 1}),
    ("c3", jconvert.convert_mmdet_csp, {"n": 2}),
])
def test_keys_round_trip_through_jax_converter(built, name, convert, kw):
    _, tm, kind, _, _, v = built[name]
    sd = {k: t for k, t in tm.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    _round_trip(convert, sd, v, **kw)


def test_image_pool_attn_keys_round_trip():
    feats = _feats()
    text = _text(6, 20)
    jm = jw.ImagePoolingAttentionModule(20, 32, num_heads=4, with_scale=True)
    v = jax_init(jm, 13, text, feats)
    tm = port_from("image_pool_attn", v, tw.ImagePoolingAttentionModule(
        [c for _, c in FEATS], 20, 32, num_heads=4, with_scale=True))
    _round_trip(jconvert.convert_image_pool_attn, tm.state_dict(),
                {"params": v["params"]}, num_feats=3)
