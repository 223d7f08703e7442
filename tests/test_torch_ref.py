"""The port's WeDetect-Ref model (`wedetect_tpu_torch/models/ref.py`,
`ops/roi_align.py`, `ops/sine_embed.py`, `ckpt/convert_ref.py`) against
the JAX package on the same weights and inputs, on the CPU.

Tolerances: the ops and the grounding extras agree to 1e-5 (f32, other
summation orders); the proposal logits of the whole model to 1e-4
(two decoder layers and four ViT blocks of f32 matmuls, whose
summation order differs between XLA's and PyTorch's CPU kernels).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_ref_util import batch, cfgs, jax_params, port_model
from wedetect_tpu.ckpt.convert_ref import convert_ref_model
from wedetect_tpu.data.vision_process import image_to_patches
from wedetect_tpu.models import ref as JR
from wedetect_tpu.ops.roi_align import roi_align as j_roi_align
from wedetect_tpu.ops.sine_embed import sine_embed as j_sine_embed
from wedetect_tpu_torch.ckpt.convert_ref import from_jax_ref_params
from wedetect_tpu_torch.data.vision_process import image_to_pixels
from wedetect_tpu_torch.models import ref as TR
from wedetect_tpu_torch.ops.roi_align import roi_align
from wedetect_tpu_torch.ops.sine_embed import sine_embed

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = cfgs()
    params = jax_params(jcfg)
    return jcfg, tcfg, params, port_model(params, tcfg)


@pytest.mark.parametrize("sampling_ratio", [-1, 2])
def test_roi_align_matches_jax(sampling_ratio):
    rng = np.random.default_rng(sampling_ratio + 5)
    feat = rng.standard_normal((20, 28, 6)).astype(np.float32)
    # inside, at the map's edges, beyond them, degenerate, large
    rois = np.array([[3, 4, 60, 50], [0, 0, 224, 160], [200, 140, 230, 170],
                     [-20, -10, 30, 12], [100, 80, 100.5, 80.2],
                     [5.5, 7.25, 219.75, 155.5]], np.float32)
    want = j_roi_align(jnp.asarray(feat), jnp.asarray(rois), 7, 1.0 / 8,
                       sampling_ratio=sampling_ratio)
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 7,
                    1.0 / 8, sampling_ratio=sampling_ratio)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("n_coords", [2, 4])
def test_sine_embed_matches_jax(n_coords):
    pos = np.random.default_rng(n_coords).uniform(
        0, 1, (9, n_coords)).astype(np.float32)
    want = j_sine_embed(jnp.asarray(pos), 48)
    got = sine_embed(torch.from_numpy(pos), 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_pixels_to_patches_exact():
    img = np.random.default_rng(0).integers(0, 255, (70, 100, 3),
                                            dtype=np.uint8)
    want, gh, gw = image_to_patches(img, patch=4, temporal_patch=2,
                                    merge=2)
    pixels, gh2, gw2 = image_to_pixels(img, patch=4, merge=2)
    got = TR.pixels_to_patches(torch.tensor(pixels), 4, 2, 2)
    assert (gh, gw) == (gh2, gw2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pyramid_and_object_feats_match_jax(tiny):
    jcfg, tcfg, params, model = tiny
    rng = np.random.default_rng(3)
    d = tcfg.text.hidden
    scales = [rng.standard_normal((4, 6, d)).astype(np.float32)
              for _ in range(3)]
    boxes = np.array([[4, 4, 60, 40], [10, 8, 190, 120], [0, 0, 192, 128]],
                     np.float32)
    mod = JR.RefModules(jcfg, 8, 12)

    def j_run(m, s1, s2, s3, bx):
        p = m.extras.build_pyramid(s1, s2, s3)
        return p, m.extras.object_feats(*p, bx)

    (jp, jobj) = mod.apply({"params": params}, *scales, boxes, method=j_run)
    with torch.no_grad():
        tp = model.model.build_pyramid(*(torch.from_numpy(s)
                                         for s in scales))
        tobj = model.model.object_feats(*tp, torch.from_numpy(boxes))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(tobj.numpy(), np.asarray(jobj), atol=1e-5,
                               rtol=1e-4)


def _joint(jcfg, params, bt, impl="auto"):
    return np.asarray(JR.ref_score_step(
        jcfg, 8, 8, params, jnp.asarray(bt.patches), jnp.asarray(bt.ids),
        jnp.asarray(bt.mask), jnp.asarray(bt.pos), bt.visual_start,
        jnp.asarray(bt.boxes), jnp.asarray(bt.ori_wh), jnp.asarray(bt.obj),
        jnp.float32, impl))


def test_ref_modules_joint_matches_jax(tiny):
    jcfg, tcfg, params, model = tiny
    bt = batch()
    want = _joint(jcfg, params, bt)
    got = TR.ref_score_step(model, 8, 8, bt.patches, bt.ids, bt.mask,
                            bt.pos, bt.visual_start, bt.boxes, bt.ori_wh,
                            bt.obj)
    assert got.shape == want.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_ref_modules_split_matches_jax(tiny):
    """prefill_split and prefix_stage + suffix_stage against JAX
    ref_score_step_split (and so against the joint path)."""
    jcfg, tcfg, params, model = tiny
    bt = batch()
    want = np.asarray(JR.ref_score_step_split(
        jcfg, 8, 8, params, jnp.asarray(bt.patches),
        jnp.asarray(bt.prefix_ids), jnp.asarray(bt.suffix_ids),
        jnp.asarray(bt.prefix_mask), jnp.asarray(bt.suffix_mask),
        jnp.asarray(bt.prefix_pos), jnp.asarray(bt.suffix_pos),
        jnp.asarray(bt.boxes), bt.visual_start, jnp.asarray(bt.ori_wh),
        jnp.asarray(bt.suffix_obj)))
    one = TR.ref_score_step_split(
        model, 8, 8, bt.patches, bt.prefix_ids, bt.suffix_ids,
        bt.prefix_mask, bt.suffix_mask, bt.prefix_pos, bt.suffix_pos,
        bt.boxes, bt.visual_start, bt.ori_wh, bt.suffix_obj)
    obj, kvs = TR.ref_prefix_step(model, 8, 8, bt.patches, bt.prefix_ids,
                                  bt.prefix_mask, bt.prefix_pos, bt.boxes,
                                  bt.ori_wh, bt.visual_start)
    two = TR.ref_suffix_step(model, obj, kvs, bt.suffix_ids, bt.suffix_mask,
                             bt.suffix_pos, bt.prefix_mask, bt.suffix_obj)
    for got in (one, two):
        np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    np.testing.assert_allclose(two.numpy(), _joint(jcfg, params, batch()),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("path", ["joint", "split"])
def test_flash_slice_on_cpu(path):
    """attn_impl="flash" on the CPU: the decoder (head_dim 128, so K2's
    tiling holds) runs gqa_flash_attention_plain and the ViT
    flash_attention_plain, against JAX at "einsum"."""
    jcfg, tcfg = cfgs(head_dim=128)
    params = jax_params(jcfg, seed=4)
    model = port_model(params, tcfg, attn_impl="flash")
    bt = batch(seed=6, p_pad=128, s_pad=128, l_pad=256)
    if path == "joint":
        want = _joint(jcfg, params, bt, impl="einsum")
        got = TR.ref_score_step(model, 8, 8, bt.patches, bt.ids, bt.mask,
                                bt.pos, bt.visual_start, bt.boxes,
                                bt.ori_wh, bt.obj)
    else:
        want = np.asarray(JR.ref_score_step_split(
            jcfg, 8, 8, params, jnp.asarray(bt.patches),
            jnp.asarray(bt.prefix_ids), jnp.asarray(bt.suffix_ids),
            jnp.asarray(bt.prefix_mask), jnp.asarray(bt.suffix_mask),
            jnp.asarray(bt.prefix_pos), jnp.asarray(bt.suffix_pos),
            jnp.asarray(bt.boxes), bt.visual_start, jnp.asarray(bt.ori_wh),
            jnp.asarray(bt.suffix_obj), jnp.float32, "einsum"))
        got = TR.ref_score_step_split(
            model, 8, 8, bt.patches, bt.prefix_ids, bt.suffix_ids,
            bt.prefix_mask, bt.suffix_mask, bt.prefix_pos, bt.suffix_pos,
            bt.boxes, bt.visual_start, bt.ori_wh, bt.suffix_obj)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_weight_round_trip(tiny):
    """JAX init -> numpy -> from_jax_ref_params -> the JAX package's
    own HF converter (convert_ref_model) gives back the JAX params
    exactly: the port's state dict carries the HF checkpoint's key names.
    No real checkpoint is in the repository, so this round trip is the
    only check of checkpoint compatibility."""
    jcfg, tcfg, params, model = tiny
    sd = from_jax_ref_params(params, tcfg)
    assert set(sd) == set(model.state_dict())
    back = convert_ref_model({k: v.numpy() for k, v in sd.items()}, jcfg)
    a = jax.tree_util.tree_leaves_with_path(params)
    b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(a) == len(b)
    for path, x in a:
        np.testing.assert_array_equal(np.asarray(b[path]), x)


def test_init_ref_variables_distributions():
    """Seeded random init: deterministic, every weight written, the
    flax initializers' scales and out_proj's prior bias."""
    _, tcfg = cfgs()
    a = TR.init_ref_variables(tcfg, seed=0, device="cpu")
    b = TR.init_ref_variables(tcfg, seed=0, device="cpu")
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    m = a.model
    w = m.language_model.layers[0].mlp.down_proj.weight.detach()
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.1
    assert float(w.abs().max()) <= 2 / np.sqrt(w.shape[1]) / 0.8796 + 1e-6
    assert abs(float(m.visual.pos_embed.weight.detach().std()) - 0.02) < 0.005
    assert torch.all(m.language_model.norm.weight == 1)
    np.testing.assert_allclose(float(a.out_proj.bias),
                               -np.log(0.99 / 0.01), rtol=1e-6)


def test_cast_ref_model_keeps_norms_f32():
    _, tcfg = cfgs()
    model = TR.cast_ref_model(TR.init_ref_variables(tcfg, 0, "cpu"),
                              "bfloat16")
    m = model.model
    assert m.language_model.layers[0].self_attn.q_proj.weight.dtype == \
        torch.bfloat16
    assert m.visual.patch_embed.proj.weight.dtype == torch.bfloat16
    assert m.first_scale_conv1.weight.dtype == torch.bfloat16
    for t in (m.language_model.norm.weight, m.visual.blocks[0].norm1.weight,
              m.first_scale_norm.weight, m.visual.pos_embed.weight,
              model.out_proj.weight):
        assert t.dtype == torch.float32
