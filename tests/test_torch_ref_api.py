"""The port's RefScorer (`wedetect_tpu_torch/models/ref_api.py`), its
image preprocessing and the Ref CLI, against the JAX package on the
CPU.

RefScorer.score is compared on sigmoid scores at 1e-5 (logits agree to
1e-4, see test_torch_ref.py, and the scores here sit near the
out_proj prior of 0.01, where the sigmoid's slope is 0.01). The
resize is bitwise.
"""

import numpy as np
import pytest
import torch

from torch_ref_util import FakeTok, cfgs, jax_params, port_model
from wedetect_tpu.data.pil_resize import resize_bicubic_u8 as j_resize
from wedetect_tpu.data.vision_process import image_to_pixels as j_pixels
from wedetect_tpu.models.ref_api import RefScorer as JRefScorer
from wedetect_tpu_torch.data import vision_process as tvp
from wedetect_tpu_torch.data.pil_resize import resize_bicubic_u8
from wedetect_tpu_torch.models.ref import init_ref_variables
from wedetect_tpu_torch.models.ref_api import (RefScorer, pad_to_bucket,
                                               pad_to_tileable_bucket)
from wedetect_tpu_torch.ops import attention

QUERIES = ["red box", "dog", "the cat on the left"]


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = cfgs()
    params = jax_params(jcfg)
    return jcfg, tcfg, params


def _image():
    # 50x70: smart_resize (factor 8) takes it to 48x72, a 12x18 grid
    # whose 216 tokens the ViT pads to 256
    return np.random.default_rng(7).integers(0, 255, (50, 70, 3),
                                             dtype=np.uint8)


PROPS = np.array([[0, 0, 30, 30], [10, 10, 60, 45], [5, 20, 69, 49]],
                 np.float32)


@pytest.mark.parametrize("prefix_sharing", [True, False])
@pytest.mark.parametrize("device_patchify", [True, False])
def test_score_matches_jax(tiny, prefix_sharing, device_patchify):
    jcfg, tcfg, params = tiny
    common = dict(tokenizer=FakeTok(), seq_buckets=(64, 128),
                  query_batch=2, max_proposals=4,
                  prefix_sharing=prefix_sharing,
                  device_patchify=device_patchify)
    want = JRefScorer(cfg=jcfg, params=params, **common).score(
        _image(), PROPS, QUERIES, pad_token_id=0)
    scorer = RefScorer(cfg=tcfg, model=port_model(params, tcfg),
                       device="cpu", **common)
    got = scorer.score(_image(), PROPS, QUERIES, pad_token_id=0)
    assert got.shape == want.shape == (3, 3)
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_score_split_equals_joint_bf16(tiny):
    """bf16 weights cast once at construction; both paths agree."""
    _, tcfg, params = tiny
    common = dict(tokenizer=FakeTok(), seq_buckets=(128,), query_batch=4,
                  max_proposals=3, dtype="bfloat16", device="cpu")
    a = RefScorer(cfg=tcfg, model=port_model(params, tcfg),
                  prefix_sharing=True, **common)
    assert a.model.model.merge.weight.dtype == torch.bfloat16
    b = RefScorer(cfg=tcfg, model=port_model(params, tcfg),
                  prefix_sharing=False, **common)
    sa = a.score(_image(), PROPS, QUERIES[:2], pad_token_id=0)
    sb = b.score(_image(), PROPS, QUERIES[:2], pad_token_id=0)
    assert np.isfinite(sa).all()
    np.testing.assert_allclose(sa, sb, atol=2e-3)


@pytest.mark.parametrize("shape,out", [((50, 70, 3), (72, 48)),
                                       ((33, 17, 3), (40, 64)),
                                       ((64, 64), (32, 32)),
                                       ((120, 90, 3), (90, 120))])
def test_resize_bicubic_u8_bitwise(shape, out):
    img = np.random.default_rng(shape[0]).integers(0, 255, shape,
                                                   dtype=np.uint8)
    np.testing.assert_array_equal(resize_bicubic_u8(img, *out),
                                  j_resize(img, *out))


def test_image_to_pixels_matches_jax():
    img = _image()
    for buckets in (None, tvp.make_grid_buckets(64, 8)):
        a, gh, gw = tvp.image_to_pixels(img, patch=4, merge=2,
                                        grid_buckets=buckets)
        b, jgh, jgw = j_pixels(img, patch=4, merge=2, grid_buckets=buckets)
        assert (gh, gw) == (jgh, jgw)
        np.testing.assert_array_equal(a, b)


def test_resize_without_pillow_takes_numpy_path(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real(name, *a, **kw)

    img = _image()
    want = tvp.resize_pil_bicubic(img, 72, 48)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    np.testing.assert_array_equal(tvp.resize_pil_bicubic(img, 72, 48), want)


def test_pad_to_bucket():
    assert pad_to_bucket(10, (16, 32)) == 16
    assert pad_to_bucket(17, (16, 32)) == 32
    assert pad_to_bucket(99, (16, 32)) == 99


def test_pad_to_tileable_bucket():
    assert pad_to_tileable_bucket(10, (128, 256)) == 128
    assert pad_to_tileable_bucket(200, (128, 256)) == 256
    assert pad_to_tileable_bucket(257, (128, 256)) == 384
    assert pad_to_tileable_bucket(1025, (512, 1024)) == 1152


@pytest.mark.parametrize("prefix_sharing", [True, False])
def test_oversize_sequences_stay_on_the_kernels(monkeypatch, prefix_sharing):
    """A suffix (and a joint sequence) longer than the largest bucket is
    padded to a multiple of 128, so attn_impl="flash" (what "auto" is on
    the card) runs the kernels' contracts and never the einsum; logits
    equal the einsum scorer's at 1e-5 (the two differ only on pad rows,
    which are discarded)."""
    _, tcfg = cfgs(head_dim=128)
    common = dict(tokenizer=FakeTok(), seq_buckets=(128,),
                  suffix_buckets=(128,), query_batch=2, max_proposals=100,
                  prefix_sharing=prefix_sharing, device="cpu")
    props = np.tile(PROPS, (34, 1))[:100]
    want = RefScorer(cfg=tcfg, model=init_ref_variables(tcfg, 2, "cpu"),
                     attn_impl="einsum", **common).logits(
        _image(), props, QUERIES[:2], pad_token_id=0)

    def no_einsum(*a, **kw):
        raise AssertionError("the einsum attention ran")

    monkeypatch.setattr(attention, "_reference_attention", no_einsum)
    monkeypatch.setattr(attention, "_grouped_reference_attention", no_einsum)
    scorer = RefScorer(cfg=tcfg, model=init_ref_variables(tcfg, 2, "cpu"),
                       attn_impl="flash", **common)
    assert len(scorer.build_suffix(QUERIES[0], 100)) > 128
    got = scorer.logits(_image(), props, QUERIES[:2], pad_token_id=0)
    assert got.shape == (2, 100)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_scorer_default_device_raises_without_cuda(tiny, monkeypatch):
    _, tcfg, params = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        RefScorer(cfg=tcfg, model=port_model(params, tcfg),
                  tokenizer=FakeTok())


def test_scorer_rejects_untileable_buckets(tiny):
    _, tcfg, params = tiny
    with pytest.raises(ValueError, match="seq_buckets"):
        RefScorer(cfg=tcfg, model=port_model(params, tcfg),
                  tokenizer=FakeTok(), seq_buckets=(100,),
                  attn_impl="flash", device="cpu")
    RefScorer(cfg=tcfg, model=port_model(params, tcfg), tokenizer=FakeTok(),
              seq_buckets=(100,), device="cpu")     # auto on CPU: einsum


def test_cli_refuses_unported_modes_and_random_ref(tmp_path, capsys):
    import cv2

    from wedetect_tpu_torch.cli import infer_wedetect_ref as cli

    path = tmp_path / "img.png"
    cv2.imwrite(str(path), _image())
    # --video is ported: it is video chat and needs --generate
    with pytest.raises(SystemExit, match="requires --generate"):
        cli.main(["--image", str(path), "--device", "cpu", "--video",
                  "v.mp4"])
    for extra in ([], ["--int8-prefill"]):        # --int8-prefill is ported
        with pytest.raises(SystemExit, match="ref_checkpoint"):
            cli.main(["--image", str(path), "--device", "cpu", "--generate",
                      "describe", *extra])
    with pytest.raises(SystemExit, match="--query"):
        cli.main(["--image", str(path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="random-init Ref"):
        cli.main(["--image", str(path), "--query", "a dog", "--random-init",
                  "--device", "cpu", "--num_proposals", "5"])
    assert "proposals from WeDetect-Uni" in capsys.readouterr().out
