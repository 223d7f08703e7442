"""The port's detection drawing (`wedetect_tpu_torch/utils/vis.py`) and
the three CLIs' drawing options against the JAX package on the CPU.

The contract is pixel equality: `draw_detections` and `visualize_batch`
draw the same pixels as the JAX package's with PIL's default font and
with an explicit TrueType font (the first of DejaVu or matplotlib's copy
that exists on the host); boxes, scores and labels may be tensors. Each
CLI writes its file at the input's size, different from the input and
equal to the JAX drawing of the detections the CLI returned.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from wedetect_tpu.utils import vis as JVIS
from wedetect_tpu_torch.train.train_step import Batch
from wedetect_tpu_torch.utils import vis as TVIS


def _font_path():
    cands = ["/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"]
    try:
        import matplotlib

        cands.append(os.path.join(matplotlib.get_data_path(), "fonts", "ttf",
                                  "DejaVuSans.ttf"))
    except ImportError:
        pass
    return next((c for c in cands if os.path.exists(c)), None)


def _scene(seed=0, n=6, hw=(120, 160)):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, hw + (3,), dtype=np.uint8)
    xy = rng.uniform(0, 100, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (n, 2))],
                           1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    labels = rng.integers(0, 25, n).astype(np.int64)
    return img, boxes, scores, labels


@pytest.mark.parametrize("font", ["default", "path"])
@pytest.mark.parametrize("names", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_draw_detections_pixel_equal(font, names, as_tensor):
    path = _font_path() if font == "path" else None
    if font == "path" and path is None:
        pytest.skip("no TrueType font on this host")
    img, boxes, scores, labels = _scene(seed=int(names) + 2 * int(as_tensor))
    class_names = [f"cls{i}" for i in range(25)] if names else None
    kw = dict(class_names=class_names, font_path=path)
    want = JVIS.draw_detections(img, boxes, scores, labels, **kw)
    args = ((torch.from_numpy(boxes), torch.from_numpy(scores),
             torch.from_numpy(labels)) if as_tensor
            else (boxes, scores, labels))
    got = TVIS.draw_detections(Image.fromarray(img) if as_tensor else img,
                               *args, **kw)
    assert got.size == want.size == (img.shape[1], img.shape[0])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert (np.asarray(got) != img).any()


def test_draw_options_and_empty_match_jax():
    img, boxes, scores, labels = _scene(seed=5, n=3)
    for kw in (dict(line_width=1, font_size=20), dict(line_width=6)):
        np.testing.assert_array_equal(
            np.asarray(TVIS.draw_detections(img, boxes, scores, labels,
                                            **kw)),
            np.asarray(JVIS.draw_detections(img, boxes, scores, labels,
                                            **kw)))
    empty = TVIS.draw_detections(img, boxes[:0], scores[:0], labels[:0])
    np.testing.assert_array_equal(np.asarray(empty), img)


def test_caption_font_and_palette_match_jax(tmp_path):
    assert TVIS.PALETTE == JVIS.PALETTE
    assert TVIS._CJK_FONT_CANDIDATES == JVIS._CJK_FONT_CANDIDATES
    assert type(TVIS.load_caption_font()) is type(JVIS.load_caption_font())
    bad = str(tmp_path / "missing.ttf")
    for mod in (TVIS, JVIS):
        with pytest.raises(OSError):
            mod.load_caption_font(bad)


@pytest.mark.parametrize("floats", [False, True])
def test_visualize_batch_matches_jax(tmp_path, floats):
    """uint8 images, or normalized floats denormalized with mean/std; gt
    masks pick the boxes drawn; the files decode to the same pixels."""
    rng = np.random.default_rng(int(floats))
    imgs = rng.integers(0, 255, (2, 64, 80, 3), dtype=np.uint8)
    mean, std = (10.0, 20.0, 30.0), (50.0, 60.0, 70.0)
    images = ((imgs - np.array(mean)) / np.array(std)).astype(np.float32) \
        if floats else imgs
    gtb = np.array([[[2, 3, 40, 30], [10, 10, 70, 60], [0, 0, 0, 0]],
                    [[5, 5, 20, 20], [0, 0, 0, 0], [0, 0, 0, 0]]],
                   np.float32)
    gtl = np.array([[1, 3, 0], [2, 0, 0]], np.int32)
    gtm = np.array([[True, True, False], [True, False, False]])
    kw = dict(class_texts=["a", "b", "c", "d"])
    if floats:
        kw.update(mean=mean, std=std)
    tb = Batch(images=torch.from_numpy(images), texts=None,
               gt_bboxes=torch.from_numpy(gtb),
               gt_labels=torch.from_numpy(gtl), gt_mask=torch.from_numpy(gtm))
    got = TVIS.visualize_batch(tb, out_dir=str(tmp_path / "t"), **kw)
    jb = Batch(images=images, texts=None, gt_bboxes=gtb, gt_labels=gtl,
               gt_mask=gtm)
    want = JVIS.visualize_batch(jb, out_dir=str(tmp_path / "j"), **kw)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["batch_0.jpg", "batch_1.jpg"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(Image.open(g)),
                                      np.asarray(Image.open(w)))


# ----------------------------------------------------------------- CLIs
def _image(tmp_path, hw=(96, 128)):
    import cv2

    path = str(tmp_path / "img.png")
    img = np.random.default_rng(0).integers(0, 255, hw + (3,),
                                            dtype=np.uint8)
    cv2.imwrite(path, img)
    return path, img[..., ::-1]            # the file's RGB pixels


def _check_drawing(out, img, r, labels, class_names=None):
    drawn = np.asarray(Image.open(out))
    assert drawn.shape == img.shape
    assert (drawn != img).any()
    want = JVIS.draw_detections(img, r["bboxes"], r["scores"], labels,
                                class_names=class_names)
    np.testing.assert_array_equal(drawn, np.asarray(want))


def test_infer_wedetect_output_writes_drawing(tmp_path, capsys):
    from wedetect_tpu_torch.cli import infer_wedetect

    path, img = _image(tmp_path)
    out = str(tmp_path / "pred.png")
    r = infer_wedetect.main(["--image", path, "--text", "a,b",
                             "--random-init", "--size", "tiny", "--device",
                             "cpu", "--threshold", "0.0", "--output", out])
    assert f"saved {out}" in capsys.readouterr().out
    assert len(r["bboxes"]) > 0
    _check_drawing(out, img, r, r["labels"], class_names=["a", "b"])


def test_generate_proposal_visualize_writes_drawing(tmp_path, capsys):
    from wedetect_tpu_torch.cli import generate_proposal

    path, img = _image(tmp_path)
    out = str(tmp_path / "props.png")
    r = generate_proposal.main(["--image", path, "--size", "base",
                                "--random-init", "--device", "cpu",
                                "--num_proposals", "5", "--score_thre", "0",
                                "--visualize", "--output", out])
    assert f"saved {out}" in capsys.readouterr().out
    assert len(r["bboxes"]) > 0
    _check_drawing(out, img, r, np.zeros(len(r["bboxes"]), np.int64))


def test_infer_wedetect_ref_visualize_writes_drawing(tmp_path, monkeypatch,
                                                     capsys):
    """Scoring with --visualize: the kept box drawn with the query as its
    caption (the checkpoint loader stubbed with the miniature random
    Ref, which --random-init refuses for scoring)."""
    from wedetect_tpu_torch.cli import _ref_load
    from wedetect_tpu_torch.cli import infer_wedetect_ref as cli

    monkeypatch.setattr(_ref_load, "load_ref",
                        lambda ckpt, device="cuda":
                        _ref_load.tiny_random_ref(device))
    path, img = _image(tmp_path)
    out = str(tmp_path / "ref.png")
    r = cli.main(["--image", path, "--query", "a dog", "--ref_checkpoint",
                  "stub", "--device", "cpu", "--num_proposals", "5",
                  "--visualize", "--output", out])
    assert f"saved {out}" in capsys.readouterr().out
    assert len(r["boxes"]) == 1
    _check_drawing(out, img, {"bboxes": r["boxes"], "scores": r["scores"]},
                   np.zeros(1, np.int64), class_names=["a dog"])
