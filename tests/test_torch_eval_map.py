"""The port's COCO and LVIS evaluators and its native matcher against the
JAX package's, on the randomized scenes of the differential tests
(ties, integer boxes, crowds, duplicates, empty images, a per-image
and a dataset-wide cap that bind, neg and not-exhaustive domains, r/c/f
frequencies).

The metric dicts must be exactly equal: both packages run the same
numpy f64 arithmetic in the same order, and the matchers only compare.
Against the independent oracles (tests/coco_oracle.py,
tests/lvis_oracle.py) the limit is the differential tests' 1e-7. The
native matcher is held bitwise (dtm, gtm) to its plain Python version.
"""

import math

import numpy as np
import pytest
from coco_oracle import CocoOracle
from lvis_oracle import LvisOracle
from test_coco_differential import make_scene
from test_lvis_differential import make_lvis_scene

from wedetect_tpu.eval.coco_map import CocoEvaluator as JCoco
from wedetect_tpu.eval.lvis_map import LvisEvaluator as JLvis
from wedetect_tpu_torch import native
from wedetect_tpu_torch.eval.coco_map import (AREA_RNG, IOU_THRS,
                                              CocoEvaluator, box_iou_xyxy,
                                              coco_match_python)
from wedetect_tpu_torch.eval.lvis_map import LvisEvaluator

KEYS = ("mAP", "AP50", "AP75", "APs", "APm", "APl", "APr", "APc", "APf")


def same(a, b) -> bool:
    return (math.isnan(a) and math.isnan(b)) or a == b


def assert_metrics_equal(got, want):
    """Exactly equal metric dicts (NaN where the other has NaN)."""
    assert set(got) == set(want)
    for k in got:
        if k == "per_class":
            assert set(got[k]) == set(want[k])
            for c in got[k]:
                assert same(got[k][c], want[k][c]), (c, got[k][c],
                                                     want[k][c])
        else:
            assert same(got[k], want[k]), (k, got[k], want[k])


def assert_metrics_close(got, want, tol=1e-7):
    for k in KEYS:
        g, w = got.get(k, math.nan), want.get(k, math.nan)
        assert (math.isnan(g) and math.isnan(w)) or abs(g - w) < tol, k
    assert set(got["per_class"]) == set(want["per_class"])
    for c, g in got["per_class"].items():
        w = want["per_class"][c]
        assert (math.isnan(g) and math.isnan(w)) or abs(g - w) < tol, c


def coco_scenes(seed, n_images=9, n_classes=4):
    """The differential test's dataset: scenes with the last image
    holding no detection, the one before no gt, the third from last
    only crowds."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_images):
        gtb, gtl, gtc, gta, dtb, dts, dtl = make_scene(
            rng, n_classes, ties=bool(seed % 2), ints=bool((seed // 2) % 2))
        if i == n_images - 1:
            dtb, dts, dtl = (np.zeros((0, 4)), np.zeros(0),
                             np.zeros(0, np.int64))
        if i == n_images - 2:
            gtb, gtl, gtc, gta = (np.zeros((0, 4)), np.zeros(0, np.int64),
                                  np.zeros(0, bool), np.zeros(0))
        if i == n_images - 3 and len(gtc):
            gtc[:] = True
        out.append(({"boxes": gtb, "labels": gtl, "iscrowd": gtc,
                     "areas": gta}, dtb, dts, dtl))
    return out


def lvis_scenes(seed, n_images=10, n_classes=5):
    """The LVIS differential test's dataset and its frequencies."""
    rng = np.random.default_rng(seed)
    freqs = {c: ("r", "c", "f")[int(rng.integers(0, 3))]
             for c in range(n_classes)}
    out = []
    for i in range(n_images):
        gtb, gtl, gta, dtb, dts, dtl, neg, nexh = make_lvis_scene(
            rng, n_classes, ties=bool(seed % 2))
        if i == n_images - 1:
            dtb, dts, dtl = (np.zeros((0, 4)), np.zeros(0),
                             np.zeros(0, np.int64))
        if i == n_images - 2:
            gtb, gtl, gta = (np.zeros((0, 4)), np.zeros(0, np.int64),
                             np.zeros(0))
            neg = {c for c in range(n_classes) if rng.random() < 0.5}
            nexh = set()
        out.append(({"boxes": gtb, "labels": gtl,
                     "iscrowd": np.zeros(len(gtb), bool), "areas": gta},
                    dtb, dts, dtl, neg, nexh))
    return freqs, out


@pytest.mark.parametrize("seed,max_dets", [(s, 100) for s in range(6)]
                         + [(3, 3), (11, 3)])
def test_coco_map_equals_jax(seed, max_dets):
    scenes = coco_scenes(seed)
    evs = [JCoco(range(4), max_dets=max_dets),
           CocoEvaluator(range(4), max_dets=max_dets),
           CocoEvaluator(range(4), max_dets=max_dets, matcher="python")]
    orc = CocoOracle(max_dets=max_dets)
    for gt, dtb, dts, dtl in scenes:
        for ev in evs:
            ev.add_image(gt, dtb, dts, dtl)
        orc.add_image(gt["boxes"], gt["labels"], gt["iscrowd"], gt["areas"],
                      dtb, dts, dtl)
    want, native_m, python_m = (ev.summarize() for ev in evs)
    assert_metrics_equal(native_m, want)
    assert_metrics_equal(python_m, want)
    assert_metrics_close(native_m, orc.evaluate())


@pytest.mark.parametrize("seed,cap", [(s, 10000) for s in range(0, 10, 2)]
                         + [(1003, 3), (3007, 3), (8001, 8), (8012, 8)])
def test_lvis_map_equals_jax(seed, cap):
    freqs, scenes = lvis_scenes(seed)
    evs = [JLvis(range(5), per_class_cap=cap, frequencies=freqs),
           LvisEvaluator(range(5), per_class_cap=cap, frequencies=freqs),
           LvisEvaluator(range(5), per_class_cap=cap, frequencies=freqs,
                         matcher="python")]
    orc = LvisOracle(per_class_cap=cap, frequencies=freqs)
    for gt, dtb, dts, dtl, neg, nexh in scenes:
        for ev in evs:
            ev.add_image(gt, dtb, dts, dtl, neg_cats=neg,
                         not_exhaustive=nexh)
        orc.add_image(gt["boxes"], gt["labels"], gt["areas"], dtb, dts, dtl,
                      neg_cats=neg, not_exhaustive=nexh)
    want, native_m, python_m = (ev.summarize() for ev in evs)
    assert {"APr", "APc", "APf"} <= set(native_m)
    assert_metrics_equal(native_m, want)
    assert_metrics_equal(python_m, want)
    assert_metrics_close(native_m, orc.evaluate())
    if cap < 10000:
        # the cap binds: some class has more detections than the cap
        n = np.bincount(np.concatenate([s[3] for s in scenes]), minlength=5)
        assert n.max() > cap


def match_inputs(seeds=range(8)):
    """Every (image, class, area range) matching problem of the COCO
    scenes, as _eval_img builds it: detections in score order, gts
    sorted by the range's ignore flag."""
    out = []
    for seed in seeds:
        for gt, dtb, dts, dtl in coco_scenes(seed):
            for cls in np.unique(np.concatenate([gt["labels"], dtl])):
                g, d = gt["labels"] == cls, dtl == cls
                order = np.argsort(-dts[d], kind="mergesort")
                iou_full = box_iou_xyxy(dtb[d][order], gt["boxes"][g],
                                        gt["iscrowd"][g])
                for amin, amax in AREA_RNG.values():
                    area = gt["areas"][g]
                    ig0 = gt["iscrowd"][g] | (area < amin) | (area > amax)
                    o = np.argsort(ig0, kind="mergesort")
                    if iou_full.shape[0] and len(o):
                        out.append((iou_full[:, o], ig0[o],
                                    gt["iscrowd"][g][o]))
    return out


def test_native_matcher_bitwise_python():
    """The native matcher equals its plain version on every matching
    problem of the scenes; with one IoU threshold changed (0.75 ->
    0.7), the native answers miss the plain ones somewhere."""
    problems = match_inputs()
    assert len(problems) > 200
    changed = IOU_THRS.copy()
    changed[5] = 0.7
    misses = 0
    for iou, ig, crowd in problems:
        dtm, gtm = native.coco_match(iou, ig, crowd, IOU_THRS)
        pdtm, pgtm = coco_match_python(iou, ig, crowd, IOU_THRS)
        assert dtm.dtype == pdtm.dtype == np.int64
        np.testing.assert_array_equal(dtm, pdtm)
        np.testing.assert_array_equal(gtm, pgtm)
        cdtm, cgtm = native.coco_match(iou, ig, crowd, changed)
        misses += not (np.array_equal(cdtm, pdtm)
                       and np.array_equal(cgtm, pgtm))
    assert misses > 0


def test_native_build_in_build_dir_and_failure_raises(tmp_path,
                                                      monkeypatch):
    """The library is built from the port's own coco_match.cc into
    build/native/ under a hash of source and flags; a source that does
    not compile raises with g++'s output."""
    so = native.build()
    assert so.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert native.SRC.parent.name == "native"
    assert native.SRC.parents[1].name == "wedetect_tpu_torch"
    assert "-march=native" not in native.GXX_FLAGS
    bad = tmp_path / "coco_match.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_matcher_choice():
    with pytest.raises(ValueError, match="matcher"):
        CocoEvaluator(range(2), matcher="numpy")
    assert LvisEvaluator(range(2), matcher="python").matcher == "python"
