"""The port's grounding evaluation (`eval/merge.py`, `eval/rec.py`,
`eval/grounding_metrics.py`, `data/d3.py`, `eval/grounding_data.py`,
`data/loader.image_size` and `cli/eval_grounding.py`) against the JAX
package on the CPU.

Merges are held bitwise, metrics exactly, item lists equal; score_items
through both of its branches equals JAX's on a stub scorer and, on the
rec-batch branch, on the real scorers of both packages (scores at f32
atol 1e-5, rtol 1e-4, as test_torch_ref_multi.py holds them). The CLI
runs end to end on the CPU with a random miniature Ref.
"""

import argparse
import json
import pickle

import numpy as np
import pytest
import torch

from torch_ref_util import (FakeTok, cfgs, jax_params, one_torch_thread,
                            port_model)  # noqa: F401
from wedetect_tpu.cli import eval_grounding as J
from wedetect_tpu.data.d3 import D3 as JD3
from wedetect_tpu.eval import grounding_data as jgd
from wedetect_tpu.eval import grounding_metrics as jgm
from wedetect_tpu.eval import merge as jmerge
from wedetect_tpu.eval import rec as jrec
from wedetect_tpu.models.ref_api import RefScorer as JRefScorer
from wedetect_tpu_torch.cli import eval_grounding as T
from wedetect_tpu_torch.data.d3 import D3
from wedetect_tpu_torch.data.loader import image_size
from wedetect_tpu_torch.eval import grounding_data as tgd
from wedetect_tpu_torch.eval import grounding_metrics as tgm
from wedetect_tpu_torch.eval import merge as tmerge
from wedetect_tpu_torch.eval import rec as trec
from wedetect_tpu_torch.models.ref_api import RefScorer

cv2 = pytest.importorskip("cv2")


def _equal(a, b):
    """Nested results equal exactly (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, (np.ndarray, np.generic, float, int)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b


def _boxes(rng, n, side=100.0):
    xy = rng.uniform(0, side, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(2, side / 3, (n, 2))], 1)


# ----------------------------------------------------------- merge


@pytest.mark.parametrize("kw", [
    dict(), dict(num_select=7), dict(score_thre=0.6), dict(nms=True),
    dict(nms=True, score_thre=0.3), dict(single_box=True),
    dict(single_box=True, nms=True), dict(nms=True, nms_iou=0.3,
                                          num_select=2000)])
@pytest.mark.parametrize("q,n", [(3, 20), (4, 300)])
def test_merge_predictions_bitwise(kw, q, n):
    """Every merge flag, and the 1000 cap (4 x 300 candidates)."""
    rng = np.random.default_rng(q * n)
    props = _boxes(rng, n)
    props[n // 2:n // 2 + 5] = props[0] + rng.uniform(0, 1, (5, 4))
    scores = rng.uniform(0, 1, (q, n))
    scores[0, :3] = 0.5                      # ties
    _equal(tmerge.merge_predictions(scores, props, **kw),
           jmerge.merge_predictions(scores, props, **kw))


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_nms_bitwise(thr):
    rng = np.random.default_rng(int(thr * 10))
    boxes = _boxes(rng, 60, 50.0)
    scores = rng.uniform(0, 1, 60).round(2)   # ties
    labels = rng.integers(0, 4, 60)
    _equal(tmerge.nms_numpy(boxes, scores, thr),
           jmerge.nms_numpy(boxes, scores, thr))
    _equal(tmerge.batched_nms_numpy(boxes, scores, labels, thr),
           jmerge.batched_nms_numpy(boxes, scores, labels, thr))
    _equal(tmerge.batched_nms_numpy(boxes[:0], scores[:0], labels[:0], thr),
           jmerge.batched_nms_numpy(boxes[:0], scores[:0], labels[:0], thr))


# ---------------------------------------------------------- metrics


def test_rec_metrics_exact():
    rng = np.random.default_rng(1)
    gts = [_boxes(rng, int(rng.integers(0, 3))) for _ in range(40)]
    preds = [np.concatenate([g + rng.uniform(-4, 4, g.shape),
                             _boxes(rng, 12)])[rng.permutation(len(g) + 12)]
             for g in gts]
    preds[3] = np.zeros((0, 4))
    for topk in ((1, 5, 10), (2, 3)):
        _equal(trec.rec_topk_accuracy(preds, gts, topk),
               jrec.rec_topk_accuracy(preds, gts, topk))
    scores = rng.uniform(0, 1, 30).round(1)
    props = _boxes(rng, 30)
    _equal(trec.score_and_rank(props, scores, 7),
           jrec.score_and_rank(props, scores, 7))


def test_grounding_metrics_exact():
    rng = np.random.default_rng(2)
    gref, human = [], []
    for i in range(30):
        gt = _boxes(rng, int(rng.integers(0, 4)))
        pred = np.concatenate([gt[:int(rng.integers(0, len(gt) + 1))]
                               + rng.uniform(-5, 5, (1, 4)),
                               _boxes(rng, int(rng.integers(0, 3)))])
        gref.append(dict(pred_boxes=pred, gt_boxes=gt,
                         no_target=len(gt) == 0))
        human.append(dict(pred_boxes=pred, gt_boxes=gt,
                          total_persons=len(gt) + int(rng.integers(0, 4)),
                          rejection=len(gt) == 0))
    for thr in (0.5, 0.3):
        _equal(tgm.grefcoco_metrics(gref, iou_thr=thr),
               jgm.grefcoco_metrics(gref, iou_thr=thr))
        _equal(tgm.humanref_density_f1(human, iou_thr=thr),
               jgm.humanref_density_f1(human, iou_thr=thr))
    names = {i: " ".join(["w"] * (1 + i)) for i in range(12)}
    aps = {i: float(rng.uniform()) for i in range(14)}
    aps[5] = float("nan")
    _equal(tgm.dod_length_breakdown(aps, names),
           jgm.dod_length_breakdown(aps, names))


# --------------------------------------------------------- builders


@pytest.fixture
def coco_json(tmp_path):
    data = {
        "images": [{"id": 1, "file_name": "a.jpg", "width": 100,
                    "height": 80},
                   {"id": 2, "file_name": "b.jpg", "width": 60,
                    "height": 60},
                   {"id": 3, "file_name": "c.jpg"}],
        "annotations": [
            {"id": 10, "image_id": 1, "category_id": 7,
             "bbox": [10, 10, 95, 20], "area": 400, "iscrowd": 0},
            {"id": 11, "image_id": 1, "category_id": 9,
             "bbox": [5, 5, 10, 10], "area": 100, "iscrowd": 1},
            {"id": 12, "image_id": 2, "category_id": 9,
             "bbox": [0, 0, 30, 30], "area": 900, "iscrowd": 0},
            {"id": 13, "image_id": 2, "category_id": 7,
             "bbox": [1, 1, 3, 3], "area": 9, "ignore": True},
            {"id": 14, "image_id": 3, "category_id": 9,
             "bbox": [2, 2, 8, 8], "area": 64, "iscrowd": 0},
        ],
        "categories": [{"id": 9, "name": "dog"},
                       {"id": 7, "name": "cat"}],
    }
    p = tmp_path / "coco.json"
    p.write_text(json.dumps(data))
    return str(p)


def test_build_coco_and_odinw(coco_json):
    for classes in (None, ["a cat", "a dog"]):
        _equal(tgd.build_coco(coco_json, "/imgs", classes),
               jgd.build_coco(coco_json, "/imgs", classes))
    spec = {"x": {"ann_path": coco_json, "img_path": "/x"},
            "y": {"ann_path": coco_json, "img_path": "/y",
                  "classes_en": ["c1", "c2"]}}
    _equal(tgd.build_odinw(spec), jgd.build_odinw(spec))


def test_build_refcoco_grefcoco_humanref(tmp_path):
    ref = [{"id": 5 + i, "image": f"x{i}.jpg",
            "conversations": [{"value": "q"}, {"value": f"red mug {i}"}],
            "bounding_boxes": [[1, 2, 3 + i, 4]]} for i in range(3)]
    paths = []
    for name in ("refcoco_val.json", "refcoco+_testA.json"):
        (tmp_path / name).write_text(json.dumps(ref))
        paths.append(str(tmp_path / name))
    _equal(tgd.build_refcoco(paths, "/imgs"),
           jgd.build_refcoco(paths, "/imgs"))

    gref = {"images": [{"id": 1, "file_name": "a.jpg", "width": 50,
                        "height": 50, "caption": "two dogs"},
                       {"id": 2, "file_name": "b.jpg", "width": 50,
                        "height": 50, "caption": "nothing"}],
            "annotations": [{"id": 1, "image_id": 1, "category_id": 1,
                             "bbox": [0, 0, 60, 10]},
                            {"id": 2, "image_id": 2, "category_id": -1,
                             "bbox": [0, 0, 0, 0]}],
            "categories": [{"id": 1, "name": "x"}]}
    (tmp_path / "g.json").write_text(json.dumps(gref))
    g = [str(tmp_path / "g.json")] * 2
    _equal(tgd.build_grefcoco(g, "/imgs", subsets=("val", "testA")),
           jgd.build_grefcoco(g, "/imgs", subsets=("val", "testA")))

    lines = [{"id": 1, "image_name": "h.jpg", "referring": "tall person",
              "answer_boxes": [[0, 0, 5, 5]],
              "candidate_boxes": [[0, 0, 5, 5], [6, 6, 9, 9]],
              "domain": "attribute"},
             {"id": 2, "image_name": "h2.jpg", "referring": "a unicorn",
              "answer_boxes": [], "candidate_boxes": [[1, 1, 2, 2]],
              "domain": "rejection"}]
    (tmp_path / "h.jsonl").write_text("\n".join(json.dumps(x)
                                                for x in lines))
    _equal(tgd.build_humanref(str(tmp_path / "h.jsonl"), "/imgs"),
           jgd.build_humanref(str(tmp_path / "h.jsonl"), "/imgs"))


@pytest.fixture
def d3_pkls(tmp_path):
    imgs = {2: {"id": 2, "file_name": "d3_0002.jpg"},
            1: {"id": 1, "file_name": "d3_0001.jpg"},
            3: {"id": 3, "file_name": "d3_0003.jpg"}}
    groups = {100: {"id": 100, "img_ids": [1], "sent_ids": [8, 7]},
              101: {"id": 101, "image_ids": [2, 3],
                    "inner_sent_ids": [8]}}
    sents = {7: {"id": 7, "raw_sent": "a red fire hydrant"},
             8: {"id": 8, "raw_sent": "dog lying on the warm sandy "
                                      "beach next to the sea"}}
    annos = {50: {"id": 50, "image_id": 1, "bbox": [0, 0, 10, 10],
                  "sent_ids": [7]}}
    root = tmp_path / "pkl"
    root.mkdir()
    for name, obj in [("d3_imgs_info.pkl", imgs),
                      ("d3_groups_info.pkl", groups),
                      ("d3_sents.pkl", sents),
                      ("d3_annos.pkl", annos)]:
        with open(root / name, "wb") as f:
            pickle.dump(obj, f)
    return str(root)


def test_d3_reader_and_builder(d3_pkls, tmp_path):
    t, j = D3("/imgs", d3_pkls), JD3("/imgs", d3_pkls)
    _equal(t.get_img_ids(), j.get_img_ids())
    _equal(t.load_imgs(2), j.load_imgs(2))
    for ids in (None, [1], [3], [2, 3]):
        _equal(t.get_group_ids(img_ids=ids), j.get_group_ids(img_ids=ids))
    for gids in (None, [100], [101, 100]):
        _equal(t.get_sent_ids(group_ids=gids),
               j.get_sent_ids(group_ids=gids))
    _equal(t.load_sents(), j.load_sents())
    _equal(tgd.build_d3("/imgs", d3_pkls), jgd.build_d3("/imgs", d3_pkls))
    with pytest.raises(FileNotFoundError):
        D3("/imgs", str(tmp_path))


# ---------------------------------------------------- header reads


@pytest.mark.parametrize("ext,params", [
    (".jpg", ()), (".jpeg", (cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
    (".png", ()), (".bmp", ()), (".tiff", ())])
def test_image_size_matches_pil(tmp_path, ext, params):
    """Header reads give Pillow's size (the JAX package's reader); a
    format without a parsed header (TIFF) is decoded."""
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 255, (37, 53, 3), np.uint8)
    path = str(tmp_path / f"a{ext}")
    cv2.imwrite(path, img, list(params))
    with Image.open(path) as im:
        assert image_size(path) == im.size == (53, 37)


def test_image_size_gif_and_exif(tmp_path):
    """GIF headers, and a JPEG whose APP1 segment comes before the frame
    header."""
    from PIL import Image

    img = np.random.default_rng(1).integers(0, 255, (21, 34, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / "a.gif")
    exif = Image.Exif()
    exif[0x0112] = 6                        # rotated: PIL keeps the raw size
    Image.fromarray(img).save(tmp_path / "e.jpg", exif=exif)
    for name in ("a.gif", "e.jpg"):
        with Image.open(tmp_path / name) as im:
            assert image_size(str(tmp_path / name)) == im.size == (34, 21)


# ------------------------------------------------------ score_items


def _write_items(root, sizes, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for i, (h, w) in enumerate(sizes):
        name = f"im{i}.png"
        cv2.imwrite(str(root / name),
                    rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        p = rng.uniform(0, min(h, w) - 8, (2 + i % 3, 4))
        p[:, 2:] += p[:, :2] + 6
        items.append({"id": i, "dataset": "refcoco", "image": name,
                      "img_root": str(root), "queries": [f"thing {i}"],
                      "query_labels": [0], "gt_bboxes": [p[0].tolist()],
                      "gt_labels": ["x"], "proposals": p.tolist()})
    return items


class StubScorer:
    """Deterministic scores from the image and the query (JAX's
    test_grounding_eval stub), recording which entry point ran."""

    prefix_sharing = True
    query_batch = 2

    def __init__(self, grid_buckets=((32, 32),)):
        self.grid_buckets = grid_buckets
        self.calls = []

    def _scores(self, img, props, q):
        r = np.random.default_rng(len(q) + int(img.sum()) % 97)
        return r.uniform(0.01, 0.99, len(props))

    def score(self, img, props, queries, pad_token_id=0):
        self.calls.append("score")
        return np.stack([self._scores(img, props, q) for q in queries])

    def score_rec(self, samples, pad_token_id=0):
        self.calls.append("score_rec")
        return [self._scores(im, pr, q) for im, pr, q in samples]


def _args(**kw):
    ns = argparse.Namespace(ann=[], img_root="", proposals="", pkl_root="",
                            odinw_spec="", num_select=300, num_proposals=100,
                            nms=False, score_thre=-1.0, single_box=False)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("buckets", [((32, 32),), None])
@pytest.mark.parametrize("kw", [dict(single_box=True, num_select=5),
                                dict(nms=True, num_select=3)])
def test_score_items_stub_matches_jax(tmp_path, buckets, kw):
    """Both branches (rec-batch with grid buckets, per item without) give
    JAX's results; the rec-batch branch calls only score_rec."""
    items = _write_items(tmp_path, [(40, 50), (50, 40), (41, 52), (30, 30),
                                    (42, 48)])
    t, j = StubScorer(buckets), StubScorer(buckets)
    timings = {}
    got = T.score_items(items, t, {}, _args(**kw), timings=timings)
    want = J.score_items(items, j, {}, _args(**kw))
    _equal(got, want)
    assert t.calls == j.calls
    assert set(t.calls) == ({"score_rec"} if buckets else {"score"})
    assert set(timings) == set(T.TIMING_KEYS) - {"metrics_ms"} - (
        set() if buckets else {"header_ms"})


def test_score_items_real_scorers_match_jax(tmp_path):
    """The rec-batch branch with the real scorers of both packages (same
    weights, two grid buckets, a padded chunk): equal boxes and labels,
    scores within the f32 limit."""
    jcfg, tcfg = cfgs()
    params = jax_params(jcfg)
    items = _write_items(tmp_path, [(30, 50), (50, 30), (31, 47), (29, 51),
                                    (52, 33)], seed=3)
    common = dict(tokenizer=FakeTok(), query_batch=2, max_proposals=4,
                  grid_buckets=((32, 48), (48, 32)))
    args = _args(single_box=True, num_select=3, pad_token_id=0)

    class JScorer(JRefScorer):
        # JAX's score_items passes no pad id: pad with an id in the tiny
        # vocabulary, as the port's does through args.pad_token_id
        def score_rec(self, samples, pad_token_id=0):
            return super().score_rec(samples, pad_token_id=0)

    want = J.score_items(items, JScorer(cfg=jcfg, params=params, **common),
                         {}, args)
    got = T.score_items(items, RefScorer(cfg=tcfg, model=port_model(
        params, tcfg), device="cpu", **common), {}, args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5,
                                   rtol=1e-4)


# ------------------------------------------------------ run_metrics


def _results(rng, items):
    out = []
    for it in items:
        gt = np.asarray(it["gt_bboxes"], np.float64).reshape(-1, 4)
        n = int(rng.integers(0, 4))
        boxes = np.concatenate([gt[:1] + rng.uniform(-2, 2, (min(1, len(gt)),
                                                              4)),
                                _boxes(rng, n)])
        labels = rng.choice(np.asarray(it["query_labels"]), len(boxes))
        out.append({"id": it["id"], "dataset": it["dataset"],
                    "boxes": boxes, "labels": labels,
                    "scores": rng.uniform(0, 1, len(boxes)),
                    "gt_bboxes": it["gt_bboxes"],
                    "gt_labels": it["gt_labels"],
                    "no_target": it.get("no_target", False),
                    "rejection": it.get("rejection", False),
                    "total_persons": it.get("total_persons", 0)})
    return out


def test_run_metrics_match_jax(tmp_path, coco_json, d3_pkls):
    rng = np.random.default_rng(5)
    ref = [{"id": i, "image": "x.jpg",
            "conversations": [{"value": "q"}, {"value": "mug"}],
            "bounding_boxes": [_boxes(rng, 1)[0].tolist()]}
           for i in range(12)]
    for name in ("refcoco_val", "refcocog_test"):
        (tmp_path / f"{name}.json").write_text(json.dumps(ref))
    refs = [str(tmp_path / f"{n}.json") for n in ("refcoco_val",
                                                  "refcocog_test")]
    gimgs = [{"id": i, "file_name": "a.jpg", "width": 200, "height": 200,
              "caption": "c"} for i in range(10)]
    ganns = [{"id": i, "image_id": i, "category_id": -1 if i % 4 == 0 else 1,
              "bbox": _boxes(rng, 1)[0].tolist()} for i in range(10)]
    (tmp_path / "g.json").write_text(json.dumps(
        {"images": gimgs, "annotations": ganns,
         "categories": [{"id": 1, "name": "x"}]}))
    hlines = [{"id": i, "image_name": "h.jpg", "referring": "p",
               "answer_boxes": _boxes(rng, i % 3).tolist(),
               "candidate_boxes": _boxes(rng, 4).tolist(),
               "domain": "rejection" if i % 3 == 0 else "attribute"}
              for i in range(9)]
    (tmp_path / "h.jsonl").write_text("\n".join(json.dumps(x)
                                                for x in hlines))
    d3_ann = {"images": [{"id": i, "file_name": f"d3_000{i}.jpg",
                          "width": 200, "height": 200} for i in (1, 2, 3)],
              "annotations": [{"id": k, "image_id": 1 + k % 3,
                               "category_id": 7 + k % 2,
                               "bbox": [5.0 * k, 5, 30, 30], "area": 900,
                               "iscrowd": 0} for k in range(6)],
              "categories": [{"id": 7, "name": "a red fire hydrant"},
                             {"id": 8, "name": "dog lying on the warm "
                              "sandy beach next to the sea"}]}
    (tmp_path / "d3.json").write_text(json.dumps(d3_ann))
    spec = {"x": {"ann_path": coco_json, "img_path": "/x"},
            "y": {"ann_path": coco_json, "img_path": "/y"}}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    cases = [
        ("refcoco", jgd.build_refcoco(refs, "/i"), _args()),
        ("coco", jgd.build_coco(coco_json, "/i"), _args(ann=[coco_json])),
        ("grefcoco", jgd.build_grefcoco([str(tmp_path / "g.json")], "/i",
                                        subsets=("val",)),
         _args(ann=[str(tmp_path / "g.json")])),
        ("humanref", jgd.build_humanref(str(tmp_path / "h.jsonl"), "/i"),
         _args()),
        ("d3", jgd.build_d3("/i", d3_pkls),
         _args(ann=[str(tmp_path / "d3.json")] * 3)),
        ("odinw", jgd.build_odinw(spec),
         _args(odinw_spec=str(tmp_path / "spec.json")))]
    for dataset, items, args in cases:
        if dataset == "d3":   # score against the COCO-format d3 file
            for it in items:
                it["gt_bboxes"] = []
        results = _results(rng, items)
        got = T.run_metrics(dataset, results, args)
        _equal(got, J.run_metrics(dataset, results, args))
        assert got


# -------------------------------------------------------------- CLI


def _refcoco_set(root, n=5):
    rng = np.random.default_rng(7)
    anns, props = [], {}
    for i in range(n):
        h, w = (96, 128) if i % 2 else (128, 96)
        name = f"r{i}.jpg"
        cv2.imwrite(str(root / name),
                    rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        b = _boxes(rng, 6, 80.0)
        props[name] = b.tolist()
        anns.append({"id": i, "image": name,
                     "conversations": [{"value": "q"},
                                       {"value": f"the thing {i}"}],
                     "bounding_boxes": [b[i % 6].tolist()]})
    (root / "refcoco_val.json").write_text(json.dumps(anns))
    (root / "props.json").write_text(json.dumps(props))
    return str(root / "refcoco_val.json"), str(root / "props.json")


def test_cli_random_init_on_cpu(tmp_path):
    """cli/eval_grounding end to end on the CPU: a refcoco-format set
    through the rec-batch branch (two buckets, padded chunks) and the
    per-item branch; their proposals' scores agree."""
    ann, props = _refcoco_set(tmp_path)
    common = ["--random-init", "--device", "cpu", "--dataset", "refcoco",
              "--ann", ann, "--img-root", str(tmp_path), "--proposals",
              props, "--num_select", "3", "--batch-queries", "2"]
    timings = {}
    out = T.main(common + ["--grid-tokens", "16", "--out",
                           str(tmp_path / "m.json")], timings=timings)
    acc = out["refcoco_val"]
    assert set(acc) == {"acc@1", "acc@5", "acc@10"}
    assert all(0.0 <= v <= 1.0 for v in acc.values())
    assert json.loads((tmp_path / "m.json").read_text()) == out
    assert timings["items"] == 5 and timings["score_ms"] > 0
    assert set(T.TIMING_KEYS) <= set(timings)


def test_cli_rec_batch_equals_per_item(tmp_path):
    """The scorer the CLI builds: score_rec across images equals score()
    image by image on the same buckets."""
    ann, props = _refcoco_set(tmp_path)
    scorer, pad = T.load_scorer("", 2, 16, random_init=True, device="cpu")
    items = T.build_items(_args(dataset="refcoco", ann=[ann],
                                img_root=str(tmp_path)))
    pmap = json.loads(open(props).read())
    rec = T.score_items(items, scorer, pmap, _args(pad_token_id=pad))
    per = RefScorer(cfg=scorer.cfg, model=scorer.model,
                    tokenizer=scorer.tokenizer, query_batch=2,
                    grid_buckets=scorer.grid_buckets, prefix_sharing=False,
                    device="cpu")
    per_item = T.score_items(items, per, pmap, _args(pad_token_id=pad))
    for a, b in zip(rec, per_item):
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("pad,want", [(0, 0), (None, 151643), (7, 7)])
def test_load_scorer_pad_id(monkeypatch, pad, want):
    """load_scorer returns the tokenizer's own pad id, 0 included; Qwen's
    151643 only where the tokenizer has none."""
    from wedetect_tpu_torch.cli import _ref_load

    with pytest.raises(ValueError, match="tiny or 2b"):
        _ref_load.random_ref("7b", "cpu")
    cfg, model, tok = _ref_load.tiny_random_ref("cpu")
    tok.pad_token_id = pad
    monkeypatch.setattr(_ref_load, "random_ref",
                        lambda size, device: (cfg, model, tok))
    _, got = T.load_scorer("", 2, random_init=True, device="cpu")
    assert got == want


def test_cli_coco_and_no_card(tmp_path, monkeypatch, coco_json):
    """--dataset coco (every class name a query) on the CPU; without
    --device cpu the CLI raises where no card is present."""
    rng = np.random.default_rng(9)
    for name in ("a.jpg", "b.jpg", "c.jpg"):
        cv2.imwrite(str(tmp_path / name),
                    rng.integers(0, 255, (80, 100, 3), dtype=np.uint8))
    props = {n: _boxes(rng, 5, 60.0).tolist()
             for n in ("a.jpg", "b.jpg", "c.jpg")}
    (tmp_path / "p.json").write_text(json.dumps(props))
    argv = ["--random-init", "--dataset", "coco", "--ann", coco_json,
            "--img-root", str(tmp_path), "--proposals",
            str(tmp_path / "p.json"), "--max-items", "2"]
    out = T.main(argv + ["--device", "cpu"])
    assert set(out) == {"coco"} and "mAP" in out["coco"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        T.main(argv)
