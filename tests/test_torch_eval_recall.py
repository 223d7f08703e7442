"""The port's proposal recall, object retrieval and retrieval class
tables against the JAX package's (the same numpy, so exactly equal),
and its two CLIs, cli/eval_recall.py and cli/extract_embedding.py, on
the CPU at WeDetect-Uni tiny with random weights on
tests/test_eval_pipeline.py's PNG fixture.
"""

import json
import pickle

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_eval_pipeline import coco_dir  # noqa: E402,F401
from wedetect_tpu.data import retrieval_classes as jclasses  # noqa: E402
from wedetect_tpu.eval import recall as jrecall  # noqa: E402
from wedetect_tpu.eval import retrieval as jretrieval  # noqa: E402
from wedetect_tpu_torch.data import retrieval_classes as tclasses  # noqa: E402,E501
from wedetect_tpu_torch.eval import recall as trecall  # noqa: E402
from wedetect_tpu_torch.eval import retrieval as tretrieval  # noqa: E402


def boxes(rng, n, size=200.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(4, size / 2, (n, 2))
    return np.concatenate([xy, xy + wh], -1)


def recall_inputs(seed):
    """Per-image gts and proposals: jittered gt copies among random
    boxes, scored (5 columns, unsorted) or not (4), empty images of
    either kind, integer boxes (exact IoU ties) in every third image."""
    rng = np.random.default_rng(seed)
    gts, props = [], []
    for i in range(12):
        g = boxes(rng, int(rng.integers(0, 7)))
        p = np.concatenate([g + rng.normal(0, 6, g.shape),
                            boxes(rng, int(rng.integers(0, 400)))])
        if i % 3 == 0:
            g, p = np.round(g), np.round(p)
        if i % 2:
            p = np.concatenate([p, rng.uniform(0, 1, (len(p), 1))], -1)
        if i == 5:
            p = p[:0]
        gts.append(None if i == 7 else g)
        props.append(p)
    return gts, props


@pytest.mark.parametrize("seed", range(4))
def test_recall_equals_jax(seed):
    gts, props = recall_inputs(seed)
    for nums, thrs in (((100, 300), None), ((1, 10, 1000), [0.3, 0.5, 0.7])):
        got = trecall.eval_recalls(gts, props, nums, thrs)
        want = jrecall.eval_recalls(gts, props, nums, thrs)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.max() <= 1
        assert (trecall.summarize_recalls(got, nums)
                == jrecall.summarize_recalls(want, nums))
    ious = np.random.default_rng(seed).uniform(0, 1, (6, 9)).astype(
        np.float32)
    np.testing.assert_array_equal(trecall._greedy_gt_ious(ious),
                                  jrecall._greedy_gt_ious(ious))


@pytest.mark.parametrize("seed", range(3))
def test_retrieval_equals_jax(seed):
    rng = np.random.default_rng(seed)
    k, c = 6, 16
    names = [f"class{i}" for i in range(k)]
    text = rng.standard_normal((k, c)).astype(np.float32)
    results = []
    for img in range(10):
        p = int(rng.integers(0, 30))
        results.append({"image_id": 100 + img,
                        "embeddings": rng.standard_normal((p, c)).astype(
                            np.float32) * 0.3,
                        "scale": rng.normal(0, 0.5, p).astype(np.float32),
                        "bias": rng.normal(-2, 1, p).astype(np.float32)})
        np.testing.assert_array_equal(
            tretrieval.score_image(results[-1]["embeddings"], text,
                                   results[-1]["scale"], results[-1]["bias"]),
            jretrieval.score_image(results[-1]["embeddings"], text,
                                   results[-1]["scale"], results[-1]["bias"]))
    gt = {n: {100 + int(i) for i in rng.choice(10, int(rng.integers(0, 6)),
                                               replace=False)}
          for n in names}
    for thr in (0.2, 0.5):
        got = tretrieval.retrieval_metrics(results, text, names, gt, thr)
        want = jretrieval.retrieval_metrics(results, text, names, gt, thr)
        assert got == want
        assert "macro" in got


def test_retrieval_classes_equal_jax():
    with open(tclasses.__file__.replace(".py", ".json"),
              encoding="utf-8") as f:
        port = json.load(f)
    with open(jclasses.__file__.replace(".py", ".json"),
              encoding="utf-8") as f:
        assert port == json.load(f)
    for class_set, n in (("coco", 80), ("lvis", 1203)):
        for lang in ("zh", "en"):
            got = tclasses.load_retrieval_classes(class_set, lang)
            assert got == jclasses.load_retrieval_classes(class_set, lang)
            assert len(got) == n
    with pytest.raises(KeyError, match="class set"):
        tclasses.load_retrieval_classes("voc")
    with pytest.raises(KeyError, match="language"):
        tclasses.load_retrieval_classes("coco", "fr")


def _cli_args(coco_dir, *extra):  # noqa: F811
    return ["--ann", str(coco_dir / "ann.json"), "--img-root",
            str(coco_dir), "--random-init", "--size", "tiny",
            "--max-images", "2", "--batch-size", "2", *extra]


def test_cli_eval_recall_on_cpu(coco_dir, tmp_path):  # noqa: F811
    from wedetect_tpu_torch.cli import eval_recall

    out = tmp_path / "recall.json"
    summary = eval_recall.main(_cli_args(coco_dir, "--device", "cpu",
                                         "--out", str(out)))
    assert set(summary) == {"AR@100", "AR@300"}     # JAX's keys
    assert all(0.0 <= v <= 1.0 for v in summary.values())
    assert json.loads(out.read_text()) == summary


def test_cli_extract_embedding_on_cpu(coco_dir, tmp_path):  # noqa: F811
    from wedetect_tpu_torch.cli import extract_embedding

    out = tmp_path / "emb.pkl"
    extract_embedding.main(_cli_args(coco_dir, "--device", "cpu",
                                     "--class-set", "coco", "--out",
                                     str(out)))
    payload = pickle.loads(out.read_bytes())
    assert set(payload) == {"image_embedding", "text_embedding",
                            "classnames"}
    assert payload["classnames"] == jclasses.load_retrieval_classes("coco")
    assert payload["text_embedding"].shape == (80, 768)
    recs = payload["image_embedding"]
    assert [r["image_id"] for r in recs] == [1, 2]
    for r in recs:
        assert set(r) == {"image_id", "embedding", "scale", "bias",
                          "scores", "bboxes"}
        n = len(r["scores"])
        assert n > 0 and r["embedding"].shape == (n, 768)
        assert r["scale"].shape == r["bias"].shape == (n,)
        assert r["bboxes"].shape == (n, 4)
    # the records score offline through the port's retrieval metric
    metrics = tretrieval.retrieval_metrics(
        [{"image_id": r["image_id"], "embeddings": r["embedding"],
          "scale": r["scale"], "bias": r["bias"]} for r in recs],
        payload["text_embedding"], payload["classnames"],
        {payload["classnames"][0]: {1}})
    assert set(metrics) == {payload["classnames"][0], "macro"}


@pytest.mark.parametrize("cli", ["eval_recall", "extract_embedding"])
def test_cli_needs_device_flag_without_card(coco_dir, tmp_path, monkeypatch,
                                            cli):  # noqa: F811
    import importlib

    mod = importlib.import_module(f"wedetect_tpu_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(_cli_args(coco_dir, "--out", str(tmp_path / "x")))
