"""The port's evaluation path against the JAX package's on the CPU: the
eval loader, the shard, `evaluate_coco` (COCO, LVIS, flip TTA) with its
dump, `detect_step_tta`, the two-process merge, and cli/test.py.

Weights: the port's seeded init with perturbed BN statistics, carried
to JAX by its own converter (`convert_detector`) and back into the port
by `ckpt/convert.from_jax_variables` (the pair is an exact round trip,
tests/test_torch_api.py::test_weight_round_trip), at mini_cfg's widths
on tests/test_eval_pipeline.py's PNG fixture (five images of 60-120
px). Detections: boxes within 1e-3 px (the networks agree to 1e-4,
boxes are scaled back by up to 1 / 0.53), scores within 1e-5, labels
and validity equal. Metrics within 1e-6; the dumps recomputed by either
package give the run's metrics exactly.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from test_eval_pipeline import coco_dir  # noqa: E402,F401
from test_torch_detector import cfgs, perturb_stats  # noqa: E402
from test_torch_eval_map import assert_metrics_equal  # noqa: E402
from wedetect_tpu.ckpt.convert import convert_detector  # noqa: E402
from wedetect_tpu.data.coco import CocoDetDataset as JDataset  # noqa: E402
from wedetect_tpu.data.loader import EvalLoader as JLoader  # noqa: E402
from wedetect_tpu.eval import dump as jdump  # noqa: E402
from wedetect_tpu.eval import runner as jrunner  # noqa: E402
from wedetect_tpu.models import wedetect as JW  # noqa: E402
from wedetect_tpu_torch.ckpt.convert import from_jax_variables  # noqa: E402
from wedetect_tpu_torch.data.coco import CocoDetDataset  # noqa: E402
from wedetect_tpu_torch.data.loader import EvalLoader  # noqa: E402
from wedetect_tpu_torch.eval import dist  # noqa: E402
from wedetect_tpu_torch.eval import dump as tdump  # noqa: E402
from wedetect_tpu_torch.eval import runner as trunner  # noqa: E402
from wedetect_tpu_torch.models import wedetect as TW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BOX_ATOL, SCORE_ATOL, METRIC_ATOL = 1e-3, 1e-5, 1e-6
# the LVIS fixture: three categories, one of each frequency group
LVIS_CATS = [{"id": 7, "name": "redbox", "frequency": "f"},
             {"id": 12, "name": "other", "frequency": "c"},
             {"id": 20, "name": "third", "frequency": "r"}]


@pytest.fixture(scope="module")
def lvis_ann(coco_dir, weights):  # noqa: F811
    """An LVIS-format file over coco_dir's images: the red box (f), and
    the port's first four detections of each image (three classes) moved
    by 0-3 px as more ground truth, so that the metrics are not all 0;
    neg_category_ids (the absent classes of images 1-3) and
    not_exhaustive_category_ids (one present class of image 3)."""
    ann = json.loads((coco_dir / "ann.json").read_text())
    ds = CocoDetDataset(str(coco_dir / "ann.json"), str(coco_dir))
    _, _, tcfg, model = models(weights, 3)
    batch = next(iter(EvalLoader(ds, tcfg.img_size, batch_size=5)))
    det = TW.detect_step(tcfg, model, batch["images"], text_embeds(3),
                         batch["scale_factor"], batch["pad_param"],
                         batch["ori_shape"])
    rng = np.random.default_rng(3)
    anns = list(ann["annotations"])
    for i, img in enumerate(ann["images"]):
        v = det.valid[i].numpy()
        boxes, labels = det.boxes[i].numpy()[v][:4], det.labels[i][v][:4]
        present = {7}
        for j, (box, label) in enumerate(zip(boxes, labels.tolist())):
            x0, y0, x1, y1 = box + rng.uniform(-3, 3, 4)
            cat = LVIS_CATS[label]["id"]
            present.add(cat)
            anns.append({"id": 100 + 10 * i + j, "image_id": img["id"],
                         "category_id": cat, "bbox": [x0, y0, x1 - x0,
                                                      y1 - y0],
                         "area": (x1 - x0) * (y1 - y0), "iscrowd": 0})
        absent = [c["id"] for c in LVIS_CATS if c["id"] not in present]
        img["neg_category_ids"] = absent if i < 3 else []
        img["not_exhaustive_category_ids"] = ([max(present)] if i == 2
                                              else [])
    path = coco_dir / "lvis.json"
    path.write_text(json.dumps({**ann, "annotations": anns,
                                "categories": LVIS_CATS}))
    return path


def ann_path(coco_dir, lvis_ann, mode):  # noqa: F811
    return str(lvis_ann if "lvis" in mode else coco_dir / "ann.json")


@pytest.fixture(scope="module")
def weights():
    """(port state dict, JAX variables) of the same seeded weights. The
    head is given a spread of box sizes (DFL biases towards the small
    bins, 3x the weights) and of class scores (logit scale e^1.5), so
    the boxes are not all clamped to the whole image and the scores
    are not all within 1e-2 of 0.5."""
    jcfg, tcfg = cfgs()
    sd = TW.init_variables(tcfg, seed=0, device="cpu").state_dict()
    g = torch.Generator().manual_seed(2)
    for i in range(3):
        reg = f"bbox_head.reg_preds.{i}.6."
        sd[reg + "bias"] = (-0.8 * (torch.arange(64) % 16).float()
                            + 0.5 * torch.randn(64, generator=g))
        sd[reg + "weight"] = sd[reg + "weight"] * 3
        sd[f"bbox_head.cls_contrasts.{i}.logit_scale"] += 2.5
    jvars = perturb_stats(convert_detector(
        {k: v.numpy() for k, v in sd.items()}, jcfg), seed=1)
    return from_jax_variables(jvars, tcfg), jvars


def models(weights, k):
    """Matching (JAX cfg, JAX variables, port cfg, port module) at K."""
    sd, jvars = weights
    jcfg, tcfg = cfgs(num_classes=k)
    model = TW.WeDetectModule(tcfg).eval()
    model.load_state_dict(sd, strict=True)
    return jcfg, jax.tree.map(jnp.asarray, jvars), tcfg, model


def text_embeds(k):
    return np.random.default_rng(1).standard_normal((k, 32)).astype(
        np.float32)


MODES = {"coco": dict(), "lvis": dict(lvis=True),
         "lvis_tta": dict(lvis=True, tta=True)}


@pytest.fixture(scope="module")
def runs(coco_dir, lvis_ann, weights, tmp_path_factory):  # noqa: F811
    """Each mode's JAX and port evaluate_coco runs, with their dumps."""
    out = {}
    tmp = tmp_path_factory.mktemp("dumps")
    for mode, kw in MODES.items():
        path = ann_path(coco_dir, lvis_ann, mode)
        jds, tds = JDataset(path, str(coco_dir)), CocoDetDataset(
            path, str(coco_dir))
        k = len(tds.class_names)
        jcfg, jvars, tcfg, model = models(weights, k)
        jd, td = str(tmp / f"jax_{mode}.npz"), str(tmp / f"torch_{mode}.npz")
        want = jrunner.evaluate_coco(jcfg, jvars, jds, text_embeds(k),
                                     batch_size=2, dump_path=jd, **kw)
        timings = {}
        got = trunner.evaluate_coco(tcfg, model, tds, text_embeds(k),
                                    batch_size=2, dump_path=td,
                                    timings=timings, **kw)
        out[mode] = dict(want=want, got=got, jd=jd, td=td, jds=jds, tds=tds,
                         timings=timings)
    return out


def assert_dets_close(got, want):
    """Per-image detections: boxes 1e-3 px, scores 1e-5, labels equal."""
    assert [r["img_id"] for r in got] == [r["img_id"] for r in want]
    for g, w in zip(got, want):
        assert len(g["scores"]) == len(w["scores"]), g["img_id"]
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=SCORE_ATOL)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=BOX_ATOL)
        np.testing.assert_allclose(g["embeds"].astype(np.float32),
                                   w["embeds"].astype(np.float32),
                                   atol=2e-3, rtol=2e-3)


def assert_metrics_close(got, want, what):
    """Metrics within 1e-6; a miss names the IoU-threshold flip it
    reveals (a detection's IoU within the box tolerance of 0.5-0.95)."""
    assert set(got) == set(want)
    for k, g in got.items():
        pairs = ([(g[c], want[k][c]) for c in g] if k == "per_class"
                 else [(g, want[k])])
        for a, b in pairs:
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= METRIC_ATOL, (
                f"{what} {k}: port {a} vs JAX {b}: detections within "
                "tolerance, so a match flipped at an IoU threshold")


@pytest.mark.parametrize("mode", list(MODES))
def test_evaluate_coco_equals_jax(runs, mode):
    r = runs[mode]
    got, want = tdump.load_detections(r["td"]), jdump.load_detections(r["jd"])
    assert sum(len(x["scores"]) for x in got) > 0
    assert_dets_close(got, want)
    assert_metrics_close(r["got"], r["want"], mode)
    keys = {"mAP", "AP50", "AP75", "APs", "APm", "APl", "per_class"}
    assert set(r["got"]) == keys | ({"APr", "APc", "APf"}
                                    if "lvis" in mode else set())
    assert r["timings"]["images"] == 5 and r["timings"]["batches"] == 3
    assert all(r["timings"][k] >= 0 for k in trunner.TIMING_KEYS)


@pytest.mark.parametrize("mode", list(MODES))
def test_dump_read_by_either_package(runs, mode):
    """Each package reads the other's .npz; recompute_metrics on a dump
    gives that run's metrics exactly, whichever package recomputes (the
    port with either matcher)."""
    r = runs[mode]
    lvis = "lvis" in mode
    for path, live in ((r["td"], r["got"]), (r["jd"], r["want"])):
        a, b = tdump.load_detections(path), jdump.load_detections(path)
        assert len(a) == len(b) == 5
        for x, y in zip(a, b):
            assert x.keys() == y.keys() and x["img_id"] == y["img_id"]
            for key in ("boxes", "scores", "labels", "embeds"):
                np.testing.assert_array_equal(x[key], y[key])
        for matcher in ("native", "python"):
            assert_metrics_equal(tdump.recompute_metrics(
                r["tds"], path, lvis, matcher=matcher), live)
        assert_metrics_equal(jdump.recompute_metrics(r["jds"], path, lvis),
                             live)


def test_dump_image_without_detections(tmp_path):
    """An image with no detection keeps (0, C) embeds in the port's dump,
    which JAX's load_detections reads back; JAX's own save_detections
    raises on such an image (reshape(0, -1), a fault of the JAX package,
    ROADMAP §3), which the port repairs."""
    rng = np.random.default_rng(0)
    recs = [{"img_id": 1, "boxes": np.zeros((0, 4), np.float32),
             "scores": np.zeros(0, np.float32),
             "labels": np.zeros(0, np.int64),
             "embeds": np.zeros((0, 8), np.float32)},
            {"img_id": 2, "boxes": rng.uniform(0, 64, (3, 4)).astype(
                np.float32), "scores": np.float32([0.9, 0.5, 0.1]),
             "labels": np.int64([0, 2, 1]),
             "embeds": rng.standard_normal((3, 8)).astype(np.float16)}]
    path = str(tmp_path / "dets.npz")
    tdump.save_detections(path, recs)
    for back in (tdump.load_detections(path), jdump.load_detections(path)):
        assert [r["embeds"].shape for r in back] == [(0, 8), (3, 8)]
        for a, b in zip(recs, back):
            for key in ("boxes", "scores", "labels", "embeds"):
                np.testing.assert_array_equal(b[key], a[key])
    tdump.save_detections(str(tmp_path / "first.npz"), recs[:1])
    assert tdump.load_detections(str(tmp_path / "first.npz"))[0][
        "embeds"].shape == (0, 8)
    with pytest.raises(ValueError, match="reshape"):
        jdump.save_detections(str(tmp_path / "jax.npz"), recs)


def test_detect_step_tta_equals_jax(coco_dir, weights):  # noqa: F811
    jcfg, jvars, tcfg, model = models(weights, 3)
    ds = CocoDetDataset(str(coco_dir / "ann.json"), str(coco_dir))
    batch = next(iter(EvalLoader(ds, tcfg.img_size, batch_size=2,
                                 indices=[1, 2])))
    args = (batch["images"], text_embeds(3), batch["scale_factor"],
            batch["pad_param"], batch["ori_shape"])
    # a left/right-asymmetric pad: the flipped view's pad is mirrored
    assert (batch["pad_param"][:, 2] != batch["pad_param"][:, 3]).any()
    # class_mask=None passed as evaluate_coco passes it: the jitted step
    # compiled by the runs fixture is reused
    want = JW.detect_step_tta(jcfg, jvars, *(jnp.asarray(a) for a in args),
                              None)
    got = TW.detect_step_tta(tcfg, model, *args)
    m = tcfg.test.tta_max_per_img
    assert got.boxes.shape == (2, m, 4) and got.embeds.shape == (2, m, 32)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 16          # more than one view's worth
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  np.asarray(want.labels)[valid])
    np.testing.assert_array_equal(got.anchors.numpy(),
                                  np.asarray(want.anchors))
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid],
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=BOX_ATOL)
    np.testing.assert_allclose(got.embeds.numpy()[valid],
                               np.asarray(want.embeds)[valid],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bs,indices", [(2, None), (3, [4, 0, 2, 3])])
def test_eval_loader_equals_jax(coco_dir, bs, indices):  # noqa: F811
    path = str(coco_dir / "ann.json")
    got = list(EvalLoader(CocoDetDataset(path, str(coco_dir)), (64, 64),
                          batch_size=bs, indices=indices))
    want = list(JLoader(JDataset(path, str(coco_dir)), (64, 64),
                        batch_size=bs, indices=indices))
    assert len(got) == len(want) > 1
    assert got[-1]["n_valid"] < bs          # the last batch is padded
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key, x in g.items():
            if isinstance(x, np.ndarray):
                assert x.dtype == w[key].dtype, key
                np.testing.assert_array_equal(x, w[key])
            else:
                assert x == w[key], key


def test_eval_loader_fast_decode_raises(coco_dir, tmp_path,  # noqa: F811
                                        monkeypatch):
    """fast_decode=True is taken (the JAX loader's batches on the PNG
    fixture), and a JPEG whose decoder cannot be built raises: no cv2
    fallback for a missing toolchain."""
    from wedetect_tpu_torch import native

    path = str(coco_dir / "ann.json")
    got = list(EvalLoader(CocoDetDataset(path, str(coco_dir)), (64, 64),
                          batch_size=2, fast_decode=True))
    want = list(JLoader(JDataset(path, str(coco_dir)), (64, 64),
                        batch_size=2, fast_decode=True))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["images"], w["images"])
    ann = json.loads((coco_dir / "ann.json").read_text())
    ann["images"] = ann["images"][:1]
    ann["images"][0]["file_name"] = "a.jpg"
    cv2.imwrite(str(tmp_path / "a.jpg"), np.zeros((40, 50, 3), np.uint8))
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    ds = CocoDetDataset(str(tmp_path / "ann.json"), str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_image_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ could not run"):
        list(EvalLoader(ds, (64, 64), fast_decode=True))


def test_process_shard_equals_jax():
    for n in (0, 1, 5, 10, 17):
        for world in (1, 2, 3, 4, 8):
            for rank in range(world):
                assert (trunner.process_shard(n, rank, world)
                        == jrunner.process_shard(n, rank, world))
    assert trunner.process_shard(7) == range(7)   # no process group


def test_all_gather_object_single_process(monkeypatch):
    for var in ("WEDETECT_DIST", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    dist.maybe_initialize("cpu")
    assert not torch.distributed.is_initialized()
    obj = {"a": [1, 2], "b": np.arange(3)}
    out = dist.all_gather_object(obj)
    assert len(out) == 1 and out[0] is obj
    assert dist.process_index() == 0 and dist.process_count() == 1
    dist.barrier()


RANK_SCRIPT = """
import pickle, sys
import torch
sys.modules["jax"] = sys.modules["wedetect_tpu"] = None
from wedetect_tpu_torch.configs import ModelCfg, TestCfg
from wedetect_tpu_torch.data.coco import CocoDetDataset
from wedetect_tpu_torch.eval import dist, runner
from wedetect_tpu_torch.models.wedetect import WeDetectModule
root, out, sd_path, coco, lvis, emb2, emb3 = sys.argv[1:]
dist.maybe_initialize("cpu")
rank = dist.process_index()
sd = torch.load(sd_path)
res = {"world": dist.process_count()}
for mode, ann, emb in (("coco", coco, emb2), ("lvis", lvis, emb3)):
    ds = CocoDetDataset(ann, root)
    k = len(ds.class_names)
    cfg = ModelCfg(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                   neck_scale=0.25, neck_repeats=2,
                   head_in_channels=(32, 64, 128), embed_dims=32,
                   img_size=(64, 64), text=None, num_classes=k,
                   test=TestCfg(nms_pre=256, max_per_img=16))
    model = WeDetectModule(cfg).eval()
    model.load_state_dict(sd)
    w = torch.load(emb).numpy()
    res[mode] = runner.evaluate_coco(
        cfg, model, ds, w, batch_size=2, lvis=mode == "lvis",
        dump_path=f"{out}/{mode}.npz")
with open(f"{out}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
"""


def test_two_process_gloo_equals_one(runs, coco_dir, lvis_ann, weights,
                                     tmp_path):  # noqa: F811
    """evaluate_coco over two gloo ranks (file:// rendezvous, no ports)
    gives the one-process metrics and dump: every rank the same merged
    metrics, rank 0 the merged dump."""
    sd_path, emb2, emb3 = (str(tmp_path / n)
                           for n in ("sd.pt", "emb2.pt", "emb3.pt"))
    torch.save(weights[0], sd_path)
    torch.save(torch.from_numpy(text_embeds(2)), emb2)
    torch.save(torch.from_numpy(text_embeds(3)), emb3)
    args = [str(coco_dir), str(tmp_path), sd_path,
            str(coco_dir / "ann.json"), str(lvis_ann), emb2, emb3]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), WEDETECT_DIST="1",
                   RANK=str(rank), WORLD_SIZE="2", OMP_NUM_THREADS="2",
                   WEDETECT_DIST_INIT=f"file://{tmp_path}/rendezvous")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, *args], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    for rank in range(2):
        res = pickle.loads((tmp_path / f"rank{rank}.pkl").read_bytes())
        assert res["world"] == 2
        for mode in ("coco", "lvis"):
            assert_metrics_equal(res[mode], runs[mode]["got"])
    for mode in ("coco", "lvis"):
        merged = tdump.load_detections(str(tmp_path / f"{mode}.npz"))
        one = tdump.load_detections(runs[mode]["td"])
        assert len(merged) == len(one) == 5
        for a, b in zip(merged, one):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


def _cli_args(coco_dir, ann, *extra):  # noqa: F811
    return ["--ann", str(ann), "--img-root", str(coco_dir), "--random-init",
            "--size", "tiny", "--max-images", "2", "--batch-size", "2",
            *extra]


def test_cli_test_lvis_tta_dump_on_cpu(coco_dir, lvis_ann, tmp_path,
                                       capsys):  # noqa: F811
    from wedetect_tpu_torch.cli import test as cli_test

    out, dump = tmp_path / "metrics.json", tmp_path / "dets.npz"
    metrics = cli_test.main(_cli_args(
        coco_dir, lvis_ann, "--device", "cpu", "--lvis", "--tta", "--dump",
        str(dump), "--out", str(out)))
    assert set(metrics) == {"mAP", "AP50", "AP75", "APs", "APm", "APl",
                            "per_class", "APr", "APc", "APf"}
    saved = json.loads(out.read_text())
    assert set(saved) == set(metrics)
    assert '"mAP"' in capsys.readouterr().out
    recs = jdump.load_detections(str(dump))     # JAX's reader, JAX's keys
    assert [r["img_id"] for r in recs] == [1, 2]
    assert all(r["embeds"].shape[1] == 768 for r in recs if len(r["scores"]))
    assert all(len(r["scores"]) <= 100 for r in recs)   # tta_max_per_img


def test_cli_test_needs_device_flag_without_card(coco_dir, monkeypatch):  # noqa: F811,E501
    from wedetect_tpu_torch.cli import test as cli_test

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_test.main(_cli_args(coco_dir, coco_dir / "ann.json"))
