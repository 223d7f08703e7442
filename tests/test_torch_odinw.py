"""The port's ODinW evaluation (`cli/eval_odinw.py`) against the JAX
package's (`wedetect_tpu.cli.eval_odinw`): `discover` on a tree with
the layouts ODinW downloads come in, and `main` end to end on two tiny
subsets with ODinW-13 class lists.

Weights: mini_cfg's widths with the 768-wide embedding that main's
random text bank has (default_rng(0), (K, 768)), the port's seeded init
carried to JAX by its converter; each package's Detector.from_random is
replaced by a factory that records its arguments and returns these
weights. main asks for bf16 compute; the factory builds f32 detectors,
because the two packages' bf16 paths round differently (XLA's bf16
against torch autocast) and the results are compared exactly. Ground
truth: the port's own detections, moved by 0-3 px, so that the mAPs are
above 0. The images are JPEGs: both packages decode them natively.
"""

import json

import numpy as np
import pytest

import jax

cv2 = pytest.importorskip("cv2")

from wedetect_tpu.ckpt.convert import convert_detector  # noqa: E402
from wedetect_tpu.cli import eval_odinw as jodinw  # noqa: E402
from wedetect_tpu.configs import ModelCfg as JModelCfg  # noqa: E402
from wedetect_tpu.configs import TestCfg as JTestCfg  # noqa: E402
from wedetect_tpu.models import api as japi  # noqa: E402
from wedetect_tpu_torch import configs as TC  # noqa: E402
from wedetect_tpu_torch.cli import eval_odinw as todinw  # noqa: E402
from wedetect_tpu_torch.models import api as tapi  # noqa: E402
from wedetect_tpu_torch.models import wedetect as TW  # noqa: E402

AQUARIUM = ["fish", "jellyfish", "penguin", "puffin", "shark", "starfish",
            "stingray"]
PASCAL_VOC = ["aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
              "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
              "motorbike", "person", "pottedplant", "sheep", "sofa",
              "train", "tvmonitor"]


def _kw(k):
    return dict(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                neck_scale=0.25, neck_repeats=2,
                head_in_channels=(32, 64, 128), embed_dims=768,
                img_size=(64, 64), text=None, num_classes=k)


def _cfgs(k):
    t = dict(nms_pre=256, max_per_img=16)
    return (JModelCfg(test=JTestCfg(**t), **_kw(k)),
            TC.ModelCfg(test=TC.TestCfg(**t), **_kw(k)))


def test_discover_equals_jax(tmp_path):
    """`*test*.json` (else `*valid*.json`) matches file names: the
    Roboflow export named in GLIP's ODinW configs
    (`Aquarium Combined.v2-raw-1024.coco/test/
    annotations_without_background.json`) is not found, by either
    package."""
    layout = {
        "Aquarium/Aquarium Combined.v2-raw-1024.coco/test/"
        "annotations_without_background.json": "{}",
        "PascalVOC/PascalVOC.v1-1.coco/test/instances_test.json": "{}",
        "PascalVOC/PascalVOC.v1-1.coco/valid/instances_valid.json": "{}",
        "Pothole/valid/_annotations.valid.json": "{}",
        "Empty/readme.txt": "",
        "notes.json": "{}",
    }
    for rel, text in layout.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    got = todinw.discover(str(tmp_path))
    assert got == jodinw.discover(str(tmp_path))
    assert [g[0] for g in got] == ["PascalVOC", "Pothole"]
    assert got[0][1].endswith("test/instances_test.json")
    assert got[0][2].endswith("PascalVOC.v1-1.coco/test")


@pytest.fixture(scope="module")
def weights():
    """(port state dict, JAX variables) of the same seeded weights."""
    _, tcfg = _cfgs(len(AQUARIUM))
    sd = TW.init_variables(tcfg, seed=0, device="cpu").state_dict()
    jvars = convert_detector({k: v.numpy() for k, v in sd.items()},
                             _cfgs(len(AQUARIUM))[0])
    return sd, jax.tree.map(np.asarray, jvars)


def _write_subset(root, name, classes, sd, seed):
    """4 seeded JPEGs of 60-120 px under
    <name>/<name>.coco/test/, and an annotation file whose boxes are the
    port's top 3 detections an image, moved by 0-3 px."""
    d = root / name / f"{name}.coco" / "test"
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    _, tcfg = _cfgs(len(classes))
    det = tapi.Detector(cfg=tcfg, model=_model(tcfg, sd))
    det.reparameterize(classes, embeds=np.random.default_rng(0)
                       .standard_normal((len(classes), 768))
                       .astype(np.float32))
    images, anns = [], []
    for i in range(4):
        h, w = (int(v) for v in rng.integers(60, 121, 2))
        small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3),
                             dtype=np.uint8)
        path = d / f"{i:04d}.jpg"
        cv2.imwrite(str(path), cv2.resize(small, (w, h)),
                    [cv2.IMWRITE_JPEG_QUALITY, 92])
        images.append({"id": i + 1, "file_name": path.name, "width": w,
                       "height": h})
        r = det([str(path)], score_thr=0.0)[0]
        for j in np.argsort(-r["scores"], kind="stable")[:3]:
            x0, y0, x1, y1 = r["bboxes"][j] + rng.uniform(-3, 3, 4)
            x0, x1 = sorted((max(x0, 0.0), min(x1, w)))
            y0, y1 = sorted((max(y0, 0.0), min(y1, h)))
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(r["labels"][j]) + 1,
                         "bbox": [x0, y0, max(x1 - x0, 1.0),
                                  max(y1 - y0, 1.0)],
                         "area": max(x1 - x0, 1.0) * max(y1 - y0, 1.0),
                         "iscrowd": 0})
    cats = [{"id": i + 1, "name": c} for i, c in enumerate(classes)]
    (d / "annotations_test.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": cats}))


def _model(tcfg, sd):
    model = tapi._build_detector(tcfg, "cpu")
    model.load_state_dict(sd, strict=True)
    return model


def test_main_equals_jax(tmp_path, weights, monkeypatch, capsys):
    """Both mains on the same tree and weights: the same per-subset
    lines, the same results JSON (exactly) and the same --out file;
    each asked its factory for bf16 at the subset's K on the CPU."""
    sd, jvars = weights
    _write_subset(tmp_path, "Aquarium", AQUARIUM, sd, 1)
    _write_subset(tmp_path, "PascalVOC", PASCAL_VOC, sd, 2)
    calls = {"port": [], "jax": []}

    def port_factory(size, **kw):
        calls["port"].append((size, kw))
        _, tcfg = _cfgs(kw["num_classes"])
        return tapi.Detector(cfg=tcfg, model=_model(tcfg, sd))

    def jax_factory(size, **kw):
        calls["jax"].append((size, kw))
        jcfg, _ = _cfgs(kw["num_classes"])
        return japi.Detector(cfg=jcfg, variables=jvars)

    monkeypatch.setattr(tapi.Detector, "from_random",
                        staticmethod(port_factory))
    monkeypatch.setattr(japi.Detector, "from_random",
                        staticmethod(jax_factory))
    args = ["--root", str(tmp_path), "--random-init", "--batch-size", "2"]
    got = todinw.main(args + ["--device", "cpu", "--out",
                              str(tmp_path / "port.json")])
    port_out = capsys.readouterr().out
    jodinw.main(args + ["--out", str(tmp_path / "jax.json")])
    jax_out = capsys.readouterr().out
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got == want == json.loads((tmp_path / "port.json").read_text())
    assert set(got) == {"Aquarium", "PascalVOC", "mean_mAP"}
    assert got["Aquarium"] > 0 and got["PascalVOC"] > 0
    assert got["mean_mAP"] == pytest.approx(
        (got["Aquarium"] + got["PascalVOC"]) / 2, abs=1e-12)
    assert port_out == jax_out
    assert [c[1]["num_classes"] for c in calls["port"]] == [7, 20]
    for (ps, pkw), (js, jkw) in zip(calls["port"], calls["jax"]):
        assert ps == js == "base"
        assert pkw.pop("device") == "cpu"
        assert pkw == jkw and pkw["compute_dtype"] == "bfloat16"
    # --subsets picks by name; a NaN mAP (no gts) is dropped from the mean
    ann = tmp_path / "PascalVOC/PascalVOC.coco/test/annotations_test.json"
    data = json.loads(ann.read_text())
    data["annotations"] = []
    ann.write_text(json.dumps(data))
    capsys.readouterr()
    got = todinw.main(args + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    jodinw.main(args)
    assert port_out == capsys.readouterr().out
    assert "PascalVOC: mAP nan" in port_out
    assert got["Aquarium"] > 0 and got["PascalVOC"] != got["PascalVOC"]
    assert got["mean_mAP"] == got["Aquarium"]
    only = todinw.main(args + ["--device", "cpu", "--subsets", "Aquarium"])
    assert set(only) == {"Aquarium", "mean_mAP"}


def test_cli_needs_a_subset(tmp_path):
    with pytest.raises(SystemExit, match="no ODinW subsets"):
        todinw.main(["--root", str(tmp_path), "--device", "cpu"])


def test_cli_parses_like_jax():
    argv = ["--root", "r", "--size", "tiny", "--subsets", "a", "b",
            "--batch-size", "4", "--max-images", "3", "--random-init"]
    t, j = todinw.parse_args(argv), jodinw.parse_args(argv)
    assert vars(t) == {**vars(j), "device": "cuda"}
