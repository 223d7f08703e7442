"""The port's user API, preprocessing, checkpoint key names and import
isolation, against the JAX package where there is a counterpart.

Detections of `Detector.__call__` are compared exactly on labels and
counts and to 1e-3 px on boxes / 1e-4 on scores: the networks agree to
1e-4 (test_torch_detector.py) and boxes are scaled back to the original
image by up to 1 / 0.4.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from wedetect_tpu.ckpt.convert import convert_detector
from wedetect_tpu.configs import ModelCfg as JModelCfg
from wedetect_tpu.configs import TestCfg as JTestCfg
from wedetect_tpu.models.api import Detector as JDetector
from wedetect_tpu.models.wedetect import init_variables as jax_init
from wedetect_tpu.ops import letterbox as jlb
from wedetect_tpu_torch import configs as TC
from wedetect_tpu_torch.ckpt.convert import from_jax_variables
from wedetect_tpu_torch.models import wedetect as TW
from wedetect_tpu_torch.models.api import Detector
from wedetect_tpu_torch.ops import letterbox as tlb

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "wedetect_tpu_torch"


def _kw(**kw):
    base = dict(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                neck_scale=0.25, neck_repeats=2,
                head_in_channels=(32, 64, 128), embed_dims=32,
                img_size=(64, 64), text=None, num_classes=4)
    base.update(kw)
    return base


def _cfgs(**kw):
    t = dict(nms_pre=256, max_per_img=16)
    return (JModelCfg(test=JTestCfg(**t), **_kw(**kw)),
            TC.ModelCfg(test=TC.TestCfg(**t), **_kw(**kw)))


def _images():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in ((64, 64), (50, 80), (160, 90))]


@pytest.mark.parametrize("preproc", ["pipeline", "yolov5"])
def test_detector_call_matches_jax(preproc):
    jcfg, tcfg = _cfgs()
    jvars = jax_init(jcfg, seed=0)
    w = np.random.default_rng(1).standard_normal((4, 32)).astype(np.float32)
    jdet = JDetector(cfg=jcfg, variables=jvars, preproc=preproc)
    jdet.reparameterize(["a", "b", "c", "d"], embeds=w)
    tdet = Detector.from_jax_variables(jax.tree.map(np.asarray, jvars), tcfg,
                                       device="cpu", preproc=preproc)
    tdet.reparameterize(["a", "b", "c", "d"], embeds=w)
    want = jdet(_images(), score_thr=0.3, max_dets=10)
    got = tdet(_images(), score_thr=0.3, max_dets=10)
    assert sum(len(r["labels"]) for r in got) > 0
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g["labels"], r["labels"])
        np.testing.assert_allclose(g["scores"], r["scores"], atol=1e-4)
        np.testing.assert_allclose(g["bboxes"], r["bboxes"], atol=1e-3)
        np.testing.assert_allclose(g["embeddings"], r["embeddings"],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("preproc", ["pipeline", "yolov5"])
def test_detector_call_on_jpeg_paths_matches_jax(tmp_path, preproc):
    """JPEG paths: each package's native decode + letterbox (the yolov5
    preprocessing decodes with cv2 in both); detections as above. The
    decoders may differ by 1 LSB on a few pixels (the build flags;
    tests/test_torch_native_image.py)."""
    import cv2

    jcfg, tcfg = _cfgs()
    jvars = jax_init(jcfg, seed=0)
    w = np.random.default_rng(1).standard_normal((4, 32)).astype(np.float32)
    jdet = JDetector(cfg=jcfg, variables=jvars, preproc=preproc)
    jdet.reparameterize(["a", "b", "c", "d"], embeds=w)
    tdet = Detector.from_jax_variables(jax.tree.map(np.asarray, jvars), tcfg,
                                       device="cpu", preproc=preproc)
    tdet.reparameterize(["a", "b", "c", "d"], embeds=w)
    paths = []
    for i, img in enumerate(_images()):
        paths.append(str(tmp_path / f"{i}.jpg"))
        cv2.imwrite(paths[-1], img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    want = jdet(paths, score_thr=0.3, max_dets=10)
    got = tdet(paths, score_thr=0.3, max_dets=10)
    assert sum(len(r["labels"]) for r in got) > 0
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g["labels"], r["labels"])
        np.testing.assert_allclose(g["scores"], r["scores"], atol=1e-4)
        np.testing.assert_allclose(g["bboxes"], r["bboxes"], atol=1e-3)
        np.testing.assert_allclose(g["embeddings"], r["embeddings"],
                                   atol=1e-4, rtol=1e-4)


def test_text_tower_through_detector():
    """from_jax_variables with text params; reparameterize on token ids
    runs the port's tower, equal to the flax TextTower to 1e-5."""
    import jax.numpy as jnp

    from wedetect_tpu.configs import TextCfg as JTextCfg
    from wedetect_tpu.nn.xlmr import TextTower as JTextTower

    tkw = dict(hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, vocab_size=300,
               max_position_embeddings=40, head_out=32)
    jcfg, tcfg = _cfgs(text=JTextCfg(**tkw))
    tcfg = TC.ModelCfg(**{**_kw(text=TC.TextCfg(**tkw)),
                          "test": tcfg.test})
    ids = np.random.default_rng(3).integers(3, 300, (4, 9)).astype(np.int32)
    ids[:, 0], ids[1, 5:], ids[2, 3:] = 0, 1, 1
    mask = (ids != 1).astype(np.int32)
    tparams = JTextTower(jcfg.text).init(
        jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(mask))["params"]
    want = JTextTower(jcfg.text).apply({"params": tparams}, jnp.asarray(ids),
                                       jnp.asarray(mask))
    det = Detector.from_jax_variables(
        jax.tree.map(np.asarray, jax_init(jcfg, seed=0)), tcfg,
        text_params=jax.tree.map(np.asarray, tparams), device="cpu")
    det.reparameterize(list("abcd"), token_ids=(ids, mask))
    np.testing.assert_allclose(det._text_embeds.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    out = det(_images()[:1], score_thr=0.0)
    assert out[0]["bboxes"].shape[1] == 4


@pytest.mark.parametrize("shape", [(64, 64), (50, 80), (200, 120),
                                   (30, 20)])
def test_letterbox_matches_jax(shape):
    img = np.random.default_rng(shape[0]).integers(
        0, 255, shape + (3,), dtype=np.uint8)
    scale = (64, 64)
    for a, b in zip(jlb.preprocess_image(img, scale),
                    tlb.preprocess_image(img, scale)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jlb.yolov5_letterbox(img, scale),
                    tlb.yolov5_letterbox(img, scale)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jlb.letter_resize(img, scale),
                    tlb.letter_resize(img, scale)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(jlb.keep_ratio_resize(img, scale),
                                  tlb.keep_ratio_resize(img, scale))


def test_default_device_is_cuda(monkeypatch):
    """Without device=..., every entry point asks for the card and
    raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="cuda"):
        Detector.from_random("tiny")
    with pytest.raises(RuntimeError, match="cuda"):
        TW.init_variables(tcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        Detector.from_jax_variables(
            jax.tree.map(np.asarray, jax_init(jcfg, seed=0)), tcfg)


@pytest.mark.parametrize("variant", ["text", "uni", "uni_adapter"])
def test_weight_round_trip(variant):
    """JAX init -> numpy -> from_jax_variables -> the JAX package's own
    torch-checkpoint converter gives back the original variables exactly:
    the port's state dict uses the reference checkpoint's key names."""
    kw = {"text": {}, "uni": dict(num_prompts=8, num_classes=8),
          "uni_adapter": dict(num_prompts=8, num_classes=8,
                              use_mlp_adapter=True)}[variant]
    jcfg, tcfg = _cfgs(**kw)
    jvars = jax.tree.map(np.asarray, jax_init(jcfg, seed=2))
    sd = from_jax_variables(jvars, tcfg)
    model = TW.WeDetectModule(tcfg)
    model.load_state_dict(sd, strict=True)
    back = convert_detector({k: v.numpy() for k, v in sd.items()}, jcfg)
    a = jax.tree_util.tree_leaves_with_path(jvars)
    b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(a) == len(b)
    for path, x in a:
        np.testing.assert_array_equal(np.asarray(b[path]), x)


def _port_sources():
    return sorted([*PKG.rglob("*.py"), ROOT / "chip_smoke.py"])


def test_port_imports_no_jax_source_scan():
    banned = ("jax", "flax", "wedetect_tpu")
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in banned:
                    found.append(f"{path.relative_to(ROOT)}: {n}")
    assert not found, found
    assert len(_port_sources()) > 20


# the detection-evaluation slice: every module the import checks above
# and below must cover (their globs find whatever exists)
EVAL_SLICE = ("native/__init__.py", "native/coco_match.cc",
              "eval/coco_map.py", "eval/lvis_map.py", "eval/dist.py",
              "eval/dump.py", "eval/runner.py", "eval/recall.py",
              "eval/retrieval.py", "data/retrieval_classes.py",
              "data/retrieval_classes.json", "data/loader.py",
              "cli/test.py", "cli/eval_recall.py",
              "cli/extract_embedding.py")


def test_eval_slice_modules_scanned():
    for rel in EVAL_SLICE:
        assert (PKG / rel).is_file(), rel


# the deploy slice: the native decoder, the fold and bake, ODinW and WeRef
DEPLOY_SLICE = ("native/__init__.py", "native/image_pipeline.cc",
                "ckpt/__init__.py", "ckpt/fuse.py", "nn/__init__.py",
                "nn/head.py", "cli/eval_odinw.py", "data/weref.py",
                "data/loader.py", "data/wds.py", "models/api.py")


def test_deploy_slice_modules_scanned():
    sources = _port_sources()
    for rel in DEPLOY_SLICE:
        assert (PKG / rel).is_file(), rel
        if rel.endswith(".py"):
            assert PKG / rel in sources, rel
    # the C++ copy stands alone: no include of, or path to, the JAX
    # package's sources
    cc = (PKG / "native/image_pipeline.cc").read_text()
    assert "#include \"" not in cc and "wedetect_tpu/" not in cc.replace(
        "wedetect_tpu/native/image_pipeline.cc", "")


# the legacy modules: RepVGG and the legacy necks, the YOLOv5 family,
# the CLIP towers and the pseudo-text backbone
LEGACY_SLICE = ("nn/layers.py", "nn/yolo_world_pafpn.py", "nn/yolov5_head.py",
                "ops/yolov5.py", "train/yolov5_loss.py", "nn/clip.py",
                "nn/pseudo_text.py", "nn/__init__.py", "train/__init__.py",
                "ckpt/convert.py")


def test_legacy_slice_modules_scanned():
    sources = _port_sources()
    for rel in LEGACY_SLICE:
        assert PKG / rel in sources, rel


def test_every_jax_module_has_a_port_counterpart():
    """Each file of the JAX package's nn/, ops/ and train/ has its
    counterpart in the port; K1's Pallas file is ported as
    ops/row_topk.py."""
    jax_pkg = ROOT / "wedetect_tpu"
    renamed = {"ops/pallas_topk.py": "ops/row_topk.py"}
    missing = []
    for sub in ("nn", "ops", "train"):
        for f in sorted((jax_pkg / sub).glob("*.py")):
            rel = f"{sub}/{f.name}"
            if not (PKG / renamed.get(rel, rel)).is_file():
                missing.append(rel)
    assert not missing, missing


def test_port_imports_with_jax_blocked():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__") for p in PKG.rglob("*.py"))
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'wedetect_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"import importlib\nfor m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_infer_cli_random_init_on_cpu(tmp_path, capsys):
    import cv2

    from wedetect_tpu_torch.cli import infer_wedetect

    path = tmp_path / "img.png"
    cv2.imwrite(str(path), np.random.default_rng(0).integers(
        0, 255, (120, 90, 3), dtype=np.uint8))
    r = infer_wedetect.main(["--image", str(path), "--text", "a,b",
                             "--random-init", "--size", "tiny",
                             "--device", "cpu", "--threshold", "0.0",
                             "--output", str(tmp_path / "out.png")])
    out = capsys.readouterr().out
    assert "detections over thr" in out and "saved" in out
    assert (tmp_path / "out.png").exists()
    assert np.isfinite(r["bboxes"]).all()
    assert ((r["bboxes"] >= 0) & (r["bboxes"] <= 120)).all()
