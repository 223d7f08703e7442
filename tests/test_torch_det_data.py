"""The port's detector-training data (`data/augment.py`, `data/coco.py`,
`data/concat.py`, `data/sampler.py`, `data/wds.py`) against the JAX
package's under the same rng, and `cli/train.py` end to end on the CPU.

Tolerances: the data copies bitwise (images, boxes, labels, texts and
the rng's state after each call). wds decodes with each package's
native JPEG decoder (a plain decode, no resampling: bitwise). The CLI:
a run stopped at a checkpoint and resumed ends bitwise equal to the run
kept going (model, BN statistics, Adam state, step).
"""

import io
import json
import tarfile

import numpy as np
import pytest
import torch

from wedetect_tpu.data import augment as JAUG
from wedetect_tpu.data import coco as JCOCO
from wedetect_tpu.data import concat as JCAT
from wedetect_tpu.data import sampler as JSMP
from wedetect_tpu.data import wds as JWDS
from wedetect_tpu_torch.ckpt import io as CIO
from wedetect_tpu_torch.cli import train as TCLI
from wedetect_tpu_torch.data import augment as TAUG
from wedetect_tpu_torch.data import coco as TCOCO
from wedetect_tpu_torch.data import concat as TCAT
from wedetect_tpu_torch.data import sampler as TSMP
from wedetect_tpu_torch.data import wds as TWDS

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the models here are small, and with several
    test workers on the host torch's default thread team only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_sample(rng, n=3, size=80, label_range=10, texts=None):
    img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    ctr = rng.uniform(20, 60, (n, 2))
    wh = rng.uniform(10, 30, (n, 2))
    boxes = np.concatenate([np.clip(ctr - wh / 2, 0, None),
                            np.clip(ctr + wh / 2, None, size)],
                           -1).astype(np.float32)
    s = {"image": img, "gt_bboxes": boxes,
         "gt_labels": rng.integers(0, label_range, n)}
    if texts is not None:
        s["texts"] = texts
    return s


def same(a, b, path="out"):
    """Bitwise equality of nested samples: arrays with their dtypes."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def both(fn_name, make_args, seed, mods=(TAUG, JAUG)):
    """Call the port's and JAX's `fn_name` on equal inputs from equal
    rngs; the outputs and the rngs after the call must agree."""
    out = []
    for mod in mods:
        rng = np.random.default_rng(seed)
        args = make_args(np.random.default_rng(seed + 100))
        out.append((getattr(mod, fn_name)(*args, rng=rng),
                    rng.bit_generator.state))
    same(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    return out[0][0]


@pytest.mark.parametrize("kw", [
    dict(num_neg_samples=(5, 10), max_num_samples=12),
    dict(num_neg_samples=(80, 80), max_num_samples=80),
    dict(num_neg_samples=(0, 3), max_num_samples=4,
         prompt_format="a photo of {}")])
def test_random_load_text_bitwise(kw):
    texts = [[f"c{i}", f"s{i}"] for i in range(30)]
    for seed in range(3):
        res = []
        for mod in (TAUG, JAUG):
            rng = np.random.default_rng(seed)
            s = make_sample(np.random.default_rng(seed + 50), n=6,
                            label_range=30)
            res.append((mod.random_load_text(s, texts, rng, **kw),
                        rng.bit_generator.state))
        same(res[0][0], res[1][0])
        assert res[0][1] == res[1][1]
        out = res[0][0]
    assert len(out["texts"]) <= kw["max_num_samples"]


def test_mosaic_and_mixup_bitwise():
    both("mosaic4", lambda r: ([make_sample(r, size=s) for s in
                                (80, 64, 100, 50)], 64), 1)
    both("mosaic9", lambda r: ([make_sample(r, size=40 + 8 * i)
                                for i in range(9)], 64), 2)
    both("mixup2", lambda r: (make_sample(r), make_sample(r)), 3)
    for seed in (4, 5, 6):
        both("yolox_mixup", lambda r: (make_sample(r, size=96),
                                       make_sample(r, size=64)), seed)


def test_merge_mixed_texts_bitwise():
    parts = [make_sample(np.random.default_rng(i), texts=t) for i, t in
             enumerate((["cat", "dog"], ["dog", "bird"], [["x", "y"]],
                        None))]
    same(TAUG.merge_mixed_texts(parts), JAUG.merge_mixed_texts(parts))


class FakeDs:
    def __init__(self, n, texts, labels):
        self.n, self.texts, self.labels = n, texts, labels

    def __len__(self):
        return self.n

    def sample(self, i):
        return {"gt_labels": np.array(self.labels[i % len(self.labels)]),
                "texts": self.texts, "idx": i}


def test_concat_repeat_and_sampler_bitwise():
    def build(mod):
        d1 = FakeDs(3, [["cat"], ["dog"]], [[0], [1], [0, 1]])
        d2 = FakeDs(2, [["dog"], ["bird", "finch"]], [[1], [0, 1]])
        d3 = FakeDs(2, [["fox"]], [[0], [2]])   # label 2: no text
        return mod.RepeatDataset(mod.ConcatDetDataset([d1, d2, d3]), 2)

    t, j = build(TCAT), build(JCAT)
    assert len(t) == len(j) == 14
    assert t.texts == j.texts
    for i in range(len(t)):
        same(t.sample(i), j.sample(i))
    same(t.dataset.cat_to_indices(), j.dataset.cat_to_indices())
    for i in range(len(t.dataset)):
        assert t.dataset.get_cat_ids(i) == j.dataset.get_cat_ids(i)
    table = t.dataset.cat_to_indices()
    for kw in (dict(seed=0), dict(seed=3, epoch=2),
               dict(seed=1, rank=1, world_size=3)):
        ts = TSMP.ClassAwareSampler(table, 50, **kw)
        js = JSMP.ClassAwareSampler(table, 50, **kw)
        assert list(ts) == list(js) and len(ts) == len(js)


# ------------------------------------------------------------- coco, wds
def write_coco(root, n_images=3):
    """A tiny COCO-format dataset: PNG images of three sizes, three
    categories (ids 3, 7, 9), one crowd annotation, one empty image."""
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i, (h, w) in enumerate([(60, 80), (64, 64), (90, 50)][:n_images]):
        name = f"img{i}.png"
        cv2.imwrite(str(root / name),
                    rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        images.append({"id": i + 1, "file_name": name, "width": w,
                       "height": h})
        if i == 2:
            continue
        for j in range(3):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": [3, 7, 9][j],
                         "bbox": [x, y, rng.uniform(8, w / 2),
                                  rng.uniform(8, h / 2)],
                         "iscrowd": int(i == 1 and j == 2)})
    cats = [{"id": c, "name": n} for c, n in ((9, "bird"), (3, "cat"),
                                               (7, "dog"))]
    path = root / "train.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": cats}))
    return str(path)


def test_coco_dataset_bitwise(tmp_path):
    ann = write_coco(tmp_path)
    (tmp_path / "texts.json").write_text(json.dumps([["cat", "kitty"],
                                                     ["dog"], ["bird"]]))
    kw = dict(test_mode=False, class_text_path=str(tmp_path / "texts.json"))
    t = TCOCO.CocoDetDataset(ann, str(tmp_path), **kw)
    j = JCOCO.CocoDetDataset(ann, str(tmp_path), **kw)
    assert t.class_names == j.class_names == ["cat", "dog", "bird"]
    same(t.items, j.items)
    assert t.texts == j.texts and t.frequencies == j.frequencies
    for i in range(len(t)):
        same(t.gt_arrays(i), j.gt_arrays(i))
        same(t.train_arrays(i, 4), j.train_arrays(i, 4))
    assert TCOCO.first_texts(t.texts) == JCOCO.first_texts(j.texts)
    assert len(TCOCO.CocoDetDataset(ann, str(tmp_path), test_mode=False,
                                    filter_empty=True)) == 2


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("wds")
    rng = np.random.default_rng(0)
    for s in range(2):
        with tarfile.open(root / f"shard-{s}.tar", "w") as tf:
            for i in range(5):
                key = f"{s}_{i:04d}"
                img = rng.integers(0, 255, (40, 50, 3), dtype=np.uint8)
                ok, enc = cv2.imencode(".jpg", img)
                assert ok
                ann = {"meta": {"image_name": f"{key}.jpg"},
                       "annotations": [
                           {"bbox": [5, 5, 20, 20], "text_ch": "狗"},
                           {"bbox": [1, 2, 10, 12],
                            "text_ch": ["cat", "dog", "bird"][i % 3]}]}
                if i == 3:          # a broken sample: no annotations
                    ann["annotations"] = []
                for ext, data in (("jpg", enc.tobytes()),
                                  ("json", json.dumps(ann).encode())):
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return str(root / "shard-*.tar")


@pytest.mark.parametrize("kw", [
    dict(en_zh_map={"cat": "猫"}),
    dict(class_texts=[["bird", "finch"]], use_negative_queue=True, seed=3),
    dict(rank=1, world_size=2)])
def test_wds_stream_bitwise(shards, kw):
    t, j = TWDS.WdsDetDataset(shards, **kw), JWDS.WdsDetDataset(shards, **kw)
    assert t.paths == j.paths
    for _ in range(12):
        same(t.next_sample(), j.next_sample())
    groups = [list(m.iter_tar_samples(t.paths[0])) for m in (TWDS, JWDS)]
    same(groups[0], groups[1])
    assert len(groups[0]) == 5


def test_neg_queue_bitwise():
    t, j = TWDS.NegQueue(size=4, seed=1), JWDS.NegQueue(size=4, seed=1)
    for texts in ([["a"], ["b"], ["object"]], ["c", "d", "e"],
                  [["f", "g"], ["h"]]):
        t.update(texts)
        j.update(texts)
        assert t.queue == j.queue
        for q in ([["c"]], ["z"], []):
            assert t.enrich(q) == j.enrich(q)


# -------------------------------------------------------------------- CLI
def _cli(tmp_path, ckpt, steps, *extra):
    ann = str(tmp_path / "train.json")
    return TCLI.main(["--ann", ann, "--img-root", str(tmp_path),
                      "--size", "tiny", "--img-size", "64",
                      "--num-classes", "4", "--batch-size", "2",
                      "--steps", str(steps), "--ckpt-dir", str(ckpt),
                      "--ckpt-every", "2", "--device", "cpu", *extra])


def test_cli_train_resume_is_bitwise(tmp_path, monkeypatch):
    """cli/train.main on a tiny COCO dataset: 4 steps straight, against 2
    steps, then --resume to 4 (the data stream and the text bank pick up
    where the first run stopped). The run's config has mini_cfg's widths
    (tests/test_detector.py:14) in place of `--size tiny`'s, whose
    checkpoints take ~420 MB each."""
    from wedetect_tpu_torch.configs import ModelCfg

    def mini_config(args):
        return ModelCfg(name="mini", depths=(1, 1, 2, 1),
                        dims=(32, 64, 128, 256), neck_scale=0.25,
                        neck_repeats=2, head_in_channels=(32, 64, 128),
                        embed_dims=32, text=None, **TCLI._cfg_kw(args))

    monkeypatch.setattr(TCLI, "build_config", mini_config)
    write_coco(tmp_path)
    a = _cli(tmp_path, tmp_path / "a", 4)
    assert a.step == 4 and a.tx.count == 4 and not a.model.training
    _cli(tmp_path, tmp_path / "b", 2)
    b = _cli(tmp_path, tmp_path / "b", 4, "--resume")
    assert b.step == 4
    sa, sb = (torch.load(str(tmp_path / d / "step_4" / "train_state.pt"),
                         weights_only=True) for d in ("a", "b"))
    assert sa["step"] == sb["step"] == 4
    for k, v in sa["model"].items():
        assert torch.equal(v, sb["model"][k]), k
    for x, y in zip(sa["opt_state"]["mu"] + sa["opt_state"]["nu"],
                    sb["opt_state"]["mu"] + sb["opt_state"]["nu"]):
        assert torch.equal(x, y)
    first = torch.load(str(tmp_path / "b" / "step_2" / "train_state.pt"),
                       weights_only=True)["model"]
    moved = [k for k, v in sa["model"].items() if not torch.equal(v, first[k])]
    assert any(k.startswith("backbone.") for k in moved)
    assert any(k.endswith("running_mean") for k in moved)
    assert CIO.latest_checkpoint(str(tmp_path / "b")).endswith("step_4")


def test_cli_init_checkpoint_loads_the_weights(tmp_path):
    """--init-checkpoint: a state dict the test writes (canonical keys,
    no text tower) is the model the train state starts from."""
    from wedetect_tpu_torch.models.wedetect import init_variables

    args = TCLI.parse_args(["--size", "tiny", "--img-size", "64",
                            "--init-checkpoint", str(tmp_path / "w.pth"),
                            "--device", "cpu"])
    cfg = TCLI.build_config(args)
    sd = init_variables(cfg, seed=7, device="cpu").state_dict()
    torch.save(sd, args.init_checkpoint)
    state, _ = TCLI.build_state(args, cfg)
    got = state.model.state_dict()
    assert state.model.cfg == cfg and state.step == 0
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


def test_cli_refuses_fsdp_and_a_missing_card(tmp_path, monkeypatch):
    """--fsdp beyond the world (one process here) raises, as JAX's
    make_mesh asserts; so does a missing card."""
    with pytest.raises(ValueError, match="fsdp=2"):
        TCLI.main(["--ann", "x.json", "--fsdp", "2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TCLI.main(["--ann", "x.json"])


def test_random_text_bank_is_stable():
    enc = TCLI.random_text_bank(8)
    a = enc(["cat", "dog"])
    assert a.shape == (2, 8) and a.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(a, axis=-1), 1.0, rtol=1e-6)
    assert enc(["cat", "dog"]) is a
    np.testing.assert_array_equal(TCLI.random_text_bank(8)(["cat", "dog"]),
                                  a)
    assert not np.array_equal(enc(["dog", "cat"]), a)
