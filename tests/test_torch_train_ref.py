"""The port's WeDetect-Ref training (`wedetect_tpu_torch/train/`,
`data/sft_chat.py`, `ckpt/io.py`, `cli/train_ref.py`) against the JAX
package on the same weights, data and seeds, on the CPU.

Tolerances: the focal loss to 1e-6 (f32 elementwise); soft labels,
datasets and step inputs exactly; the optimizer to 1e-6 of optax (f32,
the same chain); two SFT steps of the tiny Ref to 1e-5 relative in loss
and grad_norm, the first step's gradients to 1e-5 of each tensor's
largest entry, and the updated parameters to 1e-5 relative plus 1e-6
absolute on all but 0.1% of the entries. Those few are entries whose
gradient is near zero: Adam divides each entry by its own magnitude, so
a sign that differs in the last bits between the frameworks moves the
parameter by up to lr * mult per step either way, and they are held to
that bound. Checkpoint resume bitwise.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torch_ref_util import IMG, OBJ, VSTART, batch, cfgs, jax_params, \
    port_model
from wedetect_tpu.cli import train_ref as JCLI
from wedetect_tpu.data import sft_chat as JD
from wedetect_tpu.models.ref import sigmoid_focal_loss as j_focal
from wedetect_tpu.train import optimizer as JO
from wedetect_tpu.train import ref_lm as JLM
from wedetect_tpu.train import ref_sft as JSFT
from wedetect_tpu.train.train_step import TrainState as JState
from wedetect_tpu_torch.ckpt import io as CIO
from wedetect_tpu_torch.ckpt.convert_ref import (from_jax_ref_params,
                                                 jax_param_paths)
from wedetect_tpu_torch.cli import train_ref as TCLI
from wedetect_tpu_torch.data import sft_chat as TD
from wedetect_tpu_torch.models.ref import sigmoid_focal_loss
from wedetect_tpu_torch.train import optimizer as TO
from wedetect_tpu_torch.train import ref_lm as TLM
from wedetect_tpu_torch.train import ref_sft as TSFT
from wedetect_tpu_torch.train.train_step import TrainState


class StubTok:
    pad_token_id = 0

    def encode(self, s, add_special_tokens=False):
        return [ord(c) % 100 for c in s][:6]


# ----------------------------------------------------------- loss, labels
@pytest.mark.parametrize("masked", [False, True])
def test_sigmoid_focal_loss_matches_jax(masked):
    rng = np.random.default_rng(int(masked))
    logits = (rng.standard_normal(64) * 3).astype(np.float32)
    targets = np.where(rng.uniform(size=64) > 0.6, rng.uniform(size=64),
                       0.0).astype(np.float32)
    valid = (rng.uniform(size=64) > 0.2).astype(np.float32) if masked \
        else None
    want = j_focal(jnp.asarray(logits), jnp.asarray(targets),
                   valid=None if valid is None else jnp.asarray(valid))
    got = sigmoid_focal_loss(torch.from_numpy(logits),
                             torch.from_numpy(targets),
                             valid=None if valid is None
                             else torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("n_props", [0, 5, 40])
def test_build_soft_labels_bitwise(n_props):
    rng = np.random.default_rng(n_props)
    gts = np.array([[10, 10, 60, 50], [100, 40, 180, 120],
                    [5, 90, 40, 140]], np.float32)
    props = np.concatenate([gts[:2] + rng.uniform(-6, 6, (2, 4)),
                            rng.uniform(0, 200, (max(n_props - 2, 0), 4))
                            ])[:n_props].astype(np.float32)
    props[:, 2:] = np.maximum(props[:, 2:], props[:, :2] + 1)
    want = JSFT.build_soft_labels(gts, props, np.random.default_rng(7))
    got = TSFT.build_soft_labels(gts, props, np.random.default_rng(7))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- optimizer
def _tree():
    rng = np.random.default_rng(0)
    shapes = {"a": {"kernel": (4, 3), "bias": (3,)},
              "vision": {"w": (2, 5)},
              "extras": {"out_proj": {"kernel": (3, 1), "bias": (1,)},
                         "norm": {"scale": (3,)}}}
    return jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


def _paths(tree):
    return [(JO._path_str(p), x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_matches_optax(clip):
    """3 applied updates (warmup + cosine, weight decay, lr multipliers)
    with grad_accum 2: optax MultiSteps averages the micro-steps and
    counts the schedule only on applied updates."""
    params = _tree()
    kw = dict(base_lr=1e-2, weight_decay=0.1,
              custom_lr_mults={"vision": 0.1, "out_proj": 10.0},
              grad_clip_norm=clip)
    jtx = JO.with_grad_accum(JO.make_optimizer(
        params, lr_schedule=JO.make_lr_schedule(1e-2, 5, warmup_steps=2),
        **kw), 2)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jtx.init(jp)
    tparams = [(p, torch.from_numpy(x.copy())) for p, x in _paths(params)]
    ttx = TO.with_grad_accum(TO.make_optimizer(
        tparams, lr_schedule=TO.make_lr_schedule(1e-2, 5, warmup_steps=2),
        **kw), 2)
    rng = np.random.default_rng(1)
    for _ in range(6):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32),
            params)
        upd, jst = jtx.update(jax.tree.map(jnp.asarray, grads), jst, jp)
        jp = optax.apply_updates(jp, upd)
        for (_, t), (_, g) in zip(tparams, _paths(grads)):
            t.grad = torch.from_numpy(g)
        ttx.step()
        for (_, t), (_, x) in zip(tparams, _paths(jp)):
            np.testing.assert_allclose(t.numpy(), np.asarray(x), atol=1e-6,
                                       rtol=1e-6)
    assert ttx.count == 3


def test_lr_schedule_matches_optax():
    for sched, warm in (("cosine", 3), ("cosine", 0), ("linear", 2),
                        ("constant", 2)):
        want = JO.make_lr_schedule(1e-3, 12, warmup_steps=warm,
                                   schedule=sched)
        got = TO.make_lr_schedule(1e-3, 12, warmup_steps=warm,
                                  schedule=sched)
        for c in range(15):
            np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                       atol=1e-12)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = cfgs()
    return jcfg, tcfg, jax_params(jcfg, seed=3)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_multipliers_and_decay_match_jax(tiny, stage):
    """Each port tensor's lr multiplier and decay flag equal the JAX
    segment rule's on its JAX path: one optax update with unit gradients
    gives -lr * mult per tensor."""
    jcfg, tcfg, params = tiny
    model = port_model(params, tcfg)
    if stage == 3:
        jtx = JSFT.ref_optimizer(params, base_lr=1.0)
        ttx = TSFT.ref_optimizer(model, base_lr=1.0)
    else:
        jtx = JLM.stage_optimizer(params, stage, base_lr=1.0)
        ttx = TLM.stage_optimizer(model, stage, base_lr=1.0)
    ones = jax.tree.map(lambda x: jnp.ones(x.shape, jnp.float32), params)
    upd, _ = jtx.update(ones, jtx.init(params), params)
    want = {JO._path_str(p): float(-np.asarray(u).ravel()[0])
            for p, u in jax.tree_util.tree_leaves_with_path(upd)}
    decay = {JO._path_str(p): bool(d) for p, d in
             jax.tree_util.tree_leaves_with_path(JO.decay_mask(params))}
    paths = jax_param_paths(tcfg)
    names = [n for n, _ in model.named_parameters()]
    assert ttx.paths == [paths[n] for n in names]
    assert len(ttx.paths) == len(want)
    for path, m, d in zip(ttx.paths, ttx.mults, ttx.decay):
        assert m == pytest.approx(want[path], rel=1e-4), path
        assert d == decay[path], path
    assert {1: {0.0, 1.0}, 2: {0.0, 1.0}, 3: {0.0, 1.0, 10.0}}[stage] == \
        set(ttx.mults)


# ------------------------------------------------------------------ steps
def _labels(bt, seed=0):
    rng = np.random.default_rng(seed)
    lab = (rng.uniform(0, 1, bt.obj.shape)
           * (rng.uniform(0, 1, bt.obj.shape) > 0.4)).astype(np.float32)
    valid = np.ones(bt.obj.shape, np.float32)
    valid[1, -1] = 0
    return lab, valid


def _lm_labels(bt):
    lab = np.where(bt.mask > 0, bt.ids, JLM.IGNORE_INDEX).astype(np.int32)
    lab[bt.ids == IMG] = JLM.IGNORE_INDEX
    return lab


def _compare_params(model, jparams, tcfg, tx, lr, steps):
    want = from_jax_ref_params(jax.tree.map(np.asarray, jparams), tcfg)
    for (n, p), m in zip(model.named_parameters(), tx.mults):
        got, w = p.detach().numpy(), want[n].numpy()
        err = np.abs(got - w)
        loose = err > 1e-6 + 1e-5 * np.abs(w)
        assert loose.mean() <= 1e-3, (n, int(loose.sum()))
        assert err.max() <= 2 * steps * lr * m + 1e-6, (n, err.max())


def _jax_grads(jcfg, stage, params, args, labels, valid):
    """JAX's loss_fn of ref_sft_step / ref_lm_step, differentiated."""
    from wedetect_tpu.models.ref import RefModules as JRefModules

    mod = JRefModules(jcfg, 8, 8)

    def loss(p):
        if stage == 3:
            logits = mod.apply({"params": p}, *args)
            return j_focal(logits.reshape(-1), labels.reshape(-1),
                           valid=valid.reshape(-1))
        hidden = mod.apply({"params": p}, *args, method=JLM._hidden_states)
        emb = p["embed"]["embed_tokens"]["embedding"]
        return JLM.lm_cross_entropy(hidden @ emb.T, labels)

    return jax.grad(loss)(params)


@pytest.mark.parametrize("route", ["einsum", "flash"])
@pytest.mark.parametrize("stage", [2, 3])
def test_sft_steps_match_jax(route, stage):
    """Two steps of ref_sft_step (stage 3) or ref_lm_step (stage 2) from
    the same weights: loss, grad_norm, the first step's gradients and the
    updated parameters. The flash route (head_dim 128,
    attn_impl="flash") runs the plain forward and backward of K2 and K3
    through their autograd Functions; JAX runs its einsum attention (the
    same function on every real row)."""
    hd = 128 if route == "flash" else 16
    jcfg, tcfg = cfgs(head_dim=hd)
    params = jax_params(jcfg, seed=3)
    model = port_model(params, tcfg,
                       attn_impl="flash" if route == "flash" else "auto")
    bt = batch(seed=2, p_pad=128, s_pad=128, l_pad=256) if hd == 128 \
        else batch(seed=2)
    args = (bt.patches, bt.ids, bt.mask, bt.pos, bt.visual_start, bt.boxes,
            bt.ori_wh, bt.obj)
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    jp = jax.tree.map(jnp.asarray, params)
    lr = 1e-5
    if stage == 3:
        lab, valid = _labels(bt)
        js = JState.create({"params": jp}, JSFT.ref_optimizer(jp, lr))
        ts = TrainState.create(model, TSFT.ref_optimizer(model, lr))
        jgrads = _jax_grads(jcfg, 3, jp, [jargs[i] for i in
                                          (0, 1, 2, 3, 5, 6, 4, 7)],
                            jnp.asarray(lab), jnp.asarray(valid))
    else:
        lab = _lm_labels(bt)
        js = JState.create({"params": jp},
                           JLM.stage_optimizer(jp, 2, base_lr=lr))
        ts = TrainState.create(model,
                               TLM.stage_optimizer(model, 2, base_lr=lr))
        jgrads = _jax_grads(jcfg, 2, jp, [jargs[i] for i in
                                          (0, 1, 2, 3, 5, 6, 4, 7)],
                            jnp.asarray(lab), None)
    for step in range(2):
        if stage == 3:
            js, jm = JSFT.ref_sft_step(jcfg, 8, 8, js, *jargs,
                                       jnp.asarray(lab), jnp.asarray(valid))
            ts, tm = TSFT.ref_sft_step(tcfg, 8, 8, ts, *args, lab, valid)
            assert int(tm["num_pos"]) == int(jm["num_pos"])
        else:
            js, jm = JLM.ref_lm_step(jcfg, 8, 8, js, *jargs,
                                     jnp.asarray(lab), 1)
            ts, tm = TLM.ref_lm_step(tcfg, 8, 8, ts, *args, lab, 1)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        if step == 0:
            want = from_jax_ref_params(jax.tree.map(np.asarray, jgrads),
                                       tcfg)
            for n, p in model.named_parameters():
                g = (torch.zeros_like(p) if p.grad is None else p.grad)
                w = want[n]
                err = float((g - w).abs().max())
                assert err <= 1e-5 * max(float(w.abs().max()), 1e-6), \
                    (n, err)
    assert ts.step == int(js.step) == 2
    _compare_params(model, js.params, tcfg, ts.tx, lr, 2)


def test_every_parameter_gets_a_gradient(tiny):
    """The whole model is differentiated, the vision tower included (its
    gradient enters grad_norm), and a frozen tower stays bitwise."""
    jcfg, tcfg, params = tiny
    model = port_model(params, tcfg)
    bt = batch(seed=4)
    lab, valid = _labels(bt, seed=4)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ts = TrainState.create(model, TSFT.ref_optimizer(model, base_lr=1e-3))
    TSFT.ref_sft_step(tcfg, 8, 8, ts, bt.patches, bt.ids, bt.mask, bt.pos,
                      bt.visual_start, bt.boxes, bt.ori_wh, bt.obj, lab,
                      valid)
    for n, p in model.named_parameters():
        assert p.grad is not None, n
        if n.startswith("model.visual."):
            assert torch.equal(p.detach(), before[n]), n
    assert not torch.equal(model.out_proj.weight.detach(),
                           before["out_proj.weight"])


# ------------------------------------------------------------------- data
@pytest.fixture(scope="module")
def files(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("refsft")
    rng = np.random.default_rng(0)
    img_path = str(root / "img0.png")
    cv2.imwrite(img_path, (rng.random((32, 48, 3)) * 255).astype(np.uint8))
    chat = [{"image": img_path, "conversations": [
        {"from": "human", "value": "<image>\nDescribe the image"},
        {"from": "gpt", "value": "a colorful noise pattern"}]}]
    stage3 = [{"image": img_path, "class_name": "red blob",
               "bounding_boxes": [[2.0, 2.0, 20.0, 20.0],
                                  [30.0, 4.0, 44.0, 28.0]]},
              {"image": img_path, "class_name": "blob", "caption": "a blob",
               "bounding_boxes": [[8.0, 8.0, 30.0, 25.0]]}]
    props = {img_path: [[0.0, 0.0, 22.0, 22.0], [30.0, 5.0, 46.0, 30.0],
                        [10.0, 10.0, 40.0, 28.0], [1.0, 1.0, 9.0, 9.0]]}
    paths = {}
    for name, obj in (("chat", chat), ("stage3", stage3), ("props", props)):
        paths[name] = str(root / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    paths["image"] = img_path
    return paths


def _datasets(mod, stage, files, **kw):
    ids = dict(image_token_id=IMG, vision_start_token_id=VSTART,
               object_token_id=OBJ, patch=4, merge=2, seed=0)
    if stage == 3:
        return mod.ReferringSftDataset(files["stage3"], files["props"],
                                       StubTok(), max_proposals=8, **ids,
                                       **kw)
    return mod.ChatSftDataset(files["chat"], StubTok(), **ids, **kw)


def _same_sample(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("stage,kw", [
    (2, {}), (3, {}), (3, {"multiscale": True}),
    (3, {"grid_buckets": "make"})])
def test_datasets_and_step_inputs_match_jax(files, stage, kw):
    from wedetect_tpu_torch.data.vision_process import make_grid_buckets

    if kw.get("grid_buckets") == "make":
        kw = {"grid_buckets": make_grid_buckets(total_tokens=96,
                                                factor=8)}
    jds = _datasets(JD, stage, files, **kw)
    tds = _datasets(TD, stage, files, **kw)
    jcfg, tcfg = cfgs()
    for idx in (0, len(jds) - 1, 0):      # the second 0: rng advanced
        want, got = jds.sample(idx), tds.sample(idx)
        _same_sample(got, want)
        wb = JCLI.build_step_inputs(jcfg, want, stage, (256,), 8, 0)
        gb = TCLI.build_step_inputs(tcfg, got, stage, (256,), 8, 0)
        _same_sample(gb, wb)


def test_dataset_image_reader(files):
    """An in-memory reader in place of the file reader: the same sample."""
    import cv2

    img = cv2.cvtColor(cv2.imread(files["image"]), cv2.COLOR_BGR2RGB)
    a = _datasets(TD, 3, files).sample(0)
    b = _datasets(TD, 3, files,
                  image_reader={files["image"]: img}.__getitem__).sample(0)
    _same_sample(a, b)


def test_video_samples_raise(files, tmp_path):
    path = tmp_path / "video.json"
    path.write_text(json.dumps([{"video": ["a.png"], "conversations": [
        {"from": "human", "value": "<video>\nhi"}]}]))
    ds = TD.ChatSftDataset(str(path), StubTok(), image_token_id=IMG,
                           vision_start_token_id=VSTART)
    with pytest.raises(NotImplementedError):
        ds.sample(0)
    with pytest.raises(NotImplementedError):
        TCLI.main(["--stage", "3", "--data", "x", "--fsdp", "4"])


# ------------------------------------------------------- loop, checkpoint
def test_train_ref_loop_resume_is_bitwise(files, tiny, tmp_path):
    """A run that stops at a checkpoint and resumes from it ends bitwise
    equal to the same run kept in memory (model, Adam state, step)."""
    jcfg, tcfg, params = tiny
    kw = dict(seq_buckets=(256,), max_proposals=8, pad_token_id=0,
              log_every=100)

    def fresh():
        model = port_model(params, tcfg)
        return TrainState.create(model, TSFT.ref_optimizer(model,
                                                           base_lr=1e-3))

    ckpt = str(tmp_path / "ref3")
    a = TCLI.train_ref_loop(tcfg, fresh(), _datasets(TD, 3, files), 3, 2,
                            ckpt_dir=ckpt, ckpt_every=2, **kw)
    last = CIO.latest_checkpoint(ckpt)
    assert last is not None and last.endswith("step_2")
    a = TCLI.train_ref_loop(tcfg, a, _datasets(TD, 3, files), 3, 4, **kw)
    b = CIO.restore_train_state(last, fresh())
    assert b.step == 2
    b = TCLI.train_ref_loop(tcfg, b, _datasets(TD, 3, files), 3, 4, **kw)
    assert a.step == b.step == 4 and a.tx.count == b.tx.count == 4
    for (n, x), y in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(x, y), n
    for x, y in zip(a.tx.mu + a.tx.nu, b.tx.mu + b.tx.nu):
        assert torch.equal(x, y)


def test_train_ref_loop_stages_run_and_log(files, tiny):
    jcfg, tcfg, params = tiny
    seen = []
    for stage in (1, 2, 3):
        model = port_model(params, tcfg)
        tx = (TSFT.ref_optimizer(model, base_lr=2e-3) if stage == 3
              else TLM.stage_optimizer(model, stage))
        state = TCLI.train_ref_loop(
            tcfg, TrainState.create(model, tx), _datasets(TD, stage, files),
            stage, 2, seq_buckets=(256,), max_proposals=8, pad_token_id=0,
            log_every=1, log_fn=lambda s, m: seen.append(m))
        assert state.step == 2
    assert [m["stage"] for m in seen] == [1, 1, 2, 2, 3, 3]
    assert all(np.isfinite(m["loss"]) for m in seen)
