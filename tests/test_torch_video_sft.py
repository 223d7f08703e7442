"""The port's video SFT samples (`data/sft_chat.ChatSftDataset` video
entries, `cli/train_ref.build_step_inputs`, `train/ref_lm.ref_lm_step`
at grid_t > 1, the train_ref CLI) against the JAX package on the CPU, at
the tiny video Ref (tests/torch_video_util.py).

Tolerances: samples and step inputs exactly; two stage-2 steps to 1e-5
relative in loss and grad_norm, and the first step's gradients to 1e-5
of each tensor's largest entry (the terms of tests/
test_torch_train_ref.py). The einsum route runs both packages' einsum
attention; the flash route (decoder head_dim 128, attn_impl="flash")
runs the port's K2 and K3 plain forward and backward through their
autograd Functions against JAX's einsum.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_ref_util import one_torch_thread  # noqa: F401 (autouse)
from torch_video_util import IMG, OBJ, VID, VSTART, video_cfgs, video_params
from wedetect_tpu.cli import train_ref as JCLI
from wedetect_tpu.data import sft_chat as JD
from wedetect_tpu.models.ref import RefModules as JRefModules
from wedetect_tpu.train import ref_lm as JLM
from wedetect_tpu.train.train_step import TrainState as JState
from wedetect_tpu_torch.ckpt.convert_ref import from_jax_ref_params
from wedetect_tpu_torch.cli import train_ref as TCLI
from wedetect_tpu_torch.data import sft_chat as TD
from wedetect_tpu_torch.models.ref import RefModules
from wedetect_tpu_torch.train import ref_lm as TLM
from wedetect_tpu_torch.train.train_step import TrainState

SEQ = (512,)


class StubTok:
    pad_token_id = 0

    def encode(self, s, add_special_tokens=False):
        return [ord(c) % 100 for c in s][:6]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Three 32x48 PNG frames (a list: 3 frames pad to 2 temporal
    groups) and an MJPG .avi of 12 frames at 10 fps, each in a chat json
    with a <video> turn; and a json mixing an image and a video sample."""
    import cv2

    root = tmp_path_factory.mktemp("video_sft")
    rng = np.random.default_rng(0)
    frames = (rng.random((6, 32, 48, 3)) * 255).astype(np.uint8)
    paths = []
    for i in range(3):
        p = str(root / f"f{i}.png")
        cv2.imwrite(p, cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR))
        paths.append(p)
    avi = str(root / "clip.avi")
    w = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (48, 32))
    assert w.isOpened()
    for f in frames:
        for _ in range(2):
            w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()
    conv = [{"from": "human", "value": "<video>\nDescribe the clip"},
            {"from": "gpt", "value": "random colors flicker"}]
    out = {}
    for name, video in (("frames", paths), ("avi", avi)):
        out[name] = str(root / f"{name}.json")
        with open(out[name], "w") as f:
            json.dump([{"video": video, "conversations": conv}], f)
    out["mixed"] = str(root / "mixed.json")
    with open(out["mixed"], "w") as f:
        json.dump([{"video": paths, "conversations": conv},
                   {"image": paths[0], "conversations": [
                       {"from": "human", "value": "<image>\nWhat is it"},
                       {"from": "gpt", "value": "noise"}]}], f)
    return out


def _dataset(mod, path, seed=0):
    return mod.ChatSftDataset(path, StubTok(), image_token_id=IMG,
                              vision_start_token_id=VSTART,
                              object_token_id=OBJ, video_token_id=VID,
                              patch=4, merge=2, seed=seed)


def _same(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("src", ["frames", "avi"])
def test_video_sample_and_step_inputs_match_jax(files, src):
    """A video sample bitwise (ids, labels, patches, grid, grid_t,
    visual_start, the first frame, the dummy boxes and ori_wh), one
    contiguous span of grid_t * mh * mw video tokens; then the step's
    padded inputs with get_rope_index_single_video ids."""
    jcfg, tcfg = video_cfgs()
    got, want = _dataset(TD, files[src]).sample(0), \
        _dataset(JD, files[src]).sample(0)
    _same(got, want)
    gh, gw = got["grid"]
    n_vid = got["grid_t"] * (gh // 2) * (gw // 2)
    assert got["grid_t"] == 2
    vs = got["visual_start"]
    assert (got["input_ids"][vs:vs + n_vid] == VID).all()
    assert (got["input_ids"] == VID).sum() == n_vid
    _same(TCLI.build_step_inputs(tcfg, got, 2, SEQ, 4, 0),
          JCLI.build_step_inputs(jcfg, want, 2, SEQ, 4, 0))


def test_mixed_dataset_retries_match_jax(files, tmp_path):
    """Image and video samples in one json, and a broken video entry
    replaced by a random sample as JAX's sample() does (no sample kind
    raises at once any more)."""
    for idx in (0, 1, 0):
        _same(_dataset(TD, files["mixed"]).sample(idx),
              _dataset(JD, files["mixed"]).sample(idx))
    bad = tmp_path / "bad.json"
    data = json.load(open(files["mixed"]))
    data.insert(0, {"video": [str(tmp_path / "missing.png")],
                    "conversations": data[0]["conversations"]})
    bad.write_text(json.dumps(data))
    for seed in (0, 1):
        _same(_dataset(TD, str(bad), seed).sample(0),
              _dataset(JD, str(bad), seed).sample(0))


def _step_batch(files, tcfg):
    sample = _dataset(TD, files["frames"]).sample(0)
    return TCLI.build_step_inputs(tcfg, sample, 2, SEQ, 4, 0)


def _jax_grads(jcfg, b, params):
    gh, gw = b["grid"]
    mod = JRefModules(jcfg, gh, gw, grid_t=b["grid_t"])

    def loss(p):
        hidden = mod.apply({"params": p}, b["patches"], b["input_ids"],
                           b["attn_mask"], b["position_ids"], b["boxes"],
                           b["ori_wh"], b["visual_start"],
                           b["object_positions"], method=JLM._hidden_states)
        emb = p["embed"]["embed_tokens"]["embedding"]
        return JLM.lm_cross_entropy(hidden @ emb.T, b["labels"])

    return jax.jit(jax.grad(loss))(params)


@pytest.mark.parametrize("route", ["einsum", "flash"])
def test_video_lm_steps_match_jax(files, route):
    """Two stage-2 ref_lm_steps on the frame-list sample (grid_t = 2,
    20 x 28 grid: 1120 ViT tokens, padded to 1152 on the flash route;
    280 video tokens in a 512 bucket): loss, grad_norm and the first
    step's gradients, the vision tower's included (stage 2 freezes it
    with a zero lr, not by dropping its gradient)."""
    hd = 128 if route == "flash" else 16
    jcfg, tcfg = video_cfgs(head_dim=hd)
    params = video_params(jcfg, seed=3)
    model = RefModules(tcfg, attn_impl="flash" if route == "flash"
                       else "auto")
    model.load_state_dict(from_jax_ref_params(params, tcfg), strict=True)
    b = _step_batch(files, tcfg)
    gh, gw = b["grid"]
    keys = ("patches", "input_ids", "attn_mask", "position_ids",
            "visual_start", "boxes", "ori_wh", "object_positions")
    args = [b[k] for k in keys]
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    jp = jax.tree.map(jnp.asarray, params)
    lr = 1e-5
    js = JState.create({"params": jp}, JLM.stage_optimizer(jp, 2,
                                                           base_lr=lr))
    ts = TrainState.create(model, TLM.stage_optimizer(model, 2, base_lr=lr))
    jgrads = _jax_grads(jcfg, b, jp)
    for step in range(2):
        js, jm = JLM.ref_lm_step(jcfg, gh, gw, js, *jargs,
                                 jnp.asarray(b["labels"]), b["grid_t"])
        ts, tm = TLM.ref_lm_step(tcfg, gh, gw, ts, *args, b["labels"],
                                 b["grid_t"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        if step == 0:
            want = from_jax_ref_params(jax.tree.map(np.asarray, jgrads),
                                       tcfg)
            for n, p in model.named_parameters():
                g = torch.zeros_like(p) if p.grad is None else p.grad
                w = want[n]
                err = float((g - w).abs().max())
                assert err <= 1e-5 * max(float(w.abs().max()), 1e-6), \
                    (n, err)
            assert float(model.model.visual.blocks[0].attn.qkv.weight.grad
                         .abs().max()) > 0
    assert ts.step == int(js.step) == 2


def test_caption_only_slots_gradient_matches_jax(files):
    """An image caption sample under build_step_inputs: every proposal
    slot is padding (-1), so several slots fall on one scratch place and
    none on a real token. One stage-2 step: JAX's loss and grad_norm to
    1e-5, the token table's gradient to 1e-5 of its largest entry (each
    real token's gradient counted once)."""
    jcfg, tcfg = video_cfgs()
    params = video_params(jcfg, seed=4)
    model = RefModules(tcfg)
    model.load_state_dict(from_jax_ref_params(params, tcfg), strict=True)
    sample = _dataset(TD, files["mixed"]).sample(1)
    assert sample["grid_t"] == 1
    b = TCLI.build_step_inputs(tcfg, sample, 2, SEQ, 4, 0)
    assert (b["object_positions"] == -1).all()
    gh, gw = b["grid"]
    jp = jax.tree.map(jnp.asarray, params)
    js = JState.create({"params": jp}, JLM.stage_optimizer(jp, 2))
    ts = TrainState.create(model, TLM.stage_optimizer(model, 2))
    keys = ("patches", "input_ids", "attn_mask", "position_ids",
            "visual_start", "boxes", "ori_wh", "object_positions")
    want = from_jax_ref_params(jax.tree.map(np.asarray,
                                            _jax_grads(jcfg, b, jp)), tcfg)
    _, jm = JLM.ref_lm_step(jcfg, gh, gw, js,
                            *[jnp.asarray(b[k]) if k != "visual_start"
                              else b[k] for k in keys],
                            jnp.asarray(b["labels"]), 1)
    _, tm = TLM.ref_lm_step(tcfg, gh, gw, ts, *[b[k] for k in keys],
                            b["labels"], 1)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    name = "model.language_model.embed_tokens.weight"
    g = dict(model.named_parameters())[name].grad
    err = float((g - want[name]).abs().max())
    assert err <= 1e-5 * float(want[name].abs().max()), err


def test_train_ref_cli_on_video_json(files, monkeypatch, tmp_path, capsys):
    """cli/train_ref at stage 2 for two steps on the video json (the
    checkpoint loader stubbed with the tiny video Ref): finite losses
    logged and a checkpoint written."""
    from wedetect_tpu_torch.cli import _ref_load

    jcfg, tcfg = video_cfgs()
    params = video_params(jcfg, seed=3)

    def load_ref(checkpoint, device="cuda"):
        model = RefModules(tcfg)
        model.load_state_dict(from_jax_ref_params(params, tcfg), strict=True)
        return tcfg, model.to(device).eval(), StubTok()

    monkeypatch.setattr(_ref_load, "load_ref", load_ref)
    ckpt = str(tmp_path / "ref2")
    TCLI.main(["--stage", "2", "--data", files["avi"], "--steps", "2",
               "--log-every", "1", "--seq-buckets", "512", "--ckpt-dir",
               ckpt, "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(line.split("'loss': ")[1].split(",")[0])
              for line in out.splitlines() if "'loss'" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    from wedetect_tpu_torch.ckpt.io import latest_checkpoint
    assert latest_checkpoint(ckpt).endswith("step_2")
