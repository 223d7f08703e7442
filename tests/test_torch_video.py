"""The port's video preprocessing and video hidden states against the
JAX package, on the CPU.

- `smart_nframes`, `sample_frame_indices`, `video_frame_pixel_budget`
  and `get_rope_index_single_video`: equal.
- `fetch_video` over every source form and `video_to_patches`: bitwise.
- `RefModules.hidden_states(grid_t=2)` against JAX's
  `RefModules(grid_t=2)` through `train.ref_lm._hidden_states`, on the
  real rows: f32, max abs error <= 1e-5 * max(1, max |JAX|). The einsum
  route runs both packages' einsum attention; the flash route (decoder
  head_dim 128, attn_impl="flash") runs the port's K2 and K3 plain
  versions through their wrappers against JAX's einsum (the same
  function on every real row), as the JAX package runs its model on the
  CPU. Controls that must miss the same limit: the two temporal groups
  swapped, and image-layout rope ids in place of the video ones.
"""

import numpy as np
import pytest
import torch

import jax

from torch_ref_util import one_torch_thread  # noqa: F401
from torch_video_util import (VID, video_batch, video_cfgs, video_params)
from wedetect_tpu.data import vision_process as JV
from wedetect_tpu.models.ref import RefModules as JRefModules
from wedetect_tpu.nn import qwen3vl as JQ
from wedetect_tpu.train import ref_lm as JLM
from wedetect_tpu_torch.ckpt.convert_ref import from_jax_ref_params
from wedetect_tpu_torch.data import vision_process as TV
from wedetect_tpu_torch.models.ref import RefModules
from wedetect_tpu_torch.nn import qwen3vl as TQ

HIDDEN_TOL = 1e-5


# ------------------------------------------------------------ sampling
@pytest.mark.parametrize("args,kw", [
    ((300, 30.0), {}), ((10, 30.0), {}), ((100, 30.0), {"nframes": 9}),
    ((100, 30.0), {"nframes": 11}), ((10000, 30.0), {"max_frames": 7}),
    ((120, 24.0), {"fps": 1.0}), ((5000, 25.0), {}),
    ((37, 10.0), {"fps": 4.0, "min_frames": 6})])
def test_smart_nframes_matches_jax(args, kw):
    assert TV.smart_nframes(*args, **kw) == JV.smart_nframes(*args, **kw)


def test_smart_nframes_raises_as_jax():
    for mod in (TV, JV):
        with pytest.raises(ValueError):
            mod.smart_nframes(1, 30.0)


@pytest.mark.parametrize("total,n", [(300, 20), (12, 4), (7, 6), (2, 2)])
def test_sample_frame_indices_match_jax(total, n):
    got, want = TV.sample_frame_indices(total, n), \
        JV.sample_frame_indices(total, n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,kw", [
    (2, {}), (16, {}), (64, {}), (768, {}), (8, {"max_pixels": 200000}),
    (4, {"min_pixels": 50000, "total_pixels": 1e6}),
    (6, {"patch": 14, "merge": 2})])
def test_video_frame_pixel_budget_matches_jax(n, kw):
    assert TV.video_frame_pixel_budget(n, **kw) == \
        JV.video_frame_pixel_budget(n, **kw)


def test_constants_match_jax():
    for name in ("VIDEO_MIN_TOKEN_NUM", "VIDEO_MAX_TOKEN_NUM", "VIDEO_FPS",
                 "FRAME_FACTOR", "FPS_MIN_FRAMES", "FPS_MAX_FRAMES",
                 "MODEL_SEQ_LEN"):
        assert getattr(TV, name) == getattr(JV, name), name


# ---------------------------------------------------------- fetch_video
@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """One file or object of every source form fetch_video accepts."""
    import cv2
    from PIL import Image

    root = tmp_path_factory.mktemp("video_sources")
    rng = np.random.default_rng(0)
    frames = (rng.random((5, 32, 48, 3)) * 255).astype(np.uint8)
    fdir = root / "frames"
    fdir.mkdir()
    paths = []
    for i in range(5):
        p = str(fdir / f"f{i:02d}.png")
        Image.fromarray(frames[i]).save(p)
        paths.append(p)
    big = str(root / "big.png")
    Image.fromarray((rng.random((64, 96, 3)) * 255).astype(np.uint8)
                    ).save(big)
    npy, npz = str(root / "stack.npy"), str(root / "stack.npz")
    np.save(npy, frames)
    np.savez(npz, frames=frames[:4])
    gif = str(root / "clip.gif")
    g = [Image.fromarray((rng.random((32, 48, 3)) * 255).astype(np.uint8))
         for _ in range(30)]
    g[0].save(gif, save_all=True, append_images=g[1:], duration=100, loop=0)
    avi = str(root / "clip.avi")
    w = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (48, 32))
    assert w.isOpened()
    for f in frames:
        for _ in range(2):
            w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()
    return {"array": (frames, {}), "list": (paths[:4], {}),
            "list_odd": (paths, {}), "mixed": ([paths[0], big], {}),
            "directory": (str(fdir), {}),
            "glob": (str(fdir / "f0[0-3].png"), {}),
            "npy": (npy, {}), "npz": (npz, {}), "file_uri": ("file://" + npy,
                                                            {}),
            "gif": (gif, {}), "gif_fps": (gif, {"fps": 4.0}),
            "avi": (avi, {}), "avi_nframes": (avi, {"nframes": 6})}


@pytest.mark.parametrize("form", [
    "array", "list", "list_odd", "mixed", "directory", "glob", "npy", "npz",
    "file_uri", "gif", "gif_fps", "avi", "avi_nframes"])
def test_fetch_video_bitwise(sources, form):
    src, kw = sources[form]
    got, got_fps = TV.fetch_video(src, **kw)
    want, want_fps = JV.fetch_video(src, **kw)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got_fps == want_fps
    assert got.shape[0] % TV.FRAME_FACTOR == 0


def test_fetch_video_refuses_as_jax(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    for src in (123, str(empty), str(tmp_path / "none*.png"),
                str(tmp_path / "missing.mp4")):
        for mod in (TV, JV):
            with pytest.raises(ValueError):
                mod.fetch_video(src)


# ------------------------------------------------------ video_to_patches
@pytest.mark.parametrize("t,h,w,kw", [
    (4, 64, 96, {"patch": 4, "merge": 2}),
    (3, 64, 96, {"patch": 4, "merge": 2}),
    (5, 50, 70, {"patch": 4, "merge": 2, "min_pixels": 3000,
                 "max_pixels": 6000}),
    (16, 480, 640, {}),
    (1, 100, 90, {}),
    (6, 40, 400, {"total_pixels": 2e5})])
def test_video_to_patches_bitwise(t, h, w, kw):
    frames = (np.random.default_rng(t).random((t, h, w, 3)) * 255
              ).astype(np.uint8)
    got = TV.video_to_patches(frames, **kw)
    want = JV.video_to_patches(frames, **kw)
    assert got[1:] == want[1:]
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == -(-t // 2)


def test_full_width_clip_sizing():
    """16 frames at 480x640 under the default budget keep their size:
    grid 30 x 40, 8 temporal groups, 9600 ViT tokens (75 x 128) and 2400
    video tokens."""
    lo, hi = TV.video_frame_pixel_budget(16)
    assert TV.smart_resize(480, 640, 32, lo, hi) == (480, 640)


# ---------------------------------------------------------------- rope
@pytest.mark.parametrize("gt,gh,gw,before,after", [
    (2, 4, 6, 3, 2), (1, 4, 4, 2, 3), (5, 4, 4, 1, 4), (8, 60, 80, 4, 9),
    (3, 2, 2, 0, 0)])
def test_rope_index_single_video_matches_jax(gt, gh, gw, before, after):
    n = gt * (gh // 2) * (gw // 2)
    ids = np.concatenate([np.arange(1, before + 1), np.full(n, 77),
                          np.arange(5, 5 + after), np.zeros(3)]
                         ).astype(np.int64)
    got = TQ.get_rope_index_single_video(ids, 77, gt, gh, gw, 2)
    want = JQ.get_rope_index_single_video(ids, 77, gt, gh, gw, 2)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # text after the span resumes at st + max(grid_t, mh, mw)
    if after:
        assert got[0, before + n] == before + max(gt, gh // 2, gw // 2)


def test_rope_index_single_video_without_video():
    ids = np.arange(10)
    np.testing.assert_array_equal(
        TQ.get_rope_index_single_video(ids, 77, 2, 4, 4, 2),
        JQ.get_rope_index_single_video(ids, 77, 2, 4, 4, 2))


# ------------------------------------------------------- hidden states
def _jax_hidden(jcfg, params, bt, patches=None, pos=None):
    mod = JRefModules(jcfg, bt.gh, bt.gw, grid_t=bt.gt)
    fn = jax.jit(lambda p, *a: mod.apply({"params": p}, *a[:6],
                                         bt.visual_start, a[6],
                                         method=JLM._hidden_states))
    return np.asarray(fn(params, bt.patches if patches is None else patches,
                         bt.ids, bt.mask, bt.pos if pos is None else pos,
                         bt.boxes, bt.ori_wh, bt.obj))


def _port_hidden(model, bt, patches=None, pos=None):
    with torch.no_grad():
        return model.hidden_states(
            bt.patches if patches is None else patches, bt.ids, bt.mask,
            bt.pos if pos is None else pos, bt.boxes, bt.ori_wh,
            bt.visual_start, bt.obj, grid_h=bt.gh, grid_w=bt.gw,
            grid_t=bt.gt).numpy()


def _err(got, want, mask):
    real = mask.astype(bool)
    return float(np.abs(got[real] - want[real]).max()), \
        HIDDEN_TOL * max(1.0, float(np.abs(want[real]).max()))


def _port(params, tcfg, attn_impl):
    model = RefModules(tcfg, attn_impl=attn_impl)
    model.load_state_dict(from_jax_ref_params(params, tcfg), strict=True)
    return model.eval()


@pytest.fixture(scope="module", params=["einsum", "flash"])
def route(request):
    hd = 128 if request.param == "flash" else 16
    jcfg, tcfg = video_cfgs(head_dim=hd)
    params = video_params(jcfg, seed=3)
    model = _port(params, tcfg, "flash" if hd == 128 else "auto")
    return request.param, jcfg, params, model


@pytest.mark.parametrize("objects", [False, True])
def test_video_hidden_states_match_jax(route, objects):
    """grid_t = 2 at an 8 x 12 grid: 192 ViT tokens (padded to 256 on
    the flash route, one segment over both groups) and a 48-token video
    span; with `objects`, two <object> slots read the RoI pyramid of the
    first temporal group."""
    name, jcfg, params, model = route
    bt = video_batch(objects=objects, l_pad=128 if name == "flash" else None)
    want = _jax_hidden(jcfg, params, bt)
    got = _port_hidden(model, bt)
    err, tol = _err(got, want, bt.mask)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("control", ["swap_groups", "image_rope"])
def test_video_controls_miss(route, control):
    """The same model and text with the temporal groups swapped, or with
    image-layout rope ids over the video span (an image of grid_t * mh
    rows), must move the hidden states beyond the limit: time reaches
    the model through the patches and through the rope ids."""
    name, jcfg, params, model = route
    bt = video_batch(objects=True, l_pad=128 if name == "flash" else None)
    want = _jax_hidden(jcfg, params, bt)
    if control == "swap_groups":
        got = _port_hidden(model, bt, patches=bt.swap_groups())
    else:
        pos = np.zeros_like(bt.pos)
        for i in range(bt.ids.shape[0]):
            ids = np.where(bt.ids[i] == VID, 1000, bt.ids[i])
            pos[:, i] = TQ.get_rope_index_single_image(
                ids, 1000, bt.gt * bt.gh, bt.gw, 2)
        got = _port_hidden(model, bt, pos=pos)
    err, tol = _err(got, want, bt.mask)
    assert err > 100 * tol, (control, err, tol)


def test_image_path_unchanged_by_grid_t_default(route):
    """grid_t = 1 (every image path) through the video-aware code: the
    default and an explicit grid_t=1 are bitwise one call."""
    name, _, _, model = route
    bt = video_batch(gt=1, l_pad=128 if name == "flash" else None)
    a = _port_hidden(model, bt)
    with torch.no_grad():
        b = model.hidden_states(bt.patches, bt.ids, bt.mask, bt.pos,
                                bt.boxes, bt.ori_wh, bt.visual_start,
                                bt.obj, grid_h=bt.gh, grid_w=bt.gw).numpy()
    assert np.array_equal(a, b)


def test_vision_and_objects_match_jax(route):
    """The video's image tokens (every group, image pos-embeds repeated
    per group) and the RoI object features (the pyramid of the first
    temporal group) against JAX's `_vision_and_objects`."""
    _, jcfg, params, model = route
    bt = video_batch(objects=True)
    mod = JRefModules(jcfg, bt.gh, bt.gw, grid_t=bt.gt)
    tok_w, obj_w, _ = jax.jit(lambda p, *a: mod.apply(
        {"params": p}, *a, method=JRefModules._vision_and_objects))(
        params, bt.patches, bt.boxes, bt.ori_wh)
    with torch.no_grad():
        tok, _, scales = model._vision_one(torch.from_numpy(bt.patches),
                                           bt.gh, bt.gw, grid_t=bt.gt)
        obj = model._objects_from(scales, bt.boxes, bt.ori_wh)
    assert tok.shape[0] == bt.gt * (bt.gh // 2) * (bt.gw // 2)
    for got, want in ((tok.numpy(), np.asarray(tok_w)),
                      (obj.numpy(), np.asarray(obj_w))):
        err = float(np.abs(got - want).max())
        assert err <= HIDDEN_TOL * max(1.0, float(np.abs(want).max())), err
