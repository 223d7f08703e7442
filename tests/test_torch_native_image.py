"""The port's JPEG decoder (cv2's libjpeg-turbo + the header, EXIF and
letterbox code of `wedetect_tpu_torch/native/image_pipeline.cc`)
against the JAX package's native decoder (libjpeg) and against cv2, on
the CPU.

Tolerances:
- decode_jpeg: bitwise the JAX package's (no resampling), for every
  chroma sampling, gray, progressive and odd sizes; the header's frame
  size and orientation those of the JAX package's libjpeg.
- decode_letterbox, exact and fast: scale factor, pad and ori shape
  bitwise the JAX package's; pixels within 1 LSB of its, on at most
  PIXEL_DIFF_SHARE of the values (a change of rounding would move most
  resampled values). The port builds without `-march=native`, which
  lets the JAX package's g++ contract the float resampling to FMA:
  measured here, no value differs on the upscales, the integer-ratio
  area path and the identity; 42 of 1,228,800 (3.4e-5), each by 1, on
  the non-integer area downscale 800 x 900 -> 640; 2 of 12,288
  (1.6e-4) on the 120 x 200 -> 64 x 64 letterbox.
- against cv2: the JAX package's own limits (tests/test_native_loader.py).
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import wedetect_tpu.native as jnative  # noqa: E402
from wedetect_tpu.data import loader as jloader  # noqa: E402
from wedetect_tpu.data import wds as JWDS  # noqa: E402
from wedetect_tpu.data.coco import CocoDetDataset as JDataset  # noqa: E402
from wedetect_tpu_torch import native  # noqa: E402
from wedetect_tpu_torch.data import loader as tloader  # noqa: E402
from wedetect_tpu_torch.data import wds as TWDS  # noqa: E402
from wedetect_tpu_torch.data.coco import CocoDetDataset  # noqa: E402
from wedetect_tpu_torch.ops.letterbox import preprocess_image  # noqa: E402

# the share of pixel values allowed to differ (by 1) from the JAX build
PIXEL_DIFF_SHARE = 1e-3
# tests/test_native_loader.py's letterbox cases, and two more: a
# non-integer area downscale and a >= 2x one (fast decode engages)
CASES = [((480, 640), (640, 640)), ((720, 1280), (640, 640)),
         ((300, 500), (320, 320)), ((640, 640), (640, 640)),
         ((800, 900), (640, 640)), ((1458, 2592), (640, 640))]
# an EXIF Orientation tag in an APP1 segment (value at byte 18)
TIFF = (b"II*\x00\x08\x00\x00\x00\x01\x00\x12\x01\x03\x00\x01\x00"
        b"\x00\x00\x06\x00\x00\x00\x00\x00\x00\x00")


def _synthetic(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1),
                    (xx + yy) % 256], -1).astype(np.uint8)
    noise = rng.integers(0, 32, img.shape, np.int32)
    return np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def _jpeg(img, quality=92, *flags):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, quality, *flags])
    assert ok
    return buf.tobytes()


def _exif(data, orient):
    tiff = TIFF[:18] + bytes([orient]) + TIFF[19:]
    body = b"Exif\x00\x00" + tiff
    return (data[:2] + b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big")
            + body + data[2:])


def _cv2_rgb(data):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _same_as_jax(got, want):
    """Metadata bitwise; pixels within 1 LSB on at most
    PIXEL_DIFF_SHARE of the values. Returns the count that differ."""
    assert got[3] == want[3]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].shape == want[0].shape
    d = np.abs(got[0].astype(np.int32) - want[0].astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).sum() <= PIXEL_DIFF_SHARE * d.size, (d > 0).sum()
    return int((d > 0).sum())


def test_build_links_no_libjpeg():
    """One route on every host: the library needs no libjpeg (cv2
    decodes), and is the port's own source built without -march."""
    import subprocess

    assert "-march=native" not in native.GXX_FLAGS
    assert native.IMAGE_SRC.parents[1].name == "wedetect_tpu_torch"
    so = native.build(native.IMAGE_SRC)
    deps = subprocess.run(["ldd", str(so)], capture_output=True,
                          text=True).stdout
    assert "libjpeg" not in deps and "nvjpeg" not in deps, deps


@pytest.mark.parametrize("shape,scale", CASES)
@pytest.mark.parametrize("fast", [False, True])
def test_letterbox_equals_jax(shape, scale, fast):
    data = _jpeg(_synthetic(*shape, seed=shape[0]))
    got = native.decode_letterbox(data, scale, fast=fast)
    want = jnative.decode_letterbox(data, scale, fast=fast)
    n = _same_as_jax(got, want)
    if shape != (800, 900):       # only the non-integer area downscale
        assert n == 0, n


@pytest.mark.parametrize("shape,scale", CASES[:4])
def test_letterbox_against_cv2(shape, scale):
    """tests/test_native_loader.py's limits against cv2 + preprocess."""
    data = _jpeg(_synthetic(*shape, seed=shape[0]))
    g_img, g_sf, g_pad, g_ori = native.decode_letterbox(data, scale)
    w_img, w_sf, w_pad, w_ori = preprocess_image(_cv2_rgb(data), scale)
    assert g_ori == tuple(w_ori)
    np.testing.assert_allclose(g_sf, w_sf, rtol=1e-6)
    np.testing.assert_array_equal(g_pad, w_pad)
    diff = np.abs(g_img.astype(np.int32) - w_img.astype(np.int32))
    assert np.mean(diff) < 1.5, np.mean(diff)
    assert np.quantile(diff, 0.99) <= 3, np.quantile(diff, 0.99)


def test_decode_against_cv2_and_jax():
    data = _jpeg(_synthetic(480, 640))
    got = native.decode_jpeg(data)
    np.testing.assert_array_equal(got, jnative.decode_jpeg(data))
    diff = np.abs(got.astype(np.int32) - _cv2_rgb(data).astype(np.int32))
    assert np.mean(diff) < 1.0
    assert np.quantile(diff, 0.999) <= 2
    assert native.jpeg_info(data) == (480, 640)


def test_fast_decode_tolerance_and_metadata():
    """DCT-scaled decode against exact on a >= 2x downscale: metadata
    exact, pixels within tests/test_native_loader.py's envelope."""
    data = _jpeg(_synthetic(1458, 2592))
    pe, sfe, pade, orie = native.decode_letterbox(data, (640, 640))
    pf, sff, padf, orif = native.decode_letterbox(data, (640, 640),
                                                  fast=True)
    assert orie == orif
    np.testing.assert_array_equal(sfe, sff)
    np.testing.assert_array_equal(pade, padf)
    diff = np.abs(pe.astype(np.int32) - pf.astype(np.int32))
    assert 0 < np.mean(diff) < 2.0, np.mean(diff)
    assert np.percentile(diff, 99) <= 12, np.percentile(diff, 99)


@pytest.mark.parametrize("orient", range(1, 9))
def test_exif_orientation(tmp_path, orient):
    """EXIF orientations 1-8: the shape and pixels of cv2.imread's
    upright image, the JAX package's decode bitwise, and the fused
    letterbox's ori_shape upright."""
    data = _exif(_jpeg(_synthetic(120, 200, seed=7), 95), orient)
    f = tmp_path / f"o{orient}.jpg"
    f.write_bytes(data)
    want = cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB)
    got = native.decode_jpeg(data)
    assert got.shape == want.shape == ((200, 120, 3) if orient >= 5
                                       else (120, 200, 3))
    np.testing.assert_array_equal(got, jnative.decode_jpeg(data))
    assert np.mean(np.abs(got.astype(np.int32) - want.astype(np.int32))) < 1
    assert native.jpeg_info(data) == want.shape[:2]
    r = native.decode_letterbox(data, (64, 64))
    _same_as_jax(r, jnative.decode_letterbox(data, (64, 64)))
    assert r[3] == want.shape[:2]


def test_exif_after_fill_bytes():
    """A 0xFF fill byte before the APP1 marker: the EXIF scanner skips it
    and still rotates."""
    data = _exif(_jpeg(_synthetic(60, 90, seed=11), 95), 6)
    data = data[:2] + b"\xff" + data[2:]
    got = native.decode_jpeg(data)
    assert got.shape == (90, 60, 3)
    np.testing.assert_array_equal(got, jnative.decode_jpeg(data))


def test_half_integer_letterbox_rounding():
    """41 x 61 letterboxed to (640, 480) hits nh = 322.5: ties to even,
    as Python's round() in preprocess_image."""
    data = _jpeg(_synthetic(41, 61, seed=3), 98)
    got = native.decode_letterbox(data, (640, 480))
    _, w_sf, w_pad, w_ori = preprocess_image(_cv2_rgb(data), (640, 480))
    np.testing.assert_allclose(got[1], w_sf, rtol=1e-6)
    np.testing.assert_array_equal(got[2], w_pad)
    assert got[3] == tuple(w_ori)
    _same_as_jax(got, jnative.decode_letterbox(data, (640, 480)))


@pytest.mark.parametrize("sampling", ["411", "420", "422", "440", "444"])
@pytest.mark.parametrize("shape", [(41, 61), (480, 640), (17, 3), (1, 5)])
def test_decode_is_libjpegs(sampling, shape):
    """cv2's libjpeg-turbo decodes as the JAX package's libjpeg, bit for
    bit, at every chroma sampling (odd sizes and planes of width <= 2
    included); at 480 x 640 also at each DCT scale of the fast path
    (held through decode_letterbox at the scaled size, where nothing is
    resized)."""
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    data = _jpeg(_synthetic(*shape, seed=shape[0]), 90,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag)
    np.testing.assert_array_equal(native.decode_jpeg(data),
                                  jnative.decode_jpeg(data))
    if shape == (480, 640):
        for denom in (2, 4, 8):
            size = (480 // denom, 640 // denom)
            assert native.load_image().wd_decode_scale(
                480, 640, 1, *size) == denom
            got = native.decode_letterbox(data, size, fast=True)
            want = jnative.decode_letterbox(data, size, fast=True)
            assert _same_as_jax(got, want) == 0


def test_decode_gray_progressive_exif_is_libjpegs():
    img = _synthetic(100, 130)
    for data in (_jpeg(img, 92, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
                 cv2.imencode(".jpg", img[..., 0])[1].tobytes(),
                 _exif(_jpeg(img), 8)):
        np.testing.assert_array_equal(native.decode_jpeg(data),
                                      jnative.decode_jpeg(data))
        assert native.jpeg_info(data) == jnative.decode_jpeg(data).shape[:2]


def test_header_rejects_what_libjpeg_rejects():
    """The header reader takes the frames the JAX package's libjpeg
    decodes to RGB and rejects the rest: 12-bit, lossless, a height of
    0, a scan before any frame, truncated segments."""
    data = _jpeg(_synthetic(40, 50))
    sof = data.index(b"\xff\xc0")
    bad = [data[:sof + 4] + b"\x0c" + data[sof + 5:],      # 12-bit
           data[:sof + 1] + b"\xc3" + data[sof + 2:],      # lossless
           data[:sof + 5] + b"\x00\x00" + data[sof + 7:],  # height 0
           data[:sof] + b"\xff\xda" + data[sof + 2:],      # scan first
           data[:sof + 6]]                                # truncated
    before = native.decode_fallbacks
    for b in bad:
        assert native.jpeg_info(b) is None
        assert native.decode_jpeg(b) is None
        assert native.decode_letterbox(b, (32, 32)) is None
    assert native.decode_fallbacks - before == 3 * len(bad)
    assert native.jpeg_info(data) == (40, 50)


def test_corrupt_and_cmyk_take_the_cv2_path(tmp_path):
    """A file the decoder rejects is decoded by cv2 for that file only,
    as in the JAX package: PNG bytes under a .jpg name and a CMYK JPEG
    (libjpeg has no CMYK -> RGB) give the JAX loader's sample bitwise
    and count one fallback each; garbage fails in both packages."""
    from PIL import Image

    img = _synthetic(50, 70, seed=4)
    cv2.imwrite(str(tmp_path / "png.jpg"), img)
    with open(tmp_path / "png.jpg", "wb") as f:
        f.write(cv2.imencode(".png", img)[1].tobytes())
    Image.fromarray(img).convert("CMYK").save(tmp_path / "cmyk.jpg",
                                              quality=95)
    (tmp_path / "bad.jpg").write_bytes(b"\xff\xd8" + bytes(range(256)))
    ann = {"images": [{"id": i + 1, "file_name": n, "width": 70,
                       "height": 50}
                      for i, n in enumerate(("png.jpg", "cmyk.jpg",
                                             "bad.jpg"))],
           "annotations": [], "categories": [{"id": 1, "name": "a"}]}
    import json

    (tmp_path / "ann.json").write_text(json.dumps(ann))
    tds = CocoDetDataset(str(tmp_path / "ann.json"), str(tmp_path))
    jds = JDataset(str(tmp_path / "ann.json"), str(tmp_path))
    before = native.decode_fallbacks
    for i in (0, 1):
        for fast in (False, True):
            got = tloader.eval_sample(tds, i, (64, 64), fast_decode=fast)
            want = jloader.eval_sample(jds, i, (64, 64), fast_decode=fast)
            for k in ("image", "scale_factor", "pad_param", "ori_shape"):
                np.testing.assert_array_equal(got[k], want[k])
    assert native.decode_fallbacks - before == 4
    assert native.decode_jpeg((tmp_path / "cmyk.jpg").read_bytes()) is None
    for loader, ds in ((tloader, tds), (jloader, jds)):
        with pytest.raises(FileNotFoundError):
            loader.eval_sample(ds, 2, (64, 64))


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no loaded decoder."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_image_lib", None)
    return tmp_path / "build"


def test_build_without_gxx_raises(fresh_build, monkeypatch):
    monkeypatch.setenv("PATH", str(fresh_build))
    with pytest.raises(RuntimeError, match="g\\+\\+ could not run"):
        native.decode_jpeg(_jpeg(_synthetic(8, 8)))
    assert native._image_lib is None


@pytest.mark.parametrize("fast", [False, True])
def test_eval_sample_equals_jax(tmp_path, fast):
    """eval_sample on JPEG files (one a >= 2x downscale, one rotated):
    the JAX package's sample, pixels as in _same_as_jax."""
    import json

    names = []
    for i, (h, w) in enumerate(((300, 500), (1458, 2592), (120, 200))):
        data = _jpeg(_synthetic(h, w, seed=i))
        if i == 2:
            data = _exif(data, 6)
        names.append(f"{i}.jpg")
        (tmp_path / names[-1]).write_bytes(data)
    ann = {"images": [{"id": i + 1, "file_name": n, "width": 1, "height": 1}
                      for i, n in enumerate(names)],
           "annotations": [], "categories": [{"id": 1, "name": "a"}]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    tds = CocoDetDataset(str(tmp_path / "ann.json"), str(tmp_path))
    jds = JDataset(str(tmp_path / "ann.json"), str(tmp_path))
    before = native.decode_fallbacks
    for i in range(3):
        got = tloader.eval_sample(tds, i, (320, 320), fast_decode=fast)
        want = jloader.eval_sample(jds, i, (320, 320), fast_decode=fast)
        _same_as_jax((got["image"], got["scale_factor"], got["pad_param"],
                      tuple(got["ori_shape"])),
                     (want["image"], want["scale_factor"],
                      want["pad_param"], tuple(want["ori_shape"])))
        assert got["img_id"] == want["img_id"]
    assert native.decode_fallbacks == before
    batches = list(tloader.EvalLoader(tds, (320, 320), batch_size=2,
                                      fast_decode=fast))
    first = tloader.eval_sample(tds, 0, (320, 320), fast_decode=fast)
    np.testing.assert_array_equal(batches[0]["images"][0], first["image"])


def test_wds_decode_equals_jax():
    """The shard reader's _decode: the native decode, bitwise the JAX
    package's."""
    import json

    img = _synthetic(40, 50, seed=2)
    raw = {"jpg": _jpeg(img),
           "json": json.dumps({"annotations": [
               {"bbox": [5, 5, 20, 20], "text_ch": "a"}]}).encode()}
    t = TWDS.WdsDetDataset.__new__(TWDS.WdsDetDataset)
    j = JWDS.WdsDetDataset.__new__(JWDS.WdsDetDataset)
    for ds in (t, j):
        ds.ann_key, ds.label_key = "annotations", "text_ch"
        ds.en_zh_map, ds.base_class_texts, ds.neg_queue = {}, None, None
    got, want = t._decode(raw), j._decode(raw)
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["image"], native.decode_jpeg(raw["jpg"]))
