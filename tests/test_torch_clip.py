"""The port's CLIP towers (`nn/clip.py`) and the pseudo-text backbone
(`nn/pseudo_text.py`) against the JAX modules at miniature widths: seeded
random flax params carried across with `from_jax_clip_text` /
`from_jax_clip_vision`, the same token ids (with and without an
attention mask) and images (NCHW on the port side). The HF key names are
pinned by a round trip through the JAX package's `convert_clip_text` /
`convert_clip_vision`.

Tolerance atol = rtol = 1e-4 (f32 both sides).
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wedetect_tpu.nn import clip as jclip
from wedetect_tpu.nn.pseudo_text import PseudoTextBackbone as JPseudo
from wedetect_tpu_torch.ckpt.convert import (from_jax_clip_text,
                                             from_jax_clip_vision)
from wedetect_tpu_torch.nn import clip as tclip
from wedetect_tpu_torch.nn.pseudo_text import PseudoTextBackbone

from torch_legacy_util import ATOL, RTOL, jax_apply, jax_init, nchw

TEXT = dict(vocab_size=99, hidden=32, layers=2, heads=4, intermediate=64,
            max_positions=16, projection_dim=24, eos_token_id=98)
VISION = dict(hidden=32, layers=2, heads=4, intermediate=64, image_size=32,
              patch=8)
IDS = np.array([[97, 5, 9, 98, 0, 0, 0],
                [97, 11, 12, 13, 14, 98, 0],
                [97, 98, 3, 4, 98, 0, 0]], np.int32)
MASK = (np.arange(IDS.shape[1])[None] <= np.argmax(IDS == 98, 1)[:, None]
        ).astype(np.int32)


@pytest.fixture(scope="module")
def text_tower():
    jm = jclip.ClipTextTower(jclip.ClipTextCfg(**TEXT))
    v = jax_init(jm, 0, IDS)
    cfg = tclip.ClipTextCfg(**TEXT)
    tm = tclip.ClipTextTower(cfg)
    tm.load_state_dict(from_jax_clip_text(v["params"], cfg), strict=True)
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def vision_tower():
    img = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jm = jclip.ClipVisionTower(jclip.ClipVisionCfg(**VISION))
    v = jax_init(jm, 1, img)
    cfg = tclip.ClipVisionCfg(**VISION)
    tm = tclip.ClipVisionTower(cfg)
    tm.load_state_dict(from_jax_clip_vision(v["params"], cfg), strict=True)
    return jm, v, tm.eval(), img


@pytest.mark.parametrize("masked", [False, True])
def test_text_tower_matches_jax(text_tower, masked):
    jm, v, tm = text_tower
    args = (IDS, MASK) if masked else (IDS,)
    want = np.asarray(jax_apply(jm, v, *args))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a).long() for a in args))
    assert got.dtype == torch.float32 and got.shape == (3, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)


def test_text_tower_mask_changes_output(text_tower):
    """Masking the keys after each row's first EOS leaves the output as
    it is (causal attention never reaches them from the EOS); masking a
    key before the EOS changes it."""
    _, _, tm = text_tower
    ids = torch.from_numpy(IDS).long()
    mask = torch.from_numpy(MASK).long()
    with torch.no_grad():
        free, masked = tm(ids), tm(ids, mask)
        hole = mask.clone()
        hole[1, 2] = 0
        holed = tm(ids, hole)
    torch.testing.assert_close(free, masked, atol=ATOL, rtol=RTOL)
    assert (holed[1] - free[1]).abs().max() > 1e-3


def test_vision_tower_matches_jax(vision_tower):
    jm, v, tm, img = vision_tower
    want = np.asarray(jax_apply(jm, v, img))
    with torch.no_grad():
        got = tm(nchw(img))
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_text_keys_round_trip_through_jax_converter(text_tower):
    _, v, tm = text_tower
    sd = {k: t.numpy() for k, t in tm.state_dict().items()}
    assert "text_model.encoder.layers.0.self_attn.q_proj.weight" in sd
    assert "text_model.embeddings.position_embedding.weight" in sd
    back = jclip.convert_clip_text(sd, jclip.ClipTextCfg(**TEXT))
    _same_tree(back, v["params"])


def test_vision_keys_round_trip_through_jax_converter(vision_tower):
    _, v, tm, _ = vision_tower
    sd = {k: t.numpy() for k, t in tm.state_dict().items()}
    assert "vision_model.pre_layrnorm.weight" in sd
    back = jclip.convert_clip_vision(sd, jclip.ClipVisionCfg(**VISION))
    _same_tree(back, v["params"])


def _same_tree(got, want):
    a = dict(jax.tree_util.tree_leaves_with_path(want))
    b = dict(jax.tree_util.tree_leaves_with_path(got))
    assert a.keys() == b.keys()
    for path, x in a.items():
        np.testing.assert_array_equal(np.asarray(b[path]), x)


def test_quick_gelu_matches_jax():
    x = np.linspace(-6, 6, 97).astype(np.float32)
    np.testing.assert_allclose(tclip.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jclip.quick_gelu(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


def test_block_bf16_casts(text_tower):
    """In bf16 the linears run in bf16 and LayerNorm, softmax and the
    output in f32: the bf16 tower stays within bf16 rounding of f32."""
    _, _, tm = text_tower
    bf = tclip.ClipTextTower(tm.cfg, dtype=torch.bfloat16)
    bf.load_state_dict(tm.state_dict())
    ids = torch.from_numpy(IDS).long()
    with torch.no_grad():
        got, want = bf.eval()(ids), tm(ids)
    assert got.dtype == torch.float32
    assert bf.text_model.final_layer_norm.weight.dtype == torch.float32
    assert (got - want).abs().max() < 5e-2


TABLE = {"person": [3.0, 4.0, 0.0], "dog": [0.0, 0.5, 0.5],
         "car": [-1.0, 2.0, 2.0]}


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("source", ["pickle", "table"])
def test_pseudo_text_matches_jax(tmp_path, normalize, source):
    if source == "pickle":
        path = tmp_path / "emb.pkl"
        path.write_bytes(pickle.dumps({k: np.asarray(v)
                                       for k, v in TABLE.items()}))
        kw = {"embedding_path": str(path)}
    else:
        kw = {"table": TABLE}
    texts = ["dog", "person", "car", "dog"]
    got = PseudoTextBackbone(normalize=normalize, device="cpu", **kw)(texts)
    want = JPseudo(normalize=normalize, **kw)(texts)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_pseudo_text_defaults_to_the_card():
    if torch.cuda.is_available():
        assert PseudoTextBackbone(table=TABLE)(["dog"]).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PseudoTextBackbone(table=TABLE)
