"""The port's Qwen3-VL (`wedetect_tpu_torch/nn/qwen3vl.py`) against the
JAX package on the same weights and inputs, on the CPU.

Tolerance 1e-4 on hidden states (f32; four ViT blocks or two decoder
layers of matmuls whose summation order differs between XLA's and
PyTorch's CPU kernels); the host-side position helpers are exact and
the MRoPE tables agree to 1e-6 (f32 pow and cos of positions < 100).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_ref_util import cfgs, jax_params, port_model
from wedetect_tpu.nn import qwen3vl as JQ
from wedetect_tpu_torch.nn import qwen3vl as TQ

TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = cfgs()
    params = jax_params(jcfg)
    return jcfg, tcfg, params, port_model(params, tcfg)


@pytest.mark.parametrize("gh,gw", [(8, 12), (8, 8)])
def test_vision_model_matches_jax(tiny, gh, gw):
    """(8, 12): 96 tokens padded to 128 (pad tokens in segment 0)."""
    jcfg, tcfg, params, model = tiny
    rng = np.random.default_rng(gh * gw)
    patches = rng.standard_normal((gh * gw, 96)).astype(np.float32)
    want, wtaps = JQ.VisionModel(jcfg.vision, gh, gw).apply(
        {"params": params["vision"]}, jnp.asarray(patches))
    with torch.no_grad():
        got, taps = model.model.visual(torch.from_numpy(patches), gh, gw)
    assert got.shape == want.shape and len(taps) == len(wtaps) == 2
    for a, b in zip([got, *taps], [want, *wtaps]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL)


def _text_inputs(seed, b=2, l=20, hidden=48, v=6, vs=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, hidden)).astype(np.float32)
    ids = np.zeros(l, np.int64)
    ids[vs:vs + 4] = 120
    pos = JQ.get_rope_index_single_image(ids, 120, 4, 4, 2)
    pos = np.broadcast_to(pos[:, None], (3, b, l)).astype(np.int32).copy()
    mask = np.ones((b, l), np.int32)
    mask[-1, -4:] = 0
    ds = [rng.standard_normal((4, hidden)).astype(np.float32)
          for _ in range(2)]
    return x, pos, mask, ds


def test_text_model_call_matches_jax(tiny):
    jcfg, tcfg, params, model = tiny
    x, pos, mask, ds = _text_inputs(0)
    want = JQ.TextModel(jcfg.text).apply(
        {"params": params["text"]}, jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(mask), [jnp.asarray(d) for d in ds], 3)
    with torch.no_grad():
        got = model.model.language_model(
            torch.from_numpy(x), torch.from_numpy(pos),
            torch.from_numpy(mask), [torch.from_numpy(d) for d in ds], 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_prefix_suffix_passes_match_jax(tiny):
    """prefix_pass (KV of every layer), suffix_pass and prefill_split."""
    jcfg, tcfg, params, model = tiny
    xp, pos, _, ds = _text_inputs(1, b=1, l=12)
    pmask = np.ones((1, 12), np.int32)
    pmask[0, -2:] = 0
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((3, 8, 48)).astype(np.float32)
    spos = np.broadcast_to((20 + np.arange(8))[None, None],
                           (3, 3, 8)).astype(np.int32).copy()
    smask = np.ones((3, 8), np.int32)
    smask[2, 5:] = 0
    jm = JQ.TextModel(jcfg.text)
    jv = {"params": params["text"]}
    jds = [jnp.asarray(d) for d in ds]
    kvs = jm.apply(jv, jnp.asarray(xp), jnp.asarray(pos), jnp.asarray(pmask),
                   jds, 3, method="prefix_pass")
    want = jm.apply(jv, kvs, jnp.asarray(xs), jnp.asarray(spos),
                    jnp.asarray(pmask), jnp.asarray(smask),
                    method="suffix_pass")
    want_split = jm.apply(jv, jnp.asarray(xp), jnp.asarray(xs),
                          jnp.asarray(pos), jnp.asarray(spos),
                          jnp.asarray(pmask), jnp.asarray(smask), jds, 3,
                          method="prefill_split")
    tm = model.model.language_model
    t = torch.from_numpy
    with torch.no_grad():
        tkvs = tm.prefix_pass(t(xp), t(pos), t(pmask),
                              [t(d) for d in ds], 3)
        got = tm.suffix_pass(tkvs, t(xs), t(spos), t(pmask), t(smask))
        got_split = tm.prefill_split(t(xp), t(xs), t(pos), t(spos),
                                     t(pmask), t(smask), [t(d) for d in ds],
                                     3)
    assert len(tkvs) == len(kvs) == 2
    for (a, b), (c, d) in zip(tkvs, kvs):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(d), atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got_split.numpy(), np.asarray(want_split),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("head_dim,section", [(16, (4, 2, 2)),
                                              (128, (24, 20, 20))])
def test_interleaved_mrope_matches_jax(head_dim, section):
    kw = dict(head_dim=head_dim, mrope_section=section, rope_theta=5e6)
    pos = np.random.default_rng(0).integers(0, 90, (3, 2, 11)).astype(
        np.int32)
    wc, ws = JQ.interleaved_mrope_cos_sin(jnp.asarray(pos),
                                          JQ.RefTextCfg(**kw))
    tc, ts = TQ.interleaved_mrope_cos_sin(torch.from_numpy(pos),
                                          TQ.RefTextCfg(**kw))
    np.testing.assert_allclose(tc.numpy(), np.asarray(wc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), atol=1e-6)


def test_position_helpers_exact():
    for gh, gw in ((8, 12), (30, 40), (4, 4)):
        np.testing.assert_array_equal(TQ.vision_pos_ids(gh, gw, 2),
                                      JQ.vision_pos_ids(gh, gw, 2))
        for a, b in zip(TQ.vision_pos_interp(gh, gw, 48, 2),
                        JQ.vision_pos_interp(gh, gw, 48, 2)):
            np.testing.assert_array_equal(a, b)
        ids = np.concatenate([np.arange(5), np.full(gh * gw // 4, 120),
                              np.arange(7)])
        np.testing.assert_array_equal(
            TQ.get_rope_index_single_image(ids, 120, gh, gw, 2),
            JQ.get_rope_index_single_image(ids, 120, gh, gw, 2))
    ids = np.arange(9)                                   # no image
    np.testing.assert_array_equal(
        TQ.get_rope_index_single_image(ids, 120, 4, 4, 2),
        JQ.get_rope_index_single_image(ids, 120, 4, 4, 2))


def test_presets_match_jax():
    for name in ("ref_2b", "ref_4b"):
        a, b = getattr(TQ, name)(), getattr(JQ, name)()
        assert a.vision.__dict__ == b.vision.__dict__
        assert a.text.__dict__ == b.text.__dict__
        assert (a.image_token_id, a.object_token_id) == \
            (b.image_token_id, b.object_token_id)
