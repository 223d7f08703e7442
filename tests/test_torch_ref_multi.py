"""The port's multi-image and cross-image Ref entry points against the JAX
package on the CPU: `get_rope_index_multi`, `RefModules.score_multi` and
`prefix_stage_multi`, `ref_rec_batch_step`, `RefScorer.score_rec` and
`score_multi_images`, and `ref_generate_multi`, on the miniature configs
of torch_ref_util with the JAX parameters carried into the port.

Logits are held at f32 atol 1e-5, rtol 1e-4 (as test_torch_ref_api.py
holds `score`); sigmoid scores likewise. Greedy tokens and MRoPE ids are
held exactly. A control that gives every suffix row image 0's KV must
miss the cross-image step's limit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_ref_util import (IMG, OBJ, VSTART, FakeTok, cfgs, jax_params,
                            one_torch_thread, port_model)  # noqa: F401
from wedetect_tpu.models import ref as JR
from wedetect_tpu.models.ref_api import RefScorer as JRefScorer
from wedetect_tpu.models.ref_generate import ref_generate_multi as j_gen_multi
from wedetect_tpu.nn.qwen3vl import get_rope_index_multi as j_rope_multi
from wedetect_tpu.nn.qwen3vl import get_rope_index_single_image
from wedetect_tpu_torch.models import ref as TR
from wedetect_tpu_torch.models.ref_api import RefScorer
from wedetect_tpu_torch.models.ref_generate import (ref_generate,
                                                    ref_generate_multi)
from wedetect_tpu_torch.nn.qwen3vl import get_rope_index_multi

TOL = dict(atol=1e-5, rtol=1e-4)
PATCH_DIM = 96


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = cfgs()
    params = jax_params(jcfg)
    return jcfg, tcfg, params, port_model(params, tcfg)


def _n_img(g):
    return (g[0] // 2) * (g[1] // 2)


def _multi_ids(grids, tail):
    """A sequence with one vision span an image (text between them) and
    `tail` after the last: (ids, visual_starts)."""
    ids, starts = [1, 2], []
    for i, g in enumerate(grids):
        ids.append(VSTART)
        starts.append(len(ids))
        ids += [IMG] * _n_img(g) + [7 + i]
    return np.array(ids + list(tail), np.int32), tuple(starts)


@pytest.mark.parametrize("grids", [((8, 8),), ((8, 12), (4, 8)),
                                   ((4, 4), (12, 8), (8, 4)),
                                   ((2, 16), (16, 2))])
def test_get_rope_index_multi_bitwise(grids):
    ids, _ = _multi_ids(grids, [9, 8, 5, OBJ, OBJ, 2])
    got = get_rope_index_multi(ids, IMG, grids, 2)
    np.testing.assert_array_equal(got, j_rope_multi(ids, IMG, grids, 2))
    # text after image i resumes at its start + max(mh_i, mw_i)
    st = int(np.nonzero(ids == IMG)[0][0])
    g = grids[0]
    assert got[0, st + _n_img(g)] == st + max(g[0] // 2, g[1] // 2)


# three images, the middle one context only (no boxes)
GRIDS = ((8, 12), (4, 8), (8, 8))
ORI = [np.array(v, np.float32) for v in ([96.0, 64.0], [64.0, 32.0],
                                         [64.0, 64.0])]
BOXES = [np.array([[4, 4, 60, 40], [10, 8, 90, 60]], np.float32), None,
         np.array([[0, 0, 30, 30], [8, 5, 60, 50], [2, 2, 9, 9]],
                  np.float32)]


def _multi_case(seed=3):
    rng = np.random.default_rng(seed)
    patches = [rng.standard_normal((g[0] * g[1], PATCH_DIM))
               .astype(np.float32) for g in GRIDS]
    n_obj = sum(len(b) for b in BOXES if b is not None)
    tails = [[9, 8, 5] + [OBJ] * n_obj + [2], [11] + [OBJ] * n_obj + [2]]
    ids, starts = _multi_ids(GRIDS, tails[0])
    l = len(ids) + 4
    rows = [_multi_ids(GRIDS, t)[0] for t in tails]
    input_ids = np.zeros((2, l), np.int32)
    mask = np.zeros((2, l), np.int32)
    pos = np.zeros((3, 2, l), np.int32)
    objp = np.zeros((2, n_obj), np.int32)
    for i, r in enumerate(rows):
        input_ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
        pos[:, i] = j_rope_multi(np.pad(r, (0, l - len(r))), IMG, GRIDS, 2)
        objp[i] = np.nonzero(r == OBJ)[0]
    return patches, starts, input_ids, mask, pos, objp


def test_score_multi_matches_jax(tiny):
    jcfg, _, params, model = tiny
    patches, starts, ids, mask, pos, objp = _multi_case()
    want = JR.ref_score_step_multi(
        jcfg, GRIDS, params, tuple(map(jnp.asarray, patches)),
        jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pos),
        tuple(None if b is None else jnp.asarray(b) for b in BOXES),
        tuple(map(jnp.asarray, ORI)), starts, jnp.asarray(objp))
    got = TR.ref_score_step_multi(model, GRIDS, patches, ids, mask, pos,
                                  BOXES, ORI, starts, objp)
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefix_stage_multi_matches_jax(tiny):
    jcfg, _, params, model = tiny
    patches, starts, ids, mask, pos, _ = _multi_case()
    p = int(np.nonzero(ids[0] == 9)[0][0])       # the prefix ends at 9
    p_pad = p + 3
    pids = np.zeros((1, p_pad), np.int32)
    pids[0, :p] = ids[0, :p]
    pmask = np.zeros((1, p_pad), np.int32)
    pmask[0, :p] = 1
    ppos = np.zeros((3, 1, p_pad), np.int32)
    ppos[:, 0, :p] = pos[:, 0, :p]
    jobj, jkvs = JR.ref_prefix_step_multi(
        jcfg, GRIDS, params, tuple(map(jnp.asarray, patches)),
        jnp.asarray(pids), jnp.asarray(pmask), jnp.asarray(ppos),
        tuple(None if b is None else jnp.asarray(b) for b in BOXES),
        tuple(map(jnp.asarray, ORI)), starts)
    obj, kvs = TR.ref_prefix_step_multi(model, GRIDS, patches, pids, pmask,
                                        ppos, BOXES, ORI, starts)
    assert obj.shape == (5, 48)
    np.testing.assert_allclose(obj.numpy(), np.asarray(jobj), **TOL)
    for (k, v), (jk, jv) in zip(kvs, jkvs):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def _rec_case(b=3, gh=8, gw=12, n=3, seed=4):
    """B images of one grid, one query row each, laid out as
    RefScorer.score_rec lays a chunk out (JAX's argument layout)."""
    rng = np.random.default_rng(seed)
    n_img = _n_img((gh, gw))
    patches = rng.standard_normal((b, gh * gw, PATCH_DIM)).astype(np.float32)
    boxes = rng.uniform(0, 40, (b, n, 4)).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2] + 4
    ori = np.tile(np.array([[96.0, 64.0]], np.float32), (b, 1))
    ori[1] = [80.0, 60.0]
    prefix = np.concatenate([[1, 2, VSTART], np.full(n_img, IMG), [7]])
    p_real, p_pad, s_pad = len(prefix), len(prefix) + 5, 12
    pids = np.zeros((b, p_pad), np.int32)
    pids[:, :p_real] = prefix
    pmask = np.zeros((b, p_pad), np.int32)
    pmask[:, :p_real] = 1
    ppos = np.zeros((b, 3, 1, p_pad), np.int32)
    ppos[:, :, 0, :p_real] = get_rope_index_single_image(prefix, IMG, gh,
                                                         gw, 2)
    nxt = int(ppos.max()) + 1
    sids = np.zeros((b, s_pad), np.int32)
    smask = np.zeros((b, s_pad), np.int32)
    objp = np.zeros((b, n), np.int32)
    for i in range(b):
        suf = np.concatenate([rng.integers(2, 60, 2 + i), np.full(n, OBJ),
                              [2]])
        sids[i, :len(suf)] = suf
        smask[i, :len(suf)] = 1
        objp[i] = np.nonzero(suf == OBJ)[0]
    spos = np.broadcast_to((nxt + np.arange(s_pad))[None, None],
                           (3, b, s_pad)).astype(np.int32).copy()
    return (gh, gw, patches, pids, pmask, ppos, boxes, ori, 3, sids, smask,
            spos, objp)


def test_ref_rec_batch_step_matches_jax_and_per_image(tiny, monkeypatch):
    jcfg, _, params, model = tiny
    (gh, gw, patches, pids, pmask, ppos, boxes, ori, vs, sids, smask, spos,
     objp) = case = _rec_case()
    want = np.asarray(JR.ref_rec_batch_step(
        jcfg, gh, gw, params, *map(jnp.asarray, (patches, pids, pmask,
                                                 ppos, boxes, ori)),
        vs, jnp.float32, "auto", *map(jnp.asarray, (sids, smask, spos,
                                                    objp))))
    got = TR.ref_rec_batch_step(model, *case).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # each row equals its image's own prefix and suffix stages
    for i in range(len(patches)):
        obj, kvs = TR.ref_prefix_step(model, gh, gw, patches[i],
                                      pids[i:i + 1], pmask[i:i + 1],
                                      ppos[i], boxes[i], ori[i], vs)
        row = TR.ref_suffix_step(model, obj, kvs, sids[i:i + 1],
                                 smask[i:i + 1], spos[:, i:i + 1],
                                 pmask[i:i + 1], objp[i:i + 1])
        np.testing.assert_allclose(got[i:i + 1], row.numpy(), **TOL)
    # control: every suffix row reads image 0's prefix KV
    stage = TR.RefModules.suffix_stage

    def image0_kv(self, obj, kvs, *a):
        kvs = tuple((k[:1].expand_as(k), v[:1].expand_as(v))
                    for k, v in kvs)
        return stage(self, obj, kvs, *a)

    monkeypatch.setattr(TR.RefModules, "suffix_stage", image0_kv)
    wrong = TR.ref_rec_batch_step(model, *case).numpy()
    np.testing.assert_allclose(wrong[0], got[0], **TOL)
    assert np.abs(wrong[1:] - want[1:]).max() > 1e-5 + 1e-4 * np.abs(
        want[1:]).max()


def test_vision_batched_equals_single(tiny):
    """The ViT over (B, S, Dp) (one attention call a block, through the
    K3 route's plain version) equals each image alone."""
    _, _, _, model = tiny
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 96, PATCH_DIM))
                         .astype(np.float32))
    vis = model.model.visual
    with torch.no_grad():
        out, taps = vis(x, 8, 12, attn_impl="flash")
        for i in range(3):
            o1, t1 = vis(x[i], 8, 12, attn_impl="flash")
            np.testing.assert_allclose(out[i].numpy(), o1.numpy(),
                                       atol=1e-6, rtol=1e-5)
            for a, b in zip(taps, t1):
                np.testing.assert_allclose(a[i].numpy(), b.numpy(),
                                           atol=1e-6, rtol=1e-5)


def _images(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, s + (3,), dtype=np.uint8) for s in sizes]


def _props(rng, h, w, n):
    p = rng.uniform(0, min(h, w) - 10, (n, 4)).astype(np.float32)
    p[:, 2:] += p[:, :2] + 6
    return p


def test_score_rec_matches_jax_and_per_image(tiny):
    """Two grid buckets, a padded chunk and samples out of bucket order:
    the port's fused steps equal JAX's score_rec and its own per-image
    logits(); without grid buckets every sample goes through logits()."""
    jcfg, tcfg, params, model = tiny
    rng = np.random.default_rng(11)
    sizes = [(30, 50), (50, 30), (31, 47), (33, 52), (49, 31), (29, 51)]
    samples = [(im, _props(rng, *im.shape[:2], 2 + i % 2), f"thing {i}")
               for i, im in enumerate(_images(12, sizes))]
    common = dict(tokenizer=FakeTok(), query_batch=3, max_proposals=3,
                  grid_buckets=((32, 48), (48, 32)))
    want = JRefScorer(cfg=jcfg, params=params, **common).score_rec(
        samples, pad_token_id=0)
    scorer = RefScorer(cfg=tcfg, model=model, device="cpu", **common)
    got = scorer.score_rec(samples, pad_token_id=0)
    logits = scorer.rec_logits(samples, pad_token_id=0)
    for (im, pr, q), g, w, lg in zip(samples, got, want, logits):
        assert g.shape == w.shape == (len(pr),)
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_allclose(
            lg, scorer.logits(im, pr, [q], pad_token_id=0)[0], **TOL)
    per_image = RefScorer(cfg=tcfg, model=model, device="cpu",
                          **{**common, "grid_buckets": None})
    for (im, pr, q), lg in zip(samples[:2], per_image.rec_logits(
            samples[:2], pad_token_id=0)):
        np.testing.assert_array_equal(
            lg, per_image.logits(im, pr, [q], pad_token_id=0)[0])


@pytest.mark.parametrize("sharing", [True, False])
def test_score_multi_images_matches_jax(tiny, sharing):
    """Three images of two grids, the middle one context only: each
    proposal-bearing image's (Q, N_i) scores equal JAX's; sharing and
    joint agree."""
    jcfg, tcfg, params, model = tiny
    imgs = _images(13, [(30, 50), (40, 40), (50, 30)])
    rng = np.random.default_rng(14)
    props = [_props(rng, 30, 50, 2), None, _props(rng, 50, 30, 3)]
    queries = ["red box", "dog", "the cat"]
    common = dict(tokenizer=FakeTok(), seq_buckets=(128, 256),
                  suffix_buckets=(64, 128), query_batch=2, max_proposals=3,
                  prefix_sharing=sharing)
    want = JRefScorer(cfg=jcfg, params=params, **common).score_multi_images(
        imgs, props, queries, pad_token_id=0)
    scorer = RefScorer(cfg=tcfg, model=model, device="cpu", **common)
    got = scorer.score_multi_images(imgs, props, queries, pad_token_id=0)
    assert [g.shape for g in got] == [(3, 2), (3, 3)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    other = RefScorer(cfg=tcfg, model=model, device="cpu",
                      **{**common, "prefix_sharing": not sharing})
    for a, b in zip(scorer.multi_image_logits(imgs, props, queries, 0),
                    other.multi_image_logits(imgs, props, queries, 0)):
        np.testing.assert_allclose(a, b, **TOL)
    # every image context only: no score block
    assert scorer.score_multi_images(imgs[:2], [None, None], ["a"],
                                     pad_token_id=0) == []


def test_ref_generate_multi_matches_jax_and_single(tiny):
    """Greedy tokens of a two-image caption prompt equal JAX's; with one
    image ref_generate_multi equals ref_generate."""
    jcfg, tcfg, params, model = tiny
    rng = np.random.default_rng(6)
    grids = ((8, 8), (4, 8))
    patches = [rng.standard_normal((g[0] * g[1], PATCH_DIM))
               .astype(np.float32) for g in grids]
    ori = [np.array([64.0, 64.0], np.float32),
           np.array([32.0, 16.0], np.float32)]
    boxes = [np.array([[0, 0, 64, 64]], np.float32), None]
    ids, starts = _multi_ids(grids, rng.integers(2, 80, 3))
    pos = j_rope_multi(ids, IMG, grids, 2)[:, None].astype(np.int32)
    mask = np.ones((1, len(ids)), np.int32)
    nxt = np.array([pos.max() + 1], np.int32)
    want = np.asarray(j_gen_multi(
        jcfg, grids, params, tuple(map(jnp.asarray, patches)),
        jnp.asarray(ids[None]), jnp.asarray(mask), jnp.asarray(pos),
        (jnp.asarray(boxes[0]), None), tuple(map(jnp.asarray, ori)),
        starts, jnp.asarray(nxt), 6, eos_id=95))
    got = ref_generate_multi(tcfg, grids, model, patches, ids[None], mask,
                             pos, boxes, ori, starts, nxt, 6, eos_id=95)
    np.testing.assert_array_equal(got.numpy(), want)

    one_ids, one_starts = _multi_ids(grids[:1], rng.integers(2, 80, 4))
    one_pos = j_rope_multi(one_ids, IMG, grids[:1], 2)[:, None]
    one_mask = np.ones((1, len(one_ids)), np.int32)
    one_nxt = np.array([one_pos.max() + 1], np.int32)
    single = ref_generate(tcfg, *grids[0], model, patches[0], one_ids[None],
                          one_mask, one_pos, one_starts[0], one_nxt,
                          boxes[0], ori[0], 6, eos_id=95)
    multi = ref_generate_multi(tcfg, grids[:1], model, patches[:1],
                               one_ids[None], one_mask, one_pos, [None],
                               ori[:1], one_starts, one_nxt, 6, eos_id=95)
    np.testing.assert_array_equal(multi.numpy(), single.numpy())

