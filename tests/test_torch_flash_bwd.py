"""The port's flash attention backward (`ops/flash_gqa.py` K2-bwd,
`ops/flash_attention.py` K3-bwd): the plain backward versions, which the
autograd Functions run on CPU tensors, against the JAX kernels'
gradients on the same inputs, on the CPU.

- K2: `jax.grad` through the JAX package's Pallas kernel in interpret
  mode (the real dq and dk/dv kernel code), f32 within 1e-5 (summation
  order only), bf16 within 2e-2 of the gradient's magnitude (both round
  p and ds to bf16 before their products; a value may land one bf16 ulp
  apart, 2^-8 relative, and the sums carry a few such).
- K3: `jax.grad` of the stock kernel's own autograd reference
  (`mha_reference_no_custom_vjp` with `SegmentIds`, pad rows attending
  pad keys as the kernel does), and autograd of the port's einsum
  reference on real rows.
- torch.autograd.gradcheck of both Functions in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wedetect_tpu.ops.flash_gqa import gqa_flash_attention as j_gqa
from wedetect_tpu_torch.ops import attention as TA
from wedetect_tpu_torch.ops import flash_attention as fa
from wedetect_tpu_torch.ops import flash_gqa as fg

# (B, S, Lk, H, KVH, D, causal, masked): tests/test_flash_gqa.py's
# test_grad_agreement cases, square causal, and non-causal
K2_CASES = [
    (2, 128, 384, 4, 2, 128, True, False),
    (2, 128, 640, 8, 2, 128, True, True),
    (1, 128, 128, 4, 1, 128, True, False),
    (1, 256, 256, 8, 8, 128, False, True),
    (1, 128, 256, 4, 2, 256, True, True),     # D = 256 (the SIMT route)
]


def _k2_inputs(case, seed):
    b, s, lk, h, kvh, d, causal, masked = case
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal(sh).astype(np.float32)
                  for sh in ((b, s, h, d), (b, lk, kvh, d), (b, lk, kvh, d),
                             (b, s, h, d)))
    valid = None
    if masked:
        valid = np.ones((b, lk), np.int32)
        valid[:, lk // 2 - 8:lk // 2] = 0
        valid[:, -5:] = 0
    return q, k, v, w, valid


def _jax_k2_grads(q, k, v, w, valid, causal, dtype=jnp.float32):
    kv = None if valid is None else jnp.asarray(valid)

    def loss(q, k, v):
        o = j_gqa(q, k, v, causal=causal, kv_valid=kv)
        return jnp.sum(o.astype(jnp.float32) * w)

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_k2_grads(q, k, v, w, valid, causal, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    kv = None if valid is None else torch.from_numpy(valid)
    scale = q.shape[-1] ** -0.5
    o, lse = fg.gqa_flash_attention_plain(*t, causal=causal, kv_valid=kv,
                                          sm_scale=scale, return_lse=True)
    do = torch.from_numpy(w).to(dtype)
    return fg.gqa_flash_attention_bwd_plain(*t, kv, o, lse, do, causal,
                                            scale)


@pytest.mark.parametrize("case", K2_CASES,
                         ids=["rect_g2", "rect_g4_m", "square", "noncausal",
                              "d256"])
def test_k2_plain_backward_matches_jax_kernel(case):
    q, k, v, w, valid = _k2_inputs(case, seed=sum(case[:3]))
    want = _jax_k2_grads(q, k, v, w, valid, case[6])
    got = _port_k2_grads(q, k, v, w, valid, case[6])
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), x, atol=1e-5, rtol=1e-5)


def test_k2_plain_backward_bf16_matches_jax_kernel():
    case = K2_CASES[1]
    q, k, v, w, valid = _k2_inputs(case, seed=5)
    want = _jax_k2_grads(q, k, v, w, valid, True, jnp.bfloat16)
    got = _port_k2_grads(q, k, v, w, valid, True, torch.bfloat16)
    for g, x in zip(got, want):
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - x).max()
        assert err <= 2e-2 * np.abs(x).max(), err


@pytest.mark.parametrize("case", K2_CASES[1:3], ids=["rect_g4_m", "square"])
def test_k2_plain_backward_matches_autograd(case):
    """On rows with a visible valid key (all rows here) the plain
    backward is the gradient of the plain forward."""
    q, k, v, w, valid = _k2_inputs(case, seed=11)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    kv = None if valid is None else torch.from_numpy(valid)
    o = fg.gqa_flash_attention_plain(*t, causal=case[6], kv_valid=kv)
    want = torch.autograd.grad((o * torch.from_numpy(w)).sum(), t)
    got = _port_k2_grads(q, k, v, w, valid, case[6])
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, atol=1e-5, rtol=1e-5)


def test_k2_function_runs_plain_backward_on_cpu():
    """gqa_flash_attention on CPU tensors: the autograd Function's
    gradients are the plain backward's, through the attention dispatch."""
    case = K2_CASES[0]
    q, k, v, w, valid = _k2_inputs(case, seed=2)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = TA.gqa_attention(*t, causal=True, impl="flash")
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), t)
    want = _port_k2_grads(q, k, v, w, valid, True)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


# (B, S, Lk, H, KVH, D, causal, invalid key ranges): the f32 dk/dv
# kernel's walk cases: K2_GRID of chip_smoke.py at reduced heads, a last
# row tile past S * G (S = 40, G = 1), S = 336 (bq = 16: F moves every 32
# folded rows) and a non-causal block of invalid keys
WALK_CASES = [
    (2, 128, 384, 4, 2, 128, True, ()),
    (1, 128, 128, 4, 1, 128, True, ()),
    (2, 128, 640, 4, 1, 128, True, ((312, 320), (635, 640))),
    (1, 256, 256, 2, 2, 128, False, ((120, 128), (251, 256))),
    (1, 128, 512, 2, 1, 128, True, ((248, 256), (507, 512))),
    (1, 128, 256, 4, 2, 128, True, ((0, 132),)),    # rows see no valid key
    (2, 96, 384, 4, 2, 128, True, ((200, 216),)),
    (1, 40, 128, 2, 2, 128, True, ((20, 30),)),      # a partial row tile
    (1, 336, 384, 4, 2, 128, True, ((100, 110),)),
    (1, 128, 256, 2, 1, 128, False, ((64, 128),)),
]
WALK_IDS = ["rect_g2", "square_g4", "holes_g4", "noncausal", "rect_512",
            "no_valid_key", "s96", "partial_tile", "s336",
            "noncausal_dead_block"]


def _walk_inputs(case, seed):
    b, s, lk, h, kvh, d, causal, holes = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh)
                                    .astype(np.float32))
                   for sh in ((b, s, h, d), (b, lk, kvh, d),
                              (b, lk, kvh, d), (b, s, h, d)))
    valid = torch.ones((b, lk), dtype=torch.int32)
    for lo, hi in holes:
        valid[:, lo:hi] = 0
    o, lse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                          kv_valid=valid, sm_scale=d ** -0.5,
                                          return_lse=True)
    return (q, k, v, valid, o, lse, do), d ** -0.5


def _skipped_pairs(walked, b, kvh, g, s, lk, rows=fg.DKDV_F32_ROWS,
                   keys=fg.DKDV_F32_KEYS):
    """(B, KVH, G, S, Lk) bool: the (row, key) pairs of the tiles that a
    walk map (B, KVH, row tiles, key tiles) of `rows` x `keys` tiles
    skips, in the plain version's layout (folded row r = position r // G,
    head r % G)."""
    skip = (~walked).repeat_interleave(rows, 2)[:, :, :s * g]
    skip = skip.repeat_interleave(keys, 3)               # (B, KVH, rows, Lk)
    return skip.reshape(b, kvh, s, g, lk).permute(0, 1, 3, 2, 4)


def _walk_exact(args, scale, causal, walked, grads=(1, 2),
                rows=fg.DKDV_F32_ROWS, keys=fg.DKDV_F32_KEYS):
    """(p is exactly 0 on every skipped pair, the gradients `grads` of
    (dq, dk, dv) unchanged with p and ds zeroed there) for a walk map
    (B, KVH, row tiles, key tiles)."""
    q, k, v, valid, o, lse, do = args
    b, s, h, _ = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    skip = _skipped_pairs(walked, b, kvh, h // kvh, s, lk, rows, keys)
    p, ds = fg.bwd_plain_weights(*args, causal, scale)
    want = fg.gqa_flash_attention_bwd_plain(*args, causal, scale)
    got = fg.bwd_plain_products(q, k, v, do, p.masked_fill(skip, 0),
                                ds.masked_fill(skip, 0))
    return bool((p[skip] == 0).all()), all(torch.equal(got[i], want[i])
                                           for i in grads)


def _drop_largest_walked_tile(args, scale, causal, walked, rows, keys):
    """A copy of a walk map (B, KVH, row tiles, key tiles) without the
    walked tile holding the largest p: the controls' wrong rule."""
    q, k = args[0], args[1]
    b, s, h, _ = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    p, _ = fg.bwd_plain_weights(*args, causal, scale)
    pf = p.permute(0, 1, 3, 2, 4).reshape(b, kvh, s * g, lk)
    nt, nk = walked.shape[-2:]
    pf = torch.cat([pf, pf.new_zeros(b, kvh, nt * rows - s * g, lk)], 2)
    tile_max = pf.reshape(b, kvh, nt, rows, nk, keys).amax((3, 5))
    tile_max = tile_max.masked_fill(~walked, 0)
    assert float(tile_max.max()) > 0
    wrong = walked.clone(memory_format=torch.contiguous_format)
    wrong.view(-1)[int(tile_max.argmax())] = False
    return wrong


@pytest.mark.parametrize("case", WALK_CASES, ids=WALK_IDS)
def test_dkdv_f32_walk_skips_only_zero_tiles(case):
    """The f32 dk/dv kernel's skip rule (`dkdv_tile_walked`) is exact: on
    every skipped (row tile, key block) p is exactly 0, and the plain dk
    and dv are bitwise unchanged with p and ds zeroed there. A rule that
    also skips one contributing tile fails the same check."""
    b, s, lk, h, kvh, d, causal, holes = case
    args, scale = _walk_inputs(case, seed=s + lk + h)
    walked = fg.dkdv_walk_map(s, lk, h // kvh, causal, args[3], args[5])
    assert walked.shape == (b, kvh, lk // 64, -(-s * h // kvh // 32))
    walked = walked.transpose(-1, -2).contiguous()  # row, key tiles
    assert _walk_exact(args, scale, causal, walked) == (True, True)
    # the control: drop the walked tile with the largest p
    wrong = _drop_largest_walked_tile(args, scale, causal, walked, 32, 64)
    assert _walk_exact(args, scale, causal, wrong) == (False, False)


@pytest.mark.parametrize("case", WALK_CASES, ids=WALK_IDS)
def test_dq_f32_walk_skips_only_zero_tiles(case):
    """The f32 dq kernel's walk (`dq_walk_map`: the same rule over its
    64-row x 32-key tiles) is exact: on every (row block, key tile) it
    skips p is exactly 0, and the plain dq is bitwise unchanged with p
    and ds zeroed there. Dropping the walked tile with the largest p
    fails the same check."""
    b, s, lk, h, kvh, d, causal, holes = case
    args, scale = _walk_inputs(case, seed=s + lk + h + 1)
    walked = fg.dq_walk_map(s, lk, h // kvh, causal, args[3], args[5])
    rows, keys = fg.DQ_F32_ROWS, fg.DQ_F32_KEYS
    assert walked.shape == (b, kvh, -(-s * h // kvh // rows), lk // keys)
    kw = dict(grads=(0,), rows=rows, keys=keys)
    assert _walk_exact(args, scale, causal, walked, **kw) == (True, True)
    wrong = _drop_largest_walked_tile(args, scale, causal, walked, rows,
                                      keys)
    assert _walk_exact(args, scale, causal, wrong, **kw) == (False, False)


def test_dkdv_f32_walk_at_the_training_shape():
    """One kv head of the SFT step's decoder attention (S = Lk = 2048,
    G = 2, 1253 valid keys): the frontier alone scans 2560 tiles of
    32 rows x 64 keys, the skip rule walks 1800 (1280 and 900 in
    64 x 64 tiles), and the 12 key blocks past the last valid key walk
    none."""
    case = (1, 2048, 2048, 2, 1, 128, True, ((1253, 2048),))
    args, _ = _walk_inputs(case, seed=0)
    valid, lse = args[3], args[5]
    walked = fg.dkdv_walk_map(2048, 2048, 2, True, valid, lse)
    scanned = fg.dkdv_walk_map(2048, 2048, 2, True, valid,
                               torch.full_like(lse, float("-inf")))
    assert int(walked.sum()) == 1800 and int(scanned.sum()) == 2560
    per_block = walked.sum(-1)[0, 0]
    assert per_block[0] == 128 and per_block[19] == 128 - 4 * 19
    assert not per_block[20:].any()


def test_dq_f32_walk_at_the_training_shape():
    """One kv head of the SFT step's decoder attention (S = Lk = 2048,
    G = 2, 1253 valid keys) in the dq kernel's 64-row x 32-key tiles: the
    frontier alone scans 2560 tiles, the skip rule walks 1780 (30%
    fewer); row block t (positions 32 t to 32 t + 31) walks
    min(t + 1, 40) key tiles, and no row block walks the 24 key tiles
    past the last valid key."""
    case = (1, 2048, 2048, 2, 1, 128, True, ((1253, 2048),))
    args, _ = _walk_inputs(case, seed=0)
    valid, lse = args[3], args[5]
    walked = fg.dq_walk_map(2048, 2048, 2, True, valid, lse)
    scanned = fg.dq_walk_map(2048, 2048, 2, True, valid,
                             torch.full_like(lse, float("-inf")))
    assert walked.shape == (1, 1, 64, 64)
    assert int(walked.sum()) == 1780 and int(scanned.sum()) == 2560
    per_block = walked.sum(-1)[0, 0]
    assert torch.equal(per_block, torch.clamp(torch.arange(64) + 1, max=40))
    assert not walked[..., 40:].any()
    # the rule over the dk/dv kernel's 32 x 64 tiles, seen from the rows,
    # keeps every tile that overlaps one this map keeps
    coarse = fg.dkdv_walk_map(2048, 2048, 2, True, valid, lse)
    coarse = coarse.transpose(-1, -2).repeat_interleave(2, -1)
    fine = walked.repeat_interleave(2, -2)
    assert not (fine & ~coarse).any()


@pytest.mark.parametrize("dtype,d,g,route", [
    (torch.float32, 128, 2, "f32"), (torch.float32, 128, 3, "f32"),
    (torch.float32, 64, 2, "simt"), (torch.float32, 256, 2, "simt"),
    (torch.float32, 512, 2, "simt"), (torch.bfloat16, 128, 2, "sm90"),
    (torch.bfloat16, 128, 3, "simt"), (torch.bfloat16, 256, 2, "simt")])
def test_dq_route_by_type_and_dim(dtype, d, g, route):
    """K2-bwd-dq in f32 at D = 128 takes the FFMA kernel, as dk/dv does;
    every other input keeps bwd_route's kernel."""
    assert fg.dq_route(dtype, d, g) == route
    assert fg.dq_route(dtype, d, g) == fg.dkdv_route(dtype, d, g)
    if route != "f32":
        assert route == fg.bwd_route(dtype, d, g)


def test_dq_route_rejects_other_types():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fg.dq_route(torch.float16, 128, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fg.dq_route(torch.float64, 128, 2)


def test_dkdv_tile_walked_keeps_rows_without_a_valid_key():
    """A row whose lse is ~-1e30 has p = 1 on its scanned keys: it keeps
    a tile of invalid keys below its frontier; with a finite lse the
    same tile is skipped, and past the frontier it is skipped either
    way."""
    f = torch.full((32,), 256)
    qpos = torch.arange(32) + 200
    dead = torch.zeros(64, dtype=torch.bool)
    assert fg.dkdv_tile_walked(f, qpos, torch.full((32,), -1e30), dead,
                               128, True)
    assert not fg.dkdv_tile_walked(f, qpos, torch.zeros(32), dead, 128,
                                   True)
    assert not fg.dkdv_tile_walked(f, qpos, torch.full((32,), -1e30), dead,
                                   256, True)
    live = torch.ones(64, dtype=torch.bool)
    assert fg.dkdv_tile_walked(f, qpos, torch.zeros(32), live, 128, True)
    # causal: valid keys all after every row's position
    assert not fg.dkdv_tile_walked(f, qpos - 110, torch.zeros(32), live,
                                   128, True)


def test_k2_backward_f32_on_cpu_loads_no_library(monkeypatch):
    """gqa_flash_attention_bwd on f32 CPU tensors at D = 128 (the f32
    dk/dv kernel's input on the card) runs the plain version and never
    builds or loads a kernel library."""
    from wedetect_tpu_torch.ops import _build

    def no_load(name):
        raise AssertionError(f"loaded {name} for CPU tensors")

    monkeypatch.setattr(_build, "load", no_load)
    monkeypatch.setattr(_build, "build", no_load)
    args, scale = _walk_inputs(WALK_CASES[0], seed=1)
    got = fg.gqa_flash_attention_bwd(*args, causal=True, sm_scale=scale)
    want = fg.gqa_flash_attention_bwd_plain(*args, True, scale)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_k2_f32_autograd_on_cpu_loads_no_library(monkeypatch):
    """loss.backward() through gqa_flash_attention on f32 CPU tensors at
    D = 128 (the f32 dq and dk/dv kernels' input on the card) runs the
    plain backward, launches nothing and never builds or loads a kernel
    library."""
    from wedetect_tpu_torch.ops import _build

    def no_load(name):
        raise AssertionError(f"loaded {name} for CPU tensors")

    monkeypatch.setattr(_build, "load", no_load)
    monkeypatch.setattr(_build, "build", no_load)
    for fn in (fg.gqa_flash_bwd_dq, fg.gqa_flash_bwd_dq_f32,
               fg.gqa_flash_bwd_dkdv, fg.gqa_flash_bwd_dkdv_f32):
        monkeypatch.setattr(fn, "launches", 0)
    (q, k, v, valid, _, _, do), scale = _walk_inputs(WALK_CASES[6], seed=2)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fg.gqa_flash_attention(*leaves, causal=True, kv_valid=valid,
                               sm_scale=scale)
    o.backward(do)
    o2, lse = fg.gqa_flash_attention_plain(q, k, v, causal=True,
                                           kv_valid=valid, sm_scale=scale,
                                           return_lse=True)
    want = fg.gqa_flash_attention_bwd_plain(q, k, v, valid, o2, lse, do,
                                            True, scale)
    for t, x in zip(leaves, want):
        assert torch.equal(t.grad, x)
    assert fg.gqa_flash_bwd_dq.launches == 0
    assert fg.gqa_flash_bwd_dq_f32.launches == 0


# three segments with boundaries off the 64-grid, then pad (segment 0):
# ids 1 on [0, 100), 2 on [100, 300), 3 on [300, 480), 0 on [480, 512)
K3_THREE_SEGMENTS = ((100, 1), (300, 2), (480, 3))


def _k3_ids(l, n_real):
    """Segment ids (l,): n_real real tokens in segment 1 and pad in 0, or
    for a tuple of (end, id) runs, each run's id up to its end, then 0."""
    runs = ((n_real, 1),) if isinstance(n_real, int) else n_real
    ids = np.zeros(l, np.int32)
    start = 0
    for end, sid in runs:
        ids[start:end] = sid
        start = end
    return ids


def _k3_inputs(b, l, h, d, n_real, seed):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((b, l, h, d)).astype(np.float32)
                  for _ in range(4))
    seg = np.broadcast_to(_k3_ids(l, n_real), (b, l)).copy()
    return q, k, v, w, seg


def _port_k3_grads(q, k, v, w, seg, causal, scale, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    s = torch.from_numpy(seg)
    kw = dict(q_segment_ids=s, kv_segment_ids=s, causal=causal,
              sm_scale=scale)
    o, lse = fa.flash_attention_plain(*t, return_lse=True, **kw)
    return fa.flash_attention_bwd_plain(
        *t, o, lse, torch.from_numpy(w).to(dtype), **kw)


def _stock_k3_grads(q, k, v, w, seg, causal, scale, dtype=jnp.float32):
    """jax.grad of the stock kernel's autograd reference, in `dtype`."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds, mha_reference_no_custom_vjp)

    ids = jnp.asarray(seg)

    def loss(q, k, v):
        o = mha_reference_no_custom_vjp(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), segment_ids=SegmentIds(q=ids, kv=ids),
            causal=causal, sm_scale=scale)
        return jnp.sum(o.transpose(0, 2, 1, 3).astype(jnp.float32) * w)

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


@pytest.mark.parametrize("b,l,h,d,n_real,causal", [
    (1, 256, 2, 64, 200, False), (2, 128, 2, 64, 128, True),
    (1, 128, 1, 128, 100, False), (1, 128, 2, 256, 100, False),
    (1, 512, 2, 64, K3_THREE_SEGMENTS, False)])
def test_k3_plain_backward_matches_stock_reference(b, l, h, d, n_real,
                                                   causal):
    q, k, v, w, seg = _k3_inputs(b, l, h, d, n_real, seed=l + h)
    scale = d ** -0.5
    want = _stock_k3_grads(q, k, v, w, seg, causal, scale)
    got = _port_k3_grads(q, k, v, w, seg, causal, scale)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), x, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,l,h,n_real,causal", [
    (1, 256, 2, 200, False), (1, 256, 2, 256, True),
    (1, 512, 2, K3_THREE_SEGMENTS, False)])
def test_k3_plain_backward_bf16_matches_stock_reference(b, l, h, n_real,
                                                        causal):
    """bf16 at D = 64, the input of the wgmma backward kernels, which
    are held to this plain version. Errors relative to each gradient's
    largest entry. The stock reference runs in bf16 throughout (logits,
    softmax and products rounded to bf16), which puts it 2.1-2.4% from
    the f64 gradient of the same bf16 inputs here, so it is held within
    3e-2; the plain version rounds only p and ds to bf16 before their
    products (f32 sums), and is held within 1e-2 of the f64 gradient
    (it reads 0.3-0.5%)."""
    q, k, v, w, seg = _k3_inputs(b, l, h, 64, n_real, seed=l + 7)
    want = _stock_k3_grads(q, k, v, w, seg, causal, 0.125, jnp.bfloat16)
    got = _port_k3_grads(q, k, v, w, seg, causal, 0.125, torch.bfloat16)
    s = torch.from_numpy(seg)
    exact = [torch.from_numpy(x).to(torch.bfloat16).double()
             for x in (q, k, v)]
    kw = dict(q_segment_ids=s, kv_segment_ids=s, causal=causal,
              sm_scale=0.125)
    o, lse = fa.flash_attention_plain(*exact, return_lse=True, **kw)
    truth = fa.flash_attention_bwd_plain(
        *exact, o, lse, torch.from_numpy(w).to(torch.bfloat16).double(),
        **kw)
    for g, x, t in zip(got, want, truth):
        assert g.dtype == torch.bfloat16
        g, t = g.float().numpy(), t.numpy()
        assert np.abs(g - x).max() <= 3e-2 * np.abs(x).max()
        assert np.abs(g - t).max() <= 1e-2 * np.abs(t).max()


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "sm90"), (torch.float32, 64, "simt"),
    (torch.bfloat16, 128, "simt"), (torch.bfloat16, 256, "simt")])
def test_k3_bwd_route_by_type(dtype, d, route):
    assert fa.bwd_route(dtype, d) == route


def test_k3_bwd_route_rejects_other_types():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.bwd_route(torch.float16, 64)


def test_k3_backward_on_cpu_loads_no_library(monkeypatch):
    """flash_attention_bwd on CPU tensors (bf16 at D = 64, the wgmma
    route's input on the card) runs the plain version and never builds
    or loads a kernel library."""
    from wedetect_tpu_torch.ops import _build

    def no_load(name):
        raise AssertionError(f"loaded {name} for CPU tensors")

    monkeypatch.setattr(_build, "load", no_load)
    monkeypatch.setattr(_build, "build", no_load)
    q, k, v, w, seg = _k3_inputs(1, 256, 2, 64, K3_THREE_SEGMENTS[:2],
                                 seed=4)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, w)]
    s = torch.from_numpy(seg)
    kw = dict(q_segment_ids=s, kv_segment_ids=s, causal=False,
              sm_scale=0.125)
    o, lse = fa.flash_attention_plain(*t[:3], return_lse=True, **kw)
    got = fa.flash_attention_bwd(*t[:3], o, lse, t[3], **kw)
    want = fa.flash_attention_bwd_plain(*t[:3], o, lse, t[3], **kw)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.float32, 64, "f32"), (torch.bfloat16, 64, "sm90"),
    (torch.float32, 72, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 128, "simt"), (torch.float32, 512, "simt")])
def test_k3_dkv_route_by_type_and_dim(dtype, d, route):
    """dk/dv in f32 at D = 64 takes the FFMA kernel; bwd_route keeps the
    wgmma / SIMT split that dkv_route and dq_route refine."""
    assert fa.dkv_route(dtype, d) == route
    assert fa.bwd_route(dtype, d) == ("sm90" if route == "sm90"
                                      else "simt")


def test_k3_dkv_route_rejects_other_types():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.dkv_route(torch.float16, 64)


def test_k3_backward_f32_on_cpu_loads_no_library(monkeypatch):
    """flash_attention_bwd on f32 CPU tensors at D = 64 (the f32 dk/dv
    kernel's input on the card) runs the plain version and never builds
    or loads a kernel library."""
    from wedetect_tpu_torch.ops import _build

    def no_load(name):
        raise AssertionError(f"loaded {name} for CPU tensors")

    monkeypatch.setattr(_build, "load", no_load)
    monkeypatch.setattr(_build, "build", no_load)
    args, kw = _dkv_walk_inputs(DKV_WALK_CASES[0], seed=1)
    got = fa.flash_attention_bwd(*args, **kw)
    want = fa.flash_attention_bwd_plain(*args, **kw)
    for g, x in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, x)


# (B, L, H, row segment runs, key segment runs or "same", causal): the
# f32 dk/dv kernel's walk cases at D = 64. Runs are (end, id) pairs, each
# id up to its end, then 0 (pad); None: no segment ids. The training
# shape's tail at a smaller L (88 pad tokens from off the 64-grid, the
# last row tile pad only), a tail (L = 200), three segments, causal with
# and without ids, and rows whose segment no key has (lse ~ -1e30: p = 1
# on every key below the frontier), with and without causal
DKV_WALK_CASES = [
    (1, 768, 2, ((680, 1),), "same", False),
    (1, 200, 2, ((180, 1),), "same", False),
    (1, 512, 2, K3_THREE_SEGMENTS, "same", False),
    (1, 384, 2, ((150, 1), (300, 2)), "same", True),
    (1, 320, 2, None, None, True),
    (2, 256, 2, ((100, 1), (164, 9), (256, 1)), ((256, 1),), False),
    (1, 256, 2, ((100, 1), (164, 9), (256, 1)), ((256, 1),), True),
]
DKV_WALK_IDS = ["train_tail", "tail_l200", "three_segments",
                "causal_segments", "causal_no_ids", "unseen_segment",
                "unseen_segment_causal"]


def _dkv_walk_inputs(case, seed):
    b, l, h, q_runs, kv_runs, causal = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, l, h, 64))
                                    .astype(np.float32)) for _ in range(4))
    qs = ks = None
    if q_runs is not None:
        qs = torch.from_numpy(np.broadcast_to(_k3_ids(l, q_runs),
                                              (b, l)).copy())
        ks = qs if kv_runs == "same" else torch.from_numpy(
            np.broadcast_to(_k3_ids(l, kv_runs), (b, l)).copy())
    kw = dict(q_segment_ids=qs, kv_segment_ids=ks, causal=causal,
              sm_scale=0.125)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    return (q, k, v, o, lse, do), kw


def _dkv_skipped_pairs(walked, l):
    """(B, H, L, L) bool: the (row, key) pairs of the tiles a walk map
    (B, H, key blocks, row tiles) skips, in the plain version's layout."""
    skip = (~walked).permute(0, 1, 3, 2)              # (B, H, NT, NKB)
    skip = skip.repeat_interleave(fa.DKV_F32_ROWS, 2)[:, :, :l]
    return skip.repeat_interleave(fa.DKV_F32_KEYS, 3)[..., :l]


def _dkv_walk_exact(args, kw, walked):
    """(p is exactly 0 on every skipped pair, dk and dv unchanged with p
    and ds zeroed there) for a walk map."""
    q, k, v, o, lse, do = args
    skip = _dkv_skipped_pairs(walked, q.shape[1])
    p, ds = fa.bwd_plain_weights(*args, **kw)
    _, dk, dv = fa.flash_attention_bwd_plain(*args, **kw)
    _, dk0, dv0 = fa.bwd_plain_products(q, k, v, do, p.masked_fill(skip, 0),
                                        ds.masked_fill(skip, 0))
    return bool((p[skip] == 0).all()), (torch.equal(dk0, dk)
                                        and torch.equal(dv0, dv))


@pytest.mark.parametrize("case", DKV_WALK_CASES, ids=DKV_WALK_IDS)
def test_dkv_f32_walk_skips_only_zero_tiles(case):
    """The f32 dk/dv kernel's skip rule (`dkv_tile_walked`) is exact: on
    every skipped (row tile, key block) p is exactly 0, and the plain dk
    and dv are bitwise unchanged with p and ds zeroed there. A rule that
    also skips one contributing tile fails the same check."""
    b, l, h = case[:3]
    args, kw = _dkv_walk_inputs(case, seed=l + h)
    lse = args[4]
    walked = fa.dkv_walk_map(l, kw["causal"], kw["q_segment_ids"],
                             kw["kv_segment_ids"], lse)
    rows, keys = fa.DKV_F32_ROWS, fa.DKV_F32_KEYS
    nt, nkb = -(-l // rows), -(-l // keys)
    assert walked.shape == (b, h, nkb, nt)
    if case[4] not in ("same", None):
        assert float(lse.max()) > -1e29 > float(lse.min())
    assert _dkv_walk_exact(args, kw, walked) == (True, True)
    # the control: drop the walked tile with the largest p
    p, _ = fa.bwd_plain_weights(*args, **kw)
    pf = torch.nn.functional.pad(p, (0, nkb * keys - l, 0, nt * rows - l))
    tile_max = pf.reshape(b, h, nt, rows, nkb, keys).amax((3, 5))
    tile_max = tile_max.permute(0, 1, 3, 2).masked_fill(~walked, 0)
    assert float(tile_max.max()) > 0
    wrong = walked.clone()
    wrong.view(-1)[int(tile_max.argmax())] = False
    assert _dkv_walk_exact(args, kw, wrong) == (False, False)


def test_dkv_f32_walk_at_the_training_shape():
    """One head of the SFT step's ViT attention (L = 4224: 4144 real
    tokens in segment 1, 80 pad tokens in segment 0): the frontier alone
    scans 33 x 66 = 2178 tiles of 64 rows x 128 keys, the skip rule walks
    2146. Key blocks 0-31 (real keys only) skip the last row tile (pad
    rows only); block 32 (keys 4096-4223, real and pad) walks all 66."""
    l, n_real = 4224, 4144
    assert (fa.DKV_F32_ROWS, fa.DKV_F32_KEYS) == (64, 128)
    seg = (torch.arange(l) < n_real).to(torch.int32)[None]
    lse = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 1, l)).astype(np.float32))
    walked = fa.dkv_walk_map(l, False, seg, seg, lse)
    scanned = fa.dkv_walk_map(l, False, seg, seg,
                              torch.full_like(lse, float("-inf")))
    assert int(walked.sum()) == 2146 and int(scanned.sum()) == 2178
    per_block = walked.sum(-1)[0, 0]
    assert (per_block[:32] == 65).all() and not walked[0, 0, :32, 65].any()
    assert per_block[32] == 66


def test_dkv_tile_walked_keeps_rows_without_a_visible_key():
    """A row whose lse is ~-1e30 keeps a block whose keys it cannot see
    (p = 1 there); with a finite lse the same tile is skipped, and under
    causal a row before the block's first key skips it either way."""
    qpos = torch.arange(64) + 128
    qseg = torch.full((64,), 2, dtype=torch.int32)
    kseg = torch.ones(64, dtype=torch.int32)
    dead = torch.full((64,), -1e30)
    assert fa.dkv_tile_walked(qpos, qseg, dead, kseg, 64, 256, False)
    assert not fa.dkv_tile_walked(qpos, qseg, torch.zeros(64), kseg, 64,
                                  256, False)
    assert fa.dkv_tile_walked(qpos, qseg, torch.zeros(64), qseg, 64, 256,
                              False)
    assert not fa.dkv_tile_walked(qpos - 128, qseg, dead, kseg, 64, 256,
                                  True)
    # a block of 128 keys, as the kernel's: the row's segment in its
    # second half only
    wide = torch.cat([kseg, qseg])
    assert fa.dkv_tile_walked(qpos, qseg, torch.zeros(64), wide, 0, 256,
                              False)
    assert not fa.dkv_tile_walked(qpos - 128, qseg, torch.zeros(64), wide,
                                  0, 256, True)
    # causal: the row's segment starts in the block only after the row
    late = torch.cat([torch.ones(32), torch.full((32,), 2)]).int()
    assert not fa.dkv_tile_walked(torch.arange(32) + 128, qseg[:32],
                                  torch.zeros(32), late, 128, 256, True)
    assert fa.dkv_tile_walked(torch.arange(32) + 160, qseg[:32],
                              torch.zeros(32), late, 128, 256, True)
    # rows and keys past L count for nothing
    assert not fa.dkv_tile_walked(qpos + 64, qseg, dead, qseg, 64, 192,
                                  False)


def _dq_skipped_pairs(walked, l):
    """(B, H, L, L) bool: the (row, key) pairs of the tiles a dq walk map
    (B, H, row blocks, key tiles) skips, in the plain version's layout."""
    skip = (~walked).repeat_interleave(fa.DQ_F32_ROWS, 2)[:, :, :l]
    return skip.repeat_interleave(fa.DQ_F32_KEYS, 3)[..., :l]


def _dq_walk_exact(args, kw, walked):
    """(p is exactly 0 on every skipped pair, dq unchanged with p and ds
    zeroed there) for a dq walk map."""
    q, k, v, o, lse, do = args
    skip = _dq_skipped_pairs(walked, q.shape[1])
    p, ds = fa.bwd_plain_weights(*args, **kw)
    dq, _, _ = fa.flash_attention_bwd_plain(*args, **kw)
    dq0, _, _ = fa.bwd_plain_products(q, k, v, do, p.masked_fill(skip, 0),
                                      ds.masked_fill(skip, 0))
    return bool((p[skip] == 0).all()), torch.equal(dq0, dq)


@pytest.mark.parametrize("case", DKV_WALK_CASES, ids=DKV_WALK_IDS)
def test_dq_f32_walk_skips_only_zero_tiles(case):
    """The f32 dq kernel's skip rule (`dkv_tile_walked` in its tiles,
    `dq_walk_map`) is exact: on every skipped (row block, key tile) p is
    exactly 0, and the plain dq is bitwise unchanged with p and ds zeroed
    there. A rule that also skips the walked tile with the largest p
    fails the same check."""
    b, l, h = case[:3]
    args, kw = _dkv_walk_inputs(case, seed=l + h + 1)
    lse = args[4]
    walked = fa.dq_walk_map(l, kw["causal"], kw["q_segment_ids"],
                            kw["kv_segment_ids"], lse)
    rows, keys = fa.DQ_F32_ROWS, fa.DQ_F32_KEYS
    nrb, nkt = -(-l // rows), -(-l // keys)
    assert walked.shape == (b, h, nrb, nkt)
    assert _dq_walk_exact(args, kw, walked) == (True, True)
    # the control: drop the walked tile with the largest p
    p, _ = fa.bwd_plain_weights(*args, **kw)
    pf = torch.nn.functional.pad(p, (0, nkt * keys - l, 0, nrb * rows - l))
    tile_max = pf.reshape(b, h, nrb, rows, nkt, keys).amax((3, 5))
    tile_max = tile_max.masked_fill(~walked, 0)
    assert float(tile_max.max()) > 0
    wrong = walked.clone()
    wrong.view(-1)[int(tile_max.argmax())] = False
    assert _dq_walk_exact(args, kw, wrong) == (False, False)


@pytest.mark.parametrize("case", DKV_WALK_CASES, ids=DKV_WALK_IDS)
def test_dq_walk_map_tests_each_tile_by_the_rule(case):
    """Each entry of `dq_walk_map` is `dkv_tile_walked` of that row
    block's rows (position, segment id, lse) and that key tile's keys,
    called tile by tile: the map's layout is (row block, key tile)."""
    b, l, h, *_ = case
    args, kw = _dkv_walk_inputs(case, seed=l)
    lse = args[4]
    qs, ks = kw["q_segment_ids"], kw["kv_segment_ids"]
    if qs is None:
        qs = ks = torch.zeros((b, l), dtype=torch.int32)
    walked = fa.dq_walk_map(l, kw["causal"], kw["q_segment_ids"],
                            kw["kv_segment_ids"], lse)
    rows, keys = fa.DQ_F32_ROWS, fa.DQ_F32_KEYS
    for rb in range(walked.shape[2]):
        r = torch.arange(rb * rows, (rb + 1) * rows)
        rin = r.clamp(max=l - 1)
        for kt in range(walked.shape[3]):
            kk = torch.arange(kt * keys, (kt + 1) * keys).clamp(max=l - 1)
            want = fa.dkv_tile_walked(r, qs[:, None, rin], lse[..., rin],
                                      ks[:, None, kk], kt * keys, l,
                                      kw["causal"])
            assert torch.equal(walked[:, :, rb, kt], want), (rb, kt)


def test_dq_f32_walk_at_the_training_shape():
    """One head of the SFT step's ViT attention (L = 4224: 4144 real
    tokens in segment 1, 80 pad tokens in segment 0): the frontier alone
    scans 33 x 66 = 2178 tiles of 128 rows x 64 keys, the skip rule walks
    2146. Row blocks 0-31 (real rows only) skip the last key tile (pad
    keys only); block 32 (rows 4096-4223, real and pad) walks all 66."""
    l, n_real = 4224, 4144
    assert (fa.DQ_F32_ROWS, fa.DQ_F32_KEYS) == (128, 64)
    seg = (torch.arange(l) < n_real).to(torch.int32)[None]
    lse = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 1, l)).astype(np.float32))
    walked = fa.dq_walk_map(l, False, seg, seg, lse)
    scanned = fa.dq_walk_map(l, False, seg, seg,
                             torch.full_like(lse, float("-inf")))
    assert walked.shape == (1, 1, 33, 66)
    assert int(walked.sum()) == 2146 and int(scanned.sum()) == 2178
    per_block = walked.sum(-1)[0, 0]
    assert (per_block[:32] == 65).all() and not walked[0, 0, :32, 65].any()
    assert per_block[32] == 66
    # under causal a row block walks the key tiles up to its last row
    causal = fa.dq_walk_map(l, True, seg, seg, lse)[0, 0]
    assert causal.sum(-1).tolist() == [2 * (rb + 1) for rb in range(32)] + [
        66]


@pytest.mark.parametrize("dtype,d,route", [
    (torch.float32, 64, "f32"), (torch.bfloat16, 64, "sm90"),
    (torch.float32, 72, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 128, "simt"), (torch.float32, 512, "simt")])
def test_k3_dq_route_by_type_and_dim(dtype, d, route):
    """dq in f32 at D = 64 takes the FFMA kernel, as dk/dv does; every
    other input keeps bwd_route's kernel."""
    assert fa.dq_route(dtype, d) == route
    assert fa.dq_route(dtype, d) == fa.dkv_route(dtype, d)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_k3_dq_route_rejects_other_types(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.dq_route(dtype, 64)


@pytest.mark.parametrize("causal", [False, True])
def test_k3_backward_f32_through_autograd_on_cpu_loads_no_library(
        monkeypatch, causal):
    """loss.backward() through flash_attention on f32 CPU tensors at
    D = 64 (the f32 dq and dk/dv kernels' input on the card) runs the
    plain backward and never builds or loads a kernel library."""
    from wedetect_tpu_torch.ops import _build

    def no_load(name):
        raise AssertionError(f"loaded {name} for CPU tensors")

    monkeypatch.setattr(_build, "load", no_load)
    monkeypatch.setattr(_build, "build", no_load)
    case = DKV_WALK_CASES[3 if causal else 2]
    args, kw = _dkv_walk_inputs(case, seed=5)
    q, k, v, o, lse, do = args
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, **kw).backward(do)
    want = fa.flash_attention_bwd_plain(*args, **kw)
    for t, w in zip(leaves, want):
        assert t.grad.dtype == torch.float32
        assert torch.equal(t.grad, w)


def test_k3_plain_backward_matches_einsum_on_real_rows():
    """With dO zero on pad rows (the ViT drops them), the gradients equal
    those of the einsum reference, which masks pad keys for every row."""
    b, l, h, d, n_real = 1, 256, 2, 64, 200
    q, k, v, w, seg = _k3_inputs(b, l, h, d, n_real, seed=3)
    w[:, n_real:] = 0
    scale = d ** -0.5
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = TA._reference_attention(*t, causal=False,
                                kv_valid=torch.from_numpy(seg),
                                sm_scale=scale)
    want = torch.autograd.grad((o * torch.from_numpy(w)).sum(), t)
    got = _port_k3_grads(q, k, v, w, seg, False, scale)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_gqa_function(causal):
    rng = np.random.default_rng(int(causal))
    q, k, v = (torch.from_numpy(rng.standard_normal(sh)).requires_grad_()
               for sh in ((1, 8, 2, 128), (1, 128, 1, 128),
                          (1, 128, 1, 128)))
    valid = torch.ones((1, 128), dtype=torch.int32)
    valid[:, 60:70] = 0
    assert torch.autograd.gradcheck(
        lambda q, k, v: fg.gqa_flash_attention(q, k, v, causal=causal,
                                               kv_valid=valid),
        (q, k, v), fast_mode=True)


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_flash_function(causal):
    rng = np.random.default_rng(2 + int(causal))
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, 8)))
               .requires_grad_() for _ in range(3))
    seg = (torch.arange(16) < 12).to(torch.int32)[None]
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention(q, k, v, q_segment_ids=seg,
                                           kv_segment_ids=seg,
                                           causal=causal, sm_scale=0.3),
        (q, k, v), fast_mode=True)
