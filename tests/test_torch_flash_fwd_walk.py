"""K2's f32 forward on the card (`csrc/flash_gqa_f32.cu`) walks only the
key tiles its skip rule keeps (`ops/flash_gqa.fwd_tile_walked`,
`fwd_walk_map`). Here, on the CPU:

- the rule is exact in both of the kernel's tiles (64 rows x 32 keys and
  32 x 64, `fwd_f32_tile`): the plain forward with the skipped (row
  block, key tile) pairs removed from the scan gives bitwise the plain O
  and lse, and a rule that also drops the walked tile holding the
  largest weight misses;
- the rule is the backward's (`dq_walk_map` with the forward's lse) in
  the same tiles, and its counts at the SFT step's decoder shape;
- `fwd_route` sends f32 at D = 128 to the new kernel, every other input
  where it went before;
- the plain version, O and lse, against the Pallas `_fwd_kernel` under
  the interpreter on the walk's edge cases (rows without a visible valid
  key, a partial row block, non-causal), f32 at 2e-5 (summation order
  only; lse at -1e30 relative);
- CPU tensors run the plain version and load no library.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wedetect_tpu.ops import flash_gqa as J
from wedetect_tpu_torch.ops import flash_gqa as fg

TILES = sorted(fg.FWD_F32_TILES.items(), reverse=True)   # (rows, keys)
# (B, S, Lk, H, KVH, D, causal, invalid key ranges): chip_smoke.py's
# K2_GRID (fully masked rows, a partial row block with S * G = 192,
# non-causal), then the f32 backward's walk cases at reduced heads (a
# last row block past S * G, S = 336, a non-causal block of invalid
# keys, a batch without a valid key)
CASES = [
    (2, 128, 384, 4, 2, 128, True, ()),
    (1, 128, 128, 4, 1, 128, True, ()),
    (2, 128, 640, 8, 2, 128, True, ((312, 320), (635, 640))),
    (1, 256, 256, 8, 8, 128, False, ((120, 128), (251, 256))),
    (1, 128, 512, 16, 8, 128, True, ((248, 256), (507, 512))),
    (1, 128, 256, 4, 2, 128, True, ((0, 132),)),
    (2, 96, 384, 4, 2, 128, True, ((200, 216),)),
    (2, 128, 640, 4, 1, 128, True, ((312, 320), (635, 640))),
    (1, 128, 512, 2, 1, 128, True, ((248, 256), (507, 512))),
    (1, 40, 128, 2, 2, 128, True, ((20, 30),)),
    (1, 336, 384, 4, 2, 128, True, ((100, 110),)),
    (1, 128, 256, 2, 1, 128, False, ((64, 128),)),
    (1, 128, 256, 2, 1, 128, False, ((0, 256),)),
    (1, 256, 640, 4, 2, 128, True, ((332, 384), (600, 640))),
]
IDS = ["rect_g2", "square_g4", "holes_g4", "noncausal", "rect_512",
       "no_valid_key", "s96_partial", "holes_g4_kv1", "rect_512_g2",
       "partial_tile", "s336", "noncausal_dead_block", "noncausal_none",
       "suffix"]


def _inputs(case, seed):
    b, s, lk, h, kvh, d, causal, holes = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, s, h, d), (b, lk, kvh, d), (b, lk, kvh, d)))
    valid = torch.ones((b, lk), dtype=torch.int32)
    for lo, hi in holes:
        valid[:, lo:hi] = 0
    return q, k, v, valid, d ** -0.5


def _skipped_pairs(walked, b, kvh, g, s, lk, rows, keys):
    """(B, KVH, G, S, Lk) bool: the (row, key) pairs of the tiles a walk
    map (B, KVH, row blocks, key tiles) of `rows` x `keys` tiles skips, in
    the plain version's layout (folded row r = position r // G, head
    r % G)."""
    skip = (~walked).repeat_interleave(rows, 2)[:, :, :s * g]
    skip = skip.repeat_interleave(keys, 3)               # (B, KVH, rows, Lk)
    return skip.reshape(b, kvh, s, g, lk).permute(0, 1, 3, 2, 4)


def _walked_plain(q, k, v, valid, causal, scale, walked, rows, keys):
    """The plain forward's (O, lse) with the pairs the walk skips removed
    from the scan (their logits -inf, as past F)."""
    b, s, h, _ = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    logits = fg._masked_logits(q, k, valid, causal, scale)
    skip = _skipped_pairs(walked, b, kvh, h // kvh, s, lk, rows, keys)
    return fg.fwd_plain_from_logits(logits.masked_fill(skip, float("-inf")),
                                    v, q.dtype)


def _drop_heaviest_walked_tile(q, k, valid, causal, scale, walked, lse,
                               rows, keys):
    """A copy of a walk map without the walked tile holding the largest
    weight exp(logit - lse): the control's wrong rule."""
    b, s, h, _ = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    logits = fg._masked_logits(q, k, valid, causal, scale)
    w = torch.exp(logits - lse.reshape(b, kvh, s, g).permute(
        0, 1, 3, 2)[..., None])
    wf = w.permute(0, 1, 3, 2, 4).reshape(b, kvh, s * g, lk)
    nt, nk = walked.shape[-2:]
    wf = torch.cat([wf, wf.new_zeros(b, kvh, nt * rows - s * g, lk)], 2)
    tile_max = wf.reshape(b, kvh, nt, rows, nk, keys).amax((3, 5))
    tile_max = tile_max.masked_fill(~walked, 0)
    assert float(tile_max.max()) > 0
    wrong = walked.clone(memory_format=torch.contiguous_format)
    wrong.view(-1)[int(tile_max.argmax())] = False
    return wrong


@pytest.mark.parametrize("rows,keys", TILES, ids=["wide", "narrow"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fwd_f32_walk_skips_only_zero_tiles(case, rows, keys):
    """The f32 forward's skip rule (`fwd_walk_map`) is exact in each of
    the kernel's tiles: the plain forward with every skipped (row block,
    key tile) pair removed from the scan gives bitwise the plain O and
    lse. Dropping the walked tile with the largest weight as well
    changes O."""
    b, s, lk, h, kvh, d, causal, holes = case
    q, k, v, valid, scale = _inputs(case, seed=s + lk + h)
    o, lse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                          kv_valid=valid, sm_scale=scale,
                                          return_lse=True)
    walked = fg.fwd_walk_map(s, lk, h // kvh, kvh, causal, valid, rows=rows)
    assert walked.shape == (b, kvh, -(-s * h // kvh // rows), lk // keys)
    got, glse = _walked_plain(q, k, v, valid, causal, scale, walked, rows,
                              keys)
    assert torch.equal(got, o) and torch.equal(glse, lse)
    wrong = _drop_heaviest_walked_tile(q, k, valid, causal, scale, walked,
                                       lse, rows, keys)
    bad, _ = _walked_plain(q, k, v, valid, causal, scale, wrong, rows, keys)
    assert not torch.equal(bad, o)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fwd_walk_map_is_the_backward_rule(case):
    """The rows without a visible valid key are the rows whose lse is at
    most -1e29, so the forward's map is the dq kernel's map (the same
    tiles) read with the forward's lse."""
    b, s, lk, h, kvh, d, causal, holes = case
    q, k, v, valid, scale = _inputs(case, seed=s + lk + h + 1)
    _, lse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                          kv_valid=valid, sm_scale=scale,
                                          return_lse=True)
    g = h // kvh
    none = fg.no_visible_key(s, lk, causal, valid)
    lse_none = lse.reshape(b, kvh, s, g) <= -1e29
    assert torch.equal(none[:, None, :, None].expand_as(lse_none), lse_none)
    assert torch.equal(fg.fwd_walk_map(s, lk, g, kvh, causal, valid),
                       fg.dq_walk_map(s, lk, g, causal, valid, lse))
    # the narrow tile, 32 rows x 64 keys, is the dk/dv kernel's
    narrow = fg.dkdv_walk_map(s, lk, g, causal, valid, lse, rows=32, keys=64)
    assert torch.equal(fg.fwd_walk_map(s, lk, g, kvh, causal, valid,
                                       rows=32), narrow.transpose(-1, -2))


@pytest.mark.parametrize("shape,tile", [
    ((1, 384, 2, 8), (32, 64)),      # the Ref prefix: 96 wide blocks
    ((8, 256, 2, 8), (64, 32)),      # the Ref suffix: 512
    ((1, 2048, 2, 8), (64, 32)),     # K2_TRAIN: 512
    ((1, 1056, 2, 4), (64, 32)),     # 33 x 4 = 132: exactly full
    ((1, 1024, 2, 4), (32, 64)),     # 32 x 4 = 128
    ((1, 128, 2, 1), (32, 64))], ids=["prefix", "suffix", "train",
                                      "full", "one_wave_short", "tiny"])
def test_fwd_f32_tile_by_grid(shape, tile):
    """The wide tile when its grid of 64-row blocks fills the 132 SMs of
    an H100, else the narrow one."""
    b, s, g, kvh = shape
    assert fg.fwd_f32_tile(b, s, g, kvh, sms=132) == tile


def test_fwd_f32_walk_at_the_training_shape():
    """K2_TRAIN, the SFT step's decoder attention (S = Lk = 2048, 16 q /
    8 kv heads, 1253 valid keys) in the kernel's 64-row x 32-key tiles:
    the frontier alone scans 20480 tiles (the SIMT kernel's walk, bk =
    512), the skip rule walks 14240 (30% fewer); row block t (positions
    32 t to 32 t + 31) walks min(t + 1, 40) key tiles, and no block walks
    the 24 key tiles past the last valid key."""
    valid = torch.ones((1, 2048), dtype=torch.int32)
    valid[:, 1253:] = 0
    walked = fg.fwd_walk_map(2048, 2048, 2, 8, True, valid)
    scanned = fg.fwd_walk_map(2048, 2048, 2, 8, True,
                              torch.zeros_like(valid))
    assert walked.shape == (1, 8, 64, 64)
    assert int(walked.sum()) == 14240 and int(scanned.sum()) == 20480
    per_block = walked.sum(-1)
    want = torch.clamp(torch.arange(64) + 1, max=40)
    assert torch.equal(per_block, want.expand(1, 8, 64))
    assert not walked[..., 40:].any()
    # the frontier's walk: F = 512, 1024, 1536, 2048 by 512 positions
    assert torch.equal(scanned.sum(-1)[0, 0],
                       torch.arange(64) // 16 * 16 + 16)


@pytest.mark.parametrize("dtype,d,g,route", [
    (torch.float32, 128, 2, "f32"), (torch.float32, 128, 1, "f32"),
    (torch.float32, 128, 3, "f32"), (torch.float32, 128, 128, "f32"),
    (torch.float32, 256, 2, "simt"), (torch.float32, 384, 2, "simt"),
    (torch.float32, 512, 2, "simt"), (torch.bfloat16, 128, 2, "sm90"),
    (torch.bfloat16, 128, 3, "simt"), (torch.bfloat16, 256, 2, "simt")])
def test_fwd_route_by_type_dim_and_group(dtype, d, g, route):
    """K2's forward: f32 at D = 128 takes the FFMA kernel at any G, f32
    at other head dims the SIMT one, bf16 as before (`bwd_route`'s
    sibling rule with its 128-row box); the backward's routes are
    unchanged."""
    assert fg.fwd_route(dtype, d, g) == route
    if dtype == torch.float32:
        assert fg.dq_route(dtype, d, g) == route


def test_no_visible_key_and_the_tile_rule():
    """A causal row sees no valid key when the batch's first valid key
    lies past its position; a non-causal row when the batch has none. A
    row without a visible valid key keeps every tile below its frontier,
    valid keys or not; with one, a tile of invalid keys is skipped."""
    valid = torch.ones((2, 256), dtype=torch.int32)
    valid[0, :140] = 0
    valid[1] = 0
    none = fg.no_visible_key(128, 256, True, valid)       # positions 128..
    assert none[0, :12].all() and not none[0, 12:].any()
    assert none[1].all()
    assert not fg.no_visible_key(128, 256, False, valid)[0].any()
    assert fg.no_visible_key(128, 256, False, valid)[1].all()
    f = torch.full((64,), 256)
    qpos = torch.arange(64) + 128
    dead = torch.zeros(32, dtype=torch.bool)
    yes, no = torch.ones(64, dtype=torch.bool), torch.zeros(64,
                                                            dtype=torch.bool)
    assert fg.fwd_tile_walked(f, qpos, yes, dead, 32, True)
    assert not fg.fwd_tile_walked(f, qpos, no, dead, 32, True)
    assert not fg.fwd_tile_walked(f, qpos, yes, dead, 256, True)
    live = torch.ones(32, dtype=torch.bool)
    assert fg.fwd_tile_walked(f, qpos, no, live, 160, True)
    assert not fg.fwd_tile_walked(f, qpos - 100, no, live, 160, True)


@pytest.mark.parametrize("case", [CASES[i] for i in (5, 6, 3, 11, 12)],
                         ids=["no_valid_key", "s96_partial", "noncausal",
                              "noncausal_dead_block", "noncausal_none"])
def test_plain_o_and_lse_match_pallas_kernel(case):
    """The plain forward that the f32 kernel is held to on the card, O and
    lse, against the Pallas `_fwd_kernel` (through `_primal`, the
    interpreter) in the folded layout: rows without a visible valid key
    (O the mean of V, lse ~ -1e30), a partial row block, non-causal."""
    b, s, lk, h, kvh, d, causal, holes = case
    q, k, v, valid, scale = _inputs(case, seed=s + h)
    o, lse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                          kv_valid=valid, sm_scale=scale,
                                          return_lse=True)
    outg, jlse = J._primal(*(jnp.asarray(t.numpy()) for t in (q, k, v,
                                                             valid)),
                           causal, scale)
    want = np.asarray(J._from_grouped_q(outg, s, h))
    np.testing.assert_allclose(o.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=2e-5, rtol=2e-5)
    assert (lse <= -1e29).any() == bool(fg.no_visible_key(
        s, lk, causal, valid).any())


def test_k2_f32_forward_on_cpu_loads_no_library(monkeypatch):
    """gqa_flash_attention on f32 CPU tensors at D = 128 (the f32
    kernel's input on the card) runs the plain version, counts no
    launch and never builds or loads a kernel library."""
    from wedetect_tpu_torch.ops import _build

    def no_load(name):
        raise AssertionError(f"loaded {name} for CPU tensors")

    monkeypatch.setattr(_build, "load", no_load)
    monkeypatch.setattr(_build, "build", no_load)
    monkeypatch.setattr(fg.gqa_flash_fwd_f32, "launches", 0)
    monkeypatch.setattr(fg.gqa_flash_attention, "launches", 0)
    q, k, v, valid, scale = _inputs(CASES[6], seed=3)
    got = fg.gqa_flash_attention(q, k, v, kv_valid=valid, sm_scale=scale,
                                 return_lse=True)
    want = fg.gqa_flash_attention_plain(q, k, v, kv_valid=valid,
                                        sm_scale=scale, return_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fg.gqa_flash_fwd_f32.launches == 0
    assert fg.gqa_flash_attention.launches == 0
