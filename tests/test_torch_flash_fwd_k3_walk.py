"""K3's f32 forward on the card (`csrc/flash_attn_f32.cu`) walks only the
key tiles its skip rule keeps (`ops/flash_attention.fwd_tile_walked`,
`fwd_walk_map`). Here, on the CPU:

- the rule is exact on every walk case of the f32 backward kernels
  (`DKV_WALK_CASES`: the training shape's tail, a tail, three segments,
  causal with and without ids, rows whose segment no key has, with and
  without causal) and on the ViT's pattern at two heads, in both of the
  kernel's tiles (128 rows x 64 keys and 64 x 64, `fwd_f32_tile`): the
  plain forward with the skipped (row block, key tile) pairs removed
  from the scan gives bitwise the plain O and lse, and a rule that also
  drops the walked tile holding the largest weight misses;
- one rule serves the forward and the backward: the rows with no key of
  their segment (`no_visible_key`, from the segment ids) are the rows
  whose lse is at most -1e29, so the forward's map is the backward
  kernels' map in the same tiles read with the forward's lse;
- its counts and its tiles at the ViT's shapes;
- f32 CPU tensors at D = 64, through autograd too, run the plain
  version and load no library.
"""

import pytest
import torch

from test_torch_flash_bwd import (DKV_WALK_CASES, DKV_WALK_IDS,
                                  _dkv_walk_inputs)
from wedetect_tpu_torch.ops import flash_attention as fa

# the ViT at a 480x640 image (1200 real tokens padded to 1280, the pad in
# segment 0) at two heads
CASES = DKV_WALK_CASES + [(1, 1280, 2, ((1200, 1),), "same", False)]
IDS = DKV_WALK_IDS + ["vit_h2"]
# (rows, keys): the kernel's wide and narrow tiles
TILES = sorted(fa.FWD_F32_TILES.items(), reverse=True)


def _skipped_pairs(walked, l, rows, keys):
    """(B', 1, L, L) bool: the (row, key) pairs of the tiles a walk map
    (B', 1, row blocks, key tiles) skips, in the plain version's layout
    (the same for every head)."""
    skip = (~walked).repeat_interleave(rows, 2)[:, :, :l]
    return skip.repeat_interleave(keys, 3)[..., :l]


def _logits(q, k, kw):
    return fa._masked_logits(q, k, kw["q_segment_ids"],
                             kw["kv_segment_ids"], kw["causal"],
                             kw["sm_scale"])


def _walked_plain(q, k, v, kw, walked, rows, keys):
    """The plain forward's (O, lse) with the pairs the walk skips removed
    from the scan (their logits -inf, as past the frontier)."""
    skip = _skipped_pairs(walked, q.shape[1], rows, keys)
    return fa.fwd_plain_from_logits(
        _logits(q, k, kw).masked_fill(skip, float("-inf")), v, q.dtype)


def _drop_heaviest_walked_tile(q, k, kw, lse, walked, rows, keys):
    """A copy of a walk map without the walked tile holding the largest
    weight exp(logit - lse) over its rows, keys and heads: the control's
    wrong rule."""
    b, l, h, _ = q.shape
    w = torch.exp(_logits(q, k, kw) - lse[..., None])      # (B, H, L, L)
    nrb, nkt = walked.shape[-2:]
    w = torch.nn.functional.pad(w, (0, nkt * keys - l, 0, nrb * rows - l))
    tile_max = w.reshape(b, h, nrb, rows, nkt, keys).amax((1, 3, 5))
    wrong = walked.expand(b, 1, nrb, nkt).clone()
    tile_max = tile_max.masked_fill(~wrong[:, 0], 0)
    assert float(tile_max.max()) > 0
    wrong.view(-1)[int(tile_max.argmax())] = False
    return wrong


@pytest.mark.parametrize("rows,keys", TILES, ids=["wide", "narrow"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k3_fwd_f32_walk_skips_only_zero_tiles(case, rows, keys):
    """The f32 forward's skip rule (`fwd_walk_map`) is exact in each of
    the kernel's tiles: the plain forward with every skipped (row block,
    key tile) pair removed from the scan gives bitwise the plain O and
    lse. Dropping the walked tile with the largest weight as well changes
    O."""
    b, l, h, _, kv_runs, causal = case
    (q, k, v, o, lse, _), kw = _dkv_walk_inputs(case, seed=l + h + 2)
    walked = fa.fwd_walk_map(l, causal, kw["q_segment_ids"],
                             kw["kv_segment_ids"], rows=rows, keys=keys)
    assert walked.shape == (1 if kv_runs is None else b, 1, -(-l // rows),
                            -(-l // keys))
    if kv_runs not in ("same", None):
        assert float(lse.min()) <= -1e29 < float(lse.max())
    got, glse = _walked_plain(q, k, v, kw, walked, rows, keys)
    assert torch.equal(got, o) and torch.equal(glse, lse)
    wrong = _drop_heaviest_walked_tile(q, k, kw, lse, walked, rows, keys)
    bad, _ = _walked_plain(q, k, v, kw, wrong, rows, keys)
    assert not torch.equal(bad, o)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k3_fwd_walk_map_is_the_backward_rule(case):
    """The rows that `no_visible_key` finds from the segment ids are the
    rows whose plain lse is at most -1e29, and the forward's map equals
    the dq kernel's map read with the forward's lse: the same tiles
    (FWD_F32 = DQ_F32), one rule (`dkv_tile_walked` is `fwd_tile_walked`
    with lse <= -1e29). In the narrow tile, 64 x 64, it is the backward's
    rule in that tile (`dkv_walk_map`, transposed)."""
    b, l, h, _, _, causal = case
    args, kw = _dkv_walk_inputs(case, seed=l + h + 3)
    lse = args[4]
    qs, ks = kw["q_segment_ids"], kw["kv_segment_ids"]
    none = fa.no_visible_key(l, causal, qs, ks)
    assert torch.equal(none[:, None].expand_as(lse), lse <= -1e29)
    assert (fa.FWD_F32_ROWS, fa.FWD_F32_KEYS) == (fa.DQ_F32_ROWS,
                                                  fa.DQ_F32_KEYS)
    dq = fa.dq_walk_map(l, causal, qs, ks, lse)
    assert torch.equal(fa.fwd_walk_map(l, causal, qs, ks).expand_as(dq), dq)
    narrow = fa.dkv_walk_map(l, causal, qs, ks, lse, rows=64,
                             keys=64).transpose(-1, -2)
    assert torch.equal(fa.fwd_walk_map(l, causal, qs, ks, rows=64)
                       .expand_as(narrow), narrow)


def test_k3_fwd_f32_walk_at_the_vit_shapes():
    """One head of the ViT's attention, 80 pad tokens in segment 0, not
    causal. At the training shape (L = 4224, 4144 real tokens) the
    frontier alone scans 33 x 66 = 2178 tiles of 128 rows x 64 keys, the
    rule walks 2146: row blocks 0-31 (real rows only) skip the last key
    tile (pad keys only), block 32 walks all 66. At a 480x640 image
    (L = 1280, 1200 real) 191 of 200 in the wide tile, and 364 of 400 in
    the narrow one, which that shape takes (the pad-only row block walks
    the two tiles that hold pad keys)."""
    def vit(l, n_real, rows=fa.FWD_F32_ROWS):
        seg = (torch.arange(l) < n_real).to(torch.int32)[None]
        walked = fa.fwd_walk_map(l, False, seg, seg, rows=rows)
        scanned = fa.fwd_walk_map(l, False, None, None, rows=rows)
        return walked[0, 0], scanned[0, 0]

    walked, scanned = vit(4224, 4144)
    assert walked.shape == (33, 66)
    assert int(walked.sum()) == 2146 and int(scanned.sum()) == 2178
    per_block = walked.sum(-1)
    assert (per_block[:32] == 65).all() and not walked[:32, 65].any()
    assert per_block[32] == 66
    walked, scanned = vit(1280, 1200)
    assert int(walked.sum()) == 191 and int(scanned.sum()) == 200
    assert walked.sum(-1).tolist() == [19] * 9 + [20]
    walked, scanned = vit(1280, 1200, rows=64)
    assert int(walked.sum()) == 364 and int(scanned.sum()) == 400
    assert walked.sum(-1).tolist() == [19] * 18 + [20, 2]
    assert walked[19].tolist() == [False] * 18 + [True, True]


@pytest.mark.parametrize("shape,tile", [
    ((1, 1280, 16), (64, 64)),       # the ViT at 480x640: 160 wide blocks
    ((1, 4224, 16), (128, 64)),      # its training shape: 4 full waves
    ((1, 1056, 16), (64, 64)),       # 144 wide blocks: 2 waves, 272: 3
    ((1, 1024, 16), (128, 64)),      # 128 wide blocks: 1 wave, 256: 2
    ((2, 4224, 16), (128, 64)),      # 1056 wide blocks: 8 full waves
    ((1, 128, 2), (64, 64))], ids=["vit", "train", "short_second_wave",
                                   "one_wide_wave", "train_b2", "tiny"])
def test_fwd_f32_tile_by_grid(shape, tile):
    """The narrow tile when its waves (each block 0.6 of a wide block's
    time) end before the wide tile's on the 132 SMs of an H100, else the
    wide one."""
    b, l, h = shape
    assert fa.fwd_f32_tile(b, l, h, sms=132) == tile


def test_no_visible_key_and_the_tile_rule():
    """Not causal, a row sees no key of its segment when no key carries
    its id; causal, when its id's first key lies past it. Such a row
    keeps every tile below its frontier; a row that sees one skips a
    tile without its id, and under causal a tile past it."""
    ks = torch.ones((1, 256), dtype=torch.int32)
    ks[:, 200:] = 2
    qs = ks.clone()
    qs[:, 100:110] = 9                             # an id no key carries
    none = fa.no_visible_key(256, False, qs, ks)[0]
    assert none[100:110].all() and none.sum() == 10
    # causal: rows 0-199 see key 0; rows 200.. see key 200 (their own)
    none = fa.no_visible_key(256, True, ks, ks)[0]
    assert not none.any()
    late = ks.clone()
    late[:, 150:220] = 2                           # id 2 from key 150 on
    none = fa.no_visible_key(256, True, ks, late)[0]
    assert not none[:200].any() and not none[200:].any()
    none = fa.no_visible_key(256, True, late, ks)[0]
    assert none[150:200].all() and none.sum() == 50
    assert not fa.no_visible_key(256, True, None, None).any()
    qpos = torch.arange(64) + 128
    qseg = torch.full((64,), 2, dtype=torch.int32)
    kseg = torch.ones(64, dtype=torch.int32)
    yes = torch.ones(64, dtype=torch.bool)
    no = torch.zeros(64, dtype=torch.bool)
    assert fa.fwd_tile_walked(qpos, qseg, yes, kseg, 64, 256, False)
    assert not fa.fwd_tile_walked(qpos, qseg, no, kseg, 64, 256, False)
    assert fa.fwd_tile_walked(qpos, qseg, no, qseg, 64, 256, False)
    assert not fa.fwd_tile_walked(qpos, qseg, yes, kseg, 192, 256, True)
    assert fa.fwd_tile_walked(qpos, qseg, yes, kseg, 128, 256, True)
    # rows past L count for nothing
    assert not fa.fwd_tile_walked(qpos + 128, qseg, yes, qseg, 0, 256,
                                  False)
    # the backward's rule is the forward's with lse <= -1e29
    lse = torch.where(yes, -1e30, 0.0)
    assert fa.dkv_tile_walked(qpos, qseg, lse, kseg, 64, 256, False)
    assert not fa.dkv_tile_walked(qpos, qseg, lse + 1e30, kseg, 64, 256,
                                  False)


@pytest.mark.parametrize("causal", [False, True])
def test_k3_f32_forward_on_cpu_loads_no_library(monkeypatch, causal):
    """flash_attention on f32 CPU tensors at D = 64 (the f32 forward's
    input on the card), forward and loss.backward(), runs the plain
    versions, counts no launch and never builds or loads a kernel
    library."""
    from wedetect_tpu_torch.ops import _build

    def no_load(name):
        raise AssertionError(f"loaded {name} for CPU tensors")

    monkeypatch.setattr(_build, "load", no_load)
    monkeypatch.setattr(_build, "build", no_load)
    for fn in (fa.flash_attention, fa.flash_attention_fwd_f32):
        monkeypatch.setattr(fn, "launches", 0)
    case = DKV_WALK_CASES[3 if causal else 5]
    (q, k, v, o, lse, do), kw = _dkv_walk_inputs(case, seed=7)
    assert fa.fwd_route(q.dtype, q.shape[-1]) == "f32"
    got, glse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(got, o) and torch.equal(glse, lse)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, **kw).backward(do)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention_fwd_f32.launches == 0
