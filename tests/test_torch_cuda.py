"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`; each test skips where no card is present. On the
card (whose Python has no JAX, so without the JAX conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rows(r, k, seed, dev, kind="mixed", t=64):
    """K1's inputs by kind: "mixed" (masks, ties, full masks, signed
    zeros), "sparse" (the detect path: most rows empty, the rest 1-63
    candidates), "nan" (NaN rows among mixed ones), "boundary" (exactly
    t and t + 1 candidates), "cut_tie" (more than t, the t-th value tied
    across the cut), "inf" (+-inf among values)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (r, k)).astype(np.float32)
    if kind in ("mixed", "nan"):
        x[::3] = np.floor(x[::3] * 4) / 4                 # ties
        x[rng.uniform(0, 1, (r, k)) > rng.uniform(0, 1, (r, 1))] = -np.inf
        x[::11] = -np.inf                                 # fully masked
        x[1::13] = rng.choice(np.array([0.0, -0.0, -np.inf], np.float32),
                              (len(x[1::13]), k))         # signed zeros
    if kind == "nan":
        bits = x.view(np.uint32)
        bits[::5, 7] = 0x7FC00000                         # +nan
        bits[1::5, 3] = 0xFFC00000                        # -nan
        bits[2::5, -1] = 0x7FC00001                       # the last lane
        for i in range(3, r, 5):                          # several payloads
            pos = rng.choice(k, 4, replace=False)
            bits[i, pos] = (rng.integers(0, 2, 4).astype(np.uint32) << 31
                            | 0x7F800000
                            | rng.integers(1, 1 << 23, 4).astype(np.uint32))
    elif kind == "sparse":
        n = np.where(rng.uniform(0, 1, r) < 0.25, rng.integers(1, 64, r), 0)
        rank = rng.uniform(0, 1, (r, k)).argsort(1).argsort(1)
        x = np.where(rank < n[:, None], 0.3 + 0.7 * x, -np.inf)
        x[::4] = np.floor(x[::4] * 8) / 8
    elif kind == "boundary":
        n = t + np.arange(r) % 2
        rank = rng.uniform(0, 1, (r, k)).argsort(1).argsort(1)
        x = np.where(rank < n[:, None], np.floor(x * 3) / 3, -np.inf)
    elif kind == "cut_tie":
        rank = rng.uniform(0, 1, (r, k)).argsort(1).argsort(1)
        x = np.where(rank < t // 2, 0.5 + x / 2,
                     np.where(rank < t // 2 + t, 0.25, x / 5))
        x[:, ::7] = -np.inf
    elif kind == "inf":
        x = rng.choice(np.array([np.inf, -np.inf, 0.5, 0.25, -1.0],
                                np.float32), (r, k))
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)


def _branches(x, t):
    """Rows by branch, as the kernel counts them: no candidate, at most
    t, more than t, a NaN."""
    nan = torch.isnan(x).any(1)
    n = (x > float("-inf")).sum(1)
    return [int(((n == 0) & ~nan).sum()), int(((n > 0) & (n <= t) & ~nan)
                                              .sum()),
            int(((n > t) & ~nan).sum()), int(nan.sum())]


MAX_K = -1   # row_topk_max_k(), read on the card


@pytest.mark.parametrize("kind,r,k,t", [
    ("mixed", 1000, 1203, 64), ("mixed", 999, 37, 37), ("mixed", 512, 80, 64),
    ("mixed", 300, 1280, 64), ("mixed", 200, 2000, 64), ("mixed", 64, 33, 1),
    ("sparse", 67200, 1203, 64),         # the detect path's shape
    ("nan", 999, 1203, 64), ("nan", 100, 2000, 64),
    ("boundary", 1000, 1203, 64), ("boundary", 200, 2000, 64),
    ("boundary", 300, 100, 7),
    ("cut_tie", 500, 1203, 64), ("cut_tie", 100, 2000, 64),
    ("cut_tie", 256, 300, 130),          # t > 64: slots in chunks
    ("inf", 256, 200, 20), ("mixed", 128, 150, 150),
    ("mixed", 64, MAX_K, 64), ("sparse", 256, MAX_K, 64),
    ("cut_tie", 32, MAX_K, 100),
])
def test_row_topk_kernel_bitwise(cuda, monkeypatch, kind, r, k, t):
    """The kernel against t rounds of iterative max (row_topk_plain) and
    against its own rule (row_topk_by_key), bitwise, on both the
    register (K <= 1280) and the shared-memory path; the rows it counts
    in each branch equal the input's."""
    from wedetect_tpu_torch.ops.row_topk import (row_topk, row_topk_by_key,
                                                 row_topk_max_k,
                                                 row_topk_plain)

    k = row_topk_max_k() if k == MAX_K else k
    monkeypatch.setattr(row_topk, "launches", 0)
    x = _rows(r, k, seed=r + k, dev=cuda, kind=kind, t=t)
    branches = torch.zeros(4, dtype=torch.int32, device=cuda)
    kv, kc = row_topk(x, t, branches=branches)
    torch.cuda.synchronize()
    assert row_topk.launches == 1
    for pv, pc in (row_topk_plain(x, t), row_topk_by_key(x, t)):
        assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
        assert torch.equal(kc, pc)
    assert branches.tolist() == _branches(x, t)


def test_row_topk_rejects_bad_input(cuda):
    from wedetect_tpu_torch.ops.row_topk import row_topk

    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(TypeError):
        row_topk(x.double(), 2)
    with pytest.raises(ValueError):
        row_topk(x[:, ::2], 2)           # not contiguous
    with pytest.raises(ValueError):
        row_topk(x, 9)                   # t > K
    with pytest.raises(ValueError):      # branch counts: int32, 4 of them
        row_topk(x, 2, branches=torch.zeros(4, device=cuda))
    with pytest.raises(ValueError):
        row_topk(torch.zeros((4, 8000), device=cuda), 2)   # K > max


def test_detect_step_card_matches_cpu(cuda, monkeypatch):
    """A miniature detector: the card (row top-k kernel in the sparse
    selection) against the CPU (plain version) on the same scores."""
    from wedetect_tpu_torch.configs import ModelCfg, TestCfg
    from wedetect_tpu_torch.models import wedetect as W
    from wedetect_tpu_torch.ops import nms
    from wedetect_tpu_torch.ops.row_topk import row_topk

    monkeypatch.setattr(nms, "TOPK_THRESHOLD_MIN_N", 1)
    monkeypatch.setattr(row_topk, "launches", 0)
    cfg = ModelCfg(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                   neck_scale=0.25, neck_repeats=2,
                   head_in_channels=(32, 64, 128), embed_dims=32,
                   img_size=(64, 64), text=None, num_classes=8,
                   test=TestCfg(nms_pre=256, max_per_img=16, score_thr=0.3))
    model = W.init_variables(cfg, seed=1, device=cuda)
    imgs = np.random.default_rng(0).integers(0, 255, (2, 64, 64, 3),
                                             dtype=np.uint8)
    w = np.random.default_rng(1).standard_normal((8, 32)).astype(np.float32)
    dec = W.forward_raw(cfg, model, imgs, w)
    args = [torch.ones((2, 2)), torch.zeros((2, 4)), torch.full((2, 2), 64.)]
    card = W.postprocess(cfg, dec, *(a.to(cuda) for a in args))
    cpu = W.postprocess(cfg, W.DetectorOutputs(*(x.cpu() for x in dec)),
                        *args)
    assert row_topk.launches == 1
    assert int(cpu.valid.sum()) > 0
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


# (B, S, Lk, H, KVH, D, causal, masked): the JAX grid
# (tests/test_flash_gqa.py) and the Ref path's prefix and suffix shapes
K2_CASES = [
    (2, 128, 384, 4, 2, 128, True, False),
    (1, 128, 128, 4, 1, 128, True, False),
    (2, 128, 640, 8, 2, 128, True, True),
    (1, 256, 256, 8, 8, 128, False, True),
    (1, 128, 512, 16, 8, 128, True, True),
    (1, 384, 384, 16, 8, 128, True, True),
    (8, 256, 640, 16, 8, 128, True, True),
    (2, 96, 384, 4, 2, 128, True, True),      # S * G = 192: a partial block
]
# D = 256: the SIMT kernels in both types (JAX tiles any D % 128 == 0)
K2_D256 = [
    (1, 128, 256, 4, 2, 256, True, True),
    (1, 128, 128, 2, 2, 256, False, False),
]
# (atol, rtol). f32: summation order only. bf16: the kernel and the
# plain version round the same f32 value to bf16 (at most one bf16 ulp
# of |O| apart, 0.0039 at |O| < 1 on the card), so the limit is
# 2e-3 + 1e-2 |O|, above one ulp at every magnitude
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-3, 1e-2)}


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    return torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)


def _attn_inputs(shape_q, shape_kv, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=dev, dtype=dtype) for s in (shape_q, shape_kv,
                                                   shape_kv)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,lk,h,kvh,d,causal,masked", K2_CASES + K2_D256)
def test_gqa_flash_kernel_matches_plain(cuda, monkeypatch, dtype, b, s, lk,
                                        h, kvh, d, causal, masked):
    from wedetect_tpu_torch.ops.flash_gqa import (gqa_flash_attention,
                                                  gqa_flash_attention_plain)

    monkeypatch.setattr(gqa_flash_attention, "launches", 0)
    q, k, v = _attn_inputs((b, s, h, d), (b, lk, kvh, d), dtype, cuda,
                           seed=s + lk)
    valid = None
    if masked:
        m = torch.ones((b, lk), dtype=torch.int32)
        m[:, lk // 2 - 8:lk // 2] = 0
        m[:, -5:] = 0
        m[0, :4] = 0                       # rows whose first keys are masked
        valid = m.to(cuda)
    got, lse = gqa_flash_attention(q, k, v, causal=causal, kv_valid=valid,
                                   return_lse=True)
    torch.cuda.synchronize()
    want, wlse = gqa_flash_attention_plain(q, k, v, causal=causal,
                                           kv_valid=valid, return_lse=True)
    assert gqa_flash_attention.launches == 1
    assert got.dtype == dtype
    assert _close(got, want, dtype)
    assert torch.allclose(lse, wlse, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("b,s,lk,h,kvh,d,causal,masked", K2_CASES)
def test_gqa_flash_sm90_kernel_matches_plain(cuda, monkeypatch, b, s, lk, h,
                                             kvh, d, causal, masked):
    """bf16 goes to the wgmma + TMA kernel (its own launch count), and
    agrees with the plain version."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    monkeypatch.setattr(fg.gqa_flash_attention, "launches", 0)
    monkeypatch.setattr(fg.gqa_flash_fwd_sm90, "launches", 0)
    dtype = torch.bfloat16
    q, k, v = _attn_inputs((b, s, h, d), (b, lk, kvh, d), dtype, cuda,
                           seed=s + lk + 7)
    valid = torch.ones((b, lk), dtype=torch.int32)
    if masked:
        valid[:, lk // 2 - 8:lk // 2] = 0
        valid[:, -5:] = 0
        valid[-1, :4] = 0
    valid = valid.to(cuda)
    got, lse = fg.gqa_flash_attention(q, k, v, causal=causal, kv_valid=valid,
                                      return_lse=True)
    torch.cuda.synchronize()
    want, wlse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                              kv_valid=valid,
                                              return_lse=True)
    assert fg.gqa_flash_fwd_sm90.launches == 1
    assert fg.gqa_flash_attention.launches == 1
    assert got.dtype == dtype
    assert _close(got, want, dtype)
    assert torch.allclose(lse, wlse, atol=1e-3, rtol=1e-5)


def test_gqa_flash_sm90_fully_masked_rows(cuda):
    """bf16: rows whose scanned keys are all masked get the mean of V
    over the scanned keys."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    q, k, v = _attn_inputs((1, 128, 4, 128), (1, 256, 2, 128),
                           torch.bfloat16, cuda, seed=5)
    valid = torch.ones((1, 256), dtype=torch.int32, device=cuda)
    valid[:, :132] = 0
    launches = fg.gqa_flash_fwd_sm90.launches
    got = fg.gqa_flash_attention(q, k, v, causal=True, kv_valid=valid)
    want = fg.gqa_flash_attention_plain(q, k, v, causal=True, kv_valid=valid)
    assert fg.gqa_flash_fwd_sm90.launches == launches + 1
    assert _close(got, want, torch.bfloat16)
    mean_v = v[0].float().mean(0)                         # (KVH, D)
    assert _close(got[0, 0].reshape(2, 2, 128),
                  mean_v[:, None].expand(2, 2, 128), torch.bfloat16)


def test_gqa_flash_sm90_rejects_bad_input(cuda, monkeypatch):
    """Misaligned or non-contiguous bf16 input raises; nothing falls
    back to the SIMT kernel. A group size that does not divide 128 goes
    to the SIMT kernel by route (`fwd_route`), and the wgmma kernel
    itself refuses it."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    q = torch.zeros((1, 128, 4, 128), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 128, 2, 128), device=cuda, dtype=torch.bfloat16)
    buf = torch.zeros(q.numel() + 8, device=cuda, dtype=torch.bfloat16)
    shifted = buf[1:1 + q.numel()].view(q.shape)         # 2-byte offset
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fg.gqa_flash_attention(shifted, k, k)
    with pytest.raises(ValueError, match="contiguous"):
        fg.gqa_flash_attention(q, k.transpose(1, 2).contiguous()
                               .transpose(1, 2), k)
    monkeypatch.setattr(fg.gqa_flash_fwd_sm90, "launches", 0)
    x, k3, v3 = _attn_inputs((1, 128, 6, 128), (1, 128, 2, 128),
                             torch.bfloat16, cuda, seed=4)
    got = fg.gqa_flash_attention(x, k3, v3)
    assert fg.gqa_flash_fwd_sm90.launches == 0
    assert _close(got, fg.gqa_flash_attention_plain(x, k3, v3),
                  torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        fg.gqa_flash_fwd_sm90(x, k3, v3, None, True, 0.1)


def test_gqa_flash_kernel_fully_masked_rows(cuda):
    """Rows whose scanned keys are all masked: the mean of V over the
    scanned keys, on the kernel as on the plain version."""
    from wedetect_tpu_torch.ops.flash_gqa import (gqa_flash_attention,
                                                  gqa_flash_attention_plain)

    q, k, v = _attn_inputs((1, 128, 4, 128), (1, 256, 2, 128),
                           torch.float32, cuda, seed=5)
    valid = torch.ones((1, 256), dtype=torch.int32, device=cuda)
    valid[:, :132] = 0
    got = gqa_flash_attention(q, k, v, causal=True, kv_valid=valid)
    want = gqa_flash_attention_plain(q, k, v, causal=True, kv_valid=valid)
    assert (got - want).abs().max() <= 1e-4
    mean_v = v[0].mean(0)                                 # (KVH, D)
    assert (got[0, 0].reshape(2, 2, 128) - mean_v[:, None]).abs().max() \
        <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,d,n_real,causal", [
    (1, 1280, 16, 64, 1200, False),      # the ViT at a 480x640 image
    (1, 256, 4, 64, 256, True),
    (2, 384, 4, 128, 300, False),
    (1, 128, 2, 128, 128, False),
    (1, 256, 2, 256, 200, False),
    (1, 128, 2, 256, 128, True)])
def test_flash_attention_kernel_matches_plain(cuda, monkeypatch, dtype, b, l,
                                              h, d, n_real, causal):
    from wedetect_tpu_torch.ops import flash_attention as fa
    from wedetect_tpu_torch.ops.flash_attention import (flash_attention,
                                                        flash_attention_plain)

    monkeypatch.setattr(flash_attention, "launches", 0)
    monkeypatch.setattr(fa.flash_attention_fwd_sm90, "launches", 0)
    monkeypatch.setattr(fa.flash_attention_fwd_f32, "launches", 0)
    q, k, v = _attn_inputs((b, l, h, d), (b, l, h, d), dtype, cuda, seed=l)
    seg = (torch.arange(l, device=cuda) < n_real).to(torch.int32)
    seg = seg[None].expand(b, l).contiguous()
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
              sm_scale=d ** -0.5, return_lse=True)
    got, lse = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want, wlse = flash_attention_plain(q, k, v, **kw)
    assert flash_attention.launches == 1
    # at D = 64 bf16 ran the wgmma kernel and f32 the FFMA one, the rest
    # the SIMT one
    route = fa.fwd_route(dtype, d)
    assert route == ("simt" if d != 64 else
                     "f32" if dtype == torch.float32 else "sm90")
    assert fa.flash_attention_fwd_sm90.launches == int(route == "sm90")
    assert fa.flash_attention_fwd_f32.launches == int(route == "f32")
    assert _close(got, want, dtype)
    assert torch.allclose(lse, wlse, atol=1e-3, rtol=1e-5)


# the per-rank shapes of tensor-parallel serving at ref_2b: each of tp
# ranks runs 16 / tp query heads, 8 / tp kv heads and 16 / tp ViT heads
# (a 480x640 image: the prefix of 384 keys, the suffix of 8 rows of 256
# over 640 keys, the ViT's 1280 padded tokens of which 1200 are real)
TP_RANK_SHAPES = {
    "k2_prefix": lambda tp: ("k2", 1, 384, 384, 16 // tp, 8 // tp, 128),
    "k2_suffix": lambda tp: ("k2", 8, 256, 640, 16 // tp, 8 // tp, 128),
    "k3_vit": lambda tp: ("k3", 1, 1280, 1200, 16 // tp, None, 64)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("shape", list(TP_RANK_SHAPES))
def test_tp_rank_shapes_match_plain(cuda, monkeypatch, dtype, tp, shape):
    """K2 and K3 at a tensor-parallel rank's head counts take the same
    routes (f32 the FFMA kernels, bf16 the wgmma ones) and agree with
    their plain versions."""
    from wedetect_tpu_torch.ops import flash_attention as fa
    from wedetect_tpu_torch.ops import flash_gqa as fg

    kind, b, s, lk, h, kvh, d = TP_RANK_SHAPES[shape](tp)
    f32 = dtype == torch.float32
    if kind == "k2":
        route = fg.gqa_flash_fwd_f32 if f32 else fg.gqa_flash_fwd_sm90
        monkeypatch.setattr(route, "launches", 0)
        q, k, v = _attn_inputs((b, s, h, d), (b, lk, kvh, d), dtype, cuda,
                               seed=s + lk + h)
        p = lk - s if lk > s else lk              # the prefix's keys
        valid = torch.ones((b, lk), dtype=torch.int32)
        valid[:, p - 20:p] = 0                    # the prefix's padding
        valid[1:, -40:] = 0                       # shorter suffix rows
        valid = valid.to(cuda)
        kw = dict(causal=True, kv_valid=valid, return_lse=True)
        got, lse = fg.gqa_flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want, wlse = fg.gqa_flash_attention_plain(q, k, v, **kw)
    else:
        route = fa.flash_attention_fwd_f32 if f32 else \
            fa.flash_attention_fwd_sm90
        monkeypatch.setattr(route, "launches", 0)
        q, k, v = _attn_inputs((b, s, h, d), (b, s, h, d), dtype, cuda,
                               seed=s + h)
        seg = (torch.arange(s, device=cuda) < lk).to(torch.int32)[None]
        kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=False,
                  sm_scale=d ** -0.5, return_lse=True)
        got, lse = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want, wlse = fa.flash_attention_plain(q, k, v, **kw)
    assert route.launches == 1
    assert _close(got, want, dtype)
    assert torch.allclose(lse, wlse, atol=1e-3, rtol=1e-5)


def test_attention_kernels_reject_bad_input(cuda):
    from wedetect_tpu_torch.ops.flash_attention import flash_attention
    from wedetect_tpu_torch.ops.flash_gqa import gqa_flash_attention

    q = torch.zeros((1, 128, 4, 128), device=cuda)
    k = torch.zeros((1, 128, 2, 128), device=cuda)
    with pytest.raises(TypeError):
        gqa_flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):                      # v's shape
        gqa_flash_attention(q, k, k[:, :, :1].contiguous())
    with pytest.raises(ValueError):                      # not contiguous
        gqa_flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                            k)
    with pytest.raises(ValueError):                      # not square
        flash_attention(q, q[:, :64], q[:, :64])
    # above 512, the card's limit, both raise before any launch
    x = torch.zeros((1, 128, 4, 520), device=cuda)
    with pytest.raises(ValueError, match="up to 512"):
        flash_attention(x, x, x)
    x = torch.zeros((1, 128, 4, 640), device=cuda)
    xk = torch.zeros((1, 128, 2, 640), device=cuda)
    with pytest.raises(ValueError, match="at most 512"):
        gqa_flash_attention(x, xk, xk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,causal", [(32, False), (72, False), (80, True),
                                      (512, False)])
def test_flash_attention_head_dims_match_plain(cuda, monkeypatch, dtype, d,
                                               causal):
    """K3 at a head dim the SIMT kernels are not built for (32, 72, 80:
    padded with zero columns to 64 or 128) and at 512 (16 x 16 backward
    tiles): forward and backward on the SIMT kernels, against the plain
    versions (TOL, BWD_TOL), the backward bitwise over two runs."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    others = (fa.flash_attention_fwd_sm90, fa.flash_attention_fwd_f32,
              fa.flash_attention_bwd_dq_sm90,
              fa.flash_attention_bwd_dkv_sm90, fa.flash_attention_bwd_dkv_f32,
              fa.flash_attention_bwd_dq_f32)
    for fn in (fa.flash_attention, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, *others):
        monkeypatch.setattr(fn, "launches", 0)
    b, l, h, n_real = 1, 256, 2, 200
    q, k, v = _attn_inputs((b, l, h, d), (b, l, h, d), dtype, cuda, seed=d)
    do = _attn_inputs((b, l, h, d), (b, l, h, d), dtype, cuda, seed=d + 1)[0]
    do[:, n_real:] = 0
    seg = (torch.arange(l, device=cuda) < n_real).to(torch.int32)[None]
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
              sm_scale=d ** -0.5)
    got, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    grads = [fa.flash_attention_bwd(q, k, v, got, lse, do, **kw)
             for _ in range(2)]
    torch.cuda.synchronize()
    want, wlse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert got.shape == q.shape and got.is_contiguous()
    assert _close(got, want, dtype)
    assert (lse - wlse).abs().max() <= 1e-3
    plain = fa.flash_attention_bwd_plain(q, k, v, got, lse, do, **kw)
    for a, a2, w in zip(grads[0], grads[1], plain):
        assert a.shape == q.shape and a.dtype == dtype
        assert torch.equal(a, a2)
        assert _rel_err(a, w) <= BWD_TOL[dtype]
    assert fa.flash_attention.launches == 1
    assert fa.flash_attention_bwd_dq.launches == 2
    assert fa.flash_attention_bwd_dkv.launches == 2
    assert all(fn.launches == 0 for fn in others)      # the SIMT kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [384, 512])
def test_gqa_flash_head_dims_match_plain(cuda, monkeypatch, dtype, d):
    """K2 at D = 384 and 512 (JAX tiles any D % 128 == 0): forward and
    backward on the SIMT kernels against the plain versions."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in (fg.gqa_flash_attention, fg.gqa_flash_fwd_sm90,
               fg.gqa_flash_bwd_dq, fg.gqa_flash_bwd_dkdv):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, do, valid = _bwd_case((1, 128, 256, 4, 2, d, True,
                                    ((120, 136),)), dtype, cuda, seed=d)
    got, lse = fg.gqa_flash_attention(q, k, v, causal=True, kv_valid=valid,
                                      return_lse=True)
    grads = [fg.gqa_flash_attention_bwd(q, k, v, valid, got, lse, do,
                                        causal=True, sm_scale=d ** -0.5)
             for _ in range(2)]
    torch.cuda.synchronize()
    want, wlse = fg.gqa_flash_attention_plain(q, k, v, causal=True,
                                              kv_valid=valid, return_lse=True)
    assert _close(got, want, dtype)
    assert torch.allclose(lse, wlse, atol=1e-3, rtol=1e-5)
    plain = fg.gqa_flash_attention_bwd_plain(q, k, v, valid, got, lse, do,
                                             True, d ** -0.5)
    for a, a2, w in zip(grads[0], grads[1], plain):
        assert torch.equal(a, a2)
        assert _rel_err(a, w) <= BWD_TOL[dtype]
    assert fg.gqa_flash_attention.launches == 1
    assert fg.gqa_flash_fwd_sm90.launches == 0
    assert fg.gqa_flash_bwd_dq.launches == 2
    assert fg.gqa_flash_bwd_dkdv.launches == 2


def test_attention_auto_on_the_card_raises_on_untileable_shapes(cuda,
                                                                monkeypatch):
    """On a CUDA tensor "auto" runs the kernels or raises: no einsum."""
    from wedetect_tpu_torch.ops import attention
    from wedetect_tpu_torch.ops.flash_gqa import gqa_flash_attention

    def no_einsum(*a, **kw):
        raise AssertionError("the einsum attention ran on the card")

    monkeypatch.setattr(attention, "_reference_attention", no_einsum)
    monkeypatch.setattr(attention, "_grouped_reference_attention", no_einsum)
    monkeypatch.setattr(gqa_flash_attention, "launches", 0)
    q = torch.zeros((1, 200, 4, 128), device=cuda)
    k = torch.zeros((1, 200, 2, 128), device=cuda)
    with pytest.raises(ValueError, match="not tileable"):
        attention.gqa_attention(q, k, k)
    with pytest.raises(ValueError, match="not tileable"):
        attention.dot_product_attention(q, q, q)
    attention.gqa_attention(q[:, :128].contiguous(), k[:, :128].contiguous(),
                            k[:, :128].contiguous())
    assert gqa_flash_attention.launches == 1


def test_ref_scorer_oversize_suffix_on_the_card(cuda, monkeypatch):
    """A suffix longer than the largest bucket is padded to a multiple of
    128 and runs K2 on the card, never the einsum."""
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_api import RefScorer
    from wedetect_tpu_torch.nn.qwen3vl import RefCfg, RefTextCfg, RefVisionCfg
    from wedetect_tpu_torch.ops import attention
    from wedetect_tpu_torch.ops.flash_gqa import gqa_flash_attention

    class Tok:
        def encode(self, text, add_special_tokens=False):
            return [(ord(ch) % 80) + 1 for ch in text]

    def no_einsum(*a, **kw):
        raise AssertionError("the einsum attention ran on the card")

    cfg = RefCfg(
        vision=RefVisionCfg(depth=2, hidden=128, heads=2, intermediate=256,
                            patch=4, temporal_patch=2, merge=2,
                            out_hidden=256, num_pos_emb=64,
                            deepstack_idx=(0, 1)),
        text=RefTextCfg(vocab_size=256, hidden=256, layers=2, heads=4,
                        kv_heads=2, head_dim=128, intermediate=512,
                        rope_theta=1000.0),
        image_token_id=120, vision_start_token_id=122, object_token_id=123)
    monkeypatch.setattr(attention, "_reference_attention", no_einsum)
    monkeypatch.setattr(attention, "_grouped_reference_attention", no_einsum)
    monkeypatch.setattr(gqa_flash_attention, "launches", 0)
    scorer = RefScorer(cfg=cfg, model=init_ref_variables(cfg, 1, cuda),
                       tokenizer=Tok(), suffix_buckets=(128,),
                       max_proposals=120, device=cuda)
    image = np.random.default_rng(0).integers(0, 255, (64, 96, 3),
                                              dtype=np.uint8)
    boxes = np.array([[2, 2, 30, 20], [10, 5, 90, 60]], np.float32)
    assert len(scorer.build_suffix("a dog", 120)) > 128
    scores = scorer.score(image, boxes, ["a dog"], pad_token_id=0)
    assert scores.shape == (1, 2) and np.isfinite(scores).all()
    assert gqa_flash_attention.launches == 2 * cfg.text.layers


# ------------------------------------------------------------- backward
# (atol, rtol) of the backward kernels against the plain backward, on
# gradients scaled to unit magnitude (error / max |plain|). f32: the
# summation order only; bf16: both round ds and p to bf16 before their
# products, so a value may land one bf16 ulp apart (2^-8 relative)
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,lk,h,kvh,d,causal,masked", K2_CASES[:5] + [
    (1, 512, 512, 16, 8, 128, True, True)] + K2_D256)
def test_gqa_flash_bwd_kernels_match_plain(cuda, monkeypatch, dtype, b, s,
                                           lk, h, kvh, d, causal, masked):
    from wedetect_tpu_torch.ops import flash_gqa as fg

    monkeypatch.setattr(fg.gqa_flash_bwd_dq, "launches", 0)
    monkeypatch.setattr(fg.gqa_flash_bwd_dkdv, "launches", 0)
    q, k, v = _attn_inputs((b, s, h, d), (b, lk, kvh, d), dtype, cuda,
                           seed=s + lk + 1)
    do = _attn_inputs((b, s, h, d), (b, lk, kvh, d), dtype, cuda,
                      seed=s + lk + 2)[0]
    valid = None
    if masked:
        m = torch.ones((b, lk), dtype=torch.int32)
        m[:, lk // 2 - 8:lk // 2] = 0
        m[:, -5:] = 0
        valid = m.to(cuda)
    scale = d ** -0.5
    o, lse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                          kv_valid=valid, sm_scale=scale,
                                          return_lse=True)
    got = [fg.gqa_flash_attention_bwd(q, k, v, valid, o, lse, do,
                                      causal=causal, sm_scale=scale)
           for _ in range(2)]
    torch.cuda.synchronize()
    want = fg.gqa_flash_attention_bwd_plain(q, k, v, valid, o, lse, do,
                                            causal, scale)
    assert fg.gqa_flash_bwd_dq.launches == 2
    assert fg.gqa_flash_bwd_dkdv.launches == 2
    for a, a2, w in zip(got[0], got[1], want):
        assert a.dtype == dtype
        assert torch.equal(a, a2)                          # deterministic
        assert _rel_err(a, w) <= BWD_TOL[dtype]


def _k3_bwd_counters(fa):
    """K3-bwd's launch counters: both routes, then the wgmma kernels'."""
    return (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
            fa.flash_attention_bwd_dq_sm90, fa.flash_attention_bwd_dkv_sm90)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,d,n_real,causal", [
    (1, 1280, 16, 64, 1200, False),
    (1, 256, 4, 64, 256, True),
    (2, 384, 4, 128, 300, False),
    (1, 256, 2, 256, 200, False),
    (1, 128, 2, 256, 128, True)])
def test_flash_attention_bwd_kernels_match_plain(cuda, monkeypatch, dtype, b,
                                                 l, h, d, n_real, causal):
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in _k3_bwd_counters(fa):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v = _attn_inputs((b, l, h, d), (b, l, h, d), dtype, cuda,
                           seed=l + 1)
    do = _attn_inputs((b, l, h, d), (b, l, h, d), dtype, cuda, seed=l + 2)[0]
    do[:, n_real:] = 0                   # the ViT drops its pad rows
    seg = (torch.arange(l, device=cuda) < n_real).to(torch.int32)
    seg = seg[None].expand(b, l).contiguous()
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
              sm_scale=d ** -0.5)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = [fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
           for _ in range(2)]
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert fa.flash_attention_bwd_dq.launches == 2
    assert fa.flash_attention_bwd_dkv.launches == 2
    # bf16 at D = 64 ran the wgmma kernels, the rest the SIMT ones
    sm90 = 2 if fa.bwd_route(dtype, d) == "sm90" else 0
    assert fa.flash_attention_bwd_dq_sm90.launches == sm90
    assert fa.flash_attention_bwd_dkv_sm90.launches == sm90
    for a, a2, w in zip(got[0], got[1], want):
        assert torch.equal(a, a2)                          # deterministic
        assert _rel_err(a, w) <= BWD_TOL[dtype]


# (B, L, H, causal, segment runs per batch row): the bf16 K3 backward
# kernels' cases at D = 64. A row's runs are (end, id) pairs: each id up
# to its end, then segment 0 (pad); None: no segment ids
SM90_K3_BWD_CASES = [
    (1, 1280, 16, False, [((1200, 1),)]),          # the ViT, 80 pad tokens
    (1, 256, 4, True, [((256, 1),)]),              # causal
    (1, 512, 4, False, [((100, 1), (300, 2), (480, 3))]),  # off the grid
    (1, 200, 4, False, [((180, 1),)]),             # L = 200: a tail
    (2, 384, 4, False, [((300, 1),), ((350, 1),)]),  # pads per batch row
    (1, 320, 2, True, None),                       # no ids, causal tail
]


def _k3_seg(b, l, runs, dev):
    if runs is None:
        return None
    seg = torch.zeros((b, l), dtype=torch.int32)
    for row, row_runs in enumerate(runs):
        start = 0
        for end, sid in row_runs:
            seg[row, start:end] = sid
            start = end
    return seg.to(dev)


def _k3_bwd_case(case, dev, seed):
    b, l, h, causal, runs = case
    q, k, v = _attn_inputs((b, l, h, 64), (b, l, h, 64), torch.bfloat16,
                           dev, seed)
    do = _attn_inputs((b, l, h, 64), (b, l, h, 64), torch.bfloat16, dev,
                      seed + 1)[0]
    seg = _k3_seg(b, l, runs, dev)
    if seg is not None:
        do[seg == 0] = 0                 # the ViT drops its pad rows
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
              sm_scale=0.125)
    return q, k, v, do, kw


@pytest.mark.parametrize("case", SM90_K3_BWD_CASES)
def test_flash_attention_bwd_sm90_kernels_match_plain(cuda, monkeypatch,
                                                      case):
    """bf16 K3-bwd at D = 64 goes to the wgmma + TMA kernels (their own
    launch counts), agrees with the plain backward and repeats bit for
    bit."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in _k3_bwd_counters(fa):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, do, kw = _k3_bwd_case(case, cuda, seed=case[1])
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = [fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
           for _ in range(2)]
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for fn in _k3_bwd_counters(fa):
        assert fn.launches == 2
    for a, a2, w in zip(got[0], got[1], want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, a2)                          # deterministic
        assert _rel_err(a, w) <= BWD_TOL[torch.bfloat16]


def test_flash_attention_bwd_sm90_through_autograd(cuda, monkeypatch):
    """loss.backward() through flash_attention in bf16 at D = 64 reaches
    the wgmma forward kernel and the wgmma backward kernels, once each."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    counters = (*_k3_bwd_counters(fa), fa.flash_attention,
                fa.flash_attention_fwd_sm90)
    for fn in counters:
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, do, kw = _k3_bwd_case(SM90_K3_BWD_CASES[2], cuda, seed=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, **kw).backward(do)
    for fn in counters:
        assert fn.launches == 1
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for t, w in zip(leaves, want):
        assert _rel_err(t.grad, w) <= BWD_TOL[torch.bfloat16]


# (B, L, H, causal, segment runs per batch row) of the bf16 K3 forward
# kernel at D = 64, as SM90_K3_BWD_CASES: the ViT at a 480x640 image and
# at the training grid bucket (4144 of 4224 tokens), square causal
# without ids, causal with ids, three segments off the 64-grid, a tail,
# pads per batch row, and L shorter than one 64-key tile
SM90_K3_FWD_CASES = [
    (1, 1280, 16, False, [((1200, 1),)]),
    (1, 4224, 16, False, [((4144, 1),)]),
    (1, 1280, 16, True, None),
    (1, 384, 4, True, [((150, 1), (300, 2))]),
    (1, 512, 4, False, [((100, 1), (300, 2), (480, 3))]),
    (1, 200, 4, False, [((180, 1),)]),
    (2, 384, 4, False, [((300, 1),), ((350, 1),)]),
    (1, 40, 2, True, [((30, 1),)]),
]


@pytest.mark.parametrize("case", SM90_K3_FWD_CASES)
def test_flash_attention_fwd_sm90_kernel_matches_plain(cuda, monkeypatch,
                                                       case):
    """bf16 K3 at D = 64 goes to the wgmma + TMA kernel (its own launch
    count) and agrees with the plain version: O within TOL, lse within
    1e-3."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in (fa.flash_attention, fa.flash_attention_fwd_sm90):
        monkeypatch.setattr(fn, "launches", 0)
    b, l, h, causal, runs = case
    q, k, v = _attn_inputs((b, l, h, 64), (b, l, h, 64), torch.bfloat16,
                           cuda, seed=l + h)
    seg = _k3_seg(b, l, runs, cuda)
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
              sm_scale=0.125, return_lse=True)
    got, lse = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want, wlse = fa.flash_attention_plain(q, k, v, **kw)
    assert fa.flash_attention.launches == 1
    assert fa.flash_attention_fwd_sm90.launches == 1
    assert got.dtype == torch.bfloat16
    assert _close(got, want, torch.bfloat16)
    assert (lse - wlse).abs().max() <= 1e-3


def test_flash_attention_fwd_sm90_rejects_bad_input(cuda, monkeypatch):
    """The wgmma wrapper raises for f32, for D = 128 and for a misaligned
    q, k or v (TMA), and launches nothing; nothing falls back."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in (fa.flash_attention, fa.flash_attention_fwd_sm90):
        monkeypatch.setattr(fn, "launches", 0)
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 128)):
        q, k, v = _attn_inputs((1, 128, 2, d), (1, 128, 2, d), dtype, cuda,
                               seed=d)
        with pytest.raises(ValueError, match="head dim 64"):
            fa.flash_attention_fwd_sm90(q, k, v)
    q, k, v = _attn_inputs((1, 128, 2, 64), (1, 128, 2, 64), torch.bfloat16,
                           cuda, seed=1)
    buf = torch.zeros(q.numel() + 8, device=cuda, dtype=torch.bfloat16)
    shifted = buf[1:1 + q.numel()].view(q.shape)         # 2-byte offset
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    for args in ((shifted, k, v), (q, shifted, v), (q, k, shifted)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention_fwd_sm90(*args)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention(*args)
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention_fwd_sm90.launches == 0


def test_flash_attention_bwd_sm90_rejects_bad_input(cuda, monkeypatch):
    """The wgmma wrappers raise for f32, for D = 128 and for misaligned
    input (TMA); nothing falls back."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in _k3_bwd_counters(fa):
        monkeypatch.setattr(fn, "launches", 0)
    wrappers = (fa.flash_attention_bwd_dq_sm90,
                fa.flash_attention_bwd_dkv_sm90)
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 128)):
        q, k, v = _attn_inputs((1, 128, 2, d), (1, 128, 2, d), dtype, cuda,
                               seed=d)
        rows = torch.zeros((1, 2, 128), device=cuda)
        for fn in wrappers:
            with pytest.raises(ValueError, match="head dim 64"):
                fn(q, k, v, q, rows, rows)
    q, k, v = _attn_inputs((1, 128, 2, 64), (1, 128, 2, 64), torch.bfloat16,
                           cuda, seed=1)
    rows = torch.zeros((1, 2, 128), device=cuda)
    buf = torch.zeros(q.numel() + 8, device=cuda, dtype=torch.bfloat16)
    shifted = buf[1:1 + q.numel()].view(q.shape)         # 2-byte offset
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    for fn in (*wrappers, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(q, k, v, shifted, rows, rows)
    for fn in _k3_bwd_counters(fa):
        assert fn.launches == 0


# (B, S, Lk, H, KVH, D, causal, invalid key ranges): the bf16 backward
# kernels' cases. S = 336 has bq = 16, so F moves every 32 folded rows,
# inside the dk/dv kernel's 64-row tiles
SM90_BWD_CASES = [
    (2, 128, 384, 4, 2, 128, True, ()),                    # rectangular
    (1, 256, 256, 8, 8, 128, False, ((120, 128),)),        # non-causal
    (2, 128, 640, 8, 2, 128, True, ((312, 320), (635, 640))),  # G = 4
    (1, 128, 256, 4, 2, 128, True, ((0, 132),)),           # rows all masked
    (2, 96, 384, 4, 2, 128, True, ((200, 216),)),          # S*G = 192
    (1, 336, 384, 4, 2, 128, True, ((100, 110),)),         # straddling F
    (1, 512, 512, 16, 8, 128, True, ((300, 512),)),        # training-like
]


def _shifted(t):
    """A contiguous copy of t's shape on its device, 4 bytes past a 16-byte
    boundary (what cp.async and TMA refuse)."""
    buf = torch.zeros(t.numel() + 8, device=t.device, dtype=t.dtype)
    x = buf[1:1 + t.numel()].view(t.shape)               # 4-byte offset
    assert x.is_contiguous() and x.data_ptr() % 16
    return x


def _bwd_case(case, dtype, dev, seed):
    b, s, lk, h, kvh, d, causal, holes = case
    q, k, v = _attn_inputs((b, s, h, d), (b, lk, kvh, d), dtype, dev, seed)
    do = _attn_inputs((b, s, h, d), (b, lk, kvh, d), dtype, dev,
                      seed + 1)[0]
    valid = torch.ones((b, lk), dtype=torch.int32)
    for lo, hi in holes:
        valid[:, lo:hi] = 0
    return q, k, v, do, valid.to(dev)


@pytest.mark.parametrize("case", SM90_BWD_CASES)
def test_gqa_flash_bwd_sm90_kernels_match_plain(cuda, monkeypatch, case):
    """bf16 K2-bwd goes to the wgmma + TMA kernels (their own launch
    counts), agrees with the plain backward and repeats bit for bit."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in (fg.gqa_flash_bwd_dq, fg.gqa_flash_bwd_dkdv,
               fg.gqa_flash_bwd_dq_sm90, fg.gqa_flash_bwd_dkdv_sm90):
        monkeypatch.setattr(fn, "launches", 0)
    causal = case[6]
    q, k, v, do, valid = _bwd_case(case, torch.bfloat16, cuda,
                                   seed=sum(case[:3]))
    scale = case[5] ** -0.5
    o, lse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                          kv_valid=valid, sm_scale=scale,
                                          return_lse=True)
    got = [fg.gqa_flash_attention_bwd(q, k, v, valid, o, lse, do,
                                      causal=causal, sm_scale=scale)
           for _ in range(2)]
    torch.cuda.synchronize()
    want = fg.gqa_flash_attention_bwd_plain(q, k, v, valid, o, lse, do,
                                            causal, scale)
    assert fg.gqa_flash_bwd_dq_sm90.launches == 2
    assert fg.gqa_flash_bwd_dkdv_sm90.launches == 2
    assert fg.gqa_flash_bwd_dq.launches == 2
    assert fg.gqa_flash_bwd_dkdv.launches == 2
    for a, a2, w in zip(got[0], got[1], want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, a2)                          # deterministic
        assert _rel_err(a, w) <= BWD_TOL[torch.bfloat16]


def test_gqa_flash_bwd_sm90_through_autograd(cuda, monkeypatch):
    """loss.backward() through gqa_flash_attention in bf16 reaches the
    wgmma backward kernels, once each."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in (fg.gqa_flash_bwd_dq_sm90, fg.gqa_flash_bwd_dkdv_sm90,
               fg.gqa_flash_fwd_sm90):
        monkeypatch.setattr(fn, "launches", 0)
    case = (1, 256, 384, 8, 4, 128, True, ((300, 384),))
    q, k, v, do, valid = _bwd_case(case, torch.bfloat16, cuda, seed=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fg.gqa_flash_attention(*leaves, causal=True, kv_valid=valid)
    o.backward(do)
    assert fg.gqa_flash_fwd_sm90.launches == 1
    assert fg.gqa_flash_bwd_dq_sm90.launches == 1
    assert fg.gqa_flash_bwd_dkdv_sm90.launches == 1
    po, plse = fg.gqa_flash_attention_plain(q, k, v, causal=True,
                                            kv_valid=valid, return_lse=True)
    want = fg.gqa_flash_attention_bwd_plain(q, k, v, valid, po, plse, do,
                                            True, 128 ** -0.5)
    for t, w in zip(leaves, want):
        assert _rel_err(t.grad, w) <= BWD_TOL[torch.bfloat16]


def test_gqa_flash_bwd_sm90_rejects_bad_input(cuda, monkeypatch):
    """Misaligned bf16 input raises (TMA); nothing falls back. G not
    dividing 64 takes the SIMT kernels by route, and the wgmma kernel
    itself refuses it."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    q, k, v, do, valid = _bwd_case((1, 128, 128, 4, 2, 128, True, ()),
                                   torch.bfloat16, cuda, seed=1)
    lse = torch.zeros((1, 2, 256), device=cuda)
    buf = torch.zeros(do.numel() + 8, device=cuda, dtype=torch.bfloat16)
    shifted = buf[1:1 + do.numel()].view(do.shape)       # 2-byte offset
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    kw = dict(causal=True, sm_scale=0.1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fg.gqa_flash_bwd_dq(q, k, v, valid, shifted, lse, lse, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fg.gqa_flash_bwd_dkdv(q, k, v, valid, shifted, lse, lse, **kw)
    monkeypatch.setattr(fg.gqa_flash_bwd_dq_sm90, "launches", 0)
    x, k3, v3, d3, valid3 = _bwd_case((1, 128, 128, 6, 2, 128, True, ()),
                                      torch.bfloat16, cuda, seed=2)
    lse3 = torch.zeros((1, 2, 384), device=cuda)
    assert fg.bwd_route(x.dtype, 128, 3) == "simt"
    fg.gqa_flash_bwd_dq(x, k3, v3, valid3, d3, lse3, lse3, **kw)
    assert fg.gqa_flash_bwd_dq_sm90.launches == 0
    dq = torch.empty_like(x)
    with pytest.raises(RuntimeError, match="launch failed"):
        fg.gqa_flash_bwd_dq_sm90(x, k3, v3, valid3, d3, lse3, lse3, dq, **kw)


# (B, S, Lk, H, KVH, D, causal, invalid key ranges): the f32 dk/dv
# kernel's cases, chip_smoke.py's K2_TRAIN, the f32 D = 128 cases of its
# K2_GRID and K2_BWD_MORE, a last row tile past S * G (S = 40) and
# G = 3 (not a power of two)
F32_DKDV_CASES = [
    (1, 2048, 2048, 16, 8, 128, True, ((1253, 2048),)),    # K2_TRAIN
    (2, 128, 384, 4, 2, 128, True, ()),
    (1, 128, 128, 4, 1, 128, True, ()),
    (2, 128, 640, 8, 2, 128, True, ((312, 320), (635, 640))),
    (1, 256, 256, 8, 8, 128, False, ((120, 128), (251, 256))),
    (1, 128, 512, 16, 8, 128, True, ((248, 256), (507, 512))),
    (1, 128, 256, 4, 2, 128, True, ((0, 132),)),           # rows all masked
    (2, 96, 384, 4, 2, 128, True, ((200, 216),)),          # S*G = 192
    (1, 336, 384, 4, 2, 128, True, ((100, 110),)),         # straddling F
    (1, 40, 128, 2, 2, 128, True, ((20, 30),)),            # partial tile
    (1, 128, 256, 6, 2, 128, True, ((30, 40),)),           # G = 3
]


def _f32_bwd_counters(fg):
    return (fg.gqa_flash_bwd_dq, fg.gqa_flash_bwd_dkdv,
            fg.gqa_flash_bwd_dkdv_f32, fg.gqa_flash_bwd_dkdv_sm90,
            fg.gqa_flash_bwd_dq_f32, fg.gqa_flash_bwd_dq_sm90)


@pytest.mark.parametrize("case", F32_DKDV_CASES)
def test_gqa_flash_bwd_dkdv_f32_kernel_matches_plain(cuda, monkeypatch,
                                                     case):
    """f32 K2-bwd-dkdv at D = 128 goes to the FFMA kernel (one launch a
    call, its own count), agrees with the plain backward (TOL's f32 atol
    and BWD_TOL) and repeats bit for bit."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in _f32_bwd_counters(fg):
        monkeypatch.setattr(fn, "launches", 0)
    causal = case[6]
    q, k, v, do, valid = _bwd_case(case, torch.float32, cuda,
                                   seed=sum(case[:3]))
    scale = case[5] ** -0.5
    o, lse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                          kv_valid=valid, sm_scale=scale,
                                          return_lse=True)
    delta = fg.row_delta(o, do, k.shape[2])
    kw = dict(causal=causal, sm_scale=scale)
    got = [fg.gqa_flash_bwd_dkdv(q, k, v, valid, do, lse, delta, **kw)
           for _ in range(2)]
    torch.cuda.synchronize()
    _, dk, dv = fg.gqa_flash_attention_bwd_plain(q, k, v, valid, o, lse,
                                                 do, causal, scale)
    assert fg.gqa_flash_bwd_dkdv_f32.launches == 2
    assert fg.gqa_flash_bwd_dkdv.launches == 2
    assert fg.gqa_flash_bwd_dkdv_sm90.launches == 0
    for a, a2, w in zip(got[0], got[1], (dk, dv)):
        assert a.dtype == torch.float32
        assert torch.equal(a, a2)                          # deterministic
        assert _rel_err(a, w) <= BWD_TOL[torch.float32]
        assert _close(a, w, torch.float32)


@pytest.mark.parametrize("d", [64, 256])
def test_gqa_flash_bwd_dkdv_f32_only_at_d128(cuda, monkeypatch, d):
    """f32 at D = 64 or 256 keeps the SIMT dk/dv kernel: no launch of the
    f32 kernel."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in _f32_bwd_counters(fg):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, do, valid = _bwd_case((1, 128, 256, 4, 2, d, True, ()),
                                   torch.float32, cuda, seed=d)
    lse = torch.zeros((1, 2, 256), device=cuda)
    assert fg.dkdv_route(torch.float32, d, 2) == "simt"
    fg.gqa_flash_bwd_dkdv(q, k, v, valid, do, lse, lse, causal=True,
                          sm_scale=0.1)
    torch.cuda.synchronize()
    assert fg.gqa_flash_bwd_dkdv.launches == 1
    assert fg.gqa_flash_bwd_dkdv_f32.launches == 0


def test_gqa_flash_bwd_dkdv_f32_rejects_bad_input(cuda, monkeypatch):
    """An unaligned q, dO, dk or dv, a wrong type or a wrong head dim
    raises before any launch; nothing falls back."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    monkeypatch.setattr(fg.gqa_flash_bwd_dkdv_f32, "launches", 0)
    q, k, v, do, valid = _bwd_case((1, 128, 128, 4, 2, 128, True, ()),
                                   torch.float32, cuda, seed=1)
    lse = torch.zeros((1, 2, 256), device=cuda)
    kw = dict(causal=True, sm_scale=0.1)

    with pytest.raises(ValueError, match="16-byte aligned"):
        fg.gqa_flash_bwd_dkdv(q, k, v, valid, _shifted(do), lse, lse, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fg.gqa_flash_bwd_dkdv(_shifted(q), k, v, valid, do, lse, lse, **kw)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fg.gqa_flash_bwd_dkdv_f32(q, k, v, valid, do, lse, lse, dk,
                                  _shifted(v), **kw)
    with pytest.raises(TypeError, match="float32"):
        fg.gqa_flash_bwd_dkdv_f32(*(t.bfloat16() for t in (q, k, v)),
                                  valid, do.bfloat16(), lse, lse,
                                  dk.bfloat16(), dv.bfloat16(), **kw)
    q2, k2, v2, do2, valid2 = _bwd_case((1, 128, 128, 4, 2, 256, True, ()),
                                        torch.float32, cuda, seed=2)
    with pytest.raises(ValueError, match="head dim 128"):
        fg.gqa_flash_bwd_dkdv_f32(q2, k2, v2, valid2, do2, lse, lse,
                                  torch.empty_like(k2), torch.empty_like(v2),
                                  **kw)
    assert fg.gqa_flash_bwd_dkdv_f32.launches == 0


def test_gqa_flash_bwd_dkdv_f32_through_autograd(cuda, monkeypatch):
    """loss.backward() through gqa_flash_attention in f32 reaches the f32
    dk/dv kernel once (and dq's f32 kernel once)."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in _f32_bwd_counters(fg):
        monkeypatch.setattr(fn, "launches", 0)
    case = (1, 256, 384, 8, 4, 128, True, ((300, 384),))
    q, k, v, do, valid = _bwd_case(case, torch.float32, cuda, seed=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fg.gqa_flash_attention(*leaves, causal=True, kv_valid=valid)
    o.backward(do)
    assert fg.gqa_flash_bwd_dkdv_f32.launches == 1
    assert fg.gqa_flash_bwd_dkdv.launches == 1
    assert fg.gqa_flash_bwd_dq.launches == 1
    po, plse = fg.gqa_flash_attention_plain(q, k, v, causal=True,
                                            kv_valid=valid, return_lse=True)
    want = fg.gqa_flash_attention_bwd_plain(q, k, v, valid, po, plse, do,
                                            True, 128 ** -0.5)
    for t, w in zip(leaves, want):
        assert _rel_err(t.grad, w) <= BWD_TOL[torch.float32]


@pytest.mark.parametrize("case", F32_DKDV_CASES)
def test_gqa_flash_bwd_dq_f32_kernel_matches_plain(cuda, monkeypatch,
                                                   case):
    """f32 K2-bwd-dq at D = 128 goes to the FFMA kernel (one launch a
    call, its own count), agrees with the plain dq (TOL's f32 atol and
    BWD_TOL) and repeats bit for bit."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in _f32_bwd_counters(fg):
        monkeypatch.setattr(fn, "launches", 0)
    causal = case[6]
    q, k, v, do, valid = _bwd_case(case, torch.float32, cuda,
                                   seed=sum(case[:3]) + 7)
    scale = case[5] ** -0.5
    o, lse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                          kv_valid=valid, sm_scale=scale,
                                          return_lse=True)
    delta = fg.row_delta(o, do, k.shape[2])
    kw = dict(causal=causal, sm_scale=scale)
    got = [fg.gqa_flash_bwd_dq(q, k, v, valid, do, lse, delta, **kw)
           for _ in range(2)]
    torch.cuda.synchronize()
    dq, _, _ = fg.gqa_flash_attention_bwd_plain(q, k, v, valid, o, lse, do,
                                                causal, scale)
    assert fg.gqa_flash_bwd_dq_f32.launches == 2
    assert fg.gqa_flash_bwd_dq.launches == 2
    assert fg.gqa_flash_bwd_dq_sm90.launches == 0
    assert got[0].dtype == torch.float32
    assert torch.equal(got[0], got[1])                     # deterministic
    assert _rel_err(got[0], dq) <= BWD_TOL[torch.float32]
    assert _close(got[0], dq, torch.float32)


@pytest.mark.parametrize("case", F32_DKDV_CASES)
def test_gqa_flash_bwd_dq_f32_walk_matches_rule(cuda, case):
    """The key tiles each row block of the f32 dq kernel walked, read back
    from the kernel, are the skip rule's (ops/flash_gqa.dq_walk_map); the
    dq of that launch is the route's, bit for bit."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    b, s, lk, h, kvh, d, causal, holes = case
    q, k, v, do, valid = _bwd_case(case, torch.float32, cuda,
                                   seed=sum(case[:3]) + 8)
    scale = d ** -0.5
    o, lse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                          kv_valid=valid, sm_scale=scale,
                                          return_lse=True)
    delta = fg.row_delta(o, do, kvh)
    kw = dict(causal=causal, sm_scale=scale)
    rule = fg.dq_walk_map(s, lk, h // kvh, causal, valid, lse)
    walked = torch.full(rule.shape[:3], -1, dtype=torch.int32, device=cuda)
    dq = torch.empty_like(q)
    fg.gqa_flash_bwd_dq_f32(q, k, v, valid, do, lse, delta, dq,
                            walked=walked, **kw)
    torch.cuda.synchronize()
    assert torch.equal(walked, rule.sum(-1).int())
    assert torch.equal(dq, fg.gqa_flash_bwd_dq(q, k, v, valid, do, lse,
                                               delta, **kw))


@pytest.mark.parametrize("case", F32_DKDV_CASES)
def test_gqa_flash_bwd_dkdv_f32_walk_matches_rule(cuda, case):
    """The row tiles each key block of the f32 dk/dv kernel walked, read
    back from the kernel, are the skip rule's (ops/flash_gqa.
    dkdv_walk_map); the dk and dv of that launch are the route's, bit for
    bit."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    b, s, lk, h, kvh, d, causal, holes = case
    q, k, v, do, valid = _bwd_case(case, torch.float32, cuda,
                                   seed=sum(case[:3]) + 9)
    scale = d ** -0.5
    o, lse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                          kv_valid=valid, sm_scale=scale,
                                          return_lse=True)
    delta = fg.row_delta(o, do, kvh)
    kw = dict(causal=causal, sm_scale=scale)
    rule = fg.dkdv_walk_map(s, lk, h // kvh, causal, valid, lse)
    walked = torch.full(rule.shape[:3], -1, dtype=torch.int32, device=cuda)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fg.gqa_flash_bwd_dkdv_f32(q, k, v, valid, do, lse, delta, dk, dv,
                              walked=walked, **kw)
    torch.cuda.synchronize()
    assert torch.equal(walked, rule.sum(-1).int())
    want_dk, want_dv = fg.gqa_flash_bwd_dkdv(q, k, v, valid, do, lse, delta,
                                             **kw)
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
    bad = torch.zeros(rule.shape[:2], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="walked"):
        fg.gqa_flash_bwd_dkdv_f32(q, k, v, valid, do, lse, delta, dk, dv,
                                  walked=bad, **kw)


@pytest.mark.parametrize("d", [64, 256])
def test_gqa_flash_bwd_dq_f32_only_at_d128(cuda, monkeypatch, d):
    """f32 at D = 64 or 256 keeps the SIMT dq kernel: no launch of the f32
    kernel."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in _f32_bwd_counters(fg):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, do, valid = _bwd_case((1, 128, 256, 4, 2, d, True, ()),
                                   torch.float32, cuda, seed=d + 1)
    lse = torch.zeros((1, 2, 256), device=cuda)
    assert fg.dq_route(torch.float32, d, 2) == "simt"
    fg.gqa_flash_bwd_dq(q, k, v, valid, do, lse, lse, causal=True,
                        sm_scale=0.1)
    torch.cuda.synchronize()
    assert fg.gqa_flash_bwd_dq.launches == 1
    assert fg.gqa_flash_bwd_dq_f32.launches == 0


def test_gqa_flash_bwd_dq_f32_rejects_bad_input(cuda, monkeypatch):
    """An unaligned q, k, v, dO or dq, a wrong type, a wrong head dim or a
    wrong `walked` raises before any launch; nothing falls back."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    monkeypatch.setattr(fg.gqa_flash_bwd_dq_f32, "launches", 0)
    q, k, v, do, valid = _bwd_case((1, 128, 128, 4, 2, 128, True, ()),
                                   torch.float32, cuda, seed=1)
    lse = torch.zeros((1, 2, 256), device=cuda)
    kw = dict(causal=True, sm_scale=0.1)

    with pytest.raises(ValueError, match="16-byte aligned"):
        fg.gqa_flash_bwd_dq(q, k, v, valid, _shifted(do), lse, lse, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fg.gqa_flash_bwd_dq(q, _shifted(k), v, valid, do, lse, lse, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fg.gqa_flash_bwd_dq_f32(q, k, v, valid, do, lse, lse, _shifted(q),
                                **kw)
    with pytest.raises(TypeError, match="float32"):
        fg.gqa_flash_bwd_dq_f32(*(t.bfloat16() for t in (q, k, v)), valid,
                                do.bfloat16(), lse, lse,
                                torch.empty_like(q).bfloat16(), **kw)
    q2, k2, v2, do2, valid2 = _bwd_case((1, 128, 128, 4, 2, 256, True, ()),
                                        torch.float32, cuda, seed=2)
    with pytest.raises(ValueError, match="head dim 128"):
        fg.gqa_flash_bwd_dq_f32(q2, k2, v2, valid2, do2, lse, lse,
                                torch.empty_like(q2), **kw)
    for bad in (torch.zeros((1, 2, 7), dtype=torch.int32, device=cuda),
                torch.zeros((1, 2, 8), dtype=torch.int64, device=cuda)):
        with pytest.raises(ValueError, match="walked"):
            fg.gqa_flash_bwd_dq_f32(q, k, v, valid, do, lse, lse,
                                    torch.empty_like(q), walked=bad, **kw)
    assert fg.gqa_flash_bwd_dq_f32.launches == 0


def test_gqa_flash_bwd_dq_f32_through_autograd(cuda, monkeypatch):
    """loss.backward() through gqa_flash_attention in f32 reaches the f32
    dq kernel once, and no other dq kernel; the gradients agree with the
    plain backward."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in _f32_bwd_counters(fg):
        monkeypatch.setattr(fn, "launches", 0)
    case = (1, 336, 384, 4, 2, 128, True, ((100, 110),))
    q, k, v, do, valid = _bwd_case(case, torch.float32, cuda, seed=4)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fg.gqa_flash_attention(*leaves, causal=True, kv_valid=valid)
    o.backward(do)
    assert fg.gqa_flash_bwd_dq_f32.launches == 1
    assert fg.gqa_flash_bwd_dq.launches == 1
    assert fg.gqa_flash_bwd_dq_sm90.launches == 0
    po, plse = fg.gqa_flash_attention_plain(q, k, v, causal=True,
                                            kv_valid=valid, return_lse=True)
    want = fg.gqa_flash_attention_bwd_plain(q, k, v, valid, po, plse, do,
                                            True, 128 ** -0.5)
    for t, w in zip(leaves, want):
        assert _rel_err(t.grad, w) <= BWD_TOL[torch.float32]


# (B, S, Lk, H, KVH, D, causal, invalid key ranges): the f32 forward
# kernel's cases: chip_smoke.py's K2_PREFIX, K2_SUFFIX, K2_TRAIN and
# K2_GRID, S = 336 (F moves every 32 folded rows), a last row block past
# S * G (S = 40), G = 3 (not a power of two) and a non-causal batch
# without a valid key
F32_FWD_CASES = [
    (1, 384, 384, 16, 8, 128, True, ((332, 384),)),             # prefix
    (8, 256, 640, 16, 8, 128, True, ((332, 384), (600, 640))),  # suffix
    (1, 2048, 2048, 16, 8, 128, True, ((1253, 2048),)),         # K2_TRAIN
    (2, 128, 384, 4, 2, 128, True, ()),
    (1, 128, 128, 4, 1, 128, True, ()),
    (2, 128, 640, 8, 2, 128, True, ((312, 320), (635, 640))),
    (1, 256, 256, 8, 8, 128, False, ((120, 128), (251, 256))),
    (1, 128, 512, 16, 8, 128, True, ((248, 256), (507, 512))),
    (1, 128, 256, 4, 2, 128, True, ((0, 132),)),           # rows all masked
    (2, 96, 384, 4, 2, 128, True, ((200, 216),)),          # S*G = 192
    (1, 336, 384, 4, 2, 128, True, ((100, 110),)),
    (1, 40, 128, 2, 2, 128, True, ((20, 30),)),
    (1, 128, 256, 6, 2, 128, True, ((30, 40),)),           # G = 3
    (1, 128, 256, 2, 1, 128, False, ((0, 256),)),
]


def _fwd_counters(fg):
    return (fg.gqa_flash_attention, fg.gqa_flash_fwd_f32,
            fg.gqa_flash_fwd_sm90)


@pytest.mark.parametrize("case", F32_FWD_CASES)
def test_gqa_flash_fwd_f32_kernel_matches_plain(cuda, monkeypatch, case):
    """f32 K2 at D = 128 goes to the FFMA kernel (one launch a call, its
    own count), agrees with the plain forward (TOL's f32 atol for O, 1e-3
    for lse), keeps lse <= -1e29 exactly on the rows without a visible
    valid key, and repeats bit for bit."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in _fwd_counters(fg):
        monkeypatch.setattr(fn, "launches", 0)
    causal = case[6]
    q, k, v, _, valid = _bwd_case(case, torch.float32, cuda,
                                  seed=sum(case[:3]) + 9)
    got = [fg.gqa_flash_attention(q, k, v, causal=causal, kv_valid=valid,
                                  return_lse=True) for _ in range(2)]
    torch.cuda.synchronize()
    want, wlse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                              kv_valid=valid,
                                              return_lse=True)
    assert fg.gqa_flash_fwd_f32.launches == 2
    assert fg.gqa_flash_attention.launches == 2
    assert fg.gqa_flash_fwd_sm90.launches == 0
    (o, lse), (o2, lse2) = got
    assert o.dtype == torch.float32
    assert torch.equal(o, o2) and torch.equal(lse, lse2)   # deterministic
    assert _close(o, want, torch.float32)
    assert torch.allclose(lse, wlse, atol=1e-3, rtol=1e-5)
    assert torch.equal(lse <= -1e29, wlse <= -1e29)


@pytest.mark.parametrize("rows", [64, 32], ids=["wide", "narrow"])
@pytest.mark.parametrize("case", F32_FWD_CASES)
def test_gqa_flash_fwd_f32_walk_matches_rule(cuda, case, rows):
    """Each of the f32 forward's tiles, forced: agrees with the plain
    forward, and the key tiles each row block walked, read back from the
    kernel, are the skip rule's in that tile (ops/flash_gqa.fwd_walk_map).
    In the tile the route takes (`fwd_f32_tile`), O and lse are the
    route's, bit for bit."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    b, s, lk, h, kvh, d, causal, holes = case
    q, k, v, _, valid = _bwd_case(case, torch.float32, cuda,
                                  seed=sum(case[:3]) + 10)
    scale = d ** -0.5
    rule = fg.fwd_walk_map(s, lk, h // kvh, kvh, causal, valid, rows=rows)
    walked = torch.full(rule.shape[:3], -1, dtype=torch.int32, device=cuda)
    o, lse = fg.gqa_flash_fwd_f32(q, k, v, valid, causal, scale,
                                  walked=walked, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(walked, rule.sum(-1).int())
    want, wlse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                              kv_valid=valid, sm_scale=scale,
                                              return_lse=True)
    assert _close(o, want, torch.float32)
    assert torch.allclose(lse, wlse, atol=1e-3, rtol=1e-5)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if fg.fwd_f32_tile(b, s, h // kvh, kvh, sms)[0] == rows:
        ro, rlse = fg.gqa_flash_attention(q, k, v, causal=causal,
                                          kv_valid=valid, sm_scale=scale,
                                          return_lse=True)
        assert torch.equal(o, ro) and torch.equal(lse, rlse)


def test_gqa_flash_fwd_f32_tiles_match_the_wrapper(cuda):
    """The kernel's tiles (its C entry) are the ones the wrapper and the
    skip rule's map assume; another row count is refused."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    lib = fg._fwd_f32_lib()
    for rows, keys in fg.FWD_F32_TILES.items():
        assert lib.gqa_flash_fwd_f32_keys(rows) == keys
    assert lib.gqa_flash_fwd_f32_keys(48) == 0
    q, k, v, _, valid = _bwd_case((1, 128, 128, 4, 2, 128, True, ()),
                                  torch.float32, cuda, seed=3)
    with pytest.raises(RuntimeError, match="launch failed"):
        fg.gqa_flash_fwd_f32(q, k, v, valid, True, 0.1, rows=48)


@pytest.mark.parametrize("d", [256, 384])
def test_gqa_flash_fwd_f32_only_at_d128(cuda, monkeypatch, d):
    """f32 at D = 256 or 384 keeps the SIMT forward: no launch of the
    f32 kernel, and the plain version's answer."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in _fwd_counters(fg):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, _, valid = _bwd_case((1, 128, 256, 4, 2, d, True, ((10, 20),)),
                                  torch.float32, cuda, seed=d + 2)
    assert fg.fwd_route(torch.float32, d, 2) == "simt"
    got = fg.gqa_flash_attention(q, k, v, kv_valid=valid)
    torch.cuda.synchronize()
    assert fg.gqa_flash_attention.launches == 1
    assert fg.gqa_flash_fwd_f32.launches == 0
    assert _close(got, fg.gqa_flash_attention_plain(q, k, v, kv_valid=valid),
                  torch.float32)


def test_gqa_flash_fwd_f32_rejects_bad_input(cuda, monkeypatch):
    """An unaligned q, k or v, a wrong type, a wrong head dim or a wrong
    `walked` raises before any launch; nothing falls back."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in _fwd_counters(fg):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, _, valid = _bwd_case((1, 128, 128, 4, 2, 128, True, ()),
                                  torch.float32, cuda, seed=1)

    for args in ((_shifted(q), k, v), (q, _shifted(k), v), (q, k, _shifted(v))):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fg.gqa_flash_attention(*args, kv_valid=valid)
    with pytest.raises(TypeError, match="float32"):
        fg.gqa_flash_fwd_f32(q.bfloat16(), k.bfloat16(), v.bfloat16(), valid,
                             True, 0.1)
    q2, k2, v2, _, valid2 = _bwd_case((1, 128, 128, 4, 2, 256, True, ()),
                                      torch.float32, cuda, seed=2)
    with pytest.raises(ValueError, match="head dim 128"):
        fg.gqa_flash_fwd_f32(q2, k2, v2, valid2, True, 0.1)
    for bad in (torch.zeros((1, 2, 7), dtype=torch.int32, device=cuda),
                torch.zeros((1, 2, 4), dtype=torch.int64, device=cuda)):
        with pytest.raises(ValueError, match="walked"):
            fg.gqa_flash_fwd_f32(q, k, v, valid, True, 0.1, walked=bad)
    assert fg.gqa_flash_fwd_f32.launches == 0
    assert fg.gqa_flash_attention.launches == 0


def test_gqa_flash_fwd_f32_through_autograd(cuda, monkeypatch):
    """loss.backward() through gqa_flash_attention in f32 runs the f32
    forward once and the f32 dq and dk/dv kernels on its lse; the
    gradients agree with the plain backward (BWD_TOL)."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in (*_fwd_counters(fg), *_f32_bwd_counters(fg)):
        monkeypatch.setattr(fn, "launches", 0)
    case = (1, 256, 384, 8, 4, 128, True, ((0, 140), (300, 384)))
    q, k, v, do, valid = _bwd_case(case, torch.float32, cuda, seed=5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fg.gqa_flash_attention(*leaves, causal=True, kv_valid=valid)
    o.backward(do)
    torch.cuda.synchronize()
    assert fg.gqa_flash_fwd_f32.launches == 1
    assert fg.gqa_flash_bwd_dq_f32.launches == 1
    assert fg.gqa_flash_bwd_dkdv_f32.launches == 1
    po, plse = fg.gqa_flash_attention_plain(q, k, v, causal=True,
                                            kv_valid=valid, return_lse=True)
    want = fg.gqa_flash_attention_bwd_plain(q, k, v, valid, po, plse, do,
                                            True, 128 ** -0.5)
    assert _close(o.detach(), po, torch.float32)
    for t, w in zip(leaves, want):
        assert _rel_err(t.grad, w) <= BWD_TOL[torch.float32]


# (B, L, H, causal, segment runs per batch row) of the f32 K3 dk/dv
# kernel at D = 64, as SM90_K3_BWD_CASES: the training shape (4144 of
# 4224 tokens), three segments off the 64-grid, causal with and without
# ids, the tail (L = 200) and pads per batch row
F32_DKV_CASES = [
    (1, 4224, 16, False, [((4144, 1),)]),
    (1, 512, 4, False, [((100, 1), (300, 2), (480, 3))]),
    (1, 384, 4, True, [((150, 1), (300, 2))]),
    (1, 320, 2, True, None),
    (1, 200, 4, False, [((180, 1),)]),
    (2, 384, 4, False, [((300, 1),), ((350, 1),)]),
]


def _f32_dkv_case(case, dev, seed):
    b, l, h, causal, runs = case
    q, k, v = _attn_inputs((b, l, h, 64), (b, l, h, 64), torch.float32,
                           dev, seed)
    do = _attn_inputs((b, l, h, 64), (b, l, h, 64), torch.float32, dev,
                      seed + 1)[0]
    seg = _k3_seg(b, l, runs, dev)
    if seg is not None:
        do[seg == 0] = 0                 # the ViT drops its pad rows
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
              sm_scale=0.125)
    return q, k, v, do, kw


def _f32_dkv_counters(fa):
    return (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
            fa.flash_attention_bwd_dkv_f32, fa.flash_attention_bwd_dkv_sm90)


@pytest.mark.parametrize("case", F32_DKV_CASES)
def test_flash_attention_bwd_dkv_f32_kernel_matches_plain(cuda, monkeypatch,
                                                          case):
    """f32 K3-bwd-dkv at D = 64 goes to the FFMA kernel (one launch a
    call, its own count), agrees with the plain backward (TOL's f32 atol
    and BWD_TOL) and repeats bit for bit."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in _f32_dkv_counters(fa):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, do, kw = _f32_dkv_case(case, cuda, seed=case[1] + 5)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fa.row_delta(o, do)
    got = [fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
           for _ in range(2)]
    torch.cuda.synchronize()
    _, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert fa.flash_attention_bwd_dkv_f32.launches == 2
    assert fa.flash_attention_bwd_dkv.launches == 2
    assert fa.flash_attention_bwd_dkv_sm90.launches == 0
    for a, a2, w in zip(got[0], got[1], (dk, dv)):
        assert a.dtype == torch.float32
        assert torch.equal(a, a2)                          # deterministic
        assert _rel_err(a, w) <= BWD_TOL[torch.float32]
        assert _close(a, w, torch.float32)


def test_flash_attention_bwd_dkv_f32_unseen_segment(cuda):
    """Rows whose segment no key has (lse ~ -1e30: p = 1 on every key
    below the frontier) keep their tiles, as on the plain version."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    q, k, v = _attn_inputs((1, 256, 2, 64), (1, 256, 2, 64), torch.float32,
                           cuda, seed=9)
    do = _attn_inputs((1, 256, 2, 64), (1, 256, 2, 64), torch.float32, cuda,
                      seed=10)[0]
    ks = torch.ones((1, 256), dtype=torch.int32, device=cuda)
    qs = ks.clone()
    qs[:, 100:164] = 9
    kw = dict(q_segment_ids=qs, kv_segment_ids=ks, causal=False,
              sm_scale=0.125)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert float(lse.min()) <= -1e29
    dk, dv = fa.flash_attention_bwd_dkv_f32(q, k, v, do, lse,
                                            fa.row_delta(o, do), **kw)
    _, pdk, pdv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for a, w in zip((dk, dv), (pdk, pdv)):
        assert _rel_err(a, w) <= BWD_TOL[torch.float32]


def test_flash_attention_bwd_dkv_f32_rejects_bad_input(cuda, monkeypatch):
    """The f32 kernel takes f32 at D = 64 only, contiguous and 16-byte
    aligned; anything else raises before any launch, and nothing falls
    back. f32 at another head dim goes to the SIMT kernel by route."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in _f32_dkv_counters(fa):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, do, kw = _f32_dkv_case((1, 128, 2, False, [((100, 1),)]), cuda,
                                    seed=1)
    rows = torch.zeros((1, 2, 128), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention_bwd_dkv_f32(*(t.bfloat16() for t in (q, k, v, do)),
                                       rows, rows, **kw)
    x = torch.zeros((1, 128, 2, 128), device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        fa.flash_attention_bwd_dkv_f32(x, x, x, x, rows, rows, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd_dkv_f32(q, k, v.transpose(1, 2).contiguous()
                                       .transpose(1, 2), do, rows, rows,
                                       **kw)
    buf = torch.zeros(q.numel() + 8, device=cuda)
    shifted = buf[1:1 + q.numel()].view(q.shape)         # 4-byte offset
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    for args in ((shifted, k, v, do), (q, shifted, v, do),
                 (q, k, shifted, do), (q, k, v, shifted)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention_bwd_dkv_f32(*args, rows, rows, **kw)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention_bwd_dkv(*args, rows, rows, **kw)
    for fn in _f32_dkv_counters(fa):
        assert fn.launches == 0
    x = _attn_inputs((1, 128, 2, 128), (1, 128, 2, 128), torch.float32,
                     cuda, seed=2)[0]
    assert fa.dkv_route(torch.float32, 128) == "simt"
    fa.flash_attention_bwd_dkv(x, x, x, x, rows, rows, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dkv.launches == 1
    assert fa.flash_attention_bwd_dkv_f32.launches == 0


def test_flash_attention_bwd_dkv_f32_through_autograd(cuda, monkeypatch):
    """loss.backward() through flash_attention in f32 at D = 64 reaches
    the f32 dk/dv kernel once (and the dq route once)."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in _f32_dkv_counters(fa):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, do, kw = _f32_dkv_case(F32_DKV_CASES[1], cuda, seed=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, **kw).backward(do)
    assert fa.flash_attention_bwd_dkv_f32.launches == 1
    assert fa.flash_attention_bwd_dkv.launches == 1
    assert fa.flash_attention_bwd_dq.launches == 1
    assert fa.flash_attention_bwd_dkv_sm90.launches == 0
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for t, w in zip(leaves, want):
        assert _rel_err(t.grad, w) <= BWD_TOL[torch.float32]


# the f32 dq kernel's cases: F32_DKV_CASES and the ViT at a 480x640
# image; and rows whose segment no key has (lse ~ -1e30), with and
# without causal: (B, L, H, causal, row runs, key runs)
F32_DQ_CASES = F32_DKV_CASES + [(1, 1280, 16, False, [((1200, 1),)])]
UNSEEN_SEGMENT_CASES = [
    (1, 256, 2, False, [((100, 1), (164, 9), (256, 1))], [((256, 1),)]),
    (1, 256, 2, True, [((100, 1), (164, 9), (256, 1))], [((256, 1),)]),
]


def _f32_unseen_case(case, dev, seed):
    b, l, h, causal, q_runs, kv_runs = case
    q, k, v, do, kw = _f32_dkv_case((b, l, h, causal, q_runs), dev, seed)
    kw["kv_segment_ids"] = _k3_seg(b, l, kv_runs, dev)
    return q, k, v, do, kw


def _f32_dq_counters(fa):
    return (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
            fa.flash_attention_bwd_dq_f32, fa.flash_attention_bwd_dkv_f32,
            fa.flash_attention_bwd_dq_sm90, fa.flash_attention_bwd_dkv_sm90)


@pytest.mark.parametrize("case", F32_DQ_CASES)
def test_flash_attention_bwd_dq_f32_kernel_matches_plain(cuda, monkeypatch,
                                                         case):
    """f32 K3-bwd-dq at D = 64 goes to the FFMA kernel (one launch a
    call, its own count), agrees with the plain dq (TOL's f32 atol and
    BWD_TOL) and repeats bit for bit."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in _f32_dq_counters(fa):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, do, kw = _f32_dkv_case(case, cuda, seed=case[1] + 6)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fa.row_delta(o, do)
    got = [fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
           for _ in range(2)]
    torch.cuda.synchronize()
    dq, _, _ = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert fa.flash_attention_bwd_dq_f32.launches == 2
    assert fa.flash_attention_bwd_dq.launches == 2
    assert fa.flash_attention_bwd_dq_sm90.launches == 0
    assert got[0].dtype == torch.float32 and got[0].shape == q.shape
    assert torch.equal(got[0], got[1])                     # deterministic
    assert _rel_err(got[0], dq) <= BWD_TOL[torch.float32]
    assert _close(got[0], dq, torch.float32)


@pytest.mark.parametrize("case", UNSEEN_SEGMENT_CASES,
                         ids=["unseen_segment", "unseen_segment_causal"])
def test_flash_attention_bwd_dq_f32_unseen_segment(cuda, case):
    """Rows whose segment no key has (lse ~ -1e30: p = 1 on every key
    below the frontier) keep their key tiles, as on the plain version."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    q, k, v, do, kw = _f32_unseen_case(case, cuda, seed=11)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert float(lse.min()) <= -1e29
    dq = fa.flash_attention_bwd_dq_f32(q, k, v, do, lse,
                                       fa.row_delta(o, do), **kw)
    pdq, _, _ = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert _rel_err(dq, pdq) <= BWD_TOL[torch.float32]
    assert _close(dq, pdq, torch.float32)


@pytest.mark.parametrize("case", F32_DQ_CASES + UNSEEN_SEGMENT_CASES)
def test_flash_attention_bwd_dq_f32_walk_matches_rule(cuda, case):
    """The key tiles each row block of the f32 dq kernel walked, read
    back from the kernel, are the skip rule's (dq_walk_map); the dq of
    that launch is the route's, bit for bit."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    make = _f32_unseen_case if len(case) == 6 else _f32_dkv_case
    q, k, v, do, kw = make(case, cuda, seed=case[1] + 7)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fa.row_delta(o, do)
    rule = fa.dq_walk_map(q.shape[1], kw["causal"], kw["q_segment_ids"],
                          kw["kv_segment_ids"], lse)
    walked = torch.full(rule.shape[:3], -1, dtype=torch.int32, device=cuda)
    dq = fa.flash_attention_bwd_dq_f32(q, k, v, do, lse, delta,
                                       walked=walked, **kw)
    torch.cuda.synchronize()
    assert torch.equal(walked, rule.sum(-1).int())
    assert torch.equal(dq, fa.flash_attention_bwd_dq(q, k, v, do, lse,
                                                     delta, **kw))


@pytest.mark.parametrize("case", F32_DKV_CASES + UNSEEN_SEGMENT_CASES)
def test_flash_attention_bwd_dkv_f32_walk_matches_rule(cuda, case):
    """The row tiles each key block of the f32 dk/dv kernel walked, read
    back from the kernel, are the skip rule's (dkv_walk_map); dk and dv
    of that launch are the route's, bit for bit."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    make = _f32_unseen_case if len(case) == 6 else _f32_dkv_case
    q, k, v, do, kw = make(case, cuda, seed=case[1] + 8)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fa.row_delta(o, do)
    rule = fa.dkv_walk_map(q.shape[1], kw["causal"], kw["q_segment_ids"],
                           kw["kv_segment_ids"], lse)
    walked = torch.full(rule.shape[:3], -1, dtype=torch.int32, device=cuda)
    got = fa.flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta,
                                         walked=walked, **kw)
    torch.cuda.synchronize()
    assert torch.equal(walked, rule.sum(-1).int())
    for a, w in zip(got, fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                    **kw)):
        assert torch.equal(a, w)


def test_flash_attention_bwd_dq_f32_rejects_bad_input(cuda, monkeypatch):
    """The f32 dq kernel takes f32 at D = 64 only, contiguous and 16-byte
    aligned, with a `walked` of its shape; anything else raises before
    any launch, and nothing falls back. f32 at another head dim goes to
    the SIMT kernel by route."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in _f32_dq_counters(fa):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, do, kw = _f32_dkv_case((1, 128, 2, False, [((100, 1),)]), cuda,
                                    seed=1)
    rows = torch.zeros((1, 2, 128), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention_bwd_dq_f32(*(t.bfloat16() for t in (q, k, v, do)),
                                      rows, rows, **kw)
    x = torch.zeros((1, 128, 2, 128), device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        fa.flash_attention_bwd_dq_f32(x, x, x, x, rows, rows, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd_dq_f32(q, k, v.transpose(1, 2).contiguous()
                                      .transpose(1, 2), do, rows, rows, **kw)
    for i in range(4):
        args = [q, k, v, do]
        args[i] = _shifted(args[i])
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention_bwd_dq_f32(*args, rows, rows, **kw)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention_bwd_dq(*args, rows, rows, **kw)
    for bad in (torch.zeros((1, 2, 2), dtype=torch.int32, device=cuda),
                torch.zeros((1, 2, 1), dtype=torch.int64, device=cuda),
                torch.zeros((1, 2, 1), dtype=torch.int32)):
        with pytest.raises(ValueError, match="walked"):
            fa.flash_attention_bwd_dq_f32(q, k, v, do, rows, rows,
                                          walked=bad, **kw)
        with pytest.raises(ValueError, match="walked"):
            fa.flash_attention_bwd_dkv_f32(q, k, v, do, rows, rows,
                                           walked=bad, **kw)
    for fn in _f32_dq_counters(fa):
        assert fn.launches == 0
    x = _attn_inputs((1, 128, 2, 128), (1, 128, 2, 128), torch.float32,
                     cuda, seed=2)[0]
    assert fa.dq_route(torch.float32, 128) == "simt"
    fa.flash_attention_bwd_dq(x, x, x, x, rows, rows, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dq.launches == 1
    assert fa.flash_attention_bwd_dq_f32.launches == 0


def test_flash_attention_bwd_dq_f32_through_autograd(cuda, monkeypatch):
    """loss.backward() through flash_attention in f32 at D = 64 reaches
    the f32 dq and dk/dv kernels once each and no other K3-bwd kernel;
    the q, k and v gradients agree with the plain backward."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in _f32_dq_counters(fa):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, do, kw = _f32_dkv_case(F32_DKV_CASES[2], cuda, seed=13)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, **kw).backward(do)
    assert [fn.launches for fn in _f32_dq_counters(fa)] == [1, 1, 1, 1, 0, 0]
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for t, w in zip(leaves, want):
        assert _rel_err(t.grad, w) <= BWD_TOL[torch.float32]


# K3's f32 forward at D = 64: the f32 dq kernel's cases (the training
# shape, three segments off the 64-grid, causal with and without ids, the
# tail L = 200, pads per batch row, the ViT at a 480x640 image) and square
# causal at the ViT's width; and the rows whose segment no key has
F32_K3_FWD_CASES = F32_DQ_CASES + [(1, 1280, 16, True, [((1280, 1),)])]


def _k3_fwd_counters(fa):
    return (fa.flash_attention, fa.flash_attention_fwd_f32,
            fa.flash_attention_fwd_sm90)


def _k3_f32_case(case, dev, seed):
    """q, k, v and the forward's keywords of a F32_K3_FWD_CASES or
    UNSEEN_SEGMENT_CASES case."""
    make = _f32_unseen_case if len(case) == 6 else _f32_dkv_case
    q, k, v, _, kw = make(case, dev, seed)
    return q, k, v, kw


@pytest.mark.parametrize("case", F32_K3_FWD_CASES + UNSEEN_SEGMENT_CASES)
def test_flash_attention_fwd_f32_kernel_matches_plain(cuda, monkeypatch,
                                                      case):
    """f32 K3 at D = 64 goes to the FFMA kernel (one launch a call, its
    own count), agrees with the plain forward (TOL's f32 atol for O, 1e-3
    for lse), keeps lse <= -1e29 exactly on the rows with no key of their
    segment, and repeats bit for bit."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in _k3_fwd_counters(fa):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, kw = _k3_f32_case(case, cuda, seed=case[1] + 9)
    got = [fa.flash_attention(q, k, v, return_lse=True, **kw)
           for _ in range(2)]
    torch.cuda.synchronize()
    want, wlse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert [fn.launches for fn in _k3_fwd_counters(fa)] == [2, 2, 0]
    (o, lse), (o2, lse2) = got
    assert o.dtype == torch.float32 and o.shape == q.shape
    assert torch.equal(o, o2) and torch.equal(lse, lse2)   # deterministic
    assert _close(o, want, torch.float32)
    assert torch.allclose(lse, wlse, atol=1e-3, rtol=1e-5)
    assert torch.equal(lse <= -1e29, wlse <= -1e29)


@pytest.mark.parametrize("rows", [128, 64], ids=["wide", "narrow"])
@pytest.mark.parametrize("case", F32_K3_FWD_CASES + UNSEEN_SEGMENT_CASES)
def test_flash_attention_fwd_f32_walk_matches_rule(cuda, case, rows):
    """Each of the f32 forward's tiles, forced: agrees with the plain
    forward, and the key tiles each row block walked, read back from the
    kernel, are the skip rule's in that tile (fwd_walk_map, the same for
    every head). In the tile the route takes (`fwd_f32_tile`), O and lse
    are the route's, bit for bit."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    q, k, v, kw = _k3_f32_case(case, cuda, seed=case[1] + 10)
    b, l, h, _ = q.shape
    rule = fa.fwd_walk_map(l, kw["causal"], kw["q_segment_ids"],
                           kw["kv_segment_ids"], rows=rows).to(cuda)
    walked = torch.full((b, h, rule.shape[2]), -1, dtype=torch.int32,
                        device=cuda)
    o, lse = fa.flash_attention_fwd_f32(q, k, v, walked=walked, rows=rows,
                                        **kw)
    torch.cuda.synchronize()
    assert torch.equal(walked, rule.sum(-1).int().expand(b, h, -1))
    want, wlse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert _close(o, want, torch.float32)
    assert torch.allclose(lse, wlse, atol=1e-3, rtol=1e-5)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if fa.fwd_f32_tile(b, l, h, sms)[0] == rows:
        ro, rlse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        assert torch.equal(o, ro) and torch.equal(lse, rlse)


def test_flash_attention_fwd_f32_tiles_match_the_wrapper(cuda):
    """The kernel's tiles (its C entry) are the ones the wrapper and the
    skip rule's map assume; another row count is refused."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    lib = fa._fwd_f32_lib()
    for rows, keys in fa.FWD_F32_TILES.items():
        assert lib.flash_attention_fwd_f32_keys(rows) == keys
    assert lib.flash_attention_fwd_f32_keys(48) == 0
    q, k, v, kw = _k3_f32_case((1, 128, 2, False, [((100, 1),)]), cuda,
                               seed=3)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_attention_fwd_f32(q, k, v, rows=48, **kw)


def test_flash_attention_fwd_f32_rejects_bad_input(cuda, monkeypatch):
    """The f32 forward takes f32 at D = 64 only, contiguous and 16-byte
    aligned, with a `walked` of its shape; anything else raises before any
    launch, and nothing falls back."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    for fn in _k3_fwd_counters(fa):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, kw = _k3_f32_case((1, 128, 2, False, [((100, 1),)]), cuda,
                               seed=1)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention_fwd_f32(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                   **kw)
    x = torch.zeros((1, 128, 2, 128), device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        fa.flash_attention_fwd_f32(x, x, x, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd_f32(q, k, v.transpose(1, 2).contiguous()
                                   .transpose(1, 2), **kw)
    for i in range(3):
        args = [q, k, v]
        args[i] = _shifted(args[i])
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention_fwd_f32(*args, **kw)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention(*args, **kw)
    # the tile at this shape (1, 128, 2) is the narrow one: 2 row blocks
    for bad in (torch.zeros((1, 2, 3), dtype=torch.int32, device=cuda),
                torch.zeros((1, 2, 2), dtype=torch.int64, device=cuda),
                torch.zeros((1, 2, 2), dtype=torch.int32),
                torch.zeros((1, 2, 2), dtype=torch.int32, device=cuda)[
                    ..., :1]):
        with pytest.raises(ValueError, match="walked"):
            fa.flash_attention_fwd_f32(q, k, v, walked=bad, **kw)
    with pytest.raises(ValueError, match="walked"):           # wide: 1 block
        fa.flash_attention_fwd_f32(q, k, v, rows=128, walked=torch.zeros(
            (1, 2, 2), dtype=torch.int32, device=cuda), **kw)
    for fn in _k3_fwd_counters(fa):
        assert fn.launches == 0


@pytest.mark.parametrize("case", [F32_DKV_CASES[1], F32_DKV_CASES[2],
                                  UNSEEN_SEGMENT_CASES[0]],
                         ids=["three_segments", "causal_segments",
                              "unseen_segment"])
def test_flash_attention_fwd_f32_through_autograd(cuda, monkeypatch, case):
    """loss.backward() through flash_attention in f32 at D = 64 runs the
    f32 forward once and the f32 dq and dk/dv kernels on its lse; the q,
    k and v gradients agree with the plain backward (BWD_TOL)."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    counters = (*_k3_fwd_counters(fa), *_f32_dq_counters(fa))
    for fn in counters:
        monkeypatch.setattr(fn, "launches", 0)
    make = _f32_unseen_case if len(case) == 6 else _f32_dkv_case
    q, k, v, do, kw = make(case, cuda, seed=17)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, **kw)
    out.backward(do)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [1, 1, 0, 1, 1, 1, 1, 0, 0]
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert _close(out.detach(), o, torch.float32)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for t, w in zip(leaves, want):
        assert _rel_err(t.grad, w) <= BWD_TOL[torch.float32]


def test_ref_modules_backward_on_the_card(cuda, monkeypatch):
    """loss.backward() through a miniature RefModules on the card reaches
    every parameter (K2 and K3 carry gradients), equal to the CPU's."""
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.nn.qwen3vl import (RefCfg, RefTextCfg,
                                               RefVisionCfg,
                                               get_rope_index_single_image)
    from wedetect_tpu_torch.ops import flash_attention as fa
    from wedetect_tpu_torch.ops import flash_gqa as fg

    for fn in (fg.gqa_flash_bwd_dq, fg.gqa_flash_bwd_dkdv,
               fg.gqa_flash_bwd_dkdv_f32, fg.gqa_flash_bwd_dq_f32,
               fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_f32,
               fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dkv_f32):
        monkeypatch.setattr(fn, "launches", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = RefCfg(
        vision=RefVisionCfg(depth=2, hidden=128, heads=2, intermediate=256,
                            patch=4, temporal_patch=2, merge=2,
                            out_hidden=256, num_pos_emb=64,
                            deepstack_idx=(0, 1)),
        text=RefTextCfg(vocab_size=256, hidden=256, layers=2, heads=4,
                        kv_heads=2, head_dim=128, intermediate=512,
                        rope_theta=1000.0),
        image_token_id=120, vision_start_token_id=122, object_token_id=123)
    cpu = init_ref_variables(cfg, seed=5, device="cpu")
    card = init_ref_variables(cfg, seed=5, device=cuda)
    card.load_state_dict(cpu.state_dict())
    gh, gw, l = 8, 12, 128
    rng = np.random.default_rng(6)
    patches = rng.standard_normal((gh * gw, 96)).astype(np.float32)
    seq = np.concatenate([[1, 2, 122], np.full(24, 120), [7, 9],
                          np.full(3, 123), [2]])
    ids = np.zeros((1, l), np.int32)
    ids[0, :len(seq)] = seq
    mask = (np.arange(l) < len(seq)).astype(np.int32)[None]
    pos = get_rope_index_single_image(ids[0], 120, gh, gw, 2)[:, None]
    obj = np.nonzero(seq == 123)[0][None].astype(np.int32)
    boxes = np.array([[2, 2, 30, 20], [10, 5, 47, 31], [0, 0, 48, 32]],
                     np.float32)
    grads = []
    for m in (card, cpu):
        m.zero_grad()
        out = m(patches, ids, mask, pos, boxes,
                np.array([48.0, 32.0], np.float32), 3, obj, grid_h=gh,
                grid_w=gw)
        out.sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    assert fg.gqa_flash_bwd_dq.launches == cfg.text.layers
    assert fg.gqa_flash_bwd_dkdv.launches == cfg.text.layers
    assert fg.gqa_flash_bwd_dkdv_f32.launches == cfg.text.layers
    assert fg.gqa_flash_bwd_dq_f32.launches == cfg.text.layers
    assert fa.flash_attention_bwd_dq.launches == cfg.vision.depth
    assert fa.flash_attention_bwd_dkv.launches == cfg.vision.depth
    assert fa.flash_attention_bwd_dkv_f32.launches == cfg.vision.depth
    assert fa.flash_attention_bwd_dq_f32.launches == cfg.vision.depth
    missing = [n for n, g in grads[0].items() if g is None]
    assert not missing, missing
    for n, g in grads[0].items():
        want = grads[1][n]
        err = float((g.cpu() - want).abs().max())
        assert err <= 1e-5 * max(float(want.abs().max()), 1e-3), (n, err)


# ------------------------------------------------------ detector training
def _det_mini_cfg(**kw):
    from wedetect_tpu_torch.configs import ModelCfg

    return ModelCfg(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                    neck_scale=0.25, neck_repeats=2,
                    head_in_channels=(32, 64, 128), embed_dims=32,
                    img_size=(128, 128), text=None, num_classes=4, **kw)


def _det_step(cfg, model, seed=0):
    from wedetect_tpu_torch.train.train_step import (Batch, TrainState,
                                                     det_optimizer,
                                                     train_step)

    rng = np.random.default_rng(seed)
    g = cfg.train.max_gt_per_image
    gtb = np.zeros((2, g, 4), np.float32)
    gtl = np.zeros((2, g), np.int32)
    gtm = np.zeros((2, g), bool)
    gtb[0, :3] = [[8, 8, 60, 80], [40, 20, 120, 100], [80, 80, 94, 92]]
    gtl[0, :3] = [1, 3, 2]
    gtb[1, :1] = [[20, 20, 40, 36]]
    gtm[0, :3] = gtm[1, :1] = True
    batch = Batch(rng.integers(0, 256, (2, 128, 128, 3), np.uint8),
                  rng.standard_normal((2, 4, 32)).astype(np.float32),
                  gtb, gtl, gtm)
    state = TrainState.create(model, det_optimizer(model, base_lr=5e-4))
    _, m = train_step(cfg, state, batch)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: t.cpu() for n, t in model.state_dict().items()})


def test_det_train_step_card_matches_cpu(cuda):
    """One f32 train_step of a miniature detector (mini_cfg's widths at
    128x128, chip_smoke.det_mini_cfg says why) on the card and on the
    CPU from the same weights: losses to 1e-4 relative, each gradient to
    1e-4 of its tensor's largest entry or one f32 ulp of the model's
    largest (tests/test_torch_train_det.py), BN statistics and the
    updated parameters (lr 5e-4, Adam: +-2 lr) likewise; K1 never
    launches."""
    from wedetect_tpu_torch.models import wedetect as W
    from wedetect_tpu_torch.ops.row_topk import row_topk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _det_mini_cfg()
    cpu = W.init_variables(cfg, seed=5, device="cpu")
    card = W.init_variables(cfg, seed=5, device=cuda)
    card.load_state_dict(cpu.state_dict())
    before = row_topk.launches
    got, want = _det_step(cfg, card), _det_step(cfg, cpu)
    assert row_topk.launches == before
    for k in ("loss", "loss_cls", "loss_bbox", "loss_dfl", "grad_norm"):
        assert abs(got[0][k] - want[0][k]) <= 1e-4 * abs(want[0][k]), k
    assert got[0]["num_pos"] == want[0]["num_pos"] > 0
    top = max(float(w.abs().max()) for w in want[1].values())
    for n, w in want[1].items():
        err = float((got[1][n] - w).abs().max())
        assert err <= max(1e-4 * float(w.abs().max()), 2.0 ** -23 * top), n
    for n, w in want[2].items():
        err = float((got[2][n].float() - w.float()).abs().max())
        bound = 1e-5 if n.endswith(("running_mean", "running_var")) \
            else 2 * 5e-4 + 1e-6
        assert err <= bound, (n, err)


def test_drop_path_generator_on_the_card(cuda):
    """Drop path on CUDA tensors draws from a CUDA generator: the same
    seed gives the same masks, whole samples are dropped or kept scaled
    by 1 / keep, and the train step's generator lives on the card."""
    from wedetect_tpu_torch.nn.convnext import drop_path
    from wedetect_tpu_torch.train.train_step import drop_path_generator

    y = torch.randn(256, 8, 4, 4, device=cuda)
    gen = drop_path_generator(_det_mini_cfg(drop_path_rate=0.3), 7, cuda)
    assert gen.device.type == "cuda"
    a = drop_path(y, 0.3, gen)
    b = drop_path(y, 0.3, drop_path_generator(
        _det_mini_cfg(drop_path_rate=0.3), 7, cuda))
    assert torch.equal(a, b)
    kept = (a != 0).flatten(1).any(1)
    assert torch.equal(a[~kept], torch.zeros_like(a[~kept]))
    assert torch.allclose(a[kept], y[kept] / 0.7)
    assert 0.5 < float(kept.float().mean()) < 0.9
    with pytest.raises(RuntimeError):
        drop_path(y, 0.3, torch.Generator())       # a CPU generator


def _mini_gen_cfg():
    from wedetect_tpu_torch.nn.qwen3vl import RefCfg, RefTextCfg, RefVisionCfg

    return RefCfg(
        vision=RefVisionCfg(depth=2, hidden=128, heads=2, intermediate=256,
                            patch=4, temporal_patch=2, merge=2,
                            out_hidden=256, num_pos_emb=64,
                            deepstack_idx=(0, 1)),
        text=RefTextCfg(vocab_size=256, hidden=256, layers=2, heads=4,
                        kv_heads=2, head_dim=128, intermediate=512,
                        rope_theta=1000.0),
        image_token_id=120, vision_start_token_id=122, object_token_id=123)


def test_prng_and_sampler_on_the_card_bitwise(cuda):
    """The PRNG twin's bits, uniforms and draws and the serving sampler
    on the card equal the CPU's bitwise."""
    from wedetect_tpu_torch.models.serve import _sample_rows
    from wedetect_tpu_torch.ops import prng

    seeds = torch.tensor([0, 7, -3, 2**31 - 1], dtype=torch.int32)
    logits = torch.randn(4, 151936, generator=torch.Generator().manual_seed(0))
    got, want = [], []
    for dev, out in ((cuda, got), (torch.device("cpu"), want)):
        keys = prng.fold_in(prng.PRNGKey(seeds.to(dev)), 9)
        out += [prng.random_bits(keys, (1000,)).cpu(),
                prng.uniform(keys, (1000,)).cpu().view(torch.int32),
                prng.categorical(keys, logits.to(dev)).cpu(),
                _sample_rows(logits.to(dev), (0.8, 50, 0.9), seeds.to(dev),
                             torch.arange(4, device=dev)).cpu()]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"kv_bits": 8}, {"piggyback": True}])
def test_generation_and_server_card_match_cpu(cuda, kw):
    """A miniature Ref (head_dim 128): greedy ref_generate and a 3-slot
    GenServer on the card emit the CPU's tokens (f32, TF32 off), with K2
    and K3 launched in every admission prefill."""
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_generate import ref_generate
    from wedetect_tpu_torch.models.serve import GenServer
    from wedetect_tpu_torch.nn.qwen3vl import get_rope_index_single_image
    from wedetect_tpu_torch.ops import flash_attention as fa
    from wedetect_tpu_torch.ops import flash_gqa as fg

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _mini_gen_cfg()
    cpu = init_ref_variables(cfg, seed=11, device="cpu")
    card = init_ref_variables(cfg, seed=11, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(12)
    reqs = []
    for k in range(4):
        seq = np.concatenate([[1, 2, 122], np.full(24, 120),
                              rng.integers(5, 110, 3 + 2 * k)])
        ids = np.zeros(128, np.int32)
        ids[:len(seq)] = seq
        mask = (np.arange(128) < len(seq)).astype(np.int32)
        pos = np.zeros((3, 128), np.int32)
        pos[:, :len(seq)] = get_rope_index_single_image(seq, 120, 8, 12, 2)
        reqs.append((rng.standard_normal((96, 96)).astype(np.float32), ids,
                     mask, pos, int(pos.max()) + 1))
    pa, ids, mask, pos, n0 = reqs[0]
    toks = [ref_generate(cfg, 8, 12, m, pa, ids[None], mask[None],
                         pos[:, None], 3, np.array([n0]),
                         np.array([[0, 0, 48, 32]], np.float32),
                         np.array([48.0, 32.0], np.float32), 8, 255,
                         pad_id=254).cpu() for m in (card, cpu)]
    assert torch.equal(*toks)
    outs = []
    for m in (card, cpu):
        fg.gqa_flash_attention.launches = fa.flash_attention.launches = 0
        srv = GenServer(cfg, 8, 12, m, slots=3, prompt_len=128, max_new=8,
                        chunk=3, eos_id=255, pad_id=254, **kw)
        rids = [srv.submit(*r[:4], 3, r[4]) for r in reqs]
        out = srv.run()
        outs.append([list(map(int, out[r])) for r in rids])
        if m is card:
            classic = srv.stats["admits"] - srv.stats.get("pb_admits", 0)
            assert fg.gqa_flash_attention.launches == 2 * classic
            assert fa.flash_attention.launches == 2 * srv.stats["admits"]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("rows", [1, 16, 17])
def test_int_mm_padding_rule_on_the_card(cuda, rows):
    """torch._int_mm through ops/int8's padding rule at rows 1, 16 and
    17, K = N = 12 (off the card's multiples of 8): the sums equal the
    CPU's int64 product exactly; unpadded, the card refuses the shape
    (it raises; nothing falls back)."""
    from wedetect_tpu_torch.ops import int8 as TI

    g = torch.Generator().manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 12), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (12, 12), generator=g, dtype=torch.int8)
    a[0], w[0] = 127, -127
    got = TI.int8_matmul(a.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got.cpu().long(), a.long() @ w.long().T)
    with pytest.raises(RuntimeError):
        torch._int_mm(a.to(cuda), w.to(cuda).t())
        torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_ops_card_equal_cpu(cuda, dtype):
    """quant_linear and quant_conv2d (3x3 / stride 2 and 1x1) on the card
    equal the CPU's bit for bit: exact int32 sums, the same epilogue."""
    from wedetect_tpu_torch.ops import int8 as TI

    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 5, 37, generator=g).to(dtype)
    w = torch.randn(20, 37, generator=g).to(dtype)
    b = torch.randn(20, generator=g)
    want = TI.quant_linear(x, w, b)
    assert torch.equal(TI.quant_linear(x.to(cuda), w.to(cuda),
                                       b.to(cuda)).cpu(), want)
    xc = torch.randn(2, 6, 9, 7, generator=g).to(dtype)
    for k, s in ((3, 2), (1, 1)):
        wc = torch.randn(10, 6, k, k, generator=g).to(dtype)
        want = TI.quant_conv2d(xc, wc, None, s, k // 2)
        got = TI.quant_conv2d(xc.to(cuda), wc.to(cuda), None, s, k // 2)
        assert torch.equal(got.cpu(), want)


def test_calibrated_int4_fit_card_equals_cpu(cuda):
    """The activation-weighted int4 fit (models/quant, run on the
    weight's device) gives the CPU's codes and scales on the card."""
    from wedetect_tpu_torch.models import quant

    g = torch.Generator().manual_seed(7)
    w = torch.randn(256, 96, generator=g)
    w[:, 0] *= 30.0
    rms = (torch.rand(256, generator=g) * 3 + 0.1).numpy()
    want = quant.quantize_weight4(w, act_rms=rms)
    got = quant.quantize_weight4(w.to(cuda), act_rms=rms)
    for k in ("w4p", "rscale", "scale"):
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k].cpu(), want[k]), k


def _eval_fixture(root, n=4, k=3):
    """An LVIS-format dataset of n seeded PNGs (60-120 px) with one gt
    of each class a image, every category with a frequency."""
    import json

    import cv2

    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(60, 120, 2))
        cv2.imwrite(str(root / f"img{i}.png"),
                    rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        images.append({"id": i + 1, "file_name": f"img{i}.png", "width": w,
                       "height": h, "neg_category_ids": [],
                       "not_exhaustive_category_ids": []})
        for c in range(k):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            bw, bh = rng.uniform(8, w - x), rng.uniform(8, h - y)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": c + 1, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": 0})
    cats = [{"id": c + 1, "name": f"c{c}", "frequency": "rcf"[c % 3]}
            for c in range(k)]
    (root / "lvis.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": cats}))
    return root / "lvis.json"


@pytest.mark.parametrize("tta", [False, True])
def test_evaluate_coco_card_matches_cpu(cuda, tmp_path, tta, monkeypatch):
    """eval/runner.evaluate_coco (LVIS, with its dump) on the card equals
    the same weights on the CPU, TF32 off: boxes within 1e-3 px, scores
    within 1e-5, labels equal; metrics within 1e-6."""
    from wedetect_tpu_torch.configs import ModelCfg, TestCfg
    from wedetect_tpu_torch.data.coco import CocoDetDataset
    from wedetect_tpu_torch.eval.dump import load_detections
    from wedetect_tpu_torch.eval.runner import evaluate_coco
    from wedetect_tpu_torch.models import wedetect as W

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    ann = _eval_fixture(tmp_path)
    cfg = ModelCfg(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                   neck_scale=0.25, neck_repeats=2,
                   head_in_channels=(32, 64, 128), embed_dims=32,
                   img_size=(64, 64), text=None, num_classes=3,
                   test=TestCfg(nms_pre=256, max_per_img=16))
    cpu = W.init_variables(cfg, seed=0, device="cpu")
    with torch.no_grad():
        for i in range(3):   # small boxes, spread scores
            reg = cpu.bbox_head.reg_preds[i][6]
            reg.bias.copy_(-0.8 * (torch.arange(64) % 16).float())
            reg.weight.mul_(3)
            cpu.bbox_head.cls_contrasts[i].logit_scale += 2.5
    card = W.init_variables(cfg, seed=0, device=cuda)
    card.load_state_dict(cpu.state_dict())
    w = np.random.default_rng(1).standard_normal((3, 32)).astype(np.float32)
    ds = CocoDetDataset(str(ann), str(tmp_path))
    res = {}
    for name, model in (("cpu", cpu), ("card", card)):
        path = str(tmp_path / f"{name}.npz")
        res[name] = (evaluate_coco(cfg, model, ds, w, batch_size=3,
                                   lvis=True, tta=tta, dump_path=path),
                     load_detections(path))
    (want, wd), (got, gd) = res["cpu"], res["card"]
    assert sum(len(r["scores"]) for r in gd) > 0
    for g, r in zip(gd, wd):
        np.testing.assert_array_equal(g["labels"], r["labels"])
        np.testing.assert_allclose(g["scores"], r["scores"], atol=1e-5)
        np.testing.assert_allclose(g["boxes"], r["boxes"], atol=1e-3)
    for key in ("mAP", "AP50", "AP75", "APs", "APm", "APl", "APr", "APc",
                "APf"):
        a, b = got[key], want[key]
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-6, key


def _video_prompt(cfg, gt=3, gh=8, gw=12, tail=5, seed=13):
    """A video prompt of the miniature Ref: gt temporal groups at a
    gh x gw grid (gt * gh * gw ViT tokens, padded to a multiple of 128 in
    the ViT) as one contiguous span, right-padded to 128 tokens."""
    from wedetect_tpu_torch.nn.qwen3vl import get_rope_index_single_video

    rng = np.random.default_rng(seed)
    n_vid = gt * (gh // 2) * (gw // 2)
    seq = np.concatenate([[1, 2, cfg.vision_start_token_id],
                          np.full(n_vid, cfg.video_token_id),
                          rng.integers(5, 110, tail)])
    ids = np.zeros(128, np.int32)
    ids[:len(seq)] = seq
    mask = (np.arange(128) < len(seq)).astype(np.int32)
    pos = np.zeros((3, 128), np.int32)
    pos[:, :len(seq)] = get_rope_index_single_video(
        seq, cfg.video_token_id, gt, gh, gw, 2)
    patches = rng.standard_normal((gt * gh * gw, 96)).astype(np.float32)
    return dict(patches=patches, gt=gt, gh=gh, gw=gw, ids=ids[None],
                mask=mask[None], pos=pos[:, None], nxt=int(pos.max()) + 1,
                boxes=np.array([[0, 0, 4.0 * gw, 4.0 * gh]], np.float32),
                ori=np.array([4.0 * gw, 4.0 * gh], np.float32))


def _video_cfg():
    import dataclasses

    return dataclasses.replace(_mini_gen_cfg(), video_token_id=121)


def _video_prefill(model, b, patches=None):
    from wedetect_tpu_torch.models import ref_generate as TG

    with torch.inference_mode():
        return TG._prefill_hidden_kvs(
            model, b["gh"], b["gw"],
            b["patches"] if patches is None else patches, b["ids"],
            b["mask"], b["pos"], b["boxes"], b["ori"], 3,
            np.full((1, 1), -1, np.int32), grid_t=b["gt"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_video_prefill_kernels_match_plain(cuda, monkeypatch, dtype):
    """A video prefill (3 temporal groups: 288 ViT tokens padded to 384
    as one segment, a 72-token span) through K2 and K3 on the type's
    route (2 launches each) against the same prefill through their plain
    versions: hidden states and KV on the real rows, f32 within 1e-4;
    bf16 (the kernel and the plain version round P to bf16 at different
    points, and two layers carry it) within the Ref phase's logit terms,
    max 0.1 and mean 0.025 (chip_smoke.REF_LOGIT_TOL, _MEAN_TOL); the
    clip with two groups swapped misses."""
    from wedetect_tpu_torch.models.ref import (cast_ref_model,
                                               init_ref_variables)
    from wedetect_tpu_torch.ops import flash_attention as fa
    from wedetect_tpu_torch.ops import flash_gqa as fg

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = _video_cfg()
    model = cast_ref_model(init_ref_variables(cfg, seed=11, device=cuda),
                           dtype)
    b = _video_prompt(cfg)
    route = {"float32": "f32", "bfloat16": "sm90"}[dtype]
    k2_route = getattr(fg, f"gqa_flash_fwd_{route}")
    k3_route = getattr(fa, f"flash_attention_fwd_{route}")
    for fn in (fg.gqa_flash_attention, fa.flash_attention, k2_route,
               k3_route):
        fn.launches = 0
    got_h, got_kv = _video_prefill(model, b)
    n, n3 = cfg.text.layers, cfg.vision.depth
    assert (fg.gqa_flash_attention.launches, k2_route.launches) == (n, n)
    assert (fa.flash_attention.launches, k3_route.launches) == (n3, n3)
    swapped = b["patches"].copy()
    g = b["gh"] * b["gw"]
    swapped[:g], swapped[g:2 * g] = b["patches"][g:2 * g], b["patches"][:g]
    ctrl_h, _ = _video_prefill(model, b, patches=swapped)
    monkeypatch.setattr(fg, "gqa_flash_attention",
                        fg.gqa_flash_attention_plain)
    monkeypatch.setattr(fa, "flash_attention", fa.flash_attention_plain)
    want_h, want_kv = _video_prefill(model, b)
    real = torch.as_tensor(b["mask"][0], device=cuda).bool()
    max_tol, mean_tol = (1e-4, 1e-4) if dtype == "float32" else (0.1, 0.025)

    def err(x, y):
        d = (x[0, real].float() - y[0, real].float()).abs()
        return float(d.max()), float(d.mean())

    def close(x, y):
        e = err(x, y)
        return e[0] <= max_tol and e[1] <= mean_tol

    assert close(got_h, want_h), err(got_h, want_h)
    for (gk, gv), (wk, wv) in zip(got_kv, want_kv):
        assert close(gk, wk) and close(gv, wv), (err(gk, wk), err(gv, wv))
    assert not close(ctrl_h, want_h), err(ctrl_h, want_h)


def test_video_generation_card_matches_cpu(cuda, monkeypatch):
    """Greedy ref_generate(grid_t=3) of the miniature Ref on the card
    emits the CPU's tokens (f32, TF32 off)."""
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_generate import ref_generate

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = _video_cfg()
    cpu = init_ref_variables(cfg, seed=11, device="cpu")
    card = init_ref_variables(cfg, seed=11, device=cuda)
    card.load_state_dict(cpu.state_dict())
    b = _video_prompt(cfg)
    toks = [ref_generate(cfg, b["gh"], b["gw"], m, b["patches"], b["ids"],
                         b["mask"], b["pos"], 3, np.array([b["nxt"]]),
                         b["boxes"], b["ori"], 8, 255, pad_id=254,
                         grid_t=b["gt"]).cpu() for m in (card, cpu)]
    assert torch.equal(*toks)


def test_video_lm_step_card_matches_cpu(cuda, monkeypatch):
    """One stage-2 ref_lm_step on a video sample (grid_t = 3) on the card
    and on the CPU from the same weights: loss and grad_norm within 1e-5
    relative; on the card K2, K3 and their backward kernels launch once a
    layer on the f32 routes (the ViT takes gradients)."""
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.ops import flash_attention as fa
    from wedetect_tpu_torch.ops import flash_gqa as fg
    from wedetect_tpu_torch.train.ref_lm import (IGNORE_INDEX, ref_lm_step,
                                                 stage_optimizer)
    from wedetect_tpu_torch.train.train_step import TrainState

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = _video_cfg()
    b = _video_prompt(cfg)
    labels = np.where(b["mask"] > 0, b["ids"], IGNORE_INDEX).astype(np.int32)
    labels[b["ids"] == cfg.video_token_id] = IGNORE_INDEX
    counters = (fg.gqa_flash_fwd_f32, fg.gqa_flash_bwd_dq_f32,
                fg.gqa_flash_bwd_dkdv_f32, fa.flash_attention_fwd_f32,
                fa.flash_attention_bwd_dq_f32, fa.flash_attention_bwd_dkv_f32)
    metrics = {}
    cpu = init_ref_variables(cfg, seed=11, device="cpu")
    for name, dev in (("cpu", "cpu"), ("card", cuda)):
        model = init_ref_variables(cfg, seed=11, device=dev)
        model.load_state_dict(cpu.state_dict())
        if name == "cpu":
            model.attn_impl = "flash"           # the plain versions
        state = TrainState.create(model, stage_optimizer(model, 2))
        for fn in counters:
            fn.launches = 0
        _, m = ref_lm_step(cfg, b["gh"], b["gw"], state, b["patches"],
                           b["ids"], b["mask"], b["pos"], 3, b["boxes"],
                           b["ori"], np.full((1, 1), -1, np.int32), labels,
                           b["gt"])
        metrics[name] = {k: float(v) for k, v in m.items()}
        if name == "card":
            layers = [cfg.text.layers] * 3 + [cfg.vision.depth] * 3
            assert [fn.launches for fn in counters] == layers
    for key in ("loss", "grad_norm"):
        assert metrics["card"][key] == pytest.approx(metrics["cpu"][key],
                                                     rel=1e-5), key


ZERO3_UNIT = r"""
import json
from wedetect_tpu_torch.parallel import fsdp
from wedetect_tpu_torch.parallel.mesh import make_mesh


def run(dev):
    torch.manual_seed(0)
    unit = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.GELU(),
                               torch.nn.Linear(256, 64))
    z = fsdp.shard_params(unit, make_mesh(data=1, fsdp=2),
                          units=[("unit", [unit])], device=dev)
    x = torch.randn(32, 64, generator=torch.Generator().manual_seed(1))
    x = x.to(dev).requires_grad_()
    with fsdp.forward_scope(unit):
        y = unit(x)
    y.square().sum().backward()
    return ([t.detach().cpu() for t in (y, x.grad)]
            + [p.grad.cpu() for p in unit.parameters()]), z.gathers()


torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
card, card_gathers = run("cuda")
host, _ = run("cpu")
err = max(float((a - b).abs().max() / b.abs().max())
          for a, b in zip(card, host))
with open(f"{OUT}/rank{RANK}.json", "w") as f:
    json.dump({"err": err, "gathers": card_gathers,
               "shapes": [list(t.shape) for t in card[2:]]}, f)
"""


def test_zero3_unit_gather_on_card_matches_cpu(cuda, tmp_path):
    """Parameter sharding (parallel/fsdp.py) on the card: two gloo ranks
    on card 0 shard one unit (a Linear-GELU-Linear block), gather it for
    the forward and again, through the saved-tensor hooks on autograd's
    device thread, for the backward; the output, the input's gradient
    and each rank's gradient slices equal the same run on the CPU within
    1e-5 of each tensor's largest entry (f32, TF32 off)."""
    import json
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from torch_dist_util import run_ranks

    run_ranks(ZERO3_UNIT, tmp_path, timeout=300)
    for r in range(2):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["gathers"] == {"unit": [1, 1]}
        assert res["shapes"] == [[128, 64], [128], [64, 128], [32]]
        assert res["err"] <= 1e-5, res


# ------------------------------------------------ the legacy modules
def _legacy_rel(got, want):
    """max |got - want| over max |want|, over a tensor or a sequence."""
    if not isinstance(got, (tuple, list)):
        got, want = [got], [want]
    return max(float((g.detach().float().cpu() - w.detach().float().cpu())
                     .abs().max() / w.detach().float().cpu().abs().max())
               for g, w in zip(got, want))


def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _legacy_neck(name):
    from wedetect_tpu_torch.nn import yolo_world_pafpn as ywp

    w = (64, 128, 256)
    kw = dict(out_channels=w, guide_channels=32, embed_channels=(32, 64, 128),
              num_heads=(1, 2, 4), num_csp_blocks=2)
    return {"yolo_world": lambda: ywp.YOLOWorldPAFPN(**kw),
            "yolo_world_dual": lambda: ywp.YOLOWorldPAFPN(dual=True, **kw),
            "yolov8_pafpn": lambda: ywp.YOLOv8PAFPN(out_channels=w),
            "yolov5_pafpn": lambda: ywp.YOLOv5PAFPN(w)}[name]()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["yolo_world", "yolo_world_dual",
                                  "yolov8_pafpn", "yolov5_pafpn"])
def test_legacy_necks_card_match_cpu(cuda, monkeypatch, name, train):
    """The legacy necks on the card against the same weights on the CPU
    (f32, TF32 off): outputs within 1e-4 of their largest entry, and in
    train mode the BN running statistics after one update within 1e-5."""
    import copy

    _no_tf32(monkeypatch)
    torch.manual_seed(0)
    cpu = _legacy_neck(name).train(train)
    card = copy.deepcopy(cpu).to(cuda)
    g = torch.Generator().manual_seed(1)
    feats = [torch.randn(2, c, s, s, generator=g)
             for c, s in ((64, 16), (128, 8), (256, 4))]
    args = [feats] + ([torch.randn(2, 5, 32, generator=g)]
                      if name.startswith("yolo_world") else [])
    with torch.no_grad():
        want = cpu(*args)
        got = card(*[[f.to(cuda) for f in a] if isinstance(a, list)
                     else a.to(cuda) for a in args])
    assert _legacy_rel(got, want) <= 1e-4
    if train:
        sd = card.state_dict()
        for k, v in cpu.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert _legacy_rel(sd[k], v) <= 1e-5, k


@pytest.mark.parametrize("stride", [1, 2])
def test_repvgg_card_matches_cpu_and_fused(cuda, monkeypatch, stride):
    """RepVGGBlock on the card against the CPU (1e-4 of the largest
    entry, f32), and its repvgg_fuse deploy form against the train form
    on the card."""
    import copy

    from wedetect_tpu_torch.nn.layers import RepVGGBlock, repvgg_fuse

    _no_tf32(monkeypatch)
    torch.manual_seed(2)
    cpu = RepVGGBlock(32, 32, stride)
    g = torch.Generator().manual_seed(3)
    for m in cpu.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.2, generator=g)
            m.running_var.uniform_(0.5, 1.5, generator=g)
    cpu.eval()
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn(2, 32, 16, 16, generator=g)
    fused = RepVGGBlock(32, 32, stride, deploy=True).to(cuda)
    fused.load_state_dict(repvgg_fuse(card))
    with torch.no_grad():
        y = card(x.to(cuda))
        assert _legacy_rel(y, cpu(x)) <= 1e-4
        assert _legacy_rel(fused(x.to(cuda)), y) <= 1e-4


def test_yolov5_head_decode_nms_loss_card_match_cpu(cuda, monkeypatch):
    """YOLOv5HeadModule -> yolov5_decode -> batched_static_nms on the
    card against the CPU (head and decode within 1e-4 of the largest
    entry; NMS slots bitwise on the same decode), and yolov5_loss's terms
    and gradients (1e-4 of the largest entry)."""
    import copy

    from wedetect_tpu_torch.nn.yolov5_head import YOLOv5HeadModule
    from wedetect_tpu_torch.ops.nms import batched_static_nms
    from wedetect_tpu_torch.ops.yolov5 import yolov5_decode
    from wedetect_tpu_torch.train.yolov5_loss import yolov5_loss

    _no_tf32(monkeypatch)
    torch.manual_seed(4)
    head = YOLOv5HeadModule(5, (16, 32, 64)).eval()
    with torch.no_grad():
        for conv in head.convs_pred:
            conv.bias.view(3, 10)[:, 4] += 4.0
    card = copy.deepcopy(head).to(cuda)
    g = torch.Generator().manual_seed(5)
    feats = [torch.randn(2, c, s, s, generator=g)
             for c, s in ((16, 16), (32, 8), (64, 4))]
    with torch.no_grad():
        raw = card([f.to(cuda) for f in feats])
        assert _legacy_rel(raw, head(feats)) <= 1e-4
        boxes, scores = yolov5_decode(raw)
        assert _legacy_rel([boxes, scores],
                           yolov5_decode([r.cpu() for r in raw])) <= 1e-4
        got = batched_static_nms(scores, boxes, 0.001, 30000, 0.7, 100)
        want = batched_static_nms(scores.cpu(), boxes.cpu(), 0.001, 30000,
                                  0.7, 100)
    assert int(got.valid.sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    gt = torch.tensor([[[10., 12., 60., 70.], [64., 30., 120., 90.]]] * 2)
    labels = torch.tensor([[1, 3], [0, 4]])
    mask = torch.tensor([[True, True], [True, False]])

    def step(preds, dev):
        ps = [p.detach().clone().to(dev).requires_grad_() for p in preds]
        out = yolov5_loss(ps, gt.to(dev), labels.to(dev), mask.to(dev),
                          (128, 128))
        out.total.backward()
        return out, [p.grad for p in ps]

    (lc, gc), (ld, gd) = step(raw, "cpu"), step(raw, cuda)
    for a, b in zip(ld, lc):
        assert _legacy_rel(a, b) <= 1e-4
    assert _legacy_rel(gd, gc) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_clip_towers_card_match_cpu(cuda, monkeypatch, dtype, tol):
    """The CLIP towers (4 layers, narrow) on the card against the same
    weights and call on the CPU: max error over the largest entry, 1e-4
    in f32 (TF32 off) and 5e-2 in bf16."""
    from wedetect_tpu_torch.nn import clip

    _no_tf32(monkeypatch)
    tc = clip.ClipTextCfg(vocab_size=1000, hidden=128, layers=4, heads=4,
                          intermediate=256, projection_dim=64,
                          eos_token_id=999)
    vc = clip.ClipVisionCfg(hidden=128, layers=4, heads=4, intermediate=256,
                            image_size=64, patch=16)
    torch.manual_seed(6)
    text, vision = clip.ClipTextTower(tc, dtype), clip.ClipVisionTower(vc,
                                                                       dtype)
    text_d = clip.ClipTextTower(tc, dtype).to(cuda)
    text_d.load_state_dict(text.state_dict())
    vision_d = clip.ClipVisionTower(vc, dtype).to(cuda)
    vision_d.load_state_dict(vision.state_dict())
    g = torch.Generator().manual_seed(7)
    ids = torch.randint(1, 998, (3, 77), generator=g)
    ids[:, 20] = 999
    mask = (torch.arange(77)[None] <= 20).long().expand(3, -1)
    img = torch.randn(2, 3, 64, 64, generator=g)
    with torch.no_grad():
        assert _legacy_rel(text_d(ids.to(cuda), mask.to(cuda)),
                           text(ids, mask)) <= tol
        assert _legacy_rel(vision_d(img.to(cuda)), vision(img)) <= tol


def test_pseudo_text_backbone_on_card(cuda):
    from wedetect_tpu_torch.nn.pseudo_text import PseudoTextBackbone

    out = PseudoTextBackbone(table={"a": [3.0, 4.0], "b": [0.0, 2.0]})(
        ["b", "a"])
    assert out.is_cuda
    torch.testing.assert_close(out.cpu(), torch.tensor([[0.0, 1.0],
                                                        [0.6, 0.8]]))
