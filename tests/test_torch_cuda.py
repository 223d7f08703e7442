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


def _rows(r, k, seed, dev):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (r, k)).astype(np.float32)
    x[::3] = np.floor(x[::3] * 4) / 4                     # ties
    x[rng.uniform(0, 1, (r, k)) > rng.uniform(0, 1, (r, 1))] = -np.inf
    x[::11] = -np.inf                                     # fully masked
    x[1::13] = rng.choice(np.array([0.0, -0.0, -np.inf], np.float32),
                          (len(x[1::13]), k))             # signed zeros
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("r,k,t", [(1000, 1203, 64), (999, 37, 37),
                                   (512, 80, 64), (300, 1280, 64),
                                   (200, 2000, 64), (64, 33, 1)])
def test_row_topk_kernel_bitwise(cuda, monkeypatch, r, k, t):
    from wedetect_tpu_torch.ops.row_topk import row_topk, row_topk_plain

    monkeypatch.setattr(row_topk, "launches", 0)
    x = _rows(r, k, seed=r + k, dev=cuda)
    kv, kc = row_topk(x, t)
    torch.cuda.synchronize()
    pv, pc = row_topk_plain(x, t)
    assert row_topk.launches == 1
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(kc, pc)


def test_row_topk_rejects_bad_input(cuda):
    from wedetect_tpu_torch.ops.row_topk import row_topk

    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(TypeError):
        row_topk(x.double(), 2)
    with pytest.raises(ValueError):
        row_topk(x[:, ::2], 2)           # not contiguous
    with pytest.raises(ValueError):
        row_topk(x, 9)                   # t > K


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
@pytest.mark.parametrize("b,s,lk,h,kvh,d,causal,masked", K2_CASES)
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
    (1, 128, 2, 128, 128, False)])
def test_flash_attention_kernel_matches_plain(cuda, monkeypatch, dtype, b, l,
                                              h, d, n_real, causal):
    from wedetect_tpu_torch.ops.flash_attention import (flash_attention,
                                                        flash_attention_plain)

    monkeypatch.setattr(flash_attention, "launches", 0)
    q, k, v = _attn_inputs((b, l, h, d), (b, l, h, d), dtype, cuda, seed=l)
    seg = (torch.arange(l, device=cuda) < n_real).to(torch.int32)
    seg = seg[None].expand(b, l).contiguous()
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
              sm_scale=d ** -0.5, return_lse=True)
    got, lse = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want, wlse = flash_attention_plain(q, k, v, **kw)
    assert flash_attention.launches == 1
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
    x = torch.zeros((1, 128, 4, 32), device=cuda)
    with pytest.raises(ValueError):                      # head dim 32
        flash_attention(x, x, x)


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
    (1, 512, 512, 16, 8, 128, True, True)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,d,n_real,causal", [
    (1, 1280, 16, 64, 1200, False),
    (1, 256, 4, 64, 256, True),
    (2, 384, 4, 128, 300, False)])
def test_flash_attention_bwd_kernels_match_plain(cuda, monkeypatch, dtype, b,
                                                 l, h, d, n_real, causal):
    from wedetect_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(fa.flash_attention_bwd_dq, "launches", 0)
    monkeypatch.setattr(fa.flash_attention_bwd_dkv, "launches", 0)
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
    for a, a2, w in zip(got[0], got[1], want):
        assert torch.equal(a, a2)                          # deterministic
        assert _rel_err(a, w) <= BWD_TOL[dtype]


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
               fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
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
    assert fa.flash_attention_bwd_dq.launches == cfg.vision.depth
    assert fa.flash_attention_bwd_dkv.launches == cfg.vision.depth
    missing = [n for n, g in grads[0].items() if g is None]
    assert not missing, missing
    for n, g in grads[0].items():
        want = grads[1][n]
        err = float((g.cpu() - want).abs().max())
        assert err <= 1e-5 * max(float(want.abs().max()), 1e-3), (n, err)
