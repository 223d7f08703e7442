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
