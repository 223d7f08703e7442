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
