"""The port's row top-k (K1) against the JAX Pallas kernel run in
interpret mode on the CPU. The contract is bitwise: vals and cls must be
equal on every slot, empty (-inf) slots included. The CUDA kernel itself
is held to `row_topk_plain` on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wedetect_tpu.ops.pallas_topk import row_topk as jax_row_topk
from wedetect_tpu_torch.ops.row_topk import row_topk, row_topk_plain


def _rows(kind, r, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((r, k)).astype(np.float32)
    if kind == "ties":       # 4 non-negative levels: long tied runs
        x = np.floor(rng.uniform(0, 1, (r, k)) * 4).astype(np.float32) / 4
    elif kind == "masked":   # thresholded scores: partly / fully -inf
        x = rng.uniform(0, 1, (r, k)).astype(np.float32)
        keep = rng.uniform(0, 1, (r, 1))
        x[rng.uniform(0, 1, (r, k)) > keep] = -np.inf
        x[::5] = -np.inf
        x[1::7, : k // 2] = -np.inf
    elif kind == "signed_zeros":
        x = rng.choice(np.array([0.0, -0.0, -np.inf, 0.5], np.float32),
                       (r, k))
    return x


def _assert_bitwise(x, t, row_block):
    want_v, want_c = jax_row_topk(jnp.asarray(x), t, row_block=row_block,
                                  interpret=True)
    got_v, got_c = row_topk_plain(torch.from_numpy(x), t)
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("kind,r,k,t", [
    ("random", 48, 96, 8),
    ("random", 16, 40, 40),      # K not a multiple of 32, t == K
    ("ties", 32, 64, 64),        # t == K: every slot of a tied row
    ("ties", 16, 37, 12),
    ("masked", 48, 130, 64),     # empty slots after the finite values
    ("masked", 16, 33, 33),
    ("signed_zeros", 16, 40, 40),
])
def test_plain_matches_pallas_bitwise(kind, r, k, t):
    _assert_bitwise(_rows(kind, r, k, seed=r + k + t), t,
                    row_block=16 if r % 16 == 0 else 8)


def test_empty_slots_pick_lowest_neg_inf_index():
    x = np.full((8, 6), -np.inf, np.float32)
    x[:, 2] = 0.5
    x[:, 4] = 0.25
    vals, cls = row_topk_plain(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(cls[0].numpy(), [2, 4, 0, 0, 0, 0])
    assert torch.isinf(vals[0, 2:]).all()
    _assert_bitwise(x, 6, row_block=8)


def test_wrapper_sends_cpu_tensor_to_plain(monkeypatch):
    monkeypatch.setattr(row_topk, "launches", 0)
    x = torch.from_numpy(_rows("masked", 24, 50, seed=3))
    got = row_topk(x, 16)
    want = row_topk_plain(x, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert row_topk.launches == 0     # no kernel launch on the CPU


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        row_topk(torch.zeros((2, 4), device="meta"), 2)
