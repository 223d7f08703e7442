"""The port's row top-k (K1) against the JAX Pallas kernel run in
interpret mode on the CPU. The contract is bitwise: vals and cls must be
equal on every slot, empty (-inf) slots included. Both `row_topk_plain`
(t rounds of iterative max) and `row_topk_by_key` (the CUDA kernel's
rule: one stable sort by order-preserving key) are held to it. The CUDA
kernel itself is held to both on the card by chip_smoke.py and
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wedetect_tpu.ops.pallas_topk import row_topk as jax_row_topk
from wedetect_tpu_torch.ops.row_topk import (order_keys, row_topk,
                                             row_topk_by_key, row_topk_plain)


def _rows(kind, r, k, seed, t=64):
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
    elif kind == "zero_example":  # -0 at 0, 1, 5 and +0 at 2: +0 +0 +0 -0
        x = np.full((r, k), -np.inf, np.float32)
        x[:, [0, 1, 5]] = -0.0
        x[:, 2] = 0.0
        x[1::2, 3] = 0.25           # a value above the zeros
        x[2::4, 7] = 0.0            # the last +0 after every -0
    elif kind == "inf":           # +inf is a candidate, -inf is not
        x = rng.choice(np.array([np.inf, -np.inf, 0.5, 0.25, -1.0],
                                np.float32), (r, k))
        x[::4] = -np.inf
        x[::4, ::9] = np.inf
    elif kind == "sparse":        # the detect path: 0-63 candidates a row
        x = np.full((r, k), -np.inf, np.float32)
        for i in range(r):
            n = 0 if i % 3 == 0 else int(rng.integers(1, 64))
            pos = rng.choice(k, n, replace=False)
            x[i, pos] = rng.uniform(0.3, 1, n)
            if i % 4 == 1:          # ties among the candidates
                x[i, pos] = np.floor(x[i, pos] * 8) / 8
    elif kind == "boundary":      # exactly t, then t + 1 candidates
        x = np.full((r, k), -np.inf, np.float32)
        for i in range(r):
            n = min(t + i % 2, k)
            pos = rng.choice(k, n, replace=False)
            x[i, pos] = np.floor(rng.uniform(0, 1, n) * 3) / 3
    elif kind == "cut_tie":       # dense; the t-th value tied across the cut
        x = rng.uniform(0, 0.2, (r, k)).astype(np.float32)
        for i in range(r):
            perm = rng.permutation(k)
            x[i, perm[:t // 2]] = rng.uniform(0.5, 1, t // 2)
            x[i, perm[t // 2:t // 2 + t]] = 0.25  # ranks t // 2 .. t + t // 2
            x[i, perm[t // 2 + t::3]] = -np.inf
    return x


def _keys(x):
    return order_keys(torch.from_numpy(x)).numpy()


def _nan(bits):
    return np.array([bits], np.uint32).view(np.float32)[0]


PNAN, MNAN = _nan(0x7FC00000), _nan(0xFFC00000)


def _nan_rows(kind, k, seed):
    """Rows of 8 that hold NaNs among finite values, +-inf and +-0."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (8, k)).astype(np.float32)
    x[:, 1::3] = -np.inf
    x[1::2, 4] = np.inf
    x[::3, 5], x[1::3, 6] = 0.0, -0.0
    if kind == "plus":            # one +nan
        x[:, 7] = PNAN
    elif kind == "minus":         # one -nan (0xffc00000): its bits kept
        x[:, 7] = MNAN
    elif kind == "beside_inf_zero":
        x[:, :4] = [np.inf, -np.inf, 0.0, -0.0]
        x[:, 4] = PNAN
        x[1::2, 4] = MNAN
    elif kind == "last_lane":
        x[:, -1] = MNAN
        x[::2, -1] = PNAN
    elif kind == "payloads":      # several NaNs of either sign per row
        bits = x.view(np.uint32)
        for i in range(8):
            pos = rng.choice(k, 1 + i % 5, replace=False)
            sign = rng.integers(0, 2, len(pos)).astype(np.uint32) << 31
            bits[i, pos] = sign | 0x7F800000 | rng.integers(
                1, 1 << 23, len(pos)).astype(np.uint32)
    x[7] = rng.uniform(0, 1, k)   # one row without a NaN
    return x


def _assert_bitwise(x, t, row_block, fn=row_topk_plain):
    want_v, want_c = jax_row_topk(jnp.asarray(x), t, row_block=row_block,
                                  interpret=True)
    got_v, got_c = fn(torch.from_numpy(x), t)
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


CASES = [
    ("random", 48, 96, 8),
    ("random", 16, 40, 40),      # K not a multiple of 32, t == K
    ("ties", 32, 64, 64),        # t == K: every slot of a tied row
    ("ties", 16, 37, 12),
    ("masked", 48, 130, 64),     # empty slots after the finite values
    ("masked", 16, 33, 33),
    ("signed_zeros", 16, 40, 40),
]
# what selection by key must also get right: the sort, the branch
# boundary (n = t against n = t + 1), the cut inside a run of ties, and
# the extremes of t
KEY_CASES = [
    ("zero_example", 8, 12, 12),
    ("signed_zeros", 16, 96, 9),  # a cut inside the zeros
    ("inf", 16, 50, 20),
    ("sparse", 48, 200, 64),
    ("boundary", 16, 100, 64),
    ("boundary", 16, 40, 7),
    ("cut_tie", 16, 300, 64),
    ("cut_tie", 8, 90, 5),
    ("random", 16, 70, 1),       # t = 1
    ("masked", 16, 70, 1),
    ("masked", 16, 150, 150),    # t = K > 64: the kernel's slot chunks
    ("cut_tie", 8, 200, 130),
]


@pytest.mark.parametrize("kind,r,k,t", CASES + KEY_CASES)
def test_plain_matches_pallas_bitwise(kind, r, k, t):
    _assert_bitwise(_rows(kind, r, k, seed=r + k + t, t=t), t,
                    row_block=16 if r % 16 == 0 else 8)


@pytest.mark.parametrize("kind,r,k,t", CASES + KEY_CASES)
def test_by_key_matches_pallas_bitwise(kind, r, k, t):
    """Selection by key (the CUDA kernel's rule) equals t rounds of
    iterative max, bit for bit."""
    _assert_bitwise(_rows(kind, r, k, seed=r + k + t, t=t), t,
                    row_block=16 if r % 16 == 0 else 8, fn=row_topk_by_key)


def test_key_cases_reach_both_branches():
    """The cases above hold rows with at most t candidates and rows with
    more, rows of exactly t and t + 1, and ties across the cut."""
    counts = {}
    for kind, r, k, t in KEY_CASES:
        n = (_keys(_rows(kind, r, k, seed=r + k + t, t=t)) > 0x007FFFFF).sum(1)
        counts.setdefault(kind, set()).update(
            ("empty" if c == 0 else "sparse" if c <= t else "dense")
            for c in n)
    assert counts["sparse"] == {"empty", "sparse"}
    assert counts["boundary"] == {"sparse", "dense"}
    assert counts["cut_tie"] == {"dense"}
    x = _rows("boundary", 16, 100, seed=180, t=64)
    assert sorted(set((_keys(x) > 0x007FFFFF).sum(1))) == [64, 65]
    x = _rows("cut_tie", 16, 300, seed=380, t=64)
    kth = np.sort(x, axis=1)[:, ::-1][:, 63]
    assert (kth == 0.25).all() and ((x == 0.25).sum(1) == 64).all()


def test_order_keys_order_the_values():
    v = np.array([-np.inf, -3.0, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf],
                 np.float32)
    key = _keys(v[None])[0]
    assert key[0] == 0x007FFFFF and key[3] == key[4]
    assert (np.diff(key[[0, 1, 2, 4, 5, 6, 7]]) > 0).all()


@pytest.mark.parametrize("kind,k,t", [
    ("plus", 40, 8), ("minus", 40, 40), ("beside_inf_zero", 33, 5),
    ("last_lane", 37, 37), ("last_lane", 96, 1), ("payloads", 130, 64),
])
def test_nan_rows_match_pallas_bitwise(kind, k, t):
    """A row with a NaN: every slot (that NaN, K), the NaN's bits kept;
    of several NaNs, the lowest-index negative one, else the last."""
    x = _nan_rows(kind, k, seed=k + t)
    _assert_bitwise(x, t, row_block=8)
    _assert_bitwise(x, t, row_block=8, fn=row_topk_by_key)
    vals, cls = row_topk_plain(torch.from_numpy(x), t)
    assert (cls[:7] == k).all() and torch.isnan(vals[:7]).all()
    assert not torch.isnan(vals[7]).any()


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
    with pytest.raises(ValueError):   # branch counts are the kernel's
        row_topk(x, 16, branches=torch.zeros(4, dtype=torch.int32))


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        row_topk(torch.zeros((2, 4), device="meta"), 2)
