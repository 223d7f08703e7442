"""The port's PRNG twin (`wedetect_tpu_torch/ops/prng.py`) against
`jax.random` (threefry2x32, partitionable) on the CPU.

Keys, `fold_in`, `split`, random bits and uniforms are bitwise equal at
odd shapes and at the vocabulary width of ref_2b (151936); Gumbel draws
are within 2 ulp of max(|x|, 1), the scale of the inner logarithm
(torch's and XLA's logarithms differ in the last bit);
categorical draws and the serving sampler `_sample_rows` (top-k, then
top-p) pick the same tokens as JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_ref_util import one_torch_thread  # noqa: F401 (autouse)
from wedetect_tpu.models.serve import _sample_rows as j_sample_rows
from wedetect_tpu_torch.models.serve import _sample_rows
from wedetect_tpu_torch.ops import prng

SEEDS = [0, 5, 1234567, 2**31 - 1, -1, -7]
VOCAB = 151936


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_bitwise(seed):
    k, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(k))
    for d in (0, 1, 17, 2**31 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      _np(jax.random.fold_in(k, d)))
    for n in (2, 3, 7):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                      _np(jax.random.split(k, n)))
    # a chain: split, then fold_in of the second half
    a, b = jax.random.split(k)
    ta, tb = prng.split(tk)
    np.testing.assert_array_equal(prng.fold_in(tb, 9).numpy(),
                                  _np(jax.random.fold_in(b, 9)))
    np.testing.assert_array_equal(ta.numpy(), _np(a))


def test_batched_keys_match_per_key():
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    idx = torch.arange(len(SEEDS), dtype=torch.int32) * 3
    got = prng.fold_in(prng.PRNGKey(seeds), idx).numpy()
    want = np.stack([_np(jax.random.fold_in(jax.random.PRNGKey(s), int(i)))
                     for s, i in zip(SEEDS, idx)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (2, 3, 5),
                                   (2, VOCAB)])
def test_bits_and_uniform_bitwise(shape):
    k = jax.random.PRNGKey(3)
    tk = prng.PRNGKey(3)
    np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(),
                                  _np(jax.random.bits(k, shape)))
    want = np.asarray(jax.random.uniform(k, shape))
    got = prng.uniform(tk, shape).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want = np.asarray(jax.random.uniform(k, shape, minval=-2.0, maxval=3.0))
    got = prng.uniform(tk, shape, -2.0, 3.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_gumbel_within_two_ulp():
    k = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.gumbel(k, (4, VOCAB)))
    got = prng.gumbel(prng.PRNGKey(11), (4, VOCAB)).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 2 * ulp).all(), \
        float((np.abs(got - want) / ulp).max())


def test_categorical_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, VOCAB)).astype(np.float32) * 2
    for seed in (1, 2, 3):
        want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                                 logits))
        got = prng.categorical(prng.PRNGKey(seed), torch.tensor(logits))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sampling", [(0.0, 0, 1.0), (1.0, 0, 1.0),
                                      (0.8, 50, 1.0), (0.8, 0, 0.9),
                                      (0.7, 20, 0.8)])
def test_sample_rows_matches_jax(sampling):
    """The serving sampler over 16 rows of a 2000-token vocabulary with
    per-row seeds and token indices, and a row of exact ties at the
    top-k cut: the same tokens as JAX's."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((16, 2000)).astype(np.float32) * 3
    logits[3, :60] = 5.0                       # ties across the k-th value
    seeds = rng.integers(-2**31, 2**31 - 1, 16).astype(np.int32)
    idx = rng.integers(0, 500, 16).astype(np.int32)
    want = np.asarray(j_sample_rows(jnp.asarray(logits), sampling,
                                    jnp.asarray(seeds), jnp.asarray(idx)))
    got = _sample_rows(torch.tensor(logits), sampling, torch.tensor(seeds),
                       torch.tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)
