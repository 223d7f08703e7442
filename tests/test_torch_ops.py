"""The port's box ops against the JAX package: priors exact (they are
the same numpy code), distance2bbox exact (elementwise adds),
dfl_expectation to 1e-6 (a 16-term f32 sum in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wedetect_tpu.ops import boxes as jboxes
from wedetect_tpu.ops import dfl as jdfl
from wedetect_tpu.ops import priors as jpriors
from wedetect_tpu_torch.ops import boxes as tboxes
from wedetect_tpu_torch.ops import dfl as tdfl
from wedetect_tpu_torch.ops import priors as tpriors


@pytest.mark.parametrize("img", [(64, 64), (640, 640), (96, 160)])
def test_priors_exact(img):
    strides = (8, 16, 32)
    sizes = [(img[0] // s, img[1] // s) for s in strides]
    for a, b in zip(jpriors.flat_priors_and_strides(sizes, strides),
                    tpriors.flat_priors_and_strides(sizes, strides)):
        np.testing.assert_array_equal(a, b)


def test_distance2bbox_exact():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 640, (2, 100, 2)).astype(np.float32)
    dist = rng.uniform(0, 200, (2, 100, 4)).astype(np.float32)
    want = jboxes.distance2bbox(jnp.asarray(pts), jnp.asarray(dist))
    got = tboxes.distance2bbox(torch.from_numpy(pts), torch.from_numpy(dist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("reg_max", [16, 8])
def test_dfl_expectation(reg_max):
    rng = np.random.default_rng(reg_max)
    logits = (3 * rng.standard_normal((2, 50, 4 * reg_max))).astype(
        np.float32)
    want = jdfl.dfl_expectation(jnp.asarray(logits), reg_max)
    got = tdfl.dfl_expectation(torch.from_numpy(logits), reg_max)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
