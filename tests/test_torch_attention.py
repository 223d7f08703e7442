"""The port's attention dispatch (`wedetect_tpu_torch/ops/attention.py`)
and K3's plain version (`ops/flash_attention.py`) against the JAX
package on the CPU.

The einsum routes repeat the JAX arithmetic (f32 logits, -1e9 bias):
1e-6. K3's plain version is held to JAX `_reference_attention` on real
rows only: pad rows attend pad keys in the flash kernels and real keys
in the einsum, by design (tests/test_tpu_kernels.py:5-10); 1e-5 for the
other summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wedetect_tpu.ops import attention as JA
from wedetect_tpu_torch.ops import attention as TA
from wedetect_tpu_torch.ops import flash_attention as TF
from wedetect_tpu_torch.ops import flash_gqa as TG


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _valid(b, lk, holes):
    m = np.ones((b, lk), np.int32)
    if holes:
        m[:, -3:] = 0
        m[-1, lk // 2:lk // 2 + 2] = 0
    return m


# (B, Lq, Lk, H, KVH, D, causal, masked)
EINSUM_CASES = [
    (2, 9, 9, 4, 4, 8, False, False),
    (2, 9, 9, 4, 4, 8, False, True),
    (2, 9, 9, 4, 2, 8, True, True),
    (2, 5, 12, 6, 2, 16, True, False),     # rectangular, end-aligned
    (3, 5, 12, 6, 3, 16, True, True),
    (1, 7, 7, 2, 1, 8, True, True),
]


@pytest.mark.parametrize("fn", ["dot_product_attention", "gqa_attention"])
@pytest.mark.parametrize("b,lq,lk,h,kvh,d,causal,masked", EINSUM_CASES)
def test_einsum_routes_match_jax(fn, b, lq, lk, h, kvh, d, causal, masked):
    if fn == "dot_product_attention":
        kvh = h
        if lq != lk and not causal:
            pytest.skip("rectangular is causal only")
    rng = np.random.default_rng(lq * 100 + lk + h)
    q = _rand(rng, b, lq, h, d)
    k = _rand(rng, b, lk, kvh, d)
    v = _rand(rng, b, lk, kvh, d)
    valid = _valid(b, lk, masked) if masked else None
    want = getattr(JA, fn)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_valid=None if valid is None else jnp.asarray(valid),
        impl="einsum")
    for impl in ("einsum", "auto"):          # auto on a CPU tensor: einsum
        got = getattr(TA, fn)(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal,
            kv_valid=None if valid is None else torch.from_numpy(valid),
            impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("l,n_real,causal", [(256, 200, False),
                                             (128, 128, True),
                                             (256, 250, True)])
def test_flash_attention_plain_matches_reference_on_real_rows(l, n_real,
                                                              causal):
    rng = np.random.default_rng(l + n_real)
    b, h, d = 2, 4, 64
    q, k, v = (_rand(rng, b, l, h, d) for _ in range(3))
    valid = (np.arange(l) < n_real).astype(np.int32)[None].repeat(b, 0)
    want = JA._reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_valid=jnp.asarray(valid), sm_scale=d ** -0.5)
    seg = torch.from_numpy(valid)
    got = TF.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
        sm_scale=d ** -0.5)
    np.testing.assert_allclose(got[:, :n_real].numpy(),
                               np.asarray(want)[:, :n_real], atol=1e-5,
                               rtol=1e-5)
    # a pad row attends the pad keys only
    if n_real < l and not causal:
        pad = JA._reference_attention(
            *(jnp.asarray(t[:, n_real:]) for t in (q, k, v)), causal=False,
            kv_valid=None, sm_scale=d ** -0.5)
        np.testing.assert_allclose(got[:, n_real:].numpy(),
                                   np.asarray(pad), atol=1e-5, rtol=1e-5)


def _count(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    return calls


def test_flash_impl_on_cpu_runs_the_plain_versions(monkeypatch):
    k3 = _count(monkeypatch, TF, "flash_attention_plain")
    k2 = _count(monkeypatch, TG, "gqa_flash_attention_plain")
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_rand(rng, 1, 128, 4, 128))
    k = torch.from_numpy(_rand(rng, 1, 256, 2, 128))
    v = torch.from_numpy(_rand(rng, 1, 256, 2, 128))
    out = TA.gqa_attention(q, k, v, causal=True, impl="flash")
    want = TA.gqa_attention(q, k, v, causal=True, impl="einsum")
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5)
    assert k2 == [1] and k3 == []
    # square ViT attention, and rectangular causal through front padding
    x = torch.from_numpy(_rand(rng, 1, 128, 2, 64))
    y = torch.from_numpy(_rand(rng, 1, 256, 2, 64))
    TA.dot_product_attention(x, x, x, impl="flash")
    rect = TA.dot_product_attention(x, y, y, causal=True, impl="flash")
    want = TA.dot_product_attention(x, y, y, causal=True, impl="einsum")
    np.testing.assert_allclose(rect.numpy(), want.numpy(), atol=1e-5)
    assert k3 == [1, 1] and k2 == [1]


def test_flash_impl_raises_on_untileable_shapes_as_jax():
    rng = np.random.default_rng(1)
    x = _rand(rng, 1, 100, 2, 64)
    y = _rand(rng, 1, 120, 2, 64)
    cases = [
        ("dot_product_attention", (x, x, x), dict(causal=False)),
        ("dot_product_attention", (x, y, y), dict(causal=False)),
        ("gqa_attention", (_rand(rng, 1, 128, 4, 64),
                           _rand(rng, 1, 128, 2, 64),
                           _rand(rng, 1, 128, 2, 64)), dict(causal=True)),
    ]
    for fn, args, kw in cases:
        with pytest.raises(ValueError):
            getattr(JA, fn)(*(jnp.asarray(a) for a in args), impl="flash",
                            **kw)
        with pytest.raises(ValueError):
            getattr(TA, fn)(*(torch.from_numpy(a) for a in args),
                            impl="flash", **kw)


def test_tileability_matches_jax():
    for n in (64, 100, 128, 256, 384, 640, 1000, 1024, 1280, 1536):
        assert TA._pick_block(n) == JA._pick_block(n)
        assert TA.is_flash_tileable(n) == JA.is_flash_tileable(n)
