"""Head dims beyond the presets' 64 and 128, on the CPU: the plain
versions of K2 and K3 (which the kernels are held to on the card) at the
widths the card now computes, and the padding that carries a K3 width
the SIMT kernels are not built for to one they are.

- K2 at D = 384 (JAX tiles any D % 128 == 0): the forward and the
  gradients against the JAX package's Pallas kernel in interpret mode,
  f32 within 2e-5 (forward) and 1e-5 (gradients), summation order only.
- K3 at D = 72 and 80 (Qwen2.5-VL's ViT has 1280 / 16 = 80): the
  forward and the gradients against the stock kernel's reference
  (`mha_reference_no_custom_vjp`), f32 within 1e-5.
- Padding: the plain versions on zero-padded q, k, v (and dO), sliced
  back, against the unpadded ones, within 1e-6 (the sums gain zero terms,
  which may regroup them); the padded columns of O, dq, dk and dv are
  exactly 0.
- The limit: above 512 the card's checks raise before any launch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wedetect_tpu.ops.flash_gqa import gqa_flash_attention as j_gqa
from wedetect_tpu_torch.ops import flash_attention as fa
from wedetect_tpu_torch.ops import flash_gqa as fg


def _k2_inputs(b, s, lk, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, d), (b, lk, kvh, d), (b, lk, kvh, d),
                       (b, s, h, d))]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_k2_plain_matches_pallas_kernel_at_d384(causal):
    b, s, lk, h, kvh, d = 1, 128, 256, 2, 1, 384
    q, k, v, w = _k2_inputs(b, s, lk, h, kvh, d, seed=384 + causal)
    valid = np.ones((b, lk), np.int32)
    valid[:, 120:136] = 0
    jv = jnp.asarray(valid)

    def loss(q, k, v):
        return jnp.sum(j_gqa(q, k, v, causal=causal, kv_valid=jv) * w)

    jargs = [jnp.asarray(x) for x in (q, k, v)]
    want_o = np.asarray(j_gqa(*jargs, causal=causal, kv_valid=jv))
    want_g = jax.grad(loss, argnums=(0, 1, 2))(*jargs)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    tv = torch.from_numpy(valid)
    o, lse = fg.gqa_flash_attention_plain(*t, causal=causal, kv_valid=tv,
                                          return_lse=True)
    np.testing.assert_allclose(o.numpy(), want_o, atol=2e-5, rtol=2e-5)
    got_g = fg.gqa_flash_attention_bwd_plain(*t, tv, o, lse,
                                             torch.from_numpy(w), causal,
                                             d ** -0.5)
    for g, x in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-5,
                                   rtol=1e-5)


def _k3_inputs(l, h, d, n_real, seed):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((1, l, h, d)).astype(np.float32)
                  for _ in range(4))
    seg = (np.arange(l) < n_real).astype(np.int32)[None]
    return q, k, v, w, seg


@pytest.mark.parametrize("d,causal", [(72, False), (80, False), (80, True)])
def test_k3_plain_matches_stock_reference_at_odd_dims(d, causal):
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds, mha_reference_no_custom_vjp)

    l, h = 256, 2
    q, k, v, w, seg = _k3_inputs(l, h, d, 200, seed=d)
    ids = jnp.asarray(seg)
    scale = d ** -0.5

    def ref(q, k, v):
        return mha_reference_no_custom_vjp(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), segment_ids=SegmentIds(q=ids, kv=ids),
            causal=causal, sm_scale=scale).transpose(0, 2, 1, 3)

    jargs = [jnp.asarray(x) for x in (q, k, v)]
    want_o = np.asarray(ref(*jargs))
    want_g = jax.grad(lambda *a: jnp.sum(ref(*a) * w),
                      argnums=(0, 1, 2))(*jargs)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    s = torch.from_numpy(seg)
    kw = dict(q_segment_ids=s, kv_segment_ids=s, causal=causal,
              sm_scale=scale)
    o, lse = fa.flash_attention_plain(*t, return_lse=True, **kw)
    np.testing.assert_allclose(o.numpy(), want_o, atol=1e-5, rtol=1e-5)
    got_g = fa.flash_attention_bwd_plain(*t, o, lse, torch.from_numpy(w),
                                         **kw)
    for g, x in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("d,width", [(1, 64), (32, 64), (64, 64),
                                     (72, 128), (80, 128), (200, 256),
                                     (300, 384), (384, 384), (500, 512),
                                     (512, 512)])
def test_simt_head_dim(d, width):
    assert fa.simt_head_dim(d) == width


@pytest.mark.parametrize("d", [513, 640, 1024])
def test_simt_head_dim_raises_above_512(d):
    with pytest.raises(ValueError, match="up to 512"):
        fa.simt_head_dim(d)


@pytest.mark.parametrize("d,causal", [(32, False), (72, True), (80, False)])
def test_k3_padded_plain_equals_unpadded(d, causal):
    """The SIMT launch's padding: the plain forward and backward on q, k,
    v and dO zero-padded to simt_head_dim(d), at the caller's sm_scale,
    sliced back, equal the unpadded ones; the padded columns are 0."""
    l, h = 192, 2
    q, k, v, w, seg = _k3_inputs(l, h, d, 150, seed=d + 1)
    t = [torch.from_numpy(x) for x in (q, k, v, w)]
    s = torch.from_numpy(seg)
    kw = dict(q_segment_ids=s, kv_segment_ids=s, causal=causal,
              sm_scale=d ** -0.5)
    width = fa.simt_head_dim(d)
    padded = fa.pad_head_dim(width, *t)
    assert all(x.shape[-1] == width for x in padded)
    assert all(torch.equal(x[..., :d], y) for x, y in zip(padded, t))
    o, lse = fa.flash_attention_plain(*t[:3], return_lse=True, **kw)
    po, plse = fa.flash_attention_plain(*padded[:3], return_lse=True, **kw)
    torch.testing.assert_close(po[..., :d], o, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(plse, lse, atol=1e-6, rtol=1e-6)
    grads = fa.flash_attention_bwd_plain(*t[:3], o, lse, t[3], **kw)
    pgrads = fa.flash_attention_bwd_plain(*padded[:3], po, plse, padded[3],
                                          **kw)
    for x in (po, *pgrads):
        assert not x[..., d:].any()
    for g, pg in zip(grads, pgrads):
        torch.testing.assert_close(pg[..., :d], g, atol=1e-6, rtol=1e-6)


def test_k3_check_raises_above_512():
    """The K3 wrappers' input check (run before any launch) names the
    limit; at 512 it passes."""
    x = torch.zeros((1, 128, 1, 520))
    with pytest.raises(ValueError, match="up to 512"):
        fa._check_cuda("flash_attention", x, x, x)
    y = torch.zeros((1, 128, 1, 512))
    fa._check_cuda("flash_attention", y, y, y)


@pytest.mark.parametrize("d", [384, 512, 640])
def test_k2_supports_is_jax_rule_and_the_card_check_limits_it(d):
    """`supports` stays JAX's rule (any D % 128 == 0), so the decoder
    routes alike in both packages; the card's check takes every such D
    up to 512 and raises above it, before any launch."""
    from wedetect_tpu.ops.flash_gqa import supports as j_supports

    assert fg.supports(128, 256, d, 2) == j_supports(128, 256, d, 2) is True
    q = torch.zeros((1, 128, 4, d))
    k = torch.zeros((1, 256, 2, d))
    if d <= 512:
        fg._check_cuda("gqa_flash_attention", q, k, k)
    else:
        with pytest.raises(ValueError, match="at most 512"):
            fg._check_cuda("gqa_flash_attention", q, k, k)
