"""The port's flash attention backward (`ops/flash_gqa.py` K2-bwd,
`ops/flash_attention.py` K3-bwd): the plain backward versions, which the
autograd Functions run on CPU tensors, against the JAX kernels'
gradients on the same inputs, on the CPU.

- K2: `jax.grad` through the JAX package's Pallas kernel in interpret
  mode (the real dq and dk/dv kernel code), f32 within 1e-5 (summation
  order only), bf16 within 2e-2 of the gradient's magnitude (both round
  p and ds to bf16 before their products; a value may land one bf16 ulp
  apart, 2^-8 relative, and the sums carry a few such).
- K3: `jax.grad` of the stock kernel's own autograd reference
  (`mha_reference_no_custom_vjp` with `SegmentIds`, pad rows attending
  pad keys as the kernel does), and autograd of the port's einsum
  reference on real rows.
- torch.autograd.gradcheck of both Functions in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wedetect_tpu.ops.flash_gqa import gqa_flash_attention as j_gqa
from wedetect_tpu_torch.ops import attention as TA
from wedetect_tpu_torch.ops import flash_attention as fa
from wedetect_tpu_torch.ops import flash_gqa as fg

# (B, S, Lk, H, KVH, D, causal, masked): tests/test_flash_gqa.py's
# test_grad_agreement cases, square causal, and non-causal
K2_CASES = [
    (2, 128, 384, 4, 2, 128, True, False),
    (2, 128, 640, 8, 2, 128, True, True),
    (1, 128, 128, 4, 1, 128, True, False),
    (1, 256, 256, 8, 8, 128, False, True),
]


def _k2_inputs(case, seed):
    b, s, lk, h, kvh, d, causal, masked = case
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal(sh).astype(np.float32)
                  for sh in ((b, s, h, d), (b, lk, kvh, d), (b, lk, kvh, d),
                             (b, s, h, d)))
    valid = None
    if masked:
        valid = np.ones((b, lk), np.int32)
        valid[:, lk // 2 - 8:lk // 2] = 0
        valid[:, -5:] = 0
    return q, k, v, w, valid


def _jax_k2_grads(q, k, v, w, valid, causal, dtype=jnp.float32):
    kv = None if valid is None else jnp.asarray(valid)

    def loss(q, k, v):
        o = j_gqa(q, k, v, causal=causal, kv_valid=kv)
        return jnp.sum(o.astype(jnp.float32) * w)

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_k2_grads(q, k, v, w, valid, causal, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    kv = None if valid is None else torch.from_numpy(valid)
    scale = q.shape[-1] ** -0.5
    o, lse = fg.gqa_flash_attention_plain(*t, causal=causal, kv_valid=kv,
                                          sm_scale=scale, return_lse=True)
    do = torch.from_numpy(w).to(dtype)
    return fg.gqa_flash_attention_bwd_plain(*t, kv, o, lse, do, causal,
                                            scale)


@pytest.mark.parametrize("case", K2_CASES,
                         ids=["rect_g2", "rect_g4_m", "square", "noncausal"])
def test_k2_plain_backward_matches_jax_kernel(case):
    q, k, v, w, valid = _k2_inputs(case, seed=sum(case[:3]))
    want = _jax_k2_grads(q, k, v, w, valid, case[6])
    got = _port_k2_grads(q, k, v, w, valid, case[6])
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), x, atol=1e-5, rtol=1e-5)


def test_k2_plain_backward_bf16_matches_jax_kernel():
    case = K2_CASES[1]
    q, k, v, w, valid = _k2_inputs(case, seed=5)
    want = _jax_k2_grads(q, k, v, w, valid, True, jnp.bfloat16)
    got = _port_k2_grads(q, k, v, w, valid, True, torch.bfloat16)
    for g, x in zip(got, want):
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - x).max()
        assert err <= 2e-2 * np.abs(x).max(), err


@pytest.mark.parametrize("case", K2_CASES[1:3], ids=["rect_g4_m", "square"])
def test_k2_plain_backward_matches_autograd(case):
    """On rows with a visible valid key (all rows here) the plain
    backward is the gradient of the plain forward."""
    q, k, v, w, valid = _k2_inputs(case, seed=11)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    kv = None if valid is None else torch.from_numpy(valid)
    o = fg.gqa_flash_attention_plain(*t, causal=case[6], kv_valid=kv)
    want = torch.autograd.grad((o * torch.from_numpy(w)).sum(), t)
    got = _port_k2_grads(q, k, v, w, valid, case[6])
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, atol=1e-5, rtol=1e-5)


def test_k2_function_runs_plain_backward_on_cpu():
    """gqa_flash_attention on CPU tensors: the autograd Function's
    gradients are the plain backward's, through the attention dispatch."""
    case = K2_CASES[0]
    q, k, v, w, valid = _k2_inputs(case, seed=2)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = TA.gqa_attention(*t, causal=True, impl="flash")
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), t)
    want = _port_k2_grads(q, k, v, w, valid, True)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def _k3_inputs(b, l, h, d, n_real, seed):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((b, l, h, d)).astype(np.float32)
                  for _ in range(4))
    seg = np.broadcast_to((np.arange(l) < n_real).astype(np.int32),
                          (b, l)).copy()
    return q, k, v, w, seg


def _port_k3_grads(q, k, v, w, seg, causal, scale):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    s = torch.from_numpy(seg)
    kw = dict(q_segment_ids=s, kv_segment_ids=s, causal=causal,
              sm_scale=scale)
    o, lse = fa.flash_attention_plain(*t, return_lse=True, **kw)
    return fa.flash_attention_bwd_plain(*t, o, lse, torch.from_numpy(w),
                                        **kw)


@pytest.mark.parametrize("b,l,h,d,n_real,causal", [
    (1, 256, 2, 64, 200, False), (2, 128, 2, 64, 128, True),
    (1, 128, 1, 128, 100, False)])
def test_k3_plain_backward_matches_stock_reference(b, l, h, d, n_real,
                                                   causal):
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds, mha_reference_no_custom_vjp)

    q, k, v, w, seg = _k3_inputs(b, l, h, d, n_real, seed=l + h)
    scale = d ** -0.5
    ids = jnp.asarray(seg)

    def loss(q, k, v):
        o = mha_reference_no_custom_vjp(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), segment_ids=SegmentIds(q=ids, kv=ids),
            causal=causal, sm_scale=scale)
        return jnp.sum(o.transpose(0, 2, 1, 3) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_k3_grads(q, k, v, w, seg, causal, scale)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-5,
                                   rtol=1e-5)


def test_k3_plain_backward_matches_einsum_on_real_rows():
    """With dO zero on pad rows (the ViT drops them), the gradients equal
    those of the einsum reference, which masks pad keys for every row."""
    b, l, h, d, n_real = 1, 256, 2, 64, 200
    q, k, v, w, seg = _k3_inputs(b, l, h, d, n_real, seed=3)
    w[:, n_real:] = 0
    scale = d ** -0.5
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = TA._reference_attention(*t, causal=False,
                                kv_valid=torch.from_numpy(seg),
                                sm_scale=scale)
    want = torch.autograd.grad((o * torch.from_numpy(w)).sum(), t)
    got = _port_k3_grads(q, k, v, w, seg, False, scale)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_gqa_function(causal):
    rng = np.random.default_rng(int(causal))
    q, k, v = (torch.from_numpy(rng.standard_normal(sh)).requires_grad_()
               for sh in ((1, 8, 2, 128), (1, 128, 1, 128),
                          (1, 128, 1, 128)))
    valid = torch.ones((1, 128), dtype=torch.int32)
    valid[:, 60:70] = 0
    assert torch.autograd.gradcheck(
        lambda q, k, v: fg.gqa_flash_attention(q, k, v, causal=causal,
                                               kv_valid=valid),
        (q, k, v), fast_mode=True)


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_flash_function(causal):
    rng = np.random.default_rng(2 + int(causal))
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, 8)))
               .requires_grad_() for _ in range(3))
    seg = (torch.arange(16) < 12).to(torch.int32)[None]
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention(q, k, v, q_segment_ids=seg,
                                           kv_segment_ids=seg,
                                           causal=causal, sm_scale=0.3),
        (q, k, v), fast_mode=True)
