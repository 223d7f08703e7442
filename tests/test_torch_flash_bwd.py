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
    (1, 128, 256, 4, 2, 256, True, True),     # D = 256 (the SIMT route)
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
                         ids=["rect_g2", "rect_g4_m", "square", "noncausal",
                              "d256"])
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


# three segments with boundaries off the 64-grid, then pad (segment 0):
# ids 1 on [0, 100), 2 on [100, 300), 3 on [300, 480), 0 on [480, 512)
K3_THREE_SEGMENTS = ((100, 1), (300, 2), (480, 3))


def _k3_ids(l, n_real):
    """Segment ids (l,): n_real real tokens in segment 1 and pad in 0, or
    for a tuple of (end, id) runs, each run's id up to its end, then 0."""
    runs = ((n_real, 1),) if isinstance(n_real, int) else n_real
    ids = np.zeros(l, np.int32)
    start = 0
    for end, sid in runs:
        ids[start:end] = sid
        start = end
    return ids


def _k3_inputs(b, l, h, d, n_real, seed):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((b, l, h, d)).astype(np.float32)
                  for _ in range(4))
    seg = np.broadcast_to(_k3_ids(l, n_real), (b, l)).copy()
    return q, k, v, w, seg


def _port_k3_grads(q, k, v, w, seg, causal, scale, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    s = torch.from_numpy(seg)
    kw = dict(q_segment_ids=s, kv_segment_ids=s, causal=causal,
              sm_scale=scale)
    o, lse = fa.flash_attention_plain(*t, return_lse=True, **kw)
    return fa.flash_attention_bwd_plain(
        *t, o, lse, torch.from_numpy(w).to(dtype), **kw)


def _stock_k3_grads(q, k, v, w, seg, causal, scale, dtype=jnp.float32):
    """jax.grad of the stock kernel's autograd reference, in `dtype`."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds, mha_reference_no_custom_vjp)

    ids = jnp.asarray(seg)

    def loss(q, k, v):
        o = mha_reference_no_custom_vjp(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), segment_ids=SegmentIds(q=ids, kv=ids),
            causal=causal, sm_scale=scale)
        return jnp.sum(o.transpose(0, 2, 1, 3).astype(jnp.float32) * w)

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


@pytest.mark.parametrize("b,l,h,d,n_real,causal", [
    (1, 256, 2, 64, 200, False), (2, 128, 2, 64, 128, True),
    (1, 128, 1, 128, 100, False), (1, 128, 2, 256, 100, False),
    (1, 512, 2, 64, K3_THREE_SEGMENTS, False)])
def test_k3_plain_backward_matches_stock_reference(b, l, h, d, n_real,
                                                   causal):
    q, k, v, w, seg = _k3_inputs(b, l, h, d, n_real, seed=l + h)
    scale = d ** -0.5
    want = _stock_k3_grads(q, k, v, w, seg, causal, scale)
    got = _port_k3_grads(q, k, v, w, seg, causal, scale)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), x, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,l,h,n_real,causal", [
    (1, 256, 2, 200, False), (1, 256, 2, 256, True),
    (1, 512, 2, K3_THREE_SEGMENTS, False)])
def test_k3_plain_backward_bf16_matches_stock_reference(b, l, h, n_real,
                                                        causal):
    """bf16 at D = 64, the input of the wgmma backward kernels, which
    are held to this plain version. Errors relative to each gradient's
    largest entry. The stock reference runs in bf16 throughout (logits,
    softmax and products rounded to bf16), which puts it 2.1-2.4% from
    the f64 gradient of the same bf16 inputs here, so it is held within
    3e-2; the plain version rounds only p and ds to bf16 before their
    products (f32 sums), and is held within 1e-2 of the f64 gradient
    (it reads 0.3-0.5%)."""
    q, k, v, w, seg = _k3_inputs(b, l, h, 64, n_real, seed=l + 7)
    want = _stock_k3_grads(q, k, v, w, seg, causal, 0.125, jnp.bfloat16)
    got = _port_k3_grads(q, k, v, w, seg, causal, 0.125, torch.bfloat16)
    s = torch.from_numpy(seg)
    exact = [torch.from_numpy(x).to(torch.bfloat16).double()
             for x in (q, k, v)]
    kw = dict(q_segment_ids=s, kv_segment_ids=s, causal=causal,
              sm_scale=0.125)
    o, lse = fa.flash_attention_plain(*exact, return_lse=True, **kw)
    truth = fa.flash_attention_bwd_plain(
        *exact, o, lse, torch.from_numpy(w).to(torch.bfloat16).double(),
        **kw)
    for g, x, t in zip(got, want, truth):
        assert g.dtype == torch.bfloat16
        g, t = g.float().numpy(), t.numpy()
        assert np.abs(g - x).max() <= 3e-2 * np.abs(x).max()
        assert np.abs(g - t).max() <= 1e-2 * np.abs(t).max()


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "sm90"), (torch.float32, 64, "simt"),
    (torch.bfloat16, 128, "simt"), (torch.bfloat16, 256, "simt")])
def test_k3_bwd_route_by_type(dtype, d, route):
    assert fa.bwd_route(dtype, d) == route


def test_k3_bwd_route_rejects_other_types():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.bwd_route(torch.float16, 64)


def test_k3_backward_on_cpu_loads_no_library(monkeypatch):
    """flash_attention_bwd on CPU tensors (bf16 at D = 64, the wgmma
    route's input on the card) runs the plain version and never builds
    or loads a kernel library."""
    from wedetect_tpu_torch.ops import _build

    def no_load(name):
        raise AssertionError(f"loaded {name} for CPU tensors")

    monkeypatch.setattr(_build, "load", no_load)
    monkeypatch.setattr(_build, "build", no_load)
    q, k, v, w, seg = _k3_inputs(1, 256, 2, 64, K3_THREE_SEGMENTS[:2],
                                 seed=4)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, w)]
    s = torch.from_numpy(seg)
    kw = dict(q_segment_ids=s, kv_segment_ids=s, causal=False,
              sm_scale=0.125)
    o, lse = fa.flash_attention_plain(*t[:3], return_lse=True, **kw)
    got = fa.flash_attention_bwd(*t[:3], o, lse, t[3], **kw)
    want = fa.flash_attention_bwd_plain(*t[:3], o, lse, t[3], **kw)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


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
