"""K2's plain version (`wedetect_tpu_torch/ops/flash_gqa.py`) against
the JAX grouped-KV flash kernel run through the Pallas interpreter, on
the CPU, at atol = rtol = 2e-5 (f32; the kernel's blocked online
softmax against one softmax per row: summation order only).

All rows are compared, including rows whose scanned keys are all
masked: there both return the mean of V over the keys the Pallas
kernel's tiling scans (not 0, and not the -1e9 einsum's answer).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wedetect_tpu.ops import flash_gqa as J
from wedetect_tpu_torch.ops import flash_gqa as T

TOL = 2e-5
CASES = [
    # (B, S, Lk, H, KVH, D, causal, masked): tests/test_flash_gqa.py's grid
    (2, 128, 384, 4, 2, 128, True, False),
    (1, 128, 128, 4, 1, 128, True, False),
    (2, 128, 640, 8, 2, 128, True, True),
    (1, 256, 256, 8, 8, 128, False, True),
    (1, 128, 512, 16, 8, 128, True, True),
    # D = 256: JAX tiles any D % 128 == 0; the card runs it on the SIMT
    # kernel in both types
    (1, 128, 256, 4, 2, 256, True, True),
]


def _inputs(b, s, lk, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, lk, kvh, d), (b, lk, kvh, d))]


def _both(q, k, v, causal, valid):
    want = J.gqa_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_valid=None if valid is None else jnp.asarray(valid))
    got = T.gqa_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        kv_valid=None if valid is None else torch.from_numpy(valid))
    return got, want


@pytest.mark.parametrize(
    "b,s,lk,h,kvh,d,causal,masked", CASES,
    ids=[f"B{c[0]}S{c[1]}L{c[2]}H{c[3]}KV{c[4]}D{c[5]}"
         f"{'c' if c[6] else 'n'}{'m' if c[7] else ''}" for c in CASES])
def test_plain_matches_pallas_kernel(b, s, lk, h, kvh, d, causal, masked):
    q, k, v = _inputs(b, s, lk, h, kvh, d, seed=b * 1000 + s + lk)
    valid = None
    if masked:
        valid = np.ones((b, lk), np.int32)
        valid[:, lk // 2 - 8:lk // 2] = 0
        valid[:, -5:] = 0
    got, want = _both(q, k, v, causal, valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


# (B, S, Lk, H, KVH, D, causal, invalid key ranges): the cases the bf16
# kernel (csrc/flash_gqa_sm90.cu) is held to on the card, at CPU sizes
BF16_CASES = [
    (1, 128, 384, 4, 2, 128, True, ()),            # tests/test_flash_gqa.py:113
    (2, 128, 640, 4, 2, 128, True, ((332, 384), (600, 640))),  # suffix-like
    (2, 96, 384, 4, 2, 128, True, ((200, 216),)),  # S*G = 192: partial block
    (1, 128, 256, 4, 2, 128, True, ((0, 132),)),   # rows all masked
]


@pytest.mark.parametrize(
    "b,s,lk,h,kvh,d,causal,holes", BF16_CASES,
    ids=["rect", "suffix_holes", "partial_block", "all_masked_rows"])
def test_plain_matches_pallas_kernel_bf16(b, s, lk, h, kvh, d, causal,
                                          holes):
    """The plain version in bf16 against the Pallas kernel in bf16 under
    the interpreter. The two round p to bf16 against different running
    maxima: 2e-2."""
    q, k, v = _inputs(b, s, lk, h, kvh, d, seed=3 + s + lk)
    valid = np.ones((b, lk), np.int32)
    for lo, hi in holes:
        valid[:, lo:hi] = 0
    want = J.gqa_flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                   for x in (q, k, v)), causal=causal,
                                 kv_valid=jnp.asarray(valid))
    got = T.gqa_flash_attention(*(torch.from_numpy(x).bfloat16()
                                  for x in (q, k, v)), causal=causal,
                                kv_valid=torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_fwd_route_by_type():
    """bf16 at D = 128 with G dividing 128 takes the wgmma kernel; f32 at
    D = 128 the FFMA one; f32 at D = 256, and bf16 at any other shape
    (D = 256, G = 3), the SIMT one; other types raise."""
    assert T.fwd_route(torch.bfloat16, 128, 2) == "sm90"
    assert T.fwd_route(torch.bfloat16, 128, 1) == "sm90"
    assert T.fwd_route(torch.bfloat16, 128, 128) == "sm90"
    assert T.fwd_route(torch.float32, 128, 2) == "f32"
    assert T.fwd_route(torch.float32, 256, 2) == "simt"
    assert T.fwd_route(torch.bfloat16, 256, 2) == "simt"
    assert T.fwd_route(torch.bfloat16, 128, 3) == "simt"
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            T.fwd_route(dtype, 128, 2)


def test_bwd_route_by_type():
    """The backward's wgmma kernels take bf16 at D = 128 with G dividing
    64 (the dk/dv kernel's 64-row boxes); f32 and other bf16 shapes take
    the SIMT kernels; other types raise."""
    assert T.bwd_route(torch.bfloat16, 128, 2) == "sm90"
    assert T.bwd_route(torch.bfloat16, 128, 64) == "sm90"
    assert T.bwd_route(torch.bfloat16, 256, 2) == "simt"
    assert T.bwd_route(torch.bfloat16, 128, 128) == "simt"
    assert T.bwd_route(torch.bfloat16, 128, 3) == "simt"
    assert T.bwd_route(torch.float32, 128, 2) == "simt"
    with pytest.raises(TypeError):
        T.bwd_route(torch.float16, 128, 2)


@pytest.mark.parametrize("dtype,d,g,route", [
    (torch.float32, 128, 2, "f32"), (torch.float32, 128, 1, "f32"),
    (torch.float32, 128, 3, "f32"), (torch.float32, 128, 128, "f32"),
    (torch.float32, 64, 2, "simt"), (torch.float32, 256, 2, "simt"),
    (torch.bfloat16, 128, 2, "sm90"), (torch.bfloat16, 128, 64, "sm90"),
    (torch.bfloat16, 128, 128, "simt"), (torch.bfloat16, 128, 3, "simt"),
    (torch.bfloat16, 256, 2, "simt"), (torch.bfloat16, 64, 1, "simt")])
def test_dkdv_route_by_type_dim_and_group(dtype, d, g, route):
    """K2-bwd-dkdv: f32 at D = 128 takes the FFMA kernel at any G; bf16
    at D = 128 with G dividing 64 the wgmma one; every other shape the
    SIMT one. dq keeps bwd_route (f32 on the SIMT kernel)."""
    assert T.dkdv_route(dtype, d, g) == route
    if dtype == torch.float32:
        assert T.bwd_route(dtype, d, g) == "simt"


def test_dkdv_route_rejects_other_types():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        T.dkdv_route(torch.float16, 128, 2)


@pytest.mark.parametrize("lk,n_masked", [(128, 4), (256, 132), (384, 260)])
def test_leading_keys_masked_all_rows(lk, n_masked):
    """The first rows see only masked keys among those the kernel scans:
    the mean of V over the scanned keys, on every row."""
    q, k, v = _inputs(1, 128, lk, 4, 2, 128, seed=lk)
    valid = np.ones((1, lk), np.int32)
    valid[:, :n_masked] = 0
    got, want = _both(q, k, v, True, valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    f = int(T.row_frontier(128, lk, 2, True)[0])
    mean_v = v[0, :f].mean(0)                               # (KVH, D)
    np.testing.assert_allclose(got[0, 0].numpy().reshape(2, 2, 128),
                               np.repeat(mean_v[:, None], 2, 1), atol=1e-5)


def test_lse_is_logsumexp_of_scanned_logits():
    q, k, v = _inputs(1, 128, 256, 4, 2, 128, seed=9)
    o, lse = T.gqa_flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        return_lse=True)
    assert lse.shape == (1, 2, 256)
    # folded row 1 = query 0, head 1 (kv head 0), end-aligned at key 128
    logits = q[0, 0, 1] @ k[0, :129, 0].T / np.sqrt(128)
    want = np.log(np.exp(logits - logits.max()).sum()) + logits.max()
    np.testing.assert_allclose(float(lse[0, 0, 1]), want, rtol=1e-5)


def test_tiling_rules_match_jax():
    for s in (1, 2, 7, 8, 64, 100, 128, 256, 384, 1024):
        for g in (1, 2, 3, 4, 8):
            assert T._pick_bq(s, g) == J._pick_bq(s, g), (s, g)
    for lk in (64, 128, 200, 256, 384, 640, 1024, 1280):
        assert T._pick_bk(lk) == J._pick_bk(lk), lk
        for s in (8, 128, 256, 384):
            for d in (64, 128, 256):
                for g in (1, 2, 4):
                    assert T.supports(s, lk, d, g) == J.supports(s, lk, d, g)


def test_wrapper_runs_plain_on_cpu(monkeypatch):
    """A CPU tensor goes to the plain version; no launch is counted."""
    monkeypatch.setattr(T.gqa_flash_attention, "launches", 0)
    calls = []
    plain = T.gqa_flash_attention_plain
    monkeypatch.setattr(T, "gqa_flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 128, 128, 4, 2, 128,
                                                     seed=1))
    T.gqa_flash_attention(q, k, v)
    assert calls == [1] and T.gqa_flash_attention.launches == 0


def test_rejects_bad_shapes():
    q = torch.zeros((1, 128, 4, 128))
    for kk, qq in ((torch.zeros((1, 200, 2, 128)), q),      # Lk % 128
                   (torch.zeros((1, 64, 2, 128)), q),       # Lk < S causal
                   (torch.zeros((1, 128, 2, 128)),
                    torch.zeros((1, 128, 3, 128)))):        # H % KVH
        with pytest.raises(ValueError):
            T.gqa_flash_attention(qq, kk, kk, causal=True)
