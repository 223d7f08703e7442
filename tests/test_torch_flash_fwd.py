"""The port's K3 forward (`ops/flash_attention.py`): its route by type and
head dim, the CPU path, and the plain version -- which the CPU path runs
and which the kernels on the card are held to -- against the stock Pallas
kernel's own reference (`mha_reference_no_custom_vjp` with `SegmentIds`
and `save_residuals=True`: O, and lse = m + log l), O and lse, on the
CPU.

The cases are the edges of the bf16 wgmma kernel at D = 64: pad tokens
in segment 0, three segments with boundaries off its 64-key tiles, a
tail (L = 200, not a multiple of 64), square causal, and causal with
segment ids.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wedetect_tpu_torch.ops import flash_attention as fa

# (B, L, H, segment runs, causal): runs is n_real (n_real tokens in
# segment 1, then pad in 0) or (end, id) pairs, each id up to its end
# and 0 after
CASES = [
    (1, 256, 2, 200, False),                               # pad tokens
    (1, 512, 2, ((100, 1), (300, 2), (480, 3)), False),    # off the grid
    (1, 200, 2, 180, False),                               # L = 200
    (2, 256, 2, 256, True),                                # square causal
    (1, 384, 2, ((150, 1), (300, 2)), True),               # causal + ids
]
IDS = ["pad", "three_segments", "tail", "causal", "causal_segments"]
SCALE = 0.125                                              # 64 ** -0.5


def _ids(l, runs):
    runs = ((runs, 1),) if isinstance(runs, int) else runs
    ids = np.zeros(l, np.int32)
    start = 0
    for end, sid in runs:
        ids[start:end] = sid
        start = end
    return ids


def _inputs(b, l, h, runs, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, h, 64)).astype(np.float32)
               for _ in range(3))
    return q, k, v, np.broadcast_to(_ids(l, runs), (b, l)).copy()


def _stock(q, k, v, seg, causal, dtype):
    """The stock reference in `dtype`: O (B, L, H, D) and lse (B, H, L),
    both as f32 numpy."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds, mha_reference_no_custom_vjp)

    ids = jnp.asarray(seg)
    o, l, m = mha_reference_no_custom_vjp(
        *(jnp.asarray(x).astype(dtype).transpose(0, 2, 1, 3)
          for x in (q, k, v)),
        segment_ids=SegmentIds(q=ids, kv=ids), causal=causal,
        sm_scale=SCALE, save_residuals=True)
    lse = m.astype(jnp.float32) + jnp.log(l.astype(jnp.float32))
    return (np.asarray(o.transpose(0, 2, 1, 3).astype(jnp.float32)),
            np.asarray(lse))


def _plain(q, k, v, seg, causal, dtype):
    s = torch.from_numpy(seg)
    return fa.flash_attention_plain(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        q_segment_ids=s, kv_segment_ids=s, causal=causal, sm_scale=SCALE,
        return_lse=True)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k3_plain_forward_matches_stock_reference(case):
    """f32: the same function, summation order apart."""
    b, l, h, runs, causal = case
    q, k, v, seg = _inputs(b, l, h, runs, seed=l + h)
    want, wlse = _stock(q, k, v, seg, causal, jnp.float32)
    got, lse = _plain(q, k, v, seg, causal, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), wlse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k3_plain_forward_bf16_matches_stock_reference(case):
    """bf16 at D = 64, the input of the wgmma kernel, which is held to this
    plain version on the card. Errors relative to the largest entry, with
    the f64 plain version of the same bf16 inputs as truth. The stock
    reference runs in bf16 throughout (logits, m, l and O rounded to
    bf16), 0.4-0.8% from the truth in O and 0.07-0.11% in lse here, so
    the plain version is held within 2e-2 (O) and 5e-3 (lse) of it. The
    plain version rounds only p (before p.V) and O to bf16, one bf16 ulp
    (2^-8) of an entry at most: held within 1e-2 of the truth in O (it
    reads 0.17-0.31%), and its f32 lse within 1e-5 (it reads 1e-7)."""
    b, l, h, runs, causal = case
    q, k, v, seg = _inputs(b, l, h, runs, seed=l + 7)
    want, wlse = _stock(q, k, v, seg, causal, jnp.bfloat16)
    got, lse = _plain(q, k, v, seg, causal, torch.bfloat16)
    truth, tlse = (x.numpy() for x in _plain(
        *(torch.from_numpy(x).to(torch.bfloat16).float().numpy()
          for x in (q, k, v)), seg, causal, torch.float64))
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got, lse = got.float().numpy(), lse.numpy()
    assert _rel(got, want) <= 2e-2
    assert _rel(lse, wlse) <= 5e-3
    assert _rel(got, truth) <= 1e-2
    assert _rel(lse, tlse) <= 1e-5


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "sm90"), (torch.float32, 64, "f32"),
    (torch.bfloat16, 128, "simt"), (torch.bfloat16, 256, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 72, "simt"),
    (torch.float32, 512, "simt"), (torch.bfloat16, 72, "simt")])
def test_k3_fwd_route_by_type(dtype, d, route):
    """The forward by type and head dim: at D = 64 f32 takes the FFMA
    kernel and bf16 the wgmma one, every other head dim the SIMT kernel.
    The backward's route (`bwd_route`) keeps its answers: f32 "simt",
    bf16 "sm90" at D = 64 (`dq_route` and `dkv_route` refine it)."""
    assert fa.fwd_route(dtype, d) == route
    assert fa.bwd_route(dtype, d) == (
        "sm90" if (dtype, d) == (torch.bfloat16, 64) else "simt")


def test_k3_fwd_route_rejects_other_types():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.fwd_route(torch.float16, 64)


def test_k3_forward_on_cpu_loads_no_library(monkeypatch):
    """flash_attention on CPU tensors (bf16 at D = 64, the wgmma route's
    input on the card) runs the plain version, counts no launch and never
    builds or loads a kernel library."""
    from wedetect_tpu_torch.ops import _build

    def no_load(name):
        raise AssertionError(f"loaded {name} for CPU tensors")

    monkeypatch.setattr(_build, "load", no_load)
    monkeypatch.setattr(_build, "build", no_load)
    for fn in (fa.flash_attention, fa.flash_attention_fwd_sm90):
        monkeypatch.setattr(fn, "launches", 0)
    q, k, v, seg = _inputs(*CASES[1][:4], seed=4)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    s = torch.from_numpy(seg)
    kw = dict(q_segment_ids=s, kv_segment_ids=s, causal=False,
              sm_scale=SCALE, return_lse=True)
    got, lse = fa.flash_attention(*t, **kw)
    want, wlse = fa.flash_attention_plain(*t, **kw)
    assert torch.equal(got, want) and torch.equal(lse, wlse)
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention_fwd_sm90.launches == 0
