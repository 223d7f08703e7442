"""The port's weight-only quantization (`wedetect_tpu_torch/models/
quant.py`) against `wedetect_tpu/models/quant.py` on the CPU.

Codes and scales are bitwise equal to JAX's from the same f32 weights
(int8, plain int4 and the activation-calibrated int4 fit); packing is
bitwise over all 16 nibbles; `matmul_any` agrees with JAX's per leaf
type within 1e-5 (f32 matmuls of different libraries), and bitwise with
the pre-dequantized product at power-of-two scales. The decode-param
tree of a port model equals the JAX tree of the same params carried
across by `ckpt/convert_ref.from_jax_decode_params`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_ref_util import cfgs, jax_params, port_model
from torch_ref_util import one_torch_thread  # noqa: F401 (autouse)
from wedetect_tpu.models import quant as JQ
from wedetect_tpu_torch.ckpt.convert_ref import from_jax_decode_params
from wedetect_tpu_torch.models import quant as TQ

MATMUL_TOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = cfgs()
    params = jax_params(jcfg)
    return jcfg, tcfg, params


def _w(shape, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[:, 0] *= 40.0                                # an outlier column
    w[3] *= 0.01                                   # a quiet row
    return w


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("shape", [(48, 96), (96, 48), (130, 7)])
def test_quantize_weight_int8_bitwise(shape):
    w = _w(shape)
    want = JQ.quantize_weight(jnp.asarray(w), axis=0)
    got = TQ.quantize_weight(torch.tensor(w), axis=0)
    _bits(got["w8"].numpy(), want["w8"])
    _bits(got["scale"].numpy(), want["scale"])


@pytest.mark.parametrize("calibrated", [False, True])
def test_quantize_weight4_bitwise(calibrated):
    w = _w((64, 40), seed=1)
    rms = (np.random.default_rng(2).random(64).astype(np.float32) * 3
           if calibrated else None)
    want = JQ.quantize_weight4(jnp.asarray(w), axis=0, act_rms=rms)
    got = TQ.quantize_weight4(torch.tensor(w), axis=0, act_rms=rms)
    for k in ("w4p", "rscale", "scale"):
        _bits(got[k].numpy(), want[k])


def test_pack_unpack_all_nibbles():
    """Every (low, high) pair of codes in [-8, 7] packs to JAX's byte
    and unpacks back."""
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    q = np.stack([lo.ravel(), hi.ravel()]).astype(np.int8)      # (2, 256)
    q = np.concatenate([q, q[::-1]], axis=0)                    # (4, 256)
    packed = TQ.pack_int4(torch.tensor(q))
    _bits(packed.numpy(), JQ.pack_int4(jnp.asarray(q)))
    np.testing.assert_array_equal(TQ.unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(
        TQ.unpack_int4(packed).numpy(),
        np.asarray(JQ.unpack_int4(jnp.asarray(packed.numpy()))).astype(
            np.int8))


@pytest.mark.parametrize("kind", ["weight", "w8", "w4p", "w4"])
def test_matmul_any_per_leaf(kind):
    w = _w((64, 24), seed=3)
    y = np.random.default_rng(4).standard_normal((5, 64)).astype(np.float32)
    if kind == "weight":
        jleaf = {"kernel": jnp.asarray(w)}
        tleaf = {"weight": torch.tensor(w.T.copy())}
    elif kind == "w8":
        jleaf = JQ.quantize_weight(jnp.asarray(w))
        tleaf = TQ.quantize_weight(torch.tensor(w))
    else:
        jleaf = JQ.quantize_weight4(jnp.asarray(w))
        tleaf = TQ.quantize_weight4(torch.tensor(w))
        if kind == "w4":
            tleaf = TQ.prepare_decode_params({"x": tleaf})["x"]
            assert "w4" in tleaf and tleaf["w4"].dtype == torch.int8
    want = np.asarray(JQ.matmul_any(jnp.asarray(y), jleaf, jnp.float32))
    got = TQ.matmul_any(torch.tensor(y), tleaf, torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=MATMUL_TOL, rtol=MATMUL_TOL)


def test_matmul_any_pow2_scale_bitwise():
    """Power-of-two scales commute with rounding: the int8 and int4
    leaves equal the pre-dequantized product bitwise."""
    rng = np.random.default_rng(1)
    y = torch.tensor(rng.standard_normal((5, 32)).astype(np.float32))
    w8 = torch.tensor(rng.integers(-127, 128, (32, 24)).astype(np.int8))
    s = torch.tensor((2.0 ** rng.integers(-8, 2, 24)).astype(np.float32))
    r = torch.tensor((2.0 ** rng.integers(-3, 3, 32)).astype(np.float32))
    got = TQ.matmul_any(y, {"w8": w8, "scale": s}, torch.float32)
    assert torch.equal(got, y @ (w8.float() * s))
    q4 = torch.tensor(rng.integers(-7, 8, (32, 24)).astype(np.int8))
    leaf = {"w4p": TQ.pack_int4(q4), "rscale": r, "scale": s}
    got4 = TQ.matmul_any(y, leaf, torch.float32)
    assert torch.equal(got4, ((y * r) @ q4.float()) * s)
    deq = TQ.dequantize_decode_params({"x": leaf})["x"]["weight"]
    assert torch.equal(deq.T, r[:, None] * q4.float() * s[None])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("untied", [False, True])
def test_quantize_decode_params_matches_jax(tiny, bits, untied):
    """The port model's quantized decode tree equals the JAX tree of the
    same params, leaf for leaf, bitwise (the tied head quantizes the
    transposed embedding in both)."""
    _, tcfg, params = tiny
    if untied:
        rng = np.random.default_rng(5)
        params = dict(params, lm_head={"kernel": rng.standard_normal(
            (tcfg.text.hidden, tcfg.text.vocab_size)).astype(np.float32)})
    jtree = JQ.quantize_decode_params(params, bits=bits)
    want = from_jax_decode_params(jtree)
    model = port_model(params, tcfg)
    assert (model.lm_head is not None) == untied
    got = TQ.quantize_decode_params(model, bits=bits)

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            _bits(a.detach().numpy(), b.numpy())

    walk(got, want)
    assert TQ.quantized_bytes(got) == sum(
        np.asarray(x).nbytes for x in jax.tree.leaves(jtree))
