"""The port's dynamic int8 ops (`wedetect_tpu_torch/ops/int8.py`) and the
detector's int8 mode (`ModelCfg.quant_int8`, the CLIs' --int8) against
the JAX package on the CPU; the Ref's int8 prefill is in
tests/test_torch_int8_ref.py.

Ops: `quant_linear` / `quant_conv2d` equal JAX's `quant_dot_general` /
`quant_conv_general` bitwise in f32 and bf16 (the int32 sums are exact
and the epilogue runs in JAX's order), at shapes that need every kind of
padding of the one `torch._int_mm` rule.

Models: a module's int8 output moves as soon as a value lands on the
other side of a rounding boundary, so model-level limits are set against
the int8-vs-float gap, with the port's float forward as the control
that must miss:
- the f32 detector is held to JAX's ops as written (`jax.disable_jit`):
  within DET_TOL, against a gap of ~2e-3, no code differing at these
  seeds. Jitted, XLA fuses the float work ahead of each quantize and
  moves it by ulps; at these seeds one code of the 14th int8 call flips
  and the flip cascades (the jitted JAX int8 forward ends ~1.2e-3 from
  its own eager one), so the jitted forward is no reference at this
  precision;
- in bf16, and in f32 too, every quantized call is checked on its own:
  the port's modules are called in JAX's order with JAX's weights (bf16
  rounded in bf16), and the port's op on JAX's recorded input equals
  JAX's op bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import wedetect_tpu.ops.int8 as JI
from wedetect_tpu.ckpt.convert import convert_detector
from test_torch_detector import cfgs as det_cfgs, images
from torch_ref_util import one_torch_thread  # noqa: F401 (autouse)
from wedetect_tpu.models import wedetect as JW
from wedetect_tpu_torch.models import wedetect as TW
from wedetect_tpu_torch.ops import int8 as TI

DET_TOL = 1e-5          # f32 detector logits / DFL logits vs eager JAX
DENSE = (((1,), (0,)), ((), ()))
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _bits_equal(got: torch.Tensor, want) -> bool:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return np.array_equal(got.float().numpy().view(np.uint32),
                          want.view(np.uint32))


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_bitwise(dtype):
    x = np.random.default_rng(0).standard_normal((5, 7, 9)) \
        .astype(np.float32) * 3
    x[1] = 0.0                                      # an all-zero row
    xt = torch.tensor(x).to(dtype)
    xj = jnp.asarray(x).astype(JDT[dtype])
    for dims, axes in ((-1, -1), ((0, 1, 2), (0, 1, 2)), ((1, 2), (1, 2))):
        q, s = TI._quantize(xt, dims)
        jq, js = JI._quantize(xj, axes)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert _bits_equal(s, js)
        assert q.dtype == torch.int8 and int(q.abs().max()) == 127


# (rows, K, N): rows <= 16 and > 16; K and N off and on multiples of 8
LINEAR_SHAPES = [(1, 12, 12), (3, 5, 7), (16, 12, 12), (17, 64, 40),
                 (40, 37, 9), (2, 4, 3, 20)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LINEAR_SHAPES)
def test_quant_linear_bitwise(shape, dtype):
    """quant_linear == quant_dot_general (+ the bias as flax adds it),
    bit for bit; the padding rule ran (rows, K or N off the rule)."""
    rng = np.random.default_rng(sum(shape))
    *lead, k, n = shape
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    jdt = JDT[dtype]
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    want = JI.quant_dot_general(xj.reshape(-1, k), wj, DENSE)
    want = (want + jnp.asarray(b).astype(jdt)).reshape(*lead, n)
    got = TI.quant_linear(torch.tensor(x).to(dtype),
                          torch.tensor(w.T.copy()).to(dtype),
                          torch.tensor(b))
    assert got.dtype == dtype and got.shape == tuple(want.shape)
    assert _bits_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_quant_conv2d_bitwise(kernel, stride, dtype):
    """quant_conv2d == quant_conv_general (NCHW vs NHWC, OIHW vs HWIO),
    bit for bit: one activation scale over the whole batch; C = 5 and
    O = 7 need K and N padded, 1x1 at stride 1 and B * H * W = 2 x 3 x 2
    the rows."""
    rng = np.random.default_rng(kernel * 10 + stride)
    for b, c, h, w, o in ((2, 5, 9, 7, 7), (2, 3, 3, 2, 12)):
        x = rng.standard_normal((b, c, h, w)).astype(np.float32)
        x[1] *= 8.0                      # the images' ranges differ
        wt = rng.standard_normal((o, c, kernel, kernel)).astype(np.float32)
        jdt = JDT[dtype]
        xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt)
        wj = jnp.asarray(wt.transpose(2, 3, 1, 0)).astype(jdt)
        dn = jax.lax.conv_dimension_numbers(xj.shape, wj.shape,
                                            ("NHWC", "HWIO", "NHWC"))
        p = kernel // 2
        want = JI.quant_conv_general(xj, wj, (stride, stride),
                                     [(p, p), (p, p)],
                                     dimension_numbers=dn)
        got = TI.quant_conv2d(torch.tensor(x).to(dtype),
                              torch.tensor(wt).to(dtype), None, stride, p)
        assert got.dtype == dtype
        assert _bits_equal(got.permute(0, 2, 3, 1).contiguous(), want)


def test_per_tensor_conv_scale_control_misses():
    """The conv's activation scale is one over the batch: a scale per
    image (the B = 1 result of each image) misses JAX at B = 2."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 8, 8)).astype(np.float32)
    x[1] *= 10.0
    w = rng.standard_normal((4, 6, 3, 3)).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    wj = jnp.asarray(w.transpose(2, 3, 1, 0))
    dn = jax.lax.conv_dimension_numbers(xj.shape, wj.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    want = JI.quant_conv_general(xj, wj, (1, 1), [(1, 1), (1, 1)],
                                 dimension_numbers=dn)
    xt, wt = torch.tensor(x), torch.tensor(w)
    assert _bits_equal(TI.quant_conv2d(xt, wt, None, 1, 1)
                       .permute(0, 2, 3, 1).contiguous(), want)
    per_image = torch.cat([TI.quant_conv2d(xt[i:i + 1], wt, None, 1, 1)
                           for i in range(2)])
    assert not _bits_equal(per_image.permute(0, 2, 3, 1).contiguous(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_conv_stays_float(dtype):
    """Depthwise and grouped convs run the float op on both sides."""
    rng = np.random.default_rng(4)
    for groups in (6, 2):
        x = rng.standard_normal((1, 6, 8, 8)).astype(np.float32)
        w = rng.standard_normal((6, 6 // groups, 3, 3)).astype(np.float32)
        xt, wt = torch.tensor(x).to(dtype), torch.tensor(w).to(dtype)
        got = TI.quant_conv2d(xt, wt, None, 1, 1, groups)
        assert torch.equal(got, F.conv2d(xt, wt, None, 1, 1, 1, groups))
        jdt = JDT[dtype]
        xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt)
        wj = jnp.asarray(w.transpose(2, 3, 1, 0)).astype(jdt)
        dn = jax.lax.conv_dimension_numbers(xj.shape, wj.shape,
                                            ("NHWC", "HWIO", "NHWC"))
        kw = dict(dimension_numbers=dn, feature_group_count=groups)
        jq = JI.quant_conv_general(xj, wj, (1, 1), [(1, 1), (1, 1)], **kw)
        jf = jax.lax.conv_general_dilated(xj, wj, (1, 1), [(1, 1), (1, 1)],
                                          **kw)
        assert _bits_equal(torch.tensor(np.asarray(jf.astype(jnp.float32))),
                           jq)
        tol = 1e-5 if dtype == torch.float32 else 5e-2
        np.testing.assert_allclose(
            got.float().permute(0, 2, 3, 1).numpy(),
            np.asarray(jq.astype(jnp.float32)), atol=tol, rtol=tol)


@pytest.mark.parametrize("m,k,n", [(1, 12, 12), (16, 12, 12), (17, 12, 12),
                                   (3, 5, 7), (33, 24, 16)])
def test_int_mm_padding_rule(m, k, n):
    """The one padding rule: rows to >= 17, K and N to multiples of 8;
    the sums equal the int64 product exactly, codes at +-127 included."""
    assert TI.int_mm_padded_shape(m, k, n) == (
        max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8)
    g = torch.Generator().manual_seed(m * 100 + k)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    a[0] = 127
    w[0] = -127
    got = TI.int8_matmul(a, w)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.long(), a.long() @ w.long().T)


def test_quant_modules_flags_and_mode():
    lin = TI.QuantLinear(8, 4)
    conv = TI.QuantConv2d(3, 4, 3, padding=1)
    seq = torch.nn.Sequential(lin, torch.nn.Linear(4, 4))
    x = torch.randn(2, 8)
    assert torch.equal(lin(x), F.linear(x, lin.weight, lin.bias))
    with TI.quant_mode(seq, True):
        assert lin.quant
        assert torch.equal(lin(x), TI.quant_linear(x, lin.weight, lin.bias))
    assert not lin.quant
    TI.set_quant(conv, True)
    xc = torch.randn(1, 3, 5, 5)
    assert torch.equal(conv(xc),
                       TI.quant_conv2d(xc, conv.weight, conv.bias, 1, 1))
    assert set(lin.state_dict()) == {"weight", "bias"}


# ------------------------------------------------------------- detector


def _record_jax_calls(mp):
    """Record (kind, lhs, rhs, out) of every JAX int8 call, in order,
    through ordered debug callbacks (concrete under jit too)."""
    calls = []

    def wrap(kind, fn):
        def rec(lhs, rhs, *a, **k):
            out = fn(lhs, rhs, *a, **k)
            jax.debug.callback(
                lambda *t: calls.append((kind,) + tuple(map(np.asarray, t))),
                lhs, rhs, out, ordered=True)
            return out
        return rec

    mp.setattr(JI, "quant_dot_general", wrap("linear", JI.quant_dot_general))
    mp.setattr(JI, "quant_conv_general", wrap("conv", JI.quant_conv_general))
    return calls


class _PortCalls:
    """The port's int8 modules in the order a forward calls them."""

    def __init__(self, model):
        self.order = []
        self.hooks = [m.register_forward_hook(
            lambda m_, i_, o_: self.order.append(m_))
            for m in model.modules()
            if isinstance(m, (TI.QuantLinear, TI.QuantConv2d))]

    def __enter__(self):
        return self.order

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def check_calls(calls, order, dtype, autocast=False, recorded=False):
    """Each port module called in JAX's order, its weight JAX's kernel
    (after the compute-dtype cast), and the port's op on JAX's input
    equal, bitwise, to JAX's op: the recorded output of a forward run
    as written (`recorded`), else the op run here on the recorded
    operands (a jitted forward's own outputs are XLA's rewrite of it)."""
    assert len(calls) == len(order) > 0
    jdt = JDT[dtype]
    ctx = (torch.autocast("cpu", dtype=torch.bfloat16) if autocast
           else torch.autocast("cpu", enabled=False))
    for (kind, lhs, rhs, out), mod in zip(calls, order):
        w = mod.weight.detach().to(dtype)
        lj, rj = jnp.asarray(lhs).astype(jdt), jnp.asarray(rhs).astype(jdt)
        lt = torch.tensor(np.asarray(lj.astype(jnp.float32))).to(dtype)
        if kind == "linear":
            assert isinstance(mod, TI.QuantLinear)
            assert _bits_equal(w.T.contiguous(), rj)
            k = lhs.shape[-1]
            want = (out.reshape(-1, out.shape[-1]) if recorded else
                    JI.quant_dot_general(lj.reshape(-1, k), rj, DENSE))
            with ctx:
                got = TI.quant_linear(lt.reshape(-1, k), w)
        else:
            assert isinstance(mod, TI.QuantConv2d)
            assert _bits_equal(w.permute(2, 3, 1, 0).contiguous(), rj)
            p = mod.padding[0]
            dn = jax.lax.conv_dimension_numbers(lj.shape, rj.shape,
                                                ("NHWC", "HWIO", "NHWC"))
            want = out if recorded else JI.quant_conv_general(
                lj, rj, mod.stride, [(p, p)] * 2, dimension_numbers=dn)
            with ctx:
                got = TI.quant_conv2d(lt.permute(0, 3, 1, 2), w, None,
                                      mod.stride, mod.padding)
            got = got.permute(0, 2, 3, 1).contiguous()
        assert got.dtype == dtype
        assert _bits_equal(got, want)


def _det(dtype="float32", **kw):
    """(JAX cfg, its int8 twin, JAX variables, port cfg, port float model,
    port int8 cfg, port int8 model): the port's seeded init with moved
    BN statistics, carried to JAX by its own converter."""
    jcfg, tcfg = det_cfgs(compute_dtype=dtype, **kw)
    model = TW.init_variables(tcfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.add_(torch.randn(m.weight.shape, generator=g) / 10)
                m.bias.add_(torch.randn(m.bias.shape, generator=g) / 10)
    jvars = convert_detector({k: v.numpy()
                              for k, v in model.state_dict().items()}, jcfg)
    jq = dataclasses.replace(jcfg, quant_int8=True)
    tq = dataclasses.replace(tcfg, quant_int8=True)
    mq = TW.WeDetectModule(tq).eval()
    mq.load_state_dict(model.state_dict(), strict=True)
    return jcfg, jq, jvars, tcfg, model, tq, mq


IMGS = images(2, seed=1)
W = np.random.default_rng(2).standard_normal((4, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def det_f32():
    """The f32 Det model, JAX's int8 forward_raw as written (eager) with
    its int8 calls recorded, and JAX's float forward_raw."""
    jcfg, jq, jvars, tcfg, model, tq, mq = _det()
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        calls = _record_jax_calls(mp)
        want = JW.forward_raw(jq, jvars, jnp.asarray(IMGS), jnp.asarray(W))
        jax.effects_barrier()
    jfloat = JW.forward_raw(jcfg, jvars, jnp.asarray(IMGS), jnp.asarray(W))
    return dict(jq=jq, jvars=jvars, tcfg=tcfg, model=model, tq=tq, mq=mq,
                want=want, jfloat=jfloat, calls=calls)


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


def _hold_to_jax(got, ctrl, want, jfloat):
    """Logits and DFL logits within DET_TOL of JAX's int8 forward, the
    gap to JAX's float forward over 100x that, the control missing."""
    for f in ("logits", "dist_logits"):
        w = np.asarray(getattr(want, f))
        gap = _max_err(np.asarray(getattr(jfloat, f)), w)
        assert gap > 100 * DET_TOL, (f, gap)
        assert _max_err(getattr(got, f).numpy(), w) <= DET_TOL, f
        assert _max_err(getattr(ctrl, f).numpy(), w) > DET_TOL, f


def test_detector_int8_matches_jax(det_f32):
    """WeDetectModule with quant_int8 (Det) against JAX's int8
    forward_raw as written, f32; the port's float forward misses."""
    d = det_f32
    assert all(m.quant for m in d["mq"].modules()
               if isinstance(m, (TI.QuantLinear, TI.QuantConv2d)))
    got = TW.forward_raw(d["tq"], d["mq"], IMGS, W)
    ctrl = TW.forward_raw(d["tcfg"], d["model"], IMGS, W)
    _hold_to_jax(got, ctrl, d["want"], d["jfloat"])


def test_detector_uni_int8_matches_jax():
    """The same for Uni: its prompt bank as the text side (no `w`)."""
    jcfg, jq, jvars, tcfg, model, tq, mq = _det(num_prompts=8,
                                                num_classes=8)
    with jax.disable_jit():
        want = JW.forward_raw(jq, jvars, jnp.asarray(IMGS))
    jfloat = JW.forward_raw(jcfg, jvars, jnp.asarray(IMGS))
    _hold_to_jax(TW.forward_raw(tq, mq, IMGS), TW.forward_raw(tcfg, model,
                                                              IMGS),
                 want, jfloat)


def test_detect_step_int8_same_detections(det_f32):
    """detect_step end to end in int8, f32: the same NMS slots (valid,
    anchors, labels) as JAX's postprocess of its int8 outputs, boxes and
    scores within 1e-4."""
    d = det_f32
    sf = np.array([[0.5, 0.5], [1.0, 1.0]], np.float32)
    pad = np.array([[7, 0, 3, 0], [0, 0, 0, 0]], np.float32)
    ori = np.array([[100, 50], [64, 64]], np.float32)
    want = jax.jit(JW.postprocess, static_argnums=0)(
        d["jq"], d["want"], jnp.asarray(sf), jnp.asarray(pad),
        jnp.asarray(ori))
    got = TW.detect_step(d["tq"], d["mq"], IMGS, W, sf, pad, ori)
    assert int(got.valid.sum()) > 0
    for f in ("valid", "anchors", "labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("boxes", "scores", "embeds"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   atol=1e-4, rtol=1e-4, err_msg=f)


def test_detector_int8_calls_match_jax(det_f32):
    """Every quantized call of the f32 detector: the block MLPs, each
    Conv+BN conv of the neck and the head's tower convs, in JAX's order
    (the stem, downsampling, depthwise and 1x1 prediction convs and the
    contrastive product stay float); bf16 in
    tests/test_torch_int8_bf16.py."""
    d = det_f32
    with _PortCalls(d["mq"]) as order:
        TW.forward_raw(d["tq"], d["mq"], IMGS, W)
    check_calls(d["calls"], order, torch.float32, recorded=True)


def test_int8_cli_flags(tmp_path, capsys):
    """--int8 on infer_wedetect and generate_proposal builds the int8
    model (random init, on the CPU)."""
    import cv2

    from wedetect_tpu_torch.cli import generate_proposal, infer_wedetect

    path = tmp_path / "img.png"
    cv2.imwrite(str(path), images(1, hw=96)[0])
    seen = []
    orig = TI.quant_conv2d

    def spy(*a, **k):
        seen.append(1)
        return orig(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TI, "quant_conv2d", spy)
        r = infer_wedetect.main(["--image", str(path), "--text", "a,b",
                                 "--size", "tiny", "--random-init",
                                 "--device", "cpu", "--int8"])
        n_det = len(seen)
        p = generate_proposal.main(["--image", str(path), "--size", "base",
                                    "--random-init", "--device", "cpu",
                                    "--int8", "--num_proposals", "5"])
    assert n_det > 0 and len(seen) > n_det
    assert r["bboxes"].shape[1] == 4 and p["bboxes"].shape[1] == 4
