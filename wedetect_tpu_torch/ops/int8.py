"""Dynamic int8 matmul and convolution for the quantized serving modes.

Port of `wedetect_tpu/ops/int8.py`. Both operands are quantized on the
fly with symmetric absmax to 127 levels, multiplied as int8 x int8 with
int32 sums, and the two scales multiply the result:

- activations: one scale per row for a Linear (the row scale factors
  out of the contraction exactly), one scale for the whole tensor for a
  convolution (a window mixes rows; one amax over the batch, not one an
  image);
- weights: one scale per output channel (the channel never enters the
  contraction).

`quant_linear` and `quant_conv2d` are the counterparts of JAX's
`quant_dot_general` and `quant_conv_general`: the epilogue
`y.float() * ls * rs` runs in that order, is cast to the compute dtype,
and the bias is added after, as flax adds it. A grouped or depthwise
convolution stays float, as in JAX. The compute dtype is the autocast
dtype where autocast is on (the detector's bf16 mode), else the input's:
a bf16 weight is quantized from its bf16 values, as flax casts the
kernel before the product.

The int8 product is `torch._int_mm` on both devices (in the JAX package
it is an XLA op outside any Pallas kernel). On CUDA it takes more than
16 rows, K and N multiples of 8 and a column-major right operand;
`int_mm_padded_shape` is the one padding rule, run on the CPU as on the
card: rows, K and N are padded with zero codes, which leave the int32
sums exact. A 1x1 convolution is a reshape and a k x k or strided one an
unfold (zero codes in the border) ahead of the product.

Under tensor parallelism (`quant_linear(..., group=)`, reached from
`parallel/mesh.row_linear`) a row-parallel weight holds this rank's
slice of the contraction: the activation rows' and the weight columns'
absmax are MAXes over the group, and the int32 partial sums are summed
over the group before the epilogue, so the codes, the scales and the
sums are the one-process call's and the output is its output bitwise,
as XLA's global view of JAX's op computes the same exact int32 sum. A
column-parallel weight holds whole contractions, so its local call is
already exact.

`QuantLinear` and `QuantConv2d` are nn.Linear / nn.Conv2d (same
parameters, same state-dict keys) whose `quant` flag routes the forward
here; the detector and the Ref towers build them where JAX passes
`dot_general=` / `conv_general_dilated=`, and `set_quant` /
`quant_mode` set the flag on every such module of a model. Inference
only: the rounding has no useful gradient.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from wedetect_tpu_torch.parallel.collectives import MAX

# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device: CUDA turns a division by
    a Python scalar into a product with its reciprocal (one ulp off now
    and then); a 0-dim tensor on x's device keeps it a division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _quantize(x: torch.Tensor, dims, eps: float = 1e-12, group=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 over `dims`: (x8, scale) with x8 * scale ~= x;
    the scale keeps the reduced dims for broadcasting. Rounds half to
    even, as jnp.round does. `group`: the tensor-parallel group over
    which `dims` is sliced (the absmax is its MAX)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dims, keepdim=True)
    if group is not None:
        group.all_reduce(amax, op=MAX)
    scale = true_div(torch.clamp(amax, min=eps), 127.0)
    x8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x8, scale


def int_mm_padded_shape(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """The (rows, K, N) that `int8_matmul` hands torch._int_mm for an
    (m, k) x (k, n) product: rows at least 17, K and N rounded up to
    multiples of 8."""
    up = lambda x: -(-x // INT_MM_MULTIPLE) * INT_MM_MULTIPLE  # noqa: E731
    return max(m, INT_MM_MIN_ROWS), up(k), up(n)


def int8_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, the exact sums of
    a8 @ w8.T: the operands padded with zero codes to
    `int_mm_padded_shape`, w8 handed over column-major."""
    m, k = a8.shape
    n = w8.shape[0]
    mp, kp, np_ = int_mm_padded_shape(m, k, n)
    if (mp, kp) != (m, k):
        a8 = F.pad(a8, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w8 = F.pad(w8, (0, kp - k, 0, np_ - n))
    y = torch._int_mm(a8.contiguous(), w8.contiguous().t())
    return y[:m, :n]


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


def quant_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor = None, group=None) -> torch.Tensor:
    """F.linear(x, weight, bias) with the product in int8: x (..., K) with
    a scale a row, weight (N, K) with a scale an output channel. `group`:
    the tensor-parallel group whose ranks hold the K slices of a
    row-parallel layer (module docstring); the bias is added once, after
    the sum."""
    dt = _compute_dtype(x)
    k = x.shape[-1]
    x8, ls = _quantize(x.to(dt), dims=-1, group=group)      # (..., 1)
    w8, rs = _quantize(weight.to(dt), dims=1, group=group)  # (N, 1)
    y = int8_matmul(x8.reshape(-1, k), w8).reshape(*x.shape[:-1], -1)
    if group is not None:
        # exact int32 sums; the padded product's view made contiguous
        y = group.all_reduce(y.contiguous())
    out = (y.float() * ls * rs.reshape(-1)).to(dt)
    return out if bias is None else out + bias.to(dt)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _im2col(x8: torch.Tensor, kh: int, kw: int, stride, padding):
    """(B, C, H, W) int8 -> ((B * Ho * Wo, C * kh * kw) int8, Ho, Wo):
    each output position's window, zero codes past the border, in the
    (C, kh, kw) order of an OIHW weight."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    b, c, h, w = x8.shape
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    if kh == kw == 1 and (sh, sw) == (1, 1) and (ph, pw) == (0, 0):
        return x8.permute(0, 2, 3, 1).reshape(-1, c), ho, wo
    xp = F.pad(x8, (pw, pw, ph, ph))
    cols = torch.stack([xp[:, :, i:i + sh * (ho - 1) + 1:sh,
                           j:j + sw * (wo - 1) + 1:sw]
                        for i in range(kh) for j in range(kw)], dim=2)
    return cols.permute(0, 3, 4, 1, 2).reshape(b * ho * wo, -1), ho, wo


def quant_conv2d(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor = None,
                 stride: Union[int, Sequence[int]] = 1,
                 padding: Union[int, Sequence[int]] = 0,
                 groups: int = 1) -> torch.Tensor:
    """F.conv2d (NCHW, OIHW) with the product in int8: one activation
    scale for the whole tensor, one weight scale an output channel.
    A grouped or depthwise convolution runs F.conv2d, as JAX's does."""
    if groups != 1:
        return F.conv2d(x, weight, bias, stride, padding, groups=groups)
    dt = _compute_dtype(x)
    b = x.shape[0]
    o, _, kh, kw = weight.shape
    x8, ls = _quantize(x.to(dt), dims=(0, 1, 2, 3))    # (1, 1, 1, 1)
    w8, rs = _quantize(weight.to(dt), dims=(1, 2, 3))  # (O, 1, 1, 1)
    cols, ho, wo = _im2col(x8, kh, kw, stride, padding)
    y = int8_matmul(cols, w8.reshape(o, -1)).reshape(b, ho, wo, o)
    out = (y.float() * ls * rs.reshape(-1)).to(dt)
    if bias is not None:
        out = out + bias.to(dt)
    return out.permute(0, 3, 1, 2)


class QuantLinear(nn.Linear):
    """nn.Linear whose forward is `quant_linear` while `quant` is set."""

    quant = False

    def forward(self, x):
        if self.quant:
            return quant_linear(x, self.weight, self.bias)
        return super().forward(x)


class QuantConv2d(nn.Conv2d):
    """nn.Conv2d (zero padding, no dilation) whose forward is
    `quant_conv2d` while `quant` is set."""

    quant = False

    def forward(self, x):
        if self.quant:
            return quant_conv2d(x, self.weight, self.bias, self.stride,
                                self.padding, self.groups)
        return super().forward(x)


def _quant_modules(module: nn.Module) -> Iterator[nn.Module]:
    return (m for m in module.modules()
            if isinstance(m, (QuantLinear, QuantConv2d)))


def set_quant(module: nn.Module, on: bool) -> nn.Module:
    """Set the int8 flag of every QuantLinear / QuantConv2d in `module`."""
    for m in _quant_modules(module):
        m.quant = bool(on)
    return module


@contextlib.contextmanager
def quant_mode(module: nn.Module, on: bool):
    """`set_quant(module, on)` for the duration of the block; each flag
    is restored after."""
    mods = list(_quant_modules(module))
    before = [m.quant for m in mods]
    for m in mods:
        m.quant = bool(on)
    try:
        yield module
    finally:
        for m, q in zip(mods, before):
            m.quant = q
