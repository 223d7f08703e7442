"""The control of the correctness check: a plain reference computed in
fp8 (e4m3), the precision below the configurations' bfloat16.

Every matmul and convolution of the model takes fp8 operands: the
weights of its Linear and convolution layers are rounded once, and the
input of each such layer's forward as it comes (two weights the
reference applies by hand, the Ref's patch embedding and transposed
convolutions, take their inputs unrounded), each tensor scaled by its
own absolute maximum (per-tensor scaling, 448 the largest e4m3 value). The
detector's contrastive product (region embeddings against class
embeddings) and the Ref's attention (q, k and v) round their operands
alike. Accumulation, norms, activations and softmax stay float32, as
an fp8 GEMM's would. The harness never runs this in a benchmark run;
`benchmark/readings.py` and the tests do.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
GEMM_LAYERS = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, nn.Conv3d)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, back in x's type."""
    if not x.is_floating_point() or x.numel() == 0:
        return x
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return ((x / scale).to(FP8).to(x.dtype)) * scale


def _round_args(module, args):
    return tuple(fp8(a) if isinstance(a, torch.Tensor) else a for a in args)


@contextlib.contextmanager
def fp8_operands(model: nn.Module, product_types=(), attention_owner=None):
    """The model computing with fp8 operands for the block: its GEMM
    layers' weights rounded in place (for good: the control builds its
    own copy of the reference), their inputs rounded by a pre-hook,
    every module of `product_types` given fp8 as its `operand` (the
    operands of its product alone, not what it returns), and
    `attention_owner`'s module-level `attention(q, k, v, mask)` given
    rounded q, k, v."""
    hooks = []
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GEMM_LAYERS):
                m.weight.copy_(fp8(m.weight))
                hooks.append(m.register_forward_pre_hook(_round_args))
    products = [m for m in model.modules()
                if isinstance(m, tuple(product_types))]
    for m in products:
        m.operand = fp8
    saved = None
    if attention_owner is not None:
        saved = attention_owner.attention

        def attention(q, k, v, mask):
            return saved(fp8(q), fp8(k), fp8(v), mask)

        attention_owner.attention = attention
    try:
        yield model
    finally:
        for h in hooks:
            h.remove()
        for m in products:
            m.operand = None
        if saved is not None:
            attention_owner.attention = saved
