"""Seeded random initialization from an explicit torch.Generator.

Modules are built on the meta device and materialized directly on the
target device, so a full-size model (the XLM-R vocabulary alone is 192M
weights) is initialized where it runs. Every parameter and buffer is
written exactly once; `init_module` raises if one is left unset.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from wedetect_tpu_torch.nn.convnext import ConvNeXtBlock, LayerNorm2d
from wedetect_tpu_torch.nn.head import ContrastiveScore
from wedetect_tpu_torch.nn.layers import BottleRep


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)


def init_module(module: nn.Module, seed: int, device) -> nn.Module:
    """Materialize `module` (built on the meta device) on `device` with
    random weights from torch.Generator(seed); return it in eval mode.

    Conv / Linear weights are LeCun-normal (flax's default), biases 0;
    embeddings N(0, 0.02); norms 1 / 0 with BN running stats 0 / 1;
    ConvNeXt layer scale 1e-6; BottleRep alpha 1; contrastive bias 0 and
    logit_scale at its constructor value; a learned prompt bank normal
    and L2-normalized.
    """
    device = torch.device(device)
    module = module.to_empty(device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    done = set()

    def put(t: torch.Tensor):
        done.add(id(t))
        return t

    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(put(m.weight), m.weight[0].numel(), g)
            elif isinstance(m, nn.ConvTranspose2d):
                _lecun_normal_(put(m.weight), m.weight.shape[0], g)
            elif isinstance(m, nn.Embedding):
                put(m.weight).normal_(0.0, 0.02, generator=g)
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, LayerNorm2d)):
                put(m.weight).fill_(1.0)
            if isinstance(m, nn.BatchNorm2d):
                put(m.running_mean).zero_()
                put(m.running_var).fill_(1.0)
                put(m.num_batches_tracked).zero_()
            if getattr(m, "bias", None) is not None and not isinstance(
                    m, ContrastiveScore):
                put(m.bias).zero_()
            if isinstance(m, ConvNeXtBlock):
                put(m.gamma).fill_(1e-6)
            elif isinstance(m, BottleRep):
                put(m.alpha).fill_(1.0)
            elif isinstance(m, ContrastiveScore):
                put(m.bias).zero_()
                put(m.logit_scale).fill_(-1.0 if m.use_bn
                                         else math.log(1 / 0.07))
        bank = getattr(module, "embeddings", None)
        if isinstance(bank, nn.Parameter):
            put(bank).normal_(0.0, 1.0, generator=g)
            bank /= torch.linalg.vector_norm(bank, dim=-1, keepdim=True)

    missed = [n for n, t in [*module.named_parameters(),
                             *module.named_buffers()] if id(t) not in done]
    if missed:
        raise RuntimeError(f"init_module: left uninitialized: {missed}")
    return module.eval()
