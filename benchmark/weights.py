"""Seeded weights, made on the device in one draw.

A model's state dict is planned from a module tree built on the meta
device (names and shapes only): each tensor is either drawn from a
normal distribution at a standard deviation of its own, or filled with
a constant. All the drawn tensors are slices of one `torch.randn` call
from a `torch.Generator` on the device, so a seed gives the same weights
whatever the tree's size, and the set-up costs one kernel, not one a
tensor. The same dict loads into the program and into the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

# (kind, value): ("normal", std) or ("const", fill)
Rule = Tuple[str, float]


def plan(module: nn.Module, rule: Callable[[str, nn.Module, str,
                                            torch.Tensor], Rule]
         ) -> List[Tuple[str, torch.Size, Rule]]:
    """[(state-dict name, shape, rule)] for every parameter and buffer
    of `module`, in named_modules order."""
    out = []
    for mname, m in module.named_modules():
        tensors = list(m.named_parameters(recurse=False)) + list(
            m.named_buffers(recurse=False))
        for pname, t in tensors:
            name = f"{mname}.{pname}" if mname else pname
            out.append((name, t.shape, rule(mname, m, pname, t)))
    return out


def materialize(entries, seed: int, device, dtype=torch.float32
                ) -> Dict[str, torch.Tensor]:
    """The state dict of a plan: one normal draw of every "normal"
    element, sliced and scaled per tensor; constants filled."""
    device = torch.device(device)
    total = sum(shape.numel() for _, shape, (kind, _) in entries
                if kind == "normal")
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, (kind, value) in entries:
        n = shape.numel()
        if kind == "normal":
            out[name] = flat[at:at + n].view(shape).mul_(value)
            at += n
        elif kind == "const":
            out[name] = torch.full(shape, value, device=device,
                                   dtype=torch.int64 if name.endswith(
                                       "num_batches_tracked") else dtype)
        else:
            raise ValueError(kind)
    return out


def lecun_std(fan_in: int) -> float:
    return fan_in ** -0.5
