"""Optimizer construction with the reference's param-group rules.

Port of `wedetect_tpu/train/optimizer.py` (reference
wedetect/engine/optimizers/yolow_v5_optim_constructor.py:18-196): AdamW
with batch-size-scaled weight decay, no decay on 1-D params and on
bias/scale-like names, per-path lr multipliers, an optional global-norm
clip and gradient accumulation.

The JAX package builds an optax chain over a param pytree; `Optimizer`
applies the same chain to a list of tensors, step for step:
[clip_by_global_norm] -> scale_by_adam (eps outside the sqrt, bias
correction by the applied-update count) -> masked add_decayed_weights ->
the per-path lr multiplier -> the learning rate of the schedule at the
applied-update count (negated), added to the params in place. With
`with_grad_accum` it is `optax.MultiSteps`: gradients are averaged over
`accum_steps` micro-steps (Welford mean) and the chain, its count and
the schedule advance only on applied updates.

The masks and multipliers read each tensor's JAX param path ("/"-joined,
e.g. "vision/block0/qkv/kernel"): callers pass (path, tensor) pairs, so
the JAX segment rule applies unchanged (for WeDetect-Ref the paths come
from `ckpt/convert_ref.jax_param_paths`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

Schedule = Callable[[int], float]
NamedParams = Iterable[Tuple[str, torch.Tensor]]


def decay_mask(named_params: NamedParams) -> List[bool]:
    """True where weight decay applies: ndim >= 2 (conv/linear kernels,
    embeddings), excluding anything named bias/scale/alpha/gamma."""
    out = []
    for path, x in named_params:
        name = path.lower()
        out.append(x.dim() >= 2 and not any(
            name.endswith(bad) for bad in ("bias", "scale", "alpha", "gamma",
                                           "logit_scale")))
    return out


def lr_multiplier(path: str, custom_lr_mults: Optional[Dict[str, float]]
                  ) -> float:
    """The multiplier of the last key that matches `path` as a full
    segment (or segment sequence when the key holds "/"); 1 when none
    does. Segment matching keeps "vision" off
    "extras/object_vision_projector"."""
    segs = path.split("/")
    m = 1.0
    for key, v in (custom_lr_mults or {}).items():
        ks = key.split("/")
        if any(segs[i:i + len(ks)] == ks
               for i in range(len(segs) - len(ks) + 1)):
            m = v
    return m


def make_lr_schedule(base_lr: float, total_steps: int,
                     warmup_steps: int = 0, schedule: str = "cosine",
                     final_lr_ratio: float = 0.01) -> Schedule:
    """Linear warmup from 0 then cosine/linear decay to
    base_lr * final_lr_ratio, or constant after warmup (optax's
    cosine_decay_schedule, linear_schedule and join_schedules)."""
    decay_steps = max(total_steps - warmup_steps, 1)
    end = base_lr * final_lr_ratio

    def main(count: int) -> float:
        c = min(count, decay_steps)
        if schedule == "cosine":
            cos = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
            return base_lr * ((1 - final_lr_ratio) * cos + final_lr_ratio)
        if schedule == "linear":
            return (base_lr - end) * (1 - c / decay_steps) + end
        return base_lr

    if schedule not in ("cosine", "linear", "constant"):
        raise ValueError(schedule)
    if warmup_steps <= 0:
        return main

    def joined(count: int) -> float:
        if count >= warmup_steps:
            return main(count - warmup_steps)
        return base_lr * min(count, warmup_steps) / warmup_steps

    return joined


class Optimizer:
    """The optax chain of `make_optimizer` over a list of tensors (module
    docstring). `step()` reads each tensor's `.grad` (None counts as a
    zero gradient, as JAX differentiates every leaf) and updates the
    tensors in place."""

    def __init__(self, named_params: NamedParams, lr, *, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 custom_lr_mults: Optional[Dict[str, float]] = None,
                 grad_clip_norm: Optional[float] = None):
        named = list(named_params)
        self.paths = [p for p, _ in named]
        self.params = [t for _, t in named]
        self.lr: Schedule = lr if callable(lr) else (lambda c, v=lr: v)
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.decay = decay_mask(named)
        self.mults = [lr_multiplier(p, custom_lr_mults) for p in self.paths]
        self.grad_clip_norm = grad_clip_norm
        self.accum_steps = 1
        self.count = 0          # applied updates (optax's inner count)
        self.mini_step = 0      # MultiSteps' micro-step within an update
        self.mu = [torch.zeros_like(t) for t in self.params]
        self.nu = [torch.zeros_like(t) for t in self.params]
        self.acc: List[torch.Tensor] = []

    def grads(self) -> List[torch.Tensor]:
        return [torch.zeros_like(t) if t.grad is None else t.grad
                for t in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = self.grads()
        if self.accum_steps > 1:
            if not self.acc:
                self.acc = [torch.zeros_like(t) for t in self.params]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            if n < self.accum_steps - 1:
                self.mini_step += 1
                return
            grads = self.acc
        if self.grad_clip_norm:
            norm = global_norm(grads)
            if not bool(norm < self.grad_clip_norm):
                grads = [g / norm * self.grad_clip_norm for g in grads]
        t = self.count + 1
        bc1, bc2 = 1 - self.b1 ** t, 1 - self.b2 ** t
        lr = self.lr(self.count)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            mu, nu = self.mu[i], self.nu[i]
            mu.mul_(self.b1).add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1 - self.b2))
            if self.mults[i] == 0.0:
                continue        # a frozen tensor: the update is exactly 0
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.decay[i] and self.weight_decay:
                u = u + self.weight_decay * p
            if self.mults[i] != 1.0:
                u = u * self.mults[i]
            p.add_(u * -lr)
        self.count = t
        if self.accum_steps > 1:
            self.mini_step = 0
            for a in self.acc:
                a.zero_()

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for dst, src in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            for d, s in zip(dst, src, strict=True):
                d.copy_(s)
        self.acc = [a.to(p.device) for a, p in zip(state["acc"],
                                                    self.params)]


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def with_grad_accum(tx: Optimizer, accum_steps: int) -> Optimizer:
    """Gradient accumulation (the reference optimizer wrapper's
    _accumulative_counts): updates apply every `accum_steps` steps."""
    tx.accum_steps = max(int(accum_steps), 1)
    return tx


def make_optimizer(named_params: NamedParams,
                   base_lr: float = 5e-4,
                   weight_decay: float = 0.05 / 2,
                   total_batch_size: int = 64,
                   base_total_batch_size: int = 64,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   lr_schedule: Optional[Schedule] = None,
                   custom_lr_mults: Optional[Dict[str, float]] = None,
                   grad_clip_norm: Optional[float] = None) -> Optimizer:
    """AdamW with masked, batch-scaled weight decay over (JAX path,
    tensor) pairs; custom_lr_mults {key: mult} as in `lr_multiplier`."""
    wd = weight_decay * total_batch_size / base_total_batch_size
    return Optimizer(named_params,
                     lr_schedule if lr_schedule is not None else base_lr,
                     betas=betas, weight_decay=wd,
                     custom_lr_mults=custom_lr_mults,
                     grad_clip_norm=grad_clip_norm)
