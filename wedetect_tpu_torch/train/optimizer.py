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

Over a `parallel/mesh.Mesh` (`Optimizer.shard`), the step is the JAX
package's over its mesh, where `fsdp_sharding` shards the parameters
and the optax state (ZeRO-3):
- with an fsdp axis above 1 the parameters are already this rank's
  slices (`parallel/fsdp.shard_params`: each marked with its full shape,
  sharded along the axis `parallel/mesh.fsdp_spec` picks, whole where
  no axis divides), and so are their gradients;
- the gradients are summed over the data group (the ranks that hold the
  same slices; each rank's loss is its share of the global batch's,
  `train/losses.py`), through flat buffers;
- `mu`, `nu` and the MultiSteps accumulator hold the same slices, and
  each rank updates its slice of each parameter in place: nothing is
  gathered after the step;
- `grad_norm` and the clip read the norm of the full gradient: the
  slices' squares summed over the fsdp group, the whole tensors' counted
  once. Squares and sums are taken in f64 and the root rounded to f32,
  so the norm does not depend on how the gradient is cut (the f32 sum
  of one process and the sharded sum would differ in the last bits).
`state_dict` gathers the full moments to the host (every rank must call
it) and `load_state_dict` takes full moments and keeps this rank's
slices, so a checkpoint moves between meshes of any shape.
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
        self.mesh = None
        self.specs: List[Optional[int]] = [None] * len(self.params)
        self.shapes = [tuple(t.shape) for t in self.params]
        self.mu = [torch.zeros_like(t) for t in self.params]
        self.nu = [torch.zeros_like(t) for t in self.params]
        self.acc: List[torch.Tensor] = []
        self._reduced = False

    def shard(self, mesh) -> "Optimizer":
        """Run over `mesh` (module docstring): this rank keeps its
        slices of the state it holds now. With an fsdp axis above 1 the
        parameters must be this rank's slices already
        (`parallel/fsdp.shard_params`). Returns self."""
        from wedetect_tpu_torch.parallel.fsdp import full_shape
        from wedetect_tpu_torch.parallel.mesh import fsdp_spec

        size = mesh.shape["fsdp"]
        self.mesh = mesh
        self.shapes = [full_shape(p) for p in self.params]
        self.specs = [fsdp_spec(s, size) for s in self.shapes]
        whole = [self.paths[i] for i, (p, d) in enumerate(
            zip(self.params, self.specs))
            if d is not None and tuple(p.shape) == self.shapes[i]]
        if whole:
            raise ValueError(
                f"fsdp = {size}: the parameters must be this rank's slices "
                f"(parallel/fsdp.shard_params); whole: {whole[:4]}")

        def local(ts):
            # a slice is copied (its full tensor is then freed); a tensor
            # that is already local only moves to its parameter's device
            out = []
            for i, t in enumerate(ts):
                x = self._local(t, i)
                out.append(x.to(self.params[i].device, copy=x is not t))
            return out

        self.mu, self.nu, self.acc = (local(self.mu), local(self.nu),
                                      local(self.acc))
        return self

    def _local(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of a tensor shaped as the full params[i]; a
        tensor shaped as the slice is already local."""
        if self.specs[i] is None or tuple(t.shape) != self.shapes[i]:
            return t
        from wedetect_tpu_torch.parallel.collectives import fsdp_slice

        g = self.mesh.fsdp_group
        return fsdp_slice(t, self.specs[i], g.index, g.size)

    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.shape["fsdp"] > 1

    def grads(self) -> List[torch.Tensor]:
        return [torch.zeros_like(t) if t.grad is None else t.grad
                for t in self.params]

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Sum the gradients over the mesh's data group, in place (each
        rank's `.grad` then holds the global batch's gradient); once per
        backward, before reading the gradients. A no-op without a data
        group of several ranks."""
        if self.mesh is not None and not self._reduced:
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.mesh.data_group.all_reduce_flat(
                [p.grad for p in self.params])
        self._reduced = True

    def _norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The norm of the full gradient whose local slices are `grads`:
        the sharded slices' squares summed over the fsdp group (module
        docstring)."""
        if not self._sharded():
            return global_norm(grads)
        dev = grads[0].device
        sharded = torch.zeros(1, dtype=torch.float64, device=dev)
        whole = torch.zeros((), dtype=torch.float64, device=dev)
        for g, d in zip(grads, self.specs):
            if d is None:
                whole = whole + _square_sum(g)
            else:
                sharded = sharded + _square_sum(g)
        self.mesh.fsdp_group.all_reduce(sharded)
        return torch.sqrt(sharded[0] + whole).float()

    @torch.no_grad()
    def grad_norm(self) -> torch.Tensor:
        """The global norm of this backward's gradients (summed over the
        data group first), the frozen tensors' included."""
        self.reduce_grads()
        return self._norm([self._local(g, i)
                           for i, g in enumerate(self.grads())])

    @torch.no_grad()
    def step(self) -> None:
        self.reduce_grads()
        self._reduced = False
        grads = [self._local(g, i) for i, g in enumerate(self.grads())]
        if self.accum_steps > 1:
            if not self.acc:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            if n < self.accum_steps - 1:
                self.mini_step += 1
                return
            grads = self.acc
        if self.grad_clip_norm:
            norm = self._norm(grads)
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
            ps = self._local(p, i)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.decay[i] and self.weight_decay:
                u = u + self.weight_decay * ps
            if self.mults[i] != 1.0:
                u = u * self.mults[i]
            ps.add_(u * -lr)
        self.count = t
        if self.accum_steps > 1:
            self.mini_step = 0
            for a in self.acc:
                a.zero_()

    def _full(self, state: List[torch.Tensor]) -> List[torch.Tensor]:
        """Full host tensors from every rank's slices of `state`."""
        if not self._sharded() or not state:
            return state
        from wedetect_tpu_torch.parallel.fsdp import gather_full

        return gather_full(self.mesh, state, self.specs, self.shapes)

    def state_dict(self) -> dict:
        """The state with full moments (a collective over the fsdp group
        when sharded: every rank calls it)."""
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self._full(self.mu), "nu": self._full(self.nu),
                "acc": self._full(self.acc)}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for dst, src in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            for i, (d, s) in enumerate(zip(dst, src, strict=True)):
                d.copy_(self._local(s, i))
        self.acc = [self._local(a, i).to(p.device, copy=True)
                    for i, (a, p) in enumerate(zip(state["acc"],
                                                   self.params))]


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """The f64 sum of g's squares (exact squares of f32 entries)."""
    d = g.detach().reshape(-1).double()
    return torch.dot(d, d)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm),
    accumulated in f64 and rounded to f32 (module docstring)."""
    return torch.sqrt(sum(_square_sum(g) for g in grads)).float()


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
