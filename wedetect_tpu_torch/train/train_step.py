"""The train state, as far as WeDetect-Ref training needs it.

Port of `wedetect_tpu/train/train_step.TrainState`: the JAX state
carries the step counter, the params, the batch statistics, the optax
state and the transformation; here the model holds the params and
`train/optimizer.Optimizer` its own state, updating the params in
place. The detector's `loss_fn` and `train_step` are not ported yet.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from wedetect_tpu_torch.train.optimizer import Optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Optimizer

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer) -> "TrainState":
        return cls(step=0, model=model, tx=tx)
