"""Training checkpoints: save, restore and find the latest.

Port of `wedetect_tpu/ckpt/io.py`'s train-state half, with torch.save in
place of orbax. A checkpoint is a directory (`<ckpt_dir>/step_<n>`, as
in the JAX package) holding `train_state.pt`: the step, the model's
state dict and the optimizer's state (Adam moments, applied-update
count, accumulation state). It is written to a temporary name and
renamed, so a crash never leaves a half-written checkpoint.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_FILE = "train_state.pt"


def save_train_state(path: str, state) -> None:
    """Full training checkpoint of a train/train_step.TrainState (the
    reference's HF resume_from_checkpoint carries the same —
    sft_referring.py:439-443)."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save({"step": int(state.step),
                "model": state.model.state_dict(),
                "opt_state": state.tx.state_dict()}, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def restore_train_state(path: str, state):
    """Restore into an existing TrainState (its model and optimizer give
    the structure and the device), in place; returns it."""
    device = next(state.model.parameters()).device
    tree = torch.load(os.path.join(path, _FILE), map_location=device,
                      weights_only=True)
    state.model.load_state_dict(tree["model"], strict=True)
    state.tx.load_state_dict(tree["opt_state"])
    state.step = int(tree["step"])
    return state


def latest_checkpoint(root: str) -> Optional[str]:
    """The highest-numbered step directory under root (HF
    get_last_checkpoint semantics — sft_referring.py:439-443)."""
    if not os.path.isdir(root):
        return None
    steps = [int(name[5:]) for name in os.listdir(root)
             if name.startswith("step_") and name[5:].isdigit()]
    if not steps:
        return None
    return os.path.join(root, f"step_{max(steps)}")
