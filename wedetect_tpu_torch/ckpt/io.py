"""Checkpoints: a tree of tensors, the training state, and the latest
step.

Port of `wedetect_tpu/ckpt/io.py`, with torch.save in place of orbax.
`save_checkpoint` / `load_checkpoint` write and read a nested dict (or
list, tuple) of tensors in a directory (`checkpoint.pt`), as the JAX
package's orbax pair does for a pytree. A training checkpoint is a
directory (`<ckpt_dir>/step_<n>`, as in the JAX package) holding
`train_state.pt`: the step, the model's state dict (with the detector's
BN running statistics, its buffers) and the optimizer's state (Adam
moments, applied-update count, accumulation state). Each file is
written to a temporary name and renamed, so a crash never leaves a
half-written checkpoint.

Over a mesh (`TrainState.mesh`), `save_train_state` is called by every
rank: the sharded parameters and the optimizer's moments are gathered
to the host a bucket at a time (`parallel/fsdp.full_state_dict`,
`Optimizer.state_dict`) and rank 0 writes the one file, in the
one-process layout; the ranks leave together. `restore_train_state`
reads that file on the host (memory-mapped) on every rank and each
keeps its slices (`parallel/fsdp.load_full_state_dict`). So a checkpoint
written by W ranks resumes in one process, and the reverse.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

_FILE = "train_state.pt"
_TREE = "checkpoint.pt"


def _atomic_save(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, tree: Any) -> None:
    """Save a nested dict / list / tuple of tensors (and Python scalars)
    to the directory `path`."""
    os.makedirs(path, exist_ok=True)
    _atomic_save(tree, os.path.join(path, _TREE))


def load_checkpoint(path: str, like: Optional[Any] = None) -> Any:
    """The tree saved under `path`; with `like` (a tree of the same
    structure), each tensor lands on its `like` tensor's device and
    dtype, and a missing key or a shape that differs raises."""
    tree = torch.load(os.path.join(path, _TREE), map_location="cpu",
                      weights_only=True)
    return tree if like is None else _like(tree, like, "")


def _like(tree: Any, like: Any, where: str) -> Any:
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"checkpoint keys differ at {where or '/'}")
        return {k: _like(tree[k], v, f"{where}/{k}")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"checkpoint length differs at {where}")
        return type(like)(_like(t, l, f"{where}/{i}")
                          for i, (t, l) in enumerate(zip(tree, like)))
    if isinstance(like, torch.Tensor):
        if tuple(tree.shape) != tuple(like.shape):
            raise ValueError(f"{where}: shape {tuple(tree.shape)} in the "
                             f"checkpoint, {tuple(like.shape)} expected")
        return tree.to(device=like.device, dtype=like.dtype)
    return tree


def save_train_state(path: str, state) -> None:
    """Full training checkpoint of a train/train_step.TrainState (the
    reference's HF resume_from_checkpoint carries the same —
    sft_referring.py:439-443). Over a mesh every rank calls it and rank
    0 writes (module docstring)."""
    from wedetect_tpu_torch.parallel.fsdp import full_state_dict

    mesh = state.mesh
    tree = {"step": int(state.step),
            "model": full_state_dict(state.model),
            "opt_state": state.tx.state_dict()}
    if mesh is None or mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        _atomic_save(tree, os.path.join(path, _FILE))
    if mesh is not None:
        mesh.world_group.barrier(next(state.model.parameters()).device)


def restore_train_state(path: str, state):
    """Restore into an existing TrainState (its model and optimizer give
    the structure, the device and, over a mesh, this rank's slices), in
    place; returns it."""
    from wedetect_tpu_torch.parallel.fsdp import load_full_state_dict

    tree = torch.load(os.path.join(path, _FILE), map_location="cpu",
                      weights_only=True, mmap=True)
    load_full_state_dict(state.model, tree["model"])
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
