"""Multi-process collectives for eval merges, on torch.distributed.

The port's `wedetect_tpu.eval.dist`: arbitrary picklable python objects
gathered from every process (reference eval_recall/eval_recall.py:
1566-1588, eval_retrieval/extract_embedding.py:1746-1775), rank and
world size for the contiguous shards. A single process (no process
group) gathers `[obj]` and is rank 0 of 1.
"""

from __future__ import annotations

import os
import sys
from typing import Any, List

import torch
import torch.distributed as dist

from wedetect_tpu_torch import resolve_device


def maybe_initialize(device="cuda") -> None:
    """Join the multi-process job when the launch environment says there
    is one: torchrun's RANK and WORLD_SIZE (with MASTER_ADDR and
    MASTER_PORT), or the explicit WEDETECT_DIST=1 opt-in (the init
    method from WEDETECT_DIST_INIT, default "env://"). nccl when
    `device` is a card (each process on LOCAL_RANK's card), gloo on the
    CPU. A world of one, or no such environment, stays single-process.
    Safe to call twice. This is the port's one join point: training
    (`parallel/mesh.make_mesh`) and the eval merges run on the group it
    joins."""
    env = os.environ
    if dist.is_initialized():
        return
    if env.get("WEDETECT_DIST") != "1" and not (
            "RANK" in env and "WORLD_SIZE" in env):
        return
    world = int(env.get("WORLD_SIZE", "1"))
    if world <= 1:
        print("# single-process run (WORLD_SIZE <= 1)", file=sys.stderr)
        return
    rank = int(env["RANK"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=env.get("WEDETECT_DIST_INIT", "env://"),
        rank=rank, world_size=world)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def all_gather_object(obj: Any) -> List[Any]:
    """Gather one picklable object from every process (ordered by rank).
    Single-process: returns [obj]."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()
