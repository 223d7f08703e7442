"""The ("data", "fsdp") rank layout of multi-process training.

Port of `wedetect_tpu/parallel/mesh.py`'s data and fsdp axes (the
reference trains the detector with DDP + SyncBN and WeDetect-Ref with
torchrun + DeepSpeed ZeRO). The JAX package runs one global-view step
over a device mesh; here each process is one rank of a
torch.distributed world, and the step computes on its own rows what
the global-view step computes on the global batch:

- "data": the batch is split over the data axis in contiguous rows
  (`shard_batch`); BatchNorm takes its statistics over the data group
  (`nn/layers.BatchNorm2d`), the detector's loss normalisers are global
  sums, and the gradients are summed over the data group
  (`train/optimizer.Optimizer`).
- "fsdp": the optimizer's state (Adam's moments, the accumulator) is
  stored as this rank's slice by `fsdp_spec`, JAX's largest-axis rule;
  each rank updates its slice and the parameters are re-assembled by
  the collectives' gather.

Rank r sits at (d, f) with r = d * fsdp + f, as
`np.asarray(devices).reshape(data, fsdp)` lays the devices out. Every
collective is an all_reduce or a broadcast (`parallel/collectives.py`).
The process group is joined by `eval/dist.maybe_initialize`, and only
there.

Tensor-parallel serving (`make_tp_mesh`, `ref_tp_sharding`) is not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from wedetect_tpu_torch.parallel.collectives import CollectiveStats, Group


class Mesh:
    """This rank's place on a (data, fsdp) layout of the world:
    `shape` {"data": D, "fsdp": F}, `rank`, `data_index` (d) and
    `fsdp_index` (f), the axis groups `data_group` (the D ranks that
    share f), `fsdp_group` (the F ranks that share d) and `world_group`,
    and the `stats` of every collective they run."""

    def __init__(self, data: int, fsdp: int, rank: int,
                 groups: Dict[str, Any]):
        self.shape = {"data": data, "fsdp": fsdp}
        self.rank = rank
        self.data_index, self.fsdp_index = divmod(rank, fsdp)
        self.stats = CollectiveStats()
        d, f = self.data_index, self.fsdp_index
        self.data_group = Group(groups.get(("data", f)),
                                [i * fsdp + f for i in range(data)], d,
                                self.stats)
        self.fsdp_group = Group(groups.get(("fsdp", d)),
                                [d * fsdp + j for j in range(fsdp)], f,
                                self.stats)
        self.world_group = Group(groups.get("world"),
                                 list(range(data * fsdp)), rank,
                                 self.stats)

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of n rows;
        raises where the data axis does not divide n."""
        d = self.shape["data"]
        if n % d:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"data = {d} ranks")
        k = n // d
        return slice(self.data_index * k, (self.data_index + 1) * k)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, "
                f"fsdp={self.shape['fsdp']}, rank={self.rank})")


def make_mesh(data: int = -1, fsdp: int = 1) -> Mesh:
    """The ("data", "fsdp") layout over the torch.distributed world (a
    world of one where no process group is joined); data=-1 takes the
    ranks that fsdp leaves. Every rank must call it, in the same order
    as its other group creations: it creates the axis groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if fsdp < 1 or world % fsdp:
        raise ValueError(f"fsdp={fsdp} does not divide the world of "
                         f"{world} ranks")
    if data == -1:
        data = world // fsdp
    if data * fsdp != world:
        raise ValueError(f"data x fsdp = {data}x{fsdp} != {world} ranks")
    groups: Dict[Any, Any] = {}
    if world > 1:
        # dist.new_group is collective over the world: every rank
        # creates every group, in one order
        for d in range(data):
            ranks = [d * fsdp + f for f in range(fsdp)]
            pg = dist.new_group(ranks) if fsdp > 1 else None
            groups[("fsdp", d)] = pg
        for f in range(fsdp):
            ranks = [d * fsdp + f for d in range(data)]
            pg = dist.new_group(ranks) if data > 1 else None
            groups[("data", f)] = pg
        groups["world"] = dist.group.WORLD
    return Mesh(data, fsdp, rank, groups)


def fsdp_spec(shape: Sequence[int], size: int) -> Optional[int]:
    """The axis a tensor of `shape` is sharded along over an fsdp axis
    of `size` ranks, or None (replicated): JAX's `fsdp_sharding` rule,
    the largest axis (the first of equal ones) that `size` divides."""
    if size == 1 or len(shape) == 0:
        return None
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % size == 0 and shape[d] >= size:
            return d
    return None


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch: Any, rows: int) -> Any:
    """This rank's rows of a global host batch of `rows` rows (numpy
    arrays or tensors, in dicts, tuples and NamedTuples): each leaf
    whose leading dim is `rows` split over "data" in contiguous blocks.
    Every other leaf (a shared (K, C) text bank) stays whole, as the
    global view that JAX's shard_batch lays out computes on it."""
    sl = mesh.rows(rows)

    def take(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == rows:
            return x[sl]
        return x

    return _tree_map(take, batch)


def replicate_tree(mesh: Mesh, tree: Any) -> Any:
    """Broadcast every tensor of `tree` from rank 0, in place (a state
    dict's tensors share storage with the module's, so this replicates
    a model); returns the tree. numpy leaves and scalars are left as
    they are."""
    def put(x):
        if isinstance(x, torch.Tensor):
            mesh.world_group.broadcast(x.data, 0)
        return x

    _tree_map(put, tree)
    return tree

