"""The collectives of multi-process training and serving, built from two
of torch.distributed's: `all_reduce` (SUM, or MAX) and `broadcast`.

A gather is an all_reduce SUM of zero-filled full tensors into which
each rank has written its own slice (x + 0 is exact, so the result is
each rank's values bitwise; a -0.0 comes back as +0.0). One code path
then runs over NCCL on the card, over gloo on the CPU, and over gloo
with several ranks on one card, where gloo carries only these two
collectives for CUDA tensors. No collective chooses another route at
run time. A MAX gives the absmax of a tensor-parallel slice's int8 and
int4 scales, and an int32 SUM the exact int8 partial sums of a
row-parallel product (`ops/int8.quant_linear`); both are counted by
kind, beside the float SUMs.

`Group` is one axis of the mesh as seen from one rank: the process
group of the ranks that share this rank's other coordinate, its size,
and this rank's index on it. `make_mesh` gives a group of size 1 no
process group: its collectives return their input, and that is the
world-1 path (a Group built on a one-rank process group does call it).
Every call is counted in the mesh's `CollectiveStats` (calls, bytes,
seconds); with `timed` set, each call synchronises the card before and
after, so its seconds are device time and not the time to enqueue.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

SUM = dist.ReduceOp.SUM
MAX = dist.ReduceOp.MAX
# the flat buffers of `all_reduce_flat` and `gather_flat` hold at most
# this many elements (256 MiB of f32), so a sweep over a large model
# adds at most one such buffer to its memory
BUCKET_NUMEL = 1 << 26


@dataclasses.dataclass
class CollectiveStats:
    """What the collectives of one mesh cost: calls, bytes reduced or
    broadcast, and seconds on the host's clock (device seconds when
    `timed`); `kinds` counts the calls by reduction and dtype ("max
    float32", "sum int32", ...; "broadcast")."""

    timed: bool = False
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    kinds: Dict[str, int] = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0
        self.kinds = {}


class Group:
    """One mesh axis from one rank (module docstring)."""

    def __init__(self, pg, ranks: Sequence[int], index: int,
                 stats: CollectiveStats):
        self.pg = pg
        self.ranks = list(ranks)       # global ranks, in axis order
        self.size = len(self.ranks)
        self.index = index
        self.stats = stats

    def _run(self, fn, t: torch.Tensor, kind: str):
        if self.stats.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn()
        if self.stats.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.stats.seconds += time.perf_counter() - t0
        self.stats.calls += 1
        self.stats.bytes += t.numel() * t.element_size()
        self.stats.kinds[kind] = self.stats.kinds.get(kind, 0) + 1
        return out

    def all_reduce(self, t: torch.Tensor, op=SUM) -> torch.Tensor:
        """In-place reduction over the group (SUM, or MAX), outside
        autograd; returns t."""
        if self.pg is not None:
            kind = f"{'max' if op == MAX else 'sum'} {str(t.dtype)[6:]}"
            self._run(lambda: dist.all_reduce(t, op, group=self.pg), t,
                      kind)
        return t

    def all_reduce_grad(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the group that autograd differentiates: the backward
        sums the output's gradient over the group (SyncBatchNorm's
        reduction of the statistics' gradients)."""
        if self.pg is None:
            return t
        from torch.distributed.nn.functional import all_reduce

        return self._run(lambda: all_reduce(t, SUM, group=self.pg), t,
                         f"sum {str(t.dtype)[6:]}")

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place, from the group's member `src` (an axis index)."""
        if self.pg is not None:
            self._run(lambda: dist.broadcast(t, self.ranks[src],
                                             group=self.pg), t, "broadcast")
        return t

    def barrier(self, device) -> None:
        """Every member reaches this point before any leaves it: an
        all_reduce of one zero."""
        self.all_reduce(torch.zeros(1, device=device))

    def all_reduce_flat(self, tensors: Sequence[torch.Tensor]) -> None:
        """SUM each tensor over the group in place, through flat buffers
        of at most BUCKET_NUMEL elements (one collective a bucket)."""
        if self.pg is None:
            return
        for bucket in _buckets(tensors):
            ts = [tensors[i] for i in bucket]
            flat = torch.cat([t.reshape(-1) for t in ts])
            self.all_reduce(flat)
            for t, v in zip(ts, _views(flat, ts)):
                t.copy_(v)

    def gather_flat(self, fulls: Sequence[torch.Tensor],
                    writes: Sequence[Callable[[torch.Tensor], Any]]
                    ) -> None:
        """Assemble full tensors from the members' slices: for each
        bucket of `fulls`, a zero-filled flat buffer, into whose view
        shaped as fulls[i] `writes[i]` writes this rank's slice; the SUM
        over the group is copied into fulls[i]."""
        if self.pg is None:
            return
        for bucket in _buckets(fulls):
            ts = [fulls[i] for i in bucket]
            flat = torch.zeros(sum(t.numel() for t in ts), dtype=ts[0].dtype,
                               device=ts[0].device)
            views = _views(flat, ts)
            for i, v in zip(bucket, views):
                writes[i](v)
            self.all_reduce(flat)
            for t, v in zip(ts, views):
                t.copy_(v)


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of consecutive runs of one dtype and device, at most
    BUCKET_NUMEL elements each (a larger tensor is a bucket of its
    own)."""
    out: List[List[int]] = []
    n = 0
    for i, t in enumerate(tensors):
        head = tensors[out[-1][0]] if out else None
        if (head is not None and n + t.numel() <= BUCKET_NUMEL
                and t.dtype == head.dtype and t.device == head.device):
            out[-1].append(i)
            n += t.numel()
        else:
            out.append([i])
            n = t.numel()
    return out


def _views(flat: torch.Tensor, like: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    views, o = [], 0
    for t in like:
        views.append(flat[o:o + t.numel()].view(t.shape))
        o += t.numel()
    return views


def fsdp_slice(t: torch.Tensor, dim: Optional[int], index: int,
               size: int) -> torch.Tensor:
    """The view of `t` that member `index` of `size` holds when `t` is
    sharded along `dim` (contiguous equal blocks); `t` itself when `dim`
    is None (replicated)."""
    if dim is None:
        return t
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n)
