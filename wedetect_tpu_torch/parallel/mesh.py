"""The rank layouts of multi-process training and tensor-parallel serving.

Port of `wedetect_tpu/parallel/mesh.py` (the reference trains the
detector with DDP + SyncBN and WeDetect-Ref with torchrun + DeepSpeed
ZeRO). The JAX package runs one global-view program over a device mesh;
here each process is one rank of a torch.distributed world, and computes
on its own rows or its own slices what the global-view program computes
on the whole. Training runs on a ("data", "fsdp") layout (`make_mesh`):

- "data": the batch is split over the data axis in contiguous rows
  (`shard_batch`); BatchNorm takes its statistics over the data group
  (`nn/layers.BatchNorm2d`), the detector's loss normalisers are global
  sums, and the gradients are summed over the data group
  (`train/optimizer.Optimizer`).
- "fsdp": the parameters, their gradients and the optimizer's state
  (Adam's moments, the accumulator) are stored as this rank's slice by
  `fsdp_spec`, JAX's largest-axis rule (ZeRO-3, `parallel/fsdp.py`):
  each unit of the model is gathered for its forward and again for its
  backward, and each rank updates only its slices.

Tensor-parallel serving of the Ref runs on a ("data", "tp") layout
(`make_tp_mesh`), each "tp" group holding one copy of the model in the
Megatron layout of JAX's `ref_tp_sharding` (`ref_tp_spec`): the
projections whose output carries heads or ffn channels by column (q, k,
v, gate, up; the ViT's qkv and fc1, the mergers' fc1), those that
contract them back to the hidden width by row (o, down; the ViT's proj
and fc2, the mergers' fc2), the token table over the vocabulary, and
everything else (norms, the patch embed and pos-embed table, the
grounding extras, `out_proj`, an untied `lm_head`) whole. A rank runs
its own heads; a row-parallel layer's partial products are summed over
the group (`row_linear`, one all_reduce a block), its bias added once
after the sum; a token lookup gives zero rows outside the rank's
vocabulary range, then an all_reduce (`vocab_embed`); the tied LM head's
logits are gathered to the whole vocabulary (`gather_vocab`) before
anything reads them, so every rank samples the same token. Where JAX's
global view shards a tensor only as a layout, the port's local view
differs:
- the ViT's fused qkv is sliced by head inside each third (rank t takes
  heads [t h / tp, (t + 1) h / tp) of q, of k and of v), where JAX's
  P(None, "tp") splits the fused columns in contiguous blocks;
- the biases of column-parallel layers are sliced with their outputs,
  which JAX replicates;
- `tp` must divide every sharded width (the decoder's heads, kv heads
  and ffn width, the ViT's heads, ffn and merger widths, the
  vocabulary: `check_ref_tp` raises), where JAX replicates a tensor whose
  width tp does not divide. For ref_2b and ref_4b, tp in {1, 2, 4, 8};
- a quantized decode tree (models/quant.quantize_decode_params of a TP
  model) holds the rank's slices of the codes and scales, laid out as
  the layers it replaces (a rank holds 1 / tp of the codes), where JAX's
  rule replicates the tree (its leaves are `w8`, `scale`, `w4p`, not
  `kernel`, so they fall to P()).
The port's TP layers run for inference only. Under the int8 prefill
(`RefCfg.quant_int8`) a row-parallel QuantLinear takes its absmax
scales as MAXes and its int32 sums as SUMs over the group
(`ops/int8.quant_linear(group=)`), so every int8 product is the
one-process product bitwise. The mergers' fc2 stays a float
row-parallel layer there, summed in f32 as in JAX's global view: its
rounding can move an int8 code downstream, so the TP int8 score logits
are the one-process call's to within that, not bitwise (they are
bitwise once that fc2 is computed whole:
tests/test_torch_tp_quant.py, chip_smoke.py tp_serve).

Rank r sits at (d, f) with r = d * fsdp + f (r = d * tp + t), as
`np.asarray(devices).reshape(data, fsdp)` lays the devices out. Every
collective is an all_reduce (SUM, or MAX) or a broadcast
(`parallel/collectives.py`).
The process group is joined by `eval/dist.maybe_initialize`, and only
there.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from wedetect_tpu_torch.ops.int8 import quant_linear
from wedetect_tpu_torch.parallel.collectives import (CollectiveStats, Group,
                                                     fsdp_slice)


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


def _world_layout(data: int, n: int, axis: str):
    """(data, rank, groups) of a (data, axis) layout of n ranks an axis
    over the world; every rank creates every group, in one order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n < 1 or world % n:
        raise ValueError(f"{axis}={n} does not divide the world of "
                         f"{world} ranks")
    if data == -1:
        data = world // n
    if data * n != world:
        raise ValueError(f"data x {axis} = {data}x{n} != {world} ranks")
    groups: Dict[Any, Any] = {}
    if world > 1:
        # dist.new_group is collective over the world: every rank
        # creates every group, in one order
        for d in range(data):
            ranks = [d * n + f for f in range(n)]
            pg = dist.new_group(ranks) if n > 1 else None
            groups[(axis, d)] = pg
        for f in range(n):
            ranks = [d * n + f for d in range(data)]
            pg = dist.new_group(ranks) if data > 1 else None
            groups[("data", f)] = pg
        groups["world"] = dist.group.WORLD
    return data, rank, groups


def make_mesh(data: int = -1, fsdp: int = 1) -> Mesh:
    """The ("data", "fsdp") layout over the torch.distributed world (a
    world of one where no process group is joined); data=-1 takes the
    ranks that fsdp leaves. Every rank must call it, in the same order
    as its other group creations: it creates the axis groups."""
    data, rank, groups = _world_layout(data, fsdp, "fsdp")
    return Mesh(data, fsdp, rank, groups)


class TpMesh:
    """This rank's place on a (data, tp) layout of the world: `shape`
    {"data": D, "tp": T}, `rank`, `data_index` (d) and `tp_index` (t),
    the groups `tp` (the T ranks that share d and hold one copy of the
    model between them), `data_group` and `world_group`, and the
    `stats` of every collective they run."""

    def __init__(self, data: int, tp: int, rank: int,
                 groups: Dict[str, Any]):
        self.shape = {"data": data, "tp": tp}
        self.rank = rank
        self.data_index, self.tp_index = divmod(rank, tp)
        self.stats = CollectiveStats()
        d, t = self.data_index, self.tp_index
        self.tp = Group(groups.get(("tp", d)),
                        [d * tp + j for j in range(tp)], t, self.stats)
        self.data_group = Group(groups.get(("data", t)),
                                [i * tp + t for i in range(data)], d,
                                self.stats)
        self.world_group = Group(groups.get("world"),
                                 list(range(data * tp)), rank, self.stats)

    def __repr__(self) -> str:
        return (f"TpMesh(data={self.shape['data']}, "
                f"tp={self.shape['tp']}, rank={self.rank})")


def make_tp_mesh(data: int = 1, tp: int = -1) -> TpMesh:
    """The ("data", "tp") layout over the torch.distributed world;
    tp=-1 takes the ranks that data leaves. Every rank must call it, in
    the same order as its other group creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp == -1:
        if data < 1 or world % data:
            raise ValueError(f"data={data} does not divide the world of "
                             f"{world} ranks")
        tp = world // data
    data, rank, groups = _world_layout(data, tp, "tp")
    return TpMesh(data, tp, rank, groups)


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
    they are. Host tensors under nccl go through the card one at a
    time (a model replicated on the host before `parallel/fsdp.
    shard_params` never sits whole on the card)."""
    hop = (mesh.world_group.pg is not None
           and dist.get_backend(mesh.world_group.pg) == "nccl")

    def put(x):
        if isinstance(x, torch.Tensor):
            if hop and not x.is_cuda:
                y = x.data.to(torch.cuda.current_device())
                mesh.world_group.broadcast(y, 0)
                x.data.copy_(y)
            else:
                mesh.world_group.broadcast(x.data, 0)
        return x

    _tree_map(put, tree)
    return tree



# ------------------------------------------------------ tensor parallel
# JAX's rule (wedetect_tpu/parallel/mesh.py:86-121) on the port's HF key
# names: the parent module of a 2-D weight names its layout
_TP_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "qkv",
           "linear_fc1")
_TP_ROW = ("o_proj", "down_proj", "proj", "linear_fc2")
# the two towers; the grounding extras, out_proj and lm_head stay whole
_TP_TOWERS = ("model.visual.", "model.language_model.")


def ref_tp_spec(key: str, shape: Sequence[int], tp: int) -> Optional[str]:
    """How JAX's `ref_tp_sharding` shards the Ref tensor of port key
    `key` over `tp` ranks: "column" (a Linear weight's output rows),
    "row" (its input columns), "vocab" (the token table's rows) or None
    (whole). 1-D tensors, tensors outside the two towers and widths tp
    does not divide are whole, as in JAX."""
    if tp == 1 or len(shape) < 2 or not key.startswith(_TP_TOWERS):
        return None
    parent, name = key.split(".")[-2:]
    if name != "weight":
        return None
    if parent == "embed_tokens":
        return "vocab" if shape[0] % tp == 0 else None
    if len(shape) == 2:
        if parent in _TP_COL and shape[0] % tp == 0:
            return "column"
        if parent in _TP_ROW and shape[1] % tp == 0:
            return "row"
    return None


def ref_tp_kind(key: str, shapes: Mapping[str, Sequence[int]],
                tp: int) -> Optional[str]:
    """How a rank slices the tensor `key` of a Ref state dict whose
    tensors have `shapes`: its weight's `ref_tp_spec`, the bias of a
    column-parallel layer with its outputs, and the ViT's fused qkv
    (weight and bias) as "qkv", by head inside each third."""
    weight = key[:-len("bias")] + "weight" if key.endswith(".bias") else key
    if weight not in shapes:
        return None
    kind = ref_tp_spec(weight, shapes[weight], tp)
    if key != weight and kind != "column":
        return None
    if kind == "column" and weight.endswith("attn.qkv.weight"):
        return "qkv"
    return kind


def ref_tp_slice(t: torch.Tensor, kind: Optional[str], index: int,
                 size: int) -> torch.Tensor:
    """Member `index`'s view of `t` under `kind` (ref_tp_kind) over
    `size` ranks; "qkv" takes block `index` of each third."""
    if kind is None:
        return t
    if kind == "qkv":
        return torch.cat([fsdp_slice(part, 0, index, size)
                          for part in t.chunk(3, dim=0)])
    return fsdp_slice(t, 1 if kind == "row" else 0, index, size)


def check_ref_tp(cfg, tp: int) -> None:
    """Raise unless `tp` ranks can each hold whole heads and equal
    slices of every width the Megatron layout shards (module
    docstring)."""
    v, t = cfg.vision, cfg.text
    widths = {"decoder heads": t.heads, "decoder kv heads": t.kv_heads,
              "decoder ffn width": t.intermediate,
              "vocabulary": t.vocab_size, "ViT heads": v.heads,
              "ViT ffn width": v.intermediate,
              "merger width": v.hidden * v.merge ** 2}
    bad = [f"{n} {w}" for n, w in widths.items() if tp < 1 or w % tp]
    if bad:
        raise ValueError(f"tp={tp} does not divide the Ref's "
                         + ", ".join(bad))


def shard_ref_state(state_dict: Mapping[str, torch.Tensor], mesh,
                    cfg=None) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full Ref state dict (contiguous copies,
    on the tensors' device), to load into RefModules(cfg, tp=mesh.tp);
    `cfg` checks the layout first (check_ref_tp)."""
    size, index = mesh.shape["tp"], mesh.tp_index
    if cfg is not None:
        check_ref_tp(cfg, size)
    shapes = {k: tuple(v.shape) for k, v in state_dict.items()}
    return {k: ref_tp_slice(v, ref_tp_kind(k, shapes, size), index,
                            size).contiguous()
            for k, v in state_dict.items()}


def active_tp(tp: Optional[Group]) -> Optional[Group]:
    """The group a model's TP layers reduce over: None for no group or a
    group of one rank (the one-process path)."""
    return tp if tp is not None and tp.size > 1 else None


def tp_size(tp: Optional[Group]) -> int:
    return 1 if tp is None else tp.size


def row_sum(tp: Optional[Group], y: torch.Tensor) -> torch.Tensor:
    """The sum over the tp group of a row-parallel layer's partial
    products, in place; y itself where tp is None."""
    if tp is not None:
        tp.all_reduce(y)
    return y


def row_linear(lin, x: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """A Linear whose weight holds this rank's input columns: the
    partial product summed over the tp group (`row_sum`), then the bias
    once; an int8 QuantLinear (`quant` set) through
    ops/int8.quant_linear(group=tp). tp None: lin(x)."""
    if tp is None:
        return lin(x)
    if torch.is_grad_enabled():
        raise NotImplementedError(
            "the tensor-parallel layers run for inference only: call "
            "them under torch.inference_mode() or torch.no_grad()")
    if getattr(lin, "quant", False):
        # the int8 prefill: MAX scales and an int32 sum over the group
        return quant_linear(x, lin.weight, lin.bias, tp)
    y = row_sum(tp, F.linear(x, lin.weight))
    return y if lin.bias is None else y + lin.bias


def vocab_embed(table: torch.Tensor, ids: torch.Tensor,
                tp: Optional[Group]) -> torch.Tensor:
    """Rows of a token table holding this rank's vocabulary range
    [tp.index n, (tp.index + 1) n): zero rows for the ids outside it,
    then the sum over the group (each id's row comes from one rank, so
    the result is its row bitwise)."""
    if tp is None:
        return F.embedding(ids, table)
    n = table.shape[0]
    local = ids - tp.index * n
    inside = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table)
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    return tp.all_reduce(rows)


def gather_vocab(local: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """Logits over this rank's vocabulary range (..., V / tp) -> over the
    whole vocabulary (..., V) on every rank: an all_reduce of zero-filled
    buffers, each rank's values bitwise."""
    if tp is None:
        return local
    n = local.shape[-1]
    full = local.new_zeros(local.shape[:-1] + (n * tp.size,))
    full[..., tp.index * n:(tp.index + 1) * n] = local
    return tp.all_reduce(full)
