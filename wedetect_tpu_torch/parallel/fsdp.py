"""Parameter sharding (ZeRO-3) over a mesh's "fsdp" axis.

Port of the parameter half of JAX's `fsdp_sharding`
(`wedetect_tpu/parallel/mesh.py`), which the JAX training CLIs put on
the parameters as well as on the optimizer state. `shard_params` keeps,
on each rank, only its slice of every parameter that `fsdp_spec` shards
(the largest axis the fsdp size divides); a tensor no axis divides stays
whole, as JAX replicates it. The parameters keep their names and their
objects: `named_parameters()` and `state_dict()` give the one-process
keys, with this rank's slices as values.

A *unit* is a group of modules whose sharded parameters one flat
all_reduce assembles (`parallel/collectives.py`: a zero-filled buffer
into which each rank writes its slice; x + 0 is exact). The port's
units (`default_units`): for the detector each ConvNeXt block and
downsample layer, each neck submodule and each head tower and contrast
norm; for WeDetect-Ref the ViT's stem (patch embed and pos-embed table),
each ViT block, each merger, the grounding extras, the token table, each
decoder layer, and the head (final norm, out_proj, an untied lm_head).
A unit is the modules used together in one stretch of the forward, so
the forward gathers each unit once.

- Forward: reading a sharded parameter (`module.weight`, by attribute,
  wherever the read happens) makes its unit resident: the unit's slices
  are gathered into full tensors, which the modules compute with; the
  unit resident before it is dropped. One unit is resident at a time.
- Backward: the gather is a `torch.autograd.Function` (`_Gather`), whose
  backward narrows each full gradient to this rank's slice, so every
  leaf's `.grad` is a slice and a gradient that sums several uses is
  autograd's sum, in the one-process order, narrowed. Inside
  `forward_scope` a `saved_tensors_hooks` pair keeps autograd from
  holding the gathered tensors: a saved full tensor (or a view of one,
  or a cast of one, as bf16 autocast makes) is packed as a reference,
  and the unit is gathered again, once, when the backward first unpacks
  one; that copy is dropped when the unit's `_Gather` node has run.
- Every rank of the fsdp group issues the same gathers in the same
  order: the forward follows the module order and the backward
  autograd's, which is the same where the graphs have the same shape.

`full_state_dict` and `load_full_state_dict` move the one-process
layout in and out (a checkpoint), a unit at a time through the host.
`train/optimizer.Optimizer.shard` reads each parameter's full shape
(`full_shape`) and keeps its state in the same slices.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from wedetect_tpu_torch.parallel.collectives import (CollectiveStats,
                                                     fsdp_slice)

# the full shape of a sharded parameter, set on its object by shard_params
_FULL = "fsdp_full_shape"


def full_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The shape of the whole tensor of which `t` is a slice (`t`'s own
    shape for a tensor that is not a slice)."""
    return tuple(getattr(t, _FULL, None) or t.shape)


def mark_slice(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Record on `t` that it is a slice of a tensor of `shape`; returns
    t."""
    setattr(t, _FULL, tuple(shape))
    return t


class _Entry:
    """One sharded tensor of a unit: the slice (a Parameter), its axis
    and the full shape."""

    def __init__(self, param: torch.Tensor, dim: int, shape=None):
        self.param = param
        self.dim = dim
        self.shape = full_shape(param) if shape is None else tuple(shape)


class Unit:
    """Modules whose sharded parameters are gathered together (module
    docstring). `gathers` counts this unit's forward and backward
    gathers."""

    def __init__(self, name: str, entries: List[_Entry], owner: "Zero3"):
        self.name = name
        self.entries = entries
        self.owner = owner
        self.fulls: Optional[List[torch.Tensor]] = None
        self.instance: Optional[_Instance] = None
        self.gathers = [0, 0]

    def full(self, param: nn.Parameter) -> torch.Tensor:
        self.owner.activate(self)
        return self.fulls[self._index[id(param)]]

    def _index_entries(self) -> None:
        self._index = {id(e.param): k for k, e in enumerate(self.entries)}


class _Instance:
    """One forward gather of a unit: the buffers its full tensors view
    (while resident) and the backward's copy (while its backward runs)."""

    def __init__(self, unit: Unit):
        self.unit = unit
        self.bufs: Optional[List[torch.Tensor]] = None
        self.views: List[Tuple[int, int]] = []   # (buffer, offset)
        self.backward_bufs: Optional[List[torch.Tensor]] = None

    def assemble(self):
        """(buffers, full tensors): the unit's slices gathered into one
        zero-filled buffer a dtype, this rank's slices written in, one
        all_reduce each; the full tensors are views of the buffers."""
        unit, z = self.unit, self.unit.owner
        dtypes: List[torch.dtype] = []
        for e in unit.entries:
            if e.param.dtype not in dtypes:
                dtypes.append(e.param.dtype)
        sizes = [0] * len(dtypes)
        self.views = []
        for e in unit.entries:
            b = dtypes.index(e.param.dtype)
            self.views.append((b, sizes[b]))
            sizes[b] += _numel(e.shape)
        dev = unit.entries[0].param.device
        bufs = [torch.zeros(n, dtype=dt, device=dev)
                for n, dt in zip(sizes, dtypes)]
        fulls = [self._view(bufs, k) for k in range(len(unit.entries))]
        for e, f in zip(unit.entries, fulls):
            fsdp_slice(f, e.dim, z.index, z.size).copy_(e.param.detach())
        for b in bufs:
            z.all_reduce(b)
        return bufs, fulls

    def _view(self, bufs, k: int) -> torch.Tensor:
        b, o = self.views[k]
        shape = self.unit.entries[k].shape
        return bufs[b][o:o + _numel(shape)].view(shape)

    def regather(self) -> List[torch.Tensor]:
        """The backward's copy of the unit's buffers, gathered at the
        first call."""
        if self.backward_bufs is None:
            self.backward_bufs, _ = self.assemble()
            self.unit.gathers[1] += 1
        return self.backward_bufs


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


class _Gather(torch.autograd.Function):
    """slices -> full tensors (the unit's gather); backward: each full
    gradient narrowed to this rank's slice (a copy, so the full gradient
    is freed)."""

    @staticmethod
    def forward(ctx, inst, *slices):
        ctx.inst = inst
        ctx.set_materialize_grads(False)
        inst.bufs, fulls = inst.assemble()
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        inst = ctx.inst
        z = inst.unit.owner
        out = [None]
        for k, (e, g) in enumerate(zip(inst.unit.entries, grads)):
            if g is None or not ctx.needs_input_grad[k + 1]:
                out.append(None)
            else:
                out.append(fsdp_slice(g, e.dim, z.index, z.size).clone())
        inst.backward_bufs = None
        return tuple(out)


class _Saved:
    """A saved tensor packed as a reference into a unit's gather: a view
    of buffer `buf` (size, stride, offset), or a cast of full tensor
    `cast[1]` to dtype `cast[0]`."""

    __slots__ = ("inst", "buf", "geometry", "cast")

    def __init__(self, inst, buf=None, geometry=None, cast=None):
        self.inst, self.buf, self.geometry, self.cast = (inst, buf, geometry,
                                                         cast)


class Zero3:
    """A model's parameter sharding over `mesh`'s fsdp group: its units,
    the resident unit, and the gathers' cost (`stats`: calls, bytes,
    seconds, the mesh's own CollectiveStats counting them too)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.fsdp_group
        self.size, self.index = self.group.size, self.group.index
        self.units: List[Unit] = []
        self.resident: Optional[Unit] = None
        self.stats = CollectiveStats()
        self._live: Dict[int, Tuple[_Instance, int]] = {}

    # ------------------------------------------------------ gathering
    def all_reduce(self, buf: torch.Tensor) -> None:
        """The group's all_reduce, its cost added to `stats` too."""
        s = self.mesh.stats
        calls, nbytes, secs = s.calls, s.bytes, s.seconds
        self.group.all_reduce(buf)
        self.stats.calls += s.calls - calls
        self.stats.bytes += s.bytes - nbytes
        self.stats.seconds += s.seconds - secs

    def activate(self, unit: Unit) -> None:
        """Make `unit` resident (module docstring)."""
        grad = torch.is_grad_enabled()
        if self.resident is unit and (unit.instance is not None
                                      or not grad):
            return
        self.release()
        inst = _Instance(unit)
        if grad:
            fulls = list(_Gather.apply(inst, *(e.param
                                               for e in unit.entries)))
            for b, buf in enumerate(inst.bufs):
                self._live[buf.untyped_storage().data_ptr()] = (inst, b)
            unit.instance = inst
        else:
            _, fulls = inst.assemble()
            unit.instance = None
        unit.gathers[0] += 1
        unit.fulls = fulls
        self.resident = unit

    def release(self) -> None:
        """Drop the resident unit's full tensors."""
        unit = self.resident
        if unit is None:
            return
        inst = unit.instance
        if inst is not None and inst.bufs is not None:
            for buf in inst.bufs:
                self._live.pop(buf.untyped_storage().data_ptr(), None)
            inst.bufs = None
        unit.fulls, unit.instance, self.resident = None, None, None

    # --------------------------------------------------- saved tensors
    def _pack(self, t: torch.Tensor):
        if not self._live or t.layout != torch.strided:
            return t
        try:
            ptr = t.untyped_storage().data_ptr()
        except RuntimeError:
            return t
        hit = self._live.get(ptr)
        if hit is not None:
            inst, b = hit
            return _Saved(inst, buf=b, geometry=(tuple(t.shape), t.stride(),
                                                 t.storage_offset()))
        fn = t.grad_fn
        if fn is not None and type(fn).__name__ == "ToCopyBackward0":
            src, k = fn.next_functions[0]
            inst = getattr(src, "inst", None)
            if (isinstance(inst, _Instance) and inst.bufs is not None
                    and tuple(t.shape) == inst.unit.entries[k].shape):
                return _Saved(inst, cast=(t.dtype, k))
        return t

    @staticmethod
    def _unpack(s):
        if not isinstance(s, _Saved):
            return s
        bufs = s.inst.regather()
        if s.cast is not None:
            dtype, k = s.cast
            return s.inst._view(bufs, k).to(dtype)
        size, stride, offset = s.geometry
        return bufs[s.buf].as_strided(size, stride, offset)

    @contextlib.contextmanager
    def scope(self):
        with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                      self._unpack):
            try:
                yield
            finally:
                self.release()

    # ----------------------------------------------------------- cost
    def gathers(self) -> Dict[str, List[int]]:
        """{unit name: [forward gathers, backward gathers]} since the
        last `reset`."""
        return {u.name: list(u.gathers) for u in self.units}

    def reset(self) -> None:
        self.stats.reset()
        for u in self.units:
            u.gathers = [0, 0]


def _getattr(cls):
    base = cls.__mro__[1]

    def __getattr__(self, name):
        attrs = self.__dict__.get("_fsdp_attrs")
        if attrs is not None and name in attrs:
            unit, param = attrs[name]
            return unit.full(param)
        return base.__getattr__(self, name)

    return __getattr__


_SHARDED_CLASSES: Dict[type, type] = {}


def _sharded_class(cls: type) -> type:
    """cls with a __getattr__ that returns the gathered full tensor of a
    sharded parameter (the parameter itself stays in `_parameters`)."""
    if cls not in _SHARDED_CLASSES:
        sub = type(cls.__name__, (cls,), {"__module__": cls.__module__})
        sub.__getattr__ = _getattr(sub)
        _SHARDED_CLASSES[cls] = sub
    return _SHARDED_CLASSES[cls]


def default_units(model: nn.Module) -> List[Tuple[str, List[nn.Module]]]:
    """The port's units of `model` (module docstring): the detector's or
    the Ref's; another model must be given its units."""
    from wedetect_tpu_torch.models.ref import RefModules
    from wedetect_tpu_torch.models.wedetect import WeDetectModule

    if isinstance(model, WeDetectModule):
        return det_units(model)
    if isinstance(model, RefModules):
        return ref_units(model)
    raise TypeError(f"no default units for {type(model).__name__}: pass "
                    f"units=[(name, [modules]), ...]")


def det_units(model) -> List[Tuple[str, List[nn.Module]]]:
    bb, head = model.backbone, model.bbox_head
    units = []
    for i, (down, stage) in enumerate(zip(bb.downsample_layers,
                                          bb.stages)):
        units.append((f"backbone.down{i}", [down]))
        units += [(f"backbone.stage{i}.{j}", [blk])
                  for j, blk in enumerate(stage)]
    if hasattr(model, "down_mlp"):
        units.append(("down_mlp", [model.down_mlp]))
    units += [(f"neck.{n}", [m]) for n, m in model.neck.named_children()]
    for i, (cls, contrast, reg) in enumerate(zip(
            head.cls_preds, head.cls_contrasts, head.reg_preds)):
        units += [(f"head.cls{i}", [cls]), (f"head.contrast{i}", [contrast]),
                  (f"head.reg{i}", [reg])]
    return units


def ref_units(model) -> List[Tuple[str, List[nn.Module]]]:
    g = model.model
    vis, lm = g.visual, g.language_model
    units = [("vision.stem", [vis.patch_embed, vis.pos_embed])]
    units += [(f"vision.block{i}", [b]) for i, b in enumerate(vis.blocks)]
    units += [(f"vision.deepstack{j}", [m])
              for j, m in enumerate(vis.deepstack_merger_list)]
    units.append(("vision.merger", [vis.merger]))
    units.append(("extras", [g.image_pos_projector,
                             g.object_vision_projector,
                             g.object_pos_projector, g.first_scale_conv1,
                             g.first_scale_conv2, g.second_scale_conv,
                             g.first_scale_norm, g.merge]))
    units.append(("embed", [lm.embed_tokens]))
    units += [(f"layer{i}", [l]) for i, l in enumerate(lm.layers)]
    head = [lm.norm, model.out_proj]
    if model.lm_head is not None:
        head.append(model.lm_head)
    units.append(("head", head))
    return units


def shard_params(model: nn.Module, mesh, units=None,
                 device=None) -> Optional[Zero3]:
    """Keep this rank's fsdp slice of every parameter of `model` that
    `fsdp_spec` shards (module docstring), on `device` (default: where
    each tensor is; a meta tensor becomes an empty one there), and the
    other tensors and the buffers whole on `device`. `units`: (name,
    modules) pairs, `default_units(model)` by default; parameters of
    modules outside them form the unit "rest". Returns the Zero3 (also
    `model.zero3`), or None where the fsdp axis is 1. A model already
    sharded over `mesh` is returned as it is."""
    from wedetect_tpu_torch.parallel.mesh import fsdp_spec

    if mesh is None or mesh.shape["fsdp"] == 1:
        return None
    z = getattr(model, "zero3", None)
    if z is not None:
        if z.mesh is not mesh:
            raise ValueError("the model is already sharded over another "
                             "mesh")
        return z
    dev = None if device is None else torch.device(device)
    z = Zero3(mesh)
    units = list(default_units(model) if units is None else units)
    owner: Dict[int, Tuple[_Entry, Unit]] = {}
    seen = set()
    members = []
    for name, mods in units:
        members.append((name, [s for m in mods for s in m.modules()]))
        seen.update(id(s) for s in members[-1][1])
    rest = [m for m in model.modules() if id(m) not in seen]
    if any(p is not None for m in rest for p in m._parameters.values()):
        members.append(("rest", rest))
    for name, mods in members:
        unit = Unit(name, [], z)
        for m in mods:
            for attr, p in list(m._parameters.items()):
                if p is None:
                    continue
                key = id(p)
                if key not in owner:
                    dim = fsdp_spec(tuple(p.shape), z.size)
                    p = m._parameters[attr] = _place(p, dim, z, dev)
                    if dim is None:
                        continue
                    owner[key] = (_Entry(p, dim), unit)
                    unit.entries.append(owner[key][0])
                # a parameter two modules share belongs to the first unit
                entry, home = owner[key]
                p = m._parameters[attr] = entry.param
                if m.__dict__.get("_fsdp_attrs") is None:
                    m.__class__ = _sharded_class(type(m))
                    m._fsdp_attrs = {}
                m._fsdp_attrs[attr] = (home, p)
        unit._index_entries()
        if unit.entries:
            z.units.append(unit)
    for m in model.modules():
        for key, b in list(m._buffers.items()):
            if b is not None and dev is not None:
                m._buffers[key] = (torch.empty_like(b, device=dev) if b.is_meta
                                   else b.to(dev))
    model.zero3 = z
    return z


def _place(p: nn.Parameter, dim: Optional[int], z: Zero3,
           dev) -> nn.Parameter:
    """p with its data made its slice (dim given) or left whole, on dev;
    a meta parameter becomes a new, empty one there."""
    target = p.device if dev is None else dev
    shape = tuple(p.shape)
    local = list(shape)
    if dim is not None:
        local[dim] //= z.size
    with torch.no_grad():
        if p.is_meta:
            p = nn.Parameter(torch.empty(local, dtype=p.dtype,
                                         device=target),
                             requires_grad=p.requires_grad)
        elif dim is None:
            p.data = p.data.to(target)
        else:
            p.data = fsdp_slice(p.data, dim, z.index, z.size).to(
                target, copy=True).contiguous()
    if dim is not None:
        mark_slice(p, shape)
    return p


def forward_scope(model: nn.Module):
    """The context a training forward runs in: with parameter sharding,
    the saved-tensor hooks that keep gathered tensors out of autograd's
    saved state, and the resident unit dropped on exit; otherwise
    nothing."""
    z = getattr(model, "zero3", None)
    return contextlib.nullcontext() if z is None else z.scope()


def _chunks(entries: Sequence[_Entry], limit: int) -> Iterable[List[_Entry]]:
    run, n = [], 0
    for e in entries:
        if run and (n + _numel(e.shape) > limit
                    or e.param.dtype != run[0].param.dtype):
            yield run
            run, n = [], 0
        run.append(e)
        n += _numel(e.shape)
    if run:
        yield run


def gather_full(mesh, tensors: Sequence[torch.Tensor],
                dims: Sequence[Optional[int]],
                shapes: Sequence[Sequence[int]]) -> List[torch.Tensor]:
    """Full host copies of `tensors` (this rank's slices along `dims` of
    tensors of `shapes`; a None dim is a whole tensor, copied), gathered
    over the mesh's fsdp group in flat buffers of at most BUCKET_NUMEL
    elements: the card holds one buffer at a time. Every rank of the
    group calls it."""
    from wedetect_tpu_torch.parallel.collectives import BUCKET_NUMEL

    z = Zero3(mesh)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    entries, where = [], {}
    for i, (t, d, shape) in enumerate(zip(tensors, dims, shapes)):
        if d is None:
            out[i] = t.detach().to("cpu", copy=True)
        else:
            entries.append(_Entry(t, d, shape))
            where[id(entries[-1])] = i
    for run in _chunks(entries, BUCKET_NUMEL):
        _, fulls = _Instance(Unit("", run, z)).assemble()
        for e, f in zip(run, fulls):
            # a copy: on the host too, so the flat buffer is freed here
            out[where[id(e)]] = f.to("cpu", copy=True)
        del _, fulls
    return out


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` in the one-process layout, on the host: the
    sharded parameters gathered over the fsdp group (every rank calls
    it), the other entries copied. Without sharding, the state dict."""
    z = getattr(model, "zero3", None)
    if z is None:
        return model.state_dict()
    sd = model.state_dict(keep_vars=True)
    keys = list(sd)
    fulls = gather_full(z.mesh, [sd[k] for k in keys],
                        [_dim_of(z, sd[k]) for k in keys],
                        [full_shape(sd[k]) for k in keys])
    return dict(zip(keys, fulls))


def _dim_of(z: Zero3, t: torch.Tensor) -> Optional[int]:
    from wedetect_tpu_torch.parallel.mesh import fsdp_spec

    shape = full_shape(t)
    if shape == tuple(t.shape):
        return None
    return fsdp_spec(shape, z.size)


def load_full_state_dict(model: nn.Module,
                         state: Dict[str, torch.Tensor]) -> None:
    """Load a one-process state dict (any device) into `model`: each
    sharded parameter takes this rank's slice of its full tensor; the
    keys must match (strict)."""
    z = getattr(model, "zero3", None)
    if z is None:
        model.load_state_dict(state, strict=True)
        return
    own = model.state_dict(keep_vars=True)
    missing = set(own) ^ set(state)
    if missing:
        raise ValueError(f"state dict keys differ: {sorted(missing)[:8]}")
    with torch.no_grad():
        for k, t in own.items():
            src = state[k]
            if tuple(src.shape) != full_shape(t):
                raise ValueError(f"{k}: shape {tuple(src.shape)}, "
                                 f"{full_shape(t)} expected")
            d = _dim_of(z, t)
            t.copy_(src if d is None else fsdp_slice(src, d, z.index,
                                                     z.size))


def param_bytes(model: nn.Module) -> Dict[str, int]:
    """Bytes of the parameters this rank stores: `stored` in all,
    `sharded` of them slices, `whole` the rest."""
    sharded = whole = 0
    for p in model.parameters():
        n = p.numel() * p.element_size()
        if full_shape(p) != tuple(p.shape):
            sharded += n
        else:
            whole += n
    return {"stored": sharded + whole, "sharded": sharded, "whole": whole}
