"""The runs of tests/test_torch_zero3.py that both sides of each
comparison execute: the gloo ranks (through torch_dist_util.run_ranks)
and the one-process runs in the test's own process. Pure torch and the
port; no JAX. Inputs are the files of torch_dist_train_util.load_inputs
(cfg.pkl, sd.pt, inputs.npz) under `out`."""

import contextlib
import time
import weakref

import numpy as np
import torch

from torch_dist_train_util import BATCH_KEYS, load_inputs
from wedetect_tpu_torch.ckpt import io as CIO
from wedetect_tpu_torch.parallel import fsdp
from wedetect_tpu_torch.parallel.collectives import fsdp_slice
from wedetect_tpu_torch.parallel.mesh import fsdp_spec, shard_batch
from wedetect_tpu_torch.train import train_step as TS

CONTROLS = ("zero_regather", "own_slice_only")


class GatherWatch:
    """Weak references to every buffer a unit gather makes: at each
    gather, how many buffers of earlier gathers are still alive (forward
    and backward alike). `max_alive` 0 means no rank ever held two
    units' full tensors at once. gloo's worker thread drops its own
    reference to an all_reduced buffer just after the call returns, so
    a count waits up to SETTLE_S for such references to go."""

    SETTLE_S = 0.5

    def __init__(self):
        self.refs = []
        self.max_alive = 0
        self._assemble = fsdp._Instance.assemble

    def __enter__(self):
        watch = self

        def assemble(inst):
            watch.max_alive = max(watch.max_alive, watch.alive())
            bufs, fulls = watch._assemble(inst)
            watch.refs += [weakref.ref(b) for b in bufs]
            return bufs, fulls

        fsdp._Instance.assemble = assemble
        return self

    def __exit__(self, *exc):
        fsdp._Instance.assemble = self._assemble

    def alive(self) -> int:
        end = time.monotonic() + self.SETTLE_S
        n = sum(r() is not None for r in self.refs)
        while n and time.monotonic() < end:
            time.sleep(0.001)
            n = sum(r() is not None for r in self.refs)
        return n


@contextlib.contextmanager
def broken_gathers(name):
    """The gathers broken as the control `name` says, for a run that
    must miss: `zero_regather` gives the backward zero-filled full
    tensors; `own_slice_only` leaves the other ranks' slices out of
    every gather (its all_reduce is skipped); None breaks nothing."""
    saved = fsdp._Instance.regather, fsdp.Zero3.all_reduce
    if name == "zero_regather":
        def regather(inst):
            if inst.backward_bufs is None:
                bufs, _ = inst.assemble()
                inst.backward_bufs = [torch.zeros_like(b) for b in bufs]
            return inst.backward_bufs

        fsdp._Instance.regather = regather
    elif name == "own_slice_only":
        fsdp.Zero3.all_reduce = lambda self, buf: None
    elif name is not None:
        raise ValueError(name)
    try:
        yield
    finally:
        fsdp._Instance.regather, fsdp.Zero3.all_reduce = saved


def storage(model, sd, mesh):
    """This rank's stored parameters against the one-process state dict
    `sd`: exact slices by fsdp_spec, their bytes, whether any sharded
    tensor is stored whole, and the parameter names."""
    size, index = mesh.shape["fsdp"], mesh.fsdp_index
    exact, want_bytes, whole = True, 0, []
    for n, p in model.named_parameters():
        d = fsdp_spec(tuple(sd[n].shape), size)
        want = fsdp_slice(sd[n], d, index, size)
        exact &= bool(p.device == want.device and torch.equal(p.detach(),
                                                              want))
        want_bytes += want.numel() * want.element_size()
        if d is not None and tuple(p.shape) == tuple(sd[n].shape):
            whole.append(n)
    return {"exact_slices": exact, "want_bytes": want_bytes,
            "bytes": fsdp.param_bytes(model), "whole": whole,
            "names": [n for n, _ in model.named_parameters()]}


def _record(res, mesh, model):
    """After a step: the gathers (reset for the next) and calls."""
    z = getattr(model, "zero3", None)
    if z is not None:
        res["gathers"].append(z.gathers())
        res["zero3_calls"].append(z.stats.calls)
        res["zero3_mb"].append(z.stats.bytes / 1e6)
        z.reset()
    if mesh is not None:
        res["calls"].append(mesh.stats.calls)
        mesh.stats.reset()


def full_grads(state, mesh):
    """{name: the step's summed gradient, gathered to its full shape}."""
    tx = state.tx
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in tx.params]
    if mesh is not None and mesh.shape["fsdp"] > 1:
        grads = fsdp.gather_full(mesh, grads, tx.specs, tx.shapes)
    names = [n for n, _ in state.model.named_parameters()]
    return {n: g.detach().clone() for n, g in zip(names, grads)}


def _finish(res, state, model):
    res["state"] = {k: v.clone() for k, v in
                    fsdp.full_state_dict(model).items()}
    res["mu"] = [t.clone() for t in state.tx.mu]
    res["nu"] = [t.clone() for t in state.tx.nu]
    res["specs"] = list(state.tx.specs)
    res["names"] = [n for n, _ in model.named_parameters()]
    return res


def _new_res():
    return {"metrics": [], "gathers": [], "zero3_calls": [], "zero3_mb": [],
            "calls": []}


def det_run(out, mesh, opt, steps=2):
    """`steps` detector train steps of the saved cfg and weights on the
    saved global batches over `mesh` (None: one process): metrics, the
    full state, this rank's moments (after the first step `mu1`, `nu1`)
    and their specs, the storage check, the gathers and collective calls
    a step, and `max_alive` (GatherWatch)."""
    from wedetect_tpu_torch.models.wedetect import WeDetectModule

    cfg, sd, inputs = load_inputs(out)
    model = WeDetectModule(cfg).eval()
    model.load_state_dict(sd)
    state = TS.TrainState.create(model, TS.det_optimizer(model, **opt),
                                 mesh)
    res = _new_res()
    if mesh is not None and mesh.shape["fsdp"] > 1:
        res["storage"] = storage(model, sd, mesh)
    if mesh is not None:
        mesh.stats.reset()
    with GatherWatch() as watch:
        for step in range(steps):
            b = tuple(inputs[f"{k}{step}"] for k in BATCH_KEYS)
            if mesh is not None:
                b = shard_batch(mesh, b, len(b[0]))
            state, m = TS.train_step(cfg, state, TS.Batch(*b))
            res["metrics"].append({k: float(v) for k, v in m.items()})
            _record(res, mesh, model)
            if step == 0:
                res["mu1"] = [t.clone() for t in state.tx.mu]
                res["nu1"] = [t.clone() for t in state.tx.nu]
                res["grads"] = full_grads(state, mesh)
                if mesh is not None:
                    mesh.stats.reset()      # not a step's collective
        res["max_alive"] = watch.max_alive
        res["alive_after"] = watch.alive()
    return _finish(res, state, model)


def ref_args(d):
    return (d["patches"], d["ids"], d["mask"], d["pos"],
            int(d["visual_start"]), d["boxes"], d["ori_wh"], d["obj"])


def ref_run(out, mesh, stage, lr, steps=2, ckpt=None, resume=None,
            control=None):
    """`steps` steps of the saved tiny Ref (stage 3: ref_sft_step, stage
    2: ref_lm_step through the tied head) over `mesh` (None: one
    process): as det_run, plus `ckpt` (save_train_state after the first
    step there), `resume` (restore_train_state from there first, then
    step to `steps`) and `control` (broken_gathers, for a run that must
    miss)."""
    from wedetect_tpu_torch.models.ref import RefModules
    from wedetect_tpu_torch.train import ref_lm as TLM
    from wedetect_tpu_torch.train import ref_sft as TSFT

    cfg, sd, d = load_inputs(out)
    model = RefModules(cfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    tx = (TSFT.ref_optimizer(model, lr) if stage == 3 else
          TLM.stage_optimizer(model, 2, base_lr=lr))
    state = TS.TrainState.create(model, tx, mesh)
    res = _new_res()
    if mesh is not None and mesh.shape["fsdp"] > 1:
        res["storage"] = storage(model, sd, mesh)
    if resume:
        state = CIO.restore_train_state(resume, state)
    if mesh is not None:
        mesh.stats.reset()
    with broken_gathers(control), GatherWatch() as watch:
        while state.step < steps:
            if stage == 3:
                state, m = TSFT.ref_sft_step(cfg, 8, 8, state,
                                             *ref_args(d), d["labels"],
                                             d["valid"])
            else:
                state, m = TLM.ref_lm_step(cfg, 8, 8, state, *ref_args(d),
                                           d["lm_labels"], 1)
            res["metrics"].append({k: float(v) for k, v in m.items()})
            _record(res, mesh, model)
            if state.step == 1 and ckpt:
                CIO.save_train_state(ckpt, state)
                if mesh is not None:
                    mesh.stats.reset()      # not a step's collective
        res["max_alive"] = watch.max_alive
        res["alive_after"] = watch.alive()
    res["mults"] = list(state.tx.mults)
    return _finish(res, state, model)


def lm_labels(ids, mask):
    """Stage-2 labels of the tiny batch: every real token supervises."""
    return np.where(mask > 0, ids, -100).astype(np.int32)
