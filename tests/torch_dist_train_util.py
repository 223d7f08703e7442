"""The runs of tests/test_torch_dist_train.py that both sides of each
comparison execute: the gloo ranks (through torch_dist_util.run_ranks)
and the one-process control in the test's own process. Pure torch and
the port; no JAX."""

import pickle

import numpy as np
import torch

from wedetect_tpu_torch.ckpt import io as CIO
from wedetect_tpu_torch.models import wedetect as TW
from wedetect_tpu_torch.nn.layers import BatchNorm2d
from wedetect_tpu_torch.parallel.fsdp import full_state_dict
from wedetect_tpu_torch.parallel.mesh import shard_batch
from wedetect_tpu_torch.train import train_step as TS

BATCH_KEYS = ("images", "texts", "gt_bboxes", "gt_labels", "gt_mask")


def load_inputs(out):
    with open(f"{out}/cfg.pkl", "rb") as f:
        cfg = pickle.load(f)
    return cfg, torch.load(f"{out}/sd.pt"), np.load(f"{out}/inputs.npz")


def _opt(model, opt):
    return TS.det_optimizer(model, **opt)


def det_run(out, mesh, rate, opt, steps=2, local_bn=False, ckpt=None,
            grads=False):
    """`steps` detector train steps of the saved cfg and weights (drop
    path at `rate`) on the saved global batches, over `mesh` (None: one
    process on the whole batch): metrics, parameters, BN statistics,
    this rank's moments (after the last step, and `mu1` / `nu1` after
    the first) and their specs; the parameters gathered to their full
    shapes where the fsdp axis shards them; `grads` adds the first step's
    summed gradients; `local_bn` gives the BatchNorms no group (each
    rank's own statistics: the control); `ckpt` writes the state after
    the first step there."""
    import dataclasses

    cfg, sd, inputs = load_inputs(out)
    cfg = dataclasses.replace(cfg, drop_path_rate=rate)

    def fresh():
        model = TW.WeDetectModule(cfg).eval()
        model.load_state_dict(sd)
        return TS.TrainState.create(model, _opt(model, opt), mesh)

    def batch(step):
        b = tuple(inputs[f"{k}{step}"] for k in BATCH_KEYS)
        return TS.Batch(*(b if mesh is None else
                          shard_batch(mesh, b, len(b[0]))))

    res = {"metrics": []}
    if grads:
        st = fresh()
        TS.loss_fn(cfg, st.model, batch(0),
                   TS.drop_path_generator(cfg, 0, "cpu"), mesh)[0].backward()
        st.tx.reduce_grads()
        res["grads"] = {n: p.grad.clone()
                        for n, p in st.model.named_parameters()}
    state = fresh()
    if local_bn:
        for m in state.model.modules():
            if isinstance(m, BatchNorm2d):
                m.group = None
    for step in range(steps):
        state, m = TS.train_step(cfg, state, batch(step))
        res["metrics"].append({k: float(v) for k, v in m.items()})
        if step == 0:
            res["mu1"] = [t.clone() for t in state.tx.mu]
            res["nu1"] = [t.clone() for t in state.tx.nu]
            if ckpt:
                CIO.save_train_state(ckpt, state)
    res["state"] = {k: v.clone() for k, v in
                    full_state_dict(state.model).items()}
    res["mu"] = [t.clone() for t in state.tx.mu]
    res["nu"] = [t.clone() for t in state.tx.nu]
    res["specs"] = list(state.tx.specs)
    res["names"] = [n for n, _ in state.model.named_parameters()]
    return res


def ref_run(out, mesh, lr, steps=2):
    """`steps` stage-3 SFT steps of the saved tiny Ref on the saved
    inputs over `mesh`: metrics, parameters (gathered to their full
    shapes), this rank's moments."""
    from wedetect_tpu_torch.models.ref import RefModules
    from wedetect_tpu_torch.train import ref_sft as TSFT

    cfg, sd, d = load_inputs(out)
    model = RefModules(cfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    state = TS.TrainState.create(model, TSFT.ref_optimizer(model, lr), mesh)
    args = (d["patches"], d["ids"], d["mask"], d["pos"],
            int(d["visual_start"]), d["boxes"], d["ori_wh"], d["obj"],
            d["labels"], d["valid"])
    res = {"metrics": []}
    for _ in range(steps):
        state, m = TSFT.ref_sft_step(cfg, 8, 8, state, *args)
        res["metrics"].append({k: float(v) for k, v in m.items()})
    full = full_state_dict(model)
    res["params"] = {n: full[n].clone() for n, _ in model.named_parameters()}
    res["mu"] = [t.clone() for t in state.tx.mu]
    res["nu"] = [t.clone() for t in state.tx.nu]
    res["specs"] = list(state.tx.specs)
    return res
