"""Parameter sharding (ZeRO-3) over the "fsdp" axis in the port
(`parallel/fsdp.py`; `train/optimizer.Optimizer.shard` on slices;
`ckpt/io.py` through the one-process layout), on the CPU: gloo ranks
(tests/torch_dist_util.py) with the same numpy-seeded inputs and JAX's
init carried across, against the one-process port and JAX's global-view
steps on meshes of the host devices tests/conftest.py forces.

- The detector (mini_cfg, global B = 4, two steps, lr 1e-4) at fsdp = 2
  (data = 1) and, in a world of 4, at data = 2 x fsdp = 2. The latter
  against JAX's train_step on make_mesh(data=2, fsdp=2) with the
  parameters and optax state on `fsdp_sharding` (fsdp = 2 against JAX is
  tests/test_torch_dist_train.py's, on the same sharded step): the
  rules of
  tests/test_torch_dist_train.py (metrics 1e-5 relative, grad_norm
  1e-4, num_pos exactly; gradients 1e-4 of each tensor's largest entry
  or one f32 ulp of the model's largest; parameters 1e-5 relative +
  1e-6 on all but 0.1%, every entry within 2 * steps * lr; BN statistics
  within 1e-6 + 0.1 * 2 * steps * lr; the first moments' slices within
  1e-4 / 2e-4 of each tensor's largest entry or the gradient rule's
  bound). Against the port without parameter sharding, bitwise: fsdp = 2
  against one process; data = 2 x fsdp = 2 against data = 2 (each rank
  of a data index against that data rank): metrics, parameters, BN
  statistics, the gradients and the moment slices.
- The tiny Ref, fsdp = 2, stage 3 (`ref_sft_step`) and stage 2
  (`ref_lm_step`, whose LM head is the tied token table): bitwise the
  one-process port; stage 2 against JAX's `ref_lm_step` on
  make_mesh(data=1, fsdp=2) by tests/test_torch_train_ref.py's rules
  (loss and grad_norm 1e-5 relative, parameters 1e-5 relative + 1e-6 on
  all but 0.1% and within 2 * steps * lr * mult; moment slices 1e-4 of
  each tensor's largest entry). Stage 3 against JAX is
  tests/test_torch_dist_train_ref.py's.
- Storage: each rank's parameters are exactly its `fsdp_spec` slices
  under the one-process names, their bytes the slices' sum; no two
  units' gathered tensors are ever alive at once, and none after a step.
- Collectives a step: two gathers a unit (one forward, one backward;
  none in the backward of a unit whose backward reads no weight: the
  Ref's ViT stem and token table, whose lookups save only indices; the
  token table twice forward and once backward at stage 2, for the tied
  head), plus the norm's one call, plus what the data axis costs without
  parameter sharding.
- Controls that must miss: a backward on zero-filled re-gathers, a
  gather that leaves out the other rank's slice, and a rank that issues
  one extra gather (the ranks' order mismatched: gloo fails, under a
  timeout of its own).
- Checkpoints: a fsdp = 2 run's checkpoint is bitwise the one-process
  run's; it resumes in one process and at fsdp = 2, and a one-process
  checkpoint resumes at fsdp = 2, each bitwise the uninterrupted run.
"""

import pickle
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_dist_train import (LR, STEPS, _adam_state, _GradModel,
                                   _metrics_close, _moments_close,
                                   _params_close, global_batch)
from test_torch_train_det import (assert_grads_close, cfgs, jax_variables,
                                  jgrads_as_port)
from torch_dist_util import run_ranks
from torch_ref_util import batch as ref_batch
from torch_ref_util import cfgs as ref_cfgs
from torch_ref_util import jax_params as ref_jax_params
from torch_zero3_util import CONTROLS, det_run, lm_labels, ref_run
from wedetect_tpu.parallel import mesh as JM
from wedetect_tpu.train import optimizer as JO
from wedetect_tpu.train import ref_lm as JLM
from wedetect_tpu.train.train_step import Batch as JBatch
from wedetect_tpu.train.train_step import TrainState as JState
from wedetect_tpu.train.train_step import train_step as j_train_step
from wedetect_tpu_torch.ckpt.convert import from_jax_variables
from wedetect_tpu_torch.ckpt.convert_ref import from_jax_ref_params
from wedetect_tpu_torch.parallel.collectives import fsdp_slice
from wedetect_tpu_torch.parallel.mesh import make_mesh

OPT = dict(base_lr=LR, weight_decay=0.025, total_batch_size=4)
REF_LR = 1e-3
# the Ref's units whose backward reads no gathered weight
NO_BACKWARD_GATHER = {3: {"vision.stem": [1, 0], "embed": [1, 0]},
                      2: {"vision.stem": [1, 0], "embed": [2, 1]}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ detector
DET_RANKS = r"""
from torch_zero3_util import det_run
from wedetect_tpu_torch.parallel.mesh import make_mesh

opt = dict(base_lr=float(ARGS[0]), weight_decay=0.025, total_batch_size=4)
layouts = {4: {"data2_fsdp2": (2, 2)},
           2: {"fsdp2": (1, 2), "data2": (2, 1)}}[WORLD]
res = {k: det_run(OUT, make_mesh(data=d, fsdp=f), opt)
       for k, (d, f) in layouts.items()}
torch.save(res, f"{OUT}/rank{RANK}.pt")
"""


@pytest.fixture(scope="module")
def det(tmp_path_factory):
    jcfg, tcfg = cfgs()
    jvars = jax_variables(jcfg)
    out = tmp_path_factory.mktemp("zero3_det")
    with open(out / "cfg.pkl", "wb") as f:
        pickle.dump(tcfg, f)
    torch.save(from_jax_variables(jvars, tcfg), out / "sd.pt")
    np.savez(out / "inputs.npz", **{
        f"{k}{s}": a for s in range(STEPS) for k, a in
        zip(("images", "texts", "gt_bboxes", "gt_labels", "gt_mask"),
            global_batch(s))})
    run_ranks(DET_RANKS, out, LR, world=4, timeout=240)
    four = [torch.load(out / f"rank{r}.pt") for r in range(4)]
    run_ranks(DET_RANKS, out, LR, timeout=240)
    two = [torch.load(out / f"rank{r}.pt") for r in range(2)]
    ranks = {"data2_fsdp2": [r["data2_fsdp2"] for r in four],
             "fsdp2": [r["fsdp2"] for r in two],
             "data2": [r["data2"] for r in two]}
    return dict(jcfg=jcfg, tcfg=tcfg, jvars=jvars, ranks=ranks,
                one=det_run(out, None, OPT))


# each layout: (data, fsdp), the unsharded run it is bitwise (data index
# -> rank of that run)
LAYOUTS = {"fsdp2": (1, 2, "one"), "data2_fsdp2": (2, 2, "data2")}


def jax_steps(det, data, fsdp):
    """JAX's train_step on a (data, fsdp) mesh of the host devices, the
    parameters and optax state on fsdp_sharding: metrics per step, the
    final state, the first moments and the first step's gradients as
    port tensors."""
    jcfg, tcfg, jvars = det["jcfg"], det["tcfg"], det["jvars"]
    mesh = JM.make_mesh(data=data, fsdp=fsdp,
                        devices=jax.devices()[:data * fsdp])
    jtx = JO.make_optimizer(jvars["params"], **OPT)
    js = JState.create(jax.tree.map(jnp.asarray, jvars), jtx)
    js = js.replace(
        params=jax.device_put(js.params, JM.fsdp_sharding(mesh, js.params)),
        batch_stats=JM.replicate_tree(mesh, js.batch_stats),
        opt_state=jax.device_put(js.opt_state,
                                 JM.fsdp_sharding(mesh, js.opt_state)))
    out = {"metrics": []}
    for s in range(STEPS):
        js, m = j_train_step(jcfg, js, JBatch(*JM.shard_batch(
            mesh, global_batch(s))))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if s == 0:
            adam = _adam_state(js.opt_state)
            out["mu1"] = jgrads_as_port(adam.mu, js.batch_stats, tcfg)
            out["nu1"] = jgrads_as_port(adam.nu, js.batch_stats, tcfg)
            out["grads"] = {k: v / 0.1 for k, v in out["mu1"].items()}
    out["state"] = jgrads_as_port(js.params, js.batch_stats, tcfg)
    return out


def test_det_data2_fsdp2_matches_jax(det):
    """data = 2 x fsdp = 2, the parameters sharded: each rank against
    JAX's step on make_mesh(data=2, fsdp=2) (module docstring's rules;
    fsdp = 2 at data = 1 against JAX is tests/test_torch_dist_train.py's,
    which runs the same sharded step)."""
    want = jax_steps(det, 2, 2)
    ranks = det["ranks"]["data2_fsdp2"]
    names = ranks[0]["names"]
    top_g = max(float(want["grads"][n].abs().max()) for n in names)
    noise = assert_grads_close(_GradModel(names, ranks[0]["grads"]),
                               want["grads"])
    assert len(noise) < 20
    for r, run in enumerate(ranks):
        _metrics_close(run["metrics"], want["metrics"])
        _params_close(run, want["state"], names, noise)
        _moments_close(run, want, r % 2, top_g)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_det_zero3_steps_bitwise_unsharded(det, layout):
    """Two detector steps with the parameters sharded are bitwise the
    port's run of the same data layout without parameter sharding
    (module docstring): metrics, parameters, BN statistics, the first
    step's summed gradients, and the moments' slices."""
    data, fsdp, base = LAYOUTS[layout]
    ranks = det["ranks"][layout]
    for r, run in enumerate(ranks):
        d, f = divmod(r, fsdp)
        ref = det["one"] if base == "one" else det["ranks"][base][d]
        assert run["metrics"] == ref["metrics"]
        for k, v in ref["state"].items():
            assert torch.equal(run["state"][k], v), k
        for n in run["names"]:
            assert torch.equal(run["grads"][n], ref["grads"][n]), n
        for kind in ("mu", "nu", "mu1", "nu1"):
            for i, t in enumerate(run[kind]):
                assert torch.equal(t, fsdp_slice(ref[kind][i],
                                                 run["specs"][i], f, 2))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_det_ranks_store_only_their_slices(det, layout):
    """Each rank's parameters are exactly its fsdp_spec slices of the
    one-process weights, under the one-process names, and their bytes
    are the slices' sum (half the model, bar the few scalars no axis
    divides); no two units' gathered tensors were alive at once, and
    none after the steps."""
    one = det["one"]
    for run in det["ranks"][layout]:
        st = run["storage"]
        assert st["exact_slices"] and not st["whole"]
        assert st["names"] == one["names"]
        assert st["bytes"]["stored"] == st["want_bytes"]
        total = sum(v.numel() * 4 for k, v in one["state"].items()
                    if k in one["names"])
        assert st["bytes"]["sharded"] * 2 + st["bytes"]["whole"] == total
        assert st["bytes"]["whole"] < 1e-3 * total
        assert run["max_alive"] == 0 and run["alive_after"] == 0


def test_det_collectives_a_step(det):
    """Every unit gathered once forward and once backward; each step's
    collectives are those gathers, the norm's one call, and what the
    data axis costs without parameter sharding (the data = 2 run's
    calls)."""
    for layout, (data, _, _) in LAYOUTS.items():
        for r, run in enumerate(det["ranks"][layout]):
            for step in range(STEPS):
                base = (0 if data == 1 else
                        det["ranks"]["data2"][r // 2]["calls"][step])
                g = run["gathers"][step]
                assert all(v == [1, 1] for v in g.values()), g
                assert len(g) == 28
                assert run["zero3_calls"][step] == 2 * len(g)
                assert run["calls"][step] == base + 2 * len(g) + 1


# ----------------------------------------------------------------- Ref
REF_RANKS = r"""
from torch_dist_train_util import load_inputs
from torch_zero3_util import CONTROLS, ref_run, storage
from wedetect_tpu_torch.models.ref import init_ref_variables
from wedetect_tpu_torch.parallel.mesh import make_mesh

lr = float(ARGS[0])
mesh = make_mesh(data=1, fsdp=2)
cfg = load_inputs(OUT)[0]
whole = init_ref_variables(cfg, seed=0, device="cpu").state_dict()
res = {"init": storage(init_ref_variables(cfg, seed=0, device="cpu",
                                          mesh=mesh), whole, mesh),
       "stage3": ref_run(OUT, mesh, 3, lr, ckpt=f"{OUT}/ranks/step_1"),
       "stage2": ref_run(OUT, mesh, 2, lr)}
res["resume_own"] = ref_run(OUT, mesh, 3, lr, resume=f"{OUT}/ranks/step_1")
res["resume_one"] = ref_run(OUT, mesh, 3, lr, resume=f"{OUT}/one/step_1")
for c in CONTROLS:
    res[c] = ref_run(OUT, mesh, 3, lr, control=c)
torch.save(res, f"{OUT}/rank{RANK}.pt")
"""

# a rank that issues one gather the other does not: the ranks' gathers
# pair up wrongly from there on
REF_ORDER = r"""
from torch_zero3_util import ref_run
from wedetect_tpu_torch.parallel import fsdp
from wedetect_tpu_torch.parallel.mesh import make_mesh

if RANK == 1:
    scope = fsdp.Zero3.scope

    def extra_gather(self):
        with torch.no_grad():
            self.activate(self.units[-1])
        return scope(self)

    fsdp.Zero3.scope = extra_gather
ref_run(OUT, make_mesh(data=1, fsdp=2), 3, float(ARGS[0]), steps=1)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jcfg, tcfg = ref_cfgs()
    params = ref_jax_params(jcfg, seed=3)
    bt = ref_batch(seed=2)
    rng = np.random.default_rng(0)
    lab = (rng.uniform(0, 1, bt.obj.shape)
           * (rng.uniform(0, 1, bt.obj.shape) > 0.4)).astype(np.float32)
    valid = np.ones(bt.obj.shape, np.float32)
    valid[1, -1] = 0
    out = tmp_path_factory.mktemp("zero3_ref")
    with open(out / "cfg.pkl", "wb") as f:
        pickle.dump(tcfg, f)
    torch.save(from_jax_ref_params(params, tcfg), out / "sd.pt")
    np.savez(out / "inputs.npz", patches=bt.patches, ids=bt.ids,
             mask=bt.mask, pos=bt.pos, visual_start=bt.visual_start,
             boxes=bt.boxes, ori_wh=bt.ori_wh, obj=bt.obj, labels=lab,
             valid=valid, lm_labels=lm_labels(bt.ids, bt.mask))
    one = {3: ref_run(out, None, 3, REF_LR, ckpt=str(out / "one" / "step_1")),
           2: ref_run(out, None, 2, REF_LR)}
    run_ranks(REF_RANKS, out, REF_LR, timeout=240)
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(2)]
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, bt=bt, out=out,
                one=one, ranks=ranks)


def _same(run, one, r):
    """Bitwise: metrics, full parameters, rank r's moment slices."""
    return (run["metrics"] == one["metrics"]
            and all(torch.equal(run["state"][k], v)
                    for k, v in one["state"].items())
            and all(torch.equal(t, fsdp_slice(one[kind][i],
                                              run["specs"][i], r, 2))
                    for kind in ("mu", "nu")
                    for i, t in enumerate(run[kind])))


@pytest.mark.parametrize("stage", [3, 2])
def test_ref_zero3_steps_bitwise_one_process(ref, stage):
    """Two Ref steps at fsdp = 2 are the one-process steps bitwise; each
    rank stores exactly its slices under the one-process names, no two
    units' gathered tensors are alive at once, and each step's calls
    are the gathers (NO_BACKWARD_GATHER's units aside, two a unit) plus
    the norm's."""
    one = ref["one"][stage]
    for r, res in enumerate(ref["ranks"]):
        run = res[f"stage{stage}"]
        assert _same(run, one, r)
        st = run["storage"]
        assert st["exact_slices"] and not st["whole"]
        assert st["names"] == one["names"]
        assert st["bytes"]["stored"] == st["want_bytes"]
        assert run["max_alive"] == 0 and run["alive_after"] == 0
        for step in range(STEPS):
            g = run["gathers"][step]
            for unit, counts in g.items():
                assert counts == NO_BACKWARD_GATHER[stage].get(
                    unit, [1, 1]), (unit, counts)
            n = sum(sum(c) for c in g.values())
            assert run["zero3_calls"][step] == n
            assert run["calls"][step] == n + 1


def test_sharded_seeded_init_is_the_one_process_init(ref):
    """init_ref_variables(mesh=) over fsdp = 2 (the card phases' seeded
    weights: each tensor drawn whole in the one-process order, then
    sliced) stores exactly the one-process init's slices."""
    one = ref["one"][3]
    for res in ref["ranks"]:
        st = res["init"]
        assert st["exact_slices"] and not st["whole"]
        assert st["names"] == one["names"]
        assert st["bytes"]["stored"] == st["want_bytes"]


def test_ref_stage2_zero3_matches_jax(ref):
    """Stage 2 (the tied LM head) at fsdp = 2 against JAX's ref_lm_step
    on make_mesh(data=1, fsdp=2) (module docstring's rules)."""
    jcfg, tcfg, bt = ref["jcfg"], ref["tcfg"], ref["bt"]
    mesh = JM.make_mesh(data=1, fsdp=2, devices=jax.devices()[:2])
    jp = jax.tree.map(jnp.asarray, ref["params"])
    js = JState.create({"params": jp},
                       JLM.stage_optimizer(jp, 2, base_lr=REF_LR))
    js = js.replace(
        params=jax.device_put(js.params, JM.fsdp_sharding(mesh, js.params)),
        opt_state=jax.device_put(js.opt_state,
                                 JM.fsdp_sharding(mesh, js.opt_state)))
    args = [jnp.asarray(a) for a in (bt.patches, bt.ids, bt.mask, bt.pos)]
    args += [bt.visual_start] + [jnp.asarray(a) for a in (
        bt.boxes, bt.ori_wh, bt.obj)]
    lab = jnp.asarray(lm_labels(bt.ids, bt.mask))
    jm = []
    for _ in range(STEPS):
        js, m = JLM.ref_lm_step(jcfg, 8, 8, js, *args, lab, 1)
        jm.append({k: float(v) for k, v in m.items()})
    adam = _adam_state(js.opt_state)
    want = {k: from_jax_ref_params(jax.tree.map(np.asarray, t), tcfg)
            for k, t in (("params", js.params), ("mu", adam.mu),
                         ("nu", adam.nu))}
    for r, res in enumerate(ref["ranks"]):
        run = res["stage2"]
        for g, w in zip(run["metrics"], jm):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                           err_msg=key)
        for n, m in zip(run["names"], run["mults"]):
            got, w = (run["state"][n].numpy(),
                      want["params"][n].numpy())
            err = np.abs(got - w)
            assert (err > 1e-6 + 1e-5 * np.abs(w)).mean() <= 1e-3, n
            assert err.max() <= 2 * STEPS * REF_LR * m + 1e-6, n
        for i, n in enumerate(run["names"]):
            for kind in ("mu", "nu"):
                w = fsdp_slice(want[kind][n], run["specs"][i], r, 2)
                err = float((run[kind][i] - w).abs().max())
                assert err <= 1e-4 * float(w.abs().max()) + 1e-12, (kind,
                                                                    n)


@pytest.mark.parametrize("control", CONTROLS)
def test_broken_gathers_miss(ref, control):
    """A backward on zero-filled re-gathers, or gathers that leave out
    the other rank's slice: the steps miss the one-process run (the
    same check passes for the intact gathers above)."""
    for r, res in enumerate(ref["ranks"]):
        assert not _same(res[control], ref["one"][3], r)


def test_mismatched_gather_order_fails(ref):
    """One rank issues a gather the other does not: the ranks' gathers
    pair up wrongly and the run fails (gloo reads a message of another
    size) or hangs; its own timeout bounds it."""
    with pytest.raises((AssertionError, subprocess.TimeoutExpired)):
        run_ranks(REF_ORDER, ref["out"], REF_LR, timeout=60)


def test_checkpoints_move_between_layouts(ref):
    """A fsdp = 2 run's checkpoint after step 1 is the one-process run's
    bitwise; it resumes in one process and at fsdp = 2, and the
    one-process checkpoint resumes at fsdp = 2, each bitwise the
    uninterrupted run."""
    out, one = ref["out"], ref["one"][3]
    got, want = (torch.load(str(out / d / "step_1" / "train_state.pt"),
                            weights_only=True) for d in ("ranks", "one"))
    assert got["step"] == want["step"] == 1
    assert set(got["model"]) == set(want["model"])
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for kind in ("mu", "nu"):
        for x, y in zip(got["opt_state"][kind], want["opt_state"][kind]):
            assert x.shape == y.shape and torch.equal(x, y)
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == 1
    rest = dict(one, metrics=one["metrics"][1:])
    for r, res in enumerate(ref["ranks"]):
        for key in ("resume_own", "resume_one"):
            assert _same(res[key], rest, r), key
    resumed = ref_run(out, None, 3, REF_LR,
                      resume=str(out / "ranks" / "step_1"))
    assert resumed["metrics"] == one["metrics"][1:]
    for k, v in one["state"].items():
        assert torch.equal(resumed["state"][k], v), k
    for a, b in zip(resumed["mu"] + resumed["nu"], one["mu"] + one["nu"]):
        assert torch.equal(a, b)
