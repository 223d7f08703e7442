"""Multi-process detector training in the port (`parallel/`, the
data-parallel and fsdp paths of `train/`, `ckpt/io.py`, cli/train.py)
against the JAX package's global-view steps on a 2-device mesh (of the
8 host devices tests/conftest.py forces), on the CPU: two gloo ranks
(tests/torch_dist_util.py), the same numpy-seeded inputs and JAX's init
carried across with from_jax_variables. The Ref SFT's fsdp path is in
tests/test_torch_dist_train_ref.py.

Tolerances:
- data = 2 (mini_cfg, global B = 4, two steps, drop path off):
  against JAX's train_step on make_mesh(data=2), with the rules of
  tests/test_torch_train_det.py: loss and parts to 1e-5 relative,
  grad_norm to 1e-4, num_pos exactly; the first step's summed gradients
  (JAX's read back from its first Adam mu, (1 - b1) * grad) within 1e-4
  of each tensor's largest entry or one f32 ulp e of the model's
  largest (tensors that hold rounding noise only); parameters within
  2 * steps * lr and 1e-5 relative + 1e-6 on all but 0.1% of the
  entries; BN running statistics within 1e-6 + 0.1 * 2 * steps * lr.
  Adam's moments after the first step (this rank's slices), where they
  carry the gradient's error: mu within 1e-4 and nu within 2e-4 of each
  tensor's largest entry, or within what the gradients' absolute limit
  e gives: mu (1 - b1) e, nu (1 - b2) (2 |g| + e) e. After
  the second step the moments hold a gradient taken at parameters that
  Adam's sign noise has moved by up to lr (the parameter rule above),
  so they are not held to JAX's there. Control: BatchNorm on each
  rank's own rows misses the BN statistics.
- fsdp = 2 (data = 1): the same rules against JAX's train_step on
  make_mesh(data=1, fsdp=2), and bitwise the one-process port (every
  rank computes the whole gradient; the sharded update is elementwise).
- Drop path on (rate 0.3): JAX draws its masks from jax.random and the
  port from torch.Generator, so these runs are held to the one-process
  port on the global batch: fsdp = 2 bitwise; data = 2 by the rules
  above (the gradient sums over the ranks and BatchNorm's one-pass
  global variance round differently).
- Checkpoints, the CLI and the world of one: bitwise (resume, fsdp);
  the CLI at data = 2 by the data = 2 rules after its first step.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_det_data import write_coco
from test_torch_train_det import (LR, assert_grads_close, assert_stats_close,
                                  cfgs, jax_variables, jgrads_as_port,
                                  make_batch)
from torch_dist_train_util import det_run
from torch_dist_util import run_ranks
from wedetect_tpu.parallel import mesh as JM
from wedetect_tpu.train import optimizer as JO
from wedetect_tpu.train.train_step import Batch as JBatch
from wedetect_tpu.train.train_step import TrainState as JState
from wedetect_tpu.train.train_step import train_step as j_train_step
from wedetect_tpu_torch.ckpt import io as CIO
from wedetect_tpu_torch.ckpt.convert import from_jax_variables
from wedetect_tpu_torch.parallel.collectives import fsdp_slice
from wedetect_tpu_torch.parallel.mesh import make_mesh
from wedetect_tpu_torch.train import train_step as TS

OPT = dict(base_lr=LR, weight_decay=0.025, total_batch_size=4)
STEPS = 2
ULP = 2.0 ** -23


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def global_batch(step):
    """Global B = 4: make_batch's two rows twice (seeded per half)."""
    a, b = make_batch(seed=step), make_batch(seed=step + 10)
    return tuple(np.concatenate([x, y]) for x, y in zip(a, b))


# ------------------------------------------------------- detector runs
DET_RANKS = r"""
from torch_dist_train_util import det_run
from wedetect_tpu_torch.parallel.mesh import make_mesh

opt = dict(base_lr=float(ARGS[0]), weight_decay=0.025, total_batch_size=4)
dp, fsdp = make_mesh(data=2), make_mesh(data=1, fsdp=2)
res = {"dp": det_run(OUT, dp, 0.0, opt, grads=True),
       "dp_local_bn": det_run(OUT, dp, 0.0, opt, local_bn=True),
       "dp_drop": det_run(OUT, dp, 0.3, opt),
       "fsdp": det_run(OUT, fsdp, 0.0, opt, ckpt=f"{OUT}/ckpt/step_1"),
       "fsdp_drop": det_run(OUT, fsdp, 0.3, opt)}
torch.save(res, f"{OUT}/rank{RANK}.pt")
"""


@pytest.fixture(scope="module")
def det(tmp_path_factory):
    jcfg, tcfg = cfgs()
    jvars = jax_variables(jcfg)
    out = tmp_path_factory.mktemp("dist_det")
    with open(out / "cfg.pkl", "wb") as f:
        pickle.dump(tcfg, f)
    torch.save(from_jax_variables(jvars, tcfg), out / "sd.pt")
    np.savez(out / "inputs.npz", **{
        f"{k}{s}": a for s in range(STEPS) for k, a in
        zip(("images", "texts", "gt_bboxes", "gt_labels", "gt_mask"),
            global_batch(s))})
    run_ranks(DET_RANKS, out, LR, timeout=240)
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(2)]
    one = {name: det_run(out, None, rate, OPT)
           for name, rate in (("plain", 0.0), ("drop", 0.3))}
    return dict(jcfg=jcfg, tcfg=tcfg, jvars=jvars, out=out, ranks=ranks,
                one=one)


@pytest.fixture(scope="module")
def jtx(det):
    return JO.make_optimizer(det["jvars"]["params"], **OPT)


def jax_global(det, jtx, data, fsdp):
    """JAX's train_step on a (data, fsdp) mesh of two host devices:
    metrics per step, the final state as port tensors, the moments after
    the first step and the first step's gradients (jax.grad of the
    sharded step, read back from Adam's first mu)."""
    jcfg, tcfg, jvars = det["jcfg"], det["tcfg"], det["jvars"]
    mesh = JM.make_mesh(data=data, fsdp=fsdp, devices=jax.devices()[:2])
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
            # the step's gradient: Adam's first mu is (1 - b1) * grad
            out["grads"] = {k: v / 0.1 for k, v in out["mu1"].items()}
    out["state"] = jgrads_as_port(js.params, js.batch_stats, tcfg)
    return out


def _adam_state(opt_state):
    nodes = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu"))
    return [n for n in nodes if hasattr(n, "mu")][0]


@pytest.fixture(scope="module")
def jax_dp(det, jtx):
    return jax_global(det, jtx, 2, 1)


@pytest.fixture(scope="module")
def jax_fsdp(det, jtx):
    return jax_global(det, jtx, 1, 2)


def _metrics_close(got, want):
    for g, w in zip(got, want):
        for key, rtol in (("loss", 1e-5), ("loss_cls", 1e-5),
                          ("loss_bbox", 1e-5), ("loss_dfl", 1e-5),
                          ("grad_norm", 1e-4)):
            np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                       err_msg=key)
        assert g["num_pos"] == w["num_pos"]


def _params_close(run, want, names, noise):
    """test_torch_train_det's rule for the parameters; the BN
    statistics within 1e-6 + 0.1 * 2 * steps * lr."""
    loose = total = 0
    for n in names:
        got, w = run["state"][n].numpy(), want[n].numpy()
        err = np.abs(got - w)
        if n not in noise:
            loose += int((err > 1e-6 + 1e-5 * np.abs(w)).sum())
            total += err.size
        assert err.max() <= 2 * STEPS * LR + 1e-6, (n, err.max())
    assert loose <= 1e-3 * total, (loose, total)
    model = _Stats(run["state"])
    assert_stats_close(model, want, atol=1e-6 + 0.1 * 2 * STEPS * LR)


class _Stats:
    """A state dict seen through `state_dict()` (assert_stats_close)."""

    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd


def _moments_close(run, want, fidx, top_g):
    """This rank's slices of the moments after the first step against
    the full moments at the same indices (module docstring)."""
    e = ULP * top_g     # the gradient rule's absolute bound
    for i, n in enumerate(run["names"]):
        mu_w = fsdp_slice(want["mu1"][n], run["specs"][i], fidx, 2)
        g = float(mu_w.abs().max()) / 0.1
        for kind, rel, bound in (("mu", 1e-4, 0.1 * e),
                                 ("nu", 2e-4, 0.001 * (2 * g + e) * e)):
            w = fsdp_slice(want[kind + "1"][n], run["specs"][i], fidx, 2)
            got = run[kind + "1"][i]
            assert got.shape == w.shape, (kind, n)
            err = float((got - w).abs().max())
            if err > rel * float(w.abs().max()):
                assert err <= bound, (kind, n, err)


@pytest.fixture(scope="module")
def noise(det, jax_dp):
    """The tensors whose data = 2 first-step gradient is rounding noise
    (the module docstring's rule against JAX's sharded jax.grad)."""
    names = det["ranks"][0]["dp"]["names"]
    model = _GradModel(names, det["ranks"][0]["dp"]["grads"])
    found = assert_grads_close(model, jax_dp["grads"])
    assert len(found) < 20
    return found


class _GradModel:
    """Named parameters whose .grad is the run's summed gradient."""

    def __init__(self, names, grads):
        self.params = []
        for n in names:
            p = torch.nn.Parameter(torch.zeros_like(grads[n]))
            p.grad = grads[n]
            self.params.append((n, p))

    def named_parameters(self):
        return iter(self.params)


def test_data_parallel_steps_match_jax(det, jax_dp, noise):
    """data = 2: each rank's summed gradient (the global BatchNorm's
    backward included) is jax.grad of JAX's sharded step, both ranks
    log JAX's global metrics, and after two steps hold JAX's parameters,
    BN statistics and moments."""
    names = det["ranks"][0]["dp"]["names"]
    top_g = max(float(jax_dp["grads"][n].abs().max()) for n in names)
    for r in range(2):
        run = det["ranks"][r]["dp"]
        if r == 1:
            assert_grads_close(_GradModel(names, run["grads"]),
                               jax_dp["grads"])
        _metrics_close(run["metrics"], jax_dp["metrics"])
        _params_close(run, jax_dp["state"], names, noise)
        assert all(d is None for d in run["specs"])
        _moments_close(run, jax_dp, 0, top_g)
    for k, v in det["ranks"][0]["dp"]["state"].items():
        assert torch.equal(v, det["ranks"][1]["dp"]["state"][k]), k


def test_per_rank_batchnorm_control_misses(det, jax_dp):
    """BatchNorm on each rank's own two rows (what a plain data-parallel
    run without the global statistics does): the BN statistics miss
    JAX's global-view step."""
    run = det["ranks"][0]["dp_local_bn"]
    with pytest.raises(AssertionError):
        assert_stats_close(_Stats(run["state"]), jax_dp["state"],
                           atol=1e-6 + 0.1 * 2 * STEPS * LR)


def test_fsdp_steps_match_jax_and_one_process(det, jax_dp, jax_fsdp, noise):
    """fsdp = 2 (data = 1): the metrics, parameters, BN statistics and
    each rank's slices of the moments against JAX's step on
    make_mesh(data=1, fsdp=2); bitwise the one-process port."""
    names = det["ranks"][0]["fsdp"]["names"]
    one = det["one"]["plain"]
    top_g = max(float(jax_dp["grads"][n].abs().max()) for n in names)
    for r in range(2):
        run = det["ranks"][r]["fsdp"]
        _metrics_close(run["metrics"], jax_fsdp["metrics"])
        _params_close(run, jax_fsdp["state"], names, noise)
        assert any(d is not None for d in run["specs"])
        _moments_close(run, jax_fsdp, r, top_g)
        assert run["metrics"] == one["metrics"]
        for k, v in run["state"].items():
            assert torch.equal(v, one["state"][k]), k
        for kind in ("mu", "nu"):
            for i, t in enumerate(run[kind]):
                assert torch.equal(t, fsdp_slice(one[kind][i],
                                                 run["specs"][i], r, 2))


def test_drop_path_runs_match_one_process(det):
    """Drop path at 0.3: each rank uses its rows of the global batch's
    masks. fsdp = 2 is bitwise the one-process run; data = 2 within the
    data-parallel rules (and differs from the run without drop path)."""
    one = det["one"]["drop"]
    names = one["names"]
    for r in range(2):
        run = det["ranks"][r]["fsdp_drop"]
        assert run["metrics"] == one["metrics"]
        for k, v in run["state"].items():
            assert torch.equal(v, one["state"][k]), k
        dp = det["ranks"][r]["dp_drop"]
        _metrics_close(dp["metrics"], one["metrics"])
        _params_close(dp, one["state"], names, set())
    assert det["one"]["drop"]["metrics"] != det["one"]["plain"]["metrics"]


def test_two_rank_checkpoint_resumes_in_one_process(det):
    """The fsdp = 2 ranks' checkpoint after step 1 (rank 0 writes the
    gathered moments in the one-process layout) restored into one
    process and stepped once: bitwise the uninterrupted run."""
    from wedetect_tpu_torch.models import wedetect as TW

    tcfg, out = det["tcfg"], det["out"]
    model = TW.WeDetectModule(tcfg).eval()
    model.load_state_dict(torch.load(out / "sd.pt"))
    state = TS.TrainState.create(model, TS.det_optimizer(model, **OPT))
    state = CIO.restore_train_state(str(out / "ckpt" / "step_1"), state)
    assert state.step == 1 and state.tx.count == 1
    state, _ = TS.train_step(tcfg, state, TS.Batch(*global_batch(1)))
    one = det["one"]["plain"]
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, one["state"][k]), k
    for i, (mu, nu) in enumerate(zip(state.tx.mu, state.tx.nu)):
        assert torch.equal(mu, one["mu"][i]) and torch.equal(nu, one["nu"][i])


def test_world_one_mesh_is_the_one_process_step(det):
    """A world of one through the mesh code (make_mesh() with no process
    group, as a CLI builds it) gives the mesh-free step bitwise, for the
    detector (drop path on) and for the Ref SFT step."""
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "fsdp": 1}
    a, b = (det_run(det["out"], m, 0.3, OPT) for m in (None, mesh))
    assert a["metrics"] == b["metrics"]
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
    for x, y in zip(a["mu"] + a["nu"], b["mu"] + b["nu"]):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- CLIs
DET_CLI = r"""
from wedetect_tpu_torch.cli import train as TCLI
from wedetect_tpu_torch.configs import ModelCfg


def mini_config(args):
    kw = dict(TCLI._cfg_kw(args), compute_dtype="float32")
    return ModelCfg(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                    neck_scale=0.25, neck_repeats=2,
                    head_in_channels=(32, 64, 128), embed_dims=32, text=None,
                    **kw)


TCLI.build_config = mini_config
for fsdp in ("1", "2")[:WORLD]:
    TCLI.main(["--ann", f"{OUT}/train.json", "--img-root", OUT, "--size",
               "tiny", "--img-size", "64", "--num-classes", "4",
               "--batch-size", "4", "--steps", "2", "--ckpt-dir",
               f"{OUT}/fsdp{fsdp}", "--ckpt-every", "1", "--device", "cpu",
               "--fsdp", fsdp, "--drop-path", "0.2", "--lr", "1e-4"])
"""


def test_det_cli_two_ranks(tmp_path):
    """cli/train.main under two gloo ranks on the tiny COCO set (mini_cfg
    in f32, drop path 0.2, global batch 4, lr 1e-4 as in the step tests,
    two steps): --fsdp 2 writes the one-process run's checkpoints
    bitwise; --fsdp 1 (data = 2, two rows a rank) holds the one-process
    run's first checkpoint by the data-parallel rules of the parameters
    and BN statistics. After the second step the data = 2 run is not
    held to them: a bias whose exact gradient is zero moves by +-lr in
    either run, and the second step's BatchNorm statistics read it
    through the convolutions after it (the step tests hold two
    data-parallel steps to JAX where no such bias feeds a 1x1 conv of
    256 channels)."""
    write_coco(tmp_path)
    run_ranks(DET_CLI, tmp_path, timeout=240)
    one = tmp_path / "one"
    one.mkdir()
    (one / "train.json").write_text((tmp_path / "train.json").read_text())
    for p in tmp_path.glob("*.png"):
        (one / p.name).write_bytes(p.read_bytes())
    run_ranks(DET_CLI, one, world=1, timeout=240)
    def ckpt(root, fsdp, step):
        return torch.load(str(root / f"fsdp{fsdp}" / f"step_{step}" /
                              "train_state.pt"), weights_only=True)

    got, want = ckpt(tmp_path, "1", 1), ckpt(one, "1", 1)
    assert got["step"] == want["step"] == 1
    names = [k for k in want["model"] if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    _params_close({"state": got["model"]}, want["model"], names, set())
    assert ckpt(tmp_path, "1", 2)["step"] == 2
    for step in (1, 2):
        got, want = ckpt(tmp_path, "2", step), ckpt(one, "1", step)
        for k, v in want["model"].items():
            assert torch.equal(got["model"][k], v), k
        for x, y in zip(got["opt_state"]["mu"] + got["opt_state"]["nu"],
                        want["opt_state"]["mu"] + want["opt_state"]["nu"]):
            assert torch.equal(x, y)
