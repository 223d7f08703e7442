"""Multi-process WeDetect-Ref SFT in the port: the stage-3 step over
fsdp = 2 against the JAX package's `ref_sft_step` on
make_mesh(data=1, fsdp=2) (two of the 8 host devices), and
cli/train_ref.py under two gloo ranks, on the CPU
(tests/torch_dist_util.py).

Tolerances: against JAX, tests/test_torch_train_ref.py's rules (loss
and grad_norm to 1e-5 relative; parameters to 1e-5 relative + 1e-6 on
all but 0.1% of each tensor, every entry within 2 * steps * lr * mult);
each rank's slices of Adam's moments within 1e-4 of each tensor's
largest entry (the stage-3 lr multipliers leave no tensor whose
gradient is rounding noise alone). Against the one-process port,
bitwise: every rank computes the whole gradient on the same sample and
the sharded update is elementwise; the CLI's ranks draw the one-process
run's samples in its order.
"""

import json
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_dist_train import STEPS, _adam_state
from test_torch_train_ref import StubTok, files  # noqa: F401
from torch_dist_train_util import ref_run
from torch_dist_util import run_ranks
from torch_ref_util import batch as ref_batch
from torch_ref_util import cfgs as ref_cfgs
from torch_ref_util import jax_params as ref_jax_params
from wedetect_tpu.parallel import mesh as JM
from wedetect_tpu.train import ref_sft as JSFT
from wedetect_tpu.train.train_step import TrainState as JState
from wedetect_tpu_torch.ckpt.convert_ref import from_jax_ref_params
from wedetect_tpu_torch.parallel.collectives import fsdp_slice
from wedetect_tpu_torch.parallel.mesh import make_mesh
from wedetect_tpu_torch.train import train_step as TS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- Ref
REF_RANKS = r"""
from torch_dist_train_util import ref_run
from wedetect_tpu_torch.parallel.mesh import make_mesh

torch.save(ref_run(OUT, make_mesh(data=1, fsdp=2), float(ARGS[0])),
           f"{OUT}/rank{RANK}.pt")
"""
REF_LR = 1e-3


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
    out = tmp_path_factory.mktemp("dist_ref")
    with open(out / "cfg.pkl", "wb") as f:
        pickle.dump(tcfg, f)
    torch.save(from_jax_ref_params(params, tcfg), out / "sd.pt")
    np.savez(out / "inputs.npz", patches=bt.patches, ids=bt.ids,
             mask=bt.mask, pos=bt.pos, visual_start=bt.visual_start,
             boxes=bt.boxes, ori_wh=bt.ori_wh, obj=bt.obj, labels=lab,
             valid=valid)
    run_ranks(REF_RANKS, out, REF_LR, timeout=240)
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(2)]
    one = ref_run(out, None, REF_LR)
    world1 = ref_run(out, make_mesh(), REF_LR)

    # JAX's stage-3 step on make_mesh(data=1, fsdp=2)
    mesh = JM.make_mesh(data=1, fsdp=2, devices=jax.devices()[:2])
    jp = jax.tree.map(jnp.asarray, params)
    js = JState.create({"params": jp}, JSFT.ref_optimizer(jp, REF_LR))
    js = js.replace(
        params=jax.device_put(js.params, JM.fsdp_sharding(mesh, js.params)),
        opt_state=jax.device_put(js.opt_state,
                                 JM.fsdp_sharding(mesh, js.opt_state)))
    args = [jnp.asarray(a) for a in (bt.patches, bt.ids, bt.mask, bt.pos)]
    args += [bt.visual_start] + [jnp.asarray(a) for a in (
        bt.boxes, bt.ori_wh, bt.obj, lab, valid)]
    jm = []
    for _ in range(STEPS):
        js, m = JSFT.ref_sft_step(jcfg, 8, 8, js, *args)
        jm.append({k: float(v) for k, v in m.items()})
    adam = _adam_state(js.opt_state)
    want = {k: from_jax_ref_params(jax.tree.map(np.asarray, t), tcfg)
            for k, t in (("params", js.params), ("mu", adam.mu),
                         ("nu", adam.nu))}
    return dict(tcfg=tcfg, ranks=ranks, one=one, world1=world1, jax=want,
                jax_metrics=jm)


def test_ref_fsdp_steps_match_jax_and_one_process(ref):
    """Stage 3 over fsdp = 2: both ranks log JAX's loss and grad_norm
    and hold its parameters and their slices of its moments; bitwise the
    one-process port, which a world of one through the mesh code also
    is."""
    from wedetect_tpu_torch.train import ref_sft as TSFT
    from wedetect_tpu_torch.models.ref import RefModules

    model = RefModules(ref["tcfg"])
    mults = TSFT.ref_optimizer(model, REF_LR).mults
    names = list(ref["one"]["params"])
    for r in range(2):
        run = ref["ranks"][r]
        for g, w in zip(run["metrics"], ref["jax_metrics"]):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                           err_msg=key)
            assert g["num_pos"] == w["num_pos"]
        for n, m in zip(names, mults):
            got, w = run["params"][n].numpy(), ref["jax"]["params"][n].numpy()
            err = np.abs(got - w)
            assert (err > 1e-6 + 1e-5 * np.abs(w)).mean() <= 1e-3, n
            assert err.max() <= 2 * STEPS * REF_LR * m + 1e-6, n
        sharded = 0
        for i, n in enumerate(names):
            d = run["specs"][i]
            sharded += d is not None
            for kind in ("mu", "nu"):
                w = fsdp_slice(ref["jax"][kind][n], d, r, 2)
                err = float((run[kind][i] - w).abs().max())
                assert err <= 1e-4 * float(w.abs().max()) + 1e-12, (kind, n)
                assert torch.equal(run[kind][i],
                                   fsdp_slice(ref["one"][kind][i], d, r, 2))
        assert 0 < sharded < len(names)
        assert run["metrics"] == ref["one"]["metrics"]
        for n in names:
            assert torch.equal(run["params"][n], ref["one"]["params"][n]), n
    w1 = ref["world1"]
    assert w1["metrics"] == ref["one"]["metrics"]
    for n in names:
        assert torch.equal(w1["params"][n], ref["one"]["params"][n]), n


def test_ref_steps_refuse_a_data_axis():
    from wedetect_tpu_torch.train.ref_sft import check_ref_mesh
    from wedetect_tpu_torch.parallel.mesh import Mesh

    state = TS.TrainState(step=0, model=None, tx=None,
                          mesh=Mesh(2, 1, 0, {}))
    with pytest.raises(ValueError, match="fsdp only"):
        check_ref_mesh(state)



# ---------------------------------------------------------------- CLI
REF_CLI = r"""
import json
import pickle
from wedetect_tpu_torch.cli import _ref_load
from wedetect_tpu_torch.cli import train_ref as TCLI
from wedetect_tpu_torch.data import sft_chat
from wedetect_tpu_torch.models.ref import RefModules

with open(f"{OUT}/cfg.pkl", "rb") as f:
    cfg, tok = pickle.load(f)


def load_ref(checkpoint, device="cuda"):
    model = RefModules(cfg)
    model.load_state_dict(torch.load(f"{OUT}/sd.pt"), strict=True)
    return cfg, model.eval(), tok


drawn = []
sample = sft_chat.ReferringSftDataset.sample


def record(self, idx):
    drawn.append(int(idx))
    return sample(self, idx)


_ref_load.load_ref = load_ref
sft_chat.ReferringSftDataset.sample = record
d = json.loads(ARGS[0])
TCLI.main(["--stage", "3", "--data", d["stage3"], "--proposals",
           d["props"], "--steps", "3", "--max-proposals", "8",
           "--seq-buckets", "256", "--grid-tokens", "1", "--ckpt-dir",
           f"{OUT}/ckpt", "--ckpt-every", "2", "--log-every", "1",
           "--lr", "1e-3", "--fsdp", str(WORLD), "--device", "cpu"])
with open(f"{OUT}/drawn{RANK}.json", "w") as f:
    json.dump(drawn, f)
"""


def test_ref_cli_two_ranks(files, tmp_path):  # noqa: F811
    """cli/train_ref.main (stage 3, --fsdp 2) under two gloo ranks:
    every rank draws the one-process run's samples, in its order, and
    the checkpoints are the one-process run's bitwise."""
    jcfg, tcfg = ref_cfgs()
    params = ref_jax_params(jcfg, seed=3)
    for d in (tmp_path, tmp_path / "one"):
        d.mkdir(exist_ok=True)
        with open(d / "cfg.pkl", "wb") as f:
            pickle.dump((tcfg, StubTok()), f)
        torch.save(from_jax_ref_params(params, tcfg), d / "sd.pt")
    arg = json.dumps({k: files[k] for k in ("stage3", "props")})
    run_ranks(REF_CLI, tmp_path, arg, timeout=240)
    run_ranks(REF_CLI, tmp_path / "one", arg, world=1, timeout=240)
    drawn = [json.loads((tmp_path / f"drawn{r}.json").read_text())
             for r in range(2)]
    want = json.loads((tmp_path / "one" / "drawn0.json").read_text())
    assert drawn[0] == drawn[1] == want and len(want) >= 3
    for step in ("step_2", "step_3"):
        got, exp = (torch.load(str(d / "ckpt" / step / "train_state.pt"),
                               weights_only=True)
                    for d in (tmp_path, tmp_path / "one"))
        for k, v in exp["model"].items():
            assert torch.equal(got["model"][k], v), k
        for x, y in zip(got["opt_state"]["mu"] + got["opt_state"]["nu"],
                        exp["opt_state"]["mu"] + exp["opt_state"]["nu"]):
            assert torch.equal(x, y)
