"""The port's mesh and collectives (`wedetect_tpu_torch/parallel/`) and
its global-batch BatchNorm and drop path against the JAX package's
`parallel/mesh.py` and flax, on the CPU; the multi-rank cases run as
two gloo processes (tests/torch_dist_util.py).

Tolerances:
- fsdp_spec, shard_batch, the rank layout and the collectives:
  exactly (the gather and the broadcast bitwise; sums of small integers
  exactly).
- global-batch BatchNorm over two ranks against flax's BatchNorm on
  the whole batch and `jax.grad` of it: outputs and running statistics
  to 1e-5 + 1e-5 relative, the input gradient and the weight and bias
  gradients (summed over the ranks) to 1e-5 of their largest entry
  (f32: the one-pass variance over 2 x 4 x 5 x 5 values loses a few
  ulps of the mean's square). Control: each rank's own statistics miss.
- drop path over two ranks: bitwise the one-process block on the whole
  batch (the global mask is drawn and sliced).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from test_torch_train_det import cfgs, jax_variables
from torch_dist_util import run_ranks
from torch_ref_util import cfgs as ref_cfgs
from torch_ref_util import jax_params as ref_jax_params
from wedetect_tpu.parallel import mesh as JM
from wedetect_tpu_torch.ckpt import convert as TCV
from wedetect_tpu_torch.ckpt import convert_ref as TCR
from wedetect_tpu_torch.models import wedetect as TW
from wedetect_tpu_torch.models.ref import RefModules
from wedetect_tpu_torch.parallel import collectives as TCOL
from wedetect_tpu_torch.parallel import mesh as TM


# ------------------------------------------------------------- fsdp_spec
def _jax_axis(sharding):
    spec = tuple(sharding.spec)
    return spec.index("fsdp") if "fsdp" in spec else None


def _specs_by_path(params, size):
    mesh = JM.make_mesh(data=1, fsdp=size, devices=jax.devices()[:size])
    sh = JM.fsdp_sharding(mesh, params)
    out = {}
    for (path, leaf), (_, s) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(sh)):
        key = "/".join(p.key for p in path)
        out[key] = (np.shape(leaf), _jax_axis(s))
    return out


def _port_tree(kind):
    if kind == "det":
        jcfg, tcfg = cfgs()
        params = jax_variables(jcfg)["params"]
        model = TW.WeDetectModule(tcfg)
        paths = TCV.jax_param_paths(tcfg)
    else:
        jcfg, tcfg = ref_cfgs()
        params = ref_jax_params(jcfg, seed=0)
        model = RefModules(tcfg, lm_head="lm_head" in params)
        paths = TCR.jax_param_paths(tcfg)
    return params, [(paths[n], p) for n, p in model.named_parameters()]


@pytest.mark.parametrize("kind", ["det", "ref"])
@pytest.mark.parametrize("size", [2, 4])
def test_fsdp_spec_matches_jax(kind, size):
    """Leaf by leaf, matched by key name: fsdp_spec on the JAX leaf's
    shape is fsdp_sharding's axis; on the port tensor (torch layout:
    OIHW, (out, in), the ViT's patch embedding as a Conv3d) it shards
    exactly the leaves JAX shards, each rank holding 1 / size of it (the
    axis can be another logical axis than JAX's where the layouts order
    tied axes differently or reshape: memory only)."""
    params, named = _port_tree(kind)
    want = _specs_by_path(params, size)
    assert len(named) == len(want)
    sharded = 0
    for path, t in named:
        shape, axis = want[path]
        assert TM.fsdp_spec(shape, size) == axis, path
        got = TM.fsdp_spec(tuple(t.shape), size)
        assert (got is None) == (axis is None), path
        if axis is not None:
            assert t.shape[got] % size == 0, path
            sharded += 1
    assert 0 < sharded < len(named)
    assert TM.fsdp_spec((8, 6), 1) is None and TM.fsdp_spec((), 2) is None
    assert TM.fsdp_spec((6, 8), 4) == 1 and TM.fsdp_spec((3, 5), 2) is None


# ------------------------------------------------------------ shard_batch
def _local_mesh(data, fsdp, rank):
    """A Mesh of that shape at `rank` without a process group (for the
    row arithmetic; its collectives are not called)."""
    return TM.Mesh(data, fsdp, rank, {})


@pytest.mark.parametrize("data,fsdp", [(2, 1), (2, 2), (4, 1)])
def test_shard_batch_matches_jax_addressable_shards(data, fsdp):
    """Each rank's rows are the rows JAX's shard_batch places on the
    device at the same mesh position; a leaf whose leading dim is not
    the batch's row count stays whole (replicated)."""
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 255, (8, 4, 4, 3), dtype=np.uint8),
             "boxes": rng.standard_normal((8, 5, 4)).astype(np.float32),
             "bank": rng.standard_normal((3, 6)).astype(np.float32)}
    n = data * fsdp
    jmesh = JM.make_mesh(data=data, fsdp=fsdp, devices=jax.devices()[:n])
    jb = JM.shard_batch(jmesh, batch)
    devs = list(np.asarray(jmesh.devices).reshape(-1))
    for rank in range(n):
        got = TM.shard_batch(_local_mesh(data, fsdp, rank), batch, 8)
        for key, arr in jb.items():
            shard = [s for s in arr.addressable_shards
                     if s.device == devs[rank]][0]
            np.testing.assert_array_equal(got[key], np.asarray(shard.data),
                                          err_msg=f"{key} rank {rank}")
    tb = TM.shard_batch(_local_mesh(2, 1, 1), tuple(
        torch.from_numpy(batch[k]) for k in ("boxes", "bank")), 8)
    assert tb[0].shape == (4, 5, 4) and tb[1].shape == (3, 6)


def test_shard_batch_keeps_a_bank_whose_rows_divide():
    """A shared (K, C) bank whose K the data axis divides is not a batch
    leaf: it stays whole on every rank, as JAX's global view computes on
    all K rows; a row count the data axis does not divide raises."""
    rng = np.random.default_rng(1)
    boxes = rng.standard_normal((6, 5, 4)).astype(np.float32)
    bank = rng.standard_normal((4, 3)).astype(np.float32)
    for rank in range(2):
        got_boxes, got_bank = TM.shard_batch(_local_mesh(2, 1, rank),
                                             (boxes, bank), 6)
        np.testing.assert_array_equal(got_boxes, boxes[3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(got_bank, bank)
    with pytest.raises(ValueError):
        TM.shard_batch(_local_mesh(2, 1, 0), (boxes[:5], bank), 5)
    with pytest.raises(ValueError):
        _local_mesh(4, 1, 0).rows(6)


def test_make_mesh_world_one():
    mesh = TM.make_mesh()
    assert mesh.shape == {"data": 1, "fsdp": 1} and mesh.rank == 0
    assert mesh.rows(5) == slice(0, 5)
    x = torch.arange(4.0)
    assert mesh.data_group.all_reduce(x) is x
    assert torch.equal(x, torch.arange(4.0)) and mesh.stats.calls == 0
    for kw in ({"fsdp": 2}, {"data": 2}, {"fsdp": 0}):
        with pytest.raises(ValueError):
            TM.make_mesh(**kw)


# ------------------------------------------------------ two gloo ranks
COLLECTIVES = r"""
import pickle
import torch
from wedetect_tpu_torch.parallel import collectives as C
from wedetect_tpu_torch.parallel.mesh import make_mesh

res = {}
for name, kw in (("dp", dict(data=2)), ("fsdp", dict(data=1, fsdp=2))):
    m = make_mesh(**kw)
    res[name] = dict(shape=m.shape, index=(m.data_index, m.fsdp_index),
                     data_size=m.data_group.size,
                     fsdp_size=m.fsdp_group.size)
mesh = make_mesh(data=1, fsdp=2)
g = mesh.fsdp_group
x = torch.arange(6.0) + 10 * RANK
res["all_reduce"] = g.all_reduce(x.clone())
C.BUCKET_NUMEL = 5          # three buckets for these tensors
ts = [torch.full((2, 2), 1.0 + RANK), torch.arange(3.0) * (RANK + 1),
      torch.ones(4, dtype=torch.float64) * RANK]
g.all_reduce_flat(ts)
res["flat"] = ts
full = [torch.empty(4, 6), torch.empty(2, 3)]
src = [torch.arange(24.0).view(4, 6) * 0.5 - 3,
       torch.full((2, 3), 7.0 + RANK)]
writes = [lambda v: C.fsdp_slice(v, 0, g.index, 2).copy_(
              C.fsdp_slice(src[0], 0, g.index, 2)),
          lambda v: v.copy_(src[1]) if g.index == 0 else None]
g.gather_flat(full, writes)
res["gather"], res["src"] = full, src
b = torch.full((3,), float(RANK))
g.broadcast(b, 1)
res["broadcast"] = b
g.barrier("cpu")
w = torch.tensor([1.0, 2.0], requires_grad=True)
y = g.all_reduce_grad(w * (RANK + 1))
(y * torch.tensor([3.0, 5.0])).sum().backward()
res["grad_out"], res["grad"] = y.detach(), w.grad
res["calls"] = mesh.stats.calls
with open(f"{OUT}/rank{RANK}.pkl", "wb") as f:
    pickle.dump(res, f)
"""


def test_collectives_two_ranks(tmp_path):
    """make_mesh's layout (rank = d * fsdp + f), and every collective
    over a group of two gloo ranks: all_reduce, the bucketed flat
    all_reduce, the gather (bitwise the owners' slices), broadcast from
    member 1, the barrier, and the all_reduce that autograd
    differentiates (its backward sums the gradient over the ranks)."""
    import pickle

    run_ranks(COLLECTIVES, tmp_path)
    res = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
           for r in range(2)]
    for r, got in enumerate(res):
        assert got["dp"] == dict(shape={"data": 2, "fsdp": 1},
                                 index=(r, 0), data_size=2, fsdp_size=1)
        assert got["fsdp"] == dict(shape={"data": 1, "fsdp": 2},
                                   index=(0, r), data_size=1, fsdp_size=2)
        assert torch.equal(got["all_reduce"], 2 * torch.arange(6.0) + 10)
        assert torch.equal(got["flat"][0], torch.full((2, 2), 3.0))
        assert torch.equal(got["flat"][1], torch.arange(3.0) * 3)
        assert torch.equal(got["flat"][2], torch.ones(4, dtype=torch.float64))
        assert torch.equal(got["gather"][0], got["src"][0])
        assert torch.equal(got["gather"][1], torch.full((2, 3), 7.0))
        assert torch.equal(got["broadcast"], torch.ones(3))
        assert torch.equal(got["grad_out"], torch.tensor([3.0, 6.0]))
        # d/dw of sum_r (3, 5) . y, y = sum_r (r + 1) w: (r + 1) * (6, 10)
        assert torch.equal(got["grad"], (r + 1) * torch.tensor([6.0, 10.0]))
        assert got["calls"] >= 8


BATCHNORM = r"""
import numpy as np
import torch
from wedetect_tpu_torch.nn.convnext import ConvNeXtBlock
from wedetect_tpu_torch.nn.layers import BatchNorm2d
from wedetect_tpu_torch.parallel.mesh import make_mesh

mesh = make_mesh(data=2)
d = np.load(f"{OUT}/inputs.npz")
rows = mesh.rows(4)
out = {}
for name, group in (("global", mesh.data_group), ("local", None)):
    bn = BatchNorm2d(4, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(d["w"]))
        bn.bias.copy_(torch.from_numpy(d["b"]))
    bn.group = group
    bn.train()
    x = torch.from_numpy(d["x"][rows]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(d["cot"][rows])).sum().backward()
    out[name] = dict(y=y.detach(), dx=x.grad, dw=bn.weight.grad,
                     db=bn.bias.grad, mean=bn.running_mean.clone(),
                     var=bn.running_var.clone())
blk = ConvNeXtBlock(8, layer_scale_init=1.0, drop_path=0.5)
blk.load_state_dict(torch.load(f"{OUT}/block.pt"))
blk.group = mesh.data_group
blk.train()
xb = torch.load(f"{OUT}/xb.pt")
n = xb.shape[0] // 2
out["drop"] = blk(xb[RANK * n:(RANK + 1) * n],
                  torch.Generator().manual_seed(9)).detach()
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""


def _flax_bn(x_nchw, w, b, cot):
    """flax BatchNorm (train mode, torch momentum 0.1) on the whole
    batch: output, running stats, and jax.grad of <y, cot> in x, w, b."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    x = jnp.asarray(np.transpose(x_nchw, (0, 2, 3, 1)))
    c = jnp.asarray(np.transpose(cot, (0, 2, 3, 1)))
    stats = {"mean": jnp.zeros(4), "var": jnp.ones(4)}

    def f(x, w, b):
        y, mut = bn.apply({"params": {"scale": w, "bias": b},
                           "batch_stats": stats}, x, mutable=["batch_stats"])
        return (y * c).sum(), (y, mut["batch_stats"])

    (_, (y, st)), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                             has_aux=True)(
        x, jnp.asarray(w), jnp.asarray(b))
    to_nchw = (lambda a: np.transpose(np.asarray(a), (0, 3, 1, 2)))
    return dict(y=to_nchw(y), dx=to_nchw(grads[0]), dw=np.asarray(grads[1]),
                db=np.asarray(grads[2]), mean=np.asarray(st["mean"]),
                var=np.asarray(st["var"]))


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= 1e-5 * scale + 1e-5 * (what in ("y", "mean", "var")), \
        (what, err, scale)


def test_global_batchnorm_and_drop_path_two_ranks(tmp_path):
    """BatchNorm over a data group of two ranks is flax's BatchNorm on
    the global batch: output rows, running statistics, and the gradients
    of jax.grad (input rows; weight and bias summed over the ranks). The
    control, each rank's own statistics, misses. Drop path draws the
    global batch's mask: bitwise the one-process block."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 4, 5, 5)) * 2 + 1).astype(np.float32)
    x[2:] += 3.0                # the two ranks' halves differ in mean
    d = dict(x=x, w=rng.uniform(0.5, 1.5, 4).astype(np.float32),
             b=rng.standard_normal(4).astype(np.float32),
             cot=rng.standard_normal(x.shape).astype(np.float32))
    np.savez(tmp_path / "inputs.npz", **d)
    blk = ConvNeXtBlock_seeded()
    torch.save(blk.state_dict(), tmp_path / "block.pt")
    xb = torch.randn(8, 8, 5, 5, generator=torch.Generator().manual_seed(2))
    torch.save(xb, tmp_path / "xb.pt")
    run_ranks(BATCHNORM, tmp_path)
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    want = _flax_bn(d["x"], d["w"], d["b"], d["cot"])
    for kind in ("global", "local"):
        got = {k: (torch.cat([r[kind][k] for r in res]) if k in ("y", "dx")
                   else (res[0][kind][k] + res[1][kind][k]
                         if k in ("dw", "db") else res[0][kind][k]))
               for k in want}
        if kind == "global":
            for k in want:
                _close(got[k].numpy(), want[k], k)
            for k in ("mean", "var"):
                assert torch.equal(res[0][kind][k], res[1][kind][k])
        else:
            with pytest.raises(AssertionError):
                for k in want:
                    _close(got[k].numpy(), want[k], k)
    blk.train()
    one = blk(xb, torch.Generator().manual_seed(9)).detach()
    two = torch.cat([r["drop"] for r in res])
    assert torch.equal(one, two)
    kept = [not torch.equal(one[i], xb[i]) for i in range(8)]
    assert 0 < sum(kept) < 8          # some rows dropped, some kept


def ConvNeXtBlock_seeded():
    from wedetect_tpu_torch.nn.convnext import ConvNeXtBlock

    blk = ConvNeXtBlock(8, layer_scale_init=1.0, drop_path=0.5)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return blk


def test_fsdp_slice_blocks():
    t = torch.arange(24.0).view(4, 6)
    parts = [TCOL.fsdp_slice(t, 1, i, 3) for i in range(3)]
    assert torch.equal(torch.cat(parts, 1), t)
    assert TCOL.fsdp_slice(t, None, 1, 3) is t
    assert parts[1].data_ptr() == t[:, 2:].data_ptr()


# ------------------------------------------------------------ checkpoints
def test_save_and_load_checkpoint_round_trip(tmp_path):
    """ckpt/io's tree checkpoint (the orbax pair's port): a nested tree
    of tensors and scalars comes back bitwise, through a temporary file
    renamed into place; with `like`, each tensor takes its like's dtype
    and a changed shape or key set raises."""
    from wedetect_tpu_torch.ckpt import io as CIO

    tree = {"params": {"w": torch.randn(3, 4), "b": torch.arange(4.0)},
            "opt": [torch.ones(2), {"count": 3}], "step": 7}
    CIO.save_checkpoint(str(tmp_path / "c"), tree)
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == [
        "checkpoint.pt"]
    got = CIO.load_checkpoint(str(tmp_path / "c"))
    assert torch.equal(got["params"]["w"], tree["params"]["w"])
    assert got["opt"][1] == {"count": 3} and got["step"] == 7
    like = {"params": {"w": torch.zeros(3, 4, dtype=torch.float64),
                       "b": torch.zeros(4)},
            "opt": [torch.zeros(2), {"count": 0}], "step": 0}
    got = CIO.load_checkpoint(str(tmp_path / "c"), like)
    assert got["params"]["w"].dtype == torch.float64
    assert torch.equal(got["params"]["w"].float(), tree["params"]["w"])
    bad = dict(like, params={"w": torch.zeros(4, 3), "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        CIO.load_checkpoint(str(tmp_path / "c"), bad)
    with pytest.raises(ValueError, match="keys"):
        CIO.load_checkpoint(str(tmp_path / "c"), {"params": {}})


OPTIMIZER = r"""
import torch
from wedetect_tpu_torch.parallel.collectives import fsdp_slice
from wedetect_tpu_torch.parallel.fsdp import mark_slice
from wedetect_tpu_torch.parallel.mesh import fsdp_spec, make_mesh
from wedetect_tpu_torch.train.optimizer import make_optimizer, with_grad_accum


def run(mesh):
    g = torch.Generator().manual_seed(0)
    full = [torch.randn(6, 4, generator=g), torch.randn(3, generator=g),
            torch.randn(5, 5, generator=g)]
    specs = [None if mesh is None else fsdp_spec(tuple(p.shape), 2)
             for p in full]
    # over the mesh the parameters are this rank's slices (ZeRO-3)
    params = [p if d is None else
              mark_slice(fsdp_slice(p, d, RANK, 2).clone(), p.shape)
              for p, d in zip(full, specs)]
    named = [("a/kernel", params[0]), ("a/bias", params[1]),
             ("b/kernel", params[2])]
    tx = with_grad_accum(make_optimizer(named, base_lr=1e-2,
                                        grad_clip_norm=0.5), 2)
    if mesh is not None:
        tx.shard(mesh)
    for step in range(6):
        for i, p in enumerate(params):
            grad = torch.randn(full[i].shape, generator=g) * (i + 1)
            p.grad = (grad if specs[i] is None else
                      fsdp_slice(grad, specs[i], RANK, 2).clone())
        tx.step()
    return params, tx.state_dict(), [list(t.shape) for t in tx.mu], specs


one = run(None)
two = run(make_mesh(data=1, fsdp=2))
torch.save({"one": one, "two": two}, f"{OUT}/rank{RANK}.pt")
"""


def test_sharded_optimizer_with_accumulation_and_clip(tmp_path):
    """Optimizer.shard over fsdp = 2 with MultiSteps (2 micro-steps) and
    the global-norm clip active, on parameters and gradients that are
    each rank's slices (ZeRO-3): each rank's parameter slices and its
    gathered state_dict equal the one-process optimizer's within 1e-6
    relative (the accumulated gradient's norm sums the slices' squares
    over the ranks, in another order); the moments are stored as
    half-size slices of the sharded tensors."""
    from wedetect_tpu_torch.parallel.collectives import fsdp_slice

    run_ranks(OPTIMIZER, tmp_path)
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt")
        (p1, s1, shapes1, _), (p2, s2, shapes2, specs) = (res["one"],
                                                          res["two"])
        assert shapes1 == [[6, 4], [3], [5, 5]]
        assert shapes2 == [[3, 4], [3], [5, 5]]
        for a, b, d in zip(p1, p2, specs):
            torch.testing.assert_close(b, fsdp_slice(a, d, r, 2),
                                       rtol=1e-6, atol=1e-7)
        assert s1["count"] == s2["count"] == 3
        for key in ("mu", "nu", "acc"):
            for a, b in zip(s1[key], s2[key]):
                assert a.shape == b.shape
                torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9)
