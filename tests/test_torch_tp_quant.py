"""The quantized and speculative modes of tensor-parallel Ref serving in
the port against the JAX package on the CPU: `models/quant.
quantize_decode_params` of a tensor-parallel model (int8, int4 and the
calibrated int4 fit), the int8 prefill (`RefCfg.quant_int8` through
`parallel/mesh.row_linear`), `ref_generate` and `GenServer(mesh=,
decode_params=)` with quantized trees, and `ref_generate_spec`, on
tp = 2 and tp = 4 gloo ranks (tests/torch_dist_util.py), held to JAX's
global-view runs on make_tp_mesh(data=1, tp=4) over four of the 8 host
devices, at tests/test_tp.py's miniature (tests/torch_tp_util.py).

Limits: a rank's decode trees equal the slices of the one-process
port's trees bitwise (codes and scales); every int8 product of the TP
int8 prefill is the one-process product bitwise, so the TP int8 score
logits equal the one-process port's int8 call bitwise once the mergers'
float fc2 (row-parallel, summed in f32 as JAX's global view sums it:
parallel/mesh.py's stated difference) is computed whole; as served they
lie within 1e-5 of the one-process call and of JAX's global-view int8
call (tests/test_torch_int8.py's DET_TOL); generation,
serving and speculative tokens (and the verify-step count) equal JAX's,
on every rank. The calibration statistics of a TP model lie within
1e-5 (relative) of one process's. Two controls must miss: the
row-parallel int8 activation scale taken from the rank's slice (no
MAX), which misses the one-process logits by more than 100 x 1e-5, and
the int4 row layer's column scale fit on the rank's rows alone, whose
row-parallel leaves are not the one-process slices.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax

from test_torch_tp import _flat, _inputs
from torch_dist_util import run_ranks
from torch_tp_util import (GH, GW, QUANT_SERVE_MODES, SPEC_K, SPEC_MODES,
                           SPEC_NEW, serve, tp_cfg)
from wedetect_tpu.models import ref_speculative as JS
from wedetect_tpu.models.quant import quantize_decode_params as j_quantize
from wedetect_tpu.models.ref import RefModules as JRefModules
from wedetect_tpu.models.ref import ref_score_step as j_score
from wedetect_tpu.models.ref_generate import ref_generate as j_generate
from wedetect_tpu.models.serve import GenServer as JGenServer
from wedetect_tpu.nn import qwen3vl as JQ
from wedetect_tpu.parallel.mesh import make_tp_mesh as j_tp_mesh
from wedetect_tpu.parallel.mesh import ref_tp_sharding
from wedetect_tpu_torch.models import quant as TQ
from wedetect_tpu_torch.models.ref import RefModules
from wedetect_tpu_torch.nn import qwen3vl as TQW
from wedetect_tpu_torch.parallel.collectives import CollectiveStats, Group

TPS = (2, 4)
INT8_TOL = 1e-5          # tests/test_torch_int8.py's DET_TOL
CALIB_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's params (saved flat for the ranks) and its global-view runs
    on make_tp_mesh(data=1, tp=4) with int8 / int4 decode trees and the
    int8 prefill: the int8 score logits, greedy tokens, GenServer tokens
    in each QUANT_SERVE_MODES mode, and ref_generate_spec's tokens and
    steps in each SPEC_MODES mode."""
    root = tmp_path_factory.mktemp("tp_quant")
    cfg = tp_cfg(JQ)
    cfg8 = dataclasses.replace(cfg, quant_int8=True)
    score, gen, reqs = _inputs()
    s, g = score, gen
    mod = JRefModules(cfg, GH, GW)
    init = jax.jit(lambda key, *a: mod.init(key, *a[:6], 4, a[6]))
    params = init(jax.random.PRNGKey(0), s["patches"], s["ids"], s["mask"],
                  s["pos"], s["boxes"], s["ori"], s["objp"])["params"]
    mesh = j_tp_mesh(data=1, tp=4, devices=jax.devices()[:4])
    sharded = jax.device_put(params, ref_tp_sharding(mesh, params))
    out = {}
    with mesh:
        trees = {b: j_quantize(sharded, bits=b) for b in (8, 4)}
        out["logits8"] = np.asarray(j_score(
            cfg8, GH, GW, sharded, s["patches"], s["ids"], s["mask"],
            s["pos"], 4, s["boxes"], s["ori"], s["objp"]))
        gen_args = (g["patches"], g["ids"], g["mask"], g["pos"], 1, g["nxt"],
                    g["boxes"], g["ori"])
        out["gen"] = {b: np.asarray(j_generate(
            cfg, GH, GW, sharded, *gen_args, 6, eos_id=95,
            decode_params=trees[b])).tolist() for b in (8, 4)}
        out["spec"] = {}
        for name, kw in SPEC_MODES.items():
            kw = dict(kw)
            bits = kw.pop("bits", None)
            toks, steps = JS.ref_generate_spec(
                cfg, GH, GW, sharded, *gen_args, SPEC_NEW, 95, 0,
                decode_params=trees[bits] if bits else None, spec_k=SPEC_K,
                **kw)
            out["spec"][name] = {"tokens": np.asarray(toks).tolist(),
                                 "steps": int(steps)}
    out["serve"] = {}
    for name, kw in QUANT_SERVE_MODES.items():
        kw = dict(kw)
        bits, pre = kw.pop("bits"), kw.pop("prefill8", False)
        out["serve"][name] = serve(JGenServer, cfg8 if pre else cfg, sharded,
                                   reqs, mesh=mesh, decode_params=trees[bits],
                                   **kw)
    params = jax.tree.map(np.asarray, params)
    np.savez(root / "params.npz", **_flat(params))
    np.savez(root / "inputs.npz",
             **{f"score_{k}": v for k, v in score.items()},
             **{f"gen_{k}": v for k, v in gen.items()},
             **{f"req{r}_{k}": np.asarray(v) for r, q in enumerate(reqs)
                for k, v in q.items()})
    return dict(root=root, **out)


RANKS = r"""
import json
import numpy as np
from wedetect_tpu_torch.ckpt.convert_ref import from_jax_ref_params
from wedetect_tpu_torch.models import quant as TQ
from wedetect_tpu_torch.models.quant_calib import calibrate_decode_acts
from wedetect_tpu_torch.models.ref import (RefModules, ref_score_step,
                                           tp_ref_model)
from wedetect_tpu_torch.models.ref_generate import ref_generate
from wedetect_tpu_torch.models.ref_speculative import ref_generate_spec
from wedetect_tpu_torch.models.serve import GenServer
from wedetect_tpu_torch.nn import qwen3vl as TQW
from wedetect_tpu_torch.ops import int8 as TI
from wedetect_tpu_torch.parallel import mesh as TM
from wedetect_tpu_torch.parallel.collectives import fsdp_slice
import torch.nn.functional as F
from torch_tp_util import (GH, GW, QUANT_SERVE_MODES, SPEC_K, SPEC_MODES,
                           SPEC_NEW, serve, tp_cfg)

cfg = tp_cfg(TQW)
tree = {}
for key, v in np.load(f"{OUT}/params.npz").items():
    node = tree
    *path, leaf = key.split("/")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = v
z = np.load(f"{OUT}/inputs.npz")
s = {k[6:]: z[k] for k in z.files if k.startswith("score_")}
g = {k[4:]: z[k] for k in z.files if k.startswith("gen_")}
reqs = [{k[len(f"req{r}_"):]: z[k] for k in z.files
         if k.startswith(f"req{r}_")} for r in range(4)]
for q in reqs:
    q["nxt"] = int(q["nxt"])
mesh = TM.make_tp_mesh(data=1, tp=WORLD)
model = tp_ref_model(cfg, from_jax_ref_params(tree, cfg, mesh), mesh, "cpu")
one = RefModules(cfg)
one.load_state_dict(from_jax_ref_params(tree, cfg))
one.eval()
t, n = mesh.tp_index, WORLD
out = {}


def flat(node, prefix=""):
    res = {}
    for k, v in node.items():
        if isinstance(v, dict):
            res.update(flat(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            res[prefix + k] = v
    return res


def mismatches(mine, whole):
    # the keys whose rank tensor is not the matching slice of the
    # one-process tensor: o_proj / down_proj by contraction row (rscale
    # with them, scale whole), every other matmul and the tied head by
    # output column (rscale whole)
    bad = []
    mine, whole = flat(mine), flat(whole)
    assert mine.keys() == whole.keys(), (mine.keys() ^ whole.keys())
    for k, w in whole.items():
        leaf = k.split("/")[-1]
        matmul = k.split("/")[-2] if "/" in k else k
        if k == "embed":
            want = fsdp_slice(w, 0, t, n)
        elif leaf not in ("w8", "w4p", "scale", "rscale"):
            want = w
        elif matmul in ("o_proj", "down_proj"):
            want = w if leaf == "scale" else fsdp_slice(w, 0, t, n)
        else:
            want = w if leaf == "rscale" else fsdp_slice(w, w.ndim - 1, t, n)
        if not torch.equal(mine[k], want):
            bad.append(k)
    return bad


batch = dict(grid_h=GH, grid_w=GW, patches=g["patches"], input_ids=g["ids"],
             attn_mask=g["mask"], position_ids=g["pos"], visual_start=1,
             boxes_xyxy=g["boxes"], ori_wh=g["ori"])
calib = calibrate_decode_acts(cfg, one, [batch])
calib_tp = calibrate_decode_acts(cfg, model, [batch])


def np_flat(node, prefix=""):
    res = {}
    for k, v in node.items():
        if isinstance(v, dict):
            res.update(np_flat(v, f"{prefix}{k}/"))
        else:
            res[prefix + k] = np.asarray(v)
    return res


ca, cb = np_flat(calib_tp), np_flat(calib)
out["calib_keys_equal"] = ca.keys() == cb.keys()
out["calib_rel_err"] = max(float(np.abs(ca[k] - cb[k]).max()
                                 / np.abs(cb[k]).max()) for k in cb)

trees = {}
for name, bits, cal in (("int8", 8, None), ("int4", 4, None),
                        ("int4_calibrated", 4, calib)):
    mesh.stats.reset()
    trees[name] = TQ.quantize_decode_params(model, bits, calib=cal)
    out[f"tree_{name}_kinds"] = dict(mesh.stats.kinds)
    out[f"tree_{name}_bad"] = mismatches(
        trees[name], TQ.quantize_decode_params(one, bits, calib=cal))
    out[f"tree_{name}_bytes"] = [
        TQ.quantized_bytes(trees[name]),
        TQ.quantized_bytes(TQ.quantize_decode_params(one, bits, calib=cal))]
# control: the int4 row layers' column scale fit on the rank's rows alone
fit4 = TQ.quantize_weight4
TQ.quantize_weight4 = lambda *a, row_group=None, **k: fit4(*a, **k)
try:
    out["tree_int4_rowfit_bad"] = mismatches(
        TQ.quantize_decode_params(model, 4), TQ.quantize_decode_params(one, 4))
finally:
    TQ.quantize_weight4 = fit4


def score(m):
    return ref_score_step(m, GH, GW, s["patches"], s["ids"], s["mask"],
                          s["pos"], 4, s["boxes"], s["ori"], s["objp"])


def whole_float_rows(lin, x, group):
    # a float row-parallel layer (the mergers' fc2 under the int8
    # prefill) computed whole: its input and weight gathered exactly
    if group is None or getattr(lin, "quant", False):
        return row_linear(lin, x, group)
    return F.linear(TM.gather_vocab(x.contiguous(), group),
                    TM.gather_vocab(lin.weight.contiguous(), group), lin.bias)


# quant_linear(group=) on the rank's K slices against the whole call,
# bitwise, through int_mm_padded_shape's rows, K and N padding
gen = torch.Generator().manual_seed(11)
out["quant_linear_bitwise"] = []
for m, k, nn_ in ((5, 48, 7), (33, 96, 20), (1, 200, 3)):
    x = torch.randn(m, k, generator=gen)
    w = torch.randn(nn_, k, generator=gen)
    bias = torch.randn(nn_, generator=gen)
    got = TI.quant_linear(fsdp_slice(x, 1, t, n), fsdp_slice(w, 1, t, n),
                          bias, mesh.tp)
    out["quant_linear_bitwise"].append(
        bool(torch.equal(got, TI.quant_linear(x, w, bias))))

row_linear = TQW.row_linear
with TI.quant_mode(model, True), TI.quant_mode(one, True):
    mesh.stats.reset()
    np.save(f"{OUT}/logits8_{WORLD}.{RANK}.npy", score(model).numpy())
    out["score8_kinds"] = dict(mesh.stats.kinds)
    np.save(f"{OUT}/one8_{WORLD}.{RANK}.npy", score(one).numpy())
    TQW.row_linear = whole_float_rows
    try:
        np.save(f"{OUT}/whole_merger8_{WORLD}.{RANK}.npy",
                score(model).numpy())
    finally:
        TQW.row_linear = row_linear
    # control: the row-parallel activation scale from the rank's slice
    quantize = TI._quantize
    TI._quantize = lambda x, dims, eps=1e-12, group=None: quantize(
        x, dims, eps, None if dims == -1 else group)
    try:
        np.save(f"{OUT}/local_scale_{WORLD}.{RANK}.npy", score(model).numpy())
    finally:
        TI._quantize = quantize

gen_args = (g["patches"], g["ids"], g["mask"], g["pos"], 1, g["nxt"],
            g["boxes"], g["ori"])
bits_tree = {8: trees["int8"], 4: trees["int4"]}
out["gen"] = {str(b): ref_generate(cfg, GH, GW, model, *gen_args, 6,
                                   eos_id=95,
                                   decode_params=bits_tree[b]).tolist()
              for b in (8, 4)}
out["spec"] = {}
for name, kw in SPEC_MODES.items():
    kw = dict(kw)
    bits = kw.pop("bits", None)
    toks, steps = ref_generate_spec(
        cfg, GH, GW, model, *gen_args, SPEC_NEW, 95, 0,
        decode_params=bits_tree[bits] if bits else None, spec_k=SPEC_K, **kw)
    out["spec"][name] = {"tokens": toks.tolist(), "steps": int(steps)}
out["serve"] = {}
for name, kw in QUANT_SERVE_MODES.items():
    kw = dict(kw)
    bits, pre = kw.pop("bits"), kw.pop("prefill8", False)
    stats = {}
    with TI.quant_mode(model, pre):
        toks = serve(GenServer, cfg, model, reqs, stats=stats, mesh=mesh,
                     decode_params=bits_tree[bits], **kw)
    out["serve"][name] = {"tokens": toks, "stats": stats}
with open(f"{OUT}/rank{WORLD}.{RANK}.json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def ranks(jax_runs):
    """Each world's rank results: {tp: [rank 0's, ...]}."""
    root = jax_runs["root"]
    out = {}
    for tp in TPS:
        run_ranks(RANKS, root, world=tp, timeout=300)
        out[tp] = []
        for r in range(tp):
            with open(root / f"rank{tp}.{r}.json") as f:
                d = json.load(f)
            for name in ("logits8", "one8", "whole_merger8", "local_scale"):
                d[name] = np.load(root / f"{name}_{tp}.{r}.npy")
            out[tp].append(d)
    return out


# ---------------------------------------------------------------- trees


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("tree", ["int8", "int4", "int4_calibrated"])
def test_tree_is_one_process_slice(ranks, tp, tree):
    """(a) quantize_decode_params on a TP model: every rank's codes and
    scales are the slices of the one-process tree bitwise (column layers
    and the tied head by output column, o_proj / down_proj by contraction
    row; int4 rscale whole on column layers, with the rows on row
    layers); a rank holds less than the one-process tree's bytes. The
    plain fits reduce their scales with MAX, the calibrated one gathers
    each matrix whole (float SUMs only)."""
    for r in ranks[tp]:
        assert r[f"tree_{tree}_bad"] == [], r[f"tree_{tree}_bad"]
        mine, whole = r[f"tree_{tree}_bytes"]
        assert mine < whole
        kinds = r[f"tree_{tree}_kinds"]
        if tree == "int4_calibrated":
            assert "max float32" not in kinds and kinds["sum float32"] > 0
        else:
            assert kinds["max float32"] > 0


@pytest.mark.parametrize("tp", TPS)
def test_calibration_on_tp_model(ranks, tp):
    """(b) calibrate_decode_acts on a TP model gives whole-width
    statistics, within 1e-5 of one process's (the row-parallel sums
    only reorder f32 additions), on every rank."""
    for r in ranks[tp]:
        assert r["calib_keys_equal"]
        assert r["calib_rel_err"] <= CALIB_RTOL, r["calib_rel_err"]


# -------------------------------------------------------- int8 prefill


@pytest.mark.parametrize("tp", TPS)
def test_quant_linear_group_bitwise(ranks, tp):
    """(c) ops/int8.quant_linear(group=) on a rank's slice of the
    contraction (MAX scales, the int32 sums summed before the epilogue,
    the bias once): the whole call bitwise, on every rank, with rows, K
    and N padded by the one rule."""
    for r in ranks[tp]:
        assert r["quant_linear_bitwise"] == [True, True, True]


@pytest.mark.parametrize("tp", TPS)
def test_int8_prefill_score(jax_runs, ranks, tp):
    """(c) ref_score_step with the int8 prefill on tp ranks: with the
    mergers' float fc2 computed whole, the one-process port's int8 logits
    bitwise (every int8 product exact: MAX scales, int32 sums); as
    served, within 1e-5 of that call and of JAX's global-view int8 call;
    every rank's logits bitwise rank 0's."""
    r0 = ranks[tp][0]["logits8"]
    for r in ranks[tp]:
        np.testing.assert_array_equal(r["whole_merger8"], r["one8"])
        np.testing.assert_array_equal(r["logits8"], r0)
        assert r["score8_kinds"]["max float32"] > 0
        assert r["score8_kinds"]["sum int32"] > 0
    np.testing.assert_allclose(r0, ranks[tp][0]["one8"], rtol=INT8_TOL,
                               atol=INT8_TOL)
    np.testing.assert_allclose(r0, jax_runs["logits8"], rtol=INT8_TOL,
                               atol=INT8_TOL)


# ---------------------------------------------------------- generation


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("bits", [8, 4])
def test_generate_quantized_matches_jax(jax_runs, ranks, tp, bits):
    """(d) ref_generate with the rank's int8 / int4 tree: JAX's greedy
    tokens from its tree on the global view, on every rank."""
    for r in ranks[tp]:
        assert r["gen"][str(bits)] == jax_runs["gen"][bits]


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("mode", list(QUANT_SERVE_MODES))
def test_serve_quantized_matches_jax(jax_runs, ranks, tp, mode):
    """(e) GenServer(mesh=, decode_params=) on tp ranks: each request's
    JAX tokens on every rank, with int8 and int4 trees, the int8 KV pool,
    a batched admission wave, piggyback admission, and the int8 prefill
    on every admission (sampled)."""
    want = {int(k): v for k, v in jax_runs["serve"][mode].items()}
    assert sum(map(len, want.values())) > 4
    for r in ranks[tp]:
        assert {int(k): v for k, v in r["serve"][mode]["tokens"].items()} \
            == want
        stats = r["serve"][mode]["stats"]
        if mode == "int8_batch_admit":
            assert stats["admit_batches"] >= 1
        if mode == "int4_piggyback":
            assert stats["pb_admits"] >= 1


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("mode", list(SPEC_MODES))
def test_spec_matches_jax(jax_runs, ranks, tp, mode):
    """(f) ref_generate_spec on tp ranks: JAX's tokens and verify-step
    count, plain (drafts accepted: fewer steps than tokens), with every
    draft rejected, and with an int8 tree, on every rank."""
    want = jax_runs["spec"][mode]
    if mode == "force_reject":
        assert want["steps"] == SPEC_NEW
    elif mode == "plain":
        assert want["steps"] < SPEC_NEW
    for r in ranks[tp]:
        assert r["spec"][mode] == want


# ------------------------------------------------------------- controls


@pytest.mark.parametrize("tp", TPS)
def test_local_activation_scale_misses(ranks, tp):
    """(g) The row-parallel int8 activation scale taken from the rank's
    slice (no MAX over the group) misses the one-process int8 logits by
    more than 100 x the JAX limit."""
    err = np.abs(ranks[tp][0]["local_scale"] - ranks[tp][0]["one8"]).max()
    assert err > 100 * INT8_TOL, err


@pytest.mark.parametrize("tp", TPS)
def test_local_int4_row_fit_misses(ranks, tp):
    """(h) The int4 fit of a row layer whose column scale comes from the
    rank's rows alone: the row-parallel leaves (and only they) are not the
    one-process slices."""
    for r in ranks[tp]:
        bad = r["tree_int4_rowfit_bad"]
        assert bad and all(k.split("/")[-2] in ("o_proj", "down_proj")
                           for k in bad), bad


def test_one_process_tree_on_tp_model_raises():
    """A decode tree built on another layout (a one-process model's)
    handed to a TP model's generation raises: a rank decodes from its
    own slices."""
    from wedetect_tpu_torch.models import ref_generate as TG

    cfg = tp_cfg(TQW)
    model = RefModules(cfg, tp=Group(None, [0, 1], 0, CollectiveStats()))
    with pytest.raises(ValueError, match="layout"):
        TG.ref_generate(cfg, GH, GW, model, None, np.zeros((1, 4), np.int32),
                        np.ones((1, 4), np.int32), None, 1, None, None, None,
                        2, 99, decode_params=TQ.quantize_decode_params(
                            RefModules(cfg), bits=8))
