"""Tensor-parallel Ref serving in the port against the JAX package's on
the CPU: `parallel/mesh.make_tp_mesh`, `ref_tp_spec` and
`shard_ref_state`, and `ref_score_step`, `ref_generate` and
`GenServer(mesh=)` on tp = 2 and tp = 4 gloo ranks
(tests/torch_dist_util.py), held to JAX's global-view runs on
make_tp_mesh(data=1, tp=4) over four of the 8 host devices, on the
inputs of tests/test_tp.py.

Tolerances: scoring logits within rtol = atol = 2e-5 of JAX's
(tests/test_tp.py's limit), every rank's bitwise rank 0's; generation
and serving tokens equal JAX's, and every rank's equal. Two controls
must miss the scoring limit: the row-parallel all_reduce dropped, and
the ViT's fused qkv sliced in contiguous column blocks (as JAX's
P(None, "tp") lays out the fused kernel) where the port slices it by
head inside each third.
"""

import json
import types

import numpy as np
import pytest
import torch

import jax

from torch_dist_util import run_ranks
from torch_tp_util import EOS, GH, GW, P, SERVE_MODES, G, serve, tp_cfg
from wedetect_tpu.models.ref import RefModules as JRefModules
from wedetect_tpu.models.ref import ref_score_step as j_score
from wedetect_tpu.models.ref_generate import ref_generate as j_generate
from wedetect_tpu.models.serve import GenServer as JGenServer
from wedetect_tpu.nn import qwen3vl as JQ
from wedetect_tpu.parallel.mesh import make_tp_mesh as j_tp_mesh
from wedetect_tpu.parallel.mesh import ref_tp_sharding
from wedetect_tpu_torch.ckpt.convert_ref import _entries, from_jax_ref_params
from wedetect_tpu_torch.models import quant as TQ
from wedetect_tpu_torch.models.ref import RefModules
from wedetect_tpu_torch.nn import qwen3vl as TQW
from wedetect_tpu_torch.parallel import mesh as TM
from wedetect_tpu_torch.parallel.collectives import CollectiveStats, Group

TOL = 2e-5
TPS = (2, 4)


def _inputs():
    """tests/test_tp.py's inputs: the scoring batch, the generation
    prompt and four serving requests (padded to P)."""
    cfg = tp_cfg(JQ)
    rng = np.random.default_rng(0)
    score = dict(
        patches=rng.standard_normal((GH * GW, 96)).astype(np.float32),
        ids=rng.integers(0, 100, (2, 64)).astype(np.int32),
        mask=np.ones((2, 64), np.int32),
        pos=np.tile(np.arange(64)[None, None], (3, 2, 1)).astype(np.int32),
        boxes=np.array([[1, 1, 30, 40]], np.float32),
        ori=np.array([64.0, 64.0], np.float32),
        objp=np.array([[50], [50]], np.int32))
    n_img = (GH // 2) * (GW // 2)

    def prompt(tail):
        ids = np.concatenate([[1, cfg.vision_start_token_id],
                              np.full(n_img, cfg.image_token_id),
                              rng.integers(2, 100, tail)]).astype(np.int32)
        pos = JQ.get_rope_index_single_image(ids, cfg.image_token_id, GH,
                                             GW, 2)
        return ids, pos

    ids0, pos0 = prompt(5)
    gen = dict(patches=rng.standard_normal((GH * GW, 96)).astype(np.float32),
               ids=ids0[None], mask=np.ones((1, len(ids0)), np.int32),
               pos=pos0[:, None].astype(np.int32),
               nxt=np.array([pos0.max() + 1], np.int32),
               boxes=np.array([[0, 0, 64, 64]], np.float32),
               ori=np.array([64.0, 64.0], np.float32))
    reqs = []
    for r in range(4):
        ids, pos = prompt(3 + r)
        p_ids = np.zeros(P, np.int32)
        p_ids[:len(ids)] = ids
        p_mask = (np.arange(P) < len(ids)).astype(np.int32)
        p_pos = np.zeros((3, P), np.int32)
        p_pos[:, :len(ids)] = pos
        reqs.append(dict(
            patches=rng.standard_normal((GH * GW, 96)).astype(np.float32),
            ids=p_ids, mask=p_mask, pos=p_pos, nxt=int(pos.max()) + 1))
    return score, gen, reqs


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's params (saved flat for the ranks) and its global-view runs on
    make_tp_mesh(data=1, tp=4): scoring logits, greedy tokens and the
    GenServer's tokens in each mode."""
    root = tmp_path_factory.mktemp("tp")
    cfg = tp_cfg(JQ)
    score, gen, reqs = _inputs()
    s = score
    mod = JRefModules(cfg, GH, GW)
    init = jax.jit(lambda key, *a: mod.init(key, *a[:6], 4, a[6]))
    params = init(jax.random.PRNGKey(0), s["patches"], s["ids"], s["mask"],
                  s["pos"], s["boxes"], s["ori"], s["objp"])["params"]
    mesh = j_tp_mesh(data=1, tp=4, devices=jax.devices()[:4])
    specs = ref_tp_sharding(mesh, params)
    sharded = jax.device_put(params, specs)
    with mesh:
        logits = np.asarray(j_score(
            cfg, GH, GW, sharded, s["patches"], s["ids"], s["mask"],
            s["pos"], 4, s["boxes"], s["ori"], s["objp"]))
        toks = np.asarray(j_generate(
            cfg, GH, GW, sharded, gen["patches"], gen["ids"], gen["mask"],
            gen["pos"], 1, gen["nxt"], gen["boxes"], gen["ori"], 6,
            eos_id=95))
    served = {name: serve(JGenServer, cfg, sharded, reqs, mesh=mesh, **kw)
              for name, kw in SERVE_MODES.items()}
    params = jax.tree.map(np.asarray, params)
    np.savez(root / "params.npz", **_flat(params))
    np.savez(root / "inputs.npz",
             **{f"score_{k}": v for k, v in score.items()},
             **{f"gen_{k}": v for k, v in gen.items()},
             **{f"req{r}_{k}": np.asarray(v) for r, q in enumerate(reqs)
                for k, v in q.items()})
    return dict(root=root, params=params, specs=specs, logits=logits,
                toks=toks, served=served)


RANKS = r"""
import json
import numpy as np
from wedetect_tpu_torch.ckpt.convert_ref import from_jax_ref_params
from wedetect_tpu_torch.models.ref import (init_ref_variables, ref_score_step,
                                           tp_ref_model)
from wedetect_tpu_torch.models.ref_generate import ref_generate
from wedetect_tpu_torch.models.serve import GenServer
from wedetect_tpu_torch.nn import qwen3vl as TQW
from wedetect_tpu_torch.parallel import mesh as TM
from wedetect_tpu_torch.parallel.collectives import fsdp_slice
from torch_tp_util import GH, GW, SERVE_MODES, serve, tp_cfg

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


def score(m):
    return ref_score_step(m, GH, GW, s["patches"], s["ids"], s["mask"],
                          s["pos"], 4, s["boxes"], s["ori"], s["objp"])


out = {"tp_index": mesh.tp_index, "tp_ranks": mesh.tp.ranks}
np.save(f"{OUT}/logits{WORLD}.{RANK}.npy", score(model).numpy())
row_sum = TM.row_sum
TM.row_sum = lambda tp, y: y
np.save(f"{OUT}/no_reduce{WORLD}.{RANK}.npy", score(model).numpy())
TM.row_sum = row_sum
# the fused qkv in contiguous column blocks: rank t holds rows
# [t 3h / tp, (t + 1) 3h / tp) of the (3h, h) weight
full = from_jax_ref_params(tree, cfg)
blocks = from_jax_ref_params(tree, cfg, mesh)
for k in blocks:
    if ".attn.qkv." in k:
        blocks[k] = fsdp_slice(full[k], 0, mesh.tp_index, WORLD).clone()
np.save(f"{OUT}/qkv_blocks{WORLD}.{RANK}.npy",
        score(tp_ref_model(cfg, blocks, mesh, "cpu")).numpy())
out["generate"] = ref_generate(
    cfg, GH, GW, model, g["patches"], g["ids"], g["mask"], g["pos"], 1,
    g["nxt"], g["boxes"], g["ori"], 6, eos_id=95).tolist()
out["serve"] = {}
for name, kw in SERVE_MODES.items():
    stats = {}
    toks = serve(GenServer, cfg, model, reqs, stats=stats, mesh=mesh, **kw)
    out["serve"][name] = {"tokens": toks, "stats": stats}
pool = GenServer(cfg, GH, GW, model, slots=2, prompt_len=8, max_new=2,
                 eos_id=1, mesh=mesh, kv_bits=8)._state.caches[0][0]
out["kv8_pool"] = [list(pool["q8"].shape), list(pool["s"].shape)]
# init_ref_variables(mesh=): the slices of the one-process init, bitwise
one = TM.shard_ref_state(init_ref_variables(cfg, 5, "cpu").state_dict(),
                         mesh, cfg)
mine = init_ref_variables(cfg, 5, "cpu", mesh=mesh).state_dict()
out["init_slices_equal"] = (one.keys() == mine.keys() and all(
    torch.equal(one[k], mine[k]) for k in one))
if WORLD == 4:
    m22 = TM.make_tp_mesh(data=2, tp=2)
    out["data2"] = [m22.data_index, m22.tp_index, m22.tp.ranks,
                    m22.data_group.ranks]
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
            for name in ("logits", "no_reduce", "qkv_blocks"):
                d[name] = np.load(root / f"{name}{tp}.{r}.npy")
            out[tp].append(d)
    return out


# ------------------------------------------------------------- layout


def _jax_leaf(tree, path):
    for name in path:
        tree = tree[name]
    return tree


def test_ref_tp_spec_is_jax_rule(jax_runs):
    """(a) For every parameter, ref_tp_spec on the port's key and torch
    shape gives the axis of JAX's ref_tp_sharding on the same tensor,
    mapped through the converter's key map: P(None, "tp") on a Dense
    kernel (in, out) is "column" (the Linear weight's rows), P("tp",
    None) "row" (its columns), on the embedding "vocab", P() whole.
    The local view then differs as stated in parallel/mesh.py: the
    fused qkv is cut by head inside each third ("qkv"), and the biases
    of column-parallel layers, which JAX replicates, follow their
    rows."""
    cfg = tp_cfg(TQW)
    sd = from_jax_ref_params(jax_runs["params"], cfg)
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    want_of = {(None, "tp"): "column", ("tp", None): "row"}
    counts = {}
    for key, path, _ in _entries(cfg, lm_head=False):
        spec = tuple(_jax_leaf(jax_runs["specs"], path).spec)
        if not spec:
            want = None
        elif path[-1] == "embedding":
            want = "vocab" if spec == ("tp", None) else spec
        else:
            want = want_of[spec]
        got = TM.ref_tp_spec(key, shapes[key], 4)
        assert got == want, (key, path, spec)
        counts[got] = counts.get(got, 0) + 1
        kind = TM.ref_tp_kind(key, shapes, 4)
        if key.endswith("attn.qkv.weight") or key.endswith("attn.qkv.bias"):
            assert kind == "qkv", key
        elif key.endswith(".bias") and TM.ref_tp_spec(
                key[:-4] + "weight", shapes[key[:-4] + "weight"],
                4) == "column":
            assert kind == "column", key
        else:
            assert kind == got, key
    # per ViT block qkv, fc1; per merger fc1; per layer q, k, v, gate,
    # up; per block proj, fc2; per merger fc2; per layer o, down
    v, t = cfg.vision, cfg.text
    n_merge = 1 + len(v.deepstack_idx)
    assert counts == {"column": 2 * v.depth + n_merge + 5 * t.layers,
                      "row": 2 * v.depth + n_merge + 2 * t.layers,
                      "vocab": 1, None: len(shapes) - counts["column"]
                      - counts["row"] - 1}


def _unshard(shards, key, kind):
    """The full tensor from every rank's slice (the inverse of
    ref_tp_slice); "qkv" joins each third's blocks."""
    if kind is None:
        return shards[0][key]
    if kind == "qkv":
        thirds = [[s[key].chunk(3, dim=0)[i] for s in shards]
                  for i in range(3)]
        return torch.cat([torch.cat(t) for t in thirds])
    return torch.cat([s[key] for s in shards], dim=1 if kind == "row" else 0)


@pytest.mark.parametrize("tp", TPS)
def test_shards_reassemble_bitwise(jax_runs, tp):
    """(b) The tp ranks' slices put back together are the full state
    dict bitwise; each rank holds 1 / tp of every sharded tensor."""
    cfg = tp_cfg(TQW)
    full = from_jax_ref_params(jax_runs["params"], cfg)
    shards = [TM.shard_ref_state(full, types.SimpleNamespace(
        shape={"tp": tp}, tp_index=i), cfg) for i in range(tp)]
    shapes = {k: tuple(v.shape) for k, v in full.items()}
    n_sharded = 0
    for key, t in full.items():
        kind = TM.ref_tp_kind(key, shapes, tp)
        assert torch.equal(_unshard(shards, key, kind), t), key
        if kind is not None:
            n_sharded += 1
            assert shards[0][key].numel() * tp == t.numel(), key
    assert n_sharded > 0
    # the local model takes the slices as they are
    model = RefModules(cfg, tp=Group(None, list(range(tp)), 0,
                                     CollectiveStats()))
    model.load_state_dict(shards[0], strict=True)


# -------------------------------------------------------------- entries


@pytest.mark.parametrize("tp", TPS)
def test_score_matches_jax(jax_runs, ranks, tp):
    """(c) ref_score_step on tp ranks: JAX's TP logits within 2e-5, and
    every rank's output bitwise rank 0's."""
    want = jax_runs["logits"]
    r0 = ranks[tp][0]["logits"]
    np.testing.assert_allclose(r0, want, rtol=TOL, atol=TOL)
    for r in ranks[tp]:
        np.testing.assert_array_equal(r["logits"], r0)


@pytest.mark.parametrize("tp", TPS)
def test_generate_matches_jax(jax_runs, ranks, tp):
    """(d) ref_generate on tp ranks: JAX's greedy TP tokens on every
    rank."""
    for r in ranks[tp]:
        assert r["generate"] == jax_runs["toks"].tolist()


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_serve_matches_jax(jax_runs, ranks, tp, mode):
    """(e) GenServer(mesh=) on tp ranks: each request's JAX tokens, in
    every rank (greedy, warped sampling, the int8 KV pool on the rank's
    kv heads, piggyback admission, a batched admission wave)."""
    want = {int(k): v for k, v in jax_runs["served"][mode].items()}
    assert sum(map(len, want.values())) > 4
    for r in ranks[tp]:
        assert {int(k): v for k, v in r["serve"][mode]["tokens"].items()} \
            == want
        if mode == "batch_admit":
            assert r["serve"][mode]["stats"]["admit_batches"] >= 1
    if mode == "kv8":
        kvh = tp_cfg(TQW).text.kv_heads // tp
        assert ranks[tp][0]["kv8_pool"] == [[2, 10, kvh, 16], [2, 10, kvh]]


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("control", ["no_reduce", "qkv_blocks"])
def test_controls_miss(jax_runs, ranks, tp, control):
    """(f) Dropping the row-parallel all_reduce, or slicing the fused
    qkv in contiguous blocks, misses JAX's logits by far more than the
    limit."""
    err = np.abs(ranks[tp][0][control] - jax_runs["logits"]).max()
    assert err > 100 * TOL, err


@pytest.mark.parametrize("tp", TPS)
def test_rank_layout(ranks, tp):
    """make_tp_mesh: rank r = d * tp + t; init_ref_variables(mesh=) gives
    each rank the slices of the one-process init bitwise."""
    for r, d in enumerate(ranks[tp]):
        assert d["tp_index"] == r and d["tp_ranks"] == list(range(tp))
        assert d["init_slices_equal"]
    if tp == 4:
        assert [d["data2"] for d in ranks[4]] == [
            [0, 0, [0, 1], [0, 2]], [0, 1, [0, 1], [1, 3]],
            [1, 0, [2, 3], [0, 2]], [1, 1, [2, 3], [1, 3]]]


# --------------------------------------------------------------- limits


def _fake_tp(size):
    """A tp group of `size` with no process group behind it: its
    collectives return their input (enough to reach the raises)."""
    return Group(None, list(range(size)), 0, CollectiveStats())


def _tp_model(cfg=None):
    return RefModules(cfg or tp_cfg(TQW), tp=_fake_tp(2))


def _limit(case):
    from wedetect_tpu_torch.models.serve import GenServer
    from wedetect_tpu_torch.models.serve_http import GenService

    cfg = tp_cfg(TQW)
    if case == "tp_not_dividing_heads":
        # tp = 8 divides JAX's widths but not the ViT's 4 heads
        RefModules(cfg, tp=_fake_tp(8))
    elif case == "shard_not_dividing_heads":
        TM.shard_ref_state(RefModules(cfg).state_dict(),
                           types.SimpleNamespace(shape={"tp": 3},
                                                 tp_index=0), cfg)
    elif case == "one_process_tree_to_server":
        mesh = types.SimpleNamespace(shape={"tp": 2})
        model = _tp_model()
        mesh.tp = model.tp
        GenServer(cfg, GH, GW, model, prompt_len=P, max_new=G, eos_id=EOS,
                  mesh=mesh, decode_params=TQ.quantize_decode_params(
                      RefModules(cfg)))
    elif case == "serve_http":
        GenService(types.SimpleNamespace(model=_tp_model()))
    elif case == "server_without_mesh":
        GenServer(cfg, GH, GW, _tp_model(), prompt_len=P, max_new=G,
                  eos_id=EOS)


LIMITS = {"tp_not_dividing_heads": ValueError,
          "shard_not_dividing_heads": ValueError,
          "one_process_tree_to_server": ValueError,
          "serve_http": NotImplementedError,
          "server_without_mesh": ValueError}


@pytest.mark.parametrize("case", list(LIMITS))
def test_stated_limits_raise(case):
    """(g) What this port leaves out raises, with a message: a tp that
    does not divide the heads (where JAX's global view accepts any tp
    that divides a width), the HTTP service under TP, a TP model served
    without its mesh, and a TP server handed a one-process decode tree
    (a rank decodes from its own slices: tests/test_torch_tp_quant.py
    runs the quantized and speculative modes)."""
    with pytest.raises(LIMITS[case]) as e:
        _limit(case)
    if LIMITS[case] is NotImplementedError:
        assert "ROADMAP.md §1 item" in str(e.value)


def test_row_linear_adds_bias_once():
    """A row-parallel Linear's bias is added once, after the sum over
    the group: two halves of a Linear through a summing fake group give
    the whole Linear's output, and the one-process path is the Linear
    itself."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 3)
    x = torch.randn(4, 8)
    halves = []
    for i in range(2):
        part = torch.nn.Linear(4, 3)
        with torch.no_grad():
            part.weight.copy_(lin.weight[:, 4 * i:4 * i + 4])
            part.bias.copy_(lin.bias)
        halves.append((part, x[:, 4 * i:4 * i + 4]))

    class Sum:
        size, index = 2, 0

        def all_reduce(self, y):
            other, xo = halves[1]
            return y.add_(torch.nn.functional.linear(xo, other.weight))

    with torch.no_grad():
        got = TM.row_linear(halves[0][0], halves[0][1], Sum())
        torch.testing.assert_close(got, lin(x), rtol=1e-6, atol=1e-6)
        assert torch.equal(TM.row_linear(lin, x, None), lin(x))
