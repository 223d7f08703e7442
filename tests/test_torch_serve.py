"""The port's continuous-batching engine (`wedetect_tpu_torch/models/
serve.py`) against the JAX package's GenServer on the CPU.

Per request, the port's GenServer emits the JAX GenServer's tokens in
every mode: greedy (also equal to the port's own per-request
ref_generate, under the margin rule of tests/test_torch_ref_generate),
a padded batch_admit wave, piggyback admission, the int8 KV pool,
weight-only int8 and int4 decode, sampling (top-k, top-p, per-request
seeds) and per-request caps. `_kv_quant` is bitwise; `_gqa_int8kv` is
within 1e-5 of JAX's. Scheduling (slots, chunk size, pipelining,
admission path) never changes the tokens; an idle piggyback dispatch
installs nothing.
"""

import copy
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_ref_generate import assert_margins
from torch_ref_util import IMG, VSTART, cfgs, jax_params, port_model
from torch_ref_util import one_torch_thread  # noqa: F401 (autouse)
from wedetect_tpu.models import serve as JSV
from wedetect_tpu.models.quant import quantize_decode_params as j_quantize
from wedetect_tpu.nn.qwen3vl import get_rope_index_single_image
from wedetect_tpu_torch.models import quant as TQ
from wedetect_tpu_torch.models import serve as TSV
from wedetect_tpu_torch.models.ref import RefModules
from wedetect_tpu_torch.models.ref_generate import ref_generate
from wedetect_tpu_torch.parallel.collectives import CollectiveStats, Group

GH = GW = 8
P, G = 32, 6
EOS, PAD = 127, 126
ATTN_TOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = cfgs()
    params = jax_params(jcfg)
    return jcfg, tcfg, params, port_model(params, tcfg)


def _requests(n=5, seed=0):
    """n requests with their own images and tail lengths, padded to P:
    (patches, ids (P,), mask, pos (3, P), next_pos0)."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n):
        ids_r = np.concatenate([[1, VSTART], np.full(16, IMG),
                                rng.integers(2, 100, 3 + r)]).astype(np.int32)
        pos_r = get_rope_index_single_image(ids_r, IMG, GH, GW, 2)
        ids = np.zeros(P, np.int32)
        ids[:len(ids_r)] = ids_r
        mask = np.zeros(P, np.int32)
        mask[:len(ids_r)] = 1
        pos = np.zeros((3, P), np.int32)
        pos[:, :len(ids_r)] = pos_r
        out.append((rng.standard_normal((64, 96)).astype(np.float32), ids,
                    mask, pos, int(pos_r.max()) + 1))
    return out


def _run(server_cls, cfg, m, reqs, caps=None, pipeline=True, **kw):
    srv = server_cls(cfg, GH, GW, m, prompt_len=P, max_new=G, eos_id=EOS,
                     pad_id=PAD, **{"slots": 2, "chunk": 3, **kw})
    rids = [srv.submit(pa, i, ma, po, 1, n0, seed=100 + k,
                       max_new=None if caps is None else caps[k])
            for k, (pa, i, ma, po, n0) in enumerate(reqs)]
    out = srv.run(pipeline=pipeline)
    return [list(map(int, out[r])) for r in rids], srv.stats


MODES = {
    "greedy": {},
    "batch_admit": dict(slots=3, chunk=2, batch_admit=True),
    "piggyback": dict(piggyback=True),
    "kv8": dict(kv_bits=8),
    "int8": dict(bits=8),
    "int4": dict(bits=4),
    "sampled": dict(temperature=0.9, top_k=20, top_p=0.9),
    "caps": dict(caps=[2, None, 1, 4, 3]),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_server_matches_jax_per_request(tiny, mode):
    jcfg, tcfg, params, model = tiny
    kw = dict(MODES[mode])
    bits = kw.pop("bits", None)
    caps = kw.pop("caps", None)
    jkw, tkw = dict(kw), dict(kw)
    if bits:
        jkw["decode_params"] = j_quantize(params, bits=bits)
        tkw["decode_params"] = TQ.quantize_decode_params(model, bits=bits)
    reqs = _requests()
    want, jstats = _run(JSV.GenServer, jcfg, params, reqs, caps, **jkw)
    got, tstats = _run(TSV.GenServer, tcfg, model, reqs, caps, **tkw)
    assert got == want
    assert sum(map(len, got)) > 10
    for key in ("admits", "admit_batches", "pb_admits"):
        assert tstats.get(key) == jstats.get(key), key
    if mode == "batch_admit":
        assert tstats["admit_batches"] >= 1
    if mode == "caps":
        assert [len(t) <= (c or G) for t, c in
                zip(got, MODES["caps"]["caps"])] == [True] * 5
    if mode == "greedy":
        # each request alone through the port's ref_generate
        for (pa, i, ma, po, n0), toks in zip(reqs, got):
            one = (pa, i[None], ma[None], po[:, None], np.array([n0]))
            ref = ref_generate(tcfg, GH, GW, model, pa, i[None], ma[None],
                               po[:, None], 1, np.array([n0]),
                               np.array([[0, 0, 10, 10]], np.float32),
                               np.array([10.0, 10.0], np.float32), G, EOS,
                               pad_id=PAD).numpy()[0]
            trimmed = []
            for t in ref:
                if t in (EOS, PAD):
                    break
                trimmed.append(int(t))
            assert toks == trimmed
            assert_margins(model, one, ref[None])


def test_kv_quant_bitwise_and_int8_attention(tiny):
    _, tcfg, _, _ = tiny
    c = tcfg.text
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 10, c.kv_heads, c.head_dim))
         * rng.random((3, 10, c.kv_heads, 1)) * 4).astype(np.float32)
    jq, js = JSV._kv_quant(jnp.asarray(x))
    tq, ts = TSV._kv_quant(torch.tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    q = rng.standard_normal((3, 1, c.heads, c.head_dim)).astype(np.float32)
    vq, vs = TSV._kv_quant(torch.tensor(x[::-1].copy()))
    valid = (rng.random((3, 10)) > 0.3).astype(np.int32)
    valid[:, 0] = 1
    want = JSV._gqa_int8kv(
        jnp.asarray(q), {"q8": jq, "s": js},
        {"q8": jnp.asarray(vq.numpy()), "s": jnp.asarray(vs.numpy())},
        jnp.asarray(valid), 0.25)
    got = TSV._gqa_int8kv(torch.tensor(q), {"q8": tq, "s": ts},
                          {"q8": vq, "s": vs}, torch.tensor(valid), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)


def test_scheduling_invariance(tiny):
    """The same requests through differently scheduled servers give the
    same tokens: greedy over chunk sizes, slots, pipelining and
    admission paths; sampled over the same, with per-request seeds."""
    _, tcfg, _, model = tiny
    reqs = _requests(seed=3)
    for sampling in ({}, dict(temperature=0.8, top_k=50, top_p=0.9)):
        outs = [_run(TSV.GenServer, tcfg, model, reqs, **sampling, **kw)[0]
                for kw in (dict(slots=3, chunk=3),
                           dict(slots=1, chunk=2, pipeline=False),
                           dict(slots=2, chunk=G, piggyback=True),
                           dict(slots=4, chunk=1, batch_admit=True))]
        assert all(o == outs[0] for o in outs[1:])


def test_idle_piggyback_dispatch_installs_nothing(tiny):
    """_decode_chunk_pb at pend_slot == slots (the JAX package's idle
    dispatch): the prompt rows run and nothing is installed. Its tokens
    and state equal a plain _decode_chunk's, the free slot's prompt
    region and mask stay as they were, and JAX's idle dispatch emits the
    same tokens."""
    jcfg, tcfg, params, model = tiny
    reqs = _requests(n=3, seed=4)
    servers = []
    for cls, cfg, m in ((TSV.GenServer, tcfg, model),
                        (JSV.GenServer, jcfg, params)):
        srv = cls(cfg, GH, GW, m, slots=3, prompt_len=P, max_new=G,
                  chunk=3, eos_id=EOS, pad_id=PAD)
        for pa, i, ma, po, n0 in reqs[:2]:
            srv.submit(pa, i, ma, po, 1, n0)
        srv._admit_queued()
        srv.submit(*reqs[2][:4], 1, reqs[2][4])
        servers.append(srv)
    tsrv, jsrv = servers
    item = tsrv._queue[0]
    emb, ds, mask, pos, ln, np0, vs, seed, cap = tsrv._encode(item)
    before = copy.deepcopy(tsrv._state)
    plain = copy.deepcopy(tsrv._state)
    idle = TSV._decode_chunk_pb(tcfg, 3, EOS, PAD, tsrv.decode_params,
                                tsrv._state, emb, ds, mask, pos, ln, np0, 3,
                                vs, (0.0, 0, 1.0), seed, cap)
    want = TSV._decode_chunk(tcfg, 3, EOS, PAD, tsrv.decode_params, plain)
    np.testing.assert_array_equal(idle.numpy(), want.numpy())
    st = tsrv._state
    for name in ("prompt_mask", "gen_count", "next_pos", "cur_tok", "done",
                 "seeds", "caps"):
        assert torch.equal(getattr(st, name), getattr(plain, name)), name
    assert torch.equal(st.prompt_mask, before.prompt_mask)
    for (k, v), (k0, v0) in zip(st.caches, before.caches):
        assert torch.equal(k[2, :P], k0[2, :P])
        assert torch.equal(v[2, :P], v0[2, :P])
    jemb, jds, jmask, jpos, jln, jnp0, jvs, jseed, jcap = jsrv._encode(
        jsrv._queue[0])
    jtoks, _ = JSV._decode_chunk_pb(
        jcfg, 3, EOS, PAD, jnp.float32, params, jsrv._state, jemb, jds,
        jmask, jpos, jln, jnp0, jnp.asarray(3, jnp.int32), jvs,
        (0.0, 0, 1.0), jseed, jcap)
    np.testing.assert_array_equal(idle.numpy(), np.asarray(jtoks))


def test_pool_allocated_once_and_kv8_bytes(tiny):
    """The KV pool is allocated at construction and written in place by
    every admission and chunk; the int8 pool is 0.52x-0.53x the f32
    pool's bytes at head_dim 16 (codes + one f32 scale a vector)."""
    _, tcfg, _, model = tiny
    reqs = _requests(n=3)
    for kv_bits in (16, 8):
        srv = TSV.GenServer(tcfg, GH, GW, model, slots=2, prompt_len=P,
                            max_new=G, chunk=2, eos_id=EOS, pad_id=PAD,
                            kv_bits=kv_bits)
        ptrs = [(k if kv_bits == 16 else k["q8"]).data_ptr()
                for k, _ in srv._state.caches]
        for pa, i, ma, po, n0 in reqs:
            srv.submit(pa, i, ma, po, 1, n0)
        assert len(srv.run()) == 3
        assert ptrs == [(k if kv_bits == 16 else k["q8"]).data_ptr()
                        for k, _ in srv._state.caches]
        if kv_bits == 16:
            full = srv.pool_bytes()
        else:
            hd = tcfg.text.head_dim
            assert srv.pool_bytes() / full == pytest.approx(
                (hd + 4) / (4 * hd))


def test_mesh_raises(tiny):
    """GenServer(mesh=) serves a model built on the mesh's tp group (the
    tensor-parallel runs are tests/test_torch_tp.py's and
    tests/test_torch_tp_quant.py's): a one-process model under a tp = 2
    mesh raises, and so does a quantized decode tree of the one-process
    model handed to a tensor-parallel model; the tensor-parallel model's
    own quantized tree (its slices and its group) is taken."""
    _, tcfg, _, model = tiny
    tp = Group(None, [0, 1], 0, CollectiveStats())
    mesh = types.SimpleNamespace(shape={"data": 1, "tp": 2}, tp=tp)
    with pytest.raises(ValueError, match="mesh.tp"):
        TSV.GenServer(tcfg, GH, GW, model, prompt_len=P, max_new=G,
                      eos_id=EOS, mesh=mesh)
    tp_model = RefModules(tcfg, tp=tp)
    with pytest.raises(ValueError, match="layout"):
        TSV.GenServer(tcfg, GH, GW, tp_model, prompt_len=P,
                      max_new=G, eos_id=EOS, mesh=mesh,
                      decode_params=TQ.quantize_decode_params(model))
    srv = TSV.GenServer(tcfg, GH, GW, tp_model, prompt_len=P, max_new=G,
                        eos_id=EOS, mesh=mesh,
                        decode_params=TQ.quantize_decode_params(tp_model))
    assert srv.decode_params["tp"] is tp
