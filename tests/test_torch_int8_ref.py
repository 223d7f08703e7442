"""The WeDetect-Ref int8 prefill (`RefCfg.quant_int8`,
`RefScorer(quant_prefill=True)`, the Ref CLI's --int8-prefill) against
the JAX package on the CPU, at the tiny Ref config of
tests/torch_ref_util.py.

The f32 Ref score, prefill hidden states and greedy tokens are held to
jitted JAX (REF_TOL, HIDDEN_TOL), against an int8-vs-float gap of ~1e-2
in the logits; the port's float path is the control that must miss. In
bf16 and f32 every quantized call is checked on its own
(test_torch_int8.check_calls): the port's modules in JAX's order with
JAX's weights, and the port's op on JAX's input equal to JAX's op,
bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_int8 import _PortCalls, _record_jax_calls, check_calls
from torch_ref_util import IMG, VSTART, FakeTok, jax_params, port_model
from torch_ref_util import cfgs as ref_cfgs
from torch_ref_util import one_torch_thread  # noqa: F401 (autouse)
from wedetect_tpu.models import ref_generate as JG
from wedetect_tpu.models.ref import RefModules as JRefModules
from wedetect_tpu.models.ref_api import RefScorer as JRefScorer
from wedetect_tpu.nn.qwen3vl import get_rope_index_single_image
from wedetect_tpu_torch.models import ref_generate as TG
from wedetect_tpu_torch.models.ref import cast_ref_model
from wedetect_tpu_torch.models.ref_api import RefScorer
from wedetect_tpu_torch.ops import int8 as TI

REF_TOL = 1e-5          # f32 Ref logits vs jitted JAX
HIDDEN_TOL = 1e-5       # f32 prefill hidden states vs jitted JAX
BOXES = np.array([[0, 0, 10, 10]], np.float32)
ORI = np.array([10.0, 10.0], np.float32)
EOS, PAD = 127, 126


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = ref_cfgs()
    return jcfg, tcfg, jax_params(jcfg)


def _ref_image():
    return np.random.default_rng(7).integers(0, 255, (50, 70, 3),
                                             dtype=np.uint8)


PROPS = np.array([[0, 0, 30, 30], [10, 10, 60, 45], [5, 20, 69, 49]],
                 np.float32)
QUERIES = ["red box", "dog", "the cat on the left"]


def _logit(s):
    return np.log(s / (1 - s))


@pytest.mark.parametrize("prefix_sharing", [True, False])
def test_ref_score_int8_matches_jax(tiny, prefix_sharing):
    """RefScorer(quant_prefill=True).score against JAX's, f32: logits
    within REF_TOL, well below the int8-vs-float gap; the port's float
    scorer (the same model) misses."""
    jcfg, tcfg, params = tiny
    common = dict(tokenizer=FakeTok(), seq_buckets=(64, 128),
                  query_batch=2, max_proposals=4,
                  prefix_sharing=prefix_sharing)
    args = (_ref_image(), PROPS, QUERIES)
    want = _logit(JRefScorer(cfg=jcfg, params=params, quant_prefill=True,
                             **common).score(*args, pad_token_id=0))
    jfloat = _logit(JRefScorer(cfg=jcfg, params=params, **common)
                    .score(*args, pad_token_id=0))
    model = port_model(params, tcfg)
    scorer = RefScorer(cfg=tcfg, model=model, device="cpu",
                       quant_prefill=True, **common)
    got = scorer.logits(*args, pad_token_id=0)
    ctrl = RefScorer(cfg=tcfg, model=model, device="cpu", **common).logits(
        *args, pad_token_id=0)
    assert np.abs(jfloat - want).max() > 100 * REF_TOL
    assert np.abs(got - want).max() <= REF_TOL
    assert np.abs(ctrl - want).max() > REF_TOL
    # the scorer's flag is set for its own calls only
    assert not any(m.quant for m in model.modules()
                   if isinstance(m, TI.QuantLinear))


def test_ref_int8_calls_match_jax(tiny, monkeypatch):
    """Every quantized call of an f32 joint Ref prefill: the ViT blocks'
    qkv, proj and MLP Linears and the decoder's seven projections, in
    JAX's order (patch embed, mergers, extras and the LM head stay
    float); bf16 in tests/test_torch_int8_bf16.py."""
    ref_calls_check(tiny, monkeypatch, "float32")


def ref_calls_check(tiny, monkeypatch, dtype):
    jcfg, tcfg, params = tiny
    jq = dataclasses.replace(jcfg, quant_int8=True)
    tq = dataclasses.replace(tcfg, quant_int8=True)
    model = cast_ref_model(port_model(params, tq), dtype)
    patches, ids, mask, pos, _ = _gen_prompts()
    objp = np.full((2, 1), -1, np.int32)
    calls = _record_jax_calls(monkeypatch)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    mod = JRefModules(jq, 8, 8, dtype=jdt)
    jax.jit(lambda p, *a: mod.apply({"params": p}, *a[:6], 1, a[6],
                                    method=JG._prefill_hidden_kvs))(
        params, patches, ids, mask, pos, BOXES, ORI, objp)
    jax.effects_barrier()
    with _PortCalls(model) as order, torch.no_grad():
        TG._prefill_hidden_kvs(model, 8, 8, patches, ids, mask, pos, BOXES,
                               ORI, 1, objp)
    assert len(calls) == 4 * jcfg.vision.depth + 7 * jcfg.text.layers
    check_calls(calls, order,
                torch.float32 if dtype == "float32" else torch.bfloat16)


def _gen_prompts(seed=0):
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((64, 96)).astype(np.float32)
    rows = [np.concatenate([[1, VSTART], np.full(16, IMG),
                            rng.integers(2, 100, t)]).astype(np.int32)
            for t in (5, 3)]
    p = max(map(len, rows))
    ids = np.zeros((2, p), np.int32)
    mask = np.zeros((2, p), np.int32)
    pos = np.zeros((3, 2, p), np.int32)
    nxt = np.zeros(2, np.int32)
    for r, row in enumerate(rows):
        ids[r, :len(row)] = row
        mask[r, :len(row)] = 1
        pr = get_rope_index_single_image(row, IMG, 8, 8, 2)
        pos[:, r, :len(row)] = pr
        nxt[r] = pr.max() + 1
    return patches, ids, mask, pos, nxt


def test_greedy_tokens_with_quant_prefill(tiny):
    """Greedy generation after an int8 prefill: the prefill's last
    hidden states within HIDDEN_TOL of JAX's int8 prefill (the float
    prefill, the control, misses) and the same tokens as JAX's."""
    jcfg, tcfg, params = tiny
    jq = dataclasses.replace(jcfg, quant_int8=True)
    tq = dataclasses.replace(tcfg, quant_int8=True)
    model = port_model(params, tq)
    patches, ids, mask, pos, nxt = _gen_prompts(seed=3)
    objp = np.full((2, 1), -1, np.int32)
    mod = JRefModules(jq, 8, 8)
    jh, _ = jax.jit(lambda p, *a: mod.apply(
        {"params": p}, *a[:6], 1, a[6], method=JG._prefill_hidden_kvs))(
        params, patches, ids, mask, pos, BOXES, ORI, objp)
    jh = np.asarray(jh)
    with torch.no_grad():
        th, _ = TG._prefill_hidden_kvs(model, 8, 8, patches, ids, mask, pos,
                                       BOXES, ORI, 1, objp)
        with TI.quant_mode(model, False):
            fh, _ = TG._prefill_hidden_kvs(model, 8, 8, patches, ids, mask,
                                           pos, BOXES, ORI, 1, objp)
    real = mask.astype(bool)
    assert np.abs(th.numpy() - jh)[real].max() <= HIDDEN_TOL
    assert np.abs(fh.numpy() - jh)[real].max() > HIDDEN_TOL
    want = np.asarray(JG.ref_generate(
        jq, 8, 8, params, jnp.asarray(patches), jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(pos), 1, jnp.asarray(nxt),
        jnp.asarray(BOXES), jnp.asarray(ORI), 8, EOS, pad_id=PAD))
    got = TG.ref_generate(tq, 8, 8, model, patches, ids, mask, pos, 1, nxt,
                          BOXES, ORI, 8, EOS, pad_id=PAD).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_text_quant_prefill_matches_jax(tiny):
    """RefScorer(quant_prefill=True).generate_text (and the Ref CLI's
    --int8-prefill with --generate) on the CPU: JAX's text."""
    jcfg, tcfg, params = tiny

    class DecTok(FakeTok):
        def decode(self, ids):
            return " ".join(str(i) for i in ids)

    call = dict(max_new_tokens=6, eos_token_id=EOS, pad_token_id=PAD)
    want = JRefScorer(cfg=jcfg, params=params, tokenizer=DecTok(),
                      quant_prefill=True).generate_text(
        _ref_image(), "what is here", **call)
    scorer = RefScorer(cfg=tcfg, model=port_model(params, tcfg),
                       tokenizer=DecTok(), device="cpu", quant_prefill=True)
    assert scorer.generate_text(_ref_image(), "what is here", **call) \
        == want and want
