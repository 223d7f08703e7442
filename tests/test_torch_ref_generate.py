"""The port's generation (`wedetect_tpu_torch/models/ref_generate.py`,
`models/ref_speculative.py`, `RefScorer.generate_text`, the Ref CLI's
--generate) and the untied LM head against the JAX package on the CPU.

Greedy tokens are held exactly in f32, under a margin rule: at every
generated step the teacher-forced logits of the port model pick the
emitted token by more than LOGIT_TOL over the runner-up, so a token
cannot flip at a near-tie between the frameworks (their f32 logits
agree to ~1e-6). Sampled streams are equal under the same seed (the
`ops/prng` twin of jax.random). The prefill's hidden states and KV
agree to 1e-4 in f32 and to BF16_TOL of their largest entry in bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_ref_util import FakeTok, IMG, VSTART, cfgs, jax_params, \
    port_model
from torch_ref_util import one_torch_thread  # noqa: F401 (autouse)
from wedetect_tpu.models import ref_generate as JG
from wedetect_tpu.models import ref_speculative as JS
from wedetect_tpu.models.quant import quantize_decode_params as j_quantize
from wedetect_tpu.models.ref import RefModules as JRefModules
from wedetect_tpu.models.ref_api import RefScorer as JRefScorer
from wedetect_tpu.nn.qwen3vl import get_rope_index_single_image
from wedetect_tpu_torch.ckpt.convert_ref import from_jax_decode_params
from wedetect_tpu_torch.models import quant as TQ
from wedetect_tpu_torch.models import ref_generate as TG
from wedetect_tpu_torch.models import ref_speculative as TS
from wedetect_tpu_torch.models.ref import cast_ref_model
from wedetect_tpu_torch.models.ref_api import RefScorer
from wedetect_tpu_torch.nn.qwen3vl import interleaved_mrope_cos_sin
from wedetect_tpu_torch.ops import prng

LOGIT_TOL = 1e-4
HIDDEN_TOL = 1e-4
BF16_TOL = 3e-2
GH = GW = 8
EOS, PAD = 127, 126
BOXES = np.array([[0, 0, 10, 10]], np.float32)
ORI = np.array([10.0, 10.0], np.float32)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = cfgs()
    params = jax_params(jcfg)
    return jcfg, tcfg, params, port_model(params, tcfg)


def _untied(params, tcfg, seed=7):
    rng = np.random.default_rng(seed)
    head = rng.standard_normal((tcfg.text.hidden, tcfg.text.vocab_size))
    return dict(params, lm_head={"kernel": (head * 0.2).astype(np.float32)})


def _prompts(tails, seed=0):
    """One image and right-padded prompts of the given tail lengths:
    (patches, ids (B, P), mask, pos (3, B, P), next_pos (B,))."""
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((GH * GW, 96)).astype(np.float32)
    rows = []
    for tail in tails:
        ids = np.concatenate([[1, VSTART], np.full(16, IMG),
                              rng.integers(2, 100, tail)]).astype(np.int32)
        rows.append((ids, get_rope_index_single_image(ids, IMG, GH, GW, 2)))
    p = max(len(r[0]) for r in rows)
    b = len(rows)
    ids = np.zeros((b, p), np.int32)
    mask = np.zeros((b, p), np.int32)
    pos = np.zeros((3, b, p), np.int32)
    for r, (i_r, p_r) in enumerate(rows):
        ids[r, :len(i_r)] = i_r
        mask[r, :len(i_r)] = 1
        pos[:, r, :len(i_r)] = p_r
    nxt = np.array([r[1].max() + 1 for r in rows], np.int32)
    return patches, ids, mask, pos, nxt


def _jax_gen(jcfg, params, pr, max_new, **kw):
    patches, ids, mask, pos, nxt = pr
    return np.asarray(JG.ref_generate(
        jcfg, GH, GW, params, jnp.asarray(patches), jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(pos), 1, jnp.asarray(nxt),
        jnp.asarray(BOXES), jnp.asarray(ORI), max_new, EOS, pad_id=PAD,
        **kw))


def _port_gen(tcfg, model, pr, max_new, **kw):
    patches, ids, mask, pos, nxt = pr
    return TG.ref_generate(tcfg, GH, GW, model, patches, ids, mask, pos, 1,
                           nxt, BOXES, ORI, max_new, EOS, pad_id=PAD,
                           **kw).numpy()


def assert_margins(model, pr, toks):
    """Teacher-force each row's prompt + emitted tokens through the port
    model: every emitted token must be the argmax of its step's logits by
    more than LOGIT_TOL."""
    patches, ids, mask, pos, nxt = pr
    for r in range(ids.shape[0]):
        n_p = int(mask[r].sum())
        gen = []
        for t in toks[r]:
            gen.append(int(t))
            if t in (EOS, PAD):
                break
        seq = np.concatenate([ids[r, :n_p], gen]).astype(np.int32)
        spos = np.concatenate(
            [pos[:, r, :n_p],
             np.broadcast_to(nxt[r] + np.arange(len(gen)), (3, len(gen)))],
            axis=1)
        with torch.no_grad():
            h = model.hidden_states(
                patches, seq[None], np.ones((1, len(seq)), np.int32),
                spos[:, None], BOXES, ORI, 1, np.full((1, 1), -1, np.int32),
                grid_h=GH, grid_w=GW)
            lg = model.lm_logits(h)[0, n_p - 1:n_p - 1 + len(gen)]
        top = torch.topk(lg, 2).values
        np.testing.assert_array_equal(lg.argmax(-1).numpy(), gen)
        margin = float((top[:, 0] - top[:, 1]).min())
        assert margin > LOGIT_TOL, (r, margin)


def test_decode_layer_matches_jax(tiny):
    jcfg, tcfg, params, model = tiny
    c = tcfg.text
    rng = np.random.default_rng(3)
    b, cap, w = 2, 12, 7
    x = rng.standard_normal((b, 1, c.hidden)).astype(np.float32)
    ck = rng.standard_normal((b, cap, c.kv_heads, c.head_dim)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    valid = np.ones((b, cap), np.int32)
    valid[0, 9:] = 0
    valid[1, 3] = 0
    pos3 = torch.tensor([[[20], [25]]] * 3)
    cos, sin = (t.numpy() for t in interleaved_mrope_cos_sin(pos3, c))
    jx, jk, jv = JG._decode_layer(
        params["text"]["layer1"], jcfg.text, jnp.asarray(x),
        jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(ck), jnp.asarray(cv),
        w, jnp.asarray(valid))
    tk, tv = torch.tensor(ck), torch.tensor(cv)
    with torch.no_grad():
        tx = TG._decode_layer(TQ.decode_params(model)["text"]["layer1"], c,
                              torch.tensor(x), torch.tensor(cos),
                              torch.tensor(sin), tk, tv, w,
                              torch.tensor(valid))
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx),
                               atol=HIDDEN_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=HIDDEN_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=HIDDEN_TOL)


@pytest.mark.parametrize("untied", [False, True])
def test_greedy_matches_jax(tiny, untied):
    """A ragged batch of two prompt lengths (B = 2), greedy, f32: the
    same tokens as JAX's ref_generate, under the margin rule; with an
    untied head, generation reads it on every step."""
    jcfg, tcfg, params, model = tiny
    if untied:
        params = _untied(params, tcfg)
        model = port_model(params, tcfg)
        assert model.lm_head is not None
    pr = _prompts((5, 3))
    want = _jax_gen(jcfg, params, pr, 10)
    got = _port_gen(tcfg, model, pr, 10)
    np.testing.assert_array_equal(got, want)
    assert_margins(model, pr, got)


def test_sampled_stream_matches_jax(tiny):
    jcfg, tcfg, params, model = tiny
    pr = _prompts((5, 3), seed=1)
    want = _jax_gen(jcfg, params, pr, 10, temperature=0.9,
                    rng=jax.random.PRNGKey(5))
    got = _port_gen(tcfg, model, pr, 10, temperature=0.9,
                    rng=prng.PRNGKey(5))
    np.testing.assert_array_equal(got, want)
    assert len(set(got.ravel().tolist())) > 3        # really sampled


def test_eos_stops_rows_and_pads(tiny):
    """eos is emitted, later columns are pad; the port's early exit once
    every row is done gives JAX's full-length output."""
    jcfg, tcfg, params, model = tiny
    pr = _prompts((5, 3))
    first = _port_gen(tcfg, model, pr, 4)
    eos = int(first[0, 2])                     # a token row 0 emits
    kw = dict(eos_id=eos)
    patches, ids, mask, pos, nxt = pr
    want = np.asarray(JG.ref_generate(
        jcfg, GH, GW, params, jnp.asarray(patches), jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(pos), 1, jnp.asarray(nxt),
        jnp.asarray(BOXES), jnp.asarray(ORI), 20, eos, pad_id=PAD))
    got = TG.ref_generate(tcfg, GH, GW, model, patches, ids, mask, pos, 1,
                          nxt, BOXES, ORI, 20, pad_id=PAD, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 3:] == PAD).all()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_decode_matches_jax(tiny, bits):
    """Weight-only int8 / int4 decode from the same codes (the JAX tree
    carried across, and the port's own tree, which is bitwise equal):
    the same tokens as JAX's at this seed."""
    jcfg, tcfg, params, model = tiny
    jq = j_quantize(params, bits=bits)
    pr = _prompts((5, 3), seed=2)
    want = _jax_gen(jcfg, params, pr, 8, decode_params=jq)
    got = _port_gen(tcfg, model, pr, 8,
                    decode_params=TQ.quantize_decode_params(model, bits))
    np.testing.assert_array_equal(got, want)
    got2 = _port_gen(tcfg, model, pr, 8,
                     decode_params=from_jax_decode_params(jq))
    np.testing.assert_array_equal(got2, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_hidden_kvs_matches_jax(tiny, dtype):
    jcfg, tcfg, params, _ = tiny
    model = cast_ref_model(port_model(params, tcfg), dtype)
    patches, ids, mask, pos, _ = _prompts((5, 3))
    objp = np.full((2, 1), -1, np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    mod = JRefModules(jcfg, GH, GW, dtype=jdt)
    jh, jkvs = jax.jit(lambda p, *a: mod.apply(
        {"params": p}, *a[:6], 1, a[6], method=JG._prefill_hidden_kvs))(
        params, patches, ids, mask, pos, BOXES, ORI, objp)
    with torch.no_grad():
        th, tkvs = TG._prefill_hidden_kvs(model, GH, GW, patches, ids, mask,
                                          pos, BOXES, ORI, 1, objp)
    pairs = [(th, jh)] + [(a, b) for tk, jk in zip(tkvs, jkvs)
                          for a, b in zip(tk, jk)]
    for got, want in pairs:
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want)[mask.astype(bool)]
        lim = (HIDDEN_TOL if dtype == "float32"
               else BF16_TOL * np.abs(want).max())
        assert err.max() <= lim, (dtype, err.max(), lim)


def test_draft_lookup_bitwise():
    rng = np.random.default_rng(4)
    for n, k in ((2, 8), (3, 4), (1, 5)):
        hist = rng.integers(0, 6, (5, 40)).astype(np.int32)
        gram = rng.integers(0, 6, (5, n)).astype(np.int32)
        valid = (rng.random((5, 40)) > 0.2).astype(np.int32)
        wd, wf = JS.draft_lookup(jnp.asarray(hist), jnp.asarray(gram),
                                 jnp.asarray(valid), k)
        td, tf = TS.draft_lookup(torch.tensor(hist).long(),
                                 torch.tensor(gram).long(),
                                 torch.tensor(valid), k)
        np.testing.assert_array_equal(td.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(wf))


@pytest.mark.parametrize("force_reject", [False, True])
def test_spec_matches_jax_and_greedy(tiny, force_reject):
    """Prompt-lookup speculative decode: JAX's tokens and verify-step
    count, and the port's own greedy tokens."""
    jcfg, tcfg, params, model = tiny
    pr = _prompts((5, 3))
    patches, ids, mask, pos, nxt = pr
    wt, ws = JS.ref_generate_spec(
        jcfg, GH, GW, params, jnp.asarray(patches), jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(pos), 1, jnp.asarray(nxt),
        jnp.asarray(BOXES), jnp.asarray(ORI), 12, EOS, PAD, spec_k=4,
        force_reject=force_reject)
    tt, steps = TS.ref_generate_spec(
        tcfg, GH, GW, model, patches, ids, mask, pos, 1, nxt, BOXES, ORI, 12,
        EOS, PAD, spec_k=4, force_reject=force_reject)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(wt))
    assert steps == int(ws)
    assert (steps == 12) == force_reject
    np.testing.assert_array_equal(tt.numpy(),
                                  _port_gen(tcfg, model, pr, 12))


class DecTok(FakeTok):
    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.mark.parametrize("mode", ["greedy", "speculative", "int8"])
def test_generate_text_matches_jax(tiny, mode):
    jcfg, tcfg, params, _ = tiny
    img = np.random.default_rng(7).integers(0, 255, (50, 70, 3),
                                            dtype=np.uint8)
    kw = dict(quantize_decode="int8" if mode == "int8" else False)
    call = dict(max_new_tokens=6, eos_token_id=EOS, pad_token_id=PAD,
                speculative=mode == "speculative")
    want = JRefScorer(cfg=jcfg, params=params, tokenizer=DecTok(),
                      **kw).generate_text(img, "what is here", **call)
    scorer = RefScorer(cfg=tcfg, model=port_model(params, tcfg),
                       tokenizer=DecTok(), device="cpu", **kw)
    got = scorer.generate_text(img, "what is here", **call)
    assert got == want and got


def test_generate_cli_on_cpu(tmp_path, capsys):
    """--generate with a miniature random Ref on the CPU, greedy and
    int8-speculative: text is printed, and both modes agree."""
    import cv2

    from wedetect_tpu_torch.cli import infer_wedetect_ref as cli

    path = tmp_path / "img.png"
    cv2.imwrite(str(path), np.random.default_rng(0).integers(
        0, 255, (64, 96, 3), dtype=np.uint8))
    base = ["--image", str(path), "--device", "cpu", "--random-init",
            "--generate", "Describe it.", "--max_new_tokens", "5"]
    a = cli.main(base)
    b = cli.main(base + ["--speculative"])
    assert a["text"] == b["text"] and len(a["text"]) > 0
    assert a["text"] in capsys.readouterr().out


def test_video_and_multi_image_raise(tiny):
    """A video prompt (grid_t = 2: two temporal groups, one contiguous
    span of 2 * 16 tokens, video rope ids) now runs: JAX's tokens."""
    from wedetect_tpu.nn.qwen3vl import get_rope_index_single_video

    jcfg, tcfg, params, model = tiny
    rng = np.random.default_rng(11)
    patches = rng.standard_normal((2 * GH * GW, 96)).astype(np.float32)
    ids = np.concatenate([[1, VSTART], np.full(32, IMG),
                          rng.integers(2, 100, 5)]).astype(np.int32)
    pos = get_rope_index_single_video(ids, IMG, 2, GH, GW, 2)
    nxt = np.array([pos.max() + 1], np.int32)
    want = np.asarray(JG.ref_generate(
        jcfg, GH, GW, params, jnp.asarray(patches), jnp.asarray(ids[None]),
        jnp.ones((1, len(ids)), jnp.int32), jnp.asarray(pos[:, None]), 2,
        jnp.asarray(nxt), jnp.asarray(BOXES), jnp.asarray(ORI), 4, EOS,
        pad_id=PAD, grid_t=2))
    got = TG.ref_generate(tcfg, GH, GW, model, patches, ids[None],
                          np.ones((1, len(ids)), np.int32), pos[:, None], 2,
                          nxt, BOXES, ORI, 4, EOS, pad_id=PAD,
                          grid_t=2).numpy()
    np.testing.assert_array_equal(got, want)
    # quant_prefill is ported: it sets the scorer's cfg, and the model's
    # int8 modules only for the scorer's own calls
    scorer = RefScorer(cfg=tcfg, model=model, device="cpu",
                       quant_prefill=True)
    assert scorer.cfg.quant_int8 and not tcfg.quant_int8
    assert not model.model.language_model.layers[0].self_attn.q_proj.quant


def test_lm_head_loss_matches_jax_and_control_misses(tiny):
    """A stage-1/2 tree with an untied lm_head: one stage-1 ref_lm_step
    gives JAX's loss and grad norm to 1e-5 (the head trains in stage 1,
    as in JAX), and the updated head matches; the same step with the head
    dropped from the port model (the tied embedding) misses."""
    from torch_ref_util import batch
    from wedetect_tpu.train import ref_lm as JLM
    from wedetect_tpu.train.train_step import TrainState as JState
    from wedetect_tpu_torch.train import ref_lm as TLM
    from wedetect_tpu_torch.train.train_step import TrainState

    jcfg, tcfg, params, _ = tiny
    params = _untied(params, tcfg)
    bt = batch(seed=2)
    lab = np.where(bt.mask > 0, bt.ids, JLM.IGNORE_INDEX).astype(np.int32)
    lab[bt.ids == IMG] = JLM.IGNORE_INDEX
    args = (bt.patches, bt.ids, bt.mask, bt.pos, bt.visual_start, bt.boxes,
            bt.ori_wh, bt.obj)
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    jp = jax.tree.map(jnp.asarray, params)
    lr = 1e-3
    js = JState.create({"params": jp}, JLM.stage_optimizer(jp, 1, base_lr=lr))
    js, jm = JLM.ref_lm_step(jcfg, 8, 8, js, *jargs, jnp.asarray(lab), 1)

    def port_step(p):
        model = port_model(p, tcfg)
        ts = TrainState.create(model, TLM.stage_optimizer(model, 1,
                                                          base_lr=lr))
        _, tm = TLM.ref_lm_step(tcfg, 8, 8, ts, *args, lab, 1)
        return model, tm

    model, tm = port_step(params)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                   err_msg=key)
    # Adam's first step moves each entry by about lr * sign(grad): an
    # entry whose gradient is ~0 may flip sign between the frameworks
    err = np.abs(model.lm_head.weight.detach().numpy().T
                 - np.asarray(js.params["lm_head"]["kernel"]))
    assert (err > 1e-6).mean() <= 1e-3 and err.max() <= 2 * lr
    _, control = port_step({k: v for k, v in params.items()
                            if k != "lm_head"})
    assert abs(float(control["loss"]) - float(jm["loss"])) > \
        1e-5 * abs(float(jm["loss"]))
