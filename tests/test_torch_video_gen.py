"""The port's video generation (`ref_generate(grid_t=...)`,
`RefScorer.generate_video_text`, the Ref CLI's --video) against the JAX
package on the CPU, at the tiny video Ref (tests/torch_video_util.py).

Greedy tokens are held exactly in f32, under the margin rule of
tests/test_torch_ref_generate.py: at every generated step the port's
teacher-forced joint forward (its rope ids recomputed by
get_rope_index_single_video over the prompt and the emitted tokens)
picks the emitted token by more than LOGIT_TOL over the runner-up.
That is also the pin of tests/test_video.py's joint-forward test: the
decode continues the text positions at pos.max() + 1. Sampled streams
are equal under the same seed; the prefill's hidden states and KV agree
to 1e-4 in f32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_ref_util import one_torch_thread  # noqa: F401 (autouse)
from torch_video_util import (VID, FakeTok, video_batch, video_cfgs,
                              video_params)
from wedetect_tpu.models import ref_generate as JG
from wedetect_tpu.models.quant import quantize_decode_params as j_quantize
from wedetect_tpu.models.ref import RefModules as JRefModules
from wedetect_tpu.models.ref_api import RefScorer as JRefScorer
from wedetect_tpu_torch.ckpt.convert_ref import from_jax_ref_params
from wedetect_tpu_torch.models import quant as TQ
from wedetect_tpu_torch.models import ref_generate as TG
from wedetect_tpu_torch.models.ref import RefModules
from wedetect_tpu_torch.models.ref_api import RefScorer
from wedetect_tpu_torch.nn.qwen3vl import get_rope_index_single_video
from wedetect_tpu_torch.ops import prng

LOGIT_TOL = 1e-4
HIDDEN_TOL = 1e-4
EOS, PAD = 127, 126


def _port(params, tcfg, attn_impl="auto"):
    model = RefModules(tcfg, attn_impl=attn_impl)
    model.load_state_dict(from_jax_ref_params(params, tcfg), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = video_cfgs()
    params = video_params(jcfg, seed=5)
    return jcfg, tcfg, params, _port(params, tcfg)


def _next_pos(bt):
    return np.array([bt.pos[:, r][:, bt.mask[r] > 0].max() + 1
                     for r in range(bt.ids.shape[0])], np.int32)


def _jax_gen(jcfg, params, bt, max_new, **kw):
    return np.asarray(JG.ref_generate(
        jcfg, bt.gh, bt.gw, params, jnp.asarray(bt.patches),
        jnp.asarray(bt.ids), jnp.asarray(bt.mask), jnp.asarray(bt.pos),
        bt.visual_start, jnp.asarray(_next_pos(bt)), jnp.asarray(bt.boxes),
        jnp.asarray(bt.ori_wh), max_new, EOS, pad_id=PAD, grid_t=bt.gt,
        **kw))


def _port_gen(tcfg, model, bt, max_new, **kw):
    return TG.ref_generate(
        tcfg, bt.gh, bt.gw, model, bt.patches, bt.ids, bt.mask, bt.pos,
        bt.visual_start, _next_pos(bt), bt.boxes, bt.ori_wh, max_new, EOS,
        pad_id=PAD, grid_t=bt.gt, **kw).numpy()


def assert_margins(model, bt, toks):
    """Teacher-force each row's prompt + emitted tokens through the
    port's joint forward, with rope ids recomputed over the whole
    sequence: every emitted token is its step's argmax by more than
    LOGIT_TOL."""
    for r in range(bt.ids.shape[0]):
        n_p = int(bt.mask[r].sum())
        gen = []
        for t in toks[r]:
            gen.append(int(t))
            if t in (EOS, PAD):
                break
        seq = np.concatenate([bt.ids[r, :n_p], gen]).astype(np.int32)
        # rope ids over the prompt and the emitted tokens (an emitted
        # video id is text: it does not join the span)
        text = np.where(np.arange(len(seq)) < n_p, seq, 0)
        pos = get_rope_index_single_video(text, VID, bt.gt, bt.gh, bt.gw, 2)
        # the flash route tiles by 128: right-pad the joint sequence
        n = len(seq)
        pad = -(-n // 128) * 128 - n if model.attn_impl == "flash" else 0
        with torch.no_grad():
            h = model.hidden_states(
                bt.patches, np.pad(seq, (0, pad))[None],
                np.pad(np.ones(n, np.int32), (0, pad))[None],
                np.pad(pos, ((0, 0), (0, pad)))[:, None], bt.boxes,
                bt.ori_wh, bt.visual_start,
                np.full((1, 1), -1, np.int32), grid_h=bt.gh, grid_w=bt.gw,
                grid_t=bt.gt)
            lg = model.lm_logits(h)[0, n_p - 1:n_p - 1 + len(gen)]
        top = torch.topk(lg, 2).values
        np.testing.assert_array_equal(lg.argmax(-1).numpy(), gen)
        margin = float((top[:, 0] - top[:, 1]).min())
        assert margin > LOGIT_TOL, (r, margin)


@pytest.mark.parametrize("route", ["einsum", "flash"])
def test_video_greedy_matches_jax_and_joint_forward(tiny, route):
    """A ragged batch of two rows on one 2-group clip, greedy, f32: JAX's
    ref_generate(grid_t=2) tokens, and the teacher-forced joint forward's.
    The flash route (decoder head_dim 128, attn_impl="flash", the prompt
    padded to 128) runs the port's K2 and K3 plain versions."""
    if route == "flash":
        jcfg, tcfg = video_cfgs(head_dim=128)
        params = video_params(jcfg, seed=5)
        model = _port(params, tcfg, "flash")
        bt = video_batch(seed=2, l_pad=128)
    else:
        jcfg, tcfg, params, model = tiny
        bt = video_batch(seed=2)
    want = _jax_gen(jcfg, params, bt, 10)
    got = _port_gen(tcfg, model, bt, 10)
    np.testing.assert_array_equal(got, want)
    assert_margins(model, bt, got)


def test_video_sampled_stream_matches_jax(tiny):
    jcfg, tcfg, params, model = tiny
    bt = video_batch(seed=3)
    want = _jax_gen(jcfg, params, bt, 10, temperature=0.9,
                    rng=jax.random.PRNGKey(4))
    got = _port_gen(tcfg, model, bt, 10, temperature=0.9,
                    rng=prng.PRNGKey(4))
    np.testing.assert_array_equal(got, want)
    assert len(set(got.ravel().tolist())) > 3        # really sampled


@pytest.mark.parametrize("bits", [8, 4])
def test_video_quantized_decode_matches_jax(tiny, bits):
    """Weight-only int8 / int4 decode on a video prompt: JAX's tokens
    from the same codes."""
    jcfg, tcfg, params, model = tiny
    bt = video_batch(seed=4)
    want = _jax_gen(jcfg, params, bt, 8,
                    decode_params=j_quantize(params, bits=bits))
    got = _port_gen(tcfg, model, bt, 8,
                    decode_params=TQ.quantize_decode_params(model, bits))
    np.testing.assert_array_equal(got, want)


def test_video_prefill_hidden_kvs_match_jax(tiny):
    """The video prefill (_prefill_hidden_kvs(grid_t=2)): hidden states
    and every layer's KV on the real rows, f32 to 1e-4."""
    jcfg, tcfg, params, model = tiny
    bt = video_batch(seed=5, objects=True)
    mod = JRefModules(jcfg, bt.gh, bt.gw, grid_t=bt.gt)
    wh, wkv = jax.jit(lambda p, *a: mod.apply(
        {"params": p}, *a[:6], bt.visual_start, a[6],
        method=JG._prefill_hidden_kvs))(
        params, bt.patches, bt.ids, bt.mask, bt.pos, bt.boxes, bt.ori_wh,
        bt.obj)
    with torch.no_grad():
        th, tkv = TG._prefill_hidden_kvs(
            model, bt.gh, bt.gw, bt.patches, bt.ids, bt.mask, bt.pos,
            bt.boxes, bt.ori_wh, bt.visual_start, bt.obj, grid_t=bt.gt)
    real = bt.mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[real], np.asarray(wh)[real],
                               atol=HIDDEN_TOL)
    for (tk, tv), (jk, jv) in zip(tkv, wkv):
        np.testing.assert_allclose(tk.numpy()[real], np.asarray(jk)[real],
                                   atol=HIDDEN_TOL)
        np.testing.assert_allclose(tv.numpy()[real], np.asarray(jv)[real],
                                   atol=HIDDEN_TOL)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """A 4-frame GIF at 64x96 and a 5-frame .npy stack at 48x64."""
    from PIL import Image

    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    gif = str(root / "clip.gif")
    g = [Image.fromarray((rng.random((64, 96, 3)) * 255).astype(np.uint8))
         for _ in range(4)]
    g[0].save(gif, save_all=True, append_images=g[1:], duration=500, loop=0)
    npy = str(root / "clip.npy")
    np.save(npy, (rng.random((5, 48, 64, 3)) * 255).astype(np.uint8))
    return {"gif": gif, "npy": npy}


def _video_params_for(jcfg, src):
    """JAX params initialised at the grid the scorer builds for src."""
    from wedetect_tpu.data.vision_process import fetch_video, video_to_patches

    frames, _ = fetch_video(src)
    _, gt, gh, gw = video_to_patches(frames, patch=4, temporal_patch=2,
                                     merge=2)
    return video_params(jcfg, seed=6, gt=gt, gh=gh, gw=gw)


@pytest.mark.parametrize("clip,mode", [
    ("gif", "greedy"), ("npy", "greedy"), ("gif", "sampled"),
    ("gif", "int8"), ("npy", "quant_prefill")])
def test_generate_video_text_matches_jax(tiny, clips, clip, mode):
    """RefScorer.generate_video_text end to end (fetch_video,
    video_to_patches, the chat layout, ref_generate(grid_t)) with a stub
    tokenizer: JAX's text."""
    jcfg, tcfg, _, _ = tiny
    params = _video_params_for(jcfg, clips[clip])
    kw = dict(quantize_decode="int8" if mode == "int8" else False,
              quant_prefill=mode == "quant_prefill")
    call = dict(max_new_tokens=6, eos_token_id=EOS, pad_token_id=PAD,
                temperature=0.8 if mode == "sampled" else 0.0, seed=3)
    want = JRefScorer(cfg=jcfg, params=params, tokenizer=FakeTok(),
                      **kw).generate_video_text(clips[clip], "what moves",
                                                **call)
    scorer = RefScorer(cfg=tcfg, model=_port(params, tcfg),
                       tokenizer=FakeTok(), device="cpu", **kw)
    got = scorer.generate_video_text(clips[clip], "what moves", **call)
    assert got == want and got


def test_build_video_prompt_layout(tiny, clips):
    """The prompt: user header, vision start, grid_t * mh * mw video
    tokens from visual_start, vision end, prompt, assistant header,
    right-padded to a multiple of 128; next position pos.max() + 1 is
    st + max(grid_t, mh, mw) plus the text after the span."""
    _, tcfg, _, model = tiny
    scorer = RefScorer(cfg=tcfg, model=model, tokenizer=FakeTok(),
                       device="cpu")
    patches, gt, gh, gw, ids, mask, pos, vs, w, h = \
        scorer.build_video_prompt(clips["npy"], "hi", PAD)
    n_vid = gt * (gh // 2) * (gw // 2)
    assert (gt, w, h) == (3, 64, 48) and patches.shape[0] == gt * gh * gw
    assert len(ids) % 128 == 0 and ids[vs - 1] == tcfg.vision_start_token_id
    assert (ids[vs:vs + n_vid] == VID).all() and ids[vs + n_vid] != VID
    n_real = int(mask.sum())
    assert (ids[n_real:] == PAD).all()
    after = n_real - (vs + n_vid)
    assert pos.max() + 1 == vs + max(gt, gh // 2, gw // 2) + after


def test_video_cli_on_cpu(tmp_path, capsys):
    """--video --generate with a miniature random Ref on the CPU: text is
    printed, the same as the scorer's; --video without --generate
    refuses."""
    from wedetect_tpu_torch.cli import infer_wedetect_ref as cli

    npy = str(tmp_path / "clip.npy")
    np.save(npy, np.random.default_rng(0).integers(
        0, 255, (4, 64, 64, 3), dtype=np.uint8))
    base = ["--video", npy, "--device", "cpu", "--random-init",
            "--generate", "Describe the clip.", "--max_new_tokens", "5"]
    a = cli.main(base)
    assert len(a["text"]) > 0 and a["text"] in capsys.readouterr().out
    b = cli.main(base + ["--int8-decode", "--nframes", "4"])
    assert len(b["text"]) > 0
    with pytest.raises(SystemExit, match="requires --generate"):
        cli.main(["--video", npy, "--device", "cpu", "--random-init"])
