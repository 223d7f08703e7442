"""The port's int4 decode calibration (`models/quant_calib.py`,
`RefScorer.calibrate_decode`) and the quantization gate
(`eval/quant_gate.py`, `cli/quant_gate.py`) against the JAX package on
the CPU, at the JAX gate CLI's tiny Ref config (its params carried
across by `ckpt/convert_ref`).

Limits: the calibration sums of squares, counts and RMS to 1e-6
relative (both sides sum f32 squares; the port's sums leave as float64);
the calibrated int4 codes and scales bitwise, with the plain fit as the
control that must differ; each gate field within 1e-6 (cosines, sigmoid
deltas) or exactly (token counts, lengths, bytes, top-1 agreement).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import wedetect_tpu.models.ref as JR
from torch_ref_util import FakeTok, jax_params, port_model
from torch_ref_util import one_torch_thread  # noqa: F401 (autouse)
from wedetect_tpu.cli import quant_gate as JC
from wedetect_tpu.eval import quant_gate as JGate
from wedetect_tpu.models import quant as JQ
from wedetect_tpu.models import quant_calib as JCal
from wedetect_tpu.models.ref_api import RefScorer as JRefScorer
from wedetect_tpu.nn import qwen3vl as JQwen
from wedetect_tpu_torch.cli import quant_gate as TC
from wedetect_tpu_torch.eval import quant_gate as TGate
from wedetect_tpu_torch.models import quant as TQ
from wedetect_tpu_torch.models import quant_calib as TCal
from wedetect_tpu_torch.models.ref_api import RefScorer

REL = 1e-6
GATE_TOL = 1e-6
MAX_NEW = 6


def _jax_cfg(tcfg):
    v, t = tcfg.vision, tcfg.text
    return JQwen.RefCfg(
        vision=JQwen.RefVisionCfg(**{f: getattr(v, f) for f in (
            "depth", "hidden", "heads", "intermediate", "patch",
            "temporal_patch", "merge", "out_hidden", "num_pos_emb",
            "deepstack_idx")}),
        text=JQwen.RefTextCfg(**{f: getattr(t, f) for f in (
            "vocab_size", "hidden", "layers", "heads", "kv_heads",
            "head_dim", "intermediate", "rope_theta", "mrope_section")}),
        image_token_id=tcfg.image_token_id,
        vision_start_token_id=tcfg.vision_start_token_id,
        object_token_id=tcfg.object_token_id)


@pytest.fixture(scope="module")
def gate():
    """The CLI's tiny config on both sides, JAX's params and the port
    model holding them, and JAX's own random batches (its init stubbed
    to these params)."""
    tcfg = TC.tiny_cfg()
    jcfg = _jax_cfg(tcfg)
    params = jax_params(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR.RefModules, "init",
                   lambda self, *a, **k: {"params": params})
        setup = JC._random_setup(0, 3, 2)
    cfg, gh, gw, _, gen, rec, calib, eos, pad = setup
    assert cfg == jcfg
    return dict(jcfg=jcfg, tcfg=tcfg, params=params,
                model=port_model(params, tcfg), gh=gh, gw=gw, gen=gen,
                rec=rec, calib=calib, eos=eos, pad=pad)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def test_random_batches_and_config_match_jax(gate):
    """The CLI's --random config and its seeded batches are JAX's,
    bitwise (the same draws in the same order)."""
    gh, gw, gen, rec, calib = TC.random_batches(0, 3, 2)
    assert (gh, gw) == (gate["gh"], gate["gw"])
    for got, ref in ((gen, gate["gen"]), (rec, gate["rec"])):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(calib) == len(gate["calib"]) == 1
    for k, v in gate["calib"][0].items():
        np.testing.assert_array_equal(np.asarray(calib[0][k]), np.asarray(v))


def test_collect_batch_matches_jax(gate):
    """One calibration batch (right-padded rows, pads masked): the sums
    of squares at every tap and the token count within REL."""
    bt = gate["calib"][0]
    args = (int(bt["grid_h"]), int(bt["grid_w"]))
    want, wcount = JCal.collect_batch(
        gate["jcfg"], *args, gate["params"], jnp.asarray(bt["patches"]),
        jnp.asarray(bt["input_ids"]), jnp.asarray(bt["attn_mask"]),
        jnp.asarray(bt["position_ids"]), int(bt["visual_start"]),
        jnp.asarray(bt["boxes_xyxy"]), jnp.asarray(bt["ori_wh"]))
    got, count = TCal.collect_batch(
        gate["tcfg"], *args, gate["model"], bt["patches"], bt["input_ids"],
        bt["attn_mask"], bt["position_ids"], int(bt["visual_start"]),
        bt["boxes_xyxy"], bt["ori_wh"])
    assert count == float(wcount) == float(bt["attn_mask"].sum())
    want = jax.tree.map(np.asarray, want)
    assert set(got["text"]) == set(want["text"])
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == np.float64 and g.shape == w.shape
        assert _rel(g, w) <= REL


def _scorer_pair(gate, **kw):
    image = np.random.default_rng(5).integers(0, 255, (40, 56, 3),
                                              dtype=np.uint8)
    reqs = [(image, "what is here"), (image, "a dog on the left")]
    j = JRefScorer(cfg=gate["jcfg"], params=gate["params"],
                   tokenizer=FakeTok(), quantize_decode="int4", **kw)
    t = RefScorer(cfg=gate["tcfg"], model=port_model(gate["params"],
                                                     gate["tcfg"]),
                  tokenizer=FakeTok(), device="cpu", quantize_decode="int4",
                  **kw)
    return j, t, reqs


def _int4_leaves(tree):
    """(name, leaf) of every int4 leaf of a decode tree: the seven
    matmuls of each layer and the LM head."""
    out = [("lm_head", tree["lm_head"])]
    for name, layer in sorted(tree["text"].items()):
        if name.startswith("layer"):
            out += [(f"{name}/{k}", layer[k]) for k in TQ._LAYER_MATMULS]
    return out


def test_calibrate_decode_matches_jax(gate):
    """RefScorer.calibrate_decode (two requests through the chat
    template): the activation RMS within REL of JAX's; the int4 tree
    quantize_decode_params fits from JAX's RMS bitwise JAX's, and the
    tree the scorer sets from its own RMS has JAX's codes, its scales
    within REL (they move continuously with the RMS); the plain int4 fit
    (the control) differs from JAX's calibrated codes."""
    j, t, reqs = _scorer_pair(gate)
    want = jax.tree.map(np.asarray, j.calibrate_decode(reqs, pad_token_id=0))
    got = t.calibrate_decode(reqs, pad_token_id=0)
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == np.float32 and _rel(g, w) <= REL
    jtree = _int4_leaves(jax.tree.map(np.asarray, j._decode_params))
    from_jax = _int4_leaves(TQ.quantize_decode_params(t.model, bits=4,
                                                      calib=want))
    own = _int4_leaves(t.decode_tree())
    plain = _int4_leaves(TQ.quantize_decode_params(t.model, bits=4))
    differs = False
    for (name, jl), (_, fl), (_, ol), (_, pl) in zip(jtree, from_jax, own,
                                                     plain):
        for f in ("w4p", "rscale", "scale"):
            assert _bits(fl[f].numpy(), jl[f]), (name, f)
        assert _bits(ol["w4p"].numpy(), jl["w4p"]), name
        for f in ("rscale", "scale"):
            assert _rel(ol[f].numpy(), jl[f]) <= REL, (name, f)
        differs |= not _bits(pl["w4p"].numpy(), jl["w4p"])
    assert differs


def test_calibrate_decode_requires_int4(gate):
    scorer = RefScorer(cfg=gate["tcfg"], model=gate["model"],
                       tokenizer=FakeTok(), device="cpu",
                       quantize_decode="int8")
    with pytest.raises(AssertionError, match="int4"):
        scorer.calibrate_decode([(np.zeros((32, 32, 3), np.uint8), "a")])


def test_substitute_text_kernels_matches_jax(gate):
    """Inside the block every text-layer matmul weight is JAX's
    substituted kernel (transposed), bitwise; the originals return."""
    model, params = gate["model"], gate["params"]
    jq = JQ.quantize_decode_params(params, bits=4)
    want = JGate.substitute_text_kernels(params, jq)["text"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with TGate.substitute_text_kernels(model, TQ.quantize_decode_params(
            model, bits=4)):
        for i, layer in enumerate(model.model.language_model.layers):
            for k, lin in TGate._layer_linears(layer).items():
                assert _bits(lin.weight.detach().T.contiguous().numpy(),
                             np.asarray(want[f"layer{i}"][k]["kernel"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.fixture(scope="module")
def reports(gate):
    g = gate
    args = (g["gh"], g["gw"])
    want = JGate.gate_report(g["jcfg"], *args, g["params"],
                             JQ.quantize_decode_params(g["params"], bits=4),
                             g["gen"], g["rec"], MAX_NEW, g["eos"], g["pad"])
    got = TGate.gate_report(g["tcfg"], *args, g["model"],
                            TQ.quantize_decode_params(g["model"], bits=4),
                            g["gen"], g["rec"], MAX_NEW, g["eos"], g["pad"])
    return got, want


def test_gate_report_matches_jax(reports):
    """Each field of gate_report (plain int4, three prompts, six greedy
    tokens, the REC probe) against JAX's."""
    got, want = reports
    assert set(got) == set(want) and set(got["rec"]) == set(want["rec"])
    for k in ("greedy_agree_tokens_mean", "greedy_agree_frac_mean",
              "greedy_agree_frac_min", "eff_len_mean", "n_prompts",
              "quantized_bytes"):
        assert got[k] == want[k], k
    for k in ("logit_cos_mean", "logit_cos_min"):
        assert abs(got[k] - want[k]) <= GATE_TOL, k
    for k in ("max_abs_delta", "mean_abs_delta"):
        assert abs(got["rec"][k] - want["rec"][k]) <= GATE_TOL, k
    assert got["rec"]["top1_agree"] == want["rec"]["top1_agree"]
    assert got["logit_cos_min"] < 1.0 and got["rec"]["max_abs_delta"] > 0


def test_cli_random_prints_one_json_line(reports, capsys, tmp_path):
    """cli/quant_gate --random --device cpu --calibrate 2: one JSON line
    with the JAX CLI's keys (wedetect_tpu/cli/quant_gate.py main: bits,
    mode, note, plain, calibrated, calib_prompts; each report
    gate_report's), also written to --json_out."""
    _, want = reports
    out = tmp_path / "gate.json"
    TC.main(["--random", "--device", "cpu", "--calibrate", "2",
             "--n_prompts", "2", "--max_new", "4", "--json_out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rep = json.loads(lines[0])
    assert rep == json.loads(out.read_text())
    assert set(rep) == {"bits", "mode", "note", "plain", "calibrated",
                        "calib_prompts"}
    assert rep["bits"] == 4 and rep["mode"] == "random"
    for k in ("plain", "calibrated"):
        assert set(rep[k]) == set(want)
        assert set(rep[k]["rec"]) == set(want["rec"])
        assert rep[k]["n_prompts"] == 2
    with pytest.raises(SystemExit, match="ref_checkpoint"):
        TC.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="bits 4"):
        TC.main(["--random", "--device", "cpu", "--bits", "8",
                 "--calibrate", "2"])
