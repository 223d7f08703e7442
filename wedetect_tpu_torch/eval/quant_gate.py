"""int4 / int8 decode-quantization quality gate.

Port of `wedetect_tpu/eval/quant_gate.py`. Weight-only int4
(`models/quant`) is lossy, and how much it costs depends on the
checkpoint. Given a model (random weights in the tests, a converted
checkpoint in deployment) and a quantized decode tree, the gate measures
what decides whether quantized decode is safe to enable:

1. **first-step logit cosine**: the direction of the next-token logits
   right after the prefill, per prompt;
2. **greedy-token agreement**: how many of the quantized decode's greedy
   tokens match the full-precision stream, per prompt;
3. **REC score delta**: grounding scores with the text layers' kernels
   replaced by their dequantized codes against the originals (scoring
   never reads the decode tree, so this isolates the weights' damage on
   the grounding head): max / mean |delta sigmoid| and top-1 agreement.

Driven by cli/quant_gate.py; the calibrated int4 fit
(`models/quant_calib`) plugs in through the tree it is given. The
prefill runs on the model's device (K2 and K3 on the card).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from wedetect_tpu_torch.models import quant
from wedetect_tpu_torch.models.quant import (_LAYER_MATMULS,
                                             dequantize_decode_params,
                                             quantized_bytes)


_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")


def _layer_linears(layer):
    """A TextLayer's seven projections by their decode-tree names."""
    return {k: getattr(layer.self_attn if k in _ATTN else layer.mlp, k)
            for k in _LAYER_MATMULS}


@contextlib.contextmanager
def substitute_text_kernels(model, qparams):
    """Within the block, every text-layer matmul weight of `model` is
    replaced by its dequantized codes from `qparams` (cast to the
    weight's dtype): what scoring sees if the quantized weights were the
    model. The originals are restored on exit."""
    deq = dequantize_decode_params(qparams)["text"]
    saved = []
    try:
        for i, layer in enumerate(model.model.language_model.layers):
            for k, lin in _layer_linears(layer).items():
                w = lin.weight
                saved.append((lin, w.data))
                w.data = deq[f"layer{i}"][k]["weight"].to(w.device, w.dtype)
        yield model
    finally:
        for lin, data in saved:
            lin.weight.data = data


def _t(x, dev):
    return torch.as_tensor(np.asarray(x), device=dev)


@torch.inference_mode()
def first_logit_cosines(cfg, grid_h, grid_w, model, qparams, patches,
                        input_ids, attn_mask, position_ids, visual_start,
                        boxes_xyxy, ori_wh):
    """Per-row cosine between the full-precision and quantized LM-head
    logits at each prompt's last real position (float64 on the host)."""
    from wedetect_tpu_torch.models.ref_generate import _lm_logits

    dev = model.device
    b = np.asarray(input_ids).shape[0]
    hidden = model.hidden_states(
        patches, _t(input_ids, dev), _t(attn_mask, dev),
        _t(position_ids, dev), boxes_xyxy, ori_wh, visual_start,
        torch.full((b, 1), -1, dtype=torch.int32, device=dev),
        grid_h=grid_h, grid_w=grid_w)
    full = quant.decode_params(model)
    last = np.asarray(attn_mask).sum(axis=1) - 1
    cosines = []
    for r in range(b):
        h = hidden[r, int(last[r])]
        lf = _lm_logits(full, h).double().cpu().numpy()
        lq = _lm_logits(qparams, h).double().cpu().numpy()
        cosines.append(float(
            np.dot(lf, lq)
            / max(np.linalg.norm(lf) * np.linalg.norm(lq), 1e-30)))
    return np.array(cosines)


def greedy_agreement(cfg, grid_h, grid_w, model, qparams, patches,
                     input_ids, attn_mask, position_ids, visual_start,
                     next_pos, boxes_xyxy, ori_wh, max_new: int,
                     eos_id: int, pad_id: int = 0):
    """Greedy decode with and without the quantized tree; returns
    (agree_len (B,), eff_len (B,)): the leading-match length against the
    full-precision stream and that stream's effective length (through
    eos, else max_new)."""
    from wedetect_tpu_torch.models.ref_generate import ref_generate

    args = (cfg, grid_h, grid_w, model, patches, input_ids, attn_mask,
            position_ids, visual_start, next_pos, boxes_xyxy, ori_wh,
            max_new, eos_id, 0.0, pad_id)
    full = ref_generate(*args).cpu().numpy()
    quantd = ref_generate(*args, decode_params=qparams).cpu().numpy()
    b = full.shape[0]
    agree = np.empty(b, np.int64)
    eff = np.empty(b, np.int64)
    for r in range(b):
        eos_at = np.nonzero(full[r] == eos_id)[0]
        eff[r] = int(eos_at[0]) + 1 if len(eos_at) else max_new
        neq = np.nonzero(full[r, :eff[r]] != quantd[r, :eff[r]])[0]
        agree[r] = int(neq[0]) if len(neq) else eff[r]
    return agree, eff


def rec_score_delta(cfg, grid_h, grid_w, model, qparams, patches,
                    input_ids, attn_mask, position_ids, visual_start,
                    boxes_xyxy, ori_wh, object_positions):
    """REC scoring with the original and the substituted (dequantized)
    text kernels: dict(max_abs_delta, mean_abs_delta, top1_agree) over
    sigmoid scores and each row's argmax proposal."""
    from wedetect_tpu_torch.models.ref import ref_score_step

    def run():
        logits = ref_score_step(
            model, grid_h, grid_w, patches, input_ids, attn_mask,
            position_ids, visual_start, boxes_xyxy, ori_wh,
            _t(object_positions, model.device))
        return 1.0 / (1.0 + np.exp(-logits.float().cpu().numpy()))

    sf = run()
    with substitute_text_kernels(model, qparams):
        sq = run()
    return {
        "max_abs_delta": float(np.abs(sf - sq).max()),
        "mean_abs_delta": float(np.abs(sf - sq).mean()),
        "top1_agree": float(
            (sf.argmax(axis=1) == sq.argmax(axis=1)).mean()),
    }


def gate_report(cfg, grid_h, grid_w, model, qparams, gen_batch, rec_batch,
                max_new: int, eos_id: int, pad_id: int = 0):
    """Run the three probes and assemble the gate's JSON-ready dict.

    gen_batch: (patches, input_ids, attn_mask, position_ids,
    visual_start, next_pos, boxes_xyxy, ori_wh); rec_batch: the same
    without next_pos and with object_positions last, or None to skip the
    REC probe."""
    (patches, ids, mask, pos, vs, next_pos, boxes, ori) = gen_batch
    cos = first_logit_cosines(cfg, grid_h, grid_w, model, qparams, patches,
                              ids, mask, pos, vs, boxes, ori)
    agree, eff = greedy_agreement(
        cfg, grid_h, grid_w, model, qparams, patches, ids, mask, pos, vs,
        next_pos, boxes, ori, max_new, eos_id, pad_id)
    frac = agree / np.maximum(eff, 1)
    report = {
        "logit_cos_mean": float(cos.mean()),
        "logit_cos_min": float(cos.min()),
        "greedy_agree_tokens_mean": float(agree.mean()),
        "greedy_agree_frac_mean": float(frac.mean()),
        "greedy_agree_frac_min": float(frac.min()),
        "eff_len_mean": float(eff.mean()),
        "n_prompts": int(len(cos)),
        "quantized_bytes": int(quantized_bytes(
            {"text": qparams["text"], "lm_head": qparams["lm_head"]})),
    }
    if rec_batch is not None:
        (rpatches, rids, rmask, rpos, rvs, rboxes, rori, robj) = rec_batch
        report["rec"] = rec_score_delta(
            cfg, grid_h, grid_w, model, qparams, rpatches, rids, rmask,
            rpos, rvs, rboxes, rori, robj)
    return report
