"""Calibration statistics for the weight-only int4 decode fit.

Port of `wedetect_tpu/models/quant_calib.py`. `models/quant`'s
activation-weighted int4 fit needs, for every quantized matmul, the RMS
of that matmul's input activation per contraction channel. They are
collected by replaying the text decoder over real prompts layer by
layer, the same sequence-wide math as `nn/qwen3vl.TextLayer` (and the
twin of `models/ref_generate._decode_layer`), with a masked per-channel
sum of squares taken at each of the seven matmul inputs and at the LM
head:

- q/k/v_proj read the input_ln output,
- o_proj the attention output,
- gate/up_proj the post_ln output,
- down_proj `silu(gate) * up`,
- lm_head the final normed hidden states.

The prefill's hidden states stand in for the decode-time single-token
ones (same trunk, same layers). The assembly ahead of the decoder
(`_calib_assembly`) is the model's own: the vision tower (K3 on the
card) and the object scatter. The replay's attention is the grouped
einsum (`impl="einsum"`), as in JAX. It computes in the model's dtype;
the sums leave the card as float64 and are accumulated on the host over
any number of batches, then finalized to sqrt(sum / tokens).

On a tensor-parallel model (models/ref.RefModules(tp=...)) every rank of
the group replays its own heads and ffn channels, sums o_proj and
down_proj over the group, and gathers the sums of squares of those two
inputs (its slice of their channels) to the whole width, so each rank
holds the whole-width statistics that quantize_decode_params(calib=)
reads on a tensor-parallel model.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wedetect_tpu_torch.models.ref_generate import _rms
from wedetect_tpu_torch.nn.qwen3vl import (_apply_rope,
                                           interleaved_mrope_cos_sin,
                                           tp_text_cfg)
from wedetect_tpu_torch.ops.attention import gqa_attention
from wedetect_tpu_torch.parallel import mesh as pmesh


def _calib_assembly(model, grid_h: int, grid_w: int, patches, input_ids,
                    boxes_xyxy, ori_wh, visual_start: int,
                    object_positions):
    """The grounding prefill's embedding assembly (vision tower, image
    tokens, object scatter), stopping before the decoder so that the
    collector can replay its layers with taps. Returns (inputs_embeds
    (B, P, D), the deepstack taps)."""
    from wedetect_tpu_torch.models.ref import _t

    img_tokens, obj, taps = model._vision_and_objects(
        patches, boxes_xyxy, ori_wh, grid_h, grid_w)
    x = model._put_span(model._embed(input_ids), img_tokens, visual_start)
    x = model._scatter_objects(x, obj, _t(object_positions, model.device))
    return x, list(taps)


@torch.inference_mode()
def collect_batch(cfg, grid_h: int, grid_w: int, model, patches, input_ids,
                  attn_mask, position_ids, visual_start: int, boxes_xyxy,
                  ori_wh, object_positions=None) -> Tuple[Dict, float]:
    """One calibration batch -> (per-matmul sums of squares, token count).

    Arguments mirror models/ref_generate.ref_generate's prefill
    (right-padded (B, P) prompts over one shared image); pad positions
    are masked out. Returns ({"text": {"layer{i}": {matmul: ss (H,)}},
    "lm_head": ss}, count), the sums as float64 numpy arrays."""
    from wedetect_tpu_torch.models.ref import _t

    tp = getattr(model, "tp", None)
    c = tp_text_cfg(cfg.text, pmesh.tp_size(tp))
    dev = model.device
    input_ids = _t(input_ids, dev)
    b, p_len = input_ids.shape
    if object_positions is None:
        object_positions = torch.full((b, 1), -1, dtype=torch.int32,
                                      device=dev)
    x, taps = _calib_assembly(model, grid_h, grid_w, patches, input_ids,
                              boxes_xyxy, ori_wh, visual_start,
                              object_positions)
    lm = model.model.language_model
    x = x.to(lm.dtype)
    cos, sin = interleaved_mrope_cos_sin(_t(position_ids, dev), c)
    kv_valid = _t(attn_mask, dev).to(torch.int32)
    valid = kv_valid.float()[..., None]                   # (B, P, 1)
    count = float(valid.sum())

    def ss(y):
        return (y.float().square() * valid).sum(dim=(0, 1))

    def ss_row(y):
        """ss of a row-parallel input: this rank's channels, gathered."""
        return pmesh.gather_vocab(ss(y), tp)

    stats = {}
    for i, layer in enumerate(lm.layers):
        a, m = layer.self_attn, layer.mlp
        ls = {}
        y = _rms(x, layer.input_layernorm.weight, c.rms_eps)
        ls["q_proj"] = ls["k_proj"] = ls["v_proj"] = ss(y)
        q = F.linear(y, a.q_proj.weight)
        k = F.linear(y, a.k_proj.weight)
        v = F.linear(y, a.v_proj.weight)
        q = _rms(q.reshape(b, p_len, c.heads, c.head_dim), a.q_norm.weight,
                 c.rms_eps)
        k = _rms(k.reshape(b, p_len, c.kv_heads, c.head_dim),
                 a.k_norm.weight, c.rms_eps)
        v = v.reshape(b, p_len, c.kv_heads, c.head_dim)
        q, k = _apply_rope(q, k, cos[:, :, None, :], sin[:, :, None, :])
        o = gqa_attention(q, k, v, causal=True, kv_valid=kv_valid,
                          sm_scale=1.0 / math.sqrt(c.head_dim),
                          impl="einsum").reshape(b, p_len, -1).to(x.dtype)
        ls["o_proj"] = ss_row(o)
        x = x + pmesh.row_sum(tp, F.linear(o, a.o_proj.weight))
        y = _rms(x, layer.post_attention_layernorm.weight, c.rms_eps)
        ls["gate_proj"] = ls["up_proj"] = ss(y)
        h = F.silu(F.linear(y, m.gate_proj.weight)) \
            * F.linear(y, m.up_proj.weight)
        ls["down_proj"] = ss_row(h)
        x = x + pmesh.row_sum(tp, F.linear(h, m.down_proj.weight))
        if i < len(taps):                               # deepstack taps
            x = lm._inject_deepstack(x, taps[i], visual_start)
        stats[f"layer{i}"] = ls
    hidden = _rms(x, lm.norm.weight, c.rms_eps)
    out = {"text": stats, "lm_head": ss(hidden)}
    return _tree_map(lambda t: t.double().cpu().numpy(), out), count


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def calibrate_decode_acts(cfg, model, batches: Iterable[Dict]) -> Dict:
    """Accumulate collect_batch over calibration batches and finalize to
    the per-matmul activation-RMS tree (float32 numpy) that
    quantize_decode_params(bits=4, calib=...) reads.

    `batches`: dicts with keys grid_h, grid_w, patches, input_ids,
    attn_mask, position_ids, visual_start, boxes_xyxy, ori_wh (and
    optionally object_positions), the ref_generate prefill layout;
    grids may differ from batch to batch."""
    acc, total = None, 0.0
    for bt in batches:
        stats, count = collect_batch(
            cfg, int(bt["grid_h"]), int(bt["grid_w"]), model, bt["patches"],
            bt["input_ids"], bt["attn_mask"], bt["position_ids"],
            int(bt["visual_start"]), bt["boxes_xyxy"], bt["ori_wh"],
            bt.get("object_positions"))
        total += count
        acc = stats if acc is None else _tree_map2(np.add, acc, stats)
    assert acc is not None and total > 0, "no calibration tokens"
    return _tree_map(lambda a: np.sqrt(a / total).astype(np.float32), acc)


def _tree_map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)
