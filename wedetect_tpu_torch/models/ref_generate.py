"""Autoregressive text generation for WeDetect-Ref (chat, captioning).

Port of `wedetect_tpu/models/ref_generate.py` (reference
wedetect_ref/models/qwen3vl_grounding.py:311-379: the stage-1/2 twin
inherits HF `.generate()`). One call: a batched prefill through the
grounding trunk (`_prefill_hidden_kvs`: vision tower, object features,
`TextModel.prefix_pass(return_hidden=True)`; K3 in every ViT block and
K2 in every decoder layer on the card), then greedy or temperature
decode over a preallocated KV cache of (B, P + max_new, KVH, HD) per
layer, written in place. Rows are right-padded prompts decoded in
lockstep: the attention mask and the shared write column keep them
apart.

The single-token decode layer (`_decode_layer`) reads the decode-param
tree of `models/quant` (full precision, int8 or int4) and attends with
the grouped einsum (`impl="einsum"`), as the JAX package does: no
Pallas kernel lies on the decode step, and K2 does not take S = 1.
Sampling draws from `ops/prng`, so a seed gives JAX's stream: the key
chain of `jax.random.split` from `PRNGKey(seed)`.

The loop stops once every row has emitted eos: the remaining columns
are pad, as the JAX scan would emit them. `ref_generate_multi` takes
prompts holding several images (`_prefill_hidden_kvs_multi`: the
model's multi-image assembly, each image's ViT at its own grid) onto
the same decode. Not ported yet: video prompts (`grid_t > 1`).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from wedetect_tpu_torch.models import quant
from wedetect_tpu_torch.models.quant import matmul_any, prepare_decode_params
from wedetect_tpu_torch.nn.qwen3vl import (RefTextCfg, _apply_rope,
                                           interleaved_mrope_cos_sin)
from wedetect_tpu_torch.ops import prng
from wedetect_tpu_torch.ops.attention import gqa_attention

# how often (in steps) the decode loop reads back whether every row is done
DONE_CHECK_EVERY = 8


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _lm_logits(dp: Dict, hidden: torch.Tensor) -> torch.Tensor:
    """f32 LM logits: the decode tree's `lm_head` leaf (untied, or a
    quantized copy of the tied table) when present, else the tied input
    embedding."""
    h = hidden.float()
    if "lm_head" in dp:
        return matmul_any(h, dp["lm_head"], torch.float32)
    return h @ dp["embed"].float().T


def _qkv(p, c: RefTextCfg, x, cos, sin):
    """The layer's pre-attention half on (B, S, D) rows: the normed,
    roped q (B, S, H, HD) and k, and v (B, S, KVH, HD)."""
    b, s = x.shape[:2]
    eps, dt = c.rms_eps, x.dtype
    y = _rms(x, p["input_ln"], eps)
    q = matmul_any(y, p["q_proj"], dt)
    k = matmul_any(y, p["k_proj"], dt)
    v = matmul_any(y, p["v_proj"], dt)
    q = _rms(q.reshape(b, s, c.heads, c.head_dim), p["q_norm"], eps)
    k = _rms(k.reshape(b, s, c.kv_heads, c.head_dim), p["k_norm"], eps)
    v = v.reshape(b, s, c.kv_heads, c.head_dim)
    q, k = _apply_rope(q, k, cos[:, :, None, :], sin[:, :, None, :])
    return q, k, v


def _out_mlp(p, c: RefTextCfg, x, o):
    """The layer's post-attention half: o_proj residual, then the MLP."""
    dt = x.dtype
    x = x + matmul_any(o.to(dt).reshape(x.shape[0], x.shape[1], -1),
                       p["o_proj"], dt)
    y = _rms(x, p["post_ln"], c.rms_eps)
    gate = matmul_any(y, p["gate_proj"], dt)
    up = matmul_any(y, p["up_proj"], dt)
    return x + matmul_any(F.silu(gate) * up, p["down_proj"], dt)


def _decode_layer(p, c: RefTextCfg, x, cos, sin, cache_k, cache_v,
                  write_at: int, kv_valid):
    """One decoder layer for a single-token step. x (B, 1, D); cache_k/v
    (B, C, KVH, HD), this step's post-rope KV written in place at column
    `write_at` (the same for every row); the query attends the whole
    cache under kv_valid (B, C). Returns the new x."""
    q, k, v = _qkv(p, c, x, cos, sin)
    cache_k[:, write_at] = k[:, 0].to(cache_k.dtype)
    cache_v[:, write_at] = v[:, 0].to(cache_v.dtype)
    o = gqa_attention(q, cache_k, cache_v, causal=False, kv_valid=kv_valid,
                      sm_scale=1.0 / math.sqrt(c.head_dim), impl="einsum")
    return _out_mlp(p, c, x, o)


def _sample(logits: torch.Tensor, temperature: float, key) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return prng.categorical(key, logits / temperature)


def _prefill_hidden_kvs(model, grid_h: int, grid_w: int, patches, input_ids,
                        attn_mask, position_ids, boxes_xyxy, ori_wh,
                        visual_start: int, object_positions):
    """The grounding prefill: the model's vision and RoI assembly, then
    prefix_pass(return_hidden=True) -> (the final normed hidden states
    (B, P, D), the per-layer post-rope KV, each (B, P, KVH, HD)). The
    one-image call of _prefill_hidden_kvs_multi."""
    return _prefill_hidden_kvs_multi(
        model, (patches,), ((grid_h, grid_w),), input_ids, attn_mask,
        position_ids, (boxes_xyxy,), (ori_wh,), (visual_start,),
        object_positions)


def _prefill_hidden_kvs_multi(model, patches_list, grids, input_ids,
                              attn_mask, position_ids, boxes_list,
                              ori_wh_list, visual_starts, object_positions):
    """_prefill_hidden_kvs of prompts holding several images: the
    model's multi-image assembly (RefModules._assemble, each
    image's ViT at its own grid), then prefix_pass(return_hidden=True)."""
    from wedetect_tpu_torch.models.ref import _t

    dev = model.device
    x, ds, _ = model._assemble(patches_list, grids, input_ids, boxes_list,
                               ori_wh_list, visual_starts, object_positions)
    kvs, hidden = model.model.language_model.prefix_pass(
        x, _t(position_ids, dev), _t(attn_mask, dev), deepstack_embeds=ds,
        visual_start=tuple(visual_starts), return_hidden=True,
        attn_impl=model.attn_impl)
    return hidden, kvs


def _gather_last(hidden: torch.Tensor, attn_mask: torch.Tensor):
    """Each row's hidden state at its last real prompt position."""
    last = attn_mask.sum(dim=1).long() - 1
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]


def _new_caches(kvs, extra: int) -> List:
    """(B, P + extra, KVH, HD) caches holding each layer's prompt KV."""
    out = []
    for k, v in kvs:
        pad = (0, 0, 0, 0, 0, extra)
        out.append((F.pad(k, pad), F.pad(v, pad)))
    return out


@torch.inference_mode()
def ref_generate(cfg, grid_h: int, grid_w: int, model, patches, input_ids,
                 attn_mask, position_ids, visual_start: int, next_pos,
                 boxes_xyxy, ori_wh, max_new_tokens: int, eos_id: int,
                 temperature: float = 0.0, pad_id: int = 0,
                 object_positions=None, rng=None, decode_params=None,
                 grid_t: int = 1) -> torch.Tensor:
    """Greedy or temperature generation from image-bearing prompts.

    patches: one shared image (patches or uint8 pixels); input_ids /
    attn_mask (B, P) right-padded prompts; position_ids (3, B, P);
    next_pos (B,) each row's first generated position; boxes_xyxy (N, 4)
    with object_positions (B, N) thread <object> features into the
    prompt (None: caption-only, a dummy box). rng: an `ops/prng` key
    (default PRNGKey(0)). decode_params: the tree the decode layers and
    the LM head read (default the model's own weights; pass
    models/quant.quantize_decode_params(model) for weight-only int8 or
    int4 decode; the prefill stays full precision). Returns
    (B, max_new_tokens) int32 tokens: eos is emitted, later positions
    hold pad_id. The compute dtype is the model's (models/ref.
    cast_ref_model)."""
    if grid_t > 1:
        raise NotImplementedError(
            "video prompts (grid_t > 1): not ported yet")
    return ref_generate_multi(
        cfg, ((grid_h, grid_w),), model, (patches,), input_ids, attn_mask,
        position_ids, (boxes_xyxy,), (ori_wh,), (visual_start,), next_pos,
        max_new_tokens, eos_id, temperature, pad_id, object_positions, rng,
        decode_params)


@torch.inference_mode()
def ref_generate_multi(cfg, grids, model, patches_list, input_ids, attn_mask,
                       position_ids, boxes_list, ori_wh_list, visual_starts,
                       next_pos, max_new_tokens: int, eos_id: int,
                       temperature: float = 0.0, pad_id: int = 0,
                       object_positions=None, rng=None,
                       decode_params=None) -> torch.Tensor:
    """ref_generate for prompts holding several images: grids each
    image's unmerged (gh, gw), visual_starts each span's offset, as in
    models/ref.ref_score_step_multi; boxes_list entries may be None;
    object_positions None for caption-only prompts; decode_params as in
    ref_generate. Returns (B, max_new_tokens) int32 tokens."""
    from wedetect_tpu_torch.models.ref import _t

    dev = model.device
    input_ids = _t(input_ids, dev)
    attn_mask = _t(attn_mask, dev)
    b = input_ids.shape[0]
    if object_positions is None:
        object_positions = torch.full((b, 1), -1, dtype=torch.int32,
                                      device=dev)
    if rng is None:
        rng = prng.PRNGKey(0, device=dev)
    hidden, kvs = _prefill_hidden_kvs_multi(
        model, patches_list, grids, input_ids, attn_mask, position_ids,
        boxes_list, ori_wh_list, visual_starts, object_positions)
    dp = (decode_params if decode_params is not None
          else quant.decode_params(model))
    return _decode_from_prefill(cfg.text, dp, hidden, kvs, attn_mask,
                                _t(next_pos, dev), max_new_tokens, eos_id,
                                temperature, pad_id, rng.to(dev))


def _decode_from_prefill(c: RefTextCfg, dp, hidden, kvs, attn_mask,
                         next_pos, max_new: int, eos_id: int,
                         temperature: float, pad_id: int, rng):
    """Sample the first token at each row's last real prompt position,
    then single-token steps over the preallocated cache."""
    dp = prepare_decode_params(dp)
    dev = hidden.device
    b, p_len = attn_mask.shape
    dtype = hidden.dtype
    sampled = temperature != 0.0        # greedy draws no random bits
    if sampled:
        rng, r0 = prng.split(rng)
    tok = _sample(_lm_logits(dp, _gather_last(hidden, attn_mask)),
                  temperature, r0 if sampled else None)
    caches = _new_caches(kvs, max_new)
    tp, emb = dp["text"], dp["embed"]
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    gen_valid = torch.zeros((b, max_new), dtype=torch.int32, device=dev)
    kv_valid = torch.cat([attn_mask.to(torch.int32), gen_valid], dim=1)
    out = torch.full((b, max_new), pad_id, dtype=torch.int32, device=dev)
    for t in range(max_new):
        out[:, t] = torch.where(done, pad_id, tok)
        done = done | (tok == eos_id)
        if t % DONE_CHECK_EVERY == DONE_CHECK_EVERY - 1 and bool(done.all()):
            break           # every later column is pad
        x = emb[tok][:, None, :].to(dtype)
        pos3 = (next_pos + t).reshape(1, b, 1).expand(3, b, 1)
        cos, sin = interleaved_mrope_cos_sin(pos3, c)
        kv_valid[:, p_len + t] = 1
        for i in range(c.layers):
            kc, vc = caches[i]
            x = _decode_layer(tp[f"layer{i}"], c, x, cos, sin, kc, vc,
                              p_len + t, kv_valid)
        h = _rms(x, tp["norm"], c.rms_eps)[:, 0]
        if sampled:
            rng, r = prng.split(rng)
        nxt = _sample(_lm_logits(dp, h), temperature, r if sampled else None)
        tok = torch.where(done, tok, nxt)       # frozen rows stay put
    return out
