"""Draft-free speculative decoding (prompt lookup) for WeDetect-Ref.

Port of `wedetect_tpu/models/ref_speculative.py`. A decode step reads
every decoder weight for a few token rows; a verify step over K
candidate tokens reads the same bytes, so each accepted draft token
saves a step. Drafts come from prompt lookup: the most recent earlier
occurrence of the last `ngram` tokens in prompt + history proposes the
tokens that followed it. No draft model.

Greedy only, and exact: a drafted token is accepted only where it
equals the verify forward's own argmax, and the first mismatch emits
that argmax instead, so the tokens are `ref_generate`'s greedy ones.
The verify layer attends with the grouped einsum under a per-query
mask; no Pallas kernel lies on it. The prefill is `ref_generate`'s
(K3 and K2 on the card). The loop runs on the host and reads back once
a step whether every row is done.

On a tensor-parallel model (models/ref.RefModules(tp=...)) each rank
runs its own heads on its kv-head caches, sums the row-parallel products
over the group, and gathers the verify rows' logits over the vocabulary
(`models/ref_generate._lm_logits`): every rank drafts, accepts and
stops on the same tokens, so the ranks stay in lockstep. A quantized
tree is the model's own (`models/quant.quantize_decode_params(model)`).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from wedetect_tpu_torch.models import quant
from wedetect_tpu_torch.models.quant import prepare_decode_params
from wedetect_tpu_torch.models.ref_generate import (_embed_rows, _gather_last,
                                                    _lm_logits, _new_caches,
                                                    _out_mlp,
                                                    _prefill_hidden_kvs, _qkv,
                                                    _rms, local_text_cfg)
from wedetect_tpu_torch.nn.qwen3vl import RefTextCfg, interleaved_mrope_cos_sin


def _spec_attention(q, k, v, mask, sm_scale: float):
    """Einsum attention with a per-query-row mask (B, K, C): KV heads
    repeated, f32 logits, -1e9 bias, softmax cast back to q's dtype (the
    numerics of the single-token decode)."""
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    logits = logits + torch.where(mask, 0.0, -1e9)[:, None]
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _decode_layer_block(p: Dict, c: RefTextCfg, x, cos, sin, cache_k,
                        cache_v, write_at, mask, tp=None):
    """One decoder layer over a K-token verify block. x (B, K, D); the
    block's post-rope KV written in place at the per-row columns
    write_at (B, K); each query attends the cache under mask (B, K, C);
    the row-parallel products summed over the tensor-parallel group
    `tp` (c then holds the rank's widths)."""
    q, k, v = _qkv(p, c, x, cos, sin)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    cache_k[rows, write_at] = k.to(cache_k.dtype)
    cache_v[rows, write_at] = v.to(cache_v.dtype)
    o = _spec_attention(q, cache_k, cache_v, mask,
                        1.0 / math.sqrt(c.head_dim))
    return _out_mlp(p, c, x, o, tp)


def draft_lookup(hist, prev_gram, valid, spec_k: int):
    """The most recent position where the n-gram prev_gram (B, n) occurs
    in hist (B, Lh) over valid (B, Lh) slots whose continuation start is
    valid too; returns the spec_k - 1 tokens that followed it
    (B, spec_k - 1; clipped to the buffer, rejected at verification when
    past the valid region) and a found flag (B,)."""
    b, lh = hist.shape
    n = prev_gram.shape[1]
    valid = valid.to(torch.bool)
    ok = torch.ones((b, lh - n), dtype=torch.bool, device=hist.device)
    for j in range(n):
        ok = ok & (hist[:, j:j + lh - n] == prev_gram[:, j:j + 1])
        ok = ok & valid[:, j:j + lh - n]
    ok = ok & valid[:, n:n + lh - n]
    found = ok.any(dim=1)
    i = torch.arange(lh - n, device=hist.device)
    best = torch.where(ok, i[None], -1).amax(dim=1)          # last match
    gidx = (best + n)[:, None] + torch.arange(spec_k - 1,
                                              device=hist.device)[None]
    draft = torch.gather(hist, 1, gidx.clamp(0, lh - 1))
    return draft, found


@torch.inference_mode()
def ref_generate_spec(cfg, grid_h: int, grid_w: int, model, patches,
                      input_ids, attn_mask, position_ids, visual_start: int,
                      next_pos, boxes_xyxy, ori_wh, max_new_tokens: int,
                      eos_id: int, pad_id: int = 0, object_positions=None,
                      decode_params=None, spec_k: int = 8, ngram: int = 2,
                      force_reject: bool = False):
    """Greedy generation with prompt-lookup speculative decoding; the
    arguments of ref_generate minus temperature. Returns (tokens
    (B, max_new), steps): steps is the number of verify forwards, fewer
    than max_new when drafts were accepted. force_reject discards every
    draft (each verify emits one token); the tokens stay greedy."""
    from wedetect_tpu_torch.models.ref import _t

    dev = model.device
    if decode_params is not None:
        quant.check_decode_tree(decode_params, getattr(model, "tp", None))
    input_ids = _t(input_ids, dev)
    attn_mask = _t(attn_mask, dev)
    b = input_ids.shape[0]
    if object_positions is None:
        object_positions = torch.full((b, 1), -1, dtype=torch.int32,
                                      device=dev)
    hidden, kvs = _prefill_hidden_kvs(
        model, grid_h, grid_w, patches, input_ids, attn_mask, position_ids,
        boxes_xyxy, ori_wh, visual_start, object_positions)
    dp = (decode_params if decode_params is not None
          else quant.decode_params(model))
    return _spec_decode(cfg.text, dp, hidden, kvs, input_ids, attn_mask,
                        _t(next_pos, dev), max_new_tokens, eos_id, pad_id,
                        spec_k, ngram, force_reject)


def _spec_decode(c: RefTextCfg, dp, hidden, kvs, input_ids, attn_mask,
                 next_pos, max_new: int, eos_id: int, pad_id: int,
                 spec_k: int, ngram: int, force_reject: bool = False):
    dev = hidden.device
    dtype = hidden.dtype
    b, p_len = attn_mask.shape
    kk = spec_k
    cap = max_new + kk            # generated-KV slots (a block may overhang)
    prompt_len = attn_mask.sum(dim=1).long()
    input_ids = input_ids.long()
    cur = torch.argmax(_lm_logits(dp, _gather_last(hidden, attn_mask)),
                       dim=-1)
    caches = _new_caches(kvs, cap)
    dp = prepare_decode_params(dp)
    c, tp = local_text_cfg(c, dp), dp.get("tp")
    layers = dp["text"]
    # one sink column past max_new takes the writes the JAX scatter drops
    out = torch.full((b, max_new + 1), pad_id, dtype=torch.long, device=dev)
    jk = torch.arange(kk, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    lh = p_len + max_new
    pos_h = torch.arange(lh, device=dev)
    m = torch.zeros(b, dtype=torch.long, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    pmask = attn_mask.to(torch.bool)[:, None, :].expand(b, kk, p_len)
    t = 0
    while t < max_new and not bool(done.all()):
        # draft: the n-gram continuation from [prompt, generated]
        hist = torch.cat([input_ids, out[:, :max_new]], dim=1)
        valid = ((pos_h[None] < prompt_len[:, None])
                 | ((pos_h[None] >= p_len)
                    & (pos_h[None] < p_len + m[:, None])))
        gram = [cur]
        for j in range(1, ngram):
            # j-th token back: out[m - j], or the prompt tail when fewer
            # than j tokens were generated
            from_gen = torch.gather(out, 1, (m - j).clamp(0, max_new - 1)
                                    [:, None])[:, 0]
            from_pr = torch.gather(
                input_ids, 1,
                (prompt_len - (j - m)).clamp(0, p_len - 1)[:, None])[:, 0]
            gram.append(torch.where(m >= j, from_gen, from_pr))
        prev_gram = torch.stack(gram[::-1], dim=1)
        draft, found = draft_lookup(hist, prev_gram, valid, kk)
        draft = torch.where(found[:, None], draft, pad_id)
        block = torch.cat([cur[:, None], draft], dim=1)        # (B, K)

        # verify forward over the K-token block
        x = _embed_rows(dp, block).to(dtype)
        posk = (next_pos + m)[:, None] + jk[None]
        cos, sin = interleaved_mrope_cos_sin(posk[None].expand(3, b, kk), c)
        gen_ok = (torch.arange(cap, device=dev)[None, None, :]
                  < (m[:, None] + jk[None] + 1)[:, :, None])
        mask = torch.cat([pmask, gen_ok], dim=2)
        write_at = p_len + m[:, None] + jk[None]
        for i in range(c.layers):
            kc, vc = caches[i]
            x = _decode_layer_block(layers[f"layer{i}"], c, x, cos, sin, kc,
                                    vc, write_at, mask, tp)
        h = _rms(x, layers["norm"], c.rms_eps)
        g = torch.argmax(_lm_logits(dp, h), dim=-1)            # (B, K)

        # accept the longest draft prefix that matches the argmax
        matches = (block[:, 1:] == g[:, :-1]).long()
        if force_reject:
            matches = torch.zeros_like(matches)
        cnt = torch.cumprod(matches, dim=1).sum(dim=1) + 1
        iseos = (block == eos_id) & (jk[None] < cnt[:, None])
        has_eos = iseos.any(dim=1)
        cnt = torch.where(has_eos, iseos.long().argmax(dim=1) + 1, cnt)
        cnt = torch.minimum(cnt, max_new - m)
        cnt = torch.where(done, 0, cnt)
        widx = torch.where(jk[None] < cnt[:, None], m[:, None] + jk[None],
                           max_new)
        out[rows, widx] = block
        cur_new = torch.gather(g, 1, (cnt - 1).clamp(0, kk - 1)[:, None])[:, 0]
        cur = torch.where(cnt > 0, cur_new, cur)
        m = m + cnt
        done = done | has_eos | (m >= max_new)
        t += 1
    return out[:, :max_new].to(torch.int32), t
