"""Continuous-batching generation engine for WeDetect-Ref serving.

Port of `wedetect_tpu/models/serve.py`. A fixed pool of decode slots
shares one preallocated KV cache; each finished row is refilled with
the next queued request while the other rows keep decoding (the
reference's stage-1/2 twin inherits HF `.generate()`, one static batch
to completion: wedetect_ref/models/qwen3vl_grounding.py:311-379).

- `_admit`: one request's prefill (the grounding trunk of
  `models/ref_generate`: K3 in every ViT block, K2 in every decoder
  layer on the card, over the padded prompt bucket), its post-rope KV
  written into one slot's rows of the (slots, P + G, KVH, HD) pool;
  `_admit_many` runs a wave of requests through one batched decoder
  pass (K2 once a layer for the wave, K3 once a block a request).
- `_decode_chunk`: T single-token steps for every slot in lockstep,
  each row at its own depth (its own write column P + gen_count[row]
  and validity row), so fresh rows decode beside deep ones.
- `kv_bits=8`: the pool as int8 codes plus one f32 absmax scale a
  written (token, kv-head) vector, ~0.52x the bf16 pool; the decode
  attention folds the scales exactly (`_gqa_int8kv`).
- `piggyback=True`: a steady-state admission's decoder prefill rides
  the decode chunk, F = ceil(P / T) prompt rows a step sharing the
  decode step's matmuls (`_decode_chunk_pb`); the vision half runs
  once a request (`_encode_prompt`).

Sampling: greedy by default; `temperature > 0` samples (top-k, then
top-p) with per-request streams: token i of a request with seed s is
categorical(fold_in(PRNGKey(s), i), warp(logits) / T) through
`ops/prng`, the JAX package's stream, so the slot, the chunk size, the
admission order and the batch never change a request's tokens.

The pool is allocated once and written in place; no chunk copies it.
Where the JAX package lets a scatter drop an out-of-bounds index (the
padding lanes of an admission wave, the prompt rows past P, an idle
piggyback dispatch at slot == slots), the port selects the valid lanes
and columns on the host, where they are known. `run(pipeline=True)`
overlaps a chunk's token readback (a non-blocking copy into pinned
memory and a CUDA event) with the next chunk. The decode and the
piggybacked prompt rows attend with plain einsums, as the JAX package's
do (`impl="einsum"`, serve.py:244-247, :507-529): no Pallas kernel lies
on them.

Tensor-parallel serving (`GenServer(mesh=)`, a model built on the mesh's
tp group: models/ref.tp_ref_model or init_ref_variables(mesh=)): every
rank of the group runs this engine on its own slices, the KV pool (codes
and scales for kv_bits=8) on its kv heads, as the JAX package pins the
pool sharded over the kv-head axis. The decode tree carries the group
(models/ref_generate): each layer sums its row-parallel products over
it, and the sampler reads the gathered logits, so every rank draws the
same tokens. Every rank submits the same requests in one order and runs
the same host scheduler on them; as each reads back the same tokens,
their admissions and slots stay in lockstep, and no rank decides alone.
An int8 / int4 tree of the TP model (`decode_params=quantize_decode_
params(model)`: the rank's slices of the codes) decodes alike, with
`kv_bits=8` and `batch_admit`, and with piggyback where the one-process
engine takes it (full-precision caches); a model with `quant_int8` runs
its admissions' prefill in int8 (`parallel/mesh.row_linear`).
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from wedetect_tpu_torch.models import quant
from wedetect_tpu_torch.models.quant import prepare_decode_params
from wedetect_tpu_torch.models.ref_generate import (_embed_rows, _lm_logits,
                                                    _out_mlp,
                                                    _prefill_hidden_kvs, _qkv,
                                                    _rms, local_text_cfg)
from wedetect_tpu_torch.nn.qwen3vl import (RefTextCfg,
                                           interleaved_mrope_cos_sin,
                                           tp_text_cfg)
from wedetect_tpu_torch.ops import prng
from wedetect_tpu_torch.ops.attention import gqa_attention
from wedetect_tpu_torch.ops.int8 import true_div


@dataclasses.dataclass
class EngineState:
    """The engine's device state, updated in place by every program.

    caches: a (k, v) pair a layer, each (slots, P + G, KVH, HD) in the
    compute dtype or the int8 {"q8", "s"} pair; prompt_mask (slots, P)
    int32; per slot (int32 unless noted): gen_count (tokens generated so
    far), next_pos (next MRoPE position), cur_tok (the next token to feed,
    already sampled), done (bool: eos, cap reached, or an empty slot),
    seeds (the request's sampling seed), caps (its generation cap <= G)."""
    caches: List
    prompt_mask: torch.Tensor
    gen_count: torch.Tensor
    next_pos: torch.Tensor
    cur_tok: torch.Tensor
    done: torch.Tensor
    seeds: torch.Tensor
    caps: torch.Tensor
    dtype: torch.dtype

    @property
    def g_cap(self) -> int:
        k = self.caches[0][0]
        return (k["q8"] if isinstance(k, dict) else k).shape[1] \
            - self.prompt_mask.shape[1]


def _sample_rows(logits, sampling, seeds, idx) -> torch.Tensor:
    """Per-row sampling with scheduling-invariant streams: token idx[r]
    of the request with seed seeds[r] is
    categorical(fold_in(PRNGKey(seed), idx), warp(logits) / T).
    sampling = (temperature, top_k, top_p): temperature 0 is the argmax;
    top_k > 0 keeps the logits at or above the k-th value; top_p < 1
    keeps the smallest descending prefix of mass >= top_p (at least one
    token; ties at the cut all kept). top-k applies before top-p."""
    temperature, top_k, top_p = sampling
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    lg = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, -torch.inf, lg)
    if top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        p = torch.softmax(srt, dim=-1)
        cum_prev = torch.cumsum(p, dim=-1) - p        # mass above rank
        n_keep = (cum_prev < top_p).sum(dim=-1, keepdim=True)   # >= 1
        lg = torch.where(lg < torch.gather(srt, -1, n_keep - 1),
                         -torch.inf, lg)
    keys = prng.fold_in(prng.PRNGKey(seeds), idx)
    return prng.categorical(keys, lg)


def _kv_quant(x: torch.Tensor):
    """Post-rope K or V -> (int8 codes, f32 absmax scale a vector):
    symmetric int8 over the head_dim axis."""
    xf = x.float()
    s = true_div(torch.clamp(xf.abs().amax(dim=-1), min=1e-12), 127.0)
    q8 = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(
        torch.int8)
    return q8, s


def _cache_scatter(cache, rows, cols, kv):
    """Write kv at cache[rows, cols] in place, for both representations
    (the compute-dtype array, or the int8 {"q8", "s"} pair)."""
    if isinstance(cache, dict):
        q8, s = _kv_quant(kv)
        cache["q8"][rows, cols] = q8
        cache["s"][rows, cols] = s.to(cache["s"].dtype)
    else:
        cache[rows, cols] = kv.to(cache.dtype)


def _cache_install(cache, kv, slot: int):
    """Install a (P, KVH, HD) prefill segment at cache[slot, :P]."""
    _cache_scatter(cache, slot, slice(0, kv.shape[0]), kv)


def _gqa_int8kv(q, kc, vc, kv_valid, sm_scale: float):
    """Decode attention over the int8 cache with exact scale folding:
    q . (k8_j s_j) = (q . k8_j) s_j on the logits and
    sum_j p_j (v8_j s_j) = sum_j (p_j s_j) v8_j on the output, so the
    only approximation is the 8-bit code. Grouped KV, f32 softmax, -1e9
    mask bias."""
    b, _, h, d = q.shape
    kvh = kc["q8"].shape[2]
    qg = q[:, 0].reshape(b, kvh, h // kvh, d)
    logits = torch.einsum("bkgd,bckd->bkgc", qg,
                          kc["q8"].to(q.dtype)).float()
    ks = kc["s"].float().permute(0, 2, 1)              # (B, KVH, C)
    logits = logits * ks[:, :, None, :] * sm_scale
    mask = kv_valid.to(torch.bool)[:, None, None, :]
    logits = logits + torch.where(mask, 0.0, -1e9)
    p = torch.softmax(logits, dim=-1)
    vs = vc["s"].float().permute(0, 2, 1)
    p = (p * vs[:, :, None, :]).to(q.dtype)
    o = torch.einsum("bkgc,bckd->bkgd", p, vc["q8"].to(q.dtype))
    return o.reshape(b, 1, h, d)


def _decode_layer_rowwise(p, c: RefTextCfg, x, cos, sin, cache_k, cache_v,
                          write_col, kv_valid, tp=None):
    """One decoder layer, one token a row, each row at its own depth: the
    KV written at cache[row, write_col[row]], attention under the
    per-row kv_valid (B, C); int8 caches fold their scales."""
    q, k, v = _qkv(p, c, x, cos, sin)
    rows = torch.arange(x.shape[0], device=x.device)
    _cache_scatter(cache_k, rows, write_col, k[:, 0])
    _cache_scatter(cache_v, rows, write_col, v[:, 0])
    sm = 1.0 / math.sqrt(c.head_dim)
    if isinstance(cache_k, dict):
        o = _gqa_int8kv(q, cache_k, cache_v, kv_valid, sm)
    else:
        o = gqa_attention(q, cache_k, cache_v, causal=False,
                          kv_valid=kv_valid, sm_scale=sm, impl="einsum")
    return _out_mlp(p, c, x, o, tp)


def _install_slots(state: EngineState, slots, mask, next_pos0, tok0, seeds,
                   caps):
    """Activate slots (an int or an index tensor): prompt mask, counters,
    the parked first token, seed and cap."""
    state.prompt_mask[slots] = mask.to(torch.int32)
    state.gen_count[slots] = 0
    state.next_pos[slots] = next_pos0
    state.cur_tok[slots] = tok0.to(torch.int32)
    state.done[slots] = False
    state.seeds[slots] = seeds
    state.caps[slots] = caps


@torch.inference_mode()
def _admit(model, grid_h: int, grid_w: int, decode_params, state, slot: int,
           patches, input_ids, attn_mask, visual_start: int, position_ids,
           next_pos0: int, boxes_xyxy, ori_wh, object_positions,
           sampling=(0.0, 0, 1.0), seed: int = 0, cap: int = 2**30):
    """Prefill one request and install it into `slot`. input_ids /
    attn_mask (1, P); position_ids (3, 1, P). Its first token is sampled
    here from the decode tree (as ref_generate does) and parked in
    cur_tok; the next chunk emits it."""
    dev = model.device
    hidden, kvs = _prefill_hidden_kvs(
        model, grid_h, grid_w, patches, input_ids, attn_mask, position_ids,
        boxes_xyxy, ori_wh, visual_start, object_positions)
    mask = torch.as_tensor(np.asarray(attn_mask), device=dev).reshape(-1)
    last = int(np.asarray(attn_mask).sum()) - 1
    seeds = torch.tensor([seed], dtype=torch.int32, device=dev)
    tok0 = _sample_rows(_lm_logits(decode_params, hidden[0, last][None]),
                        sampling, seeds, torch.zeros_like(seeds))
    for (kc, vc), (k, v) in zip(state.caches, kvs):
        _cache_install(kc, k[0], slot)
        _cache_install(vc, v[0], slot)
    _install_slots(state, slot, mask, next_pos0, tok0[0], seed, cap)


def _stack_taps(taps_per_lane):
    return [torch.stack(t) for t in zip(*taps_per_lane)]


@torch.inference_mode()
def _admit_many(model, grid_h: int, grid_w: int, decode_params, state,
                slots, patches, input_ids, attn_mask, visual_start: int,
                position_ids, next_pos0, boxes_xyxy, ori_wh, object_positions,
                sampling=(0.0, 0, 1.0), lane_seeds=None, lane_caps=None):
    """Prefill a wave of N requests and install them into `slots` (N,).
    Shapes: patches (N, ...); input_ids / attn_mask (N, P);
    position_ids (3, N, P); next_pos0 (N,); boxes_xyxy (N, Q, 4);
    ori_wh (N, 2); object_positions (N, Q). A lane whose slot is out of
    range (the server pads a partial wave with slot == slots) is
    dropped before any compute. The kept lanes run the vision half one
    image at a time and the decoder prefix pass as one batch."""
    from wedetect_tpu_torch.models.ref import _t

    dev = model.device
    n_slots = state.prompt_mask.shape[0]
    slots = np.asarray(slots)
    keep = np.nonzero((slots >= 0) & (slots < n_slots))[0]
    if len(keep) == 0:
        return
    lane_seeds = (np.zeros(len(slots), np.int32) if lane_seeds is None
                  else np.asarray(lane_seeds))
    lane_caps = (np.full(len(slots), 2**30, np.int32) if lane_caps is None
                 else np.asarray(lane_caps))
    mask = np.asarray(attn_mask)[keep]
    xs, taps_all = [], []
    for i in keep:
        img_tokens, obj, taps = model._vision_and_objects(
            patches[i], boxes_xyxy[i], ori_wh[i], grid_h, grid_w)
        x = model._put_span(model._embed(np.asarray(input_ids)[i][None]),
                            img_tokens, visual_start)
        xs.append(model._scatter_objects(
            x, obj, _t(np.asarray(object_positions)[i][None], dev)))
        taps_all.append(taps)
    kvs, hidden = model.model.language_model.prefix_pass(
        torch.cat(xs), _t(np.asarray(position_ids)[:, keep], dev),
        _t(mask, dev), deepstack_embeds=_stack_taps(taps_all),
        visual_start=visual_start, return_hidden=True,
        attn_impl=model.attn_impl)
    last = torch.as_tensor(mask.sum(axis=1) - 1, device=dev).long()
    h_last = hidden[torch.arange(len(keep), device=dev), last]
    seeds = torch.as_tensor(lane_seeds[keep], dtype=torch.int32, device=dev)
    tok0 = _sample_rows(_lm_logits(decode_params, h_last), sampling, seeds,
                        torch.zeros_like(seeds))
    rows = torch.as_tensor(slots[keep], device=dev).long()
    cols = torch.arange(mask.shape[1], device=dev)
    for (kc, vc), (k, v) in zip(state.caches, kvs):
        _cache_scatter(kc, rows[:, None], cols[None], k)
        _cache_scatter(vc, rows[:, None], cols[None], v)
    _install_slots(state, rows, _t(mask, dev),
                   _t(np.asarray(next_pos0)[keep], dev), tok0, seeds,
                   _t(lane_caps[keep], dev))


@torch.inference_mode()
def _decode_chunk(cfg, chunk: int, eos_id: int, pad_id: int, decode_params,
                  state: EngineState, sampling=(0.0, 0, 1.0)) -> torch.Tensor:
    """`chunk` lockstep single-token steps across all slots; returns the
    (slots, chunk) emitted tokens (int32, on the state's device). Each
    step emits the carried token (pad for done or empty rows), marks
    done on eos or the request's cap, then samples the next token.
    decode_params: a tree through quant.prepare_decode_params (GenServer
    unpacks int4 codes once, at construction)."""
    dp = decode_params
    c, tp = local_text_cfg(cfg.text, dp), dp.get("tp")
    layers = dp["text"]
    b, p_len = state.prompt_mask.shape
    g_cap = state.g_cap
    dev = state.prompt_mask.device
    gen_cols = torch.arange(g_cap, dtype=torch.int32, device=dev)
    toks = []
    for _ in range(chunk):
        done = state.done | (state.gen_count >= state.caps)
        toks.append(torch.where(done, pad_id, state.cur_tok))
        done = done | (state.cur_tok == eos_id)
        x = _embed_rows(dp, state.cur_tok.long())[:, None, :].to(
            state.dtype)
        pos3 = state.next_pos.reshape(1, b, 1).expand(3, b, 1)
        cos, sin = interleaved_mrope_cos_sin(pos3, c)
        depth = torch.clamp(state.gen_count, max=g_cap - 1)
        wcol = (p_len + depth).long()
        kv_valid = torch.cat([state.prompt_mask, (gen_cols[None]
                              <= depth[:, None]).to(torch.int32)], dim=1)
        for i in range(c.layers):
            kc, vc = state.caches[i]
            x = _decode_layer_rowwise(layers[f"layer{i}"], c, x, cos, sin,
                                      kc, vc, wcol, kv_valid, tp)
        h = _rms(x, layers["norm"], c.rms_eps)[:, 0]
        nxt = _sample_rows(_lm_logits(dp, h), sampling, state.seeds,
                           state.gen_count + 1)
        state.cur_tok = torch.where(done, state.cur_tok, nxt.to(torch.int32))
        state.done = done
        state.gen_count = state.gen_count + 1
        state.next_pos = state.next_pos + 1
    return torch.stack(toks, dim=1)


@torch.inference_mode()
def _encode_prompt(model, grid_h: int, grid_w: int, patches, input_ids,
                   boxes_xyxy, ori_wh, object_positions, visual_start: int):
    """The embedding-assembly half of a prefill: vision tower, object
    features, token embeddings with the image and object scatters,
    stopping before the decoder. Returns ((P, D) embeddings, (n_taps, V,
    D) deepstack taps), both in the compute dtype."""
    from wedetect_tpu_torch.models.ref import _t

    dt = model.model.language_model.dtype
    img_tokens, obj, taps = model._vision_and_objects(
        patches, boxes_xyxy, ori_wh, grid_h, grid_w)
    x = model._put_span(model._embed(np.asarray(input_ids).reshape(1, -1)),
                        img_tokens, visual_start)
    x = model._scatter_objects(
        x, obj, _t(np.asarray(object_positions).reshape(1, -1), model.device))
    return x[0].to(dt), torch.stack([t.to(dt) for t in taps])


def _pb_layer(p, c: RefTextCfg, x, cos, sin, cache_k, cache_v, wcol_dec,
              kv_valid_dec, kv_valid_pref, pref_write, pend_slot: int,
              n_dec: int, tp=None):
    """One decoder layer over n_dec decode rows and F piggybacked prompt
    rows: the matmuls run on the concatenated (n_dec + F, 1, D) rows; the
    groups split for the cache writes and the attention.

    Decode rows: as _decode_layer_rowwise. Prompt rows: K/V written at
    the admitted slot's prompt columns `pref_write` = (slot, start,
    count) (None: nothing to write, an idle dispatch or rows past P),
    then attention over that slot's prompt region under kv_valid_pref
    (F, P), which holds both the causal rule and the prompt's mask."""
    q, k, v = _qkv(p, c, x, cos, sin)
    rows = torch.arange(n_dec, device=x.device)
    _cache_scatter(cache_k, rows, wcol_dec, k[:n_dec, 0])
    _cache_scatter(cache_v, rows, wcol_dec, v[:n_dec, 0])
    if pref_write is not None:
        slot, start, cnt = pref_write
        cache_k[slot, start:start + cnt] = k[n_dec:n_dec + cnt, 0].to(
            cache_k.dtype)
        cache_v[slot, start:start + cnt] = v[n_dec:n_dec + cnt, 0].to(
            cache_v.dtype)
    sm = 1.0 / math.sqrt(c.head_dim)
    o_dec = gqa_attention(q[:n_dec], cache_k, cache_v, causal=False,
                          kv_valid=kv_valid_dec, sm_scale=sm, impl="einsum")
    # the prompt rows against the slot's prompt region: query head
    # j = kv * G + g reads kv head kv
    f = x.shape[0] - n_dec
    p_len = kv_valid_pref.shape[1]
    g = c.heads // c.kv_heads
    slot_r = min(pend_slot, n_dec - 1)
    ck = cache_k[slot_r, :p_len]
    cv = cache_v[slot_r, :p_len]
    qp = q[n_dec:, 0].reshape(f, c.kv_heads, g, c.head_dim)
    logits = torch.einsum("fkgd,pkd->fkgp", qp, ck).float() * sm
    maskb = kv_valid_pref.to(torch.bool)[:, None, None, :]
    logits = logits + torch.where(maskb, 0.0, -1e9)
    pr = torch.softmax(logits, dim=-1).to(q.dtype)
    o_pref = torch.einsum("fkgp,pkd->fkgd", pr, cv).reshape(
        f, 1, c.heads * c.head_dim)
    o = torch.cat([o_dec.reshape(n_dec, 1, -1).to(x.dtype),
                   o_pref.to(x.dtype)], dim=0)
    return _out_mlp(p, c, x, o, tp)


@torch.inference_mode()
def _decode_chunk_pb(cfg, chunk: int, eos_id: int, pad_id: int,
                     decode_params, state: EngineState, pend_emb, pend_ds,
                     pend_mask, pend_pos, pend_len: int, pend_np0: int,
                     pend_slot: int, visual_start: int,
                     sampling=(0.0, 0, 1.0), pend_seed: int = 0,
                     pend_cap: int = 2**30) -> torch.Tensor:
    """_decode_chunk with one piggybacked admission: each of the
    `chunk` steps also runs F = ceil(P / chunk) rows of the pending
    prompt, so its whole decoder prefill completes within the chunk. The
    admitted slot installs (done False, first token parked) after the
    last step, so its first token is emitted by the next chunk, the
    stream `_admit` gives. pend_slot out of range (slot == slots) is an
    idle dispatch: the prompt rows run and nothing is installed.

    pend_emb (P, D), pend_ds (n_taps, V, D) from _encode_prompt;
    pend_mask (P,); pend_pos (3, P); pend_len the prompt's real length."""
    dp = decode_params
    c, tp = local_text_cfg(cfg.text, dp), dp.get("tp")
    layers = dp["text"]
    dev = state.prompt_mask.device
    b, p_len = state.prompt_mask.shape
    g_cap = state.g_cap
    f = -(-p_len // chunk)
    l_pad = f * chunk
    gen_cols = torch.arange(g_cap, dtype=torch.int32, device=dev)
    prompt_cols = torch.arange(p_len, dtype=torch.int32, device=dev)
    n_taps, n_vis = pend_ds.shape[0], pend_ds.shape[1]
    live = 0 <= pend_slot < b
    pend_mask = torch.as_tensor(pend_mask, device=dev).to(torch.int32)
    pend_pos = torch.as_tensor(pend_pos, device=dev)
    # install the admitted prompt's mask up front: the slot stays done
    # for the whole chunk, so its decode rows are inert
    if live:
        state.prompt_mask[pend_slot] = pend_mask
    pe = torch.nn.functional.pad(pend_emb, (0, 0, 0, l_pad - p_len))
    pp = torch.nn.functional.pad(pend_pos, (0, l_pad - p_len))
    h_pend = None
    toks = []
    for t in range(chunk):
        done = state.done | (state.gen_count >= state.caps)
        toks.append(torch.where(done, pad_id, state.cur_tok))
        done = done | (state.cur_tok == eos_id)
        seg = t * f
        offs = seg + torch.arange(f, dtype=torch.int32, device=dev)
        x = torch.cat([_embed_rows(dp, state.cur_tok.long())[:, None, :]
                       .to(state.dtype),
                       pe[seg:seg + f, None, :].to(state.dtype)], dim=0)
        pos = torch.cat([state.next_pos.reshape(1, b, 1).expand(3, b, 1),
                         pp[:, seg:seg + f, None].to(state.next_pos.dtype)],
                        dim=1)
        cos, sin = interleaved_mrope_cos_sin(pos, c)
        depth = torch.clamp(state.gen_count, max=g_cap - 1)
        wcol_dec = (p_len + depth).long()
        kv_valid_dec = torch.cat([state.prompt_mask, (gen_cols[None]
                                  <= depth[:, None]).to(torch.int32)], dim=1)
        kv_valid_pref = ((prompt_cols[None, :] <= offs[:, None])
                         & (pend_mask > 0)[None, :]).to(torch.int32)
        n_in = max(0, min(f, p_len - seg))   # this step's rows within P
        pref_write = (pend_slot, seg, n_in) if live and n_in else None
        # the deepstack taps at the vision span, after layer i, as
        # prefix_pass injects them
        lo, hi = max(seg, visual_start), min(seg + f, visual_start + n_vis)
        for i in range(c.layers):
            kc, vc = state.caches[i]
            x = _pb_layer(layers[f"layer{i}"], c, x, cos, sin, kc, vc,
                          wcol_dec, kv_valid_dec, kv_valid_pref, pref_write,
                          pend_slot, b, tp)
            if i < n_taps and lo < hi:
                x[b + lo - seg:b + hi - seg, 0] += pend_ds[i][
                    lo - visual_start:hi - visual_start].to(x.dtype)
        h = _rms(x[:b], layers["norm"], c.rms_eps)[:, 0]
        nxt = _sample_rows(_lm_logits(dp, h), sampling, state.seeds,
                           state.gen_count + 1)
        # the prompt's last real token's hidden state, when this step's
        # rows hold it (the admitted slot's first token samples from it)
        last_idx = pend_len - 1 - seg
        if 0 <= last_idx < f:
            h_pend = _rms(x[b + last_idx], layers["norm"], c.rms_eps)[0]
        state.cur_tok = torch.where(done, state.cur_tok, nxt.to(torch.int32))
        state.done = done
        state.gen_count = state.gen_count + 1
        state.next_pos = state.next_pos + 1
    if live:
        seeds = torch.tensor([pend_seed], dtype=torch.int32, device=dev)
        tok0 = _sample_rows(_lm_logits(dp, h_pend[None]), sampling, seeds,
                            torch.zeros_like(seeds))
        _install_slots(state, pend_slot, pend_mask, pend_np0, tok0[0],
                       pend_seed, pend_cap)
    return torch.stack(toks, dim=1)


def new_state(cfg, slots: int, prompt_len: int, max_new: int, dtype, device,
              pad_id: int = 0, kv_bits: int = 16, tp: int = 1) -> EngineState:
    """An empty engine: every slot done, the KV pool allocated once (on
    this rank's kv heads of a `tp`-way group)."""
    c = tp_text_cfg(cfg.text, tp)
    cap = prompt_len + max_new
    kv_shape = (slots, cap, c.kv_heads, c.head_dim)

    def one_cache():
        if kv_bits == 8:
            return {"q8": torch.zeros(kv_shape, dtype=torch.int8,
                                      device=device),
                    "s": torch.zeros(kv_shape[:3], dtype=torch.float32,
                                     device=device)}
        return torch.zeros(kv_shape, dtype=dtype, device=device)

    i32 = dict(dtype=torch.int32, device=device)
    return EngineState(
        caches=[(one_cache(), one_cache()) for _ in range(c.layers)],
        prompt_mask=torch.zeros((slots, prompt_len), **i32),
        gen_count=torch.zeros(slots, **i32),
        next_pos=torch.zeros(slots, **i32),
        cur_tok=torch.full((slots,), pad_id, **i32),
        done=torch.ones(slots, dtype=torch.bool, device=device),
        seeds=torch.zeros(slots, **i32),
        caps=torch.full((slots,), max_new, **i32),
        dtype=dtype)


class GenServer:
    """Continuous-batching generation over a fixed slot pool.

        srv = GenServer(cfg, gh, gw, model, slots=8, prompt_len=384,
                        max_new=128, chunk=16, eos_id=...)
        rid = srv.submit(patches, ids, mask, pos, visual_start, next_pos0)
        results = srv.run()                # {rid: np.int32 tokens}

    Requests share the padded prompt bucket `prompt_len`, the image grid
    and `visual_start`; their real lengths vary through the mask. The
    compute dtype is the model's. `decode_params` takes a models/quant
    tree (int8 or int4 decode; the prefill stays full precision).
    `kv_bits=8` stores the pool as int8 (not with piggyback: the ridden
    prompt rows read the pool directly). `batch_admit=True` admits
    shape-compatible waves of at least half the pool through one batched
    prefill (`_admit_many`). `piggyback=True` rides one admission a
    chunk on the decode steps; further free slots take the classic
    admission. `mesh` (a parallel/mesh.TpMesh): tensor-parallel serving
    of a model built on mesh.tp (module docstring); every rank of the
    group constructs its GenServer, submits and runs alike."""

    def __init__(self, cfg, grid_h: int, grid_w: int, model, *,
                 slots: int = 8, prompt_len: int, max_new: int,
                 chunk: int = 16, eos_id: int, pad_id: int = 0,
                 decode_params=None, batch_admit: bool = False,
                 piggyback: bool = False, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, mesh=None,
                 kv_bits: int = 16):
        assert chunk >= 1 and max_new >= 1 and slots >= 1
        assert kv_bits in (16, 8), kv_bits
        assert not (piggyback and kv_bits == 8), \
            "piggyback prefill rides full-precision caches only"
        tp = getattr(model, "tp", None)
        if mesh is None and tp is not None:
            raise ValueError("a tensor-parallel model serves through "
                             "GenServer(mesh=)")
        if mesh is not None and mesh.shape["tp"] > 1 and tp is not mesh.tp:
            raise ValueError("GenServer(mesh=) serves a model built on "
                             "mesh.tp (models/ref.tp_ref_model)")
        if decode_params is not None:
            quant.check_decode_tree(decode_params, tp)
        self.kv_bits = kv_bits
        self.batch_admit = batch_admit
        self.piggyback = piggyback
        self.sampling = (float(temperature), int(top_k), float(top_p))
        self.cfg, self.gh, self.gw = cfg, grid_h, grid_w
        self.model = model
        # int4 codes unpacked once here, not in every chunk
        self.decode_params = prepare_decode_params(
            decode_params if decode_params is not None
            else quant.decode_params(model))
        self.slots, self.P, self.G = slots, prompt_len, max_new
        self.chunk = chunk
        self.eos_id, self.pad_id = eos_id, pad_id
        self.device = model.device
        self._state = new_state(cfg, slots, prompt_len, max_new,
                                model.model.language_model.dtype,
                                self.device, pad_id, kv_bits,
                                1 if tp is None else tp.size)
        self._queue = deque()
        self._live = {}            # slot -> request id
        self._buf = {}             # request id -> [tokens]
        self._out = {}             # request id -> np.ndarray (finished)
        self._next_id = 0
        # streaming hook: on_tokens(rid, [new tokens]) from _collect
        self.on_tokens = None
        # the piggyback lane: (slot, rid, encoded args), reserved by
        # _admit_queued and consumed by the next _dispatch_chunk
        self._pend_attach = None
        # chunks * chunk * slots decode slot-steps issued; delivered
        # tokens over slot-steps is the occupancy; admits = prefills
        self.stats = {"chunks": 0, "admits": 0}

    def pool_bytes(self) -> int:
        """Bytes of the KV pool (codes and scales for kv_bits=8)."""
        return quant.quantized_bytes(
            {f"{i}{n}": c if isinstance(c, dict) else {"kv": c}
             for i, kv in enumerate(self._state.caches)
             for n, c in zip("kv", kv)})

    def submit(self, patches, input_ids, attn_mask, position_ids,
               visual_start: int, next_pos0: int, boxes_xyxy=None,
               ori_wh=None, object_positions=None, seed=None,
               max_new=None) -> int:
        """Queue one request. input_ids / attn_mask (P,) or (1, P);
        position_ids (3, P) or (3, 1, P). `seed` drives the request's
        sampling stream (default its request id); `max_new` caps its
        tokens (<= G), freeing its slot once reached. Returns a request
        id that step()/run() resolve."""
        ids = np.asarray(input_ids, np.int32).reshape(1, self.P)
        mask = np.asarray(attn_mask, np.int32).reshape(1, self.P)
        pos = np.asarray(position_ids, np.int32).reshape(3, 1, self.P)
        if boxes_xyxy is None:
            boxes_xyxy = np.array([[0, 0, 10, 10]], np.float32)
        if ori_wh is None:
            ori_wh = np.array([10.0, 10.0], np.float32)
        if object_positions is None:
            object_positions = np.full((1, 1), -1, np.int32)
        cap = self.G if max_new is None else max(1, min(int(max_new),
                                                        self.G))
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, patches, ids, mask, pos,
                            int(visual_start), int(next_pos0),
                            np.asarray(boxes_xyxy, np.float32),
                            np.asarray(ori_wh, np.float32),
                            np.asarray(object_positions, np.int32),
                            int(rid if seed is None else seed), cap))
        self._buf[rid] = []
        return rid

    def _free_slots(self):
        return [s for s in range(self.slots) if s not in self._live]

    @staticmethod
    def _batchable(a, b):
        """Two queued requests can share one _admit_many call when their
        shapes and visual_start agree."""
        return (np.shape(a[1]) == np.shape(b[1])
                and a[5] == b[5]
                and np.shape(a[7]) == np.shape(b[7])
                and np.shape(a[9]) == np.shape(b[9]))

    def _admit_queued(self):
        """Prefill every queued request that fits a free slot.
        Consecutive shape-compatible requests go through one
        _admit_many wave when batch_admit is on and the wave is at
        least half the pool."""
        free = self._free_slots()
        if self.piggyback and self._pend_attach is None and free \
                and self._queue:
            slot = free.pop(0)
            item = self._queue.popleft()
            self._pend_attach = (slot, item[0], self._encode(item))
        while free and self._queue:
            n = min(len(free), len(self._queue))
            if self.batch_admit:
                head = self._queue[0]
                r = 1
                while r < n and self._batchable(head, self._queue[r]):
                    r += 1
                n = r
            if not self.batch_admit or n < max(2, (self.slots + 1) // 2):
                n = 1
            items = [self._queue.popleft() for _ in range(n)]
            slots_n, free = free[:n], free[n:]
            dp = self.decode_params
            if n == 1:
                (rid, patches, ids, mask, pos, vs, np0, boxes, ori, objp,
                 seed, cap) = items[0]
                _admit(self.model, self.gh, self.gw, dp, self._state,
                       slots_n[0], patches, ids, mask, vs, pos, np0, boxes,
                       ori, objp, self.sampling, seed, cap)
                self._live[slots_n[0]] = rid
            else:
                # a partial wave is padded to the pool's width with
                # copies of its first request at slot == slots, which
                # _admit_many drops (the JAX package's single compile)
                pad = self.slots - n
                lanes = items + [items[0]] * pad
                slot_idx = np.asarray(list(slots_n) + [self.slots] * pad,
                                      np.int32)
                _admit_many(
                    self.model, self.gh, self.gw, dp, self._state, slot_idx,
                    [it[1] for it in lanes],
                    np.stack([it[2].reshape(self.P) for it in lanes]),
                    np.stack([it[3].reshape(self.P) for it in lanes]),
                    items[0][5],
                    np.stack([it[4].reshape(3, self.P) for it in lanes],
                             axis=1),
                    np.asarray([it[6] for it in lanes], np.int32),
                    np.stack([it[7] for it in lanes]),
                    np.stack([it[8] for it in lanes]),
                    np.stack([it[9].ravel() for it in lanes]),
                    self.sampling,
                    np.asarray([it[10] for it in lanes], np.int32),
                    np.asarray([it[11] for it in lanes], np.int32))
                for slot, it in zip(slots_n, items):
                    self._live[slot] = it[0]
                self.stats["admit_batches"] = \
                    self.stats.get("admit_batches", 0) + 1
            self.stats["admits"] += n

    def _encode(self, item):
        """The vision half of one admission; returns _decode_chunk_pb's
        pending arguments minus the slot."""
        (rid, patches, ids, mask, pos, vs, np0, boxes, ori, objp, seed,
         cap) = item
        emb, ds = _encode_prompt(self.model, self.gh, self.gw, patches,
                                 ids.reshape(self.P), boxes, ori, objp, vs)
        return (emb, ds, mask.reshape(self.P), pos.reshape(3, self.P),
                int(mask.sum()), np0, vs, seed, cap)

    def _readback(self, toks: torch.Tensor):
        """Start the chunk's token readback: on the card a non-blocking
        copy into pinned memory and an event; on the CPU the tensor."""
        if toks.device.type != "cuda":
            return toks, None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _dispatch_chunk(self):
        """Dispatch one decode chunk; returns (the readback handle, the
        slot -> rid map as of this chunk). With a piggyback admission
        pending, the chunk carries its prompt rows, and the admitted rid
        joins the live map after the snapshot (its first token lands in
        the next chunk)."""
        pend = self._pend_attach if self.piggyback else None
        if pend is None:
            toks = _decode_chunk(self.cfg, self.chunk, self.eos_id,
                                 self.pad_id, self.decode_params,
                                 self._state, self.sampling)
            self.stats["chunks"] += 1
            return self._readback(toks), dict(self._live)
        slot, rid, (emb, ds, mask, pos, ln, np0, vs, seed, cap) = pend
        toks = _decode_chunk_pb(self.cfg, self.chunk, self.eos_id,
                                self.pad_id, self.decode_params, self._state,
                                emb, ds, mask, pos, ln, np0, slot, vs,
                                self.sampling, seed, cap)
        snap = dict(self._live)
        self._live[slot] = rid
        self._pend_attach = None
        self.stats["admits"] += 1
        self.stats["pb_admits"] = self.stats.get("pb_admits", 0) + 1
        self.stats["chunks"] += 1
        return self._readback(toks), snap

    def _collect(self, handle, live_snap):
        """Wait for one chunk's tokens and drain finished requests. Rows
        resolve against the snapshot of the chunk's dispatch; rids that
        finished earlier are skipped."""
        toks, ev = handle
        if ev is not None:
            ev.synchronize()
        toks = toks.numpy()
        finished = {}
        for slot, rid in live_snap.items():
            buf = self._buf.get(rid)
            if buf is None:
                continue
            n0 = len(buf)
            hit_end = False
            for t in toks[slot]:
                t = int(t)
                if t == self.eos_id or t == self.pad_id \
                        or len(buf) >= self.G:
                    hit_end = True
                    break
                buf.append(t)
            if self.on_tokens is not None and len(buf) > n0:
                self.on_tokens(rid, buf[n0:])
            if hit_end or len(buf) >= self.G:
                out = np.asarray(buf, np.int32)
                self._out[rid] = out
                finished[rid] = out
                if self._live.get(slot) == rid:
                    del self._live[slot]
                del self._buf[rid]
        return finished

    def step(self):
        """Admit, decode one chunk, drain: synchronous. Returns {rid:
        tokens} finished this step (also kept for run())."""
        self._admit_queued()
        return self._collect(*self._dispatch_chunk())

    @property
    def busy(self) -> bool:
        """True while any request is queued or decoding."""
        return bool(self._queue or self._live)

    def pump(self, pending=None):
        """One pipelined scheduler turn: admit and dispatch a chunk if any
        work is live, then collect the previous turn's tokens. Returns
        (next_pending, finished); pass next_pending back next call."""
        nxt = None
        if self._queue or self._live:
            self._admit_queued()
            nxt = self._dispatch_chunk()
        finished = {}
        if pending is not None:
            finished = self._collect(*pending)
        return nxt, finished

    def run(self, pipeline: bool = True) -> Dict[int, np.ndarray]:
        """Decode until every request finishes; {rid: np.int32 tokens
        (eos and pad excluded)}. pipeline=True overlaps each chunk's
        readback with the next chunk (a finished slot is found one chunk
        later); the tokens are the same either way."""
        if not pipeline:
            while self._queue or self._live:
                self.step()
        else:
            pending = None
            while self._queue or self._live or pending is not None:
                pending, _ = self.pump(pending)
        out, self._out = self._out, {}
        return out
