"""Qwen3-VL in PyTorch: ViT with deepstack taps + Qwen3 decoder (MRoPE).

Port of `wedetect_tpu/nn/qwen3vl.py` under the HF Qwen3-VL key names
(`visual.blocks.{i}.attn.qkv`, `language_model.layers.{i}.self_attn.q_proj`,
...), which `wedetect_tpu/ckpt/convert_ref.py` reads. The patch embed
keeps the checkpoint's Conv3d-shaped weight (hidden, C, T, P, P) and
runs as one matmul over flattened patches.

Compute dtype: a module computes in the dtype of its matmul weights
(float32, or bfloat16 once `models/ref.cast_ref_model` has cast them);
norms keep f32 weights and compute in f32, as `RMSNorm` and
`nn.LayerNorm(dtype=f32)` do in the JAX package. The ViT's attention
goes through `ops/attention.dot_product_attention` (K3 on the card), the
decoder's through `ops/attention.gqa_attention` (K2 on the card).

`RefCfg.quant_int8` is the dynamic int8 prefill (`ops/int8.py`): the
ViT blocks' four Linears and the decoder layers' seven projections are
`QuantLinear`s, as JAX passes them `dot_general=`; the patch embed, the
mergers and everything outside the two towers stay float.

Tensor parallelism (`tp`, a `parallel/collectives.Group` of the ranks
that hold one model between them; `parallel/mesh.py` states the layout):
each module is built with this rank's slices. A ViT block or decoder
layer runs its own heads (the decoder's layers on `tp_text_cfg`, the
local widths) and ffn channels, and sums its row-parallel outputs over
the group (`row_linear`; under `quant_int8` its absmax scales and
int32 sums too, so each int8 product is the one-process one bitwise);
the mergers' fc1 / fc2 likewise; the token table holds this rank's
vocabulary range (`vocab_embed`). tp None is the one-process model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wedetect_tpu_torch.ops.attention import (dot_product_attention,
                                              gqa_attention)
from wedetect_tpu_torch.ops.int8 import QuantLinear
from wedetect_tpu_torch.parallel.mesh import (row_linear, tp_size,
                                              vocab_embed)


@dataclasses.dataclass(frozen=True)
class RefVisionCfg:
    depth: int = 24
    hidden: int = 1024
    heads: int = 16
    intermediate: int = 4096
    patch: int = 16
    temporal_patch: int = 2
    in_ch: int = 3
    merge: int = 2
    out_hidden: int = 2048
    num_pos_emb: int = 2304  # 48 * 48
    deepstack_idx: Tuple[int, ...] = (5, 11, 17)

    @property
    def head_dim(self):
        return self.hidden // self.heads


@dataclasses.dataclass(frozen=True)
class RefTextCfg:
    vocab_size: int = 151936
    hidden: int = 2048
    layers: int = 28
    heads: int = 16
    kv_heads: int = 8
    head_dim: int = 128
    intermediate: int = 6144
    rms_eps: float = 1e-6
    rope_theta: float = 5e6
    mrope_section: Tuple[int, int, int] = (24, 20, 20)


@dataclasses.dataclass(frozen=True)
class RefCfg:
    vision: RefVisionCfg = RefVisionCfg()
    text: RefTextCfg = RefTextCfg()
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    object_token_id: int = 151665
    # dynamic int8 prefill matmuls of the ViT blocks and the decoder
    # layers (ops/int8.py); independent of the weight-only decode modes
    quant_int8: bool = False

    @classmethod
    def from_hf_config(cls, hf) -> "RefCfg":
        """Build from a transformers Qwen3VLConfig."""
        v, t = hf.vision_config, hf.text_config
        return cls(
            vision=RefVisionCfg(
                depth=v.depth, hidden=v.hidden_size,
                heads=v.num_heads, intermediate=v.intermediate_size,
                patch=v.patch_size, temporal_patch=v.temporal_patch_size,
                in_ch=v.in_channels, merge=v.spatial_merge_size,
                out_hidden=v.out_hidden_size,
                num_pos_emb=v.num_position_embeddings,
                deepstack_idx=tuple(v.deepstack_visual_indexes)),
            text=RefTextCfg(
                vocab_size=t.vocab_size, hidden=t.hidden_size,
                layers=t.num_hidden_layers, heads=t.num_attention_heads,
                kv_heads=t.num_key_value_heads,
                head_dim=getattr(t, "head_dim",
                                 t.hidden_size // t.num_attention_heads),
                intermediate=t.intermediate_size,
                rms_eps=t.rms_norm_eps, rope_theta=t.rope_theta,
                mrope_section=tuple(t.rope_scaling["mrope_section"])),
            image_token_id=hf.image_token_id,
            video_token_id=getattr(hf, "video_token_id", 151656),
            vision_start_token_id=hf.vision_start_token_id,
        )


def tp_text_cfg(c: RefTextCfg, tp: int) -> RefTextCfg:
    """The decoder widths one of `tp` ranks holds: its heads, kv heads
    and ffn channels (the same group ratio); c itself for tp = 1."""
    if tp == 1:
        return c
    return dataclasses.replace(c, heads=c.heads // tp,
                               kv_heads=c.kv_heads // tp,
                               intermediate=c.intermediate // tp)


def ref_2b() -> RefCfg:
    """WeDetect-Ref 2B preset (the RefCfg defaults: Qwen3-VL-2B)."""
    return RefCfg()


def ref_4b() -> RefCfg:
    """WeDetect-Ref 4B preset: the Qwen3-VL-4B decoder scale over the
    same vision tower with a matching projector width."""
    return RefCfg(
        vision=dataclasses.replace(RefVisionCfg(), out_hidden=2560),
        text=RefTextCfg(hidden=2560, layers=36, heads=32, kv_heads=8,
                        head_dim=128, intermediate=9728),
    )


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """nn.LayerNorm(dtype=f32) of the JAX package: f32 in and out, then
    the compute dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(dtype)


class RMSNorm(nn.Module):
    """RMSNorm with an f32 `weight`; computes in f32, returns `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight).to(dtype)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _apply_rope(q, k, cos, sin):
    qf, kf = q.float(), k.float()
    cos, sin = cos.float(), sin.float()
    qe = qf * cos + _rotate_half(qf) * sin
    ke = kf * cos + _rotate_half(kf) * sin
    return qe.to(q.dtype), ke.to(k.dtype)


# --------------------------------------------------------------- vision


def vision_pos_ids(grid_h: int, grid_w: int, merge: int) -> np.ndarray:
    """(S, 2) (row, col) ids in merge-permuted token order."""
    mh, mw = grid_h // merge, grid_w // merge
    rows = (np.arange(mh)[:, None, None, None] * merge
            + np.arange(merge)[None, None, :, None])
    cols = (np.arange(mw)[None, :, None, None] * merge
            + np.arange(merge)[None, None, None, :])
    rows = np.broadcast_to(rows, (mh, mw, merge, merge)).reshape(-1)
    cols = np.broadcast_to(cols, (mh, mw, merge, merge)).reshape(-1)
    return np.stack([rows, cols], -1)


def vision_pos_interp(grid_h: int, grid_w: int, side: int, merge: int):
    """Static bilinear gather (indices (4, S), weights (4, S)) for the
    learned pos-embed table, in merge-permuted token order."""
    h_idx = np.linspace(0, side - 1, grid_h)
    w_idx = np.linspace(0, side - 1, grid_w)
    hf, wf = h_idx.astype(np.int64), w_idx.astype(np.int64)
    hc = np.clip(hf + 1, None, side - 1)
    wc = np.clip(wf + 1, None, side - 1)
    dh, dw = h_idx - hf, w_idx - wf
    idx = np.stack([
        (hf[:, None] * side + wf[None, :]).reshape(-1),
        (hf[:, None] * side + wc[None, :]).reshape(-1),
        (hc[:, None] * side + wf[None, :]).reshape(-1),
        (hc[:, None] * side + wc[None, :]).reshape(-1),
    ])
    wgt = np.stack([
        ((1 - dh)[:, None] * (1 - dw)[None, :]).reshape(-1),
        ((1 - dh)[:, None] * dw[None, :]).reshape(-1),
        (dh[:, None] * (1 - dw)[None, :]).reshape(-1),
        (dh[:, None] * dw[None, :]).reshape(-1),
    ])
    mh, mw = grid_h // merge, grid_w // merge
    perm = (np.arange(grid_h * grid_w)
            .reshape(mh, merge, mw, merge)
            .transpose(0, 2, 1, 3).reshape(-1))
    return idx[:, perm], wgt[:, perm]


class _VisionAttn(nn.Module):
    def __init__(self, c: RefVisionCfg, tp: int = 1):
        super().__init__()
        self.qkv = QuantLinear(c.hidden, 3 * c.hidden // tp)
        self.proj = QuantLinear(c.hidden // tp, c.hidden)


class _VisionMlp(nn.Module):
    def __init__(self, c: RefVisionCfg, tp: int = 1):
        super().__init__()
        self.linear_fc1 = QuantLinear(c.hidden, c.intermediate // tp)
        self.linear_fc2 = QuantLinear(c.intermediate // tp, c.hidden)


class VisionBlock(nn.Module):
    def __init__(self, cfg: RefVisionCfg, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.norm1 = nn.LayerNorm(cfg.hidden, eps=1e-6)
        self.norm2 = nn.LayerNorm(cfg.hidden, eps=1e-6)
        self.attn = _VisionAttn(cfg, tp_size(tp))
        self.mlp = _VisionMlp(cfg, tp_size(tp))

    def forward(self, x, cos, sin, valid=None, attn_impl: str = "auto"):
        """x (S, hidden), or (B, S, hidden): B images of one grid, one
        attention launch over the batch; cos / sin (S, head_dim) and
        valid (S,) are the grid's, shared by every image."""
        c = self.cfg
        dt = self.attn.qkv.weight.dtype
        shape = x.shape
        s = shape[-2]
        x = x.reshape(-1, s, c.hidden)
        b = x.shape[0]
        d = c.head_dim
        y = layer_norm(self.norm1, x, dt)
        q, k, v = (t.reshape(b, s, -1, d)       # this rank's heads
                   for t in self.attn.qkv(y).chunk(3, dim=-1))
        q, k = _apply_rope(q, k, cos[None, :, None, :],
                           sin[None, :, None, :])
        o = dot_product_attention(
            q, k, v, causal=False,
            kv_valid=None if valid is None else valid.expand(b, s),
            sm_scale=1.0 / math.sqrt(d), impl=attn_impl)
        x = x + row_linear(self.attn.proj, o.reshape(b, s, -1), self.tp)
        y = layer_norm(self.norm2, x, dt)
        y = self.mlp.linear_fc1(y)
        y = F.gelu(y.float(), approximate="tanh").to(dt)
        return (x + row_linear(self.mlp.linear_fc2, y,
                               self.tp)).reshape(shape)


class PatchMerger(nn.Module):
    def __init__(self, cfg: RefVisionCfg, postshuffle: bool = False,
                 tp=None):
        super().__init__()
        self.cfg = cfg
        self.postshuffle = postshuffle
        self.tp = tp
        m2 = cfg.merge ** 2
        self.norm = nn.LayerNorm(cfg.hidden * m2 if postshuffle
                                 else cfg.hidden, eps=1e-6)
        width = cfg.hidden * m2 // tp_size(tp)
        self.linear_fc1 = nn.Linear(cfg.hidden * m2, width)
        self.linear_fc2 = nn.Linear(width, cfg.out_hidden)

    def forward(self, x):
        c = self.cfg
        dt = self.linear_fc1.weight.dtype
        m2 = c.merge ** 2
        if self.postshuffle:
            x = layer_norm(self.norm, x.reshape(-1, c.hidden * m2), dt)
        else:
            x = layer_norm(self.norm, x, dt).reshape(-1, c.hidden * m2)
        x = self.linear_fc1(x)
        x = F.gelu(x.float(), approximate="none").to(dt)
        return row_linear(self.linear_fc2, x, self.tp)


class _PatchEmbed(nn.Module):
    def __init__(self, c: RefVisionCfg):
        super().__init__()
        k = (c.temporal_patch, c.patch, c.patch)
        self.proj = nn.Conv3d(c.in_ch, c.hidden, k, stride=k)

    def forward(self, patches):
        w = self.proj.weight
        return F.linear(patches.to(w.dtype), w.reshape(w.shape[0], -1),
                        self.proj.bias)


class VisionModel(nn.Module):
    """patches (grid_t*gh*gw, in_ch*t*p*p) -> (merged
    (grid_t*gh*gw/m^2, out_hidden), deepstack list of the same); or
    patches (B, S, in_ch*t*p*p) of B images on one grid -> (B, V,
    out_hidden) and taps of the same, each block one attention launch
    over the batch (the JAX package vmaps the single-image tower)."""

    def __init__(self, cfg: RefVisionCfg, tp=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg)
        self.pos_embed = nn.Embedding(cfg.num_pos_emb, cfg.hidden)
        self.blocks = nn.ModuleList(VisionBlock(cfg, tp)
                                    for _ in range(cfg.depth))
        self.merger = PatchMerger(cfg, postshuffle=False, tp=tp)
        self.deepstack_merger_list = nn.ModuleList(
            PatchMerger(cfg, postshuffle=True, tp=tp)
            for _ in cfg.deepstack_idx)

    def forward(self, patches, grid_h: int, grid_w: int, grid_t: int = 1,
                attn_impl: str = "auto"):
        c = self.cfg
        dev = patches.device
        x = self.patch_embed(patches)
        dt = x.dtype
        side = int(c.num_pos_emb ** 0.5)
        idx, wgt = vision_pos_interp(grid_h, grid_w, side, c.merge)
        # no local keeps the table: under parameter sharding it is a
        # gathered tensor, dropped when the next unit is gathered
        pos = torch.einsum("ksd,ks->sd",
                           self.pos_embed.weight.float()[
                               torch.as_tensor(idx, device=dev)],
                           torch.as_tensor(wgt, dtype=torch.float32,
                                           device=dev))
        x = x + pos.repeat(grid_t, 1).to(dt)

        ids = np.tile(vision_pos_ids(grid_h, grid_w, c.merge), (grid_t, 1))
        dim = c.head_dim // 4
        inv = 1.0 / (10000.0 ** (np.arange(0, dim * 2, 2, dtype=np.float64)
                                 / (dim * 2)))
        freqs = np.concatenate([ids[:, 0:1] * inv[None],
                                ids[:, 1:2] * inv[None]], axis=1)
        emb = np.concatenate([freqs, freqs], axis=-1)
        cos = torch.as_tensor(np.cos(emb), dtype=torch.float32, device=dev)
        sin = torch.as_tensor(np.sin(emb), dtype=torch.float32, device=dev)

        # pad the token axis to a flash-tileable multiple of 128; pad
        # rows form segment 0 and never reach a real token
        s = grid_t * grid_h * grid_w
        s_pad = -(-s // 128) * 128
        valid = None
        if s_pad != s:
            x = F.pad(x, (0, 0, 0, s_pad - s))
            cos = F.pad(cos, (0, 0, 0, s_pad - s))
            sin = F.pad(sin, (0, 0, 0, s_pad - s))
            valid = (torch.arange(s_pad, device=dev) < s).to(torch.int32)

        lead = x.shape[:-2]             # () or (B,)

        def merged(merger, t):
            # a merge block is m^2 consecutive tokens of one image
            return merger(t[..., :s, :]).reshape(
                *lead, s // c.merge ** 2, c.out_hidden)

        taps = []
        for i, block in enumerate(self.blocks):
            x = block(x, cos, sin, valid, attn_impl=attn_impl)
            if i in c.deepstack_idx:
                j = c.deepstack_idx.index(i)
                taps.append(merged(self.deepstack_merger_list[j], x))
        return merged(self.merger, x), taps


# ----------------------------------------------------------------- text


def interleaved_mrope_cos_sin(position_ids: torch.Tensor, cfg: RefTextCfg):
    """position_ids (3, B, L) -> cos/sin (B, L, head_dim), f32."""
    dev = position_ids.device
    half = cfg.head_dim // 2
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, cfg.head_dim, 2, dtype=torch.float32, device=dev)
        / cfg.head_dim))
    freqs = position_ids[..., None].float() * inv        # (3, B, L, half)
    ft = freqs[0]
    lane = torch.arange(half, device=dev)
    for axis, offset in ((1, 1), (2, 2)):
        length = cfg.mrope_section[axis] * 3
        sel = (lane % 3 == offset) & (lane < length)
        ft = torch.where(sel, freqs[axis], ft)
    emb = torch.cat([ft, ft], dim=-1)
    return torch.cos(emb), torch.sin(emb)


class _SelfAttn(nn.Module):
    def __init__(self, c: RefTextCfg):
        super().__init__()
        self.q_proj = QuantLinear(c.hidden, c.heads * c.head_dim,
                                  bias=False)
        self.k_proj = QuantLinear(c.hidden, c.kv_heads * c.head_dim,
                                  bias=False)
        self.v_proj = QuantLinear(c.hidden, c.kv_heads * c.head_dim,
                                  bias=False)
        self.o_proj = QuantLinear(c.heads * c.head_dim, c.hidden,
                                  bias=False)
        self.q_norm = RMSNorm(c.head_dim, c.rms_eps)
        self.k_norm = RMSNorm(c.head_dim, c.rms_eps)


class _Mlp(nn.Module):
    def __init__(self, c: RefTextCfg):
        super().__init__()
        self.gate_proj = QuantLinear(c.hidden, c.intermediate, bias=False)
        self.up_proj = QuantLinear(c.hidden, c.intermediate, bias=False)
        self.down_proj = QuantLinear(c.intermediate, c.hidden, bias=False)


class TextLayer(nn.Module):
    """One Qwen3 decoder layer.

    prefix_kv: optional (pk, pv), each (1 | B, P, kv_heads, head_dim):
    post-rope KV of a shared leading prefix, placed before this call's
    own keys (end-aligned causal). return_kv: also return this call's
    own post-rope (k, v), pre-repeat. With `tp`, cfg is this rank's
    widths (tp_text_cfg) and o_proj and down_proj are row-parallel."""

    def __init__(self, cfg: RefTextCfg, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.input_layernorm = RMSNorm(cfg.hidden, cfg.rms_eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden, cfg.rms_eps)
        self.self_attn = _SelfAttn(cfg)
        self.mlp = _Mlp(cfg)

    def forward(self, x, cos, sin, kv_valid, prefix_kv=None,
                return_kv: bool = False, attn_impl: str = "auto"):
        c = self.cfg
        a = self.self_attn
        dt = a.q_proj.weight.dtype
        b, l, _ = x.shape
        y = self.input_layernorm(x, dt)
        q = a.q_norm(a.q_proj(y).reshape(b, l, c.heads, c.head_dim), dt)
        k = a.k_norm(a.k_proj(y).reshape(b, l, c.kv_heads, c.head_dim), dt)
        v = a.v_proj(y).reshape(b, l, c.kv_heads, c.head_dim)
        q, k = _apply_rope(q, k, cos[:, :, None, :], sin[:, :, None, :])
        own_kv = (k, v)
        if prefix_kv is not None:
            pk, pv = prefix_kv
            k = torch.cat([pk.expand((b,) + pk.shape[1:]), k], dim=1)
            v = torch.cat([pv.expand((b,) + pv.shape[1:]), v], dim=1)
        o = gqa_attention(q, k, v, causal=True, kv_valid=kv_valid,
                          sm_scale=1.0 / math.sqrt(c.head_dim),
                          impl=attn_impl)
        x = x + row_linear(a.o_proj, o.reshape(b, l, -1), self.tp)
        y = self.post_attention_layernorm(x, dt)
        m = self.mlp
        out = x + row_linear(m.down_proj,
                             F.silu(m.gate_proj(y)) * m.up_proj(y), self.tp)
        return (out, own_kv) if return_kv else out


class Embedder(nn.Embedding):
    """Token embedding (HF `embed_tokens`): ids -> (..., hidden) in the
    table's dtype. With `tp`, the table holds this rank's vocabulary
    range (vocab_embed)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, tp=None):
        super().__init__(num_embeddings, embedding_dim)
        self.tp = tp

    def forward(self, input_ids):
        ids = torch.as_tensor(input_ids).long()
        if self.tp is None:
            return super().forward(ids)
        return vocab_embed(self.weight, ids, self.tp)


class TextModel(nn.Module):
    """Decoder over precomputed input embeddings (prefill scoring).

    deepstack_embeds: list of (V, out_hidden) visual features added after
    layers 0..n-1 over the span [visual_start, visual_start + V) of every
    row (one shared image), or of (B, V, out_hidden), one image a row;
    or, for sequences holding several images, a list of tuples of
    (V_i, out_hidden) with visual_start a tuple of the spans' starts.
    `cfg` is the whole model's; with `tp` the layers run on this rank's
    widths (tp_text_cfg)."""

    def __init__(self, cfg: RefTextCfg, tp=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embedder(cfg.vocab_size // tp_size(tp),
                                     cfg.hidden, tp)
        local = tp_text_cfg(cfg, tp_size(tp))
        self.layers = nn.ModuleList(TextLayer(local, tp)
                                    for _ in range(cfg.layers))
        self.norm = RMSNorm(cfg.hidden, cfg.rms_eps)

    @property
    def dtype(self):
        # the parameter list, not an attribute read that would gather
        # layer 0 under parameter sharding (parallel/fsdp.py)
        return next(self.layers[0].self_attn.q_proj.parameters()).dtype

    def _inject_deepstack(self, x, ds, visual_start):
        """Add tap features over visual span(s). ds: (V, D) shared by
        every row, or (B, V, D) a row each, at the int visual_start; or
        a tuple of (V_i, D) with a tuple of starts for sequences that
        hold several images (each image's tap at its own span)."""
        if not isinstance(ds, (tuple, list)):
            ds, visual_start = (ds,), (visual_start,)
        for d_i, vs_i in zip(ds, visual_start):
            n = d_i.shape[-2]
            d_i = d_i.to(x.dtype)
            span = x[:, vs_i:vs_i + n] + (d_i if d_i.dim() == 3
                                          else d_i[None])
            x = torch.cat([x[:, :vs_i], span, x[:, vs_i + n:]], dim=1)
        return x

    def forward(self, inputs_embeds, position_ids, attention_mask,
                deepstack_embeds: Optional[Sequence[torch.Tensor]] = None,
                visual_start: int = 0, attn_impl: str = "auto"):
        cos, sin = interleaved_mrope_cos_sin(position_ids, self.cfg)
        kv_valid = attention_mask.to(torch.int32)
        x = inputs_embeds.to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, kv_valid, attn_impl=attn_impl)
            if deepstack_embeds is not None and i < len(deepstack_embeds):
                x = self._inject_deepstack(x, deepstack_embeds[i],
                                           visual_start)
        return self.norm(x, self.dtype)

    def prefix_pass(self, prefix_embeds, prefix_position_ids, prefix_mask,
                    deepstack_embeds=None, visual_start: int = 0,
                    return_hidden: bool = False, attn_impl: str = "auto"):
        """The (1, P, D) shared prefix, or (B, P, D) rows each with its
        own image (cross-image REC batching; deepstack taps (B, V, D)),
        through every layer -> the per-layer post-rope KV (tuple of
        (k, v), each (1 | B, P, kv_heads, head_dim)) [, the normed hidden
        states]."""
        cos, sin = interleaved_mrope_cos_sin(prefix_position_ids, self.cfg)
        pvalid = prefix_mask.to(torch.int32)
        x = prefix_embeds.to(self.dtype)
        kvs = []
        for i, layer in enumerate(self.layers):
            x, kv = layer(x, cos, sin, pvalid, return_kv=True,
                          attn_impl=attn_impl)
            kvs.append(kv)
            if deepstack_embeds is not None and i < len(deepstack_embeds):
                x = self._inject_deepstack(x, deepstack_embeds[i],
                                           visual_start)
        if return_hidden:
            return tuple(kvs), self.norm(x, self.dtype)
        return tuple(kvs)

    def suffix_pass(self, kvs, suffix_embeds, suffix_position_ids,
                    prefix_mask, suffix_mask, attn_impl: str = "auto"):
        """(B, S, D) suffix rows attending to the prefix KV from
        prefix_pass -> normed hidden states. kvs and prefix_mask (1, P)
        are shared by every row, or (B, ...) a row each: row i attends
        image i's prefix."""
        b = suffix_embeds.shape[0]
        cos, sin = interleaved_mrope_cos_sin(suffix_position_ids, self.cfg)
        pvalid = prefix_mask.to(torch.int32)
        full_valid = torch.cat([pvalid.expand(b, pvalid.shape[1]),
                                suffix_mask.to(torch.int32)], dim=1)
        y = suffix_embeds.to(self.dtype)
        for i, layer in enumerate(self.layers):
            y = layer(y, cos, sin, full_valid, prefix_kv=kvs[i],
                      attn_impl=attn_impl)
        return self.norm(y, self.dtype)

    def prefill_split(self, prefix_embeds, suffix_embeds,
                      prefix_position_ids, suffix_position_ids,
                      prefix_mask, suffix_mask, deepstack_embeds=None,
                      visual_start: int = 0, attn_impl: str = "auto"):
        """Prefix-sharing prefill: the prefix runs the dense layers once,
        the suffix rows attend [prefix KV; own causal KV]. The same
        function as forward() on the concatenated sequences."""
        kvs = self.prefix_pass(prefix_embeds, prefix_position_ids,
                               prefix_mask, deepstack_embeds=deepstack_embeds,
                               visual_start=visual_start, attn_impl=attn_impl)
        return self.suffix_pass(kvs, suffix_embeds, suffix_position_ids,
                                prefix_mask, suffix_mask, attn_impl=attn_impl)


def get_rope_index_single_image(input_ids: np.ndarray, image_token_id: int,
                                grid_h: int, grid_w: int,
                                merge: int) -> np.ndarray:
    """Host-side MRoPE position ids (3, L) for one sequence with one
    image: text advances all three axes; image tokens get (t=st,
    st+row, st+col); text after the image resumes at st + max(mh, mw)."""
    l = len(input_ids)
    pos = np.zeros((3, l), np.int64)
    img = np.nonzero(input_ids == image_token_id)[0]
    if len(img) == 0:
        pos[:] = np.arange(l)
        return pos
    st = int(img[0])
    mh, mw = grid_h // merge, grid_w // merge
    assert len(img) == mh * mw, (len(img), mh, mw)
    pos[:, :st] = np.arange(st)
    rows = np.repeat(np.arange(mh), mw)
    cols = np.tile(np.arange(mw), mh)
    pos[0, st:st + mh * mw] = st
    pos[1, st:st + mh * mw] = st + rows
    pos[2, st:st + mh * mw] = st + cols
    nxt = st + max(mh, mw)
    rest = l - (st + mh * mw)
    pos[:, st + mh * mw:] = nxt + np.arange(rest)
    return pos


def get_rope_index_single_video(input_ids: np.ndarray, video_token_id: int,
                                grid_t: int, grid_h: int, grid_w: int,
                                merge: int) -> np.ndarray:
    """Host-side MRoPE position ids (3, L) for one sequence with one
    contiguous video span: per temporal group the (row, col) grid
    repeats and the t axis advances by one group; text after the span
    resumes at st + max(grid_t, mh, mw).

    This is the JAX package's layout, not HF's: the HF Qwen3-VL
    processor splits a video into per-frame vision spans separated by
    timestamp text (each span with t = 1). The contiguous span is what
    data/sft_chat.ChatSftDataset and RefScorer.generate_video_text
    emit; time still advances on the t axis and rows and columns match
    per frame."""
    l = len(input_ids)
    pos = np.zeros((3, l), np.int64)
    vid = np.nonzero(input_ids == video_token_id)[0]
    if len(vid) == 0:
        pos[:] = np.arange(l)
        return pos
    st = int(vid[0])
    mh, mw = grid_h // merge, grid_w // merge
    n = grid_t * mh * mw
    assert len(vid) == n, (len(vid), grid_t, mh, mw)
    pos[:, :st] = np.arange(st)
    pos[0, st:st + n] = st + np.repeat(np.arange(grid_t), mh * mw)
    pos[1, st:st + n] = st + np.tile(np.repeat(np.arange(mh), mw), grid_t)
    pos[2, st:st + n] = st + np.tile(np.tile(np.arange(mw), mh), grid_t)
    nxt = st + max(grid_t, mh, mw)
    pos[:, st + n:] = nxt + np.arange(l - (st + n))
    return pos


def get_rope_index_multi(input_ids: np.ndarray, image_token_id: int,
                         grids: Sequence[Tuple[int, int]],
                         merge: int) -> np.ndarray:
    """Host-side MRoPE position ids (3, L) for one sequence holding
    several images: text advances all three axes; the i-th contiguous
    run of image tokens gets (t=st, st+row, st+col) at the running
    offset st; text after image i resumes at st + max(mh_i, mw_i).
    grids lists each image's unmerged (grid_h, grid_w) in order."""
    l = len(input_ids)
    pos = np.zeros((3, l), np.int64)
    is_img = input_ids == image_token_id
    edges = np.flatnonzero(np.diff(np.concatenate(
        [[0], is_img.view(np.int8), [0]])))
    runs = list(zip(edges[::2], edges[1::2]))
    assert len(runs) == len(grids), (len(runs), len(grids))
    cur = 0     # next text position
    prev_end = 0
    for (st, en), (gh, gw) in zip(runs, grids):
        mh, mw = gh // merge, gw // merge
        assert en - st == mh * mw, (en - st, mh, mw)
        n_text = st - prev_end
        pos[:, prev_end:st] = cur + np.arange(n_text)
        cur += n_text
        pos[0, st:en] = cur
        pos[1, st:en] = cur + np.repeat(np.arange(mh), mw)
        pos[2, st:en] = cur + np.tile(np.arange(mw), mh)
        cur += max(mh, mw)
        prev_end = en
    pos[:, prev_end:] = cur + np.arange(l - prev_end)
    return pos
