"""Plain WeDetect-Ref (Qwen3-VL with the grounding extras): the
benchmark's reference for REC scoring.

The published model (WeChatCV/WeDetect wedetect_ref/models/
qwen3vl_referring.py over Qwen/Qwen3-VL-2B-Instruct), in float32 plain
PyTorch, one chat sequence at a time and whole: the image span, the
query and the <object> slots in one causal pass, with softmax attention
written out (no kernel, no padding, no prefix sharing, no batching).

- ViT: patch embed (the Conv3d weight as one matmul), the learned
  position table interpolated bilinearly to the grid, 2-D rotary
  embeddings, blocks of LayerNorm / attention / tanh-GELU MLP, the
  patch merger, and three deepstack mergers whose outputs are added to
  the image span after decoder layers 0, 1, 2.
- Decoder: Qwen3 layers (RMSNorm, q/k RMSNorm per head, interleaved
  MRoPE, grouped KV heads, SwiGLU), final RMSNorm.
- Grounding: sine position embeddings of the merged grid (an MLP) added
  to the image tokens; a stride 8 / 16 / 32 pyramid from the last two
  deepstack taps and the merged tokens (transposed convolutions), 7x7
  RoIAlign of each proposal at every level, merged and projected, plus
  an MLP of the box's sine embedding, written into the <object> slots;
  `out_proj` scores each slot.

Parameter names are the checkpoint's (HF Qwen3-VL names under
`model.`), so one state dict loads here and into the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IMAGE_MEAN = 0.5
IMAGE_STD = 0.5


@dataclass(frozen=True)
class VisionCfg:
    depth: int = 24
    hidden: int = 1024
    heads: int = 16
    intermediate: int = 4096
    patch: int = 16
    temporal_patch: int = 2
    in_ch: int = 3
    merge: int = 2
    out_hidden: int = 2048
    num_pos_emb: int = 2304
    deepstack_idx: Tuple[int, ...] = (5, 11, 17)


@dataclass(frozen=True)
class TextCfg:
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


@dataclass(frozen=True)
class RefCfg:
    vision: VisionCfg = VisionCfg()
    text: TextCfg = TextCfg()
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    object_token_id: int = 151665


def attention(q, k, v, mask):
    """q (L, H, D), k / v (Lk, Hk, D) with H a multiple of Hk; mask
    (L, Lk) bool of the visible pairs."""
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~mask[None], float("-inf"))
    return torch.einsum("hqk,khd->qhd", s.softmax(-1), v)


def rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def sine_embed(pos: torch.Tensor, dim_total: int) -> torch.Tensor:
    """pos (N, 2) (x, y) or (N, 4) (cx, cy, w, h) -> (N, dim_total):
    each coordinate c gives dim = dim_total / n sines and cosines of
    c * 2 pi / 10000^(2 (i // 2) / dim), interleaved; coordinates in the
    order y, x[, w, h]."""
    n = pos.shape[-1]
    dim = dim_total // n
    i = torch.arange(dim, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(i / 2.0) / dim)

    def one(c):
        p = c[:, None] * (2.0 * math.pi) / dim_t
        return torch.stack([p[:, 0::2].sin(), p[:, 1::2].cos()],
                           2).reshape(len(c), -1)
    parts = [one(pos[:, 1]), one(pos[:, 0])]
    if n == 4:
        parts += [one(pos[:, 2]), one(pos[:, 3])]
    return torch.cat(parts, -1)


def roi_align(feat, rois, out: int, scale: float):
    """torchvision's roi_align (aligned=False, sampling_ratio=-1) on an
    (H, W, C) map: rois (N, 4) xyxy scaled by `scale`; each of the
    out x out bins averages ceil(roi_side / out) bilinear samples a side
    (samples beyond [-1, size] read 0, the rest are clamped into the
    map). Computed as one (N, out, H) and one (N, out, W) weight matrix,
    since the bilinear weights and the bin means factor by axis."""
    h, w, _ = feat.shape
    r = rois * scale

    def axis(lo, hi, size):
        side = (hi - lo).clamp(min=1.0)
        b = side / out
        g = torch.ceil(side / out).clamp(min=1.0)
        gmax = int(g.max())
        j = torch.arange(gmax, dtype=torch.float32, device=feat.device)
        k = torch.arange(out, dtype=torch.float32, device=feat.device)
        p = (lo[:, None, None] + b[:, None, None]
             * (k[None, :, None] + (j[None, None, :] + 0.5)
                / g[:, None, None]))                      # (N, out, gmax)
        use = (j[None, None, :] < g[:, None, None]) & (p >= -1) & (p <= size)
        p = p.clamp(min=0)
        p0 = p.floor()
        last = p0 >= size - 1
        p0 = torch.where(last, torch.full_like(p0, size - 1), p0)
        p = torch.where(last, p0, p)
        p1 = torch.where(last, p0, p0 + 1)
        frac = p - p0
        wgt = use / g[:, None, None]
        grid = torch.arange(size, device=feat.device)
        m = ((p0.long()[..., None] == grid) * ((1 - frac) * wgt)[..., None]
             + (p1.long()[..., None] == grid) * (frac * wgt)[..., None])
        return m.sum(2)                                   # (N, out, size)

    wy = axis(r[:, 1], r[:, 3], h)
    wx = axis(r[:, 0], r[:, 2], w)
    return torch.einsum("nih,njw,hwc->nijc", wy, wx, feat)


class Mlp2xGelu(nn.Sequential):
    def __init__(self, d_in, d_out):
        super().__init__(nn.Linear(d_in, d_out), nn.GELU(),
                         nn.Linear(d_out, d_out))


class RMSNorm(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * self.weight


class _VisionAttn(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.qkv = nn.Linear(c.hidden, 3 * c.hidden)
        self.proj = nn.Linear(c.hidden, c.hidden)


class _VisionMlp(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.linear_fc1 = nn.Linear(c.hidden, c.intermediate)
        self.linear_fc2 = nn.Linear(c.intermediate, c.hidden)


class VisionBlock(nn.Module):
    def __init__(self, c: VisionCfg):
        super().__init__()
        self.c = c
        self.norm1 = nn.LayerNorm(c.hidden, eps=1e-6)
        self.norm2 = nn.LayerNorm(c.hidden, eps=1e-6)
        self.attn = _VisionAttn(c)
        self.mlp = _VisionMlp(c)

    def forward(self, x, cos, sin):
        c = self.c
        s, d = x.shape[0], c.hidden // c.heads
        q, k, v = self.attn.qkv(self.norm1(x)).reshape(
            s, 3, c.heads, d).unbind(1)
        q = q * cos[:, None] + rotate_half(q) * sin[:, None]
        k = k * cos[:, None] + rotate_half(k) * sin[:, None]
        full = torch.ones((s, s), dtype=torch.bool, device=x.device)
        x = x + self.attn.proj(attention(q, k, v, full).reshape(s, -1))
        y = F.gelu(self.mlp.linear_fc1(self.norm2(x)), approximate="tanh")
        return x + self.mlp.linear_fc2(y)


class PatchMerger(nn.Module):
    def __init__(self, c: VisionCfg, postshuffle: bool):
        super().__init__()
        m2 = c.merge ** 2
        self.c, self.postshuffle = c, postshuffle
        self.norm = nn.LayerNorm(c.hidden * m2 if postshuffle else c.hidden,
                                 eps=1e-6)
        self.linear_fc1 = nn.Linear(c.hidden * m2, c.hidden * m2)
        self.linear_fc2 = nn.Linear(c.hidden * m2, c.out_hidden)

    def forward(self, x):
        m2 = self.c.merge ** 2
        if self.postshuffle:
            x = self.norm(x.reshape(-1, x.shape[-1] * m2))
        else:
            x = self.norm(x).reshape(-1, x.shape[-1] * m2)
        return self.linear_fc2(F.gelu(self.linear_fc1(x)))


class _PatchEmbed(nn.Module):
    def __init__(self, c: VisionCfg):
        super().__init__()
        k = (c.temporal_patch, c.patch, c.patch)
        self.proj = nn.Conv3d(c.in_ch, c.hidden, k, stride=k)


class VisionModel(nn.Module):
    def __init__(self, c: VisionCfg):
        super().__init__()
        self.c = c
        self.patch_embed = _PatchEmbed(c)
        self.pos_embed = nn.Embedding(c.num_pos_emb, c.hidden)
        self.blocks = nn.ModuleList(VisionBlock(c) for _ in range(c.depth))
        self.merger = PatchMerger(c, False)
        self.deepstack_merger_list = nn.ModuleList(
            PatchMerger(c, True) for _ in c.deepstack_idx)

    def forward(self, pixels: torch.Tensor):
        """pixels (H, W, 3) uint8 at the resized size -> (merged tokens
        (V, out_hidden), [deepstack taps (V, out_hidden)]), tokens in
        merge-block order (2 x 2 patches of one merged token together)."""
        c = self.c
        m, p, t = c.merge, c.patch, c.temporal_patch
        h, w, _ = pixels.shape
        gh, gw = h // p, w // p
        dev = pixels.device
        x = (pixels.float() / 255.0 - IMAGE_MEAN) / IMAGE_STD
        x = x.permute(2, 0, 1)[None].expand(t, c.in_ch, h, w)
        x = x.reshape(t, c.in_ch, gh // m, m, p, gw // m, m, p)
        x = x.permute(2, 5, 3, 6, 1, 0, 4, 7).reshape(gh * gw, -1)
        wt = self.patch_embed.proj.weight
        x = x @ wt.reshape(wt.shape[0], -1).T + self.patch_embed.proj.bias
        # (row, col) of every token in merge-block order
        rr, cc = torch.meshgrid(torch.arange(gh, device=dev),
                                torch.arange(gw, device=dev), indexing="ij")
        order = lambda a: a.reshape(gh // m, m, gw // m, m).permute(  # noqa
            0, 2, 1, 3).reshape(-1)
        rows, cols = order(rr), order(cc)
        # the position table bilinearly interpolated to the grid
        side = int(round(c.num_pos_emb ** 0.5))
        table = self.pos_embed.weight.reshape(side, side, -1)
        ys = torch.linspace(0, side - 1, gh, dtype=torch.float64,
                            device=dev)[rows]
        xs = torch.linspace(0, side - 1, gw, dtype=torch.float64,
                            device=dev)[cols]
        y0, x0 = ys.floor().long(), xs.floor().long()
        y1, x1 = (y0 + 1).clamp(max=side - 1), (x0 + 1).clamp(max=side - 1)
        dy, dx = (ys - y0)[:, None].float(), (xs - x0)[:, None].float()
        x = x + ((1 - dy) * (1 - dx) * table[y0, x0] + (1 - dy) * dx
                 * table[y0, x1] + dy * (1 - dx) * table[y1, x0]
                 + dy * dx * table[y1, x1])
        # 2-D rotary embedding: a quarter of the head dim for rows, a
        # quarter for columns, the whole repeated twice
        dim = c.hidden // c.heads // 4
        inv = 1.0 / 10000.0 ** (torch.arange(0, 2 * dim, 2, device=dev,
                                             dtype=torch.float64) / (2 * dim))
        f = torch.cat([rows[:, None] * inv, cols[:, None] * inv], 1)
        f = torch.cat([f, f], 1)
        cos, sin = f.cos().float(), f.sin().float()
        taps = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, cos, sin)
            if i in c.deepstack_idx:
                taps.append(self.deepstack_merger_list[
                    c.deepstack_idx.index(i)](x))
        return self.merger(x), taps


class _SelfAttn(nn.Module):
    def __init__(self, c: TextCfg):
        super().__init__()
        self.q_proj = nn.Linear(c.hidden, c.heads * c.head_dim, bias=False)
        self.k_proj = nn.Linear(c.hidden, c.kv_heads * c.head_dim,
                                bias=False)
        self.v_proj = nn.Linear(c.hidden, c.kv_heads * c.head_dim,
                                bias=False)
        self.o_proj = nn.Linear(c.heads * c.head_dim, c.hidden, bias=False)
        self.q_norm = RMSNorm(c.head_dim, c.rms_eps)
        self.k_norm = RMSNorm(c.head_dim, c.rms_eps)


class _Mlp(nn.Module):
    def __init__(self, c: TextCfg):
        super().__init__()
        self.gate_proj = nn.Linear(c.hidden, c.intermediate, bias=False)
        self.up_proj = nn.Linear(c.hidden, c.intermediate, bias=False)
        self.down_proj = nn.Linear(c.intermediate, c.hidden, bias=False)


class TextLayer(nn.Module):
    def __init__(self, c: TextCfg):
        super().__init__()
        self.c = c
        self.input_layernorm = RMSNorm(c.hidden, c.rms_eps)
        self.post_attention_layernorm = RMSNorm(c.hidden, c.rms_eps)
        self.self_attn = _SelfAttn(c)
        self.mlp = _Mlp(c)

    def forward(self, x, cos, sin, mask):
        c, a = self.c, self.self_attn
        n = x.shape[0]
        y = self.input_layernorm(x)
        q = a.q_norm(a.q_proj(y).reshape(n, c.heads, c.head_dim))
        k = a.k_norm(a.k_proj(y).reshape(n, c.kv_heads, c.head_dim))
        v = a.v_proj(y).reshape(n, c.kv_heads, c.head_dim)
        q = q * cos[:, None] + rotate_half(q) * sin[:, None]
        k = k * cos[:, None] + rotate_half(k) * sin[:, None]
        x = x + a.o_proj(attention(q, k, v, mask).reshape(n, -1))
        y = self.post_attention_layernorm(x)
        m = self.mlp
        return x + m.down_proj(F.silu(m.gate_proj(y)) * m.up_proj(y))


class TextModel(nn.Module):
    def __init__(self, c: TextCfg):
        super().__init__()
        self.c = c
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden)
        self.layers = nn.ModuleList(TextLayer(c) for _ in range(c.layers))
        self.norm = RMSNorm(c.hidden, c.rms_eps)


def mrope_cos_sin(pos: torch.Tensor, c: TextCfg):
    """pos (3, L) (t, h, w) -> cos, sin (L, head_dim): the frequency
    lanes interleave the axes, lane i taking h where i % 3 == 1 and
    i < 3 * section_h, w where i % 3 == 2 and i < 3 * section_w, else
    t."""
    half = c.head_dim // 2
    inv = 1.0 / c.rope_theta ** (torch.arange(
        0, c.head_dim, 2, dtype=torch.float64, device=pos.device)
        / c.head_dim)
    lane = torch.arange(half, device=pos.device)
    axis = torch.zeros(half, dtype=torch.long, device=pos.device)
    axis[(lane % 3 == 1) & (lane < 3 * c.mrope_section[1])] = 1
    axis[(lane % 3 == 2) & (lane < 3 * c.mrope_section[2])] = 2
    f = pos.double()[axis].T * inv                  # (L, half)
    f = torch.cat([f, f], -1)
    return f.cos().float(), f.sin().float()


class ConvT2x(nn.ConvTranspose2d):
    def __init__(self, cin, cout):
        super().__init__(cin, cout, 2, stride=2)


class Grounding(nn.Module):
    def __init__(self, c: RefCfg):
        super().__init__()
        d = c.text.hidden
        self.image_pos_projector = Mlp2xGelu(d, d)
        self.object_vision_projector = Mlp2xGelu(
            d if d > 4000 else 49 * d, d)
        self.object_pos_projector = Mlp2xGelu(d, d)
        self.first_scale_conv1 = ConvT2x(d, d // 2)
        self.first_scale_conv2 = ConvT2x(d // 2, d // 4)
        self.second_scale_conv = ConvT2x(d, d // 2)
        self.first_scale_norm = nn.LayerNorm(d // 2, eps=1e-5)
        self.merge = nn.Linear(d // 4 + d // 2 + d, d)
        self.visual = VisionModel(c.vision)
        self.language_model = TextModel(c.text)


def conv_t(m: ConvT2x, x):
    """(H, W, C) -> (2H, 2W, C') by the 2x2 stride-2 transposed conv."""
    y = F.conv_transpose2d(x.permute(2, 0, 1)[None], m.weight, m.bias, 2)
    return y[0].permute(1, 2, 0)


class RefReference(nn.Module):
    """`model.*` (the trunk and extras) and `out_proj`, as the
    checkpoint names them."""

    def __init__(self, c: RefCfg):
        super().__init__()
        self.c = c
        self.model = Grounding(c)
        self.out_proj = nn.Linear(c.text.hidden, 1)

    def objects(self, merged, taps, mh, mw, boxes, ori_wh):
        """RoI features of boxes (N, 4) in original image coordinates
        (ori_wh: its width, height) -> (N, hidden)."""
        g, d = self.model, self.c.text.hidden
        grid = lambda t: t.reshape(mh, mw, d)  # noqa: E731
        s1 = F.gelu(g.first_scale_norm(conv_t(g.first_scale_conv1,
                                              grid(taps[-2]))))
        s1 = conv_t(g.first_scale_conv2, s1)
        s2 = conv_t(g.second_scale_conv, grid(taps[-1]))
        s3 = grid(merged)
        size = boxes.new_tensor([mw * 32.0, mh * 32.0] * 2)
        b = boxes / (boxes.new_tensor(list(ori_wh) * 2) / size)
        r = torch.cat([roi_align(s1, b, 7, 1 / 8), roi_align(s2, b, 7, 1 / 16),
                       roi_align(s3, b, 7, 1 / 32)], -1)
        roi = g.merge(r).reshape(len(b), -1)
        if d > 4000:
            roi = roi.reshape(len(b), 49, d).mean(1)
        roi = g.object_vision_projector(roi)
        cxcywh = torch.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                              b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], -1)
        return roi + g.object_pos_projector(sine_embed(cxcywh / size, d))

    def forward(self, pixels, ids, pos, boxes, ori_wh) -> torch.Tensor:
        """One chat: pixels (H, W, 3) uint8 resized to the grid, ids (L,)
        with one contiguous image span and N <object> slots, pos (3, L)
        MRoPE ids, boxes (N, 4), ori_wh the original (width, height).
        Returns the N slots' logits."""
        c, g = self.c, self.model
        dev = pixels.device
        merged, taps = g.visual(pixels)
        mh = pixels.shape[0] // (c.vision.patch * c.vision.merge)
        mw = pixels.shape[1] // (c.vision.patch * c.vision.merge)
        d = c.text.hidden
        xs = (torch.arange(mw, dtype=torch.float32, device=dev) / mw) + 0.5
        ys = (torch.arange(mh, dtype=torch.float32, device=dev) / mh) + 0.5
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        img = merged + g.image_pos_projector(sine_embed(
            torch.stack([xx.reshape(-1), yy.reshape(-1)], -1), d))
        lm = g.language_model
        x = lm.embed_tokens(ids).clone()
        span = torch.nonzero(ids == c.image_token_id)[:, 0]
        st, n_img = int(span[0]), len(span)
        x[st:st + n_img] = img
        slots = torch.nonzero(ids == c.object_token_id)[:, 0]
        x[slots] = self.objects(merged, taps, mh, mw, boxes, ori_wh)
        cos, sin = mrope_cos_sin(pos, c.text)
        n = len(ids)
        causal = torch.ones((n, n), dtype=torch.bool, device=dev).tril()
        for i, layer in enumerate(lm.layers):
            x = layer(x, cos, sin, causal)
            if i < len(taps):
                x = torch.cat([x[:st], x[st:st + n_img] + taps[i],
                               x[st + n_img:]])
        return self.out_proj(lm.norm(x)[slots])[:, 0]


def rope_index(ids: np.ndarray, image_token_id: int, mh: int, mw: int
               ) -> np.ndarray:
    """MRoPE ids (3, L) of a chat with one image span of mh x mw merged
    tokens: text before it counts up on all three axes; the image's
    tokens take (s, s + row, s + col) from its start s; text after it
    resumes at s + max(mh, mw)."""
    n = len(ids)
    pos = np.tile(np.arange(n), (3, 1))
    span = np.nonzero(ids == image_token_id)[0]
    s = int(span[0])
    rows, cols = np.divmod(np.arange(mh * mw), mw)
    pos[0, s:s + mh * mw] = s
    pos[1, s:s + mh * mw] = s + rows
    pos[2, s:s + mh * mw] = s + cols
    pos[:, s + mh * mw:] = s + max(mh, mw) + np.arange(n - s - mh * mw)
    return pos


def grid_buckets(total_tokens: int, factor: int,
                 ratios: Sequence[float] = (0.33, 0.5, 0.67, 0.75, 1.0,
                                            1.33, 1.5, 2.0, 3.0)):
    """The (h, w) pixel sizes of ~total_tokens patches each, one an
    aspect ratio h / w."""
    out = []
    for r in ratios:
        gw = max(1, round((total_tokens / r) ** 0.5))
        out.append((max(1, round(gw * r)) * factor, gw * factor))
    return out


def snap(h: int, w: int, buckets):
    return min(buckets, key=lambda b: abs(b[0] / b[1] - h / w))
