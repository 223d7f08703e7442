"""Legacy YOLO-World text-guided necks and the text-free YOLOv5 / YOLOv8
PAFPNs, in NCHW.

The port of `wedetect_tpu.nn.yolo_world_pafpn` (reference
wedetect/models/layers/yolo_bricks.py:88-244, 403-457, 572-649 and
wedetect/models/necks/yolo_world_pafpn.py:1144-1364, yolov5_pafpn.py,
yolov8_pafpn.py), class for class:

- CSPLayerWithTwoConv: 1x1 split into 2*mid, a chain of Darknet
  bottlenecks on the second half, concat all, 1x1 out
- MaxSigmoidAttnBlock: multi-head max-over-text sigmoid gating
- MaxSigmoidCSPLayerWithTwoConv: CSP with an extra attention branch
- ImagePoolingAttentionModule: text queries attend to 3x3 max-pooled
  pyramid features; residual update of the text features
- YOLOWorldPAFPN (`dual=True`: YOLOWorldDualPAFPN's text enhancer
  between the paths), YOLOv5PAFPN (C3 CSPLayer), YOLOv8PAFPN.

Module names are the reference checkpoint's, as
`wedetect_tpu/ckpt/convert.py:133-258` reads them (mmcv ConvModule's
`X.conv` / `X.bn`, no `block`): `top_down_layers.{i}`,
`bottom_up_layers.{i}`, `downsample_layers.{i}`, `reduce_layers.2`,
`main_conv`, `short_conv`, `final_conv`, `blocks.{i}.conv1`,
`attn_block.guide_fc`, `text_enhancer.projections.{i}`, `query.0`, ...
The reference's parameterless reduce / upsample / out layers hold no
keys and are plain ops here. Every BN is the head convention (eps 1e-3,
torch momentum 0.03). Input channels are constructor arguments (flax
infers them); they default to the output widths, as the JAX modules'
defaults assume.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wedetect_tpu_torch.nn.layers import Conv1x1, ConvModule

BN_KW = dict(bn_eps=1e-3, bn_momentum=0.03)


def _cm(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
        act: Optional[str] = "silu") -> ConvModule:
    return ConvModule(in_ch, out_ch, kernel, stride, act, **BN_KW)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample (the JAX package's repeat along H and W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class DarknetBottleneck(nn.Module):
    """conv1 + conv2 (3x3 both, or `kernels`) and an identity when
    `add_identity` and in == out."""

    def __init__(self, in_ch: int, out_ch: int, add_identity: bool = True,
                 kernels: Sequence[int] = (3, 3)):
        super().__init__()
        self.conv1 = _cm(in_ch, out_ch, kernels[0])
        self.conv2 = _cm(out_ch, out_ch, kernels[1])
        self.add_identity = add_identity and in_ch == out_ch

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.add_identity else y


class _TwoConvCSP(nn.Module):
    """The split / bottleneck chain / concat / 1x1 of the two-conv CSP
    layers; `n_extra` parts (an attention branch on the last part) are
    added by the subclass."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: float,
                 num_blocks: int, add_identity: bool, n_extra: int):
        super().__init__()
        self.mid = mid = int(out_ch * expand_ratio)
        self.main_conv = _cm(in_ch, 2 * mid, 1)
        self.blocks = nn.ModuleList(
            DarknetBottleneck(mid, mid, add_identity)
            for _ in range(num_blocks))
        self.final_conv = _cm((2 + num_blocks + n_extra) * mid, out_ch, 1)

    def _parts(self, x):
        parts = list(self.main_conv(x).split(self.mid, dim=1))
        for blk in self.blocks:
            parts.append(blk(parts[-1]))
        return parts


class CSPLayerWithTwoConv(_TwoConvCSP):
    def __init__(self, in_ch: int, out_ch: int, expand_ratio: float = 0.5,
                 num_blocks: int = 1, add_identity: bool = True):
        super().__init__(in_ch, out_ch, expand_ratio, num_blocks,
                         add_identity, 0)

    def forward(self, x):
        return self.final_conv(torch.cat(self._parts(x), 1))


class MaxSigmoidAttnBlock(nn.Module):
    """Gate `project_conv(x)` per head by sigmoid(max over the guide's
    texts of <embed, guide> / sqrt(E/m) + bias) (* scale). Channels split
    head-major, (m, E/m), as the reference's reshape does."""

    def __init__(self, in_ch: int, out_ch: int, guide_ch: int,
                 embed_ch: int, num_heads: int = 1,
                 with_scale: bool = False):
        super().__init__()
        self.num_heads, self.embed_ch, self.out_ch = (num_heads, embed_ch,
                                                      out_ch)
        self.guide_fc = nn.Linear(guide_ch, embed_ch)
        self.bias = nn.Parameter(torch.zeros(num_heads))
        if with_scale:
            self.scale = nn.Parameter(torch.ones(1, num_heads, 1, 1))
        if embed_ch != in_ch:
            self.embed_conv = _cm(in_ch, embed_ch, 1, act=None)
        self.project_conv = _cm(in_ch, out_ch, 3, act=None)

    def forward(self, x, guide):
        """x: (B, C, H, W); guide: (B, K, guide_ch)."""
        b, _, h, w = x.shape
        m, hc = self.num_heads, self.embed_ch // self.num_heads
        g = self.guide_fc(guide).reshape(b, -1, m, hc)
        embed = self.embed_conv(x) if hasattr(self, "embed_conv") else x
        embed = embed.reshape(b, m, hc, h, w)
        attn = torch.einsum("bmchw,bnmc->bmhwn", embed, g)
        attn = attn.max(dim=-1).values / hc ** 0.5
        attn = torch.sigmoid(attn + self.bias.to(attn.dtype)[:, None, None])
        if hasattr(self, "scale"):
            attn = attn * self.scale.to(attn.dtype)
        y = self.project_conv(x).reshape(b, m, self.out_ch // m, h, w)
        return (y * attn[:, :, None]).reshape(b, self.out_ch, h, w)


class MaxSigmoidCSPLayerWithTwoConv(_TwoConvCSP):
    def __init__(self, in_ch: int, out_ch: int, guide_ch: int,
                 embed_ch: int, num_heads: int = 1,
                 expand_ratio: float = 0.5, num_blocks: int = 1,
                 add_identity: bool = False, with_scale: bool = False):
        super().__init__(in_ch, out_ch, expand_ratio, num_blocks,
                         add_identity, 1)
        self.attn_block = MaxSigmoidAttnBlock(
            self.mid, self.mid, guide_ch, embed_ch, num_heads, with_scale)

    def forward(self, x, guide):
        parts = self._parts(x)
        parts.append(self.attn_block(parts[-1], guide))
        return self.final_conv(torch.cat(parts, 1))


class ImagePoolingAttentionModule(nn.Module):
    """Text queries attend to each level's 1x1 projection, max-pooled to
    pool_size x pool_size; the heads' output is projected back to the
    text width and added to the text (times `scale`, 0 at init, when
    with_scale). LayerNorm and softmax in f32."""

    def __init__(self, image_channels: Sequence[int], text_ch: int,
                 embed_ch: int, num_heads: int = 8, pool_size: int = 3,
                 with_scale: bool = False):
        super().__init__()
        self.embed_ch, self.num_heads, self.pool_size = (embed_ch,
                                                         num_heads,
                                                         pool_size)
        self.projections = nn.ModuleList(
            Conv1x1(c, embed_ch) for c in image_channels)
        self.query = nn.Sequential(nn.LayerNorm(text_ch),
                                   nn.Linear(text_ch, embed_ch))
        self.key = nn.Sequential(nn.LayerNorm(embed_ch),
                                 nn.Linear(embed_ch, embed_ch))
        self.value = nn.Sequential(nn.LayerNorm(embed_ch),
                                   nn.Linear(embed_ch, embed_ch))
        self.proj = nn.Linear(embed_ch, text_ch)
        if with_scale:
            self.scale = nn.Parameter(torch.zeros(1))

    @staticmethod
    def _ln_linear(seq, x):
        ln, fc = seq
        y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight,
                         ln.bias, ln.eps)
        return fc(y.to(x.dtype))

    def forward(self, text, feats: Sequence[torch.Tensor]):
        b = feats[0].shape[0]
        m, hc = self.num_heads, self.embed_ch // self.num_heads
        # torch's adaptive max pool: the windows [floor(i h / out),
        # ceil((i + 1) h / out)) that JAX's _adaptive_max_pool slices
        img = torch.cat([
            F.adaptive_max_pool2d(proj(f), self.pool_size).flatten(2)
            .transpose(1, 2) for proj, f in zip(self.projections, feats)],
            1)                                            # (B, P, E)
        q = self._ln_linear(self.query, text).reshape(b, -1, m, hc)
        k = self._ln_linear(self.key, img).reshape(b, -1, m, hc)
        v = self._ln_linear(self.value, img).reshape(b, -1, m, hc)
        attn = torch.einsum("bnmc,bkmc->bmnk", q, k) / hc ** 0.5
        attn = torch.softmax(attn.float(), -1).to(v.dtype)
        out = torch.einsum("bmnk,bkmc->bnmc", attn, v)
        out = self.proj(out.reshape(b, -1, self.embed_ch))
        if hasattr(self, "scale"):
            out = out * self.scale.to(out.dtype)
        return out + text


class YOLOWorldPAFPN(nn.Module):
    """Text-guided YOLOv8 PAFPN over 3 levels; `dual=True` adds the
    image-pooling text enhancer (embed 256) between the paths."""

    def __init__(self, in_channels: Optional[Sequence[int]] = None,
                 out_channels: Sequence[int] = (256, 512, 1024),
                 guide_channels: int = 512,
                 embed_channels: Sequence[int] = (128, 256, 512),
                 num_heads: Sequence[int] = (4, 8, 16),
                 num_csp_blocks: int = 3, dual: bool = False):
        super().__init__()
        cin = tuple(in_channels or out_channels)
        cout = tuple(out_channels)
        n = len(cout)

        def csp(i, in_ch):
            return MaxSigmoidCSPLayerWithTwoConv(
                in_ch, cout[i], guide_channels, embed_channels[i],
                num_heads=num_heads[i], num_blocks=num_csp_blocks)

        # top_down_layers[n - 1 - idx] fuses level idx into idx - 1
        up_ch = [cin[-1]] + [cout[i] for i in range(n - 2, 0, -1)]
        self.top_down_layers = nn.ModuleList(
            csp(idx - 1, up_ch[n - 1 - idx] + cin[idx - 1])
            for idx in range(n - 1, 0, -1))
        inner_ch = [cout[i] for i in range(n - 1)] + [cin[-1]]
        if dual:
            self.text_enhancer = ImagePoolingAttentionModule(
                inner_ch, guide_channels, 256)
        self.downsample_layers = nn.ModuleList(
            _cm(cout[i], cout[i], 3, 2) for i in range(n - 1))
        self.bottom_up_layers = nn.ModuleList(
            csp(i + 1, cout[i] + inner_ch[i + 1]) for i in range(n - 1))

    def forward(self, feats: Sequence[torch.Tensor], text):
        n = len(feats)
        assert n == len(self.top_down_layers) + 1
        inner = [feats[-1]]
        for idx in range(n - 1, 0, -1):
            cat = torch.cat([_upsample2x(inner[0]), feats[idx - 1]], 1)
            inner.insert(0, self.top_down_layers[n - 1 - idx](cat, text))
        if hasattr(self, "text_enhancer"):
            text = self.text_enhancer(text, inner)
        outs = [inner[0]]
        for idx in range(n - 1):
            down = self.downsample_layers[idx](outs[-1])
            outs.append(self.bottom_up_layers[idx](
                torch.cat([down, inner[idx + 1]], 1), text))
        return tuple(outs)


class VanillaSigmoidBlock(nn.Module):
    """Projection-only 'attention' block (reference
    yolo_bricks.py:651-694: the gating is commented out upstream,
    leaving a 3x3 conv that ignores the guide)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.project_conv = _cm(in_ch, out_ch, 3, act=None)

    def forward(self, x, guide=None):
        return self.project_conv(x)


class EfficientCSPLayerWithTwoConv(_TwoConvCSP):
    """CSP layer whose extra branch is a VanillaSigmoidBlock (reference
    yolo_bricks.py:696-749)."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: float = 0.5,
                 num_blocks: int = 1, add_identity: bool = True):
        super().__init__(in_ch, out_ch, expand_ratio, num_blocks,
                         add_identity, 1)
        self.attn_block = VanillaSigmoidBlock(self.mid, self.mid)

    def forward(self, x, guide=None):
        parts = self._parts(x)
        parts.append(self.attn_block(parts[-1], guide))
        return self.final_conv(torch.cat(parts, 1))


class CSPLayer(nn.Module):
    """mmdet C3 CSP layer (the YOLOv5 neck brick): main and short 1x1
    convs to out * expand_ratio, N bottlenecks (1x1 -> 3x3) on the main
    path, concat, final 1x1."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: float = 0.5,
                 num_blocks: int = 1, add_identity: bool = True):
        super().__init__()
        mid = int(out_ch * expand_ratio)
        self.main_conv = _cm(in_ch, mid, 1)
        self.short_conv = _cm(in_ch, mid, 1)
        self.blocks = nn.ModuleList(
            DarknetBottleneck(mid, mid, add_identity, kernels=(1, 3))
            for _ in range(num_blocks))
        self.final_conv = _cm(2 * mid, out_ch, 1)

    def forward(self, x):
        main = self.main_conv(x)
        for blk in self.blocks:
            main = blk(main)
        return self.final_conv(torch.cat([main, self.short_conv(x)], 1))


class YOLOv5PAFPN(nn.Module):
    """Text-free YOLOv5 PAFPN over 3 levels (in == out channels a
    level): the top level reduced 1x1, nearest-2x upsample + concat + C3
    top-down (the upper one followed by a 1x1 reduce), strided conv +
    concat + C3 bottom-up."""

    def __init__(self, channels: Sequence[int] = (256, 512, 1024),
                 num_csp_blocks: int = 1):
        super().__init__()
        ch = tuple(channels)
        assert len(ch) == 3, "3-level PAFPN"

        def c3(in_ch, out_ch):
            return CSPLayer(in_ch, out_ch, num_blocks=num_csp_blocks,
                            add_identity=False)

        self.reduce_layers = nn.ModuleList(
            [nn.Identity(), nn.Identity(), _cm(ch[2], ch[1], 1)])
        self.top_down_layers = nn.ModuleList([
            nn.Sequential(c3(2 * ch[1], ch[1]), _cm(ch[1], ch[0], 1)),
            c3(2 * ch[0], ch[0])])
        self.downsample_layers = nn.ModuleList(
            _cm(ch[i], ch[i], 3, 2) for i in range(2))
        self.bottom_up_layers = nn.ModuleList(
            c3(2 * ch[i], ch[i + 1]) for i in range(2))

    def forward(self, feats: Sequence[torch.Tensor]):
        n = len(feats)
        reduced = [r(f) for r, f in zip(self.reduce_layers, feats)]
        inner = [reduced[-1]]
        for idx in range(n - 1, 0, -1):
            cat = torch.cat([_upsample2x(inner[0]), reduced[idx - 1]], 1)
            inner.insert(0, self.top_down_layers[n - 1 - idx](cat))
        outs = [inner[0]]
        for idx in range(n - 1):
            down = self.downsample_layers[idx](outs[-1])
            outs.append(self.bottom_up_layers[idx](
                torch.cat([down, inner[idx + 1]], 1)))
        return tuple(outs)


class YOLOv8PAFPN(nn.Module):
    """Text-free YOLOv8 PAFPN: the YOLOWorldPAFPN topology with plain
    CSPLayerWithTwoConv fusion (reference yolov8_pafpn.py:25-113)."""

    def __init__(self, in_channels: Optional[Sequence[int]] = None,
                 out_channels: Sequence[int] = (256, 512, 1024),
                 num_csp_blocks: int = 3):
        super().__init__()
        cin = tuple(in_channels or out_channels)
        cout = tuple(out_channels)
        n = len(cout)

        def csp(i, in_ch):
            return CSPLayerWithTwoConv(in_ch, cout[i],
                                       num_blocks=num_csp_blocks,
                                       add_identity=False)

        up_ch = [cin[-1]] + [cout[i] for i in range(n - 2, 0, -1)]
        self.top_down_layers = nn.ModuleList(
            csp(idx - 1, up_ch[n - 1 - idx] + cin[idx - 1])
            for idx in range(n - 1, 0, -1))
        inner_ch = [cout[i] for i in range(n - 1)] + [cin[-1]]
        self.downsample_layers = nn.ModuleList(
            _cm(cout[i], cout[i], 3, 2) for i in range(n - 1))
        self.bottom_up_layers = nn.ModuleList(
            csp(i + 1, cout[i] + inner_ch[i + 1]) for i in range(n - 1))

    def forward(self, feats: Sequence[torch.Tensor]):
        n = len(feats)
        inner = [feats[-1]]
        for idx in range(n - 1, 0, -1):
            cat = torch.cat([_upsample2x(inner[0]), feats[idx - 1]], 1)
            inner.insert(0, self.top_down_layers[n - 1 - idx](cat))
        outs = [inner[0]]
        for idx in range(n - 1):
            down = self.downsample_layers[idx](outs[-1])
            outs.append(self.bottom_up_layers[idx](
                torch.cat([down, inner[idx + 1]], 1)))
        return tuple(outs)
