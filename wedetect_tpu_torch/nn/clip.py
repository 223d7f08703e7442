"""CLIP text and vision towers (alternative backbones) under Hugging
Face's CLIP key names.

The port of `wedetect_tpu.nn.clip` (reference
wedetect/models/backbones/mm_backbone.py:28-77, HuggingCLIPVisionBackbone:
the CLS token of last_hidden_state, before the post layernorm; and
:471-537, HuggingCLIPLanguageBackbone: text_embeds, L2-normalized).
Standard CLIP: pre-LN transformer, quick-GELU MLPs, a causal text mask
with pooling at the first EOS token and a projection; a bias-free patch
conv + CLS token + learned positions for vision.

Parameters stay f32; `dtype` is the compute type, as flax's `dtype`:
each Linear and the patch conv run in it, LayerNorm, softmax and
quick-GELU in f32, the masked logits get -1e9. Attention is a plain
matmul and softmax (the JAX module reaches no Pallas kernel). The
vision tower takes NCHW images, as HF's `pixel_values`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ClipTextCfg:
    vocab_size: int = 49408
    hidden: int = 512
    layers: int = 12
    heads: int = 8
    intermediate: int = 2048
    max_positions: int = 77
    projection_dim: int = 512
    eos_token_id: int = 49407
    ln_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class ClipVisionCfg:
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    image_size: int = 224
    patch: int = 32
    ln_eps: float = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _ln(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32, cast back to x's type."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A Linear in x's type (f32 parameters cast, as flax's `dtype`)."""
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


class _Attention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)


class _MLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)


class ClipBlock(nn.Module):
    """One pre-LN encoder layer (HF CLIPEncoderLayer's keys)."""

    def __init__(self, hidden: int, heads: int, intermediate: int,
                 ln_eps: float):
        super().__init__()
        self.heads = heads
        self.layer_norm1 = nn.LayerNorm(hidden, eps=ln_eps)
        self.self_attn = _Attention(hidden)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=ln_eps)
        self.mlp = _MLP(hidden, intermediate)

    def forward(self, x, mask_bias):
        """x (B, L, hidden) in the compute type; mask_bias f32,
        broadcastable to (B, heads, L, L)."""
        b, l, hid = x.shape
        h = self.heads
        d = hid // h
        sa = self.self_attn
        y = _ln(self.layer_norm1, x)
        q, k, v = (_dense(lin, y).reshape(b, l, h, d).transpose(1, 2)
                   for lin in (sa.q_proj, sa.k_proj, sa.v_proj))
        attn = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
        attn = torch.softmax(attn.float() + mask_bias, -1).to(x.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        x = x + _dense(sa.out_proj, o.transpose(1, 2).reshape(b, l, hid))
        y = _dense(self.mlp.fc1, _ln(self.layer_norm2, x))
        y = quick_gelu(y.float()).to(x.dtype)
        return x + _dense(self.mlp.fc2, y)


class _Encoder(nn.Module):
    def __init__(self, hidden, heads, intermediate, ln_eps, layers):
        super().__init__()
        self.layers = nn.ModuleList(
            ClipBlock(hidden, heads, intermediate, ln_eps)
            for _ in range(layers))

    def forward(self, x, mask_bias):
        for layer in self.layers:
            x = layer(x, mask_bias)
        return x


class _TextEmbeddings(nn.Module):
    def __init__(self, c: ClipTextCfg):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden)
        self.position_embedding = nn.Embedding(c.max_positions, c.hidden)


class _TextModel(nn.Module):
    def __init__(self, c: ClipTextCfg):
        super().__init__()
        self.embeddings = _TextEmbeddings(c)
        self.encoder = _Encoder(c.hidden, c.heads, c.intermediate, c.ln_eps,
                                c.layers)
        self.final_layer_norm = nn.LayerNorm(c.hidden, eps=c.ln_eps)


class ClipTextTower(nn.Module):
    """input_ids (B, L) -> (B, projection_dim) f32, L2-normalized; keys
    `text_model.*` and `text_projection.weight`."""

    def __init__(self, cfg: ClipTextCfg, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.text_model = _TextModel(cfg)
        self.text_projection = nn.Linear(cfg.hidden, cfg.projection_dim,
                                         bias=False)

    def forward(self, input_ids, attention_mask=None):
        c, tm = self.cfg, self.text_model
        b, l = input_ids.shape
        emb = tm.embeddings
        x = (emb.token_embedding(input_ids).to(self.dtype)
             + emb.position_embedding.weight[:l].to(self.dtype))
        allowed = torch.ones(l, l, dtype=torch.bool,
                             device=input_ids.device).tril()[None, None]
        if attention_mask is not None:
            allowed = allowed & attention_mask.bool()[:, None, None, :]
        bias = torch.zeros(allowed.shape, dtype=torch.float32,
                           device=input_ids.device).masked_fill(~allowed,
                                                                -1e9)
        x = _ln(tm.final_layer_norm, tm.encoder(x, bias))
        # pool at the first EOS token (HF: the eos token id's position)
        eos = (input_ids == c.eos_token_id).int().argmax(-1)
        pooled = x[torch.arange(b, device=x.device), eos]
        proj = _dense(self.text_projection, pooled).float()
        return proj / torch.linalg.vector_norm(proj, dim=-1, keepdim=True)


class _VisionEmbeddings(nn.Module):
    def __init__(self, c: ClipVisionCfg):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(c.hidden))
        self.patch_embedding = nn.Conv2d(3, c.hidden, c.patch, c.patch,
                                         bias=False)
        self.position_embedding = nn.Embedding(
            1 + (c.image_size // c.patch) ** 2, c.hidden)


class _VisionModel(nn.Module):
    def __init__(self, c: ClipVisionCfg):
        super().__init__()
        self.embeddings = _VisionEmbeddings(c)
        self.pre_layrnorm = nn.LayerNorm(c.hidden, eps=c.ln_eps)
        self.encoder = _Encoder(c.hidden, c.heads, c.intermediate, c.ln_eps,
                                c.layers)


class ClipVisionTower(nn.Module):
    """images (B, 3, H, W) -> the CLS token's last hidden state
    (B, hidden), before any post layernorm, in the compute type; keys
    `vision_model.*`."""

    def __init__(self, cfg: ClipVisionCfg, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.vision_model = _VisionModel(cfg)

    def forward(self, images):
        vm = self.vision_model
        emb = vm.embeddings
        b = images.shape[0]
        x = F.conv2d(images.to(self.dtype),
                     emb.patch_embedding.weight.to(self.dtype),
                     stride=self.cfg.patch)
        x = x.flatten(2).transpose(1, 2)                # (B, patches, hid)
        cls = emb.class_embedding.to(self.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], 1)
        x = x + emb.position_embedding.weight[:x.shape[1]].to(self.dtype)
        x = _ln(vm.pre_layrnorm, x)
        zeros = torch.zeros((), dtype=torch.float32, device=x.device)
        return vm.encoder(x, zeros)[:, 0]
