"""XLM-RoBERTa text tower under the HF key names.

Reference: mm_backbone.py:342-421 (XLMRobertaLanguageBackbone): HF
XLMRobertaModel -> CLS hidden state -> Linear head (hidden -> 768) ->
L2 normalize. A post-LN RoBERTa encoder: position id = cumulative
non-pad count + pad_token_id, exact GELU FFN. Attention is the plain
einsum + softmax of `wedetect_tpu/nn/xlmr.py` (f32 softmax, -1e9 key
mask). The tower runs once per class set (`Detector.reparameterize`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from wedetect_tpu_torch.configs import TextCfg


class _SelfAttention(nn.Module):
    def __init__(self, cfg: TextCfg):
        super().__init__()
        h = cfg.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.num_heads = cfg.num_heads


class _SelfOutput(nn.Module):
    def __init__(self, cfg: TextCfg):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size,
                                      eps=cfg.layer_norm_eps)


class _Attention(nn.Module):
    def __init__(self, cfg: TextCfg):
        super().__init__()
        self.self = _SelfAttention(cfg)
        self.output = _SelfOutput(cfg)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, ln_eps=None):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        if ln_eps is not None:
            self.LayerNorm = nn.LayerNorm(d_out, eps=ln_eps)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TextCfg):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, cfg.hidden_size,
                             cfg.layer_norm_eps)

    def forward(self, x, mask_bias):
        sa = self.attention.self
        b, n, hid = x.shape
        h = sa.num_heads
        d = hid // h
        q, k, v = (lin(x).reshape(b, n, h, d).transpose(1, 2)
                   for lin in (sa.query, sa.key, sa.value))
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
        probs = torch.softmax(scores.float() + mask_bias, -1).to(x.dtype)
        ctx = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        ctx = ctx.transpose(1, 2).reshape(b, n, hid)
        ao = self.attention.output
        x = ao.LayerNorm(x + ao.dense(ctx))
        f = F.gelu(self.intermediate.dense(x).float(),
                   approximate="none").to(x.dtype)
        return self.output.LayerNorm(x + self.output.dense(f))


class _Embeddings(nn.Module):
    def __init__(self, cfg: TextCfg):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size,
                                      eps=cfg.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: TextCfg):
        super().__init__()
        self.layer = nn.ModuleList(EncoderLayer(cfg)
                                   for _ in range(cfg.num_layers))


class TextTower(nn.Module):
    """Encoder -> CLS -> head Linear -> L2 norm.

    State dict keys are HF's (`embeddings.word_embeddings.weight`,
    `encoder.layer.0.attention.self.query.weight`, ...) plus
    `head.weight` / `head.bias`.
    """

    def __init__(self, cfg: TextCfg):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.head = nn.Linear(cfg.hidden_size, cfg.head_out)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """input_ids, attention_mask: (N, L) integer -> (N, head_out)."""
        c = self.cfg
        e = self.embeddings
        mask = attention_mask.to(torch.int64)
        pos_ids = torch.cumsum(mask, -1) * mask + c.pad_token_id
        x = (e.word_embeddings(input_ids.long())
             + e.position_embeddings(pos_ids)
             + e.token_type_embeddings.weight[0])
        x = e.LayerNorm(x)
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        out = self.head(x[:, 0]).float()
        return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
