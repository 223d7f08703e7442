"""Precomputed-embedding text backbone.

The port of `wedetect_tpu.nn.pseudo_text` (reference
wedetect/models/backbones/mm_backbone.py:540-594,
PseudoLanguageBackbone): prompts are looked up in a precomputed
{text: embedding} table instead of running a language model, which
freezes or caches the text features at train time.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from wedetect_tpu_torch import resolve_device


class PseudoTextBackbone:
    """`embedding_path`: a pickle of {text: vector} (unpickled: load
    only trusted files), or `table` in its place. Calls return
    (K, C) f32 on `device` (the card unless the caller names the CPU),
    L2-normalized when `normalize`."""

    def __init__(self, embedding_path: str = "",
                 table: Optional[Dict[str, np.ndarray]] = None,
                 normalize: bool = True, device="cuda"):
        if table is None:
            with open(embedding_path, "rb") as f:
                table = pickle.load(f)
        self.table = {k: np.asarray(v, np.float32) for k, v in table.items()}
        self.normalize = normalize
        self.device = resolve_device(device)

    def __call__(self, texts: Sequence[str]) -> torch.Tensor:
        """(K, C) embeddings for the prompt list."""
        out = torch.from_numpy(np.stack([self.table[t] for t in texts])).to(
            self.device)
        if self.normalize:
            out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        return out
