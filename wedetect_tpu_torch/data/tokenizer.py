"""Host-side tokenization for the XLM-RoBERTa text tower (reference
mm_backbone.py:378-383: batched HF tokenizer with padding). The
sentencepiece files are not shipped; pass a local path or hub name."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class TextTokenizer:
    def __init__(self, model_name: str = "xlm-roberta-base"):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(model_name)

    def __call__(self, texts: Sequence[str],
                 max_len: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (input_ids, attention_mask) int32 (N, L) padded."""
        enc = self.tok(list(texts), padding=True, truncation=True,
                       max_length=max_len, return_tensors="np")
        return (enc["input_ids"].astype(np.int32),
                enc["attention_mask"].astype(np.int32))
