"""WeDetect-Ref checkpoint loading for the CLI entry points.

Loads an HF-format directory (config.json + tokenizer + *.safetensors,
the reference's checkpoint layout) into (RefCfg, RefModules on
`device`, tokenizer), with the untied `lm_head` when the checkpoint
carries one. transformers and safetensors are imported on use.
`tiny_random_ref` builds the random-weight smoke model of the
generation and serving CLIs (`--random-init`); `random_ref` that one or
ref_2b at full width, as the grounding CLI's `--random-size` picks.
"""

from __future__ import annotations

import dataclasses

import torch


def load_ref(checkpoint: str, device="cuda"):
    import transformers

    from wedetect_tpu_torch import resolve_device
    from wedetect_tpu_torch.ckpt.convert_ref import load_hf_state_dict
    from wedetect_tpu_torch.models.ref import RefModules
    from wedetect_tpu_torch.nn.qwen3vl import RefCfg

    if not checkpoint:
        raise SystemExit(
            "random-init Ref requires the full Qwen3-VL config; supply "
            "--ref_checkpoint (HF dir with config.json + weights)")
    cfg = RefCfg.from_hf_config(
        transformers.AutoConfig.from_pretrained(checkpoint))
    tok = transformers.AutoTokenizer.from_pretrained(checkpoint)
    obj_id = tok.convert_tokens_to_ids("<object>")
    if obj_id is not None and obj_id >= 0:
        cfg = dataclasses.replace(cfg, object_token_id=obj_id)
    sd = load_hf_state_dict(checkpoint)
    # a stage-1/2 checkpoint carries an untied lm_head (reference
    # qwen3vl_grounding.py:315); other extra entries are not read
    with torch.device("meta"):
        model = RefModules(cfg, lm_head="lm_head.weight" in sd)
    model = model.to_empty(device=resolve_device(device))
    model.load_state_dict({k: sd[k] for k in model.state_dict()
                           if k in sd}, strict=True)
    return cfg, model.eval(), tok


class StubTokenizer:
    """A character tokenizer for random-weight smoke runs (no tokenizer
    files): one id a character below the special ids, the chat
    template's markers as single ids."""

    SPECIAL = ("<|im_start|>", "<|im_end|>", "<|vision_end|>")

    def __init__(self, vocab_size: int):
        self.n = vocab_size - 16           # ids 1..n-1 for characters
        self.special = {t: vocab_size - 8 + i
                        for i, t in enumerate(self.SPECIAL)}
        self.pad_token_id = vocab_size - 1

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.special.get(token, self.pad_token_id)

    def encode(self, text: str, add_special_tokens: bool = False):
        out, i = [], 0
        while i < len(text):
            hit = next((t for t in self.SPECIAL if text.startswith(t, i)),
                       None)
            if hit:
                out.append(self.special[hit])
                i += len(hit)
            else:
                out.append(1 + ord(text[i]) % (self.n - 1))
                i += 1
        return out

    def decode(self, ids) -> str:
        inv = {v: k for k, v in self.special.items()}
        return "".join(inv.get(int(t), chr(32 + int(t) % 95)) for t in ids)


def tiny_random_ref(device="cuda", seed: int = 0):
    """(RefCfg, random RefModules, StubTokenizer) of a miniature Ref
    whose head dims the card's kernels tile (ViT 2 x 128, heads of 64;
    decoder 2 x 256, 4 q / 2 kv heads of 128; vocab 512): the smoke
    model of the generation and serving CLIs' --random-init."""
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.nn.qwen3vl import (RefCfg, RefTextCfg,
                                               RefVisionCfg)

    cfg = RefCfg(
        vision=RefVisionCfg(depth=2, hidden=128, heads=2, intermediate=256,
                            patch=16, temporal_patch=2, merge=2,
                            out_hidden=256, num_pos_emb=64,
                            deepstack_idx=(0, 1)),
        text=RefTextCfg(vocab_size=512, hidden=256, layers=2, heads=4,
                        kv_heads=2, head_dim=128, intermediate=512,
                        rope_theta=1000.0),
        image_token_id=496, video_token_id=497, vision_start_token_id=498,
        object_token_id=499)
    return (cfg, init_ref_variables(cfg, seed=seed, device=device),
            StubTokenizer(cfg.text.vocab_size))


def random_ref(size: str = "tiny", device="cuda", seed: int = 0):
    """(RefCfg, random RefModules, StubTokenizer): tiny_random_ref's
    miniature Ref ("tiny") or ref_2b at full width ("2b")."""
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    if size == "tiny":
        return tiny_random_ref(device, seed)
    if size != "2b":
        raise ValueError(f"random Ref size {size!r}: tiny or 2b")
    cfg = ref_2b()
    return (cfg, init_ref_variables(cfg, seed=seed, device=device),
            StubTokenizer(cfg.text.vocab_size))
